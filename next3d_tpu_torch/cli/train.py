"""``python -m next3d_tpu_torch.cli.main train``: GAN training on one
device.

Counterpart of next3d_tpu/cli/train.py (reference train_next3d.py:224-422):
the same options with the same defaults (``add_options``), the per-dataset
rendering block, the super-resolution module by resolution, lazy
regularization intervals G = density_reg_every and D = 16, the EMA
half-life batch * 10 / 32 kimg, a grid of reals and of G_ema's fakes, plus
``--device`` (default ``cuda``) and ``--timing-every``. ``--kimg`` and
``--tick`` take fractions of a kimg too, for short runs.

Float32 without TF32 throughout, as the JAX package trains at float32.
A resumed run is an exact continuation of a port snapshot, so the
reference's resume-time changes of the schedules (train_next3d.py:394-401,
meant for warm starts from a reference .pkl, which are not ported) are not
applied.

Not ported yet, and raising when asked for (ROADMAP.md Queue 1 item 5):
the texture variant's and video training, the dual-label discriminator
(``--gen-exp-cond``), augmentation (``--aug`` other than noaug), metrics,
and more than one device (``--gpus``).
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import torch

from .common import CFG_RENDERING_BLOCKS, DEMO_OBJ, FFHQ_RENDERING_KWARGS


def choose_sr_module(resolution):
    """reference train_next3d.py:301-308."""
    return {512: 'SuperresolutionHybrid8XDC',
            256: 'SuperresolutionHybrid4X',
            128: 'SuperresolutionHybrid2X'}[resolution]


def add_options(p, bool_type):
    """The JAX command's options and defaults (next3d_tpu/cli/train.py
    :36-118)."""
    p.add_argument('--outdir', required=True)
    p.add_argument('--data', dest='data_path', required=True)
    p.add_argument('--gpus', dest='num_devices', type=int, default=None)
    p.add_argument('--batch', dest='batch_size', type=int, default=32)
    p.add_argument('--gamma', dest='r1_gamma', type=float, default=4.0)
    p.add_argument('--kimg', dest='total_kimg', type=float, default=25000)
    p.add_argument('--tick', dest='kimg_per_tick', type=float, default=4)
    p.add_argument('--snap', dest='snapshot_ticks', type=int, default=20)
    p.add_argument('--glr', type=float, default=0.0025)
    p.add_argument('--dlr', type=float, default=0.002)
    p.add_argument('--cbase', dest='channel_base', type=int, default=32768)
    p.add_argument('--cmax', dest='channel_max', type=int, default=512)
    p.add_argument('--map-depth', type=int, default=2)
    p.add_argument('--mbstd-group', type=int, default=4)
    p.add_argument('--gen-pose-cond', type=bool_type, default=False)
    p.add_argument('--gen-exp-cond', type=bool_type, default=False)
    p.add_argument('--gpc-reg-prob', type=float, default=0.5)
    p.add_argument('--gpc-reg-fade-kimg', type=float, default=1000.0)
    p.add_argument('--disc-c-noise', type=float, default=0.0)
    p.add_argument('--density-reg', type=float, default=0.25)
    p.add_argument('--density-reg-every', type=float, default=4)
    p.add_argument('--density-reg-p-dist', type=float, default=0.004)
    p.add_argument('--reg-type', default='l1',
                   choices=['l1', 'monotonic-detach', 'monotonic-fixed'])
    p.add_argument('--style-mixing-prob', type=float, default=0.0)
    p.add_argument('--aug', default='noaug', choices=['noaug', 'ada',
                                                       'fixed'])
    p.add_argument('--target', dest='ada_target', type=float, default=0.6)
    p.add_argument('--p', dest='aug_p', type=float, default=0.2)
    p.add_argument('--freezed', type=int, default=0)
    p.add_argument('--mirror', type=bool_type, default=False)
    p.add_argument('--metrics', type=str, default='none')
    p.add_argument('--workers', type=int, default=3)
    p.add_argument('--resume', dest='resume_path', type=str, default=None)
    p.add_argument('--resume-blur', type=bool_type, default=False)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--topology-path', type=str, default=DEMO_OBJ)
    p.add_argument('--eye-mask-path', type=str, default=None)
    p.add_argument('--resolution', type=int, default=512)
    p.add_argument('--sr-num-fp16-res', type=int, default=4)
    p.add_argument('--sr-noise-mode', default='none',
                   choices=['random', 'none'])
    p.add_argument('--neural-rendering-resolution-initial', type=int,
                   default=64)
    p.add_argument('--neural-rendering-resolution-final', type=int,
                   default=None)
    p.add_argument('--neural-rendering-resolution-fade-kimg', type=float,
                   default=1000.0)
    p.add_argument('--blur-fade-kimg', type=float, default=200.0)
    p.add_argument('--cfg', default='ffhq', choices=['ffhq', 'afhq',
                                                      'shapenet'])
    p.add_argument('--model-version', default='next3d',
                   choices=['next3d', 'texture'])
    p.add_argument('--plane-resolution', type=int, default=256)
    p.add_argument('--dataset-type', default='image',
                   choices=['image', 'video'])
    p.add_argument('--num-frames-per-video', type=int, default=1)
    p.add_argument('--max-num-frames', type=int, default=1024)
    p.add_argument('--max-dist', type=int, default=32)
    p.add_argument('--sampling-type', default='random',
                   choices=['random', 'uniform', 'consecutive'])
    p.add_argument('--dry-run', action='store_true')
    p.add_argument('--timing-every', dest='timing_sample_every', type=int,
                   default=16, help='time each phase every N batches')


def _unported(opts):
    for asked, what in (
            (opts['model_version'] != 'next3d', 'training the texture '
             'variant (--model-version texture)'),
            (opts['dataset_type'] != 'image', 'video training'),
            (opts['gen_exp_cond'], 'the dual-label discriminator '
             '(--gen-exp-cond)'),
            (opts['aug'] != 'noaug', 'augmentation (--aug)'),
            (opts['metrics'] not in (None, '', 'none', 'None'),
             'in-training metrics (--metrics)'),
            ((opts['num_devices'] or 1) > 1, 'training on more than one '
             'device (--gpus)')):
        if asked:
            raise NotImplementedError(f'{what} is not ported to '
                                      f'next3d_tpu_torch yet (ROADMAP.md '
                                      f'Queue 1 item 5)')


def build_training(opts, device):
    """(G, D, G_ema, loss, step, config, loop kwargs) for the options of
    ``train``, the networks initialized from ``seed`` on the CPU and moved
    to ``device``."""
    from ..models.triplane_next3d import TriPlaneGenerator
    from ..nn.discriminator import DualDiscriminator
    from ..train.loss import LossConfig, StyleGAN2Loss
    from ..train.train_step import (TrainStep, make_optimizer,
                                    trainable_parameters)

    o = opts
    rendering_kwargs = dict(FFHQ_RENDERING_KWARGS)
    rendering_kwargs.update(CFG_RENDERING_BLOCKS[o['cfg']])
    rendering_kwargs.update(
        c_gen_conditioning_zero=not o['gen_pose_cond'],
        gpc_reg_prob=o['gpc_reg_prob'] if o['gen_pose_cond'] else None,
        density_reg=o['density_reg'],
        density_reg_p_dist=o['density_reg_p_dist'],
        reg_type=o['reg_type'],
        superresolution_module=choose_sr_module(o['resolution']),
        superresolution_noise_mode=o['sr_noise_mode'],
        image_resolution=o['resolution'])
    g_kwargs = dict(z_dim=512, c_dim=25, w_dim=512,
                    img_resolution=o['resolution'], img_channels=3,
                    channel_base=o['channel_base'],
                    channel_max=o['channel_max'],
                    mapping_kwargs=dict(num_layers=o['map_depth']),
                    sr_num_fp16_res=o['sr_num_fp16_res'],
                    rendering_kwargs=rendering_kwargs,
                    plane_resolution=o['plane_resolution'])
    init = torch.Generator().manual_seed(o['seed'])
    G = TriPlaneGenerator(topology_path=o['topology_path'],
                          uv_face_eye_mask_path=o['eye_mask_path'],
                          generator=init, **g_kwargs)
    D = DualDiscriminator(
        c_dim=25, img_resolution=o['resolution'], img_channels=3,
        channel_base=o['channel_base'], channel_max=o['channel_max'],
        block_kwargs=dict(freeze_layers=o['freezed']),
        epilogue_kwargs=dict(mbstd_group_size=o['mbstd_group']),
        disc_c_noise=o['disc_c_noise'], generator=init)
    G_ema = copy.deepcopy(G).eval()
    G, D, G_ema = (m.to(device) for m in (G, D, G_ema))
    for p in G_ema.parameters():
        p.requires_grad_(False)

    batch = o['batch_size']
    loss_cfg = LossConfig(
        r1_gamma=o['r1_gamma'],
        gpc_reg_prob=o['gpc_reg_prob'] if o['gen_pose_cond'] else None,
        gpc_reg_fade_kimg=o['gpc_reg_fade_kimg'],
        density_reg=o['density_reg'],
        density_reg_p_dist=o['density_reg_p_dist'], reg_type=o['reg_type'],
        style_mixing_prob=o['style_mixing_prob'],
        box_warp=rendering_kwargs.get('box_warp', 1.0),
        neural_rendering_resolution_initial=o[
            'neural_rendering_resolution_initial'],
        neural_rendering_resolution_final=o[
            'neural_rendering_resolution_final'],
        neural_rendering_resolution_fade_kimg=o[
            'neural_rendering_resolution_fade_kimg'],
        blur_init_sigma=10.0 if o['blur_fade_kimg'] > 0 else 0.0,
        blur_fade_kimg=o['blur_fade_kimg'] * batch / 32)
    loss = StyleGAN2Loss(G, D, loss_cfg)
    g_reg_interval = int(o['density_reg_every']) if o['density_reg'] > 0 \
        else None
    step = TrainStep(
        loss,
        make_optimizer(trainable_parameters(G), o['glr'], 0.0, 0.99, 1e-8,
                       reg_interval=g_reg_interval),
        make_optimizer(trainable_parameters(D, D.frozen_paths()), o['dlr'],
                       0.0, 0.99, 1e-8, reg_interval=16))
    config = dict(outdir=o['outdir'], data=o['data_path'], batch=batch,
                  cfg=o['cfg'], model_version=o['model_version'],
                  gamma=o['r1_gamma'], kimg=o['total_kimg'], glr=o['glr'],
                  dlr=o['dlr'], aug=o['aug'], freezed=o['freezed'],
                  mirror=o['mirror'], style_mixing_prob=o[
                      'style_mixing_prob'], reg_type=o['reg_type'],
                  seed=o['seed'], G_kwargs=g_kwargs)
    loop = dict(total_kimg=o['total_kimg'], batch_size=batch,
                ema_kimg=batch * 10 / 32, g_reg_interval=g_reg_interval,
                kimg_per_tick=o['kimg_per_tick'],
                snapshot_ticks=o['snapshot_ticks'],
                image_snapshot_ticks=o['snapshot_ticks'],
                resume_path=o['resume_path'], seed=o['seed'],
                workers=o['workers'],
                timing_sample_every=o['timing_sample_every'])
    return G, D, G_ema, loss, step, config, loop


def train(device='cuda', **opts):
    """Run the command; returns the loop's result (``cur_nimg`` and the
    ticks' records) with the networks (``G``, ``D``, ``G_ema``)."""
    from ..data.dataset import ImageFolderDataset
    from ..train.training_loop import training_loop
    from .common import float32_math, save_image_grid

    _unported(opts)
    if opts['dry_run']:
        print('dry run OK:')
        print(json.dumps({k: v for k, v in opts.items()}, indent=2,
                         default=str))
        return None
    device = torch.device(device)
    G, D, G_ema, loss, step, config, loop = build_training(opts, device)
    dataset = ImageFolderDataset(opts['data_path'],
                                 resolution=opts['resolution'],
                                 xflip=opts['mirror'])
    dataset.prebake()
    # the reals grid and the batch of G_ema's fakes (reference
    # training_loop.py:277-282, :428-435)
    outdir = opts['outdir']
    os.makedirs(outdir, exist_ok=True)
    vis_n = int(min(16, opts['batch_size'], len(dataset)))
    vis_rnd = np.random.RandomState(opts['seed'])
    items = [dataset[int(i)] for i in vis_rnd.choice(len(dataset), vis_n,
                                                      replace=False)]
    save_image_grid(np.stack([im for im, _, _ in items]),
                    os.path.join(outdir, 'reals.png'), drange=(0, 255))
    vis = dict(gen_z=vis_rnd.randn(vis_n, 512).astype(np.float32),
               gen_c=np.stack([c for _, c, _ in items]).astype(np.float32),
               gen_v=np.stack([v for _, _, v in items]).astype(np.float32),
               nrr=opts['neural_rendering_resolution_initial'])
    with float32_math():
        result = training_loop(G, D, G_ema, loss, step, dataset, outdir,
                               device, config=config,
                               snapshot_vis_batch=vis, **loop)
    return dict(result, G=G, D=D, G_ema=G_ema)
