"""``python -m next3d_tpu_torch.cli.main train``: GAN training on one
device.

Counterpart of next3d_tpu/cli/train.py (reference train_next3d.py:224-422):
the same options with the same defaults (``add_options``), the per-dataset
rendering block, the super-resolution module by resolution, lazy
regularization intervals G = density_reg_every and D = 16, the EMA
half-life batch * 10 / 32 kimg, a grid of reals and of G_ema's fakes, plus
``--device`` (default ``cuda``) and ``--timing-every``. ``--kimg`` and
``--tick`` take fractions of a kimg too, for short runs.

As the JAX command: ``--model-version texture`` trains
``TriPlaneTextureGenerator``; ``--aug ada|fixed`` puts the reference's
augment pipe (blit, geometric and colour transforms) in front of D, its
probability adapted towards ``--target`` from 0 (ada) or fixed at ``--p``;
``--dataset-type video --num-frames-per-video T`` trains on clips of T
frames, D seeing a clip's frames as 3*T channels and its labels as 25*T;
``--gen-exp-cond`` gives D a second label mapping for a 50-wide
expression label (``DualLabelDualDiscriminator``), so the dataset's labels
are 75 wide. A ``--resume`` changes the schedules as JAX's does
(reference train_next3d.py:394-401): ADA reacts over 100 kimg instead of
500, the EMA has no ramp-up and, unless ``--resume-blur``, the blur and
the conditioning-swap fades are off. ``--resume`` takes a format-1
snapshot of either package's loop or a reference network pickle, such as
EG3D's ``ffhqrebalanced512-64.pkl`` of the reference's recipe, which
warm-starts the networks (``train/training_loop.py load_resume``).

Float32 without TF32 throughout, as the JAX package trains at float32.

``--metrics`` names metrics of ``metrics/metric_main.py`` (comma-separated,
``none`` for none) that the loop computes on G_ema after each snapshot, on
the training dataset, each appended to ``metric-<name>.jsonl`` in the run
directory; a metric that fails is printed as ``metric <name> FAILED`` and
training goes on, as in the JAX package (JAX training_loop.py:318-338).

Not ported yet, and raising when asked for (ROADMAP.md Queue 1): more than
one device (``--gpus``).
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import torch

from .common import CFG_RENDERING_BLOCKS, DEMO_OBJ, FFHQ_RENDERING_KWARGS


# the augment pipe of --aug ada|fixed (reference train_next3d.py:388)
PIPE_KWARGS = dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1,
                   xfrac=1, brightness=1, contrast=1, lumaflip=1, hue=1,
                   saturation=1)


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


def parse_metric_list(s):
    """'fid2k_full,kid50k_full' -> the names; none for None, '' and
    'none' (JAX :30-33)."""
    if s is None or s in ('', 'none', 'None'):
        return []
    return [m.strip() for m in str(s).split(',') if m.strip()]


def _unported(opts):
    if (opts['num_devices'] or 1) > 1:
        raise NotImplementedError(
            'training on more than one device (--gpus) is not ported to '
            'next3d_tpu_torch yet (ROADMAP.md Queue 1 item 7)')


def build_training(opts, device):
    """(G, D, G_ema, loss, step, config, loop kwargs) for the options of
    ``train``, the networks initialized from ``seed`` on the CPU and moved
    to ``device``."""
    from ..models.triplane_next3d import TriPlaneGenerator
    from ..models.triplane_texture import TriPlaneTextureGenerator
    from ..nn.discriminator import (DualDiscriminator,
                                    DualLabelDualDiscriminator)
    from ..train.augment import AugmentPipe
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
    G_cls = {'next3d': TriPlaneGenerator,
             'texture': TriPlaneTextureGenerator}[o['model_version']]
    G = G_cls(topology_path=o['topology_path'],
              uv_face_eye_mask_path=o['eye_mask_path'], generator=init,
              **g_kwargs)
    # clips: D sees a clip's frames as channels and its labels concatenated
    # (JAX :179-193)
    T = num_frames(o)
    d_kwargs = dict(
        img_resolution=o['resolution'], img_channels=3 * T,
        channel_base=o['channel_base'], channel_max=o['channel_max'],
        block_kwargs=dict(freeze_layers=o['freezed']),
        epilogue_kwargs=dict(mbstd_group_size=o['mbstd_group']),
        disc_c_noise=o['disc_c_noise'], generator=init)
    if o['gen_exp_cond']:
        D = DualLabelDualDiscriminator(c_dim=25 * T, c2_dim=50 * T,
                                       **d_kwargs)
    else:
        D = DualDiscriminator(c_dim=25 * T, **d_kwargs)
    G_ema = copy.deepcopy(G).eval()
    G, D, G_ema = (m.to(device) for m in (G, D, G_ema))
    for p in G_ema.parameters():
        p.requires_grad_(False)

    # the schedules a resume changes (JAX :195-204, reference
    # train_next3d.py:394-401)
    ada_kimg, ema_rampup = 500, 0.05
    blur_init_sigma = 10.0 if o['blur_fade_kimg'] > 0 else 0.0
    gpc_reg_fade_kimg = o['gpc_reg_fade_kimg']
    if o['resume_path'] is not None:
        ada_kimg, ema_rampup = 100, None
        if not o['resume_blur']:
            blur_init_sigma = gpc_reg_fade_kimg = 0.0
    augment_pipe = AugmentPipe(**PIPE_KWARGS) if o['aug'] != 'noaug' \
        else None

    batch = o['batch_size']
    loss_cfg = LossConfig(
        r1_gamma=o['r1_gamma'],
        gpc_reg_prob=o['gpc_reg_prob'] if o['gen_pose_cond'] else None,
        gpc_reg_fade_kimg=gpc_reg_fade_kimg,
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
        blur_init_sigma=blur_init_sigma,
        blur_fade_kimg=o['blur_fade_kimg'] * batch / 32, num_frames=T)
    loss = StyleGAN2Loss(G, D, loss_cfg, augment_pipe=augment_pipe)
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
                  dlr=o['dlr'], aug=o['aug'], ada_target=o['ada_target'],
                  aug_p=o['aug_p'], freezed=o['freezed'],
                  mirror=o['mirror'], style_mixing_prob=o[
                      'style_mixing_prob'], reg_type=o['reg_type'],
                  seed=o['seed'], dataset_type=o['dataset_type'],
                  num_frames=T, gen_exp_cond=o['gen_exp_cond'],
                  metrics=parse_metric_list(o['metrics']),
                  G_kwargs=g_kwargs)
    loop = dict(total_kimg=o['total_kimg'], batch_size=batch,
                ema_kimg=batch * 10 / 32, ema_rampup=ema_rampup,
                g_reg_interval=g_reg_interval,
                kimg_per_tick=o['kimg_per_tick'],
                snapshot_ticks=o['snapshot_ticks'],
                image_snapshot_ticks=o['snapshot_ticks'],
                resume_path=o['resume_path'], seed=o['seed'],
                workers=o['workers'],
                timing_sample_every=o['timing_sample_every'],
                ada_target=o['ada_target'] if o['aug'] == 'ada' else None,
                augment_p=o['aug_p'] if o['aug'] == 'fixed' else 0.0,
                ada_kimg=ada_kimg, metrics=parse_metric_list(o['metrics']))
    return G, D, G_ema, loss, step, config, loop


def num_frames(opts):
    """Frames a clip: ``--num-frames-per-video`` for a video dataset, else
    1."""
    return opts['num_frames_per_video'] if opts['dataset_type'] == 'video' \
        else 1


def make_dataset(opts):
    """The dataset of ``--data``: PNG images, or clips of PNG frames
    (``--dataset-type video``, JAX :258-263)."""
    from ..data.dataset import ImageFolderDataset
    from ..data.video_dataset import VideoFramesFolderDataset
    if opts['dataset_type'] == 'video':
        return VideoFramesFolderDataset(
            opts['data_path'], resolution=opts['resolution'],
            num_frames=num_frames(opts), sampling=opts['sampling_type'],
            max_frame_dist=opts['max_dist'],
            max_num_frames=opts['max_num_frames'])
    dataset = ImageFolderDataset(opts['data_path'],
                                 resolution=opts['resolution'],
                                 xflip=opts['mirror'])
    dataset.prebake()
    return dataset


def train(device='cuda', **opts):
    """Run the command; returns the loop's result (``cur_nimg``, the ticks'
    records and ``ada_p``) with the networks (``G``, ``D``, ``G_ema``)."""
    _unported(opts)
    if opts['dry_run']:
        print('dry run OK:')
        print(json.dumps({k: v for k, v in opts.items()}, indent=2,
                         default=str))
        return None
    device = torch.device(device)
    return fit(opts, build_training(opts, device), device)


def fit(opts, training, device):
    """Train ``training`` (``build_training``'s networks, loss, step, config
    and loop kwargs) on the dataset of ``opts``."""
    from ..train.training_loop import training_loop
    from .common import float32_math, save_image_grid

    G, D, G_ema, loss, step, config, loop = training
    dataset = make_dataset(opts)
    # the reals grid and the batch of G_ema's fakes (reference
    # training_loop.py:277-282, :428-435), a clip's first frame (JAX
    # :276-286)
    outdir = opts['outdir']
    os.makedirs(outdir, exist_ok=True)
    vis_n = int(min(16, opts['batch_size'], len(dataset)))
    vis_rnd = np.random.RandomState(opts['seed'])
    items = [dataset[int(i)] for i in vis_rnd.choice(len(dataset), vis_n,
                                                      replace=False)]

    def frame0(a, base_ndim):
        return a[0] if a.ndim == base_ndim + 1 else a

    save_image_grid(np.stack([frame0(im, 3) for im, _, _ in items]),
                    os.path.join(outdir, 'reals.png'), drange=(0, 255))
    vis = dict(gen_z=vis_rnd.randn(vis_n, 512).astype(np.float32),
               gen_c=np.stack([frame0(c, 1) for _, c, _ in items]
                              ).astype(np.float32),
               gen_v=np.stack([frame0(v, 2) for _, _, v in items]
                              ).astype(np.float32),
               nrr=opts['neural_rendering_resolution_initial'])
    with float32_math():
        result = training_loop(G, D, G_ema, loss, step, dataset, outdir,
                               device, config=config,
                               snapshot_vis_batch=vis, **loop)
    return dict(result, G=G, D=D, G_ema=G_ema)
