"""Benchmark of the port: 512^2 avatar synthesis, reenactment and training
throughput on one CUDA card.

Counterpart of the repository's ``bench.py`` (the JAX package's), with its
environment, its defaults, its modes and its one JSON line on stdout:

    python3 -m next3d_tpu_torch.bench

  {"metric": "...", "value": N, "unit": "img/s", "vs_baseline": N}

Environment (``bench.py:80-94``):

  NEXT3D_BENCH_MODE=synthesis|reenact|train
      synthesis: the flagship's forward (mapping at psi 0.7, cutoff 14, then
      ``synthesis`` with constant noise); reenact: the identity built once,
      then ``synthesis_from_identity`` a frame; train: the four phases of a
      GAN step with the G_ema update, each of the three step types (plain,
      +Greg, +Dreg) timed apart and combined at the lazy regularization's
      cadence (Greg every 4th step, Dreg every 16th)
  NEXT3D_BENCH_BATCH=8
  NEXT3D_BENCH_BF16=1     the generator's bf16 policy (``force_fp32=False``);
                          0 runs float32 throughout
  NEXT3D_BENCH_ITERS=10
  NEXT3D_BENCH_SWEEP=0    1: also the batch sweep 1, 8, 16, 32 (synthesis)
  NEXT3D_BENCH_FUSED=0    1: ``fused_plane_sampling``
  NEXT3D_BENCH_RASTER=auto  the rasterizer (render/rasterizer.py IMPLS)
  NEXT3D_TOPOLOGY         an OBJ with ``<name>_kpt2d.txt`` beside it, as
                          ``__graft_entry__.py`` reads it; unset: the
                          in-repo synthetic head (utils/synthetic_head.py)

The weights are random, drawn from a ``torch.Generator`` seeded with 0:
they are not the JAX package's ``PRNGKey(0)`` init. The discriminator is
float32, as the JAX loss runs it (``force_fp32=True``); the port's D takes
no ``num_fp16_res``. Training recomputes the synthesis in the backward
(``remat_synthesis=True``), as ``bench.py`` runs it. float32 matmuls and
convolutions run without TF32.

Timing: each measurement's first call and a warm-up absorb the kernels'
build (ops/cuda_build.py, on first use) and cuDNN's first calls; the
varied inputs are staged on the device before the clock starts, and the
device is synchronized before and after each timed loop (each step in
``train``). ``vs_baseline`` divides by BASELINE.md's A100 anchor of 15
img/s, an estimate and no measurement.

stderr: the step times (train); the batch sweep, where an out-of-memory
error prints ``failed (<type>)``; in synthesis, the convolution and matmul
FLOPs of one forward counted by ``torch.utils.flop_counter`` (the
hand-written kernels are not counted) and, on the card, the model FLOP
utilization against the H100's dense peak for the precision (989 TFLOP/s
bf16; 67 TFLOP/s float32 without TF32) beside the card's name and power
limit; the peak device memory; the hand-written kernels' launches over
the whole run (``launch_counts``).
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

A100_BASELINE_IMGS_PER_SEC = 15.0   # BASELINE.md's estimate
PEAK_FLOPS = {True: 989e12, False: 67e12}   # H100 SXM dense: bf16, float32
METRICS = {'synthesis': '512px_synthesis_imgs_per_sec_per_chip',
           'reenact': '512px_reenact_frames_per_sec_per_chip',
           'train': '512px_train_step_imgs_per_sec_per_chip'}
# the FFHQ 512^2 rendering config of __graft_entry__.py:10-18
RENDER_KW_FFHQ = dict(
    ray_start=2.25, ray_end=3.3, box_warp=1.0,
    depth_resolution=48, depth_resolution_importance=48,
    disparity_space_sampling=False, clamp_mode='softplus',
    c_gen_conditioning_zero=False, c_scale=1.0, gpc_reg_prob=0.5,
    superresolution_module='SuperresolutionHybrid8XDC',
    superresolution_noise_mode='none', sr_antialias=True,
    density_reg=0.25, density_reg_p_dist=0.004, reg_type='l1',
    decoder_lr_mul=1.0)
G_KWARGS = dict(z_dim=512, c_dim=25, w_dim=512, img_resolution=512,
                img_channels=3, sr_num_fp16_res=4,
                rendering_kwargs=RENDER_KW_FFHQ)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def load_topology():
    """(mesh, landmarks (68, 3)): ``NEXT3D_TOPOLOGY``'s OBJ and the
    ``_kpt2d.txt`` beside it when the variable is set, else the synthetic
    head."""
    from .utils.obj_io import load_lms, load_obj
    from .utils.synthetic_head import synthetic_head
    path = os.environ.get('NEXT3D_TOPOLOGY')
    if not path:
        return synthetic_head()
    lms = os.path.splitext(path)[0] + '_kpt2d.txt'
    for f in (path, lms):
        if not os.path.exists(f):
            raise FileNotFoundError(f'NEXT3D_TOPOLOGY: {f} does not exist')
    return load_obj(path), load_lms(lms)


def camera_batch(n):
    """(n, 25) float32: the frontal FFHQ camera (``__graft_entry__.py
    _camera_batch``)."""
    from .render import camera_utils
    cam = camera_utils.lookat_pose(math.pi / 2, math.pi / 2, [0, 0, 0.2],
                                   radius=2.7, batch_size=1, device='cpu')
    K = camera_utils.fov_to_intrinsics(18.837)
    c = np.concatenate([cam.numpy().reshape(1, 16), K.reshape(1, 9)],
                       axis=1).astype(np.float32)
    return np.repeat(c, n, axis=0)


def verts_batch(n, mesh, lms):
    """(n, verts + 68, 3) float32: the mesh's verts and the landmarks
    (``__graft_entry__.py _verts_batch``)."""
    v = np.concatenate([mesh.verts, lms], axis=0)[None].astype(np.float32)
    return np.repeat(v, n, axis=0)


def amortized_step(t_plain, t_greg, t_dreg):
    """A step's seconds at the lazy regularization's cadence: Greg every 4
    G steps, Dreg every 16 D steps (``bench.py:210``)."""
    return t_plain + (t_greg - t_plain) / 4 + (t_dreg - t_plain) / 16


def card_line():
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def launch_counts():
    """The hand-written kernels' launch counts in this process."""
    from .ops import raster, raster_zbuffer, triplane
    return {'K1': raster.rasterize_binned_uv.launches,
            'K3': raster.rasterize_binned_uv16.launches,
            'K4': triplane.triplane_sample.launches,
            'K4bf16': triplane.triplane_sample.launches_bf16,
            'K4b': triplane.triplane_sample_backward.launches,
            'K4b_bf16': triplane.triplane_sample_backward_bf16.launches,
            'K5': raster_zbuffer.rasterize_zbuffer.launches}


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _measure(fn, x, batch, iters, device):
    """img/s of ``fn(x')`` over ``iters`` calls on inputs x' = x + i * 1e-6
    staged on the device, after a first call and a warm-up."""
    fn(x)
    _sync(device)
    staged = [x + i * 1e-6 for i in range(iters)]
    fn(staged[0])
    _sync(device)
    t0 = time.perf_counter()
    for xi in staged:
        fn(xi)
    _sync(device)
    return batch * iters / (time.perf_counter() - t0)


def build_generator(kw, mesh, device, use_bf16=True, fused=False,
                    raster='auto'):
    """The flagship of config ``kw`` on ``mesh``, seeded 0."""
    from .models.triplane_next3d import TriPlaneGenerator
    kw = dict(kw, rendering_kwargs=dict(kw['rendering_kwargs']))
    if fused:
        kw['rendering_kwargs']['fused_plane_sampling'] = True
    G = TriPlaneGenerator(topology_path=mesh, force_fp32=not use_bf16,
                          rasterizer_impl=raster,
                          generator=torch.Generator().manual_seed(0), **kw)
    return G.to(device)


def _train_rate(G, widths, inputs, batch, iters, device):
    """Training img/s: the three step types timed apart (first call,
    warm-up, then the median of max(2, iters // 2) steps), combined by
    ``amortized_step``."""
    from .nn.discriminator import DualDiscriminator
    from .train.loss import LossConfig, StyleGAN2Loss
    from .train.train_step import (TrainStep, make_optimizer,
                                   trainable_parameters)
    z, c, v = inputs
    # float32, as the JAX loss runs D (its num_fp16_res is not ported), at
    # the generator's widths, as the train command builds it
    D = DualDiscriminator(
        c_dim=25, img_resolution=G.img_resolution, img_channels=3,
        conv_clamp=256, generator=torch.Generator().manual_seed(0),
        **widths).to(device)
    loss = StyleGAN2Loss(G, D, LossConfig(
        r1_gamma=4.0, gpc_reg_prob=None, density_reg=0.25,
        neural_rendering_resolution_initial=64, blur_init_sigma=0.0,
        remat_synthesis=True))
    step = TrainStep(
        loss,
        make_optimizer(trainable_parameters(G), 0.0025, 0.0, 0.99, 1e-8,
                       reg_interval=4),
        make_optimizer(trainable_parameters(D, D.frozen_paths()), 0.002,
                       0.0, 0.99, 1e-8, reg_interval=16))
    G_ema = copy.deepcopy(G).eval().requires_grad_(False)
    sched, nrr = loss.schedules(0)
    R = G.img_resolution
    real = torch.from_numpy(np.random.RandomState(1).randn(
        batch, 3, R, R).astype(np.float32)).to(device)
    batch_d = dict(gen_z=z, gen_c=c, gen_v=v, real_c=c)
    generator = torch.Generator(device=device).manual_seed(2)

    def one_step(gz, do_greg, do_dreg):
        step.run_phases(G_ema, dict(batch_d, gen_z=gz), real, generator,
                        sched, nrr, do_greg=do_greg, do_dreg=do_dreg)
        _sync(device)

    def timed(do_greg, do_dreg, n=max(2, iters // 2)):
        tag = f'greg={int(do_greg)} dreg={int(do_dreg)}'
        staged = [z + i * 1e-6 for i in range(n)]
        warm = z + 99e-6
        t0 = time.perf_counter()
        one_step(z, do_greg, do_dreg)
        log(f'[train {tag}] first: {time.perf_counter() - t0:.1f}s')
        t0 = time.perf_counter()
        one_step(warm, do_greg, do_dreg)
        log(f'[train {tag}] warm-up: {time.perf_counter() - t0:.1f}s')
        ts = []
        for i, zi in enumerate(staged):
            t0 = time.perf_counter()
            one_step(zi, do_greg, do_dreg)
            ts.append(time.perf_counter() - t0)
            log(f'[train {tag}] step {i}: {ts[-1]:.3f}s')
        return sorted(ts)[len(ts) // 2]

    t_plain = timed(False, False)
    t_greg = timed(True, False)
    t_dreg = timed(False, True)
    t_avg = amortized_step(t_plain, t_greg, t_dreg)
    log(f'step seconds: plain {t_plain:.3f}, +Greg {t_greg:.3f}, '
        f'+Dreg(R1) {t_dreg:.3f}; schedule-amortized {t_avg:.3f}')
    return batch / t_avg


def _inputs(n, mesh, lms, device, seed=0):
    z = torch.from_numpy(np.random.RandomState(seed).randn(n, 512).astype(
        np.float32)).to(device)
    return (z, torch.from_numpy(camera_batch(n)).to(device),
            torch.from_numpy(verts_batch(n, mesh, lms)).to(device))


def run(mode='synthesis', batch=8, use_bf16=True, iters=10, sweep=False,
        fused=False, raster='auto', device='cuda', g_kwargs=None):
    """Measure ``mode`` on ``device`` and print the JSON line on stdout;
    returns its record. ``g_kwargs`` updates the generator's config
    (``G_KWARGS``)."""
    from .cli.common import float32_math
    if mode not in METRICS:
        raise ValueError(f'NEXT3D_BENCH_MODE: {mode!r} is not one of '
                         f'{sorted(METRICS)}')
    device = torch.device(device)
    mesh, lms = load_topology()
    kw = dict(G_KWARGS, **(g_kwargs or {}))
    G = build_generator(kw, mesh, device, use_bf16, fused, raster)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    z, c, v = _inputs(batch, mesh, lms, device)
    with float32_math():
        if mode == 'train':
            widths = {k: kw[k] for k in ('channel_base', 'channel_max')
                      if k in kw}
            value = _train_rate(G.train(), widths, (z, c, v), batch, iters,
                                device)
        else:
            G.eval().requires_grad_(False)
            with torch.no_grad():
                value = _forward_rates(G, mode, (z, c, v), batch, iters,
                                       sweep, use_bf16, mesh, lms, device)
    if device.type == 'cuda':
        log(f'peak device memory: '
            f'{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB')
    log(f'kernel launches: {json.dumps(launch_counts())}')
    record = {'metric': METRICS[mode], 'value': round(value, 3),
              'unit': 'img/s',
              'vs_baseline': round(value / A100_BASELINE_IMGS_PER_SEC, 3)}
    print(json.dumps(record), flush=True)
    return record


def _forward_rates(G, mode, inputs, batch, iters, sweep, use_bf16, mesh,
                   lms, device):
    z, c, v = inputs
    if mode == 'reenact':
        ws = G.mapping(z, c, truncation_psi=0.7, truncation_cutoff=14)
        textures, static = G.build_identity(ws, noise_mode='const')
        return _measure(lambda v_: G.synthesis_from_identity(
            ws, textures, static, c, v_, noise_mode='const')['image'],
            v, batch, iters, device)

    def forward(z, c, v):
        ws = G.mapping(z, c, truncation_psi=0.7, truncation_cutoff=14)
        return G.synthesis(ws, c, v, noise_mode='const')['image']

    value = _measure(lambda z_: forward(z_, c, v), z, batch, iters, device)
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        forward(z, c, v)
    per_image = counter.get_total_flops() / batch
    line = (f'model {per_image / 1e9:.1f} GFLOP/img (convolutions and '
            f'matmuls by FlopCounterMode; the hand-written kernels not '
            f'counted)')
    if device.type == 'cuda':
        peak = PEAK_FLOPS[use_bf16]
        line += (f'; MFU {100 * per_image * value / peak:.2f}% of the H100 '
                 f'{"bf16" if use_bf16 else "float32"} dense peak '
                 f'{peak / 1e12:.0f} TFLOP/s; card {card_line()}')
    log(line)
    if sweep:
        for b in (1, 8, 16, 32):
            zb, cb, vb = _inputs(b, mesh, lms, device, seed=1)
            try:
                r = _measure(lambda z_: forward(z_, cb, vb), zb, b,
                             max(4, iters // 2), device)
                log(f'batch {b:3d}: {r:.3f} img/s')
            except torch.cuda.OutOfMemoryError as e:
                log(f'batch {b:3d}: failed ({type(e).__name__})')
                torch.cuda.empty_cache()
    return value


def main():
    env = os.environ.get
    if not torch.cuda.is_available():
        raise RuntimeError('next3d_tpu_torch.bench measures a CUDA card, and '
                           'torch finds none')
    run(mode=env('NEXT3D_BENCH_MODE', 'synthesis'),
        batch=int(env('NEXT3D_BENCH_BATCH', '8')),
        use_bf16=env('NEXT3D_BENCH_BF16', '1') == '1',
        iters=int(env('NEXT3D_BENCH_ITERS', '10')),
        sweep=env('NEXT3D_BENCH_SWEEP', '0') == '1',
        fused=env('NEXT3D_BENCH_FUSED', '0') == '1',
        raster=env('NEXT3D_BENCH_RASTER', 'auto'),
        device='cuda')


if __name__ == '__main__':
    main()
