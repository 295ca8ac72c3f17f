"""GPU smoke run of the PyTorch/CUDA port (next3d_tpu_torch).

Usage, from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--profile]

Phases (any failure ends the run with a non-zero exit and no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the hand-written kernels from csrc/ (one nvcc per source, all
     started together, sm_90a);
  3. the rasterizer kernels on the head through the flagship's 4 views at
     256^2, N = 4 (16 images), each against its plain torch version on the
     card, bit for bit: K1 (binned, (u, v)), K2 (binned, zbuf; its
     pix_to_face equal to K1's), K3 (16-px tiles; equal to K1), K5 (per-face
     z-buffer, patch 32; its pixels that differ from K1's are logged). The
     binned kernels' CUDA prep is held against the torch prep (the same
     segment starts, and the same entries in each segment, rows bit-equal)
     and timed alone beside it and beside the resolve kernel;
  4. K4, tri-plane sampling, against its plain version: planes
     (4, 3, 32, 256, 256) at the coarse-pass points of the FFHQ camera,
     with the channels-last layout pass timed alone;
  5. K6, the 8-row block gather, at (98304, 128) with 131072 indices, in
     bf16 and f32, bit for bit;
  6. the 512^2 FFHQ forward (mapping + synthesis, port-native random init)
     at batch 1 and 4, with the kernels' launch counters;
  7. synthesis_from_identity over 3 frames with the identity cached;
  8. median img/s at batch 1 and 4;
  9. the texture variant (TriPlaneTextureGenerator) on the same config:
     forward at batch 1 and 4, K2's launches, median img/s;
 10. the flagship at batch 4 with rasterizer_impl 'pallas_binned16' (K3;
     images equal to phase 6's) and 'pallas' (K5; image within 1e-4
     mean-abs of phase 6's);
 11. with --profile only, for the flagship (after phase 8) and the texture
     variant (in phase 9): the forward's stages in ms at batch 1 and 4, and
     the device-busy share of 3 forwards from torch.profiler.

Every kernel is timed by CUDA events beside its plain version and, where
one PyTorch call computes the same function, that call (library_ms); the
binned kernels also carry their CUDA prep's time alone (prep_ms) and K4 the
channels-last layout pass's (layout_ms, one pass serves a forward's 2
launches). Its bound is the larger of its bytes (inputs read once, outputs
written once) over 3.35 TB/s and its float32 operations on this run's data
over 67 TFLOP/s, the H100 SXM's published peaks.

The head is the mesh that NEXT3D_TOPOLOGY names (an .obj with UVs and a
``<name>_kpt2d.txt`` landmark file beside it) when that file exists, else
the in-repo synthetic head. The run uses no JAX. Its last two lines are a
JSON object with one entry per kernel and the result line
{"ok": true, "device": {...}}.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

SEED = 0
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
CSRC = 'next3d_tpu_torch/csrc/'
LIBRARIES = ('raster_binned_uv', 'raster_binned_prep', 'triplane_sample',
             'raster_zbuffer', 'gather_row_blocks')
PEAK_BYTES_S = 3.35e12    # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12   # H100 SXM float32 outside the tensor cores
# float32 operations a (pixel, candidate) pair needs in the binned kernels:
# three edge planes, c + x*gx + y*gy each
OPS_BINNED_PAIR = 12
# ... and a (face, pixel) test in K5: three edge functions with the face's
# differences hoisted (2 sub, 2 mul, 1 sub each), 3 barycentric scalings and
# the depth (3 mul, 2 add)
OPS_ZBUFFER_TEST = 23


def log(*args):
    print(*args, flush=True)


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps=10, warmup=2):
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=10):
    """Mean device time of ``fn()`` in ms: the summed durations of the
    kernels and memsets it ran, from a torch.profiler trace of ``reps``
    calls (time the device spent idle between them is left out)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / reps / 1e3


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, n_ops):
    """The least time of the work on the card, and what sets it."""
    by_bytes = n_bytes / PEAK_BYTES_S * 1e3
    by_ops = n_ops / PEAK_F32_FLOP_S * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by='bytes' if by_bytes >= by_ops else 'operations')


def load_head():
    from next3d_tpu_torch.utils.obj_io import load_lms, load_obj
    from next3d_tpu_torch.utils.synthetic_head import synthetic_head
    path = os.environ.get('NEXT3D_TOPOLOGY')
    if path and os.path.exists(path):
        log(f'head: {path}')
        return load_obj(path), load_lms(os.path.splitext(path)[0]
                                        + '_kpt2d.txt')
    log('head: in-repo synthetic head (next3d_tpu_torch/utils/'
        'synthetic_head.py)')
    return synthetic_head()


def head_batch(mesh, lms, n, device, jitter=0.002):
    """(n, 5023 + 68, 3): the neutral head, then jittered expressions."""
    import numpy as np
    v = np.concatenate([mesh.verts, lms])[None].astype(np.float32)
    rs = np.random.RandomState(SEED)
    noise = rs.randn(n, *v.shape[1:]).astype(np.float32) * jitter
    noise[0] = 0
    return torch.from_numpy(v + noise).to(device)


def ffhq_camera(n, device):
    from next3d_tpu_torch.render.camera_utils import (fov_to_intrinsics,
                                                      lookat_pose)
    cam = lookat_pose(math.pi / 2, math.pi / 2, [0, 0, 0.2], radius=2.7,
                      batch_size=n, device=device)
    K = torch.from_numpy(fov_to_intrinsics(18.837)).to(device)
    return torch.cat([cam.reshape(n, 16), K.reshape(1, 9).expand(n, 9)], 1)


def binned_pairs(verts, faces, attrs, image_size, tile):
    """(pixel, candidate) pairs the binned resolve tests for these inputs."""
    from next3d_tpu_torch.ops.raster import binned_prep
    _, starts = binned_prep(verts, faces, attrs, image_size, tile)
    return int((starts[:, -1] - starts[:, 0]).sum()) * tile * tile


def zbuffer_tests(verts, faces, image_size, patch):
    """(face, pixel) pairs K5 needs for these inputs: each kept face's
    bbox pixels inside the image and inside its stripe."""
    from next3d_tpu_torch.ops.raster_zbuffer import zbuffer_prep
    data, y0, stripe_h = zbuffer_prep(verts, faces, image_size, patch)
    x, y = data[:, 0:3], data[:, 3:6]
    cols = (torch.floor(x.amax(1)).clamp(max=image_size - 1)
            - torch.ceil(x.amin(1)).clamp(min=0) + 1).clamp(min=0)
    rows = (torch.minimum(torch.floor(y.amax(1)), y0 + stripe_h - 1.0)
            - torch.maximum(torch.ceil(y.amin(1)), y0.float()) + 1
            ).clamp(min=0)
    return int((cols * rows * (data[:, 9] > 0)).sum())


def check_rasterizers(G, v):
    """Phase 3: K1, K2, K3 and K5 on the flagship's 16-image rasterizer
    input, each bit for bit against its plain version."""
    from next3d_tpu_torch.ops import raster, raster_zbuffer
    tv, _ = G.project_views(v[:, :5023], v[:, 5023:])
    tv = tv.contiguous()
    res = G.uv_resolution
    uv_args = (tv, G.faces, G.face_uv[None], res)
    in_bytes = nbytes(tv, G.faces)
    out_img = tv.shape[0] * res * res * 4
    results = {}

    def record(name, got, want, fn, plain, n_bytes, n_ops, reps=3):
        torch.cuda.synchronize()
        mismatch = [int((a != b).sum()) for a, b in zip(got, want)]
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got[1:], want[1:]))
        ms = time_ms(fn)
        plain_ms = time_ms(plain, reps=reps, warmup=1)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=None, **bound(n_bytes, n_ops))
        log(f'{name}: {tuple(tv.shape[:1])} images at {res}^2: mismatching '
            f'elements {mismatch}, max-abs {err:.3g}; wrapper {ms:.3f} ms, '
            f'plain {plain_ms:.3f} ms, bound {results[name]["bound_ms"]:.4f}'
            f' ms by {results[name]["bound_by"]}')
        if any(mismatch):
            raise RuntimeError(f'{name} disagrees with its plain version')

    def check_prep(name, args, tile, counted):
        """The CUDA prep against the torch prep, then each timed alone
        beside the resolve kernel; returns the CUDA prep's ms."""
        slab, starts = raster.binned_prep_cuda(*args, tile)
        want_slab, want_starts = raster.binned_prep(*args, tile)
        torch.cuda.synchronize()
        same_starts = torch.equal(starts, want_starts)
        same_rows = same_starts and all(
            torch.equal(a, b[:, :a.shape[1]]) for a, b in zip(
                raster.segments_in_face_order(slab, starts), want_slab))
        prep_ms = time_ms(lambda: raster.binned_prep_cuda(*args, tile))
        torch_ms = time_ms(lambda: raster.binned_prep(*args, tile))
        resolve_ms = time_ms(lambda: raster._resolve_cuda(
            slab, starts, res, tile, counted))
        prep_device_ms = device_ms(lambda: raster.binned_prep_cuda(*args,
                                                                   tile))
        occupancy = int((starts[:, 1:] - starts[:, :-1]).max())
        log(f'{name} prep: starts equal {same_starts}, segments equal '
            f'{same_rows}, {int(starts[:, -1].sum())} entries, max tile '
            f'segment {occupancy}; CUDA prep {prep_ms:.3f} ms '
            f'({prep_device_ms:.3f} ms of it on the device), torch prep '
            f'{torch_ms:.3f} ms, resolve kernel {resolve_ms:.3f} ms')
        if not same_rows:
            raise RuntimeError(f'{name} CUDA prep disagrees with the torch '
                               f'prep')
        return prep_ms

    k1 = raster.rasterize_binned_uv(*uv_args)
    k1_plain = raster.rasterize_binned_uv_plain(*uv_args)
    log(f'K1 coverage {float((k1[0] >= 0).float().mean()):.3f}')
    record('K1', k1, k1_plain, lambda: raster.rasterize_binned_uv(*uv_args),
           lambda: raster.rasterize_binned_uv_plain(*uv_args),
           in_bytes + nbytes(G.face_uv) + 3 * out_img,
           OPS_BINNED_PAIR * binned_pairs(*uv_args, raster.TILE))
    results['K1']['prep_ms'] = check_prep('K1', uv_args, raster.TILE,
                                          raster.rasterize_binned_uv)

    k2 = raster.rasterize_binned(tv, G.faces, res)
    record('K2', k2, raster.rasterize_binned_plain(tv, G.faces, res),
           lambda: raster.rasterize_binned(tv, G.faces, res),
           lambda: raster.rasterize_binned_plain(tv, G.faces, res),
           in_bytes + 2 * out_img,
           OPS_BINNED_PAIR * binned_pairs(tv, G.faces, None, res, raster.TILE))
    results['K2']['prep_ms'] = check_prep('K2', (tv, G.faces, None, res),
                                          raster.TILE,
                                          raster.rasterize_binned)
    if not torch.equal(k2[0], k1[0]):
        raise RuntimeError('K2 pix_to_face differs from K1')

    k3 = raster.rasterize_binned_uv16(*uv_args)
    record('K3', k3, raster.rasterize_binned_uv16_plain(*uv_args),
           lambda: raster.rasterize_binned_uv16(*uv_args),
           lambda: raster.rasterize_binned_uv16_plain(*uv_args),
           in_bytes + nbytes(G.face_uv) + 3 * out_img,
           OPS_BINNED_PAIR * binned_pairs(*uv_args, raster.TILE16))
    results['K3']['prep_ms'] = check_prep('K3', uv_args, raster.TILE16,
                                          raster.rasterize_binned_uv16)
    if not all(torch.equal(a, b) for a, b in zip(k3, k1)):
        raise RuntimeError('K3 differs from K1')

    zb_args = (tv, G.faces, res, 32)
    k5 = raster_zbuffer.rasterize_zbuffer(*zb_args)
    record('K5', k5, raster_zbuffer.rasterize_zbuffer_plain(*zb_args),
           lambda: raster_zbuffer.rasterize_zbuffer(*zb_args),
           lambda: raster_zbuffer.rasterize_zbuffer_plain(*zb_args),
           in_bytes + 2 * out_img,
           OPS_ZBUFFER_TEST * zbuffer_tests(*zb_args))
    log(f'K5 (patch 32) vs K1: {int((k5[0] != k1[0]).sum())} of '
        f'{k1[0].numel()} pixels differ in pix_to_face, coverage on '
        f'{int(((k5[0] >= 0) != (k1[0] >= 0)).sum())}')
    return results


def check_k4(device):
    import torch.nn.functional as F
    from next3d_tpu_torch.ops.triplane import (channels_last,
                                               project_onto_planes,
                                               triplane_sample,
                                               triplane_sample_plain)
    from next3d_tpu_torch.render.ray_sampler import sample_rays
    from next3d_tpu_torch.render.renderer import sample_stratified
    g = torch.Generator(device=device).manual_seed(SEED)
    raw = torch.randn(4, 3, 32, 256, 256, generator=g, device=device)
    planes = channels_last(raw)
    c = ffhq_camera(4, device)
    ro, rd = sample_rays(c[:, :16].reshape(-1, 4, 4),
                         c[:, 16:25].reshape(-1, 3, 3), 64)
    depths = sample_stratified(None, ro, 2.25, 3.3, 48)
    coords = (ro[:, :, None] + depths * rd[:, :, None]).reshape(4, -1, 3)
    got = triplane_sample(planes, coords, 1.0)
    want = triplane_sample_plain(planes, coords, 1.0)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ms = time_ms(lambda: triplane_sample(planes, coords, 1.0))
    plain_ms = time_ms(lambda: triplane_sample_plain(planes, coords, 1.0))
    layout_ms = time_ms(lambda: channels_last(raw))
    # the one PyTorch call for the same sampling: F.grid_sample on the
    # channels-first planes at the projected points
    feats = raw.reshape(12, 32, 256, 256)
    grid = project_onto_planes(2.0 * coords)[:, None]   # box_warp 1
    library_ms = time_ms(lambda: F.grid_sample(
        feats, grid, mode='bilinear', padding_mode='zeros',
        align_corners=False))
    M = coords.shape[1]
    # 4 taps of 32 channels, a multiply and an add each, per point and plane
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, layout_ms=layout_ms,
               **bound(nbytes(planes, coords, got), 12 * M * 32 * 8))
    log(f'K4 planes (4, 3, 32, 256, 256), {M} points: max-abs {err:.3g}; '
        f'kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, F.grid_sample '
        f'{library_ms:.3f} ms, channels-last layout {layout_ms:.3f} ms, '
        f'bound {out["bound_ms"]:.4f} ms by {out["bound_by"]}')
    if not err <= 1e-5:
        raise RuntimeError('K4 disagrees with its plain version')
    return out


def check_k6(device):
    """Phase 5: the gather at the shape of the TPU kernel's measurement,
    in bf16 and f32; the entry for the kernels line is bf16's."""
    from next3d_tpu_torch.ops.dma_gather import (gather_row_blocks,
                                                 gather_row_blocks_plain)
    g = torch.Generator(device=device).manual_seed(SEED)
    idx = torch.randint(0, 98304, (131072,), generator=g, device=device,
                        dtype=torch.int32)
    tables = {dt: torch.randn(98304, 128, generator=g, device=device).to(dt)
              for dt in (torch.bfloat16, torch.float32)}
    gather_row_blocks.launches = 0
    outs = {dt: gather_row_blocks(t, idx) for dt, t in tables.items()}
    torch.cuda.synchronize()
    launches = gather_row_blocks.launches
    results = {}
    for dt, table in tables.items():
        want = gather_row_blocks_plain(table, idx)
        err = float((outs[dt].float() - want.float()).abs().max())
        if not torch.equal(outs[dt], want):
            raise RuntimeError(f'K6 {dt} disagrees with its plain version')
        blocks, blk = table.view(-1, 8, 128), idx // 8
        results[dt] = dict(
            max_abs_err=err, ms=time_ms(lambda: gather_row_blocks(table, idx)),
            plain_ms=time_ms(lambda: gather_row_blocks_plain(table, idx)),
            library_ms=time_ms(lambda: blocks.index_select(0, blk)),
            **bound(nbytes(table, idx, want), 0))
        r = results[dt]
        log(f'K6 {dt} table (98304, 128), 131072 indices: exact; kernel '
            f'{r["ms"]:.3f} ms, plain {r["plain_ms"]:.3f} ms, index_select '
            f'{r["library_ms"]:.3f} ms, bound {r["bound_ms"]:.4f} ms by '
            f'{r["bound_by"]}')
    return results[torch.bfloat16], launches


def check_outputs(out, n):
    for key, shape in (('image', (n, 3, 512, 512)),
                       ('image_raw', (n, 3, 64, 64)),
                       ('image_depth', (n, 1, 64, 64))):
        x = out[key]
        if tuple(x.shape) != shape or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f'{key}: shape {tuple(x.shape)} or non-finite')
    # the composite depth is clamped to the sample range, whose last
    # stratified sample lies half a bin (midpoint jitter) past ray_end
    lo, hi = RENDER_KW_FFHQ['ray_start'], RENDER_KW_FFHQ['ray_end']
    hi += (hi - lo) / (RENDER_KW_FFHQ['depth_resolution'] - 1) / 2
    d = out['image_depth']
    if not (float(d.min()) >= lo and float(d.max()) <= hi):
        raise RuntimeError(f'depth [{float(d.min())}, {float(d.max())}] '
                           f'outside [{lo}, {hi}]')


def median_ms(fn, reps=5):
    """Median synchronized wall time of ``fn()`` in ms, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def throughput(name, forward, card):
    """Median img/s of ``forward(n)`` at batch 1 and 4: 2 warm-ups, then 5
    forwards, each ended by a synchronize."""
    for n in (1, 4):
        for _ in range(2):
            forward(n)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(n)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        log(f'{name} batch {n}: median {n / statistics.median(times):.3f} '
            f'img/s (forward ms {[round(t * 1e3, 2) for t in times]}) '
            f'on {card}')


def counted(fn, kernels):
    """Run ``fn()`` with the launch counters of ``kernels`` (a dict name ->
    wrapper) set to 0 just before; returns its result and the counts."""
    for wrapper in kernels.values():
        wrapper.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: w.launches for name, w in kernels.items()}


def flagship_stages(G, forward, z, c, v):
    """The flagship forward's stages, each a call on the forward's own
    inputs."""
    from next3d_tpu_torch.ops import raster
    verts, lms = G._split_v(v)
    ws = G.mapping(z, c, truncation_psi=0.7, truncation_cutoff=14)
    n_tex = G.texture_backbone.num_ws
    eg3d_ws = ws[:, :n_tex]
    textures, static = G.build_identity(ws, noise_mode='const')
    images, _, lm2d = G.rasterize(verts, lms, textures)
    tv, _ = G.project_views(verts, lms)
    args = (tv.contiguous(), G.faces, G.face_uv[None], G.uv_resolution)
    slab, starts = raster.binned_prep_cuda(*args)
    res, tile = G.uv_resolution, raster.TILE
    planes = G.mix_planes_from_identity(eg3d_ws, textures, static, verts,
                                        lms, noise_mode='const')
    stages = {
        'whole forward': forward,
        'mapping': lambda: G.mapping(z, c, truncation_psi=0.7,
                                     truncation_cutoff=14),
        'texture backbone': lambda: G.texture_backbone.synthesis(
            ws[:, n_tex:], noise_mode='const'),
        'static backbone': lambda: G.backbone.synthesis(
            ws[:, :n_tex], noise_mode='const'),
        'rasterize (K1 + texture sample + fill_mouth)': lambda: G.rasterize(
            verts, lms, textures),
        '- K1 CUDA prep': lambda: raster.binned_prep_cuda(*args),
        '- K1 resolve kernel': lambda: raster._resolve_cuda(
            slab, starts, res, tile, raster.rasterize_binned_uv),
        '- K1 resolve plain': lambda: raster._resolve_plain(slab, starts,
                                                            res, tile),
        'mouth + blend StyleUNets': lambda: G._mouth_pipeline(
            images[0], lm2d, eg3d_ws, 'const', None),
        'render + SR': lambda: G._render_from_planes(
            planes, eg3d_ws, c, None, 'const', None)}
    return stages


def texture_stages(T, forward, z, c, v):
    """The texture variant's forward stages."""
    from next3d_tpu_torch.ops.raster import rasterize_binned
    from next3d_tpu_torch.render.rasterizer import \
        interpolate_face_attributes
    ws = T.mapping(z, c, truncation_psi=0.7, truncation_cutoff=14)
    n_tex = T.texture_backbone.num_ws
    eg3d_ws = ws[:, :n_tex]
    textures, static = T.build_identity(ws, noise_mode='const')
    planes = T.mix_planes_from_identity(eg3d_ws, textures, static, v, None)
    tv = T.project_orth(v)
    res = T.uv_resolution
    pf, _ = rasterize_binned(tv, T.faces, res)
    return {
        'whole forward': forward,
        'mapping': lambda: T.mapping(z, c, truncation_psi=0.7,
                                     truncation_cutoff=14),
        'texture backbone': lambda: T.texture_backbone.synthesis(
            ws[:, n_tex:], noise_mode='const'),
        'static backbone': lambda: T.backbone.synthesis(
            ws[:, :n_tex], noise_mode='const'),
        'rasterize_orth (K2 + interpolation + texture sample)':
            lambda: T.rasterize_orth(v, textures),
        '- K2 (CUDA prep + kernel)': lambda: rasterize_binned(tv, T.faces,
                                                              res),
        '- interpolate_face_attributes': lambda: interpolate_face_attributes(
            tv, T.faces, T.face_uvcoords[None], pf, res),
        'render + SR': lambda: T._render_from_planes(
            planes, eg3d_ws, c, None, 'const', None)}


def profile_stages(name, stages, forward, n):
    """Phase 11: the forward split into its stages (each timed alone on the
    same inputs), and the share of wall time in which a kernel ran."""
    for stage, fn in stages.items():
        log(f'{name} stage batch {n}: {stage}: {median_ms(fn):.3f} ms')

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            forward()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for lo, hi in spans:             # the union of the kernels' intervals
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    busy /= 1e3
    log(f'{name} profile batch {n}, 3 forwards: wall {wall:.1f} ms, device '
        f'busy {busy:.1f} ms ({100 * busy / wall:.0f}%), {len(spans)} kernels')
    log(prof.key_averages().table(sort_by='self_cuda_time_total',
                                  row_limit=12, max_name_column_width=60))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--profile', action='store_true',
                        help='add phase 11, the per-stage profile')
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    card = card_line()
    log(f'card: {card}')
    log(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}')
    # fp32 parity mode: the JAX package runs float32 at Precision.HIGHEST;
    # cuDNN convolutions would otherwise run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from next3d_tpu_torch.models.triplane_next3d import TriPlaneGenerator
    from next3d_tpu_torch.models.triplane_texture import \
        TriPlaneTextureGenerator
    from next3d_tpu_torch.ops import (cuda_build, dma_gather, raster,
                                      raster_zbuffer, triplane)

    t0 = time.time()
    for so in cuda_build.build_all(LIBRARIES):
        log(f'built {so.name}; nvcc says:\n'
            + so.with_suffix('.log').read_text().strip())
    log(f'kernel build {time.time() - t0:.1f} s')

    mesh, lms = load_head()

    def build(cls, **kw):
        t0 = time.time()
        G = cls(z_dim=512, c_dim=25, w_dim=512, img_resolution=512,
                img_channels=3, topology_path=mesh,
                rendering_kwargs=RENDER_KW_FFHQ, sr_num_fp16_res=4,
                generator=torch.Generator().manual_seed(SEED), **kw)
        G = G.to(device).eval()
        log(f'{cls.__name__} {kw}: '
            f'{sum(p.numel() for p in G.parameters())} parameters, built in '
            f'{time.time() - t0:.1f} s')
        return G

    G = build(TriPlaneGenerator)
    kernels = {'K1': raster.rasterize_binned_uv,
               'K2': raster.rasterize_binned,
               'K3': raster.rasterize_binned_uv16,
               'K4': triplane.triplane_sample,
               'K5': raster_zbuffer.rasterize_zbuffer,
               'K6': dma_gather.gather_row_blocks}
    launches = {}

    with torch.no_grad():
        stats = check_rasterizers(G, head_batch(mesh, lms, 4, device))
        stats['K4'] = check_k4(device)
        stats['K6'], launches['K6'] = check_k6(device)

        g = torch.Generator(device=device).manual_seed(SEED)
        z = {n: torch.randn(n, 512, generator=g, device=device)
             for n in (1, 4)}
        c = {n: ffhq_camera(n, device) for n in (1, 4)}
        v = {n: head_batch(mesh, lms, n, device) for n in (1, 4)}

        def forward_of(model, flame_only=False):
            def forward(n):
                vn = v[n][:, :5023] if flame_only else v[n]
                return model(z[n], c[n], vn, truncation_psi=0.7,
                             truncation_cutoff=14, noise_mode='const')
            return forward

        forward = forward_of(G)
        outs, counts = counted(lambda: {n: forward(n) for n in (1, 4)},
                               kernels)
        for n, out in outs.items():
            check_outputs(out, n)
        log(f'512^2 forward at batch 1 and 4: finite, depth in the sample '
            f'range; launches {counts}')
        launches.update(K1=counts['K1'], K4=counts['K4'])
        if min(launches.values()) <= 0:
            raise RuntimeError('a kernel of the main path never launched')

        ws = G.mapping(z[1], c[1], truncation_psi=0.7, truncation_cutoff=14)
        textures, static = G.build_identity(ws, noise_mode='const')
        frames = head_batch(mesh, lms, 3, device, jitter=0.003)
        for f in range(3):
            out = G.synthesis_from_identity(ws, textures, static, c[1],
                                            frames[f:f + 1],
                                            noise_mode='const')
            check_outputs(out, 1)
            if f == 0:
                err = max(float((out[k] - outs[1][k]).abs().max())
                          for k in out)
                log(f'synthesis_from_identity frame 0 vs synthesis: '
                    f'max-abs {err:.3g}')
                if not err <= 1e-4:
                    raise RuntimeError('identity-cached synthesis disagrees')

        throughput('flagship', forward, card)
        if opts.profile:
            for n in (1, 4):
                profile_stages('flagship', flagship_stages(
                    G, lambda: forward(n), z[n], c[n], v[n]),
                    lambda: forward(n), n)

        T = build(TriPlaneTextureGenerator)
        forward_t = forward_of(T, flame_only=True)
        outs_t, counts = counted(lambda: {n: forward_t(n) for n in (1, 4)},
                                 kernels)
        for n, out in outs_t.items():
            check_outputs(out, n)
        log(f'texture variant 512^2 forward at batch 1 and 4: finite, depth '
            f'in the sample range; launches {counts}')
        launches['K2'] = counts['K2']
        if counts['K2'] <= 0:
            raise RuntimeError('the texture variant never launched K2')
        throughput('texture variant', forward_t, card)
        if opts.profile:
            for n in (1, 4):
                profile_stages('texture variant', texture_stages(
                    T, lambda: forward_t(n), z[n], c[n], v[n][:, :5023]),
                    lambda: forward_t(n), n)
        del T, outs_t

        # the default forward is not bit-reproducible on the card (cuDNN's
        # transposed convolutions may accumulate with atomics), so this
        # phase compares under cuDNN's deterministic algorithms, with the
        # default forward's own run-to-run spread beside it
        torch.backends.cudnn.deterministic = True
        ref = forward(4)
        spread = max(float((forward(4)[k] - ref[k]).abs().max()) for k in ref)
        verts, lms = G._split_v(v[4])
        tex4, _ = G.build_identity(G.mapping(
            z[4], c[4], truncation_psi=0.7, truncation_cutoff=14),
            noise_mode='const')
        ref_raster = G.rasterize(verts, lms, tex4)
        log(f'default forward at batch 4, deterministic cuDNN: run-to-run '
            f'max-abs {spread:.3g}')
        for impl, name in (('pallas_binned16', 'K3'), ('pallas', 'K5')):
            Gi = build(TriPlaneGenerator, rasterizer_impl=impl)
            Gi.load_state_dict(G.state_dict())
            out, counts = counted(lambda: forward_of(Gi)(4), kernels)
            launches[name] = counts[name]
            check_outputs(out, 4)
            diff = (out['image'] - ref['image']).abs()
            log(f"flagship rasterizer_impl='{impl}' at batch 4: launches "
                f"{counts}; image vs the default: max-abs "
                f"{float(diff.max()):.3g}, mean-abs {float(diff.mean()):.3g}")
            if counts[name] <= 0:
                raise RuntimeError(f'{impl} never launched {name}')
            if impl == 'pallas_binned16':
                # the stage the impl changes is bit-equal, and so is the
                # forward wherever the default forward reproduces itself
                images, alphas, _ = Gi.rasterize(verts, lms, tex4)
                same = all(torch.equal(a, b) for a, b in zip(
                    images + alphas, ref_raster[0] + ref_raster[1]))
                bit_equal = all(torch.equal(out[k], ref[k]) for k in out)
                log(f'pallas_binned16: rasterize stage bit-equal {same}, '
                    f'forward bit-equal {bit_equal}')
                if not same or not (bit_equal or spread > 0):
                    raise RuntimeError('pallas_binned16 changed the forward')
            elif not float(diff.mean()) <= 1e-4:
                raise RuntimeError('pallas moved the image too far')
            del Gi
        torch.backends.cudnn.deterministic = False

    names = {
        'K1': ('rasterize_binned_uv', 'raster_binned_uv.cu',
               'next3d_tpu/ops/pallas_raster.py:489'),
        'K2': ('rasterize_binned', 'raster_binned_uv.cu',
               'next3d_tpu/ops/pallas_raster.py:799'),
        'K3': ('rasterize_binned_uv16', 'raster_binned_uv.cu',
               'next3d_tpu/ops/pallas_raster.py:744'),
        'K4': ('triplane_sample', 'triplane_sample.cu',
               'next3d_tpu/ops/pallas_triplane.py:177'),
        'K5': ('rasterize_zbuffer', 'raster_zbuffer.cu',
               'next3d_tpu/ops/pallas_raster.py:101'),
        'K6': ('gather_row_blocks', 'gather_row_blocks.cu',
               'next3d_tpu/ops/pallas_dma_gather.py:93')}
    line = [dict(name=f'{k} {fn}', route='cuda', source=CSRC + src,
                 replaces=replaces, launches=launches[k], **stats[k])
            for k, (fn, src, replaces) in names.items()]
    log(card)
    log(json.dumps({'kernels': line}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
