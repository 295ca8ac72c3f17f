"""Generate images, and optionally shape volumes, from a snapshot.

Counterpart of next3d_tpu/cli/gen_samples.py (reference:
gen_samples_next3d.py:120-254): per seed, 3 yaw angles conditioned on the
frontal pose, concatenated side by side into ``seed<NNNN>.png``; with
``shapes``, the sigma grid of ``shape_res``^3 points to ``.mrc`` or to a
marching-tetrahedra ``.ply``.

The tri-planes are built once per seed; the 3 views are rendered from them,
and the sigma grid is decoded from them in chunks of at most ``max_batch``
points a card, each chunk split over every visible card for ``--device
cuda`` (the JAX command shards it over every local device), each card's
part one launch of kernel K4.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..ops.triplane import C_KERNEL
from ..parallel.dist import local_devices, replicas, split_over_devices
from .common import (DEMO_LMS, DEMO_OBJ, camera_label, inference,
                     load_demo_verts, load_generator, save_image_grid,
                     synchronize)

# K4 indexes its (1, 3, M, 32) output in 32 bits
MAX_CHUNK = (2 ** 31 - 1) // (3 * C_KERNEL)


def generate_images(network_path, seeds, truncation_psi=0.7,
                    truncation_cutoff=14, outdir='out', shapes=False,
                    shape_res=512, fov_deg=18.837, obj_path=DEMO_OBJ,
                    lms_path=DEMO_LMS, shape_format='.mrc', max_batch=1000000,
                    topology_path=None, generator=None, device='cuda'):
    """Write the images (and shapes) of ``seeds``. ``generator`` replaces
    the snapshot at ``network_path``. Returns the timings: seconds a seed
    (its images and shape, writes included) and, with ``shapes``, the sigma
    grid's seconds a seed and its points."""
    os.makedirs(outdir, exist_ok=True)
    with inference():
        G = generator if generator is not None else load_generator(
            network_path, topology_path or obj_path, device)
        devices = local_devices(device)
        device = G.orth_scale.device
        v = torch.from_numpy(load_demo_verts(obj_path, lms_path)).to(device)
        cond_c = torch.from_numpy(camera_label(0, 0, fov=fov_deg)).to(device)
        angles = [(0.4, 0), (0, 0), (-0.4, 0)]  # reference :188
        stats = dict(seconds_per_seed=[], sigma_seconds=[], sigma_points=0)
        for seed in seeds:
            synchronize(device)
            t0 = time.perf_counter()
            z = torch.from_numpy(np.random.RandomState(seed).randn(
                1, G.z_dim).astype(np.float32)).to(device)
            ws = G.mapping(z, cond_c, truncation_psi=truncation_psi,
                           truncation_cutoff=truncation_cutoff)
            planes, eg3d_ws = G.build_planes(ws, v, noise_mode='const')
            imgs = []
            for yaw, pitch in angles:
                c = torch.from_numpy(camera_label(yaw, pitch,
                                                  fov=fov_deg)).to(device)
                imgs.append(G._render_from_planes(
                    planes, eg3d_ws, c, None, 'const', None)['image'])
            row = torch.cat(imgs, dim=3).cpu().numpy()  # along the width
            path = os.path.join(outdir, f'seed{seed:04d}.png')
            save_image_grid(row, path)
            print(f'wrote {path}', flush=True)

            if shapes:
                stats['sigma_seconds'].append(extract_shape(
                    G, planes, shape_res, max_batch,
                    os.path.join(outdir, f'seed{seed:04d}{shape_format}'),
                    devices))
                stats['sigma_points'] = shape_res ** 3
            stats['seconds_per_seed'].append(time.perf_counter() - t0)
    return stats


def extract_shape(G, planes, shape_res, max_batch, out_path, devices=None):
    """The sigma of ``planes`` at the ``shape_res``^3 grid of
    ``create_samples``, decoded in chunks of at most ``max_batch`` points a
    device (and of K4's 32-bit limit), each chunk split over ``devices``
    (default: the planes' device alone; ``G`` and ``planes`` on the
    first), its border padded to -1000 (reference :232-239), to
    ``out_path`` (.mrc, else a .ply isosurface at level 10). Returns the
    seconds the grid took, its copy to the host included."""
    from ..render.shape_utils import (create_samples, save_mrc,
                                      save_ply_from_sigma)
    device = planes.device
    devices = devices or [device]
    Gs, planes_on = replicas(G, devices), [planes] + [
        planes.to(d) for d in devices[1:]]
    for d in devices:
        synchronize(d)
    t0 = time.perf_counter()
    samples, _, _ = create_samples(
        N=shape_res, cube_length=G.rendering_kwargs['box_warp'] * 1)
    total = samples.shape[0]
    chunk = max(1, min(max_batch, total, MAX_CHUNK)) * len(devices)

    def decode(i, coords):
        return Gs[i].sample_with_planes(planes_on[i], coords[None],
                                        coords[None])['sigma'][0, :, 0]

    sigmas = torch.empty(total, dtype=torch.float32, device=device)
    for lo in range(0, total, chunk):
        coords = torch.from_numpy(samples[lo:lo + chunk]).to(device)
        sigmas[lo:lo + chunk] = split_over_devices(decode, [coords],
                                                   devices)
    sigmas = sigmas.cpu().numpy().reshape(shape_res, shape_res, shape_res)
    seconds = time.perf_counter() - t0

    pad = int(30 * shape_res / 256)
    pv = -1000.0
    sigmas[:pad] = pv
    sigmas[-pad:] = pv
    sigmas[:, :pad] = pv
    sigmas[:, -pad:] = pv
    sigmas[:, :, :pad] = pv
    sigmas[:, :, -pad:] = pv

    if out_path.endswith('.mrc'):
        save_mrc(out_path, sigmas)
    else:
        save_ply_from_sigma(out_path, sigmas, level=10.0)
    print(f'wrote {out_path}', flush=True)
    return seconds
