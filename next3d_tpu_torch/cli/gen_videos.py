"""Orbit-interpolation videos from a snapshot.

Counterpart of next3d_tpu/cli/gen_videos.py (reference:
gen_videos_next3d.py:88-336): a grid of seeds, their w latents cubic-
interpolated from keyframe to keyframe, under a camera orbiting the frontal
pose (yaw +-0.35, pitch +-0.25), written to ``interpolation.mp4`` (or its
PNG-frame directory).

All grid cells render in one batched call a frame. With one keyframe a
cell (as many seeds as cells) w is the same in every frame, so the cells'
identities (neural texture and static tri-plane) are built once and each
frame runs ``synthesis_from_identity``; otherwise each frame's
interpolated w goes through the whole synthesis.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from .common import (DEMO_LMS, DEMO_OBJ, camera_label, frame_uint8,
                     inference, load_demo_verts, load_generator,
                     synchronize)


def generate_video(network_path, seeds, truncation_psi=0.7,
                   truncation_cutoff=14, grid='2x2', outdir='out',
                   w_frames=120, fps=60, obj_path=DEMO_OBJ,
                   lms_path=DEMO_LMS, generator=None, device='cuda'):
    """Write the video. ``generator`` replaces the snapshot at
    ``network_path``. Returns its frames and the seconds from the start of
    the first frame to the end of the last, writes included."""
    from scipy import interpolate as sinterp
    from ..utils.video import VideoWriter

    os.makedirs(outdir, exist_ok=True)
    gw, gh = (int(x) for x in grid.split('x'))
    seeds = list(seeds)
    if len(seeds) < gw * gh:
        seeds = (seeds * (gw * gh))[:gw * gh]

    with inference():
        G = generator if generator is not None else load_generator(
            network_path, obj_path, device)
        device = G.orth_scale.device
        v = load_demo_verts(obj_path, lms_path)
        cond_c = camera_label(0, 0)

        # keyframe ws per seed (cubic loop interpolation, reference :105-117)
        zs = np.stack([np.random.RandomState(s).randn(G.z_dim)
                       for s in seeds])
        ws = G.mapping(torch.from_numpy(zs.astype(np.float32)).to(device),
                       torch.from_numpy(np.repeat(cond_c, len(seeds),
                                                  0)).to(device),
                       truncation_psi=truncation_psi,
                       truncation_cutoff=truncation_cutoff).cpu().numpy()
        num_keyframes = len(seeds) // (gw * gh)
        ws = ws.reshape(gh, gw, num_keyframes, *ws.shape[1:])

        B = gh * gw
        vb = torch.from_numpy(np.repeat(v, B, 0)).to(device)
        cached = num_keyframes == 1
        if cached:
            w_const = torch.from_numpy(ws[:, :, 0].reshape(
                B, *ws.shape[3:])).to(device)
            textures, static = G.build_identity(w_const, noise_mode='const')
        else:
            # one cubic interpolator per cell, hoisted out of the frame loop
            x = np.arange(-num_keyframes, num_keyframes * 2)
            interps = [
                sinterp.interp1d(x, np.tile(ws[yi, xi], (3, 1, 1)),
                                 kind='cubic', axis=0)
                for yi in range(gh) for xi in range(gw)]

        video_path = os.path.join(outdir, 'interpolation.mp4')
        writer = VideoWriter(video_path, fps=fps)
        total = num_keyframes * w_frames
        synchronize(device)
        t0 = time.perf_counter()
        for frame_idx in range(total):
            pitch = -0.25 * np.sin(2 * math.pi * frame_idx / total)
            yaw = 0.35 * np.sin(2 * math.pi * frame_idx / total)
            c = torch.from_numpy(np.repeat(camera_label(yaw, pitch), B,
                                           0)).to(device)
            if cached:
                imgs = G.synthesis_from_identity(
                    w_const, textures, static, c, vb,
                    noise_mode='const')['image']
            else:
                w = np.stack([f(frame_idx / w_frames) for f in interps])
                w = torch.from_numpy(w.astype(np.float32)).to(device)
                imgs = G.synthesis(w, c, vb, noise_mode='const')['image']
            H = imgs.shape[-1]
            canvas = imgs.reshape(gh, gw, 3, H, H).permute(2, 0, 3, 1, 4) \
                .reshape(3, gh * H, gw * H)
            writer.append(frame_uint8(canvas))
        out = writer.close()
        stats = dict(frames=total, seconds=time.perf_counter() - t0)
    print(f'wrote {out}', flush=True)
    return stats
