"""FLAME-driven avatar reenactment, the serving path.

Counterpart of next3d_tpu/cli/reenact.py (reference:
reenact_avatar_next3d.py:88-174): a fixed identity from a frontal
conditioning pose; per driving frame, its FLAME vertices and landmarks and
its camera label (smoothed over 3 frames) drive one synthesis, and the
frames go to ``reenact_seed<NNNN>.mp4`` (or its PNG-frame directory).

The identity's neural texture and static tri-plane depend on ws alone, so
``build_identity`` runs once a seed and each frame runs only
``synthesis_from_identity`` (rasterize, mouth, blend, render,
super-resolution). The driving meshes are parsed before the first frame.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from .common import (DEMO_OBJ, camera_label, frame_uint8, inference,
                     load_generator, synchronize)


def load_driving_sequence(drive_root):
    """Per-frame (camera label, verts + lms) arrays from a driving dir
    (reference reenact_avatar_next3d.py:125-154; layout README.md:76-83):
    cs (T, 25) and vs (T, V + 68, 3), float32, in label order."""
    from ..utils.obj_io import load_lms, load_obj_verts
    with open(os.path.join(drive_root, 'dataset.json')) as f:
        labels = json.load(f)['labels']
    labels = sorted(labels, key=lambda kv: kv[0])
    frames = []
    for fname, label in labels:
        stem = os.path.splitext(os.path.basename(fname))[0]
        obj = os.path.join(drive_root, stem + '.obj')
        kpt = os.path.join(drive_root, stem + '_kpt2d.txt')
        if not (os.path.exists(obj) and os.path.exists(kpt)):
            continue
        verts = load_obj_verts(obj)
        lms = load_lms(kpt)
        frames.append((np.asarray(label, np.float32),
                       np.concatenate([verts, lms], 0).astype(np.float32)))
    if not frames:
        raise IOError(f'no driving frames under {drive_root}')
    cs = np.stack([f[0] for f in frames])
    vs = np.stack([f[1] for f in frames])
    return cs, vs


def smooth_cameras(cs, window=3):
    """3-frame camera smoothing (reference :159)."""
    out = cs.copy()
    for i in range(len(cs)):
        lo = max(0, i - window + 1)
        out[i] = cs[lo:i + 1].mean(0)
    return out


def reenact(network_path, drive_root, seeds=(166,), truncation_psi=0.7,
            truncation_cutoff=14, outdir='out', fps=30,
            topology_path=DEMO_OBJ, generator=None, device='cuda'):
    """Write one reenactment video a seed. ``generator`` replaces the
    snapshot at ``network_path``. Returns the timings of the last seed:
    its frames, the seconds from the start of its first frame to the end
    of its last, writes included, and the seconds of those frames without
    their writes."""
    from ..utils.video import VideoWriter
    os.makedirs(outdir, exist_ok=True)
    with inference():
        G = generator if generator is not None else load_generator(
            network_path, topology_path, device)
        device = G.orth_scale.device
        cs, vs = load_driving_sequence(drive_root)
        cs = torch.from_numpy(smooth_cameras(cs)).to(device)
        vs = torch.from_numpy(vs).to(device)
        cond_c = torch.from_numpy(camera_label(0, 0)).to(device)
        stats = {}
        for seed in seeds:
            z = torch.from_numpy(np.random.RandomState(seed).randn(
                1, G.z_dim).astype(np.float32)).to(device)
            ws = G.mapping(z, cond_c, truncation_psi=truncation_psi,
                           truncation_cutoff=truncation_cutoff)
            textures, static = G.build_identity(ws, noise_mode='const')
            path = os.path.join(outdir, f'reenact_seed{seed:04d}.mp4')
            writer = VideoWriter(path, fps=fps)
            synchronize(device)
            t0 = time.perf_counter()
            writes = 0.0
            for i in range(len(cs)):
                img = G.synthesis_from_identity(
                    ws, textures, static, cs[i:i + 1], vs[i:i + 1],
                    noise_mode='const')['image']
                frame = frame_uint8(img[0])
                t1 = time.perf_counter()
                writer.append(frame)
                writes += time.perf_counter() - t1
            out = writer.close()
            total = time.perf_counter() - t0
            stats = dict(frames=len(cs), seconds=total,
                         seconds_without_writes=total - writes)
            print(f'wrote {out} ({len(cs)} frames)', flush=True)
    return stats
