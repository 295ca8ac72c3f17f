"""Density cross-sections for debug images.

Counterpart of next3d_tpu/render/crosssection.py (reference:
crosssection_utils.py:13-24): sigma on a square slice through the volume,
from the generator's ``sample_mixed``. On the flagship that builds the
planes (kernel K1 rasterizes the texture) and samples them at the slice's
points (kernel K4).
"""

from __future__ import annotations

import numpy as np
import torch


def sample_cross_section(G, ws, v, resolution=256, w=1.2, axis='y',
                         offset=0.0):
    """sigma on the plane perpendicular to ``axis`` at ``offset``, a
    (resolution, resolution) tensor on ws's device. ``v`` is the flagship's
    expression input (FLAME verts followed by the landmarks)."""
    coords = np.linspace(-w / 2, w / 2, resolution, dtype=np.float32)
    a, b = np.meshgrid(coords, coords, indexing='ij')
    flat_a, flat_b = a.reshape(-1), b.reshape(-1)
    off = np.full_like(flat_a, offset)
    if axis == 'y':
        pts = np.stack([flat_a, off, flat_b], -1)
    elif axis == 'x':
        pts = np.stack([off, flat_a, flat_b], -1)
    else:
        pts = np.stack([flat_a, flat_b, off], -1)
    pts = torch.from_numpy(pts[None]).to(ws.device)
    out = G.sample_mixed(pts, pts, ws, v, noise_mode='const')
    return out['sigma'].reshape(resolution, resolution)
