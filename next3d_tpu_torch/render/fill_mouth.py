"""Hole filling for the rasterized face alpha.

Counterpart of next3d_tpu/render/fill_mouth.py: every pixel NOT
4-connected-reachable from corner (0, 0) through pixels with
alpha*255 <= 254 becomes 1 (the reference's OpenCV floodFill,
renderer.py:583-601). The flood runs as rounds of directional sweeps, each
propagating reachability along every row and column in both directions with
``cumsum``/``cummax``, until the reachable count stops changing; the result
is exact for any topology. The loop condition reads the count on the host,
one sync per round (each a ``sync.flood_round`` span). ``fill_mouth_exact``
is the JAX package's fixed-round dilation flood, kept to cross-check it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import span

_INT32_MIN = torch.iinfo(torch.int32).min


def _sweep_axis(r, seg, f, dim):
    """Propagate reachability both ways along ``dim``.

    ``seg`` is the run id along the axis (cumsum of ~fillable, constant
    inside a run of fillable cells); a prefix max of (reachable ? seg : -1)
    equals ``seg`` exactly when a reachable cell at or before this one lies
    in the same run. The suffix max uses negated ids, so that later runs
    tag lower and cannot mask a same-run hit.
    """
    minus1 = torch.full_like(seg, -1)
    fwd = torch.cummax(torch.where(r, seg, minus1), dim=dim).values
    neg = torch.where(r, -seg, torch.full_like(seg, _INT32_MIN))
    bwd = torch.cummax(neg.flip(dim), dim=dim).values.flip(dim)
    return r | (f & ((fwd == seg) | (bwd == -seg)))


def _flood_reachable(fillable, seed):
    """Exact 4-connected reachable set from ``seed`` through ``fillable``;
    both (..., H, W) bool."""
    nf = (~fillable).to(torch.int32)
    seg_w = torch.cumsum(nf, dim=-1, dtype=torch.int32)
    seg_h = torch.cumsum(nf, dim=-2, dtype=torch.int32)

    def round_(r):
        r = _sweep_axis(r, seg_w, fillable, -1)
        return _sweep_axis(r, seg_h, fillable, -2)

    def count(r):
        with span('sync.flood_round'):
            return int(r.sum())

    r = round_(seed & fillable)
    prev, n = -1, count(r)
    while n != prev:
        r = round_(r)
        prev, n = n, count(r)
    return r


def fill_mouth(images):
    """images: (B, 1, H, W) alpha in [0, 1] -> filled alpha."""
    assert images.shape[1] == 1
    a = images[:, 0]
    fillable = a * 255.0 <= 254.0
    seed = torch.zeros_like(fillable)
    seed[:, 0, 0] = True
    reachable = _flood_reachable(fillable, seed)
    return torch.where(reachable, a, torch.ones_like(a))[:, None]


def fill_mouth_exact(images, iters=None):
    """Single-resolution dilation flood (JAX :102-135), an independent
    formulation for cross-checking ``fill_mouth`` in tests: from corner
    (0, 0), if it is fillable, ``iters`` (default H + W) rounds of a
    4-neighbour dilation kept inside the fillable pixels."""
    B, C, H, W = images.shape
    a = images[:, 0]
    fillable = (a * 255.0 <= 254.0).to(a.dtype)
    if iters is None:
        iters = H + W
    m = torch.zeros_like(fillable)
    m[..., 0, 0] = fillable[..., 0, 0]
    for _ in range(iters):
        up = F.pad(m[..., 1:, :], (0, 0, 0, 1))
        down = F.pad(m[..., :-1, :], (0, 0, 1, 0))
        left = F.pad(m[..., :, 1:], (0, 1))
        right = F.pad(m[..., :, :-1], (1, 0))
        dilated = torch.maximum(m, torch.maximum(torch.maximum(up, down),
                                                 torch.maximum(left, right)))
        m = torch.minimum(dilated, fillable)
    return torch.where(m > 0.5, a, torch.ones_like(a))[:, None]
