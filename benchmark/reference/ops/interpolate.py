"""Resizing primitives: ``F.interpolate`` with the reference's settings.

Counterpart of next3d_tpu/ops/interpolate.py. The JAX package rebuilt
torch's bilinear (plain and antialiased) and nearest resizes as static-shape
weighted gathers so that the mouth crop/paste window could stay dynamic
under ``jit``; in eager torch the window is a slice and the resize is
``F.interpolate`` itself, which is what those functions are specified to
equal.

The crop and paste take bf16 images too (the flagship's mouth pipeline
under ``force_fp32=False``). Torch's antialiased bilinear resize has no
bf16 kernel on the CPU, so on every device the bf16 window is resized in
float32 and the result rounded to bf16. The JAX package casts its resize
weights to bf16 and rounds after each of its two passes (JAX :139,185);
the port rounds once.
"""

from __future__ import annotations

import torch.nn.functional as F


def interpolate_bilinear(x, size, antialias=False):
    """F.interpolate(x, size, mode='bilinear', align_corners=False,
    antialias=...); x: (N, C, H, W)."""
    if isinstance(size, int):
        size = (size, size)
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=size, mode='bilinear', align_corners=False,
                         antialias=antialias)


def interpolate_nearest(x, size):
    """F.interpolate(x, size) in its default mode='nearest'."""
    if isinstance(size, int):
        size = (size, size)
    return F.interpolate(x, size=size, mode='nearest')


def _resize_antialiased(x, size):
    """Antialiased bilinear resize of (N, C, H, W) to ``size``, computed in
    float32 and returned in x's dtype."""
    return F.interpolate(x.float(), size=size, mode='bilinear',
                         align_corners=False, antialias=True).to(x.dtype)


def resample_region(src, start_y, start_x, size_y, size_x, out_h, out_w):
    """Antialiased bilinear resize of the window
    ``src[:, sy:sy+szy, sx:sx+szx]`` to (out_h, out_w); src: (C, H, W)."""
    crop = src[None, :, start_y:start_y + size_y, start_x:start_x + size_x]
    return _resize_antialiased(crop, (out_h, out_w))[0]


def paste_resized_region(canvas, patch, start_y, start_x, size_y, size_x):
    """``canvas`` with its (size_y, size_x) window at (start_y, start_x)
    replaced by ``patch`` resized there (antialiased bilinear); canvas and
    patch are (C, H, W); a window reaching past the canvas is cut at its
    edge. Returns a new tensor."""
    resized = _resize_antialiased(patch[None], (size_y, size_x))[0]
    end_y = min(start_y + size_y, canvas.shape[1])
    end_x = min(start_x + size_x, canvas.shape[2])
    out = canvas.clone()
    out[:, start_y:end_y, start_x:end_x] = \
        resized[:, :end_y - start_y, :end_x - start_x]
    return out
