"""The rasterization entry points.

Counterpart of next3d_tpu/render/rasterizer.py: ``interpolate_face_attributes``
(:352), ``rasterize_with_attributes`` (:420) and ``rasterize_uv_with_alpha``
(:459). ``impl`` takes the JAX package's names, so that a JAX config builds
the same model here:

  'pallas_binned'    K1 for (u, v), K2 for attributes (``ops/raster.py``);
  'pallas_binned16'  K3 for (u, v); attributes go through K2 (the JAX
                     package falls back to its scatter golden there, which
                     computes the same visibility);
  'pallas'           K5 (``ops/raster_zbuffer.py``), then
                     ``interpolate_face_attributes``;
  'auto'             'pallas_binned', on every device of the port.

The JAX package's 'tiled' and 'scatter' rasterizers are not ported
(ROADMAP.md). Each kernel runs on a CUDA tensor and its plain version on a
CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.raster import (rasterize_binned, rasterize_binned_uv,
                          rasterize_binned_uv16)
from ..ops.raster_zbuffer import fma32, rasterize_zbuffer

IMPLS = ('auto', 'pallas_binned', 'pallas_binned16', 'pallas')
AREA_EPS = 1e-8  # a face of smaller |area| keeps 1/area = 1 in the interpolation


def resolve_impl(impl):
    """The port's rasterizer for a JAX ``rasterizer_impl`` name."""
    if impl in ('tiled', 'scatter'):
        raise ValueError(f"rasterizer impl {impl!r} is not ported (ROADMAP.md "
                         f"Queue 1 item 5, the 'tiled' and 'scatter' "
                         f"rasterizers); use one of {IMPLS}")
    if impl not in IMPLS:
        raise ValueError(f'unknown rasterizer impl {impl!r}; use one of '
                         f'{IMPLS}')
    return 'pallas_binned' if impl == 'auto' else impl


class _FusedMultiplyAdd(torch.autograd.Function):
    """``a * b + c`` rounded once (``fma32``), as XLA contracts the JAX
    package's interpolation on the CPU, with the derivative of
    ``a * b + c``, which the rounding does not change."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        ctx.shapes = a.shape, b.shape, c.shape
        return fma32(a, b, c)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        shape_a, shape_b, shape_c = ctx.shapes
        need_a, need_b, need_c = ctx.needs_input_grad
        return ((grad * b).sum_to_size(shape_a) if need_a else None,
                (grad * a).sum_to_size(shape_b) if need_b else None,
                grad.sum_to_size(shape_c) if need_c else None)


_fma = _FusedMultiplyAdd.apply


def _edge(ax, ay, bx, by, px, py):
    """Twice the signed area of triangle (a, b, p), in the fused form
    ``fma(bx - ax, py - ay, -((by - ay) * (px - ax)))``."""
    return _fma(bx - ax, py - ay, -((by - ay) * (px - ax)))


def interpolate_face_attributes(verts, faces, attributes, pix_to_face,
                                image_size):
    """Differentiable barycentric attribute interpolation (JAX :352-417).

    verts (B, V, 3) projected as for the rasterizers; faces (F, 3);
    attributes (B or 1, F, 3, D) per-corner values; pix_to_face (B, H, W).
    Returns (B, D + 1, H, W): the interpolated attributes, 0 where no face
    covers the pixel, then the alpha mask. Gradients flow to verts (through
    the barycentrics recomputed at the pixel centres) and to attributes.
    The edge functions and the attribute sum round in the fused form that
    XLA compiles the JAX function into, so the two agree bit for bit.
    """
    B = verts.shape[0]
    H = W = image_size
    F = faces.shape[0]
    D = attributes.shape[-1]
    mask = (pix_to_face >= 0).reshape(B, H * W)
    fidx = torch.where(mask, pix_to_face.reshape(B, H * W), 0).long()

    vx = (verts[..., 0] + 1) * (W / 2) - 0.5
    vy = (verts[..., 1] + 1) * (H / 2) - 0.5
    tri = faces.long()
    # one per-pixel row gather from a per-face table of
    # [corner x (3) | corner y (3) | corner attributes (3 D)]
    table = torch.cat([vx[:, tri], vy[:, tri],
                       attributes.expand(B, F, 3, D).reshape(B, F, 3 * D)],
                      dim=-1)                                # (B, F, 6 + 3D)
    rows = torch.gather(table, 1, fidx[..., None].expand(-1, -1,
                                                        table.shape[-1]))
    gx, gy = rows[..., 0:3], rows[..., 3:6]
    face_attrs = rows[..., 6:].reshape(B, H * W, 3, D)

    pcy, pcx = torch.meshgrid(
        torch.arange(H, dtype=verts.dtype, device=verts.device),
        torch.arange(W, dtype=verts.dtype, device=verts.device),
        indexing='ij')
    pcx = pcx.reshape(1, H * W)
    pcy = pcy.reshape(1, H * W)
    w0 = _edge(gx[..., 1], gy[..., 1], gx[..., 2], gy[..., 2], pcx, pcy)
    w1 = _edge(gx[..., 2], gy[..., 2], gx[..., 0], gy[..., 0], pcx, pcy)
    w2 = _edge(gx[..., 0], gy[..., 0], gx[..., 1], gy[..., 1], pcx, pcy)
    area = _edge(gx[..., 0], gy[..., 0], gx[..., 1], gy[..., 1],
                 gx[..., 2], gy[..., 2])
    inv = 1.0 / torch.where(area.abs() > AREA_EPS, area,
                            torch.ones_like(area))
    b0, b1, b2 = ((w * inv)[..., None] for w in (w0, w1, w2))  # (B, HW, 1)
    # the 3-term sum in the fused form fma(b2, a2, fma(b1, a1, b0 * a0))
    a0, a1, a2 = face_attrs.unbind(-2)
    vals = _fma(b2, a2, _fma(b1, a1, b0 * a0))                 # (B, HW, D)
    vals = vals * mask[..., None].to(vals.dtype)
    out = vals.reshape(B, H, W, D).permute(0, 3, 1, 2)
    alpha = mask.reshape(B, 1, H, W).to(out.dtype)
    return torch.cat([out, alpha], dim=1)


def rasterize_with_attributes(verts, faces, attributes, image_size,
                              patch=32, impl='auto'):
    """(B, D + 1, H, W) attribute and alpha images (JAX :420-456): the
    visibility of ``impl`` (K2, or K5 with ``patch``), then
    ``interpolate_face_attributes``."""
    if resolve_impl(impl) == 'pallas':
        pix_to_face, _ = rasterize_zbuffer(verts, faces, image_size, patch)
    else:
        pix_to_face, _ = rasterize_binned(verts, faces, image_size)
    return interpolate_face_attributes(verts, faces, attributes, pix_to_face,
                                       image_size)


def rasterize_uv_with_alpha(verts, faces, uv_attrs, image_size, patch=32,
                            impl='auto'):
    """verts (B, V, 3) with x, y in [-1, 1] and z depth (smaller in front);
    faces (F, 3); uv_attrs (B or 1, F, 3, 2) per-corner (u, v).

    Returns (B, 3, H, W): (u, v, alpha), with u = v = alpha = 0 where no
    face covers the pixel. The binned impls emit (u, v) from the kernel
    (K1, K3); 'pallas' interpolates them after K5, as the JAX package does.
    """
    impl = resolve_impl(impl)
    if impl in ('pallas_binned', 'pallas_binned16'):
        fn = rasterize_binned_uv16 if impl == 'pallas_binned16' \
            else rasterize_binned_uv
        pix_to_face, u, v = fn(verts, faces, uv_attrs, image_size)
        alpha = (pix_to_face >= 0).to(u.dtype)
        return torch.stack([u, v, alpha], dim=1)
    ones = torch.ones_like(uv_attrs[..., :1])
    out = rasterize_with_attributes(
        verts, faces, torch.cat([uv_attrs, ones], dim=-1), image_size,
        patch=patch, impl=impl)                 # (B, 4, H, W): u, v, 1, alpha
    return torch.cat([out[:, :2], out[:, 3:]], dim=1)


def required_patch_size(verts, faces, image_size):
    """Max face bbox span in pixels (numpy; reference helper :500). The
    binned kernels are exact while this stays below their 32-px tile; K5
    while it stays below its patch."""
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    px = (verts[..., 0] + 1) * (image_size / 2)
    py = (verts[..., 1] + 1) * (image_size / 2)
    fx = px[..., faces]
    fy = py[..., faces]
    span = np.maximum(fx.max(-1) - fx.min(-1), fy.max(-1) - fy.min(-1))
    return float(span.max())
