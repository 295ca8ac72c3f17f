"""The rasterization entry points of the reference: the binned path alone.

A frozen copy of ``next3d_tpu_torch/render/rasterizer.py``'s
``interpolate_face_attributes``, ``rasterize_with_attributes`` and
``rasterize_uv_with_alpha`` for the rasterizer that 'auto' and
'pallas_binned' select at a plane size that is a multiple of 32: K1 for
(u, v), K2 then the barycentric interpolation for attributes, both as the
plain versions of ``ops/raster.py``. Another rasterizer name raises.
"""

from __future__ import annotations

import torch

from ..ops.raster import fma32, rasterize_binned, rasterize_binned_uv

IMPLS = ('auto', 'pallas_binned')
AREA_EPS = 1e-8  # a face of smaller |area| keeps 1/area = 1 in the interpolation


def check_impl(impl, image_size):
    """Raise unless ``impl`` selects the binned rasterizers at
    ``image_size``."""
    if impl not in IMPLS or image_size % 32:
        raise ValueError(f'the reference rasterizes with K1 and K2 alone: '
                         f'{impl!r} at {image_size}px is not that path')


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
    The pixel coordinates, the edge functions and the attribute sum round
    in the fused form that XLA compiles the JAX function into, so the two
    agree bit for bit at every image size.
    """
    B = verts.shape[0]
    H = W = image_size
    F = faces.shape[0]
    D = attributes.shape[-1]
    mask = (pix_to_face >= 0).reshape(B, H * W)
    fidx = torch.where(mask, pix_to_face.reshape(B, H * W), 0).long()

    half = verts.new_tensor(W / 2)
    shift = verts.new_tensor(-0.5)
    vx = _fma(verts[..., 0] + 1, half, shift)
    vy = _fma(verts[..., 1] + 1, half, shift)
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
                              impl='auto', **unused):
    """(B, D + 1, H, W) attribute and alpha images: K2's visibility, then
    ``interpolate_face_attributes``."""
    check_impl(impl, image_size)
    pix_to_face, _ = rasterize_binned(verts, faces, image_size)
    return interpolate_face_attributes(verts, faces, attributes, pix_to_face,
                                       image_size)


def rasterize_uv_with_alpha(verts, faces, uv_attrs, image_size, impl='auto',
                            **unused):
    """(B, 3, H, W): (u, v, alpha) from K1, 0 where no face covers the
    pixel."""
    check_impl(impl, image_size)
    pix_to_face, u, v = rasterize_binned_uv(verts, faces, uv_attrs,
                                            image_size)
    alpha = (pix_to_face >= 0).to(u.dtype)
    return torch.stack([u, v, alpha], dim=1)
