"""K5: the per-face z-buffer rasterizer.

Counterpart of next3d_tpu/ops/pallas_raster.py rasterize_mesh_pallas (kernel
_raster_kernel :31), with its exact semantics: pixel centres at the -0.5
offset, faces with area <= 1e-8 culled, a face writing only its stripe of
``min(patch + 8, H)`` full-width rows from the 8-aligned row at or above
its top (a face taller than the stripe is cut), the smallest z winning, the
earlier face winning a z tie, and a z of 1e10 or more never winning.

Rounding. On the CPU, XLA contracts each ``a*b - c*d`` and each sum of
products of the reference into fused multiply-adds, so the reference
computes ``area = fma(x1-x0, y2-y0, -((y1-y0)*(x2-x0)))``, each edge as
``w0 = fma(cx-bx, py-by, -((cy-by)*(px-bx)))`` (and its two cyclic
copies), the barycentric ``b_i = w_i * inv_area`` as one rounded product
and the depth as ``z = fma(b2, cz, fma(b0, az, b1*bz))``. The port
evaluates that form, in torch with ``fma32`` (float32 ``a*b + c`` rounded
once) and in the kernel with ``__fmaf_rn``, so the plain version equals
JAX's interpret-mode K5 bit for bit, also on near-degenerate slivers where a
separately rounded form passes pixels far outside the face
(tests/test_torch_raster_variants.py test_k5_matches_jax_on_slivers), and
the kernel equals the plain version.

On a CUDA tensor ``rasterize_zbuffer`` runs the kernels of
``csrc/raster_zbuffer.cu``: the prep (``zbuffer_prep_cuda``), then the face
kernel, which culls each face's stripe coarse to fine by an exact corner
test (``cull_plain`` mirrors it for the tests), and the decode. On a CPU
tensor it runs ``zbuffer_prep`` and the plain ``_zbuffer_plain``, which
tests every (kept face, stripe pixel) pair. Both resolve the sequential
loop's order with one packed key per pixel, ``ordered(z) * 2^32 + face``,
reduced by a minimum (``atomicMin`` on the card, ``scatter_reduce_('amin')``
here).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import cuda_build

BIG_Z = 1e10
PLAIN_CHUNK_ELEMS = 1 << 22  # (face, stripe pixel) pairs per plain step
# the face kernel's sub-tile, px; its level-0 strips are SUB_W wide too
SUB_W, SUB_H = 8, 4
FACES, DECODE = 1, 2  # the stages of ``_launch_zbuffer``
_SHIFT = 1 << 32


def fma32(a, b, c):
    """float32 ``a * b + c`` rounded once, as a fused multiply-add does, for
    float32 tensors that broadcast, on any device. The product is exact in
    float64 (24 + 24 bits), TwoSum gives the exact error of the float64
    sum, and the sum is rounded to odd (moved one ulp toward the error when
    it is inexact and even) so that the cast to float32 rounds once
    correctly (53 >= 24 + 2 bits)."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)         # NaN where s is infinite
    inexact = ((err > 0) | (err < 0)) & ((s.view(torch.int64) & 1) == 0)
    odd = torch.nextafter(s, torch.copysign(torch.full_like(s, math.inf), err))
    return torch.where(inexact, odd, s).float()


def _ordered(bits):
    """int32 float bits -> an int32 that orders as the floats do."""
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _pack(z, face):
    """The (z, face) key: smaller z first, then the smaller face."""
    bits = (z + 0.0).view(torch.int32)       # -0 -> +0
    return _ordered(bits).to(torch.int64) * _SHIFT + face


KEY_EMPTY = int(np.float32(BIG_Z).view(np.int32)) * _SHIFT  # (1e10, face 0)


def _stripe(image_size, patch):
    stripe_h = min(patch + 8, image_size)
    if stripe_h % 8 or image_size % 8:
        raise ValueError(f'image_size {image_size} and the stripe of patch '
                         f'{patch} must be 8-aligned')
    return stripe_h


def zbuffer_prep(verts, faces, image_size, patch=32):
    """verts (B, V, 3) with x, y in [-1, 1] and z depth; faces (F, 3).

    Returns face_data (B, 10, F) float32, the rows ax bx cx ay by cy az bz cz
    inv_area (0 for a culled face), y0 (B, F) int32, each face's first
    stripe row, and the stripe height.
    """
    H = W = image_size
    stripe_h = _stripe(H, patch)
    faces = faces.long()
    verts = verts.detach().float()
    px = (verts[..., 0] + 1) * (W / 2) - 0.5
    py = (verts[..., 1] + 1) * (H / 2) - 0.5
    fx = px[:, faces]                                        # (B, F, 3)
    fy = py[:, faces]
    fz = verts[..., 2][:, faces]
    x0, x1, x2 = fx.unbind(-1)
    y0, y1, y2 = fy.unbind(-1)
    area = fma32(x1 - x0, y2 - y0, -((y1 - y0) * (x2 - x0)))
    keep = area > 1e-8
    inv_area = torch.where(keep, 1.0 / torch.where(keep, area,
                                                   torch.ones_like(area)),
                           torch.zeros_like(area))
    face_data = torch.cat([fx.permute(0, 2, 1), fy.permute(0, 2, 1),
                           fz.permute(0, 2, 1), inv_area[:, None]], dim=1)
    # the 8-aligned row at or above ceil(ymin), kept inside the image; the
    # clamp of ymin first changes nothing after the final clip
    ymin = torch.minimum(torch.minimum(y0, y1), y2)
    top = torch.ceil(torch.clamp(ymin, -16.0, H + 16.0)).to(torch.int32)
    first = torch.clamp(torch.div(top, 8, rounding_mode='floor') * 8, 0,
                        H - stripe_h)
    return face_data.contiguous(), first.to(torch.int32).contiguous(), \
        stripe_h


def _edges(face):
    """The three edges of face rows ``face`` (ax bx cx ay by cy ..., any
    shapes), each (ex, ey, x, y): the edge vector and the corner it starts
    from, b -> c, c -> a and a -> b."""
    ax, bx, cx, ay, by, cy = face[:6]
    return ((cx - bx, cy - by, bx, by), (ax - cx, ay - cy, cx, cy),
            (bx - ax, by - ay, ax, ay))


def _barycentric(ex, ey, x, y, inv, px, py):
    """One barycentric at pixel (px, py), rounded as the reference rounds
    it: fl(fma(ex, py - y, -(ey * (px - x))) * inv)."""
    return fma32(ex, py - y, -(ey * (px - x))) * inv


def _cover(keys, face, item, faces, image_size, row, col):
    """Test kept faces ``face`` (n, 10), numbered ``item`` = b * faces + f,
    at the pixels (row, col), long tensors that broadcast to (n, ...)
    against ``item[:, None, ...]``, and reduce the key of every covering
    (face, pixel) pair into ``keys`` (B * H * W)."""
    H = W = image_size
    shape = (-1,) + (1,) * (row.dim() - 1)
    f = [a.reshape(shape) for a in face.unbind(1)]
    inv = f[9]
    b = [_barycentric(*e, inv, col.float(), row.float())
         for e in _edges(f)]
    inside = (b[0] >= 0) & (b[1] >= 0) & (b[2] >= 0)
    full = inside.shape

    def at(a):
        return a.expand(full)[inside]

    z = fma32(at(b[2]), at(f[8]), fma32(at(b[0]), at(f[6]),
                                         at(b[1]) * at(f[7])))
    win = z < BIG_Z
    item = item.reshape(shape)
    pixel = at(((item // faces) * H + row) * W + col)
    keys.scatter_reduce_(0, pixel[win], _pack(z[win], at(item % faces)[win]),
                         'amin')


def _decode(keys, shape):
    hit = keys != KEY_EMPTY
    hi = torch.div(keys, _SHIFT, rounding_mode='floor')
    face = (keys - hi * _SHIFT).to(torch.int32)
    z = _ordered(hi.to(torch.int32)).view(torch.float32)
    return (torch.where(hit, face, -1).reshape(shape),
            torch.where(hit, z, BIG_Z).reshape(shape))


def _zbuffer_plain(face_data, y0, image_size, stripe_h):
    """Every (kept face, stripe pixel) pair, faces in chunks of at most
    PLAIN_CHUNK_ELEMS pairs, reduced into one key per pixel."""
    B, _, F = face_data.shape
    H = W = image_size
    dev = face_data.device
    keys = torch.full((B * H * W,), KEY_EMPTY, dtype=torch.int64, device=dev)
    fd = face_data.permute(0, 2, 1).reshape(B * F, 10)
    kept = torch.nonzero(fd[:, 9] > 0).squeeze(1)            # b * F + f
    rows = torch.arange(stripe_h, device=dev)
    cols = torch.arange(W, device=dev)[None, None]            # (1, 1, W)
    chunk = max(1, PLAIN_CHUNK_ELEMS // (stripe_h * W))
    for c0 in range(0, kept.numel(), chunk):
        item = kept[c0:c0 + chunk]
        row = y0.reshape(-1)[item].long()[:, None] + rows[None]  # (c, S)
        _cover(keys, fd[item], item, F, image_size, row[..., None], cols)
    return _decode(keys, (B, H, W))


def cull_plain(face_data, y0, image_size, stripe_h):
    """The face kernel's coarse levels in plain torch, for the tests and
    chip_smoke.py (no rasterizer calls it). For each kept face, level 0
    tests the stripe's column strips, SUB_W px wide and the stripe high,
    and level 1 the SUB_W x SUB_H sub-tiles of the strips that level 0
    kept. A rectangle is culled when one of the face's barycentrics,
    evaluated by the per-pixel expression at the rectangle's corner where
    it is largest (the smallest x if ey >= 0, else the largest; the largest
    y if ex >= 0, else the smallest), is < 0.

    Returns item (K,), the kept faces as b * F + f in order, strips
    (K, W / SUB_W) bool, the strips level 0 keeps, and subs
    (K, stripe_h / SUB_H, W / SUB_W) bool, the sub-tiles both levels keep.
    """
    B, _, F = face_data.shape
    dev = face_data.device
    fd = face_data.permute(0, 2, 1).reshape(B * F, 10)
    item = torch.nonzero(fd[:, 9] > 0).squeeze(1)
    f = [a[:, None, None] for a in fd[item].unbind(1)]       # (K, 1, 1)
    edges = _edges(f)
    top = y0.reshape(-1)[item].float()[:, None, None]
    x_lo = torch.arange(0, image_size, SUB_W, device=dev).float()[None, None]

    def keeps(y_lo, y_hi):
        keep = torch.ones((), dtype=torch.bool, device=dev)
        for ex, ey, x, y in edges:
            px = torch.where(ey >= 0, x_lo, x_lo + (SUB_W - 1))
            py = torch.where(ex >= 0, y_hi, y_lo)
            keep = keep & ~(_barycentric(ex, ey, x, y, f[9], px, py) < 0)
        return keep

    strips = keeps(top, top + (stripe_h - 1))                # (K, 1, nx)
    sub_lo = top + torch.arange(0, stripe_h, SUB_H, device=dev).float()[
        None, :, None]                                        # (K, ny, 1)
    subs = strips & keeps(sub_lo, sub_lo + (SUB_H - 1))      # (K, ny, nx)
    return item, strips[:, 0], subs


def zbuffer_prep_cuda(verts, faces, image_size, patch=32):
    """``zbuffer_prep``'s contract on CUDA tensors, by the prep kernel of
    ``csrc/raster_zbuffer.cu`` (one launch): bit-equal to it on the kept
    faces (y0 of a culled face may differ). ``faces`` must index
    ``verts``."""
    B, V, _ = verts.shape
    F = faces.shape[0]
    stripe_h = _stripe(image_size, patch)
    dev = verts.device
    verts = verts.detach().float().contiguous()
    faces = faces.long().contiguous()
    if verts.shape[-1] != 3 or faces.shape != (F, 3) or faces.device != dev:
        raise ValueError('verts must be (B, V, 3) and faces (F, 3) on one '
                         'device')
    face_data = torch.empty((B, 10, F), dtype=torch.float32, device=dev)
    first = torch.empty((B, F), dtype=torch.int32, device=dev)
    cuda_build.launch('raster_zbuffer', 'raster_zbuffer_prep', dev,
                      verts.data_ptr(), faces.data_ptr(),
                      face_data.data_ptr(), first.data_ptr(), B, V, F,
                      image_size, stripe_h)
    return face_data, first, stripe_h


def _launch_zbuffer(face_data, y0, keys, pix_to_face, zbuf, stripe_h,
                    stages=FACES | DECODE):
    """Launch the face kernel (into ``keys``, which must start at
    KEY_EMPTY) and/or the decode (``keys`` into the outputs), as
    ``stages`` says; (B, H, W) buffers on the device of face_data."""
    B, _, F = face_data.shape
    _, H, W = keys.shape
    cuda_build.launch('raster_zbuffer', 'raster_zbuffer', face_data.device,
                      face_data.data_ptr(), y0.data_ptr(), keys.data_ptr(),
                      pix_to_face.data_ptr(), zbuf.data_ptr(), B, F, H, W,
                      stripe_h, stages)


def _zbuffer_cuda(face_data, y0, image_size, stripe_h):
    B, _, F = face_data.shape
    H = W = image_size
    if face_data.dtype != torch.float32 or y0.dtype != torch.int32 \
            or y0.shape != (B, F) or y0.device != face_data.device \
            or not (face_data.is_contiguous() and y0.is_contiguous()):
        raise ValueError('face_data must be contiguous float32 (B, 10, F) '
                         'and y0 contiguous int32 (B, F) on one device')
    dev = face_data.device
    keys = torch.full((B, H, W), KEY_EMPTY, dtype=torch.int64, device=dev)
    pf = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    zbuf = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    _launch_zbuffer(face_data, y0, keys, pf, zbuf, stripe_h)
    rasterize_zbuffer.launches += 1
    return pf, zbuf


def rasterize_zbuffer(verts, faces, image_size, patch=32):
    """K5. Returns (pix_to_face (B, H, W) int32, -1 where empty; zbuf
    (B, H, W) float32, 1e10 where empty). Launches the CUDA kernels for CUDA
    tensors and runs the plain version for CPU tensors. Not
    differentiable."""
    if verts.is_cuda:
        face_data, y0, stripe_h = zbuffer_prep_cuda(verts, faces, image_size,
                                                    patch)
        return _zbuffer_cuda(face_data, y0, image_size, stripe_h)
    return rasterize_zbuffer_plain(verts, faces, image_size, patch)


rasterize_zbuffer.launches = 0


def rasterize_zbuffer_plain(verts, faces, image_size, patch=32):
    """The plain torch version on any device."""
    face_data, y0, stripe_h = zbuffer_prep(verts, faces, image_size, patch)
    return _zbuffer_plain(face_data, y0, image_size, stripe_h)
