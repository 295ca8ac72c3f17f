"""K5: the per-face z-buffer rasterizer.

Counterpart of next3d_tpu/ops/pallas_raster.py rasterize_mesh_pallas (kernel
_raster_kernel :31), with its exact semantics: pixel centres at the -0.5
offset, faces with area <= 1e-8 culled, a face writing only its stripe of
``min(patch + 8, H)`` full-width rows from the 8-aligned row at or above
its top (a face taller than the stripe is cut), the smallest z winning, the
earlier face winning a z tie, and a z of 1e10 or more never winning.

``zbuffer_prep`` computes the per-face inputs in torch. ``rasterize_zbuffer``
then launches the kernel in ``csrc/raster_zbuffer.cu`` for CUDA tensors and
runs the plain version for CPU tensors. Both resolve the sequential loop's
order with one packed key per pixel, ``ordered(z) * 2^32 + face``, reduced
by a minimum (``atomicMin`` on the card, ``scatter_reduce_('amin')`` here),
and both evaluate the edge and depth arithmetic in the TPU kernel's order.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_build

BIG_Z = 1e10
PLAIN_CHUNK_ELEMS = 1 << 24  # (face, stripe pixel) pairs per plain step
_SHIFT = 1 << 32


def _ordered(bits):
    """int32 float bits -> an int32 that orders as the floats do."""
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _pack(z, face):
    """The (z, face) key: smaller z first, then the smaller face."""
    bits = (z + 0.0).view(torch.int32)       # -0 -> +0
    return _ordered(bits).to(torch.int64) * _SHIFT + face


KEY_EMPTY = int(np.float32(BIG_Z).view(np.int32)) * _SHIFT  # (1e10, face 0)


def zbuffer_prep(verts, faces, image_size, patch=32):
    """verts (B, V, 3) with x, y in [-1, 1] and z depth; faces (F, 3).

    Returns face_data (B, 10, F) float32, the rows ax bx cx ay by cy az bz cz
    inv_area (0 for a culled face), y0 (B, F) int32, each face's first
    stripe row, and the stripe height.
    """
    H = W = image_size
    stripe_h = min(patch + 8, H)
    if stripe_h % 8 or H % 8:
        raise ValueError(f'image_size {H} and the stripe of patch {patch} '
                         f'must be 8-aligned')
    faces = faces.long()
    verts = verts.detach().float()
    px = (verts[..., 0] + 1) * (W / 2) - 0.5
    py = (verts[..., 1] + 1) * (H / 2) - 0.5
    fx = px[:, faces]                                        # (B, F, 3)
    fy = py[:, faces]
    fz = verts[..., 2][:, faces]
    area = ((fx[..., 1] - fx[..., 0]) * (fy[..., 2] - fy[..., 0])
            - (fy[..., 1] - fy[..., 0]) * (fx[..., 2] - fx[..., 0]))
    keep = area > 1e-8
    inv_area = torch.where(keep, 1.0 / torch.where(keep, area,
                                                   torch.ones_like(area)),
                           torch.zeros_like(area))
    face_data = torch.cat([fx.permute(0, 2, 1), fy.permute(0, 2, 1),
                           fz.permute(0, 2, 1), inv_area[:, None]], dim=1)
    # the 8-aligned row at or above ceil(ymin), kept inside the image; the
    # clamp of ymin first changes nothing after the final clip
    ymin = torch.minimum(torch.minimum(fy[..., 0], fy[..., 1]), fy[..., 2])
    top = torch.ceil(torch.clamp(ymin, -16.0, H + 16.0)).to(torch.int32)
    y0 = torch.clamp(torch.div(top, 8, rounding_mode='floor') * 8, 0,
                     H - stripe_h)
    return face_data.contiguous(), y0.to(torch.int32).contiguous(), stripe_h


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
    cols = torch.arange(W, device=dev)
    px = cols.float()[None, None, :]                          # (1, 1, W)
    chunk = max(1, PLAIN_CHUNK_ELEMS // (stripe_h * W))
    for c0 in range(0, kept.numel(), chunk):
        item = kept[c0:c0 + chunk]
        ax, bx, cx, ay, by, cy, az, bz, cz, inv = (
            a[:, None, None] for a in fd[item].unbind(1))
        row = y0.reshape(-1)[item].long()[:, None] + rows[None]  # (c, S)
        py = row.float()[:, :, None]                              # (c, S, 1)
        b0 = ((cx - bx) * (py - by) - (cy - by) * (px - bx)) * inv
        b1 = ((ax - cx) * (py - cy) - (ay - cy) * (px - cx)) * inv
        b2 = ((bx - ax) * (py - ay) - (by - ay) * (px - ax)) * inv
        z = b0 * az + b1 * bz + b2 * cz                            # (c, S, W)
        win = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & (z < BIG_Z)
        face = (item % F)[:, None, None].expand_as(z)
        pixel = ((item // F)[:, None, None] * H + row[..., None]) * W \
            + cols[None, None]
        keys.scatter_reduce_(0, pixel[win], _pack(z[win], face[win]),
                             'amin')
    return _decode(keys, (B, H, W))


def _zbuffer_cuda(face_data, y0, image_size, stripe_h):
    B, _, F = face_data.shape
    H = W = image_size
    if face_data.dtype != torch.float32 or y0.dtype != torch.int32 \
            or y0.shape != (B, F) or y0.device != face_data.device:
        raise ValueError('face_data must be float32 (B, 10, F) and y0 int32 '
                         '(B, F) on one device')
    dev = face_data.device
    keys = torch.full((B, H, W), KEY_EMPTY, dtype=torch.int64, device=dev)
    pf = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    zbuf = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    cuda_build.launch('raster_zbuffer', 'raster_zbuffer', dev,
                      face_data.data_ptr(), y0.data_ptr(), keys.data_ptr(),
                      pf.data_ptr(), zbuf.data_ptr(), B, F, H, W, stripe_h)
    rasterize_zbuffer.launches += 1
    return pf, zbuf


def rasterize_zbuffer(verts, faces, image_size, patch=32):
    """K5. Returns (pix_to_face (B, H, W) int32, -1 where empty; zbuf
    (B, H, W) float32, 1e10 where empty). Launches the CUDA kernel for CUDA
    tensors and runs the plain version for CPU tensors. Not
    differentiable."""
    face_data, y0, stripe_h = zbuffer_prep(verts, faces, image_size, patch)
    if face_data.is_cuda:
        return _zbuffer_cuda(face_data, y0, image_size, stripe_h)
    return _zbuffer_plain(face_data, y0, image_size, stripe_h)


rasterize_zbuffer.launches = 0


def rasterize_zbuffer_plain(verts, faces, image_size, patch=32):
    """The plain torch version on any device."""
    face_data, y0, stripe_h = zbuffer_prep(verts, faces, image_size, patch)
    return _zbuffer_plain(face_data, y0, image_size, stripe_h)
