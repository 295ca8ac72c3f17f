"""The rasterization entry points.

Counterpart of next3d_tpu/render/rasterizer.py: ``rasterize_mesh`` (:44),
``rasterize_mesh_tiled`` (:159), ``required_tile_capacity`` (:323),
``interpolate_face_attributes`` (:352), ``rasterize_with_attributes``
(:420) and ``rasterize_uv_with_alpha`` (:459). ``impl`` takes the JAX
package's names, so that a JAX config builds the same model here, and
``select_impl`` picks the rasterizer by JAX's table:

  'pallas_binned'    K1 for (u, v), K2 for attributes (``ops/raster.py``),
                     at an image size that is a multiple of 32; else
                     'tiled' at a multiple of 16, else 'scatter';
  'pallas_binned16'  K3 for (u, v) at a multiple of 32; 'scatter' for
                     attributes or at another size;
  'pallas'           K5 (``ops/raster_zbuffer.py``), then
                     ``interpolate_face_attributes``;
  'tiled'            ``rasterize_mesh_tiled`` at a multiple of 16, else
                     'scatter';
  'scatter'          ``rasterize_mesh``, the exact golden;
  'auto'             'pallas_binned' at a multiple of 32, else 'tiled' (the
                     JAX package's choice on its accelerator, on every
                     device of the port).

K1-K3 and K5 run their kernels on a CUDA tensor and their plain versions on
a CPU tensor. 'tiled' and 'scatter' are XLA compositions in the JAX package
(``top_k``, ``scan``, scatter-min), with no TPU kernel, so their port is
plain torch on whatever device the tensors are on. Both round as XLA
compiles them on the CPU, with ``fma32`` (ops/raster_zbuffer.py): each
pixel coordinate as ``fma(x + 1, W / 2, -0.5)``, each edge function as
``fma(bx - ax, py - ay, -((by - ay) * (px - ax)))`` and each depth sum as
``fma(t2, z2, fma(t0, z0, t1 * z1))``, so that they give JAX's pix_to_face
and zbuf bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.raster import (rasterize_binned, rasterize_binned_uv,
                          rasterize_binned_uv16)
from ..ops.raster_zbuffer import _ordered, fma32, rasterize_zbuffer
from ..utils.profiling import span

IMPLS = ('auto', 'pallas_binned', 'pallas_binned16', 'pallas', 'tiled',
         'scatter')
AREA_EPS = 1e-8  # a face of smaller |area| keeps 1/area = 1 in the interpolation
BIG_Z = 1e10     # the depth of an empty pixel
NO_FACE = 2 ** 30
# (image, face, patch pixel) candidates of ``rasterize_mesh`` a step; the
# result does not depend on it
CANDIDATES_PER_STEP = 1 << 24


def select_impl(impl, image_size, attributes=False):
    """The rasterizer that a JAX ``rasterizer_impl`` name selects at
    ``image_size``: 'pallas_binned' (K1, or K2 for ``attributes``),
    'pallas_binned16' (K3), 'pallas' (K5), 'tiled' or 'scatter', by the
    JAX package's dispatch (JAX :436-456, :475-497)."""
    if impl not in IMPLS:
        raise ValueError(f'unknown rasterizer impl {impl!r}; use one of '
                         f'{IMPLS}')
    binned = image_size % 32 == 0
    if impl == 'auto':
        impl = 'pallas_binned' if binned else 'tiled'
    if impl == 'pallas':
        return impl
    if impl == 'pallas_binned16':
        return impl if binned and not attributes else 'scatter'
    if impl == 'pallas_binned' and binned:
        return impl
    if impl in ('tiled', 'pallas_binned') and image_size % 16 == 0:
        return 'tiled'
    return 'scatter'


def _pixel_xy(verts, image_size):
    """Pixel coordinates of verts (B, V, 3): column and row, each (B, V),
    rounded as ``fma(x + 1, W / 2, -0.5)``, and the depth."""
    verts = verts.detach().float()
    half = verts.new_tensor(image_size / 2)
    shift = verts.new_tensor(-0.5)
    return (fma32(verts[..., 0] + 1, half, shift),
            fma32(verts[..., 1] + 1, half, shift), verts[..., 2])


def _edge_terms(ax, ay, bx, by, px, py):
    """The operands (a, b, c) of the edge function of triangle (a, b, p),
    twice its signed area, in the fused form ``fma(a, b, c)``."""
    return bx - ax, py - ay, -((by - ay) * (px - ax))


def _covers(terms, inv):
    """``fl(fma(a, b, c) * inv) >= 0`` for float32 terms (a, b, c) and a
    positive finite ``inv``, without emulating every fma: a * b is exact in
    float64 and adding c keeps the sign of the fused value, which the
    float32 roundings keep too, unless the result underflows to -0. Only
    where the value times ``inv`` is that small is the fused value rounded
    itself."""
    a, b, c = terms
    s = a.double() * b.double() + c.double()
    out = s >= 0
    tiny = (s < 0) & (s * inv.double() > -2.0 ** -100)
    if tiny.any():
        at = tiny.nonzero(as_tuple=True)
        a, b, c, inv = (x.expand(tiny.shape)[at] for x in (a, b, c, inv))
        out[at] = fma32(a, b, c) * inv >= 0
    return out


def _at(terms, shape, at):
    """The fused edge values of ``terms`` at the indices ``at`` of
    ``shape``."""
    return fma32(*(t.expand(shape)[at] for t in terms))


def _depth(t, z):
    """``t0 z0 + t1 z1 + t2 z2`` rounded as fma(t2, z2, fma(t0, z0, t1 z1))."""
    return fma32(t[2], z[2], fma32(t[0], z[0], t[1] * z[1]))


def _corners(verts, faces, image_size):
    """Per face: corner columns, rows and depths, each (B, F, 3), and the
    doubled signed area (B, F)."""
    px, py, pz = _pixel_xy(verts, image_size)
    faces = faces.long().to(px.device)
    fx, fy, fz = px[:, faces], py[:, faces], pz[:, faces]
    area = fma32(*_edge_terms(fx[..., 0], fy[..., 0], fx[..., 1],
                              fy[..., 1], fx[..., 2], fy[..., 2]))
    return fx, fy, fz, area


def rasterize_mesh(verts, faces, image_size, patch=32, face_chunk=2048,
                   eps=1e-8):
    """pix_to_face and zbuf for a batch of meshes: the scatter golden (JAX
    :44-156).

    verts (B, V, 3) with x, y in [-1, 1] and z depth (smaller in front);
    faces (F, 3). Every kept face (area > ``eps``) tests the ``patch`` x
    ``patch`` pixels from the ceiling of its bbox minimum; the covered
    pixels take the smallest z, and among the candidates at that z the
    lowest face id. Faces whose bbox exceeds ``patch`` are rasterized in
    part. The kept (image, face) pairs go in steps of at most ``B *
    face_chunk``, the JAX function's chunk of ``face_chunk`` faces in every
    image, and of at most CANDIDATES_PER_STEP candidates; the step changes
    no result.

    Returns pix_to_face (B, H, W) int32, -1 where empty, and zbuf
    (B, H, W) float32, BIG_Z where empty. No gradient.
    """
    B = verts.shape[0]
    H = W = image_size
    fx, fy, fz, area = _corners(verts, faces, image_size)
    dev = fx.device
    k = torch.arange(patch, device=dev)
    ky, kx = (a.reshape(-1) for a in torch.meshgrid(k, k, indexing='ij'))
    # the kept faces of every image: the others cover nothing
    img_all, face_all = (area > eps).nonzero(as_tuple=True)
    step = max(1, min(B * face_chunk, CANDIDATES_PER_STEP // patch ** 2))
    flat, depth, fids = [img_all[:0]], [area.new_zeros(0)], [face_all[:0]]
    for lo in range(0, img_all.numel(), step):
        img, face = img_all[lo:lo + step], face_all[lo:lo + step]
        x, y, z = (a[img, face] for a in (fx, fy, fz))     # (n, 3)
        inv = 1.0 / area[img, face, None]                   # (n, 1)
        # ceil of the bbox minimum as int32; a face that far off the image
        # covers none of it, so the clamp keeps every result
        xmin, ymin = (torch.ceil(c.amin(-1)).clamp(-2 ** 30, 2 ** 30)
                      .to(torch.int32)[:, None] for c in (x, y))
        cx, cy = xmin + kx, ymin + ky                       # (n, P*P)
        px, py = cx.float(), cy.float()
        c = [(x[:, i, None], y[:, i, None]) for i in range(3)]
        w = [_edge_terms(*c[(i + 1) % 3], *c[(i + 2) % 3], px, py)
             for i in range(3)]
        inside = ((cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
                  & _covers(w[0], inv) & _covers(w[1], inv)
                  & _covers(w[2], inv))
        item, _ = at = inside.nonzero(as_tuple=True)
        depth.append(_depth([_at(e, inside.shape, at) * inv[item, 0]
                             for e in w], [z[item, i] for i in range(3)]))
        flat.append((img[item] * H + cy[at]) * W + cx[at])
        fids.append(face[item])
    flat, depth, fids = (torch.cat(a) for a in (flat, depth, fids))
    zbuf = torch.full((B * H * W,), BIG_Z, device=dev)
    zbuf.scatter_reduce_(0, flat, depth, 'amin')
    # the winners: the candidates at the buffered minimum, then the lowest id
    win = depth <= zbuf[flat]
    fid = torch.full((B * H * W,), NO_FACE, dtype=torch.int64, device=dev)
    fid.scatter_reduce_(0, flat[win], fids[win], 'amin')
    pix_to_face = torch.where(fid >= NO_FACE, -1, fid).to(torch.int32)
    return pix_to_face.reshape(B, H, W), zbuf.reshape(B, H, W)


def _nearest(score, k):
    """Indices of the ``k`` largest scores along the last axis, ties in
    index order, with -0 below +0: ``jax.lax.top_k``'s order (a stable
    sort of the scores' total-order keys)."""
    key = _ordered(score.contiguous().view(torch.int32))
    return torch.sort(key, dim=-1, descending=True, stable=True)[1][..., :k]


def rasterize_mesh_tiled(verts, faces, image_size, tile=8, capacity=448,
                         tile_chunk=32, eps=1e-8, coarse_k=None):
    """The dense tile-binned rasterizer (JAX :159-320): the semantics of
    ``rasterize_mesh`` with each ``tile`` x ``tile`` tile keeping the
    ``capacity`` faces of smallest z_min that overlap it (ties to the lower
    face id), then testing its pixels against them and taking per pixel
    the first candidate of smallest z. A face is dropped only where
    ``capacity`` nearer faces overlap the tile. With ``coarse_k``, each
    fine tile chooses from the ``coarse_k`` nearest faces of its 4x tile.
    Tiles go in steps of ``tile_chunk``, which changes no result.

    Returns pix_to_face (B, H, W) int32 and zbuf (B, H, W) float32. No
    gradient.
    """
    B = verts.shape[0]
    F = faces.shape[0]
    H = W = image_size
    if H % tile:
        raise ValueError(f'image_size {H} is not a multiple of tile {tile}')
    Tx, Ty = W // tile, H // tile
    T = Tx * Ty
    capacity = min(capacity, F)
    fx, fy, fz, area = _corners(verts, faces, image_size)
    dev = fx.device
    keep = area > eps
    xmin, xmax = fx.amin(-1), fx.amax(-1)
    ymin, ymax = fy.amin(-1), fy.amax(-1)
    zmin = fz.amin(-1)
    # per face: x0 x1 x2 y0 y1 y2 z0 z1 z2 area, gathered per tile
    table = torch.cat([fx, fy, fz, area[..., None]], -1)   # (B, F, 10)
    ranks = torch.arange(T, device=dev)
    tile_x = (ranks % Tx * tile).float()
    tile_y = (ranks // Tx * tile).float()
    o = torch.arange(tile, dtype=torch.float32, device=dev)
    oy, ox = (a.reshape(-1) for a in torch.meshgrid(o, o, indexing='ij'))
    neg_inf = torch.tensor(-float('inf'), device=dev)

    def overlaps(bx0, bx1, by0, by1, cx, cy, size):
        return ((bx0 <= cx[None, :, None] + (size - 1))
                & (bx1 >= cx[None, :, None])
                & (by0 <= cy[None, :, None] + (size - 1))
                & (by1 >= cy[None, :, None]))

    if coarse_k is not None:
        coarse = tile * 4
        coarse_k = min(coarse_k, F)
        Tx1 = Tx // 4
        T1 = Tx1 * (Ty // 4)
        r1 = torch.arange(T1, device=dev)
        over1 = overlaps(xmin[:, None], xmax[:, None], ymin[:, None],
                         ymax[:, None], (r1 % Tx1 * coarse).float(),
                         (r1 // Tx1 * coarse).float(), coarse) \
            & keep[:, None]
        cand = _nearest(torch.where(over1, -zmin[:, None], neg_inf),
                        coarse_k)                           # (B, T1, k1)
        # out-of-range parents clamp, as XLA's gather does
        parent = ((ranks // Tx // 4) * Tx1 + (ranks % Tx) // 4).clamp(
            max=T1 - 1)

    pf, zb = [], []
    for lo in range(0, T, tile_chunk):
        cx, cy = tile_x[lo:lo + tile_chunk], tile_y[lo:lo + tile_chunk]
        Tc = cx.shape[0]
        if coarse_k is not None:
            cnd = cand[:, parent[lo:lo + tile_chunk]]       # (B, Tc, k1)

            def per(a):
                return a[:, None].expand(B, Tc, F).gather(2, cnd)
        else:
            cnd = None

            def per(a):
                return a[:, None]
        overlap = overlaps(per(xmin), per(xmax), per(ymin), per(ymax),
                           cx, cy, tile) & per(keep)
        k_id = _nearest(torch.where(overlap, -per(zmin), neg_inf), capacity)
        f_valid = overlap.expand(B, Tc, -1).gather(2, k_id)
        # the slots past the chunk's last valid one cover nothing, and an
        # empty pixel takes slot 0 either way: drop them
        used = max(1, int((f_valid * torch.arange(
            1, k_id.shape[-1] + 1, device=dev)).amax()))
        k_id, f_valid = k_id[..., :used], f_valid[..., :used]
        f_id = k_id if cnd is None else cnd.gather(2, k_id)  # (B, Tc, K)
        rows = table.gather(1, f_id.reshape(B, -1, 1).expand(-1, -1, 10))
        g = rows.reshape(B, Tc, 1, -1, 10).unbind(-1)       # (B, Tc, 1, K)
        PX = (cx[:, None] + ox)[None, :, :, None]           # (1, Tc, P, 1)
        PY = (cy[:, None] + oy)[None, :, :, None]
        c = [(g[i], g[3 + i]) for i in range(3)]
        # a valid face has a positive finite 1 / area; the others cover none
        valid = f_valid[:, :, None, :]
        inv = 1.0 / torch.where(valid, g[9], torch.ones_like(g[9]))
        w = [_edge_terms(*c[(i + 1) % 3], *c[(i + 2) % 3], PX, PY)
             for i in range(3)]
        inside = (valid & _covers(w[0], inv) & _covers(w[1], inv)
                  & _covers(w[2], inv))
        at = inside.nonzero(as_tuple=True)
        zin = _depth([_at(e, inside.shape, at) for e in w],
                     [g[6 + i].expand_as(inside)[at] for i in range(3)]) \
            * inv.expand_as(inside)[at]
        z = torch.full(inside.shape, BIG_Z, device=dev)
        z[at] = zin
        best = z.argmin(-1)                                 # (B, Tc, P)
        zbest = z.gather(-1, best[..., None])[..., 0]
        fbest = f_id.gather(2, best)
        pf.append(torch.where(zbest < BIG_Z, fbest, -1))
        zb.append(zbest)

    def image(chunks):
        a = torch.cat(chunks, 1).reshape(B, Ty, Tx, tile, tile)
        return a.permute(0, 1, 3, 2, 4).reshape(B, H, W)
    return image(pf).to(torch.int32), image(zb)


def required_tile_capacity(verts, faces, image_size, tile=16):
    """The most faces that overlap one ``tile`` x ``tile`` tile in any image
    (numpy; JAX :323-349), to size ``capacity`` for a mesh family."""
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    H = W = image_size
    px = (verts[..., 0] + 1) * (W / 2) - 0.5
    py = (verts[..., 1] + 1) * (H / 2) - 0.5
    best = 0
    for b in range(verts.shape[0]):
        fx = px[b][faces]
        fy = py[b][faces]
        x0, x1, x2 = fx[:, 0], fx[:, 1], fx[:, 2]
        y0, y1, y2 = fy[:, 0], fy[:, 1], fy[:, 2]
        area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        keep = area > 1e-8
        Tx = -(-W // tile)
        Ty = -(-H // tile)
        counts = np.zeros((Ty, Tx), np.int64)
        txmin = np.clip(np.floor(fx.min(1) / tile), 0, Tx - 1).astype(int)
        txmax = np.clip(np.floor(fx.max(1) / tile), 0, Tx - 1).astype(int)
        tymin = np.clip(np.floor(fy.min(1) / tile), 0, Ty - 1).astype(int)
        tymax = np.clip(np.floor(fy.max(1) / tile), 0, Ty - 1).astype(int)
        for f in np.nonzero(keep)[0]:
            counts[tymin[f]:tymax[f] + 1, txmin[f]:txmax[f] + 1] += 1
        best = max(best, int(counts.max()))
    return best


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

    with span('sync.interpolate_constant'):
        half = verts.new_tensor(W / 2)
    with span('sync.interpolate_constant'):
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


def visible_faces(verts, faces, image_size, patch=32, face_chunk=2048,
                  impl='auto', tile_capacity=320):
    """pix_to_face (B, H, W), -1 where empty: the visibility of the
    rasterizer that ``select_impl`` picks for attributes (K2, K5 with
    ``patch``, 'tiled' with ``tile_capacity`` or 'scatter' with ``patch``
    and ``face_chunk``)."""
    impl = select_impl(impl, image_size, attributes=True)
    if impl == 'pallas_binned':
        pix_to_face, _ = rasterize_binned(verts, faces, image_size)
    elif impl == 'pallas':
        pix_to_face, _ = rasterize_zbuffer(verts, faces, image_size, patch)
    elif impl == 'tiled':
        pix_to_face, _ = rasterize_mesh_tiled(verts, faces, image_size,
                                              capacity=tile_capacity)
    else:
        pix_to_face, _ = rasterize_mesh(verts, faces, image_size, patch=patch,
                                        face_chunk=face_chunk)
    return pix_to_face


def rasterize_with_attributes(verts, faces, attributes, image_size,
                              patch=32, face_chunk=2048, impl='auto',
                              tile_capacity=320):
    """(B, D + 1, H, W) attribute and alpha images (JAX :420-456):
    ``visible_faces``, then ``interpolate_face_attributes``."""
    pix_to_face = visible_faces(verts, faces, image_size, patch=patch,
                                face_chunk=face_chunk, impl=impl,
                                tile_capacity=tile_capacity)
    return interpolate_face_attributes(verts, faces, attributes, pix_to_face,
                                       image_size)


def rasterize_uv_with_alpha(verts, faces, uv_attrs, image_size, patch=32,
                            face_chunk=2048, impl='auto', tile_capacity=320):
    """verts (B, V, 3) with x, y in [-1, 1] and z depth (smaller in front);
    faces (F, 3); uv_attrs (B or 1, F, 3, 2) per-corner (u, v).

    Returns (B, 3, H, W): (u, v, alpha), with u = v = alpha = 0 where no
    face covers the pixel. The binned impls emit (u, v) from the kernel
    (K1, K3); the others interpolate them after the visibility, as the JAX
    package does (JAX :459-497).
    """
    impl = select_impl(impl, image_size)
    if impl in ('pallas_binned', 'pallas_binned16'):
        fn = rasterize_binned_uv16 if impl == 'pallas_binned16' \
            else rasterize_binned_uv
        pix_to_face, u, v = fn(verts, faces, uv_attrs, image_size)
        alpha = (pix_to_face >= 0).to(u.dtype)
        return torch.stack([u, v, alpha], dim=1)
    ones = torch.ones_like(uv_attrs[..., :1])
    out = rasterize_with_attributes(
        verts, faces, torch.cat([uv_attrs, ones], dim=-1), image_size,
        patch=patch, face_chunk=face_chunk, impl=impl,
        tile_capacity=tile_capacity)            # (B, 4, H, W): u, v, 1, alpha
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
