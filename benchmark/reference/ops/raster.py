"""The binned triangle rasterizers K1 (per-pixel face and (u, v)) and K2
(per-pixel face and depth), as plain torch on any device.

A frozen copy of the plain versions in ``next3d_tpu_torch/ops/raster.py``
(``binned_prep`` and ``_resolve_plain``) and of ``fma32`` from
``ops/raster_zbuffer.py``: the 32-px tiles, the fused rounding and the
(z, face id) tie rule, so that the reference names the same face at every
pixel as the port's kernels do. No kernel is called.
"""

from __future__ import annotations

import math

import torch

TILE = 32
TILE16 = 16
BIG_Z = 1e10
NO_FACE = float(2 ** 30)
# coefficient rows: b0c b0x b0y b1c b1x b1y b2c b2x b2y zc zx zy, then
# uc ux uy vc vx vy with (u, v), then fid
N_COEFF = 19
N_COEFF_Z = 13  # without (u, v)
PLAIN_CHUNK_ELEMS = 1 << 24  # (tile, candidate, pixel) triples per plain step



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


def row_at(c, gx, gy, x, y):
    """A coefficient row (c, gx, gy) at pixel (x, y), rounded as the
    reference rounds it: fma(gy, y, fma(gx, x, c))."""
    return fma32(gy, y, fma32(gx, x, c))


def row_nonnegative(c, gx, gy, x, y):
    """``row_at(c, gx, gy, x, y) >= 0`` for pixel coordinates that are
    integers in [0, 2^29), without rounding the outer fma: in float64,
    y * gy is exact and adding fma(gx, x, c) rounds once, which keeps the
    sign, and so would the float32 rounding of the fused value (a non-zero
    value is a multiple of 2^-149, which rounds to a non-zero float32).
    Infinities and NaNs propagate as in ``row_at``."""
    return gy.double() * y.double() + fma32(gx, x, c).double() >= 0


def face_corners(verts, faces, image_size):
    """The prep's pixel coordinates of each face's corners: x, y, z, each
    (B, F, 3) float32, and the doubled signed area (B, F); the prep keeps a
    face where that area is > 1e-8."""
    H = W = image_size
    verts = verts.detach().float()
    faces = faces.long()
    px = (verts[..., 0] + 1) * (W / 2) - 0.5
    py = (verts[..., 1] + 1) * (H / 2) - 0.5
    fx = px[:, faces]                                        # (B, F, 3)
    fy = py[:, faces]
    fz = verts[..., 2][:, faces]
    x0, x1, x2 = fx.unbind(-1)
    y0, y1, y2 = fy.unbind(-1)
    area = fma32(x1 - x0, y2 - y0, -((y1 - y0) * (x2 - x0)))
    return fx, fy, fz, area


def binned_prep(verts, faces, face_attrs, image_size, tile=TILE):
    """verts (B, V, 3) with x, y in [-1, 1]; faces (F, 3) int; face_attrs
    (B or 1, F, 3, 2) per-corner (u, v), or None for the depth payload;
    tile 32 or 16.

    Returns slab (B, K, E) float32, the K coefficient rows (19 with (u, v),
    13 without) of the E = 4F (tile 32) or 9F (tile 16) entries in tile
    order, and starts (B, T + 1) int32, the segment bounds per tile.
    """
    B = verts.shape[0]
    F = faces.shape[0]
    H = W = image_size
    if tile not in (TILE, TILE16):
        raise ValueError(f'tile {tile} is neither {TILE} nor {TILE16}')
    if H % tile:
        raise ValueError(f'image_size {H} is not a multiple of {tile}')
    Tx = W // tile
    Ty = H // tile
    T = Tx * Ty
    fx, fy, fz, area = face_corners(verts, faces, image_size)
    x0, x1, x2 = fx.unbind(-1)
    y0, y1, y2 = fy.unbind(-1)
    z0, z1, z2 = fz.unbind(-1)
    keep = area > 1e-8
    inv = torch.where(keep, 1.0 / torch.where(keep, area,
                                              torch.ones_like(area)),
                      torch.zeros_like(area))

    def edge_coeffs(xa, ya, xb, yb):
        return (fma32(yb - ya, xa, -((xb - xa) * ya)) * inv,
                -(yb - ya) * inv, (xb - xa) * inv)

    b0c, b0x, b0y = edge_coeffs(x1, y1, x2, y2)
    b1c, b1x, b1y = edge_coeffs(x2, y2, x0, y0)
    b2c, b2x, b2y = edge_coeffs(x0, y0, x1, y1)

    def affine(a0, a1, a2):
        return tuple(fma32(r2, a2, fma32(r0, a0, r1 * a1)) for r0, r1, r2 in
                     ((b0c, b1c, b2c), (b0x, b1x, b2x), (b0y, b1y, b2y)))

    rows = [*affine(z0, z1, z2)]
    if face_attrs is not None:
        fa = face_attrs.detach().float().expand(B, F, 3, 2)
        rows += affine(fa[..., 0, 0], fa[..., 1, 0], fa[..., 2, 0])
        rows += affine(fa[..., 0, 1], fa[..., 1, 1], fa[..., 2, 1])
    b0c = torch.where(keep, b0c, torch.full_like(b0c, -float('inf')))
    fid = torch.arange(F, dtype=torch.float32,
                       device=verts.device).expand(B, F)
    coeffs = torch.stack([b0c, b0x, b0y, b1c, b1x, b1y, b2c, b2x, b2y,
                          *rows, fid], dim=-1)              # (B, F, K)

    def tile_of(v, n):
        return torch.clamp(torch.floor(v / tile), 0, n - 1).long()

    txlo = tile_of(torch.minimum(torch.minimum(x0, x1), x2), Tx)
    txhi = tile_of(torch.maximum(torch.maximum(x0, x1), x2), Tx)
    tylo = tile_of(torch.minimum(torch.minimum(y0, y1), y2), Ty)
    tyhi = tile_of(torch.maximum(torch.maximum(y0, y1), y2), Ty)
    dummy = torch.full_like(txlo, T)
    if tile == TILE:
        # the 4 bbox-corner tiles, duplicates routed to the dummy tile T
        e00 = tylo * Tx + txlo
        e01 = torch.where(txhi > txlo, tylo * Tx + txhi, dummy)
        e10 = torch.where(tyhi > tylo, tyhi * Tx + txlo, dummy)
        e11 = torch.where((txhi > txlo) & (tyhi > tylo), tyhi * Tx + txhi,
                          dummy)
        tids = torch.stack([e00, e01, e10, e11], dim=-1)     # (B, F, 4)
    else:
        # the 3x3 tile rectangle from the bbox-min tile, cut to the bbox
        tids = torch.stack([
            torch.where((txlo + dx <= txhi) & (tylo + dy <= tyhi),
                        (tylo + dy) * Tx + txlo + dx, dummy)
            for dy in range(3) for dx in range(3)], dim=-1)  # (B, F, 9)
    n_entries = tids.shape[-1]
    tids = torch.where(keep[..., None], tids, T).reshape(B, n_entries * F)

    tids_sorted, order = torch.sort(tids, dim=1, stable=True)
    K = coeffs.shape[-1]
    face_of = (order // n_entries)[..., None].expand(B, n_entries * F, K)
    slab = coeffs.gather(1, face_of).transpose(1, 2).contiguous()
    bounds = torch.arange(T + 1, device=verts.device).expand(B, T + 1)
    starts = torch.searchsorted(tids_sorted, bounds.contiguous())
    return slab, starts.to(torch.int32)


def _resolve_plain(slab, starts, image_size, tile):
    """Plain torch resolve: per tile, a dense (candidates x pixels)
    evaluation with the kernels' arithmetic and tie rule, tiles in chunks
    of at most PLAIN_CHUNK_ELEMS (tile, candidate, pixel) triples (one tile
    a chunk where a segment alone is longer).

    Returns (pix_to_face, u, v) for a 19-row slab and (pix_to_face, zbuf)
    for a 13-row one, each (B, H, W)."""
    B, K, E = slab.shape
    H = W = image_size
    Tx = W // tile
    T = Tx * (H // tile)
    P = tile * tile
    with_uv = K == N_COEFF
    dev = slab.device
    pf = torch.full((B * T, P), -1, dtype=torch.int32, device=dev)
    if with_uv:
        outs = [torch.zeros((B * T, P), dtype=torch.float32, device=dev)
                for _ in range(2)]
    else:
        outs = [torch.full((B * T, P), BIG_Z, dtype=torch.float32,
                           device=dev)]

    first = starts[:, :-1].reshape(-1).long()
    count = (starts[:, 1:] - starts[:, :-1]).reshape(-1).long()
    rows = slab.transpose(1, 2).reshape(B * E, K)
    pix = torch.arange(P, device=dev)
    span = torch.arange(tile, device=dev)
    # tiles by falling segment length, so that a chunk pads its candidates
    # only to its own longest segment; empty tiles keep the initial values
    order = torch.argsort(count, descending=True)
    lengths = count[order].tolist()
    c0 = 0
    while c0 < B * T and lengths[c0] > 0:
        L = lengths[c0]
        bt = order[c0:c0 + max(1, PLAIN_CHUNK_ELEMS // (L * P))]
        c0 += bt.numel()
        x0 = ((bt % T) % Tx) * tile                             # (c,)
        y0 = ((bt % T) // Tx) * tile
        gx = (x0[:, None] + pix % tile).float()                 # (c, P)
        gy = (y0[:, None] + pix // tile).float()
        xs = (x0[:, None] + span).float()[:, None]              # (c, 1, tile)
        ys = (y0[:, None] + span).float()[:, None, :, None]     # (c, 1, tile, 1)
        lane = torch.arange(L, device=dev)
        valid = lane[None] < count[bt, None]                    # (c, L)
        idx = torch.where(valid, first[bt, None] + lane[None], 0)
        cf = rows[(bt // T * E)[:, None] + idx]                 # (c, L, K)

        def nonnegative(j):
            # row j >= 0 at every pixel of the tile, (c, L, P)
            return row_nonnegative(
                cf[..., j, None, None], cf[..., j + 1, None, None],
                cf[..., j + 2, None, None], xs[:, None], ys).reshape(-1, L, P)

        inside = nonnegative(0) & nonnegative(3) & nonnegative(6) \
            & valid[..., None]
        # the depth, exactly rounded, only where the candidate covers
        ci, li, pi = inside.nonzero(as_tuple=True)
        z = torch.full(inside.shape, BIG_Z, device=dev)
        zx = fma32(cf[..., 10, None], xs, cf[..., 9, None])    # (c, L, tile)
        z[ci, li, pi] = fma32(cf[ci, li, 11], gy[ci, pi],
                              zx[ci, li, pi % tile])
        zmin = torch.clamp(z.min(dim=1).values, max=BIG_Z)      # (c, P)
        fid = torch.where(inside & (z == zmin[:, None]),
                          cf[..., K - 1, None], NO_FACE)
        fmin = fid.min(dim=1).values
        hit = fmin < NO_FACE
        pf[bt] = torch.where(hit, fmin, -1.0).to(torch.int32)
        if not with_uv:
            outs[0][bt] = zmin
            continue
        # a face has at most one entry per tile, so (z, fid) names one lane
        win = (fid == fmin[:, None]).float().argmax(dim=1)      # (c, P)
        sel = cf.gather(1, win[..., None].expand(-1, -1, K))    # (c, P, K)
        u = row_at(sel[..., 12], sel[..., 13], sel[..., 14], gx, gy)
        v = row_at(sel[..., 15], sel[..., 16], sel[..., 17], gx, gy)
        outs[0][bt] = torch.where(hit, u, 0.0)
        outs[1][bt] = torch.where(hit, v, 0.0)

    def image(a):
        return a.reshape(B, H // tile, Tx, tile, tile).permute(
            0, 1, 3, 2, 4).reshape(B, H, W)

    return (image(pf), *(image(o) for o in outs))


def rasterize_binned_uv(verts, faces, face_attrs, image_size):
    """K1: (pix_to_face (B, H, W) int32, -1 where empty; u, v (B, H, W)
    float32, 0 where empty)."""
    slab, starts = binned_prep(verts, faces, face_attrs, image_size)
    return _resolve_plain(slab, starts, image_size, TILE)


def rasterize_binned(verts, faces, image_size):
    """K2: (pix_to_face (B, H, W) int32, -1 where empty; zbuf (B, H, W)
    float32, 1e10 where no face covers the pixel)."""
    slab, starts = binned_prep(verts, faces, None, image_size)
    return _resolve_plain(slab, starts, image_size, TILE)
