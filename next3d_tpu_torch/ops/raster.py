"""K1, K2 and K3: the binned triangle rasterizers.

Counterparts of next3d_tpu/ops/pallas_raster.py
rasterize_mesh_pallas_binned_uv (K1), rasterize_mesh_pallas_binned (K2) and
rasterize_mesh_pallas_binned_uv16 (K3). ``binned_prep`` bins the faces as
the JAX prep does (``_binned_uv_entries``, ``_binned_uv_entries16``,
``_binned_prep``): per-face affine edge/z coefficients, with (u, v) for K1
and K3 or without for K2, the tile entries of each face, a stable sort by
tile id and the segment starts. The entry rule follows the tile: at 32 px
the 4 bbox-corner tiles, at 16 px the 3x3 tile rectangle from the
bbox-min tile. On a CUDA tensor the prep runs as the kernels in
``csrc/raster_binned_prep.cu`` (``binned_prep_cuda``: the same rows and
segments, each segment's entries in arbitrary order), on a CPU tensor as
torch. The resolve then tests every pixel of every tile against its
tile's segment: on a CUDA tensor with the kernels in
``csrc/raster_binned_uv.cu``, on a CPU tensor with the plain version below,
which uses the same arithmetic and tie rule. Both resolves take per pixel
the lexicographic minimum of (z, face id) over the covering candidates, so
their results do not depend on the order of a segment's entries.

Exactness: a face's bbox must span less than 32 px, so that its entries
reach every tile it overlaps (the model checks this for its topology at
construction). K1, K2 and K3 then agree with each other bit for bit.
"""

from __future__ import annotations

import torch

from . import cuda_build

TILE = 32
TILE16 = 16
BIG_Z = 1e10
NO_FACE = float(2 ** 30)
# coefficient rows: b0c b0x b0y b1c b1x b1y b2c b2x b2y zc zx zy, then
# uc ux uy vc vx vy with (u, v), then fid
N_COEFF = 19
N_COEFF_Z = 13  # without (u, v)
PLAIN_CHUNK_ELEMS = 1 << 24  # (tile, candidate, pixel) triples per plain step


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
    faces = faces.long()
    verts = verts.detach().float()

    px = (verts[..., 0] + 1) * (W / 2) - 0.5
    py = (verts[..., 1] + 1) * (H / 2) - 0.5
    fx = px[:, faces]                                        # (B, F, 3)
    fy = py[:, faces]
    fz = verts[..., 2][:, faces]
    x0, x1, x2 = fx.unbind(-1)
    y0, y1, y2 = fy.unbind(-1)
    z0, z1, z2 = fz.unbind(-1)
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    keep = area > 1e-8
    inv = torch.where(keep, 1.0 / torch.where(keep, area,
                                              torch.ones_like(area)),
                      torch.zeros_like(area))

    def edge_coeffs(xa, ya, xb, yb):
        return (((yb - ya) * xa - (xb - xa) * ya) * inv,
                -(yb - ya) * inv, (xb - xa) * inv)

    b0c, b0x, b0y = edge_coeffs(x1, y1, x2, y2)
    b1c, b1x, b1y = edge_coeffs(x2, y2, x0, y0)
    b2c, b2x, b2y = edge_coeffs(x0, y0, x1, y1)

    def affine(a0, a1, a2):
        return (b0c * a0 + b1c * a1 + b2c * a2,
                b0x * a0 + b1x * a1 + b2x * a2,
                b0y * a0 + b1y * a1 + b2y * a2)

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
    # tiles by falling segment length, so that a chunk pads its candidates
    # only to its own longest segment; empty tiles keep the initial values
    order = torch.argsort(count, descending=True)
    lengths = count[order].tolist()
    c0 = 0
    while c0 < B * T and lengths[c0] > 0:
        L = lengths[c0]
        bt = order[c0:c0 + max(1, PLAIN_CHUNK_ELEMS // (L * P))]
        c0 += bt.numel()
        gx = (((bt % T) % Tx) * tile)[:, None] + pix % tile     # (c, P)
        gy = (((bt % T) // Tx) * tile)[:, None] + pix // tile
        gx, gy = gx.float(), gy.float()
        lane = torch.arange(L, device=dev)
        valid = lane[None] < count[bt, None]                    # (c, L)
        idx = torch.where(valid, first[bt, None] + lane[None], 0)
        cf = rows[(bt // T * E)[:, None] + idx]                 # (c, L, K)
        cx, cy = gx[:, None], gy[:, None]                       # (c, 1, P)

        def aff(j):
            return (cf[..., j, None] + cf[..., j + 1, None] * cx) \
                + cf[..., j + 2, None] * cy                     # (c, L, P)

        inside = (aff(0) >= 0) & (aff(3) >= 0) & (aff(6) >= 0) \
            & valid[..., None]
        z = torch.where(inside, aff(9), BIG_Z)
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
        u = (sel[..., 12] + sel[..., 13] * gx) + sel[..., 14] * gy
        v = (sel[..., 15] + sel[..., 16] * gx) + sel[..., 17] * gy
        outs[0][bt] = torch.where(hit, u, 0.0)
        outs[1][bt] = torch.where(hit, v, 0.0)

    def image(a):
        return a.reshape(B, H // tile, Tx, tile, tile).permute(
            0, 1, 3, 2, 4).reshape(B, H, W)

    return (image(pf), *(image(o) for o in outs))


def _resolve_cuda(slab, starts, image_size, tile, counted):
    """Launch the instance of csrc/raster_binned_uv.cu for this tile and
    payload; ``counted`` is the public wrapper whose launch count grows."""
    B, K, E = slab.shape
    H = W = image_size
    T = (W // tile) * (H // tile)
    entry = {(TILE, N_COEFF): 'raster_binned_uv',
             (TILE16, N_COEFF): 'raster_binned_uv16',
             (TILE, N_COEFF_Z): 'raster_binned'}.get((tile, K))
    if entry is None or slab.dtype != torch.float32 \
            or not slab.is_contiguous():
        raise ValueError(f'slab must be contiguous float32 (B, {N_COEFF}, E) '
                         f'or, at tile {TILE}, (B, {N_COEFF_Z}, E)')
    if starts.dtype != torch.int32 or not starts.is_contiguous() \
            or starts.shape != (B, T + 1) or starts.device != slab.device:
        raise ValueError(f'starts must be contiguous int32 ({B}, {T + 1}) '
                         f'on {slab.device}')
    pf = torch.empty((B, H, W), dtype=torch.int32, device=slab.device)
    outs = [torch.empty((B, H, W), dtype=torch.float32, device=slab.device)
            for _ in range(2 if K == N_COEFF else 1)]
    cuda_build.launch('raster_binned_uv', entry, slab.device,
                      slab.data_ptr(), starts.data_ptr(), pf.data_ptr(),
                      outs[0].data_ptr(),
                      outs[1].data_ptr() if len(outs) == 2 else None,
                      B, E, H, W)
    counted.launches += 1
    return (pf, *outs)


def binned_prep_cuda(verts, faces, face_attrs, image_size, tile=TILE):
    """``binned_prep``'s contract on CUDA tensors, by the kernels in
    ``csrc/raster_binned_prep.cu`` (a memset and two launches). ``starts``
    and each segment's set of entries equal ``binned_prep``'s, and every
    coefficient row is bit-equal; the order of the entries inside a
    segment is arbitrary (the resolve does not depend on it) and the slab
    past ``starts[:, T]`` is left unwritten. ``faces`` must index
    ``verts``."""
    B, V, _ = verts.shape
    F = faces.shape[0]
    H = W = image_size
    if tile not in (TILE, TILE16) or (tile == TILE16 and face_attrs is None):
        raise ValueError(f'no prep kernel for tile {tile} '
                         f'{"without" if face_attrs is None else "with"} '
                         f'(u, v)')
    if H % tile:
        raise ValueError(f'image_size {H} is not a multiple of {tile}')
    dev = verts.device
    verts = verts.detach().float().contiguous()
    faces = faces.long().contiguous()
    if verts.shape[-1] != 3 or faces.shape != (F, 3) or faces.device != dev:
        raise ValueError('verts must be (B, V, 3) and faces (F, 3) on one '
                         'device')
    attrs, batched = None, 0
    if face_attrs is not None:
        attrs = face_attrs.detach().float().contiguous()
        if attrs.shape[1:] != (F, 3, 2) or attrs.shape[0] not in (1, B) \
                or attrs.device != dev:
            raise ValueError(f'face_attrs must be (1 or {B}, {F}, 3, 2) on '
                             f'{dev}')
        batched = int(attrs.shape[0] > 1)
    T = (W // tile) * (H // tile)
    K = N_COEFF if face_attrs is not None else N_COEFF_Z
    E = (4 if tile == TILE else 9) * F
    slab = torch.empty((B, K, E), dtype=torch.float32, device=dev)
    # starts, then the kernels' tile counts and fill cursors
    ints = torch.empty((3, B, T + 1), dtype=torch.int32, device=dev)
    cuda_build.launch('raster_binned_prep', 'raster_binned_prep', dev,
                      verts.data_ptr(), faces.data_ptr(),
                      None if attrs is None else attrs.data_ptr(), batched,
                      slab.data_ptr(), ints[0].data_ptr(),
                      ints[1].data_ptr(), B, V, F, image_size, tile)
    return slab, ints[0]


def segments_in_face_order(slab, starts):
    """Per image b, the entries of ``slab`` before ``starts[b, T]`` sorted by
    tile, then face id: ``binned_prep``'s order, in which a
    ``binned_prep_cuda`` slab compares with it bit for bit. A list of
    (K, starts[b, T]) tensors."""
    out = []
    for rows, bounds in zip(slab, starts.long()):
        n = int(bounds[-1])
        pos = torch.arange(n, device=rows.device)
        tile = torch.searchsorted(bounds, pos, right=True) - 1
        key = tile * rows.shape[1] + rows[-1, :n].long()
        out.append(rows[:, :n][:, torch.argsort(key)])
    return out


def _rasterize(counted, verts, faces, face_attrs, image_size, tile):
    if verts.is_cuda:
        slab, starts = binned_prep_cuda(verts, faces, face_attrs, image_size,
                                        tile)
        return _resolve_cuda(slab, starts, image_size, tile, counted)
    slab, starts = binned_prep(verts, faces, face_attrs, image_size, tile)
    return _resolve_plain(slab, starts, image_size, tile)


def rasterize_binned_uv(verts, faces, face_attrs, image_size):
    """K1. Returns (pix_to_face (B, H, W) int32, -1 where empty; u, v
    (B, H, W) float32, 0 where empty). Launches the CUDA kernel for CUDA
    tensors and runs the plain version for CPU tensors. Not
    differentiable."""
    return _rasterize(rasterize_binned_uv, verts, faces, face_attrs,
                      image_size, TILE)


def rasterize_binned_uv16(verts, faces, face_attrs, image_size):
    """K3: K1's contract and results, resolved in 16-px tiles."""
    return _rasterize(rasterize_binned_uv16, verts, faces, face_attrs,
                      image_size, TILE16)


def rasterize_binned(verts, faces, image_size):
    """K2: K1's visibility. Returns (pix_to_face (B, H, W) int32, -1 where
    empty; zbuf (B, H, W) float32, 1e10 where no face covers the pixel)."""
    return _rasterize(rasterize_binned, verts, faces, None, image_size, TILE)


rasterize_binned_uv.launches = 0
rasterize_binned_uv16.launches = 0
rasterize_binned.launches = 0


def rasterize_binned_uv_plain(verts, faces, face_attrs, image_size):
    """K1's plain torch version on any device (the reference the kernel is
    held against)."""
    slab, starts = binned_prep(verts, faces, face_attrs, image_size)
    return _resolve_plain(slab, starts, image_size, TILE)


def rasterize_binned_uv16_plain(verts, faces, face_attrs, image_size):
    """K3's plain torch version on any device."""
    slab, starts = binned_prep(verts, faces, face_attrs, image_size, TILE16)
    return _resolve_plain(slab, starts, image_size, TILE16)


def rasterize_binned_plain(verts, faces, image_size):
    """K2's plain torch version on any device."""
    slab, starts = binned_prep(verts, faces, None, image_size)
    return _resolve_plain(slab, starts, image_size, TILE)
