"""The binned resolve kernels' coarse test (csrc/raster_binned_uv.cu) on the
CPU, through its plain mirror ops/raster.py cull_plain: no candidate culled
from a sub-tile covers a pixel of it, and a resolve that sees only each
sub-tile's surviving candidates is bit-equal to the plain resolve for K1,
K2 and K3. The inputs are the flagship's 4-view head and the seeded
adversarial meshes of utils/raster_cases.py; tests/test_torch_cuda.py holds
the kernels to their plain versions on the same inputs on the card."""

import pytest
import torch

from next3d_tpu_torch.ops.raster import (SUB_H, SUB_W, TILE, _resolve_plain,
                                         binned_prep, cull_plain,
                                         face_corners, row_at,
                                         row_nonnegative)
from next3d_tpu_torch.utils.raster_cases import adversarial_mesh, four_views
from next3d_tpu_torch.utils.synthetic_head import synthetic_head
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)

CASES = {
    'four-views': lambda: (*four_views(synthetic_head()[0], 6), 256),
    'adversarial-64': lambda: (*adversarial_mesh(2, 64, 400, 0), 64),
    'adversarial-128': lambda: (*adversarial_mesh(2, 128, 1500, 1), 128),
}
KERNELS = pytest.mark.parametrize('with_attrs,tile', [
    (True, 32), (False, 32), (True, 16)], ids=['K1', 'K2', 'K3'])


def _slab(case, with_attrs, tile):
    verts, faces, attrs, H = CASES[case]()
    slab, starts = binned_prep(torch.from_numpy(verts),
                               torch.from_numpy(faces),
                               torch.from_numpy(attrs) if with_attrs
                               else None, H, tile)
    return slab, starts, H


def _tile_of_entries(slab, starts):
    B, _, E = slab.shape
    pos = torch.arange(E).expand(B, E).contiguous()
    return torch.searchsorted(starts.long().contiguous(), pos,
                              right=True) - 1


def _sub_of_pixels(H, tile):
    """(H, H): the number of each pixel's sub-tile within its tile."""
    yy, xx = torch.meshgrid(torch.arange(H), torch.arange(H), indexing='ij')
    return ((yy % tile) // SUB_H) * (tile // SUB_W) + (xx % tile) // SUB_W


@pytest.mark.parametrize('case', list(CASES))
@pytest.mark.parametrize('tile', [32, 16])
def test_culled_candidates_cover_no_pixel_of_their_sub_tile(case, tile):
    """Every (entry, sub-tile) pair that cull_plain drops is tested at each
    of the sub-tile's pixels with the resolve's per-pixel arithmetic (the
    sign of the fused row_at, row_nonnegative): none passes all three
    edges.
    And culling does its work: under half of the pairs survive."""
    slab, starts, H = _slab(case, False, tile)
    keep = cull_plain(slab, starts, H, tile)
    B, _, E = slab.shape
    S = keep.shape[-1]
    assert S == (tile // SUB_W) * (tile // SUB_H)
    t = _tile_of_entries(slab, starts)
    valid = t < (H // tile) ** 2
    Tx = H // tile
    t = t.clamp(max=Tx * Tx - 1)
    for s in range(S):
        # the sub-tile's columns (B, E, 1, SUB_W) and rows (B, E, SUB_H, 1)
        x = ((t % Tx) * tile + (s % (tile // SUB_W)) * SUB_W)[..., None,
                                                              None] \
            + torch.arange(SUB_W)
        y = ((t // Tx) * tile + (s // (tile // SUB_W)) * SUB_H)[..., None,
                                                               None] \
            + torch.arange(SUB_H)[:, None]
        x, y = x.float(), y.float()
        inside = (valid & ~keep[..., s])[..., None, None]
        for e in (0, 3, 6):
            c, gx, gy = (slab[:, e + d, :, None, None] for d in range(3))
            inside = inside & row_nonnegative(c, gx, gy, x, y)
        assert not bool(inside.any()), (case, tile, s)
    kept = int(keep.sum())
    n = int(valid.sum())
    print(f'{case} tile {tile}: {kept} of {n * S} (entry, sub-tile) pairs '
          f'survive ({kept / (n * S):.3f})')
    assert 0 < kept < 0.5 * n * S


def _resolve_culled(slab, starts, H, tile):
    """The plain resolve as the kernel sees the segments: for each sub-tile
    number s, _resolve_plain of the slab cut to the entries that survive in
    sub-tile s of their tile (each segment shrinks in place, order kept),
    read at the pixels of the sub-tiles numbered s."""
    keep = cull_plain(slab, starts, H, tile)
    B, K, E = slab.shape
    T = (H // tile) ** 2
    t = _tile_of_entries(slab, starts)
    sub = _sub_of_pixels(H, tile)
    out = None
    for s in range(keep.shape[-1]):
        k = keep[..., s]
        order = torch.argsort((~k).to(torch.int8), dim=1, stable=True)
        cut = slab.gather(2, order[:, None].expand(B, K, E))
        counts = torch.zeros(B, T + 1, dtype=torch.long).scatter_add_(
            1, t, k.long())[:, :T]
        cut_starts = torch.cat([torch.zeros(B, 1, dtype=torch.long),
                                counts.cumsum(1)], 1).to(torch.int32)
        got = _resolve_plain(cut, cut_starts, H, tile)
        if out is None:
            out = [g.clone() for g in got]
        for o, g in zip(out, got):
            o[:, sub == s] = g[:, sub == s]
    return out


@pytest.mark.parametrize('case', list(CASES))
@KERNELS
def test_resolve_of_surviving_candidates_is_bit_equal(case, with_attrs,
                                                      tile):
    slab, starts, H = _slab(case, with_attrs, tile)
    want = _resolve_plain(slab, starts, H, tile)
    got = _resolve_culled(slab, starts, H, tile)
    assert len(got) == (3 if with_attrs else 2)
    assert float((want[0] >= 0).float().mean()) > 0.05
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_adversarial_mesh_has_its_edge_cases():
    """The adversarial input holds what it is meant to: dropped faces (zero
    area, back-facing) beside kept ones, every bbox under 32 px, pixels on
    which an edge value is exactly 0 and the face still covers them, and
    pixels covered by two faces at one depth."""
    verts, faces, attrs = adversarial_mesh(2, 64, 400, 0)
    H = 64
    fx, fy, _, area = face_corners(torch.from_numpy(verts),
                                   torch.from_numpy(faces), H)
    keep = area > 1e-8
    assert 0.5 < float(keep.float().mean()) < 0.95
    assert bool((area == 0).any()) and bool((area < -1e-8).any())
    span = torch.maximum(fx.amax(-1) - fx.amin(-1), fy.amax(-1) - fy.amin(-1))
    assert float(span.max()) < TILE
    slab, starts = binned_prep(torch.from_numpy(verts),
                               torch.from_numpy(faces), None, H)
    t = _tile_of_entries(slab, starts)
    valid = t < (H // TILE) ** 2
    t = t.clamp(max=(H // TILE) ** 2 - 1)
    p = torch.arange(TILE * TILE)
    x = (((t % (H // TILE)) * TILE)[..., None] + p % TILE).float()
    y = (((t // (H // TILE)) * TILE)[..., None] + p // TILE).float()
    w = [row_at(slab[:, e, :, None], slab[:, e + 1, :, None],
                slab[:, e + 2, :, None], x, y) for e in (0, 3, 6)]
    inside = valid[..., None] & (w[0] >= 0) & (w[1] >= 0) & (w[2] >= 0)
    on_edge = inside & ((w[0] == 0) | (w[1] == 0) | (w[2] == 0))
    print(f'{int(inside.sum())} covered (entry, pixel) pairs, '
          f'{int(on_edge.sum())} with an edge value exactly 0')
    assert int(on_edge.sum()) > 0
    z = row_at(slab[:, 9, :, None], slab[:, 10, :, None],
               slab[:, 11, :, None], x, y)
    z = torch.where(inside, z, torch.inf)
    ties = 0
    for b in range(verts.shape[0]):
        pix = (t[b, :, None] * TILE * TILE + p)[inside[b]]
        zs = z[b][inside[b]]
        key = torch.stack([pix.double(), zs.double()], 1)
        ties += len(key) - len(torch.unique(key, dim=0))
    print(f'{ties} covered pixels with two faces at one depth')
    assert ties > 0
