"""K5's face kernel culls each face's stripe coarse to fine
(csrc/raster_zbuffer.cu): column strips, then 8x4 sub-tiles, each by an
exact corner test. Here, on the CPU, through its plain mirror
ops/raster_zbuffer.py cull_plain: no sub-tile culled from a face holds a
pixel that passes the face's per-pixel test, and a resolve that tests each
face only at the pixels of its surviving sub-tiles is bit-equal to the plain
version, which tests every stripe pixel. The inputs are the flagship's
4-view head, the adversarial meshes of the binned kernels, seeded
near-degenerate slivers and K5's own case set (utils/raster_cases.py);
tests/test_torch_cuda.py holds the kernel to its plain version on the same
kinds of input on the card."""

import pytest
import torch

from next3d_tpu_torch.ops.raster_zbuffer import (KEY_EMPTY, SUB_H, SUB_W,
                                                 _barycentric, _cover,
                                                 _decode, _edges,
                                                 _zbuffer_plain, cull_plain,
                                                 fma32, zbuffer_prep)
from next3d_tpu_torch.utils.raster_cases import (adversarial_mesh,
                                                 four_views, named_sliver,
                                                 sliver_sweep, zbuffer_mesh)
from next3d_tpu_torch.utils.synthetic_head import synthetic_head

from torch_parity import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures('one_thread')

# (verts, faces, image size, patch) makers
CASES = {
    'four-views': lambda: (*four_views(synthetic_head()[0], 6)[:2], 256, 32),
    'named-sliver': lambda: (*named_sliver(), 64, 32),
    'adversarial-64': lambda: (*adversarial_mesh(2, 64, 400, 0)[:2], 64, 32),
    'sliver-sweep-64': lambda: (*sliver_sweep(8, 64, 40, 0), 64, 32),
    'zbuffer-mesh-64': lambda: (*zbuffer_mesh(2, 64, 300, 0), 64, 32),
    'zbuffer-mesh-128-patch16': lambda: (*zbuffer_mesh(2, 128, 600, 3), 128,
                                         16),
    'zbuffer-mesh-128-patch64': lambda: (*zbuffer_mesh(2, 128, 600, 2), 128,
                                         64),
}
CHUNK = 1 << 20  # (face, pixel) pairs a step


def _prep(case):
    verts, faces, H, patch = CASES[case]()
    data, y0, stripe_h = zbuffer_prep(torch.from_numpy(verts),
                                      torch.from_numpy(faces), H, patch)
    return data, y0, H, stripe_h


def _covered_sub_tiles(data, y0, item, H, stripe_h):
    """(K, stripe_h / SUB_H, W / SUB_W) bool: the sub-tiles in which kept
    face ``item`` passes the per-pixel test at some pixel, every stripe
    pixel tested with the plain version's arithmetic."""
    B, _, F = data.shape
    fd = data.permute(0, 2, 1).reshape(B * F, 10)
    px = torch.arange(H).float()[None, None]
    out = []
    step = max(1, CHUNK // (stripe_h * H))
    for c0 in range(0, item.numel(), step):
        it = item[c0:c0 + step]
        f = [a[:, None, None] for a in fd[it].unbind(1)]
        py = (y0.reshape(-1)[it][:, None] + torch.arange(stripe_h)).float()
        py = py[..., None]                                    # (c, S, 1)
        inside = torch.ones((), dtype=torch.bool)
        for e in _edges(f):
            inside = inside & (_barycentric(*e, f[9], px, py) >= 0)
        out.append(inside.reshape(len(it), stripe_h // SUB_H, SUB_H,
                                  H // SUB_W, SUB_W).any(4).any(2))
    return torch.cat(out)


@pytest.mark.parametrize('case', list(CASES))
def test_culled_sub_tiles_hold_no_covered_pixel(case):
    """Every (kept face, sub-tile) pair that either level culls is tested
    at each of the sub-tile's pixels: none passes. And culling does its
    work: on the head under a fifth of the strips and a fiftieth of the
    sub-tiles survive, on every input under a half of the sub-tiles."""
    data, y0, H, stripe_h = _prep(case)
    item, strips, subs = cull_plain(data, y0, H, stripe_h)
    assert strips.shape == (item.numel(), H // SUB_W)
    assert subs.shape == (item.numel(), stripe_h // SUB_H, H // SUB_W)
    assert bool((subs <= strips[:, None]).all())
    covered = _covered_sub_tiles(data, y0, item, H, stripe_h)
    assert bool((covered <= subs).all()), case
    print(f'{case}: {item.numel()} kept faces; {int(strips.sum())} of '
          f'{strips.numel()} strips and {int(subs.sum())} of {subs.numel()} '
          f'sub-tiles survive, {int(covered.sum())} hold a covered pixel')
    assert 0 < int(covered.sum()) <= int(subs.sum()) < subs.numel() / 2
    if case == 'four-views':
        assert int(strips.sum()) < strips.numel() / 5
        assert int(subs.sum()) < subs.numel() / 50


def _resolve_survivors(data, y0, H, stripe_h):
    """The plain resolve as the face kernel works: each kept face tested
    only at the pixels of the sub-tiles that cull_plain keeps."""
    B, _, F = data.shape
    item, _, subs = cull_plain(data, y0, H, stripe_h)
    k, sy, sx = torch.nonzero(subs, as_tuple=True)
    it = item[k]
    p = torch.arange(SUB_W * SUB_H)
    row = (y0.reshape(-1)[it].long() + sy * SUB_H)[:, None] + p // SUB_W
    col = (sx * SUB_W)[:, None] + p % SUB_W
    keys = torch.full((B * H * H,), KEY_EMPTY, dtype=torch.int64)
    _cover(keys, data.permute(0, 2, 1).reshape(B * F, 10)[it], it, F, H,
           row, col)
    return _decode(keys, (B, H, H))


@pytest.mark.parametrize('case', list(CASES))
def test_resolve_of_surviving_sub_tiles_is_bit_equal(case):
    data, y0, H, stripe_h = _prep(case)
    want = _zbuffer_plain(data, y0, H, stripe_h)
    got = _resolve_survivors(data, y0, H, stripe_h)
    assert int((want[0] >= 0).sum()) > 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_zbuffer_mesh_has_its_cases():
    """K5's case set holds what it is meant to: kept faces wider than 32 px,
    faces taller than the stripe that the stripe cuts, kept faces with
    corners at negative coordinates and past the far borders, slivers whose
    rounded test passes pixels outside their bbox, pixels on which an
    edge's barycentric is exactly 0 and the face still covers them, and
    covered pixels where two faces tie in depth."""
    verts, faces = zbuffer_mesh(2, 128, 600, 3)
    H, stripe_h = 128, 40
    data, y0, _ = zbuffer_prep(torch.from_numpy(verts),
                               torch.from_numpy(faces), H, 32)
    kept = data[:, 9] > 0
    x, y = data[:, 0:3], data[:, 3:6]
    span_x = x.amax(1) - x.amin(1)
    span_y = y.amax(1) - y.amin(1)
    assert bool((kept & (span_x > 32)).any())
    assert bool((kept & (span_y > stripe_h)).any())
    assert bool((kept & (x.amin(1) < 0) & (y.amin(1) < 0)).any())
    assert bool((kept & (x.amax(1) > H - 1) & (y.amax(1) > H - 1)).any())
    assert bool((~kept).any())

    B, _, F = data.shape
    fd = data.permute(0, 2, 1).reshape(B * F, 10)
    item = torch.nonzero(fd[:, 9] > 0).squeeze(1)
    f = [a[:, None, None] for a in fd[item].unbind(1)]
    py = (y0.reshape(-1)[item][:, None] + torch.arange(stripe_h)).float()
    px = torch.arange(H).float()[None, None]
    b = [_barycentric(*e, f[9], px, py[..., None]) for e in _edges(f)]
    inside = (b[0] >= 0) & (b[1] >= 0) & (b[2] >= 0)
    on_edge = inside & ((b[0] == 0) | (b[1] == 0) | (b[2] == 0))
    outside = inside & ((px < torch.ceil(f[0].minimum(f[1]).minimum(f[2])))
                        | (px > torch.floor(f[0].maximum(f[1]).maximum(
                            f[2]))))
    print(f'{int(inside.sum())} covered (face, pixel) pairs, '
          f'{int(on_edge.sum())} with a barycentric exactly 0, '
          f'{int(outside.sum())} outside their face\'s bbox')
    assert int(on_edge.sum()) > 0 and int(outside.sum()) > 0

    z_face = fma32(b[2], f[8], fma32(b[0], f[6], b[1] * f[7]))
    ties = 0
    for bi in range(B):
        mine = (item // F) == bi
        zs = z_face[mine]                                     # (k, S, W)
        rows = y0.reshape(-1)[item[mine]].long()[:, None] \
            + torch.arange(stripe_h)                          # (k, S)
        pix = (rows[..., None] * H + torch.arange(H))[inside[mine]]
        key = torch.stack([pix.double(), zs[inside[mine]].double()], 1)
        ties += len(key) - len(torch.unique(key, dim=0))
    print(f'{ties} covered pixels with two faces at one depth')
    assert ties > 0

