"""K1: the port's binned UV rasterizer (plain version, CPU) against the JAX
package's Pallas kernel in interpret mode and the scatter golden, on the
in-repo synthetic head.

The kernel itself runs only on a GPU: tests/test_torch_cuda.py and
chip_smoke.py hold it against the plain version there."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from next3d_tpu.ops.pallas_raster import rasterize_mesh_pallas_binned_uv
from next3d_tpu.render.rasterizer import rasterize_mesh, required_patch_size
from next3d_tpu_torch.ops.raster import (_resolve_plain, binned_prep,
                                         rasterize_binned_uv,
                                         rasterize_binned_uv_plain, row_at,
                                         row_nonnegative,
                                         segments_in_face_order)
from next3d_tpu_torch.utils.raster_cases import four_views
from next3d_tpu_torch.utils.synthetic_head import synthetic_head


def _head_views(seed, H=128):
    """2 images of the synthetic head, normalised into [-1, 1] like
    tests/test_rasterizer.py:225-248 (the second one jittered), with the
    generator's [0, 2, 1] face reorder and random per-corner (u, v)."""
    mesh, _ = synthetic_head()
    rng = np.random.RandomState(seed)
    v = mesh.verts
    v = (v - v.mean(0)) / np.abs(v - v.mean(0)).max() * 0.9
    verts = np.stack([v, v + rng.randn(*v.shape) * 0.002]).astype(np.float32)
    verts = np.concatenate([verts[..., :2], 10.0 - verts[..., 2:] * 2], -1)
    faces = mesh.faces[:, [0, 2, 1]].astype(np.int32)
    attrs = rng.rand(1, len(faces), 3, 2).astype(np.float32) * 2 - 1
    return verts, faces, attrs, H


def test_plain_matches_jax_kernel_interpret():
    verts, faces, attrs, H = _head_views(1)
    pf_j, u_j, v_j = (np.asarray(a) for a in rasterize_mesh_pallas_binned_uv(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(attrs), H,
        4096, True))
    pf, u, v = (a.numpy() for a in rasterize_binned_uv(
        torch.from_numpy(verts), torch.from_numpy(faces),
        torch.from_numpy(attrs), H))
    assert pf.dtype == np.int32 and pf.shape == (2, H, H)
    # the same arithmetic, rounded in the same fused form, and the same tie
    # rule: every output is bit-equal
    np.testing.assert_array_equal(pf, pf_j)
    covered = pf >= 0
    assert 0.05 < covered.mean() < 0.9
    np.testing.assert_array_equal(u, u_j)
    np.testing.assert_array_equal(v, v_j)
    assert np.all(u[~covered] == 0) and np.all(v[~covered] == 0)


def test_plain_matches_scatter_golden():
    verts, faces, attrs, H = _head_views(2)
    pf_s, _ = rasterize_mesh(jnp.asarray(verts), jnp.asarray(faces), H,
                             patch=32)
    pf, _, _ = rasterize_binned_uv_plain(
        torch.from_numpy(verts), torch.from_numpy(faces),
        torch.from_numpy(attrs), H)
    np.testing.assert_array_equal(pf.numpy(), np.asarray(pf_s))


def test_prep_bins_every_kept_face_once_per_tile():
    verts, faces, attrs, H = _head_views(3)
    slab, starts = binned_prep(torch.from_numpy(verts),
                               torch.from_numpy(faces),
                               torch.from_numpy(attrs), H)
    T = (H // 32) ** 2
    assert slab.shape == (2, 19, 4 * len(faces))
    assert starts.shape == (2, T + 1) and starts.dtype == torch.int32
    assert torch.all(starts[:, 1:] >= starts[:, :-1])
    occupancy = (starts[:, 1:] - starts[:, :-1]).max().item()
    print(f'max entries per 32-px tile at {H}^2: {occupancy}')
    for b in range(2):
        for t in range(T):
            fids = slab[b, 18, starts[b, t]:starts[b, t + 1]]
            assert len(torch.unique(fids)) == len(fids)


@pytest.mark.parametrize('with_attrs,tile', [(True, 32), (False, 32),
                                              (True, 16)],
                         ids=['K1', 'K2', 'K3'])
def test_resolve_ignores_order_inside_segments(with_attrs, tile):
    """The CUDA prep places a segment's entries in arbitrary order. The
    resolve takes per pixel the lexicographic minimum of (z, face id) over
    the covering candidates, and a face has at most one entry per tile, so
    binned_prep's slab with every segment shuffled resolves bit-equal; and
    segments_in_face_order restores binned_prep's order exactly."""
    verts, faces, attrs, H = _head_views(5)
    args = (torch.from_numpy(verts), torch.from_numpy(faces),
            torch.from_numpy(attrs) if with_attrs else None, H, tile)
    slab, starts = binned_prep(*args)
    B, K, E = slab.shape
    rng = np.random.RandomState(0)
    perm = np.tile(np.arange(E), (B, 1))
    bounds = starts.numpy()
    for b in range(B):
        for lo, hi in zip(bounds[b, :-1], bounds[b, 1:]):
            perm[b, lo:hi] = rng.permutation(perm[b, lo:hi])
    shuffled = slab.gather(
        2, torch.from_numpy(perm)[:, None].expand(B, K, E)).contiguous()
    assert not torch.equal(shuffled, slab)
    for got, want in zip(_resolve_plain(shuffled, starts, H, tile),
                         _resolve_plain(slab, starts, H, tile)):
        assert torch.equal(got, want)
    for b, rows in enumerate(segments_in_face_order(shuffled, starts)):
        assert torch.equal(rows, slab[b, :, :bounds[b, -1]])


def _four_views(seed):
    """A jittered expression of the head through the flagship's 4
    orthographic views at the init orth scale and shift
    (TriPlaneGenerator.rasterize), with the model's face UVs."""
    return four_views(synthetic_head()[0], seed)


def test_four_views_match_jax_kernel_and_scatter():
    """The flagship's own rasterizer input: a jittered expression of the
    head through the 4 orthographic views at the init orth scale and shift
    (TriPlaneGenerator.rasterize), 256^2, with the model's face UVs. The
    port rounds K1's prep and per-pixel rows in the fused form into which
    XLA compiles the JAX kernel in interpret mode, so all three outputs are
    bit-equal to it (with each product rounded apart, 10 of the 262,144
    pixels differed here). The scatter golden evaluates its edges and depth
    in another form, so a few pixels differ from it: held at >= 99.98%
    agreement, the bound of tests/test_rasterizer.py:181-206, each differing
    pixel shown in float64 to be a float32 rounding tie (an edge through
    the pixel centre, or two covering faces at one depth)."""
    tv, faces, attrs = _four_views(6)
    got = [a.numpy() for a in rasterize_binned_uv(
        torch.from_numpy(tv), torch.from_numpy(faces),
        torch.from_numpy(attrs), 256)]
    want = [np.asarray(a) for a in rasterize_mesh_pallas_binned_uv(
        jnp.asarray(tv), jnp.asarray(faces), jnp.asarray(attrs), 256, 4096,
        True)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    pf = got[0]
    patch = int(required_patch_size(tv, faces, 256)) + 2
    pf_s = np.asarray(rasterize_mesh(jnp.asarray(tv), jnp.asarray(faces), 256,
                                     patch=patch)[0])
    differ = int((pf != pf_s).sum())
    print(f'port K1 vs JAX scatter: {differ} of {pf.size} px differ, '
          f'coverage on {int(((pf >= 0) != (pf_s >= 0)).sum())}')
    assert differ <= 2e-4 * pf.size
    for b, y, x in zip(*np.nonzero(pf != pf_s)):
        fids = (int(pf[b, y, x]), int(pf_s[b, y, x]))
        assert _rounding_tie(tv[b], faces, fids, x, y, 256), (b, y, x)


def _rounding_tie(verts, faces, fids, x, y, H):
    """Whether two rasterizers' answers (face ids, -1 for none) at pixel
    centre (x, y) both hold up to float32 rounding, judged in float64: a
    face's edge function is within 4 eps of its terms' magnitude of 0, or
    both faces cover the pixel and their depths differ by less than 2 eps
    of the z-plane's terms (z = sum w_i z_i, each w_i = c + gx x + gy y)."""
    eps = float(np.finfo(np.float32).eps)
    planes = []
    for f in fids:
        if f < 0:
            continue
        p = verts[faces[f]].astype(np.float64)
        px = (p[:, 0] + 1) * H / 2 - 0.5
        py = (p[:, 1] + 1) * H / 2 - 0.5
        area = (px[1] - px[0]) * (py[2] - py[0]) \
            - (py[1] - py[0]) * (px[2] - px[0])
        w, scale = [], []
        for a, b in ((1, 2), (2, 0), (0, 1)):
            c = ((py[b] - py[a]) * px[a] - (px[b] - px[a]) * py[a]) / area
            gx, gy = -(py[b] - py[a]) / area, (px[b] - px[a]) / area
            w.append(c + gx * x + gy * y)
            scale.append(abs(c) + abs(gx * x) + abs(gy * y))
        w, scale = np.array(w), np.array(scale)
        planes.append((w, scale, w @ p[:, 2], scale @ np.abs(p[:, 2])))
    edge = min(np.min(np.abs(w) / (eps * s)) for w, s, _, _ in planes)
    print(f'pixel ({x}, {y}) faces {fids}: nearest edge at {edge:.3g} eps',
          end='')
    if len(planes) == 2 and all(np.all(w >= 0) for w, *_ in planes):
        (_, _, za, sa), (_, _, zb, sb) = planes
        depth = abs(za - zb) / (eps * max(sa, sb))
        print(f', both cover it, depth gap {depth:.3g} eps')
        return edge <= 4 or depth <= 2
    print()
    return edge <= 4


def test_row_nonnegative_is_the_sign_of_row_at():
    """The plain resolve decides each edge by row_nonnegative, the sign of
    the fused row_at taken without its outer rounding. On random rows at
    pixel coordinates, on rows made to vanish at a pixel (an edge through
    its centre, zero and subnormal terms) and on infinite and NaN terms,
    both decide alike."""
    rng = np.random.RandomState(0)
    n = 200000
    x = rng.randint(0, 512, n).astype(np.float32)
    y = rng.randint(0, 512, n).astype(np.float32)
    gx = (rng.randn(n) * 10.0 ** rng.uniform(-6, 3, n)).astype(np.float32)
    gy = (rng.randn(n) * 10.0 ** rng.uniform(-6, 3, n)).astype(np.float32)
    c = (rng.randn(n) * 10.0 ** rng.uniform(-3, 4, n)).astype(np.float32)
    # a third of the rows: c = -(gx x + gy y) rounded, so the exact value
    # is a tiny residue of either sign or 0
    k = n // 3
    c[:k] = (-(gx[:k].astype(np.float64) * x[:k]
               + gy[:k].astype(np.float64) * y[:k])).astype(np.float32)
    # terms that are exactly zero, subnormal, infinite or NaN
    tiny = np.float32(1e-45)
    c[k:k + 8] = [0, -0.0, tiny, -tiny, np.inf, -np.inf, np.nan, 0]
    gx[k + 8:k + 16] = [0, tiny, -tiny, np.inf, -np.inf, np.nan, 0, 0]
    gy[k + 16:k + 24] = [0, tiny, -tiny, np.inf, -np.inf, np.nan, 0, 0]
    x[k + 8:k + 24] = 0
    args = [torch.from_numpy(a) for a in (c, gx, gy, x, y)]
    want = row_at(*args) >= 0
    got = row_nonnegative(*args)
    assert 0.3 < float(want.float().mean()) < 0.7
    assert int((row_at(*[a[:k] for a in args]) == 0).sum()) > 100
    assert torch.equal(got, want)
