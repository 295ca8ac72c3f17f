"""The port's 'tiled' and 'scatter' rasterizers (render/rasterizer.py
rasterize_mesh_tiled and rasterize_mesh, plain torch) against the JAX
package's, which run under jax.jit on the CPU, on the same inputs: the
flagship's 4-view synthetic head at 256^2, the seeded adversarial meshes
and slivers of utils/raster_cases.py at 48-128^2, a mesh whose tiles hold
more faces than ``capacity`` with one z_min among them (so the tie order
of the nearest-K choice decides which stay), and the two-level
``coarse_k`` path. Then the texture variant's forward with 'tiled' against
JAX's (the flagship's is in tests/test_torch_raster_select.py).

Both round as XLA compiles the JAX functions (the pixel coordinates, edge
functions and depth sums in the fused form), and both break ties as JAX
does (jax.lax.top_k keeps equal scores in index order; argmin takes the
first minimum), so pix_to_face and zbuf are held bit for bit: no pixel may
differ."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from next3d_tpu.render import rasterizer as jax_raster
from next3d_tpu_torch.ops.raster import rasterize_binned_uv
from next3d_tpu_torch.ops.raster_zbuffer import fma32
from next3d_tpu_torch.render.rasterizer import (_covers, rasterize_mesh,
                                                rasterize_mesh_tiled,
                                                required_tile_capacity)
from next3d_tpu_torch.utils.raster_cases import (adversarial_mesh,
                                                 four_views, sliver_sweep)
from next3d_tpu_torch.utils.synthetic_head import synthetic_head

from test_torch_raster import _rounding_tie
from test_torch_raster_select import assert_tiled_forward_matches_jax
from torch_parity import n, t
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)

PORT = {'tiled': rasterize_mesh_tiled, 'scatter': rasterize_mesh}


def _jax(name, verts, faces, size, **kw):
    fn = getattr(jax_raster, {'tiled': 'rasterize_mesh_tiled',
                              'scatter': 'rasterize_mesh'}[name])
    out = jax.jit(lambda v, f: fn(v, f, size, **kw))(jnp.asarray(verts),
                                                     jnp.asarray(faces))
    return [np.asarray(a) for a in out]


def _assert_matches_jax(name, verts, faces, size, got=None, **kw):
    """pix_to_face and zbuf of the port's ``name`` rasterizer (``got`` if
    given) bit-equal to JAX's; returns the port's pix_to_face."""
    if got is None:
        got = [n(a) for a in PORT[name](t(verts), t(faces), size, **kw)]
    want = _jax(name, verts, faces, size, **kw)
    assert got[0].dtype == np.int32 and got[0].shape == want[0].shape
    covered = got[0] >= 0
    print(f'{name} at {size}^2 {kw}: {covered.sum()} px covered, '
          f'{(got[0] != want[0]).sum()} pix_to_face and '
          f'{(got[1] != want[1]).sum()} zbuf values differ')
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert covered.any()
    assert np.all(got[1][~covered] == np.float32(1e10))
    return got[0]


@pytest.fixture(scope='module')
def head():
    tv, faces, attrs = four_views(synthetic_head()[0], 6)
    return tv, faces, attrs


@pytest.fixture(scope='module')
def head_256(head):
    """The port's two rasterizers on the head at 256^2, computed once."""
    tv, faces, _ = head
    return {name: [n(a) for a in fn(t(tv), t(faces), 256)]
            for name, fn in PORT.items()}


@pytest.mark.parametrize('name', ['tiled', 'scatter'])
def test_matches_jax_on_four_views(head, head_256, name):
    """The flagship's rasterizer input, 4 views of the jittered head at
    256^2, and the default capacity (tiled) and patch (scatter)."""
    tv, faces, _ = head
    _assert_matches_jax(name, tv, faces, 256, got=head_256[name])


def test_tiled_and_scatter_agree_on_four_views(head, head_256):
    """The two give one visibility on the head at 256^2 (the capacity
    drops no visible face there), and K1's plain version differs from them
    only at float32 rounding ties."""
    tv, faces, attrs = head
    pf_t, pf_s = head_256['tiled'][0], head_256['scatter'][0]
    np.testing.assert_array_equal(pf_t, pf_s)
    pf_k1 = n(rasterize_binned_uv(t(tv), t(faces), t(attrs), 256)[0])
    differ = np.nonzero(pf_k1 != pf_s)
    print(f'K1 vs scatter: {len(differ[0])} of {pf_s.size} px differ')
    assert len(differ[0]) <= 2e-4 * pf_s.size
    for b, y, x in zip(*differ):
        fids = (int(pf_k1[b, y, x]), int(pf_s[b, y, x]))
        assert _rounding_tie(tv[b], faces, fids, x, y, 256), (b, y, x)


@pytest.mark.parametrize('name,case,size,kw', [
    ('tiled', 'adversarial', 64, {}),
    ('scatter', 'adversarial', 64, {}),
    ('tiled', 'adversarial', 48, {'capacity': 64}),
    ('scatter', 'adversarial', 48, {'face_chunk': 300}),
    ('tiled', 'sliver', 128, {}),
    ('scatter', 'sliver', 128, {'patch': 48}),
    ('scatter', 'sliver', 80, {'patch': 48, 'face_chunk': 128}),
], ids=lambda p: str(p))
def test_matches_jax_on_hard_cases(name, case, size, kw):
    """Edges through pixel centres, corners on tile borders, slivers that
    pass the rounded edge test outside their bbox, zero-area and
    back-facing faces, depth ties; at sizes that are not multiples of 32
    too (the pixel coordinates are then rounded products)."""
    if case == 'adversarial':
        verts, faces, _ = adversarial_mesh(2, size, 2000, 3)
    else:
        verts, faces = sliver_sweep(2, size, 500, 4)
    _assert_matches_jax(name, verts, faces, size, **kw)


def _fans(n_images, seed):
    """Fans of faces around one shared vertex (z 1, the nearest corner of
    each face), 64 faces in all, a few px across at 32^2: every 8-px tile
    near the centre holds far more than a capacity of 8, all at one
    z_min, so which faces stay is decided by the tie order alone."""
    rng = np.random.default_rng(seed)
    verts, faces = [], []
    for b in range(n_images):
        centre = np.array([12.0, 12.0]) + rng.uniform(-0.5, 0.5, 2)
        pts, tri = [np.append(centre, 1.0)], []
        for ring in range(4):
            k = 16
            ang = np.sort(rng.uniform(0, 2 * np.pi, k))
            r = rng.uniform(2.0, 7.0, k)
            base = len(pts)
            for a, rr in zip(ang, r):
                pts.append([centre[0] + rr * np.cos(a),
                            centre[1] + rr * np.sin(a),
                            rng.uniform(1.5, 3.0)])
            for i in range(k):
                tri.append([0, base + i, base + (i + 1) % k])
        pts = np.asarray(pts)
        xy = (pts[:, :2] + 0.5) * (2.0 / 32) - 1.0
        verts.append(np.concatenate([xy, pts[:, 2:]], -1))
        faces = np.asarray(tri)
    faces = faces.astype(np.int32)
    verts = np.stack(verts).astype(np.float32)
    # wind every face to the front
    p = verts[0][faces]
    back = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
            - (p[:, 1, 1] - p[:, 0, 1]) * (p[:, 2, 0] - p[:, 0, 0])) < 0
    faces[back] = faces[back][:, [0, 2, 1]]
    return verts, faces


def test_capacity_eviction_follows_the_tie_order():
    """With capacity 8, tiles of the fan mesh keep 8 of up to 64 faces that
    share their nearest vertex: the port keeps JAX's 8 (equal scores in
    index order) and so matches it bit for bit, though the faces it drops
    cover pixels (the full capacity's result differs), and numbering the
    faces backwards changes which faces stay."""
    verts, faces = _fans(2, 0)
    pf = _assert_matches_jax('tiled', verts, faces, 32, capacity=8)
    full = n(rasterize_mesh_tiled(t(verts), t(faces), 32)[0])
    assert (full != pf).sum() > 0
    backwards = faces[::-1].copy()
    pf_b = n(rasterize_mesh_tiled(t(verts), t(backwards), 32,
                                  capacity=8)[0])
    pf_b = np.where(pf_b >= 0, len(faces) - 1 - pf_b, -1)
    print(f'capacity 8: {(full != pf).sum()} px differ from the full list, '
          f'{(pf_b != pf).sum()} with the faces numbered backwards')
    assert (pf_b != pf).sum() > 0


def test_capacity_eviction_on_four_views(head):
    """The head at 128^2 with capacity 16: tiles hold up to about 100 faces,
    many sharing a vertex."""
    tv, faces, _ = head
    _assert_matches_jax('tiled', tv, faces, 128, capacity=16)


@pytest.mark.parametrize('coarse_k', [40, 600])
def test_coarse_k_matches_jax(head, coarse_k):
    """The two-level path: each 8-px tile chooses from the coarse_k nearest
    faces of its 32-px tile (at 40 the coarse list drops faces too)."""
    tv, faces, _ = head
    _assert_matches_jax('tiled', tv, faces, 128, coarse_k=coarse_k,
                        capacity=32)


@pytest.mark.parametrize('size,tile', [(64, 8), (128, 16), (256, 32),
                                       (96, 8)])
def test_required_tile_capacity_matches_jax(head, size, tile):
    tv, faces, _ = head
    got = required_tile_capacity(tv, faces, size, tile=tile)
    assert got == jax_raster.required_tile_capacity(tv, faces, size,
                                                    tile=tile)
    assert got > 0


def test_covers_is_the_sign_of_the_rounded_barycentric():
    """``_covers`` decides fl(fl(fma(a, b, c)) * inv) >= 0 from the float64
    value: on random terms, on terms that cancel exactly or to a few ulps,
    on values that underflow to -0 in float32 (and only then round), and
    on infinite and NaN terms, it decides as the rounded form does."""
    rng = np.random.default_rng(0)
    m = 200_000
    a = rng.uniform(-300, 300, m).astype(np.float32)
    b = rng.uniform(-300, 300, m).astype(np.float32)
    c = -(a * b)                            # cancels to the product's error
    c[: m // 4] = rng.uniform(-9e4, 9e4, m // 4).astype(np.float32)
    c[m // 4: m // 2] += rng.integers(-3, 4, m // 4) * np.spacing(
        c[m // 4: m // 2])
    inv = rng.uniform(1e-6, 10, m).astype(np.float32)
    tiny = slice(m // 2, m // 2 + 1000)     # underflow to -0
    a[tiny], b[tiny] = np.float32(2.0 ** -70), np.float32(-(2.0 ** -70))
    c[tiny] = np.float32(0)
    inv[tiny] = np.float32(2.0 ** -15)
    special = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0], np.float32)
    a[-5:], b[-5:], c[-5:] = special, np.float32(1), np.float32(-1)
    terms = [t(x) for x in (a, b, c)]
    want = fma32(*terms) * t(inv) >= 0
    got = _covers(terms, t(inv))
    assert want[tiny].all() and (fma32(*terms)[tiny] < 0).all()
    print(f'{int((got != want).sum())} of {m} decisions differ; '
          f'{int(want.sum())} cover')
    assert torch.equal(got, want)


def test_texture_tiled_forward_matches_jax():
    """The texture variant with 'tiled' at 128^2 planes against JAX's:
    the gate of ROADMAP.md on image and image_raw."""
    assert_tiled_forward_matches_jax(texture=True)
