"""K2, K3, K5 and K6 (plain versions, CPU) and the port's
``interpolate_face_attributes`` against the JAX package: its Pallas kernels
in interpret mode, its scatter golden and its interpolation, on the in-repo
synthetic head and on the random meshes of tests/test_rasterizer.py.

The kernels themselves run only on a GPU: tests/test_torch_cuda.py and
chip_smoke.py hold each against its plain version there."""

from fractions import Fraction

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from next3d_tpu.ops.pallas_dma_gather import dma_gather_row_blocks
from next3d_tpu.ops.pallas_raster import (rasterize_mesh_pallas,
                                          rasterize_mesh_pallas_binned,
                                          rasterize_mesh_pallas_binned_uv16)
from next3d_tpu.render import rasterizer as jax_rasterizer
from next3d_tpu.render.rasterizer import rasterize_mesh
from next3d_tpu_torch.ops.dma_gather import (gather_row_blocks,
                                             gather_row_blocks_plain)
from next3d_tpu_torch.ops.raster import (rasterize_binned,
                                         rasterize_binned_plain,
                                         rasterize_binned_uv,
                                         rasterize_binned_uv16,
                                         rasterize_binned_uv16_plain)
from next3d_tpu_torch.ops.raster_zbuffer import (fma32, rasterize_zbuffer,
                                                 rasterize_zbuffer_plain)
from next3d_tpu_torch.render import rasterizer as port_rasterizer
from next3d_tpu_torch.render.rasterizer import (interpolate_face_attributes,
                                                rasterize_uv_with_alpha,
                                                rasterize_with_attributes)
from next3d_tpu_torch.utils.raster_cases import named_sliver, sliver_sweep

from test_rasterizer import random_mesh
from test_torch_raster import _head_views, _rounding_tie, _four_views
from torch_parity import n, one_thread, t  # noqa: F401  (a fixture)
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)

EPS = float(np.finfo(np.float32).eps)


def _assert_ties(pf, other, verts, faces, H, name):
    """Every pixel where the two visibilities differ is a float32 rounding
    tie, judged in float64 (tests/test_torch_raster.py _rounding_tie)."""
    differ = np.nonzero(pf != other)
    print(f'{name}: {len(differ[0])} of {pf.size} px differ')
    for b, y, x in zip(*differ):
        fids = (int(pf[b, y, x]), int(other[b, y, x]))
        assert _rounding_tie(verts[b], faces, fids, x, y, H), (name, b, y, x)


def _zplane(verts, faces, pf, H):
    """At each covered pixel, the winning face's depth plane in float64 as
    the binned kernels form it (z = sum_i z_i (c_i + gx_i x + gy_i y), with
    c_i = ((yb - ya) xa - (xb - xa) ya) / area), and the magnitude of its
    terms, which sets how far a float32 evaluation may round."""
    b, y, x = np.nonzero(pf >= 0)
    p = verts[b[:, None], faces[pf[b, y, x]]].astype(np.float64)  # (n, 3, 3)
    px = (p[..., 0] + 1) * H / 2 - 0.5
    py = (p[..., 1] + 1) * H / 2 - 0.5
    area = (px[:, 1] - px[:, 0]) * (py[:, 2] - py[:, 0]) \
        - (py[:, 1] - py[:, 0]) * (px[:, 2] - px[:, 0])
    z = scale = 0
    for i, (a, c) in enumerate(((1, 2), (2, 0), (0, 1))):
        dy, dx = py[:, c] - py[:, a], px[:, c] - px[:, a]
        w = (dy * px[:, a] - dx * py[:, a] - dy * x + dx * y) / area
        terms = (np.abs(dy * px[:, a]) + np.abs(dx * py[:, a])
                 + np.abs(dy * x) + np.abs(dx * y)) / np.abs(area)
        z = z + w * p[:, i, 2]
        scale = scale + terms * np.abs(p[:, i, 2])
    return z, scale


def test_k2_plain_matches_jax_kernel_interpret():
    verts, faces, _, H = _head_views(7)
    pf_j, z_j = (np.asarray(a) for a in rasterize_mesh_pallas_binned(
        jnp.asarray(verts), jnp.asarray(faces), H, 8192, True))
    pf, z = (n(a) for a in rasterize_binned(t(verts), t(faces), H))
    assert pf.dtype == np.int32 and z.dtype == np.float32
    assert pf.shape == z.shape == (2, H, H)
    _assert_ties(pf, pf_j, verts, faces, H, 'K2 vs JAX K2 interpret')
    assert np.all(z[pf < 0] == 1e10) and np.all(z_j[pf_j < 0] == 1e10)
    # the depth plane's terms reach 1e3-1e5 on sliver faces, so a float32
    # evaluation of the plane lies far more than an ulp of z ~ 10 from the
    # float64 one; each stays within 1 eps of its terms, and the port's,
    # rounded in the same fused form as JAX's, equals it bit for bit
    assert np.array_equal(pf, pf_j)
    want, scale = _zplane(verts, faces, pf, H)
    cov = pf >= 0
    for name, zz in (('port', z), ('JAX', z_j)):
        err = np.abs(zz[cov] - want) / (EPS * scale)
        print(f'K2 {name} zbuf vs float64: max {err.max():.3g} eps of terms')
        assert err.max() <= 1
    np.testing.assert_array_equal(z, z_j)


def test_k2_and_k3_plain_match_k1_plain():
    """The flagship's 4-view batch at 256^2: K2's visibility equals K1's,
    and K3 equals K1 bit for bit in pix_to_face, u and v (the same
    coefficients and arithmetic; tests/test_rasterizer.py:296-322 asserts
    the same of the JAX kernels). K2's zbuf is 1e10 exactly where K1 sees
    no face."""
    verts, faces, attrs = _four_views(6)
    args = (t(verts), t(faces), t(attrs), 256)
    k1 = rasterize_binned_uv(*args)
    k3 = rasterize_binned_uv16(*args)
    pf2, z2 = rasterize_binned(t(verts), t(faces), 256)
    assert torch.equal(pf2, k1[0])
    assert torch.equal(z2 == 1e10, k1[0] < 0)
    for a, b in zip(k3, k1):
        assert torch.equal(a, b)


def test_k3_plain_matches_jax_kernel_interpret():
    verts, faces, attrs, H = _head_views(8)
    pf_j, u_j, v_j = (np.asarray(a) for a in rasterize_mesh_pallas_binned_uv16(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(attrs), H,
        8192, True))
    pf, u, v = (n(a) for a in rasterize_binned_uv16_plain(
        t(verts), t(faces), t(attrs), H))
    # K1's fused rounding (ops/raster.py): every output is bit-equal
    for got, want in ((pf, pf_j), (u, u_j), (v, v_j)):
        np.testing.assert_array_equal(got, want)
    assert np.all(u[pf < 0] == 0) and np.all(v[pf < 0] == 0)


@pytest.mark.parametrize('seed,patch', [(0, 64), (1, 16), (2, 16)])
@pytest.mark.usefixtures('one_thread')
def test_k5_plain_matches_jax_kernel_interpret(seed, patch):
    """The random meshes of tests/test_rasterizer.py (B=2, up to 40 faces
    spanning the 64^2 image). At patch 64 the stripe is the whole image; at
    patch 16 it is 24 rows, so the tall faces are cut, as on the TPU.
    pix_to_face and zbuf are exact: the port rounds the area, the edges and
    the depth in the reference's fused form (ops/raster_zbuffer.py)."""
    verts, faces = random_mesh(np.random.RandomState(seed), B=2, V=30, F=40)
    H = 64
    pf_j, z_j = (np.asarray(a) for a in rasterize_mesh_pallas(
        jnp.asarray(verts), jnp.asarray(faces), H, patch, True))
    pf, z = (n(a) for a in rasterize_zbuffer(t(verts), t(faces), H, patch))
    np.testing.assert_array_equal(pf, pf_j)
    np.testing.assert_array_equal(z, z_j)
    if patch == 16:
        # the cut shows: the full-height golden covers more pixels
        pf_s, _ = rasterize_mesh(jnp.asarray(verts), jnp.asarray(faces), H,
                                 patch=80, face_chunk=16)
        assert (np.asarray(pf_s) >= 0).sum() > (pf >= 0).sum()


@pytest.mark.usefixtures('one_thread')
def test_k5_named_sliver():
    verts, faces = named_sliver()
    pf_j, z_j = (np.asarray(a) for a in rasterize_mesh_pallas(
        jnp.asarray(verts), jnp.asarray(faces), 64, 32, True))
    pf, z = (n(a) for a in rasterize_zbuffer(t(verts), t(faces), 64, 32))
    assert np.argwhere(pf_j[0] >= 0).tolist() == [[25, 11], [31, 16]]
    np.testing.assert_array_equal(pf, pf_j)
    np.testing.assert_array_equal(z, z_j)


@pytest.mark.parametrize('first_seed', [0, 5, 10, 15])
@pytest.mark.usefixtures('one_thread')
def test_k5_matches_jax_on_slivers(first_seed):
    """5 seeded meshes of 2 images x 40 near-degenerate slivers at 64^2
    (utils/raster_cases.py sliver_sweep: corners on pixel centres, the third
    1-3 ulps off the segment between them, half wound the other way):
    pix_to_face and zbuf equal JAX's interpret-mode K5 exactly. Only the
    fused rounding does this: each product and sum rounded apart differs
    from JAX on such faces."""
    covered = differ_pf = differ_z = 0
    for seed in range(first_seed, first_seed + 5):
        verts, faces = sliver_sweep(2, 64, 40, seed)
        pf_j, z_j = (np.asarray(a) for a in rasterize_mesh_pallas(
            jnp.asarray(verts), jnp.asarray(faces), 64, 32, True))
        pf, z = (n(a) for a in rasterize_zbuffer(t(verts), t(faces), 64, 32))
        differ_pf += int((pf != pf_j).sum())
        differ_z += int((z != z_j).sum())
        covered += int((pf_j >= 0).sum())
    print(f'slivers, seeds {first_seed}-{first_seed + 4}: {covered} pixels '
          f'covered; {differ_pf} differ from JAX in pix_to_face, '
          f'{differ_z} in zbuf')
    assert covered > 0 and differ_pf == differ_z == 0


def _round_to_float32(q):
    """The float32 nearest the rational ``q``, ties to even (finite)."""
    if q == 0:
        return np.float32(0)
    sign, q = (-1 if q < 0 else 1), abs(q)
    e = q.numerator.bit_length() - q.denominator.bit_length()
    if Fraction(2) ** e > q:
        e -= 1                                   # 2^e <= q < 2^(e + 1)
    scale = Fraction(2) ** (23 - max(e, -126))   # 24 bits, or subnormal
    m = q * scale
    k = m.numerator // m.denominator
    rest = m - k
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and k % 2):
        k += 1
    return np.float32(sign * float(k / scale))


def test_fma32_rounds_once():
    """fma32 against the exact rational a * b + c rounded to float32,
    ties to even: seeded values over many exponents, products that cancel
    against c, and crafted cases where the exact sum is a float32 midpoint
    or a hair beside one (where rounding twice, to float64 and then to
    float32, goes wrong)."""
    rng = np.random.RandomState(0)
    a = (rng.randn(4000) * 2.0 ** rng.randint(-30, 30, 4000)).astype(
        np.float32)
    b = (rng.randn(4000) * 2.0 ** rng.randint(-30, 30, 4000)).astype(
        np.float32)
    c = (rng.randn(4000) * 2.0 ** rng.randint(-60, 60, 4000)).astype(
        np.float32)
    c[::4] = -(a[::4] * b[::4])                  # cancellation
    one = 1 + 2.0 ** -12                         # one^2 = 1 + 2^-11 + 2^-24
    crafted = [(one, one, 0.0), (one, one, 2.0 ** -80),
               (one, one, -2.0 ** -80), (-one, one, 2.0 ** -80),
               (one, -one, -2.0 ** -80), (one, one, -1.0),
               (1 + 2.0 ** -23, 1 + 2.0 ** -23, 2.0 ** -70),
               (1 + 2.0 ** -23, 1 - 2.0 ** -24, -1.0),
               (3.0, 2.0 ** -149, 0.0), (2.0 ** -100, 2.0 ** -40, 0.0)]
    a = np.concatenate([a, np.float32([x[0] for x in crafted])])
    b = np.concatenate([b, np.float32([x[1] for x in crafted])])
    c = np.concatenate([c, np.float32([x[2] for x in crafted])])
    got = n(fma32(t(a), t(b), t(c)))
    want = np.array([_round_to_float32(Fraction(float(x)) * Fraction(float(y))
                                       + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the crafted cases decide by a single rounding: twice would tie to
    # even where the exact sum lies past the midpoint
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert np.sum(twice[-len(crafted):] != want[-len(crafted):]) >= 2


@pytest.mark.usefixtures('one_thread')
def test_k5_plain_matches_scatter_golden():
    """The synthetic head at 128^2: K5 and the scatter golden share their
    edge and depth arithmetic, so any pixel where they differ must be a
    float32 rounding tie."""
    verts, faces, _, H = _head_views(9)
    pf_s = np.asarray(rasterize_mesh(jnp.asarray(verts), jnp.asarray(faces),
                                     H, patch=32)[0])
    pf, _ = rasterize_zbuffer_plain(t(verts), t(faces), H, patch=32)
    _assert_ties(n(pf), pf_s, verts, faces, H, 'K5 vs scatter golden')
    assert (n(pf) >= 0).mean() > 0.05


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_k6_plain_matches_jax_kernel_interpret(rng, dtype):
    """tests/test_pallas_triplane.py:115's case, in float32 and in
    bfloat16 (both sides round the same float32 table): exact."""
    table = rng.randn(64, 128).astype(np.float32)
    idx = rng.randint(0, 64, 96).astype(np.int32)
    want = dma_gather_row_blocks(jnp.asarray(table).astype(dtype),
                                 jnp.asarray(idx), tile=32, depth=4,
                                 interpret=True)
    got = gather_row_blocks(t(table).to(getattr(torch, dtype)), t(idx))
    assert got.shape == (96, 8, 128) and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(n(got.float()),
                                  np.asarray(want.astype(jnp.float32)))
    assert torch.equal(got, gather_row_blocks_plain(
        t(table).to(getattr(torch, dtype)), t(idx)))
    np.testing.assert_array_equal(n(got.float())[np.arange(96), idx % 8],
                                  n(t(table).to(getattr(torch, dtype))
                                    .float())[idx])


def test_interpolate_face_attributes_matches_jax():
    """The same pix_to_face (K2's) into both interpolations: within 1e-5
    max-abs. The port's is differentiable in verts and attributes."""
    verts, faces, _, H = _head_views(10)
    rng = np.random.RandomState(10)
    attrs = rng.randn(2, len(faces), 3, 3).astype(np.float32)
    pf, _ = rasterize_binned(t(verts), t(faces), H)
    want = np.asarray(jax_rasterizer.interpolate_face_attributes(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(attrs),
        jnp.asarray(n(pf)), H))
    tv, ta = t(verts).requires_grad_(), t(attrs).requires_grad_()
    got = interpolate_face_attributes(tv, t(faces), ta, pf, H)
    assert got.shape == (2, 4, H, H)
    err = np.abs(n(got) - want).max()
    print(f'interpolate_face_attributes max-abs {err:.3g}')
    assert err <= 1e-5
    got[:, :3].square().sum().backward()
    for g in (tv.grad, ta.grad):
        assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


def _fused_interpolation(verts, faces, attrs, pix_to_face, H):
    """interpolate_face_attributes' values with its edge functions and its
    3-term attribute sum in the fused form (fma32), as XLA compiles the
    JAX package's on the CPU."""
    v, B = t(verts), verts.shape[0]
    x = (v[..., 0] + 1) * (H / 2) - 0.5
    y = (v[..., 1] + 1) * (H / 2) - 0.5
    mask = (pix_to_face >= 0).reshape(B, H * H)
    fidx = torch.where(mask, pix_to_face.reshape(B, H * H), 0).long()
    rows = torch.arange(B)[:, None]
    f = t(faces).long()
    cx, cy = x[:, f][rows, fidx], y[:, f][rows, fidx]      # (B, HW, 3)
    a = t(attrs)[rows, fidx]                                # (B, HW, 3, D)
    py, px = (g.reshape(1, -1).float() for g in torch.meshgrid(
        torch.arange(H), torch.arange(H), indexing='ij'))

    def edge(i, j, qx, qy):
        return fma32(cx[..., j] - cx[..., i], qy - cy[..., i],
                     -((cy[..., j] - cy[..., i]) * (qx - cx[..., i])))

    area = edge(0, 1, cx[..., 2], cy[..., 2])
    inv = 1.0 / torch.where(area.abs() > 1e-8, area, torch.ones_like(area))
    b = [(edge(i, j, px, py) * inv)[..., None]
         for i, j in ((1, 2), (2, 0), (0, 1))]
    vals = fma32(b[2], a[..., 2, :], fma32(b[1], a[..., 1, :],
                                           b[0] * a[..., 0, :]))
    vals = vals * mask[..., None]
    return n(torch.cat([vals.reshape(B, H, H, -1).permute(0, 3, 1, 2),
                        mask.reshape(B, 1, H, H).float()], 1))


def test_interpolation_matches_jax_under_jit():
    """The JAX package's interpolation runs inside the jitted model, where
    XLA on the CPU contracts its edge functions' a*b - c*d and its 3-term
    attribute sum into fused multiply-adds. The port rounds in that fused
    form (``fma32``), so on the flagship's 4-view head the two are equal
    bit for bit, and equal to the test's own fused form."""
    import jax
    verts, faces, attrs = _four_views(6)
    attrs = np.repeat(attrs, len(verts), 0)
    pf = rasterize_binned_uv(t(verts), t(faces), t(attrs), 256)[0]
    want = np.asarray(jax.jit(jax_rasterizer.interpolate_face_attributes,
                              static_argnums=4)(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(attrs),
        jnp.asarray(n(pf)), 256))
    got = n(interpolate_face_attributes(t(verts), t(faces), t(attrs), pf,
                                        256))
    differ = int((got != want).sum())
    print(f'interpolate_face_attributes vs JAX under jit: {differ} of '
          f'{got.size} outputs differ')
    assert differ == 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _fused_interpolation(verts, faces, attrs, pf, 256), want)


def test_interpolation_gradient_matches_jax():
    """The fused rounding keeps the analytic derivative: the gradient of a
    weighted sum of the outputs with respect to verts and to attributes
    equals jax.grad of the JAX function within 1e-5 of the largest
    gradient."""
    import jax
    verts, faces, attrs = _four_views(6)
    verts, attrs = verts[:2], np.repeat(attrs, 2, 0)
    pf = rasterize_binned_uv(t(verts), t(faces), t(attrs), 256)[0]
    weight = np.random.RandomState(3).randn(2, attrs.shape[-1] + 1, 256,
                                            256).astype(np.float32)

    def jax_loss(v, a):
        out = jax_rasterizer.interpolate_face_attributes(
            v, jnp.asarray(faces), a, jnp.asarray(n(pf)), 256)
        return jnp.sum(out * weight)

    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(
        jnp.asarray(verts), jnp.asarray(attrs))
    v, a = t(verts).requires_grad_(), t(attrs).requires_grad_()
    out = interpolate_face_attributes(v, t(faces), a, pf, 256)
    got = torch.autograd.grad((out * t(weight)).sum(), (v, a))
    for name, g, w in zip(('verts', 'attributes'), got, want):
        g, w = n(g), np.asarray(w)
        scale = np.abs(w).max()
        err = np.abs(g - w).max()
        print(f'd/d{name}: max-abs {err:.3g} of largest {scale:.3g}')
        assert scale > 0 and err <= 1e-5 * scale, name


@pytest.mark.usefixtures('one_thread')
def test_impl_names():
    """The JAX package's rasterizer_impl names: each kernel's name reaches
    its kernel's plain version on the CPU; 'tiled' and 'scatter' reach the
    port's rasterize_mesh_tiled and rasterize_mesh."""
    verts, faces, attrs, H = _head_views(11)
    v, f, a = t(verts), t(faces), t(attrs)
    k1 = rasterize_uv_with_alpha(v, f, a, H, impl='pallas_binned')
    assert torch.equal(rasterize_uv_with_alpha(v, f, a, H), k1)
    assert torch.equal(rasterize_uv_with_alpha(v, f, a, H,
                                               impl='pallas_binned16'), k1)
    k5 = rasterize_uv_with_alpha(v, f, a, H, patch=32, impl='pallas')
    assert torch.equal(k5[:, 2] > 0, rasterize_zbuffer(v, f, H)[0] >= 0)
    with_attrs = rasterize_with_attributes(v, f, a, H, impl='pallas_binned')
    assert torch.equal(with_attrs[:, 2] > 0,
                       rasterize_binned_plain(v, f, H)[0] >= 0)
    for impl, fn in (('tiled', port_rasterizer.rasterize_mesh_tiled),
                     ('scatter', port_rasterizer.rasterize_mesh)):
        got = rasterize_uv_with_alpha(v, f, a, H, impl=impl)
        assert torch.equal(got[:, 2] > 0, fn(v, f, H)[0] >= 0)
