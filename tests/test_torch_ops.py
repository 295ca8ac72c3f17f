"""The port's ops and render helpers against the JAX package on the CPU, on
the same numpy inputs.

Tolerances: float32 results of two frameworks whose convolutions and
reductions sum in different orders agree to a few ulps of the output scale
(1e-5 relative for O(1) values); integer and boolean logic (fill_mouth,
mouth boxes) and pure data movement must be exact."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from next3d_tpu import ops as jops
from next3d_tpu.ops import interpolate as jinterp
from next3d_tpu.ops.shared_sample import bilinear_sample_shared
from next3d_tpu.models.osg_decoder import OSGDecoder as JOSGDecoder
from next3d_tpu.render import camera_utils as jcam
from next3d_tpu.render import mesh as jmesh
from next3d_tpu.render import renderer as jrender
from next3d_tpu.render.fill_mouth import fill_mouth as jfill, fill_mouth_exact
from next3d_tpu.render.ray_marcher import mip_ray_marcher2 as jmarch
from next3d_tpu.render.ray_sampler import sample_rays as jrays

from next3d_tpu_torch import ops as tops
from next3d_tpu_torch.ops import interpolate as tinterp
from next3d_tpu_torch.models.osg_decoder import OSGDecoder as TOSGDecoder
from next3d_tpu_torch.render import camera_utils as tcam
from next3d_tpu_torch.render import mesh as tmesh
from next3d_tpu_torch.render import renderer as trender
from next3d_tpu_torch.render.fill_mouth import fill_mouth as tfill
from next3d_tpu_torch.render.ray_marcher import mip_ray_marcher2 as tmarch
from next3d_tpu_torch.render.ray_sampler import sample_rays as trays
from next3d_tpu_torch.utils.weights import load_jax_params

from torch_parity import n, t
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act,gain,clamp", [
    ('linear', None, None), ('lrelu', None, 256), ('lrelu', 0.7, 0.5),
    ('softplus', None, None), ('sigmoid', 2.0, None)])
def test_bias_act(rng, act, gain, clamp):
    x = rng.randn(2, 5, 4, 3).astype(np.float32) * 3
    b = rng.randn(5).astype(np.float32)
    want = jops.bias_act(x, b, act=act, gain=gain, clamp=clamp)
    got = tops.bias_act(t(x), t(b), act=act, gain=gain, clamp=clamp)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    assert float(tops.fma(t(x), 2.0, 1.0)[0, 0, 0, 0]) == x[0, 0, 0, 0] * 2 + 1


@pytest.mark.parametrize("fn,kw", [
    ('upfirdn2d', dict(up=2, down=1, padding=[1, 2, 0, -1])),
    ('upfirdn2d', dict(up=1, down=2, padding=2, flip_filter=True)),
    ('upsample2d', {}), ('downsample2d', {}), ('filter2d', dict(gain=3))])
@pytest.mark.parametrize("separable", [False, True])
def test_upfirdn2d_family(rng, fn, kw, separable):
    x = rng.randn(2, 3, 11, 9).astype(np.float32)
    taps = [1, 3, 3, 1] * (2 if separable else 1)
    f = jops.setup_filter(taps)
    np.testing.assert_array_equal(tops.setup_filter(taps), f)
    want = getattr(jops, fn)(jnp.asarray(x), f, **kw)
    got = getattr(tops, fn)(t(x), f, **kw)
    np.testing.assert_allclose(n(got), n(want), **TOL)


@pytest.mark.parametrize("up,down,kernel,groups", [
    (1, 1, 3, 1), (1, 1, 1, 2), (2, 1, 3, 1), (2, 1, 1, 1), (1, 2, 3, 2),
    (1, 2, 1, 1), (2, 1, 3, 2)])
@pytest.mark.parametrize("flip_weight", [True, False])
def test_conv2d_resample(rng, up, down, kernel, groups, flip_weight):
    x = rng.randn(2, 4, 8, 8).astype(np.float32)
    w = rng.randn(6, 4 // groups, kernel, kernel).astype(np.float32)
    f = jops.setup_filter([1, 3, 3, 1])
    kw = dict(f=f, up=up, down=down, padding=kernel // 2, groups=groups,
              flip_weight=flip_weight)
    want = jops.conv2d_resample(jnp.asarray(x), jnp.asarray(w), **kw)
    got = tops.conv2d_resample(t(x), t(w), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("size,antialias", [
    (128, True), (128, False), (32, True), ((17, 23), True)])
def test_interpolate_bilinear(rng, size, antialias):
    x = rng.randn(2, 3, 64, 64).astype(np.float32)
    want = jinterp.interpolate_bilinear(jnp.asarray(x), size, antialias)
    got = tinterp.interpolate_bilinear(t(x), size, antialias)
    np.testing.assert_allclose(n(got), n(want), **TOL)
    m = rng.rand(1, 1, 100, 100).astype(np.float32)
    np.testing.assert_array_equal(
        n(tinterp.interpolate_nearest(t(m), (256, 256))),
        n(jinterp.interpolate_nearest(jnp.asarray(m), (256, 256))))


@pytest.mark.parametrize("box", [(40, 50, 48, 48), (100, 100, 30, 31)])
def test_resample_region_crop(rng, box):
    src = rng.randn(4, 192, 192).astype(np.float32)
    want = jinterp.resample_region(jnp.asarray(src), *map(jnp.int32, box),
                                   64, 64)
    got = tinterp.resample_region(t(src), *box, 64, 64)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("sy,sx,sz", [(60, 70, 80), (10, 200, 50)])
def test_paste_resized_region(rng, sy, sx, sz):
    canvas = rng.randn(3, 256, 256).astype(np.float32)
    patch = rng.randn(3, 256, 256).astype(np.float32)
    want = jinterp.paste_resized_region(jnp.asarray(canvas),
                                        jnp.asarray(patch),
                                        *map(jnp.int32, (sy, sx, sz, sz)))
    got = tinterp.paste_resized_region(t(canvas), t(patch), sy, sx, sz, sz)
    # the JAX tap window truncates a large downscale's triangle kernel
    # (tests/test_ops.py:299 holds it to torch at the same bound)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-3, atol=2e-3)


def test_grid_sample_and_shared_mask(rng):
    x = rng.randn(2, 3, 9, 7).astype(np.float32)
    grid = rng.rand(2, 5, 6, 2).astype(np.float32) * 2.6 - 1.3  # incl. OOB
    want = jops.grid_sample_2d(jnp.asarray(x), jnp.asarray(grid))
    got = tops.grid_sample_2d(t(x), t(grid))
    np.testing.assert_allclose(n(got), n(want), **TOL)
    # the eye mask is one shared channel sampled on the same grid
    mask = rng.rand(9, 7).astype(np.float32)
    want = bilinear_sample_shared(jnp.asarray(mask), jnp.asarray(grid))
    got = tops.grid_sample_2d(t(mask)[None, None].expand(2, 1, 9, 7),
                              t(grid))[:, 0]
    np.testing.assert_allclose(n(got), n(want), **TOL)


def _alpha_with_holes(rng, size=64):
    y, x = np.mgrid[0:size, 0:size]
    r = np.hypot(y - size / 2, x - size / 2)
    a = (r < size * 0.4).astype(np.float32)
    ring = (r >= size * 0.4) & (r < size * 0.44)
    a[ring] = rng.rand(ring.sum()).astype(np.float32) * 0.9
    a[(np.abs(y - size * 0.65) < size * 0.06)
      & (np.abs(x - size / 2) < size * 0.12)] = 0.0
    a[5:9, 3:40] = 0.3          # an open bay
    a[0, :] = 0.0               # border channel from the seed
    return a[None]


def test_fill_mouth_exact(rng):
    imgs = np.stack([_alpha_with_holes(rng) for _ in range(3)])
    got = n(tfill(t(imgs)))
    np.testing.assert_array_equal(got, n(jfill(jnp.asarray(imgs))))
    np.testing.assert_array_equal(got, n(fill_mouth_exact(jnp.asarray(imgs))))


def test_mesh_helpers(rng):
    ang = rng.uniform(-180, 180, (3, 3)).astype(np.float32)
    np.testing.assert_allclose(n(tmesh.angle2matrix(ang)),
                               n(jmesh.angle2matrix(ang)), rtol=1e-6,
                               atol=1e-6)
    X = rng.randn(2, 7, 3).astype(np.float32)
    cam = np.asarray([1.5, 0.1, -0.2], np.float32)
    np.testing.assert_array_equal(
        n(tmesh.batch_orth_proj(t(X), t(cam))),
        n(jmesh.batch_orth_proj(jnp.asarray(X), jnp.asarray(cam))))
    verts = rng.randn(2, 10, 3).astype(np.float32)
    faces = rng.randint(0, 10, (2, 6, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        n(tmesh.face_vertices(t(verts), t(faces))),
        n(jmesh.face_vertices(jnp.asarray(verts), jnp.asarray(faces))))


def _camera(h=math.pi / 2, v=math.pi / 2, n_rays=16):
    jc2w = jcam.lookat_pose(h, v, jnp.asarray([0, 0, 0.2]), radius=2.7)
    tc2w = tcam.lookat_pose(h, v, [0, 0, 0.2], radius=2.7, device='cpu')
    np.testing.assert_allclose(n(tc2w), n(jc2w), rtol=1e-6, atol=1e-6)
    K = jcam.fov_to_intrinsics(18.837)
    np.testing.assert_array_equal(tcam.fov_to_intrinsics(18.837), K)
    jro, jrd = jrays(jc2w, jnp.asarray(K)[None], n_rays)
    tro, trd = trays(tc2w, t(K)[None], n_rays)
    np.testing.assert_allclose(n(tro), n(jro), **TOL)
    np.testing.assert_allclose(n(trd), n(jrd), **TOL)
    return n(jro), n(jrd)


def test_renderer_pieces(rng):
    ro, rd = _camera(math.pi / 2 + 0.3, math.pi / 2 - 0.1)
    jd = jrender.sample_stratified(None, jnp.asarray(ro), 2.25, 3.3, 12)
    td = trender.sample_stratified(None, t(ro), 2.25, 3.3, 12)
    np.testing.assert_allclose(n(td), n(jd), **TOL)
    S = 12
    colors = rng.rand(1, ro.shape[1], S, 4).astype(np.float32)
    dens = rng.randn(1, ro.shape[1], S, 1).astype(np.float32) * 3
    opts = {'clamp_mode': 'softplus'}
    for a, b in zip(tmarch(t(colors), t(dens), t(n(jd)), opts),
                    jmarch(jnp.asarray(colors), jnp.asarray(dens), jd, opts)):
        np.testing.assert_allclose(n(a), n(b), **TOL)
    _, _, w = jmarch(jnp.asarray(colors), jnp.asarray(dens), jd, opts)
    want = jrender.sample_importance(None, jd, w, 10)
    got = trender.sample_importance(None, t(n(jd)), t(n(w)), 10)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-4)
    # ties in depth keep their order (stable sort)
    d2 = n(jd)[:, :, ::-1].copy()
    d2[:, :, 3] = d2[:, :, 4]
    c2 = rng.rand(*colors.shape).astype(np.float32)
    s2 = rng.rand(*dens.shape).astype(np.float32)
    want = jrender.unify_samples(jd, jnp.asarray(colors), jnp.asarray(dens),
                                 jnp.asarray(d2), jnp.asarray(c2),
                                 jnp.asarray(s2))
    got = trender.unify_samples(t(n(jd)), t(colors), t(dens), t(d2), t(c2),
                                t(s2))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(n(a), n(b))


@pytest.mark.parametrize("ray_limits", [(2.25, 3.3), ('auto', 'auto')])
def test_renderer_and_decoder_deterministic(rng, ray_limits):
    """ImportanceRenderer at rng=None (midpoint jitter, linspace importance
    u) with the OSGDecoder, on the plain K4 path."""
    ro, rd = _camera(n_rays=8)
    jdec = JOSGDecoder(32, {'decoder_lr_mul': 1, 'decoder_output_dim': 32})
    params = jax.tree_util.tree_map(np.asarray,
                                    jdec.init(jax.random.PRNGKey(3)))
    tdec = load_jax_params(TOSGDecoder(32, {'decoder_lr_mul': 1,
                                            'decoder_output_dim': 32}),
                           params)
    feats = rng.randn(1, 3, 5, 32).astype(np.float32)
    for a, b in zip(tdec(t(feats)).values(),
                    jdec(params, jnp.asarray(feats)).values()):
        np.testing.assert_allclose(n(a), n(b), **TOL)

    planes = rng.randn(1, 3, 32, 16, 16).astype(np.float32)
    opts = dict(ray_start=ray_limits[0], ray_end=ray_limits[1], box_warp=1.0,
                depth_resolution=8, depth_resolution_importance=8,
                disparity_space_sampling=False, clamp_mode='softplus')
    want = jax.jit(lambda *a: jrender.ImportanceRenderer()(
        None, a[0], (params, jdec), a[1], a[2], opts))(planes, ro, rd)
    got = trender.ImportanceRenderer()(t(planes), tdec, t(ro), t(rd), opts)
    for a, b in zip(got, want):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-4, atol=1e-4)


def test_eye_mask_loading(rng, tmp_path):
    """The UV eye mask read from an image and resized nearest, as
    TriPlaneGenerator builds it (triplane_next3d.py:51-59)."""
    from PIL import Image
    from next3d_tpu.models.triplane_next3d import _load_eye_mask as jload
    from next3d_tpu_torch.models.triplane_next3d import _load_eye_mask
    path = tmp_path / 'mask.png'
    Image.fromarray((rng.rand(100, 90, 3) * 255).astype(np.uint8)).save(path)
    np.testing.assert_array_equal(n(_load_eye_mask(str(path), 64)),
                                  jload(str(path), 64))
