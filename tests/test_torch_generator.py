"""The whole slice: the port's TriPlaneGenerator forward against the JAX
package's, on the same parameters and inputs, at the small configuration
of tests/test_identity_cache.py (128^2 output, 2X super-resolution, 8+8
ray samples, channel_base 2048, channel_max 64) with 128^2 planes, on the
in-repo synthetic head.

The port runs K1's and K4's plain versions; the JAX side rasterizes with
its exact scatter golden (rasterizer_impl='scatter'). Bounds: the fp32
full-scale parity gate of ROADMAP.md, max-abs 2e-3 and mean-abs 1e-4 on
image, image_raw and image_depth. The port's other rasterizers run the same
slice: 'pallas_binned16' (K3) must give the default forward bit for bit,
and 'pallas' (K5, then the barycentric interpolation) must meet the same
gate against the same JAX forward.

Where two faces tie in depth to within float32 rounding (or an edge
passes through a pixel centre), the scatter golden, which evaluates its
edge and depth planes in another form than K1, can pick the other face,
and one flipped pixel moves the image by far more than the gate. So the
second expression's jitter is drawn from a seed (EXPRESSION_SEED) at which
the two rasterizers agree on every pixel of all 8 images, and the test
asserts that first. Pixel-level disagreement is held apart in
tests/test_torch_raster.py."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from next3d_tpu.models import TriPlaneGenerator as JaxGenerator
from next3d_tpu.render import camera_utils
from next3d_tpu.render.rasterizer import rasterize_mesh
from next3d_tpu_torch.ops.raster import rasterize_binned_uv
from next3d_tpu_torch.ops.raster_zbuffer import rasterize_zbuffer
from next3d_tpu_torch.models.triplane_next3d import TriPlaneGenerator
from next3d_tpu_torch.utils.synthetic_head import synthetic_head
from next3d_tpu_torch.utils.weights import load_jax_params

from torch_parity import n, one_thread, t, to_jax_tree  # noqa: F401
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)

RK = dict(ray_start=2.25, ray_end=3.3, box_warp=1.0, depth_resolution=8,
          depth_resolution_importance=8, disparity_space_sampling=False,
          clamp_mode='softplus', c_gen_conditioning_zero=False, c_scale=1.0,
          superresolution_module='SuperresolutionHybrid2X',
          superresolution_noise_mode='none', sr_antialias=True)
CFG = dict(z_dim=64, c_dim=25, w_dim=512, img_resolution=128, img_channels=3,
           rendering_kwargs=RK, channel_base=2048, channel_max=64,
           plane_resolution=128)
# the jitter seed of the second expression: one at which the port's K1 and
# the scatter golden agree on every pixel (with K1 rounded in the fused
# form of JAX's K1, seeds 0-9 flip 1 to 4 pixels)
EXPRESSION_SEED = 10


def _liven_w_avg(tree, rng):
    """A non-zero w_avg, so that truncation takes part."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _liven_w_avg(v, rng)
        elif k == 'w_avg':
            tree[k] = rng.randn(*v.shape).astype(np.float32)
    return tree


@pytest.fixture(scope='module')
def pair():
    mesh, lms = synthetic_head()
    rng = np.random.RandomState(5)
    port = TriPlaneGenerator(topology_path=mesh,
                             generator=torch.Generator().manual_seed(0),
                             **CFG).eval()
    params = _liven_w_avg(to_jax_tree(port), rng)
    load_jax_params(port, params)
    jg = JaxGenerator(topology_path=mesh, rasterizer_impl='scatter',
                      rasterizer_patch=16, **CFG)

    v = np.concatenate([mesh.verts, lms])[None].astype(np.float32)
    jitter = np.random.RandomState(EXPRESSION_SEED).randn(*v.shape)
    v = np.concatenate([v, v + jitter.astype(np.float32) * 0.002])
    cam = camera_utils.lookat_pose(math.pi / 2 + 0.2, math.pi / 2 - 0.05,
                                   jnp.asarray([0, 0, 0.2]), radius=2.7,
                                   batch_size=2)
    K = camera_utils.fov_to_intrinsics(18.837)
    c = np.concatenate([np.asarray(cam).reshape(2, 16),
                        np.tile(K.reshape(1, 9), (2, 1))], 1).astype(np.float32)
    z = rng.randn(2, 64).astype(np.float32)
    with torch.no_grad():
        ws = port.mapping(t(z), t(c), truncation_psi=0.7,
                          truncation_cutoff=14)
        out = port.synthesis(ws, t(c), t(v), noise_mode='const')

    def forward(p, z, c, v):
        ws = jg.mapping(p, z, c, truncation_psi=0.7, truncation_cutoff=14)
        return jg.synthesis(p, ws, c, v, noise_mode='const')

    want = jax.jit(forward)(params, z, c, v)
    return jg, params, port, z, c, v, ws, out, want


def _golden_pix_to_face(jg, port, v):
    """The JAX scatter golden's visibility of the port's 4-view projection."""
    with torch.no_grad():
        tv, _ = port.project_views(t(v[:, :5023]), t(v[:, 5023:]))
    pf = rasterize_mesh(jnp.asarray(n(tv)), jnp.asarray(jg.faces), 128,
                        patch=16)[0]
    return tv, n(pf)


def _assert_gate(got, want):
    shapes = {'image': (2, 3, 128, 128), 'image_raw': (2, 3, 64, 64),
              'image_depth': (2, 1, 64, 64)}
    for key, shape in shapes.items():
        a, b = n(got[key]), n(want[key])
        assert a.shape == b.shape == shape
        err = np.abs(a - b)
        print(f'{key}: max-abs {err.max():.3g} mean-abs {err.mean():.3g}')
        assert err.max() <= 2e-3 and err.mean() <= 1e-4, key


def _variant(pair, impl):
    """The port's generator with another rasterizer, on the same weights."""
    _, params, _, z, c, v, ws, _, _ = pair
    mesh, _ = synthetic_head()
    port = TriPlaneGenerator(topology_path=mesh, rasterizer_impl=impl,
                             **CFG).eval()
    load_jax_params(port, params)
    with torch.no_grad():
        return port, port.synthesis(ws, t(c), t(v), noise_mode='const')


def test_forward_matches_jax(pair):
    jg, params, port, z, c, v, _, got, want = pair
    tv, pf_golden = _golden_pix_to_face(jg, port, v)
    with torch.no_grad():
        pf = rasterize_binned_uv(tv, port.faces, port.face_uv[None], 128)[0]
    np.testing.assert_array_equal(n(pf), pf_golden)
    _assert_gate(got, want)
    # clamped to the sample range: midpoint jitter puts the last sample
    # half a bin past ray_end
    depth = n(got['image_depth'])
    assert np.all((depth >= 2.25) & (depth <= 3.3 + 1.05 / 7 / 2))


def test_binned16_forward_equals_binned(pair):
    port, got = _variant(pair, 'pallas_binned16')
    assert port.rasterizer_impl == 'pallas_binned16'
    for key, want in pair[7].items():
        assert torch.equal(got[key], want), key


@pytest.mark.usefixtures('one_thread')
def test_zbuffer_forward_matches_jax(pair):
    """'pallas': K5's visibility equals the golden's on all 8 images (the
    same edge arithmetic), then the gate."""
    jg, *_, want = pair
    port, got = _variant(pair, 'pallas')
    tv, pf_golden = _golden_pix_to_face(jg, port, pair[5])
    np.testing.assert_array_equal(
        n(rasterize_zbuffer(tv, port.faces, 128, port.rasterizer_patch)[0]),
        pf_golden)
    _assert_gate(got, want)


def test_synthesis_from_identity_matches_synthesis(pair):
    _, _, port, _, c, v, ws, full, _ = pair
    with torch.no_grad():
        textures, static = port.build_identity(ws, noise_mode='const')
        cached = port.synthesis_from_identity(ws, textures, static, t(c),
                                              t(v), noise_mode='const')
    for key in ('image', 'image_raw', 'image_depth'):
        # the same ops on the same inputs
        torch.testing.assert_close(cached[key], full[key], rtol=0, atol=1e-6)
