"""The texture-variant slice: the port's TriPlaneTextureGenerator forward
against the JAX package's, on the same parameters (the JAX tree loaded with
strict=True) and inputs, at the small configuration of
tests/test_variants.py:70-84 (128^2 output, 2X super-resolution, 64^2
planes, channel_base 2048, channel_max 128, 8+8 ray samples), on the in-repo
synthetic head.

The port rasterizes with K2's plain version and interpolates; the JAX side
runs its exact scatter golden (rasterizer_impl='scatter'). Bounds: the fp32
parity gate of ROADMAP.md, max-abs 2e-3 and mean-abs 1e-4 on image,
image_raw and image_depth. As in tests/test_torch_generator.py, the
expression jitter comes from a seed (EXPRESSION_SEED) at which K2 and the
golden agree on every pixel of all 8 images, asserted first: a pixel that
flips on a float32 rounding tie moves the image by far more than the
gate."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from next3d_tpu.models import TriPlaneTextureGenerator as JaxTexture
from next3d_tpu.render import camera_utils
from next3d_tpu.render.rasterizer import rasterize_mesh
from next3d_tpu_torch.models.triplane_texture import TriPlaneTextureGenerator
from next3d_tpu_torch.ops.raster import rasterize_binned
from next3d_tpu_torch.utils.synthetic_head import synthetic_head
from next3d_tpu_torch.utils.weights import load_jax_params

from test_torch_generator import _liven_w_avg
from torch_parity import n, t, to_jax_tree
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)

RK = dict(ray_start=2.25, ray_end=3.3, box_warp=1.0, depth_resolution=8,
          depth_resolution_importance=8, disparity_space_sampling=False,
          clamp_mode='softplus', c_gen_conditioning_zero=False, c_scale=1.0,
          superresolution_module='SuperresolutionHybrid2X',
          superresolution_noise_mode='none', sr_antialias=True)
CFG = dict(z_dim=32, c_dim=25, w_dim=512, img_resolution=128, img_channels=3,
           rendering_kwargs=RK, channel_base=2048, channel_max=128,
           plane_resolution=64)
# the jitter seed of the second expression: one at which the port's K2 and
# the scatter golden agree on every pixel
EXPRESSION_SEED = 0


@pytest.fixture(scope='module')
def pair():
    mesh, _ = synthetic_head()
    rng = np.random.RandomState(3)
    port = TriPlaneTextureGenerator(
        topology_path=mesh, generator=torch.Generator().manual_seed(0),
        **CFG).eval()
    params = _liven_w_avg(to_jax_tree(port), rng)
    jg = JaxTexture(topology_path=mesh, rasterizer_impl='scatter',
                    rasterizer_patch=16, **CFG)
    load_jax_params(port, params)

    v = mesh.verts[None].astype(np.float32)
    jitter = np.random.RandomState(EXPRESSION_SEED).randn(*v.shape)
    v = np.concatenate([v, v + jitter.astype(np.float32) * 0.002])
    cam = camera_utils.lookat_pose(math.pi / 2 - 0.2, math.pi / 2 + 0.05,
                                   jnp.asarray([0, 0, 0.2]), radius=2.7,
                                   batch_size=2)
    K = camera_utils.fov_to_intrinsics(18.837)
    c = np.concatenate([np.asarray(cam).reshape(2, 16),
                        np.tile(K.reshape(1, 9), (2, 1))], 1)
    c = c.astype(np.float32)
    z = rng.randn(2, 32).astype(np.float32)
    return jg, params, port, z, c, v


def test_jax_tree_loads_strictly(pair):
    """The JAX variant's own tree (no mouth_backbone, no neural_blending)
    has exactly the port's keys and shapes."""
    jg, _, port, *_ = pair
    shapes = jax.eval_shape(jg.init, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes)
    assert 'mouth_backbone' not in tree and 'neural_blending' not in tree
    load_jax_params(TriPlaneTextureGenerator(
        topology_path=synthetic_head()[0], **CFG), tree)


def test_forward_matches_jax(pair):
    jg, params, port, z, c, v = pair
    with torch.no_grad():
        tv = port.project_orth(t(v))
        pf = rasterize_binned(tv, port.faces, 64)[0]
        got = port(t(z), t(c), t(v), truncation_psi=0.7, truncation_cutoff=14,
                   noise_mode='const')
    pf_golden = rasterize_mesh(jnp.asarray(n(tv)), jnp.asarray(jg.faces), 64,
                               patch=16)[0]
    np.testing.assert_array_equal(n(pf), n(pf_golden))

    def forward(p, z, c, v):
        ws = jg.mapping(p, z, c, truncation_psi=0.7, truncation_cutoff=14)
        return jg.synthesis(p, ws, c, v, noise_mode='const')

    want = jax.jit(forward)(params, z, c, v)
    shapes = {'image': (2, 3, 128, 128), 'image_raw': (2, 3, 64, 64),
              'image_depth': (2, 1, 64, 64)}
    for key, shape in shapes.items():
        a, b = n(got[key]), n(want[key])
        assert a.shape == b.shape == shape
        err = np.abs(a - b)
        print(f'{key}: max-abs {err.max():.3g} mean-abs {err.mean():.3g}')
        assert err.max() <= 2e-3 and err.mean() <= 1e-4, key


def test_texture_grid_keeps_its_gradient(pair):
    """The texture is sampled at a grid that is not detached (reference
    triplane.py:168): the loss reaches orth_scale through it."""
    _, _, port, z, c, v = pair
    ws = port.mapping(t(z), t(c), truncation_psi=0.7, truncation_cutoff=14)
    textures, _ = port.build_identity(ws.detach(), noise_mode='const')
    renderings, alphas = port.rasterize_orth(t(v), textures.detach())
    assert alphas.shape == (2, 3, 64, 64) and not alphas.requires_grad
    assert float(alphas[:, 1:].abs().max()) == 0
    port.zero_grad()
    (renderings * alphas[:, :1]).sum().backward()
    assert float(port.orth_scale.grad.abs().sum()) > 0
