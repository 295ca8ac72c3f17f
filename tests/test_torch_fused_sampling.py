"""The ``fused_plane_sampling`` rendering option in the port's renderer
(next3d_tpu_torch/render/renderer.py) against the JAX package's, which
routes it to sample_from_planes_fused (next3d_tpu/render/renderer.py
:245-257), here with the TPU kernel triplane_sample_tiles in interpret
mode: the two-pass render within max-abs 2e-3 and mean-abs 1e-4 for
``fused_precision`` 'highest' and 'bf16' (off the TPU both are the float32
bilinear sample), ``gather_bf16`` ignored under the option as JAX ignores
it, and the option values and planes that JAX refuses refused."""

import math

import numpy as np
import pytest

import jax

from next3d_tpu.models.osg_decoder import OSGDecoder as JOSGDecoder
from next3d_tpu.ops.pallas_triplane import sample_from_planes_fused
from next3d_tpu.render import renderer as jrender
from next3d_tpu_torch.models.osg_decoder import OSGDecoder as TOSGDecoder
from next3d_tpu_torch.render import renderer as trender
from next3d_tpu_torch.utils.weights import load_jax_params

from test_torch_ops import _camera
from torch_parity import n, t

DECODER = {'decoder_lr_mul': 1, 'decoder_output_dim': 32}
OPTS = dict(ray_start=2.25, ray_end=3.3, box_warp=1.0, depth_resolution=8,
            depth_resolution_importance=8, disparity_space_sampling=False,
            clamp_mode='softplus', fused_plane_sampling=True,
            fused_tile_samples=128, fused_interpret=True)


@pytest.fixture(scope='module')
def scene():
    rng = np.random.RandomState(4)
    ro, rd = _camera(math.pi / 2 + 0.2, math.pi / 2 - 0.1, n_rays=8)
    jdec = JOSGDecoder(32, DECODER)
    params = jax.tree_util.tree_map(np.asarray,
                                    jdec.init(jax.random.PRNGKey(5)))
    tdec = load_jax_params(TOSGDecoder(32, DECODER), params)
    planes = rng.randn(1, 3, 32, 16, 16).astype(np.float32)
    return ro, rd, jdec, params, tdec, planes


@pytest.mark.parametrize('precision', ['highest', 'bf16'])
def test_fused_option_matches_jax_fused_path(scene, precision):
    ro, rd, jdec, params, tdec, planes = scene
    opts = dict(OPTS, fused_precision=precision)
    want = jax.jit(lambda *a: jrender.ImportanceRenderer()(
        None, a[0], (params, jdec), a[1], a[2], opts))(planes, ro, rd)
    got = trender.ImportanceRenderer()(t(planes), tdec, t(ro), t(rd), opts)
    for a, b in zip(got, want):
        diff = np.abs(n(a) - np.asarray(b))
        assert diff.max() <= 2e-3 and diff.mean() <= 1e-4, diff.max()
    # the option samples the planes as they are: gather_bf16 is ignored
    again = trender.ImportanceRenderer()(t(planes), tdec, t(ro), t(rd),
                                         dict(opts, gather_bf16=True))
    for a, b in zip(again, got):
        np.testing.assert_array_equal(n(a), n(b))


@pytest.mark.parametrize('case', ['non-square', 'precision', 'lanes',
                                  'tile'])
def test_fused_option_refuses_what_jax_refuses(scene, case):
    """Planes 16 x 8, a precision 'fp8', 4 channels (a plane row of 64
    values, not a multiple of 128 lanes) and a tile of 0 samples: JAX's
    fused path raises for each, and so does the port's renderer."""
    ro, rd, jdec, params, tdec, planes = scene
    opts = dict(OPTS)
    if case == 'non-square':
        planes = planes[..., :8]
    elif case == 'precision':
        opts['fused_precision'] = 'fp8'
    elif case == 'lanes':
        planes = planes[:, :, :4]
    else:
        opts['fused_tile_samples'] = 0
    with pytest.raises((AssertionError, KeyError, ZeroDivisionError)):
        sample_from_planes_fused(
            planes, ro[:, :4] * 0.1, 1.0,
            tile_samples=opts['fused_tile_samples'],
            precision=opts.get('fused_precision', 'bf16'), interpret=True)
    with pytest.raises(ValueError, match='fused'):
        trender.ImportanceRenderer()(t(planes), tdec, t(ro), t(rd), opts)
