"""Gradients that training takes through the port's render path, against
jax.grad of the JAX package on the same inputs (CPU).

- The importance renderer: the JAX package stops the gradient of the coarse
  depths and weights before the inverse-CDF draw (renderer.py:211-212), so
  the fine-pass points depend on no parameter; the port detaches them too.
  The gradient of the rendered rgb with respect to the planes is held to
  JAX's within 1e-5 of the largest gradient.
- K4's backward: the plain version (``index_add_`` of the four taps)
  against the gradient of ``F.grid_sample`` and against jax.grad of JAX's
  ``sample_from_planes``, within 1e-5 of the largest gradient. The kernel
  runs on the card only (tests/test_torch_cuda.py, chip_smoke.py).
- The convolutions that R1 differentiates twice (``ops/conv2d_gradfix.py``):
  gradcheck and gradgradcheck in float64.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from next3d_tpu.models.osg_decoder import OSGDecoder as JOSGDecoder
from next3d_tpu.render import camera_utils as jcam
from next3d_tpu.render import renderer as jrender
from next3d_tpu.render.ray_sampler import sample_rays as jrays
from next3d_tpu_torch.models.osg_decoder import OSGDecoder
from next3d_tpu_torch.ops import triplane
from next3d_tpu_torch.ops.triplane import (channels_last,
                                           triplane_sample_backward,
                                           triplane_sample_backward_plain,
                                           triplane_sample_plain)
from next3d_tpu_torch.render import renderer
from next3d_tpu_torch.utils.weights import load_jax_params

from torch_parity import n, one_thread, t  # noqa: F401 (a fixture)
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)

OPTS = dict(ray_start=2.25, ray_end=3.3, box_warp=1.0, depth_resolution=8,
            depth_resolution_importance=8, disparity_space_sampling=False,
            clamp_mode='softplus')


def _rays(n_rays=8, yaw=0.3):
    cam = jcam.lookat_pose(math.pi / 2 + yaw, math.pi / 2 - 0.1,
                           jnp.asarray([0, 0, 0.2]), radius=2.7)
    K = jnp.asarray(jcam.fov_to_intrinsics(18.837))[None]
    ro, rd = jrays(cam, K, n_rays)
    return np.asarray(ro), np.asarray(rd)


def _assert_close_to_largest(got, want, rel, name):
    got, want = n(got), np.asarray(want)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    print(f'{name}: max-abs {err:.3g} of largest {scale:.3g}')
    assert scale > 0 and err <= rel * scale, name


@pytest.fixture(scope='module')
def decoders():
    jdec = JOSGDecoder(32, {'decoder_lr_mul': 1, 'decoder_output_dim': 32})
    params = jax.tree_util.tree_map(np.asarray,
                                    jdec.init(jax.random.PRNGKey(3)))
    tdec = load_jax_params(OSGDecoder(32, {'decoder_lr_mul': 1,
                                           'decoder_output_dim': 32}), params)
    return jdec, params, tdec


def test_renderer_planes_gradient_matches_jax(decoders, monkeypatch):
    """The rendered rgb's gradient with respect to the planes (rng=None on
    both sides: midpoint depths, linspace importance draws) equals
    jax.grad of JAX's ImportanceRenderer, and the fine pass samples points
    that do not require grad."""
    jdec, params, tdec = decoders
    rs = np.random.RandomState(0)
    planes = rs.randn(1, 3, 32, 16, 16).astype(np.float32)
    ro, rd = _rays()
    weight = rs.randn(1, ro.shape[1], 32).astype(np.float32)

    def jax_loss(p):
        rgb, _, _ = jrender.ImportanceRenderer()(None, p, (params, jdec),
                                                 ro, rd, OPTS)
        return jnp.sum(rgb * weight)

    want = jax.jit(jax.grad(jax_loss))(jnp.asarray(planes))

    points_require_grad = []
    sample = renderer.triplane_sample

    def recording(planes_cl, coordinates, box_warp):
        points_require_grad.append(coordinates.requires_grad)
        return sample(planes_cl, coordinates, box_warp)

    monkeypatch.setattr(renderer, 'triplane_sample', recording)
    p = t(planes).requires_grad_()
    rgb, _, _ = renderer.ImportanceRenderer()(p, tdec, t(ro), t(rd), OPTS)
    got, = torch.autograd.grad((rgb * t(weight)).sum(), p)
    assert points_require_grad == [False, False]
    _assert_close_to_largest(got, want, 1e-5, 'd rgb / d planes')


def test_density_noise_draws_from_the_generator(decoders):
    """A positive density_noise adds N(0, 1) * density_noise to sigma, drawn
    from the renderer's generator (JAX :264-267); without one it raises."""
    _, _, tdec = decoders
    planes = channels_last(t(np.random.RandomState(1).randn(
        1, 3, 32, 16, 16).astype(np.float32)))
    coords = t(np.random.RandomState(2).uniform(
        -0.5, 0.5, (1, 50, 3)).astype(np.float32))
    opts = dict(OPTS, density_noise=0.5)
    r = renderer.ImportanceRenderer()
    clean = r.run_model(planes, tdec, coords, coords, OPTS)['sigma']
    noisy = r.run_model(planes, tdec, coords, coords, opts,
                        torch.Generator().manual_seed(7))['sigma']
    draw = torch.randn(clean.shape, generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(noisy, clean + 0.5 * draw, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match='generator'):
        r.run_model(planes, tdec, coords, coords, opts)


@pytest.mark.parametrize('case', ['inside', 'side_pose', 'out_of_box'])
def test_k4_plain_backward_matches_grid_sample_and_jax(case):
    """The plain backward against F.grid_sample's gradient (the plain
    forward's autograd) and against jax.grad of JAX's sample_from_planes,
    with zeros padding: points inside, sweeping out of, and far outside
    the box."""
    rs = np.random.RandomState(4)
    planes = rs.randn(2, 3, 32, 24, 20).astype(np.float32)
    if case == 'out_of_box':
        coords = rs.uniform(-1.5, 1.5, (2, 600, 3)).astype(np.float32)
    else:
        ro, rd = _rays(n_rays=10, yaw=0.0 if case == 'inside' else 0.7)
        depths = np.linspace(2.25, 3.3, 6, dtype=np.float32)
        coords = (ro[:, :, None] + depths[None, None, :, None]
                  * rd[:, :, None]).reshape(1, -1, 3)
        coords = np.concatenate([coords, coords[:, ::-1] * 0.9])
        if case == 'inside':
            coords = coords * 0.42
    grad_out = rs.randn(2, 3, coords.shape[1], 32).astype(np.float32)
    box_warp = 1.5

    p = channels_last(t(planes)).requires_grad_()
    out = triplane_sample_plain(p, t(coords), box_warp)
    by_autograd, = torch.autograd.grad(out, p, t(grad_out))
    got = triplane_sample_backward_plain(t(grad_out), t(coords), box_warp,
                                         24, 20)
    assert got.shape == (2, 3, 24, 20, 32)
    # the CPU dispatch of the wrapper is the plain version
    assert torch.equal(triplane_sample_backward(t(grad_out), t(coords),
                                                box_warp, 24, 20), got)
    _assert_close_to_largest(got, by_autograd, 1e-5, 'vs F.grid_sample')

    def jax_loss(pl):
        return jnp.sum(jrender.sample_from_planes(pl, coords, box_warp)
                       * grad_out)

    want = jax.jit(jax.grad(jax_loss))(jnp.asarray(planes))
    _assert_close_to_largest(got, np.asarray(want).transpose(0, 1, 3, 4, 2),
                             1e-5, 'vs jax.grad')
    assert triplane.triplane_sample_backward.launches == 0


@pytest.mark.usefixtures('one_thread')
@pytest.mark.parametrize('transpose,stride,padding,groups', [
    (False, 1, 1, 1), (False, 2, 0, 2), (False, 2, (1, 0), 1),
    (True, 2, 1, 1), (True, 2, 0, 4)])
def test_conv2d_gradfix_second_order(transpose, stride, padding, groups):
    """``ops/conv2d_gradfix.py``: the value of F.conv2d /
    F.conv_transpose2d, and first and second derivatives that
    torch.autograd.gradcheck and gradgradcheck accept (float64), for the
    strides, paddings and groups that D and the FIR filters take."""
    from torch.autograd import gradcheck, gradgradcheck
    from next3d_tpu_torch.ops import conv2d_gradfix
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 4, 5, 4, generator=g, dtype=torch.double,
                    requires_grad=True)
    if transpose:
        w = torch.randn(4, 1, 3, 3, generator=g, dtype=torch.double,
                        requires_grad=True)

        def fn(x, w):
            return conv2d_gradfix.conv_transpose2d(x, w, stride, padding,
                                                   0, groups)

        def ref(x, w):
            return torch.nn.functional.conv_transpose2d(
                x, w, stride=stride, padding=padding, groups=groups)
    else:
        w = torch.randn(2, 4 // groups, 3, 3, generator=g,
                        dtype=torch.double, requires_grad=True)

        def fn(x, w):
            return conv2d_gradfix.conv2d(x, w, stride, padding, groups)

        def ref(x, w):
            return torch.nn.functional.conv2d(x, w, stride=stride,
                                              padding=padding, groups=groups)
    assert torch.equal(fn(x, w), ref(x, w))
    assert gradcheck(fn, (x, w)) and gradgradcheck(fn, (x, w))
