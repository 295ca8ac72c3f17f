"""K4: the port's tri-plane sampler (plain version, CPU) against the JAX
package's XLA sampling path and its Pallas kernel in interpret mode, on the
access patterns of tests/test_pallas_triplane.py.

Tolerance 1e-5 max-abs: the same bilinear taps and weights, with the
coordinate unnormalization rounded in a different order (F.grid_sample vs
the JAX formula), on O(1) plane values. The kernel itself runs only on a
GPU: tests/test_torch_cuda.py and chip_smoke.py hold it against the plain
version there."""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from next3d_tpu.ops.pallas_triplane import sample_from_planes_fused
from next3d_tpu.render import camera_utils
from next3d_tpu.render.ray_sampler import sample_rays
from next3d_tpu.render.renderer import sample_from_planes as jax_sample
from next3d_tpu_torch.ops.triplane import channels_last, triplane_sample
from next3d_tpu_torch.render.renderer import sample_from_planes

from torch_parity import n, t
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)


def _camera_coords(n_img=1, rays=256, steps=16, yaw=0.0, pitch=0.0):
    cam = camera_utils.lookat_pose(math.pi / 2 + yaw, math.pi / 2 + pitch,
                                   jnp.asarray([0, 0, 0.2]), radius=2.7)
    K = jnp.asarray(camera_utils.fov_to_intrinsics(18.837))[None]
    ro, rd = sample_rays(jnp.tile(cam, (n_img, 1, 1)),
                         jnp.tile(K, (n_img, 1, 1)), int(math.sqrt(rays)))
    depths = jnp.linspace(2.25, 3.3, steps)
    coords = ro[:, :, None] + depths[None, None, :, None] * rd[:, :, None]
    return np.asarray(coords.reshape(n_img, -1, 3))


@pytest.mark.parametrize("case", ['inside', 'side_pose', 'out_of_box'])
def test_plain_matches_jax_sampling(rng, case):
    planes = rng.randn(2, 3, 32, 64, 64).astype(np.float32)
    if case == 'inside':       # projections stay inside the planes
        coords = _camera_coords(2, 256, 32) * 0.42
    elif case == 'side_pose':  # sweeps out of the box: zeros padding
        coords = _camera_coords(2, 256, 32, yaw=0.6, pitch=0.1)
    else:                      # far outside, on every side
        coords = rng.uniform(-1.5, 1.5, (2, 4096, 3)).astype(np.float32)
    want = n(jax_sample(jnp.asarray(planes), jnp.asarray(coords), 1.0))
    got = n(sample_from_planes(t(planes), t(coords), 1.0))
    assert got.shape == (2, 3, coords.shape[1], 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_plain_matches_pallas_kernel_interpret(rng):
    planes = rng.randn(1, 3, 32, 32, 32).astype(np.float32)
    coords = _camera_coords(1, 64, 16, yaw=0.3)  # M = 1024, partly outside
    want = n(sample_from_planes_fused(jnp.asarray(planes), jnp.asarray(coords),
                                      box_warp=2.0, tile_samples=512,
                                      interpret=True, precision='highest'))
    got = n(triplane_sample(channels_last(t(planes)), t(coords), 2.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)



def test_plain_is_differentiable_like_jax(rng):
    """On CPU tensors K4's wrapper runs F.grid_sample, which carries
    gradients to the planes and the coordinates (on the card K4's backward
    gives the planes' gradient only, and coordinates that require grad
    raise, tests/test_torch_cuda.py). They
    match jax.grad of the JAX package's sampling within 1e-4."""
    import jax
    planes = rng.randn(1, 3, 32, 16, 16).astype(np.float32)
    coords = _camera_coords(1, 64, 8, yaw=0.3) * 0.42
    weight = rng.randn(1, 3, coords.shape[1], 32).astype(np.float32)

    def loss(p, c):
        return jnp.sum(jax_sample(p, c, 1.0) * weight)

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(planes),
                                         jnp.asarray(coords))
    p, c = t(planes).requires_grad_(), t(coords).requires_grad_()
    (sample_from_planes(p, c, 1.0) * t(weight)).sum().backward()
    for got, ref in zip((p.grad, c.grad), want):
        np.testing.assert_allclose(n(got), n(ref), rtol=0, atol=1e-4)
    assert float(p.grad.abs().max()) > 0 and float(c.grad.abs().max()) > 0
