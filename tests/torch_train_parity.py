"""The training parity tests' shared setup: the port's generator and dual
discriminator beside the JAX package's on the same weights, at the small
configuration of tests/test_torch_generator.py (128^2 images, 2X
super-resolution, 8+8 ray samples) with 64^2 planes, on the synthetic head,
and one batch of numpy inputs. The JAX model rasterizes with its TPU
path's kernel, K1, in interpret mode (``k1_interpret``), as
tests/test_torch_cli_parity.py explains: the port's K1 equals it bit for
bit, while the scatter golden interpolates (u, v) in another form, which
moves sigma through the textured planes by about 1e-4 and the gradient of
Greg's L1 term, a difference of sigma at points 0.004 apart, by more than
its gate.

Randomness: the JAX phases split keys inside, so the tests build the JAX
reference from the package's public pieces (``G.mapping``, ``G.synthesis``
and ``G.sample_mixed`` with ``noise_mode='const'`` and ``rng=None``, the D,
``filtered_resizing``) following the formulas of next3d_tpu/train/loss.py.
The port's loss runs with ``deterministic=True`` (constant noise, midpoint
depths), the conditioning-swap and style-mixing probabilities 0, and Greg's
points, perturbations and ray directions drawn here with numpy and given
to both sides."""

import math

import numpy as np
import torch

import jax
import jax.numpy as jnp

from next3d_tpu.models import TriPlaneGenerator as JaxGenerator
from next3d_tpu.models import triplane_next3d as jax_model
from next3d_tpu.nn.discriminator import DualDiscriminator as JaxDual
from next3d_tpu.ops.pallas_raster import rasterize_mesh_pallas_binned_uv
from next3d_tpu.render import camera_utils
from next3d_tpu_torch.models.triplane_next3d import TriPlaneGenerator
from next3d_tpu_torch.nn.discriminator import DualDiscriminator
from next3d_tpu_torch.train.loss import LossConfig, StyleGAN2Loss
from next3d_tpu_torch.utils.synthetic_head import synthetic_head
from next3d_tpu_torch.utils.weights import (load_jax_params,
                                            params_to_state_dict)

from test_torch_generator import CFG, EXPRESSION_SEED, _liven_w_avg
from torch_parity import n, t, to_jax_tree

BATCH = 2
G_CFG = dict(CFG, plane_resolution=64)
D_KWARGS = dict(c_dim=25, img_resolution=128, img_channels=3,
                channel_base=1024, channel_max=32,
                epilogue_kwargs=dict(mbstd_group_size=2))
# the parity tests' loss: swapping probability 0 (no swap, the camera
# label conditions G), no blur, no style mixing
LOSS_CFG = dict(gpc_reg_prob=0.0, gpc_reg_fade_kimg=0.0,
                neural_rendering_resolution_initial=64, density_reg=0.25,
                density_reg_p_dist=0.004, r1_gamma=4.0)


def k1_interpret(verts, faces, uv_attrs, image_size, **_):
    """JAX's rasterize_uv_with_alpha as its 'pallas_binned' path computes
    it, the kernel in interpret mode; no gradient reaches the vertices, as
    in JAX's rasterizers."""
    pix_to_face, u, v = rasterize_mesh_pallas_binned_uv(
        jax.lax.stop_gradient(verts), faces, uv_attrs, image_size, 4096,
        True)
    return jnp.stack([u, v, (pix_to_face >= 0).astype(u.dtype)], axis=1)


def make_generators():
    """(JAX G, its params, the port's G on them), w_avg non-zero. Call it
    with ``jax_model.rasterize_uv_with_alpha`` set to ``k1_interpret``."""
    mesh, _ = synthetic_head()
    port = TriPlaneGenerator(topology_path=mesh,
                             generator=torch.Generator().manual_seed(0),
                             **G_CFG)
    params = _liven_w_avg(to_jax_tree(port), np.random.RandomState(5))
    load_jax_params(port, params)
    jg = JaxGenerator(topology_path=mesh, rasterizer_impl='scatter',
                      rasterizer_patch=16, **G_CFG)
    return jg, params, port


def make_discriminators():
    """(JAX D, its params, the port's D on them)."""
    jd = JaxDual(**D_KWARGS)
    params = jax.tree_util.tree_map(np.asarray,
                                    jd.init(jax.random.PRNGKey(1)))
    return jd, params, load_jax_params(DualDiscriminator(**D_KWARGS), params)


def make_batch():
    """Numpy gen_z, gen_c, gen_v, real_c and a real image batch in [-1, 1],
    on the expressions and camera of tests/test_torch_generator.py."""
    mesh, lms = synthetic_head()
    rng = np.random.RandomState(5)
    v = np.concatenate([mesh.verts, lms])[None].astype(np.float32)
    jitter = np.random.RandomState(EXPRESSION_SEED).randn(*v.shape)
    v = np.concatenate([v, v + jitter.astype(np.float32) * 0.002])
    cam = camera_utils.lookat_pose(math.pi / 2 + 0.2, math.pi / 2 - 0.05,
                                   jnp.asarray([0, 0, 0.2]), radius=2.7,
                                   batch_size=BATCH)
    K = camera_utils.fov_to_intrinsics(18.837)
    c = np.concatenate([np.asarray(cam).reshape(BATCH, 16),
                        np.tile(K.reshape(1, 9), (BATCH, 1))],
                       1).astype(np.float32)
    batch = dict(gen_z=rng.randn(BATCH, 64).astype(np.float32), gen_c=c,
                 gen_v=v, real_c=c[::-1].copy())
    real = np.tanh(rng.randn(BATCH, 3, 128, 128)).astype(np.float32)
    return batch, real


def greg_draws(seed=11, n_points=1000, p_dist=0.004):
    """Greg's initial points, their perturbed copies and the ray directions
    of both (JAX loss.py:263-297), drawn with numpy."""
    rs = np.random.RandomState(seed)
    initial = (rs.rand(BATCH, n_points, 3) * 2 - 1).astype(np.float32)
    perturbed = initial + rs.randn(*initial.shape).astype(np.float32) \
        * np.float32(p_dist)
    dirs = rs.randn(BATCH, 2 * n_points, 3).astype(np.float32)
    return initial, perturbed, dirs


def port_loss(G, D):
    return StyleGAN2Loss(G, D, LossConfig(**LOSS_CFG), deterministic=True)


def torch_batch(batch):
    return {k: t(v) for k, v in batch.items()}


def assert_grads_match(grads, want_tree, trainable, name='',
                       per_tensor=True):
    """The global gradient norm within 1e-3 relative, and with
    ``per_tensor`` each trainable tensor's gradient within max-abs 2e-3 of
    that tensor's largest JAX gradient plus 1e-3 of the largest gradient
    of its sub-network (the first component of its name): an allclose with
    that atol, for the noise strengths, whose gradient is a sum over every
    pixel that cancels to under 1% of the sub-network's scale and keeps
    only a few digits (up to 2% apart in float32 on this init)."""
    want = params_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                       want_tree))
    names = [k for k, ok in trainable.items() if ok]
    assert set(names) <= set(want) and set(grads) == set(names)
    net_scale = {}
    for k in names:
        net = k.split('.')[0]
        net_scale[net] = max(net_scale.get(net, 0), np.abs(want[k]).max())
    worst, failed = (0.0, None), []
    for k in names:
        g, w = n(grads[k]), want[k]
        assert g.shape == w.shape, k
        scale = np.abs(w).max()
        err = np.abs(g - w).max()
        if per_tensor and not (
                err <= 2e-3 * scale + 1e-3 * net_scale[k.split('.')[0]]):
            failed.append((k, err, scale, net_scale[k.split('.')[0]]))
        if scale > 0:
            worst = max(worst, (err / scale, k))
    norm_got = np.sqrt(sum(np.square(n(grads[k]).astype(np.float64)).sum()
                           for k in names))
    norm_want = np.sqrt(sum(np.square(want[k].astype(np.float64)).sum()
                            for k in names))
    print(f'{name}: {len(names)} tensors, worst max-abs / largest '
          f'{worst[0]:.3g} ({worst[1]}); global norm {norm_got:.7g} vs '
          f'{norm_want:.7g}')
    for f in failed:
        print('over the gate (name, max-abs, largest, net largest):', *f)
    assert not failed, name
    assert abs(norm_got - norm_want) <= 1e-3 * norm_want, name


def assert_loss_matches(got, want, name):
    got, want = float(got.detach()), float(want)
    print(f'{name}: {got:.7g} vs JAX {want:.7g}')
    assert abs(got - want) <= 1e-4 * abs(want), name
