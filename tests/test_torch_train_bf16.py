"""Training the bf16 generator (``force_fp32=False``): Gmain, Greg and
Dmain against the JAX package's ``jax.grad`` on the same parameters
(through utils/weights.py) and inputs, at the parity configuration of
tests/torch_train_parity.py with the SR blocks in bf16 too
(``sr_num_fp16_res=4``), on the parity batch's first image. D runs in
float32 in both packages, as the JAX loss runs it (next3d_tpu/train/
loss.py:222). The JAX side rasterizes with its K1 in interpret mode, which
the port's K1 equals bit for bit.

The two packages round to bf16 at different places: the port's K4 and its
backward sum in float32 where JAX's bf16 gather and its VJP (a scatter-add
in the table's type on the CPU, next3d_tpu/ops/grid_sample.py:128-140)
round in bf16, and oneDNN and XLA sum convolutions in different orders. So
bit parity with JAX is not the test. Each phase is held to JAX's own bf16
error instead: the port's bf16 gradient's relative L2 distance to JAX's
float32 gradient is at most 1.5 times JAX's bf16 gradient's, plus a slack
stated beside each phase; the losses agree with JAX's bf16 losses within
stated multiples of bf16's unit roundoff U = 2^-8. On CPU tensors K4's
autograd Function (the card's bf16 backward) returns the float32 plain
gradient cast to bf16."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from next3d_tpu.models import TriPlaneGenerator as JaxGenerator
from next3d_tpu.nn.discriminator import DualDiscriminator as JaxDual
from next3d_tpu.train.loss import LossConfig as JaxLossConfig
from next3d_tpu.train.loss import StyleGAN2Loss as JaxLoss
from next3d_tpu_torch.models.triplane_next3d import TriPlaneGenerator
from next3d_tpu_torch.nn.discriminator import DualDiscriminator
from next3d_tpu_torch.ops import triplane
from next3d_tpu_torch.train.loss import LossConfig, StyleGAN2Loss
from next3d_tpu_torch.train.train_step import trainable_mask
from next3d_tpu_torch.utils.synthetic_head import synthetic_head
from next3d_tpu_torch.utils.weights import (load_jax_params,
                                            params_to_state_dict)

from test_torch_generator import _liven_w_avg
from torch_parity import n, t, to_jax_tree
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)
from torch_train_parity import (D_KWARGS, G_CFG, LOSS_CFG, greg_draws,
                                jax_model, k1_interpret, make_batch)

U = 2.0 ** -8            # bf16's unit roundoff
CFG = dict(G_CFG, sr_num_fp16_res=4)


def _rel(got, want, names):
    """Relative L2 distance of two gradients over ``names``."""
    num = sum(np.square(n(got[k]).astype(np.float64) - want[k]).sum()
              for k in names)
    den = sum(np.square(want[k].astype(np.float64)).sum() for k in names)
    return float(np.sqrt(num / den))


def _flat(tree):
    return params_to_state_dict(jax.tree_util.tree_map(np.asarray, tree))


def _grads(loss, module):
    mask = trainable_mask(module)
    named = [(k, p) for k, p in module.named_parameters() if mask[k]]
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    return {k: g if g is not None else torch.zeros_like(p)
            for (k, p), g in zip(named, grads)}, [k for k, _ in named]


def _no_worse(phase, port, jax_bf16, jax_fp32, names, slack):
    port_gap = _rel(port, jax_fp32, names)
    jax_gap = _rel(jax_bf16, jax_fp32, names)
    print(f'{phase}: relative L2 to JAX fp32: port bf16 {port_gap:.4g}, '
          f'JAX bf16 {jax_gap:.4g}')
    assert 0 < port_gap <= 1.5 * jax_gap + slack, phase


@pytest.fixture(scope='module')
def setup():
    """The port's bf16 G and JAX's fp32 and bf16 G on one param tree, D on
    the port's seeded init, the parity batch's first image."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_model, 'rasterize_uv_with_alpha', k1_interpret)
        mesh, _ = synthetic_head()
        G = TriPlaneGenerator(topology_path=mesh, force_fp32=False,
                              generator=torch.Generator().manual_seed(0),
                              **CFG)
        pg = _liven_w_avg(to_jax_tree(G), np.random.RandomState(5))
        load_jax_params(G, pg)
        jgs = {fp32: JaxGenerator(topology_path=mesh, force_fp32=fp32,
                                  rasterizer_impl='scatter',
                                  rasterizer_patch=16, **CFG)
               for fp32 in (True, False)}
        D = DualDiscriminator(generator=torch.Generator().manual_seed(1),
                              **D_KWARGS)
        jd, pd = JaxDual(**D_KWARGS), to_jax_tree(D)
        batch, real = make_batch()
        yield dict(G=G, pg=pg, jgs=jgs, D=D, jd=jd, pd=pd, real=real[:1],
                   batch={k: a[:1] for k, a in batch.items()})


@pytest.fixture(scope='module')
def jax_gmain(setup):
    """Per precision (force_fp32 True, False): JAX's Gmain loss, its
    gradient and G's images (for Dmain)."""
    s = setup
    z, c, v = (jnp.asarray(s['batch'][k]) for k in ('gen_z', 'gen_c',
                                                     'gen_v'))
    out = {}
    for fp32, jg in s['jgs'].items():
        def gmain(p, jg=jg):
            ws = jg.mapping(p, z, c)
            img = jg.synthesis(p, ws, c, v, neural_rendering_resolution=64,
                               noise_mode='const', rng=None)
            logits = s['jd'](s['pd'], img, c, rng=None, force_fp32=True)
            return jnp.mean(jax.nn.softplus(-logits)), {
                k: img[k] for k in ('image', 'image_raw')}

        (loss, images), grads = jax.jit(jax.value_and_grad(
            gmain, has_aux=True))(s['pg'])
        out[fp32] = float(loss), _flat(grads), images
    return out


def _port_loss(s):
    return StyleGAN2Loss(s['G'], s['D'], LossConfig(**LOSS_CFG),
                         deterministic=True)


def test_gmain_bf16(setup, jax_gmain):
    """Gmain: the loss within 1 U relative of JAX's bf16 loss (measured
    0.06 U); the gradient no farther from JAX's float32 gradient than 1.5
    times JAX's bf16 gradient, plus 0.01 (measured 0.047 against JAX's
    0.31: JAX's bf16 VJP of the gather adds in bf16)."""
    s = setup
    loss_obj = _port_loss(s)
    sched, nrr = loss_obj.schedules(0)
    loss, _, _ = loss_obj.gmain_loss({k: t(v) for k, v in s['batch'].items()},
                                     None, sched, nrr)
    got, names = _grads(loss, s['G'])
    want_bf16 = jax_gmain[False][0]
    print(f'Gmain loss: port bf16 {float(loss):.7g}, JAX bf16 '
          f'{want_bf16:.7g}, JAX fp32 {jax_gmain[True][0]:.7g}')
    assert abs(float(loss) - want_bf16) <= U * abs(want_bf16)
    _no_worse('Gmain', got, jax_gmain[False][1], jax_gmain[True][1], names,
              0.01)


def test_greg_bf16(setup):
    """Greg ('l1'): mean |sigma(x) - sigma(x + e)| * density_reg at the
    same 1000 points and directions in both packages. The loss, a mean of
    differences of sigma at points 0.004 apart, within 4 U relative of
    JAX's bf16 loss (measured 1.1 U; JAX's bf16 loss is 6 U from its
    float32 loss); the gradient as Gmain's, plus 0.02 (the difference of
    two gradients that nearly cancel; measured 0.15 against JAX's 0.23)."""
    s = setup
    batch = s['batch']
    z, c, v = (jnp.asarray(batch[k]) for k in ('gen_z', 'gen_c', 'gen_v'))
    initial, perturbed, dirs = (a[:1] for a in greg_draws())
    reg = LOSS_CFG['density_reg']
    want = {}
    for fp32, jg in s['jgs'].items():
        def greg(p, jg=jg):
            ws = jg.mapping(p, z, c)
            sigma = jg.sample_mixed(
                p, jnp.concatenate([initial, perturbed], axis=1), dirs, ws,
                v, noise_mode='const', rng=None)['sigma']
            half = sigma.shape[1] // 2
            return jnp.mean(jnp.abs(sigma[:, :half] - sigma[:, half:])) \
                * reg

        loss, grads = jax.jit(jax.value_and_grad(greg))(s['pg'])
        want[fp32] = float(loss), _flat(grads)
    loss_obj = _port_loss(s)
    sched, _ = loss_obj.schedules(0)
    loss, _ = loss_obj.greg_loss({k: t(a) for k, a in batch.items()}, None,
                                 sched, draws=[(t(initial), t(perturbed),
                                                t(dirs))])
    got, names = _grads(loss, s['G'])
    print(f'Greg loss: port bf16 {float(loss):.7g}, JAX bf16 '
          f'{want[False][0]:.7g}, JAX fp32 {want[True][0]:.7g}')
    assert abs(float(loss) - want[False][0]) <= 4 * U * want[False][0]
    _no_worse('Greg', got, want[False][1], want[True][1], names, 0.02)


def test_dmain_bf16(setup, jax_gmain):
    """Dmain: softplus(D(G)) + softplus(-D(real)) with G's images from each
    package's generator without gradient: the loss within 1 U relative
    (measured 0.03 U) and D's gradient held as Gmain's (measured 0.0500
    against JAX's 0.0503: the two bf16 generators' images are as far from
    the float32 images)."""
    s = setup
    jd = s['jd']
    c, real_c = (jnp.asarray(s['batch'][k]) for k in ('gen_c', 'real_c'))
    real = jax.tree_util.tree_map(np.asarray, JaxLoss(
        None, jd, JaxLossConfig(**LOSS_CFG)).prepare_real(
            jnp.asarray(s['real']), 0.0, 64))

    @jax.jit
    def dmain(p, gen_img):
        fake = jd(p, gen_img, c, force_fp32=True)
        real_logits = jd(p, real, real_c, force_fp32=True)
        return jnp.mean(jax.nn.softplus(fake)) + \
            jnp.mean(jax.nn.softplus(-real_logits))

    want = {fp32: jax.value_and_grad(dmain)(s['pd'], jax_gmain[fp32][2])
            for fp32 in (True, False)}
    loss_obj = _port_loss(s)
    sched, nrr = loss_obj.schedules(0)
    real_port = loss_obj.prepare_real(t(s['real']), sched['blur_sigma'], nrr)
    loss, _, _ = loss_obj.dmain_loss(
        {k: t(a) for k, a in s['batch'].items()}, real_port, None, sched,
        nrr)
    got, names = _grads(loss, s['D'])
    want_bf16 = float(want[False][0])
    print(f'Dmain loss: port bf16 {float(loss):.7g}, JAX bf16 '
          f'{want_bf16:.7g}, JAX fp32 {float(want[True][0]):.7g}')
    assert abs(float(loss) - want_bf16) <= U * abs(want_bf16)
    _no_worse('Dmain', got, _flat(want[False][1]), _flat(want[True][1]),
              names, 0.01)


def test_k4_bf16_function_backward_on_cpu(rng):
    """K4's autograd Function, which the card runs for bf16 planes that
    require grad: on CPU tensors its backward is the plain float32
    backward's gradient cast to bf16, returned in bf16, with no launch
    counted by either backward kernel."""
    planes = torch.from_numpy(rng.randn(2, 3, 16, 12, 32).astype(
        np.float32)).to(torch.bfloat16).requires_grad_()
    coords = t(rng.uniform(-0.6, 0.6, (2, 500, 3)).astype(np.float32))
    grad_out = t(rng.randn(2, 3, 500, 32).astype(np.float32))
    before = (triplane.triplane_sample_backward.launches,
              triplane.triplane_sample_backward_bf16.launches)
    out = triplane._SampleWithBackward.apply(planes, coords, 1.0)
    torch.testing.assert_close(
        out, triplane.triplane_sample_plain(planes.detach(), coords, 1.0),
        rtol=0, atol=0)
    out.backward(grad_out)
    want = triplane.triplane_sample_backward_plain(grad_out, coords, 1.0,
                                                   16, 12)
    assert planes.grad.dtype == torch.bfloat16
    assert torch.equal(planes.grad, want.to(torch.bfloat16))
    assert (triplane.triplane_sample_backward.launches,
            triplane.triplane_sample_backward_bf16.launches) == before
