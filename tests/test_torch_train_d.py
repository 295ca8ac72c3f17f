"""The discriminator and its regularization phase, Dreg (R1), the optimizer,
the w_avg and G_ema updates and the trainable masks, against the JAX
package on the same weights and inputs (CPU).

Gates: D's logits within max-abs 1e-4; filtered_resizing within 1e-5
(``F.interpolate`` against the JAX package's weighted gathers); each
phase's loss within 1e-4 relative, each D tensor's gradient and the global
gradient norm as in tests/test_torch_train_g.py
(``torch_train_parity.assert_grads_match``); Adam with lazy-regularization
scaling against optax over three steps within 1e-6 of max(1, |param|);
w_avg and G_ema within 1e-6; the masks exactly."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from next3d_tpu.nn import discriminator as jax_disc
from next3d_tpu.train import loss as jax_loss_module
from next3d_tpu.train import train_step as jax_step
from next3d_tpu.train.loss import LossConfig as JaxLossConfig
from next3d_tpu.train.loss import StyleGAN2Loss as JaxLoss
from next3d_tpu_torch.nn import discriminator
from next3d_tpu_torch.nn.stylegan2 import Generator
from next3d_tpu_torch.train import loss as loss_module
from next3d_tpu_torch.train import train_step
from next3d_tpu_torch.utils.weights import (load_jax_params,
                                            params_to_state_dict,
                                            state_dict_to_params)

from torch_parity import n, one_thread, t  # noqa: F401 (a fixture)
from torch_train_parity import (BATCH, D_KWARGS, LOSS_CFG,
                                assert_grads_match, assert_loss_matches,
                                make_batch, make_discriminators, port_loss,
                                torch_batch)
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)


pytestmark = pytest.mark.usefixtures('one_thread')


@pytest.fixture(scope='module')
def setup():
    jd, pd, D = make_discriminators()
    batch, real = make_batch()
    jax_loss = JaxLoss(None, jd, JaxLossConfig(**LOSS_CFG))
    real_jax = jax.tree_util.tree_map(np.asarray, jax_loss.prepare_real(
        jnp.asarray(real), 0.0, 64))
    return jd, pd, D, batch, real, real_jax


def test_discriminator_forward_matches_jax(setup):
    """D's logits on an image and a raw render, and with freeze_layers the
    same frozen paths, for the other discriminators too."""
    jd, pd, D, batch, real, real_jax = setup
    got = D({k: t(v) for k, v in real_jax.items()}, t(batch['real_c']))
    want = jd(pd, real_jax, jnp.asarray(batch['real_c']))
    assert got.shape == (BATCH, 1)
    err = np.abs(n(got) - np.asarray(want)).max()
    print(f'D logits max-abs {err:.3g}')
    assert err <= 1e-4
    kw = dict(D_KWARGS, block_kwargs=dict(freeze_layers=3))
    assert discriminator.DualDiscriminator(**kw).frozen_paths() == \
        jax_disc.DualDiscriminator(**kw).frozen_paths() == [
            ('b128', 'fromrgb'), ('b128', 'conv0'), ('b128', 'conv1')]
    # the other discriminators (their logits: tests/test_torch_train_variants.py)
    for name, extra in (('DualLabelDualDiscriminator', dict(c2_dim=50)),
                        ('DummyDualDiscriminator', {}),
                        ('SingleDiscriminator', {})):
        assert getattr(discriminator, name)(**kw, **extra).frozen_paths() \
            == getattr(jax_disc, name)(**kw, **extra).frozen_paths(), name


@pytest.mark.parametrize('mode', ['antialiased', 'classic', 'none', 0.3])
@pytest.mark.parametrize('shape,size', [(128, 64), (32, 128)])
def test_filtered_resizing_matches_jax(mode, shape, size):
    """The training path's two resizes: a real image down to the neural
    rendering resolution, a raw render up to D's resolution."""
    x = np.random.RandomState(2).randn(2, 3, shape, shape).astype(np.float32)
    f = discriminator.setup_filter([1, 3, 3, 1])
    want = jax_disc.filtered_resizing(jnp.asarray(x), size, f, mode)
    got = discriminator.filtered_resizing(t(x), size, t(f), mode)
    assert got.shape == (2, 3, size, size)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize('sigma', [10.0, 5.3, 0.2])
def test_gaussian_blur_matches_jax(sigma):
    """The blur of D's input as it fades (JAX loss.py:58-83), with the tap
    count of blur_init_sigma 10."""
    x = np.random.RandomState(5).randn(2, 3, 64, 64).astype(np.float32)
    want = jax_loss_module.gaussian_blur_dynamic(jnp.asarray(x), sigma, 30)
    got = loss_module.gaussian_blur_dynamic(t(x), sigma, 30)
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=1e-6)


def test_prepare_real_matches_jax(setup):
    jd, pd, D, batch, real, real_jax = setup
    got = port_loss(None, D).prepare_real(t(real), 0.0, 64)
    for k in ('image', 'image_raw'):
        np.testing.assert_allclose(n(got[k]), real_jax[k], rtol=0,
                                   atol=1e-5)


def test_dreg_r1_matches_jax(setup):
    """The R1 penalty on image and image_raw by a nested jax.grad, and its
    gradient with respect to D's parameters (JAX loss.py:342-362)."""
    jd, pd, D, batch, real, real_jax = setup
    c = jnp.asarray(batch['real_c'])

    def jax_dreg(p):
        def logit_sum(image, raw):
            return jnp.sum(jd(p, {'image': image, 'image_raw': raw}, c))
        g_img, g_raw = jax.grad(logit_sum, argnums=(0, 1))(
            real_jax['image'], real_jax['image_raw'])
        r1 = jnp.sum(jnp.square(g_img), axis=(1, 2, 3)) + \
            jnp.sum(jnp.square(g_raw), axis=(1, 2, 3))
        return jnp.mean(r1) * (LOSS_CFG['r1_gamma'] / 2), jnp.mean(r1)

    (want_loss, want_r1), want = jax.jit(jax.value_and_grad(
        jax_dreg, has_aux=True))(pd)
    loss_obj = port_loss(None, D)
    sched, _ = loss_obj.schedules(0)
    loss, stats = loss_obj.dreg_loss(
        torch_batch(batch), {k: t(v) for k, v in real_jax.items()},
        torch.Generator().manual_seed(0), sched)
    assert_loss_matches(loss, want_loss, 'Dreg loss')
    assert_loss_matches(stats['Loss/r1_penalty'], want_r1, 'R1 penalty')
    mask = train_step.trainable_mask(D)
    names = [k for k, _ in D.named_parameters()]
    grads = torch.autograd.grad(loss, list(D.parameters()),
                                allow_unused=True)
    grads = {k: g if g is not None else torch.zeros_like(p) for k, g, p in
             zip(names, grads, D.parameters())}
    assert_grads_match(grads, want, mask, 'Dreg')


def test_adam_with_lazy_regularization_matches_optax(setup):
    """make_optimizer's torch Adam against the JAX package's optax.adam,
    both with the lazy-regularization scaling of interval 16, over three
    steps on the same gradients (one of them 0 for a tensor, as for a
    parameter a phase does not reach)."""
    jd, pd, D, batch, real, real_jax = setup
    tx = jax_step.make_optimizer(0.002, 0.0, 0.99, 1e-8, reg_interval=16)
    params = jax.tree_util.tree_map(jnp.asarray, pd)
    state = tx.init(params)
    opt = train_step.make_optimizer(list(D.parameters()), 0.002, 0.0, 0.99,
                                    1e-8, reg_interval=16)
    ratio = 16 / 17
    assert opt.param_groups[0]['lr'] == 0.002 * ratio
    assert opt.param_groups[0]['betas'] == (0.0, 0.99 ** ratio)
    names = [k for k, _ in D.named_parameters()]
    rs = np.random.RandomState(3)
    for step in range(3):
        grads = {k: rs.randn(*p.shape).astype(np.float32)
                 for k, p in D.named_parameters()}
        grads['b4.out.bias'] *= step != 1
        updates, state = tx.update(jax.tree_util.tree_map(
            jnp.asarray, state_dict_to_params(grads)), state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        opt.zero_grad()
        for k, p in zip(names, D.parameters()):
            p.grad = t(grads[k])
        opt.step()
    want = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    # the mapping's weights are O(100) (lr_multiplier 0.01): 1e-6 relative
    err = max((np.abs(n(p) - want[k]) / np.maximum(1, np.abs(want[k]))).max()
              for k, p in D.named_parameters())
    print(f'Adam, 3 steps: max-abs / max(1, |param|) {err:.3g}')
    assert err <= 1e-6
    load_jax_params(D, pd)


def test_w_avg_ema_and_masks_match_jax():
    rs = np.random.RandomState(4)
    backbone = Generator(z_dim=8, c_dim=0, w_dim=8, img_resolution=8,
                         img_channels=3, channel_base=64, channel_max=8)
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(rs.randn(*a.shape), np.float32),
        state_dict_to_params(backbone.state_dict()))
    load_jax_params(backbone, tree)
    w_mean = rs.randn(8).astype(np.float32)
    step = train_step.TrainStep(SimpleNamespace(
        G=SimpleNamespace(backbone=backbone)), None, None)
    step.update_w_avg(t(w_mean))
    want = jax_step.TrainStep._update_w_avg(None, {'backbone': tree}, w_mean)
    np.testing.assert_allclose(n(backbone.mapping.w_avg),
                               want['backbone']['mapping']['w_avg'],
                               rtol=0, atol=1e-6)

    other = Generator(z_dim=8, c_dim=0, w_dim=8, img_resolution=8,
                      img_channels=3, channel_base=64, channel_max=8)
    start = params_to_state_dict(state_dict_to_params(other.state_dict()))
    train_step.TrainStep.ema_update(other, backbone, 0.9)
    want = jax.tree_util.tree_map(
        lambda e, p: p + (e - p) * 0.9, state_dict_to_params(start),
        state_dict_to_params(backbone.state_dict()))
    for k, v in params_to_state_dict(want).items():
        np.testing.assert_allclose(n(other.state_dict()[k]), v, rtol=0,
                                   atol=1e-6)

    kw = dict(D_KWARGS, block_kwargs=dict(freeze_layers=2))
    D = discriminator.DualDiscriminator(**kw)
    jd = jax_disc.DualDiscriminator(**kw)
    for module, frozen in ((backbone, ()), (D, jd.frozen_paths())):
        tree = state_dict_to_params(module.state_dict())
        want = params_to_state_dict(jax_step.trainable_mask(tree, frozen))
        got = train_step.trainable_mask(module, frozen)
        assert got == {k: bool(v) for k, v in want.items()}
    assert not all(got.values()) and any(got.values())
    params = train_step.trainable_parameters(D, D.frozen_paths())
    assert len(params) == sum(got[k] for k, _ in D.named_parameters())
    assert not D.b128.conv0.weight.requires_grad
