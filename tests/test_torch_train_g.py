"""The phases that run the generator, Gmain, Greg and Dmain, against the
JAX package's formulas (next3d_tpu/train/loss.py:237-340) on the same
weights and inputs (tests/torch_train_parity.py says how both sides draw
the same randomness); Dmain takes G's images from Gmain's JAX forward.

Gates: each loss within 1e-4 relative; each trainable tensor's gradient
within max-abs 2e-3 of that tensor's largest gradient plus 1e-3 of its
sub-network's largest (for the noise strengths' cancelling sums); the
global gradient norm within 1e-3 relative. Greg's gradient is the
difference of two gradients that nearly cancel, so its two halves are
held per tensor and the whole by its norm. The JAX side is one jitted
function a phase."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from next3d_tpu.train.loss import LossConfig as JaxLossConfig
from next3d_tpu.train.loss import StyleGAN2Loss as JaxLoss
from next3d_tpu_torch.train.loss import LossConfig, StyleGAN2Loss
from next3d_tpu_torch.train.train_step import trainable_mask

from torch_parity import n, one_thread, t  # noqa: F401 (a fixture)
from torch_train_parity import (LOSS_CFG, assert_grads_match,
                                assert_loss_matches, greg_draws, jax_model,
                                k1_interpret, make_batch,
                                make_discriminators, make_generators,
                                port_loss, torch_batch)
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)


pytestmark = pytest.mark.usefixtures('one_thread')


@pytest.fixture(scope='module')
def setup():
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_model, 'rasterize_uv_with_alpha', k1_interpret)
    jg, pg, G = make_generators()
    jd, pd, D = make_discriminators()
    batch, _ = make_batch()
    yield jg, pg, G, jd, pd, D, batch
    patch.undo()


def _port_grads(loss, module, retain_graph=False):
    mask = trainable_mask(module)
    named = {k: p for k, p in module.named_parameters() if mask[k]}
    grads = torch.autograd.grad(loss, list(named.values()),
                                retain_graph=retain_graph, allow_unused=True)
    return {k: g if g is not None else torch.zeros_like(p)
            for (k, p), g in zip(named.items(), grads)}, mask


@pytest.fixture(scope='module')
def gmain_ref(setup):
    """JAX's Gmain loss, its gradient, w_mean and G's images (for Dmain)."""
    jg, pg, G, jd, pd, D, batch = setup
    z, c, v = (jnp.asarray(batch[k]) for k in ('gen_z', 'gen_c', 'gen_v'))

    def jax_gmain(p):
        ws, w_mean = jg.mapping(p, z, c, return_w_mean=True)
        out = jg.synthesis(p, ws, c, v, neural_rendering_resolution=64,
                           noise_mode='const', rng=None)
        logits = jd(pd, out, c, rng=None)
        images = {k: out[k] for k in ('image', 'image_raw')}
        return jnp.mean(jax.nn.softplus(-logits)), (w_mean, images)

    (loss, (w_mean, images)), grads = jax.jit(jax.value_and_grad(
        jax_gmain, has_aux=True))(pg)
    return loss, w_mean, grads, images


def test_gmain_matches_jax(setup, gmain_ref):
    jg, pg, G, jd, pd, D, batch = setup
    want_loss, want_w_mean, want, _ = gmain_ref
    loss_obj = port_loss(G, D)
    sched, nrr = loss_obj.schedules(0)
    assert sched['swapping_prob'] == 0.0 and nrr == 64
    loss, stats, w_mean = loss_obj.gmain_loss(
        torch_batch(batch), torch.Generator().manual_seed(0), sched, nrr)
    assert_loss_matches(loss, want_loss, 'Gmain loss')
    assert float(stats['Loss/G/loss']) == float(loss.detach())
    np.testing.assert_allclose(n(w_mean), np.asarray(want_w_mean),
                               rtol=1e-5, atol=1e-5)
    grads, mask = _port_grads(loss, G)
    assert_grads_match(grads, want, mask, 'Gmain')


def test_dmain_matches_jax(setup, gmain_ref):
    """softplus(D(G)) + softplus(-D(real)), G's images from each package's
    generator without gradient, real images through prepare_real."""
    jg, pg, G, jd, pd, D, batch = setup
    gen_img = gmain_ref[3]
    _, real = make_batch()
    real_jax = jax.tree_util.tree_map(np.asarray, JaxLoss(
        None, jd, JaxLossConfig(**LOSS_CFG)).prepare_real(
            jnp.asarray(real), 0.0, 64))

    def jax_dmain(p):
        fake = jd(p, gen_img, jnp.asarray(batch['gen_c']))
        real_logits = jd(p, real_jax, jnp.asarray(batch['real_c']))
        return jnp.mean(jax.nn.softplus(fake)) + \
            jnp.mean(jax.nn.softplus(-real_logits))

    want_loss, want = jax.jit(jax.value_and_grad(jax_dmain))(pd)
    loss_obj = port_loss(G, D)
    sched, nrr = loss_obj.schedules(0)
    real_port = loss_obj.prepare_real(t(real), sched['blur_sigma'], nrr)
    loss, stats, _ = loss_obj.dmain_loss(
        torch_batch(batch), real_port, torch.Generator().manual_seed(0),
        sched, nrr)
    assert_loss_matches(loss, want_loss, 'Dmain loss')
    assert float(stats['Loss/D/loss']) == float(loss.detach())
    grads = dict(zip([k for k, _ in D.named_parameters()],
                     torch.autograd.grad(loss, list(D.parameters()))))
    assert_grads_match(grads, want, trainable_mask(D), 'Dmain')


@pytest.fixture(scope='module')
def jax_sigma_pair(setup):
    """One jitted JAX function for every Greg test: sigma at (a, b) with
    directions d (1000 + 1000 points), and the gradients of sum(w *
    sigma(a)) and sum(w * sigma(b)) for w = the L1 term's d loss / d
    sigma(a)."""
    jg, pg, G, jd, pd, D, batch = setup
    z, c, v = (jnp.asarray(batch[k]) for k in ('gen_z', 'gen_c', 'gen_v'))
    reg = LOSS_CFG['density_reg']

    @jax.jit
    def run(p, a, b, d):
        def sigma(p):
            ws = jg.mapping(p, z, c)
            return jg.sample_mixed(p, jnp.concatenate([a, b], axis=1), d, ws,
                                   v, noise_mode='const', rng=None)['sigma']
        s, vjp = jax.vjp(sigma, p)
        half = s.shape[1] // 2
        diff = s[:, :half] - s[:, half:]
        w = jnp.sign(diff) * reg / diff.size
        zero = jnp.zeros_like(w)
        front = vjp(jnp.concatenate([w, zero], axis=1))[0]
        behind = vjp(jnp.concatenate([zero, w], axis=1))[0]
        return s[:, :half], s[:, half:], w, front, behind

    return lambda *points: run(pg, *points)


def test_greg_matches_jax(setup, jax_sigma_pair):
    """reg_type 'l1', the released config: mean |sigma(x) - sigma(x + e)|
    * density_reg at Greg's 1000 points. Its gradient is the difference
    of two gradients, of sum(w * sigma(x)) and of sum(w * sigma(x + e))
    with w = d loss / d sigma(x) = density_reg * sign(sigma(x) -
    sigma(x + e)) / count, which nearly cancel at points 0.004 apart: each
    half is held per tensor, the whole by its norm."""
    jg, pg, G, jd, pd, D, batch = setup
    initial, perturbed, dirs = greg_draws()
    s0, s1, w, want_front, want_behind = jax_sigma_pair(initial, perturbed,
                                                         dirs)
    want_loss = np.mean(np.abs(np.asarray(s0) - np.asarray(s1))) \
        * LOSS_CFG['density_reg']
    loss_obj = port_loss(G, D)
    sched, _ = loss_obj.schedules(0)
    generator = torch.Generator().manual_seed(0)
    loss, stats = loss_obj.greg_loss(
        torch_batch(batch), generator, sched,
        draws=[(t(initial), t(perturbed), t(dirs))])
    assert_loss_matches(loss, want_loss, 'Greg loss')
    grads, mask = _port_grads(loss, G)
    want = jax.tree_util.tree_map(lambda a, b: a - b, want_front, want_behind)
    assert_grads_match(grads, want, mask, 'Greg', per_tensor=False)

    ws = loss_obj._mapped_ws(torch_batch(batch), generator, sched)
    s0, s1 = loss_obj._sigma_pair(ws, t(batch['gen_v']), t(initial),
                                  t(perturbed), generator, t(dirs))
    w = t(np.asarray(w))
    front, _ = _port_grads((w * s0).sum(), G, retain_graph=True)
    behind, _ = _port_grads((w * s1).sum(), G)
    assert_grads_match(front, want_front, mask, 'Greg at x')
    assert_grads_match(behind, want_behind, mask, 'Greg at x + e')


def test_greg_monotonic_matches_jax(setup, jax_sigma_pair):
    """The monotonic reg_types' loss: relu(sigma_front - sigma_behind) at
    points and a point 1/256 behind each, times 10, plus the L1 term at
    1/256 noise, from the same sigma values as JAX's sample_mixed gives
    (JAX :298-321); box_warp 1. Both passes take 1000 points here (JAX
    draws 2000 for the first), so Greg's compiled JAX function serves.
    'monotonic-detach' and 'monotonic-fixed' differ only in the gradient."""
    jg, pg, G, jd, pd, D, batch = setup
    front, _, dirs = greg_draws(seed=12)
    behind = front + np.asarray([0, 0, -1], np.float32) / 256
    second = greg_draws(seed=13, p_dist=1 / 256)
    s_front, s_behind = (np.asarray(x) for x in
                         jax_sigma_pair(front, behind, dirs)[:2])
    s0, s1 = (np.asarray(x) for x in jax_sigma_pair(*second)[:2])
    want = np.mean(np.maximum(s_front - s_behind, 0)) * 10 + \
        np.mean(np.abs(s0 - s1)) * LOSS_CFG['density_reg']
    draws = [(t(front), t(behind), t(dirs)), tuple(t(a) for a in second)]
    for reg_type in ('monotonic-detach', 'monotonic-fixed'):
        loss_obj = StyleGAN2Loss(
            G, D, LossConfig(**LOSS_CFG, reg_type=reg_type),
            deterministic=True)
        sched, _ = loss_obj.schedules(0)
        with torch.no_grad():
            loss, _ = loss_obj.greg_loss(
                torch_batch(batch), torch.Generator().manual_seed(0), sched,
                draws=draws)
        assert_loss_matches(loss, want, f'Greg {reg_type} loss')
