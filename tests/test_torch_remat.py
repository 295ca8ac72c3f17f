"""``remat_synthesis``: G.synthesis recomputed in the backward
(``torch.utils.checkpoint``), as the JAX package's ``jax.checkpoint`` in
next3d_tpu/train/loss.py run_G (:176-192).

Remat changes what is kept between the forward and the backward, never a
value. With random noise and jittered depths drawn from a seeded
generator, Gmain's loss and every gradient are bit-equal with remat on and
off on the CPU, and the caller's generator ends in the same state: the
recompute replays the forward's draws. Against the JAX package, the port
with remat matches JAX's Gmain with its synthesis under ``jax.checkpoint``
by tests/torch_train_parity.py's gates (loss within 1e-4 relative,
``assert_grads_match``)."""

import pytest
import torch

import jax
import jax.numpy as jnp

from next3d_tpu.nn.discriminator import DualDiscriminator as JaxDual
from next3d_tpu_torch.models.triplane_next3d import TriPlaneGenerator
from next3d_tpu_torch.nn.discriminator import DualDiscriminator
from next3d_tpu_torch.train.loss import LossConfig, StyleGAN2Loss
from next3d_tpu_torch.train.train_step import trainable_mask
from next3d_tpu_torch.utils.synthetic_head import synthetic_head

from torch_parity import t, to_jax_tree
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)
from torch_train_parity import (D_KWARGS, LOSS_CFG, G_CFG,
                                assert_grads_match, assert_loss_matches,
                                jax_model, k1_interpret, make_batch,
                                make_generators, torch_batch)


def _grads(loss, module):
    mask = trainable_mask(module)
    named = [(k, p) for k, p in module.named_parameters() if mask[k]]
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    return {k: g if g is not None else torch.zeros_like(p)
            for (k, p), g in zip(named, grads)}, mask


@pytest.fixture(scope='module')
def small_pair():
    """A narrow flagship and D on the synthetic head, one image of the
    parity batch."""
    mesh, _ = synthetic_head()
    G = TriPlaneGenerator(topology_path=mesh,
                          generator=torch.Generator().manual_seed(0),
                          **dict(G_CFG, channel_base=256, channel_max=16))
    D = DualDiscriminator(generator=torch.Generator().manual_seed(1),
                          **D_KWARGS)
    batch, _ = make_batch()
    return G, D, {k: t(v[:1]) for k, v in batch.items()}


def test_remat_replays_the_draws(small_pair, monkeypatch):
    """Gmain with remat on and off, deterministic=False (random noise,
    jittered coarse and importance depths, the conditioning swap at
    probability 0.5), each from a generator seeded alike: the losses and
    every gradient bit-equal, the generators left in the same state, and
    synthesis run twice with remat (the forward and the recompute)."""
    G, D, batch = small_pair
    calls = []
    synthesis = G.synthesis

    def counted(*args, **kwargs):
        calls.append(kwargs['generator'])
        return synthesis(*args, **kwargs)

    monkeypatch.setattr(G, 'synthesis', counted)
    got = {}
    for remat in (False, True):
        loss_obj = StyleGAN2Loss(G, D, LossConfig(
            **dict(LOSS_CFG, gpc_reg_prob=0.5), remat_synthesis=remat))
        sched, nrr = loss_obj.schedules(0)
        generator = torch.Generator().manual_seed(3)
        calls.clear()
        loss, _, _ = loss_obj.gmain_loss(batch, generator, sched, nrr)
        grads, _ = _grads(loss, G)
        got[remat] = loss.detach(), grads, generator.get_state()
        if remat:   # the forward and the recompute, each on its own copy
            assert len(calls) == 2 and generator not in calls
        else:
            assert calls == [generator]
    (loss0, grads0, state0), (loss1, grads1, state1) = got[False], got[True]
    assert torch.equal(loss0, loss1), (float(loss0), float(loss1))
    differ = [k for k in grads0 if not torch.equal(grads0[k], grads1[k])]
    assert not differ, differ
    assert torch.equal(state0, state1)
    # the draws took part: another seed moves the loss
    loss_obj = StyleGAN2Loss(G, D, LossConfig(
        **dict(LOSS_CFG, gpc_reg_prob=0.5), remat_synthesis=True))
    sched, nrr = loss_obj.schedules(0)
    with torch.no_grad():
        other, _, _ = loss_obj.gmain_loss(
            batch, torch.Generator().manual_seed(4), sched, nrr)
    assert not torch.equal(other, loss0)


def test_remat_matches_jax_checkpoint():
    """The port's Gmain with remat (constant noise, midpoint depths)
    against JAX's with ``jax.checkpoint`` around the synthesis, on the same
    weights (D's from the port's seeded init) and the parity batch's first
    image."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_model, 'rasterize_uv_with_alpha', k1_interpret)
        jg, pg, G = make_generators()
        D = DualDiscriminator(generator=torch.Generator().manual_seed(1),
                              **D_KWARGS)
        jd, pd = JaxDual(**D_KWARGS), to_jax_tree(D)
        batch = {k: v[:1] for k, v in make_batch()[0].items()}
        z, c, v = (jnp.asarray(batch[k]) for k in ('gen_z', 'gen_c',
                                                    'gen_v'))

        def gmain(p):
            ws = jg.mapping(p, z, c)
            out = jax.checkpoint(lambda p, ws: jg.synthesis(
                p, ws, c, v, neural_rendering_resolution=64,
                noise_mode='const', rng=None))(p, ws)
            return jnp.mean(jax.nn.softplus(-jd(pd, out, c, rng=None)))

        want_loss, want = jax.jit(jax.value_and_grad(gmain))(pg)
    loss_obj = StyleGAN2Loss(G, D, LossConfig(**LOSS_CFG,
                                              remat_synthesis=True),
                             deterministic=True)
    sched, nrr = loss_obj.schedules(0)
    loss, _, _ = loss_obj.gmain_loss(torch_batch(batch),
                                     torch.Generator().manual_seed(0),
                                     sched, nrr)
    assert_loss_matches(loss, want_loss, 'Gmain loss, remat')
    grads, mask = _grads(loss, G)
    assert_grads_match(grads, want, mask, 'Gmain, remat')
