"""The training phases on one device.

Counterpart of next3d_tpu/train/train_step.py (reference:
training_avatar_texture/training_loop.py:311-394). Each phase takes its
loss's gradient with respect to the trainable parameters of its network
(G for Gmain and Greg, D for Dmain and Dreg), replaces NaN and infinite
gradients (``nan_to_num``, reference :356) and takes one Adam step; the
regularization phases multiply their loss by their interval (lazy
regularization). The other network's parameters do not require grad during
a phase, so no gradient is spent on them. Each phase reports the norm of
its gradients before the scrubbing as ``Grad/<phase>/norm``.

JAX's Adam (optax) treats a parameter that a phase does not reach (the
super-resolution in Greg, D's last bias in Dreg) as one with a zero
gradient: its moments decay and its step count advances. ``torch.optim.Adam``
skips a parameter whose ``.grad`` is None, so each phase gives such
parameters a zero gradient.

A batch of video clips, (B, T, ...), is flattened into frames at the top
of each phase (``StyleGAN2Loss.flatten_clips``), as in JAX.

Buffers are not trained: ``w_avg`` (the mapping's running mean of w, folded
in after each phase that ran G, beta 0.998), ``noise_const``, and the
parameters ``orth_scale`` / ``orth_shift``, which the reference keeps as
plain tensors (``NON_TRAINABLE_LEAVES``). The discriminator's
``freeze_layers`` leaves its first layers out too (``frozen_paths``).

Under several ranks (``parallel/dist.py``), each phase all-reduces its
gradients to their mean between the backward and ``nan_to_num`` in one
flat bucket, one collective a phase as JAX's one ``pmean`` a phase (JAX
:5-11, :91; reference training_loop.py:352-356). The phase's stats and
``w_mean`` ride the same bucket, as JAX pmeans them with the gradients, so
``Grad/<phase>/norm`` is the norm of the mean gradient and ``w_avg`` stays
bit-equal across the replicas (the reference lets it drift a rank; JAX
does not). Without a process group nothing is reduced: the one-card path.

Spans (``utils/profiling.py``): each phase is the span ``<phase>``, in
three parts, ``<phase>/forward`` (the loss), ``<phase>/backward`` and
``<phase>/update`` (the zero gradients of unreached leaves, the
all-reduce, the norm, the scrubbing and the Adam step), and a fourth in
Gmain and Dmain, ``<phase>/w_avg``; under several ranks the update holds
``<phase>/allreduce``. ``run_phases(timer=)`` installs its timer as the
current collector, so on a sampled batch the train command's
``PhaseTimer`` reports each of them as ``Timing/<name>``.
"""

from __future__ import annotations

import contextlib

import torch

from ..parallel import dist
from ..utils.profiling import collecting, span

NON_TRAINABLE_LEAVES = ('w_avg', 'noise_const', 'orth_scale', 'orth_shift',
                        'magnitude_ema')
W_AVG_BETA = 0.998  # reference networks_stylegan2.py:204


def trainable_mask(module, frozen_paths=()):
    """{state_dict name: trainable}: False for the leaves the reference
    never trains and for every name under a frozen path prefix (JAX
    :45-63)."""
    frozen = [tuple(fp) for fp in frozen_paths]
    mask = {}
    for name in module.state_dict():
        names = tuple(name.split('.'))
        mask[name] = names[-1] not in NON_TRAINABLE_LEAVES and not any(
            names[:len(fp)] == fp for fp in frozen)
    return mask


def trainable_parameters(module, frozen_paths=()):
    """The parameters of ``module`` that ``trainable_mask`` keeps; the
    others get ``requires_grad=False``."""
    mask = trainable_mask(module, frozen_paths)
    params = []
    for name, p in module.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    return params


def make_optimizer(params, lr, beta1, beta2, eps, reg_interval=None):
    """Adam with lazy-regularization scaling: with a regularization interval
    the learning rate and the betas are scaled by interval / (interval + 1)
    (JAX :66-74, reference training_loop.py:252-263)."""
    if reg_interval is not None and reg_interval > 1:
        mb_ratio = reg_interval / (reg_interval + 1)
        lr = lr * mb_ratio
        beta1 = beta1 ** mb_ratio
        beta2 = beta2 ** mb_ratio
    return torch.optim.Adam(params, lr=lr, betas=(beta1, beta2), eps=eps)


def _params(optimizer):
    return [p for group in optimizer.param_groups for p in group['params']]


@contextlib.contextmanager
def _frozen(others):
    """The other network's parameters do not require grad for a phase."""
    for p in others:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in others:
            p.requires_grad_(True)


def _adam_step(optimizer, loss, shared, name):
    """Phase ``name``'s backward, then its update: the mean over the ranks
    of the gradients and of the tensors ``shared`` (the phase's stats and
    w_mean, in place) in one bucket, NaN / inf scrubbing and one Adam step;
    returns the norm of the gradients before the scrubbing (not finite
    where one was not)."""
    with span(f'{name}/backward'):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    with span(f'{name}/update'):
        params = _params(optimizer)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if dist.active():
            with span(f'{name}/allreduce'):
                dist.all_reduce_mean([p.grad for p in params]
                                     + list(shared))
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(p.grad) for p in params]))
        for p in params:
            torch.nan_to_num_(p.grad)
        optimizer.step()
    return norm


def _detached(stats):
    return {k: v.detach() for k, v in stats.items()}


class TrainStep:
    """The four phases, the w_avg and G_ema updates (JAX :95-306), for the
    loss's G and D, with their optimizers (``make_optimizer`` over
    ``trainable_parameters``)."""

    def __init__(self, loss_obj, opt_G, opt_D):
        self.loss = loss_obj
        self.opt_G = opt_G
        self.opt_D = opt_D

    # each phase's ``timer``: a collector installed for the call
    # (``utils.profiling.collecting``); None leaves the current one
    def gmain(self, batch, generator, sched, nrr, timer=None):
        with collecting(timer), _frozen(_params(self.opt_D)):
            with span('Gmain/forward'):
                batch, _ = self.loss.flatten_clips(batch)
                loss, stats, w_mean = self.loss.gmain_loss(batch, generator,
                                                           sched, nrr)
                stats, w_mean = _detached(stats), w_mean.detach()
            stats['Grad/Gmain/norm'] = _adam_step(
                self.opt_G, loss, [*stats.values(), w_mean], 'Gmain')
            with span('Gmain/w_avg'):
                self.update_w_avg(w_mean)
        return stats

    def greg(self, batch, generator, gain, sched, draws=None, timer=None):
        with collecting(timer), _frozen(_params(self.opt_D)):
            with span('Greg/forward'):
                batch, _ = self.loss.flatten_clips(batch)
                loss, stats = self.loss.greg_loss(batch, generator, sched,
                                                  draws)
                stats = _detached(stats)
            stats['Grad/Greg/norm'] = _adam_step(
                self.opt_G, loss * gain, stats.values(), 'Greg')
        return stats

    def dmain(self, batch, real_img, generator, sched, nrr, timer=None):
        with collecting(timer), _frozen(_params(self.opt_G)):
            with span('Dmain/forward'):
                batch, real_img = self.loss.flatten_clips(batch, real_img)
                real = self.loss.prepare_real(real_img, sched['blur_sigma'],
                                              nrr)
                loss, stats, w_mean = self.loss.dmain_loss(
                    batch, real, generator, sched, nrr)
                stats, w_mean = _detached(stats), w_mean.detach()
            stats['Grad/Dmain/norm'] = _adam_step(
                self.opt_D, loss, [*stats.values(), w_mean], 'Dmain')
            # the reference updates G's w_avg in Dmain too (loss.py:264)
            with span('Dmain/w_avg'):
                self.update_w_avg(w_mean)
        return stats

    def dreg(self, batch, real_img, gain, generator, sched, nrr,
             timer=None):
        with collecting(timer), _frozen(_params(self.opt_G)):
            with span('Dreg/forward'):
                batch, real_img = self.loss.flatten_clips(batch, real_img)
                real = self.loss.prepare_real(real_img, sched['blur_sigma'],
                                              nrr)
                loss, stats = self.loss.dreg_loss(batch, real, generator,
                                                  sched)
                stats = _detached(stats)
            stats['Grad/Dreg/norm'] = _adam_step(
                self.opt_D, loss * gain, stats.values(), 'Dreg')
        return stats

    @torch.no_grad()
    def update_w_avg(self, w_mean):
        """w_avg <- w_mean + beta * (w_avg - w_mean) (JAX :242-247)."""
        w_avg = self.loss.G.backbone.mapping.w_avg
        w_avg.copy_(w_mean + W_AVG_BETA * (w_avg - w_mean))

    @staticmethod
    @torch.no_grad()
    def ema_update(G_ema, G, ema_beta):
        """Every parameter and buffer of the state_dict:
        ema <- p + (ema - p) * beta (JAX :249-253)."""
        src = G.state_dict()
        for name, e in G_ema.state_dict().items():
            p = src[name]
            e.copy_(p + (e - p) * ema_beta)

    def run_phases(self, G_ema, batch, real_img, generator, sched, nrr,
                   do_greg, do_dreg, g_reg_interval=4, d_reg_interval=16,
                   ema_beta=0.999, timer=None):
        """One batch's phases in the reference's order, then the EMA
        (JAX :256-306). Returns the phases' stats (tensors). ``timer``: an
        optional collector (``utils.profiling``), installed for the call:
        it receives each phase and part, and the spans beneath them. The
        train command's ``PhaseTimer`` synchronizes the device around each
        phase and part."""
        stats = {}
        with collecting(timer):
            with span('Gmain'):
                stats.update(self.gmain(batch, generator, sched, nrr))
            if do_greg:
                with span('Greg'):
                    stats.update(self.greg(batch, generator,
                                           float(g_reg_interval), sched))
            with span('Dmain'):
                stats.update(self.dmain(batch, real_img, generator, sched,
                                        nrr))
            if do_dreg:
                with span('Dreg'):
                    stats.update(self.dreg(batch, real_img,
                                           float(d_reg_interval), generator,
                                           sched, nrr))
            with span('G_ema'):
                self.ema_update(G_ema, self.loss.G, ema_beta)
        return stats
