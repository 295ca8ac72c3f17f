"""The training step on several ranks, in plain ``torch.distributed``.

The frozen ``TrainStep`` (``train_step.py``), whose each phase, between
its backward and ``nan_to_num``, replaces every gradient leaf, each of the
phase's stats and ``w_mean`` by its mean over the ranks: one
``all_reduce`` of the sum a tensor, then a division by the number of ranks
(the reference's training_loop.py:352-356 all-reduces the gradients and
divides; JAX's ``pmean`` takes the stats and ``w_mean`` with them, so that
the gradient's norm is the mean gradient's and ``w_avg`` stays equal on
every rank). Each rank trains on its own rows of the batch; the process
group is the default one, which the caller has set up. It imports nothing
of the port.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import train_step as frozen


def mean_over_ranks(tensors):
    """Each of ``tensors`` replaced, in place, by its mean over the
    ranks."""
    world = dist.get_world_size()
    for t in tensors:
        dist.all_reduce(t)
        t.div_(world)


def _adam_step(optimizer, loss, shared):
    """The frozen step's backward, NaN / inf scrubbing and Adam step, the
    gradients and ``shared`` averaged over the ranks after the backward;
    returns the norm of the mean gradient before the scrubbing."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    params = frozen._params(optimizer)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    mean_over_ranks([p.grad for p in params] + list(shared))
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad) for p in params]))
    for p in params:
        torch.nan_to_num_(p.grad)
    optimizer.step()
    return norm


class TrainStep(frozen.TrainStep):
    """The frozen phases with ``_adam_step`` averaged over the ranks."""

    def gmain(self, batch, generator, sched, nrr, timer=None):
        batch, _ = self.loss.flatten_clips(batch)
        with frozen._frozen(frozen._params(self.opt_D)):
            loss, stats, w_mean = self.loss.gmain_loss(batch, generator,
                                                       sched, nrr)
            stats, w_mean = frozen._detached(stats), w_mean.detach()
            stats['Grad/Gmain/norm'] = _adam_step(
                self.opt_G, loss, [*stats.values(), w_mean])
        self.update_w_avg(w_mean)
        return stats

    def greg(self, batch, generator, gain, sched, draws=None, timer=None):
        batch, _ = self.loss.flatten_clips(batch)
        with frozen._frozen(frozen._params(self.opt_D)):
            loss, stats = self.loss.greg_loss(batch, generator, sched, draws)
            stats = frozen._detached(stats)
            stats['Grad/Greg/norm'] = _adam_step(self.opt_G, loss * gain,
                                                 stats.values())
        return stats

    def dmain(self, batch, real_img, generator, sched, nrr, timer=None):
        batch, real_img = self.loss.flatten_clips(batch, real_img)
        real = self.loss.prepare_real(real_img, sched['blur_sigma'], nrr)
        with frozen._frozen(frozen._params(self.opt_G)):
            loss, stats, w_mean = self.loss.dmain_loss(batch, real,
                                                       generator, sched, nrr)
            stats, w_mean = frozen._detached(stats), w_mean.detach()
            stats['Grad/Dmain/norm'] = _adam_step(
                self.opt_D, loss, [*stats.values(), w_mean])
        self.update_w_avg(w_mean)
        return stats

    def dreg(self, batch, real_img, gain, generator, sched, nrr,
             timer=None):
        batch, real_img = self.loss.flatten_clips(batch, real_img)
        real = self.loss.prepare_real(real_img, sched['blur_sigma'], nrr)
        with frozen._frozen(frozen._params(self.opt_G)):
            loss, stats = self.loss.dreg_loss(batch, real, generator, sched)
            stats = frozen._detached(stats)
            stats['Grad/Dreg/norm'] = _adam_step(self.opt_D, loss * gain,
                                                 stats.values())
        return stats
