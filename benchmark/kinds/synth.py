"""Offline synthesis, closed loop, one caller: a batch of new identities
and expressions a unit, each batch mapped (``G.mapping``) and synthesized
(``G.synthesis``), then synchronized, as ``gen-samples`` and the metric
loops run the generator.

The check: once the window has closed, the reference synthesizes again a
sample of the window's batches, drawn from the seed, from the same
inputs, and the widest gap of ``image`` and ``image_raw`` to it, each
over the reference's largest value, and of ``image_depth`` weighted by
the reference's opacity of each ray (``common.opaque_gap``), is compared
with the cell's limit.
"""

from __future__ import annotations

import torch

from .. import harness, models
from ..traffic import Traffic
from .common import (Sample, flops, free, generator_shapes, no_grad_eval,
                     worst_gaps)

OUTPUTS = ('image', 'image_raw', 'image_depth')
E2E = 'synth_img_per_s'


def forward(G, mix, u):
    ws = G.mapping(u['z'], u['c_cond'],
                   truncation_psi=mix.get('truncation_psi', 1),
                   truncation_cutoff=mix.get('truncation_cutoff'))
    out = G.synthesis(ws, u['c'], u['v'],
                      noise_mode=mix.get('noise_mode', 'const'))
    # the outputs, and the reference's opacity image beside them
    return {k: out[k] for k in (*OUTPUTS, 'image_opacity') if k in out}


class Work:
    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.mix
        self.batch = self.mix['batch']
        self.traffic = Traffic(self.mix, ctx.seed, ctx.device)
        self.model = no_grad_eval(models.pair_weights(
            ctx.cfg, 'G_kwargs', ctx.seed, ctx.device, 'G',
            self.traffic.mesh))
        self.sample = Sample(ctx.seed, self.mix.get('check_units', 2))

    def warm_up(self):
        for i in (-1, -2):
            self.unit(i, keep=False)

    def unit(self, i, keep=True):
        u = self.traffic.unit(i)
        with torch.no_grad():
            out = forward(self.model, self.mix, u)
        self.ctx.sync()
        if keep:
            self.sample.offer(i, out)

    def e2e(self, units, window_s, latencies):
        return {E2E: units * self.batch / window_s}

    def shapes(self):
        return generator_shapes(self.ctx.cfg, self.batch)

    def release(self):
        del self.model
        free(self.ctx.device)


def check(ctx, work, record=None):
    """[(name, value, limit)] of the kept batches against the reference;
    with ``record``, also the reference's operations a batch."""
    ref = no_grad_eval(models.reference(ctx.cfg, 'G_kwargs', ctx.seed,
                                        ctx.device, 'G', work.traffic.mesh))
    with torch.no_grad():
        worst = worst_gaps(
            (got, forward(ref, ctx.mix, work.traffic.unit(i)))
            for i, got in sorted(work.sample.kept.items()))
        if record is not None:
            u = work.traffic.unit(min(work.sample.kept))
            record.flops_per_unit = flops(lambda: forward(ref, ctx.mix, u))
    return [(k, v, ctx.limits.get(k)) for k, v in worst.items()]


def control(ctx, work):
    """The reference in the program's place, computed in TF32, against
    the reference in float32, on the same kept batches."""
    ref = no_grad_eval(models.reference(ctx.cfg, 'G_kwargs', ctx.seed,
                                        ctx.device, 'G', work.traffic.mesh))

    def pair(u):
        with harness.tf32(True):
            got = forward(ref, ctx.mix, u)
        with harness.tf32(False):
            return got, forward(ref, ctx.mix, u)
    with torch.no_grad():
        worst = worst_gaps(pair(work.traffic.unit(i))
                           for i in sorted(work.sample.kept))
    return [(k, v, None) for k, v in worst.items()]
