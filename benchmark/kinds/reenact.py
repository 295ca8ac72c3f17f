"""Interactive reenactment, closed loop, one client: the identity built
once in set-up (``G.mapping`` then ``G.build_identity`` of the seed's z),
then a frame a unit, ``G.synthesis_from_identity`` with the unit's
expression and camera, each timed from its call to its synchronized
image, as ``reenact`` and a live avatar drive the generator.

The check: once the window has closed, the reference maps the same z and
synthesizes each frame of a sample drawn from the seed in full (identity
included) from the same inputs; the widest gap of ``image`` and
``image_raw``, over the reference's largest value, and of
``image_depth`` weighted by the reference's opacity of each ray
(``common.opaque_gap``), is compared with the cell's limit.
"""

from __future__ import annotations

import statistics

import torch

from .. import harness, models
from ..traffic import Traffic
from .common import (Sample, flops, free, generator_shapes, no_grad_eval,
                     worst_gaps)
from .synth import OUTPUTS

E2E = 'reenact_frame_p95_ms'


def _ws(G, mix, z, c_cond):
    return G.mapping(z, c_cond, truncation_psi=mix.get('truncation_psi', 1),
                     truncation_cutoff=mix.get('truncation_cutoff'))


class Work:
    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.mix
        self.batch = self.mix['batch']
        self.traffic = Traffic(self.mix, ctx.seed, ctx.device)
        self.model = no_grad_eval(models.pair_weights(
            ctx.cfg, 'G_kwargs', ctx.seed, ctx.device, 'G',
            self.traffic.mesh))
        self.noise_mode = self.mix.get('noise_mode', 'const')
        with torch.no_grad():
            self.ws = _ws(self.model, self.mix, *self.traffic.identity())
            self.identity = self.model.build_identity(
                self.ws, noise_mode=self.noise_mode)
        self.sample = Sample(ctx.seed, self.mix.get('check_units', 8))

    def warm_up(self):
        for i in (-1, -2):
            self.unit(i, keep=False)

    def unit(self, i, keep=True):
        u = self.traffic.unit(i)
        with torch.no_grad():
            out = self.model.synthesis_from_identity(
                self.ws, *self.identity, u['c'], u['v'],
                noise_mode=self.noise_mode)
        self.ctx.sync()
        if keep:
            self.sample.offer(i, {k: out[k] for k in OUTPUTS})

    def e2e(self, units, window_s, latencies):
        ms = [1e3 * t for t in latencies]
        if len(ms) < 2:
            return {E2E: ms[0]}
        return {E2E: statistics.quantiles(ms, n=100, method='inclusive')[94]}

    def shapes(self):
        return generator_shapes(self.ctx.cfg, self.batch)

    def release(self):
        del self.model, self.identity
        free(self.ctx.device)


def check(ctx, work, record=None):
    ref = no_grad_eval(models.reference(ctx.cfg, 'G_kwargs', ctx.seed,
                                        ctx.device, 'G', work.traffic.mesh))

    def pair(i, got):
        u = work.traffic.unit(i)
        return got, ref.synthesis(ws, u['c'], u['v'],
                                  noise_mode=work.noise_mode)
    with torch.no_grad():
        ws = _ws(ref, ctx.mix, *work.traffic.identity())
        identity = ref.build_identity(ws, noise_mode=work.noise_mode)
        worst = worst_gaps(pair(i, got)
                           for i, got in sorted(work.sample.kept.items()))
        if record is not None:
            u = work.traffic.unit(min(work.sample.kept))
            record.flops_per_unit = flops(
                lambda: ref.synthesis_from_identity(
                    ws, *identity, u['c'], u['v'],
                    noise_mode=work.noise_mode))
    return [(k, v, ctx.limits.get(k)) for k, v in worst.items()]


def control(ctx, work):
    """The reference in the program's place, computed in TF32 (the
    identity from the identity's own call, as the program's path runs),
    against the reference in float32 synthesizing each frame in full."""
    ref = no_grad_eval(models.reference(ctx.cfg, 'G_kwargs', ctx.seed,
                                        ctx.device, 'G', work.traffic.mesh))
    z, c_cond = work.traffic.identity()

    def pair(i):
        u = work.traffic.unit(i)
        with harness.tf32(False):
            want = ref.synthesis(ws, u['c'], u['v'],
                                 noise_mode=work.noise_mode)
        with harness.tf32(True):
            got = ref.synthesis_from_identity(
                ws_low, *identity, u['c'], u['v'],
                noise_mode=work.noise_mode)
        return got, want
    with torch.no_grad():
        with harness.tf32(False):
            ws = _ws(ref, ctx.mix, z, c_cond)
        with harness.tf32(True):
            ws_low = _ws(ref, ctx.mix, z, c_cond)
            identity = ref.build_identity(ws_low, noise_mode=work.noise_mode)
        worst = worst_gaps(pair(i) for i in sorted(work.sample.kept))
    return [(k, v, None) for k, v in worst.items()]
