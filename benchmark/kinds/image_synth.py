"""Image synthesis, closed loop, one caller: a unit is a batch of new z
(standard normal, from the seed), no label, mapped (``G.mapping(z, None,
truncation_psi)``) and synthesized (``G.synthesis(ws)``), then
synchronized, as StyleGAN3's metric loop and offline sampling call a
generator.

Under the spans' stretch of a traced run the harness's ``Spans`` is the
program's collector (``utils/profiling.py collecting``), so that the
program's own spans (``SG3.*``) are timed by CUDA events.

The check: once the window has closed, the reference synthesizes again a
sample of the window's batches, drawn from the seed, from the same z, and
the widest gap of the image to it over the reference's largest value
(``image_gap``) is compared with the cell's limit.

The operations a unit (``mfu.*``) are the reference's, counted by
``torch.utils.flop_counter``'s table, except its FIR filters: the
reference runs them as depthwise convolutions of the zero-inserted map
that keep every down-th output, which the table counts whole (three
quarters of the count at 1024²), so they count instead as the multiply-adds
of the taps that land on real samples of each kept output
(``roofline_sg3.fir_ops``).
"""

from __future__ import annotations

import torch
from next3d_tpu_torch.utils.profiling import collecting

from .. import harness, models
from ..roofline_sg3 import fir_ops, fir_passes
from ..traffic import generator
from .common import Sample, free, gap, no_grad_eval

E2E = 'synth_img_per_s'


def forward(G, mix, z):
    ws = G.mapping(z, None, truncation_psi=mix.get('truncation_psi', 1))
    return G.synthesis(ws)


def unit_z(ctx, i):
    """Unit i's z, (batch, z_dim), on the device."""
    g = generator(ctx.seed, 'unit', i, device=ctx.device)
    return torch.randn((ctx.mix['batch'], ctx.mix.get('z_dim', 512)),
                       generator=g, device=ctx.device)


# keys of a tri-plane generator that the benchmark's CPU tests set in
# every configuration they cut (``benchmark/tests/conftest.py tiny``): no
# StyleGAN3 generator takes them
TRIPLANE_ONLY = ('rendering_kwargs', 'plane_resolution', 'sr_num_fp16_res')


def _cfg(cfg):
    """``cfg`` with the generator's arguments of ``TRIPLANE_ONLY`` left
    out."""
    kw = {k: v for k, v in cfg['G_kwargs'].items() if k not in TRIPLANE_ONLY}
    return dict(cfg, G_kwargs=kw)


def _reference(ctx):
    return no_grad_eval(models.reference(_cfg(ctx.cfg), 'G_kwargs',
                                         ctx.seed, ctx.device, 'G'))


class Work:
    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.mix
        self.batch = self.mix['batch']
        ref = _reference(ctx)
        self.passes = fir_passes(ref.synthesis, self.batch)
        self.model = no_grad_eval(models.program(
            _cfg(ctx.cfg), 'G_kwargs', ref.state_dict(), ctx.device))
        del ref
        free(ctx.device)
        self.sample = Sample(ctx.seed, self.mix.get('check_units', 2))
        self.spans = None

    def warm_up(self):
        for i in (-1, -2):
            self.unit(i, keep=False)

    def unit(self, i, keep=True):
        z = unit_z(self.ctx, i)
        with torch.no_grad(), collecting(self.spans):
            out = forward(self.model, self.mix, z)
        self.ctx.sync()
        if keep:
            self.sample.offer(i, out)

    def e2e(self, units, window_s, latencies):
        return {E2E: units * self.batch / window_s}

    def shapes(self):
        return dict(fir_any=self.passes)

    def release(self):
        del self.model
        free(self.ctx.device)


class _Ops:
    """The reference's operations by ``torch.utils.flop_counter``'s table,
    its depthwise convolutions (the FIR route) left out."""

    def __init__(self):
        self.total = 0

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                count = flop_registry.get(func._overloadpacket)
                if count is not None and not _depthwise(func, args):
                    counter.total += count(*args, **kwargs, out_val=out)
                return out
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def _depthwise(func, args):
    """Whether ``func(*args)`` is a convolution of one input channel a
    group over every channel: the reference's FIR pass."""
    if 'convolution' not in func._overloadpacket.__name__:
        return False
    x, w, groups = args[0], args[1], args[-1]
    return w.shape[1] == 1 and groups == x.shape[1]


def check(ctx, work, record=None):
    """[(name, value, limit)] of the kept batches against the reference;
    with ``record``, also the operations a batch."""
    ref = _reference(ctx)
    worst = 0.0
    with torch.no_grad():
        for i, got in sorted(work.sample.kept.items()):
            worst = max(worst, gap(got, forward(ref, ctx.mix,
                                                unit_z(ctx, i))))
        if record is not None:
            z = unit_z(ctx, min(work.sample.kept))
            with _Ops() as ops:
                forward(ref, ctx.mix, z)
            record.flops_per_unit = ops.total + fir_ops(work.passes)
    return [('image_gap', worst, ctx.limits.get('image_gap'))]


def control(ctx, work):
    """The reference in the program's place, computed in TF32, against
    the reference in float32, on the same kept batches."""
    ref = _reference(ctx)
    worst = 0.0
    with torch.no_grad():
        for i in sorted(work.sample.kept):
            z = unit_z(ctx, i)
            with harness.tf32(True):
                got = forward(ref, ctx.mix, z)
            with harness.tf32(False):
                worst = max(worst, gap(got, forward(ref, ctx.mix, z)))
    return [('image_gap', worst, None)]
