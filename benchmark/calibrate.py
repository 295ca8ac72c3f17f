"""The readings that a cell's limits are set from, on the card.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \
        [--control 3] [--witness 2] [--fault half_batch] [--seconds 3]

For each seed: a run of the cell (``run.run_cell``) with a short window at
its own load, whose check against the reference gives the lower readings:
what sound runs of the program give. For the first ``--control`` seeds
also the control: the reference put in the program's place and computed
in TF32, the nearest precision below the configuration's float32 with TF32
off (the upper readings), judged by the cell's limits. For the first
``--witness`` seeds of a training cell, the reference run twice against
itself. ``--fault`` plants a fault in the program instead (``FAULTS``).
One JSON line a seed on stdout. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from benchmark import harness, run


def _halve(work):
    """A training step on half of its rows, the mean taken over them."""
    trainer = work.trainer
    inner = trainer.run

    def run_half(traffic, i, greg, dreg, timer=None):
        unit = traffic.unit

        def half(j):
            u = unit(j)
            return {k: v[:v.shape[0] // 2] for k, v in u.items()}
        traffic.unit = half
        try:
            return inner(traffic, i, greg, dreg, timer)
        finally:
            traffic.unit = unit
    trainer.run = run_half


def _stale(work):
    """A training step that returns its state unchanged."""
    def run_nothing(traffic, i, greg, dreg, timer=None):
        return {n: torch.zeros(()) for n in ('Loss/G/loss', 'Loss/D/loss')}
    work.trainer.run = run_nothing


def _skip_d(work):
    """D's Adam step skipped: D's state left unchanged, G's stepped."""
    work.trainer.step.opt_D.step = lambda *args, **kwargs: None


def _stale_ema(work):
    """G_ema never updated."""
    work.trainer.step.ema_update = lambda *args, **kwargs: None


def _altered(work):
    """Each produced image moved by 1e-3 of its scale."""
    inner = work.unit

    def unit(i, keep=True):
        inner(i, keep)
        for out in work.sample.kept.values():
            if not out.get('_altered'):
                out['image'] = out['image'] + 1e-3 * out['image'].abs().max()
                out['_altered'] = True
    work.unit = unit


FAULTS = {'half_batch': _halve, 'stale': _stale, 'skip_d': _skip_d,
          'stale_ema': _stale_ema, 'altered': _altered}


@contextlib.contextmanager
def planted(kind, fault):
    """``kind.Work`` with ``fault`` planted in each instance (none with
    ``fault`` None), for as long as the block runs."""
    Work = kind.Work

    class Broken(Work):
        def __init__(self, ctx):
            super().__init__(ctx)
            if fault:
                FAULTS[fault](self)
    kind.Work = Broken
    try:
        yield
    finally:
        kind.Work = Work


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--control', type=int, default=0)
    ap.add_argument('--witness', type=int, default=0)
    ap.add_argument('--fault', choices=sorted(FAULTS))
    ap.add_argument('--seconds', type=float, default=3)
    args = ap.parse_args(argv)
    harness.set_caches()
    bench = harness.spec()
    cell, _ = harness.workload(args.workload, bench)
    cfg = harness.config(cell['config'])
    mix = harness.traffic(cell['traffic'])
    lim = harness.limits(cell['name'])
    kind = harness.kind_module(mix['kind'])
    for n, seed in enumerate(int(s) for s in args.seeds.split(',')):
        t0 = harness.now()
        ctx = harness.Ctx(cell, cfg, mix, seed, 'cuda:0',
                          seconds=args.seconds, lim=lim)
        with planted(kind, args.fault):
            result, checks, _, work = run.run_cell(ctx, bench, cell, t0)
        line = dict(seed=seed, fault=args.fault, correct=result['correct'],
                    program={k: v for k, v, _ in checks})
        line['program'].update(getattr(work, 'readings', {}))
        if n < args.control:
            line['control'] = {k: v for k, v, _ in kind.control(ctx, work)}
            line['control_correct'] = all(
                line['control'][k] <= limit for k, limit in lim.items())
        if n < args.witness:
            line['witness'] = {k: v for k, v, _ in kind.witness(ctx, work)}
        line['seconds'] = harness.now() - t0
        line['card'] = harness.card_line()
        print(json.dumps(line), flush=True)
        del work, ctx
        torch.cuda.empty_cache()
    banned = harness.banned_modules()
    if banned:
        print(f'loaded: {banned}', file=sys.stderr)
        return 3
    return 0


if __name__ == '__main__':
    sys.exit(main())
