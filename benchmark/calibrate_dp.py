"""The readings that a data-parallel training cell's limits are set from.

    python3 -m benchmark.calibrate_dp --workload <cell> --seeds 1,2,3 \
        [--control 1] [--witness 1] [--fault unaveraged] [--seconds 3]

``calibrate.py``'s readings for a cell of ``kinds/train_dp.py``: for each
seed a run of the cell with a short window, whose check against the
data-parallel reference gives the lower readings; for the first
``--control`` seeds the reference in TF32 in the program's place, for the
first ``--witness`` the reference against itself, each replayed on the
same ranks before they stop. ``--fault`` plants a fault on rank 0:
``calibrate.py``'s ``skip_d`` and ``stale_ema``, or ``unaveraged`` (rank
0's gradients, stats and w_mean left as its own rows gave them, though it
takes its part in every all-reduce). ``--workload`` names a cell of
``BENCHMARK.json`` that has a limits file. One JSON line a seed on stdout.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import calibrate, harness, run


def _unaveraged(work):
    """Rank 0 keeps its own gradients, stats and w_mean: it joins every
    all-reduce and then puts its own values back."""
    from next3d_tpu_torch.parallel import dist as pdist
    inner = work.trainer.run

    def run_local(*args, **kwargs):
        mean = pdist.all_reduce_mean

        def local(tensors):
            tensors = list(tensors)
            own = [t.clone() for t in tensors]
            n = mean(tensors)
            for t, o in zip(tensors, own):
                t.copy_(o)
            return n
        pdist.all_reduce_mean = local
        try:
            return inner(*args, **kwargs)
        finally:
            pdist.all_reduce_mean = mean
    work.trainer.run = run_local


FAULTS = {'skip_d': calibrate.FAULTS['skip_d'],
          'stale_ema': calibrate.FAULTS['stale_ema'],
          'unaveraged': _unaveraged}


def run_seed(ctx, bench, cell, kind, fault=None, control=False,
             witness=False):
    """One calibration run of ``ctx``'s cell: its JSON line as a dict."""
    t0 = harness.now()
    Work = kind.Work

    class Kept(Work):
        def __init__(self, ctx):
            super().__init__(ctx)
            self.keep_ranks = True
            if fault:
                FAULTS[fault](self)
    kind.Work = Kept
    try:
        result, checks, _, work = run.run_cell(ctx, bench, cell, t0)
    finally:
        kind.Work = Work
    try:
        line = dict(seed=ctx.seed, fault=fault, correct=result['correct'],
                    program=dict(getattr(work, 'readings', {})))
        if control:
            line['control'] = {k: v for k, v, _ in kind.control(ctx, work)}
            line['control_correct'] = all(
                line['control'][k] <= limit
                for k, limit in ctx.limits.items())
        if witness:
            line['witness'] = {k: v for k, v, _ in kind.witness(ctx, work)}
    finally:
        work.stop()
    line['seconds'] = harness.now() - t0
    return line


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
    mix = harness.traffic(cell['traffic'])
    kind = harness.kind_module(mix['kind'])
    for n, seed in enumerate(int(s) for s in args.seeds.split(',')):
        ctx = harness.Ctx(cell, harness.config(cell['config']), mix, seed,
                          'cuda:0', seconds=args.seconds,
                          lim=harness.limits(cell['name']))
        line = run_seed(ctx, bench, cell, kind, args.fault,
                        n < args.control, n < args.witness)
        line['card'] = harness.card_line()
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 3 if harness.banned_modules() else 0


if __name__ == '__main__':
    sys.exit(main())
