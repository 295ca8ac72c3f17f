"""On the card: the control, the frozen reference computed in TF32 in the
program's place, comes out not correct by each cell's limits. Serving
cells at their widths and batch 2, with the program beside it coming out
correct; the training cell at its own size, batch 4, on the compared
steps (the control needs no window).

    python -m pytest benchmark/tests/test_bm_control.py -m cuda -q
"""

import pytest

from benchmark import harness

pytestmark = pytest.mark.cuda

CELLS = {w['name']: harness.traffic(w['traffic'])['kind']
         for w in harness.spec()['workloads']}
SERVING = [n for n, kind in CELLS.items() if kind in ('synth', 'reenact')]
TRAINING = [n for n, kind in CELLS.items() if kind == 'train']


def _ctx(cell_name, mix, device):
    cell, _ = harness.workload(cell_name)
    ctx = harness.Ctx(cell, harness.config(cell['config']), mix,
                      2 ** 33 + 17, device, lim=harness.limits(cell_name))
    harness.set_precision(ctx.cfg)
    return ctx


def _fails(control, lim):
    return any(v > lim[n] for n, v, _ in control if n in lim)


@pytest.mark.parametrize('cell_name', SERVING)
def test_control_fails_and_program_passes(cuda, cell_name):
    cell, _ = harness.workload(cell_name)
    mix = dict(harness.traffic(cell['traffic']), check_units=1)
    mix['batch'] = min(mix['batch'], 2)
    ctx = _ctx(cell_name, mix, cuda)
    kind = harness.kind_module(mix['kind'])
    work = kind.Work(ctx)
    work.unit(0)
    work.release()
    program = kind.check(ctx, work)
    assert all(v <= limit for _, v, limit in program), program
    control = kind.control(ctx, work)
    assert _fails(control, ctx.limits), control


@pytest.mark.parametrize('cell_name', TRAINING)
def test_training_control_fails(cuda, cell_name):
    cell, _ = harness.workload(cell_name)
    ctx = _ctx(cell_name, harness.traffic(cell['traffic']), cuda)
    control = harness.kind_module('train').control(ctx)
    assert _fails(control, ctx.limits), control
