"""A run with the timed path broken underneath comes out not correct, with
the cells' own limits; a sound run comes out correct. The harness's look
for a card is skipped: each test drives ``run.run_cell`` on the CPU at a
small size."""

import pytest
import torch

from benchmark import harness, run
from benchmark.calibrate import planted

from conftest import tiny_ctx

SPEC = harness.spec()
CELLS = {w['name']: w for w in SPEC['workloads']}


def _run(cell, fault=None, trace=False):
    ctx = tiny_ctx(cell, trace=trace)
    with planted(harness.kind_module(ctx.mix['kind']), fault):
        return run.run_cell(ctx, SPEC, CELLS[cell], t_start=0.0)[:3]


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_sound_run_is_correct(cell):
    result, checks, _ = _run(cell)
    assert result['correct'], checks
    assert list(result)[-1] == 'checks'
    assert result['attempted'] > 0 and result['failed'] == 0


@pytest.mark.parametrize('cell, fault', [
    ('next3d_ffhq512.synth_b8', 'altered'),
    ('next3d_texture_ffhq512.synth_b8', 'altered'),
    ('next3d_ffhq512.reenact_b1', 'altered'),
    ('next3d_ffhq512.train_b4', 'stale'),
    ('next3d_ffhq512.train_b4', 'half_batch'),
    ('next3d_ffhq512.train_b4', 'skip_d'),
    ('next3d_ffhq512.train_b4', 'stale_ema')])
def test_broken_run_is_not_correct(cell, fault):
    if cell not in CELLS:
        pytest.skip(f'{cell} is not in BENCHMARK.json')
    result, checks, _ = _run(cell, fault)
    assert not result['correct'], checks


def test_traced_run_reports_per_layer_metrics_only():
    result, _, _ = _run('next3d_ffhq512.synth_b8', trace=True)
    e2e = {m['name'] for m in SPEC['end_to_end']}
    assert not e2e & set(result['metrics'])
    assert {'busy_s', 'window_s'} <= set(result['device'])
    assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}
    # on the CPU no device op runs: nothing for the device's readers
    assert 'device_idle_pct.synth' not in result['metrics']
    # nor CUDA events for the spans; the model's operations are counted
    assert 'stage_ms.render.synth' not in result['metrics']
    assert result['metrics']['mfu.synth']['value'] > 0


def test_spans_leave_the_model_as_it_was():
    ctx = tiny_ctx('next3d_ffhq512.synth_b8')
    work = harness.kind_module('synth').Work(ctx)
    G = work.model
    before = (type(G).rasterize, G.renderer, dict(G._forward_hooks))
    spans = harness.Spans(False)
    remove = harness.install_spans(G, ctx.cfg['spans'], spans)
    with torch.no_grad():
        work.unit(0, keep=False)
    remove()
    assert {n for n, _, _ in spans.done} == set(ctx.cfg['spans'])
    assert 'rasterize' not in vars(G)
    assert G.renderer is before[1]
    assert not G.superresolution._forward_hooks
