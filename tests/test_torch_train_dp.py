"""The benchmark's data-parallel training cell (``benchmark/kinds/
train_dp.py``) as four gloo ranks on the CPU, at a small Next3D
configuration (128² images, 64² planes, 4 + 4 ray samples, 2X
super-resolution, channel_base 1024 / max 32, z of 16), a global batch of
4 (one row a rank). No JAX.

The harness's process is rank 0; it starts ranks 1-3 and drives them. The
program's three compared steps on rank 0 against the data-parallel
reference (``benchmark/reference/train/data_parallel.py``: the frozen step
with a per-leaf all-reduce mean), replayed on the same four ranks:

- sound, every compared number within the cell's limits;
- rank 0's gradients, stats and w_mean never averaged (``calibrate_dp``'s
  ``unaveraged``): caught.

Each takes about 29 s alone on 8 cores (two torch threads a rank). And a
failure in rank 0's part of a step ends the other ranks, which would wait
for it in the step's first all-reduce, before the error goes on.

The kind has no cell in ``BENCHMARK.json`` yet, nor limits of its own
(they are set from its readings on four cards): the cell is named here,
and the one-card training cell's limits stand in for them.
"""

import copy

import pytest
import torch

from benchmark import calibrate_dp, harness
from benchmark.kinds import train_dp

CELL = dict(name='next3d_ffhq512.train_b4_dp4', config='next3d_ffhq512',
            traffic='train_b4_dp4', chips=4)
LIMITS = 'next3d_ffhq512.train_b4'


def _small():
    cfg = copy.deepcopy(harness.config('next3d_ffhq512'))
    rk = dict(cfg['G_kwargs']['rendering_kwargs'], depth_resolution=4,
              depth_resolution_importance=4,
              superresolution_module='SuperresolutionHybrid2X')
    cfg['G_kwargs'].update(z_dim=16, img_resolution=128, plane_resolution=64,
                           channel_base=1024, channel_max=32,
                           rendering_kwargs=rk, sr_num_fp16_res=0)
    cfg['D_kwargs'].update(img_resolution=128, channel_base=1024,
                           channel_max=32)
    mix = copy.deepcopy(harness.traffic('train_b4_dp4'))
    mix.update(z_dim=16, resolution=128, batch=4)
    mix['loss']['neural_rendering_resolution_initial'] = 64
    return cfg, mix


@pytest.fixture
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize('fault', [None, 'unaveraged'])
def test_four_gloo_ranks_against_the_reference(fault, two_threads):
    cfg, mix = _small()
    assert mix['ranks'] == 4
    ctx = harness.Ctx(CELL, cfg, mix, 2 ** 40 + 5, 'cpu',
                      lim=harness.limits(LIMITS))
    work = train_dp.Work(ctx)
    if fault:
        calibrate_dp.FAULTS[fault](work)
    work.warm_up()
    work.release()
    checks = train_dp.check(ctx, work)
    assert [n for n, _, _ in checks] == list(train_dp.COMPARED)
    assert all(p.exitcode == 0 for p in work.procs)
    within = {n: v <= limit for n, v, limit in checks}
    if fault is None:
        assert all(within.values()), checks
    else:
        assert not within['grad_gap_g'] and not within['grad_gap_d'], checks


def test_a_failure_on_rank_0_ends_the_other_ranks(two_threads):
    cfg, mix = _small()
    ctx = harness.Ctx(CELL, cfg, mix, 2 ** 40 + 6, 'cpu',
                      lim=harness.limits(LIMITS))
    work = train_dp.Work(ctx)

    def fail(*args, **kwargs):
        raise RuntimeError('planted')
    work.trainer.run = fail
    try:
        with pytest.raises(RuntimeError, match='planted'):
            work.unit(1)
        # the other ranks, told to take the step, would wait in its first
        # all-reduce for rank 0: they are ended instead
        assert all(p.exitcode is not None for p in work.procs)
    finally:
        train_dp.pdist.teardown()
