"""The port's bench (next3d_tpu_torch/bench.py) against the JAX package's
``bench.py``: its JSON line (the same keys and metric names) for each mode
on the CPU at a small config, its camera and verts helpers against
``__graft_entry__.py``'s, its lazy-regularization cadence against
``bench.py:210``, and ``main()`` without CUDA."""

import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from next3d_tpu_torch import bench
from next3d_tpu_torch.utils.synthetic_head import save_head, synthetic_head

from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)

BENCH_PY = ast.parse((Path(__file__).resolve().parents[1] / 'bench.py')
                     .read_text())
# a 128^2 flagship, 4+4 ray samples, 64^2 planes; the bench's training
# renders at 64^2, as bench.py's LossConfig says
SMALL = dict(img_resolution=128, channel_base=256, channel_max=16,
             plane_resolution=64,
             rendering_kwargs=dict(bench.RENDER_KW_FFHQ, depth_resolution=4,
                                   depth_resolution_importance=4,
                                   superresolution_module=(
                                       'SuperresolutionHybrid2X')))


def _bench_py_record():
    """bench.py's metric names and the keys of its JSON line."""
    names = [node.value.value for node in ast.walk(BENCH_PY)
             if isinstance(node, ast.Assign)
             and getattr(node.targets[0], 'id', None) == 'metric']
    keys = [[k.value for k in node.keys] for node in ast.walk(BENCH_PY)
            if isinstance(node, ast.Dict)
            and any(getattr(k, 'value', None) == 'metric' for k in node.keys)]
    assert len(names) == 3 and len(keys) == 1
    return names, keys[0]


@pytest.mark.parametrize('mode', ['synthesis', 'reenact', 'train'])
def test_bench_prints_bench_py_line(mode, capsys, monkeypatch):
    """One JSON line on stdout with bench.py's keys, its metric name for
    the mode, a finite positive rate and vs_baseline against 15 img/s.
    The small config rasterizes with 'tiled' (NEXT3D_BENCH_RASTER), the
    quickest on the CPU (at its 64^2 planes the generator, as the JAX
    package's does, refuses K3's 'pallas_binned16': a 16-px tile holds more
    faces than that kernel's window); train runs the bf16 generator with
    remat, as the default does."""
    monkeypatch.delenv('NEXT3D_TOPOLOGY', raising=False)
    record = bench.run(mode, batch=1, iters=1, device='cpu',
                       raster='tiled', g_kwargs=SMALL)
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == record
    names, keys = _bench_py_record()
    assert list(record) == keys
    assert record['metric'] in names and mode in record['metric']
    assert record['unit'] == 'img/s'
    assert math.isfinite(record['value']) and record['value'] > 0
    assert record['vs_baseline'] == round(record['value'] / 15.0, 3)
    assert 'kernel launches: {' in out.err
    if mode == 'train':
        assert 'schedule-amortized' in out.err
    if mode == 'synthesis':
        assert 'GFLOP/img' in out.err and 'MFU' not in out.err


def test_helpers_match_graft_entry(tmp_path, monkeypatch):
    """camera_batch and verts_batch equal __graft_entry__'s _camera_batch
    and _verts_batch on the synthetic head written as an OBJ, which
    NEXT3D_TOPOLOGY names for both; unset, the bench takes the synthetic
    head itself, and a missing file raises."""
    obj, _ = save_head(str(tmp_path / 'head.obj'))
    monkeypatch.setenv('NEXT3D_TOPOLOGY', obj)
    monkeypatch.setattr(ge, 'DEMO_OBJ', obj)
    np.testing.assert_array_equal(bench.camera_batch(3), ge._camera_batch(3))
    got = bench.verts_batch(3, *bench.load_topology())
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ge._verts_batch(3))
    monkeypatch.delenv('NEXT3D_TOPOLOGY')
    mesh, lms = bench.load_topology()
    head, head_lms = synthetic_head()
    np.testing.assert_array_equal(mesh.verts, head.verts)
    np.testing.assert_array_equal(lms, head_lms)
    monkeypatch.setenv('NEXT3D_TOPOLOGY', str(tmp_path / 'missing.obj'))
    with pytest.raises(FileNotFoundError, match='missing.obj'):
        bench.load_topology()


def test_cadence_matches_bench_py():
    """amortized_step is bench.py's t_avg (its line 210) on the same step
    times."""
    expr, = [node.value for node in ast.walk(BENCH_PY)
             if isinstance(node, ast.Assign)
             and getattr(node.targets[0], 'id', None) == 't_avg']
    code = compile(ast.Expression(expr), 'bench.py', 'eval')
    for times in ((1.0, 1.5, 3.0), (0.512, 0.731, 1.93), (2.0, 2.0, 2.0)):
        want = eval(code, {}, dict(zip(('t_plain', 't_greg', 't_dreg'),
                                       times)))
        assert bench.amortized_step(*times) == want


def test_main_without_cuda_raises(monkeypatch, capsys):
    """main() measures a CUDA card: without one it raises and prints no
    line."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        bench.main()
    assert capsys.readouterr().out == ''
