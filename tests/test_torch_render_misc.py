"""The smaller pieces of the port against the JAX package's:
render/camera_utils.py gaussian_pose and uniform_pose (their deterministic
core on the same angles, then the draws), render/mesh.py
generate_triangles and transform_points, render/renderer.py
sample_from_3dgrid (F.grid_sample against JAX's explicit trilinear gather,
points off the grid included), render/fill_mouth.py fill_mouth_exact,
utils/logger.py and utils/profiling.py. Tolerances: bit-equal where both
run the same float32 operations in the same order, else 1e-6 relative
(transcendentals and sums in another order)."""

import json
import math
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from next3d_tpu.render import camera_utils as jcam
from next3d_tpu.render.fill_mouth import fill_mouth_exact as jax_fill_exact
from next3d_tpu.render import mesh as jmesh
from next3d_tpu.render import renderer as jrenderer
from next3d_tpu.utils import logger as jlogger
from next3d_tpu_torch.render import camera_utils as tcam
from next3d_tpu_torch.render.fill_mouth import fill_mouth, fill_mouth_exact
from next3d_tpu_torch.render import mesh as tmesh
from next3d_tpu_torch.render import renderer as trenderer
from next3d_tpu_torch.nn.stylegan2 import MappingNetwork
from next3d_tpu_torch.utils import logger as tlogger
from next3d_tpu_torch.utils import profiling

from torch_parity import n, t, to_jax_tree

TOL = dict(rtol=1e-6, atol=1e-6)


def test_origins_from_angles_match_jax():
    rng = np.random.RandomState(0)
    h = rng.uniform(-1, 4, (64, 1)).astype(np.float32)
    v = rng.uniform(-0.5, 3.7, (64, 1)).astype(np.float32)   # clamped too
    for radius in (1, 2.7):
        np.testing.assert_allclose(
            n(tcam._origins_from_angles(t(h), t(v), radius)),
            n(jcam._origins_from_angles(jnp.asarray(h), jnp.asarray(v),
                                        radius)), **TOL)


@pytest.mark.parametrize('name', ['gaussian_pose', 'uniform_pose'])
def test_poses_without_jitter_match_jax(name):
    want = getattr(jcam, name)(math.pi / 2 + 0.3, math.pi / 2 - 0.2,
                               radius=2.7, batch_size=3)
    got = getattr(tcam, name)(math.pi / 2 + 0.3, math.pi / 2 - 0.2,
                              radius=2.7, batch_size=3, device='cpu')
    assert got.shape == (3, 4, 4)
    np.testing.assert_allclose(n(got), n(want), **TOL)


@pytest.mark.parametrize('name,draw', [('gaussian_pose', 'normal'),
                                       ('uniform_pose', 'uniform')])
def test_jittered_poses(name, draw):
    """The draws come from the torch.Generator: the same seed gives the
    same poses, on the CPU or another device; each pose equals the
    deterministic core at its angles (which JAX's core matches); the
    angles spread as the sampler says: normal with the stddev, or uniform
    within it."""
    fn = getattr(tcam, name)
    kw = dict(radius=2.7, batch_size=4096, horizontal_stddev=0.3,
              vertical_stddev=0.15, device='cpu')
    a = fn(math.pi / 2, math.pi / 2, generator=torch.Generator().manual_seed(
        1), **kw)
    b = fn(math.pi / 2, math.pi / 2, generator=torch.Generator().manual_seed(
        1), **kw)
    assert torch.equal(a, b)
    g = torch.Generator().manual_seed(1)
    shape = (4096, 1)
    if draw == 'normal':
        h = torch.randn(shape, generator=g) * 0.3 + math.pi / 2
        v = torch.randn(shape, generator=g) * 0.15 + math.pi / 2
    else:
        h = (torch.rand(shape, generator=g) * 2 - 1) * 0.3 + math.pi / 2
        v = (torch.rand(shape, generator=g) * 2 - 1) * 0.15 + math.pi / 2
    origins = tcam._origins_from_angles(h, v, 2.7)
    assert torch.equal(a[:, :3, 3], origins)
    np.testing.assert_allclose(
        n(origins), n(jcam._origins_from_angles(
            jnp.asarray(n(h)), jnp.asarray(n(v)), 2.7)), **TOL)
    dh = n(h)[:, 0] - math.pi / 2
    if draw == 'normal':
        assert abs(dh.std() - 0.3) < 0.02 and abs(dh.mean()) < 0.02
    else:
        assert np.abs(dh).max() <= 0.3 and dh.max() > 0.29
    # the camera looks at the origin
    forward = n(a)[:, :3, 2]
    np.testing.assert_allclose(forward, -n(origins) / 2.7, atol=1e-5)


@pytest.mark.parametrize('h,w,mx,my', [(16, 16, 2, 5), (9, 13, 0, 0),
                                       (32, 24, 3, 1)])
def test_generate_triangles_matches_jax(h, w, mx, my):
    got = tmesh.generate_triangles(h, w, mx, my)
    want = jmesh.generate_triangles(h, w, mx, my)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('points_scale,out_scale', [
    (None, None), ((224, 224), None), (None, (256, 192)),
    ((224, 224), (512, 512))])
def test_transform_points_matches_jax(points_scale, out_scale):
    rng = np.random.RandomState(1)
    points = rng.uniform(-1, 1, (2, 68, 3)).astype(np.float32)
    tform = rng.randn(2, 3, 3).astype(np.float32)
    got = tmesh.transform_points(t(points), t(tform), points_scale,
                                 out_scale)
    want = jmesh.transform_points(jnp.asarray(points), jnp.asarray(tform),
                                  points_scale, out_scale)
    assert got.shape == (2, 68, 3)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(n(got)[..., 2], points[..., 2])


@pytest.mark.parametrize('grid_batch', [1, 2])
def test_sample_from_3dgrid_matches_jax(grid_batch):
    """Points inside the grid, on its voxel centres, and off it by up to
    30% (partly outside: the zero padding's share)."""
    rng = np.random.RandomState(2)
    grid = rng.randn(grid_batch, 5, 6, 7, 9).astype(np.float32)
    pts = rng.uniform(-1.3, 1.3, (2, 300, 3)).astype(np.float32)
    centres = ((np.stack(np.meshgrid(np.arange(9), np.arange(7),
                                     np.arange(6), indexing='ij'), -1)
                + 0.5) / np.array([9, 7, 6]) * 2 - 1).reshape(-1, 3)
    pts[:, :150] = centres[::2][:150].astype(np.float32)
    got = trenderer.sample_from_3dgrid(t(grid), t(pts))
    want = jrenderer.sample_from_3dgrid(jnp.asarray(grid), jnp.asarray(pts))
    assert got.shape == (2, 300, 5)
    outside = np.abs(pts).max(-1) > 1
    assert outside.sum() > 50
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)


def _alphas():
    """Face-like alpha masks: a filled disk with a hole (the mouth), a ring
    open to the outside, a pixel value of 254/255 on the edge of fillable,
    and an image whose corner is not fillable."""
    rng = np.random.RandomState(3)
    H = W = 40
    yy, xx = np.mgrid[:H, :W]
    a = np.zeros((4, 1, H, W), np.float32)
    disk = (yy - 20) ** 2 + (xx - 20) ** 2 < 15 ** 2
    hole = (yy - 24) ** 2 + (xx - 20) ** 2 < 4 ** 2
    a[0, 0] = disk & ~hole
    ring = disk & ~((yy - 20) ** 2 + (xx - 20) ** 2 < 10 ** 2)
    a[1, 0] = ring & ~((yy > 18) & (yy < 22) & (xx > 25))
    a[2, 0] = np.where(disk & ~hole, 1.0, rng.choice([0, 254 / 255, 0.5],
                                                     (H, W)))
    a[3, 0] = 1.0
    a[3, 0, 10:20, 10:20] = 0
    return a


@pytest.mark.parametrize('iters', [None, 7, 200])
def test_fill_mouth_exact_matches_jax(iters):
    """The same pixels as JAX's for its default H + W rounds and for fewer
    and more; with enough rounds for the open ring's long path, the same
    as fill_mouth's exact flood."""
    a = _alphas()
    got = n(fill_mouth_exact(t(a), iters))
    want = n(jax_fill_exact(jnp.asarray(a), iters))
    assert got.shape == a.shape
    np.testing.assert_array_equal(got, want)
    if iters == 200:
        np.testing.assert_array_equal(got, n(fill_mouth(t(a))))
        assert got[0, 0, 0, 0] == 0 and got[0, 0, 24, 20] == 1
        assert got[1, 0, 20, 20] == 0             # the open ring's inside
        assert np.all(got[3] == 1)                # no fillable corner


def test_logger_tees_as_jax(tmp_path):
    outs = []
    for mod in (jlogger, tlogger):
        path = tmp_path / f'{mod.__name__}.txt'
        stdout, stderr = sys.stdout, sys.stderr
        log = mod.Logger(str(path))
        try:
            print('tick 1 kimg 0.0')
            sys.stderr.write('warn\n')
            log.write('')
        finally:
            log.close()
        assert sys.stdout is stdout and sys.stderr is stderr
        outs.append(path.read_text())
    assert outs[0] == outs[1] == 'tick 1 kimg 0.0\nwarn\n'


def test_param_counts_match_jax():
    module = MappingNetwork(z_dim=16, c_dim=25, w_dim=32, num_ws=4,
                            num_layers=3)
    tree = to_jax_tree(module)
    assert tlogger.count_params(tree) == jlogger.count_params(tree)
    assert tlogger.count_params(module) == tlogger.count_params(tree) > 0
    assert tlogger.module_summary('G', tree) == \
        jlogger.module_summary('G', tree)
    assert tlogger.module_summary('G', module) == \
        jlogger.module_summary('G', tree)


def test_profiling_phases_scopes_and_trace(tmp_path):
    """The one collector, ``PhaseTimer``, times the phases and parts it
    receives through ``span`` and passes the dotted spans on to a recording
    profiler, whose trace shows them."""
    timer = profiling.PhaseTimer('cpu')
    x = torch.ones(8)
    with profiling.collecting(timer):
        for _ in range(3):
            with profiling.span('Gmain'):
                with profiling.span('Gmain/forward'):
                    x = x * 2
        with profiling.span('Dmain'):
            pass
    report = timer.report()
    assert set(report) == {'Timing/Gmain', 'Timing/Gmain/forward',
                           'Timing/Dmain'}
    assert all(v >= 0 for v in report.values())
    timer.reset()
    assert timer.report() == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.collecting(timer):
            with profiling.span('Gmain'):
                with profiling.span('G.render'):
                    (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert set(timer.report()) == {'Timing/Gmain'}
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())['traceEvents']
    assert {'G.render', 'Gmain'} <= {e.get('name') for e in events}
    assert os.path.getsize(path) > 0