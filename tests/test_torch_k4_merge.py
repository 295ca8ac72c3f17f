"""K4's backward merge (ops/triplane.py merge_plain, the model of the
kernel's run merge) against the plain backward, on the CPU.

Scattering merge_plain's contributions with index_add_ must give
triplane_sample_backward_plain's result within 1e-5 of its largest
gradient (the merge adds in another order), at the kernel's run length, on
the render's points and on inputs chosen to cut runs at every kind of
edge. The atomic counts are held to what the kernel must issue where the
geometry fixes them. No JAX.
"""

import math

import numpy as np
import pytest
import torch

from next3d_tpu_torch.ops.triplane import (RUN, merge_plain,
                                           triplane_sample_backward_plain)
from next3d_tpu_torch.render.camera_utils import (fov_to_intrinsics,
                                                  lookat_pose)
from next3d_tpu_torch.render.ray_sampler import sample_rays
from next3d_tpu_torch.render.renderer import sample_stratified
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)


def _render_points(n, rays, depth, kind):
    """The FFHQ camera's points: rays x rays rays of ``depth`` samples at
    midpoint depths ('coarse'), jittered from a seeded generator as training
    draws them ('jittered'), or clustered within about 0.02 of a surface
    depth a ray, sorted, as the fine pass's importance draws are
    ('fine_like')."""
    cam = lookat_pose(math.pi / 2, math.pi / 2, [0, 0, 0.2], radius=2.7,
                      batch_size=n, device='cpu')
    K = torch.from_numpy(fov_to_intrinsics(18.837))
    ro, rd = sample_rays(cam, K.expand(n, 3, 3), rays)
    g = torch.Generator().manual_seed(5)
    depths = sample_stratified(g if kind == 'jittered' else None, ro, 2.25,
                               3.3, depth)
    if kind == 'fine_like':
        surface = 2.6 + 0.2 * torch.rand(n, ro.shape[1], 1, 1, generator=g)
        depths = (surface + 0.02 * torch.randn(depths.shape, generator=g)
                  ).sort(2).values
    return (ro[:, :, None] + depths * rd[:, :, None]).reshape(n, -1, 3)


def _scatter(merge, shape):
    index, grad, _, _ = merge
    N, _, H, W, C = shape
    out = torch.zeros(N * 3 * H * W, C)
    out.index_add_(0, index, grad)
    return out.reshape(shape)


def _check(coords, box_warp, H, W, seed=0, run=RUN):
    """Scatter merge_plain's contributions and hold them against the plain
    backward; returns the merge."""
    N, M, _ = coords.shape
    grad_out = torch.from_numpy(np.random.RandomState(seed).randn(
        N, 3, M, 32).astype(np.float32))
    want = triplane_sample_backward_plain(grad_out, coords, box_warp, H, W)
    merge = merge_plain(grad_out, coords, box_warp, H, W, run)
    got = _scatter(merge, want.shape)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= 1e-5 * scale
    _, _, atomics, taps = merge
    assert len(merge[0]) == atomics <= taps
    return merge


def _on_grid(tx, ty, tz, H, W, box_warp=1.0):
    """Points whose unnormalized plane coordinates are (tx, ty, tz) texels
    (x and the 2nd plane axis on W, y on H; z on W for plane 2's first axis
    and on H for plane 1's second: pass H == W where z matters)."""
    x = ((2 * tx + 1) / W - 1) * box_warp / 2
    y = ((2 * ty + 1) / H - 1) * box_warp / 2
    z = ((2 * tz + 1) / W - 1) * box_warp / 2
    return torch.stack([x, y, z], -1).float()


@pytest.mark.parametrize('kind', ['coarse', 'jittered', 'fine_like'])
def test_merge_of_render_points_matches_plain(kind):
    """The coarse, the jittered and fine-pass-like points of a 32x32-ray
    render, 48 samples a ray (runs of 32 cross rays), on 64^2 planes:
    exact, and the merge issues fewer atomics than the taps."""
    coords = _render_points(2, 32, 48, kind)
    _, _, atomics, taps = _check(coords, 1.0, 64, 64)
    assert atomics < taps


def test_merge_of_one_cell():
    """Every point of every ray inside one interior cell, over a count that
    the run length does not divide: a run flushes its 4 taps once a plane,
    12 atomics a run."""
    M = 40 * RUN + 5
    rs = np.random.RandomState(1)
    t = torch.from_numpy(10.2 + 0.6 * rs.rand(1, M, 3))
    coords = _on_grid(t[..., 0], t[..., 1], t[..., 2], 32, 32)
    _, _, atomics, taps = _check(coords, 1.0, 32, 32)
    assert taps == 12 * M
    assert atomics == 12 * math.ceil(M / RUN)


def test_merge_of_distinct_cells_issues_every_tap():
    """Points whose cells share no texel on any plane (a diagonal two
    texels apart): nothing merges, the atomics are the in-range taps."""
    j = torch.arange(120, dtype=torch.float64)
    coords = _on_grid(2 * j + 0.25, 2 * j + 0.5, 2 * j + 0.75, 256,
                      256)[None].repeat(2, 1, 1)
    _, _, atomics, taps = _check(coords, 1.0, 256, 256)
    assert atomics == taps == 2 * 120 * 12


def test_merge_with_runs_of_one_point_issues_every_tap():
    """A run of one point flushes every in-range tap of that point: the
    atomics are the taps, on the render's points."""
    coords = _render_points(1, 16, 48, 'coarse')
    _, _, atomics, taps = _check(coords, 1.0, 64, 64, run=1)
    assert atomics == taps


def test_merge_across_ray_image_and_ragged_ends():
    """Points that stay in one cell for a while (a random walk), 3 images
    of 1000 points, not a multiple of the run length: runs cross images and
    the last run is short."""
    rs = np.random.RandomState(2)
    steps = rs.choice([0.0, 0.0, 0.0, 0.7], size=(3, 1000, 3))
    t = torch.from_numpy(8 + np.cumsum(steps, 1) % 40)
    coords = _on_grid(t[..., 0], t[..., 1], t[..., 2], 64, 64)
    _check(coords, 1.0, 64, 64, seed=3)


def test_merge_does_not_cross_images():
    """The same point everywhere in 3 images of 1000 points: a new flush at
    every run start and every image start, and nowhere else."""
    same = torch.full((3, 1000, 3), 0.1)
    _, _, atomics, _ = _check(same, 1.0, 64, 64, seed=4)
    edges = torch.arange(3000)
    segments = int(((edges % RUN == 0) | (edges % 1000 == 0)).sum())
    assert atomics == 12 * segments


def test_merge_with_points_outside_the_plane():
    """Runs with points far out of the box, points whose cell hangs over
    the plane's edge (some taps in range) and points just outside it."""
    rs = np.random.RandomState(3)
    coords = torch.from_numpy(rs.uniform(-0.3, 0.3, (2, 2000, 3))).float()
    coords[:, 5::9] *= 1e4
    coords[:, 7::11] = torch.from_numpy(
        rs.uniform(0.49, 0.51, (2, len(range(7, 2000, 11)), 3))).float()
    coords[:, 300:420] = coords[:, 300:301]
    coords[:, 600:660] = 7.0
    _check(coords, 1.0, 40, 40)


def test_merge_on_texel_edges():
    """Points exactly on texel edges (wx1 = 0 or wy1 = 0: a tap of weight
    0 still counts as in range) and on the plane's first and last texel
    centres, with box_warp 2."""
    rs = np.random.RandomState(4)
    tx = torch.from_numpy(rs.randint(-1, 33, (1, 3000)).astype(np.float64))
    ty = torch.from_numpy(rs.randint(-1, 33, (1, 3000)).astype(np.float64))
    tz = torch.from_numpy(rs.randint(0, 32, (1, 3000)) + 0.5)
    tx[:, ::3] = tx[:, :1]
    coords = _on_grid(tx, ty, tz, 32, 32, box_warp=2.0)
    _check(coords, 2.0, 32, 32)


@pytest.mark.parametrize('size', [(48, 80), (80, 48)], ids=['wide', 'tall'])
def test_merge_on_planes_that_are_not_square(size):
    """H != W, with the render's jittered points and box_warp 1.2."""
    coords = _render_points(1, 16, 48, 'jittered')
    _check(coords, 1.2, *size)
