"""K4's binned bf16 backward: its model (ops/triplane.py bin_plain, the
binning and resolve of csrc/triplane_backward_binned.cu in plain torch, and
assemble_plain, its merge) against the plain backward, on the CPU.

On every point set, each in-range (point, plane, tap), taken independently
from the kernel's float32 positions, is added exactly once, by a chunk of
the tile that holds its texel; a tile's count is the number of points with
an in-range tap in it, and its chunks hold at most ``cap`` entries each.
The assembled sums equal triplane_sample_backward_plain's within 1e-12 of
the largest gradient in float64 (the same taps and weights, added in
another order) and within 1e-5 in float32, and rounded to bf16 they lie
within one bf16 ulp of the plain version's cast. The model's gradient also
equals jax.grad of the JAX package's sampling.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from next3d_tpu.render.renderer import sample_from_planes as jax_sample
from next3d_tpu_torch.ops import triplane
from next3d_tpu_torch.ops.triplane import (CAP, TILE, assemble_plain,
                                           bin_counts, bin_plain,
                                           kernel_positions, work_bounds,
                                           tile_grid,
                                           triplane_sample_backward_plain)
from test_torch_k4_merge import _on_grid, _render_points
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)

# one bf16 ulp relative to a value's magnitude (at most)
BF16_ULP = 2.0 ** -7


def _one_texel(n, m, seed):
    """Every point of every image inside one interior texel of each plane
    (the one-texel pile-up that only split tiles carry)."""
    rs = np.random.RandomState(seed)
    t = torch.from_numpy(20.1 + 0.8 * rs.rand(n, m, 3))
    return _on_grid(t[..., 0], t[..., 1], t[..., 2], 64, 64)


def _outside(seed):
    """Points far out of the box, points whose cell hangs over the plane's
    edge (some taps in range) and points just outside it."""
    rs = np.random.RandomState(seed)
    coords = torch.from_numpy(rs.uniform(-0.3, 0.3, (2, 3000, 3))).float()
    coords[:, 5::9] *= 1e4
    edge = rs.uniform(0.49, 0.51, (2, len(range(7, 3000, 11)), 3))
    coords[:, 7::11] = torch.from_numpy(edge).float()
    coords[:, 600:660] = -7.0
    return coords


def _edges(seed):
    """Points exactly on texel edges (a tap of weight 0 still counts as in
    range) on and around the tile edges: cells whose taps straddle 2 tiles
    on one axis or 4 tiles at a corner, and the plane's first and last
    texels, with box_warp 2."""
    rs = np.random.RandomState(seed)
    near = np.concatenate([np.arange(-1, 3), np.arange(14, 18),
                           np.arange(30, 34), np.arange(61, 65)])
    tx, ty, tz = (torch.from_numpy(rs.choice(near, (1, 4000)) + 0.0)
                  for _ in range(3))
    tz[:, ::2] += 0.5
    return _on_grid(tx, ty, tz, 64, 64, box_warp=2.0)


# name: (coordinates, box_warp, H, W, cap)
CASES = {
    'coarse': lambda: (_render_points(2, 32, 48, 'coarse'), 1.0, 64, 64,
                       CAP),
    'jittered': lambda: (_render_points(2, 32, 48, 'jittered'), 1.0, 64, 64,
                         CAP),
    'fine_like': lambda: (_render_points(2, 32, 48, 'fine_like'), 1.0, 64,
                          64, CAP),
    # the render's tiles split into chunks of 300: every split path and
    # many ragged last chunks
    'coarse_small_cap': lambda: (_render_points(2, 32, 48, 'coarse'), 1.0,
                                 64, 64, 300),
    # a count the cap does not divide: ragged last chunks
    'one_texel': lambda: (_one_texel(2, 4099, 1), 1.0, 64, 64, 1000),
    'one_texel_kernel_cap': lambda: (_one_texel(1, 2 * CAP + 5, 2), 1.0, 64,
                                     64, CAP),
    'outside': lambda: (_outside(3), 1.0, 40, 40, 500),
    'edges': lambda: (_edges(4), 2.0, 64, 64, 700),
    'wide': lambda: (_render_points(1, 16, 48, 'jittered'), 1.2, 40, 80,
                     CAP),
    'tall': lambda: (_render_points(1, 16, 48, 'jittered'), 1.2, 80, 40,
                     CAP),
}


def _grad_out(coords, seed=0):
    N, M, _ = coords.shape
    return torch.from_numpy(np.random.RandomState(seed).randn(
        N, 3, M, 32).astype(np.float32))


def _in_range_taps(coords, box_warp, H, W):
    """From the kernel's float32 positions, independently of the model:
    each in-range (image, plane, point, tap)'s id ((image * 3 + plane) * M
    + point) * 4 + tap, its texel's x and y, all sorted by id."""
    ix, iy = kernel_positions(coords, box_warp, H, W)   # (N, 3, M)
    x0, y0 = ix.floor().long(), iy.floor().long()
    xs = torch.stack([x0, x0 + 1, x0, x0 + 1], -1)
    ys = torch.stack([y0, y0, y0 + 1, y0 + 1], -1)
    inside = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    ids = torch.arange(inside.numel()).reshape(inside.shape)
    return ids[inside], xs[inside], ys[inside]


@pytest.mark.parametrize('case', list(CASES))
def test_binning_adds_every_tap_once_and_matches_plain(case):
    coords, box_warp, H, W, cap = CASES[case]()
    N, M, _ = coords.shape
    grad_out = _grad_out(coords)
    binned = bin_plain(grad_out, coords, box_warp, H, W, cap=cap)
    TY, TX = tile_grid(H, W)

    # every in-range tap once, in a chunk of its texel's tile
    ids, xs, ys = _in_range_taps(coords, box_warp, H, W)
    order = torch.argsort(binned['tap'])
    assert torch.equal(binned['tap'][order], ids)
    image = ids // (4 * M)
    chunk = binned['tap_chunk'][order]
    assert torch.equal(binned['tile'][chunk],
                       (image * TY + ys // TILE) * TX + xs // TILE)
    assert torch.equal(binned['tap_texel'][order],
                       ys % TILE * TILE + xs % TILE)

    # a tile's entries: the points with an in-range tap in it, in chunks of
    # at most cap, an empty tile one empty chunk
    tile_of_tap = binned['tile'][chunk]
    point_of_tap = ids // 4 % M + image // 3 * M
    pairs = torch.unique(tile_of_tap * (N * M) + point_of_tap)
    counts = torch.bincount(pairs // (N * M), minlength=N * 3 * TY * TX)
    assert torch.equal(binned['counts'], counts)
    assert torch.equal(bin_counts(coords, box_warp, H, W), counts)
    sizes = binned['first'][1:] - binned['first'][:-1]
    assert int(sizes.max()) <= cap
    per_tile = torch.zeros_like(counts).index_add_(0, binned['tile'], sizes)
    assert torch.equal(per_tile, counts)
    chunks = torch.bincount(binned['tile'], minlength=len(counts))
    assert torch.equal(chunks, torch.clamp(-(-counts // cap), min=1))
    items, slots = work_bounds(N, M, H, W, cap=cap)
    assert len(binned['tile']) <= items and int((counts > cap).sum()) <= slots
    # the entries of each chunk are its tile's, in point order
    entry_tile = torch.repeat_interleave(binned['tile'], sizes)
    keys = entry_tile * (N * M) + binned['point']
    assert torch.equal(keys, pairs)

    # the sums: in float64 the same taps and weights as the plain version,
    # added in another order; in float32 within 1e-5 of the largest (the
    # kernel's bound; the plain version's own float32 sums stray by up to
    # 2.4e-6 of it on the one-texel pile-up); rounded to bf16 within one
    # ulp of the plain version's cast
    want = triplane_sample_backward_plain(grad_out.double(), coords,
                                          box_warp, H, W)
    got = assemble_plain(bin_plain(grad_out.double(), coords, box_warp, H,
                                   W, cap=cap), N, H, W)
    scale = float(want.abs().max())
    assert scale > 0 and got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-12 * scale
    got32 = assemble_plain(binned, N, H, W)
    assert got32.dtype == torch.float32
    assert float((got32 - want).abs().max()) <= 1e-5 * scale
    want16 = triplane_sample_backward_plain(grad_out, coords, box_warp, H,
                                            W).to(torch.bfloat16).float()
    got16 = got32.to(torch.bfloat16).float()
    assert bool(((got16 - want16).abs()
                 <= BF16_ULP * want16.abs() + 1e-6 * scale).all())


def test_binned_gradient_matches_jax(rng):
    """The model's assembled gradient of the planes against jax.grad of
    the JAX package's sample_from_planes (float32 planes), within 1e-5 of
    the largest gradient."""
    coords = _render_points(2, 16, 24, 'jittered')
    N, M, _ = coords.shape
    grad_out = _grad_out(coords, seed=1)
    planes = rng.randn(N, 3, 32, 48, 48).astype(np.float32)

    def loss(p):
        return jnp.sum(jax_sample(p, jnp.asarray(coords.numpy()), 1.0)
                       * jnp.asarray(grad_out.numpy()))

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(planes)))
    got = assemble_plain(bin_plain(grad_out, coords, 1.0, 48, 48, cap=500),
                         N, 48, 48).permute(0, 1, 4, 2, 3).numpy()
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_bf16_autograd_on_cpu_is_the_plain_gradient_cast(rng):
    """bf16 planes that require grad on the CPU: the gradient is the plain
    float32 gradient of the planes upcast, cast to bf16 once, and neither
    backward kernel counts a launch."""
    planes = torch.from_numpy(rng.randn(2, 3, 40, 24, 32).astype(
        np.float32)).to(torch.bfloat16)
    coords = _render_points(2, 8, 24, 'jittered')
    grad_out = _grad_out(coords, seed=2)
    before = (triplane.triplane_sample_backward.launches,
              triplane.triplane_sample_backward_bf16.launches)
    p16 = planes.clone().requires_grad_()
    p32 = planes.float().requires_grad_()
    with torch.enable_grad():
        triplane.triplane_sample(p16, coords, 1.0).backward(grad_out)
        triplane.triplane_sample(p32, coords, 1.0).backward(grad_out)
    assert p16.grad.dtype == torch.bfloat16
    assert torch.equal(p16.grad, p32.grad.to(torch.bfloat16))
    assert torch.equal(
        triplane.triplane_sample_backward_bf16(grad_out, coords, 1.0, 40,
                                               24),
        triplane_sample_backward_plain(grad_out, coords, 1.0, 40, 24).to(
            torch.bfloat16))
    assert (triplane.triplane_sample_backward.launches,
            triplane.triplane_sample_backward_bf16.launches) == before
