"""Tri-plane sampling + the EG3D two-pass importance volume renderer.

Counterpart of next3d_tpu/render/renderer.py (reference:
training_avatar_texture/volumetric_rendering/renderer.py). The decoder is
an ``nn.Module`` mapping (sampled_features, directions) to
{'rgb', 'sigma'}. Stochastic sampling draws from an optional
``torch.Generator``; ``generator=None`` gives the deterministic midpoint
path that the JAX package takes with ``rng=None``.

Tri-plane sampling is kernel K4 (``ops/triplane.py``, which also holds
``generate_planes`` and ``project_onto_planes``): the planes are laid out
channels-last once per forward and both passes sample them. With the
``gather_bf16`` option the layout pass stores float32 planes in bf16 (JAX
:50-65, 261); the samples come back float32.

The ``fused_plane_sampling`` option routes the JAX package's sampling to
``sample_from_planes_fused`` (JAX :245-257), its only route into its TPU
kernel ``triplane_sample_tiles``, with ``fused_precision`` the dot
precision of the TPU's matrix unit ('bf16' or 'highest';
``fused_tile_samples`` and ``fused_interpret`` are the kernel's tiling and
its CPU mode). Off the TPU both precisions compute the float32 bilinear
sample, and that path samples the planes as they are, without
``gather_bf16``'s cast. The port samples through K4 on every path, so the
option selects the same function here: the float32 sample of the planes
as they are. It refuses what the JAX path refuses (``check_fused_options``).

Spans (``utils/profiling.py``): a render's parts ``G.render.coarse`` (the
planes' layout, the ray limits, the stratified depths and the coarse
pass), ``G.render.importance`` (the coarse weights and the importance
draw), ``G.render.fine`` and ``G.render.composite`` (the merge and the
final march).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.triplane import channels_last, triplane_sample
from ..utils.profiling import span
from . import math_utils
from .ray_marcher import mip_ray_marcher2


def layout_planes(planes, gather_bf16=False):
    """planes (N, 3, C, H, W) as K4 reads them: channels-last, float32
    planes stored in bf16 with ``gather_bf16``."""
    bf16 = gather_bf16 and planes.dtype == torch.float32
    return channels_last(planes, torch.bfloat16 if bf16 else None)


def sample_from_planes(plane_features, coordinates, box_warp,
                       gather_bf16=False):
    """(N, 3, C, H, W), (N, M, 3) -> (N, 3, M, C) float32 (reference
    :62-72)."""
    return triplane_sample(layout_planes(plane_features, gather_bf16),
                           coordinates, box_warp)


FUSED_PRECISIONS = ('bf16', 'highest')


def sample_from_3dgrid(grid, coordinates):
    """Trilinear samples of a dense voxel grid (reference renderer.py
    :74-87; JAX :78-111). grid (1 or N, C, D, H, W); coordinates (N, M, 3)
    in [-1, 1], x along W, y along H, z along D. Returns (N, M, C), zero
    outside the grid (``F.grid_sample``, align_corners=False, zeros
    padding)."""
    N, M, _ = coordinates.shape
    grid = grid.expand(N, *grid.shape[1:])
    out = F.grid_sample(grid, coordinates.reshape(N, 1, 1, M, 3),
                        mode='bilinear', padding_mode='zeros',
                        align_corners=False)           # (N, C, 1, 1, M)
    return out.reshape(N, grid.shape[1], M).transpose(1, 2)


def check_fused_options(planes, options):
    """Raise ``ValueError`` for the ``fused_*`` options and planes
    (N, 3, C, H, W) that JAX's fused path refuses: planes that are not
    square (JAX ops/pallas_triplane.py:252), a precision other than 'bf16'
    and 'highest' (:200-202), a plane row of W * C values that is not a
    multiple of 128 lanes (:205-214), a tile that is not a positive number
    of samples (:195-196)."""
    _, _, C, H, W = planes.shape
    if H != W:
        raise ValueError(f'fused_plane_sampling needs square planes, got '
                         f'{H}x{W}')
    precision = options.get('fused_precision', 'bf16')
    if precision not in FUSED_PRECISIONS:
        raise ValueError(f'fused_precision {precision!r} is not one of '
                         f'{FUSED_PRECISIONS}')
    if (W * C) % 128:
        raise ValueError(f'fused_plane_sampling needs W * C a multiple of '
                         f'128, got {W} * {C}')
    tile = options.get('fused_tile_samples', 1024)
    if not (isinstance(tile, int) and tile > 0):
        raise ValueError(f'fused_tile_samples {tile!r} is not a positive '
                         f'number of samples')


def layout_for(planes, options):
    """planes (N, 3, C, H, W) laid out for K4 as the rendering ``options``
    ask: stored in bf16 under ``gather_bf16``, except under
    ``fused_plane_sampling``, whose options are checked."""
    fused = options.get('fused_plane_sampling', False)
    if fused:
        check_fused_options(planes, options)
    return layout_planes(planes,
                         options.get('gather_bf16', False) and not fused)


def _uniform(generator, shape, device):
    """U(0, 1) jitter; no generator gives the deterministic midpoint 0.5."""
    if generator is None:
        return torch.full(shape, 0.5, device=device)
    return torch.rand(shape, generator=generator, device=device)


def sample_stratified(generator, ray_origins, ray_start, ray_end,
                      depth_resolution, disparity_space_sampling=False):
    """Jittered uniform depths (N, M, S, 1) (reference :184-207);
    ray_start/ray_end are floats or (N, M, 1) tensors."""
    N, M, _ = ray_origins.shape
    dev = ray_origins.device
    shape = (N, M, depth_resolution, 1)
    if disparity_space_sampling:
        base = torch.linspace(0, 1, depth_resolution, device=dev)
        delta = 1 / (depth_resolution - 1)
        d = base.reshape(1, 1, -1, 1) + _uniform(generator, shape, dev) \
            * delta
        return 1. / (1. / ray_start * (1. - d) + 1. / ray_end * d)
    if isinstance(ray_start, (int, float)):
        base = torch.linspace(ray_start, ray_end, depth_resolution,
                              device=dev).reshape(1, 1, -1, 1).expand(shape)
        delta = (ray_end - ray_start) / (depth_resolution - 1)
        return base + _uniform(generator, shape, dev) * delta
    base = math_utils.linspace_batch(ray_start, ray_end, depth_resolution)
    base = base.permute(1, 2, 0, 3)                       # (N, M, S, 1)
    delta = (ray_end - ray_start) / (depth_resolution - 1)
    return base + _uniform(generator, shape, dev) * delta[..., None, :]


def sample_pdf(generator, bins, weights, N_importance, eps=1e-5):
    """Inverse-CDF sampling (reference :229-268).

    bins: (R, B+1) non-decreasing; weights: (R, B) -> (R, N_importance).
    """
    R, B = weights.shape
    weights = weights + eps
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # (R, B+1)
    if generator is None:
        u = torch.linspace(0, 1, N_importance,
                           device=cdf.device).expand(R, N_importance)
    else:
        u = torch.rand((R, N_importance), generator=generator,
                       device=cdf.device)
    u = u.contiguous()
    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=B)
    idx = torch.stack([below, above], dim=-1).reshape(R, 2 * N_importance)
    cdf_g = cdf.gather(1, idx).reshape(R, N_importance, 2)
    bins_g = bins.gather(1, idx).reshape(R, N_importance, 2)
    denom = cdf_g[..., 1] - cdf_g[..., 0]
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_g[..., 0] + (u - cdf_g[..., 0]) / denom \
        * (bins_g[..., 1] - bins_g[..., 0])


def _smooth_weights(weights):
    """max_pool1d(2, 1, pad=1) then avg_pool1d(2, 1), + 0.01
    (reference :220-222); (R, L) -> (R, L)."""
    padded = F.pad(weights, (1, 1), value=-float('inf'))
    mx = torch.maximum(padded[:, :-1], padded[:, 1:])        # (R, L+1)
    return (mx[:, :-1] + mx[:, 1:]) / 2 + 0.01


def sample_importance(generator, z_vals, weights, N_importance):
    """Importance depths from smoothed coarse weights (reference :209-227).
    No gradient flows through the draw: the depths and weights are detached
    as in the JAX package (renderer.py:211-212), so the fine-pass points
    depend on no parameter."""
    N, R, S, _ = z_vals.shape
    z = z_vals.detach().reshape(N * R, S)
    w = _smooth_weights(weights.detach().reshape(N * R, -1))
    z_mid = 0.5 * (z[:, :-1] + z[:, 1:])
    samples = sample_pdf(generator, z_mid, w[:, 1:-1], N_importance)
    return samples.reshape(N, R, N_importance, 1)


def unify_samples(depths1, colors1, densities1, depths2, colors2, densities2):
    """Concatenate and stable-sort by depth (reference :164-182)."""
    all_depths = torch.cat([depths1, depths2], dim=-2)
    all_colors = torch.cat([colors1, colors2], dim=-2)
    all_densities = torch.cat([densities1, densities2], dim=-2)
    _, indices = torch.sort(all_depths, dim=-2, stable=True)
    all_depths = all_depths.gather(-2, indices)
    all_colors = all_colors.gather(
        -2, indices.expand(-1, -1, -1, all_colors.shape[-1]))
    all_densities = all_densities.gather(-2, indices)
    return all_depths, all_colors, all_densities


class ImportanceRenderer:
    """Two-pass coarse/fine renderer (reference: renderer.py:89-155)."""

    def run_model(self, planes_cl, decoder, sample_coordinates,
                  sample_directions, options, generator=None):
        """planes_cl: channels-last planes (N, 3, H, W, C). A positive
        ``density_noise`` option adds Gaussian noise of that scale to sigma,
        drawn from ``generator`` (JAX :264-267)."""
        sampled_features = triplane_sample(planes_cl, sample_coordinates,
                                           options['box_warp'])
        out = decoder(sampled_features, sample_directions)
        if options.get('density_noise', 0) > 0:
            if generator is None:
                raise ValueError('density_noise needs a generator')
            sigma = out['sigma']
            out['sigma'] = sigma + torch.randn(
                sigma.shape, generator=generator, device=sigma.device,
                dtype=sigma.dtype) * options['density_noise']
        return out

    def __call__(self, planes, decoder, ray_origins, ray_directions,
                 rendering_options, generator=None):
        """planes (N, 3, C, H, W) -> (rgb (N, R, C), depth (N, R, 1),
        weight_sum (N, R, 1))."""
        opts = rendering_options

        def run(depths):
            n = depths.shape[2]
            coords = (ray_origins[:, :, None] + depths
                      * ray_directions[:, :, None]).reshape(N, -1, 3)
            dirs = ray_directions[:, :, None].expand(N, R, n, 3).reshape(
                N, -1, 3)
            out = self.run_model(planes_cl, decoder, coords, dirs, opts,
                                 generator)
            return (out['rgb'].reshape(N, R, n, -1),
                    out['sigma'].reshape(N, R, n, 1))

        with span('G.render.coarse'):
            planes_cl = layout_for(planes, opts)
            if opts['ray_start'] == opts['ray_end'] == 'auto':
                ray_start, ray_end = math_utils.get_ray_limits_box(
                    ray_origins, ray_directions,
                    box_side_length=opts['box_warp'])
                # invalid rays take the min/max start of the valid ones
                # (reference :100-103)
                valid = ray_end > ray_start
                vmin = torch.where(valid, ray_start, 1e10).min()
                vmax = torch.where(valid, ray_start, -1e10).max()
                ray_start = torch.where(valid, ray_start, vmin)
                ray_end = torch.where(valid, ray_end, vmax)
            else:
                ray_start, ray_end = opts['ray_start'], opts['ray_end']
            depths_coarse = sample_stratified(
                generator, ray_origins, ray_start, ray_end,
                opts['depth_resolution'], opts['disparity_space_sampling'])
            N, R, S, _ = depths_coarse.shape
            colors_coarse, densities_coarse = run(depths_coarse)
        N_importance = opts['depth_resolution_importance']
        if N_importance > 0:
            with span('G.render.importance'):
                _, _, weights = mip_ray_marcher2(
                    colors_coarse, densities_coarse, depths_coarse, opts)
                depths_fine = sample_importance(generator, depths_coarse,
                                                weights, N_importance)
            with span('G.render.fine'):
                colors_fine, densities_fine = run(depths_fine)
            with span('G.render.composite'):
                all_depths, all_colors, all_densities = unify_samples(
                    depths_coarse, colors_coarse, densities_coarse,
                    depths_fine, colors_fine, densities_fine)
                rgb_final, depth_final, weights = mip_ray_marcher2(
                    all_colors, all_densities, all_depths, opts)
                return rgb_final, depth_final, weights.sum(dim=2)
        with span('G.render.composite'):
            rgb_final, depth_final, weights = mip_ray_marcher2(
                colors_coarse, densities_coarse, depths_coarse, opts)
            return rgb_final, depth_final, weights.sum(dim=2)
