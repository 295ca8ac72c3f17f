"""Midpoint volume compositing (MipRayMarcher2).

Counterpart of next3d_tpu/render/ray_marcher.py (reference:
training_avatar_texture/volumetric_rendering/ray_marcher.py:22-77).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mip_ray_marcher2(colors, densities, depths, rendering_options):
    """colors (N, R, S, C), densities and depths (N, R, S, 1) ->
    (composite_rgb (N, R, C), composite_depth (N, R, 1),
     weights (N, R, S-1, 1))."""
    deltas = depths[:, :, 1:] - depths[:, :, :-1]
    colors_mid = (colors[:, :, :-1] + colors[:, :, 1:]) / 2
    densities_mid = (densities[:, :, :-1] + densities[:, :, 1:]) / 2
    depths_mid = (depths[:, :, :-1] + depths[:, :, 1:]) / 2

    assert rendering_options.get('clamp_mode', 'softplus') == 'softplus', \
        "only clamp_mode='softplus' is supported (as in the reference)"
    densities_mid = F.softplus(densities_mid - 1)

    alpha = 1 - torch.exp(-densities_mid * deltas)
    alpha_shifted = torch.cat([torch.ones_like(alpha[:, :, :1]),
                               1 - alpha + 1e-10], dim=-2)
    weights = alpha * torch.cumprod(alpha_shifted, dim=-2)[:, :, :-1]

    composite_rgb = torch.sum(weights * colors_mid, dim=-2)
    weight_total = weights.sum(dim=2)
    composite_depth = torch.sum(weights * depths_mid, dim=-2) / weight_total
    composite_depth = torch.nan_to_num(composite_depth, nan=float('inf'))
    composite_depth = torch.clamp(composite_depth, torch.min(depths),
                                  torch.max(depths))
    if rendering_options.get('white_back', False):
        composite_rgb = composite_rgb + 1 - weight_total
    return composite_rgb * 2 - 1, composite_depth, weights
