"""Ray/box math.

Counterpart of next3d_tpu/render/math_utils.py (reference:
training_avatar_texture/volumetric_rendering/math_utils.py).
"""

from __future__ import annotations

import torch


def normalize_vecs(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def get_ray_limits_box(rays_o, rays_d, box_side_length):
    """Ray/AABB intersection over the [-box/2, box/2]^3 volume.

    Returns (tmin, tmax), each (..., 1); invalid rays get (-1, -2)
    (reference: math_utils.py:46-98).
    """
    o_shape = rays_o.shape
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    half = box_side_length / 2
    bounds = torch.tensor([[-half] * 3, [half] * 3], dtype=rays_o.dtype,
                          device=rays_o.device)
    invdir = 1 / rays_d
    sign = (invdir < 0).long()

    def plane(axis):
        lo = bounds[sign[:, axis], axis]
        hi = bounds[1 - sign[:, axis], axis]
        return ((lo - rays_o[:, axis]) * invdir[:, axis],
                (hi - rays_o[:, axis]) * invdir[:, axis])

    tmin, tmax = plane(0)
    tymin, tymax = plane(1)
    is_valid = ~((tmin > tymax) | (tymin > tmax))
    tmin = torch.maximum(tmin, tymin)
    tmax = torch.minimum(tmax, tymax)
    tzmin, tzmax = plane(2)
    is_valid &= ~((tmin > tzmax) | (tzmin > tmax))
    tmin = torch.maximum(tmin, tzmin)
    tmax = torch.minimum(tmax, tzmax)
    tmin = torch.where(is_valid, tmin, torch.full_like(tmin, -1.0))
    tmax = torch.where(is_valid, tmax, torch.full_like(tmax, -2.0))
    return (tmin.reshape(*o_shape[:-1], 1), tmax.reshape(*o_shape[:-1], 1))


def linspace_batch(start, stop, num):
    """(num, *start.shape) evenly spaced start..stop inclusive
    (reference: math_utils.py:101-118)."""
    steps = torch.arange(num, dtype=torch.float32,
                         device=start.device) / (num - 1)
    steps = steps.reshape((-1,) + (1,) * start.ndim)
    return start[None] + steps * (stop - start)[None]
