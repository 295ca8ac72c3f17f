"""Per-pixel ray origins/directions from cam2world + intrinsics.

Counterpart of next3d_tpu/render/ray_sampler.py (reference:
training_avatar_texture/volumetric_rendering/ray_sampler.py:18-63).
"""

from __future__ import annotations

import torch


def sample_rays(cam2world_matrix, intrinsics, resolution):
    """cam2world (N, 4, 4), normalized intrinsics (N, 3, 3) ->
    ray_origins, ray_dirs: (N, res*res, 3); x is the fast pixel axis."""
    N = cam2world_matrix.shape[0]
    M = resolution * resolution
    device = cam2world_matrix.device
    cam_locs_world = cam2world_matrix[:, :3, 3]
    fx = intrinsics[:, 0, 0, None]
    fy = intrinsics[:, 1, 1, None]
    cx = intrinsics[:, 0, 2, None]
    cy = intrinsics[:, 1, 2, None]
    sk = intrinsics[:, 0, 1, None]

    coords = (torch.arange(resolution, dtype=torch.float32, device=device)
              + 0.5) / resolution
    yy, xx = torch.meshgrid(coords, coords, indexing='ij')
    x_cam = xx.reshape(1, M).expand(N, M)
    y_cam = yy.reshape(1, M).expand(N, M)
    z_cam = torch.ones((N, M), dtype=torch.float32, device=device)

    x_lift = (x_cam - cx + cy * sk / fy - sk * y_cam / fy) / fx * z_cam
    y_lift = (y_cam - cy) / fy * z_cam
    cam_rel_points = torch.stack([x_lift, y_lift, z_cam,
                                  torch.ones_like(z_cam)], dim=-1)
    world_rel_points = torch.einsum('nij,nmj->nmi', cam2world_matrix,
                                    cam_rel_points)[:, :, :3]
    ray_dirs = world_rel_points - cam_locs_world[:, None, :]
    ray_dirs = ray_dirs / torch.linalg.norm(ray_dirs, dim=2, keepdim=True)
    ray_origins = cam_locs_world[:, None, :].expand_as(ray_dirs)
    return ray_origins, ray_dirs
