"""Look-at camera poses (y-up sphere) and intrinsics.

Counterpart of next3d_tpu/render/camera_utils.py (reference:
camera_utils.py LookAtPoseSampler :58-86, create_cam2world_matrix :118-137,
FOV_to_intrinsics :140-149).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .math_utils import normalize_vecs


def create_cam2world_matrix(forward_vector, origin):
    """forward (N, 3), origin (N, 3) -> (N, 4, 4); y-up, no roll."""
    forward_vector = normalize_vecs(forward_vector)
    up_vector = torch.tensor([0., 1., 0.], dtype=forward_vector.dtype,
                             device=forward_vector.device).expand_as(
                                 forward_vector)
    right_vector = -normalize_vecs(torch.cross(up_vector, forward_vector,
                                               dim=-1))
    up_vector = normalize_vecs(torch.cross(forward_vector, right_vector,
                                           dim=-1))
    N = forward_vector.shape[0]
    eye = torch.eye(4, dtype=forward_vector.dtype,
                    device=forward_vector.device)
    rotation = eye.repeat(N, 1, 1)
    rotation[:, :3, :3] = torch.stack([right_vector, up_vector,
                                       forward_vector], dim=-1)
    translation = eye.repeat(N, 1, 1)
    translation[:, :3, 3] = origin
    return translation @ rotation


def lookat_pose(horizontal_mean, vertical_mean, lookat_position, radius=1,
                batch_size=1, device='cuda'):
    """LookAtPoseSampler.sample without jitter (reference:
    camera_utils.py:68-86): (batch_size, 4, 4) cam2world on ``device`` (the
    card unless the caller asks for the CPU)."""
    h = torch.full((batch_size, 1), float(horizontal_mean), device=device)
    v = torch.full((batch_size, 1), float(vertical_mean), device=device)
    v = v.clamp(1e-5, math.pi - 1e-5)
    phi = torch.arccos(1 - 2 * (v / math.pi))
    origins = radius * torch.cat([
        torch.sin(phi) * torch.cos(math.pi - h),
        torch.cos(phi),
        torch.sin(phi) * torch.sin(math.pi - h)], dim=1)
    lookat = torch.as_tensor(lookat_position, dtype=torch.float32,
                             device=device).expand_as(origins)
    return create_cam2world_matrix(normalize_vecs(lookat - origins), origins)


def fov_to_intrinsics(fov_degrees):
    """Normalized 3x3 intrinsics from FOV (numpy, float32)."""
    focal_length = float(1 / (math.tan(fov_degrees * 3.14159 / 360) * 1.414))
    return np.array([[focal_length, 0, 0.5],
                     [0, focal_length, 0.5],
                     [0, 0, 1]], dtype=np.float32)
