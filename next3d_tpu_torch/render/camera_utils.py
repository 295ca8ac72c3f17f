"""Camera pose samplers (y-up sphere) and intrinsics.

Counterpart of next3d_tpu/render/camera_utils.py (reference:
camera_utils.py GaussianCameraPoseSampler :38-55, LookAtPoseSampler
:58-86, UniformCameraPoseSampler :99-116, create_cam2world_matrix
:118-137, FOV_to_intrinsics :140-149). The jitter is drawn from an explicit
``torch.Generator``; the poses are made on ``device``, the card by default.
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


def _origins_from_angles(h, v, radius):
    """Camera origins (N, 3) on the sphere of ``radius`` at yaw ``h`` and
    pitch ``v``, each (N, 1): the deterministic core of the samplers,
    rounded as the JAX package's (JAX :36-43)."""
    v = v.clamp(1e-5, math.pi - 1e-5)
    theta = h
    phi = torch.arccos(1 - 2 * (v / math.pi))
    ox = radius * torch.sin(phi) * torch.cos(math.pi - theta)
    oz = radius * torch.sin(phi) * torch.sin(math.pi - theta)
    oy = radius * torch.cos(phi)
    return torch.cat([ox, oy, oz], dim=1)


def _angles(horizontal_mean, vertical_mean, batch_size, horizontal_stddev,
            vertical_stddev, generator, device, draw):
    """(h, v), each (batch_size, 1) on ``device``: the means, or with a
    ``generator`` and a stddev the means plus stddev times ``draw``, drawn
    on the generator's device."""
    shape = (batch_size, 1)
    if generator is not None and (horizontal_stddev or vertical_stddev):
        h = draw(shape, generator) * horizontal_stddev + horizontal_mean
        v = draw(shape, generator) * vertical_stddev + vertical_mean
        return h.to(device), v.to(device)
    return (torch.full(shape, float(horizontal_mean), device=device),
            torch.full(shape, float(vertical_mean), device=device))


def _normal(shape, generator):
    return torch.randn(shape, generator=generator, device=generator.device)


def _uniform(shape, generator):
    return torch.rand(shape, generator=generator,
                      device=generator.device) * 2 - 1


def lookat_pose(horizontal_mean, vertical_mean, lookat_position, radius=1,
                batch_size=1, horizontal_stddev=0, vertical_stddev=0,
                generator=None, device='cuda'):
    """LookAtPoseSampler.sample (reference: camera_utils.py:68-86):
    (batch_size, 4, 4) cam2world on ``device`` (the card unless the caller
    asks for the CPU), looking at ``lookat_position``; with a
    ``torch.Generator`` and a stddev, the angles are jittered by normal
    draws."""
    h, v = _angles(horizontal_mean, vertical_mean, batch_size,
                   horizontal_stddev, vertical_stddev, generator, device,
                   _normal)
    origins = _origins_from_angles(h, v, radius)
    lookat = torch.as_tensor(lookat_position, dtype=torch.float32,
                             device=device).expand_as(origins)
    return create_cam2world_matrix(normalize_vecs(lookat - origins), origins)


def gaussian_pose(horizontal_mean, vertical_mean, radius=1, batch_size=1,
                  horizontal_stddev=0, vertical_stddev=0, generator=None,
                  device='cuda'):
    """GaussianCameraPoseSampler.sample (reference: camera_utils.py:38-55;
    JAX :63-68): ``lookat_pose`` at the origin."""
    return lookat_pose(horizontal_mean, vertical_mean, [0., 0., 0.], radius,
                       batch_size, horizontal_stddev, vertical_stddev,
                       generator, device)


def uniform_pose(horizontal_mean, vertical_mean, radius=1, batch_size=1,
                 horizontal_stddev=0, vertical_stddev=0, generator=None,
                 device='cuda'):
    """UniformCameraPoseSampler.sample (reference: camera_utils.py:99-116;
    JAX :71-83): the angles jittered by uniform draws in [-stddev,
    stddev), the camera looking at the origin."""
    h, v = _angles(horizontal_mean, vertical_mean, batch_size,
                   horizontal_stddev, vertical_stddev, generator, device,
                   _uniform)
    origins = _origins_from_angles(h, v, radius)
    return create_cam2world_matrix(normalize_vecs(-origins), origins)


def fov_to_intrinsics(fov_degrees):
    """Normalized 3x3 intrinsics from FOV (numpy, float32)."""
    focal_length = float(1 / (math.tan(fov_degrees * 3.14159 / 360) * 1.414))
    return np.array([[focal_length, 0, 0.5],
                     [0, focal_length, 0.5],
                     [0, 0, 1]], dtype=np.float32)
