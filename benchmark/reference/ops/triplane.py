"""K4: tri-plane bilinear sampling, as plain torch on any device.

A frozen copy of the plain version in ``next3d_tpu_torch/ops/triplane.py``
(``triplane_sample_plain``: ``F.grid_sample`` on the planes, zeros
padding, align_corners=False), differentiable with respect to the planes
through autograd. No kernel is called.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

def generate_planes():
    """Plane axis matrices (reference: renderer.py:30-44). The 2nd and 3rd
    are deliberately not orthonormal inverses of each other: they match the
    EG3D checkpoints' convention."""
    return np.array([[[1, 0, 0], [0, 1, 0], [0, 0, 1]],
                     [[1, 0, 0], [0, 0, 1], [0, 1, 0]],
                     [[0, 0, 1], [0, 1, 0], [1, 0, 0]]], dtype=np.float32)


_INV_PLANES = np.linalg.inv(generate_planes()).astype(np.float32)


def project_onto_planes(coordinates):
    """(N, M, 3) -> (N*3, M, 2) plane coordinates (reference :46-60). The
    inverse plane matrices are permutations, so this picks (x, y), (x, z)
    and (z, y)."""
    N, M, _ = coordinates.shape
    inv = torch.from_numpy(_INV_PLANES).to(coordinates.device)
    proj = torch.einsum('nmc,pcd->npmd', coordinates, inv)
    return proj.reshape(N * 3, M, 3)[..., :2]


def channels_last(planes, dtype=None):
    """(N, 3, C, H, W) -> (N, 3, H, W, C) contiguous, in ``dtype`` (the
    planes' own by default): one pass that permutes and casts. (A cast
    after the permute would keep the permuted strides, and a
    ``.contiguous()`` after it would be a second pass.)"""
    permuted = planes.permute(0, 1, 3, 4, 2)
    if dtype is None or dtype == planes.dtype:
        return permuted.contiguous()
    return torch.empty(permuted.shape, dtype=dtype,
                       device=planes.device).copy_(permuted)


def triplane_sample_plain(planes_cl, coordinates, box_warp):
    """The plain torch version on any device; float32 out, bf16 planes
    upcast."""
    N, n_planes, H, W, C = planes_cl.shape
    M = coordinates.shape[1]
    feats = planes_cl.float().permute(0, 1, 4, 2, 3).reshape(
        N * n_planes, C, H, W)
    proj = project_onto_planes((2 / box_warp) * coordinates)
    out = F.grid_sample(feats, proj[:, None], mode='bilinear',
                        padding_mode='zeros', align_corners=False)
    return out[:, :, 0].permute(0, 2, 1).reshape(N, n_planes, M, C)


triplane_sample = triplane_sample_plain
