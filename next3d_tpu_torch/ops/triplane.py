"""K4: tri-plane bilinear sampling.

Counterpart of next3d_tpu/render/renderer.py sample_from_planes and of its
TPU kernel next3d_tpu/ops/pallas_triplane.py triplane_sample_tiles. Points
(N, M, 3), scaled by 2 / box_warp, are projected onto the 3 planes and
sampled bilinearly (zeros padding, align_corners=False), giving (N, 3, M, C).

The planes are passed channels-last, (N, 3, H, W, C) contiguous
(``channels_last``), so that one layout pass serves both render passes of a
forward and each tap's channels are one 128 B line. ``triplane_sample``
launches the kernel in ``csrc/triplane_sample.cu`` for CUDA tensors (C = 32
only; any other C raises) and runs the plain ``F.grid_sample`` version for
CPU tensors. Inference only: no backward yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build


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


def channels_last(planes):
    """(N, 3, C, H, W) -> (N, 3, H, W, C) contiguous."""
    return planes.permute(0, 1, 3, 4, 2).contiguous()


def triplane_sample_plain(planes_cl, coordinates, box_warp):
    """The plain torch version on any device."""
    N, n_planes, H, W, C = planes_cl.shape
    M = coordinates.shape[1]
    feats = planes_cl.permute(0, 1, 4, 2, 3).reshape(N * n_planes, C, H, W)
    proj = project_onto_planes((2 / box_warp) * coordinates)
    out = F.grid_sample(feats, proj[:, None], mode='bilinear',
                        padding_mode='zeros', align_corners=False)
    return out[:, :, 0].permute(0, 2, 1).reshape(N, n_planes, M, C)


C_KERNEL = 32  # the channel count the kernel is instantiated for


def _sample_cuda(planes_cl, coordinates, box_warp):
    N, n_planes, H, W, C = planes_cl.shape
    M = coordinates.shape[1]
    if n_planes != 3 or coordinates.shape != (N, M, 3):
        raise ValueError(f'planes {tuple(planes_cl.shape)} and coordinates '
                         f'{tuple(coordinates.shape)} do not match')
    if C != C_KERNEL:
        raise ValueError(f'the kernel takes {C_KERNEL} channels, not {C}')
    for name, t in (('planes', planes_cl), ('coordinates', coordinates)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != planes_cl.device:
            raise ValueError(f'{name} must be contiguous float32 on '
                             f'{planes_cl.device}')
    if planes_cl.data_ptr() % 16:
        raise ValueError('planes must be 16-byte aligned')
    if max(planes_cl.numel(), N * 3 * M * C) >= 2 ** 31:
        raise ValueError('the kernel indexes in 32 bits')
    out = torch.empty((N, 3, M, C), dtype=torch.float32,
                      device=planes_cl.device)
    cuda_build.launch('triplane_sample', 'triplane_sample', planes_cl.device,
                      planes_cl.data_ptr(), coordinates.data_ptr(),
                      out.data_ptr(), N, M, H, W, C, 2.0 / box_warp)
    triplane_sample.launches += 1
    return out


def triplane_sample(planes_cl, coordinates, box_warp):
    """planes_cl (N, 3, H, W, C), coordinates (N, M, 3) -> (N, 3, M, C)."""
    if planes_cl.is_cuda:
        return _sample_cuda(planes_cl, coordinates, box_warp)
    return triplane_sample_plain(planes_cl, coordinates, box_warp)


triplane_sample.launches = 0
