"""Mesh math helpers.

Counterpart of next3d_tpu/render/mesh.py (reference:
training_avatar_texture/volumetric_rendering/renderer.py face_vertices
:444-462, generate_triangles :466-481, transform_points :484-502,
batch_orth_proj :505-515, angle2matrix :518-547).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def face_vertices(vertices, faces):
    """vertices: (B, V, D); faces: (B, F, 3) int -> (B, F, 3, D)."""
    return torch.stack([v[f.long()] for v, f in zip(vertices, faces)])


def generate_triangles(h, w, margin_x=2, margin_y=5):
    """Dense UV-grid quad mesh with margins: (F, 3) int64 numpy faces of
    an ``h`` x ``w`` vertex grid."""
    triangles = []
    for x in range(margin_x, w - 1 - margin_x):
        for y in range(margin_y, h - 1 - margin_y):
            triangle0 = [y * w + x, y * w + x + 1, (y + 1) * w + x]
            triangle1 = [y * w + x + 1, (y + 1) * w + x + 1, (y + 1) * w + x]
            triangles.append(triangle0)
            triangles.append(triangle1)
    triangles = np.array(triangles, dtype=np.int64)
    return triangles[:, [0, 2, 1]]


def batch_orth_proj(X, camera):
    """Orthographic projection, scale + xy translation.

    X: (B, P, 3); camera: (3,) or (B, 3) = [scale, tx, ty].
    """
    camera = torch.as_tensor(camera, dtype=X.dtype,
                             device=X.device).reshape(-1, 1, 3)
    X_trans = X[:, :, :2] + camera[:, :, 1:]
    X_trans = torch.cat([X_trans, X[:, :, 2:]], dim=2)
    return camera[:, :, 0:1] * X_trans


def angle2matrix(angles):
    """XYZ Euler degrees (B, 3) -> rotation matrices Rz @ Ry @ Rx (B, 3, 3)."""
    angles = torch.as_tensor(angles, dtype=torch.float32) * (math.pi / 180.0)
    s = torch.sin(angles)
    c = torch.cos(angles)
    cx, cy, cz = c[:, 0], c[:, 1], c[:, 2]
    sx, sy, sz = s[:, 0], s[:, 1], s[:, 2]
    R = torch.stack([
        cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx,
        sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx,
        -sy, cy * sx, cy * cx,
    ], dim=0)  # (9, B)
    return R.reshape(3, 3, -1).permute(2, 0, 1)


def transform_points(points, tform, points_scale=None, out_scale=None):
    """2D homogeneous transform of points (B, P, D >= 2) by tform (B, 3, 3),
    with optional range rescaling: ``points_scale`` (h, w) maps [-1, 1] to
    pixels first, ``out_scale`` (h, w) maps pixels back to [-1, 1]; the
    coordinates past the second are kept."""
    points_2d = points[:, :, :2]
    if points_scale:
        assert points_scale[0] == points_scale[1]
        points_2d = (points_2d * 0.5 + 0.5) * points_scale[0]
    ones = torch.ones_like(points[:, :, :1])
    trans = torch.einsum('bpi,bij->bpj',
                         torch.cat([points_2d, ones], dim=-1), tform)
    if out_scale:
        tx = trans[:, :, 0] / out_scale[1] * 2 - 1
        ty = trans[:, :, 1] / out_scale[0] * 2 - 1
        trans = torch.stack([tx, ty], dim=-1)
    return torch.cat([trans[:, :, :2], points[:, :, 2:]], dim=-1)
