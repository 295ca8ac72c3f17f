"""The head mesh the cells run on: a procedural stand-in with FLAME's sizes.

A frozen copy of ``next3d_tpu_torch/utils/synthetic_head.py``
``synthetic_head`` (numpy only): 5023 verts, 10,042 faces, one UV per
face corner and 68 landmarks in the iBUG layout, 48..59 ringing the
mouth. The benchmark makes its inputs from this copy, so that a change to
the program's own head cannot change what the cells run on.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Mesh(NamedTuple):
    verts: np.ndarray                  # (V, 3) float32
    faces: np.ndarray                  # (F, 3) int32, vertex indices
    verts_uvs: np.ndarray              # (T, 2) float32
    faces_uvs: np.ndarray              # (F, 3) int32, uv indices


N_FLAME_VERTS = 5023
N_RINGS = 57
N_LON = 88
N_SPLITS = 5
SEMI_AXES = (0.085, 0.115, 0.10)
MOUTH_CENTER = (0.0, -0.05)


def _front_offset(x, y):
    """Outward z displacement of the front surface: nose bump, mouth groove."""
    nose = 0.02 * np.exp(-((x / 0.012) ** 2 + ((y + 0.005) / 0.016) ** 2))
    mx, my = MOUTH_CENTER
    groove = -0.006 * np.exp(-((y - my) / 0.003) ** 2) \
        * np.clip(1.0 - (np.abs(x - mx) / 0.025) ** 2, 0.0, None)
    return nose + groove


def _surface_point(x, y):
    a, b, c = SEMI_AXES
    s = np.clip(1.0 - (x / a) ** 2 - (y / b) ** 2, 0.0, None)
    return np.stack([x, y, c * np.sqrt(s) + _front_offset(x, y)], axis=-1)


def _landmarks():
    """68 iBUG-layout points (x, y in metres, y up) lifted onto the face."""
    pts = []
    t = np.linspace(np.pi, 2 * np.pi, 17)                      # 0..16 jaw
    pts += list(zip(0.075 * np.cos(t), 0.095 * np.sin(t)))
    for x0, x1 in ((-0.06, -0.015), (0.015, 0.06)):            # 17..26 brows
        pts += [(x, 0.045) for x in np.linspace(x0, x1, 5)]
    pts += [(0.0, y) for y in np.linspace(0.03, -0.01, 4)]     # 27..30 bridge
    pts += [(x, -0.02) for x in np.linspace(-0.015, 0.015, 5)]  # 31..35
    t = np.linspace(np.pi, -np.pi, 7)[:-1]                     # 36..47 eyes
    for cx in (-0.035, 0.035):
        pts += list(zip(cx + 0.012 * np.cos(t), 0.025 + 0.005 * np.sin(t)))
    mx, my = MOUTH_CENTER
    t = np.pi - 2 * np.pi * np.arange(12) / 12                 # 48..59 lips
    pts += list(zip(mx + 0.025 * np.cos(t), my + 0.012 * np.sin(t)))
    t = np.pi - 2 * np.pi * np.arange(8) / 8                   # 60..67 inner
    pts += list(zip(mx + 0.018 * np.cos(t), my + 0.005 * np.sin(t)))
    xy = np.asarray(pts, np.float64)
    assert xy.shape == (68, 2)
    return _surface_point(xy[:, 0], xy[:, 1]).astype(np.float32)


def synthetic_head():
    """Returns (ObjMesh, landmarks (68, 3) float32)."""
    a, b, c = SEMI_AXES
    theta = np.pi * np.arange(1, N_RINGS + 1) / (N_RINGS + 1)  # from +y pole
    phi = 2 * np.pi * np.arange(N_LON) / N_LON                 # 0 = front
    th, ph = np.meshgrid(theta, phi, indexing='ij')
    ring = np.stack([a * np.sin(th) * np.sin(ph), b * np.cos(th),
                     c * np.sin(th) * np.cos(ph)], axis=-1).reshape(-1, 3)
    front = ring[:, 2] > 0
    ring[front, 2] += _front_offset(ring[front, 0], ring[front, 1])
    top, bottom = N_RINGS * N_LON, N_RINGS * N_LON + 1
    verts = np.concatenate([ring, [[0, b, 0], [0, -b, 0]]])

    def vid(i, j):
        return i * N_LON + j % N_LON

    faces = []
    for j in range(N_LON):
        faces.append((top, vid(0, j + 1), vid(0, j)))
        for i in range(N_RINGS - 1):
            faces.append((vid(i, j), vid(i, j + 1), vid(i + 1, j)))
            faces.append((vid(i, j + 1), vid(i + 1, j + 1), vid(i + 1, j)))
        faces.append((bottom, vid(N_RINGS - 1, j), vid(N_RINGS - 1, j + 1)))
    faces = np.asarray(faces, np.int64)

    # 5 face-centre splits on the back of the head bring V to 5023
    extra = []
    back = np.nonzero(verts[faces].mean(1)[:, 2] < -0.09)[0][:N_SPLITS]
    new_faces = [f for k, f in enumerate(faces) if k not in set(back)]
    for k in back:
        f0, f1, f2 = faces[k]
        m = len(verts) + len(extra)
        extra.append(verts[faces[k]].mean(0))
        new_faces += [(f0, f1, m), (f1, f2, m), (f2, f0, m)]
    verts = np.concatenate([verts, np.asarray(extra)]).astype(np.float32)
    faces = np.asarray(new_faces, np.int32)
    assert verts.shape[0] == N_FLAME_VERTS, verts.shape

    # per-corner UVs: azimuth -> u (front at 0.5), height -> v; faces that
    # straddle the back seam are unwrapped onto the u > 0.5 side
    corners = verts[faces].astype(np.float64)                   # (F, 3, 3)
    u = 0.5 + np.arctan2(corners[..., 0], corners[..., 2]) / (2 * np.pi)
    v = 0.5 + 0.5 * corners[..., 1] / b
    seam = u.max(1) - u.min(1) > 0.5
    u[seam] = np.where(u[seam] < 0.5, u[seam] + 1.0, u[seam])
    pole = (np.abs(corners[..., 0]) < 1e-9) & (np.abs(corners[..., 2]) < 1e-9)
    for k, cidx in zip(*np.nonzero(pole)):                      # pole corner
        u[k, cidx] = np.delete(u[k], cidx).mean()
    uv = np.clip(np.stack([u, v], -1), 0.0, 1.0).astype(np.float32)
    mesh = Mesh(verts=verts, faces=faces,
                   verts_uvs=uv.reshape(-1, 2),
                   faces_uvs=np.arange(3 * len(faces), dtype=np.int32)
                   .reshape(-1, 3))
    return mesh, _landmarks()
