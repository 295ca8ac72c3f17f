"""Mesh and landmark readers: ``ObjMesh``, ``load_obj``, ``load_obj_verts``
and ``load_lms``.

Counterpart of next3d_tpu/utils/obj_io.py, kept as the port's own numpy
copy (the port imports nothing of the JAX package). The JAX package's
optional native parser is left out.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class ObjMesh(NamedTuple):
    verts: np.ndarray                  # (V, 3) float32
    faces: np.ndarray                  # (F, 3) int32, vertex indices
    verts_uvs: Optional[np.ndarray]    # (T, 2) float32 or None
    faces_uvs: Optional[np.ndarray]    # (F, 3) int32, uv indices or None


def load_obj(path) -> ObjMesh:
    """Vertices, UVs and faces of a Wavefront .obj; polygons are split into
    triangle fans."""
    verts, uvs, faces, faces_uv = [], [], [], []
    with open(path, 'r') as f:
        for line in f:
            if line.startswith('v '):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]),
                              float(parts[3])))
            elif line.startswith('vt '):
                parts = line.split()
                uvs.append((float(parts[1]), float(parts[2])))
            elif line.startswith('f '):
                vi, ti = [], []
                for p in line.split()[1:]:
                    comps = p.split('/')
                    vi.append(int(comps[0]) - 1)
                    if len(comps) > 1 and comps[1]:
                        ti.append(int(comps[1]) - 1)
                for k in range(1, len(vi) - 1):
                    faces.append((vi[0], vi[k], vi[k + 1]))
                    if ti:
                        faces_uv.append((ti[0], ti[k], ti[k + 1]))
    return ObjMesh(
        verts=np.asarray(verts, np.float32),
        faces=np.asarray(faces, np.int32),
        verts_uvs=np.asarray(uvs, np.float32) if uvs else None,
        faces_uvs=np.asarray(faces_uv, np.int32) if faces_uv else None,
    )


def load_obj_verts(path) -> np.ndarray:
    """The vertices of a Wavefront .obj alone, (V, 3) float32."""
    verts = []
    with open(path, 'r') as f:
        for line in f:
            if line.startswith('v '):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]),
                              float(parts[3])))
    return np.asarray(verts, np.float32)


def load_lms(path) -> np.ndarray:
    """Landmark .txt: whitespace-separated floats, one landmark a line."""
    return np.loadtxt(path, dtype=np.float32)
