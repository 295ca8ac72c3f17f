"""Shape extraction helpers: the sigma-grid samples, an MRC writer and a
marching-tetrahedra isosurface with a binary PLY writer (numpy only).

The port's copy of next3d_tpu/render/shape_utils.py (reference:
shape_utils.py and gen_samples_next3d.py:208-246): the same functions, the
same bytes out. The reference writes .mrc with the mrcfile package and
meshes with skimage's marching cubes; here the MRC2014 header is written
directly and the isosurface is marching tetrahedra (the same level set,
about twice marching cubes' triangles).
"""

from __future__ import annotations

import struct

import numpy as np


def create_samples(N=256, voxel_origin=(0, 0, 0), cube_length=2.0):
    """Regular N^3 grid of sample points (reference shape_utils.py:
    create_samples) — returns (N^3, 3) coords, origin, voxel size."""
    voxel_origin = np.asarray(voxel_origin, np.float64) - cube_length / 2
    voxel_size = cube_length / (N - 1)

    idx = np.arange(N ** 3, dtype=np.int64)
    samples = np.zeros((N ** 3, 3), np.float32)
    # the EG3D order: z fastest, x slowest, so that the sigmas reshape to
    # (N, N, N) indexed [x, y, z]
    samples[:, 2] = (idx % N) * voxel_size + voxel_origin[2]
    samples[:, 1] = ((idx // N) % N) * voxel_size + voxel_origin[1]
    samples[:, 0] = (idx // (N * N)) * voxel_size + voxel_origin[0]
    return samples, voxel_origin, voxel_size


def save_mrc(path, volume, voxel_size=1.0):
    """Minimal MRC2014 writer (mode 2 = float32)."""
    vol = np.ascontiguousarray(volume, np.float32)
    nz, ny, nx = vol.shape
    header = bytearray(1024)
    struct.pack_into('<3i', header, 0, nx, ny, nz)
    struct.pack_into('<i', header, 12, 2)  # mode 2: float32
    struct.pack_into('<3i', header, 28, nx, ny, nz)  # mx, my, mz
    struct.pack_into('<3f', header, 40, nx * voxel_size, ny * voxel_size,
                     nz * voxel_size)  # cell dims
    struct.pack_into('<3f', header, 52, 90.0, 90.0, 90.0)  # angles
    struct.pack_into('<3i', header, 64, 1, 2, 3)  # axis order
    struct.pack_into('<3f', header, 76, float(vol.min()), float(vol.max()),
                     float(vol.mean()))
    header[208:212] = b'MAP '
    header[212:216] = b'\x44\x44\x00\x00'  # little-endian machine stamp
    with open(path, 'wb') as f:
        f.write(bytes(header))
        f.write(vol.tobytes())


# ------------------------------------------------------- marching tetrahedra

# cube corner offsets (z fastest to match create_samples ordering)
_CORNERS = np.array([[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
                     [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], np.int64)
# 6-tetrahedra decomposition of the cube
_TETS = np.array([[0, 5, 1, 3], [0, 5, 3, 7], [0, 5, 7, 4],
                  [0, 7, 3, 2], [0, 7, 2, 6], [0, 7, 6, 4]], np.int64)


def marching_tetrahedra(volume, level=10.0, origin=(0, 0, 0), spacing=1.0):
    """Extract the level-set surface. Returns (verts (V,3), faces (F,3))."""
    vol = np.asarray(volume, np.float32)
    N0, N1, N2 = vol.shape
    # corner values for every cube
    base = np.stack(np.meshgrid(np.arange(N0 - 1), np.arange(N1 - 1),
                                np.arange(N2 - 1), indexing='ij'),
                    axis=-1).reshape(-1, 3)
    verts_out = []
    # process in slabs to bound memory
    slab = max(1, (1 << 22) // max((N1 - 1) * (N2 - 1), 1))
    for z0 in range(0, N0 - 1, slab):
        cubes = base[(base[:, 0] >= z0) & (base[:, 0] < z0 + slab)]
        if cubes.size == 0:
            continue
        corner_idx = cubes[:, None, :] + _CORNERS[None]  # (C, 8, 3)
        vals = vol[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
        for tet in _TETS:
            tv = vals[:, tet]  # (C, 4)
            tp = corner_idx[:, tet].astype(np.float32)  # (C, 4, 3)
            inside = tv > level  # (C, 4)
            n_in = inside.sum(1)
            for n, flip in ((1, False), (3, True)):
                sel = n_in == n
                if not sel.any():
                    continue
                v4 = tv[sel]
                p4 = tp[sel]
                ins = inside[sel] if not flip else ~inside[sel]
                ai = np.argmax(ins, axis=1)
                rows = np.arange(len(ai))
                others = np.array([[j for j in range(4) if j != a] for a in ai])
                pa = p4[rows, ai]
                va = v4[rows, ai]
                tri = []
                for k in range(3):
                    pb = p4[rows, others[:, k]]
                    vb = v4[rows, others[:, k]]
                    t = (level - va) / np.where(vb - va == 0, 1e-9, vb - va)
                    tri.append(pa + t[:, None] * (pb - pa))
                verts_out.append(np.stack(tri, axis=1).reshape(-1, 3))
            sel = n_in == 2
            if sel.any():
                v4 = tv[sel]
                p4 = tp[sel]
                ins = inside[sel]
                # two inside (a, b), two outside (c, d) -> quad (ac, ad, bd, bc)
                order = np.argsort(~ins, axis=1)  # inside first
                rows = np.arange(len(v4))[:, None]
                pi = p4[rows, order]
                vi = v4[rows, order]

                def edge(i, j):
                    t = (level - vi[:, i]) / np.where(
                        vi[:, j] - vi[:, i] == 0, 1e-9, vi[:, j] - vi[:, i])
                    return pi[:, i] + t[:, None] * (pi[:, j] - pi[:, i])
                e_ac, e_ad = edge(0, 2), edge(0, 3)
                e_bc, e_bd = edge(1, 2), edge(1, 3)
                verts_out.append(np.stack([e_ac, e_ad, e_bd], 1).reshape(-1, 3))
                verts_out.append(np.stack([e_ac, e_bd, e_bc], 1).reshape(-1, 3))
    if not verts_out:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    tri_verts = np.concatenate(verts_out, axis=0)
    verts = tri_verts * spacing + np.asarray(origin, np.float32)
    faces = np.arange(len(verts), dtype=np.int64).reshape(-1, 3)
    return verts.astype(np.float32), faces


def save_ply(path, verts, faces):
    with open(path, 'wb') as f:
        header = (f"ply\nformat binary_little_endian 1.0\n"
                  f"element vertex {len(verts)}\n"
                  "property float x\nproperty float y\nproperty float z\n"
                  f"element face {len(faces)}\n"
                  "property list uchar int vertex_indices\nend_header\n")
        f.write(header.encode())
        f.write(np.ascontiguousarray(verts, '<f4').tobytes())
        fdata = np.empty(len(faces), dtype=[('n', 'u1'), ('idx', '<i4', 3)])
        fdata['n'] = 3
        fdata['idx'] = faces
        f.write(fdata.tobytes())


def save_ply_from_sigma(path, sigmas, level=10.0):
    verts, faces = marching_tetrahedra(sigmas, level=level)
    save_ply(path, verts, faces)
