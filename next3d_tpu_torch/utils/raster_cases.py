"""Seeded rasterizer inputs for the binned kernels (K1, K2, K3) and the
per-face z-buffer (K5).

``adversarial_mesh`` stresses the resolve kernels' coarse test
(``csrc/raster_binned_uv.cu``): edges that pass exactly through pixel
centres, corners on the pixels where sub-tiles and tiles meet, sub-pixel
slivers, faces across sub-tile and tile borders, dropped faces (zero area,
back-facing) and depth ties. ``zbuffer_mesh`` and ``sliver_sweep`` do the
same for K5's face kernel (``csrc/raster_zbuffer.cu``) and its rounding.
``four_views`` is the flagship's rasterizer input, the head through its 4
orthographic views. All return numpy arrays in the rasterizers' contract:
verts (B, V, 3) with x, y in [-1, 1], faces (F, 3) int32, and for the
binned kernels per-corner (u, v) attrs (1, F, 3, 2). The tests and
chip_smoke.py use them; no model path does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.raster import SUB_H, SUB_W
from ..render.mesh import angle2matrix

MAX_SPAN = 30  # every face's bbox spans less than 32 px, as binning needs


def _snapped(rng, n, size):
    """Triangles with integer (pixel-centre) corners, one corner on or next
    to the last or first pixel of a sub-tile, the others up to 12 px away:
    their edges run through pixel centres, where edge values can round to
    exactly 0."""
    ax = rng.choice(np.arange(0, size, SUB_W), n) \
        + rng.choice([-1, 0, 1, SUB_W - 1], n)
    ay = rng.choice(np.arange(0, size, SUB_H), n) \
        + rng.choice([-1, 0, 1, SUB_H - 1], n)
    steps = np.array([0, 1, 2, 4, 6, 8, 12])
    d = rng.choice(steps, (n, 2, 2)) * rng.choice([-1, 1], (n, 2, 2))
    a = np.stack([ax, ay], -1).astype(np.float64)
    return np.stack([a, a + d[:, 0], a + d[:, 1]], 1)


def _slivers(rng, n, size):
    """Long thin triangles (2-30 px long, 1e-4 to 0.3 px wide) and tiny ones
    (1e-3 to 0.5 px), some centred on pixel centres."""
    half = n // 2
    p = rng.uniform(0, size, (n, 2))
    p[::3] = np.round(p[::3])
    ang = rng.uniform(0, 2 * np.pi, half)
    length = rng.uniform(2, MAX_SPAN, half)
    width = rng.choice([1e-4, 1e-2, 0.3], half)
    u = np.stack([np.cos(ang), np.sin(ang)], -1)
    perp = np.stack([-u[:, 1], u[:, 0]], -1)
    a = p[:half]
    b = a + u * length[:, None]
    c = a + u * (length * rng.uniform(0, 1, half))[:, None] \
        + perp * width[:, None]
    long_ = np.stack([a, b, c], 1)
    scale = rng.choice([1e-3, 1e-2, 0.1, 0.5], n - half)[:, None, None]
    tiny = p[half:, None] + rng.uniform(-1, 1, (n - half, 3, 2)) * scale
    return np.concatenate([long_, tiny])


def _straddling(rng, n, size):
    """Triangles of 1-12 px around points where sub-tiles or tiles meet, a
    hair or half a pixel off."""
    off = rng.choice([-0.5, -1e-3, 0.0, 1e-3, 0.5], (n, 2))
    cx = rng.choice(np.arange(SUB_W, size, SUB_W), n) - 0.5 + off[:, 0]
    cy = rng.choice(np.arange(SUB_H, size, SUB_H), n) - 0.5 + off[:, 1]
    r = rng.uniform(0.5, 6, (n, 1))
    ang = rng.uniform(0, 2 * np.pi, (n, 3))
    return np.stack([cx, cy], -1)[:, None] \
        + r[..., None] * np.stack([np.cos(ang), np.sin(ang)], -1)


def _dropped(rng, n, size):
    """Faces the prep drops: three corners on a line (integer, so the area
    is exactly 0), a repeated corner, and back-facing triangles."""
    a = rng.integers(0, size, (n, 2)).astype(np.float64)
    d = rng.integers(-6, 7, (n, 2)).astype(np.float64)
    tri = np.stack([a, a + d, a + 2 * d], 1)
    tri[1::3, 2] = tri[1::3, 0]
    back = _straddling(rng, n, size)[2::3]
    front = _area(back) > 0
    back[front] = back[front][:, [0, 2, 1]]
    tri[2::3] = back
    return tri


def _area(tri):
    (x0, y0), (x1, y1), (x2, y2) = (tri[:, k].T for k in range(3))
    return (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)


def adversarial_mesh(n_images, image_size, n_faces, seed):
    """``n_images`` views of ``n_faces`` independent triangles (face f is
    vertices 3f, 3f + 1, 3f + 2), a fifth each snapped, slivers, straddling
    sub-tile borders, dropped, and snapped again with one depth for all
    corners; every face but the dropped ones faces front, and every bbox
    spans less than 32 px. Depths come from 3 levels (so that faces tie)
    or, for the first three kinds, from [9, 11] per corner."""
    rng = np.random.default_rng(seed)
    size = image_size
    kinds = (_snapped, _slivers, _straddling, _dropped, _snapped)
    counts = np.diff(np.linspace(0, n_faces, len(kinds) + 1).astype(int))
    verts = []
    for _ in range(n_images):
        tris, zs = [], []
        for k, (kind, n) in enumerate(zip(kinds, counts)):
            tri = kind(rng, n, size)
            lo = tri.min(1, keepdims=True)
            tri = lo + np.minimum(tri - lo, MAX_SPAN)
            if kind is not _dropped:
                flip = _area(tri) < 0
                tri[flip] = tri[flip][:, [0, 2, 1]]
            if k < 3:
                z = rng.uniform(9, 11, (n, 3))
            else:
                z = np.repeat(rng.choice([9.75, 10.0, 10.25], (n, 1)), 3, 1)
            tris.append(tri)
            zs.append(z)
        tri = np.concatenate(tris).reshape(-1, 2)
        xy = (tri + 0.5) * (2.0 / size) - 1.0   # pixel centre -> [-1, 1]
        verts.append(np.concatenate([xy, np.concatenate(zs).reshape(-1, 1)],
                                    -1))
    verts = np.stack(verts).astype(np.float32)
    faces = np.arange(3 * n_faces, dtype=np.int32).reshape(n_faces, 3)
    attrs = rng.uniform(-1, 1, (1, n_faces, 3, 2)).astype(np.float32)
    return verts, faces, attrs


def _to_verts(tri, z, size):
    """(n, 3, 2) pixel coordinates and (n, 3) depths -> (3n, 3) float32
    vertices with x, y in [-1, 1] (pixel centre p at (p + 0.5) * 2 / size -
    1)."""
    xy = (tri.reshape(-1, 2) + 0.5) * (2.0 / size) - 1.0
    return np.concatenate([xy, z.reshape(-1, 1)], -1).astype(np.float32)


def _nudged(rng, n, size, max_len):
    """(n, 3, 3) float32 vertices of near-degenerate slivers: two corners
    on pixel centres up to ``max_len`` px apart, the third a float32 point
    of the segment between them moved 1-3 ulps off it in x or y, half of
    them wound the other way; depths in [1, 3]. Along the line through such
    a face, an edge function rounded in another form than the reference's
    can pass pixels far outside the face."""
    a = rng.integers(0, size, (n, 2))
    b = a + rng.integers(-max_len, max_len + 1, (n, 2))
    tri = _to_verts(np.stack([a, b, b], 1).astype(np.float64),
                    rng.uniform(1, 3, (n, 3)), size).reshape(n, 3, 3)
    t = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    tri[:, 2, :2] = tri[:, 0, :2] + t * (tri[:, 1, :2] - tri[:, 0, :2])
    axis = rng.integers(0, 2, n)
    for i in range(n):
        for _ in range(rng.integers(1, 4)):
            c = tri[i, 2, axis[i]]
            tri[i, 2, axis[i]] = np.nextafter(c, np.float32(
                rng.choice([-1, 1]) * np.inf))
    flip = rng.random(n) < 0.5
    tri[flip] = tri[flip][:, [0, 2, 1]]
    return tri


def named_sliver():
    """One kept sliver at 64^2 (area 1.9e-6 px^2; pixel-space corners x
    (11, 12.048, 16), y (25, 26.257, 31)). At patch 32 the reference covers
    (row, col) (25, 11) and (31, 16) only; its edges rounded as separate
    products and differences also pass (37, 21), (43, 26) and (61, 41),
    along the line of its long edge. Returns verts (1, 3, 3) float32 and
    faces (1, 3) int32."""
    verts = np.array([[[-0.640625, -0.203125, 1.0],
                       [-0.484375, -0.015625, 1.0],
                       [-0.6078811287879944, -0.1638323813676834, 1.0]]],
                     np.float32)
    return verts, np.array([[0, 2, 1]], np.int32)


def sliver_sweep(n_images, image_size, n_faces, seed):
    """``n_images`` images of ``n_faces`` independent near-degenerate
    slivers (face f is vertices 3f, 3f + 1, 3f + 2; see ``_nudged``), their
    corners up to 40 px apart. Returns verts (B, 3F, 3) float32 and faces
    (F, 3) int32."""
    rng = np.random.default_rng(seed)
    verts = np.stack([_nudged(rng, n_faces, image_size, 40).reshape(-1, 3)
                      for _ in range(n_images)])
    faces = np.arange(3 * n_faces, dtype=np.int32).reshape(n_faces, 3)
    return verts, faces


def _front(tri):
    """``tri`` with its back-facing triangles wound the other way."""
    flip = _area(tri) < 0
    tri[flip] = tri[flip][:, [0, 2, 1]]
    return tri


def _around(rng, n, size, half_w, half_h):
    """Triangles whose corners lie up to ``half_w`` px across and
    ``half_h`` px down from a point of the image."""
    return rng.uniform(0, size, (n, 1, 2)) + np.stack([
        rng.uniform(-half_w, half_w, (n, 3)),
        rng.uniform(-half_h, half_h, (n, 3))], -1)


def zbuffer_mesh(n_images, image_size, n_faces, seed):
    """Seeded input for K5 (the per-face z-buffer), whose stripe is full
    width and whose face kernel culls by column strips and sub-tiles:
    ``n_images`` views of ``n_faces`` independent triangles, a sixth each
    of snapped triangles (``_snapped``: corners on pixel centres and
    sub-tile borders, edges through pixel centres), faces wider than 32 px
    (up to the image's width), faces taller than a stripe of patch 32 (40
    rows; K5 cuts them), faces partly off the image with corners at
    negative coordinates and past the far borders, near-degenerate slivers
    up to half the image long (``_nudged``; some pass the rounded test
    outside their bbox) and snapped faces sharing one depth (ties). All but
    the slivers face front; half the slivers are wound the other way.
    Returns verts (B, 3F, 3) float32 and faces (F, 3) int32."""
    rng = np.random.default_rng(seed)
    size = image_size
    n = np.diff(np.linspace(0, n_faces, 7).astype(int))
    verts = []
    for _ in range(n_images):
        off = rng.uniform(-24, 8, (n[3], 1, 2)) \
            + rng.uniform(0, 24, (n[3], 3, 2))
        off[1::2] = size - 1 - off[1::2]       # past the far borders too
        tris = [_to_verts(_front(tri), rng.uniform(1, 3, (len(tri), 3)),
                          size)
                for tri in (_snapped(rng, n[0], size),
                            _around(rng, n[1], size, size, 6),
                            _around(rng, n[2], size, 8, 60), off)]
        tris.append(_nudged(rng, n[4], size, size // 2).reshape(-1, 3))
        tris.append(_to_verts(_front(_snapped(rng, n[5], size)), np.repeat(
            rng.choice([1.5, 2.0], (n[5], 1)), 3, 1), size))
        verts.append(np.concatenate(tris))
    faces = np.arange(3 * n_faces, dtype=np.int32).reshape(n_faces, 3)
    return np.stack(verts), faces


def four_views(mesh, seed):
    """A jittered expression of ``mesh`` (an ``ObjMesh`` with UVs) through
    the flagship's 4 orthographic views at the init orth scale and shift
    (TriPlaneGenerator.rasterize), with the generator's [0, 2, 1] face
    order and the model's face UVs."""
    rng = np.random.RandomState(seed)
    v = (mesh.verts + rng.randn(*mesh.verts.shape) * 0.002).astype(np.float32)
    tforms = angle2matrix(torch.tensor(
        [(0, 0, 0), (0, 90, 0), (0, -90, 0), (90, 0, 0)],
        dtype=torch.float32)).numpy()
    tv = (np.einsum('pc,vcd->vpd', v * np.float32([1, -1, 1]), tforms)
          + np.float32([0.0, -0.01, -0.01])) * np.float32(5.0)
    tv = (tv * np.float32([1, -1, -1]) + np.float32([0, 0, 10])).astype(
        np.float32)
    faces = mesh.faces[:, [0, 2, 1]].astype(np.int32)
    uv = mesh.verts_uvs[mesh.faces_uvs] * 2 - 1
    uv[..., 1] *= -1
    attrs = uv[None][:, :, [0, 2, 1]].astype(np.float32)
    return tv, faces, attrs
