"""K4: tri-plane bilinear sampling, and its backward with respect to the
planes.

Counterpart of next3d_tpu/render/renderer.py sample_from_planes and of its
TPU kernel next3d_tpu/ops/pallas_triplane.py triplane_sample_tiles. Points
(N, M, 3), scaled by 2 / box_warp, are projected onto the 3 planes and
sampled bilinearly (zeros padding, align_corners=False), giving (N, 3, M, C).

The planes are passed channels-last, (N, 3, H, W, C) contiguous
(``channels_last``), so that one layout pass serves both render passes of a
forward and each tap's channels are one 128 B line. ``triplane_sample``
launches the kernel in ``csrc/triplane_sample.cu`` for CUDA tensors (C = 32
only; any other C raises) and runs the plain ``F.grid_sample`` version for
CPU tensors, which stays differentiable in both arguments.

Planes stored in bfloat16 (the renderer's ``gather_bf16`` option, JAX
render/renderer.py:50-65) take the kernel's bf16 instance: the layout pass
permutes and casts in one pass, the kernel reads 64 B a tap, and it
computes the weights and the 4-tap sums in float32 and writes float32, as
the plain version does on the planes upcast (``triplane_sample_plain``).
The JAX package rounds each product and the sum in bf16 instead. Its
launches are counted apart, in ``triplane_sample.launches_bf16``. Its
backward is the float32 backward kernel below, which reads only the output
gradient and the points, never the planes: it accumulates in float32 and
its result is cast to bf16 once (as autograd of the plain version's upcast
does). Those launches are counted apart too, in
``triplane_sample_backward.launches_bf16``. The JAX package's gradient of
its bf16 gather adds in bf16 instead (the VJP of the gather works in the
table's type).

On the card, when grad mode is on and the planes require grad, the forward
runs inside an autograd function whose backward is the second kernel of
that file (``triplane_sample_backward``). It adds each tap's bilinear
weight times the output gradient into zero-filled channels-last
``grad_planes``, and merges taps before its atomics: a group of lanes
walks a run of ``RUN`` consecutive points and flushes a cell's taps once
the cell changes. ``merge_plain`` models the merge (the tests and
``chip_smoke.py`` use it; no forward or backward path calls it). The
atomics land in no fixed order, so the sums are not bit-reproducible. The
plain version, ``triplane_sample_backward_plain``, is an ``index_add_`` of
the four taps. There is no gradient with respect to the coordinates: no
sample point of the model depends on a parameter (the coarse depths come
from the camera, the fine depths are detached, Greg's points are drawn), so
on the card coordinates that require grad raise.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

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


C_KERNEL = 32  # the channel count the kernel is instantiated for
# the planes' storage types the kernel is instantiated for: C entry point
# and launch counter of each
INSTANCES = {torch.float32: ('triplane_sample', 'launches'),
             torch.bfloat16: ('triplane_sample_bf16', 'launches_bf16')}


def _sample_cuda(planes_cl, coordinates, box_warp):
    N, n_planes, H, W, C = planes_cl.shape
    M = coordinates.shape[1]
    if n_planes != 3 or coordinates.shape != (N, M, 3):
        raise ValueError(f'planes {tuple(planes_cl.shape)} and coordinates '
                         f'{tuple(coordinates.shape)} do not match')
    if C != C_KERNEL:
        raise ValueError(f'the kernel takes {C_KERNEL} channels, not {C}')
    if planes_cl.dtype not in INSTANCES:
        raise ValueError(f'the kernel takes float32 or bfloat16 planes, not '
                         f'{planes_cl.dtype}')
    for name, t, dtype in (('planes', planes_cl, planes_cl.dtype),
                           ('coordinates', coordinates, torch.float32)):
        if t.dtype != dtype or not t.is_contiguous() \
                or t.device != planes_cl.device:
            raise ValueError(f'{name} must be contiguous {dtype} on '
                             f'{planes_cl.device}')
    if planes_cl.data_ptr() % 16:
        raise ValueError('planes must be 16-byte aligned')
    if max(planes_cl.numel(), N * 3 * M * C) >= 2 ** 31:
        raise ValueError('the kernel indexes in 32 bits')
    entry, counter = INSTANCES[planes_cl.dtype]
    out = torch.empty((N, 3, M, C), dtype=torch.float32,
                      device=planes_cl.device)
    cuda_build.launch('triplane_sample', entry, planes_cl.device,
                      planes_cl.data_ptr(), coordinates.data_ptr(),
                      out.data_ptr(), N, M, H, W, C, 2.0 / box_warp)
    setattr(triplane_sample, counter, getattr(triplane_sample, counter) + 1)
    return out


def _taps(coordinates, box_warp, H, W):
    """Per plane image (N * 3) and point: the 4 taps' flat texel indices
    into (N * 3 * H * W) and their bilinear weights, 0 outside the plane;
    each (N * 3, M, 4)."""
    N, M, _ = coordinates.shape
    proj = project_onto_planes((2 / box_warp) * coordinates)  # (N*3, M, 2)
    ix = ((proj[..., 0] + 1) * W - 1) / 2
    iy = ((proj[..., 1] + 1) * H - 1) / 2
    x0, y0 = ix.floor(), iy.floor()
    wx1, wy1 = ix - x0, iy - y0
    xs = torch.stack([x0, x0 + 1, x0, x0 + 1], -1).long()
    ys = torch.stack([y0, y0, y0 + 1, y0 + 1], -1).long()
    w = torch.stack([(1 - wy1) * (1 - wx1), (1 - wy1) * wx1,
                     wy1 * (1 - wx1), wy1 * wx1], -1)
    inside = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    image = torch.arange(N * 3, device=coordinates.device)[:, None, None]
    index = (image * H + ys.clamp(0, H - 1)) * W + xs.clamp(0, W - 1)
    return index, torch.where(inside, w, torch.zeros_like(w))


def triplane_sample_backward_plain(grad_out, coordinates, box_warp, H, W):
    """The plain backward on any device: grad_out (N, 3, M, C) -> the
    planes' gradient (N, 3, H, W, C), each tap's weight times grad_out
    added in by ``index_add_``."""
    N, _, M, C = grad_out.shape
    index, w = _taps(coordinates, box_warp, H, W)
    g = grad_out.reshape(N * 3, M, 1, C) * w[..., None]
    grad = torch.zeros(N * 3 * H * W, C, dtype=grad_out.dtype,
                       device=grad_out.device)
    grad.index_add_(0, index.reshape(-1), g.reshape(-1, C))
    return grad.reshape(N, 3, H, W, C)


# the backward kernel's run length (csrc/triplane_sample.cu kRun)
RUN = 32


def kernel_positions(coordinates, box_warp, H, W):
    """Each point's unnormalized position (ix, iy) on each plane, (N, 3, M)
    float32, rounded as the backward kernel rounds them (each operation
    once, far-out points clamped to [-2, size + 1])."""
    scale = torch.tensor(2.0 / box_warp, dtype=torch.float32)
    c = coordinates.float() * scale.to(coordinates.device)
    gx = torch.stack([c[..., 0], c[..., 0], c[..., 2]], 1)
    gy = torch.stack([c[..., 1], c[..., 2], c[..., 1]], 1)
    return (((gx + 1) * (0.5 * W) - 0.5).clamp(-2, W + 1),
            ((gy + 1) * (0.5 * H) - 0.5).clamp(-2, H + 1))


def _cells(coordinates, box_warp, H, W):
    """Each point's cell on each plane, (N, 3, M) int64 x0 and y0, and its
    float32 weights wx1, wy1, as the backward kernel computes them."""
    ix, iy = kernel_positions(coordinates, box_warp, H, W)
    x0, y0 = ix.floor(), iy.floor()
    return x0.long(), y0.long(), ix - x0, iy - y0


def merge_plain(grad_out, coordinates, box_warp, H, W, run=RUN):
    """The backward kernel's merge in plain torch, on any device.

    grad_out (N, 3, M, C), coordinates (N, M, 3). Per plane, the points are
    cut into runs of ``run`` (counted over all N * M points), each run into
    segments of points that share a cell and an image; a segment's flush
    adds each in-range tap's summed weight times grad_out. Returns
    ``(index, grad, atomics, taps)``: each flush's texel in the flat
    (N * 3 * H * W) planes and its (C,) gradient, the count of atomics to
    grad_planes (a group's float4 atomic a lane on one texel counts once;
    this is the number of flushes), and the count of in-range taps (the
    atomics without the merge). ``index_add_`` of the flushes gives the
    planes' gradient."""
    N, _, M, C = grad_out.shape
    device = grad_out.device
    x0, y0, wx1, wy1 = _cells(coordinates, box_warp, H, W)
    point = torch.arange(N * M, device=device)
    image = point // M
    first = point % run == 0
    index, grad = [], []
    taps = 0
    for p in range(3):
        x, y = x0[:, p].reshape(-1), y0[:, p].reshape(-1)
        key = (image * (H + 4) + y + 2) * (W + 4) + x + 2
        new = first.clone()
        new[1:] |= key[1:] != key[:-1]
        segment = torch.cumsum(new, 0) - 1
        xs = torch.stack([x, x + 1, x, x + 1], 1)
        ys = torch.stack([y, y, y + 1, y + 1], 1)
        inside = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
        taps += int(inside.sum())
        line = ((image[:, None] * 3 + p) * H + ys) * W + xs
        ax, ay = wx1[:, p].reshape(-1, 1), wy1[:, p].reshape(-1, 1)
        wx = torch.cat([1 - ax, ax, 1 - ax, ax], 1)
        wy = torch.cat([1 - ay, 1 - ay, ay, ay], 1)
        # one flush a (segment, in-range tap)
        target = segment[:, None] * 4 + torch.arange(4, device=device)
        g = grad_out[:, p].reshape(N * M, 1, C) * (wy * wx)[..., None]
        ids, where = torch.unique(target[inside], return_inverse=True)
        index.append(torch.zeros_like(ids).scatter_(0, where, line[inside]))
        grad.append(torch.zeros(len(ids), C, dtype=grad_out.dtype,
                                device=device).index_add_(0, where,
                                                          g[inside]))
    index = torch.cat(index)
    return index, torch.cat(grad), len(index), taps


def _backward_cuda(grad_out, coordinates, box_warp, H, W, counter):
    N, _, M, C = grad_out.shape
    if C != C_KERNEL:
        raise ValueError(f'the kernel takes {C_KERNEL} channels, not {C}')
    for name, t in (('grad_out', grad_out), ('coordinates', coordinates)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != grad_out.device:
            raise ValueError(f'{name} must be contiguous float32 on '
                             f'{grad_out.device}')
    if grad_out.data_ptr() % 16:
        raise ValueError('grad_out must be 16-byte aligned')
    if max(N * 3 * H * W * C, grad_out.numel()) >= 2 ** 31:
        raise ValueError('the kernel indexes in 32 bits')
    grad = torch.zeros((N, 3, H, W, C), dtype=torch.float32,
                       device=grad_out.device)
    cuda_build.launch('triplane_sample', 'triplane_sample_backward',
                      grad_out.device, grad_out.data_ptr(),
                      coordinates.data_ptr(), grad.data_ptr(), N, M, H, W, C,
                      2.0 / box_warp)
    setattr(triplane_sample_backward, counter,
            getattr(triplane_sample_backward, counter) + 1)
    return grad


def triplane_sample_backward(grad_out, coordinates, box_warp, H, W,
                             counter='launches'):
    """grad_out (N, 3, M, C), coordinates (N, M, 3) -> the planes' float32
    gradient (N, 3, H, W, C): the kernel on CUDA tensors, its launch
    counted in ``counter``, the plain version on CPU tensors."""
    if grad_out.is_cuda:
        return _backward_cuda(grad_out.contiguous(), coordinates, box_warp,
                              H, W, counter)
    return triplane_sample_backward_plain(grad_out, coordinates, box_warp,
                                          H, W)


class _SampleWithBackward(torch.autograd.Function):
    """K4 with K4's backward; the planes' gradient only, for either
    storage type: float32 planes take the float32 forward, bf16 planes the
    bf16 instance, and both the float32 backward kernel, whose result is
    cast to the planes' type once. On CPU tensors both directions run the
    plain versions."""

    @staticmethod
    def forward(ctx, planes_cl, coordinates, box_warp):
        ctx.save_for_backward(coordinates)
        ctx.box_warp = box_warp
        ctx.size = planes_cl.shape[2:4]
        ctx.dtype = planes_cl.dtype
        if not planes_cl.is_cuda:
            return triplane_sample_plain(planes_cl, coordinates, box_warp)
        return _sample_cuda(planes_cl, coordinates, box_warp)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        coordinates, = ctx.saved_tensors
        grad = triplane_sample_backward(
            grad_out, coordinates, ctx.box_warp, *ctx.size,
            INSTANCES[ctx.dtype][1])
        return grad.to(ctx.dtype), None, None


def triplane_sample(planes_cl, coordinates, box_warp):
    """planes_cl (N, 3, H, W, C), coordinates (N, M, 3) -> (N, 3, M, C)."""
    if not planes_cl.is_cuda:
        return triplane_sample_plain(planes_cl, coordinates, box_warp)
    if torch.is_grad_enabled() and coordinates.requires_grad:
        raise RuntimeError(
            'K4 on the card differentiates with respect to the planes only; '
            'no sample point of the model depends on a parameter (the fine '
            'depths are detached), so coordinates that require grad are a '
            'fault: detach them, or use CPU tensors, whose F.grid_sample '
            'path is differentiable in both arguments')
    if torch.is_grad_enabled() and planes_cl.requires_grad:
        return _SampleWithBackward.apply(planes_cl, coordinates, box_warp)
    return _sample_cuda(planes_cl, coordinates, box_warp)


triplane_sample.launches = 0
triplane_sample.launches_bf16 = 0
triplane_sample_backward.launches = 0
triplane_sample_backward.launches_bf16 = 0
