"""upfirdn2d: pad -> zero-insert upsample -> FIR filter -> downsample.

Counterpart of next3d_tpu/ops/upfirdn2d.py with the same conventions
(reference semantics: torch_utils/ops/upfirdn2d.py:120-213): ``flip_filter
=False`` is a true convolution, a separable (1-D) filter is an x pass then
a y pass, and the up-1 zeros of the zero insertion follow each sample.

``upfirdn2d`` launches the kernel in ``csrc/upfirdn2d.cu`` for CUDA tensors
and runs ``upfirdn2d_plain`` (the reference's plain torch route: the
zero-inserted, padded map through a depthwise ``conv2d_gradfix``) for CPU
tensors. The kernel does the zero insertion, padding, filter, gain and
downsampling in one pass and writes only the kept outputs, float32 or
bfloat16 with float32 sums, in the plain route's layout (``plain_layout``:
NHWC for a channels-last input at up 1, else NCHW). It runs inside ``_Upfirdn2d``, whose backward is the same
function with the filter flipped, up and down swapped and the padding
transposed (as the reference's CUDA plugin), so every order of derivative
(R1's double backward through D's filters) is the kernel too. The filter
is a constant: the function saves no tensor. Its launches are counted in
``upfirdn2d.launches``, by instance in ``upfirdn2d.launches_by_instance``,
and the 1-D filters filtered in one launch in
``upfirdn2d.separable_one_launch``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build
from .conv2d_gradfix import conv2d


def _parse_scaling(scaling):
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    assert sx >= 1 and sy >= 1
    return int(sx), int(sy)


def _parse_padding(padding):
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = list(padding)
    if len(padding) == 2:
        padx, pady = padding
        padding = [padx, padx, pady, pady]
    padx0, padx1, pady0, pady1 = padding
    return int(padx0), int(padx1), int(pady0), int(pady1)


def get_filter_size(f):
    if f is None:
        return 1, 1
    assert f.ndim in (1, 2)
    return int(f.shape[-1]), int(f.shape[0])


def setup_filter(f, normalize=True, flip_filter=False, gain=1, separable=None):
    """Prepare a FIR filter (reference: upfirdn2d.py:72-116).

    Returns a float32 numpy array: 2-D (non-separable) or 1-D (separable).
    Modules register it as a non-persistent buffer: it is a function of the
    config, never a loaded weight.
    """
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    assert f.ndim in (0, 1, 2) and f.size > 0
    if f.ndim == 0:
        f = f[np.newaxis]
    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    assert f.ndim == (1 if separable else 2)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = np.flip(f, axis=tuple(range(f.ndim)))
    f = f * (gain ** (f.ndim / 2))
    return np.ascontiguousarray(f, dtype=np.float32)


class Resampling(NamedTuple):
    """One call's parameters, each axis apart."""
    upx: int
    upy: int
    downx: int
    downy: int
    padx0: int
    padx1: int
    pady0: int
    pady1: int
    flip_filter: bool
    gain: float


def resampling(up=1, down=1, padding=0, flip_filter=False, gain=1):
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    return Resampling(upx, upy, downx, downy, *_parse_padding(padding),
                      bool(flip_filter), float(gain))


def transposed(p, f, in_hw, out_hw):
    """The parameters whose call on an output's gradient gives the input's
    (reference torch_utils/ops/upfirdn2d.py:182-200): the filter flipped,
    up and down swapped, the padding transposed."""
    fw, fh = get_filter_size(f)
    (ih, iw), (oh, ow) = in_hw, out_hw
    return Resampling(
        p.downx, p.downy, p.upx, p.upy,
        fw - p.padx0 - 1, iw * p.upx - ow * p.downx + p.padx0 - p.upx + 1,
        fh - p.pady0 - 1, ih * p.upy - oh * p.downy + p.pady0 - p.upy + 1,
        not p.flip_filter, p.gain)


def upfirdn2d_plain(x, f, up=1, down=1, padding=0, flip_filter=False,
                    gain=1):
    """The plain torch version on any device: zero insertion, padding and
    a depthwise convolution of the whole map, then every down-th output."""
    assert x.ndim == 4
    if f is None:
        f = torch.ones((1, 1), dtype=torch.float32, device=x.device)
    f = torch.as_tensor(f, dtype=torch.float32, device=x.device)
    assert f.ndim in (1, 2)
    batch_size, num_channels, in_height, in_width = x.shape
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)

    # zero insertion
    x = x.reshape(batch_size, num_channels, in_height, 1, in_width, 1)
    x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
    x = x.reshape(batch_size, num_channels, in_height * upy, in_width * upx)
    # pad (positive) / crop (negative)
    x = F.pad(x, [max(padx0, 0), max(padx1, 0), max(pady0, 0), max(pady1, 0)])
    x = x[:, :, max(-pady0, 0): x.shape[2] - max(-pady1, 0),
          max(-padx0, 0): x.shape[3] - max(-padx1, 0)]

    f = f * (gain ** (f.ndim / 2))
    f = f.to(x.dtype)
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    f = f[None, None].repeat([num_channels, 1] + [1] * f.ndim)
    if f.ndim == 4:
        x = conv2d(x, f, groups=num_channels)
    else:
        x = conv2d(x, f.unsqueeze(2), groups=num_channels)
        x = conv2d(x, f.unsqueeze(3), groups=num_channels)
    return x[:, :, ::downy, ::downx]


# the kernel's instances: a 4x4 filter at (up, down) on both axes, by its
# C index; 0 (``any``) takes every other call
FIXED = {(1, 1): (1, 'up1'), (2, 1): (2, 'up2'), (1, 2): (3, 'down2')}
DTYPES = (torch.float32, torch.bfloat16)
# the most x phases (up / gcd(up, down)) of instance 0's NCHW kernel: a
# warp's lanes hold them
ANY_NCHW_PHASES = 32


def instance(fh, fw, p):
    """(C index, name) of the instance that runs a pass of an (fh, fw)
    filter with parameters ``p``."""
    if (fh, fw) == (4, 4) and p.upx == p.upy and p.downx == p.downy:
        return FIXED.get((p.upx, p.downx), (0, 'any'))
    return 0, 'any'


def is_channels_last(x):
    """Whether ``x``'s strides are channels last and not also NCHW's."""
    return (x.is_contiguous(memory_format=torch.channels_last)
            and not x.is_contiguous())


def plain_layout(x, p):
    """Whether the plain route leaves ``x``'s result channels last: cuDNN
    keeps a channels-last input's layout, but the zero insertion at up > 1
    builds an NCHW map. The kernel writes that layout, so the convolutions
    after it see what they saw on the plain route."""
    return is_channels_last(x) and p.upx == 1 and p.upy == 1


def _pass(x, f, fh, fw, fsx, fsy, p, channels_last, separable=False):
    """One launch: ``f``'s taps as an (fh, fw) filter, tap (i, j) at
    ``f[i * fsy + j * fsx]``, or with ``separable`` the 1-D filter ``f``
    along x then y (``instance`` 0, NCHW); input and output NHWC if
    ``channels_last``, else NCHW."""
    N, C, H, W = x.shape
    x = x.contiguous(memory_format=torch.channels_last if channels_last
                     else torch.contiguous_format)
    oh = (H * p.upy + p.pady0 + p.pady1 - fh) // p.downy + 1
    ow = (W * p.upx + p.padx0 + p.padx1 - fw) // p.downx + 1
    if oh <= 0 or ow <= 0:
        raise ValueError(f'upfirdn2d: no output for input {tuple(x.shape)}, '
                         f'filter ({fh}, {fw}) and {p}')
    out = torch.empty((N, C, oh, ow), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last if channels_last
                      else torch.contiguous_format)
    which, name = (0, 'any') if separable else instance(fh, fw, p)
    lanes = 16 // x.element_size()
    vec = channels_last and C % lanes == 0 and x.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    cuda_build.launch(
        'upfirdn2d', 'upfirdn2d', x.device, x.data_ptr(), out.data_ptr(),
        f.data_ptr(), int(x.dtype == torch.bfloat16), int(channels_last),
        int(vec), which, int(separable), N, C, H, W, oh, ow, p.upx, p.upy,
        p.downx, p.downy, p.padx0, p.pady0, fw, fh, fsx, fsy,
        int(p.flip_filter), p.gain)
    upfirdn2d.launches += 1
    counts = upfirdn2d.launches_by_instance
    counts[name] = counts.get(name, 0) + 1
    upfirdn2d.separable_one_launch += int(separable)
    return out


def upfirdn2d_cuda(x, f, p, channels_last):
    """The kernel on CUDA tensors, its output NHWC if ``channels_last``:
    one launch of a 2-D filter and of an NCHW 1-D one (the x pass's map
    stays in the block's shared memory), two of an NHWC 1-D one (x, then y,
    with the gain on the second). An NCHW call with more x phases than
    ANY_NCHW_PHASES takes the NHWC route on its planes as one-channel
    images, which lie in memory as in NCHW order."""
    if x.ndim != 4 or x.dtype not in DTYPES:
        raise ValueError(f'the kernel takes a 4-D float32 or bfloat16 input, '
                         f'not {x.dtype} {tuple(x.shape)}')
    if f.dtype != torch.float32 or f.ndim not in (1, 2) \
            or f.device != x.device or not f.is_contiguous():
        raise ValueError(f'the kernel takes a contiguous 1-D or 2-D float32 '
                         f'filter on {x.device}')
    if not channels_last and \
            p.upx // math.gcd(p.upx, p.downx) > ANY_NCHW_PHASES:
        N, C, H, W = x.shape
        y = upfirdn2d_cuda(x.reshape(N * C, 1, H, W), f, p, True)
        return y.reshape(N, C, *y.shape[2:])
    if f.ndim == 2:
        fh, fw = f.shape
        return _pass(x, f, fh, fw, 1, fw, p, channels_last)
    taps = f.shape[0]
    if not channels_last:
        return _pass(x, f, taps, taps, 1, 1, p, False, separable=True)
    x = _pass(x, f, 1, taps, 1, 0, p._replace(
        upy=1, downy=1, pady0=0, pady1=0, gain=1.0), channels_last)
    return _pass(x, f, taps, 1, 0, 1, p._replace(
        upx=1, downx=1, padx0=0, padx1=0), channels_last)


def _plain(x, f, p, channels_last=False):
    """``upfirdn2d_plain`` as a ``run`` of ``_Upfirdn2d`` (its layout is
    its own)."""
    return upfirdn2d_plain(x, f, (p.upx, p.upy), (p.downx, p.downy),
                           (p.padx0, p.padx1, p.pady0, p.pady1),
                           p.flip_filter, p.gain)


class _Upfirdn2d(torch.autograd.Function):
    """``run(x, f, p, channels_last)`` under autograd; the backward is this
    function again, on the transposed parameters, so it is differentiable
    to every order. Each gradient takes the plain route's layout of its
    input. The filter is kept as an attribute: nothing is saved."""

    @staticmethod
    def forward(ctx, x, f, p, run, channels_last):
        ctx.f, ctx.p, ctx.run, ctx.in_hw = f, p, run, x.shape[2:]
        ctx.grad_channels_last = plain_layout(x, p)
        return run(x, f, p, channels_last)

    @staticmethod
    def backward(ctx, dy):
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _Upfirdn2d.apply(dy, ctx.f, transposed(
                ctx.p, ctx.f, ctx.in_hw, dy.shape[2:]), ctx.run,
                ctx.grad_channels_last)
        return dx, None, None, None, None


def resample(x, f, p, run):
    """``run`` (``upfirdn2d_cuda`` or ``_plain``) of ``x`` under
    ``_Upfirdn2d``, in the plain route's layout; ``f`` a float32 tensor
    that needs no gradient."""
    if f.requires_grad:
        raise ValueError('upfirdn2d: the filter is a constant')
    return _Upfirdn2d.apply(x, f, p, run, plain_layout(x, p))


def upfirdn2d(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1):
    """x: (N, C, H, W); f: (fh, fw), (taps,) or None; padding is w.r.t. the
    upsampled image and may be negative (crop). The kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if x.device.type == 'cpu':
        return upfirdn2d_plain(x, f, up, down, padding, flip_filter, gain)
    if x.device.type != 'cuda':
        raise ValueError(f'upfirdn2d runs on CPU or CUDA tensors, not '
                         f'{x.device}')
    if f is None:
        f = torch.ones((1, 1), dtype=torch.float32, device=x.device)
    f = torch.as_tensor(f, dtype=torch.float32, device=x.device)
    return resample(x, f, resampling(up, down, padding, flip_filter, gain),
                    upfirdn2d_cuda)


upfirdn2d.launches = 0
upfirdn2d.launches_by_instance = {}
upfirdn2d.separable_one_launch = 0


def filter2d(x, f, padding=0, flip_filter=False, gain=1):
    """Shape-preserving FIR filter (reference: upfirdn2d.py:279-311)."""
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = get_filter_size(f)
    p = [padx0 + fw // 2, padx1 + (fw - 1) // 2,
         pady0 + fh // 2, pady1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1):
    """FIR upsampling (reference: upfirdn2d.py:315-350)."""
    upx, upy = _parse_scaling(up)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = get_filter_size(f)
    p = [padx0 + (fw + upx - 1) // 2, padx1 + (fw - upx) // 2,
         pady0 + (fh + upy - 1) // 2, pady1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1):
    """FIR downsampling (reference: upfirdn2d.py:354-389)."""
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = get_filter_size(f)
    p = [padx0 + (fw - downx + 1) // 2, padx1 + (fw - downx) // 2,
         pady0 + (fh - downy + 1) // 2, pady1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter,
                     gain=gain)
