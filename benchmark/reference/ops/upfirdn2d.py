"""upfirdn2d: pad -> zero-insert upsample -> FIR filter -> downsample.

Counterpart of next3d_tpu/ops/upfirdn2d.py with the same conventions
(reference semantics: torch_utils/ops/upfirdn2d.py:120-213, whose plain
torch route ``_upfirdn2d_ref`` this follows): ``flip_filter=False`` is a true
convolution, a separable (1-D) filter runs as an x pass then a y pass with
gain**(1/2) each, and torch's zero insertion puts the up-1 zeros after each
sample. The filter pass is a depthwise convolution (``conv2d_gradfix``,
which R1 differentiates twice).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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


def upfirdn2d(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1):
    """x: (N, C, H, W); f: (fh, fw), (taps,) or None; padding is w.r.t. the
    upsampled image and may be negative (crop)."""
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
