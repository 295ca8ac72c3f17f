"""2-D convolution with optional FIR up/downsampling.

Counterpart of next3d_tpu/ops/conv2d_resample.py (reference semantics:
torch_utils/ops/conv2d_resample.py:48-143), with the same padding
arithmetic and ``flip_weight`` convention (True = correlation, as
``F.conv2d``; False = true convolution). Upsampling uses the reference's
transposed-convolution route, which equals the JAX package's zero-inserted
convolution. The convolutions are ``conv2d_gradfix``'s, whose higher-order
derivatives stay convolutions.
"""

from __future__ import annotations

import torch.nn.functional as F

from .conv2d_gradfix import conv2d, conv_transpose2d
from .upfirdn2d import _parse_padding, get_filter_size, upfirdn2d


def _conv2d(x, w, stride=1, padding=(0, 0, 0, 0), groups=1, transpose=False,
            flip_weight=True):
    """Grouped NCHW conv; ``padding`` is (px0, px1, py0, py1), symmetric for
    the transposed form."""
    kh, kw = w.shape[2:]
    if not flip_weight and (kw > 1 or kh > 1):
        w = w.flip([2, 3])
    px0, px1, py0, py1 = padding
    if transpose:
        assert px0 == px1 and py0 == py1
        return conv_transpose2d(x, w, stride=stride, padding=(py0, px0),
                                groups=groups)
    if px0 == px1 and py0 == py1 and px0 >= 0 and py0 >= 0:
        return conv2d(x, w, stride=stride, padding=(py0, px0), groups=groups)
    return conv2d(F.pad(x, [px0, px1, py0, py1]), w, stride=stride,
                  groups=groups)


def conv2d_resample(x, w, f=None, up=1, down=1, padding=0, groups=1,
                    flip_weight=True, flip_filter=False):
    """x: (N, C_in, H, W); w: (C_out, C_in // groups, kh, kw); f from
    ``setup_filter`` (or None); padding w.r.t. the upsampled image."""
    assert x.ndim == 4 and w.ndim == 4
    out_channels, in_channels_per_group, kh, kw = w.shape
    fw, fh = get_filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)

    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    if up == 1 and down == 1:
        return _conv2d(x, w, padding=(px0, px1, py0, py1), groups=groups,
                       flip_weight=flip_weight)

    if down > 1 and up == 1:
        if kw == 1 and kh == 1:
            # 1x1: downsample first, conv after (reference :96-99)
            x = upfirdn2d(x, f, down=down, padding=[px0, px1, py0, py1],
                          flip_filter=flip_filter)
            return _conv2d(x, w, groups=groups, flip_weight=flip_weight)
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1],
                      flip_filter=flip_filter)
        return _conv2d(x, w, stride=down, groups=groups,
                       flip_weight=flip_weight)

    if kw == 1 and kh == 1 and down == 1:
        # 1x1: conv first, upsample after (reference :102-105)
        x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
        return upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1],
                         gain=up ** 2, flip_filter=flip_filter)

    # transposed strided conv, then FIR smoothing (reference :114-131)
    if groups == 1:
        w = w.transpose(0, 1)
    else:
        w = w.reshape(groups, out_channels // groups, in_channels_per_group,
                      kh, kw)
        w = w.transpose(1, 2)
        w = w.reshape(groups * in_channels_per_group, out_channels // groups,
                      kh, kw)
    px0 -= kw - 1
    px1 -= kw - up
    py0 -= kh - 1
    py1 -= kh - up
    pxt = max(min(-px0, -px1), 0)
    pyt = max(min(-py0, -py1), 0)
    x = _conv2d(x, w, stride=up, padding=(pxt, pxt, pyt, pyt), groups=groups,
                transpose=True, flip_weight=not flip_weight)
    x = upfirdn2d(x, f, padding=[px0 + pxt, px1 + pxt, py0 + pyt, py1 + pyt],
                  gain=up ** 2, flip_filter=flip_filter)
    if down > 1:
        x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
    return x
