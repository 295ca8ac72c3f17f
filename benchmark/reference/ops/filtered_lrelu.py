"""filtered_lrelu as the plain composition of NVlabs/stylegan3's
``torch_utils/ops/filtered_lrelu.py _filtered_lrelu_ref``: bias, the
up-FIR (zero insertion, padding, filter, at gain up**2), the leaky ReLU
with its gain and clamp, then the down-FIR. The FIR is this package's
``upfirdn2d`` (the zero-inserted, padded map through a depthwise
convolution, then every down-th output); a 1-D filter is separable, an x
pass then a y pass. Float32, as the reference runs.
"""

from __future__ import annotations

import math

from .bias_act import bias_act
from .upfirdn2d import _parse_padding, upfirdn2d


def filtered_lrelu(x, fu=None, fd=None, b=None, up=1, down=1, padding=0,
                   gain=math.sqrt(2), slope=0.2, clamp=None,
                   flip_filter=False):
    """x: (N, C, H, W); fu, fd: the up and down filters (1-D separable or
    2-D taps, or None); ``padding`` [x0, x1, y0, y1] of the upsampled map,
    negative values cropping."""
    px0, px1, py0, py1 = _parse_padding(padding)
    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                  flip_filter=flip_filter)
    x = bias_act(x, None, act='lrelu', alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x, fd, down=down, flip_filter=flip_filter)
