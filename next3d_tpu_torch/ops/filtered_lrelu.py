"""filtered_lrelu: bias -> up-FIR -> leaky ReLU (+ gain, clamp) -> down-FIR.

Counterpart of next3d_tpu/ops/filtered_lrelu.py (reference semantics:
torch_utils/ops/filtered_lrelu.py, the composition ``_filtered_lrelu_ref``
at :123-140). The JAX package computes it as an XLA composition, not as a
Pallas kernel, so this plain torch composition of the port's ``bias_act``
and ``upfirdn2d`` is the port; it runs in x's dtype, as they do.
"""

from __future__ import annotations

import math

from .bias_act import bias_act
from .upfirdn2d import _parse_padding, upfirdn2d


def filtered_lrelu(x, fu=None, fd=None, b=None, up=1, down=1, padding=0,
                   gain=math.sqrt(2), slope=0.2, clamp=None,
                   flip_filter=False):
    """x: (N, C, H, W); fu, fd: FIR filters from ``setup_filter`` (or None).

    ``padding`` goes to the upsampling pass verbatim, negative values
    included: SG3's layers compute the padding that accounts for both
    filters' supports. Output size:
    (in*up + px0+px1 - (fu-1) - (fd-1) + (down-1)) // down.
    """
    px0, px1, py0, py1 = _parse_padding(padding)
    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=[px0, px1, py0, py1],
                  gain=up ** 2, flip_filter=flip_filter)
    x = bias_act(x, None, act='lrelu', alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x, fd, down=down, flip_filter=flip_filter)
