"""Fused bias + activation (+ gain, + clamp), as plain torch.

Counterpart of next3d_tpu/ops/bias_act.py (reference semantics:
torch_utils/ops/bias_act.py:54-122). The elementwise chain stays eager
torch: it is not one of the JAX package's Pallas kernels. It runs in x's
dtype, the bias cast to it (JAX :54-59).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class _ActSpec(NamedTuple):
    func: callable
    def_alpha: float
    def_gain: float


activation_funcs = {
    'linear':   _ActSpec(lambda x, alpha: x,                         0.0, 1.0),
    'relu':     _ActSpec(lambda x, alpha: F.relu(x),                 0.0, math.sqrt(2)),
    'lrelu':    _ActSpec(lambda x, alpha: F.leaky_relu(x, alpha),    0.2, math.sqrt(2)),
    'tanh':     _ActSpec(lambda x, alpha: torch.tanh(x),             0.0, 1.0),
    'sigmoid':  _ActSpec(lambda x, alpha: torch.sigmoid(x),          0.0, 1.0),
    'elu':      _ActSpec(lambda x, alpha: F.elu(x),                  0.0, 1.0),
    'selu':     _ActSpec(lambda x, alpha: F.selu(x),                 0.0, 1.0),
    'softplus': _ActSpec(lambda x, alpha: F.softplus(x),             0.0, 1.0),
    'swish':    _ActSpec(lambda x, alpha: torch.sigmoid(x) * x,      0.0, math.sqrt(2)),
}


def bias_act(x, b=None, dim=1, act='linear', alpha=None, gain=None, clamp=None):
    """Add bias along ``dim``, apply activation, scale by gain, clamp."""
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)
    clamp = float(clamp if clamp is not None else -1)

    if b is not None:
        assert b.ndim == 1 and b.shape[0] == x.shape[dim]
        shape = [-1 if i == dim else 1 for i in range(x.ndim)]
        x = x + b.to(x.dtype).reshape(shape)
    x = spec.func(x, alpha)
    if gain != 1:
        if x.dtype in (torch.bfloat16, torch.float16):
            # the JAX package multiplies by the gain rounded to x's dtype
            gain = float(torch.tensor(gain, dtype=x.dtype))
        x = x * gain
    if clamp >= 0:
        x = x.clamp(-clamp, clamp)
    return x
