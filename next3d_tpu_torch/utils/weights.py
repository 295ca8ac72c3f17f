"""The weight bridge: JAX parameter trees into the port's modules.

The JAX package names its parameters by torch ``state_dict`` paths, one
path component per dict level, so flattening a tree with
``params_to_state_dict`` gives the port's state_dict keys. Static FIR
filters are non-persistent buffers that the port builds itself, so they
are neither expected nor loaded.
"""

from __future__ import annotations

import numpy as np
import torch


def params_to_state_dict(params, prefix=''):
    """Flatten a nested parameter tree to dotted names (the port's copy of
    next3d_tpu/utils/pkl_import.py params_to_state_dict)."""
    out = {}
    for k, v in params.items():
        name = f'{prefix}.{k}' if prefix else k
        if isinstance(v, dict):
            out.update(params_to_state_dict(v, name))
        else:
            out[name] = np.asarray(v)
    return out


def load_jax_params(module, params):
    """Load a JAX param tree (nested dicts of numpy arrays) into ``module``.

    Raises on a missing or unexpected key and on a shape mismatch
    (``load_state_dict(strict=True)``). Returns ``module``.
    """
    flat = params_to_state_dict(params)
    state = {k: torch.from_numpy(np.array(v, dtype=np.float32))
             for k, v in flat.items()}
    module.load_state_dict(state, strict=True)
    return module
