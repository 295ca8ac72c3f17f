"""The weight bridge between JAX parameter trees and the port's modules.

The JAX package names its parameters by torch ``state_dict`` paths, one
path component per dict level, so flattening a tree with
``params_to_state_dict`` gives the port's state_dict keys, and nesting a
state_dict with ``state_dict_to_params`` gives a JAX tree. Static FIR
filters are non-persistent buffers that the port builds itself, so they
are neither expected nor loaded, and a state_dict that carries them (a
reference checkpoint's) drops them. The bridge carries a reference
checkpoint's state_dict (``utils/pkl_import.py``) and the moments of a JAX
snapshot's optax states (``utils/checkpoint.py``) by the same names.
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


# buffers that are deterministic functions of the config, never parameters
_STATIC_BUFFERS = ('resample_filter', 'up_filter', 'down_filter')


def state_dict_to_params(state_dict):
    """Nest a flat dotted state_dict (torch tensors or arrays) into a tree
    of numpy arrays, one dict level per name component, leaving out the
    static filters (the port's copy of next3d_tpu/utils/pkl_import.py
    state_dict_to_params, with numpy leaves)."""
    params = {}
    for key, value in state_dict.items():
        parts = key.split('.')
        if parts[-1] in _STATIC_BUFFERS:
            continue
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        node[parts[-1]] = np.array(value)
    return params


def load_jax_params(module, params, drop_unexpected=False):
    """Load a JAX param tree (nested dicts of numpy arrays) into ``module``.

    Raises on a missing or unexpected key and on a shape mismatch
    (``load_state_dict(strict=True)``). With ``drop_unexpected``, the keys
    that ``module`` does not have are dropped instead, and their names
    printed: the JAX model reads only the names it needs, so a reference
    checkpoint's extra entries are ignored there too. A missing key or a
    shape that differs still raises. Returns ``module``.
    """
    flat = params_to_state_dict(params)
    if drop_unexpected:
        known = module.state_dict()
        dropped = sorted(k for k in flat if k not in known)
        if dropped:
            print(f'{type(module).__name__}: dropped {len(dropped)} entries '
                  f'it does not have: {dropped}', flush=True)
        flat = {k: v for k, v in flat.items() if k in known}
    state = {k: torch.from_numpy(np.array(v, dtype=np.float32))
             for k, v in flat.items()}
    module.load_state_dict(state, strict=True)
    return module
