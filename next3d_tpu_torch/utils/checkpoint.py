"""Inference snapshots: the JAX package's format, version 1.

Counterpart of next3d_tpu/utils/checkpoint.py save_snapshot, load_snapshot
and load_any_generator. A snapshot is a pickle of a dict: ``format_version``
1, the parameter trees (``params_G``, ``params_D``, ``params_G_ema``) and
optimizer states as nested dicts of numpy arrays, ``cur_nimg``,
``rng_key``, ``config`` and ``extra``; ``config`` is also written as JSON
beside it. A tree of the port's weights is ``utils.weights
state_dict_to_params(module.state_dict())``, and ``utils.weights
load_jax_params`` loads one, so the two packages read each other's
snapshots.

A training snapshot of the port also carries both optimizers' states as
``optimizer_state`` gives them (``kind`` 'torch.optim.Adam', each moment
under its parameter's name), and the loop's generator and sampler state,
so that a resumed run continues exactly. The JAX package's optax states
have another structure: ``load_optimizer_state`` raises for them rather
than restart the moments.

Reading the original Next3D's .pkl checkpoints (the JAX package's
``pkl_import``) is not ported: ``load_any_generator`` raises
``NotImplementedError`` for any file that is not a format-1 snapshot.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch


def _to_numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy_tree(v) for v in tree)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_snapshot(path, *, params_G=None, params_D=None, params_G_ema=None,
                  opt_state_G=None, opt_state_D=None, cur_nimg=0,
                  rng_key=None, config=None, extra=None):
    payload = {
        'format_version': 1,
        'params_G': _to_numpy_tree(params_G),
        'params_D': _to_numpy_tree(params_D),
        'params_G_ema': _to_numpy_tree(params_G_ema),
        'opt_state_G': _to_numpy_tree(opt_state_G),
        'opt_state_D': _to_numpy_tree(opt_state_D),
        'cur_nimg': int(cur_nimg),
        'rng_key': np.asarray(rng_key) if rng_key is not None else None,
        'config': config,
        'extra': extra,
    }
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)
    if config is not None:
        with open(os.path.splitext(path)[0] + '.json', 'w') as f:
            json.dump(config, f, indent=2, default=str)


def load_snapshot(path):
    with open(path, 'rb') as f:
        return pickle.load(f)


def load_any_generator(path, key='G_ema'):
    """Generator params and construction kwargs ``(params, G_kwargs)`` of a
    format-1 snapshot: ``params_G_ema``, else ``params_G``. ``key`` names
    the network of a reference .pkl, whose reader is not ported."""
    try:
        snap = load_snapshot(path)
    except (pickle.UnpicklingError, EOFError, ImportError, AttributeError):
        snap = None     # not a pickle, or one whose classes do not load here
    if isinstance(snap, dict) and snap.get('format_version') == 1:
        cfg = (snap.get('config') or {}).get('G_kwargs', {})
        return snap['params_G_ema'] or snap['params_G'], cfg
    raise NotImplementedError(
        f'{path} is not a format-1 snapshot; reading the reference .pkl '
        f'checkpoints (network {key!r}) is not ported yet (ROADMAP.md Queue '
        f'1 item 1: the reference-.pkl branch of load_any_generator)')


ADAM = 'torch.optim.Adam'


def optimizer_state(optimizer, named_params):
    """A torch Adam's state as a tree of numpy arrays, keyed by the names of
    ``named_params`` (name -> parameter, the optimizer's parameters)."""
    names = {id(p): name for name, p in named_params.items()}
    state = {}
    for p, s in optimizer.state.items():
        state[names[id(p)]] = {k: v.detach().cpu().numpy()
                               for k, v in s.items()}
    return {'kind': ADAM, 'state': state}


def load_optimizer_state(optimizer, saved, named_params):
    """Load ``optimizer_state``'s tree into ``optimizer`` (a torch Adam over
    the parameters of ``named_params``). Any other structure, an optax
    state of the JAX package among them, raises: carrying its moments into
    torch Adam is not ported (ROADMAP.md Queue 1 item 5)."""
    if not isinstance(saved, dict) or str(saved.get('kind')) != ADAM:
        raise NotImplementedError(
            'this optimizer state is not the port\'s torch Adam state (a '
            'JAX snapshot holds optax states); loading it into torch Adam '
            'is not ported (ROADMAP.md Queue 1 item 5): warm-start from its '
            'parameters instead')
    index = {id(p): i for i, p in enumerate(
        p for group in optimizer.param_groups for p in group['params'])}
    state = {}
    for name, values in saved['state'].items():
        p = named_params[name]
        state[index[id(p)]] = {k: torch.from_numpy(np.array(v)) for k, v
                               in values.items()}
    optimizer.load_state_dict({
        'state': state,
        'param_groups': optimizer.state_dict()['param_groups']})
