"""Snapshots: the JAX package's format, version 1, and the reference's
checkpoints.

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
so that a resumed run continues exactly. A training snapshot of the JAX
package carries optax states instead (``train/train_step.py
make_optimizer``: one ``optax.adam`` a network, ``(ScaleByAdamState(count,
mu, nu), EmptyState())``). ``load_snapshot`` unpickles their classes as
``OptaxState`` tuples, so reading one needs no optax, and
``load_optimizer_state`` carries their moments into torch Adam.

``load_any_generator`` also reads the reference's network pickles
(``utils/pkl_import.py``: Next3D and EG3D snapshots, TF-era pickles).
Unpickling can run code, as the reference's own loader does: read only
checkpoints you trust.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

from .pkl_import import RefUnpickler, generator_params, network_data
from .weights import params_to_state_dict


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


class OptaxState(tuple):
    """An instance of an optax state class, unpickled without optax: a
    tuple of its fields in order (optax's states are namedtuples), of a
    class named as optax names it."""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)

    def __repr__(self):
        return f'{type(self).__name__}{tuple.__repr__(self)}'


_OPTAX_STATES = {}


def _optax_state_class(module, name):
    key = f'{module}.{name}'
    if key not in _OPTAX_STATES:
        _OPTAX_STATES[key] = type(name, (OptaxState,), {})
    return _OPTAX_STATES[key]


class _SnapshotUnpickler(RefUnpickler):
    """The reference's unpickler (``utils/pkl_import.py``), with every
    class of optax unpickled as an ``OptaxState``."""

    def find_class(self, module, name):
        if module.split('.')[0] == 'optax':
            return _optax_state_class(module, name)
        return super().find_class(module, name)


def load_snapshot(path):
    """Unpickle a snapshot, or any checkpoint ``load_any_generator``
    reads, without optax."""
    with open(path, 'rb') as f:
        return _SnapshotUnpickler(f).load()


def is_snapshot(data):
    """Whether unpickled ``data`` is a format-1 snapshot."""
    return isinstance(data, dict) and data.get('format_version') == 1


def read_generator(path, key='G_ema'):
    """``(params, init_kwargs, source)`` of the generator in the checkpoint
    at ``path``: a format-1 snapshot's ``params_G_ema``, else its
    ``params_G``, with its ``G_kwargs`` (source 'snapshot'); or a reference
    network pickle's ``key`` network with its ``init_kwargs`` (source
    'reference')."""
    try:
        data = load_snapshot(path)
    except (pickle.UnpicklingError, EOFError, ImportError,
            AttributeError) as e:
        raise ValueError(f'{path} is neither a format-1 snapshot nor a '
                         f'reference network pickle: {e!r}') from e
    if is_snapshot(data):
        cfg = (data.get('config') or {}).get('G_kwargs', {})
        return data['params_G_ema'] or data['params_G'], cfg, 'snapshot'
    data = network_data(data)
    if not isinstance(data, dict) or data.get(key) is None:
        raise ValueError(f'{path} is neither a format-1 snapshot nor a '
                         f'reference network pickle with a {key!r} '
                         f'network')
    return (*generator_params(data, key), 'reference')


def load_any_generator(path, key='G_ema'):
    """Generator params and construction kwargs ``(params, init_kwargs)``
    of a format-1 snapshot or a reference .pkl (``read_generator``)."""
    params, init_kwargs, _ = read_generator(path, key)
    return params, init_kwargs


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


def _optax_adam_moments(saved):
    """``(count, mu, nu)`` of an ``optax.adam`` state as the JAX package's
    ``make_optimizer`` builds it, ``(ScaleByAdamState(count, mu, nu),
    EmptyState())``; ``None`` for any other structure."""
    if not (isinstance(saved, tuple) and len(saved) == 2):
        return None
    adam, lr = saved
    if type(adam).__name__ != 'ScaleByAdamState' or \
            not isinstance(adam, tuple) or len(adam) != 3 or \
            type(lr).__name__ != 'EmptyState' or len(lr) != 0:
        return None
    count, mu, nu = adam
    if not (isinstance(mu, dict) and isinstance(nu, dict)):
        return None
    return count, params_to_state_dict(mu), params_to_state_dict(nu)


def _adam_state_of_optax(saved, named_params):
    """torch Adam's per-parameter state ({name: {step, exp_avg,
    exp_avg_sq}}) from an optax adam state: optax's ``count`` is each
    parameter's ``step``, ``mu`` its ``exp_avg``, ``nu`` its
    ``exp_avg_sq``. optax also keeps moments of the leaves that are not
    trained (the JAX package masks their gradients to zero); they have no
    torch parameter and are left out."""
    moments = _optax_adam_moments(saved)
    if moments is None:
        raise ValueError(
            'this optimizer state is neither the port\'s torch Adam state '
            'nor the optax.adam state (ScaleByAdamState(count, mu, nu), '
            'EmptyState()) of the JAX package\'s make_optimizer; got '
            f'{_describe(saved)}')
    count, mu, nu = moments
    step = np.asarray(count)
    if step.shape != () or not np.issubdtype(step.dtype, np.integer):
        raise ValueError(f'the optax adam count is not an integer scalar: '
                         f'{step.dtype} {step.shape}')
    state = {}
    for name, p in named_params.items():
        for tree, what in ((mu, 'mu'), (nu, 'nu')):
            if name not in tree:
                raise ValueError(f'the optax adam state has no {what} for '
                                 f'the parameter {name!r}')
            if tuple(np.shape(tree[name])) != tuple(p.shape):
                raise ValueError(
                    f'the optax adam {what} of {name!r} has the shape '
                    f'{tuple(np.shape(tree[name]))}, the parameter '
                    f'{tuple(p.shape)}')
        state[name] = {'step': np.float32(step), 'exp_avg': mu[name],
                       'exp_avg_sq': nu[name]}
    return state


def _describe(saved):
    if isinstance(saved, dict):
        return f'a dict with the keys {sorted(map(str, saved))}'
    if isinstance(saved, tuple):
        return (f'a {type(saved).__name__} of '
                f'{[type(x).__name__ for x in saved]}')
    return f'a {type(saved).__name__}'


def load_optimizer_state(optimizer, saved, named_params):
    """Load a saved optimizer state into ``optimizer``, a torch Adam over
    the parameters of ``named_params`` (name -> parameter): the port's own
    (``optimizer_state``), or the JAX package's optax adam state, whose
    moments carry over parameter by parameter under the weight bridge's
    names. Any other structure raises ``ValueError`` with the reason."""
    index = {id(p): i for i, p in enumerate(
        p for group in optimizer.param_groups for p in group['params'])}
    if isinstance(saved, dict) and str(saved.get('kind')) == ADAM:
        saved_state = saved['state']
    else:
        saved_state = _adam_state_of_optax(saved, {
            name: p for name, p in named_params.items() if id(p) in index})
    state = {}
    for name, values in saved_state.items():
        p = named_params[name]
        state[index[id(p)]] = {k: torch.from_numpy(np.array(v)) for k, v
                               in values.items()}
    optimizer.load_state_dict({
        'state': state,
        'param_groups': optimizer.state_dict()['param_groups']})
