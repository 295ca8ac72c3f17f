"""Checkpoints in the wire formats that the port reads, built in place from
parameter trees, for the tests and chip_smoke.py (no model path uses this
module; the released checkpoints are not in the repository):

- ``write_network_pkl``: a network pickle of the reference's kind, each
  network a ``torch_utils.persistence`` object whose reduce payload is
  ``_reconstruct_persistent_obj(meta)`` with the module's state in
  ``meta['state']`` (reference torch_utils/persistence.py:107-128), its
  ``_parameters`` as torch tensors (the reference pickles ``.cpu()``
  copies of its modules) or numpy arrays, its ``_init_kwargs``, child
  modules under ``_modules``; and the snapshot's other keys
  (``training_set_kwargs``, ``augment_pipe``).
- ``write_jax_snapshot``: a format-1 snapshot as the JAX package's loop
  writes one (next3d_tpu/utils/checkpoint.py save_snapshot), its optimizer
  states ``(ScaleByAdamState(count, mu, nu), EmptyState())`` pickled under
  optax's class names (next3d_tpu/train/train_step.py make_optimizer),
  ``extra`` holding only ``ada_p`` and ``rng_key`` a JAX key.

Pickle finds a class or function by its module's name when it writes it,
so the writers put stand-in modules of those names in ``sys.modules`` for
the duration of the write and take them out again; nothing of the
reference or of optax is imported.
"""

from __future__ import annotations

import collections
import contextlib
import pickle
import sys
import types

import numpy as np
import torch

from .weights import state_dict_to_params


@contextlib.contextmanager
def _stand_in_modules(attrs):
    """``sys.modules`` entries for the dotted module names of ``attrs``
    (module name -> {attribute: object}) and their parents, for the
    duration of the block; what was there before is put back."""
    names = set()
    for name in attrs:
        parts = name.split('.')
        names.update('.'.join(parts[:i + 1]) for i in range(len(parts)))
    saved = {name: sys.modules.get(name) for name in names}
    try:
        for name in sorted(names):
            module = types.ModuleType(name)
            for key, value in attrs.get(name, {}).items():
                setattr(module, key, value)
            sys.modules[name] = module
        yield
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module


def _reconstruct_persistent_obj(meta):
    raise RuntimeError('a stand-in: the reference reconstructs from meta')


_reconstruct_persistent_obj.__module__ = 'torch_utils.persistence'
_PERSISTENCE = {'torch_utils.persistence': {
    '_reconstruct_persistent_obj': _reconstruct_persistent_obj}}


class _Persistent:
    """Pickles as ``torch_utils.persistence._reconstruct_persistent_obj(
    meta)``, the wire format of the reference's networks."""

    def __init__(self, meta):
        self.meta = meta

    def __reduce__(self):
        return (_reconstruct_persistent_obj, (self.meta,))


def module_stub(tree, torch_leaves=True, init_kwargs=None, buffers=None,
                class_name='training.networks.Module'):
    """A parameter tree (nested dicts of arrays) as a persistent module:
    each dict level a child module, each leaf a parameter (a torch tensor,
    or a numpy array with ``torch_leaves=False``); ``buffers`` (dotted
    name -> array) go under the ``_buffers`` of their module."""
    def leaf(value):
        value = np.array(value)
        return torch.from_numpy(value) if torch_leaves else value

    def build(node, bufs, kwargs, name):
        params = collections.OrderedDict()
        children = collections.OrderedDict()
        for k, v in node.items():
            if isinstance(v, dict):
                sub = {b[len(k) + 1:]: x for b, x in bufs.items()
                       if b.startswith(k + '.')}
                children[k] = build(v, sub, {}, k)
            else:
                params[k] = leaf(v)
        own = collections.OrderedDict(
            (b, leaf(x)) for b, x in bufs.items() if '.' not in b)
        state = {'training': False, '_parameters': params,
                 '_buffers': own, '_modules': children,
                 '_init_args': (), '_init_kwargs': dict(kwargs)}
        return _Persistent({'type': 'class', 'version': 6,
                            'module_src': '', 'class_name':
                            f'{class_name}.{name}', 'state': state})

    return build(tree, dict(buffers or {}), init_kwargs or {}, 'root')


def write_network_pkl(path, networks, torch_leaves=True, init_kwargs=None,
                      buffers=None, extra=None):
    """Write ``networks`` (name, such as 'G_ema' or 'D', -> parameter tree
    or None) as a network pickle of the reference's kind at ``path``.
    ``init_kwargs`` and ``buffers`` map a network's name to its own;
    ``extra`` adds keys (``training_set_kwargs`` and ``augment_pipe``
    default to None)."""
    data = {'training_set_kwargs': None, 'augment_pipe': None}
    for name, tree in networks.items():
        data[name] = None if tree is None else module_stub(
            tree, torch_leaves, (init_kwargs or {}).get(name),
            (buffers or {}).get(name))
    data.update(extra or {})
    with _stand_in_modules(_PERSISTENCE), open(path, 'wb') as f:
        pickle.dump(data, f)


def _optax_classes():
    """Stand-ins of optax's adam state classes, named as optax names
    them."""
    adam = collections.namedtuple('ScaleByAdamState', 'count mu nu')
    adam.__module__ = 'optax._src.transform'
    empty = collections.namedtuple('EmptyState', '')
    empty.__module__ = 'optax._src.base'
    return adam, empty


def write_jax_snapshot(path, params_G=None, params_D=None,
                       params_G_ema=None, adam_G=None, adam_D=None,
                       cur_nimg=0, ada_p=0.0, config=None):
    """Write a format-1 snapshot as the JAX package's training loop writes
    one: ``adam_G`` and ``adam_D`` are ``(count, mu, nu)`` of one
    ``optax.adam`` a network (``mu`` and ``nu`` trees of the network's
    parameter tree's shape, ``count`` an int32 scalar), or None."""
    adam, empty = _optax_classes()

    def optax_state(moments):
        if moments is None:
            return None
        count, mu, nu = moments
        return (adam(np.asarray(count, np.int32), mu, nu), empty())

    payload = {
        'format_version': 1, 'params_G': params_G, 'params_D': params_D,
        'params_G_ema': params_G_ema, 'opt_state_G': optax_state(adam_G),
        'opt_state_D': optax_state(adam_D), 'cur_nimg': int(cur_nimg),
        'rng_key': np.array([0, 0], np.uint32), 'config': config,
        'extra': {'ada_p': float(ada_p)}}
    with _stand_in_modules({'optax._src.transform': {
            'ScaleByAdamState': adam}, 'optax._src.base': {
            'EmptyState': empty}}), open(path, 'wb') as f:
        pickle.dump(payload, f)


def adam_moments(optimizer, module):
    """``(count, mu, nu)`` of a torch Adam over ``module``'s trainable
    parameters, as the JAX package's optax adam holds them: trees of the
    module's whole parameter tree (zeros where a leaf is not trained), the
    step count of the last parameter with a state (0 without one)."""
    flat = {k: v.detach().cpu().numpy()
            for k, v in module.state_dict().items()}
    mu = {k: np.zeros_like(v) for k, v in flat.items()}
    nu = {k: np.zeros_like(v) for k, v in flat.items()}
    count = 0
    for name, p in module.named_parameters():
        s = optimizer.state.get(p)
        if s:
            mu[name] = s['exp_avg'].detach().cpu().numpy()
            nu[name] = s['exp_avg_sq'].detach().cpu().numpy()
            count = int(s['step'])
    return count, state_dict_to_params(mu), state_dict_to_params(nu)
