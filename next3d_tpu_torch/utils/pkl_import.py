"""Read the reference's checkpoints (.pkl) into the port's parameter trees.

The port's copy of next3d_tpu/utils/pkl_import.py. The reference's
snapshots are pickles of torch modules wrapped by
``torch_utils.persistence`` (reference: torch_utils/persistence.py:37-128;
loader legacy.py:24-60): each module's reduce payload carries its source
code, constructor args and state. Running that source needs the
reference's whole stack, so the unpickler here replaces the reconstructor
with a stub that never executes the embedded source and keeps the raw
state; ``state_dict()`` then gives the flat dotted names, and
``utils/weights.py state_dict_to_params`` nests them into the tree that
``load_jax_params`` loads. A TF-era pickle (a ``(G, D, Gs)`` tuple of
tflib Networks) is converted by ``utils/legacy.py``.

The leaves are torch tensors in the released files (the reference pickles
``.cpu()`` copies of its modules; plain ``pickle`` rebuilds them through
torch's own reducers) or numpy arrays; both come out as numpy arrays.
Where the JAX package's reader stops, this one reads on: a network's tree
may hold plain torch modules (``torch.nn.Sequential``) and instances of
the reference's classes that are not persistence-wrapped and so are
pickled by a module name that does not import here; both give their
state.
"""

from __future__ import annotations

import pickle

import numpy as np

from . import easydict
from .legacy import (TFNetworkStub, convert_tf_discriminator,
                     convert_tf_generator, is_tf_legacy_data)
from .weights import state_dict_to_params


class _StubModule:
    """Placeholder for a persistence-wrapped torch module: holds raw state."""

    def __init__(self, meta):
        self.meta = meta
        state = meta.get('state', {}) if isinstance(meta, dict) else {}
        self.__dict__.update(state)

    def state_dict(self, prefix=''):
        """Reassemble the flat dotted tensor dict torch would produce."""
        return _module_state_dict(self, prefix)

    @property
    def init_args(self):
        # persistence stores these inside the module state (__dict__)
        # as _init_args/_init_kwargs (reference: persistence.py:107-118)
        return tuple(self.__dict__.get('_init_args', ()))

    @property
    def init_kwargs(self):
        return dict(self.__dict__.get('_init_kwargs', {}))


def _module_state_dict(module, prefix=''):
    """The flat dotted arrays of a stub module's tree. A child may also be
    a plain torch module, which the reference pickles as it is (the
    decoder's ``torch.nn.Sequential`` and its activations), or a
    ``_StubObject``: its state is walked the same way, as torch's
    ``state_dict`` would, without its non-persistent buffers."""
    state = vars(module)
    non_persistent = state.get('_non_persistent_buffers_set') or ()
    out = {}
    for coll in ('_parameters', '_buffers'):
        for name, t in (state.get(coll) or {}).items():
            if t is not None and not (coll == '_buffers'
                                      and name in non_persistent):
                out[prefix + name] = _to_numpy(t)
    for name, child in (state.get('_modules') or {}).items():
        if child is not None:
            out.update(_module_state_dict(child, prefix + name + '.'))
    return out


def _to_numpy(t):
    if isinstance(t, np.ndarray):
        return t
    try:
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


class _StubObject:
    """An instance of a class of the reference's code whose module does not
    import here: keeps the state it is unpickled with, as ``_StubModule``
    does."""

    reference_name = None

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, tuple):    # (state, slot state)
            state = {**(state[0] or {}), **(state[1] or {})}
        self.__dict__.update(state or {})

    def state_dict(self, prefix=''):
        return _module_state_dict(self, prefix)


_PLAIN_CLASSES = {}


def _plain_class(module, name):
    key = f'{module}.{name}'
    if key not in _PLAIN_CLASSES:
        _PLAIN_CLASSES[key] = type(name, (_StubObject,),
                                   {'reference_name': key})
    return _PLAIN_CLASSES[key]


def _stub_reconstruct(meta):
    return _StubModule(meta)


class RefUnpickler(pickle.Unpickler):
    """Unpickler that neutralizes torch_utils.persistence reconstruction."""

    def find_class(self, module, name):
        if 'persistence' in module and name == '_reconstruct_persistent_obj':
            return _stub_reconstruct
        if module == 'dnnlib.tflib.network' and name == 'Network':
            return TFNetworkStub
        # renamed module paths in old snapshots (reference legacy.py:71-72)
        if 'v13_neural_blending' in module:
            module = module.replace('v13_neural_blending', 'next3d')
        if module.startswith('dnnlib') and name == 'EasyDict':
            return easydict.EasyDict
        # torch tensors rebuild through torch's own reducers
        try:
            return super().find_class(module, name)
        except ImportError:
            # a class of the reference's code that is not persistence-
            # wrapped, pickled by name inside a network's tree: its state
            return _plain_class(module, name)


class ConvertedTFModule:
    """TF-network conversion result with the _StubModule interface."""

    def __init__(self, init_kwargs, state_dict):
        self._init_kwargs = dict(init_kwargs)
        self._state_dict = dict(state_dict)

    def state_dict(self, prefix=''):
        return {prefix + k: v for k, v in self._state_dict.items()}

    @property
    def init_args(self):
        return ()

    @property
    def init_kwargs(self):
        return dict(self._init_kwargs)


def network_data(data):
    """An unpickled reference snapshot as ``load_network_pkl`` returns it:
    a TF-era ``(G, D, Gs)`` tuple converted, the optional keys present."""
    if is_tf_legacy_data(data):
        tf_G, tf_D, tf_Gs = data
        data = {'G': ConvertedTFModule(*convert_tf_generator(tf_G)),
                'D': ConvertedTFModule(*convert_tf_discriminator(tf_D)),
                'G_ema': ConvertedTFModule(*convert_tf_generator(tf_Gs))}
    if isinstance(data, dict):
        data.setdefault('training_set_kwargs', None)
        data.setdefault('augment_pipe', None)
    return data


def load_network_pkl(path):
    """Load a reference snapshot pickle.

    Returns a dict like the reference's (legacy.py:24-60): keys typically
    'G', 'D', 'G_ema', 'augment_pipe', 'training_set_kwargs'; module values
    are ``_StubModule`` with ``.state_dict()`` / ``.init_kwargs``.
    TF-era pickles (a (G, D, Gs) tuple of tflib Networks) are converted via
    utils/legacy.py, matching reference legacy.py:28-33.
    """
    with open(path, 'rb') as f:
        return network_data(RefUnpickler(f).load())


def generator_params(data, key='G_ema'):
    """``load_network_pkl``'s dict -> (params tree, init_kwargs) of the
    network under ``key``."""
    module = data[key]
    return state_dict_to_params(module.state_dict()), dict(module.init_kwargs)


def import_generator_params(pkl_path, key='G_ema'):
    """pkl -> (params tree, init_kwargs) for a generator snapshot."""
    return generator_params(load_network_pkl(pkl_path), key)
