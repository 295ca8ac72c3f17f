"""Name -> constructor registry.

The port's copy of next3d_tpu/utils/registry.py: an explicit registry in
place of the reference's dotted-name resolution
(``dnnlib.util.construct_class_by_name``, dnnlib/util.py:291-307), with an
importlib fallback for a dotted path, so that configs select a generator by
string. The port's generators register under the JAX package's names
when ``next3d_tpu_torch.models`` is imported; ``resolve`` imports it
before it gives up on a name, so a caller need not.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def resolve(name: str) -> Callable:
    if name not in _REGISTRY:
        importlib.import_module('next3d_tpu_torch.models')
    if name in _REGISTRY:
        return _REGISTRY[name]
    # dotted-path fallback ("pkg.mod.ClassName")
    if "." in name:
        mod_name, _, attr = name.rpartition(".")
        mod = importlib.import_module(mod_name)
        return getattr(mod, attr)
    raise KeyError(f"unknown registered name: {name!r}; known: {sorted(_REGISTRY)}")


def construct_class_by_name(class_name: str, **kwargs) -> Any:
    return resolve(class_name)(**kwargs)
