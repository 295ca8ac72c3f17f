"""Attribute-access dict: the class that a reference checkpoint's
``dnnlib.EasyDict`` values unpickle as (``utils/pkl_import.py``).

The port's copy of next3d_tpu/utils/easydict.py (reference:
dnnlib/util.py:44); configs serialize to JSON.
"""

from __future__ import annotations

import json
from typing import Any


class EasyDict(dict):
    """dict with attribute access. Nested dicts are converted lazily."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(value, dict) and not isinstance(value, EasyDict):
            value = EasyDict(value)
            self[name] = value
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]

    def to_json(self, **kwargs) -> str:
        return json.dumps(self, default=_json_default, **kwargs)

    @classmethod
    def from_json(cls, s: str) -> "EasyDict":
        return _deep_convert(json.loads(s))


def _json_default(obj):
    # numpy scalars / arrays show up in configs occasionally
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return str(obj)


def _deep_convert(obj):
    if isinstance(obj, dict):
        return EasyDict({k: _deep_convert(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_deep_convert(v) for v in obj]
    return obj
