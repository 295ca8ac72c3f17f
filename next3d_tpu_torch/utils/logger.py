"""Logger tee-ing stdout/stderr to a file (reference: dnnlib/util.py:60-127)
+ parameter-count summaries (reference: torch_utils/misc.py:201-269).

Counterpart of next3d_tpu/utils/logger.py: ``Logger`` is a copy;
``count_params`` and ``module_summary`` take the JAX package's nested
param trees (as ``utils/weights.py state_dict_to_params`` gives them, of
numpy arrays or tensors) or an ``nn.Module``.
"""

from __future__ import annotations

import sys

import numpy as np
from torch import nn

from .weights import state_dict_to_params


class Logger:
    """Tee stdout (and optionally stderr) to a log file."""

    def __init__(self, file_name=None, file_mode='w', should_flush=True):
        self.file = open(file_name, file_mode) if file_name else None
        self.should_flush = should_flush
        self.stdout = sys.stdout
        self.stderr = sys.stderr
        sys.stdout = self
        sys.stderr = self

    def write(self, text):
        if len(text) == 0:
            return
        if self.file is not None:
            self.file.write(text)
        self.stdout.write(text)
        if self.should_flush:
            self.flush()

    def flush(self):
        if self.file is not None:
            self.file.flush()
        self.stdout.flush()

    def close(self):
        self.flush()
        if self.file is not None:
            self.file.close()
            self.file = None
        if sys.stdout is self:
            sys.stdout = self.stdout
        if sys.stderr is self:
            sys.stderr = self.stderr


def _tree(params):
    return state_dict_to_params(params.state_dict()) \
        if isinstance(params, nn.Module) else params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def count_params(params):
    """The number of values in a param tree or a module's state dict."""
    return sum(int(np.prod(x.shape)) for x in _leaves(_tree(params)))


def module_summary(name, params, indent=0):
    """Per-submodule parameter counts (substitutes the reference's
    print_module_summary dummy forward, misc.py:201-269: shapes are static
    here so no forward pass is needed)."""
    params = _tree(params)
    lines = []
    total = count_params(params)
    lines.append(f"{' ' * indent}{name:<28s} {total / 1e6:8.2f}M params")
    if isinstance(params, dict):
        for k, v in params.items():
            if isinstance(v, dict) and indent < 2:
                lines.extend(module_summary(k, v, indent + 2))
    return lines
