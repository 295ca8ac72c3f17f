"""Tracing / profiling utilities.

Counterpart of next3d_tpu/utils/profiling.py: the reference's torch
profiler ranges and phase timing (record_function ranges at
training_loop.py:314,349,374 and the loss's phase scopes; wall-clock
Timing/<phase> stats at training_loop.py:264-269,495-500). ``scope`` is
``torch.profiler.record_function``, so a ``torch.profiler`` trace shows the
phase structure; ``PhaseTimer`` measures host wall-clock, synchronizing
the device of ``block_on`` before it stops the clock; ``trace`` writes a
Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


def scope(name: str):
    """A named range around a model stage in profiler traces."""
    return torch.profiler.record_function(name)


def _synchronize(tree):
    """Wait for the devices of the tensors in ``tree`` (a tensor or nested
    lists, tuples and dicts of them)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            _synchronize(x)
    elif isinstance(tree, torch.Tensor) and tree.device.type == 'cuda':
        torch.cuda.synchronize(tree.device)


class PhaseTimer:
    """Wall-clock phase timing; report() yields Timing/<phase> means."""

    def __init__(self):
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self._totals[name] += time.perf_counter() - start
            self._counts[name] += 1

    def report(self, prefix='Timing/'):
        return {f'{prefix}{k}': self._totals[k] / max(self._counts[k], 1)
                for k in self._totals}

    def reset(self):
        self._totals.clear()
        self._counts.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the CPU, and the card
    where there is one) and write ``<log_dir>/trace.json``, a Chrome trace
    (chrome://tracing, Perfetto). Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))
