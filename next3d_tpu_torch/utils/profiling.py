"""The port's tracer: named spans over the program's work, and the one
collector class, ``PhaseTimer``.

``span(name)`` marks a stretch of host work, as a context manager or, where
that reads better, as a decorator. A span goes to exactly one place:

- the current collector, if one is installed (``collecting``), as
  ``collector.phase(name)``;
- otherwise a ``torch.profiler.record_function`` range, if a torch profiler
  is recording. The range lies on the profiler's clock beside the device's
  ops of the same trace, so each idle stretch of the device can be put
  down to what the host was doing;
- otherwise nowhere. Off, a span opens no range, records no CUDA event,
  makes no sync and allocates no tensor, so traced code can be captured in
  a CUDA graph.

A collector is any object whose ``phase(name)`` returns a context manager:
the protocol of ``TrainStep.run_phases(timer=)``, which installs its timer
as the current collector for its duration, so that the spans beneath it
(the loss, the generator, the renderer) reach the same collector.

Names: the program's spans are dotted. The generator's calls are
``G.mapping``, ``G.synthesis`` and ``G.synthesis_from_identity``; its
stages ``G.<stage>`` (``G.backbones``, ``G.raster``, ``G.mouth_blend``,
``G.plane_mix``, ``G.render``, ``G.sr``) tile the last two, and their
parts are ``G.<stage>.<part>``; each read of the device's data by the
host, or copy to it, that waits for the device (a host sync) is
``sync.<site>``. StyleGAN3's are ``SG3.mapping``, ``SG3.synthesis`` and its
stages ``SG3.input`` and ``SG3.layer``, a layer's ``SG3.conv`` and
``SG3.flrelu`` (``.up``, ``.act``, ``.down``). The training phases are not
dotted: ``<phase>``
(``Gmain``, ``Greg``, ``Dmain``, ``Dreg``, ``G_ema``) and
``<phase>/<part>`` (``forward``, ``backward``, ``update``, ``w_avg``,
``allreduce``).
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict

import torch

_profiling = torch._C._autograd._profiler_enabled
_collector = None


class _Named:
    """What ``span`` gives: a context manager of one name that is also a
    decorator of that name. Off, it does nothing; ``cm`` is the range or the
    collector's phase it enters when on."""

    __slots__ = ('name', 'cm')

    def __init__(self, name, cm=None):
        self.name = name
        self.cm = cm

    def __enter__(self):
        if self.cm is not None:
            return self.cm.__enter__()

    def __exit__(self, *exc):
        if self.cm is not None:
            return self.cm.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


# one object a name for the off path, so that it allocates nothing
_OFF = {}


def _off(name):
    off = _OFF.get(name)
    if off is None:
        off = _OFF[name] = _Named(name)
    return off


def _range_or_off(name):
    """A profiler range while a torch profiler records, else nothing."""
    if _profiling():
        return _Named(name, torch.profiler.record_function(name))
    return _off(name)


def span(name):
    """The span ``name``: to the current collector, else a profiler range
    while a profiler records, else nothing (module docstring)."""
    c = _collector
    if c is not None:
        return _Named(name, c.phase(name))
    # ``_range_or_off`` inlined: the off path is paid on every span
    if _profiling():
        return _Named(name, torch.profiler.record_function(name))
    off = _OFF.get(name)
    return off if off is not None else _off(name)


@contextlib.contextmanager
def collecting(collector):
    """Install ``collector`` as the current one for the block; None leaves
    the current one in place."""
    global _collector
    if collector is None:
        yield
        return
    saved, _collector = _collector, collector
    try:
        yield
    finally:
        _collector = saved


class PhaseTimer:
    """The collector of the train command: the synchronized wall time of
    each training phase and part (``<phase>``, ``<phase>/<part>``), whose
    means ``report()`` gives as ``Timing/<name>``. It times only those
    names: a dotted span (the generator's, a sync's) reaching it goes on to
    the profiler while one records, and adds no sync."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self._totals = defaultdict(float)
        self._counts = defaultdict(int)

    def _sync(self):
        if self.device is not None and self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def phase(self, name):
        if '.' in name:
            return _range_or_off(name)
        return self._timed(name)

    @contextlib.contextmanager
    def _timed(self, name):
        with _range_or_off(name):
            self._sync()
            start = time.perf_counter()
            try:
                yield
            finally:
                self._sync()
                self._totals[name] += time.perf_counter() - start
                self._counts[name] += 1

    def report(self, prefix='Timing/'):
        return {f'{prefix}{k}': self._totals[k] / max(self._counts[k], 1)
                for k in self._totals}

    def reset(self):
        self._totals.clear()
        self._counts.clear()
