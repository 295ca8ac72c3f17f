"""What every cell shares: the files found by name, the device, the
measured window, the spans of a traced run, the profiler's trace and the
result line.

Nothing here knows a model. A cell's kind (``benchmark/kinds/<kind>.py``,
named by its traffic file's ``kind``) builds the program, runs one unit of
work at a time, keeps what the check compares and names the shapes the
rooflines count; the per-layer readers (``benchmark/metrics/<name>.py``)
turn a ``Record`` into numbers.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import re
import sys
import tempfile
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no process of the benchmark may hold
BANNED = ('jax', 'jaxlib', 'flax', 'next3d_tpu')


class UnknownName(KeyError):
    pass


def load_json(path):
    with open(path) as f:
        return json.load(f)


def spec():
    return load_json(ROOT / 'BENCHMARK.json')


def find(kind, name, suffix='.json'):
    """``benchmark/<kind>/<name><suffix>``; an unknown name raises."""
    path = HERE / kind / f'{name}{suffix}'
    if not path.is_file():
        raise UnknownName(f'no {kind} named {name!r} ({path} does not '
                          f'exist)')
    return path


def workload(name, bench=None):
    """(the cell's entry, its config entry) in BENCHMARK.json."""
    bench = bench or spec()
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise UnknownName(f'no workload named {name!r}; BENCHMARK.json has '
                          f'{sorted(cells)}')
    cell = cells[name]
    configs = {c['name']: c for c in bench['configs']}
    return cell, configs[cell['config']]


def config(name):
    return load_json(find('configs', name))


def traffic(name):
    return load_json(find('traffic', name))


def limits(cell_name):
    return load_json(find('limits', cell_name))


def kind_module(kind):
    find('kinds', kind, '.py')
    return importlib.import_module(f'benchmark.kinds.{kind}')


def reader(metric):
    """The per-layer reader ``benchmark/metrics/<metric>.py`` (the names
    hold dots, so it is loaded from its path)."""
    path = find('metrics', metric, '.py')
    module_name = 'benchmark.metrics.' + metric.replace('.', '_')
    loaded = sys.modules.get(module_name)
    if loaded is not None:
        return loaded
    module_spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(module_spec)
    sys.modules[module_name] = module
    module_spec.loader.exec_module(module)
    return module


def load_attr(path):
    """'package.module:Name' -> the object."""
    module, _, attr = path.partition(':')
    return getattr(importlib.import_module(module), attr)


def banned_modules():
    """The loaded modules whose top-level name is one of BANNED, compared
    whole (``next3d_tpu_torch`` is not ``next3d_tpu``)."""
    return sorted({name for name in sys.modules
                   if name.split('.', 1)[0] in BANNED})


def set_caches():
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own kernel build already lies in ``next3d_tpu_torch/csrc/
    build/``)."""
    cache = ROOT / '.bench_cache'
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')


@contextlib.contextmanager
def tf32(on):
    """float32 matrix products and convolutions in TF32 (``on``) or not,
    for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def set_precision(cfg):
    """The configuration's float32 arithmetic: TF32 as it states."""
    tf32 = bool(cfg.get('tf32', False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


class Ctx:
    """One run of one cell: its files, seed and device."""

    def __init__(self, cell, cfg, mix, seed, device, seconds=10, trace=False,
                 lim=None):
        self.cell = cell
        self.cfg = cfg
        self.mix = mix
        self.seed = seed
        self.device = torch.device(device)
        self.seconds = seconds
        self.trace = trace
        self.limits = lim or {}

    @property
    def cuda(self):
        return self.device.type == 'cuda'

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)


# ------------------------------------------------------------------ spans
class Spans:
    """Named spans: a ``torch.profiler.record_function`` and a pair of
    CUDA events each. ``ms()`` gives each name's summed milliseconds once
    the device has finished."""

    def __init__(self, cuda):
        self.cuda = cuda
        self.open = []
        self.done = []

    def enter(self, name):
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        ev = torch.cuda.Event(enable_timing=True) if self.cuda else None
        if ev is not None:
            ev.record()
        self.open.append((name, rf, ev))

    def exit(self, name):
        for k in range(len(self.open) - 1, -1, -1):
            if self.open[k][0] == name:
                _, rf, ev = self.open.pop(k)
                end = torch.cuda.Event(enable_timing=True) if self.cuda \
                    else None
                if end is not None:
                    end.record()
                rf.__exit__(None, None, None)
                self.done.append((name, ev, end))
                return

    def phase(self, name):
        """A context manager: the training step's ``timer.phase``."""
        spans = self

        class _Phase:
            def __enter__(self):
                spans.enter(name)

            def __exit__(self, *exc):
                spans.exit(name)
        return _Phase()

    def ms(self):
        out = {}
        for name, start, end in self.done:
            if start is not None:
                out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


def _resolve(root, path):
    obj = root
    for part in path.split('.'):
        obj = getattr(obj, part, None)
        if obj is None:
            return None, None
    owner = root
    for part in path.split('.')[:-1]:
        owner = getattr(owner, part)
    return owner, obj


class _Spanned:
    """A callable spanned on each call; its other attributes are the
    wrapped object's."""

    def __init__(self, fn, stage, spans):
        self._fn, self._stage, self._spans = fn, stage, spans

    def __call__(self, *args, **kwargs):
        self._spans.enter(self._stage)
        try:
            return self._fn(*args, **kwargs)
        finally:
            self._spans.exit(self._stage)

    def __getattr__(self, name):
        return getattr(self._fn, name)


def install_spans(model, points, spans):
    """Span ``stage`` around each attribute path of ``points`` ({stage:
    [path, ...]}) of ``model``: forward pre- and post-hooks on a module, a
    wrapper on the instance for any other callable (a method or the
    renderer object). A path the model lacks is skipped. Returns a
    function that removes them all."""
    undo = []
    for stage, paths in points.items():
        for path in paths:
            owner, obj = _resolve(model, path)
            if obj is None:
                continue
            if isinstance(obj, torch.nn.Module):
                h1 = obj.register_forward_pre_hook(
                    lambda m, a, s=stage: spans.enter(s))
                h2 = obj.register_forward_hook(
                    lambda m, a, o, s=stage: spans.exit(s))
                undo += [h1.remove, h2.remove]
                continue
            name = path.rsplit('.', 1)[-1]
            had = name in vars(owner)
            object.__setattr__(owner, name, _Spanned(obj, stage, spans))
            undo.append(
                (lambda o=owner, n=name, f=obj: object.__setattr__(o, n, f))
                if had else
                (lambda o=owner, n=name: object.__delattr__(o, n)))

    def remove():
        for fn in reversed(undo):
            fn()
    return remove


# ----------------------------------------------------------------- trace
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
NAME_CHARS = 160  # a device op's name as the breakdown gives it


def read_trace(prof):
    """The profiler's trace as plain lists: device ops [(name, start_us,
    end_us)], the host's spans and ops [(cat, name, start_us, end_us)].
    The trace goes through a file in TMPDIR, deleted at once."""
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get('traceEvents', [])
    finally:
        os.unlink(path)
    device, host = [], []
    for e in events:
        if e.get('ph') != 'X' or 'dur' not in e:
            continue
        cat = e.get('cat', '')
        start = float(e['ts'])
        end = start + float(e['dur'])
        if cat in DEVICE_CATS:
            device.append((e.get('name', ''), start, end))
        elif cat in ('user_annotation', 'cpu_op'):
            host.append((cat, e.get('name', ''), start, end))
    return device, host


def union_s(intervals):
    """Seconds covered by the union of (start_us, end_us) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def gaps(device, host, start_us, end_us, top=10):
    """The longest idle stretches of the device inside [start, end], each
    named by the innermost span and host op open when it began."""
    ivs = sorted((s, e) for _, s, e in device)
    out, t = [], start_us
    for s, e in ivs + [(end_us, end_us)]:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    out.sort(key=lambda g: g[0] - g[1])

    def label(at):
        span = min((h for h in host if h[0] == 'user_annotation'
                    and h[2] <= at < h[3]), key=lambda h: h[3] - h[2],
                   default=None)
        op = min((h for h in host if h[0] == 'cpu_op'
                  and h[2] <= at < h[3]), key=lambda h: h[3] - h[2],
                 default=None)
        return (f"{span[1] if span else 'outside spans'}: "
                f"{op[1] if op else 'host'}")
    return [[label(s), (e - s) * 1e-6] for s, e in out[:top]]


class Record:
    """What a run leaves for the per-layer readers."""

    def __init__(self):
        self.rate = None            # units a second over the window
        self.units_s = None         # seconds a unit over the window
        self.batch = None           # images a unit
        self.span_units = 0         # units in the spans' stretch
        self.span_ms = {}           # {stage: summed ms in that stretch}
        self.prof_units = 0         # units in the profiled stretch
        self.window_s = None        # the profiled stretch's seconds
        self.device_ops = []        # [(name, start_us, end_us)]
        self.host = []              # [(cat, name, start_us, end_us)]
        self.shapes = {}            # the roofline's shapes a unit
        self.flops_per_unit = None  # counted on the reference

    def kernel_s(self, pattern):
        """Summed seconds and count of the device ops whose name matches
        the regular expression ``pattern``."""
        rx = re.compile(pattern)
        durs = [(e - s) * 1e-6 for n, s, e in self.device_ops
                if rx.search(n)]
        return sum(durs), len(durs)

    def busy_s(self):
        return union_s([(s, e) for _, s, e in self.device_ops])


def top_ops(device, top=10):
    by = {}
    for name, s, e in device:
        by[name] = by.get(name, 0.0) + (e - s) * 1e-6
    return [[n[:NAME_CHARS], t] for n, t in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def card_line():
    """``nvidia-smi``'s name and power limit of the card, or None."""
    import subprocess
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def now():
    return time.perf_counter()
