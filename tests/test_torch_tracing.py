"""The port's tracer (``utils/profiling.py``), its spans in the generators
and the training step, and the benchmark's readers of them. No JAX.

- Off (no collector, no profiler recording), a span runs no torch op,
  opens no profiler range, records no CUDA event, makes no sync and calls
  no collector.
- Under a CPU ``torch.profiler``, a small flagship and texture variant show
  their ``G.*`` spans, and the top-level stages cover at least 99% of
  ``synthesis`` and ``synthesis_from_identity``.
- The train command hands its timer each phase and its parts in order,
  Greg and Dreg where they are due, and its ``Timing/`` keys are a
  superset of those it reported before the parts existed.
- The readers of ``benchmark/metrics`` give known values on a hand-built
  ``harness.Record``, and nothing on a record without the program's spans.
- On the card (``cuda``): over one reenact frame and one synth batch, the
  ``sync.*`` spans are as many as the syncs that
  ``torch.cuda.set_sync_debug_mode('warn')`` reports, and each sync lies in
  one.
"""

import json
import math
import warnings

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark import harness
from next3d_tpu_torch.cli import main as cli
from next3d_tpu_torch.cli.common import camera_label
from next3d_tpu_torch.models.triplane_next3d import TriPlaneGenerator
from next3d_tpu_torch.models.triplane_texture import TriPlaneTextureGenerator
from next3d_tpu_torch.render import camera_utils
from next3d_tpu_torch.train import training_loop
from next3d_tpu_torch.utils.profiling import PhaseTimer, collecting, span
from next3d_tpu_torch.utils.synthetic_head import (save_dataset, save_head,
                                                   synthetic_head)

# autouse: one torch thread
from torch_parity import one_thread_module  # noqa: F401

RK = dict(ray_start=2.25, ray_end=3.3, box_warp=1.0, depth_resolution=8,
          depth_resolution_importance=8, disparity_space_sampling=False,
          clamp_mode='softplus', c_gen_conditioning_zero=False, c_scale=1.0,
          superresolution_module='SuperresolutionHybrid2X',
          superresolution_noise_mode='none', sr_antialias=True)
CFG = dict(z_dim=16, c_dim=25, w_dim=512, img_resolution=128, img_channels=3,
           rendering_kwargs=RK, channel_base=1024, channel_max=32,
           plane_resolution=64)
STAGES = ('G.backbones', 'G.raster', 'G.mouth_blend', 'G.plane_mix',
          'G.render', 'G.sr')
PARTS = ('G.raster.project', 'G.raster.kernel', 'G.raster.sample',
         'G.render.rays', 'G.render.coarse', 'G.render.importance',
         'G.render.fine', 'G.render.composite')
FLAGSHIP_PARTS = ('G.raster.flood', 'G.mouth_blend.crop',
                  'G.mouth_blend.mouth', 'G.mouth_blend.paste',
                  'G.mouth_blend.blend', 'sync.mouth_boxes',
                  'sync.flood_round')


class Recorder:
    """A collector that keeps each name it receives and the stack of
    those open."""

    def __init__(self):
        self.names = []
        self.open = []

    def phase(self, name):
        rec = self

        class _Phase:
            def __enter__(self):
                rec.names.append(name)
                rec.open.append(name)

            def __exit__(self, *exc):
                rec.open.pop()
        return _Phase()


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


# ------------------------------------------------------------------ tracer
def test_span_off_does_nothing(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, 'record_function',
                        lambda *a: calls.append(('range', a)))
    monkeypatch.setattr(torch.cuda, 'Event',
                        lambda *a, **k: calls.append(('event', a)))
    monkeypatch.setattr(torch.cuda, 'synchronize',
                        lambda *a: calls.append(('sync', a)))
    gone = Recorder()
    with collecting(gone):
        pass

    @span('G.decorated')
    def fn(x):
        return x + 1

    with _Ops() as mode:
        for _ in range(3):
            with span('G.raster'):
                with span('sync.flood_round'):
                    pass
        assert fn(1) == 2
    assert calls == [] and mode.ops == [] and gone.names == []
    # the off path hands back one object a name
    assert span('G.raster') is span('G.raster')


def test_span_goes_to_the_collector_else_the_profiler():
    rec = Recorder()

    @span('G.decorated')
    def fn():
        with span('G.inner'):
            return list(rec.open)

    with collecting(rec):
        with span('G.outer'):
            assert fn() == ['G.outer', 'G.decorated', 'G.inner']
        with collecting(None):     # None leaves the current collector
            with span('Gmain'):
                pass
    assert rec.names == ['G.outer', 'G.decorated', 'G.inner', 'Gmain']
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span('G.outer'):
            fn()
    names = [e.name for e in prof.events()]
    assert {'G.outer', 'G.decorated', 'G.inner'} <= set(names)
    assert rec.names == ['G.outer', 'G.decorated', 'G.inner', 'Gmain']


# ------------------------------------------------------------- generators
@pytest.fixture(scope='module')
def generators():
    mesh, lms = synthetic_head()
    out = {}
    for cls in (TriPlaneGenerator, TriPlaneTextureGenerator):
        G = cls(topology_path=mesh, generator=torch.Generator().manual_seed(0),
                **CFG).eval().requires_grad_(False)
        out[cls.__name__] = G
    v = torch.from_numpy(np.concatenate([mesh.verts, lms])[None]
                         .astype(np.float32))
    cam = camera_utils.lookat_pose(math.pi / 2 + 0.2, math.pi / 2,
                                   torch.tensor([0., 0., 0.2]), radius=2.7,
                                   batch_size=1, device='cpu')
    K = torch.as_tensor(np.asarray(camera_utils.fov_to_intrinsics(18.837)),
                        dtype=torch.float32)
    c = torch.cat([cam.reshape(1, 16), K.reshape(1, 9)], 1)
    z = torch.from_numpy(np.random.RandomState(0).randn(1, 16)
                         .astype(np.float32))
    return out, z, c, v


def _user_spans(prof):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU
            and (e.name.startswith(('G.', 'sync.')) or e.name == 'CALL')]


@pytest.mark.parametrize('model', ['TriPlaneGenerator',
                                   'TriPlaneTextureGenerator'])
@pytest.mark.parametrize('call', ['synthesis', 'synthesis_from_identity'])
def test_generator_spans_tile_the_call(generators, model, call):
    nets, z, c, v = generators
    G = nets[model]
    with torch.no_grad():
        ws = G.mapping(z, c)
        identity = G.build_identity(ws, noise_mode='const')

        def run():
            if call == 'synthesis':
                return G.synthesis(ws, c, v, noise_mode='const')
            return G.synthesis_from_identity(ws, *identity, c, v,
                                             noise_mode='const')
        run()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function('CALL'):
                run()
    spans = _user_spans(prof)
    names = {n for n, _, _ in spans}
    stages = STAGES if call == 'synthesis' else STAGES[1:]
    if model == 'TriPlaneTextureGenerator':
        stages = tuple(s for s in stages if s != 'G.mouth_blend')
        want = set(stages) | set(PARTS) | {'G.raster.interpolate'}
    else:
        want = set(stages) | set(PARTS) | set(FLAGSHIP_PARTS)
    assert want | {f'G.{call}'} <= names, sorted(want - names)
    assert 'G.mapping' not in names
    (_, start, end), = [s for s in spans if s[0] == 'CALL']
    top = [(s, e) for n, s, e in spans if n in stages]
    assert len(top) == len(stages)
    assert sum(e - s for s, e in top) >= 0.99 * (end - start)


# --------------------------------------------------------------- training
# the Timing/ keys of a sampled batch before the phases had parts
TIMING_BEFORE = {f'Timing/{p}' for p in
                 ('Gmain', 'Greg', 'Dmain', 'Dreg', 'G_ema', 'data_fetch')}
PARTS_OF = ('forward', 'backward', 'update')


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """Two batches of the train command, each timed, its timers recording
    every name they receive: (the names by batch, stats.jsonl records)."""
    root = tmp_path_factory.mktemp('trace_train')
    mesh, lms = synthetic_head()
    rs = np.random.RandomState(0)
    n = 2
    v = np.concatenate([mesh.verts, lms])[None] + rs.randn(
        n, 5091, 3).astype(np.float32) * 0.002
    save_dataset(str(root / 'data'),
                 rs.randint(0, 256, (n, 128, 128, 3)).astype(np.uint8),
                 v.astype(np.float32),
                 np.concatenate([camera_label(0.05 * i, 0.0)
                                 for i in range(n)]), mesh)
    obj, _ = save_head(str(root / 'head.obj'))
    timers = []

    class Recording(PhaseTimer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.names = []
            timers.append(self)

        def phase(self, name):
            self.names.append(name)
            return super().phase(name)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(training_loop, 'PhaseTimer', Recording)
        cli.run(['train', '--outdir', str(root / 'run'), '--data',
                 str(root / 'data'), '--batch', '1', '--kimg', '0.002',
                 '--tick', '0.001', '--snap', '100', '--resolution', '128',
                 '--cbase', '1024', '--cmax', '32', '--plane-resolution',
                 '64', '--neural-rendering-resolution-initial', '32',
                 '--topology-path', obj, '--device', 'cpu', '--workers',
                 '0', '--timing-every', '1', '--metrics', 'none'])
    (timer,) = timers
    with open(root / 'run' / 'stats.jsonl') as f:
        records = [json.loads(line) for line in f]
    return timer.names, records


def test_run_phases_hands_the_timer_phases_and_parts_in_order(trained):
    names, _ = trained
    phases = [n for n in names if '.' not in n]

    def phase(p):
        parts = PARTS_OF + (('w_avg',) if p.endswith('main') else ())
        return [p] + [f'{p}/{part}' for part in parts]
    # batch 0 runs every phase; batch 1 neither regularization
    want = (phase('Gmain') + phase('Greg') + phase('Dmain') + phase('Dreg')
            + ['G_ema'] + phase('Gmain') + phase('Dmain') + ['G_ema'])
    assert phases == want
    # the generator's spans reach the timer beneath run_phases
    first = names[:names.index('Gmain/backward')]
    assert {'G.mapping', 'G.raster', 'G.mouth_blend', 'G.render', 'G.sr',
            'sync.mouth_boxes'} <= set(first)


def test_train_command_timing_keys_grow(trained):
    _, records = trained
    keys = {k for k in records[0] if k.startswith('Timing/')}
    parts = {f'Timing/{p}/{part}' for p in ('Gmain', 'Greg', 'Dmain', 'Dreg')
             for part in PARTS_OF} | {'Timing/Gmain/w_avg',
                                      'Timing/Dmain/w_avg'}
    assert TIMING_BEFORE | parts <= keys
    assert not any('.' in k for k in keys)
    assert all(records[0][k] >= 0 for k in keys)


# ---------------------------------------------------------------- readers
def _record(program=True):
    """Two frames: spans and device ops (µs) with known idle."""
    rec = harness.Record()
    rec.prof_units = 2
    rec.span_units = 4
    ua = 'user_annotation'
    rec.host = [('cpu_op', 'aten::add', 0, 5)]
    rec.device_ops = [('k', 30, 60), ('k', 50, 80), ('k', 90, 150),
                      ('k', 260, 270), ('k', 405, 410)]
    rec.span_ms = {'Gmain': 500.0, 'Dmain': 300.0, 'G_ema': 4.0}
    if program:
        rec.host += [(ua, 'G.raster', 0, 100), (ua, 'sync.flood_round', 10,
                                                20),
                     (ua, 'sync.flood_round', 20, 25),
                     (ua, 'G.mouth_blend', 100, 200),
                     (ua, 'sync.mouth_boxes', 110, 120),
                     (ua, 'G.render', 250, 300), (ua, 'G.sr', 400, 500),
                     (ua, 'G.raster', 1000, 1010)]
        rec.span_ms.update({'Greg': 330.0, 'Gmain/update': 40.0,
                            'Greg/update': 8.0, 'Dmain/update': 20.0,
                            'Dreg/update': 100.0})
    return rec


# idle: G.raster 0-100 busy 30-80 and 90-100 (40 idle), 1000-1010 (10);
# G.mouth_blend 100-200 busy 100-150 (50); G.render 250-300 busy 260-270
# (40); G.sr 400-500 busy 405-410 (95); each over 2 frames, in ms
READINGS = {'host_syncs.reenact': 1.5, 'host_syncs.synth': 1.5,
            'idle_ms.raster.reenact': 0.025,
            'idle_ms.mouth_blend.reenact': 0.025,
            'idle_ms.render.reenact': 0.020, 'idle_ms.sr.reenact': 0.0475,
            'phase_ms.Greg.train': 82.5, 'update_ms.train': 17.0}


@pytest.mark.parametrize('metric', sorted(READINGS))
def test_reader_gives_known_values(metric):
    assert harness.reader(metric).read(_record()) == \
        pytest.approx(READINGS[metric], rel=1e-12)
    assert harness.reader(metric).read(_record(program=False)) is None


def test_new_readers_are_in_the_benchmark():
    bench = harness.spec()
    entries = {m['name']: m for m in bench['per_layer']}
    for metric in READINGS:
        assert entries[metric]['source'] == 'program_span'


# ------------------------------------------------------------------ card
@pytest.mark.cuda
def test_sync_spans_match_sync_debug_mode(generators):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    nets, z, c, v = generators
    dev = torch.device('cuda')
    z, c, v = z.to(dev), c.to(dev), v.to(dev)
    for name, G in nets.items():
        G = G.to(dev)
        with torch.no_grad():
            ws = G.mapping(z, c)
            identity = G.build_identity(ws, noise_mode='const')
            units = {
                'synth': lambda: G.synthesis(G.mapping(z, c), c, v,
                                             noise_mode='const'),
                'reenact': lambda: G.synthesis_from_identity(
                    ws, *identity, c, v, noise_mode='const')}
            for unit, run in units.items():
                run()
                torch.cuda.synchronize()
                rec = Recorder()
                seen = []

                def show(message, *a, **k):
                    seen.append((list(rec.open), str(message)[:120]))
                torch.cuda.set_sync_debug_mode('warn')
                try:
                    with warnings.catch_warnings():
                        warnings.simplefilter('always')
                        warnings.showwarning = show
                        with collecting(rec):
                            run()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                syncs = [n for n in rec.names if n.startswith('sync.')]
                print(name, unit, len(syncs), 'sync spans,', len(seen),
                      'syncs', sorted(set(syncs)))
                assert len(syncs) == len(seen) > 0, (name, unit, seen)
                assert all(any(s.startswith('sync.') for s in stack)
                           for stack, _ in seen), (name, unit, seen)
        G.cpu()
