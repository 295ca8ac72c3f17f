"""StyleGAN3 in the benchmark, on the CPU at a small size. No JAX.

- The port's SG3-R and SG3-T (``nn/stylegan3.py``) against the plain
  reference (``benchmark/reference/nn/stylegan3.py``) on the reference's
  seeded weights, loaded strictly: 64², channel_base 512, channel_max 16,
  batch 2; max-abs gap within 1e-5 of the image's scale.
- The reference's radial (jinc) down-filters against an independent
  formula: J1 by its integral and the Kaiser window by I0 and Kaiser's
  attenuation and beta formulas.
- ``fir_passes`` (``benchmark/roofline_sg3.py``) gives each layer's output
  shape as the reference computes it, and the real taps of each pass; at
  SG3-R's published widths it bounds layer 10's x4 up-filter by the call's
  input read once and its output written once, nothing for the map
  between its two passes.
- ``kinds/image_synth.py``: a run at the small size is correct, and the
  check reads a planted fault (one layer's radial down-filter swapped for
  a separable one) as not correct.
- The SG3 spans: ``SG3.input`` and ``SG3.layer`` tile ``SG3.synthesis``
  under a CPU profiler, ``SG3.conv`` and ``SG3.flrelu`` each layer,
  ``.up``, ``.act``, ``.down`` each filtered lrelu; ``filtered_lrelu.calls``
  counts a call a layer.
- The new readers on a hand-built record, and nothing without the
  program's spans.
- The reference imports no module of the port, no kernel and nothing of
  JAX (in a subprocess).
"""

import copy
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, roofline, roofline_sg3, run
from benchmark.kinds import image_synth
from benchmark.reference import init
from benchmark.reference.nn import stylegan3 as ref_sg3
from next3d_tpu_torch.nn.stylegan3 import SG3Generator
from next3d_tpu_torch.ops.filtered_lrelu import filtered_lrelu

# autouse: one torch thread
from torch_parity import one_thread_module  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(z_dim=32, c_dim=0, w_dim=32, img_resolution=64, img_channels=3,
             channel_base=512, channel_max=16)
VARIANTS = {'R': dict(conv_kernel=1, use_radial_filters=True), 'T': {}}
TOL = 1e-5
CELL = 'sg3r_ffhqu1024.synth_b4'


def _pair(variant, seed=7):
    kw = dict(SMALL, **VARIANTS[variant])
    ref = init.build(lambda: ref_sg3.SG3Generator(**kw), seed,
                     torch.device('cpu')).eval()
    port = SG3Generator(**kw).eval()
    port.load_state_dict(ref.state_dict(), strict=True)
    return ref, port


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_port_matches_the_reference(variant):
    ref, port = _pair(variant)
    z = torch.randn(2, SMALL['z_dim'],
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = ref.synthesis(ref.mapping(z, None))
        got = port.synthesis(port.mapping(z, None, truncation_psi=1))
    assert got.shape == want.shape == (2, 3, 64, 64)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= TOL * scale


def _j1(x):
    """J1 by its integral, (1/pi) int_0^pi cos(t - x sin t) dt
    (trapezoids on 4001 points)."""
    t = np.linspace(0, np.pi, 4001)
    vals = np.cos(t[None] - np.asarray(x).reshape(-1, 1) * np.sin(t[None]))
    return np.trapezoid(vals, t, axis=1).reshape(np.shape(x)) / np.pi


def _kaiser(numtaps, width, fs):
    """The Kaiser window of the design's attenuation (Kaiser's formulas)."""
    a = 2.285 * (numtaps - 1) * np.pi * (width / (fs / 2)) + 7.95
    if a > 50:
        beta = 0.1102 * (a - 8.7)
    elif a > 21:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21)
    else:
        beta = 0.0
    n = np.arange(numtaps)
    arg = beta * np.sqrt(1 - (2 * n / (numtaps - 1) - 1) ** 2)
    return np.i0(arg) / np.i0(beta)


@pytest.mark.parametrize('numtaps,cutoff,width,fs', [
    (12, 2.0, 2.287, 16), (12, 35.9, 24.1, 256), (12, 256.0, 171.0, 2048)])
def test_radial_filter_is_a_windowed_jinc(numtaps, cutoff, width, fs):
    got = ref_sg3.design_lowpass_filter(numtaps, cutoff, width, fs,
                                        radial=True).numpy()
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.sqrt(x[:, None] ** 2 + x[None, :] ** 2)
    jinc = _j1(2 * np.pi * cutoff * r) / (np.pi * r)
    w = _kaiser(numtaps, width, fs)
    want = jinc * w[:, None] * w[None, :]
    want /= want.sum()
    assert got.shape == (numtaps, numtaps)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(
        want).max())
    # radial: the same at every rotation by 90 degrees and transposition
    np.testing.assert_allclose(got, got.T, atol=1e-7)
    np.testing.assert_allclose(got, got[::-1], atol=1e-7)


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_fir_passes_follow_the_layers(variant):
    ref, _ = _pair(variant)
    S = ref.synthesis
    passes = roofline_sg3.fir_passes(S, 2)
    shapes = []
    x = S.input(torch.zeros(2, SMALL['w_dim']))
    for name in S.layer_names:
        x = getattr(S, name)(x, torch.zeros(2, SMALL['w_dim']))
        shapes.append(tuple(x.shape))
    n_passes = 0
    for name, shape in zip(S.layer_names, shapes):
        layer = getattr(S, name)
        n_up = 2 if layer.up_filter is not None else 1
        n_down = 1 if layer.down_filter is None or \
            layer.down_filter.ndim == 2 else 2
        last = passes[n_passes + n_up + n_down - 1]
        assert last[1] == last[2] == math.prod(shape), name
        # the up pass's real taps: taps over up along each upsampled axis
        if layer.up_filter is not None:
            assert passes[n_passes][3] == \
                layer.up_filter.shape[0] // layer.up_factor
        if layer.down_filter is not None and layer.down_filter.ndim == 2:
            assert last[3] == layer.down_filter.numel()
        n_passes += n_up + n_down
    assert n_passes == len(passes)
    # R's radial down-filters are one pass each, T's two
    n_radial = sum(getattr(S, n).down_radial for n in S.layer_names)
    assert (n_radial > 0) == (variant == 'R')
    assert roofline_sg3.fir_any_s(passes) == pytest.approx(
        4 * sum(a + b for a, b, _, _ in passes) / roofline.PEAK_BYTES_S)


def test_fir_bytes_of_a_separable_call_are_its_input_and_output():
    """Layer 10 of SG3-R at its published widths, batch 4: the x4 up
    call's two passes move its input once and its output once, which is
    the next (radial, one-pass) down call's input."""
    S = ref_sg3.SynthesisNetwork(
        w_dim=512, img_resolution=1024, img_channels=3, channel_base=65536,
        channel_max=1024, conv_kernel=1, use_radial_filters=True)
    passes = roofline_sg3.fir_passes(S, 4)
    start = 0
    for name in S.layer_names[:10]:
        layer = getattr(S, name)
        start += (2 if layer.up_filter is not None else 1) + \
            (1 if layer.down_filter is None or layer.down_filter.ndim == 2
             else 2)
    layer = getattr(S, S.layer_names[10])
    assert layer.up_factor == 4 and layer.up_filter.numel() == 24
    assert layer.down_filter.shape == (12, 12)
    x_pass, y_pass, down = passes[start:start + 3]
    size = [int(s) for s in getattr(S, S.layer_names[9]).out_size]
    n_in = 4 * layer.out_channels * size[0] * size[1]
    assert x_pass[:2] == (n_in, 0)
    assert y_pass[0] == 0 and y_pass[1] == down[0] > 2 ** 31
    assert roofline_sg3.fir_any_s([x_pass, y_pass]) == pytest.approx(
        4 * (n_in + down[0]) / roofline.PEAK_BYTES_S)


def _ctx(seed=2 ** 41 + 9, **kw):
    cell, _ = harness.workload(CELL)
    cfg = copy.deepcopy(harness.config(cell['config']))
    cfg['G_kwargs'].update(SMALL)
    mix = dict(harness.traffic(cell['traffic']), z_dim=SMALL['z_dim'],
               batch=2)
    return cell, harness.Ctx(cell, cfg, mix, seed, 'cpu', seconds=0.2,
                             lim=harness.limits(CELL), **kw)


def _separable_fault(work):
    """One layer's radial down-filter replaced by the separable Kaiser
    filter of the same taps, cutoff and width."""
    S = work.model.synthesis
    twin = ref_sg3.SynthesisNetwork(
        w_dim=SMALL['w_dim'], img_resolution=SMALL['img_resolution'],
        img_channels=3, channel_base=SMALL['channel_base'],
        channel_max=SMALL['channel_max'], **VARIANTS['R'])
    name = next(n for n in S.layer_names if getattr(S, n).down_radial)
    t = getattr(twin, name)
    getattr(S, name).down_filter = ref_sg3.design_lowpass_filter(
        t.down_taps, t.out_cutoff, t.out_half_width * 2,
        t.tmp_sampling_rate)


@pytest.mark.parametrize('fault', [None, 'separable_down'])
def test_image_synth_check(fault):
    cell, ctx = _ctx()
    Work = image_synth.Work

    class Broken(Work):
        def __init__(self, ctx):
            super().__init__(ctx)
            if fault:
                _separable_fault(self)
    image_synth.Work = Broken
    try:
        result, checks, _, _ = run.run_cell(ctx, harness.spec(), cell, 0.0)
    finally:
        image_synth.Work = Work
    (name, value, limit), = checks
    assert name == 'image_gap' and limit is not None
    assert result['correct'] == (fault is None), value
    assert result['attempted'] % 2 == 0 and result['attempted'] >= 2


# ------------------------------------------------------------------ spans
SPANS = ('SG3.input', 'SG3.layer', 'SG3.conv', 'SG3.flrelu', 'SG3.flrelu.up',
         'SG3.flrelu.act', 'SG3.flrelu.down')


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_sg3_spans_tile_synthesis(variant):
    _, G = _pair(variant)
    z = torch.randn(2, SMALL['z_dim'])
    with torch.no_grad():
        ws = G.mapping(z, None)
        G.synthesis(ws)
        before = filtered_lrelu.calls
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            G.mapping(z, None)
            G.synthesis(ws)
    n_layers = len(G.synthesis.layer_names)
    assert filtered_lrelu.calls - before == n_layers
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.name.startswith('SG3.')]
    count = {}
    for name, _, _ in spans:
        count[name] = count.get(name, 0) + 1
    assert count == dict({'SG3.mapping': 1, 'SG3.synthesis': 1,
                          'SG3.input': 1},
                         **{n: n_layers for n in SPANS[1:]})

    def within(outer, inner):
        return [(n, s, e) for n, s, e in spans if n == inner and any(
            so <= s and e <= eo for m, so, eo in spans if m == outer)]
    for outer, inner in (('SG3.synthesis', 'SG3.layer'),
                         ('SG3.layer', 'SG3.conv'),
                         ('SG3.layer', 'SG3.flrelu'),
                         ('SG3.flrelu', 'SG3.flrelu.up'),
                         ('SG3.flrelu', 'SG3.flrelu.act'),
                         ('SG3.flrelu', 'SG3.flrelu.down')):
        assert len(within(outer, inner)) == n_layers, (outer, inner)
    (_, start, end), = [s for s in spans if s[0] == 'SG3.synthesis']
    top = [e - s for n, s, e in spans if n in ('SG3.input', 'SG3.layer')]
    assert sum(top) >= 0.99 * (end - start)


# ---------------------------------------------------------------- readers
def _record(program=True):
    rec = harness.Record()
    rec.prof_units = 2
    rec.span_units = 3
    rec.rate = 4.0
    rec.flops_per_unit = 2.5e12
    rec.shapes = dict(fir_any=[(1000, 0, 4000, 6), (0, 16000, 16000, 6),
                               (16000, 4000, 4000, 144)])
    rec.device_ops = [
        ('void (anonymous namespace)::upfirdn2d_nchw_kernel<float, 0, 0, '
         '0, 4>((anonymous namespace)::Args)', 0, 30),
        ('void (anonymous namespace)::upfirdn2d_nchw_kernel<float, 1, 1, '
         '4, 8>((anonymous namespace)::Args)', 30, 40),
        ('void (anonymous namespace)::upfirdn2d_nhwc_kernel<float, 4, 0, '
         '0, 0, 8, 1>((anonymous namespace)::Args)', 40, 50),
        ('sm80_xmma_fprop_implicit_gemm', 50, 90)]
    if program:
        rec.span_ms = {'SG3.flrelu': 120.0, 'SG3.layer': 200.0}
    else:
        rec.device_ops = rec.device_ops[1:2] + rec.device_ops[3:]
    return rec


def test_new_readers_give_known_values():
    rec = _record()
    assert harness.reader('flrelu_ms.sg3').read(rec) == pytest.approx(40.0)
    # the any instance: 40 us of device time over 2 units, against
    # 2 x 4 x 37000 bytes at the peak rate
    least = 2 * 4 * 37000 / roofline.PEAK_BYTES_S
    assert harness.reader('fir_any_roofline.sg3').read(rec) == \
        pytest.approx(100 * least / 40e-6)
    assert harness.reader('mfu.sg3').read(rec) == pytest.approx(
        100 * 2.5e12 * 4.0 / roofline.PEAK_F32_FLOP_S)
    bare = _record(program=False)
    assert harness.reader('flrelu_ms.sg3').read(bare) is None
    assert harness.reader('fir_any_roofline.sg3').read(bare) is None


def test_new_metrics_are_in_the_benchmark():
    bench = harness.spec()
    entries = {m['name']: m for m in bench['per_layer']}
    for name, source in (('flrelu_ms.sg3', 'program_span'),
                         ('fir_any_roofline.sg3', 'device_trace'),
                         ('mfu.sg3', 'device_trace')):
        assert entries[name]['source'] == source
        assert entries[name]['workloads'] == [CELL]
    assert CELL in run.reported(bench, harness.workload(CELL)[0],
                                'end_to_end')[0]['workloads']


# ---------------------------------------------------------------- imports
def test_the_reference_imports_nothing_of_the_port():
    script = ('import sys; sys.path.insert(0, sys.argv[1]); '
              'import benchmark.reference.nn.stylegan3, '
              'benchmark.reference.ops.filtered_lrelu, '
              'benchmark.reference.train.data_parallel, '
              'benchmark.roofline_sg3; '
              'print(sorted({m.split(".")[0] for m in sys.modules}))')
    out = subprocess.run([sys.executable, '-c', script, str(ROOT)],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & {'next3d_tpu_torch', 'next3d_tpu', 'jax', 'jaxlib',
                       'flax', 'triton'}
    assert not any('cuda_build' in m for m in out.stdout.split())
