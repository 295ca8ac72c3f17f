"""StyleGAN3-R at its FFHQ-U 1024² widths on the card (``cuda``; skips
without one). No JAX: run with ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_sg3_cuda.py -q -s``.

- The FIR kernel's ``any`` instance against its plain version
  (``upfirdn2d_plain`` in float64) at the shapes of SG3-R's layer 10, batch
  4: the 24-tap x4 up-pass (1-D, one launch, negative padding) whose
  output (4, 161, 2098²) holds 2.8e9 elements, past 2^31, and the 12x12
  radial down-pass that reads it; the planes compared lie on both sides of
  element 2^31. Each pass's time (CUDA events) and share of its byte bound
  are printed.
- The layer's whole filtered lrelu against the reference's on the same
  planes.
- A synthesis of the benchmark's configuration at batch 4: every FIR
  launch is the ``any`` instance, one a call (``roofline_sg3.fir_passes``
  counts two passes for each 1-D filter: those calls are counted in
  ``separable_one_launch``); ``filtered_lrelu.calls`` one a layer; the
  ``SG3.input`` and
  ``SG3.layer`` spans tile ``SG3.synthesis`` within 1% of its device time
  (CUDA events); peak memory printed.
- Under ``torch.profiler``, every FIR kernel of a synthesis matches the
  pattern by which ``fir_any_roofline.sg3`` reads the ``any`` instance;
  each distinct call's time is printed beside its bytes bound.
"""

import importlib
import json
import math
import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness, roofline_sg3  # noqa: E402
from benchmark.reference.nn import stylegan3 as ref_sg3  # noqa: E402
from benchmark.reference.ops.filtered_lrelu import \
    filtered_lrelu as ref_flrelu  # noqa: E402

pytestmark = pytest.mark.cuda
CFG = 'sg3r_ffhqu1024'
LAYER = 'L10_1044_161'
BATCH = 4


def _device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from next3d_tpu_torch.ops import cuda_build
    cuda_build.build_all(['upfirdn2d'])
    return torch.device('cuda', 0)


def _g_kwargs():
    """The generator's arguments, less the tri-plane key that the
    configuration carries for the benchmark's own tests (``image_synth``
    drops it too)."""
    kw = dict(harness.config(CFG)['G_kwargs'])
    kw.pop('rendering_kwargs', None)
    return kw


@pytest.fixture(scope='module')
def reference_synthesis():
    """The reference network on the CPU, for its layers' parameters."""
    _device()
    kw = dict(_g_kwargs())
    kw.pop('mapping_kwargs')
    for k in ('z_dim', 'c_dim'):
        kw.pop(k)
    return ref_sg3.SynthesisNetwork(**kw)


def _timed(fn):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _planes(x, index):
    return x[index[0]:index[0] + 1, index[1]:index[1] + 1]


# (image, channel) planes: the first, and planes whose elements lie past
# element 2^31 of the (4, 161, 2098, 2098) map
PLANES = ((0, 0), (3, 150), (3, 160))


def test_any_instance_past_2_31_elements(reference_synthesis):
    device = _device()
    U = importlib.import_module('next3d_tpu_torch.ops.upfirdn2d')
    layer = getattr(reference_synthesis, LAYER)
    C = layer.out_channels
    size = int(reference_synthesis.L9_532_256.out_size[0])
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(BATCH, C, size, size, generator=g, device=device)
    fu = layer.up_filter.to(device)
    fd = layer.down_filter.to(device)
    assert fu.ndim == 1 and fu.numel() == 24 and layer.up_factor == 4
    assert fd.shape == (12, 12) and layer.down_factor == 2
    assert min(layer.padding) < 0
    before = dict(U.upfirdn2d.launches_by_instance)
    one_launch = U.upfirdn2d.separable_one_launch
    up, up_ms = _timed(lambda: U.upfirdn2d(
        x, fu, up=layer.up_factor, padding=layer.padding,
        gain=layer.up_factor ** 2))
    assert up.numel() > 2 ** 31
    down, down_ms = _timed(lambda: U.upfirdn2d(up, fd,
                                               down=layer.down_factor))
    got = U.upfirdn2d.launches_by_instance
    # two calls of each (one warm-up): the 1-D up-pass in one launch
    assert got.get('any', 0) - before.get('any', 0) == 4
    assert U.upfirdn2d.separable_one_launch - one_launch == 2
    assert {k: v for k, v in got.items() if k != 'any'} == \
        {k: v for k, v in before.items() if k != 'any'}
    passes = roofline_sg3._passes(tuple(x.shape), fu, layer.up_factor, 1,
                                  layer.padding)[0]
    passes_d = roofline_sg3._passes(tuple(up.shape), fd, 1,
                                    layer.down_factor, (0, 0, 0, 0))[0]
    for name, ps, ms in (('up x4 24 taps', passes, up_ms),
                         ('down 12x12', passes_d, down_ms)):
        bound = 1e3 * roofline_sg3.fir_any_s(ps)
        print(json.dumps(dict(fir_any=name, ms=ms, bound_ms=bound,
                              share_pct=100 * bound / ms,
                              card=harness.card_line())))
    for plane in PLANES:
        offset = (plane[0] * C + plane[1]) * up.shape[2] * up.shape[3]
        xs = _planes(x, plane).double()
        want_up = U.upfirdn2d_plain(xs, fu.double(), up=layer.up_factor,
                                    padding=layer.padding,
                                    gain=layer.up_factor ** 2)
        got_up = _planes(up, plane).double()
        scale = float(want_up.abs().max())
        assert float((got_up - want_up).abs().max()) <= 1e-5 * scale, \
            (plane, offset)
        want_down = U.upfirdn2d_plain(_planes(up, plane).double(),
                                      fd.double(), down=layer.down_factor)
        got_down = _planes(down, plane).double()
        scale = float(want_down.abs().max())
        assert float((got_down - want_down).abs().max()) <= 1e-5 * scale, \
            (plane, offset)
    assert (PLANES[-1][0] * C + PLANES[-1][1]) * up.shape[2] * up.shape[3] \
        > 2 ** 31
    del up, down
    torch.cuda.empty_cache()

    # the whole filtered lrelu of the layer against the reference's
    from next3d_tpu_torch.ops.filtered_lrelu import filtered_lrelu
    b = torch.randn(C, generator=g, device=device)
    kw = dict(fu=fu, fd=fd, up=layer.up_factor, down=layer.down_factor,
              padding=layer.padding, gain=math.sqrt(2), slope=0.2,
              clamp=layer.conv_clamp)
    out = filtered_lrelu(x, b=b, **kw)
    for plane in PLANES:
        want = ref_flrelu(_planes(x, plane), b=b[plane[1]:plane[1] + 1],
                          **kw)
        scale = float(want.abs().max())
        assert float((_planes(out, plane) - want).abs().max()) \
            <= 1e-5 * scale, plane


def test_synthesis_at_full_width(reference_synthesis):
    device = _device()
    from next3d_tpu_torch.nn.stylegan3 import SG3Generator
    U = importlib.import_module('next3d_tpu_torch.ops.upfirdn2d')
    from next3d_tpu_torch.ops.filtered_lrelu import filtered_lrelu
    from next3d_tpu_torch.utils.profiling import collecting
    G = SG3Generator(**_g_kwargs()).to(device).eval().requires_grad_(False)
    z = torch.randn(BATCH, 512, device=device,
                    generator=torch.Generator(device).manual_seed(0))
    torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad():
        ws = G.mapping(z, None)
        G.synthesis(ws)
        torch.cuda.synchronize()
        launches = dict(U.upfirdn2d.launches_by_instance)
        one_launch = U.upfirdn2d.separable_one_launch
        calls = filtered_lrelu.calls
        img = G.synthesis(ws)
        torch.cuda.synchronize()
        got = {k: v - launches.get(k, 0)
               for k, v in U.upfirdn2d.launches_by_instance.items()}
        assert filtered_lrelu.calls - calls == len(G.synthesis.layer_names)
        separable = _separable_calls(reference_synthesis)
        want = len(roofline_sg3.fir_passes(reference_synthesis, BATCH))
        assert {k: v for k, v in got.items() if v} == \
            {'any': want - separable}
        assert U.upfirdn2d.separable_one_launch - one_launch == separable
        spans = harness.Spans(True)
        with collecting(spans):
            G.synthesis(ws)
        torch.cuda.synchronize()
    ms = spans.ms()
    stages = ms['SG3.input'] + ms['SG3.layer']
    print(json.dumps(dict(sg3_spans_ms=ms, tiled=stages / ms['SG3.synthesis'],
                          peak_gib=torch.cuda.max_memory_allocated(device)
                          / 2 ** 30, card=harness.card_line())))
    assert img.shape == (BATCH, 3, 1024, 1024)
    assert bool(torch.isfinite(img).all())
    assert 0.99 * ms['SG3.synthesis'] <= stages <= 1.001 * ms['SG3.synthesis']
    assert ms['SG3.conv'] + ms['SG3.flrelu'] <= ms['SG3.layer'] * 1.001


def _separable_calls(synthesis):
    """The ``upfirdn2d`` calls of a synthesis with a 1-D filter."""
    return sum(f is not None and f.ndim == 1
               for name in synthesis.layer_names
               for f in (getattr(synthesis, name).up_filter,
                         getattr(synthesis, name).down_filter))


def test_every_fir_kernel_is_the_one_the_roofline_reads(
        reference_synthesis):
    """Every FIR kernel of a synthesis is named as ``fir_any_roofline.sg3``
    reads the ``any`` instance; the 30 calls (16 of them with a 1-D
    filter) launch 30 kernels. Each distinct call is then timed alone on a
    fresh input (CUDA events) and printed beside its bytes bound."""
    device = _device()
    from next3d_tpu_torch.nn.stylegan3 import SG3Generator
    U = importlib.import_module('next3d_tpu_torch.ops.upfirdn2d')
    G = SG3Generator(**_g_kwargs()).to(device).eval().requires_grad_(False)
    z = torch.randn(BATCH, 512, device=device,
                    generator=torch.Generator(device).manual_seed(0))
    calls = {}
    original = U.upfirdn2d_cuda

    def record(x, f, p, channels_last):
        calls.setdefault((tuple(x.shape), tuple(f.shape), p), f)
        return original(x, f, p, channels_last)

    with torch.no_grad():
        ws = G.mapping(z, None)
        G.synthesis(ws)
        torch.cuda.synchronize()
        U.upfirdn2d_cuda = record
        try:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                G.synthesis(ws)
                torch.cuda.synchronize()
        finally:
            U.upfirdn2d_cuda = original
    del G
    torch.cuda.empty_cache()
    device_ops, _ = harness.read_trace(prof)
    fir = [n for n, _, _ in device_ops if 'upfirdn2d' in n]
    pattern = re.compile(harness.reader('fir_any_roofline.sg3').ANY)
    assert fir and all(pattern.search(n) for n in fir), sorted(set(fir))
    assert len(fir) == len(roofline_sg3.fir_passes(reference_synthesis,
                                                   BATCH)) \
        - _separable_calls(reference_synthesis)
    g = torch.Generator(device=device).manual_seed(0)
    total_ms = total_bound = 0.0
    for (shape, _, p), f in calls.items():
        x = torch.randn(shape, generator=g, device=device)
        _, ms = _timed(lambda: U.upfirdn2d_cuda(x, f, p, False))
        del x
        passes = roofline_sg3._passes(
            shape, None if f.numel() == 1 else f.cpu(), p.upx, p.downx,
            (p.padx0, p.padx1, p.pady0, p.pady1))[0]
        bound = 1e3 * roofline_sg3.fir_any_s(passes)
        total_ms += ms
        total_bound += bound
        print(json.dumps(dict(fir_call=list(shape), taps=list(f.shape),
                              up=p.upx, down=p.downx, ms=ms, bound_ms=bound,
                              share_pct=100 * bound / ms)))
    print(json.dumps(dict(fir_calls=len(calls), ms=total_ms,
                          bound_ms=total_bound,
                          share_pct=100 * total_bound / total_ms,
                          card=harness.card_line())))
