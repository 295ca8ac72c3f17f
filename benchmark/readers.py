"""The arithmetic the per-layer readers share. Each reader
(``metrics/<name>.py``) names its span, kernel or quantity and calls one
of these on the run's ``harness.Record``; each returns None where the run
has nothing to read, and the harness then leaves the metric out."""

from __future__ import annotations

from . import roofline


def stage_ms(rec, *stages):
    """Milliseconds a unit in the spans ``stages``, summed, over the
    spans' stretch (CUDA events)."""
    if not rec.span_units or not any(s in rec.span_ms for s in stages):
        return None
    return sum(rec.span_ms.get(s, 0.0) for s in stages) / rec.span_units


def kernel_roofline(rec, pattern, least_s_a_unit):
    """The roofline share of the device ops matching ``pattern`` over the
    profiled stretch: its units' least time over their device time."""
    device_s, count = rec.kernel_s(pattern)
    if not count or least_s_a_unit is None:
        return None
    return roofline.share_pct(rec.prof_units * least_s_a_unit, device_s)


def k4_least_s(rec, key='k4', backward=False):
    calls = rec.shapes.get(key)
    if not calls:
        return None
    fn = roofline.k4_backward_s if backward else roofline.k4_forward_s
    return sum(fn(**c) for c in calls)


def raster_least_s(rec, fn):
    shape = rec.shapes.get('raster')
    if not shape:
        return None
    return rec.shapes.get('raster_calls', 1) * fn(**shape)


def mfu(rec):
    """The reference's operations a unit times the window's units a
    second, over the float32 peak, in percent."""
    if not rec.flops_per_unit or not rec.rate:
        return None
    return 100.0 * rec.flops_per_unit * rec.rate / roofline.PEAK_F32_FLOP_S


def device_idle_pct(rec):
    """The share of the profiled stretch in which no device op ran."""
    if not rec.window_s or not rec.device_ops:
        return None
    return 100.0 * (1.0 - rec.busy_s() / rec.window_s)


K4 = r'\btriplane_sample_kernel\b'
K4B = r'\btriplane_sample_backward_kernel\b'
PREP = r'|\bcount_kernel\b|\bplace_kernel\b'
K1 = r'raster_binned_kernel<32, ?true>' + PREP
K2 = r'raster_binned_kernel<32, ?false>' + PREP
