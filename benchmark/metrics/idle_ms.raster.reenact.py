"""Milliseconds a frame in which no device op ran while the host was
inside the program's ``G.raster`` span: each span's length less the union
of the device ops clipped to it, over the profiled stretch's units. None
where the program opens no such span."""
from benchmark import harness


def idle_ms(rec, name):
    spans = [(s, e) for cat, n, s, e in rec.host
             if cat == 'user_annotation' and n == name]
    if not rec.prof_units or not spans:
        return None
    idle_s = 0.0
    for s, e in spans:
        busy = [(max(a, s), min(b, e)) for _, a, b in rec.device_ops
                if a < e and b > s]
        idle_s += (e - s) * 1e-6 - harness.union_s(busy)
    return 1e3 * idle_s / rec.prof_units


def read(rec):
    return idle_ms(rec, 'G.raster')
