"""Milliseconds a frame in which no device op ran while the host was
inside the program's ``G.mouth_blend`` span (``idle_ms.raster.reenact``)."""
from benchmark import harness


def read(rec):
    return harness.reader('idle_ms.raster.reenact').idle_ms(rec,
                                                            'G.mouth_blend')
