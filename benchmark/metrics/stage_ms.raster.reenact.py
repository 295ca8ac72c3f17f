"""Milliseconds a unit in the 'raster' spans (CUDA events)."""
from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, 'raster')
