"""Milliseconds a unit in the 'mouth_blend' spans (CUDA events)."""
from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, 'mouth_blend')
