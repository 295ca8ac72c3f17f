"""Milliseconds a unit in the 'backbones' spans (CUDA events)."""
from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, 'backbones')
