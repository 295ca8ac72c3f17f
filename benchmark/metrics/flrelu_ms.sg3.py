"""Milliseconds a unit in the program's ``SG3.flrelu`` spans (the filtered
lrelu of each synthesis layer: bias, up-FIR, activation, down-FIR), by
CUDA events over the spans' stretch. None where the program opens no such
span."""
from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, 'SG3.flrelu')
