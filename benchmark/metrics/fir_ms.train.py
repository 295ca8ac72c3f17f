"""Milliseconds of device time a training step in the FIR resampling ops,
forward and backward (``fir_ms.synth``'s kernels)."""
from benchmark import harness


def read(rec):
    return harness.reader('fir_ms.synth').fir_ms(rec)
