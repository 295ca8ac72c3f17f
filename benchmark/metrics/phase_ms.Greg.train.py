"""Milliseconds a step in the training step's 'Greg' phase, over the spans'
stretch (CUDA events around the phase that TrainStep.run_phases reports
to its timer). The stretch's 4 steps hold one Greg, so this is Greg's
time amortized over its interval."""
from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, 'Greg')
