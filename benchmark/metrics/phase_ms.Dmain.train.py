"""Milliseconds a step in the training step's 'Dmain' phase (CUDA events
around the phase that TrainStep.run_phases reports to its timer)."""
from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, 'Dmain')
