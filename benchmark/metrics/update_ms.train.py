"""Milliseconds a step in the optimizer's tail of Gmain, Greg and Dmain:
the program's '<phase>/update' spans (the zero gradients of unreached
leaves, the norm, the scrubbing and the Adam step), by CUDA events through
the timer, over the spans' stretch. Dreg's is left out: the stretch holds
one in some runs only."""
from benchmark import readers


def read(rec):
    return readers.stage_ms(rec, 'Gmain/update', 'Greg/update',
                            'Dmain/update')
