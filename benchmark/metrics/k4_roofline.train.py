"""K4's forward (``csrc/triplane_sample.cu``): its least time at the
cell's shapes over its device time."""
from benchmark import readers


def read(rec):
    return readers.kernel_roofline(rec, readers.K4, readers.k4_least_s(rec))
