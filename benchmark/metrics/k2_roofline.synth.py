"""K2, the binned rasterizer (``csrc/raster_binned_uv.cu`` and its prep in
``csrc/raster_binned_prep.cu``): its least time at the cell's shapes over
its device time."""
from benchmark import readers, roofline


def read(rec):
    return readers.kernel_roofline(
        rec, readers.K2, readers.raster_least_s(rec, roofline.k2_s))
