"""K1, the binned UV rasterizer (``csrc/raster_binned_uv.cu`` and its prep
in ``csrc/raster_binned_prep.cu``): its least time at the cell's shapes
over its device time."""
from benchmark import readers, roofline


def read(rec):
    return readers.kernel_roofline(
        rec, readers.K1, readers.raster_least_s(rec, roofline.k1_s))
