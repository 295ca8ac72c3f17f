from .upfirdn2d import (
    setup_filter,
    upfirdn2d,
    filter2d,
    upsample2d,
    downsample2d,
)
from .bias_act import bias_act, activation_funcs
from .conv2d_resample import conv2d_resample
from .grid_sample import grid_sample_2d
from .interpolate import interpolate_bilinear
