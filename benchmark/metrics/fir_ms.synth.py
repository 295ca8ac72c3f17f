"""Milliseconds of device time a unit in the FIR resampling ops
(``upfirdn2d``): the port's kernel (``csrc/upfirdn2d.cu``) and the library
depthwise convolutions that ran the filter before it (ATen's
``conv_depthwise2d`` and cuDNN's grouped direct kernels), forward and
backward, over the profiled stretch's units."""

FIR = r'\bupfirdn2d_\w+_kernel\b|conv_depthwise2d|grouped_direct'


def fir_ms(rec):
    device_s, count = rec.kernel_s(FIR)
    if not count or not rec.prof_units:
        return None
    return 1e3 * device_s / rec.prof_units


read = fir_ms
