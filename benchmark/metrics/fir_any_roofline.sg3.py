"""The FIR kernel's ``any`` instance (``csrc/upfirdn2d.cu``, every
StyleGAN3 pass): its least time at the cell's shapes (``roofline_sg3``:
each pass's input read and kept outputs written once) over its device
time in the profiled stretch."""
from benchmark import readers, roofline_sg3

# instance 0 of either layout: the template's up, down and taps all 0
ANY = (r'\bupfirdn2d_nchw_kernel<[^,]+, ?0, ?0, ?0,'
       r'|\bupfirdn2d_nhwc_kernel<[^,]+, ?\d+, ?0, ?0, ?0,')


def read(rec):
    passes = rec.shapes.get('fir_any')
    least = roofline_sg3.fir_any_s(passes) if passes else None
    return readers.kernel_roofline(rec, ANY, least)
