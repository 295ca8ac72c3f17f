"""StyleGAN3's FIR work at a cell's shapes: the launches of the FIR
kernel's ``any`` instance a unit, their bytes and their multiply-adds.

A synthesis layer's filtered lrelu filters twice (``filtered_lrelu``): the
up-FIR on the modulated convolution's output, then the down-FIR on the
activation. A 1-D (separable) filter is two passes, x then y; a 2-D one
(the radial down-filters) one pass; no filter (the ToRGB layer) a pass of
one tap. Every pass of StyleGAN3 is the ``any`` instance: none is the 4x4
filter of the fixed ones. The bytes bound a call, not a pass: the call
reads its input once and writes its kept outputs once (float32), so that
the x pass of a separable filter counts the input's read and the y pass
the output's write, and the map between them counts nothing (a kernel
that filters both axes in one pass needs no more). An output adds only
the taps that land on real samples (taps / up along an upsampled axis).

The shapes come from the reference's layers (``reference/nn/
stylegan3.py``), never from the program.
"""

from __future__ import annotations

from . import roofline


def _taps(f):
    """(rows, columns) of taps and whether the filter is separable."""
    if f is None:
        return (1, 1), False
    if f.ndim == 1:
        return (int(f.shape[0]),) * 2, True
    return (int(f.shape[0]), int(f.shape[1])), False


def _passes(shape, f, up, down, pad):
    """[(elements it must read, elements it must write, outputs, taps an
    output)] of each pass of one ``upfirdn2d`` call on ``shape`` (N, C, H,
    W); ``pad`` (x0, x1, y0, y1) of the upsampled map. Returns them and
    the output's shape."""
    N, C, H, W = shape
    (th, tw), separable = _taps(f)
    px0, px1, py0, py1 = pad
    out_w = (W * up + px0 + px1 - tw) // down + 1
    out_h = (H * up + py0 + py1 - th) // down + 1
    n_in, n_out = N * C * H * W, N * C * out_h * out_w
    if not separable:
        return ([(n_in, n_out, n_out, (th // up) * (tw // up))],
                (N, C, out_h, out_w))
    return ([(n_in, 0, N * C * H * out_w, tw // up),
             (0, n_out, n_out, th // up)], (N, C, out_h, out_w))


def fir_passes(synthesis, batch):
    """Every FIR pass of one synthesis of ``batch`` images by the
    reference network ``synthesis``, in launch order."""
    out = []
    size = int(synthesis.input.size[1]), int(synthesis.input.size[0])
    for name in synthesis.layer_names:
        layer = getattr(synthesis, name)
        k = layer.conv_kernel
        shape = (batch, layer.out_channels, size[0] + k - 1, size[1] + k - 1)
        up, shape = _passes(shape, layer.up_filter, layer.up_factor, 1,
                            layer.padding)
        down, shape = _passes(shape, layer.down_filter, 1,
                              layer.down_factor, (0, 0, 0, 0))
        out += up + down
        size = shape[2:]
    return out


def fir_any_s(passes):
    """The least seconds of the passes: the bytes their calls must read
    and write over the memory's peak rate."""
    return roofline.least_s(sum(roofline.F32 * (read + written)
                                for read, written, _, _ in passes))


def fir_ops(passes):
    """The passes' floating-point operations: a multiply and an add a tap
    that lands on a real sample, an output."""
    return sum(2 * outputs * taps for _, _, outputs, taps in passes)
