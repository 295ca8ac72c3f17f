"""The benchmark's own counts: the card's peaks and the least time of each
hand-written kernel's work at a cell's shapes.

A kernel's least time is the larger of its bytes over the memory's peak
rate and its float32 operations over the float32 peak (the formulas of
``chip_smoke.py``: each input byte read once and each output byte written
once). Its roofline share is that least time over the device time the
profiler gives its launches. The model's operations a unit are counted on
the frozen reference (``kinds/*.check``), never on the program, so that a
later change to the program's kernels cannot change the yardstick.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM3, 67
TFLOP/s in float32 outside the tensor cores (the cells run float32 with
TF32 off), at a 700 W power limit.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
F32 = 4
I64 = 8


def least_s(n_bytes, n_ops=0):
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_FLOP_S)


def k4_forward_s(N, H, W, C, M):
    """K4 forward: planes (N, 3, H, W, C) and points (N, M, 3) read, the
    samples (N, 3, M, C) written; 4 taps of a multiply and an add a
    channel per point and plane."""
    n_bytes = F32 * (N * 3 * H * W * C + N * M * 3 + N * 3 * M * C)
    return least_s(n_bytes, N * 3 * M * C * 8)


def k4_backward_s(N, H, W, C, M):
    """K4 backward: the samples' gradient (N, 3, M, C) and the points
    read, the planes' gradient (N, 3, H, W, C) written; at most 4 in-range
    taps of a multiply and an add a channel per point and plane (the bytes
    bound it at the cells' shapes)."""
    n_bytes = F32 * (N * 3 * M * C + N * M * 3 + N * 3 * H * W * C)
    return least_s(n_bytes, N * 3 * M * C * 8)


def k1_s(B, V, F, R):
    """K1 (binned prep and resolve): projected verts (B, V, 3) float32,
    faces (F, 3) int64 and per-corner (u, v) (F, 3, 2) read; pix_to_face,
    u and v (B, R, R) written. The operations (12 a pixel and kept face
    inside the face's box) lie below the bytes at the head's sizes
    (PERF.md, kernel table), so the bytes alone bound it here."""
    return least_s(F32 * B * V * 3 + I64 * F * 3 + F32 * F * 3 * 2
                   + 3 * F32 * B * R * R)


def k2_s(B, V, F, R):
    """K2 (binned prep and resolve): projected verts and faces read;
    pix_to_face and zbuf (B, R, R) written."""
    return least_s(F32 * B * V * 3 + I64 * F * 3 + 2 * F32 * B * R * R)


def share_pct(least_total_s, device_s):
    """A roofline share in percent; None where nothing was measured."""
    if not device_s or least_total_s is None:
        return None
    return 100.0 * least_total_s / device_s
