"""K6: the aligned 8-row block gather.

Counterpart of next3d_tpu/ops/pallas_dma_gather.py dma_gather_row_blocks:
``out[i] = table[8 * (idx[i] // 8) : 8 * (idx[i] // 8) + 8]``, an (M, 8, C)
result in the table's dtype, with row ``idx[i]`` at ``out[i, idx[i] % 8]``.
Indices lie in [0, R). The TPU kernel's ``tile`` and ``depth`` arguments
sized its DMA ring and have no counterpart here. ``gather_row_blocks``
launches the kernel in ``csrc/gather_row_blocks.cu`` for CUDA tensors and
runs the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build


def gather_row_blocks_plain(table, idx):
    """The plain torch version on any device."""
    R, C = table.shape
    return table.view(R // 8, 8, C)[idx.long() // 8]


def _gather_cuda(table, idx):
    R, C = table.shape
    block_bytes = 8 * C * table.element_size()
    if idx.dtype != torch.int32 or idx.dim() != 1 \
            or idx.device != table.device:
        raise ValueError(f'idx must be a 1-D int32 tensor on {table.device}')
    if block_bytes % 16 or table.data_ptr() % 16:
        raise ValueError('an 8-row block must be a whole number of 16-byte '
                         'words, on a 16-byte aligned table')
    idx = idx.contiguous()
    out = torch.empty((idx.numel(), 8, C), dtype=table.dtype,
                      device=table.device)
    fn = cuda_build.load('gather_row_blocks').gather_row_blocks
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                    idx.numel(), R, block_bytes, stream)
    cuda_build.check('gather_row_blocks', status)
    gather_row_blocks.launches += 1
    return out


def gather_row_blocks(table, idx):
    """table (R, C) contiguous, R % 8 == 0, any dtype; idx (M,) int32 ->
    (M, 8, C)."""
    R, C = table.shape
    if R % 8 or not table.is_contiguous():
        raise ValueError(f'table must be contiguous with a multiple of 8 '
                         f'rows, got {tuple(table.shape)}')
    if table.is_cuda:
        return _gather_cuda(table, idx)
    return gather_row_blocks_plain(table, idx)


gather_row_blocks.launches = 0
