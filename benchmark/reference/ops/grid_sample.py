"""Bilinear grid sampling (align_corners=False).

Counterpart of next3d_tpu/ops/grid_sample.py and ops/shared_sample.py. The
JAX package's 2x2-packed gather, its scatter-free backward and the
separable one-hot eye-mask contraction exist only to avoid TPU gather and
scatter costs; their common semantics are ``F.grid_sample`` with the
reference's settings.

``grid_sample_gradfix`` is ``F.grid_sample`` with a backward that can be
differentiated again with respect to the input, for R1's double backward
through the augment pipe: torch (2.11 on the card) has no derivative of
``grid_sampler_2d_backward``. Sampling is linear in the input, so the
input's gradient is ``grid_sampler_2d_backward`` and that gradient's own
gradient is the sampling again (the reference's
torch_utils/ops/grid_sample_gradfix.py). Its grid takes no gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PADDING_MODES = {'zeros': 0, 'border': 1, 'reflection': 2}


def grid_sample_2d(input, grid):
    """input: (N, C, H, W); grid: (N, Ho, Wo, 2) with (x, y) in [-1, 1]
    -> (N, C, Ho, Wo)."""
    return F.grid_sample(input, grid, mode='bilinear', padding_mode='zeros',
                         align_corners=False)


def grid_sample_gradfix(input, grid, padding_mode='zeros'):
    """Bilinear ``F.grid_sample`` (align_corners=False) whose backward is
    differentiable again with respect to the input; ``grid`` must not
    require grad."""
    if grid.requires_grad:
        raise ValueError('grid_sample_gradfix takes no gradient of the grid')
    return _GridSample.apply(input, grid, padding_mode)


class _GridSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, input, grid, padding_mode):
        ctx.save_for_backward(input, grid)
        ctx.padding_mode = padding_mode
        return F.grid_sample(input, grid, mode='bilinear',
                             padding_mode=padding_mode, align_corners=False)

    @staticmethod
    def backward(ctx, grad_output):
        input, grid = ctx.saved_tensors
        return _GridSampleBackward.apply(grad_output, input, grid,
                                         ctx.padding_mode), None, None


class _GridSampleBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grad_output, input, grid, padding_mode):
        ctx.save_for_backward(grid)
        ctx.padding_mode = padding_mode
        grad_input, _ = torch.ops.aten.grid_sampler_2d_backward(
            grad_output, input, grid, 0, PADDING_MODES[padding_mode], False,
            [True, False])
        return grad_input

    @staticmethod
    def backward(ctx, grad2_grad_input):
        (grid,) = ctx.saved_tensors
        return _GridSample.apply(grad2_grad_input, grid,
                                 ctx.padding_mode), None, None, None
