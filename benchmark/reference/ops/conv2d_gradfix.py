"""2-D convolutions whose every order of derivative is a convolution.

Under autograd, ``conv2d`` and ``conv_transpose2d`` run as autograd
functions whose backward is written out: the input's gradient is the
transposed convolution (again such a function) and the weight's gradient
is ``aten.convolution_backward`` for the weight alone (a function whose
backward is again a convolution of each kind). torch's own double backward
of a convolution, which R1 takes through every convolution and FIR filter
of the discriminator, instead runs a convolution against the gradient of
the whole image: on an H100 at the 512^2 D it took 8.5 s of Dreg's 9.1 s
(``chip_smoke.py --profile``, phase 13). The reference has the same
module (torch_utils/ops/conv2d_gradfix.py); the JAX package needs none,
since XLA differentiates its convolutions directly.

Without autograd, or when neither argument requires grad, these are
``F.conv2d`` and ``F.conv_transpose2d``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d(input, weight, stride=1, padding=0, groups=1):
    if _differentiable(input, weight):
        return _op(False, tuple(weight.shape), _pair(stride), _pair(padding),
                   (0, 0), groups).apply(input, weight)
    return F.conv2d(input, weight, stride=stride, padding=padding,
                    groups=groups)


def conv_transpose2d(input, weight, stride=1, padding=0, output_padding=0,
                     groups=1):
    if _differentiable(input, weight):
        return _op(True, tuple(weight.shape), _pair(stride), _pair(padding),
                   _pair(output_padding), groups).apply(input, weight)
    return F.conv_transpose2d(input, weight, stride=stride, padding=padding,
                              output_padding=output_padding, groups=groups)


def _differentiable(input, weight):
    return torch.is_grad_enabled() and (input.requires_grad
                                        or weight.requires_grad)


@functools.lru_cache(maxsize=None)
def _op(transpose, weight_shape, stride, padding, output_padding, groups):
    """The autograd function of one convolution's configuration."""

    def transposed_padding(input_shape, output_shape):
        """The output padding under which the transposed convolution of an
        output of ``output_shape`` gives ``input_shape`` back."""
        if transpose:
            return (0, 0)
        return tuple(input_shape[i + 2] - (output_shape[i + 2] - 1)
                     * stride[i] + 2 * padding[i] - weight_shape[i + 2]
                     for i in range(2))

    def forward_op(x, w):
        if transpose:
            return F.conv_transpose2d(x, w, stride=stride, padding=padding,
                                      output_padding=output_padding,
                                      groups=groups)
        return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)

    class Conv2d(torch.autograd.Function):
        @staticmethod
        def forward(ctx, input, weight):
            ctx.save_for_backward(input if ctx.needs_input_grad[1] else None,
                                  weight if ctx.needs_input_grad[0] else None)
            ctx.input_shape = input.shape
            return forward_op(input, weight)

        @staticmethod
        def backward(ctx, grad_output):
            input, weight = ctx.saved_tensors
            grad_input = grad_weight = None
            if ctx.needs_input_grad[0]:
                p = transposed_padding(ctx.input_shape, grad_output.shape)
                grad_input = _op(not transpose, weight_shape, stride, padding,
                                 p, groups).apply(grad_output, weight)
            if ctx.needs_input_grad[1]:
                grad_weight = Conv2dGradWeight.apply(grad_output, input)
            return grad_input, grad_weight

    class Conv2dGradWeight(torch.autograd.Function):
        @staticmethod
        def forward(ctx, grad_output, input):
            ctx.save_for_backward(
                grad_output if ctx.needs_input_grad[1] else None,
                input if ctx.needs_input_grad[0] else None)
            ctx.input_shape = input.shape
            empty = grad_output.new_empty(()).expand(weight_shape)
            return torch.ops.aten.convolution_backward(
                grad_output, input, empty, None, stride, padding, (1, 1),
                transpose, output_padding, groups, [False, True, False])[1]

        @staticmethod
        def backward(ctx, grad2_grad_weight):
            grad_output, input = ctx.saved_tensors
            grad2_grad_output = grad2_input = None
            if ctx.needs_input_grad[0]:
                grad2_grad_output = Conv2d.apply(input, grad2_grad_weight)
            if ctx.needs_input_grad[1]:
                p = transposed_padding(ctx.input_shape, grad_output.shape)
                grad2_input = _op(not transpose, weight_shape, stride,
                                  padding, p, groups).apply(
                                      grad_output, grad2_grad_weight)
            return grad2_grad_output, grad2_input

    return Conv2d
