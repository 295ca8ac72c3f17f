"""Tiny tri-plane MLP decoder.

Counterpart of next3d_tpu/models/osg_decoder.py (reference:
triplane_next3d.py:348-371): mean over the 3 planes, FC(32->64) ->
softplus -> FC(64->33); rgb through the MipNeRF sigmoid clamp, the first
channel is raw sigma. Ray directions are ignored. The matmuls stay
``torch.matmul``: the JAX package computes them outside any Pallas kernel.
With the ``decoder_bf16`` option the plane mean is taken in float32, the
two FCs run bf16, and the output goes back to float32 before the sigmoid
(JAX :21-41).
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.stylegan2 import FullyConnected


class OSGDecoder(nn.Module):
    def __init__(self, n_features, options=None, generator=None):
        super().__init__()
        options = options or {}
        lr_mul = options.get('decoder_lr_mul', 1)
        out_dim = options.get('decoder_output_dim', 32)
        self.bf16 = bool(options.get('decoder_bf16', False))
        # torch Sequential indices give the JAX tree's 'net.0' / 'net.2'
        self.net = nn.Sequential(
            FullyConnected(n_features, 64, lr_multiplier=lr_mul,
                           generator=generator),
            nn.Softplus(),
            FullyConnected(64, 1 + out_dim, lr_multiplier=lr_mul,
                           generator=generator))

    def forward(self, sampled_features, ray_directions=None):
        x = sampled_features.mean(dim=1)  # (N, M, C)
        N, M, C = x.shape
        x = x.reshape(N * M, C)
        if self.bf16:
            x = x.to(torch.bfloat16)
        x = self.net(x).float().reshape(N, M, -1)
        rgb = torch.sigmoid(x[..., 1:]) * (1 + 2 * 0.001) - 0.001
        return {'rgb': rgb, 'sigma': x[..., 0:1]}
