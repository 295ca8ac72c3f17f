"""EG3D super-resolution heads used by the flagship.

Counterpart of next3d_tpu/nn/superresolution.py (reference:
training_avatar_texture/superresolution.py): two synthesis blocks fed with
(32-ch features, 3-ch rgb) that reuse the last w three times, after an
(antialiased) bilinear resize of the input to ``input_resolution``.
``SuperresolutionHybrid8XDC`` is the 512^2 FFHQ head; ``...2X`` serves the
small 128^2 configurations. Both blocks are ``use_fp16`` when
``sr_num_fp16_res > 0``, and run bf16 under ``force_fp32=False``.
"""

from __future__ import annotations

from torch import nn

from ..ops import interpolate_bilinear
from .stylegan2 import SynthesisBlock


class _SRBase(nn.Module):
    input_resolution: int

    def forward(self, rgb, x, ws, noise_mode='random', generator=None,
                force_fp32=True):
        ws = ws[:, -1:, :].repeat(1, 3, 1)
        if x.shape[-1] != self.input_resolution:
            x = interpolate_bilinear(x, self.input_resolution,
                                     antialias=self.sr_antialias)
            rgb = interpolate_bilinear(rgb, self.input_resolution,
                                       antialias=self.sr_antialias)
        kw = dict(noise_mode=noise_mode, generator=generator,
                  force_fp32=force_fp32)
        x, rgb = self.block0(x, rgb, ws, **kw)
        x, rgb = self.block1(x, rgb, ws, **kw)
        return rgb


class SuperresolutionHybrid8XDC(_SRBase):
    """128 -> 512, deep channels (reference: superresolution.py:264-290)."""

    def __init__(self, channels, img_resolution, sr_num_fp16_res, sr_antialias,
                 generator=None, **block_kwargs):
        super().__init__()
        assert img_resolution == 512
        # the reference ties the conv clamp to its fp16 flag
        fp16 = sr_num_fp16_res > 0
        clamp = 256 if fp16 else None
        self.input_resolution = 128
        self.sr_antialias = sr_antialias
        self.block0 = SynthesisBlock(channels, 256, w_dim=512, resolution=256,
                                     img_channels=3, conv_clamp=clamp,
                                     use_fp16=fp16, generator=generator,
                                     **block_kwargs)
        self.block1 = SynthesisBlock(256, 128, w_dim=512, resolution=512,
                                     img_channels=3, conv_clamp=clamp,
                                     use_fp16=fp16, generator=generator,
                                     **block_kwargs)


class SuperresolutionHybrid2X(_SRBase):
    """64 -> 128 (reference: superresolution.py:94-121)."""

    def __init__(self, channels, img_resolution, sr_num_fp16_res, sr_antialias,
                 generator=None, **block_kwargs):
        super().__init__()
        assert img_resolution == 128
        fp16 = sr_num_fp16_res > 0
        clamp = 256 if fp16 else None
        self.input_resolution = 64
        self.sr_antialias = sr_antialias
        self.block0 = SynthesisBlock(channels, 128, w_dim=512, resolution=64,
                                     img_channels=3, conv_clamp=clamp,
                                     use_fp16=fp16, no_up=True,
                                     generator=generator, **block_kwargs)
        self.block1 = SynthesisBlock(128, 64, w_dim=512, resolution=128,
                                     img_channels=3, conv_clamp=clamp,
                                     use_fp16=fp16, generator=generator,
                                     **block_kwargs)
