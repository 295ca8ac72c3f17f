"""EG3D super-resolution heads used by the flagship.

Counterpart of next3d_tpu/nn/superresolution.py (reference:
training_avatar_texture/superresolution.py): two synthesis blocks fed with
(32-ch features, 3-ch rgb) that reuse the last w three times, after an
(antialiased) bilinear resize of the input to ``input_resolution``.
``SuperresolutionHybrid8XDC`` is the 512^2 FFHQ head and ``...8X`` its
narrow twin; ``...4X`` serves 256^2 (its input is resized only when it is
smaller than 128^2) and ``...Deepfp32`` is the same head without the
antialiased resize; ``...2X`` serves the small 128^2 configurations. Both
blocks are ``use_fp16`` when ``sr_num_fp16_res > 0``, and run bf16 under
``force_fp32=False``.
"""

from __future__ import annotations

from torch import nn

from ..ops import interpolate_bilinear
from .stylegan2 import SynthesisBlock


def SynthesisBlockNoUp(*args, **kwargs):
    """SynthesisBlock without the upsampling (reference
    superresolution.py:158-257)."""
    return SynthesisBlock(*args, no_up=True, **kwargs)


class _SRBase(nn.Module):
    """Two blocks of ``widths`` channels at half of ``img_resolution``, then
    at ``img_resolution`` (the first without upsampling for ``no_up``),
    both ``use_fp16`` with the reference's conv clamp when
    ``sr_num_fp16_res > 0``."""

    _resize_only_if_smaller = False

    def __init__(self, channels, img_resolution, input_resolution, widths,
                 sr_num_fp16_res, sr_antialias, generator, block_kwargs,
                 no_up=False):
        super().__init__()
        self.input_resolution = input_resolution
        self.sr_antialias = sr_antialias
        # the reference ties the conv clamp to its fp16 flag
        fp16 = sr_num_fp16_res > 0
        kw = dict(w_dim=512, img_channels=3, conv_clamp=256 if fp16 else None,
                  use_fp16=fp16, generator=generator, **block_kwargs)
        self.block0 = (SynthesisBlockNoUp if no_up else SynthesisBlock)(
            channels, widths[0], resolution=img_resolution // 2, **kw)
        self.block1 = SynthesisBlock(widths[0], widths[1],
                                     resolution=img_resolution, **kw)

    def forward(self, rgb, x, ws, noise_mode='random', generator=None,
                force_fp32=True):
        ws = ws[:, -1:, :].repeat(1, 3, 1)
        if x.shape[-1] != self.input_resolution and not (
                self._resize_only_if_smaller
                and x.shape[-1] >= self.input_resolution):
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
        assert img_resolution == 512
        super().__init__(channels, img_resolution, 128, (256, 128),
                         sr_num_fp16_res, sr_antialias, generator,
                         block_kwargs)


class SuperresolutionHybrid8X(_SRBase):
    """128 -> 512 (reference: superresolution.py:29-56)."""

    def __init__(self, channels, img_resolution, sr_num_fp16_res, sr_antialias,
                 generator=None, **block_kwargs):
        assert img_resolution == 512
        super().__init__(channels, img_resolution, 128, (128, 64),
                         sr_num_fp16_res, sr_antialias, generator,
                         block_kwargs)


class SuperresolutionHybrid4X(_SRBase):
    """-> 256, resizing the input only if it is smaller than 128^2
    (reference: superresolution.py:62-88)."""

    _resize_only_if_smaller = True

    def __init__(self, channels, img_resolution, sr_num_fp16_res, sr_antialias,
                 generator=None, **block_kwargs):
        assert img_resolution == 256
        super().__init__(channels, img_resolution, 128, (128, 64),
                         sr_num_fp16_res, sr_antialias, generator,
                         block_kwargs, no_up=True)


class SuperresolutionHybridDeepfp32(SuperresolutionHybrid4X):
    """The legacy 256^2 head: 4X's structure, never an antialiased resize
    (reference: superresolution.py:126-153)."""

    def __init__(self, channels, img_resolution, sr_num_fp16_res,
                 sr_antialias=False, **kwargs):
        super().__init__(channels, img_resolution, sr_num_fp16_res,
                         sr_antialias=False, **kwargs)


class SuperresolutionHybrid2X(_SRBase):
    """64 -> 128 (reference: superresolution.py:94-121)."""

    def __init__(self, channels, img_resolution, sr_num_fp16_res, sr_antialias,
                 generator=None, **block_kwargs):
        assert img_resolution == 128
        super().__init__(channels, img_resolution, 64, (128, 64),
                         sr_num_fp16_res, sr_antialias, generator,
                         block_kwargs, no_up=True)
