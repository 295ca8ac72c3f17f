"""StyleUNet: StyleGAN2 synthesis with a conditioning-image encoder pyramid.

Counterpart of next3d_tpu/nn/styleunet.py (reference:
training_avatar_texture/networks_stylegan2_styleunet.py), with the same
reproduced quirks: blocks below ``final_size``'s successor are built (their
weights exist in checkpoints) but never run, the fusion convs are indexed
by loop position, and skipped blocks still consume their w slots.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops import downsample2d, setup_filter
from .stylegan2 import (Conv2d, MappingNetwork, SynthesisBlock, channels_for,
                        fp16_resolution, split_block_ws)


class EncoderResBlock(nn.Module):
    """fromrgb + 2 convs, the second downsamples (reference :97-115)."""

    def __init__(self, img_channel, in_channel, out_channel,
                 resample_filter=(1, 3, 3, 1), downsample=True,
                 generator=None):
        super().__init__()
        self.fromrgb = Conv2d(img_channel, in_channel, 1, activation='linear',
                              bias=False, generator=generator)
        self.conv1 = Conv2d(in_channel, in_channel, 3, activation='lrelu',
                            generator=generator)
        self.conv2 = Conv2d(in_channel, out_channel, 3, down=2,
                            activation='lrelu', generator=generator)
        self.register_buffer('resample_filter', torch.from_numpy(
            setup_filter(resample_filter)), persistent=False)
        self.downsample = downsample

    def forward(self, inp, skip=None):
        if self.downsample:
            inp = downsample2d(inp, self.resample_filter)
        out = self.fromrgb(inp)
        if skip is not None:
            out = out + skip
        out = self.conv1(out)
        out = self.conv2(out)
        return inp, out


class CondSynthesisNetwork(nn.Module):
    """StyleGAN2 synthesis with encoder-feature fusion (reference :493-595)."""

    def __init__(self, w_dim, img_resolution, img_channels, cond_channels=3,
                 in_size=64, final_size=4, channel_base=32768, channel_max=512,
                 num_fp16_res=4, num_cond_res=64, generator=None,
                 **block_kwargs):
        super().__init__()
        assert img_resolution >= 4 and \
            (img_resolution & (img_resolution - 1)) == 0
        self.final_size = final_size
        self.num_cond_res = num_cond_res
        self.block_resolutions = [2 ** i for i in range(
            2, int(np.log2(img_resolution)) + 1)]
        channels = {res: channels_for(res, channel_base, channel_max)
                    for res in self.block_resolutions}
        fp16_res = fp16_resolution(img_resolution, num_fp16_res)
        self.num_ws = 0
        for res in self.block_resolutions:
            block = SynthesisBlock(
                channels[res // 2] if res > 4 else 0, channels[res],
                w_dim=w_dim, resolution=res, img_channels=img_channels,
                use_fp16=res >= fp16_res, generator=generator,
                **block_kwargs)
            self.num_ws += block.num_conv
            if res == img_resolution:
                self.num_ws += block.num_torgb
            setattr(self, f'b{res}', block)

        # encoder pyramid: in_size -> final_size (reference :536-542)
        encoder_res = [2 ** i for i in range(int(np.log2(in_size)),
                                             int(np.log2(final_size)) - 1, -1)]
        self.encoder = nn.ModuleList([
            EncoderResBlock(cond_channels, channels[res], channels[res // 2],
                            downsample=(res < in_size), generator=generator)
            for res in encoder_res[:-1]])
        # fusion convs, ascending resolutions (reference :544-552)
        self.fusion = nn.ModuleList([
            Conv2d(channels[res] * (2 if res > final_size else 1),
                   channels[res], kernel_size=3, activation='linear',
                   bias=True, generator=generator)
            for res in encoder_res[::-1]])

    def forward(self, x_in, ws, noise_mode='random', generator=None,
                fused_modconv=False, force_fp32=True):
        assert ws.shape[1] == self.num_ws, (ws.shape, self.num_ws)
        blocks = [getattr(self, f'b{res}') for res in self.block_resolutions]
        block_ws = split_block_ws(blocks, ws.float())

        # with force_fp32=False the encoder and fusion convolutions run
        # bf16 too (JAX :144-149); a fusion input that mixes a float32 block
        # output with a bf16 feature is float32, as in JAX
        if not force_fp32:
            x_in = x_in.to(torch.bfloat16)
        cond_list = []
        cond_out = None
        for enc in self.encoder:
            x_in, cond_out = enc(x_in, cond_out)
            cond_list.append(cond_out)
        cond_list = cond_list[::-1]  # ascending: final_size .. in_size/2

        start = int(np.log2(self.final_size)) - 1
        x = img = None
        for index, (block, cur_ws) in enumerate(zip(blocks[start:],
                                                    block_ws[start:])):
            if 2 ** (index + int(np.log2(self.final_size))) \
                    < self.num_cond_res:
                if index == 0:
                    x = self.fusion[index](cond_list[index])
                else:
                    x = self.fusion[index](
                        torch.cat([x, cond_list[index]], dim=1))
            x, img = block(x, img, cur_ws, force_fp32=force_fp32,
                           fused_modconv=fused_modconv,
                           noise_mode=noise_mode, generator=generator)
        return img


class CondGenerator(nn.Module):
    """mapping + conditional synthesis (reference :599-625)."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 mapping_ws=-1, mapping_kwargs=None, generator=None,
                 **synthesis_kwargs):
        super().__init__()
        self.synthesis = CondSynthesisNetwork(
            w_dim=w_dim, img_resolution=img_resolution,
            img_channels=img_channels, generator=generator,
            **synthesis_kwargs)
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(
            z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
            num_ws=self.num_ws if mapping_ws == -1 else mapping_ws,
            generator=generator, **(mapping_kwargs or {}))
