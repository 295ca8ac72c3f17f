"""The dual discriminator: resnet blocks, the minibatch-std epilogue, and
the 6-channel input of the image beside its upsampled raw render.

Counterpart of next3d_tpu/nn/discriminator.py (reference:
training_avatar_texture/networks_stylegan2.py:687-925 and
dual_discriminator.py). Module and parameter names are the JAX parameter
tree's (``b512.conv0.weight``, ``mapping.embed.bias``, ``b4.fc.weight``
...), so ``utils.weights.load_jax_params`` loads a JAX tree strictly.
Parameters are drawn at construction from ``generator`` with the JAX
``init`` distributions. The port runs float32 only (the loss runs D with
``force_fp32=True`` in the JAX package too). No kernel of the port lies on
this path: R1 differentiates it twice, and every op here (convolutions,
``F.interpolate``, the FIR filters, bias_act, minibatch-std) has a double
backward.

Beside ``DualDiscriminator``: ``DualLabelDualDiscriminator`` (a second
label mapping for the expression label, ``--gen-exp-cond``),
``DummyDualDiscriminator`` (the raw branch faded out over 500k images) and
``SingleDiscriminator`` (the image alone).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops import downsample2d, interpolate_bilinear, setup_filter, upsample2d
from .stylegan2 import Conv2d, FullyConnected, MappingNetwork, channels_for


class DiscriminatorBlock(nn.Module):
    """resnet downsampling block (JAX :21-95). Layers with an index below
    ``freeze_layers`` are built with ``trainable=False``."""

    def __init__(self, in_channels, tmp_channels, out_channels, resolution,
                 img_channels, first_layer_idx, architecture='resnet',
                 activation='lrelu', resample_filter=(1, 3, 3, 1),
                 conv_clamp=None, freeze_layers=0, generator=None):
        super().__init__()
        assert in_channels in (0, tmp_channels)
        self.in_channels = in_channels
        self.architecture = architecture
        self.register_buffer('resample_filter', torch.from_numpy(
            setup_filter(resample_filter)), persistent=False)
        self.num_layers = 0

        def trainable():
            idx = first_layer_idx + self.num_layers
            self.num_layers += 1
            return idx >= freeze_layers

        conv = dict(activation=activation, conv_clamp=conv_clamp,
                    generator=generator)
        self.fromrgb = None
        if in_channels == 0 or architecture == 'skip':
            self.fromrgb = Conv2d(img_channels, tmp_channels, 1,
                                  trainable=trainable(), **conv)
        self.conv0 = Conv2d(tmp_channels, tmp_channels, 3,
                            trainable=trainable(), **conv)
        self.conv1 = Conv2d(tmp_channels, out_channels, 3, down=2,
                            trainable=trainable(),
                            resample_filter=resample_filter, **conv)
        self.skip = None
        if architecture == 'resnet':
            self.skip = Conv2d(tmp_channels, out_channels, 1, bias=False,
                               down=2, trainable=trainable(),
                               resample_filter=resample_filter,
                               generator=generator)

    def frozen_subnames(self):
        return [name for name in ('fromrgb', 'conv0', 'conv1', 'skip')
                if getattr(self, name) is not None
                and not getattr(self, name).trainable]

    def forward(self, x, img):
        if self.in_channels == 0 or self.architecture == 'skip':
            y = self.fromrgb(img)
            x = x + y if x is not None else y
            img = downsample2d(img, self.resample_filter) \
                if self.architecture == 'skip' else None
        if self.architecture == 'resnet':
            y = self.skip(x, gain=math.sqrt(0.5))
            x = self.conv0(x)
            x = self.conv1(x, gain=math.sqrt(0.5))
            return y + x, img
        return self.conv1(self.conv0(x)), img


def minibatch_std(x, group_size=4, num_channels=1):
    """JAX :98-111 (reference networks_stylegan2.py:776-797)."""
    N, C, H, W = x.shape
    G = min(group_size, N) if group_size is not None else N
    F = num_channels
    y = x.reshape(G, -1, F, C // F, H, W)
    y = y - y.mean(dim=0)
    y = y.square().mean(dim=0)
    y = (y + 1e-8).sqrt()
    y = y.mean(dim=(2, 3, 4))
    y = y.reshape(-1, F, 1, 1).repeat(G, 1, H, W)
    return torch.cat([x, y], dim=1)


class DiscriminatorEpilogue(nn.Module):
    """mbstd + conv + fc + cmap projection (JAX :114-158)."""

    def __init__(self, in_channels, cmap_dim, resolution, img_channels,
                 architecture='resnet', mbstd_group_size=4,
                 mbstd_num_channels=1, activation='lrelu', conv_clamp=None,
                 generator=None):
        super().__init__()
        self.cmap_dim = cmap_dim
        self.architecture = architecture
        self.mbstd_group_size = mbstd_group_size
        self.mbstd_num_channels = mbstd_num_channels
        self.fromrgb = Conv2d(img_channels, in_channels, 1,
                              activation=activation, generator=generator) \
            if architecture == 'skip' else None
        self.conv = Conv2d(in_channels + mbstd_num_channels, in_channels, 3,
                           activation=activation, conv_clamp=conv_clamp,
                           generator=generator)
        self.fc = FullyConnected(in_channels * resolution ** 2, in_channels,
                                 activation=activation, generator=generator)
        self.out = FullyConnected(in_channels, 1 if cmap_dim == 0
                                  else cmap_dim, generator=generator)

    def forward(self, x, img, cmap):
        if self.architecture == 'skip':
            x = x + self.fromrgb(img)
        if self.mbstd_num_channels > 0:
            x = minibatch_std(x, self.mbstd_group_size,
                              self.mbstd_num_channels)
        x = self.conv(x)
        x = self.out(self.fc(x.flatten(1)))
        if self.cmap_dim > 0:
            x = (x * cmap).sum(dim=1, keepdim=True) \
                * (1 / math.sqrt(self.cmap_dim))
        return x


class Discriminator(nn.Module):
    """Plain StyleGAN2 D (JAX :161-230); blocks ``b<res>``, the label
    mapping ``mapping`` and the epilogue ``b4``. Float32 only: the JAX
    ``num_fp16_res`` is not taken."""

    def __init__(self, c_dim, img_resolution, img_channels,
                 architecture='resnet', channel_base=32768, channel_max=512,
                 conv_clamp=256, cmap_dim=None,
                 block_kwargs=None, mapping_kwargs=None,
                 epilogue_kwargs=None, generator=None):
        super().__init__()
        self.c_dim = c_dim
        log2 = int(np.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(log2, 2, -1)]
        channels = {res: channels_for(res, channel_base, channel_max)
                    for res in self.block_resolutions + [4]}
        if cmap_dim is None:
            cmap_dim = channels[4]
        if c_dim == 0:
            cmap_dim = 0
        self.cmap_dim = cmap_dim
        common = dict(img_channels=img_channels, architecture=architecture,
                      conv_clamp=conv_clamp, generator=generator)
        layer_idx = 0
        for res in self.block_resolutions:
            block = DiscriminatorBlock(
                channels[res] if res < img_resolution else 0, channels[res],
                channels[res // 2], resolution=res,
                first_layer_idx=layer_idx, **(block_kwargs or {}), **common)
            setattr(self, f'b{res}', block)
            layer_idx += block.num_layers
        self.mapping = None
        if c_dim > 0:
            self.mapping = MappingNetwork(
                z_dim=0, c_dim=c_dim, w_dim=cmap_dim, num_ws=None,
                w_avg_beta=None, generator=generator,
                **(mapping_kwargs or {}))
        self.b4 = DiscriminatorEpilogue(channels[4], cmap_dim=cmap_dim,
                                        resolution=4,
                                        **(epilogue_kwargs or {}), **common)

    def forward(self, img, c):
        x = None
        for res in self.block_resolutions:
            x, img = getattr(self, f'b{res}')(x, img)
        cmap = self.mapping(None, c) if self.c_dim > 0 else None
        return self.b4(x, img, cmap)

    def frozen_paths(self):
        """Parameter-path prefixes that ``freeze_layers`` freezes."""
        return [(f'b{res}', name) for res in self.block_resolutions
                for name in getattr(self, f'b{res}').frozen_subnames()]


def filtered_resizing(image_orig_tensor, size, f, filter_mode='antialiased'):
    """JAX :233-248 (reference dual_discriminator.py:86-102)."""
    if filter_mode == 'antialiased':
        return interpolate_bilinear(image_orig_tensor, size, antialias=True)
    if filter_mode == 'classic':
        x = upsample2d(image_orig_tensor, f, up=2)
        x = interpolate_bilinear(x, size * 2 + 2, antialias=False)
        return downsample2d(x, f, down=2, flip_filter=True, padding=-1)
    if filter_mode == 'none':
        return interpolate_bilinear(image_orig_tensor, size, antialias=False)
    if isinstance(filter_mode, float):
        assert 0 < filter_mode < 1
        filtered = interpolate_bilinear(image_orig_tensor, size,
                                        antialias=True)
        aliased = interpolate_bilinear(image_orig_tensor, size,
                                       antialias=False)
        return (1 - filter_mode) * aliased + filter_mode * filtered
    raise ValueError(filter_mode)


class DualDiscriminator(Discriminator):
    """The 512^2 image concatenated with its raw render upsampled to it:
    a 6-channel D (JAX :251-277), whose parameters sit at the root of the
    state_dict as in the JAX tree."""

    def __init__(self, c_dim, img_resolution, img_channels, disc_c_noise=0,
                 generator=None, **disc_kwargs):
        super().__init__(c_dim, img_resolution, img_channels * 2,
                         generator=generator, **disc_kwargs)
        self.disc_c_noise = disc_c_noise
        self.register_buffer('resample_filter', torch.from_numpy(
            setup_filter([1, 3, 3, 1])), persistent=False)

    def forward(self, img, c, generator=None):
        """img: dict of 'image' (N, 3, R, R) and 'image_raw' (N, 3, r, r).
        A positive ``disc_c_noise`` adds noise of std(c) times it to the
        labels, drawn from ``generator``."""
        image_raw = filtered_resizing(img['image_raw'],
                                      size=img['image'].shape[-1],
                                      f=self.resample_filter)
        x = torch.cat([img['image'], image_raw], dim=1)
        if self.c_dim > 0 and self.disc_c_noise > 0:
            c = _label_noise(c, self.disc_c_noise, generator)
        return super().forward(x, c)


def _label_noise(c, scale, generator):
    """c + N(0, 1) * std(c over the batch) * scale, the noise drawn from
    ``generator`` (JAX :268-270; ``jnp.std``, the population std)."""
    if generator is None:
        raise ValueError('disc_c_noise needs a generator')
    return c + torch.randn(c.shape, generator=generator, device=c.device) \
        * c.std(dim=0, unbiased=False) * scale


class DualLabelDualDiscriminator(nn.Module):
    """The dual discriminator with a second label mapping (JAX :280-358):
    the label is the 25-wide camera label beside the ``c2_dim``-wide
    expression label, each mapped by its own network (``mapping``, to
    ``cmap_dim``; ``mapping2``, to 32), and the epilogue projects onto the
    two cmaps concatenated. Its blocks, ``mapping``, ``mapping2`` and ``b4``
    sit at the root of the state_dict as in the JAX tree."""

    def __init__(self, c_dim, c2_dim, img_resolution, img_channels,
                 architecture='resnet', channel_base=32768, channel_max=512,
                 conv_clamp=256, cmap_dim=None, disc_c_noise=0,
                 block_kwargs=None, mapping_kwargs=None,
                 epilogue_kwargs=None, generator=None):
        super().__init__()
        img_channels *= 2
        self.c_dim = c_dim
        self.c2_dim = c2_dim
        self.disc_c_noise = disc_c_noise
        log2 = int(np.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(log2, 2, -1)]
        channels = {res: channels_for(res, channel_base, channel_max)
                    for res in self.block_resolutions + [4]}
        if cmap_dim is None:
            cmap_dim = channels[4]
        if c_dim == 0:
            cmap_dim = 0
        self.cmap_dim = cmap_dim
        self.register_buffer('resample_filter', torch.from_numpy(
            setup_filter([1, 3, 3, 1])), persistent=False)
        common = dict(img_channels=img_channels, architecture=architecture,
                      conv_clamp=conv_clamp, generator=generator)
        layer_idx = 0
        for res in self.block_resolutions:
            block = DiscriminatorBlock(
                channels[res] if res < img_resolution else 0, channels[res],
                channels[res // 2], resolution=res,
                first_layer_idx=layer_idx, **(block_kwargs or {}), **common)
            setattr(self, f'b{res}', block)
            layer_idx += block.num_layers
        mapping = dict(z_dim=0, num_ws=None, w_avg_beta=None,
                       generator=generator, **(mapping_kwargs or {}))
        self.mapping = MappingNetwork(c_dim=c_dim, w_dim=cmap_dim, **mapping)
        self.mapping2 = MappingNetwork(c_dim=c2_dim, w_dim=32, **mapping)
        self.b4 = DiscriminatorEpilogue(channels[4], cmap_dim=cmap_dim + 32,
                                        resolution=4,
                                        **(epilogue_kwargs or {}), **common)

    def forward(self, img, c, generator=None):
        """img: dict of 'image' and 'image_raw'; c: (N, c_dim + c2_dim)."""
        c1, c2 = c[:, :self.c_dim], c[:, self.c_dim:]
        if c2.shape[1] != self.c2_dim:
            raise ValueError(f'the label must hold {self.c_dim} + '
                             f'{self.c2_dim} columns, got {c.shape[1]}')
        image_raw = filtered_resizing(img['image_raw'],
                                      size=img['image'].shape[-1],
                                      f=self.resample_filter)
        x_img = torch.cat([img['image'], image_raw], dim=1)
        if self.disc_c_noise > 0:
            c1 = _label_noise(c1, self.disc_c_noise, generator)
            c2 = _label_noise(c2, self.disc_c_noise, generator)
        x = None
        for res in self.block_resolutions:
            x, x_img = getattr(self, f'b{res}')(x, x_img)
        cmap = torch.cat([self.mapping(None, c1), self.mapping2(None, c2)],
                         dim=1)
        return self.b4(x, x_img, cmap)

    frozen_paths = Discriminator.frozen_paths


class DummyDualDiscriminator(Discriminator):
    """The dual discriminator whose raw branch fades out over the first
    500k images (JAX :361-381): the upsampled raw image is scaled by
    max(0, 1 - cur_nimg / 500000), ``cur_nimg`` given to each call."""

    def __init__(self, c_dim, img_resolution, img_channels, generator=None,
                 **disc_kwargs):
        super().__init__(c_dim, img_resolution, img_channels * 2,
                         generator=generator, **disc_kwargs)
        self.register_buffer('resample_filter', torch.from_numpy(
            setup_filter([1, 3, 3, 1])), persistent=False)

    def forward(self, img, c, generator=None, cur_nimg=0):
        raw_fade = max(0.0, 1.0 - cur_nimg / 500000.0)
        image_raw = filtered_resizing(img['image_raw'],
                                      size=img['image'].shape[-1],
                                      f=self.resample_filter) * raw_fade
        return super().forward(torch.cat([img['image'], image_raw], dim=1), c)


class SingleDiscriminator(Discriminator):
    """D on the full-resolution image alone (JAX :384-403); ``img`` is the
    image or a dict holding it under 'image'."""

    def __init__(self, c_dim, img_resolution, img_channels, disc_c_noise=0,
                 generator=None, **disc_kwargs):
        super().__init__(c_dim, img_resolution, img_channels,
                         generator=generator, **disc_kwargs)
        self.disc_c_noise = disc_c_noise

    def forward(self, img, c, generator=None):
        x = img['image'] if isinstance(img, dict) else img
        if self.c_dim > 0 and self.disc_c_noise > 0:
            c = _label_noise(c, self.disc_c_noise, generator)
        return super().forward(x, c)
