"""StyleGAN2 modules as torch ``nn.Module``s.

Counterpart of next3d_tpu/nn/stylegan2.py (reference:
training_avatar_texture/networks_stylegan2.py). Parameter and buffer names
equal the JAX parameter tree's dotted paths (``fc0.weight``,
``b64.conv1.affine.bias``, ``w_avg``, ``noise_const`` ...), so
``utils.weights.load_jax_params`` loads a JAX tree with ``strict=True``.
FIR filters are non-persistent buffers: they follow from the config.

Parameters are drawn at construction from ``generator`` (a
``torch.Generator``, or torch's default one when None) with the JAX
``init`` distributions. Noise in ``noise_mode='random'`` is drawn from the
``generator`` passed to ``forward``, which must live on the input's device.

Precision follows the JAX package's policy by explicit casts, not by
autocast: parameters stay float32, and a block built with ``use_fp16``
(the top ``num_fp16_res`` resolutions of a synthesis network) runs in
bfloat16 when its forward gets ``force_fp32=False``. There its activations
are bf16, each weight, bias, style, noise and demodulation coefficient is
cast to bf16 where it is used, and modulated_conv2d pre-normalizes the
weights and styles; its ToRGB output goes back to float32. With
``force_fp32=True``, the default, everything runs float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops import bias_act, conv2d_resample, setup_filter, upsample2d
from ..ops.bias_act import activation_funcs
from ..init import randn

# the reduced-precision types in which modulated_conv2d pre-normalizes
REDUCED = (torch.bfloat16, torch.float16)


def normalize_2nd_moment(x, dim=1, eps=1e-8):
    return x * (x.square().mean(dim=dim, keepdim=True) + eps).rsqrt()


def modulated_conv2d(x, weight, styles, noise=None, up=1, down=1, padding=0,
                     resample_filter=None, demodulate=True, flip_weight=True,
                     fused_modconv=True):
    """Weight (de)modulation (reference: networks_stylegan2.py:34-91).

    x: (N, I, H, W); weight: (O, I, kh, kw); styles: (N, I).
    """
    batch_size = x.shape[0]
    out_channels, in_channels, kh, kw = weight.shape

    # pre-normalize in reduced precision (reference :54-56; JAX :44-52)
    if x.dtype in REDUCED and demodulate:
        w_norm = weight.abs().amax(dim=[1, 2, 3], keepdim=True)
        weight = weight * (1 / math.sqrt(in_channels * kh * kw) / w_norm)
        styles = styles / styles.abs().amax(dim=1, keepdim=True)

    w = None
    dcoefs = None
    if demodulate or fused_modconv:
        w = weight[None] * styles.reshape(batch_size, 1, -1, 1, 1)
    if demodulate:
        dcoefs = (w.square().sum(dim=[2, 3, 4]) + 1e-8).rsqrt()  # (N, O)
    if demodulate and fused_modconv:
        w = w * dcoefs.reshape(batch_size, -1, 1, 1, 1)

    if not fused_modconv:
        x = x * styles.to(x.dtype).reshape(batch_size, -1, 1, 1)
        x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up,
                            down=down, padding=padding,
                            flip_weight=flip_weight)
        if demodulate:
            x = x * dcoefs.to(x.dtype).reshape(batch_size, -1, 1, 1)
        if noise is not None:
            x = x + noise.to(x.dtype)
        return x

    # fused: the batch becomes conv groups (reference :81-91)
    x = x.reshape(1, -1, *x.shape[2:])
    w = w.reshape(-1, in_channels, kh, kw)
    x = conv2d_resample(x, w.to(x.dtype), f=resample_filter, up=up,
                        down=down, padding=padding, groups=batch_size,
                        flip_weight=flip_weight)
    x = x.reshape(batch_size, -1, *x.shape[2:])
    if noise is not None:
        x = x + noise
    return x


class FullyConnected(nn.Module):
    """Equalized-lr linear (reference: networks_stylegan2.py:96-130)."""

    def __init__(self, in_features, out_features, bias=True,
                 activation='linear', lr_multiplier=1, bias_init=0,
                 weight_init=1, generator=None):
        super().__init__()
        self.activation = activation
        self.weight_gain = lr_multiplier / math.sqrt(in_features)
        self.bias_gain = lr_multiplier
        self.weight = nn.Parameter(randn(
            out_features, in_features, generator=generator,
            scale=weight_init / lr_multiplier))
        if bias:
            b = np.broadcast_to(np.asarray(bias_init, np.float32),
                                (out_features,)) / lr_multiplier
            self.bias = nn.Parameter(torch.tensor(b, dtype=torch.float32))
        else:
            self.register_parameter('bias', None)

    def forward(self, x):
        # cast, then scale, in x's dtype (JAX :117-127)
        w = self.weight.to(x.dtype) * self.weight_gain
        b = self.bias
        if b is not None:
            b = b.to(x.dtype)
            if self.bias_gain != 1:
                b = b * self.bias_gain
        return bias_act(torch.matmul(x, w.t()), b, act=self.activation)


class Conv2d(nn.Module):
    """Equalized-lr conv with optional FIR downsampling
    (reference: networks_stylegan2.py:135-188). ``trainable=False`` marks a
    layer that the discriminator's ``freeze_layers`` freezes: the training
    step leaves it out of the optimizer."""

    def __init__(self, in_channels, out_channels, kernel_size, bias=True,
                 activation='linear', down=1, resample_filter=(1, 3, 3, 1),
                 conv_clamp=None, trainable=True, generator=None):
        super().__init__()
        self.activation = activation
        self.down = down
        self.conv_clamp = conv_clamp
        self.trainable = trainable
        self.register_buffer('resample_filter', torch.from_numpy(
            setup_filter(resample_filter)), persistent=False)
        self.padding = kernel_size // 2
        self.weight_gain = 1 / math.sqrt(in_channels * kernel_size ** 2)
        self.act_gain = activation_funcs[activation].def_gain
        self.weight = nn.Parameter(randn(
            out_channels, in_channels, kernel_size, kernel_size,
            generator=generator))
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_channels))
        else:
            self.register_parameter('bias', None)

    def forward(self, x, gain=1):
        x = conv2d_resample(x, (self.weight * self.weight_gain).to(x.dtype),
                            f=self.resample_filter, down=self.down,
                            padding=self.padding)
        clamp = self.conv_clamp * gain if self.conv_clamp is not None \
            else None
        return bias_act(x, self.bias, act=self.activation,
                        gain=self.act_gain * gain, clamp=clamp)


class MappingNetwork(nn.Module):
    """z/c -> broadcast w (reference: networks_stylegan2.py:193-271)."""

    def __init__(self, z_dim, c_dim, w_dim, num_ws, num_layers=8,
                 embed_features=None, layer_features=None, activation='lrelu',
                 lr_multiplier=0.01, w_avg_beta=0.998, generator=None):
        super().__init__()
        self.z_dim = z_dim
        self.c_dim = c_dim
        self.w_dim = w_dim
        self.num_ws = num_ws
        self.num_layers = num_layers
        if embed_features is None:
            embed_features = w_dim
        if c_dim == 0:
            embed_features = 0
        if layer_features is None:
            layer_features = w_dim
        features = [z_dim + embed_features] + [layer_features] \
            * (num_layers - 1) + [w_dim]
        # JAX init draws the layers before the embedding; the order of
        # draws from one torch.Generator does not matter for the
        # distributions, only the module names do
        for i in range(num_layers):
            setattr(self, f'fc{i}', FullyConnected(
                features[i], features[i + 1], activation=activation,
                lr_multiplier=lr_multiplier, generator=generator))
        self.embed = FullyConnected(c_dim, embed_features,
                                    generator=generator) if c_dim > 0 else None
        if num_ws is not None and w_avg_beta is not None:
            self.register_buffer('w_avg', torch.zeros(w_dim))

    def forward(self, z, c, truncation_psi=1, truncation_cutoff=None,
                return_w_mean=False):
        """ws; with ``return_w_mean`` also the batch mean of w before the
        broadcast, detached: the training step folds it into the ``w_avg``
        buffer (JAX :215-241), which this forward never updates."""
        x = None
        if self.z_dim > 0:
            x = normalize_2nd_moment(z.float())
        if self.c_dim > 0:
            y = normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, y], dim=1) if x is not None else y
        for i in range(self.num_layers):
            x = getattr(self, f'fc{i}')(x)
        w_mean = x.detach().mean(dim=0) if return_w_mean else None
        if self.num_ws is not None:
            x = x[:, None, :].repeat(1, self.num_ws, 1)
        if truncation_psi != 1:
            w_avg = self.w_avg
            if self.num_ws is None or truncation_cutoff is None:
                x = w_avg + truncation_psi * (x - w_avg)
            else:
                head = w_avg + truncation_psi * (x[:, :truncation_cutoff]
                                                 - w_avg)
                x = torch.cat([head, x[:, truncation_cutoff:]], dim=1)
        return (x, w_mean) if return_w_mean else x


class SynthesisLayer(nn.Module):
    """modconv + noise + bias_act (reference: networks_stylegan2.py:276-335)."""

    def __init__(self, in_channels, out_channels, w_dim, resolution,
                 kernel_size=3, up=1, use_noise=True, activation='lrelu',
                 resample_filter=(1, 3, 3, 1), conv_clamp=None,
                 generator=None):
        super().__init__()
        self.resolution = resolution
        self.up = up
        self.use_noise = use_noise
        self.activation = activation
        self.conv_clamp = conv_clamp
        self.register_buffer('resample_filter', torch.from_numpy(
            setup_filter(resample_filter)), persistent=False)
        self.padding = kernel_size // 2
        self.act_gain = activation_funcs[activation].def_gain
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1,
                                     generator=generator)
        self.weight = nn.Parameter(randn(
            out_channels, in_channels, kernel_size, kernel_size,
            generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        if use_noise:
            self.register_buffer('noise_const', randn(
                resolution, resolution, generator=generator))
            self.noise_strength = nn.Parameter(torch.zeros(()))

    def forward(self, x, w, noise_mode='random', generator=None,
                fused_modconv=True, gain=1):
        assert noise_mode in ('random', 'const', 'none')
        styles = self.affine(w)
        noise = None
        if self.use_noise and noise_mode == 'random':
            noise = torch.randn(x.shape[0], 1, self.resolution,
                                self.resolution, generator=generator,
                                device=x.device).to(x.dtype) \
                * self.noise_strength.to(x.dtype)
        if self.use_noise and noise_mode == 'const':
            noise = (self.noise_const * self.noise_strength).to(x.dtype)
        x = modulated_conv2d(x, self.weight, styles, noise=noise, up=self.up,
                             padding=self.padding,
                             resample_filter=self.resample_filter,
                             flip_weight=(self.up == 1),
                             fused_modconv=fused_modconv)
        act_gain = self.act_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None \
            else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain,
                        clamp=act_clamp)


class ToRGBLayer(nn.Module):
    """1x1 non-demodulated modconv (reference: networks_stylegan2.py:340-360)."""

    def __init__(self, in_channels, out_channels, w_dim, kernel_size=1,
                 conv_clamp=None, generator=None):
        super().__init__()
        self.conv_clamp = conv_clamp
        self.affine = FullyConnected(w_dim, in_channels, bias_init=1,
                                     generator=generator)
        self.weight_gain = 1 / math.sqrt(in_channels * kernel_size ** 2)
        self.weight = nn.Parameter(randn(
            out_channels, in_channels, kernel_size, kernel_size,
            generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x, w, fused_modconv=True):
        styles = self.affine(w) * self.weight_gain
        x = modulated_conv2d(x, self.weight, styles, demodulate=False,
                             fused_modconv=fused_modconv)
        return bias_act(x, self.bias, clamp=self.conv_clamp)


class SynthesisBlock(nn.Module):
    """One resolution block of the skip architecture, RGB accumulated
    through ToRGB (reference: networks_stylegan2.py:492-591). ``no_up=True``
    gives the superresolution variant SynthesisBlockNoUp
    (superresolution.py:158-257). Modulation is unfused by default, as in
    the JAX package (both forms are equal in float32). With ``use_fp16``
    the block runs bfloat16 unless its forward gets ``force_fp32=True``
    (JAX :404-407).
    """

    def __init__(self, in_channels, out_channels, w_dim, resolution,
                 img_channels, resample_filter=(1, 3, 3, 1), conv_clamp=256,
                 use_fp16=False, no_up=False, generator=None,
                 **layer_kwargs):
        super().__init__()
        self.use_fp16 = use_fp16
        self.no_up = no_up
        self.register_buffer('resample_filter', torch.from_numpy(
            setup_filter(resample_filter)), persistent=False)
        if in_channels == 0:
            self.const = nn.Parameter(randn(
                out_channels, resolution, resolution, generator=generator))
            self.conv0 = None
        else:
            self.conv0 = SynthesisLayer(
                in_channels, out_channels, w_dim=w_dim, resolution=resolution,
                up=1 if no_up else 2, resample_filter=resample_filter,
                conv_clamp=conv_clamp, generator=generator, **layer_kwargs)
        self.conv1 = SynthesisLayer(out_channels, out_channels, w_dim=w_dim,
                                    resolution=resolution,
                                    conv_clamp=conv_clamp,
                                    generator=generator, **layer_kwargs)
        self.torgb = ToRGBLayer(out_channels, img_channels, w_dim=w_dim,
                                conv_clamp=conv_clamp, generator=generator)
        self.num_conv = 1 if in_channels == 0 else 2
        self.num_torgb = 1

    def forward(self, x, img, ws, force_fp32=True, fused_modconv=False,
                noise_mode='random', generator=None):
        """ws: (N, num_conv + num_torgb, w_dim). Returns x in the block's
        dtype and img in float32."""
        dtype = torch.bfloat16 if self.use_fp16 and not force_fp32 \
            else torch.float32
        kw = dict(fused_modconv=fused_modconv, noise_mode=noise_mode,
                  generator=generator)
        w_iter = iter(ws.unbind(dim=1))
        if self.conv0 is None:
            x = self.const.to(dtype)[None].expand(ws.shape[0], -1, -1, -1)
        else:
            x = self.conv0(x.to(dtype), next(w_iter), **kw)
        x = self.conv1(x, next(w_iter), **kw)
        if img is not None and not self.no_up:
            img = upsample2d(img, self.resample_filter)
        y = self.torgb(x, next(w_iter), fused_modconv=fused_modconv).float()
        return x, (img + y if img is not None else y)


def channels_for(res, channel_base, channel_max):
    return min(channel_base // res, channel_max)


def split_block_ws(blocks, ws):
    """Per-block ws slices: each block reads num_conv + num_torgb ws and
    advances by num_conv (reference: networks_stylegan2.py:627-633)."""
    out = []
    w_idx = 0
    for block in blocks:
        out.append(ws[:, w_idx: w_idx + block.num_conv + block.num_torgb])
        w_idx += block.num_conv
    return out


def fp16_resolution(img_resolution, num_fp16_res):
    """The lowest resolution of the ``use_fp16`` blocks: the top
    ``num_fp16_res`` resolutions, never below 8 (JAX :474-476)."""
    return max(2 ** (int(np.log2(img_resolution)) + 1 - num_fp16_res), 8)


class SynthesisNetwork(nn.Module):
    """Progressive const-4x4 -> img_resolution stack
    (reference: networks_stylegan2.py:596-651)."""

    def __init__(self, w_dim, img_resolution, img_channels,
                 channel_base=32768, channel_max=512, num_fp16_res=4,
                 generator=None, **block_kwargs):
        super().__init__()
        assert img_resolution >= 4 and \
            (img_resolution & (img_resolution - 1)) == 0
        self.w_dim = w_dim
        self.img_resolution = img_resolution
        self.img_channels = img_channels
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

    def forward(self, ws, noise_mode='random', generator=None,
                fused_modconv=False, force_fp32=True):
        assert ws.shape[1] == self.num_ws, (ws.shape, self.num_ws)
        blocks = [getattr(self, f'b{res}') for res in self.block_resolutions]
        x = img = None
        for block, cur_ws in zip(blocks, split_block_ws(blocks, ws.float())):
            x, img = block(x, img, cur_ws, force_fp32=force_fp32,
                           fused_modconv=fused_modconv,
                           noise_mode=noise_mode, generator=generator)
        return img


class Generator(nn.Module):
    """mapping + synthesis, with the Next3D ``mapping_ws`` override that lets
    one mapping net emit ws for two backbones
    (reference: networks_stylegan2.py:656-682; triplane_next3d.py:65)."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 mapping_ws=-1, mapping_kwargs=None, generator=None,
                 **synthesis_kwargs):
        super().__init__()
        self.z_dim = z_dim
        self.c_dim = c_dim
        self.w_dim = w_dim
        self.synthesis = SynthesisNetwork(
            w_dim=w_dim, img_resolution=img_resolution,
            img_channels=img_channels, generator=generator,
            **synthesis_kwargs)
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(
            z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
            num_ws=self.num_ws if mapping_ws == -1 else mapping_ws,
            generator=generator, **(mapping_kwargs or {}))

    def forward(self, z, c, truncation_psi=1, truncation_cutoff=None,
                **synthesis_kwargs):
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws, **synthesis_kwargs)
