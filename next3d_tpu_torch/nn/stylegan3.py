"""StyleGAN3 alias-free synthesis networks as torch ``nn.Module``s.

Counterpart of next3d_tpu/nn/stylegan3.py (reference:
training_avatar_texture/networks_stylegan3.py:27-517): the Fourier-feature
input, the filtered-lrelu synthesis layers with Kaiser or jinc low-pass
filters, the geometric cutoff and sampling-rate schedule, and the
generator. Parameter and buffer names equal the JAX parameter tree's dotted
paths, so ``utils.weights.load_jax_params`` loads a JAX tree with
``strict=True``: the input's ``transform``, ``freqs`` and ``phases``, each
layer's ``magnitude_ema`` and the mapping's ``w_avg`` are buffers, where the
JAX package keeps them as param leaves. The FIR filters are designed on the
host at construction (numpy and scipy) and kept as non-persistent buffers.

``G.synthesis.input.transform`` is the user transform that the equivariance
metrics set in place (metrics/equivariance.py). As in the JAX package, the
forward never updates ``magnitude_ema`` or ``w_avg`` (no ``update_emas``).

Spans (``utils/profiling.py``): ``SG3.mapping`` and ``SG3.synthesis`` around
those calls; ``SG3.input`` and one ``SG3.layer`` a layer tile the synthesis
(the output scale, one elementwise op, lies outside them); inside a layer
``SG3.conv`` (the styles and the modulated convolution) and ``SG3.flrelu``
(the filtered lrelu, whose parts ``.up``, ``.act`` and ``.down`` are opened
in ``ops/filtered_lrelu.py``).

Precision follows the JAX package's policy: a layer built with
``use_fp16`` runs its modulated convolution and filtered lrelu in bfloat16
when the forward gets ``force_fp32=False``; the styles, the weight
normalization and the input gain stay float32, and the network's output is
float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.filtered_lrelu import filtered_lrelu
from ..ops.upfirdn2d import setup_filter
from ..utils.profiling import span
from .stylegan2 import FullyConnected, normalize_2nd_moment


def design_lowpass_filter(numtaps, cutoff, width, fs, radial=False):
    """Kaiser (separable) or jinc (radial) low-pass filter taps, float32
    (reference :365-387; the port's copy of the JAX package's). None for
    the identity filter."""
    assert numtaps >= 1
    if numtaps == 1:
        return None
    import scipy.signal
    if not radial:
        f = scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width,
                                fs=fs)
        return np.asarray(f, np.float32)
    import scipy.special
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    with np.errstate(divide='ignore', invalid='ignore'):
        f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    # the centre tap (r == 0, odd numtaps only): the limit of
    # j1(2c*pi*r)/(pi*r) is c
    f[r == 0] = cutoff
    beta = scipy.signal.kaiser_beta(
        scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    w = np.kaiser(numtaps, beta)
    f *= np.outer(w, w)
    f /= np.sum(f)
    return np.asarray(f, np.float32)


def modulated_conv2d_sg3(x, weight, styles, padding=0, demodulate=True,
                         input_gain=None):
    """SG3's modulated convolution (reference :27-66): weight and styles
    normalized to unit variance when demodulating, the input gain folded
    into the weights, the batch as convolution groups. The weights are
    computed in float32 and cast to x's dtype."""
    batch = x.shape[0]
    out_channels, in_channels, kh, kw = weight.shape
    if demodulate:
        weight = weight * weight.square().mean(dim=[1, 2, 3],
                                               keepdim=True).rsqrt()
        styles = styles * styles.square().mean().rsqrt()
    w = weight[None] * styles[:, None, :, None, None]    # (N, O, I, kh, kw)
    if demodulate:
        dcoefs = (w.square().sum(dim=[2, 3, 4]) + 1e-8).rsqrt()
        w = w * dcoefs[:, :, None, None, None]
    if input_gain is not None:
        w = w * input_gain.reshape(1, 1, -1, 1, 1)
    y = F.conv2d(x.reshape(1, -1, *x.shape[2:]),
                 w.reshape(-1, in_channels, kh, kw).to(x.dtype),
                 padding=padding, groups=batch)
    return y.reshape(batch, -1, *y.shape[2:])


class SG3MappingNetwork(nn.Module):
    """z, c -> broadcast ws (reference :113-166): RMS-normalized z and label
    embedding, ``num_layers`` layers at lr_mult 0.01, truncation toward
    the ``w_avg`` buffer."""

    def __init__(self, z_dim, c_dim, w_dim, num_ws, num_layers=2,
                 lr_multiplier=0.01, w_avg_beta=0.998, generator=None):
        super().__init__()
        self.z_dim = z_dim
        self.c_dim = c_dim
        self.w_dim = w_dim
        self.num_ws = num_ws
        self.num_layers = num_layers
        self.w_avg_beta = w_avg_beta
        feats = [z_dim + (w_dim if c_dim > 0 else 0)] + [w_dim] * num_layers
        for i, (fi, fo) in enumerate(zip(feats[:-1], feats[1:])):
            setattr(self, f'fc{i}', FullyConnected(
                fi, fo, activation='lrelu', lr_multiplier=lr_multiplier,
                generator=generator))
        self.embed = FullyConnected(c_dim, w_dim, generator=generator) \
            if c_dim > 0 else None
        self.register_buffer('w_avg', torch.zeros(w_dim))

    @span('SG3.mapping')
    def forward(self, z, c=None, truncation_psi=1, truncation_cutoff=None,
                return_w_mean=False):
        x = normalize_2nd_moment(z.float())
        if self.c_dim > 0:
            y = normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, y], dim=1)
        for i in range(self.num_layers):
            x = getattr(self, f'fc{i}')(x)
        w_mean = x.detach().mean(dim=0)
        ws = x[:, None].expand(-1, self.num_ws, -1)
        if truncation_psi != 1:
            cutoff = self.num_ws if truncation_cutoff is None \
                else truncation_cutoff
            head = self.w_avg + truncation_psi * (ws[:, :cutoff]
                                                  - self.w_avg)
            ws = torch.cat([head, ws[:, cutoff:]], dim=1)
        return (ws, w_mean) if return_w_mean else ws


class SynthesisInput(nn.Module):
    """Fourier features under a per-sample rotation and translation from w,
    then the user ``transform`` buffer (reference :171-247)."""

    def __init__(self, w_dim, channels, size, sampling_rate, bandwidth,
                 generator=None):
        super().__init__()
        self.w_dim = w_dim
        self.channels = channels
        self.size = np.broadcast_to(np.asarray(size), (2,))
        self.sampling_rate = sampling_rate
        self.bandwidth = bandwidth
        freqs = torch.randn(channels, 2, generator=generator)
        radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
        freqs = freqs / (radii * radii.square().exp() ** 0.25) * bandwidth
        phases = torch.rand(channels, generator=generator) - 0.5
        self.weight = nn.Parameter(torch.randn(channels, channels,
                                               generator=generator))
        self.affine = FullyConnected(w_dim, 4, weight_init=0,
                                     bias_init=[1, 0, 0, 0],
                                     generator=generator)
        self.register_buffer('transform', torch.eye(3))
        self.register_buffer('freqs', freqs)
        self.register_buffer('phases', phases)

    @span('SG3.input')
    def forward(self, w):
        N = w.shape[0]
        t = self.affine(w)                  # (N, 4) = (r_c, r_s, t_x, t_y)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        zeros = torch.zeros_like(t[:, 0])
        ones = torch.ones_like(t[:, 0])
        m_r = torch.stack([t[:, 0], -t[:, 1], zeros,
                           t[:, 1], t[:, 0], zeros,
                           zeros, zeros, ones], dim=1).reshape(N, 3, 3)
        m_t = torch.stack([ones, zeros, -t[:, 2],
                           zeros, ones, -t[:, 3],
                           zeros, zeros, ones], dim=1).reshape(N, 3, 3)
        transforms = m_r @ m_t @ self.transform[None]
        freqs = self.freqs[None].expand(N, -1, -1)
        phases = self.phases[None] + (freqs @ transforms[:, :2, 2:])[..., 0]
        freqs = freqs @ transforms[:, :2, :2]
        amplitudes = (1 - (freqs.norm(dim=2) - self.bandwidth)
                      / (self.sampling_rate / 2 - self.bandwidth)).clamp(0, 1)

        # the sampling grid: affine_grid(align_corners=False) with a
        # diagonal theta of 0.5 * size / sampling_rate
        W, H = int(self.size[0]), int(self.size[1])
        dev = w.device
        gx = ((2 * torch.arange(W, dtype=torch.float32, device=dev) + 1) / W
              - 1) * (0.5 * W / self.sampling_rate)
        gy = ((2 * torch.arange(H, dtype=torch.float32, device=dev) + 1) / H
              - 1) * (0.5 * H / self.sampling_rate)
        grid = torch.stack(torch.meshgrid(gx, gy, indexing='xy'), dim=-1)

        # Fourier features: (H, W, 2) x (N, 2, C) -> (N, H, W, C)
        x = torch.einsum('hwd,ndc->nhwc', grid, freqs.transpose(1, 2))
        x = x + phases[:, None, None, :]
        x = torch.sin(x * (2 * math.pi)) * amplitudes[:, None, None, :]
        x = torch.einsum('nhwc,dc->nhwd', x,
                         self.weight / math.sqrt(self.channels))
        return x.permute(0, 3, 1, 2)


class SG3SynthesisLayer(nn.Module):
    """Alias-free layer: affine -> modulated conv -> filtered lrelu
    (reference :255-364)."""

    def __init__(self, w_dim, is_torgb, is_critically_sampled, use_fp16,
                 in_channels, out_channels, in_size, out_size,
                 in_sampling_rate, out_sampling_rate, in_cutoff, out_cutoff,
                 in_half_width, out_half_width, conv_kernel=3, filter_size=6,
                 lrelu_upsampling=2, use_radial_filters=False, conv_clamp=256,
                 magnitude_ema_beta=0.999, generator=None):
        super().__init__()
        self.w_dim = w_dim
        self.is_torgb = is_torgb
        self.is_critically_sampled = is_critically_sampled
        self.use_fp16 = use_fp16
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.in_size = np.broadcast_to(np.asarray(in_size), (2,))
        self.out_size = np.broadcast_to(np.asarray(out_size), (2,))
        self.in_sampling_rate = in_sampling_rate
        self.out_sampling_rate = out_sampling_rate
        self.tmp_sampling_rate = max(in_sampling_rate, out_sampling_rate) \
            * (1 if is_torgb else lrelu_upsampling)
        self.conv_kernel = 1 if is_torgb else conv_kernel
        self.conv_clamp = conv_clamp
        self.magnitude_ema_beta = magnitude_ema_beta

        self.up_factor = int(np.rint(self.tmp_sampling_rate
                                     / in_sampling_rate))
        assert in_sampling_rate * self.up_factor == self.tmp_sampling_rate
        self.up_taps = filter_size * self.up_factor \
            if self.up_factor > 1 and not is_torgb else 1
        up_filter = design_lowpass_filter(
            self.up_taps, in_cutoff, in_half_width * 2,
            self.tmp_sampling_rate)

        self.down_factor = int(np.rint(self.tmp_sampling_rate
                                       / out_sampling_rate))
        assert out_sampling_rate * self.down_factor == self.tmp_sampling_rate
        self.down_taps = filter_size * self.down_factor \
            if self.down_factor > 1 and not is_torgb else 1
        self.down_radial = use_radial_filters and not is_critically_sampled
        down_filter = design_lowpass_filter(
            self.down_taps, out_cutoff, out_half_width * 2,
            self.tmp_sampling_rate, radial=self.down_radial)
        # a radial filter is already 2-D: setup_filter keeps it as it is
        for name, f in (('up_filter', up_filter),
                        ('down_filter', down_filter)):
            self.register_buffer(name, None if f is None else torch.from_numpy(
                setup_filter(f, normalize=False)), persistent=False)

        pad_total = (self.out_size - 1) * self.down_factor + 1
        pad_total = pad_total - (self.in_size + self.conv_kernel - 1) \
            * self.up_factor
        pad_total = pad_total + self.up_taps + self.down_taps - 2
        pad_lo = (pad_total + self.up_factor) // 2
        pad_hi = pad_total - pad_lo
        self.padding = [int(pad_lo[0]), int(pad_hi[0]),
                        int(pad_lo[1]), int(pad_hi[1])]

        self.affine = FullyConnected(w_dim, in_channels, bias_init=1,
                                     generator=generator)
        self.weight = nn.Parameter(torch.randn(
            out_channels, in_channels, self.conv_kernel, self.conv_kernel,
            generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer('magnitude_ema', torch.ones(()))

    @span('SG3.layer')
    def forward(self, x, w, force_fp32=True):
        with span('SG3.conv'):
            styles = self.affine(w)
            if self.is_torgb:
                styles = styles / math.sqrt(self.in_channels
                                            * self.conv_kernel ** 2)
            dtype = torch.bfloat16 if self.use_fp16 and not force_fp32 \
                else torch.float32
            x = modulated_conv2d_sg3(
                x.to(dtype), self.weight, styles,
                padding=self.conv_kernel - 1, demodulate=not self.is_torgb,
                input_gain=self.magnitude_ema.rsqrt())
        with span('SG3.flrelu'):
            return filtered_lrelu(
                x, fu=self.up_filter, fd=self.down_filter,
                b=self.bias.to(x.dtype), up=self.up_factor,
                down=self.down_factor, padding=self.padding,
                gain=1 if self.is_torgb else math.sqrt(2),
                slope=1 if self.is_torgb else 0.2, clamp=self.conv_clamp)


class SG3SynthesisNetwork(nn.Module):
    """The geometric cutoff schedule and the layer stack (reference
    :402-489). Layers are named ``L{idx}_{size}_{channels}``."""

    def __init__(self, w_dim, img_resolution, img_channels,
                 channel_base=32768, channel_max=512, num_layers=14,
                 num_critical=2, first_cutoff=2, first_stopband=2 ** 2.1,
                 last_stopband_rel=2 ** 0.3, margin_size=10,
                 output_scale=0.25, num_fp16_res=4, generator=None,
                 **layer_kwargs):
        super().__init__()
        self.w_dim = w_dim
        self.num_ws = num_layers + 2
        self.img_resolution = img_resolution
        self.img_channels = img_channels
        self.num_layers = num_layers
        self.margin_size = margin_size
        self.output_scale = output_scale

        last_cutoff = img_resolution / 2
        last_stopband = last_cutoff * last_stopband_rel
        exponents = np.minimum(
            np.arange(num_layers + 1) / (num_layers - num_critical), 1)
        cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
        stopbands = first_stopband * \
            (last_stopband / first_stopband) ** exponents
        sampling_rates = np.exp2(np.ceil(np.log2(
            np.minimum(stopbands * 2, img_resolution))))
        half_widths = np.maximum(stopbands, sampling_rates / 2) - cutoffs
        sizes = sampling_rates + margin_size * 2
        sizes[-2:] = img_resolution
        channels = np.rint(np.minimum((channel_base / 2) / cutoffs,
                                      channel_max))
        channels[-1] = img_channels

        self.input = SynthesisInput(
            w_dim=w_dim, channels=int(channels[0]), size=int(sizes[0]),
            sampling_rate=sampling_rates[0], bandwidth=cutoffs[0],
            generator=generator)
        self.layer_names = []
        for idx in range(num_layers + 1):
            prev = max(idx - 1, 0)
            layer = SG3SynthesisLayer(
                w_dim=w_dim, is_torgb=(idx == num_layers),
                is_critically_sampled=(idx >= num_layers - num_critical),
                use_fp16=(sampling_rates[idx] * (2 ** num_fp16_res)
                          > img_resolution),
                in_channels=int(channels[prev]),
                out_channels=int(channels[idx]),
                in_size=int(sizes[prev]), out_size=int(sizes[idx]),
                in_sampling_rate=int(sampling_rates[prev]),
                out_sampling_rate=int(sampling_rates[idx]),
                in_cutoff=cutoffs[prev], out_cutoff=cutoffs[idx],
                in_half_width=half_widths[prev],
                out_half_width=half_widths[idx], generator=generator,
                **layer_kwargs)
            name = f'L{idx}_{int(layer.out_size[0])}_{layer.out_channels}'
            setattr(self, name, layer)
            self.layer_names.append(name)

    @span('SG3.synthesis')
    def forward(self, ws, force_fp32=True):
        ws = ws.float()
        x = self.input(ws[:, 0])
        for i, name in enumerate(self.layer_names):
            x = getattr(self, name)(x, ws[:, i + 1], force_fp32=force_fp32)
        if self.output_scale != 1:
            x = x * self.output_scale
        return x.float()


class SG3Generator(nn.Module):
    """Mapping + alias-free synthesis (reference :494-517)."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 mapping_kwargs=None, generator=None, **synthesis_kwargs):
        super().__init__()
        self.z_dim = z_dim
        self.c_dim = c_dim
        self.w_dim = w_dim
        self.img_resolution = img_resolution
        self.img_channels = img_channels
        self.synthesis = SG3SynthesisNetwork(
            w_dim=w_dim, img_resolution=img_resolution,
            img_channels=img_channels, generator=generator,
            **synthesis_kwargs)
        self.num_ws = self.synthesis.num_ws
        self.mapping = SG3MappingNetwork(
            z_dim=z_dim, c_dim=c_dim, w_dim=w_dim, num_ws=self.num_ws,
            generator=generator, **(mapping_kwargs or {}))

    def forward(self, z, c=None, truncation_psi=1, truncation_cutoff=None,
                force_fp32=True):
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws, force_fp32=force_fp32)
