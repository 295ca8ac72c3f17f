"""StyleGAN3's generator in plain torch, float32, written from NVlabs/
stylegan3 ``training/networks_stylegan3.py`` (the mapping, the Fourier-
feature input, the alias-free synthesis layer and network, the generator),
with this package's ``filtered_lrelu`` (``ops/filtered_lrelu.py``: the
published ``_filtered_lrelu_ref`` composition over the plain FIR) in place
of the published CUDA plugin. It imports nothing of the port.

Departures from the published code, none of which changes what a forward
computes from the weights it holds:

- The random leaves come from ``init.randn`` (standard normals, drawn on
  the device from the benchmark's seed), so that the benchmark hands the
  same weights to this module and to the port. The input's ``phases`` are
  standard normal where the published code draws them uniform in
  [-0.5, 0.5): a phase enters only through sin(2 pi (x + phase)), and a
  standard normal taken modulo 1 is uniform to within 1e-8. The input's
  ``freqs`` are drawn as standard normals and scaled to the published
  distribution (each over its radius r times exp(r^2)^(1/4), times the
  bandwidth) once the draw has landed: before the first ``state_dict`` or
  forward (``SynthesisInput.settle``).
- The up and down filters are non-persistent buffers (published:
  persistent): they follow from the configuration, and the state_dict
  then names exactly the port's leaves.
- No fp16 path and no ``update_emas``: the layers run float32 whatever
  ``num_fp16_res`` says, and the forward never updates ``w_avg`` or
  ``magnitude_ema`` (the metric loop and gen-samples call it so).
- The modulated convolution is ``F.conv2d`` over the batch as groups, as
  the published ``conv2d_gradfix.conv2d`` is without a gradient.
"""

from __future__ import annotations

import numpy as np
import scipy.signal
import scipy.special
import torch
import torch.nn.functional as F
from torch import nn

from ..init import randn
from ..ops.filtered_lrelu import filtered_lrelu
from .stylegan2 import FullyConnected, normalize_2nd_moment


def modulated_conv2d(x, w, s, demodulate=True, padding=0, input_gain=None):
    """networks_stylegan3.py:27-66."""
    batch_size = int(x.shape[0])
    out_channels, in_channels, kh, kw = w.shape
    if demodulate:
        w = w * w.square().mean([1, 2, 3], keepdim=True).rsqrt()
        s = s * s.square().mean().rsqrt()
    w = w.unsqueeze(0) * s.unsqueeze(1).unsqueeze(3).unsqueeze(4)
    if demodulate:
        dcoefs = (w.square().sum(dim=[2, 3, 4]) + 1e-8).rsqrt()
        w = w * dcoefs.unsqueeze(2).unsqueeze(3).unsqueeze(4)
    if input_gain is not None:
        input_gain = input_gain.expand(batch_size, in_channels)
        w = w * input_gain.unsqueeze(1).unsqueeze(3).unsqueeze(4)
    x = x.reshape(1, -1, *x.shape[2:])
    w = w.reshape(-1, in_channels, kh, kw)
    x = F.conv2d(x, w.to(x.dtype), padding=padding, groups=batch_size)
    return x.reshape(batch_size, -1, *x.shape[2:])


class MappingNetwork(nn.Module):
    """networks_stylegan3.py:113-166."""

    def __init__(self, z_dim, c_dim, w_dim, num_ws, num_layers=2,
                 lr_multiplier=0.01, w_avg_beta=0.998):
        super().__init__()
        self.z_dim = z_dim
        self.c_dim = c_dim
        self.w_dim = w_dim
        self.num_ws = num_ws
        self.num_layers = num_layers
        self.embed = FullyConnected(c_dim, w_dim) if c_dim > 0 else None
        features = [z_dim + (w_dim if c_dim > 0 else 0)] \
            + [w_dim] * num_layers
        for idx, in_f, out_f in zip(range(num_layers), features[:-1],
                                    features[1:]):
            setattr(self, f'fc{idx}', FullyConnected(
                in_f, out_f, activation='lrelu',
                lr_multiplier=lr_multiplier))
        self.register_buffer('w_avg', torch.zeros([w_dim]))

    def forward(self, z, c=None, truncation_psi=1, truncation_cutoff=None):
        x = normalize_2nd_moment(z.to(torch.float32))
        if self.c_dim > 0:
            y = normalize_2nd_moment(self.embed(c.to(torch.float32)))
            x = torch.cat([x, y], dim=1)
        for idx in range(self.num_layers):
            x = getattr(self, f'fc{idx}')(x)
        x = x.unsqueeze(1).repeat([1, self.num_ws, 1])
        if truncation_psi != 1:
            cut = self.num_ws if truncation_cutoff is None \
                else truncation_cutoff
            x[:, :cut] = self.w_avg.lerp(x[:, :cut], truncation_psi)
        return x


class SynthesisInput(nn.Module):
    """networks_stylegan3.py:171-247."""

    def __init__(self, w_dim, channels, size, sampling_rate, bandwidth):
        super().__init__()
        self.w_dim = w_dim
        self.channels = channels
        self.size = np.broadcast_to(np.asarray(size), [2])
        self.sampling_rate = sampling_rate
        self.bandwidth = bandwidth
        self.weight = nn.Parameter(randn(channels, channels))
        self.affine = FullyConnected(w_dim, 4, weight_init=0,
                                     bias_init=[1, 0, 0, 0])
        self.register_buffer('transform', torch.eye(3, 3))
        self.register_buffer('freqs', randn(channels, 2))
        self.register_buffer('phases', randn(channels))
        self.raw = True
        self.register_state_dict_pre_hook(
            lambda module, *args, **kwargs: module.settle())

    @torch.no_grad()
    def settle(self):
        """Scale the drawn frequencies to the published distribution, once
        (the module docstring)."""
        if self.raw:
            radii = self.freqs.square().sum(dim=1, keepdim=True).sqrt()
            self.freqs.div_(radii * radii.square().exp().pow(0.25))
            self.freqs.mul_(self.bandwidth)
            self.raw = False

    def forward(self, w):
        self.settle()
        transforms = self.transform.unsqueeze(0)
        freqs = self.freqs.unsqueeze(0)
        phases = self.phases.unsqueeze(0)

        t = self.affine(w)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        m_r = torch.eye(3, device=w.device).unsqueeze(0).repeat(
            [w.shape[0], 1, 1])
        m_r[:, 0, 0] = t[:, 0]
        m_r[:, 0, 1] = -t[:, 1]
        m_r[:, 1, 0] = t[:, 1]
        m_r[:, 1, 1] = t[:, 0]
        m_t = torch.eye(3, device=w.device).unsqueeze(0).repeat(
            [w.shape[0], 1, 1])
        m_t[:, 0, 2] = -t[:, 2]
        m_t[:, 1, 2] = -t[:, 3]
        transforms = m_r @ m_t @ transforms

        phases = phases + (freqs @ transforms[:, :2, 2:]).squeeze(2)
        freqs = freqs @ transforms[:, :2, :2]
        amplitudes = (1 - (freqs.norm(dim=2) - self.bandwidth)
                      / (self.sampling_rate / 2 - self.bandwidth)).clamp(0, 1)

        theta = torch.eye(2, 3, device=w.device)
        theta[0, 0] = 0.5 * self.size[0] / self.sampling_rate
        theta[1, 1] = 0.5 * self.size[1] / self.sampling_rate
        grids = F.affine_grid(theta.unsqueeze(0),
                              [1, 1, int(self.size[1]), int(self.size[0])],
                              align_corners=False)

        x = (grids.unsqueeze(3) @ freqs.permute(0, 2, 1).unsqueeze(1)
             .unsqueeze(2)).squeeze(3)
        x = x + phases.unsqueeze(1).unsqueeze(2)
        x = torch.sin(x * (np.pi * 2))
        x = x * amplitudes.unsqueeze(1).unsqueeze(2)
        weight = self.weight / np.sqrt(self.channels)
        x = x @ weight.t()
        return x.permute(0, 3, 1, 2)


def design_lowpass_filter(numtaps, cutoff, width, fs, radial=False):
    """networks_stylegan3.py:365-387: a Kaiser low-pass (1-D, separable) or
    a jinc low-pass under a 2-D Kaiser window (radial); None for one
    tap."""
    assert numtaps >= 1
    if numtaps == 1:
        return None
    if not radial:
        f = scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width,
                                fs=fs)
        return torch.as_tensor(f, dtype=torch.float32)
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    beta = scipy.signal.kaiser_beta(
        scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    w = np.kaiser(numtaps, beta)
    f *= np.outer(w, w)
    f /= np.sum(f)
    return torch.as_tensor(f, dtype=torch.float32)


class SynthesisLayer(nn.Module):
    """networks_stylegan3.py:252-363."""

    def __init__(self, w_dim, is_torgb, is_critically_sampled, use_fp16,
                 in_channels, out_channels, in_size, out_size,
                 in_sampling_rate, out_sampling_rate, in_cutoff, out_cutoff,
                 in_half_width, out_half_width, conv_kernel=3, filter_size=6,
                 lrelu_upsampling=2, use_radial_filters=False, conv_clamp=256,
                 magnitude_ema_beta=0.999):
        super().__init__()
        self.w_dim = w_dim
        self.is_torgb = is_torgb
        self.is_critically_sampled = is_critically_sampled
        self.use_fp16 = use_fp16
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.in_size = np.broadcast_to(np.asarray(in_size), [2])
        self.out_size = np.broadcast_to(np.asarray(out_size), [2])
        self.in_sampling_rate = in_sampling_rate
        self.out_sampling_rate = out_sampling_rate
        self.tmp_sampling_rate = max(in_sampling_rate, out_sampling_rate) \
            * (1 if is_torgb else lrelu_upsampling)
        self.in_cutoff = in_cutoff
        self.out_cutoff = out_cutoff
        self.in_half_width = in_half_width
        self.out_half_width = out_half_width
        self.conv_kernel = 1 if is_torgb else conv_kernel
        self.conv_clamp = conv_clamp
        self.magnitude_ema_beta = magnitude_ema_beta

        self.affine = FullyConnected(self.w_dim, self.in_channels,
                                     bias_init=1)
        self.weight = nn.Parameter(randn(self.out_channels, self.in_channels,
                                         self.conv_kernel, self.conv_kernel))
        self.bias = nn.Parameter(torch.zeros([self.out_channels]))
        self.register_buffer('magnitude_ema', torch.ones([]))

        self.up_factor = int(np.rint(self.tmp_sampling_rate
                                     / self.in_sampling_rate))
        assert self.in_sampling_rate * self.up_factor \
            == self.tmp_sampling_rate
        self.up_taps = filter_size * self.up_factor \
            if self.up_factor > 1 and not self.is_torgb else 1
        self.register_buffer('up_filter', design_lowpass_filter(
            numtaps=self.up_taps, cutoff=self.in_cutoff,
            width=self.in_half_width * 2, fs=self.tmp_sampling_rate),
            persistent=False)

        self.down_factor = int(np.rint(self.tmp_sampling_rate
                                       / self.out_sampling_rate))
        assert self.out_sampling_rate * self.down_factor \
            == self.tmp_sampling_rate
        self.down_taps = filter_size * self.down_factor \
            if self.down_factor > 1 and not self.is_torgb else 1
        self.down_radial = use_radial_filters \
            and not self.is_critically_sampled
        self.register_buffer('down_filter', design_lowpass_filter(
            numtaps=self.down_taps, cutoff=self.out_cutoff,
            width=self.out_half_width * 2, fs=self.tmp_sampling_rate,
            radial=self.down_radial), persistent=False)

        pad_total = (self.out_size - 1) * self.down_factor + 1
        pad_total -= (self.in_size + self.conv_kernel - 1) * self.up_factor
        pad_total += self.up_taps + self.down_taps - 2
        pad_lo = (pad_total + self.up_factor) // 2
        pad_hi = pad_total - pad_lo
        self.padding = [int(pad_lo[0]), int(pad_hi[0]), int(pad_lo[1]),
                        int(pad_hi[1])]

    def forward(self, x, w):
        input_gain = self.magnitude_ema.rsqrt()
        styles = self.affine(w)
        if self.is_torgb:
            weight_gain = 1 / np.sqrt(self.in_channels
                                      * (self.conv_kernel ** 2))
            styles = styles * weight_gain
        x = modulated_conv2d(x=x.to(torch.float32), w=self.weight, s=styles,
                             padding=self.conv_kernel - 1,
                             demodulate=(not self.is_torgb),
                             input_gain=input_gain)
        gain = 1 if self.is_torgb else np.sqrt(2)
        slope = 1 if self.is_torgb else 0.2
        return filtered_lrelu(x=x, fu=self.up_filter, fd=self.down_filter,
                              b=self.bias.to(x.dtype), up=self.up_factor,
                              down=self.down_factor, padding=self.padding,
                              gain=gain, slope=slope, clamp=self.conv_clamp)


class SynthesisNetwork(nn.Module):
    """networks_stylegan3.py:392-470."""

    def __init__(self, w_dim, img_resolution, img_channels,
                 channel_base=32768, channel_max=512, num_layers=14,
                 num_critical=2, first_cutoff=2, first_stopband=2 ** 2.1,
                 last_stopband_rel=2 ** 0.3, margin_size=10,
                 output_scale=0.25, num_fp16_res=4, **layer_kwargs):
        super().__init__()
        self.w_dim = w_dim
        self.num_ws = num_layers + 2
        self.img_resolution = img_resolution
        self.img_channels = img_channels
        self.num_layers = num_layers
        self.num_critical = num_critical
        self.margin_size = margin_size
        self.output_scale = output_scale
        self.num_fp16_res = num_fp16_res

        last_cutoff = self.img_resolution / 2
        last_stopband = last_cutoff * last_stopband_rel
        exponents = np.minimum(np.arange(self.num_layers + 1)
                               / (self.num_layers - self.num_critical), 1)
        cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
        stopbands = first_stopband \
            * (last_stopband / first_stopband) ** exponents
        sampling_rates = np.exp2(np.ceil(np.log2(np.minimum(
            stopbands * 2, self.img_resolution))))
        half_widths = np.maximum(stopbands, sampling_rates / 2) - cutoffs
        sizes = sampling_rates + self.margin_size * 2
        sizes[-2:] = self.img_resolution
        channels = np.rint(np.minimum((channel_base / 2) / cutoffs,
                                      channel_max))
        channels[-1] = self.img_channels

        self.input = SynthesisInput(
            w_dim=self.w_dim, channels=int(channels[0]), size=int(sizes[0]),
            sampling_rate=sampling_rates[0], bandwidth=cutoffs[0])
        self.layer_names = []
        for idx in range(self.num_layers + 1):
            prev = max(idx - 1, 0)
            is_torgb = (idx == self.num_layers)
            is_critically_sampled = \
                (idx >= self.num_layers - self.num_critical)
            use_fp16 = (sampling_rates[idx] * (2 ** self.num_fp16_res)
                        > self.img_resolution)
            layer = SynthesisLayer(
                w_dim=self.w_dim, is_torgb=is_torgb,
                is_critically_sampled=is_critically_sampled,
                use_fp16=use_fp16, in_channels=int(channels[prev]),
                out_channels=int(channels[idx]), in_size=int(sizes[prev]),
                out_size=int(sizes[idx]),
                in_sampling_rate=int(sampling_rates[prev]),
                out_sampling_rate=int(sampling_rates[idx]),
                in_cutoff=cutoffs[prev], out_cutoff=cutoffs[idx],
                in_half_width=half_widths[prev],
                out_half_width=half_widths[idx], **layer_kwargs)
            name = f'L{idx}_{layer.out_size[0]}_{layer.out_channels}'
            setattr(self, name, layer)
            self.layer_names.append(name)

    def forward(self, ws, **layer_kwargs):
        ws = ws.to(torch.float32).unbind(dim=1)
        x = self.input(ws[0])
        for name, w in zip(self.layer_names, ws[1:]):
            x = getattr(self, name)(x, w)
        if self.output_scale != 1:
            x = x * self.output_scale
        return x.to(torch.float32)


class SG3Generator(nn.Module):
    """networks_stylegan3.py:475-511: the mapping, then the synthesis."""

    def __init__(self, z_dim, c_dim, w_dim, img_resolution, img_channels,
                 mapping_kwargs=None, **synthesis_kwargs):
        super().__init__()
        self.z_dim = z_dim
        self.c_dim = c_dim
        self.w_dim = w_dim
        self.img_resolution = img_resolution
        self.img_channels = img_channels
        self.synthesis = SynthesisNetwork(
            w_dim=w_dim, img_resolution=img_resolution,
            img_channels=img_channels, **synthesis_kwargs)
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
                                      num_ws=self.num_ws,
                                      **(mapping_kwargs or {}))

    def forward(self, z, c=None, truncation_psi=1, truncation_cutoff=None):
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws)
