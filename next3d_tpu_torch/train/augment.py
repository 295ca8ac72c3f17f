"""Adaptive discriminator augmentation (ADA): the augment pipe and the
controller of its probability ``p``.

Counterpart of next3d_tpu/train/augment.py (reference:
training_avatar_texture/augment.py:124-439): pixel blitting (x-flip,
rot90, integer translation) and the general geometric transforms
(isotropic and anisotropic scaling, rotation, fractional translation)
composed into one inverse affine, applied by a wavelet upsampling, a
bilinear resample and a wavelet downsampling; the colour transforms
(brightness, contrast, luma flip, hue, saturation) as one 4x4 matrix; the
frequency-band filter; additive noise and cutout. Each transform of a group
is applied to an image with probability ``p`` times its multiplier.

It computes what the JAX package computes, which departs from the
reference in one place: the reference pads each batch with a reflect
margin of a size that depends on the draw before the resample; the JAX
package reflects the resample's *coordinates* on the 2x image instead (its
module docstring), and so does this port. The resample is
``F.grid_sample`` (through ``ops/grid_sample.py grid_sample_gradfix``,
whose backward R1 can differentiate on the card): JAX's bilinear gather
takes a coordinate in [-0.5, 0) to the pair of pixels (0, 1) with weight
``x + 1`` on pixel 1, which is ``F.grid_sample`` at ``x + 1``, and one in
(size - 1, size - 0.5] to the last pixel, its 'border' padding.

The pipe is split in two. ``draw`` takes the per-image parameters from a
``torch.Generator`` in the order of JAX's key sequence (JAX :147, in the
order of :156-293), each already gated by its probability (an identity
value where the transform is off); ``apply`` transforms images with given
parameters and is differentiable with respect to the images, twice (R1
takes the gradient of D through it). A test can so give ``apply`` the
values JAX drew.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv2d_gradfix import conv2d
from ..ops.grid_sample import grid_sample_gradfix
from ..ops.upfirdn2d import downsample2d, setup_filter, upsample2d

wavelets = {
    'haar': [0.7071067811865476, 0.7071067811865476],
    'sym2': [-0.12940952255092145, 0.22414386804185735, 0.836516303737469,
             0.48296291314469025],
    'sym6': [0.015404109327027373, 0.0034907120842174702,
             -0.11799011114819057, -0.048311742585633, 0.4910559419267466,
             0.787641141030194, 0.3379294217276218, -0.07263752278646252,
             -0.021060292512300564, 0.04472490177066578,
             0.0017677118642428036, -0.007800708325034148],
}

GEOM = ('xflip', 'rotate90', 'xint', 'scale', 'rotate', 'aniso', 'xfrac')
COLOR = ('brightness', 'contrast', 'lumaflip', 'hue', 'saturation')


def _matrix(rows, like):
    """(B,) entries (tensors or numbers) row by row -> (B, n, n)."""
    n = math.isqrt(len(rows))
    return torch.stack([r if torch.is_tensor(r) else torch.full_like(like, r)
                        for r in rows], -1).reshape(like.shape + (n, n))


def _translate2d(tx, ty):
    return _matrix([1, 0, tx, 0, 1, ty, 0, 0, 1], tx)


def _scale2d(sx, sy):
    return _matrix([sx, 0, 0, 0, sy, 0, 0, 0, 1], sx)


def _rotate2d(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    return _matrix([c, -s, 0, s, c, 0, 0, 0, 1], theta)


def _translate3d(t):
    return _matrix([1, 0, 0, t, 0, 1, 0, t, 0, 0, 1, t, 0, 0, 0, 1], t)


def _scale3d(s):
    return _matrix([s, 0, 0, 0, 0, s, 0, 0, 0, 0, s, 0, 0, 0, 0, 1], s)


def _rotate3d_axis(v, theta):
    """A rotation by ``theta`` (B,) about the axis ``v`` (4,) (JAX
    :77-90)."""
    vx, vy, vz = v[0], v[1], v[2]
    s, c = torch.sin(theta), torch.cos(theta)
    cc = 1 - c
    return _matrix([vx * vx * cc + c, vx * vy * cc - vz * s,
                    vx * vz * cc + vy * s, 0,
                    vy * vx * cc + vz * s, vy * vy * cc + c,
                    vy * vz * cc - vx * s, 0,
                    vz * vx * cc - vy * s, vz * vy * cc + vx * s,
                    vz * vz * cc + c, 0, 0, 0, 0, 1], theta)


def _reflect_coords(x, size):
    """Pixel coordinates reflected into [-0.5, size - 0.5] (JAX :93-100)."""
    x = torch.remainder(x + 0.5, 2 * size)
    return torch.minimum(x, 2 * size - x) - 0.5


def _filter_bank():
    """The 4-band filter bank of the image-space filter (JAX :131-142, the
    reference's :177-186), in numpy alone: each row's full convolution with
    the doubled lowpass is ``np.convolve``."""
    lo = np.asarray(wavelets['sym2'])
    hi = lo * ((-1) ** np.arange(lo.size))
    lo2 = np.convolve(lo, lo[::-1]) / 2
    hi2 = np.convolve(hi, hi[::-1]) / 2
    bank = np.eye(4, 1)
    for i in range(1, bank.shape[0]):
        bank = np.dstack([bank, np.zeros_like(bank)]).reshape(
            bank.shape[0], -1)[:, :-1]
        bank = np.stack([np.convolve(row, lo2) for row in bank])
        start = (bank.shape[1] - hi2.size) // 2
        bank[i, start:start + hi2.size] += hi2
    return bank.astype(np.float32)


def separable_batch_filter(x, taps):
    """Each image of ``x`` (B, C, H, W) filtered, without padding, by its
    own 1-D filter ``taps`` (B, T) along x and then along y (JAX :344-363):
    a depthwise convolution over the B*C planes."""
    B, C, H, W = x.shape
    T = taps.shape[1]
    w = taps.to(x.dtype)[:, None].expand(B, C, T).reshape(B * C, 1, 1, T)
    y = conv2d(x.reshape(1, B * C, H, W), w, groups=B * C)
    y = conv2d(y, w.reshape(B * C, 1, T, 1), groups=B * C)
    return y.reshape(B, C, *y.shape[2:])


class AugmentPipe:
    """The JAX pipe's options and defaults (JAX :102-143); ``draw`` and
    ``apply`` in place of its ``__call__(rng, images, p)``."""

    def __init__(self, xflip=0, rotate90=0, xint=0, xint_max=0.125,
                 scale=0, rotate=0, aniso=0, xfrac=0, scale_std=0.2,
                 rotate_max=1, aniso_std=0.2, xfrac_std=0.125,
                 brightness=0, contrast=0, lumaflip=0, hue=0, saturation=0,
                 brightness_std=0.2, contrast_std=0.5, hue_max=1,
                 saturation_std=1,
                 imgfilter=0, imgfilter_bands=(1, 1, 1, 1), imgfilter_std=1,
                 noise=0, cutout=0, noise_std=0.1, cutout_size=0.5):
        self.xflip, self.rotate90, self.xint = xflip, rotate90, xint
        self.xint_max = xint_max
        self.scale, self.rotate, self.aniso, self.xfrac = (scale, rotate,
                                                           aniso, xfrac)
        self.scale_std, self.rotate_max = scale_std, rotate_max
        self.aniso_std, self.xfrac_std = aniso_std, xfrac_std
        self.brightness, self.contrast = brightness, contrast
        self.lumaflip, self.hue, self.saturation = lumaflip, hue, saturation
        self.brightness_std, self.contrast_std = brightness_std, contrast_std
        self.hue_max, self.saturation_std = hue_max, saturation_std
        self.imgfilter = imgfilter
        self.imgfilter_bands = list(imgfilter_bands)
        self.imgfilter_std = imgfilter_std
        self.noise, self.cutout = noise, cutout
        self.noise_std, self.cutout_size = noise_std, cutout_size
        self.Hz_geom = setup_filter(wavelets['sym6'])
        self.Hz_fbank = _filter_bank()

    def __call__(self, images, p, generator):
        return self.apply(images, self.draw(images.shape, p, generator,
                                            images.device))

    # ------------------------------------------------------------------ draw
    def draw(self, shape, p, generator, device):
        """The per-image parameters of one call on images of ``shape`` (B,
        C, H, W) at probability ``p``, drawn from ``generator`` on
        ``device`` in the order of JAX's keys: for each enabled transform
        its value, then its gate (JAX :149-153; the rotations draw their
        own gate at 1 - sqrt(1 - rotate * p)). A dict of tensors, one key a
        transform (``rotate`` and ``rotate_after_aniso`` for the two
        rotations, ``noise`` and ``noise_values``, ``cutout_size`` and
        ``cutout_center``, ``imgfilter`` the (B, bands) gains)."""
        B, C, H, W = shape

        def uniform(*s):
            return torch.rand(s, generator=generator, device=device)

        def normal(*s):
            return torch.randn(s, generator=generator, device=device)

        def gate(value, identity, prob, extra_dims=0):
            u = uniform(B, *(1,) * extra_dims)
            return torch.where(u < prob * p, value,
                               torch.full_like(value, identity))

        def rotation():
            theta = (uniform(B) * 2 - 1) * math.pi * self.rotate_max
            u = uniform(B)
            return torch.where(u < p_rot, theta, torch.zeros_like(theta))

        d = {}
        if self.xflip > 0:
            d['xflip'] = gate(torch.floor(uniform(B) * 2), 0, self.xflip)
        if self.rotate90 > 0:
            d['rotate90'] = gate(torch.floor(uniform(B) * 4), 0,
                                 self.rotate90)
        if self.xint > 0:
            d['xint'] = gate((uniform(B, 2) * 2 - 1) * self.xint_max, 0,
                             self.xint, 1)
        if self.scale > 0:
            d['scale'] = gate(torch.exp2(normal(B) * self.scale_std), 1,
                              self.scale)
        p_rot = 1 - math.sqrt(min(max(1 - self.rotate * p, 0), 1))
        if self.rotate > 0:
            d['rotate'] = rotation()
        if self.aniso > 0:
            d['aniso'] = gate(torch.exp2(normal(B) * self.aniso_std), 1,
                              self.aniso)
        if self.rotate > 0:
            d['rotate_after_aniso'] = rotation()
        if self.xfrac > 0:
            d['xfrac'] = gate(normal(B, 2) * self.xfrac_std, 0, self.xfrac,
                              1)
        if self.brightness > 0:
            d['brightness'] = gate(normal(B) * self.brightness_std, 0,
                                   self.brightness)
        if self.contrast > 0:
            d['contrast'] = gate(torch.exp2(normal(B) * self.contrast_std),
                                 1, self.contrast)
        if self.lumaflip > 0:
            d['lumaflip'] = gate(torch.floor(uniform(B, 1, 1) * 2), 0,
                                 self.lumaflip, 2)
        if self.hue > 0 and C > 1:
            d['hue'] = gate((uniform(B) * 2 - 1) * math.pi * self.hue_max, 0,
                            self.hue)
        if self.saturation > 0 and C > 1:
            d['saturation'] = gate(torch.exp2(normal(B, 1, 1)
                                              * self.saturation_std), 1,
                                   self.saturation, 2)
        if self.imgfilter > 0:
            gains = []
            for strength in self.imgfilter_bands:
                t = torch.exp2(normal(B) * self.imgfilter_std)
                u = uniform(B)
                gains.append(torch.where(u < self.imgfilter * p * strength,
                                         t, torch.ones_like(t)))
            d['imgfilter'] = torch.stack(gains, 1)
        if self.noise > 0:
            sigma = normal(B, 1, 1, 1).abs() * self.noise_std
            d['noise'] = gate(sigma, 0, self.noise, 3)
            d['noise_values'] = normal(B, C, H, W)
        if self.cutout > 0:
            size = torch.full((B, 2, 1, 1, 1), float(self.cutout_size),
                              device=device)
            d['cutout_size'] = gate(size, 0, self.cutout, 4)
            d['cutout_center'] = uniform(B, 2, 1, 1, 1)
        return d

    # ----------------------------------------------------------------- apply
    def apply(self, images, d):
        """``images`` (B, C, H, W) transformed with the parameters ``d`` of
        ``draw`` (JAX :155-343)."""
        B, C, H, W = images.shape
        if any(getattr(self, k) > 0 for k in GEOM):
            images = self._execute_geom(images, self._geom_inverse(d, B, H, W,
                                                                   images))
        if any(getattr(self, k) > 0 for k in COLOR):
            images = self._execute_color(images, self._color_matrix(
                d, B, images))
        if self.imgfilter > 0:
            images = self._execute_filter(images, d['imgfilter'])
        if self.noise > 0:
            images = images + d['noise_values'] * d['noise']
        if self.cutout > 0:
            size, center = d['cutout_size'], d['cutout_center']
            cx = torch.arange(W, device=images.device).reshape(1, 1, 1, -1)
            cy = torch.arange(H, device=images.device).reshape(1, 1, -1, 1)
            mask_x = ((cx + 0.5) / W - center[:, 0]).abs() >= size[:, 0] / 2
            mask_y = ((cy + 0.5) / H - center[:, 1]).abs() >= size[:, 1] / 2
            images = images * (mask_x | mask_y).to(images.dtype)
        return images

    def _geom_inverse(self, d, B, H, W, like):
        """The composed inverse affine (B, 3, 3) of the blit and geometric
        transforms (JAX :156-189)."""
        G_inv = torch.eye(3, device=like.device).expand(B, 3, 3)
        one = torch.ones(B, device=like.device)
        if 'xflip' in d:
            G_inv = G_inv @ _scale2d(1 / (1 - 2 * d['xflip']), one)
        if 'rotate90' in d:
            G_inv = G_inv @ _rotate2d(math.pi / 2 * d['rotate90'])
        if 'xint' in d:
            t = d['xint']
            G_inv = G_inv @ _translate2d(-torch.round(t[:, 0] * W),
                                         -torch.round(t[:, 1] * H))
        if 'scale' in d:
            G_inv = G_inv @ _scale2d(1 / d['scale'], 1 / d['scale'])
        if 'rotate' in d:
            G_inv = G_inv @ _rotate2d(d['rotate'])
        if 'aniso' in d:
            G_inv = G_inv @ _scale2d(1 / d['aniso'], d['aniso'])
        if 'rotate_after_aniso' in d:
            G_inv = G_inv @ _rotate2d(d['rotate_after_aniso'])
        if 'xfrac' in d:
            t = d['xfrac']
            G_inv = G_inv @ _translate2d(-t[:, 0] * W, -t[:, 1] * H)
        return G_inv

    def _execute_geom(self, images, G_inv):
        """Wavelet upsampling to 2x, the affine resample with reflected
        coordinates, wavelet downsampling (JAX :295-341)."""
        B = images.shape[0]
        up = upsample2d(images, self.Hz_geom, up=2)
        Hu, Wu = up.shape[-2:]
        dev = images.device

        def diag(v):
            return torch.full((B,), v, device=dev)
        G = _translate2d(diag(-0.5), diag(-0.5)) @ (
            _scale2d(diag(2.0), diag(2.0)) @ G_inv
            @ _scale2d(diag(0.5), diag(0.5))) @ _translate2d(diag(0.5),
                                                             diag(0.5))
        ys = torch.arange(Hu, dtype=torch.float32, device=dev) - (Hu - 1) / 2
        xs = torch.arange(Wu, dtype=torch.float32, device=dev) - (Wu - 1) / 2
        gy, gx = torch.meshgrid(ys, xs, indexing='ij')
        pts = torch.stack([gx, gy, torch.ones_like(gx)]).reshape(3, -1)
        src = torch.einsum('bij,jm->bim', G, pts)
        sx = _reflect_coords(src[:, 0] + (Wu - 1) / 2, Wu)
        sy = _reflect_coords(src[:, 1] + (Hu - 1) / 2, Hu)
        # JAX's gather at a coordinate in [-0.5, 0) (module docstring)
        sx = torch.where(sx < 0, sx + 1, sx)
        sy = torch.where(sy < 0, sy + 1, sy)
        grid = torch.stack([(2 * sx + 1) / Wu - 1, (2 * sy + 1) / Hu - 1],
                           -1).reshape(B, Hu, Wu, 2)
        out = grid_sample_gradfix(up, grid.to(up.dtype), 'border')
        return downsample2d(out, self.Hz_geom, down=2, flip_filter=True)

    def _color_matrix(self, d, B, like):
        """The composed 4x4 colour transform (JAX :191-227)."""
        dev = like.device
        eye = torch.eye(4, device=dev)
        C4 = eye.expand(B, 4, 4)
        v = torch.tensor([1, 1, 1, 0], dtype=torch.float32,
                         device=dev) / math.sqrt(3)
        vv = torch.outer(v, v)
        if 'brightness' in d:
            C4 = _translate3d(d['brightness']) @ C4
        if 'contrast' in d:
            C4 = _scale3d(d['contrast']) @ C4
        if 'lumaflip' in d:
            C4 = (eye - 2 * vv * d['lumaflip']) @ C4
        if 'hue' in d:
            C4 = _rotate3d_axis(v, d['hue']) @ C4
        if 'saturation' in d:
            C4 = (vv + (eye - vv) * d['saturation']) @ C4
        return C4

    @staticmethod
    def _execute_color(images, C4):
        """JAX :229-247: 3 channels, 6 (each half alike) or 1 (the rows'
        mean)."""
        B, C, H, W = images.shape
        flat = images.reshape(B, C, H * W)
        M, b = C4[:, :3, :3], C4[:, :3, 3:]
        if C == 3:
            flat = M @ flat + b
        elif C == 6:
            flat = torch.cat([M @ flat[:, :3] + b, M @ flat[:, 3:] + b], 1)
        elif C == 1:
            Cm = C4[:, :3, :].mean(dim=1, keepdim=True)
            flat = flat * Cm[:, :, :3].sum(dim=2, keepdim=True) + Cm[:, :, 3:]
        else:
            raise ValueError('images must have 1, 3 or 6 channels')
        return flat.reshape(B, C, H, W)

    def _execute_filter(self, images, gains):
        """The frequency-band filter at the per-band gains (B, bands)
        (JAX :250-273): each band's gain normalized by the expected power,
        the bank's rows mixed per image, applied separably after a reflect
        pad."""
        dev = images.device
        bands = self.Hz_fbank.shape[0]
        power = torch.tensor(np.array([10, 1, 1, 1]) / 13, dtype=torch.float32,
                             device=dev)
        g = torch.ones(gains.shape[0], bands, device=dev)
        for i in range(len(self.imgfilter_bands)):
            t = torch.ones_like(g)
            t[:, i] = gains[:, i]
            t = t / (power * t.square()).sum(-1, keepdim=True).sqrt()
            g = g * t
        taps = g @ torch.from_numpy(self.Hz_fbank).to(dev)
        pad = self.Hz_fbank.shape[1] // 2
        x = F.pad(images, (pad, pad, pad, pad), mode='reflect')
        return separable_batch_filter(x, taps)


def ada_update_p(p, real_signs_mean, ada_target, nimg_delta, ada_kimg=500,
                 batch_size=32):
    """The ADA controller (JAX :366-372, reference training_loop.py
    :391-394): p moves by nimg_delta / (ada_kimg * 1000) towards keeping
    E[sign(D(real))] at ``ada_target``, clipped to [0, 1]."""
    adjust = np.sign(real_signs_mean - ada_target) * \
        nimg_delta / (ada_kimg * 1000)
    return float(np.clip(p + adjust, 0, 1))
