"""Equivariance metrics EQ-T / EQ-T_frac / EQ-R (StyleGAN3).

Counterpart of next3d_tpu/metrics/equivariance.py (reference
metrics/equivariance.py:24-269): the PSNR between a reference render moved
by an image-space operator and a render with the same transform applied by
the generator's Fourier-feature input (``G.synthesis.input.transform``).
Only an alias-free generator has that input; every generator of the port
raises the reference's ValueError (:202-205), as the JAX package's
TriPlaneGenerator does.

The operators (integer and fractional translation, the oriented band-limit
filter, the band-limited affine resampling and its pseudo-rotation) run in
torch on the images' device; the filters are built on the host with numpy
FFTs, as in the JAX package. ``compute_equivariance_metrics`` sets the
transform buffer in place for each render, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..cli.common import inference
from ..ops.grid_sample import grid_sample_2d
from ..ops.upfirdn2d import filter2d, upsample2d


def sinc(x):
    y = np.abs(np.asarray(x, np.float64) * np.pi)
    with np.errstate(divide='ignore', invalid='ignore'):
        z = np.sin(y) / np.clip(y, 1e-30, None)
    return np.where(y < 1e-30, 1.0, z)


def lanczos_window(x, a):
    x = np.abs(np.asarray(x, np.float64)) / a
    return np.where(x < 1, sinc(x), 0.0)


def rotation_matrix(angle):
    a = float(angle)
    m = np.eye(3, dtype=np.float32)
    m[0, 0] = np.cos(a)
    m[0, 1] = np.sin(a)
    m[1, 0] = -np.sin(a)
    m[1, 1] = np.cos(a)
    return m


def apply_integer_translation(x, tx, ty):
    """T_x operator (reference :46-60); tx, ty in image fractions."""
    _N, _C, H, W = x.shape
    ix = int(np.rint(tx * W))
    iy = int(np.rint(ty * H))
    z = torch.zeros_like(x)
    m = torch.zeros_like(x)
    if abs(ix) < W and abs(iy) < H:
        y = x[:, :, max(-iy, 0): H + min(-iy, 0),
              max(-ix, 0): W + min(-ix, 0)]
        z[:, :, max(iy, 0): H + min(iy, 0), max(ix, 0): W + min(ix, 0)] = y
        m[:, :, max(iy, 0): H + min(iy, 0), max(ix, 0): W + min(ix, 0)] = 1
    return z, m


def apply_fractional_translation(x, tx, ty, a=3):
    """T_x with sinc-Lanczos interpolation (reference :66-100)."""
    _N, _C, H, W = x.shape
    txp = float(tx * W)
    typ = float(ty * H)
    ix = int(np.floor(txp))
    iy = int(np.floor(typ))
    fx = txp - ix
    fy = typ - iy
    b = a - 1

    z = torch.zeros_like(x)
    zx0 = max(ix - b, 0)
    zy0 = max(iy - b, 0)
    zx1 = min(ix + a, 0) + W
    zy1 = min(iy + a, 0) + H
    if zx0 < zx1 and zy0 < zy1:
        taps = np.arange(a * 2) - b
        filter_x = (sinc(taps - fx) * sinc((taps - fx) / a))[None, :]
        filter_y = (sinc(taps - fy) * sinc((taps - fy) / a))[:, None]
        y = filter2d(x, (filter_x / filter_x.sum()).astype(np.float32),
                     padding=[b, a, 0, 0])
        y = filter2d(y, (filter_y / filter_y.sum()).astype(np.float32),
                     padding=[0, 0, b, a])
        y = y[:, :, max(b - iy, 0): H + b + a + min(-iy - a, 0),
              max(b - ix, 0): W + b + a + min(-ix - a, 0)]
        z[:, :, zy0:zy1, zx0:zx1] = y

    m = torch.zeros_like(x)
    mx0 = max(ix + a, 0)
    my0 = max(iy + a, 0)
    mx1 = min(ix - b, 0) + W
    my1 = min(iy - b, 0) + H
    if mx0 < mx1 and my0 < my1:
        m[:, :, my0:my1, mx0:mx1] = 1
    return z, m


def construct_affine_bandlimit_filter(mat, a=3, amax=16, aflt=64, up=4,
                                      cutoff_in=1, cutoff_out=1):
    """Oriented windowed-sinc band-limit filter (reference :106-132), a
    float32 numpy array."""
    assert a <= amax < aflt
    mat = np.asarray(mat, np.float64)
    taps = np.roll((np.arange(aflt * up * 2 - 1) + 1) / up - aflt,
                   1 - aflt * up)
    yi, xi = np.meshgrid(taps, taps, indexing='ij')
    pts = np.stack([xi, yi], axis=2) @ mat[:2, :2].T
    xo, yo = pts[..., 0], pts[..., 1]

    fi = sinc(xi * cutoff_in) * sinc(yi * cutoff_in)
    fo = sinc(xo * cutoff_out) * sinc(yo * cutoff_out)
    f = np.real(np.fft.ifftn(np.fft.fftn(fi) * np.fft.fftn(fo)))

    wi = lanczos_window(xi, a) * lanczos_window(yi, a)
    wo = lanczos_window(xo, a) * lanczos_window(yo, a)
    w = np.real(np.fft.ifftn(np.fft.fftn(wi) * np.fft.fftn(wo)))

    f = f * w
    c = (aflt - amax) * up
    f = np.roll(f, (aflt * up - 1,) * 2, axis=(0, 1))[c:-c, c:-c]
    f = np.pad(f, ((0, 1), (0, 1))).reshape(amax * 2, up, amax * 2, up)
    f = f / f.sum(axis=(0, 2), keepdims=True) / (up ** 2)
    f = f.reshape(amax * 2 * up, amax * 2 * up)[:-1, :-1]
    return f.astype(np.float32)


def apply_affine_transformation(x, mat, up=4, **filter_kwargs):
    """Band-limited affine resampling (reference :137-166)."""
    N, C, H, W = x.shape
    mat = np.asarray(mat, np.float32)

    f = construct_affine_bandlimit_filter(mat, up=up, **filter_kwargs)
    assert f.ndim == 2 and f.shape[0] == f.shape[1] and f.shape[0] % 2 == 1
    p = f.shape[0] // 2

    theta = np.linalg.inv(mat).astype(np.float32)
    theta[:2, 2] *= 2
    theta[0, 2] += 1 / up / W
    theta[1, 2] += 1 / up / H
    theta[0, :] *= W / (W + p / up * 2)
    theta[1, :] *= H / (H + p / up * 2)
    theta = torch.from_numpy(theta[:2][None]).to(x.device)
    g = F.affine_grid(theta.expand(N, 2, 3), (N, C, H, W),
                      align_corners=False)

    y = upsample2d(x, f, up=up, padding=p)
    z = grid_sample_2d(y, g)
    m = torch.zeros_like(y)
    c = p * 2 + 1
    m[:, :, c:-c, c:-c] = 1
    m = F.grid_sample(m, g, mode='nearest', padding_mode='zeros',
                      align_corners=False)
    return z, m


def apply_fractional_rotation(x, angle, a=3, **filter_kwargs):
    """R_alpha (reference :172-177)."""
    return apply_affine_transformation(x, rotation_matrix(angle), a=a,
                                       amax=a * 2, **filter_kwargs)


def apply_fractional_pseudo_rotation(x, angle, a=3, **filter_kwargs):
    """R*_alpha: the rotation's frequency response without rotating
    (reference :184-193)."""
    f = construct_affine_bandlimit_filter(rotation_matrix(-angle), a=a,
                                          amax=a * 2, up=1, **filter_kwargs)
    y = filter2d(x, f)
    m = torch.zeros_like(y)
    c = f.shape[0] // 2
    m[:, :, c:-c, c:-c] = 1
    return y, m


def _user_transform(G):
    """The transform buffer of G's synthesis input, or None."""
    return getattr(getattr(getattr(G, 'synthesis', None), 'input', None),
                   'transform', None)


def compute_equivariance_metrics(opts, num_samples, batch_size,
                                 translate_max=0.125, rotate_max=1,
                                 compute_eqt_int=False, compute_eqt_frac=False,
                                 compute_eqr=False):
    """Reference :199-266. Returns PSNR(s) in dB."""
    assert compute_eqt_int or compute_eqt_frac or compute_eqr
    G = opts.generator
    transform = _user_transform(G)
    if not isinstance(transform, torch.Tensor):
        raise ValueError(
            'Cannot compute equivariance metrics; the given generator does '
            'not support user-specified image transformations')

    device = opts.device
    res = G.img_resolution
    rnd = np.random.RandomState(opts.seed)
    I3 = np.eye(3, dtype=np.float32)

    def synthesize(ws, mat):
        transform.copy_(torch.from_numpy(np.asarray(mat, np.float32)))
        return G.synthesis(ws)

    sums = None
    with inference():
        for _ in range(0, num_samples, batch_size):
            z = torch.from_numpy(rnd.randn(batch_size, G.z_dim).astype(
                np.float32)).to(device)
            c = None
            if G.c_dim > 0:
                if opts.dataset is not None:
                    idx = rnd.randint(len(opts.dataset), size=batch_size)
                    c = np.stack([opts.dataset.get_label(int(i))
                                  for i in idx])
                else:
                    c = np.zeros((batch_size, G.c_dim), np.float32)
                c = torch.from_numpy(c.astype(np.float32)).to(device)
            ws = G.mapping(z, c)
            orig = synthesize(ws, I3)
            s = []

            if compute_eqt_int:
                t = (rnd.rand(2) * 2 - 1) * translate_max
                t = np.round(t * res) / res
                M = I3.copy()
                M[:2, 2] = -t
                img = synthesize(ws, M)
                ref, mask = apply_integer_translation(orig, t[0], t[1])
                s += [(ref - img).square() * mask, mask]

            if compute_eqt_frac:
                t = (rnd.rand(2) * 2 - 1) * translate_max
                M = I3.copy()
                M[:2, 2] = -t
                img = synthesize(ws, M)
                ref, mask = apply_fractional_translation(orig, t[0], t[1])
                s += [(ref - img).square() * mask, mask]

            if compute_eqr:
                angle = (rnd.rand() * 2 - 1) * (rotate_max * np.pi)
                img = synthesize(ws, rotation_matrix(-angle))
                ref, ref_mask = apply_fractional_rotation(orig, angle)
                pseudo, pseudo_mask = apply_fractional_pseudo_rotation(
                    img, angle)
                mask = ref_mask * pseudo_mask
                s += [(ref - pseudo).square() * mask, mask]

            s = np.asarray([float(v.double().sum()) for v in s])
            sums = s if sums is None else sums + s
        transform.copy_(torch.from_numpy(I3))

    mses = sums[0::2] / sums[1::2]
    psnrs = np.log10(2) * 20 - np.log10(mses) * 10
    return float(psnrs[0]) if len(psnrs) == 1 else tuple(map(float, psnrs))
