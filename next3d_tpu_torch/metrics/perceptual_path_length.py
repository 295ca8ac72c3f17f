"""Perceptual path length (reference: metrics/perceptual_path_length.py).

Counterpart of next3d_tpu/metrics/perceptual_path_length.py: pairs of
latents epsilon apart along a path, their images' VGG16 (LPIPS-style)
feature distance times 1/epsilon^2, the 1% and 99% quantiles filtered out.
The VGG16 detector is the TorchScript pickle at ``NEXT3D_VGG16_PATH``,
run on ``opts.device``; any callable from uint8 (N, 3, H, W) images to
(N, D) features plugs in as ``MetricOptions.detector``.

The draws (dataset items, z pairs, t) come from
``np.random.RandomState(seed)`` in the JAX package's order; the w-space
lerp runs on the device in float32 (the same operations as JAX's numpy
lerp), the z-space slerp on the host in numpy as JAX's; the distances and
the quantile filter are JAX's, on the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..cli.common import inference
from .metric_utils import MetricOptions, _to_uint8, draw_conditioning


def _slerp(a, b, t):
    a_n = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b_n = b / np.linalg.norm(b, axis=-1, keepdims=True)
    d = np.sum(a_n * b_n, axis=-1, keepdims=True)
    p = t * np.arccos(np.clip(d, -1, 1))
    c = b_n - d * a_n
    c = c / np.linalg.norm(c, axis=-1, keepdims=True)
    return (a_n * np.cos(p) + c * np.sin(p)) * np.sqrt(
        np.sum(a * a, -1, keepdims=True))


def get_vgg_detector(opts):
    if opts.detector is not None:
        return opts.detector
    path = os.environ.get('NEXT3D_VGG16_PATH')
    if path and os.path.exists(path):
        from .inception import torchscript_detector
        return torchscript_detector(path, opts.device, resize_images=False,
                                    return_lpips=True)
    raise RuntimeError('set NEXT3D_VGG16_PATH (TorchScript VGG16 pickle) or '
                       'pass MetricOptions.detector for PPL')


def ppl_draws(opts, rnd, epsilon, space, sampling):
    """One batch of the sampler: the latents w at t and t + epsilon (N, L,
    w_dim) on the device, with the batch's labels and verts."""
    G = opts.generator
    device = opts.device
    z0, c, v = draw_conditioning(opts, rnd)
    z0 = z0.cpu().numpy()
    bs = opts.batch_size
    z1 = rnd.randn(bs, G.z_dim).astype(np.float32)
    t = (rnd.rand(bs, 1).astype(np.float32) if sampling == 'full'
         else rnd.randint(2, size=(bs, 1)).astype(np.float32))
    if space == 'w':
        w0 = G.mapping(torch.from_numpy(z0).to(device), c)
        w1 = G.mapping(torch.from_numpy(z1).to(device), c)
        tt = torch.from_numpy(t).to(device)[:, :, None]
        wt0 = w0 + (w1 - w0) * tt
        wt1 = w0 + (w1 - w0) * (tt + np.float32(epsilon))
    else:
        zt0 = _slerp(z0, z1, t)
        zt1 = _slerp(z0, z1, t + epsilon)
        wt0 = G.mapping(torch.from_numpy(zt0).to(device), c)
        wt1 = G.mapping(torch.from_numpy(zt1).to(device), c)
    return wt0, wt1, c, v


def compute_ppl(opts: MetricOptions, num_samples=2000, epsilon=1e-4,
                space='w', sampling='end'):
    """reference: perceptual_path_length.py (PPLSampler semantics).

    space 'w': lerp in w after mapping; 'z': slerp in z before mapping.
    sampling 'end': t in {0, 1}; 'full': t ~ U(0, 1).
    """
    detector = get_vgg_detector(opts)
    G = opts.generator
    rnd = np.random.RandomState(opts.seed)
    dists = []
    done = 0
    with inference():
        while done < num_samples:
            wt0, wt1, c, v = ppl_draws(opts, rnd, epsilon, space, sampling)
            img0 = G.synthesis(wt0, c, v, noise_mode='const')['image']
            img1 = G.synthesis(wt1, c, v, noise_mode='const')['image']
            f0 = np.asarray(detector(_to_uint8(img0)))
            f1 = np.asarray(detector(_to_uint8(img1)))
            dists.append(np.sum(np.square(f0 - f1), axis=-1) / epsilon ** 2)
            done += opts.batch_size

    dist = np.concatenate(dists)[:num_samples]
    # the reference filters outliers outside the [1%, 99%] quantiles
    lo = np.percentile(dist, 1, method='lower')
    hi = np.percentile(dist, 99, method='higher')
    return float(np.extract(np.logical_and(dist >= lo, dist <= hi),
                            dist).mean())
