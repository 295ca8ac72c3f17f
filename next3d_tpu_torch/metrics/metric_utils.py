"""Metric machinery: feature statistics, the detector, the feature loops.

The port's copy of next3d_tpu/metrics/metric_utils.py (reference:
metrics/metric_utils.py: FeatureStats :89-165, the dataset and generator
feature loops :214-305 with the cond_vert flag that feeds FLAME verts to
the generator :27,291-294, the md5-tagged dataset-stats cache :238-247).

Everything runs on ``MetricOptions.device`` (default ``cuda``): the
generator, the detector and the images between them. Each batch's
features return to the host as numpy, where ``FeatureStats`` accumulates
them in float64 as the JAX package does, so a cache file written by either
package is read by the other. The generator loop draws its dataset items,
labels and latents from ``np.random.RandomState(seed)`` in the JAX loop's
order (JAX :210-221), so a seed gives both packages the same draws. As
the JAX loop shards a batch over its devices (JAX :196-217), the port
splits each generated batch: over the ranks of a training run
(``parallel/dist.py``), each rank generating and detecting its rows, the
features gathered in batch order on every rank; or, in one process, over
``MetricOptions.devices`` (``calc-metrics``: every visible card), each
card generating its rows with a copy of the generator, the images gathered
on ``device`` for the detector. Either way ``FeatureStats`` receives the
batch whole and in order, as from one card. The dataset loop runs whole
on each rank.

The detector is Inception-2015: ``NEXT3D_INCEPTION_PATH`` names the
reference's TorchScript pickle, which ``inception.py`` converts into the
port's own graph on the device, after a parity attestation against the
pickle run on the same device. A failed conversion or attestation raises:
the JAX package falls back to the pickle on the CPU there, the port does
not. ``NEXT3D_DETECTOR_IMPL=torch`` runs the pickle itself, on the device.
Any callable from uint8 (N, 3, H, W) images to (N, D) features plugs in as
``MetricOptions.detector``.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..cli.common import inference
from ..parallel import dist


@dataclass
class MetricOptions:
    generator: Any = None           # the generator module, on ``device``
    dataset: Any = None             # ImageFolderDataset
    detector: Optional[Callable] = None
    # 3DMM coefficient extractor for AED/APD (reenactment_distance.py):
    # uint8 (N, 3, H, W) RGB -> (N, >=53) coeffs [exp(50)|pose(3)|...]
    coeff_extractor: Optional[Callable] = None
    num_items: int = 50000
    batch_size: int = 16
    cond_vert: bool = True          # feed FLAME verts to G (reference :27)
    truncation_psi: float = 1.0
    cache_dir: Optional[str] = None
    seed: int = 0
    device: Any = 'cuda'
    # the cards a generated batch splits over in one process, ``device``
    # (the generator's) first; None: ``device`` alone
    devices: Any = None


class FeatureStats:
    """Mean/cov accumulators (reference metric_utils.py:89-165)."""

    def __init__(self, capture_all=False, capture_mean_cov=True,
                 max_items=None):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features = None
        self.all_features = []
        self.raw_mean = None
        self.raw_cov = None

    def set_num_features(self, num_features):
        if self.num_features is None:
            self.num_features = num_features
            self.raw_mean = np.zeros(num_features, np.float64)
            self.raw_cov = np.zeros((num_features, num_features), np.float64)
        else:
            assert self.num_features == num_features

    def is_full(self):
        return self.max_items is not None and self.num_items >= self.max_items

    def append(self, x):
        x = np.asarray(x, np.float32)
        assert x.ndim == 2
        if self.max_items is not None and \
                self.num_items + x.shape[0] > self.max_items:
            if self.num_items >= self.max_items:
                return
            x = x[:self.max_items - self.num_items]
        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x)
        if self.capture_mean_cov:
            x64 = x.astype(np.float64)
            self.raw_mean += x64.sum(0)
            self.raw_cov += x64.T @ x64

    def get_all(self):
        return np.concatenate(self.all_features, 0)

    def get_mean_cov(self):
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items - np.outer(mean, mean)
        return mean, cov

    def save(self, path):
        with open(path, 'wb') as f:
            pickle.dump(self.__dict__, f)

    @classmethod
    def load(cls, path):
        with open(path, 'rb') as f:
            state = pickle.load(f)
        obj = cls()
        obj.__dict__.update(state)
        return obj


def get_detector(opts: MetricOptions, probs=False):
    """The feature detector: ``opts.detector``, else the Inception-2015
    pickle at ``NEXT3D_INCEPTION_PATH`` converted to the port's graph on
    ``opts.device`` and attested against the pickle (``inception.py
    converted_inception``; a failure raises), or with
    ``NEXT3D_DETECTOR_IMPL=torch`` the pickle itself on ``opts.device``.
    With ``probs``, the pickle's IS head: the softmax of its logits without
    the output bias."""
    if opts.detector is not None:
        return opts.detector
    path = os.environ.get('NEXT3D_INCEPTION_PATH')
    if path and os.path.exists(path):
        from .inception import make_detector, torchscript_detector
        kwargs = dict(no_output_bias=True) if probs \
            else dict(return_features=True)
        if os.environ.get('NEXT3D_DETECTOR_IMPL') == 'torch':
            return torchscript_detector(path, opts.device, **kwargs)
        return make_detector(path, opts.device, **kwargs)
    raise RuntimeError(
        'No feature detector: set NEXT3D_INCEPTION_PATH to the Inception-2015 '
        'TorchScript pickle (offline cache; the reference downloads it from '
        'the NVIDIA CDN at metrics/frechet_inception_distance.py:24), or pass '
        'MetricOptions.detector.')


def _to_uint8(img):
    """Images in [-1, 1] -> uint8 on their device, rounded half to even as
    the JAX package's ``np.rint``."""
    return ((img + 1) * 127.5).clamp(0, 255).round().to(torch.uint8)


def to_device(images, device):
    """A batch of uint8 images (numpy or torch) as a tensor on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(images) if isinstance(
        images, np.ndarray) else images).to(device)


def compute_feature_stats_for_dataset(opts: MetricOptions, max_items=None,
                                      **stats_kwargs):
    detector = get_detector(opts)
    ds = opts.dataset
    n = min(len(ds), max_items or len(ds))

    cache_file = None
    if opts.cache_dir:
        tag = hashlib.md5(repr((getattr(ds, '_path', ''), n,
                                sorted(stats_kwargs.items())))
                          .encode()).hexdigest()
        cache_file = os.path.join(opts.cache_dir, f'ds-features-{tag}.pkl')
        if os.path.exists(cache_file):
            return FeatureStats.load(cache_file)

    stats = FeatureStats(max_items=n, **stats_kwargs)
    bs = opts.batch_size
    with inference():
        for lo in range(0, n, bs):
            imgs = np.stack([ds[i][0] for i in range(lo, min(lo + bs, n))])
            if imgs.shape[1] == 1:
                imgs = np.repeat(imgs, 3, axis=1)
            stats.append(detector(to_device(imgs, opts.device)))
            if stats.is_full():
                break
    if cache_file:
        os.makedirs(opts.cache_dir, exist_ok=True)
        stats.save(cache_file)
    return stats


def draw_conditioning(opts, rnd):
    """A batch's dataset labels, latents and verts (or None without
    ``cond_vert``), drawn from ``rnd`` in the JAX loop's order, as tensors
    on ``opts.device``."""
    ds, device = opts.dataset, opts.device
    idx = rnd.randint(len(ds), size=opts.batch_size)
    c = np.stack([ds.get_label(i) for i in idx])
    z = rnd.randn(opts.batch_size, opts.generator.z_dim).astype(np.float32)
    v = None
    if opts.cond_vert:
        v = torch.from_numpy(np.stack([ds.get_verts(i) for i in idx])
                             .astype(np.float32)).to(device)
    return (torch.from_numpy(z).to(device),
            torch.from_numpy(c.astype(np.float32)).to(device), v)


def compute_feature_stats_for_generator(opts: MetricOptions, max_items=None,
                                        **stats_kwargs):
    detector = get_detector(opts)
    devices = opts.devices or [torch.device(opts.device)]
    Gs = dist.replicas(opts.generator, devices)
    stats = FeatureStats(max_items=max_items or opts.num_items,
                         **stats_kwargs)
    rnd = np.random.RandomState(opts.seed)

    def generate(i, z, c, v=None):
        ws = Gs[i].mapping(z, c, truncation_psi=opts.truncation_psi)
        return Gs[i].synthesis(ws, c, v, noise_mode='const')['image']

    with inference():
        while not stats.is_full():
            batch = [x for x in draw_conditioning(opts, rnd) if x is not None]
            if dist.world() > 1:
                counts = dist.split_rows(len(batch[0]))
                lo = sum(counts[:dist.rank()])
                mine = [x[lo:lo + counts[dist.rank()]] for x in batch]
                features = torch.as_tensor(detector(_to_uint8(
                    generate(0, *mine))))
                stats.append(dist.gather_rows(features, counts).cpu())
            else:
                stats.append(detector(_to_uint8(dist.split_over_devices(
                    generate, batch, devices))))
    return stats
