"""AED / APD reenactment-quality metrics.

Counterpart of next3d_tpu/metrics/reenactment_distance.py (the reference's
intended evaluation: RMSE over the first 50 expression coefficients and the
3 pose coefficients of a 3DMM fit of each frame, evaluation.py:105-107,
per-frame protocol cal_3dmm_distance.py:14-38).

Protocol: the generator reenacts the driving dataset with a fixed identity
(z from ``opts.seed``, the first item's label for the mapping) and, per
frame, the dataset's camera label and FLAME verts, as the reenact command
does (reference reenact_avatar_next3d.py:125-164); coefficients are
extracted from the real driving frames and from the reenacted ones.

The extractor is ``MetricOptions.coeff_extractor`` (uint8 (N, 3, H, W)
RGB -> (N, >=53) coefficients [exp(50) | pose(3) | ...]) or the
TorchScript module at ``NEXT3D_3DMM_EXTRACTOR`` run on ``opts.device`` on
RGB in [0, 1]. The generator and the extractor run on ``opts.device``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..cli.common import inference
from .metric_utils import MetricOptions, _to_uint8, to_device


def get_coeff_extractor(opts: MetricOptions):
    if opts.coeff_extractor is not None:
        return opts.coeff_extractor
    path = os.environ.get('NEXT3D_3DMM_EXTRACTOR')
    if path and os.path.exists(path):
        model = torch.jit.load(path, map_location=opts.device).eval()

        def extract(images_uint8):
            with torch.no_grad():
                t = to_device(images_uint8, opts.device).float() / 255.0
                return model(t).cpu().numpy()
        return extract
    raise RuntimeError(
        'No 3DMM coefficient extractor: set NEXT3D_3DMM_EXTRACTOR to a '
        'TorchScript module mapping (N,3,H,W) float RGB to (N,>=53) '
        'coefficients [exp(50)|pose(3)|...], or pass '
        'MetricOptions.coeff_extractor.')


def compute_aed_apd(opts: MetricOptions, num_frames=None):
    """Returns dict(aed=..., apd=...) over the first ``num_frames`` frames
    of ``opts.dataset`` (all frames if None)."""
    extractor = get_coeff_extractor(opts)
    G, ds, device = opts.generator, opts.dataset, opts.device
    n = len(ds) if num_frames is None else min(len(ds), num_frames)
    bs = opts.batch_size

    rnd = np.random.RandomState(opts.seed)
    z = torch.from_numpy(rnd.randn(1, G.z_dim).astype(np.float32)).to(device)
    cond_c = torch.from_numpy(
        np.asarray(ds.get_label(0), np.float32)[None, :G.c_dim]).to(device)

    real_coeffs, fake_coeffs = [], []
    with inference():
        ws = G.mapping(z, cond_c, truncation_psi=opts.truncation_psi)
        for lo in range(0, n, bs):
            items = [ds[i] for i in range(lo, min(lo + bs, n))]
            real = np.stack([it[0] for it in items])
            if real.shape[1] == 1:
                real = np.repeat(real, 3, axis=1)
            c = np.stack([np.asarray(it[1], np.float32) for it in items])
            v = np.stack([np.asarray(it[2], np.float32) for it in items])
            fake = G.synthesis(
                ws.expand(len(items), *ws.shape[1:]),
                torch.from_numpy(c[:, :G.c_dim]).to(device),
                torch.from_numpy(v).to(device), noise_mode='const')['image']
            real_coeffs.append(np.asarray(extractor(to_device(real,
                                                              device))))
            fake_coeffs.append(np.asarray(extractor(_to_uint8(fake))))

    real_c = np.concatenate(real_coeffs, 0)
    fake_c = np.concatenate(fake_coeffs, 0)
    if real_c.shape[1] < 53 or fake_c.shape[1] < 53:
        raise ValueError(f'coeff extractor must emit >=53 coeffs, got '
                         f'{real_c.shape} and {fake_c.shape}')

    def rmse(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2)))

    return dict(aed=rmse(real_c[:, :50], fake_c[:, :50]),
                apd=rmse(real_c[:, 50:53], fake_c[:, 50:53]))
