"""FID (reference: metrics/frechet_inception_distance.py:22-41).

The port's copy of next3d_tpu/metrics/frechet_inception_distance.py: the
features come from the device, the statistics and the matrix square root
(``scipy.linalg.sqrtm``) are the JAX package's, on the host in float64.
``sqrtm`` is called without JAX's ``disp=False``, which newer SciPy
releases no longer take; it computes the same root either way.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

from .metric_utils import (MetricOptions, compute_feature_stats_for_dataset,
                           compute_feature_stats_for_generator)


def compute_fid(opts: MetricOptions, max_real=None, num_gen=50000):
    stats_real = compute_feature_stats_for_dataset(
        opts, capture_mean_cov=True, max_items=max_real)
    mu_real, sigma_real = stats_real.get_mean_cov()

    stats_gen = compute_feature_stats_for_generator(
        opts, capture_mean_cov=True, max_items=num_gen)
    mu_gen, sigma_gen = stats_gen.get_mean_cov()

    return fid_from_stats(mu_real, sigma_real, mu_gen, sigma_gen)


def fid_from_stats(mu_real, sigma_real, mu_gen, sigma_gen):
    m = np.square(mu_gen - mu_real).sum()
    s = scipy.linalg.sqrtm(np.dot(sigma_gen, sigma_real))
    return float(np.real(m + np.trace(sigma_gen + sigma_real - s * 2)))
