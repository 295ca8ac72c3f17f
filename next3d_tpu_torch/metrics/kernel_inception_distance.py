"""KID (reference: metrics/kernel_inception_distance.py).

The port's copy of next3d_tpu/metrics/kernel_inception_distance.py: the
same ``RandomState(0)`` subsets and the same float32 polynomial kernel on
the host.
"""

from __future__ import annotations

import numpy as np

from .metric_utils import (MetricOptions, compute_feature_stats_for_dataset,
                           compute_feature_stats_for_generator)


def compute_kid(opts: MetricOptions, max_real=1000000, num_gen=50000,
                num_subsets=100, max_subset_size=1000):
    real = compute_feature_stats_for_dataset(
        opts, capture_all=True, capture_mean_cov=False,
        max_items=max_real).get_all()
    gen = compute_feature_stats_for_generator(
        opts, capture_all=True, capture_mean_cov=False,
        max_items=num_gen).get_all()

    n = real.shape[1]
    m = min(min(real.shape[0], gen.shape[0]), max_subset_size)
    t = 0
    rnd = np.random.RandomState(0)
    for _ in range(num_subsets):
        x = gen[rnd.choice(gen.shape[0], m, replace=False)]
        y = real[rnd.choice(real.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)
