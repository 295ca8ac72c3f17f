"""Improved precision & recall (reference: metrics/precision_recall.py).

Counterpart of next3d_tpu/metrics/precision_recall.py: each real and
generated feature's radius is the distance to its k-th nearest neighbour
in its own set; precision is the share of generated features within the
radius of some real one, recall the share of real features within the
radius of some generated one. The distance blocks run in torch on
``opts.device`` in float64, in the JAX package's form
(|a|^2 - 2 a.b + |b|^2, clamped at 0), 1024 rows a block.
"""

from __future__ import annotations

import numpy as np
import torch

from .metric_utils import (MetricOptions, compute_feature_stats_for_dataset,
                           compute_feature_stats_for_generator)


def _sq_dists(rows, cols):
    d2 = (rows.square().sum(1, keepdim=True) - 2 * rows @ cols.T
          + cols.square().sum(1)[None])
    return d2.clamp(min=0)


def kth_nn_distance(row_features, col_features, nhood_size, batch=1024):
    """Distance to the k-th nearest col neighbour (the row itself counting
    as the nearest where it is among the cols) of each row feature."""
    return torch.cat([
        _sq_dists(row_features[lo:lo + batch], col_features)
        .kthvalue(nhood_size + 1, dim=1).values.sqrt()
        for lo in range(0, row_features.shape[0], batch)])


def nn_under_radius(queries, refs, ref_radii, batch=1024):
    """Whether each query lies within the radius of some ref."""
    return torch.cat([
        (_sq_dists(queries[lo:lo + batch], refs).sqrt()
         <= ref_radii[None, :]).any(1)
        for lo in range(0, queries.shape[0], batch)])


def compute_pr(opts: MetricOptions, max_real=200000, num_gen=50000,
               nhood_size=3):
    real = compute_feature_stats_for_dataset(
        opts, capture_all=True, capture_mean_cov=False,
        max_items=max_real).get_all()
    gen = compute_feature_stats_for_generator(
        opts, capture_all=True, capture_mean_cov=False,
        max_items=num_gen).get_all()
    real = torch.from_numpy(real.astype(np.float64)).to(opts.device)
    gen = torch.from_numpy(gen.astype(np.float64)).to(opts.device)

    # manifold radii
    real_radii = kth_nn_distance(real, real, nhood_size)
    gen_radii = kth_nn_distance(gen, gen, nhood_size)
    # precision: the share of generated features inside the real manifold;
    # recall: the share of real features inside the generated one
    precision = float(nn_under_radius(gen, real, real_radii).double().mean())
    recall = float(nn_under_radius(real, gen, gen_radii).double().mean())
    return precision, recall
