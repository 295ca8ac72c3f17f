"""Inception score (reference: metrics/inception_score.py).

The port's copy of next3d_tpu/metrics/inception_score.py: the detector
gives softmax probabilities, those of the Inception pickle called with
``no_output_bias=True`` (reference inception_score.py:23); without an
explicit detector it is the converted pickle's on ``opts.device``
(``metric_utils.get_detector(opts, probs=True)``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .metric_utils import (MetricOptions, compute_feature_stats_for_generator,
                           get_detector)


def compute_is(opts: MetricOptions, num_gen=50000, num_splits=10):
    opts = dataclasses.replace(opts, detector=get_detector(opts, probs=True))
    gen_probs = compute_feature_stats_for_generator(
        opts, capture_all=True, capture_mean_cov=False,
        max_items=num_gen).get_all()
    scores = []
    for i in range(num_splits):
        part = gen_probs[i * num_gen // num_splits:
                         (i + 1) * num_gen // num_splits]
        kl = part * (np.log(part + 1e-12) -
                     np.log(np.mean(part, 0, keepdims=True) + 1e-12))
        scores.append(np.exp(np.mean(np.sum(kl, 1))))
    return float(np.mean(scores)), float(np.std(scores))
