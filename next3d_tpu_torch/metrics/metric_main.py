"""Metric registry and dispatch (reference: metrics/metric_main.py:31-155).

The port's copy of next3d_tpu/metrics/metric_main.py: the same metric
names and result keys; ``calc_metric`` appends each result, with the
evaluated snapshot's name and ``cur_nimg`` where given, to
``<run_dir>/metric-<name>.jsonl``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict

from .metric_utils import MetricOptions

_metric_dict: Dict[str, Callable] = {}


def register_metric(fn):
    _metric_dict[fn.__name__] = fn
    return fn


def is_valid_metric(metric):
    return metric in _metric_dict


def list_valid_metrics():
    return sorted(_metric_dict)


def calc_metric(metric, run_dir=None, snapshot_pkl=None, cur_nimg=None,
                **kwargs):
    """Run ``metric`` with ``MetricOptions(**kwargs)``; the record (the
    results, the metric, its wall time and, where given, ``snapshot_pkl``
    and ``cur_nimg``) is returned and, with ``run_dir``, appended to its
    jsonl file (reference metric_main.py:49-56)."""
    if not is_valid_metric(metric):
        raise ValueError(f'unknown metric {metric}; valid: '
                         f'{list_valid_metrics()}')
    opts = MetricOptions(**kwargs)
    start = time.time()
    results = _metric_dict[metric](opts)
    total_time = time.time() - start
    record = dict(results=results, metric=metric, total_time=total_time,
                  total_time_str=f'{total_time:.1f}s')
    if snapshot_pkl is not None:
        record['snapshot_pkl'] = snapshot_pkl
    if cur_nimg is not None:
        record['cur_nimg'] = cur_nimg
    if run_dir is not None:
        with open(os.path.join(run_dir, f'metric-{metric}.jsonl'), 'at') as f:
            f.write(json.dumps(record) + '\n')
    return record


@register_metric
def fid50k_full(opts):
    from .frechet_inception_distance import compute_fid
    return {'fid50k_full': compute_fid(opts, max_real=None, num_gen=50000)}


@register_metric
def fid2k_full(opts):
    from .frechet_inception_distance import compute_fid
    return {'fid2k_full': compute_fid(opts, max_real=None, num_gen=2000)}


@register_metric
def kid50k_full(opts):
    from .kernel_inception_distance import compute_kid
    return {'kid50k_full': compute_kid(opts, max_real=1000000, num_gen=50000)}


@register_metric
def pr50k3_full(opts):
    from .precision_recall import compute_pr
    precision, recall = compute_pr(opts, max_real=200000, num_gen=50000,
                                   nhood_size=3)
    return {'pr50k3_full_precision': precision,
            'pr50k3_full_recall': recall}


# ------------------------------------------------------------------ legacy
# 50k-subset variants (reference metric_main.py:132-153): identical math but
# real statistics limited to the first 50k images instead of the full set.

@register_metric
def fid50k(opts):
    from .frechet_inception_distance import compute_fid
    return {'fid50k': compute_fid(opts, max_real=50000, num_gen=50000)}


@register_metric
def kid50k(opts):
    from .kernel_inception_distance import compute_kid
    return {'kid50k': compute_kid(opts, max_real=50000, num_gen=50000)}


@register_metric
def pr50k3(opts):
    from .precision_recall import compute_pr
    precision, recall = compute_pr(opts, max_real=50000, num_gen=50000,
                                   nhood_size=3)
    return {'pr50k3_precision': precision, 'pr50k3_recall': recall}


@register_metric
def is50k(opts):
    from .inception_score import compute_is
    mean, std = compute_is(opts, num_gen=50000, num_splits=10)
    return {'is50k_mean': mean, 'is50k_std': std}


@register_metric
def eqt50k_int(opts):
    from .equivariance import compute_equivariance_metrics
    psnr = compute_equivariance_metrics(opts, num_samples=50000,
                                        batch_size=4, compute_eqt_int=True)
    return {'eqt50k_int': psnr}


@register_metric
def eqt50k_frac(opts):
    from .equivariance import compute_equivariance_metrics
    psnr = compute_equivariance_metrics(opts, num_samples=50000,
                                        batch_size=4, compute_eqt_frac=True)
    return {'eqt50k_frac': psnr}


@register_metric
def eqr50k(opts):
    from .equivariance import compute_equivariance_metrics
    psnr = compute_equivariance_metrics(opts, num_samples=50000,
                                        batch_size=4, compute_eqr=True)
    return {'eqr50k': psnr}


@register_metric
def reenact_dist(opts):
    """AED/APD reenactment metrics over the full driving dataset
    (reference's intended evaluation, evaluation.py:105-107)."""
    from .reenactment_distance import compute_aed_apd
    r = compute_aed_apd(opts)
    return {'reenact_dist_aed': r['aed'], 'reenact_dist_apd': r['apd']}


@register_metric
def reenact_dist500(opts):
    """AED/APD over the first 500 driving frames (quick variant)."""
    from .reenactment_distance import compute_aed_apd
    r = compute_aed_apd(opts, num_frames=500)
    return {'reenact_dist500_aed': r['aed'],
            'reenact_dist500_apd': r['apd']}


@register_metric
def ppl2_wend(opts):
    from .perceptual_path_length import compute_ppl
    return {'ppl2_wend': compute_ppl(opts, num_samples=50000, epsilon=1e-4,
                                     space='w', sampling='end')}


@register_metric
def ppl2_wend2k(opts):
    """Quick 2k-sample PPL variant (not in the reference registry)."""
    from .perceptual_path_length import compute_ppl
    return {'ppl2_wend2k': compute_ppl(opts, num_samples=2000, epsilon=1e-4,
                                       space='w', sampling='end')}
