"""Training statistics: per-name moments of the reported scalars.

The port's copy of next3d_tpu/parallel/stats.py (reference:
torch_utils/training_stats.py:58-180), with its API: ``report``,
``report_dict``, ``names``, ``num``, ``mean``, ``std``, ``as_dict`` and
``reset``, accumulating [n, sum(x), sum(x^2)] in float64 on the host. Under
several ranks a training phase's stats reach the collector already averaged
over the ranks: they ride the phase's gradient bucket
(``train/train_step.py``), as JAX's ``pmean`` averages them in the phase,
so rank 0 logs what the JAX loop logs.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np
import torch


class StatsCollector:
    def __init__(self):
        self._moments = defaultdict(lambda: np.zeros(3, np.float64))

    def report(self, name: str, value):
        if torch.is_tensor(value):
            value = value.detach().cpu().numpy()
        value = np.asarray(value, np.float64).reshape(-1)
        m = self._moments[name]
        m[0] += value.size
        m[1] += value.sum()
        m[2] += np.square(value).sum()

    def report_dict(self, stats: Dict[str, float]):
        for k, v in stats.items():
            self.report(k, v)

    def names(self):
        return sorted(self._moments)

    def num(self, name):
        return int(self._moments[name][0])

    def mean(self, name):
        n, s, _ = self._moments[name]
        return float(s / n) if n else float('nan')

    def std(self, name):
        n, s, s2 = self._moments[name]
        if n == 0:
            return float('nan')
        mean = s / n
        var = max(s2 / n - mean * mean, 0.0)
        return float(np.sqrt(var))

    def as_dict(self):
        return {name: {'num': self.num(name), 'mean': self.mean(name),
                       'std': self.std(name)} for name in self.names()}

    def reset(self):
        self._moments.clear()
