"""``python -m next3d_tpu_torch.cli.main calc-metrics``: quality metrics of
a generator checkpoint.

Counterpart of next3d_tpu/cli/calc_metrics.py (reference calc_metrics.py):
the same options and defaults (``--network``, ``--metrics fid50k_full``,
``--data``, ``--topology-path``, ``--run-dir``, ``--batch 16``), plus
``--device`` (default ``cuda``). The checkpoint is a format-1 snapshot of
either package or a reference network pickle (``common.load_generator``,
through ``utils/checkpoint.py read_generator``); the dataset's images,
labels and verts are those of ``--data`` at the generator's resolution.
Each metric's record is printed as a JSON line and, with ``--run-dir``,
appended to ``metric-<name>.jsonl`` there. With ``--device cuda`` the
generator's batches split over every visible card, as the JAX command
shards them over every local device (``metrics/metric_utils.py``).
"""

from __future__ import annotations

import json

from .common import DEMO_OBJ


def add_options(p):
    """The JAX command's options and defaults (next3d_tpu/cli/
    calc_metrics.py:13-20)."""
    p.add_argument('--network', dest='network_path', required=True)
    p.add_argument('--metrics', type=str, default='fid50k_full')
    p.add_argument('--data', dest='data_path', required=True)
    p.add_argument('--topology-path', type=str, default=DEMO_OBJ)
    p.add_argument('--run-dir', type=str, default=None)
    p.add_argument('--batch', dest='batch_size', type=int, default=16)


def calc_metrics(network_path, metrics, data_path, topology_path, run_dir,
                 batch_size, device='cuda'):
    """Compute each metric of the comma-separated ``metrics``; returns
    their records."""
    from ..data.dataset import ImageFolderDataset
    from ..metrics import calc_metric, is_valid_metric, list_valid_metrics
    from ..parallel.dist import local_devices
    from .common import load_generator

    names = metrics.split(',')
    bad = [m for m in names if not is_valid_metric(m)]
    if bad:
        raise ValueError(f'unknown metric {bad[0]}; valid: '
                         f'{list_valid_metrics()}')
    G = load_generator(network_path, topology_path, device)
    dataset = ImageFolderDataset(data_path, resolution=G.img_resolution)
    records = []
    for metric in names:
        record = calc_metric(metric, run_dir=run_dir, generator=G,
                             dataset=dataset, batch_size=batch_size,
                             device=device, devices=local_devices(device))
        print(json.dumps(record, default=str), flush=True)
        records.append(record)
    return records
