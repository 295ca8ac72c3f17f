"""``train --gpus 2 --device cpu``: the train command on two gloo ranks on
the CPU, at tests/test_torch_train_cli.py's tiny size (128^2, 64^2 planes,
neural rendering resolution 32) with a global batch of 2, one image a
rank, a tick a batch:

- three ticks at once (tests/torch_dist_workers.py ``train``: the
  command's rank entry, ``run_rank``, with a stub metric registered in the
  ranks) against two ticks through the command and a resume from their
  snapshot through the command for one more: G and D bit-equal (the ranks'
  generator states, the optimizers, the sampler and the conditioning
  stream all resume; G_ema follows the resume's EMA schedule, which the
  command changes as the JAX command does);
- rank 0 alone writes the run directory: one stats.jsonl line a tick, one
  events file, one snapshot, one metric record;
- ``train --metrics`` on two ranks gives the features a single process
  computes from the snapshot's G_ema, in batch order.

Blur is off (``--blur-fade-kimg 0``) so that the resume's schedule, which
turns it off, is the run's own."""

import json
import os

import numpy as np
import pytest

from next3d_tpu_torch.cli import main as cli
from next3d_tpu_torch.cli.common import load_generator
from next3d_tpu_torch.data.dataset import ImageFolderDataset
from next3d_tpu_torch.metrics import metric_utils
from next3d_tpu_torch.utils.checkpoint import load_snapshot
from next3d_tpu_torch.utils.synthetic_head import save_head
from next3d_tpu_torch.utils.weights import params_to_state_dict

import torch_dist_workers as workers
from test_torch_train_cli import toy_dataset
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)

SNAPSHOT = 'network-snapshot-000000.pkl'


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp('train_dist')
    data = toy_dataset(str(root / 'data'))
    obj, _ = save_head(str(root / 'head.obj'))
    return root, data, obj


def _argv(files, outdir, kimg, *extra):
    root, data, obj = files
    return ['train', '--outdir', str(root / outdir), '--data', data,
            '--batch', '2', '--kimg', str(kimg), '--tick', '0.001',
            '--snap', '2', '--resolution', '128', '--cbase', '1024',
            '--cmax', '32', '--plane-resolution', '64',
            '--neural-rendering-resolution-initial', '32',
            '--blur-fade-kimg', '0', '--topology-path', obj, '--device',
            'cpu', '--workers', '0', '--gpus', '2', *extra]


@pytest.fixture(scope='module')
def runs(files):
    """Three ticks with the stub metric after the snapshot of the last,
    on two ranks; then two ticks through the command and one more from
    their snapshot."""
    argv = _argv(files, 'whole', 0.006, '--metrics', 'stub_feats')
    opts = vars(cli.build_parser().parse_args(argv))
    opts.pop('command'), opts.pop('device')
    whole = workers.run(workers.train, 2, opts)
    part = cli.run(_argv(files, 'part', 0.004))
    resumed = cli.run(_argv(files, 'resumed', 0.006, '--resume',
                            str(files[0] / 'part' / SNAPSHOT)))
    return whole, part, resumed


def _params(run_dir):
    snap = load_snapshot(os.path.join(run_dir, SNAPSHOT))
    return snap, {key: params_to_state_dict(snap[key]) for key in
                  ('params_G', 'params_D', 'params_G_ema')}


def test_two_rank_run_resumes_exactly(files, runs):
    """The resumed run's G and D equal the uninterrupted run's bit for
    bit; it continues cur_nimg and the tick count, and returns rank 0's
    ticks."""
    whole, part, resumed = runs
    assert [r['cur_nimg'] for r in whole] == [6, 6]
    assert [t['tick'] for t in whole[0]['ticks']] == [0, 1, 2]
    assert part['cur_nimg'] == 4 and resumed['cur_nimg'] == 6
    assert [t['tick'] for t in resumed['ticks']] == [2]
    for t in whole[0]['ticks']:
        bad = [k for k, x in t.items() if isinstance(x, float)
               and not np.isfinite(x)]
        assert not bad, bad
    assert 'Timing/Gmain/allreduce' in whole[0]['ticks'][0]
    snap, want = _params(files[0] / 'whole')
    assert len(snap['extra']['rank_rng_states']) == 2
    _, got = _params(files[0] / 'resumed')
    _, before = _params(files[0] / 'part')
    for key in ('params_G', 'params_D'):
        for k, v in want[key].items():
            assert np.array_equal(got[key][k], v), (key, k)
        assert any(not np.array_equal(before[key][k], v)
                   for k, v in want[key].items()), key


def test_only_rank_0_writes(files, runs):
    """Each run directory holds what one writer leaves: a stats.jsonl line
    a tick, one TensorBoard events file, one metric record, the grids and
    the snapshot."""
    root = files[0]
    for name, ticks, metric in (('whole', 3, True), ('part', 2, False),
                                ('resumed', 1, False)):
        listing = sorted(os.listdir(root / name))
        events = [f for f in listing if f.startswith('events.out.')]
        want = {'training_options.json', 'stats.jsonl', 'reals.png',
                'fakes000000.png', 'fakes000000_raw.png', SNAPSHOT,
                SNAPSHOT.replace('.pkl', '.json'), *events}
        if metric:
            want |= {'metric-stub_feats.jsonl', 'stub-feats.pkl'}
        assert set(listing) == want and len(events) == 1, (name, listing)
        with open(root / name / 'stats.jsonl') as f:
            assert len(f.readlines()) == ticks, name
    with open(root / 'whole' / 'metric-stub_feats.jsonl') as f:
        (record,) = [json.loads(line) for line in f]
    assert record['cur_nimg'] == 6 and record['snapshot_pkl'] == SNAPSHOT


def test_two_rank_metric_features_equal_one_process(files, runs):
    """The stub metric's features on two ranks (an image a rank, gathered
    in batch order) against the generator feature loop of one process on
    the snapshot's G_ema: the same 2 items in order. Each rank runs the
    generator at batch 1, one process at batch 2, whose
    convolutions may round apart; a stub feature is a mean over 128^2
    pixels of uint8 levels, so a level flipped at a pixel moves it by
    6.1e-5: the gate, 1e-3, allows a few such flips and no other item."""
    root, data, obj = files
    got = metric_utils.FeatureStats.load(str(root / 'whole' /
                                             'stub-feats.pkl'))
    G_ema = load_generator(str(root / 'whole' / SNAPSHOT), obj, 'cpu')
    dataset = ImageFolderDataset(data, resolution=128)
    want = metric_utils.compute_feature_stats_for_generator(
        metric_utils.MetricOptions(generator=G_ema, dataset=dataset,
                                   detector=workers.stub_detector,
                                   batch_size=2, device='cpu'),
        max_items=2, capture_all=True)
    a, b = got.get_all(), want.get_all()
    print('features, 2 ranks vs one process: max-abs', np.abs(a - b).max())
    assert got.num_items == want.num_items == 2
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    gaps = np.abs(a[:, None] - b[None]).max(-1)
    assert (gaps.argmin(1) == np.arange(2)).all()
