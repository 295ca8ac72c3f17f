"""The port's ``train`` command and training loop on the CPU, at a tiny
size (128^2 images, 64^2 planes, neural rendering resolution 32,
channel_base 1024, channel_max 32, batch 1) on a toy dataset of the
synthetic head: two ticks, a snapshot, a resume from it
that gives parameters bit-equal to an uninterrupted run; the command's
options against the JAX click command's; what is not ported raises."""

import os
import pickle

import numpy as np
import pytest
import torch

from next3d_tpu.cli import train as jax_train
from next3d_tpu_torch.cli import main as cli
from next3d_tpu_torch.cli.common import camera_label
from next3d_tpu_torch.utils.checkpoint import (load_optimizer_state,
                                               load_snapshot)
from next3d_tpu_torch.utils.synthetic_head import (save_dataset, save_head,
                                                   synthetic_head)

from torch_parity import one_thread  # noqa: F401 (a fixture)


def toy_dataset(root, n=4, size=128, seed=0):
    """``n`` items: random images, jittered expressions of the head, camera
    labels at a few yaws."""
    mesh, lms = synthetic_head()
    rs = np.random.RandomState(seed)
    v = np.concatenate([mesh.verts, lms])[None] + rs.randn(
        n, 5091, 3).astype(np.float32) * 0.002
    images = rs.randint(0, 256, (n, size, size, 3)).astype(np.uint8)
    labels = np.concatenate([camera_label(0.05 * i, 0.0) for i in range(n)])
    return save_dataset(root, images, v.astype(np.float32), labels, mesh)


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp('train')
    data = toy_dataset(str(root / 'data'))
    obj, _ = save_head(str(root / 'head.obj'))
    return root, data, obj


def _argv(files, outdir, kimg, *extra):
    root, data, obj = files
    return ['train', '--outdir', str(root / outdir), '--data', data,
            '--batch', '1', '--kimg', str(kimg), '--tick', '0.001',
            '--snap', '2', '--resolution', '128', '--cbase', '1024',
            '--cmax', '32', '--plane-resolution', '64',
            '--neural-rendering-resolution-initial', '32', '--topology-path',
            obj, '--device', 'cpu', '--workers', '0', *extra]


def _state(result):
    return {name: {k: v.clone() for k, v in result[name].state_dict().items()}
            for name in ('G', 'D', 'G_ema')}


@pytest.mark.usefixtures('one_thread')
def test_train_resumes_bit_exact(files):
    """Three batches at once (a tick each), against two (ticks 0 and 1, a
    snapshot at the end) and a resume from that snapshot for one more: G,
    D and G_ema equal bit for bit, and the resumed run continues cur_nimg
    and the tick count. Batch 0 runs all four phases, its stats are finite,
    and the third batch moved each network."""
    whole = cli.run(_argv(files, 'whole', 0.003))
    assert whole['cur_nimg'] == 3 and len(whole['ticks']) == 3
    first = whole['ticks'][0]
    for key in ('Loss/G/loss', 'Loss/G/reg', 'Loss/D/loss', 'Loss/D/reg',
                'Grad/Gmain/norm', 'Grad/Greg/norm', 'Grad/Dmain/norm',
                'Grad/Dreg/norm', 'Timing/Gmain', 'Timing/Greg',
                'Timing/Dmain', 'Timing/Dreg'):
        assert np.isfinite(first[key]), key

    part = cli.run(_argv(files, 'part', 0.002))
    assert part['cur_nimg'] == 2
    run = files[0] / 'part'
    assert {'reals.png', 'fakes000000.png', 'fakes000000_raw.png',
            'stats.jsonl', 'network-snapshot-000000.pkl'} <= set(
                os.listdir(run))
    snap = str(run / 'network-snapshot-000000.pkl')
    assert load_snapshot(snap)['cur_nimg'] == 2
    resumed = cli.run(_argv(files, 'resumed', 0.003, '--resume', snap))
    assert resumed['cur_nimg'] == 3
    assert [r['tick'] for r in resumed['ticks']] == [2]

    want, got = _state(whole), _state(resumed)
    for name in want:
        for k, v in want[name].items():
            assert torch.equal(got[name][k], v), (name, k)
    assert cli.run(_argv(files, 'dry', 0.001, '--dry-run')) is None
    # one batch more moved each network
    moved = _state(part)
    for name in want:
        assert any(not torch.equal(moved[name][k], v)
                   for k, v in want[name].items()), name


def test_options_match_the_jax_command():
    """Every option of the JAX click command, with its default, under the
    same destination (``--kimg`` and ``--tick`` take floats here)."""
    parser = cli.build_parser()
    sub = parser._subparsers._group_actions[0].choices['train']
    got = {a.dest: a.default for a in sub._actions if a.dest != 'help'}
    for param in jax_train.main.params:
        assert param.name in got, param.name
        default = None if param.required else param.default
        assert got[param.name] == default, param.name
    assert got['device'] == 'cuda'
    assert set(got) - {p.name for p in jax_train.main.params} == {
        'device', 'timing_sample_every'}


@pytest.mark.parametrize('extra', [
    ['--model-version', 'texture'], ['--dataset-type', 'video'],
    ['--gen-exp-cond', 'True'], ['--aug', 'ada'], ['--metrics', 'fid50k'],
    ['--gpus', '2']])
def test_unported_options_raise(files, extra):
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        cli.run(_argv(files, 'unported', 0.001, *extra))


def test_optax_state_does_not_load():
    """A JAX snapshot's optax state raises rather than restart the Adam
    moments."""
    p = torch.nn.Parameter(torch.zeros(3))
    opt = torch.optim.Adam([p])
    optax_like = ({'count': np.zeros(()), 'mu': {'w': np.zeros(3)},
                   'nu': {'w': np.zeros(3)}}, {})
    with pytest.raises(NotImplementedError, match='optax'):
        load_optimizer_state(opt, optax_like, {'w': p})
    with pytest.raises(NotImplementedError, match='optax'):
        load_optimizer_state(opt, pickle.loads(pickle.dumps(
            {'kind': 'optax.adam', 'state': {}})), {'w': p})
