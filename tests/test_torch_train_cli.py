"""The port's ``train`` command and training loop on the CPU, at a tiny
size (128^2 images, 64^2 planes, neural rendering resolution 32,
channel_base 1024, channel_max 32, batch 1) on a toy dataset of the
synthetic head: two ticks, a snapshot, a resume from it through the loop
that gives parameters bit-equal to an uninterrupted run, and one through
the command, which changes the schedules as the JAX command does; the
texture variant with ADA, a fixed augmentation probability and video clips,
each run and resumed; in-training metrics after each snapshot, a failed
one printed while training goes on; the command's options against the JAX
click command's, and what each configuration builds against what the JAX
command builds; ``--gpus`` that no machine here can serve raises. (Two
ranks: tests/test_torch_train_dist.py.)"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import dataclasses

from next3d_tpu.cli import train as jax_train
from next3d_tpu.train import training_loop as jax_training_loop
from next3d_tpu.utils.tensorboard import read_scalars
from next3d_tpu_torch.cli import main as cli
from next3d_tpu_torch.cli import train as port_train
from next3d_tpu_torch.cli.common import camera_label
from next3d_tpu_torch.metrics import metric_main
from next3d_tpu_torch.models.triplane_texture import TriPlaneTextureGenerator
from next3d_tpu_torch.utils.checkpoint import (load_optimizer_state,
                                               load_snapshot)
from next3d_tpu_torch.utils.checkpoint_cases import write_jax_snapshot
from next3d_tpu_torch.utils.synthetic_head import (save_clip_dataset,
                                                   save_dataset, save_head,
                                                   synthetic_head)
from next3d_tpu_torch.utils.weights import load_jax_params

from torch_parity import one_thread  # noqa: F401 (a fixture)
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)


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


def toy_clips(root, n=2, frames=3, size=128, seed=0):
    """``n`` clips of ``frames`` frames of ``toy_dataset``'s kind."""
    mesh, lms = synthetic_head()
    rs = np.random.RandomState(seed)
    base = np.concatenate([mesh.verts, lms])[None]
    clips = []
    for k in range(n):
        v = base + rs.randn(frames, 5091, 3).astype(np.float32) * 0.002
        images = rs.randint(0, 256, (frames, size, size, 3)).astype(np.uint8)
        labels = np.concatenate([camera_label(0.05 * (k + i), 0.0)
                                 for i in range(frames)])
        clips.append((images, v.astype(np.float32), labels))
    return save_clip_dataset(root, clips, mesh)


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp('train')
    data = toy_dataset(str(root / 'data'))
    obj, _ = save_head(str(root / 'head.obj'))
    return root, data, obj


@pytest.fixture(scope='module')
def clips(files):
    return toy_clips(str(files[0] / 'clips'))


def _argv(files, outdir, kimg, *extra, data=None):
    root, images, obj = files
    return ['train', '--outdir', str(root / outdir), '--data', data or images,
            '--batch', '1', '--kimg', str(kimg), '--tick', '0.001',
            '--snap', '2', '--resolution', '128', '--cbase', '1024',
            '--cmax', '32', '--plane-resolution', '64',
            '--neural-rendering-resolution-initial', '32', '--topology-path',
            obj, '--device', 'cpu', '--workers', '0', *extra]


def _state(result):
    return {name: {k: v.clone() for k, v in result[name].state_dict().items()}
            for name in ('G', 'D', 'G_ema')}


def _opts(argv):
    """The options ``cli.run`` hands ``train``."""
    opts = vars(cli.build_parser().parse_args(argv))
    opts.pop('command')
    return opts


def _assert_events_match_stats(run_dir):
    """The run's TensorBoard events file, read by the JAX package's
    read_scalars, holds every numeric field of each stats.jsonl record at
    the global step cur_nimg // 1000, as float32 (JAX's loop :240-245)."""
    (events,) = [f for f in os.listdir(run_dir)
                 if f.startswith('events.out.tfevents.')]
    with open(os.path.join(run_dir, 'stats.jsonl')) as f:
        records = [json.loads(line) for line in f]
    want = [(int(round(r['kimg'] * 1000)) // 1000, k, float(np.float32(v)))
            for r in records for k, v in r.items()
            if isinstance(v, (int, float))]
    assert {k for _, k, _ in want} >= {'tick', 'kimg', 'Loss/G/loss',
                                       'Loss/D/reg', 'Timing/Gmain'}
    assert read_scalars(os.path.join(run_dir, events)) == want


def stub_fid(opts):
    """A small FID for the tests: 4 generated images in one batch, the
    features each image's mean red and green level (a stub detector)."""
    from next3d_tpu_torch.metrics.frechet_inception_distance import \
        compute_fid

    def detector(images):
        return images.float().mean((2, 3))[:, :2].cpu().numpy()
    return {'stub_fid': compute_fid(dataclasses.replace(
        opts, detector=detector, batch_size=4), max_real=None, num_gen=4)}


@pytest.fixture(scope='module')
def whole(files):
    """Three batches at once (a tick each) with a snapshot at ticks 1 and 2
    and two metrics after each: the stub FID, and fid50k_full, which fails
    for want of an Inception detector. Returns the command's result and
    what it printed."""
    import contextlib
    import io
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(metric_main._metric_dict, 'stub_fid', stub_fid)
        mp.delenv('NEXT3D_INCEPTION_PATH', raising=False)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                result = cli.run(_argv(files, 'whole', 0.003, '--snap', '1',
                                       '--metrics', 'stub_fid,fid50k_full'))
        finally:
            torch.set_num_threads(threads)
    return result, out.getvalue()


@pytest.mark.usefixtures('one_thread')
def test_train_resumes_bit_exact(files, whole):
    """Three batches at once (a tick each; with metrics after the snapshots
    of ticks 1 and 2), against two (ticks 0 and 1, a snapshot at the end)
    and a resume from that snapshot for one more through the loop with the
    uninterrupted run's schedules: G, D and G_ema equal bit for bit (the
    metrics disturb no state of training), and the resumed run continues
    cur_nimg and the tick count. Batch 0 runs all four phases, its stats
    are finite, and the third batch moved each network. The run's
    TensorBoard scalars equal its stats.jsonl. (A resume through the
    command changes the schedules as the JAX command does, EMA without
    ramp-up and no blur: ``test_options_build_what_the_jax_command_builds``;
    the command's resumes run in ``test_train_variant_runs_and_resumes``.)"""
    whole, _ = whole
    assert whole['cur_nimg'] == 3 and len(whole['ticks']) == 3
    _assert_events_match_stats(str(files[0] / 'whole'))
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
    opts = _opts(_argv(files, 'resumed', 0.003))
    device = opts.pop('device')
    training = port_train.build_training(opts, device)
    training[-1]['resume_path'] = snap
    resumed = port_train.fit(opts, training, device)
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



def _jax_build(opts):
    """What the JAX command's ``train`` builds for ``opts``: the keyword
    arguments it hands its training loop (the loop itself replaced), with
    its loss object."""
    seen = {}

    def capture(G, D, loss_obj, step, it, **kwargs):
        seen.update(kwargs, G=G, D=D, loss=loss_obj)
        if hasattr(it, 'close'):
            it.close()

    kw = {k: v for k, v in opts.items()
          if k not in ('device', 'timing_sample_every')}
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_training_loop, 'training_loop', capture)
    try:
        jax_train.train(**kw)
    finally:
        patch.undo()
    return seen


CONFIGS = {
    'default': [],
    'resume': ['--resume', 'run/network-snapshot-000000.pkl'],
    'resume-blur': ['--resume', 'run/network-snapshot-000000.pkl',
                    '--resume-blur', 'True', '--aug', 'ada'],
    'ada': ['--aug', 'ada', '--target', '0.7'],
    'fixed': ['--aug', 'fixed', '--p', '0.5'],
    'texture': ['--model-version', 'texture'],
    'video': ['--dataset-type', 'video', '--num-frames-per-video', '2'],
    'gen-exp-cond': ['--gen-exp-cond', 'True'],
}


@pytest.mark.parametrize('config', list(CONFIGS))
def test_options_build_what_the_jax_command_builds(files, clips, config):
    """The schedules, the loss configuration, the augment pipe, the
    networks' classes and the discriminator's widths that the port's
    command builds for a configuration, against what the JAX command
    builds for the same options. A resume (JAX :195-204): ada_kimg 100, no
    EMA ramp-up and, unless --resume-blur, blur_init_sigma and
    gpc_reg_fade_kimg 0."""
    data = clips if config == 'video' else None
    opts = _opts(_argv(files, 'unused', 0.001, *CONFIGS[config], data=data))
    opts.pop('device')
    G, D, _, loss, _, config_dict, loop = port_train.build_training(opts,
                                                                    'cpu')
    want = _jax_build(dict(opts, outdir=str(files[0] / 'jax_build')))
    for key in ('ema_rampup', 'ada_kimg', 'ada_target', 'augment_p',
                'total_kimg', 'batch_size', 'ema_kimg', 'g_reg_interval',
                'kimg_per_tick', 'snapshot_ticks', 'resume_path', 'seed',
                'metrics'):
        assert loop[key] == want[key], key
    got_cfg = dataclasses.asdict(loss.cfg)
    want_cfg = dataclasses.asdict(want['loss'].cfg)
    for key in want_cfg:
        # the port's remat_synthesis defaults to off (train/loss.py), and
        # the command has no option for it
        if key != 'remat_synthesis':
            assert got_cfg[key] == want_cfg[key], key
    pipes = loss.augment_pipe, want['loss'].augment_pipe
    assert (pipes[0] is None) == (pipes[1] is None)
    if pipes[0] is not None:
        for key in ('xflip', 'rotate90', 'xint', 'scale', 'rotate', 'aniso',
                    'xfrac', 'brightness', 'contrast', 'lumaflip', 'hue',
                    'saturation', 'imgfilter', 'noise', 'cutout'):
            assert getattr(pipes[0], key) == getattr(pipes[1], key), key
    assert type(G).__name__ == type(want['G']).__name__
    assert type(D).__name__ == type(want['D']).__name__
    assert D.c_dim == want['D'].c_dim
    assert getattr(D, 'c2_dim', None) == getattr(want['D'], 'c2_dim', None)
    jax_d = getattr(want['D'], 'disc', want['D'])
    assert D.b128.fromrgb.weight.shape[1] == \
        jax_d.blocks[128].fromrgb.in_channels
    assert config_dict['aug'] == opts['aug']


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


VARIANTS = {
    # a target below every mean sign moves p up at each 4th batch by
    # batch * 4 / (ada_kimg * 1000)
    'texture-ada': (['--model-version', 'texture', '--aug', 'ada',
                     '--target', '-2'], 4, 4 / 500000),
    # on labels 75 wide, as the dual-label discriminator needs them
    'fixed': (['--aug', 'fixed', '--p', '0.5', '--gen-exp-cond', 'True'], 2,
              0.5),
    'video': (['--dataset-type', 'video', '--num-frames-per-video', '2',
               '--model-version', 'texture'], 2, 0.0),
}


@pytest.mark.usefixtures('one_thread')
@pytest.mark.parametrize('variant', list(VARIANTS))
def test_train_variant_runs_and_resumes(files, clips, variant):
    """The texture variant with ADA, a fixed augmentation probability with
    the dual-label discriminator (on labels 75 wide, as the JAX command
    needs them) and clips of 2 frames (of the texture variant, the cheaper
    generator on the CPU) train a few batches of 1 on the CPU, with finite
    stats, ``ada_p`` as the controller gives it in the result and in the
    snapshot, and resume from the snapshot for one batch more with the
    snapshot's ``ada_p``. The texture variant's snapshot loads into a
    ``TriPlaneTextureGenerator`` strictly."""
    extra, batches, ada_p = VARIANTS[variant]
    extra = extra + ['--snap', '100']   # a snapshot and a grid at the end
    data = None
    if variant == 'video':
        data = clips
    elif variant == 'fixed':
        data = str(files[0] / 'data75')
        if not os.path.exists(data):
            mesh, _ = synthetic_head()
            rs = np.random.RandomState(1)
            v = (np.concatenate([mesh.verts, synthetic_head()[1]])[None]
                 + rs.randn(2, 5091, 3) * 0.002).astype(np.float32)
            labels = np.concatenate([np.concatenate(
                [camera_label(0.05 * i, 0.0), rs.randn(1, 50)], 1)
                for i in range(2)]).astype(np.float32)
            save_dataset(data, rs.randint(0, 256, (2, 128, 128, 3)).astype(
                np.uint8), v, labels, mesh)
    run = cli.run(_argv(files, variant, batches / 1000, *extra, data=data))
    assert run['cur_nimg'] == batches
    for r in run['ticks']:
        bad = [k for k, x in r.items() if isinstance(x, float)
               and not np.isfinite(x)]
        assert not bad, bad
        assert 'Progress/augment' in r
    assert run['ada_p'] == pytest.approx(ada_p, rel=1e-12, abs=0)
    snap = str(files[0] / variant / 'network-snapshot-000000.pkl')
    saved = load_snapshot(snap)
    assert saved['extra']['ada_p'] == run['ada_p']
    if variant == 'texture-ada':
        G = TriPlaneTextureGenerator(topology_path=files[2],
                                     **saved['config']['G_kwargs'])
        load_jax_params(G, saved['params_G_ema'])
    resumed = cli.run(_argv(files, variant + '-resumed',
                            (batches + 1) / 1000, *extra, '--resume', snap,
                            data=data))
    assert resumed['cur_nimg'] == batches + 1
    assert [r['tick'] for r in resumed['ticks']] == [batches]
    assert resumed['ada_p'] == run['ada_p']


def test_train_metrics_write_their_records(files, whole):
    """``train --metrics`` computes each metric on G_ema after each
    snapshot and appends its record, with the snapshot's name and
    cur_nimg, to metric-<name>.jsonl in the run directory (JAX
    training_loop.py:275-278, :318-338); the dataset's statistics are
    cached there."""
    run = files[0] / 'whole'
    with open(run / 'metric-stub_fid.jsonl') as f:
        records = [json.loads(line) for line in f]
    assert [(r['snapshot_pkl'], r['cur_nimg']) for r in records] == [
        ('network-snapshot-000000.pkl', 2), ('network-snapshot-000000.pkl',
                                             3)]
    for r in records:
        assert r['metric'] == 'stub_fid'
        assert np.isfinite(r['results']['stub_fid'])
        assert r['results']['stub_fid'] > 0
    assert len([f for f in os.listdir(run)
                if f.startswith('ds-features-')]) == 1
    assert 'metric stub_fid: {' in whole[1]


def test_failed_metric_does_not_stop_training(files, whole):
    """A metric that fails (fid50k_full with no Inception detector) is
    printed as FAILED after each snapshot and writes no record, and
    training goes on to its end."""
    result, printed = whole
    failed = [line for line in printed.splitlines()
              if line.startswith('metric fid50k_full FAILED: ')]
    assert len(failed) == 2 and 'NEXT3D_INCEPTION_PATH' in failed[0]
    assert not os.path.exists(files[0] / 'whole' /
                              'metric-fid50k_full.jsonl')
    assert result['cur_nimg'] == 3
    assert [r['tick'] for r in result['ticks']] == [0, 1, 2]


def test_more_gpus_than_visible_cards_raise(files):
    """``--gpus 2`` on ``--device cuda`` asks for more cards than this
    machine shows (none here): it raises, naming both counts, and trains
    on no other device."""
    with pytest.raises(ValueError, match=rf'--gpus 2 .* the '
                       rf'{torch.cuda.device_count()} visible'):
        cli.run(_argv(files, 'gpus', 0.001, '--device', 'cuda', '--gpus',
                      '2'))
    assert not os.path.exists(files[0] / 'gpus')


def test_batch_that_does_not_split_over_gpus_raises(files):
    """A global batch that the ranks cannot share evenly raises, as the
    JAX command asserts (JAX cli/train.py:297-298)."""
    with pytest.raises(ValueError, match='--batch 3 does not split over '
                       '--gpus 2'):
        cli.run(_argv(files, 'split', 0.001, '--batch', '3', '--gpus', '2'))
    assert not os.path.exists(files[0] / 'split')


def test_optax_state_does_not_load():
    """An optimizer state of neither the port's structure nor the optax
    adam structure of the JAX package's make_optimizer raises, naming
    both, rather than restart the Adam moments (an optax adam state loads:
    tests/test_torch_resume_jax.py)."""
    p = torch.nn.Parameter(torch.zeros(3))
    opt = torch.optim.Adam([p])
    optax_like = ({'count': np.zeros(()), 'mu': {'w': np.zeros(3)},
                   'nu': {'w': np.zeros(3)}}, {})
    with pytest.raises(ValueError, match='optax'):
        load_optimizer_state(opt, optax_like, {'w': p})
    with pytest.raises(ValueError, match='optax'):
        load_optimizer_state(opt, pickle.loads(pickle.dumps(
            {'kind': 'optax.adam', 'state': {}})), {'w': p})


def test_optax_state_loads(tmp_path):
    """The optax adam state of a JAX loop's snapshot, as
    utils/checkpoint_cases.py writes one under optax's class names, loads
    into torch Adam: count as each parameter's step, mu and nu as its
    moments."""
    p = torch.nn.Parameter(torch.zeros(3))
    opt = torch.optim.Adam([p])
    mu = {'w': np.arange(3, dtype=np.float32)}
    nu = {'w': np.full(3, 0.5, np.float32)}
    path = str(tmp_path / 'jax.pkl')
    write_jax_snapshot(path, params_G={'w': np.zeros(3, np.float32)},
                       adam_G=(7, mu, nu))
    saved = load_snapshot(path)['opt_state_G']
    assert type(saved[0]).__name__ == 'ScaleByAdamState'
    load_optimizer_state(opt, saved, {'w': p})
    state = opt.state[p]
    assert float(state['step']) == 7.0
    assert torch.equal(state['exp_avg'], torch.from_numpy(mu['w']))
    assert torch.equal(state['exp_avg_sq'], torch.from_numpy(nu['w']))
