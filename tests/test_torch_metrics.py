"""The port's metrics (next3d_tpu_torch/metrics/) against the JAX package's
(next3d_tpu/metrics/) on the CPU.

FID, KID, precision/recall, IS, PPL (w and z spaces, end and full
sampling) and AED/APD run in both packages on one toy dataset with the same
stub generator and the same stub detector, as tests/test_data_metrics.py
stubs them: the stubs of both packages compute in one numpy function, so
that given the same draws they give the same images and features bit for
bit, and the metrics must agree to float64 roundoff (a relative 1e-9;
precision and recall exactly). The dataset-stats cache that one package
writes is read by the other. The generator feature loop runs the real
generators at 128^2 (tests/test_torch_cli_parity.py's configuration, JAX
rasterizing with K1 in interpret mode): the port's draws equal the JAX
loop's, and its images meet the fp32 gate of ROADMAP.md (max-abs 2e-3,
mean-abs 1e-4). The equivariance operators are held to the JAX package's,
and compute_equivariance_metrics raises JAX's ValueError for the port's
generators without a user transform. The ``calc-metrics`` command takes
the JAX command's options, and runs end to end on the CPU with a scripted
Inception detector of seeded weights."""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

from next3d_tpu.cli import common as jax_common
from next3d_tpu.data import ImageFolderDataset as JaxDataset
from next3d_tpu.metrics import equivariance as jax_eq
from next3d_tpu.metrics import metric_main as jax_main
from next3d_tpu.metrics import metric_utils as jax_utils
from next3d_tpu.models import triplane_next3d as jax_model
from next3d_tpu_torch.cli import common
from next3d_tpu_torch.cli import main as cli
from next3d_tpu_torch.cli.common import camera_label
from next3d_tpu_torch.data.dataset import ImageFolderDataset
from next3d_tpu_torch.metrics import equivariance, inception, metric_main
from next3d_tpu_torch.metrics import metric_utils
from next3d_tpu_torch.utils.checkpoint import save_snapshot
from next3d_tpu_torch.utils.synthetic_head import (save_dataset, save_head,
                                                   synthetic_head)
from next3d_tpu_torch.utils.weights import load_jax_params

from test_torch_cli_parity import G_KWARGS, _k1_interpret
from test_torch_generator import _liven_w_avg
from torch_parity import n, one_thread, to_jax_tree  # noqa: F401
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)

# metrics computed from the same features in float64 on the host: equal up
# to roundoff (the port's precision/recall distances run in torch)
REL = 1e-9
N_ITEMS = 12
Z_DIM = 8
_rs = np.random.RandomState(7)
PATTERN = _rs.randn(4, 3, 32, 32)
PROJ = _rs.randn(48, 8)
PROBS = _rs.randn(8, 10)


# ------------------------------------------------------------------ stubs
def stub_images(ws, c, v):
    """(N, 3, 32, 32) images in [-1, 1] of a batch's latents, labels and
    verts: the one function behind both packages' stub generators,
    computed in float64 and rounded once, so that neither the arrays'
    layouts nor BLAS's summation order reaches the float32 result."""
    w = np.asarray(ws, np.float64)[:, 0]
    img = np.einsum('nk,kchw->nchw', w[:, :4], PATTERN) * 0.5 \
        + 0.05 * np.asarray(c, np.float64)[:, 3, None, None, None]
    if v is not None:
        img = img + 2.0 * np.asarray(v, np.float64)[:, :, 1].mean(
            1)[:, None, None, None]
    return np.tanh(img).astype(np.float32)


def stub_features(images_uint8):
    """(N, 8) features of uint8 images of any size that 4 divides: the
    channels' 4x4 block means through a fixed projection, squared (in
    float64, rounded once)."""
    x = np.asarray(images_uint8).astype(np.float64) / 255.0
    N, C, H, W = x.shape
    x = x.reshape(N, C, 4, H // 4, 4, W // 4).mean((3, 5)).reshape(N, -1)
    return ((x @ PROJ) ** 2).astype(np.float32)


def stub_probs(images_uint8):
    f = stub_features(images_uint8).astype(np.float64) @ PROBS
    e = np.exp(f - f.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


def stub_coeffs(images_uint8):
    """(N, 56) '3DMM coefficients'."""
    f = stub_features(images_uint8)
    return np.tile(np.concatenate([f, np.sqrt(f)], 1), (1, 4))[:, :56]


def on_host(fn):
    """A stub detector of the port: tensors on the device -> numpy."""
    return lambda images: fn(n(images))


class JaxStubG:
    z_dim = Z_DIM
    c_dim = 25

    def mapping(self, params, z, c, truncation_psi=1):
        return np.repeat(np.asarray(z)[:, None], 2, 1)

    def synthesis(self, params, ws, c, v, noise_mode='const'):
        return {'image': stub_images(ws, c, None if v is None
                                     else np.asarray(v))}


class PortStubG:
    z_dim = Z_DIM
    c_dim = 25

    def mapping(self, z, c, truncation_psi=1):
        return z[:, None].repeat(1, 2, 1)

    def synthesis(self, ws, c, v, noise_mode='const'):
        return {'image': torch.from_numpy(stub_images(
            n(ws), n(c), None if v is None else n(v)))}


# --------------------------------------------------------------- fixtures
@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """A toy dataset of N_ITEMS 128^2 images with jittered head verts and
    camera labels, and the head's mesh files."""
    root = tmp_path_factory.mktemp('metrics')
    mesh, lms = synthetic_head()
    rs = np.random.RandomState(0)
    v = np.concatenate([mesh.verts, lms])[None] + rs.randn(
        N_ITEMS, 5091, 3).astype(np.float32) * 0.01
    images = rs.randint(0, 256, (N_ITEMS, 128, 128, 3)).astype(np.uint8)
    labels = np.concatenate([camera_label(0.04 * i - 0.2, 0.01 * i)
                             for i in range(N_ITEMS)])
    data = save_dataset(str(root / 'data'), images, v.astype(np.float32),
                        labels, mesh)
    obj, lms_path = save_head(str(root / 'head.obj'))
    return dict(root=root, data=data, obj=obj, lms=lms_path)


def _opts(files, port, **kw):
    """MetricOptions of one package on the toy dataset with its stubs."""
    if port:
        base = dict(generator=PortStubG(),
                    dataset=ImageFolderDataset(files['data']),
                    detector=on_host(stub_features),
                    coeff_extractor=on_host(stub_coeffs), device='cpu')
        return metric_utils.MetricOptions(**base, batch_size=4, **kw)
    base = dict(generator=JaxStubG(), params={},
                dataset=JaxDataset(files['data']), detector=stub_features,
                coeff_extractor=stub_coeffs, jit=False)
    return jax_utils.MetricOptions(**base, batch_size=4, **kw)


def _both(files, fn_name, module, detector=None, **kwargs):
    """``module.fn_name`` of both packages on their options."""
    import importlib
    got_mod = importlib.import_module(f'next3d_tpu_torch.metrics.{module}')
    want_mod = importlib.import_module(f'next3d_tpu.metrics.{module}')
    port, jax_opts = _opts(files, True), _opts(files, False)
    if detector is not None:
        port = dataclasses.replace(port, detector=on_host(detector))
        jax_opts = dataclasses.replace(jax_opts, detector=detector)
    return (getattr(got_mod, fn_name)(port, **kwargs),
            getattr(want_mod, fn_name)(jax_opts, **kwargs))


def _close(got, want, rel=REL):
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    assert np.all(np.isfinite(got)), got
    np.testing.assert_allclose(got, want, rtol=rel, atol=0)


# ------------------------------------------------------------------ tests
METRICS = {
    'fid': ('compute_fid', 'frechet_inception_distance', None,
            dict(max_real=None, num_gen=20)),
    'kid': ('compute_kid', 'kernel_inception_distance', None,
            dict(max_real=None, num_gen=20, num_subsets=7,
                 max_subset_size=10)),
    'pr': ('compute_pr', 'precision_recall', None,
           dict(max_real=None, num_gen=20, nhood_size=3)),
    'is': ('compute_is', 'inception_score', stub_probs,
           dict(num_gen=20, num_splits=4)),
    'ppl-w-end': ('compute_ppl', 'perceptual_path_length', None,
                  dict(num_samples=12, epsilon=1e-4, space='w',
                       sampling='end')),
    'ppl-z-full': ('compute_ppl', 'perceptual_path_length', None,
                   dict(num_samples=12, epsilon=1e-4, space='z',
                        sampling='full')),
    'aed-apd': ('compute_aed_apd', 'reenactment_distance', None,
                dict(num_frames=10)),
}


@pytest.mark.parametrize('metric', list(METRICS))
def test_metric_matches_jax(files, metric):
    """Each metric of both packages on the same stub generator and
    detector: the same value to a relative 1e-9 (precision and recall
    exactly); a PPL of 1/epsilon^2 = 1e8 times the feature distances
    agrees only where the sampler's draws, its lerp or slerp and its
    quantile filter are the same."""
    fn, module, detector, kwargs = METRICS[metric]
    got, want = _both(files, fn, module, detector, **kwargs)
    print(metric, got, want)
    if metric == 'pr':
        assert got == want and 0 < min(want)
    elif metric == 'aed-apd':
        assert set(got) == set(want) == {'aed', 'apd'}
        for k in want:
            _close(got[k], want[k])
            assert want[k] > 0
    else:
        _close(got, want)


def test_precision_recall_counts_equal_numpy(files):
    """The port's float64 torch distance blocks give the numpy original's
    radii and hit counts on features of the detector's width, in blocks
    that split the rows."""
    from next3d_tpu.metrics import precision_recall as jax_pr
    from next3d_tpu_torch.metrics import precision_recall as port_pr
    rs = np.random.RandomState(1)
    real = rs.randn(300, 64)
    gen = rs.randn(250, 64) * 1.1 + 0.05
    want_r = jax_pr._kth_nn_distance(real, real, 3, batch=128)
    got_r = port_pr.kth_nn_distance(torch.from_numpy(real),
                                    torch.from_numpy(real), 3, batch=128)
    np.testing.assert_allclose(n(got_r), want_r, rtol=1e-12)
    want = jax_pr._nn_under_radius(gen, real, want_r, batch=128)
    got = port_pr.nn_under_radius(torch.from_numpy(gen),
                                  torch.from_numpy(real), got_r, batch=128)
    np.testing.assert_array_equal(n(got), want)
    assert 0 < want.sum() < len(want)


def test_dataset_stats_cache_reads_across_packages(files, tmp_path):
    """The md5-tagged dataset-stats file written by one package is read by
    the other (its detector never called), with equal statistics."""
    def refuse(_images):
        raise AssertionError('the cache was not read')

    for writer, reader in ((True, False), (False, True)):
        cache = str(tmp_path / f'cache-{writer}')
        mods = {True: metric_utils, False: jax_utils}
        written = mods[writer].compute_feature_stats_for_dataset(
            _opts(files, writer, cache_dir=cache), capture_all=True)
        (name,) = os.listdir(cache)
        assert re.fullmatch(r'ds-features-[0-9a-f]{32}\.pkl', name)
        read = mods[reader].compute_feature_stats_for_dataset(
            dataclasses.replace(_opts(files, reader, cache_dir=cache),
                                detector=refuse), capture_all=True)
        assert type(read).__module__ == mods[reader].__name__
        assert read.num_items == written.num_items == N_ITEMS
        for a, b in zip(read.get_mean_cov(), written.get_mean_cov()):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(read.get_all(), written.get_all())


def test_feature_stats_match_jax():
    """FeatureStats accumulates, caps and reports mean and covariance as
    the JAX package's, bit for bit."""
    x = np.random.RandomState(2).randn(70, 6).astype(np.float32)
    got = metric_utils.FeatureStats(capture_all=True, max_items=50)
    want = jax_utils.FeatureStats(capture_all=True, max_items=50)
    for lo in range(0, 70, 16):
        got.append(x[lo:lo + 16])
        want.append(x[lo:lo + 16])
    assert got.is_full() and got.num_items == want.num_items == 50
    np.testing.assert_array_equal(got.get_all(), want.get_all())
    for a, b in zip(got.get_mean_cov(), want.get_mean_cov()):
        np.testing.assert_array_equal(a, b)


def test_to_uint8_matches_jax():
    """Images in [-1, 1] (and beyond) to uint8, ties rounded to even."""
    x = np.concatenate([np.linspace(-1.2, 1.2, 4001, dtype=np.float32),
                        (np.arange(256, dtype=np.float32) + 0.5) / 127.5
                        - 1]).reshape(1, 1, -1, 1)
    np.testing.assert_array_equal(
        n(metric_utils._to_uint8(torch.from_numpy(x))),
        jax_utils._to_uint8(x))


@pytest.fixture(scope='module')
def generators(files):
    """The port's generator and the JAX package's at
    test_torch_cli_parity.py's configuration on the same weights, JAX's
    rasterizer swapped for its K1 in interpret mode."""
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_model, 'rasterize_uv_with_alpha', _k1_interpret)
    torch.manual_seed(0)
    port = common.build_generator_from_kwargs(G_KWARGS, files['obj'],
                                              device='cpu')
    params = _liven_w_avg(to_jax_tree(port), np.random.RandomState(5))
    load_jax_params(port, params)
    jg = jax_common.build_generator_from_kwargs(G_KWARGS, files['obj'])
    yield port, jg, params
    patch.undo()


@pytest.mark.usefixtures('one_thread')
def test_generator_feature_loop_matches_jax(files, generators, monkeypatch):
    """One batch of 2 of each package's generator feature loop (seed 3,
    truncation 0.8): the port draws the JAX loop's items, labels, latents
    and verts, and its images meet the fp32 gate against JAX's jitted
    loop; the detector sees them as uint8 within 1 level."""
    port, jg, params = generators
    seen = {'port': [], 'jax': []}

    def recorder(key, to_uint8):
        def record(img):
            seen[key].append(n(img))
            return to_uint8(img)
        return record

    monkeypatch.setattr(metric_utils, '_to_uint8',
                        recorder('port', metric_utils._to_uint8))
    monkeypatch.setattr(jax_utils, '_to_uint8',
                        recorder('jax', jax_utils._to_uint8))
    drawn = []
    mapping = port.mapping
    monkeypatch.setattr(port, 'mapping', lambda z, c, **kw: (
        drawn.append((n(z), n(c), kw)), mapping(z, c, **kw))[1])

    kw = dict(batch_size=2, seed=3, truncation_psi=0.8,
              detector=stub_features)
    want = jax_utils.compute_feature_stats_for_generator(
        jax_utils.MetricOptions(generator=jg, params=params, jit=True,
                                dataset=JaxDataset(files['data']), **kw),
        max_items=2, capture_all=True)
    got = metric_utils.compute_feature_stats_for_generator(
        metric_utils.MetricOptions(generator=port, device='cpu',
                                   dataset=ImageFolderDataset(files['data']),
                                   **dict(kw, detector=on_host(
                                       stub_features))),
        max_items=2, capture_all=True)

    rnd = np.random.RandomState(3)
    ds = ImageFolderDataset(files['data'])
    idx = rnd.randint(N_ITEMS, size=2)
    z = rnd.randn(2, G_KWARGS['z_dim']).astype(np.float32)
    ((dz, dc, dkw),) = drawn
    np.testing.assert_array_equal(dz, z)
    np.testing.assert_array_equal(dc, np.stack([ds.get_label(i)
                                                for i in idx]))
    assert dkw == {'truncation_psi': 0.8}
    a, b = seen['port'][0], seen['jax'][0]
    err = np.abs(a - b)
    print(f'images: max-abs {err.max():.3g} mean-abs {err.mean():.3g}')
    assert a.shape == b.shape == (2, 3, 128, 128)
    assert err.max() <= 2e-3 and err.mean() <= 1e-4
    assert np.abs(got.get_all() - want.get_all()).max() < 0.05


EQ_CASES = {
    'integer': lambda x: ('apply_integer_translation', (x, 0.25, -0.125)),
    'integer-out': lambda x: ('apply_integer_translation', (x, 0.9, 0.2)),
    'fractional': lambda x: ('apply_fractional_translation',
                             (x, 0.1, -0.07)),
    'fractional-far': lambda x: ('apply_fractional_translation',
                                 (x, 0.33, 0.41)),
    'rotation': lambda x: ('apply_fractional_rotation', (x, 0.45)),
    'pseudo-rotation': lambda x: ('apply_fractional_pseudo_rotation',
                                  (x, -1.1)),
}


@pytest.mark.parametrize('case', list(EQ_CASES))
def test_equivariance_operators_match_jax(case):
    """The image-space operators of EQ-T, EQ-T_frac and EQ-R on a seeded
    (2, 3, 32, 32) batch (values up to about 3.4): images within 5e-5 of
    the JAX package's (float32 filters of up to 47x47 taps and resampling,
    summed in two libraries' orders: 1.5e-5 for the rotation), masks
    equal."""
    x = np.random.RandomState(4).randn(2, 3, 32, 32).astype(np.float32)
    name, args = EQ_CASES[case](x)
    got = getattr(equivariance, name)(torch.from_numpy(x), *args[1:])
    want = getattr(jax_eq, name)(*args)
    np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), atol=5e-5,
                               rtol=0)
    np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
    assert float(np.asarray(want[1]).mean()) > 0.05


def test_equivariance_bandlimit_filter_matches_jax():
    for angle in (0.3, -1.1):
        got = equivariance.construct_affine_bandlimit_filter(
            equivariance.rotation_matrix(angle), a=3, amax=6, up=4)
        want = jax_eq.construct_affine_bandlimit_filter(
            jax_eq.rotation_matrix(angle), a=3, amax=6, up=4)
        np.testing.assert_array_equal(got, want)


def test_equivariance_refuses_the_port_generators(generators):
    """None of the flagship, the texture variant and EG3D has a user
    transform: compute_equivariance_metrics raises the JAX package's
    ValueError, through the registry too (the port's SG3Generator runs it:
    tests/test_torch_sg3.py)."""
    from next3d_tpu_torch.models.triplane_eg3d import EG3DTriPlaneGenerator
    from next3d_tpu_torch.models.triplane_texture import \
        TriPlaneTextureGenerator
    port, _, _ = generators
    mesh, _ = synthetic_head()
    texture = TriPlaneTextureGenerator(
        topology_path=mesh, z_dim=8, c_dim=25, w_dim=16, img_resolution=128,
        img_channels=3, channel_base=64, channel_max=4, plane_resolution=64,
        rendering_kwargs={'superresolution_module':
                          'SuperresolutionHybrid2X'})
    eg3d = EG3DTriPlaneGenerator(
        z_dim=8, c_dim=25, w_dim=512, img_resolution=128, img_channels=3,
        channel_base=1024, channel_max=4,
        rendering_kwargs={'superresolution_module':
                          'SuperresolutionHybrid2X'})
    for G in (port, texture, eg3d):
        opts = metric_utils.MetricOptions(generator=G, device='cpu')
        with pytest.raises(ValueError, match='user-specified image '
                                             'transformations'):
            equivariance.compute_equivariance_metrics(
                opts, num_samples=4, batch_size=4, compute_eqt_int=True)
    for name in ('eqt50k_int', 'eqt50k_frac', 'eqr50k'):
        with pytest.raises(ValueError, match='user-specified'):
            metric_main.calc_metric(name, generator=port, device='cpu')


def test_registry_has_every_jax_metric():
    assert metric_main.list_valid_metrics() == jax_main.list_valid_metrics()


def test_calc_metrics_options_match_the_jax_command():
    """Every option of the JAX click command, with its default, under the
    same destination, and --device."""
    from next3d_tpu.cli.calc_metrics import main as jax_cmd
    parser = cli.build_parser()
    sub = parser._subparsers._group_actions[0].choices['calc-metrics']
    got = {a.dest: a.default for a in sub._actions if a.dest != 'help'}
    for param in jax_cmd.params:
        assert param.name in got, param.name
        default = None if param.required else param.default
        assert got[param.name] == default, param.name
    assert set(got) - {p.name for p in jax_cmd.params} == {'device'}
    assert got['device'] == 'cuda'


@pytest.mark.usefixtures('one_thread')
def test_calc_metrics_runs_end_to_end(files, generators, tmp_path,
                                      monkeypatch):
    """``calc-metrics`` on the CPU from a format-1 snapshot of the 128^2
    generator, with a scripted Inception file of seeded weights at
    NEXT3D_INCEPTION_PATH (converted and attested on the CPU) and a small
    KID registered for the test (FID's 2048^2 matrix root alone takes half
    a minute on one CPU thread): the record is printed, appended to
    metric-<name>.jsonl and finite; a missing mesh raises naming its
    option, and an unknown metric raises."""
    port, _, _ = generators
    snap = str(tmp_path / 'snap.pkl')
    save_snapshot(snap, params_G_ema=to_jax_tree(port),
                  config={'G_kwargs': G_KWARGS})
    detector = str(tmp_path / 'inception.pt')
    torch.jit.script(inception.inception_of_params(
        inception.init_params(1))).save(detector)
    monkeypatch.setenv('NEXT3D_INCEPTION_PATH', detector)
    monkeypatch.delenv('NEXT3D_DETECTOR_IMPL', raising=False)

    def kid6(opts):
        from next3d_tpu_torch.metrics.kernel_inception_distance import \
            compute_kid
        return {'kid6': compute_kid(dataclasses.replace(opts, batch_size=3),
                                    max_real=None, num_gen=6, num_subsets=4,
                                    max_subset_size=6)}
    monkeypatch.setitem(metric_main._metric_dict, 'kid6', kid6)
    run_dir = tmp_path / 'run'
    run_dir.mkdir()
    argv = ['calc-metrics', '--network', snap, '--metrics', 'kid6',
            '--data', files['data'], '--topology-path', files['obj'],
            '--run-dir', str(run_dir), '--batch', '4', '--device', 'cpu']
    (record,) = cli.run(argv)
    assert np.isfinite(record['results']['kid6'])
    assert record['results']['kid6'] != 0
    with open(run_dir / 'metric-kid6.jsonl') as f:
        assert json.loads(f.read()) == json.loads(json.dumps(record))
    assert os.path.exists(detector + '.torch_parity.json')
    with pytest.raises(FileNotFoundError, match='--topology-path'):
        cli.run(argv[:8] + [str(tmp_path / 'none.obj')] + argv[9:])
    with pytest.raises(ValueError, match='unknown metric'):
        cli.run(argv[:4] + ['kid6,nope'] + argv[5:])


def test_missing_detector_raises(files):
    """Without a detector or NEXT3D_INCEPTION_PATH the feature loops raise
    the JAX package's RuntimeError."""
    opts = dataclasses.replace(_opts(files, True), detector=None)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv('NEXT3D_INCEPTION_PATH', raising=False)
        mp.delenv('NEXT3D_VGG16_PATH', raising=False)
        with pytest.raises(RuntimeError, match='NEXT3D_INCEPTION_PATH'):
            metric_utils.compute_feature_stats_for_dataset(opts)
        with pytest.raises(RuntimeError, match='NEXT3D_VGG16_PATH'):
            from next3d_tpu_torch.metrics.perceptual_path_length import \
                compute_ppl
            compute_ppl(opts, num_samples=2)
