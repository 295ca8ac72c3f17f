"""The port's data parallelism (next3d_tpu_torch/parallel/) on two gloo
ranks on the CPU, each a process of its own (tests/torch_dist_workers.py):

- ``parallel/dist.py``'s functions: each rank's block of a global batch,
  strided local batches, the bucketed mean over tensors of mixed shapes,
  the gather of unequal rows, the broadcast of a module and an Adam state,
  and the replica check, which passes on replicas and raises on every rank
  at a planted mismatch, naming the tensor;
- ``parallel/stats.py``'s collector, fed each step's stats averaged over
  the ranks as the phases average them, against the JAX package's
  collector fed every rank's values;
- the one-process split over devices (``split_over_devices``) on [cpu,
  cpu] against one device: the generator feature loop and the sigma grid;
- the four training phases at the 128^2 parity configuration of
  tests/torch_train_parity.py, global batch 4 on 2 ranks: each phase's
  all-reduced gradient against the mean of the JAX reference's gradients
  on the two halves (``assert_grads_match``; Greg's whole by its norm, as
  tests/test_torch_train_g.py holds it), its loss within 1e-4 relative;
  and after ``run_phases`` with real learning rates, both ranks' G, D and
  G_ema bit-equal. Each JAX phase compiles once for both halves; it runs
  while the ranks train."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from next3d_tpu.nn.discriminator import DualDiscriminator as JaxDual
from next3d_tpu.parallel.stats import StatsCollector as JaxStats
from next3d_tpu.train.loss import LossConfig as JaxLossConfig
from next3d_tpu.train.loss import StyleGAN2Loss as JaxLoss
from next3d_tpu_torch.cli.gen_samples import extract_shape
from next3d_tpu_torch.metrics import metric_utils
from next3d_tpu_torch.models.triplane_next3d import TriPlaneGenerator
from next3d_tpu_torch.nn.discriminator import DualDiscriminator
from next3d_tpu_torch.train.train_step import trainable_mask
from next3d_tpu_torch.utils.synthetic_head import synthetic_head

import torch_dist_workers as workers
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)
from torch_parity import to_jax_tree
from torch_train_parity import (D_KWARGS, G_CFG, LOSS_CFG,
                                assert_grads_match, assert_loss_matches,
                                greg_draws, jax_model, k1_interpret,
                                make_batch, make_generators)


# ------------------------------------------------------ dist's functions
@pytest.fixture(scope='module')
def ranks():
    return workers.run(workers.functions, 2)


def _check_shard(r0, r1):
    full = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    assert torch.equal(r0['shard'], full[:4])
    assert torch.equal(r1['shard'], full[4:])
    assert torch.equal(r1['shard_numpy'], full[4:] * 2)
    assert r0['shard_odd'] == 'a batch of 3 does not split over 2 ranks'


def _check_local(r0, r1):
    full = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    assert torch.equal(r0['local'], full[0::2])
    assert torch.equal(r1['local'], full[1::2])


def _check_mean(r0, r1):
    """Tensor k holds rank + 1 + k on each rank: the mean is 1.5 + k, one
    float32 bucket of 3 + 4 + 1 + 5 values."""
    for r in (r0, r1):
        assert r['mean_bytes'] == 13 * 4
        for k, t in enumerate(r['mean']):
            assert torch.equal(t, torch.full(t.shape, 1.5 + k)), k
        assert 'one dtype' in r['mean_dtypes']


def _check_gather(r0, r1):
    """Rank 0 holds 3 rows, rank 1 two: both get all five in rank order;
    and each rank's generator state, bit for bit."""
    want = torch.cat([torch.arange(12, dtype=torch.float64).reshape(3, 4),
                      torch.arange(8, dtype=torch.float64).reshape(2, 4)
                      + 100])
    states = torch.stack([torch.Generator().manual_seed(r).get_state()
                          for r in (0, 1)])
    for r in (r0, r1):
        assert torch.equal(r['gathered'], want)
        assert torch.equal(r['gathered_states'], states)
    assert r0['split_rows'] == [3, 2]


def _check_broadcast(r0, r1):
    """Each rank built its own module and took its own Adam step; after
    the broadcast both hold rank 0's, buffers and moments included."""
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(3, 4),
                              torch.nn.BatchNorm1d(4))
    opt = torch.optim.Adam(net.parameters())
    net(torch.randn(5, 3)).square().sum().backward()
    opt.step()
    for r in (r0, r1):
        for k, v in net.state_dict().items():
            assert torch.equal(r['net'][k], v), k
        for got, want in zip(r['adam'], opt.state.values()):
            for k in want:
                assert torch.equal(got[k], want[k]), k


def _check_replicas(r0, r1):
    for r in (r0, r1):
        assert r['consistent']
        assert r['planted'] == "replicas differ from rank 0: ['net.0.bias']"


CHECKS = {'shard_batch': _check_shard, 'local_batch': _check_local,
          'all_reduce_mean': _check_mean, 'gather_rows': _check_gather,
          'broadcast_module': _check_broadcast,
          'check_replica_consistency': _check_replicas}


@pytest.mark.parametrize('name', list(CHECKS))
def test_dist_function_on_two_ranks(ranks, name):
    CHECKS[name](*ranks)


def test_stats_across_ranks_match_jax(ranks):
    """Each rank's collector, fed each step's stats averaged over the
    ranks, holds what the JAX collector holds fed each step's pmeaned
    stats (its loop's input), and the mean of the JAX collector fed every
    rank's raw values."""
    every, pmeaned = JaxStats(), JaxStats()
    for step in zip(*(r['stats_raw'] for r in ranks)):
        for name in step[0]:
            values = [s[name] for s in step]
            every.report(name, values)
            pmeaned.report(name, np.float32(np.mean(values)))
    for r in ranks:
        assert r['stats'] == pmeaned.as_dict()
        for name, d in r['stats'].items():
            assert d['mean'] == every.mean(name), name


# ----------------------------------------------------- one process, cards
class _Labels:
    """What the generator feature loop reads of a dataset."""

    def __init__(self, n=5):
        from next3d_tpu_torch.cli.common import camera_label
        mesh, lms = synthetic_head()
        rs = np.random.RandomState(2)
        self.v = (np.concatenate([mesh.verts, lms])[None] + rs.randn(
            n, 5091, 3) * 0.002).astype(np.float32)
        self.c = np.concatenate([camera_label(0.1 * i, 0.0)
                                 for i in range(n)])

    def __len__(self):
        return len(self.c)

    def get_label(self, i):
        return self.c[i]

    def get_verts(self, i):
        return self.v[i]


@pytest.fixture(scope='module')
def small_G():
    mesh, _ = synthetic_head()
    return TriPlaneGenerator(topology_path=mesh,
                             generator=torch.Generator().manual_seed(3),
                             **G_CFG).eval()


class _StubG(torch.nn.Module):
    """A generator of the feature loop's interface whose image rows are
    elementwise functions of their own inputs (so any split gives the same
    bits), with a parameter that its copies must carry."""
    z_dim = 8

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.randn(
            3, 16, 16, generator=torch.Generator().manual_seed(4)))

    def mapping(self, z, c, truncation_psi=1):
        return z[:, None] * truncation_psi

    def synthesis(self, ws, c, v, noise_mode='const'):
        shift = c[:, :3, None, None] * 0.1 + v[:, :3, :1, None] * 0.01
        return {'image': torch.tanh(ws[:, 0, :3, None, None] * self.w
                                    + shift)}


def test_feature_loop_split_over_devices():
    """calc-metrics' generator loop with its batches of 3 split over [cpu,
    cpu] (rows 2 + 1, a copy of the generator on the second) gives the
    features of one device, in order, bit for bit."""
    opts = metric_utils.MetricOptions(
        generator=_StubG(), dataset=_Labels(), detector=workers.stub_detector,
        batch_size=3, seed=1, device='cpu')
    one = metric_utils.compute_feature_stats_for_generator(
        opts, max_items=6, capture_all=True)
    two = metric_utils.compute_feature_stats_for_generator(
        dataclasses.replace(opts, devices=[torch.device('cpu')] * 2),
        max_items=6, capture_all=True)
    assert one.get_all().shape == (6, 6)
    assert np.array_equal(one.get_all(), two.get_all())
    assert np.array_equal(one.raw_cov, two.raw_cov)


def test_sigma_grid_split_over_devices(small_G, tmp_path):
    """gen-samples' sigma grid, 32^3 points in chunks of 3000 a device,
    each chunk split over [cpu, cpu], writes the .mrc of one device bit
    for bit (each point's sigma depends on that point alone)."""
    mesh, lms = synthetic_head()
    v = torch.from_numpy(np.concatenate([mesh.verts, lms])[None]
                         .astype(np.float32))
    from next3d_tpu_torch.cli.common import camera_label
    with torch.no_grad():
        ws = small_G.mapping(torch.randn(1, small_G.z_dim),
                             torch.from_numpy(camera_label(0, 0)))
        planes, _ = small_G.build_planes(ws, v, noise_mode='const')
        paths = [str(tmp_path / f'{n}.mrc') for n in (1, 2)]
        for n, path in zip((1, 2), paths):
            extract_shape(small_G, planes, 32, 3000, path,
                          [torch.device('cpu')] * n)
    data = [open(p, 'rb').read() for p in paths]
    assert len(data[0]) > 32 ** 3 * 4 and data[0] == data[1]


# ----------------------------------------------------------------- phases
def _global_batch():
    """Global batch 4: tests/torch_train_parity.py's batch of 2, then 2
    more rows (other latents, the expressions and cameras reversed, other
    real images)."""
    batch, real = make_batch()
    rs = np.random.RandomState(9)
    more = dict(gen_z=rs.randn(2, 64).astype(np.float32),
                gen_c=batch['gen_c'][::-1], gen_v=batch['gen_v'][::-1],
                real_c=batch['real_c'][::-1])
    glob = {k: np.ascontiguousarray(np.concatenate([batch[k], more[k]]))
            for k in batch}
    real = np.concatenate([real, np.tanh(rs.randn(2, 3, 128, 128))
                           .astype(np.float32)])
    return glob, real


def _jax_reference(jg, pg, jd, pd, batch, real, draws, g_gain, d_gain):
    """The mean over the two halves of each phase's JAX loss and gradient
    (next3d_tpu/train/loss.py's formulas, as the parity tests write
    them); each phase one jitted function, called on both halves."""
    reg, gamma = LOSS_CFG['density_reg'], LOSS_CFG['r1_gamma']

    def gmain(p, z, c, v):
        out = jg.synthesis(p, jg.mapping(p, z, c), c, v,
                           neural_rendering_resolution=64,
                           noise_mode='const', rng=None)
        images = {k: out[k] for k in ('image', 'image_raw')}
        return jnp.mean(jax.nn.softplus(-jd(pd, out, c, rng=None))), images

    def greg(p, z, c, v, a, b, d):
        sigma = jg.sample_mixed(p, jnp.concatenate([a, b], axis=1), d,
                                jg.mapping(p, z, c), v, noise_mode='const',
                                rng=None)['sigma']
        half = sigma.shape[1] // 2
        return jnp.mean(jnp.abs(sigma[:, :half] - sigma[:, half:])) * reg

    def dmain(p, fake, c, real, real_c):
        return jnp.mean(jax.nn.softplus(jd(p, fake, c))) + \
            jnp.mean(jax.nn.softplus(-jd(p, real, real_c)))

    def dreg(p, real, real_c):
        def logit_sum(image, raw):
            return jnp.sum(jd(p, {'image': image, 'image_raw': raw}, real_c))
        g_img, g_raw = jax.grad(logit_sum, argnums=(0, 1))(
            real['image'], real['image_raw'])
        r1 = jnp.sum(jnp.square(g_img), axis=(1, 2, 3)) + \
            jnp.sum(jnp.square(g_raw), axis=(1, 2, 3))
        return jnp.mean(r1) * (gamma / 2)

    fns = {'Gmain': jax.jit(jax.value_and_grad(gmain, has_aux=True)),
           'Greg': jax.jit(jax.value_and_grad(greg)),
           'Dmain': jax.jit(jax.value_and_grad(dmain)),
           'Dreg': jax.jit(jax.value_and_grad(dreg))}
    real_all = jax.tree_util.tree_map(np.asarray, JaxLoss(
        None, jd, JaxLossConfig(**LOSS_CFG)).prepare_real(
            jnp.asarray(real), 0.0, 64))
    out = {}
    for h in (slice(0, 2), slice(2, 4)):
        z, c, v, real_c = (jnp.asarray(batch[k][h]) for k in
                           ('gen_z', 'gen_c', 'gen_v', 'real_c'))
        real_h = {k: x[h] for k, x in real_all.items()}
        (loss, images), grad = fns['Gmain'](pg, z, c, v)
        res = {'Gmain': (loss, grad, 1.0),
               'Greg': (*fns['Greg'](pg, z, c, v,
                                     *(jnp.asarray(x[h]) for x in draws)),
                        g_gain),
               'Dmain': (*fns['Dmain'](pd, images, c, real_h, real_c), 1.0),
               'Dreg': (*fns['Dreg'](pd, real_h, real_c), d_gain)}
        for phase, (loss, grad, gain) in res.items():
            grad = jax.tree_util.tree_map(
                lambda g, gain=gain: np.asarray(g) * gain / 2, grad)
            if phase in out:
                grad = jax.tree_util.tree_map(np.add, out[phase][1], grad)
                loss = out[phase][0] + float(loss) / 2
            else:
                loss = float(loss) / 2
            out[phase] = (loss, grad)
    return out


@pytest.fixture(scope='module')
def phases(tmp_path_factory):
    """The ranks' phases (started first) and the JAX reference (computed
    while they run)."""
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_model, 'rasterize_uv_with_alpha', k1_interpret)
    try:
        jg, pg, G = make_generators()
        # D of the port's seeded init (JAX's eager init takes 10 s here)
        D = DualDiscriminator(generator=torch.Generator().manual_seed(1),
                              **D_KWARGS)
        jd, pd = JaxDual(**D_KWARGS), to_jax_tree(D)
        batch, real = _global_batch()
        draws = [np.concatenate(x) for x in zip(greg_draws(seed=11),
                                                greg_draws(seed=12))]
        spec = dict(G_kwargs=dict(G_CFG, topology_path=synthetic_head()[0]),
                    G=G.state_dict(), D_kwargs=D_KWARGS, D=D.state_dict(),
                    loss_cfg=LOSS_CFG, batch=batch, real=real,
                    greg_draws=draws, g_gain=4.0, d_gain=16.0, glr=0.0025,
                    dlr=0.002)
        path = tmp_path_factory.mktemp('parity') / 'spec.pt'
        torch.save(spec, path)
        handle = workers.start(workers.parity, 2, str(path))
        try:
            want = _jax_reference(jg, pg, jd, pd, batch, real, draws,
                                  spec['g_gain'], spec['d_gain'])
        finally:
            got = workers.finish(handle)
        yield got, want, trainable_mask(G), trainable_mask(D), \
            workers.digest(G, D, G)
    finally:
        patch.undo()


PHASES = {'Gmain': ('G', 'Loss/G/loss', True),
          'Greg': ('G', 'Loss/G/reg', False),
          'Dmain': ('D', 'Loss/D/loss', True),
          'Dreg': ('D', 'Loss/D/reg', True)}


@pytest.mark.parametrize('phase', list(PHASES))
def test_phase_gradient_is_the_mean_over_halves(phases, phase):
    """The gradient Adam received on rank 0 (all-reduced over the two
    ranks, then scrubbed) against the mean of JAX's gradients on the two
    halves, and the phase's loss stat, equal on both ranks, against the
    mean of JAX's losses."""
    got, want, mask_G, mask_D, _ = phases
    net, stat, per_tensor = PHASES[phase]
    grads = got[0]['grads'][list(PHASES).index(phase)]
    want_loss, want_grad = want[phase]
    assert got[0]['stats'][stat] == got[1]['stats'][stat]
    assert_loss_matches(torch.tensor(got[0]['stats'][stat]), want_loss,
                        f'{phase} loss, 2 ranks')
    assert_grads_match(grads, want_grad, mask_G if net == 'G' else mask_D,
                       f'{phase}, 2 ranks', per_tensor=per_tensor)


def test_replicas_bit_equal_after_run_phases(phases):
    """After the four phases and G_ema's update with the real learning
    rates and each rank's own random Greg points, both ranks hold the same
    G, D and G_ema bit for bit, and they moved; every stat is the same on
    both ranks."""
    got, _, _, _, initial = phases
    assert got[0]['after'] == got[1]['after']
    assert got[0]['after'] != initial
    assert got[0]['stats'] == got[1]['stats']
