"""The port's resume from the JAX package's training snapshots
(next3d_tpu_torch/utils/checkpoint.py load_optimizer_state,
train/training_loop.py load_resume), on the train command's tiny CPU
configuration: the optax adam state of the JAX package's make_optimizer,
saved by its save_snapshot after two updates, carried into torch Adam,
whose next step equals optax's third within 1e-6 relative; the snapshot
read where optax cannot be imported; a JAX loop's snapshot, its structure
from JAX's own TrainStep.init_state, resumed for one batch with the JAX
loop's fallbacks; and a snapshot holding only params_G_ema."""

import functools
import os
import subprocess
import sys
import types

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from next3d_tpu.train.train_step import TrainStep as JaxTrainStep
from next3d_tpu.train.train_step import make_optimizer as jax_make_optimizer
from next3d_tpu.utils import checkpoint as jax_checkpoint
from next3d_tpu_torch.cli import main as cli
from next3d_tpu_torch.cli import train as port_train
from next3d_tpu_torch.train.train_step import (make_optimizer,
                                               trainable_mask,
                                               trainable_parameters)
from next3d_tpu_torch.train.training_loop import load_resume
from next3d_tpu_torch.utils import checkpoint
from next3d_tpu_torch.utils.weights import (load_jax_params,
                                            params_to_state_dict,
                                            state_dict_to_params)

from test_torch_train_cli import _argv, _opts, files  # noqa: F401
from torch_parity import one_thread  # noqa: F401 (a fixture)
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)

LR, BETAS, EPS = 0.0025, (0.0, 0.99), 1e-8


def _build(files, seed=0):  # noqa: F811
    opts = _opts(_argv(files, 'unused', 0.001, '--seed', str(seed)))
    opts.pop('device')
    return port_train.build_training(opts, 'cpu')


def _tree(module):
    return state_dict_to_params(module.state_dict())


def _grads(module, rng):
    """Random gradients for the trainable leaves, zeros for the others, as
    the JAX package's TrainStep masks them."""
    mask = trainable_mask(module)
    return state_dict_to_params({
        k: (np.asarray(rng.randn(*v.shape), np.float32) if mask[k]
            else np.zeros(v.shape, np.float32))
        for k, v in module.state_dict().items()})


def test_port_adam_continues_optax(files, tmp_path):  # noqa: F811
    """optax.adam of the JAX package's make_optimizer (G's lazy
    regularization scaling) over the tree of G's texture backbone (a
    StyleGAN2 generator: trained weights, noise strengths that start at 0,
    the w_avg and noise buffers that are not trained) takes two updates on
    fixed
    gradients and is saved by the JAX save_snapshot; the port's Adam loads
    it (step, exp_avg, exp_avg_sq equal count, mu, nu) and takes the third
    step on the same gradients: every parameter within 1e-6 of optax's
    third step taken in float64 from the saved state, relative to the
    larger of the parameter and the step (a parameter that starts at 0, as
    a noise strength does, is as small as its steps). A state of another
    structure raises."""
    G = _build(files)[0].texture_backbone
    rng = np.random.RandomState(0)
    grads = [_grads(G, rng) for _ in range(3)]
    opt = jax_make_optimizer(LR, *BETAS, EPS, reg_interval=4)
    params = jax.tree_util.tree_map(jnp.asarray, _tree(G))
    state = opt.init(params)

    @jax.jit
    def update(g, state, params):
        updates, state = opt.update(g, state, params)
        return optax.apply_updates(params, updates), state

    for g in grads[:2]:
        params, state = update(g, state, params)
    path = str(tmp_path / 'jax.pkl')
    jax_checkpoint.save_snapshot(path, params_G=params, opt_state_G=state,
                                 cur_nimg=2, rng_key=jax.random.PRNGKey(0),
                                 extra={'ada_p': 0.0})
    # optax's third step in float64 from the saved float32 state: its own
    # float32 step rounds 1 - b2 ** count in float32, which at count 3
    # moves a step by up to 2e-6 of itself
    with jax.enable_x64(True):
        as64 = functools.partial(jax.tree_util.tree_map,
                                 lambda x: jnp.asarray(x, jnp.float64))
        state64 = (state[0]._replace(mu=as64(state[0].mu),
                                     nu=as64(state[0].nu)), state[1])
        want = params_to_state_dict(jax.tree_util.tree_map(
            np.asarray, update(as64(grads[2]), state64, as64(params))[0]))

    snap = checkpoint.load_snapshot(path)
    assert type(snap['opt_state_G'][0]).__name__ == 'ScaleByAdamState'
    assert isinstance(snap['opt_state_G'][0], checkpoint.OptaxState)
    load_jax_params(G, snap['params_G'])
    adam = make_optimizer(trainable_parameters(G), LR, *BETAS, EPS,
                          reg_interval=4)
    checkpoint.load_optimizer_state(adam, snap['opt_state_G'],
                                    dict(G.named_parameters()))
    named = {k: p for k, p in G.named_parameters() if p.requires_grad}
    assert len(named) == len(adam.param_groups[0]['params'])
    mu = params_to_state_dict(state[0].mu)
    nu = params_to_state_dict(state[0].nu)
    for name, p in named.items():
        s = adam.state[p]
        assert float(s['step']) == 2.0
        np.testing.assert_array_equal(s['exp_avg'].numpy(), mu[name])
        np.testing.assert_array_equal(s['exp_avg_sq'].numpy(), nu[name])
    g3 = params_to_state_dict(grads[2])
    for name, p in named.items():
        p.grad = torch.from_numpy(g3[name])
    before = params_to_state_dict(params)
    adam.step()
    for name, value in G.state_dict().items():
        w = np.asarray(want[name], np.float64)
        step_size = np.abs(w - np.asarray(before[name], np.float64)).max()
        err = np.abs(value.numpy() - w).max()
        assert err <= 1e-6 * max(np.abs(w).max(), step_size), (name, err)

    for other in ((state[0],), {'count': 0, 'mu': {}, 'nu': {}},
                  (state[0]._replace(mu={}), state[1])):
        with pytest.raises(ValueError, match='optax'):
            checkpoint.load_optimizer_state(adam, other,
                                            dict(G.named_parameters()))


def test_jax_snapshot_loads_without_optax(files, tmp_path):  # noqa: F811
    """A snapshot with optax states, read in a process where ``import
    optax`` and ``import jax`` fail: its Adam moments load into torch
    Adam."""
    opt = jax_make_optimizer(LR, *BETAS, EPS)
    tree = {'a': {'weight': jnp.ones((2, 3))}, 'b': jnp.arange(4.0)}
    state = opt.init(tree)
    updates, state = opt.update(jax.tree_util.tree_map(jnp.ones_like, tree),
                                state, tree)
    path = str(tmp_path / 'jax.pkl')
    jax_checkpoint.save_snapshot(path, params_G=tree, opt_state_G=state)
    code = (
        "import sys\n"
        "sys.modules['optax'] = None\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "from next3d_tpu_torch.utils import checkpoint\n"
        "snap = checkpoint.load_snapshot(sys.argv[1])\n"
        "named = {'a.weight': torch.nn.Parameter(torch.zeros(2, 3)),\n"
        "         'b': torch.nn.Parameter(torch.zeros(4))}\n"
        "adam = torch.optim.Adam(named.values())\n"
        "checkpoint.load_optimizer_state(adam, snap['opt_state_G'], named)\n"
        "s = adam.state[named['b']]\n"
        "assert float(s['step']) == 1 and s['exp_avg_sq'].shape == (4,)\n"
        "assert np.allclose(s['exp_avg_sq'].numpy(), 0.01)\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in\n"
        "            ('optax', 'jax') and sys.modules[m] is not None]\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, '-c', code, path], check=True,
                   timeout=120, cwd=root)


@pytest.mark.usefixtures('one_thread')
def test_jax_loop_snapshot_resumes(files, tmp_path):  # noqa: F811
    """A snapshot as the JAX loop writes one: the trees of networks of
    another seed, optax states whose structure is JAX's TrainStep
    .init_state's (after one update on random gradients), cur_nimg,
    ``extra`` with only ada_p, a JAX key as rng_key. load_resume loads the
    trees, the moments of the trained leaves and cur_nimg and ada_p, and
    leaves the generator, the sampler, the batch index and the tick to the
    seed; then ``train --resume`` runs one batch from it."""
    G, D, G_ema = _build(files, seed=5)[:3]
    trees = {k: jax.tree_util.tree_map(jnp.asarray, _tree(m))
             for k, m in (('G', G), ('D', D))}
    loss = types.SimpleNamespace(
        G=types.SimpleNamespace(init=lambda key: trees['G']),
        D=types.SimpleNamespace(init=lambda key: trees['D'],
                                frozen_paths=D.frozen_paths))
    jstep = JaxTrainStep(loss, jax_make_optimizer(LR, *BETAS, EPS, 4),
                         jax_make_optimizer(0.002, *BETAS, EPS, 16))
    state = jstep.init_state(jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    opt_states = {}
    for name, module, opt in (('G', G, jstep.opt_G), ('D', D, jstep.opt_D)):
        _, opt_states[name] = jax.jit(opt.update)(
            _grads(module, rng), getattr(state, f'opt_state_{name}'),
            trees[name])
    path = str(tmp_path / 'network-snapshot-000004.pkl')
    jax_checkpoint.save_snapshot(
        path, params_G=trees['G'], params_D=trees['D'],
        params_G_ema=trees['G'], opt_state_G=opt_states['G'],
        opt_state_D=opt_states['D'], cur_nimg=4,
        rng_key=jax.random.PRNGKey(3), extra={'ada_p': 0.125})

    G2, D2, G_ema2, _, step, _, _ = _build(files)
    resumed = load_resume(path, G2, D2, G_ema2, step)
    assert resumed == {'cur_nimg': 4, 'ada_p': 0.125}
    for got, want in ((G2, G), (G_ema2, G), (D2, D)):
        for k, v in want.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), k
    for opt, module, name in ((step.opt_G, G2, 'G'), (step.opt_D, D2, 'D')):
        mu = params_to_state_dict(opt_states[name][0].mu)
        for pname, p in module.named_parameters():
            if p in opt.state:
                np.testing.assert_array_equal(
                    opt.state[p]['exp_avg'].numpy(), mu[pname])
                assert float(opt.state[p]['step']) == 1.0
        assert len(opt.state) == sum(len(g['params'])
                                     for g in opt.param_groups)

    run = cli.run(_argv(files, 'from_jax', 0.005, '--resume', path))
    assert run['cur_nimg'] == 5 and [r['tick'] for r in run['ticks']] == [0]
    assert run['ada_p'] == 0.125


def test_g_ema_only_snapshot_resumes(files, tmp_path):  # noqa: F811
    """A snapshot with only params_G_ema (as chip_smoke.py's phase 12 and
    the inference commands use one): G_ema takes it, G and D keep their
    init, the optimizers stay fresh, cur_nimg 0 (the loop then runs from
    there as from any resume: ``test_jax_loop_snapshot_resumes``)."""
    donor = _build(files, seed=9)[0]
    path = str(tmp_path / 'g_ema.pkl')
    checkpoint.save_snapshot(path, params_G_ema=_tree(donor))
    G, D, G_ema, _, step, _, _ = _build(files)
    init = {k: _tree(m) for k, m in (('G', G), ('D', D))}
    assert load_resume(path, G, D, G_ema, step) == {'cur_nimg': 0}
    for k, v in donor.state_dict().items():
        assert torch.equal(G_ema.state_dict()[k], v), k
    for name, module in (('G', G), ('D', D)):
        flat = params_to_state_dict(init[name])
        for k, v in module.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), flat[k])
    assert not step.opt_G.state and not step.opt_D.state
