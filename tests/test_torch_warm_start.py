"""The EG3D warm start of the port's ``train --resume``
(next3d_tpu_torch/train/training_loop.py load_resume, train/warm_start.py)
against the JAX loop's reference-.pkl branch (next3d_tpu/train/
training_loop.py:106-120: JAX's load_network_pkl, eg3d_to_next3d and
copy_matching_params), on an EG3D-format pickle written in the reference's
wire format (G_ema with only ``backbone``, ``superresolution`` and
``decoder``, and a D) from networks of the train command's tiny CPU
configuration on the synthetic head: the warm-started G, G_ema and D equal
JAX's trees leaf for leaf from the same init through the weight bridge;
then one tick of ``train --resume eg3d.pkl``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from next3d_tpu.train.warm_start import copy_matching_params as jax_copy
from next3d_tpu.train.warm_start import eg3d_to_next3d as jax_eg3d_to_next3d
from next3d_tpu.utils.pkl_import import load_network_pkl as jax_load
from next3d_tpu.utils.pkl_import import \
    state_dict_to_params as jax_state_dict_to_params
from next3d_tpu_torch.cli import main as cli
from next3d_tpu_torch.cli import train as port_train
from next3d_tpu_torch.train.training_loop import load_resume
from next3d_tpu_torch.train.warm_start import (copy_matching_params,
                                               eg3d_to_next3d)
from next3d_tpu_torch.utils.checkpoint_cases import write_network_pkl
from next3d_tpu_torch.utils.weights import state_dict_to_params

from test_torch_train_cli import _argv, _opts, files  # noqa: F401
from torch_parity import one_thread  # noqa: F401 (a fixture)
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)


def _tree(module):
    return state_dict_to_params(module.state_dict())


def _assert_trees_equal(got, want):
    assert jax.tree_util.tree_structure(got) \
        == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope='module')
def eg3d_pkl(files):  # noqa: F811 (the fixture of test_torch_train_cli)
    """An EG3D snapshot: the backbone, super-resolution and decoder of a
    generator of another seed, and its D, with torch-tensor leaves."""
    opts = _opts(_argv(files, 'donor', 0.001, '--seed', '7'))
    opts.pop('device')
    G, D = port_train.build_training(opts, 'cpu')[:2]
    donor = _tree(G)
    eg3d = {k: donor[k] for k in ('backbone', 'superresolution', 'decoder')}
    path = str(files[0] / 'eg3d.pkl')
    write_network_pkl(path, {'G_ema': eg3d, 'G': eg3d, 'D': _tree(D)},
                      init_kwargs={'G_ema': {'z_dim': 512, 'c_dim': 25}})
    return path, donor, _tree(D)


def test_warm_start_matches_jax(files, eg3d_pkl):  # noqa: F811
    """load_resume of the EG3D pickle into freshly built networks: G and
    G_ema equal JAX's copy_matching_params(init, eg3d_to_next3d(G_ema)),
    D JAX's copy_matching_params(init, D), leaf for leaf; the seeded
    texture, mouth and blending backbones hold the donor backbone's leaves
    wherever a name and a shape match, the other leaves their init; the
    Adam states stay empty and the loop state fresh. A network pickle with
    no G_ema and no D raises."""
    path, donor, donor_D = eg3d_pkl
    opts = _opts(_argv(files, 'warm', 0.001))
    opts.pop('device')
    G, D, G_ema, _, step, _, _ = port_train.build_training(opts, 'cpu')
    init_G, init_D = _tree(G), _tree(D)
    assert load_resume(path, G, D, G_ema, step) == {}

    snap = jax_load(path)
    imported = jax_eg3d_to_next3d(jax_state_dict_to_params(
        snap['G_ema'].state_dict()))
    want_G = jax_copy(jax.tree_util.tree_map(jnp.asarray, init_G), imported)
    want_D = jax_copy(jax.tree_util.tree_map(jnp.asarray, init_D),
                      jax_state_dict_to_params(snap['D'].state_dict()))
    _assert_trees_equal(_tree(G), want_G)
    _assert_trees_equal(_tree(G_ema), want_G)
    _assert_trees_equal(_tree(D), want_D)
    _assert_trees_equal(_tree(D), donor_D)
    # the port's functions alone give the same trees
    _assert_trees_equal(copy_matching_params(init_G, eg3d_to_next3d(
        state_dict_to_params(snap['G_ema'].state_dict()))), want_G)

    got = _tree(G)
    seeded = kept = 0
    for name in ('texture_backbone', 'mouth_backbone', 'neural_blending',
                 'backbone'):
        flat_got = jax.tree_util.tree_flatten_with_path(got[name])[0]
        for path_, leaf in flat_got:
            node = donor['backbone']
            for key in path_:
                node = node.get(key.key) if isinstance(node, dict) else None
            init = init_G[name]
            for key in path_:
                init = init[key.key]
            if node is not None and np.shape(node) == np.shape(leaf):
                np.testing.assert_array_equal(leaf, node)
                seeded += name != 'backbone'
            else:
                np.testing.assert_array_equal(leaf, init)
                kept += 1
    assert seeded > 0 and kept > 0
    for name in ('superresolution', 'decoder'):
        _assert_trees_equal(got[name], donor[name])
    for key in ('orth_scale', 'orth_shift'):
        np.testing.assert_array_equal(got[key], init_G[key])
    assert not step.opt_G.state and not step.opt_D.state

    # a network pickle with neither G_ema nor D is refused, not ignored
    empty = str(files[0] / 'no_networks.pkl')
    write_network_pkl(empty, {'G_ema': None, 'D': None})
    with pytest.raises(ValueError, match='neither'):
        load_resume(empty, G, D, G_ema, step)


@pytest.mark.usefixtures('one_thread')
def test_train_resume_from_eg3d_pkl_runs(files, eg3d_pkl):  # noqa: F811
    """``train --resume eg3d.pkl`` runs one tick on the CPU from cur_nimg
    0 with finite stats."""
    run = cli.run(_argv(files, 'warm_run', 0.001, '--resume', eg3d_pkl[0]))
    assert run['cur_nimg'] == 1 and [r['tick'] for r in run['ticks']] == [0]
    bad = [k for k, x in run['ticks'][0].items()
           if isinstance(x, float) and not np.isfinite(x)]
    assert not bad, bad
    assert torch.isfinite(run['G_ema'].orth_scale).all()
