"""TF-era pickles in the port (next3d_tpu_torch/utils/legacy.py and
pkl_import.py) against the JAX package (next3d_tpu/utils/legacy.py), on
the synthetic (G, D, Gs) pickle of tests/test_legacy_tf.py (a 16px skip
generator and resnet discriminator of tflib Networks): the conversion is
bit-equal, init_kwargs and every state_dict entry; the port's Generator
and Discriminator on the converted weights match JAX's within 1e-5."""

import numpy as np
import pytest
import torch

import jax

from next3d_tpu.nn import Discriminator as JaxDiscriminator
from next3d_tpu.nn import Generator as JaxGenerator
from next3d_tpu.train.warm_start import \
    copy_matching_params as jax_copy_matching_params
from next3d_tpu.utils import checkpoint as jax_checkpoint
from next3d_tpu.utils import legacy as jax_legacy
from next3d_tpu.utils import pkl_import as jax_pkl_import
from next3d_tpu_torch.nn.discriminator import Discriminator
from next3d_tpu_torch.nn.stylegan2 import Generator
from next3d_tpu_torch.train.warm_start import copy_matching_params
from next3d_tpu_torch.utils import checkpoint, legacy, pkl_import
from next3d_tpu_torch.utils.weights import (load_jax_params,
                                            state_dict_to_params)

from test_legacy_tf import _fake_tflib_network_pickle
from torch_parity import n, t

TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(scope='module')
def tf_pickle(tmp_path_factory):
    root = tmp_path_factory.mktemp('legacy')
    return _fake_tflib_network_pickle(root, np.random.RandomState(0))


def _assert_state_dicts_equal(got, want):
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name])


def test_conversion_is_bit_equal_to_jax(tf_pickle):
    """Each of G, D and G_ema: the same init_kwargs and the same state_dict
    entries, bit for bit, from the port's load_network_pkl as from JAX's;
    the converters alone on the unpickled Networks agree too, and
    load_any_generator gives JAX's params."""
    path, g_state, d_state = tf_pickle
    got = pkl_import.load_network_pkl(path)
    want = jax_pkl_import.load_network_pkl(path)
    assert set(got) == set(want) == {'G', 'D', 'G_ema', 'augment_pipe',
                                     'training_set_kwargs'}
    for key in ('G', 'D', 'G_ema'):
        assert got[key].init_kwargs == want[key].init_kwargs
        _assert_state_dicts_equal(got[key].state_dict(),
                                  want[key].state_dict())

    for convert, jax_convert, state in (
            (legacy.convert_tf_generator, jax_legacy.convert_tf_generator,
             g_state),
            (legacy.convert_tf_discriminator,
             jax_legacy.convert_tf_discriminator, d_state)):
        net, jax_net = legacy.TFNetworkStub(), jax_legacy.TFNetworkStub()
        net.__setstate__(dict(state))
        jax_net.__setstate__(dict(state))
        kwargs, sd = convert(net)
        jax_kwargs, jax_sd = jax_convert(jax_net)
        assert kwargs == jax_kwargs
        _assert_state_dicts_equal(sd, jax_sd)
    assert legacy.is_tf_legacy_data((net, net, net))
    assert not legacy.is_tf_legacy_data((net, net))

    params, kwargs = checkpoint.load_any_generator(path)
    jax_params, jax_kwargs = jax_checkpoint.load_any_generator(path)
    assert kwargs == jax_kwargs
    assert jax.tree_util.tree_structure(params) \
        == jax.tree_util.tree_structure(jax_params)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(jax_params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_converted_networks_match_jax(tf_pickle):
    """The converted G and D, each filled in from its JAX init where the
    TF pickle has no entry (copy_matching_params, as
    tests/test_legacy_tf.py), load strictly into the port's Generator and
    Discriminator, whose outputs on the same inputs are within 1e-5 of
    JAX's; the port's copy_matching_params gives JAX's tree."""
    path, _, _ = tf_pickle
    data = pkl_import.load_network_pkl(path)
    rng = np.random.RandomState(1)

    gk = data['G_ema'].init_kwargs
    kwargs = dict(z_dim=gk['z_dim'], c_dim=gk['c_dim'], w_dim=gk['w_dim'],
                  img_resolution=gk['img_resolution'],
                  img_channels=gk['img_channels'],
                  channel_base=gk['channel_base'],
                  channel_max=gk['channel_max'],
                  mapping_kwargs=dict(
                      num_layers=gk['mapping_kwargs']['num_layers']))
    jg = JaxGenerator(**kwargs)
    init = jax.tree_util.tree_map(np.asarray, jg.init(jax.random.PRNGKey(0)))
    imported = state_dict_to_params(data['G_ema'].state_dict())
    want_tree = jax_copy_matching_params(init, imported)
    tree = copy_matching_params(init, imported)
    assert jax.tree_util.tree_structure(tree) \
        == jax.tree_util.tree_structure(want_tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(want_tree)):
        np.testing.assert_array_equal(a, np.asarray(b))
    G = load_jax_params(Generator(**kwargs), tree)
    z = rng.randn(2, 8).astype(np.float32)
    want = jax.jit(lambda p, z: jg(p, z, None, noise_mode='const',
                                   force_fp32=True))(want_tree, z)
    with torch.no_grad():
        got = G(t(z), None, noise_mode='const')
    assert got.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)

    dk = data['D'].init_kwargs
    d_kwargs = dict(c_dim=0, img_resolution=16, img_channels=3,
                    channel_base=dk['channel_base'],
                    channel_max=dk['channel_max'],
                    epilogue_kwargs=dict(mbstd_group_size=2))
    jd = JaxDiscriminator(**d_kwargs)
    d_tree = jax_copy_matching_params(
        jax.tree_util.tree_map(np.asarray, jd.init(jax.random.PRNGKey(1))),
        state_dict_to_params(data['D'].state_dict()))
    D = load_jax_params(Discriminator(**d_kwargs), jax.tree_util.tree_map(
        np.asarray, d_tree))
    img = rng.randn(2, 3, 16, 16).astype(np.float32)
    with torch.no_grad():
        got = D(t(img), None)
    want = jax.jit(lambda p, x: jd(p, x, None))(d_tree, img)
    np.testing.assert_allclose(n(got), np.asarray(want), **TOL)
