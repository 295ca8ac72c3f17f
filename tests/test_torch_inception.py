"""The port's Inception-2015 detector (next3d_tpu_torch/metrics/inception.py)
against the JAX package's graph (next3d_tpu/metrics/inception_jax.py) on the
CPU, on the same seeded weights carried across by ``state_dict_of_params``.

The resize to 299^2 is held to ``jax.image.resize(..., 'bilinear')`` at
128^2 (upsampling) and 512^2 (downsampling, where JAX antialiases); the
features and the IS probabilities (softmax of the logits without the output
bias) to JAX's on uint8 inputs of both sizes. The JAX side runs one jitted
program for all of them: its own resize, then ``features`` of the 299^2
image (which skips the resize), returning the features and the logits.
The converter reads a TorchScript file that the test writes from seeded
weights, as the JAX package's converter also does; an attestation or a
conversion that fails raises, and ``NEXT3D_DETECTOR_IMPL=torch`` runs the
TorchScript module itself."""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from next3d_tpu.metrics import inception_jax as jinc
from next3d_tpu_torch.metrics import inception, metric_utils

from torch_parity import n
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)

# resize: float32 bilinear weights in two libraries on values 0-255 (the
# gaps are 5.2e-4 at 128^2 and 5.4e-4 at 512^2); without antialiasing the
# 512^2 gap is 140
RESIZE_TOL = 2e-3
# features of the 94-convolution graph in float32 (oneDNN against XLA) on
# weights with unit-scale activations (features up to about 16-34, gaps of
# 3e-7 of that): relative to the largest feature
FEATURE_REL = 1e-5
# IS probabilities (each row sums to 1; gaps up to 8e-7)
PROBS_TOL = 1e-5


@pytest.fixture(scope='module')
def weights():
    """The port's seeded tree (JAX layout: every leaf away from the
    identity), the port's module on it, and JAX's jitted graph."""
    params = inception.init_params(0)

    @jax.jit
    def jax_graph(p, x):
        x = jax.image.resize(x, x.shape[:2] + (299, 299), 'bilinear')
        feat = jinc.features(p, x)
        logits = jinc.features(p, x, return_logits=True, no_output_bias=True)
        return feat, jax.nn.softmax(logits, axis=-1)
    return params, inception.inception_of_params(params), jax_graph


def _images(size, seed):
    return np.random.RandomState(seed).randint(
        0, 256, (2, 3, size, size)).astype(np.uint8)


@pytest.mark.parametrize('size', [128, 512])
def test_resize_matches_jax(size):
    x = _images(size, 1).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, 299, 299),
                                       'bilinear'))
    got = n(inception.resize_299(torch.from_numpy(x)))
    err = np.abs(got - want).max()
    print(f'{size}^2: max-abs {err:.3g}')
    assert err <= RESIZE_TOL
    plain = n(F.interpolate(torch.from_numpy(x), size=(299, 299),
                            mode='bilinear', align_corners=False))
    gap = np.abs(plain - want).max()
    print(f'{size}^2: without antialiasing max-abs {gap:.3g}')
    # shrinking, JAX antialiases and the reference's detector does not (140
    # levels apart on this batch); growing, the two agree
    assert gap > 100 if size > 299 else gap <= RESIZE_TOL


@pytest.mark.parametrize('size', [128, 512, 299])
def test_features_and_probs_match_jax(weights, size):
    params, model, jax_graph = weights
    imgs = _images(size, 2)
    want_f, want_p = (np.asarray(a) for a in jax_graph(
        params, jnp.asarray(imgs, jnp.float32)))
    with torch.no_grad():
        got_f = n(model(torch.from_numpy(imgs), return_features=True))
        got_p = n(model(torch.from_numpy(imgs), no_output_bias=True))
    scale = np.abs(want_f).max()
    err = np.abs(got_f - want_f).max()
    print(f'{size}^2: features up to {scale:.3g}, max-abs {err:.3g}; '
          f'probs max-abs {np.abs(got_p - want_p).max():.3g}')
    assert got_f.shape == (2, inception.NUM_FEATURES)
    assert scale > 1 and err <= FEATURE_REL * scale
    assert got_p.shape == (2, inception.NUM_LOGITS)
    np.testing.assert_allclose(got_p, want_p, atol=PROBS_TOL, rtol=0)
    np.testing.assert_allclose(got_p.sum(1), 1, atol=1e-5)


def test_bridge_carries_the_jax_init_strictly():
    """A tree of the shapes of JAX's own init_params loads into the module
    under strict=True (every key, every shape), the output layer's weight
    transposed."""
    shapes = jax.eval_shape(jinc.init_params, jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    tree = jax.tree_util.tree_map(
        lambda s: rs.randn(*s.shape).astype(np.float32), shapes)
    model = inception.InceptionV3()
    model.load_state_dict(inception.state_dict_of_params(tree))
    assert set(inception.state_dict_of_params(tree)) == set(
        model.state_dict())
    np.testing.assert_array_equal(n(model.output.weight),
                                  np.asarray(tree['output']['w']).T)


def _save_scripted(module, path):
    torch.jit.script(module).save(path)
    return path


class Shifted(torch.nn.Module):
    """The same weights in a wrapper whose features are off by 1."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, img, return_features: bool = False,
                no_output_bias: bool = False):
        return self.net(img, return_features, no_output_bias) + 1.0


def test_converter_reads_a_scripted_detector(tmp_path):
    """Both packages' converters read the TorchScript file of the port's
    module (the reference detector's calling convention) into the tree it
    was built from."""
    tree = inception.init_params(3)
    path = _save_scripted(inception.inception_of_params(tree),
                          str(tmp_path / 'inception.pt'))
    for got in (inception.convert_torchscript_inception(path),
                jinc.convert_torchscript_inception(path)):
        for blk, name, _ in inception.conv_specs():
            for leaf in ('w', 'beta', 'mean', 'var'):
                np.testing.assert_array_equal(np.asarray(got[blk][name][leaf]),
                                              tree[blk][name][leaf])
        for leaf in ('w', 'b'):
            np.testing.assert_array_equal(np.asarray(got['output'][leaf]),
                                          tree['output'][leaf])
    scripted = torch.jit.load(path)
    imgs = torch.from_numpy(_images(64, 4))
    model = inception.inception_of_params(tree)
    with torch.no_grad():
        for kw in ({'return_features': True}, {'no_output_bias': True}, {}):
            assert torch.equal(scripted(imgs, **kw), model(imgs, **kw))


def test_attestation_records_and_refuses(tmp_path, monkeypatch):
    """A converted detector that agrees with the pickle writes a sidecar
    record that the next attestation reads without running the pickle; one
    that disagrees raises and writes none."""
    tree = inception.init_params(5)
    model = inception.inception_of_params(tree)
    good = _save_scripted(model, str(tmp_path / 'good.pt'))
    rec = inception.attest_parity(good, model, 'cpu')
    assert rec['max_abs_feature_delta'] == 0.0 and rec['device'] == 'cpu'
    with open(good + '.torch_parity.json') as f:
        assert json.load(f) == rec

    def refuse(*args, **kwargs):
        raise AssertionError('the pickle ran despite the record')
    with monkeypatch.context() as mp:
        mp.setattr(inception, 'torchscript_detector', refuse)
        assert inception.attest_parity(good, model, 'cpu') == rec
    bad = _save_scripted(Shifted(model), str(tmp_path / 'bad.pt'))
    with pytest.raises(RuntimeError, match='parity attestation'):
        inception.attest_parity(bad, model, 'cpu')
    assert not os.path.exists(bad + '.torch_parity.json')


def test_detector_failures_raise(tmp_path, monkeypatch):
    """Through get_detector: a pickle that fails the attestation and one
    whose convolutions do not match raise (no fallback); with
    NEXT3D_DETECTOR_IMPL=torch the pickle itself runs, on the device asked
    for; a passing one gives the converted module's features."""
    tree = inception.init_params(6)
    model = inception.inception_of_params(tree)
    opts = metric_utils.MetricOptions(device='cpu')
    imgs = _images(32, 7)
    monkeypatch.delenv('NEXT3D_DETECTOR_IMPL', raising=False)

    bad = _save_scripted(Shifted(model), str(tmp_path / 'bad.pt'))
    monkeypatch.setenv('NEXT3D_INCEPTION_PATH', bad)
    with pytest.raises(RuntimeError, match='parity attestation'):
        metric_utils.get_detector(opts)
    monkeypatch.setenv('NEXT3D_DETECTOR_IMPL', 'torch')
    with torch.no_grad():
        feats = n(model(torch.from_numpy(imgs), return_features=True))
    # the scripted graph may fuse its float32 operations in another order
    np.testing.assert_allclose(metric_utils.get_detector(opts)(imgs),
                               feats + 1, atol=1e-5, rtol=0)
    monkeypatch.delenv('NEXT3D_DETECTOR_IMPL')

    stem = _save_scripted(model.stem, str(tmp_path / 'stem.pt'))
    monkeypatch.setenv('NEXT3D_INCEPTION_PATH', stem)
    with pytest.raises(RuntimeError, match='architecture mismatch'):
        metric_utils.get_detector(opts)

    good = _save_scripted(model, str(tmp_path / 'good.pt'))
    monkeypatch.setenv('NEXT3D_INCEPTION_PATH', good)
    np.testing.assert_array_equal(metric_utils.get_detector(opts)(imgs),
                                  feats)
    probs = inception.make_detector(good, 'cpu', no_output_bias=True)(imgs)
    with torch.no_grad():
        np.testing.assert_array_equal(
            probs, n(model(torch.from_numpy(imgs), no_output_bias=True)))
