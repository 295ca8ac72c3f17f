"""The port's StyleGAN3 family against the JAX package on the CPU:
``ops/filtered_lrelu.py``, ``nn/stylegan3.py`` (the filter design, the
Fourier-feature input, the generator and its gradient) and the equivariance
metrics end to end on the port's SG3Generator.

Parameters come from the port's seeded init and reach JAX through the
weight bridge (``to_jax_tree``), with ``w_avg``, ``magnitude_ema`` and the
input's affine made non-trivial so that truncation, the input gain and the
per-sample rotation take part. The JAX side runs under ``jax.jit``, one
compile a configuration. Tolerance: float32 outputs within
1e-5 * (1 + scale), as in tests/test_torch_nn.py; gradients within 1e-4
relative L2 a tensor; the bf16 forward (``force_fp32=False``) within 2^-8
(bf16's roundoff) times 2 of the output's scale; PSNRs within 0.01 dB."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from next3d_tpu.metrics import equivariance as jax_eq
from next3d_tpu.metrics import metric_utils as jax_utils
from next3d_tpu.nn import stylegan3 as jsg3
from next3d_tpu.ops.filtered_lrelu import filtered_lrelu as jax_flrelu
from next3d_tpu_torch.metrics import equivariance, metric_main, metric_utils
from next3d_tpu_torch.nn import stylegan3 as tsg3
from next3d_tpu_torch.ops.filtered_lrelu import filtered_lrelu
from next3d_tpu_torch.ops.upfirdn2d import setup_filter
from next3d_tpu_torch.utils.weights import load_jax_params

from torch_parity import n, t, to_jax_tree
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)

BF16_EPS = 2.0 ** -8


def _close(got, want, rel=1e-5):
    got, want = n(got), n(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * (1 + scale))


# ------------------------------------------------------------ filtered_lrelu
def _sg3_padding(in_size, out_size, up, down, up_taps, down_taps):
    """The padding an SG3 layer computes for its filtered lrelu
    (next3d_tpu/nn/stylegan3.py SG3SynthesisLayer), ``in_size`` the
    modulated convolution's output."""
    total = (out_size - 1) * down + 1 - in_size * up + up_taps + down_taps - 2
    lo = (total + up) // 2
    return [lo, total - lo, lo, total - lo]


# (up, down) -> input and output sizes at which the layer's padding is
# negative
FLRELU_SIZES = {(1, 1): (18, 6), (2, 1): (18, 12), (1, 2): (40, 10),
                (2, 2): (18, 6)}


@pytest.mark.parametrize('clamp', [None, 0.5])
@pytest.mark.parametrize('filters', ['separable', 'radial'])
@pytest.mark.parametrize('up,down', list(FLRELU_SIZES))
def test_filtered_lrelu_matches_jax(up, down, filters, clamp):
    """Bias, up-FIR (a Kaiser filter of 6 taps a factor: a 2-D outer
    product at 6 taps, separable at 12), lrelu with gain and clamp,
    down-FIR (Kaiser, or a radial jinc filter), at SG3's negative
    paddings; the output size as the layer's formula says."""
    rs = np.random.RandomState(up * 10 + down)
    size, out = FLRELU_SIZES[(up, down)]
    x = (rs.randn(2, 4, size, size) * 2).astype(np.float32)
    b = rs.randn(4).astype(np.float32)
    up_taps, down_taps = 6 * up, 6 * down
    fu = setup_filter(tsg3.design_lowpass_filter(up_taps, 3, 2, 8 * up),
                      normalize=False)
    fd = setup_filter(tsg3.design_lowpass_filter(
        down_taps, 3, 2, 8 * up, radial=filters == 'radial'),
        normalize=False)
    assert fd.ndim == (2 if filters == 'radial' or down_taps < 8 else 1)
    padding = _sg3_padding(size, out, up, down, up_taps, down_taps)
    assert min(padding) < 0
    kw = dict(up=up, down=down, padding=padding, clamp=clamp)
    got = filtered_lrelu(t(x), t(fu), t(fd), t(b), **kw)
    want = jax.jit(functools.partial(jax_flrelu, **kw))(x, fu, fd, b)
    assert got.shape == (2, 4, out, out)
    _close(got, want)
    if clamp is not None:
        # the clamp bites: the unclamped output differs
        free = filtered_lrelu(t(x), t(fu), t(fd), t(b), up=up, down=down,
                              padding=padding)
        assert float((free - got).abs().max()) > 0.1


@pytest.mark.parametrize('numtaps,radial', [(12, False), (7, False),
                                            (12, True), (7, True)])
def test_design_lowpass_filter_matches_jax(numtaps, radial):
    """The port's copy of the Kaiser and jinc designs gives JAX's taps bit
    for bit (an odd jinc filter has the centre tap)."""
    got = tsg3.design_lowpass_filter(numtaps, 5.0, 3.5, 32, radial=radial)
    want = jsg3.design_lowpass_filter(numtaps, 5.0, 3.5, 32, radial=radial)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert tsg3.design_lowpass_filter(1, 5.0, 3.5, 32) is None


# --------------------------------------------------------- SynthesisInput
def _rotation_translation():
    a = 0.4
    return np.array([[np.cos(a), np.sin(a), 0.1],
                     [-np.sin(a), np.cos(a), -0.07],
                     [0, 0, 1]], np.float32)


@pytest.mark.parametrize('transform', ['identity', 'rotation_translation'])
def test_synthesis_input_matches_jax(transform):
    """The Fourier features with a non-trivial affine of w (so each sample
    rotates and shifts), under the identity user transform and a rotation
    plus translation."""
    rs = np.random.RandomState(3)
    kw = dict(w_dim=16, channels=12, size=20, sampling_rate=16,
              bandwidth=2.0)
    port = tsg3.SynthesisInput(generator=torch.Generator().manual_seed(1),
                               **kw)
    tree = to_jax_tree(port)
    tree['affine']['weight'] = rs.randn(4, 16).astype(np.float32)
    if transform != 'identity':
        tree['transform'] = _rotation_translation()
    load_jax_params(port, tree)
    w = rs.randn(3, 16).astype(np.float32)
    with torch.no_grad():
        got = port(t(w))
    want = jax.jit(jsg3.SynthesisInput(**kw).__call__)(tree, w)
    assert got.shape == (3, 12, 20, 20)
    _close(got, want)


# ----------------------------------------------------------- the generator
# small 32^2 networks: StyleGAN3-T (3x3 convs, separable filters) and R
# (1x1 convs, radial down filters); 6 layers, 2 critically sampled
SG3_BASE = dict(z_dim=16, c_dim=4, w_dim=16, img_resolution=32,
                img_channels=3, channel_base=256, channel_max=16,
                num_layers=6, margin_size=4)
SG3_CONFIGS = {'T': dict(SG3_BASE),
               'R': dict(SG3_BASE, conv_kernel=1, use_radial_filters=True)}


def _liven(tree, rs):
    """Non-trivial w_avg, magnitude_ema and input affine, in place."""
    tree['mapping']['w_avg'] = rs.randn(16).astype(np.float32)
    for k, v in tree['synthesis'].items():
        if 'magnitude_ema' in v:
            v['magnitude_ema'] = np.float32(rs.uniform(0.5, 2.0))
    tree['synthesis']['input']['affine']['weight'] = \
        (rs.randn(4, 16) * 0.3).astype(np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def sg3_pair(name):
    """(JAX generator, tree, port generator) of one configuration."""
    cfg = SG3_CONFIGS[name]
    port = tsg3.SG3Generator(generator=torch.Generator().manual_seed(5),
                             **cfg)
    tree = _liven(to_jax_tree(port), np.random.RandomState(5))
    load_jax_params(port, tree)
    return jsg3.SG3Generator(**cfg), tree, port


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(2, 16).astype(np.float32),
            rs.randn(2, 4).astype(np.float32))


@pytest.mark.parametrize('name', list(SG3_CONFIGS))
def test_sg3_generator_matches_jax(name):
    """The whole generator with truncation (psi 0.7, cutoff 4), its radial
    and separable filters, R's 1x1 convolutions."""
    jg, tree, port = sg3_pair(name)
    assert any(layer.down_radial for layer in port.synthesis.children()
               if isinstance(layer, tsg3.SG3SynthesisLayer)) == (name == 'R')
    z, c = _inputs()
    kw = dict(truncation_psi=0.7, truncation_cutoff=4)
    with torch.no_grad():
        got = port(t(z), t(c), **kw)
        ws = port.mapping(t(z), t(c), **kw)
    want = jax.jit(functools.partial(jg, **kw))(tree, z, c)
    assert got.shape == (2, 3, 32, 32)
    _close(ws, jg.mapping(tree['mapping'], z, c, **kw))
    _close(got, want)


def test_sg3_bf16_matches_jax():
    """force_fp32=False: the use_fp16 layers (every layer at 32^2 with
    num_fp16_res 4) run bf16 in both packages; the output is float32."""
    jg, tree, port = sg3_pair('T')
    assert all(layer.use_fp16 for layer in port.synthesis.children()
               if isinstance(layer, tsg3.SG3SynthesisLayer))
    z, c = _inputs(1)
    with torch.no_grad():
        got = port(t(z), t(c), force_fp32=False)
        fp32 = port(t(z), t(c))
    want = jax.jit(functools.partial(jg, force_fp32=False))(tree, z, c)
    assert got.dtype == torch.float32
    _close(got, want, rel=2 * BF16_EPS)
    # and it is a bf16 forward, not the fp32 one
    assert float((got - fp32).abs().max()) > 1e-4


def test_sg3_gradient_matches_jax():
    """The gradient of a fixed projection of the image with respect to
    every parameter against jax.grad, each tensor within 1e-4 relative
    L2."""
    jg, tree, port = sg3_pair('T')
    z, c = _inputs(2)
    proj = np.random.RandomState(9).randn(2, 3, 32, 32).astype(np.float32)

    def jax_loss(params):
        return jnp.sum(jg(params, z, c, truncation_psi=0.7) * proj)

    want = jax.jit(jax.grad(jax_loss))(tree)
    port.zero_grad()
    (port(t(z), t(c), truncation_psi=0.7) * t(proj)).sum().backward()
    checked = 0
    for name, p in port.named_parameters():
        node = want
        for part in name.split('.'):
            node = node[part]
        g, w = n(p.grad), np.asarray(node)
        assert float(np.linalg.norm(w)) > 0, name
        gap = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert gap < 1e-4, (name, gap)
        checked += 1
    assert checked == len(list(port.parameters()))


# ------------------------------------------------------------ equivariance
def test_equivariance_metrics_match_jax():
    """EQ-T, EQ-T_frac and EQ-R on the tiny SG3-T through both packages'
    compute_equivariance_metrics on the same weights and seed, within 0.01
    dB a PSNR; the port restores the identity transform afterwards, and
    its metric registry runs the three names."""
    jg, tree, port = sg3_pair('T')
    kw = dict(num_samples=4, batch_size=2, compute_eqt_int=True,
              compute_eqt_frac=True, compute_eqr=True)
    got = equivariance.compute_equivariance_metrics(
        metric_utils.MetricOptions(generator=port, device='cpu'), **kw)
    want = jax_eq.compute_equivariance_metrics(
        jax_utils.MetricOptions(generator=jg, params=tree), **kw)
    assert len(got) == 3 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0, atol=0.01)
    assert torch.equal(port.synthesis.input.transform, torch.eye(3))

    calls = []
    compute = equivariance.compute_equivariance_metrics

    def capped(opts, num_samples, batch_size, **flags):
        calls.append(num_samples)
        return compute(opts, num_samples=2, batch_size=2, **flags)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(equivariance, 'compute_equivariance_metrics', capped)
        for name in ('eqt50k_int', 'eqt50k_frac', 'eqr50k'):
            record = metric_main.calc_metric(name, generator=port,
                                             device='cpu')
            assert np.isfinite(record['results'][name])
    assert calls == [50000] * 3
