"""The port's augment pipe (next3d_tpu_torch/train/augment.py) against the
JAX package's (next3d_tpu/train/augment.py) on the same images and the
same draws: ``jax_draws`` takes the per-image parameters from JAX's own
key sequence (``keys = iter(jax.random.split(rng, 64))``, JAX :147, in the
order of :156-293), so the port's ``apply`` sees what JAX's ``__call__``
drew.

Tolerances, max-abs: 1e-5 for the colour transforms, noise and cutout
(float32 matrices and sums in another order); 1e-4 for the groups that
resample, where ``F.grid_sample`` takes the reflected coordinates through
its own normalization (a round trip of about 1e-5 px at a 128-px 2x image)
and the wavelet filters sum 12 taps in another order; the gradients with
respect to the images within 1e-4 of ``jax.grad``'s."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from next3d_tpu.train import augment as jax_augment
from next3d_tpu_torch.ops.grid_sample import grid_sample_gradfix
from next3d_tpu_torch.train import augment

from torch_parity import n, t

ADA_KW = dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1,
              xfrac=1, brightness=1, contrast=1, lumaflip=1, hue=1,
              saturation=1)
GROUPS = {
    'blit': dict(xflip=1, rotate90=1, xint=1),
    'geom': dict(scale=1, rotate=1, aniso=1, xfrac=1),
    'color': dict(brightness=1, contrast=1, lumaflip=1, hue=1,
                  saturation=1),
    'filter': dict(imgfilter=1),
    'noise': dict(noise=1),
    'cutout': dict(cutout=1),
}
TOL = {'blit': 1e-4, 'geom': 1e-4, 'color': 1e-5, 'filter': 1e-5,
       'noise': 1e-5, 'cutout': 1e-5, 'ada': 1e-4}


def jax_draws(pipe, rng, shape, p):
    """The per-image parameters that JAX's ``pipe(rng, images, p)`` draws,
    as numpy, under the keys of ``augment.AugmentPipe.draw``."""
    B, C, H, W = shape
    keys = iter(jax.random.split(rng, 64))
    uniform = lambda *s: jax.random.uniform(next(keys), s)  # noqa: E731
    normal = lambda *s: jax.random.normal(next(keys), s)  # noqa: E731

    def gate(value, identity, prob, extra_dims=0):
        u = uniform(B, *(1,) * extra_dims)
        return jnp.where(u < prob * p, value, identity)

    p_rot = 1 - jnp.sqrt(jnp.clip(1 - pipe.rotate * p, 0, 1))

    def rotation():
        theta = (uniform(B) * 2 - 1) * np.pi * pipe.rotate_max
        return jnp.where(uniform(B) < p_rot, theta, 0.0)

    d = {}
    if pipe.xflip > 0:
        d['xflip'] = gate(jnp.floor(uniform(B) * 2), 0.0, pipe.xflip)
    if pipe.rotate90 > 0:
        d['rotate90'] = gate(jnp.floor(uniform(B) * 4), 0.0, pipe.rotate90)
    if pipe.xint > 0:
        d['xint'] = gate((uniform(B, 2) * 2 - 1) * pipe.xint_max, 0.0,
                         pipe.xint, 1)
    if pipe.scale > 0:
        d['scale'] = gate(jnp.exp2(normal(B) * pipe.scale_std), 1.0,
                          pipe.scale)
    if pipe.rotate > 0:
        d['rotate'] = rotation()
    if pipe.aniso > 0:
        d['aniso'] = gate(jnp.exp2(normal(B) * pipe.aniso_std), 1.0,
                          pipe.aniso)
    if pipe.rotate > 0:
        d['rotate_after_aniso'] = rotation()
    if pipe.xfrac > 0:
        d['xfrac'] = gate(normal(B, 2) * pipe.xfrac_std, 0.0, pipe.xfrac, 1)
    if pipe.brightness > 0:
        d['brightness'] = gate(normal(B) * pipe.brightness_std, 0.0,
                               pipe.brightness)
    if pipe.contrast > 0:
        d['contrast'] = gate(jnp.exp2(normal(B) * pipe.contrast_std), 1.0,
                             pipe.contrast)
    if pipe.lumaflip > 0:
        d['lumaflip'] = gate(jnp.floor(uniform(B, 1, 1) * 2), 0.0,
                             pipe.lumaflip, 2)
    if pipe.hue > 0 and C > 1:
        d['hue'] = gate((uniform(B) * 2 - 1) * np.pi * pipe.hue_max, 0.0,
                        pipe.hue)
    if pipe.saturation > 0 and C > 1:
        d['saturation'] = gate(jnp.exp2(normal(B, 1, 1)
                                        * pipe.saturation_std), 1.0,
                               pipe.saturation, 2)
    if pipe.imgfilter > 0:
        gains = []
        for strength in pipe.imgfilter_bands:
            t_i = jnp.exp2(normal(B) * pipe.imgfilter_std)
            gains.append(jnp.where(uniform(B) < pipe.imgfilter * p * strength,
                                   t_i, 1.0))
        d['imgfilter'] = jnp.stack(gains, 1)
    if pipe.noise > 0:
        sigma = jnp.abs(normal(B, 1, 1, 1)) * pipe.noise_std
        d['noise'] = gate(sigma, 0.0, pipe.noise, 3)
        d['noise_values'] = normal(B, C, H, W)
    if pipe.cutout > 0:
        d['cutout_size'] = gate(jnp.full((B, 2, 1, 1, 1), pipe.cutout_size),
                                0.0, pipe.cutout, 4)
        d['cutout_center'] = uniform(B, 2, 1, 1, 1)
    return {k: np.asarray(v, np.float32) for k, v in d.items()}


def _images(shape, seed=0):
    return np.tanh(np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _pair(kw, shape, p, seed):
    """(images, the JAX output, the port's output on JAX's draws, the
    draws)."""
    x = _images(shape, seed)
    rng = jax.random.PRNGKey(seed)
    want = np.asarray(jax_augment.AugmentPipe(**kw)(rng, jnp.asarray(x), p))
    pipe = augment.AugmentPipe(**kw)
    d = jax_draws(pipe, rng, shape, p)
    got = n(pipe.apply(t(x), {k: t(v) for k, v in d.items()}))
    return x, want, got, d


@pytest.mark.parametrize('group', list(GROUPS) + ['ada'])
def test_apply_matches_jax_on_its_draws(group):
    """Each group alone at p=1 (every transform on for every image but the
    rotations, which JAX gates at 1 - sqrt(1 - p)) on 3 channels, and the
    train command's configuration (``ada``) at p=0.6 on the 6-channel
    image + upsampled raw pair; 64^2, batch 4."""
    kw, shape, p = (ADA_KW, (4, 6, 64, 64), 0.6) if group == 'ada' else \
        (GROUPS[group], (4, 3, 64, 64), 1.0)
    x, want, got, d = _pair(kw, shape, p, seed=len(group))
    err = np.abs(got - want).max()
    print(f'{group}: max-abs {err:.3g}, changed by '
          f'{np.abs(want - x).max():.3g}, draws {sorted(d)}')
    assert got.shape == want.shape == x.shape
    assert np.abs(want - x).max() > 0.05
    assert err <= TOL[group], group


def test_draw_gates_and_shapes():
    """The port's own draw: every key of JAX's order, p=0 gives every
    transform its identity value, p=1 turns the gated ones on."""
    pipe = augment.AugmentPipe(**ADA_KW, imgfilter=1, noise=1, cutout=1)
    shape = (4, 6, 64, 64)
    gen = torch.Generator().manual_seed(0)
    off = pipe.draw(shape, 0.0, gen, 'cpu')
    want = jax_draws(pipe, jax.random.PRNGKey(0), shape, 0.0)
    assert list(off) == list(want)
    for k, v in off.items():
        assert tuple(v.shape) == want[k].shape, k
        if k not in ('noise_values', 'cutout_center'):
            np.testing.assert_array_equal(n(v), want[k], err_msg=k)
    on = pipe.draw(shape, 1.0, gen, 'cpu')
    assert (on['xint'] != 0).all() and (on['scale'] != 1).all()
    assert (on['noise'] > 0).all() and (on['cutout_size'] == 0.5).all()


def test_p_zero_is_the_identity():
    """At p=0 the pipe's resample still runs (JAX and the reference run it
    with identity transforms): the port equals JAX's p=0 output, and the
    input away from a 4-pixel border (the wavelet round trip's reflected
    edge), on 3 and on 6 channels."""
    for shape in ((4, 3, 64, 64), (4, 6, 64, 64)):
        x, want, got, _ = _pair(ADA_KW, shape, 0.0, seed=7)
        assert np.abs(got - want).max() <= 1e-4
        m = 4
        np.testing.assert_allclose(got[..., m:-m, m:-m], x[..., m:-m, m:-m],
                                   atol=1e-4)
    pipe = augment.AugmentPipe(**ADA_KW)
    x = t(_images((4, 6, 64, 64)))
    out = pipe(x, 0.0, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(n(out)[..., 4:-4, 4:-4], n(x)[..., 4:-4, 4:-4],
                               atol=1e-4)


def test_gradient_matches_jax():
    """The gradient of sum(w * pipe(x)) with respect to x, on JAX's draws
    (the train command's configuration at p=0.6 with the filter, noise and
    cutout on too), 6 channels at 32^2 (the gradients reach 20; the
    resample's coordinate rounding grows with the image, to 1.2e-4 at
    64^2); and a double backward through the pipe,
    as R1 takes one, of the gradient of sum(w * pipe(x)^2) / 2."""
    kw = dict(ADA_KW, imgfilter=1, noise=1, cutout=1)
    shape = (2, 6, 32, 32)
    x = _images(shape, 3)
    w = np.random.RandomState(4).randn(*shape).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    jpipe = jax_augment.AugmentPipe(**kw)
    want = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(
        jnp.asarray(w) * jpipe(rng, x, 0.6))))(jnp.asarray(x)))
    pipe = augment.AugmentPipe(**kw)
    d = {k: t(v) for k, v in jax_draws(pipe, rng, shape, 0.6).items()}
    xt = t(x).requires_grad_()
    (g,) = torch.autograd.grad((t(w) * pipe.apply(xt, d)).sum(), xt,
                               create_graph=True)
    err = np.abs(n(g) - want).max()
    print(f'gradient: max-abs {err:.3g} of {np.abs(want).max():.3g}')
    assert err <= 1e-4
    (g2,) = torch.autograd.grad((t(w) * pipe.apply(xt, d).square()).sum()
                                / 2, xt, create_graph=True)
    (gg,) = torch.autograd.grad(g2.square().sum(), xt)
    assert torch.isfinite(gg).all() and gg.abs().max() > 0


def test_filter_bank_and_ada_update_p_match_jax():
    np.testing.assert_allclose(augment.AugmentPipe().Hz_fbank,
                               jax_augment.AugmentPipe().Hz_fbank,
                               rtol=0, atol=1e-7)
    np.testing.assert_array_equal(augment.AugmentPipe().Hz_geom,
                                  jax_augment.AugmentPipe().Hz_geom)
    for args in ((0.5, 0.9, 0.6, 4000, 500), (0.5, 0.1, 0.6, 4000, 100),
                 (0.0, -1.0, 0.6, 10 ** 9, 500), (0.999, 1.0, 0.6, 64, 100),
                 (0.2, 0.6, 0.6, 16, 500)):
        assert augment.ada_update_p(*args) == jax_augment.ada_update_p(*args)


@pytest.mark.parametrize('padding_mode', ['zeros', 'border', 'reflection'])
def test_grid_sample_gradfix_matches_torch(padding_mode):
    """The pipe's resample, whose backward the card's torch cannot
    differentiate: its value, the input's gradient and the gradient of
    that gradient's square, against F.grid_sample's own double backward
    on the CPU (float64, equal to 1e-12), and gradgradcheck."""
    import torch.nn.functional as F
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(2, 3, 6, 7)).requires_grad_()
    grid = torch.from_numpy(rs.rand(2, 5, 4, 2) * 2.4 - 1.2)
    w = torch.from_numpy(rs.randn(2, 3, 5, 4))
    results = []
    for fn in (grid_sample_gradfix,
               lambda x, g, m: F.grid_sample(x, g, 'bilinear', m, False)):
        y = fn(x, grid, padding_mode)
        (g,) = torch.autograd.grad((w * y).sum(), x, create_graph=True)
        (gg,) = torch.autograd.grad((g * y.sum()).square().sum(), x)
        results.append([n(y), n(g), n(gg)])
    for got, want in zip(*results):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert torch.autograd.gradgradcheck(
        lambda x: grid_sample_gradfix(x, grid, padding_mode), (x,))
    with pytest.raises(ValueError, match='grid'):
        grid_sample_gradfix(x, grid.clone().requires_grad_())
