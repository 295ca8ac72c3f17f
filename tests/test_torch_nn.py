"""The port's networks against the JAX package on the CPU, on the same
parameters through the weight bridge (utils/weights.py load_jax_params).

Parameters come from the port's own seeded init (same distributions as
the JAX inits), with noise strengths and w_avg set non-zero so that noise
and truncation take part. Tolerance: 1e-5 relative to the output's scale
plus 1e-5 absolute, since stacked float32 convolutions sum in different
orders in the two frameworks."""

import numpy as np
import pytest

import jax
import torch

from next3d_tpu import nn as jnn
from next3d_tpu_torch import nn as tnn
from next3d_tpu_torch.utils.weights import load_jax_params

from torch_parity import n, t, to_jax_tree
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)


def _close(got, want):
    got, want = n(got), n(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * (1 + scale))


def _liven(tree, rng):
    """Non-zero noise strengths and w_avg, in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _liven(v, rng)
        elif k == 'noise_strength':
            tree[k] = np.float32(rng.uniform(0.05, 0.3))
        elif k == 'w_avg':
            tree[k] = rng.randn(*v.shape).astype(np.float32)
    return tree


def _pair(jcls, tcls, rng, *args, **kwargs):
    """(jax module, params, torch module) on one param tree."""
    seed = torch.Generator().manual_seed(int(rng.randint(1 << 30)))
    params = _liven(to_jax_tree(tcls(*args, generator=seed, **kwargs)), rng)
    return jcls(*args, **kwargs), params, load_jax_params(
        tcls(*args, **kwargs), params)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("noise_mode", ['const', 'none'])
def test_mapping_and_synthesis(rng, fused, noise_mode):
    jg, p, tg = _pair(jnn.Generator, tnn.Generator, rng, 16, 25, 32, 32, 12,
                      channel_base=256, channel_max=32)
    z = rng.randn(2, 16).astype(np.float32)
    c = rng.randn(2, 25).astype(np.float32)
    jws = jg.mapping(p['mapping'], z, c, truncation_psi=0.7,
                     truncation_cutoff=3)
    tws = tg.mapping(t(z), t(c), truncation_psi=0.7, truncation_cutoff=3)
    _close(tws, jws)
    with torch.no_grad():
        got = tg.synthesis(tws, noise_mode=noise_mode, fused_modconv=fused)
    _close(got, jg.synthesis(p['synthesis'], jws, noise_mode=noise_mode,
                             fused_modconv=fused))


@pytest.mark.parametrize("kind", ['mouth', 'blend'])
def test_cond_generator(rng, kind):
    """The two StyleUNet shapes of the flagship (triplane_next3d.py:105-117)
    at narrow widths: mouth (cond 64 -> final 4) and blend (cond = plane
    resolution -> final 32)."""
    if kind == 'mouth':
        kw = dict(in_size=64, final_size=4, num_cond_res=64)
        cond = 64
    else:
        kw = dict(in_size=128, final_size=32, num_cond_res=128)
        cond = 128
    jc, p, tc = _pair(jnn.CondGenerator, tnn.CondGenerator, rng, 16, 25, 32,
                      img_resolution=128, img_channels=8, cond_channels=8,
                      channel_base=1024, channel_max=16, **kw)
    x = rng.randn(2, 8, cond, cond).astype(np.float32)
    ws = rng.randn(2, jc.num_ws, 32).astype(np.float32)
    with torch.no_grad():
        got = tc.synthesis(t(x), t(ws), noise_mode='const')
    _close(got, jc.synthesis(p['synthesis'], x, ws, noise_mode='const'))


@pytest.mark.parametrize("head,res,batch", [
    ('SuperresolutionHybrid8XDC', 512, 1),
    ('SuperresolutionHybrid2X', 128, 2)])
def test_superresolution(rng, head, res, batch):
    jsr, p, tsr = _pair(getattr(jnn, head), getattr(tnn, head), rng,
                        channels=32, img_resolution=res, sr_num_fp16_res=4,
                        sr_antialias=True)
    rgb = rng.randn(batch, 3, 64, 64).astype(np.float32)
    x = rng.randn(batch, 32, 64, 64).astype(np.float32)
    ws = rng.randn(batch, 14, 512).astype(np.float32)
    with torch.no_grad():
        got = tsr(t(rgb), t(x), t(ws), noise_mode='const')
    want = jax.jit(lambda *a: jsr(*a, noise_mode='const'))(p, rgb, x, ws)
    assert got.shape == (batch, 3, res, res)
    _close(got, want)


def test_random_noise_follows_the_generator(rng):
    """noise_mode='random' draws from the torch.Generator passed in: the
    same seed repeats the image, another seed changes it (the JAX package
    draws other numbers, so this mode has no JAX parity)."""
    _, _, tg = _pair(jnn.Generator, tnn.Generator, rng, 16, 25, 32, 16, 3,
                     channel_base=128, channel_max=16)
    ws = t(rng.randn(2, tg.num_ws, 32).astype(np.float32))

    def run(seed):
        with torch.no_grad():
            return tg.synthesis(ws, noise_mode='random',
                                generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert (run(1) - run(2)).abs().max() > 1e-4
