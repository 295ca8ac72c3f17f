"""The train command's other configurations against the JAX package on the
CPU, on the same weights and inputs: the three other discriminators, the
texture variant's Gmain, Dmain on clips of two frames, and Dmain with the
augment pipe at a fixed p on JAX's draws.

The generator is the texture variant at the configuration of
tests/test_torch_texture.py (128^2, 2X super-resolution, 64^2 planes,
8+8 ray samples) with its expressions and camera, at which the port's K2
and the JAX scatter golden agree on every pixel; both images of the batch
share one z, so that the batch is also one clip of two frames (the clip
flattening repeats a clip's z for each frame). The JAX side follows
next3d_tpu/train/loss.py from its public pieces, as
tests/torch_train_parity.py explains, and the port's loss runs with
``deterministic=True``; ``run_D`` is JAX's own (``StyleGAN2Loss.run_D``,
which folds clips and augments).

Gates: the discriminators' logits within max-abs 1e-4; each loss within
1e-4 relative and each gradient by ``assert_grads_match`` (each tensor
within 2e-3 of its largest gradient plus 1e-3 of its sub-network's, the
global norm within 1e-3), as tests/test_torch_train_g.py."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from next3d_tpu.models import TriPlaneTextureGenerator as JaxTexture
from next3d_tpu.nn import discriminator as jax_disc
from next3d_tpu.render import camera_utils
from next3d_tpu.train.augment import AugmentPipe as JaxPipe
from next3d_tpu.train.loss import LossConfig as JaxLossConfig
from next3d_tpu.train.loss import StyleGAN2Loss as JaxLoss
from next3d_tpu_torch.models.triplane_texture import TriPlaneTextureGenerator
from next3d_tpu_torch.nn import discriminator as port_disc
from next3d_tpu_torch.train.augment import AugmentPipe
from next3d_tpu_torch.train.loss import LossConfig, StyleGAN2Loss
from next3d_tpu_torch.train.train_step import trainable_mask
from next3d_tpu_torch.utils.synthetic_head import synthetic_head
from next3d_tpu_torch.utils.weights import load_jax_params

from test_torch_augment import ADA_KW, jax_draws
from test_torch_generator import _liven_w_avg
from test_torch_texture import CFG, EXPRESSION_SEED
from torch_parity import n, one_thread, t, to_jax_tree  # noqa: F401
from torch_train_parity import (D_KWARGS, LOSS_CFG, assert_grads_match,
                                assert_loss_matches)

pytestmark = pytest.mark.usefixtures('one_thread')

SCHED = {'blur_sigma': 0.0, 'swapping_prob': 0.0, 'aug_p': 0.0}
SMALL_D = dict(img_resolution=64, channel_base=512, channel_max=32,
               epilogue_kwargs=dict(mbstd_group_size=2))


def _jax_params(d, seed):
    return jax.tree_util.tree_map(np.asarray, d.init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize('kind', ['dual_label', 'dummy', 'single'])
def test_discriminators_match_jax(kind):
    """Each on the JAX tree of its own init (loaded strictly), the same
    frozen paths at freeze_layers 2, and logits within 1e-4 on 4 images
    (the dummy at cur_nimg 100k, its raw branch at 0.8)."""
    rs = np.random.RandomState(1)
    img = {'image': np.tanh(rs.randn(4, 3, 64, 64)).astype(np.float32),
           'image_raw': np.tanh(rs.randn(4, 3, 32, 32)).astype(np.float32)}
    kw = dict(SMALL_D, img_channels=3, block_kwargs=dict(freeze_layers=2))
    if kind == 'dual_label':
        jd = jax_disc.DualLabelDualDiscriminator(c_dim=25, c2_dim=50, **kw)
        port = port_disc.DualLabelDualDiscriminator(c_dim=25, c2_dim=50, **kw)
        c = rs.randn(4, 75).astype(np.float32)
        call = {}
    elif kind == 'dummy':
        jd = jax_disc.DummyDualDiscriminator(c_dim=25, **kw)
        port = port_disc.DummyDualDiscriminator(c_dim=25, **kw)
        c = rs.randn(4, 25).astype(np.float32)
        call = {'cur_nimg': 100000}
    else:
        jd = jax_disc.SingleDiscriminator(c_dim=25, **kw)
        port = port_disc.SingleDiscriminator(c_dim=25, **kw)
        c = rs.randn(4, 25).astype(np.float32)
        call = {}
    params = _jax_params(jd, 2)
    load_jax_params(port, params)
    assert [tuple(p) for p in port.frozen_paths()] == \
        [tuple(p) for p in jd.frozen_paths()] != []
    want = np.asarray(jax.jit(lambda p, i, c: jd(p, i, c, **call))(
        params, img, c))
    with torch.no_grad():
        got = n(port({k: t(v) for k, v in img.items()}, t(c), **call))
    print(f'{kind}: max-abs {np.abs(got - want).max():.3g} of '
          f'{np.abs(want).max():.3g}')
    assert got.shape == want.shape == (4, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if kind == 'dual_label':
        with pytest.raises(ValueError, match='25 \\+ 50'):
            port({k: t(v) for k, v in img.items()}, t(c[:, :25]))


@pytest.fixture(scope='module')
def setup():
    """The texture variant (port and JAX, one tree), the 3-channel dual D
    of tests/torch_train_parity.py and a 6-channel one for clips of 2
    frames (c_dim 50), the batch and the reals."""
    mesh, _ = synthetic_head()
    rng = np.random.RandomState(3)
    G = TriPlaneTextureGenerator(
        topology_path=mesh, generator=torch.Generator().manual_seed(0), **CFG)
    pg = _liven_w_avg(to_jax_tree(G), rng)
    load_jax_params(G, pg)
    jg = JaxTexture(topology_path=mesh, rasterizer_impl='scatter',
                    rasterizer_patch=16, **CFG)
    v = mesh.verts[None].astype(np.float32)
    jitter = np.random.RandomState(EXPRESSION_SEED).randn(*v.shape)
    v = np.concatenate([v, v + jitter.astype(np.float32) * 0.002])
    cam = camera_utils.lookat_pose(math.pi / 2 - 0.2, math.pi / 2 + 0.05,
                                   jnp.asarray([0, 0, 0.2]), radius=2.7,
                                   batch_size=2)
    K = camera_utils.fov_to_intrinsics(18.837)
    c = np.concatenate([np.asarray(cam).reshape(2, 16),
                        np.tile(K.reshape(1, 9), (2, 1))], 1)
    c = c.astype(np.float32)
    z = np.repeat(rng.randn(1, 32).astype(np.float32), 2, 0)
    batch = dict(gen_z=z, gen_c=c, gen_v=v, real_c=c[::-1].copy())
    real = np.tanh(rng.randn(2, 3, 128, 128)).astype(np.float32)
    discs = {}
    for name, kw in (('d3', D_KWARGS),
                     ('d6', dict(D_KWARGS, c_dim=50, img_channels=6))):
        jd = jax_disc.DualDiscriminator(**kw)
        pd = _jax_params(jd, 1)
        discs[name] = jd, pd, load_jax_params(
            port_disc.DualDiscriminator(**kw), pd)
    return G, jg, pg, discs, batch, real


@pytest.fixture(scope='module')
def gmain_ref(setup):
    """JAX's Gmain loss of the texture variant, its gradient with respect
    to G and to the neural texture, and G's images (the fakes of the Dmain
    tests)."""
    _, jg, pg, discs, batch, _ = setup
    jd, pd, _ = discs['d3']
    z, c, v = (jnp.asarray(batch[k]) for k in ('gen_z', 'gen_c', 'gen_v'))
    backbone = jg.texture_backbone
    synthesis = backbone.synthesis

    def gmain(p, offset):
        # the texture plus a zero offset, whose gradient is the texture's
        backbone.synthesis = lambda *a, **k: synthesis(*a, **k) + offset
        try:
            ws = jg.mapping(p, z, c)
            out = jg.synthesis(p, ws, c, v, neural_rendering_resolution=64,
                               noise_mode='const', rng=None)
        finally:
            backbone.synthesis = synthesis
        images = {k: out[k] for k in ('image', 'image_raw')}
        return jnp.mean(jax.nn.softplus(-jd(pd, out, c))), images

    R = CFG['plane_resolution']
    (loss, images), (grads, d_texture) = jax.jit(jax.value_and_grad(
        gmain, argnums=(0, 1), has_aux=True))(pg, jnp.zeros((2, 32, R, R)))
    return loss, grads, images, np.asarray(d_texture)


def _grads(loss, module):
    mask = trainable_mask(module)
    named = {k: p for k, p in module.named_parameters() if mask[k]}
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                retain_graph=True)
    return {k: g if g is not None else torch.zeros_like(p)
            for (k, p), g in zip(named.items(), grads)}, mask


def test_texture_gmain_matches_jax(setup, gmain_ref):
    """The texture variant's Gmain (K2 and the interpolation under grad
    mode, the texture's grid_sample differentiated) against jax.grad: the
    loss, the gradient with respect to the neural texture (within 1e-3
    relative, L2) and with respect to G. The texture backbone's noise
    strengths are held by the global norm alone: each is a sum over the
    2 x C x H x W pixels of a layer of a gradient that the packages'
    float32 roundoff moves by 2e-4 to 5e-4 (relative, L2, as the
    texture's gradient), and it cancels to under 5% of the
    backbone's largest gradient, so it keeps only a few digits (2.9e-6 and
    6.0e-6 apart at b32.conv0 and b64.conv1 of 1.0e-4 and 1.6e-4; the
    port's own thread count and sampling layout move them by 2e-8)."""
    G, _, _, discs, batch, _ = setup
    want_loss, want, _, want_texture = gmain_ref
    loss_obj = StyleGAN2Loss(G, discs['d3'][2], LossConfig(**LOSS_CFG),
                             deterministic=True)
    sched, nrr = loss_obj.schedules(0)
    kept = {}
    build_identity = G.build_identity

    def keep_texture(*args, **kwargs):
        texture, static = build_identity(*args, **kwargs)
        kept['texture'] = texture
        return texture, static

    G.build_identity = keep_texture
    try:
        loss, _, _ = loss_obj.gmain_loss({k: t(x) for k, x in batch.items()},
                                         torch.Generator().manual_seed(0),
                                         sched, nrr)
    finally:
        del G.build_identity
    assert_loss_matches(loss, want_loss, 'texture Gmain loss')
    (d_texture,) = torch.autograd.grad(loss, kept['texture'],
                                       retain_graph=True)
    diff = n(d_texture) - want_texture
    rel = np.linalg.norm(diff) / np.linalg.norm(want_texture)
    print(f'gradient of the texture: relative L2 {rel:.3g}, max-abs '
          f'{np.abs(diff).max():.3g} of {np.abs(want_texture).max():.3g}')
    assert rel <= 1e-3
    grads, mask = _grads(loss, G)
    noise = {k for k in grads if k.startswith('texture_backbone.')
             and k.endswith('noise_strength')}
    assert_grads_match({k: g for k, g in grads.items() if k not in noise},
                       want, {k: ok and k not in noise
                              for k, ok in mask.items()}, 'texture Gmain')
    assert_grads_match(grads, want, mask, 'texture Gmain, global norm',
                       per_tensor=False)


def _d_grads(loss, D):
    return dict(zip([k for k, _ in D.named_parameters()],
                    torch.autograd.grad(loss, list(D.parameters()))))


def test_dmain_on_clips_matches_jax(setup, gmain_ref):
    """Dmain at num_frames=2 on one clip of the batch's two frames: the
    port's phase flattens the clip, runs G on its frames and folds them
    into D's 6 channels; JAX's run_D folds its images. Loss and D's
    gradient."""
    G, _, _, discs, batch, real = setup
    jd, pd, D = discs['d6']
    gen_img = gmain_ref[2]
    cfg = dict(LOSS_CFG, num_frames=2)
    jl = JaxLoss(None, jd, JaxLossConfig(**cfg))
    real_jax = jax.tree_util.tree_map(
        np.asarray, jl.prepare_real(jnp.asarray(real), 0.0, 64))

    def dmain(p):
        fake = jl.run_D(p, gen_img, jnp.asarray(batch['gen_c']), None, SCHED)
        reals = jl.run_D(p, real_jax, jnp.asarray(batch['real_c']), None,
                         SCHED)
        assert fake.shape == reals.shape == (1, 1)
        return jnp.mean(jax.nn.softplus(fake)) + \
            jnp.mean(jax.nn.softplus(-reals))

    want_loss, want = jax.jit(jax.value_and_grad(dmain))(pd)
    loss_obj = StyleGAN2Loss(G, D, LossConfig(**cfg), deterministic=True)
    clip = {'gen_z': t(batch['gen_z'][:1]), 'gen_c': t(batch['gen_c'][None]),
            'gen_v': t(batch['gen_v'][None]),
            'real_c': t(batch['real_c'][None])}
    flat, real_flat = loss_obj.flatten_clips(clip, t(real[None]))
    assert torch.equal(flat['gen_z'], t(batch['gen_z']))
    assert torch.equal(real_flat, t(real))
    sched, nrr = loss_obj.schedules(0)
    loss, _, _ = loss_obj.dmain_loss(
        flat, loss_obj.prepare_real(real_flat, 0.0, nrr),
        torch.Generator().manual_seed(0), sched, nrr)
    assert_loss_matches(loss, want_loss, 'Dmain on clips')
    assert_grads_match(_d_grads(loss, D), want, trainable_mask(D),
                       'Dmain on clips')


class _Replay(AugmentPipe):
    """The pipe with its draws given: each call takes the next."""

    def __init__(self, draws, **kw):
        super().__init__(**kw)
        self.draws = list(draws)

    def draw(self, shape, p, generator, device):
        d = self.draws.pop(0)
        assert tuple(d['noise_values'].shape if 'noise_values' in d
                     else shape) == tuple(shape)
        return {k: t(x) for k, x in d.items()}


def test_dmain_with_augmentation_matches_jax(setup, gmain_ref):
    """Dmain with the train command's augment pipe at a fixed p=0.5: JAX's
    run_D draws from split(key)[1] of each call's key; the port's pipe is
    given those draws. Loss and D's gradient."""
    G, _, _, discs, batch, real = setup
    jd, pd, D = discs['d3']
    gen_img = gmain_ref[2]
    sched = dict(SCHED, aug_p=0.5)
    jl = JaxLoss(None, jd, JaxLossConfig(**LOSS_CFG),
                 augment_pipe=JaxPipe(**ADA_KW))
    real_jax = jax.tree_util.tree_map(
        np.asarray, jl.prepare_real(jnp.asarray(real), 0.0, 64))
    keys = jax.random.split(jax.random.PRNGKey(9), 2)

    def dmain(p):
        fake = jl.run_D(p, gen_img, jnp.asarray(batch['gen_c']), keys[0],
                        sched)
        reals = jl.run_D(p, real_jax, jnp.asarray(batch['real_c']), keys[1],
                         sched)
        return jnp.mean(jax.nn.softplus(fake)) + \
            jnp.mean(jax.nn.softplus(-reals))

    want_loss, want = jax.jit(jax.value_and_grad(dmain))(pd)
    pipe = AugmentPipe(**ADA_KW)
    draws = [jax_draws(pipe, jax.random.split(k)[1], (2, 6, 128, 128), 0.5)
             for k in keys]
    assert any((d['xflip'] != 0).any() for d in draws)
    loss_obj = StyleGAN2Loss(G, D, LossConfig(**LOSS_CFG),
                             augment_pipe=_Replay(draws, **ADA_KW),
                             deterministic=True)
    _, nrr = loss_obj.schedules(0)
    loss, _, _ = loss_obj.dmain_loss(
        {k: t(x) for k, x in batch.items()},
        loss_obj.prepare_real(t(real), 0.0, nrr),
        torch.Generator().manual_seed(0), sched, nrr)
    assert not loss_obj.augment_pipe.draws
    assert_loss_matches(loss, want_loss, 'Dmain with augmentation')
    assert_grads_match(_d_grads(loss, D), want, trainable_mask(D),
                       'Dmain with augmentation')
