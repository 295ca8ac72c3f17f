"""Where the texture variant's gradient gap to ``jax.grad`` comes from.

    JAX_PLATFORMS=cpu python tests/torch_texture_grad_x64.py

tests/test_torch_train_variants.py holds the texture variant's Gmain
gradient with respect to the neural texture within 1e-3 relative L2 of
``jax.grad``; the gap it reads is 2e-4 to 5e-4. This script runs that
test's configuration (its ``setup`` fixture: the same weights, batch and
discriminator) twice, in two processes: JAX as the tests run it, and JAX
with ``jax_enable_x64`` on the same float32 inputs, where the values that
JAX makes in its default dtype (linspace, arange, constants from float64
numpy arrays) are float64. Each run takes the loss's gradient with respect
to the texture and to the rasterized renderings (the output of
``rasterize_orth``) in both packages, and the texture path alone (the
port's ``rasterize_orth`` and JAX's) fed JAX's cotangent of the renderings.
It prints, as relative L2 distances:

- the port against JAX, end to end, for both JAX runs;
- JAX against itself, with and without x64;
- the texture path alone, given the same cotangent.

An end-to-end float64 run of both packages is not possible without editing
the JAX package: its mapping casts z to float32 and its modulated
convolution takes its reduced-precision branch for any dtype other than
float32 (next3d_tpu/nn/stylegan2.py:50, :219).
"""

import os
import subprocess
import sys
import tempfile

import numpy as np


def measure(x64, out):
    """One run; writes the gradients to ``out`` (an .npz path)."""
    import jax
    if x64:
        jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp
    import torch

    tests = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [tests, os.path.dirname(tests)]
    import test_torch_train_variants as V
    from test_torch_texture import CFG
    from torch_parity import n, t
    from torch_train_parity import LOSS_CFG
    from next3d_tpu_torch.train.loss import LossConfig, StyleGAN2Loss

    torch.set_num_threads(4)
    G, jg, pg, discs, batch, _ = V.setup.__wrapped__()
    jd, pd, D = discs['d3']
    as32 = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(a, jnp.float32), tree)
    pg32, pd32 = as32(pg), as32(pd)
    z, c, v = (jnp.asarray(batch[k], jnp.float32)
               for k in ('gen_z', 'gen_c', 'gen_v'))
    rasterize_orth = jg.rasterize_orth
    R = CFG['plane_resolution']

    def gmain(p, off_renderings, off_texture):
        backbone = jg.texture_backbone
        synthesis = backbone.synthesis
        backbone.synthesis = lambda *a, **k: synthesis(*a, **k) + off_texture

        def offset(params, verts, texture):
            renderings, alphas = rasterize_orth(params, verts, texture)
            return renderings + off_renderings, alphas

        jg.rasterize_orth = offset
        try:
            ws = jg.mapping(p, z, c)
            images = jg.synthesis(p, ws, c, v, neural_rendering_resolution=64,
                                  noise_mode='const', rng=None)
        finally:
            backbone.synthesis = synthesis
            jg.rasterize_orth = rasterize_orth
        return jnp.mean(jax.nn.softplus(-jd(pd32, images, c)))

    _, (jax_renderings, jax_texture) = jax.jit(jax.value_and_grad(
        gmain, argnums=(1, 2)))(pg32, jnp.zeros((2, 96, R, R), jnp.float32),
                                jnp.zeros((2, 32, R, R), jnp.float32))
    jax_renderings = np.asarray(jax_renderings)

    loss_obj = StyleGAN2Loss(G, D, LossConfig(**LOSS_CFG), deterministic=True)
    sched, nrr = loss_obj.schedules(0)
    kept = {}
    build_identity, port_rasterize_orth = G.build_identity, G.rasterize_orth

    def keep_texture(*args, **kwargs):
        texture, static = build_identity(*args, **kwargs)
        kept['texture'] = texture
        return texture, static

    def keep_renderings(verts, texture):
        renderings, alphas = port_rasterize_orth(verts, texture)
        kept['renderings'], kept['verts'] = renderings, verts
        return renderings, alphas

    G.build_identity, G.rasterize_orth = keep_texture, keep_renderings
    try:
        loss, _, _ = loss_obj.gmain_loss(
            {k: t(x) for k, x in batch.items()},
            torch.Generator().manual_seed(0), sched, nrr)
    finally:
        del G.build_identity, G.rasterize_orth
    port_renderings, port_texture = (n(g) for g in torch.autograd.grad(
        loss, [kept['renderings'], kept['texture']]))

    # the texture path alone, fed JAX's cotangent of the renderings
    texture = n(kept['texture'])
    verts = n(kept['verts'])
    params = {k: jnp.asarray(pg[k], jnp.float32)
              for k in ('orth_scale', 'orth_shift')}
    _, vjp = jax.vjp(lambda x: rasterize_orth(params, verts, x)[0],
                     jnp.asarray(texture))
    (alone_jax,) = vjp(jnp.asarray(jax_renderings))
    x = torch.tensor(texture, requires_grad=True)
    renderings, _ = G.rasterize_orth(torch.tensor(verts), x)
    (alone_port,) = torch.autograd.grad(renderings, x,
                                        torch.tensor(jax_renderings))
    np.savez(out, jax_texture=np.asarray(jax_texture),
             jax_renderings=jax_renderings, port_texture=port_texture,
             port_renderings=port_renderings,
             alone_jax=np.asarray(alone_jax), alone_port=n(alone_port))


def relative(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def main():
    if len(sys.argv) == 3:
        measure(sys.argv[1] == 'x64', sys.argv[2])
        return
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for mode in ('f32', 'x64'):
            out = os.path.join(tmp, mode + '.npz')
            subprocess.run([sys.executable, os.path.abspath(__file__), mode,
                            out], check=True)
            runs[mode] = np.load(out)
        f32, x64 = runs['f32'], runs['x64']
        for name in ('texture', 'renderings'):
            print(f'gradient of the {name}, relative L2: port vs JAX '
                  f'{relative(f32["port_" + name], f32["jax_" + name]):.3g}; '
                  f'port vs JAX with x64 '
                  f'{relative(x64["port_" + name], x64["jax_" + name]):.3g}; '
                  f'JAX vs JAX with x64 '
                  f'{relative(f32["jax_" + name], x64["jax_" + name]):.3g}')
        print(f'the texture path alone, fed the same cotangent: port vs JAX '
              f'{relative(f32["alone_port"], f32["alone_jax"]):.3g}')


if __name__ == '__main__':
    main()
