"""The frozen reference agrees with the port at 128^2 on the CPU, with the
same weights from the seed and the same inputs, and takes nothing from
the port: its weights come from its own constructors and the seed."""

import torch

from benchmark import models
from benchmark.kinds import synth
from benchmark.traffic import Traffic

from conftest import tiny_ctx


def _pair(cell):
    ctx = tiny_ctx(cell)
    traffic = Traffic(ctx.mix, ctx.seed, ctx.device)
    ref = models.reference(ctx.cfg, 'G_kwargs', ctx.seed, ctx.device, 'G',
                           traffic.mesh).eval()
    prog = models.program(ctx.cfg, 'G_kwargs', ref.state_dict(), ctx.device,
                          traffic.mesh).eval()
    return ctx, traffic, ref, prog


def _agree(cell):
    ctx, traffic, ref, prog = _pair(cell)
    u = traffic.unit(0)
    with torch.no_grad():
        got = synth.forward(prog, ctx.mix, u)
        want = synth.forward(ref, ctx.mix, u)
    for k in synth.OUTPUTS:
        assert got[k].shape == want[k].shape
        assert torch.allclose(got[k], want[k], rtol=0, atol=1e-5), k
    # the planes reach the image: another expression changes it
    with torch.no_grad():
        other = synth.forward(ref, ctx.mix, traffic.unit(1))
    assert not torch.allclose(other['image'], want['image'])


def test_flagship_reference_agrees_with_the_port():
    _agree('next3d_ffhq512.synth_b8')


def test_texture_reference_agrees_with_the_port():
    _agree('next3d_texture_ffhq512.synth_b8')


def test_weights_follow_the_seed():
    ctx, traffic, ref, _ = _pair('next3d_ffhq512.synth_b8')
    again = models.reference(ctx.cfg, 'G_kwargs', ctx.seed, ctx.device, 'G',
                             traffic.mesh)
    other = models.reference(ctx.cfg, 'G_kwargs', ctx.seed + 1, ctx.device,
                             'G', traffic.mesh)
    a, b, c = ref.state_dict(), again.state_dict(), other.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = 'backbone.synthesis.b4.conv1.weight'
    assert not torch.equal(a[w], c[w])
    # standard normal leaves, scaled as the constructors scale them
    assert abs(float(a[w].std()) - 1) < 0.05
    assert torch.equal(a['orth_scale'], torch.tensor([[5.0]]))
