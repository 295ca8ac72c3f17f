"""The port's bf16 serving policy (``force_fp32=False``) against the JAX
package's on the CPU, on the same parameters and inputs.

Per module: a ``use_fp16`` SynthesisBlock and synthesis network,
modulated_conv2d with its pre-normalization, the StyleUNet, the SR heads,
the OSGDecoder, the mouth crop and paste, and K4's plain version on planes
stored in bf16 (``gather_bf16``). The slice: both generators at the small
configuration of tests/test_torch_generator.py, with ``sr_num_fp16_res=4``
so that the SR blocks run bf16 too, on the synthetic head with
``noise_mode='const'``.

Tolerances. bf16 keeps 8 significant bits: its unit roundoff U = 2**-8 is
the largest relative error of one rounding. The two frameworks round at
different places (XLA may keep a fused elementwise chain in float32,
oneDNN and XLA sum a convolution in different orders, the port's K4 and
crop/paste sum in float32 where JAX rounds each product to bf16), so one
op's outputs differ by about an ulp (2 U relative) and a stack of
convolutions by a few. Each bound is a count of U times the reference
output's largest magnitude, with its reason beside it.

The slice against the fp32 forward: tests/test_bf16_parity.py bounds the
JAX package's bf16 forward by image max-abs 0.05 / PSNR 45 dB and image_raw
0.02 / 55 dB, at its own configuration (SR blocks float32, 64^2 planes,
channel_base 1024, channel_max 64, the JAX init of key 0). The port's
bf16 forward is held to those bounds at that configuration, on the
synthetic head. At the configuration above, with the SR blocks in bf16
and random weights whose images reach 3.8 in magnitude (an ulp of bf16 at
2-4 is 0.0156), the JAX package's own bf16 flagship forward is 0.154
max-abs / 43.0 dB from the fp32 forward on the image, and 0.040 / 57.3 dB
on image_raw, beyond those bounds (the texture variant: 0.036 / 47.5 dB
and 0.0041 / 63.3 dB). There the port is held to the JAX package's own
loss: its bf16 forward's PSNR to its fp32 forward within 1 dB of JAX's,
and its max-abs within 2x.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from next3d_tpu import nn as jnn
from next3d_tpu.models import TriPlaneGenerator as JaxGenerator
from next3d_tpu.models.osg_decoder import OSGDecoder as JaxDecoder
from next3d_tpu.models.triplane_texture import \
    TriPlaneTextureGenerator as JaxTextureGenerator
from next3d_tpu.nn.stylegan2 import modulated_conv2d as jax_modconv
from next3d_tpu.ops.interpolate import (paste_resized_region as jax_paste,
                                        resample_region as jax_crop)
from next3d_tpu.render import camera_utils
from next3d_tpu.render.renderer import sample_from_planes as jax_sample
from next3d_tpu_torch import nn as tnn
from next3d_tpu_torch.models.osg_decoder import OSGDecoder
from next3d_tpu_torch.models.triplane_next3d import TriPlaneGenerator
from next3d_tpu_torch.models.triplane_texture import TriPlaneTextureGenerator
from next3d_tpu_torch.nn.stylegan2 import modulated_conv2d
from next3d_tpu_torch.ops import triplane
from next3d_tpu_torch.ops.interpolate import (paste_resized_region,
                                              resample_region)
from next3d_tpu_torch.render.renderer import (layout_planes,
                                              sample_from_planes)
from next3d_tpu_torch.utils.synthetic_head import synthetic_head
from next3d_tpu_torch.utils.weights import load_jax_params

from test_torch_generator import CFG, EXPRESSION_SEED, _liven_w_avg
from test_torch_nn import _liven, _pair
from torch_parity import n, one_thread, t, to_jax_tree  # noqa: F401
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)

U = 2.0 ** -8            # bf16's unit roundoff
BF16 = jnp.bfloat16


def _bf16_input(a):
    """numpy float32 -> the same bf16 values in both frameworks."""
    x = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    return x, jnp.asarray(x.float().numpy()).astype(BF16)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _gap(got, want):
    """(max-abs gap, largest magnitude of want), in float32."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()), float(np.abs(want).max())


def _close(got, want, units, what=''):
    """got within ``units`` * U * max|want| of want."""
    err, scale = _gap(got, want)
    print(f'{what}: max-abs {err:.4g} = {err / (U * scale):.2f} U x '
          f'{scale:.4g}')
    assert err <= units * U * scale, (what, err, scale)


def _psnr(got, want):
    """PSNR over a [-1, 1] range, as tests/test_bf16_parity.py takes it."""
    mse = float(np.mean((_f32(got) - _f32(want)) ** 2))
    return 10 * np.log10(4.0 / mse) if mse > 0 else np.inf


# ----------------------------------------------------------------- modules

@pytest.mark.parametrize('demodulate,fused', [
    (True, False), (True, True), (False, False)])
def test_modulated_conv2d(rng, demodulate, fused):
    """modulated_conv2d on bf16 activations: with demodulation both
    packages pre-normalize the weights and the styles (JAX :44-52; styles
    of magnitude up to 40 here, as an affine layer may give). One
    convolution of 16 inputs x 9 taps summed in float32 and rounded once
    (an ulp apart where the two sums round differently): 2 U, and 9 of 10
    outputs equal."""
    x, jx = _bf16_input(rng.randn(2, 16, 12, 12).astype(np.float32))
    weight = rng.randn(8, 16, 3, 3).astype(np.float32)
    styles = (rng.randn(2, 16) * 20).astype(np.float32)
    noise = rng.randn(2, 8, 12, 12).astype(np.float32) * 0.1
    kw = dict(demodulate=demodulate, fused_modconv=fused, padding=1)
    got = modulated_conv2d(x, t(weight), t(styles), noise=t(noise).to(
        torch.bfloat16), **kw)
    want = jax.jit(lambda *a: jax_modconv(*a, **kw))(
        jx, weight, styles, jnp.asarray(noise).astype(BF16))
    assert got.dtype == torch.bfloat16 and want.dtype == BF16
    _close(got, want, 2, 'modulated_conv2d')
    assert np.mean(_f32(got) == _f32(want)) >= 0.9


@pytest.mark.parametrize('kind', ['block', 'network'])
def test_synthesis_bf16(rng, kind):
    """A ``use_fp16`` SynthesisBlock (up 2, const noise with live
    strengths) and a synthesis network whose top 3 resolutions are
    ``use_fp16`` (num_fp16_res=4 at 32^2), with force_fp32=False. The
    block's x is bf16 and its img float32 (JAX :404-450). Two bf16 layers
    in the block, each rounding its output, give about 2 U (measured 2.1):
    6 U on x and 4 U on its float32 image; six in the network (measured
    1.9 U): 8 U."""
    if kind == 'block':
        kw = dict(w_dim=32, resolution=16, img_channels=3, use_fp16=True)
        tb = tnn.SynthesisBlock(16, 24, generator=torch.Generator()
                                .manual_seed(1), **kw)
        p = _liven(to_jax_tree(tb), rng)
        load_jax_params(tb, p)
        jb = jnn.SynthesisBlock(16, 24, is_last=False, **kw)
        x = rng.randn(2, 16, 8, 8).astype(np.float32)
        img = rng.randn(2, 3, 8, 8).astype(np.float32)
        ws = rng.randn(2, 3, 32).astype(np.float32)
        with torch.no_grad():
            gx, gimg = tb(t(x), t(img), t(ws), force_fp32=False,
                          noise_mode='const')
        wx, wimg = jax.jit(lambda *a: jb(*a, force_fp32=False,
                                         noise_mode='const'))(p, x, img, ws)
        assert gx.dtype == torch.bfloat16 and gimg.dtype == torch.float32
        _close(gx, wx, 6, 'block x')
        _close(gimg, wimg, 4, 'block img')
        return
    jg, p, tg = _pair(jnn.Generator, tnn.Generator, rng, 16, 25, 32, 32, 12,
                      channel_base=256, channel_max=32)
    assert [getattr(tg.synthesis, f'b{r}').use_fp16 for r in
            tg.synthesis.block_resolutions] == [False, True, True, True]
    ws = rng.randn(2, tg.num_ws, 32).astype(np.float32)
    with torch.no_grad():
        got = tg.synthesis(t(ws), noise_mode='const', force_fp32=False)
        fp32 = tg.synthesis(t(ws), noise_mode='const')
    want = jax.jit(lambda p, ws: jg.synthesis(
        p, ws, noise_mode='const', force_fp32=False))(p['synthesis'], ws)
    _close(got, want, 8, 'synthesis network')
    # the policy changes the result (bf16 is not float32) ...
    assert _gap(got, fp32)[0] > 0


@pytest.mark.parametrize('kind', ['mouth', 'blend'])
def test_cond_generator_bf16(rng, kind):
    """The flagship's two StyleUNets with force_fp32=False: the condition
    image cast to bf16 before the encoder, so the encoder and fusion
    convolutions run bf16 (JAX :144-149), then bf16 blocks above 16^2.
    About ten stacked bf16 convolutions (measured 2.7 and 3.7 U): 12 U."""
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
        got = tc.synthesis(t(x), t(ws), noise_mode='const', force_fp32=False)
    want = jax.jit(lambda p, x, ws: jc.synthesis(
        p, x, ws, noise_mode='const', force_fp32=False))(p['synthesis'], x,
                                                         ws)
    assert got.dtype == torch.float32
    _close(got, want, 12, f'StyleUNet {kind}')


@pytest.mark.parametrize('head,res', [('SuperresolutionHybrid2X', 128),
                                      ('SuperresolutionHybrid8XDC', 512)])
def test_superresolution_bf16(rng, head, res):
    """An SR head with sr_num_fp16_res=4: both blocks bf16 under
    force_fp32=False, after the float32 antialiased resize. Four bf16
    convolutions and two ToRGBs (measured 1.5-1.7 U): 8 U on the float32
    image."""
    jsr, p, tsr = _pair(getattr(jnn, head), getattr(tnn, head), rng,
                        channels=32, img_resolution=res, sr_num_fp16_res=4,
                        sr_antialias=True)
    assert tsr.block0.use_fp16 and tsr.block1.use_fp16
    rgb = rng.randn(1, 3, 64, 64).astype(np.float32)
    x = rng.randn(1, 32, 64, 64).astype(np.float32)
    ws = rng.randn(1, 14, 512).astype(np.float32)
    with torch.no_grad():
        got = tsr(t(rgb), t(x), t(ws), noise_mode='const', force_fp32=False)
    want = jax.jit(lambda *a: jsr(*a, noise_mode='const', force_fp32=False))(
        p, rgb, x, ws)
    _close(got, want, 8, head)


def test_decoder_bf16(rng):
    """decoder_bf16: the plane mean in float32, both FCs in bf16, the
    output back to float32 before the sigmoid (JAX :21-41). Two bf16
    matmuls with a softplus between (measured 1.0 U on sigma, 0.5 U on rgb
    through the sigmoid, whose slope is at most 1/4): 4 U."""
    dec = OSGDecoder(32, {'decoder_bf16': True},
                     generator=torch.Generator().manual_seed(3))
    jdec = JaxDecoder(32, {'decoder_bf16': True})
    params = to_jax_tree(dec)
    feats = rng.randn(2, 3, 500, 32).astype(np.float32)
    with torch.no_grad():
        got = dec(t(feats))
    want = jax.jit(jdec)(params, feats)
    assert got['rgb'].dtype == got['sigma'].dtype == torch.float32
    _close(got['sigma'], want['sigma'], 4, 'decoder sigma')
    _close(got['rgb'], want['rgb'], 4, 'decoder rgb')


@pytest.mark.parametrize('box', [(40, 50, 48), (90, 20, 30)])
def test_crop_and_paste_bf16(rng, box):
    """The mouth crop and paste on a bf16 image. The port resizes the bf16
    window in float32 and rounds once; JAX casts its resize weights to bf16
    and rounds after each of its two passes (measured 1.3 U): 4 U. Outside
    the window the paste leaves the canvas bit-equal. The windows lie
    inside the canvas, as gen_mouth_mask clamps them."""
    sy, sx, sz = box
    img, jimg = _bf16_input(rng.randn(4, 128, 128).astype(np.float32))
    at = [jnp.int32(i) for i in (sy, sx, sz, sz)]
    got = resample_region(img, sy, sx, sz, sz, 64, 64)
    want = jax.jit(lambda *a: jax_crop(*a, 64, 64))(jimg, *at)
    assert got.dtype == torch.bfloat16
    _close(got, want, 4, 'crop')

    patch, jpatch = _bf16_input(rng.randn(4, 64, 64).astype(np.float32))
    got = paste_resized_region(img, patch, sy, sx, sz, sz)
    want = jax.jit(jax_paste)(jimg, jpatch, *at)
    assert got.dtype == torch.bfloat16
    _close(got, want, 4, 'paste')
    outside = np.ones((128, 128), bool)
    outside[sy:sy + sz, sx:sx + sz] = False
    np.testing.assert_array_equal(_f32(got)[:, outside],
                                  _f32(img)[:, outside])


def test_k4_bf16_plain_matches_jax(rng):
    """K4 on planes stored in bf16: the layout pass permutes and casts in
    one pass, and the plain version samples the planes upcast, in float32,
    with float32 coordinates, exactly as F.grid_sample on the rounded
    planes. JAX's sample_from_planes(gather_bf16=True) rounds each weight,
    product and partial sum to bf16 (measured 1.9 U): 4 U. Both return
    float32."""
    planes = rng.randn(2, 3, 32, 64, 64).astype(np.float32)
    coords = rng.uniform(-0.6, 0.6, (2, 3000, 3)).astype(np.float32)
    planes_cl = layout_planes(t(planes), gather_bf16=True)
    assert planes_cl.dtype == torch.bfloat16 and planes_cl.is_contiguous()
    assert planes_cl.shape == (2, 3, 64, 64, 32)
    np.testing.assert_array_equal(
        _f32(planes_cl), _f32(t(planes).to(torch.bfloat16).permute(
            0, 1, 3, 4, 2)))
    got = sample_from_planes(t(planes), t(coords), 1.0, gather_bf16=True)
    assert got.dtype == torch.float32
    exact = triplane.triplane_sample_plain(planes_cl.float(), t(coords), 1.0)
    torch.testing.assert_close(got, exact, rtol=0, atol=0)
    want = jax.jit(lambda p, c: jax_sample(p, c, 1.0, gather_bf16=True))(
        planes, coords)
    assert want.dtype == jnp.float32
    _close(got, want, 4, 'K4 bf16')
    assert triplane.triplane_sample.launches_bf16 == 0


def test_k4_bf16_plain_is_differentiable(rng):
    """On CPU tensors the bf16 planes stay differentiable (the card's bf16
    instance raises under grad mode; tests/test_torch_cuda.py): the
    planes' gradient through the bf16 layout is the float32 one's up to
    the bf16 rounding of the samples it is taken at (measured 1.1 U):
    4 U."""
    planes = t(rng.randn(1, 3, 32, 16, 16).astype(np.float32))
    coords = t(rng.uniform(-0.5, 0.5, (1, 200, 3)).astype(np.float32))
    grads = []
    for bf16 in (False, True):
        p = planes.clone().requires_grad_()
        sample_from_planes(p, coords, 1.0, gather_bf16=bf16).square().sum() \
            .backward()
        grads.append(p.grad)
    assert grads[1].dtype == torch.float32
    assert float((grads[1] - grads[0]).abs().max()) > 0
    _close(grads[1], grads[0], 4, 'K4 bf16 gradient')


# --------------------------------------------------------------- the slice

RK_REF = dict(ray_start=2.25, ray_end=3.3, box_warp=1.0, depth_resolution=8,
              depth_resolution_importance=8, disparity_space_sampling=False,
              clamp_mode='softplus', c_gen_conditioning_zero=True,
              c_scale=1.0, superresolution_module='SuperresolutionHybrid2X',
              superresolution_noise_mode='none', sr_antialias=True)
CFG_BF16 = dict(CFG, sr_num_fp16_res=4)


def _camera(batch, yaw=0.2, pitch=-0.05):
    cam = camera_utils.lookat_pose(math.pi / 2 + yaw, math.pi / 2 + pitch,
                                   jnp.asarray([0, 0, 0.2]), radius=2.7,
                                   batch_size=batch)
    K = camera_utils.fov_to_intrinsics(18.837)
    return np.concatenate([np.asarray(cam).reshape(batch, 16),
                           np.tile(K.reshape(1, 9), (batch, 1))],
                          1).astype(np.float32)


@pytest.fixture(scope='module')
def slices():
    """Both generators' forwards on one param tree each: the port in fp32
    and bf16, the JAX package in bf16 (jitted once a generator). The port
    runs on one torch thread, as ``one_thread`` explains."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _slices()
    finally:
        torch.set_num_threads(threads)


def _slices():
    mesh, lms = synthetic_head()
    rng = np.random.RandomState(5)
    v = np.concatenate([mesh.verts, lms])[None].astype(np.float32)
    jitter = np.random.RandomState(EXPRESSION_SEED).randn(*v.shape)
    v = np.concatenate([v, v + jitter.astype(np.float32) * 0.002])
    c = _camera(2)
    z = rng.randn(2, 64).astype(np.float32)
    out = {}
    for name, port_cls, jax_cls, vv, kw in (
            ('flagship', TriPlaneGenerator, JaxGenerator, v,
             dict(rasterizer_impl='scatter', rasterizer_patch=16)),
            ('texture', TriPlaneTextureGenerator, JaxTextureGenerator,
             v[:, :5023], {})):
        seed = torch.Generator().manual_seed(0)
        port32 = port_cls(topology_path=mesh, generator=seed,
                          **CFG_BF16).eval()
        params = _liven_w_avg(to_jax_tree(port32), rng)
        load_jax_params(port32, params)
        port = port_cls(topology_path=mesh, force_fp32=False,
                        **CFG_BF16).eval()
        load_jax_params(port, params)          # strict
        jg = jax_cls(topology_path=mesh, force_fp32=False, **kw, **CFG_BF16)
        with torch.no_grad():
            ws = port.mapping(t(z), t(c), truncation_psi=0.7,
                              truncation_cutoff=14)
            got = port.synthesis(ws, t(c), t(vv), noise_mode='const')
            fp32 = port32.synthesis(ws, t(c), t(vv), noise_mode='const')

        def forward(p, z, c, v, jg=jg):
            ws = jg.mapping(p, z, c, truncation_psi=0.7,
                            truncation_cutoff=14)
            return jg.synthesis(p, ws, c, v, noise_mode='const')

        want = jax.jit(forward)(params, z, c, vv)
        out[name] = dict(port=port, jax=jg, ws=ws, z=z, c=c, v=vv, got=got,
                         fp32=fp32, want=want, params=params)
    return out


@pytest.mark.usefixtures('one_thread')
@pytest.mark.parametrize('name', ['flagship', 'texture'])
def test_slice_bf16_matches_jax(slices, name):
    """Port-bf16 against JAX-bf16, each rounding in its own places.
    Measured: the image 2.8 U (flagship) and 3.6 U (texture) of its scale,
    the depth 0.4 U, image_raw 0.018 of its scale of 1 (4.6 U: the volume
    render integrates the bf16 decoder's sigma). Bounds: 12 U of the
    image, 4 U of the depth, 0.025 on image_raw."""
    s = slices[name]
    for key, shape in (('image', (2, 3, 128, 128)),
                       ('image_raw', (2, 3, 64, 64)),
                       ('image_depth', (2, 1, 64, 64))):
        assert tuple(s['got'][key].shape) == shape
        assert s['got'][key].dtype == torch.float32
        assert np.isfinite(_f32(s['got'][key])).all()
    _close(s['got']['image'], s['want']['image'], 12, f'{name} image')
    _close(s['got']['image_depth'], s['want']['image_depth'], 4,
           f'{name} depth')
    raw, _ = _gap(s['got']['image_raw'], s['want']['image_raw'])
    print(f'{name} image_raw: max-abs {raw:.4g}')
    assert raw <= 0.025
    # every parameter stays float32 under the policy
    assert all(p.dtype == torch.float32 for p in s['port'].parameters())


@pytest.mark.parametrize('name', ['flagship', 'texture'])
def test_slice_bf16_loses_no_more_than_jax(slices, name):
    """Port-bf16 against port-fp32, beside JAX-bf16 against fp32: the
    port's bf16 forward loses no more than the JAX package's own (PSNR
    within 1 dB, max-abs within 2x), on image and image_raw. JAX's fp32
    forward is the port's within 2e-3 (tests/test_torch_generator.py), so
    the port's fp32 output stands for it."""
    s = slices[name]
    for key in ('image', 'image_raw'):
        port_gap, _ = _gap(s['got'][key], s['fp32'][key])
        jax_gap, _ = _gap(s['want'][key], s['fp32'][key])
        port_psnr = _psnr(s['got'][key], s['fp32'][key])
        jax_psnr = _psnr(s['want'][key], s['fp32'][key])
        print(f'{name} {key}: port-bf16 vs fp32 {port_gap:.4g} / '
              f'{port_psnr:.2f} dB, JAX-bf16 {jax_gap:.4g} / '
              f'{jax_psnr:.2f} dB')
        assert 0 < port_gap <= 2 * jax_gap
        assert port_psnr >= jax_psnr - 1.0


@pytest.mark.usefixtures('one_thread')
def test_identity_cached_bf16_matches_synthesis(slices):
    """reenact's per-frame path in bf16: synthesis_from_identity on the
    bf16 identity equals the bf16 synthesis (the same ops in the same
    order)."""
    s = slices['flagship']
    port, ws, c, v = s['port'], s['ws'], t(s['c']), t(s['v'])
    with torch.no_grad():
        textures, static = port.build_identity(ws, noise_mode='const')
        got = port.synthesis_from_identity(ws, textures, static, c, v,
                                           noise_mode='const')
    for key in got:
        torch.testing.assert_close(got[key], s['got'][key], rtol=0, atol=0)


@pytest.mark.usefixtures('one_thread')
def test_sample_paths_bf16(slices):
    """sample_with_planes and sample under force_fp32=False: the decoder
    reads planes stored in bf16 and returns float32. On the port's bf16
    planes the JAX package's sample_with_planes agrees within 8 U of each
    output's scale (K4's sums, 1.9 U apart, feed the bf16 decoder, 1.0 U
    apart; measured 1.7 U on sigma and 3.3 U on rgb). ``sample``
    (mapping, the plane build and the same decoding) gives the same
    numbers."""
    s = slices['flagship']
    port, jg = s['port'], s['jax']
    rng = np.random.RandomState(7)
    coords = rng.uniform(-0.5, 0.5, (2, 700, 3)).astype(np.float32)
    dirs = np.zeros_like(coords)
    with torch.no_grad():
        planes, _ = port.build_planes(s['ws'], t(s['v']), noise_mode='const')
        got = port.sample_with_planes(planes, t(coords), t(dirs))
        sampled = port.sample(t(coords), t(dirs), t(s['z']), t(s['c']),
                              t(s['v']), truncation_psi=0.7,
                              truncation_cutoff=14, noise_mode='const')
    want = jax.jit(lambda *a: jg.sample_with_planes(s['params'], *a))(
        n(planes), coords, dirs)
    for key in got:
        assert got[key].dtype == torch.float32
        torch.testing.assert_close(sampled[key], got[key], rtol=0, atol=0)
        _close(got[key], want[key], 8, f'sample_with_planes {key}')


@pytest.mark.usefixtures('one_thread')
def test_bf16_within_fp32_bounds_at_the_jax_bound_config():
    """tests/test_bf16_parity.py's bounds, at its configuration (SR
    float32, 64^2 planes, channel_base 1024, channel_max 64, conditioning
    zeroed, w_avg 0, neural rendering at 32^2), on the synthetic head with
    the port's init of seed 0 (the JAX init's distributions): the port's
    bf16 forward within image max-abs 0.05 and PSNR 45 dB, image_raw 0.02
    and 55 dB, of its fp32 forward."""
    mesh, lms = synthetic_head()
    kw = dict(z_dim=64, c_dim=25, w_dim=512, img_resolution=128,
              img_channels=3, plane_resolution=64, channel_base=1024,
              channel_max=64, rendering_kwargs=RK_REF)
    G32 = TriPlaneGenerator(topology_path=mesh, **kw,
                            generator=torch.Generator().manual_seed(0))
    Gbf = TriPlaneGenerator(topology_path=mesh, force_fp32=False, **kw)
    Gbf.load_state_dict(G32.state_dict())
    v = np.concatenate([mesh.verts, lms], 0)[None].astype(np.float32)
    c = _camera(1, yaw=0.0, pitch=0.0)
    z = np.random.RandomState(1).randn(1, 64).astype(np.float32)
    with torch.no_grad():
        out = {G.force_fp32: G.eval()(t(z), t(c), t(v), noise_mode='const',
                                      neural_rendering_resolution=32)
               for G in (G32, Gbf)}
    for key, (max_abs, min_psnr) in {'image': (0.05, 45.0),
                                     'image_raw': (0.02, 55.0)}.items():
        gap, _ = _gap(out[False][key], out[True][key])
        psnr = _psnr(out[False][key], out[True][key])
        print(f'{key}: max-abs {gap:.4g}, PSNR {psnr:.2f} dB')
        assert np.isfinite(_f32(out[False][key])).all()
        assert gap <= max_abs and psnr >= min_psnr, key
