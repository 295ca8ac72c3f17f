"""The port's EG3D family against the JAX package on the CPU: the
super-resolution heads (8X, 4X, Deepfp32, with 4X's resize-only-if-smaller
path), ``models/triplane_eg3d.py EG3DTriPlaneGenerator`` at 128^2,
``render/crosssection.py`` on the flagship, the registry's names, and the
``train`` command building G at 128^2, 256^2 and 512^2 (its 256^2 head,
``SuperresolutionHybrid4X``, was missing from the port).

Parameters come from the port's seeded init and reach JAX through the
weight bridge; the JAX side runs under ``jax.jit``. Bounds: the SR heads
and EG3D's images within 1e-5 * (1 + scale), as in tests/test_torch_nn.py;
EG3D's depth and the sigmas of ``sample_mixed`` and the cross-section
within the fp32 gate of ROADMAP.md, max-abs 2e-3 and mean-abs 1e-4, since
the volume render's sums and the textured planes (values up to about 100)
reach them through long float32 chains in two libraries' orders. The port
runs its kernels' plain versions. For the cross-section, JAX rasterizes
with its K1 in interpret mode, which the port's K1 equals bit for bit
(tests/test_torch_cli_parity.py)."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from next3d_tpu import nn as jnn
from next3d_tpu.cli import common as jax_common
from next3d_tpu.models import triplane_next3d as jax_model
from next3d_tpu.models.triplane_eg3d import \
    EG3DTriPlaneGenerator as JaxEG3D
from next3d_tpu.render import crosssection as jax_cs
from next3d_tpu_torch import nn as tnn
from next3d_tpu_torch.cli import common
from next3d_tpu_torch.cli import main as cli
from next3d_tpu_torch.cli import train as port_train
from next3d_tpu_torch.models import (EG3DTriPlaneGenerator,
                                     TriPlaneGenerator,
                                     TriPlaneTextureGenerator)
from next3d_tpu_torch.render.camera_utils import (fov_to_intrinsics,
                                                  lookat_pose)
from next3d_tpu_torch.render.crosssection import sample_cross_section
from next3d_tpu_torch.utils import registry
from next3d_tpu_torch.utils.synthetic_head import save_head
from next3d_tpu_torch.utils.weights import load_jax_params

from test_torch_cli_parity import (G_KWARGS, _assert_same_visibility,
                                   _k1_interpret)
from test_torch_generator import _liven_w_avg
from test_torch_sg3 import _close
from torch_parity import n, t, to_jax_tree
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)


def _gate(got, want):
    a, b = n(got), n(want)
    assert a.shape == b.shape
    err = np.abs(a - b)
    assert err.max() <= 2e-3 and err.mean() <= 1e-4, (err.max(), err.mean())


# --------------------------------------------------------------- SR heads
@pytest.mark.parametrize('head,res,size,out,noise', [
    ('SuperresolutionHybrid8X', 512, 64, 512, 'const'),
    ('SuperresolutionHybrid4X', 256, 64, 256, 'const'),
    ('SuperresolutionHybrid4X', 256, 160, 320, 'none'),
    ('SuperresolutionHybridDeepfp32', 256, 64, 256, 'const')])
def test_superresolution_heads_match_jax(head, res, size, out, noise):
    """The heads at their asserted resolutions with channels=32, batch 1:
    the input is resized to 128^2 (Deepfp32: never antialiased), but 4X
    keeps an input larger than 128^2 as it is, and then upsamples it 2x as
    JAX's does (no const noise: its noise maps are 128^2); a wrong
    resolution raises JAX's AssertionError."""
    rs = np.random.RandomState(size)
    kw = dict(channels=32, img_resolution=res, sr_num_fp16_res=4,
              sr_antialias=True)
    port = getattr(tnn, head)(generator=torch.Generator().manual_seed(2),
                              **kw)
    tree = to_jax_tree(port)
    for k, v in tree['block0']['conv1'].items():
        if k == 'noise_strength':
            tree['block0']['conv1'][k] = np.float32(0.2)
    load_jax_params(port, tree)
    jsr = getattr(jnn, head)(**kw)
    rgb = rs.randn(1, 3, size, size).astype(np.float32)
    x = rs.randn(1, 32, size, size).astype(np.float32)
    ws = rs.randn(1, 14, 512).astype(np.float32)
    with torch.no_grad():
        got = port(t(rgb), t(x), t(ws), noise_mode=noise)
    want = jax.jit(lambda *a: jsr(*a, noise_mode=noise))(tree, rgb, x, ws)
    assert got.shape == (1, 3, out, out)
    _close(got, want)
    assert port.sr_antialias == (head != 'SuperresolutionHybridDeepfp32')
    with pytest.raises(AssertionError):
        getattr(tnn, head)(**dict(kw, img_resolution=128))


# ------------------------------------------------------------------ EG3D
RK = dict(ray_start=2.25, ray_end=3.3, box_warp=1.0, depth_resolution=8,
          depth_resolution_importance=8, disparity_space_sampling=False,
          clamp_mode='softplus', c_gen_conditioning_zero=False, c_scale=1.0,
          superresolution_module='SuperresolutionHybrid2X',
          superresolution_noise_mode='none', sr_antialias=True)
EG3D_CFG = dict(z_dim=16, c_dim=25, w_dim=512, img_resolution=128,
                img_channels=3, rendering_kwargs=RK, channel_base=1024,
                channel_max=32)


def _cameras(n_views):
    cam = lookat_pose(math.pi / 2 + 0.2, math.pi / 2 - 0.05, [0, 0, 0.2],
                      radius=2.7, batch_size=n_views, device='cpu')
    K = fov_to_intrinsics(18.837).reshape(1, 9)
    return np.concatenate([cam.numpy().reshape(n_views, 16),
                           np.tile(K, (n_views, 1))], 1).astype(np.float32)


@pytest.fixture(scope='module')
def eg3d():
    """The port's EG3D and JAX's on one tree (w_avg non-zero), with
    latents, cameras and the port's ws at truncation 0.7."""
    port = EG3DTriPlaneGenerator(generator=torch.Generator().manual_seed(3),
                                 **EG3D_CFG).eval()
    rs = np.random.RandomState(6)
    tree = _liven_w_avg(to_jax_tree(port), rs)
    load_jax_params(port, tree)
    z = rs.randn(2, 16).astype(np.float32)
    c = _cameras(2)
    return dict(port=port, jg=JaxEG3D(**EG3D_CFG), tree=tree, z=z, c=c)


def test_eg3d_matches_jax(eg3d):
    """image, image_raw and image_depth of the forward with truncation
    (psi 0.7, cutoff 10), deterministic midpoint depths, const noise."""
    port, jg = eg3d['port'], eg3d['jg']
    kw = dict(truncation_psi=0.7, truncation_cutoff=10)
    with torch.no_grad():
        got = port(t(eg3d['z']), t(eg3d['c']), noise_mode='const', **kw)
    want = jax.jit(lambda p, z, c: jg(p, z, c, noise_mode='const', **kw))(
        eg3d['tree'], eg3d['z'], eg3d['c'])
    assert got['image'].shape == (2, 3, 128, 128)
    assert got['image_depth'].shape == (2, 1, 64, 64)
    _close(got['image'], want['image'])
    _close(got['image_raw'], want['image_raw'])
    _gate(got['image_depth'], want['image_depth'])
    depth = n(got['image_depth'])
    assert depth.min() >= 2.25 and depth.max() <= 3.3


def test_eg3d_sample_mixed_matches_jax(eg3d):
    """sigma and rgb at 2 x 500 random points in the box."""
    port, jg = eg3d['port'], eg3d['jg']
    rs = np.random.RandomState(8)
    pts = rs.uniform(-0.5, 0.5, (2, 500, 3)).astype(np.float32)
    with torch.no_grad():
        ws = port.mapping(t(eg3d['z']), t(eg3d['c']))
        got = port.sample_mixed(t(pts), t(pts), ws, noise_mode='const')
    want = jax.jit(lambda p, x, w: jg.sample_mixed(p, x, x, w,
                                                   noise_mode='const'))(
        eg3d['tree'], pts, n(ws))
    assert got['sigma'].shape == (2, 500, 1)
    _gate(got['sigma'], want['sigma'])
    _gate(got['rgb'], want['rgb'])


# --------------------------------------------------------- cross-section
class _JittedSampleMixed:
    """A JAX generator whose sample_mixed is one compiled program (JAX's
    sample_cross_section calls it eagerly, op by op)."""

    def __init__(self, G):
        self._f = jax.jit(lambda p, x, d, ws, v: G.sample_mixed(
            p, x, d, ws, v, noise_mode='const'))

    def sample_mixed(self, params, x, d, ws, v, noise_mode):
        assert noise_mode == 'const'
        return self._f(params, x, d, ws, v)


@pytest.fixture(scope='module')
def flagship(tmp_path_factory):
    """The port's flagship and JAX's at tests/test_torch_cli_parity.py's
    configuration on one tree, JAX's rasterizer swapped for its K1 in
    interpret mode, and the head's expression, at which both K1s pick the
    same face with the same (u, v) at every pixel."""
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_model, 'rasterize_uv_with_alpha', _k1_interpret)
    obj, lms = save_head(str(tmp_path_factory.mktemp('cs') / 'head.obj'))
    torch.manual_seed(0)
    port = common.build_generator_from_kwargs(G_KWARGS, obj, device='cpu')
    tree = _liven_w_avg(to_jax_tree(port), np.random.RandomState(5))
    load_jax_params(port, tree)
    jg = _JittedSampleMixed(jax_common.build_generator_from_kwargs(G_KWARGS,
                                                                   obj))
    v = common.load_demo_verts(obj, lms)
    _assert_same_visibility({'port': port}, v)
    yield port, jg, tree, v
    patch.undo()


@pytest.mark.parametrize('axis', ['y', 'z'])
def test_cross_section_matches_jax(flagship, axis):
    """sample_cross_section on the flagship at 128^2 (planes 128^2),
    resolution 32, through sample_mixed (K1 builds the planes, K4 samples
    them): sigma within the fp32 gate of JAX's on the same weights."""
    port, jg, tree, v = flagship
    z = np.random.RandomState(1).randn(1, 64).astype(np.float32)
    with torch.no_grad():
        ws = port.mapping(t(z), t(_cameras(1)), truncation_psi=0.7)
        got = sample_cross_section(port, ws, t(v), resolution=32, axis=axis)
    want = jax_cs.sample_cross_section(jg, tree, jnp.asarray(n(ws)),
                                       jnp.asarray(v), resolution=32,
                                       axis=axis)
    assert got.shape == (32, 32)
    assert float(got.std()) > 0
    _gate(got, want)


# ---------------------------------------------------------------- registry
def test_registry_names_resolve_to_the_port_classes():
    """JAX's registered names give the port's generators, on the device
    asked for; a dotted path falls back to an import; an unknown name
    raises JAX's KeyError."""
    for names, cls in (
            (('TriPlaneGenerator', 'next3d'), TriPlaneGenerator),
            (('TriPlaneTextureGenerator', 'avatar_texture'),
             TriPlaneTextureGenerator),
            (('EG3DTriPlaneGenerator', 'eg3d'), EG3DTriPlaneGenerator)):
        for name in names:
            builder = registry.resolve(name)
            assert builder.__module__ == cls.__module__, name
    G = registry.construct_class_by_name(
        'eg3d', device='cpu', **dict(EG3D_CFG, channel_max=4))
    assert type(G) is EG3DTriPlaneGenerator
    assert next(G.parameters()).device == torch.device('cpu')
    assert registry.resolve('next3d_tpu_torch.nn.superresolution.'
                            'SuperresolutionHybrid4X') \
        is tnn.SuperresolutionHybrid4X
    with pytest.raises(KeyError, match='unknown registered name'):
        registry.resolve('stylegan9')


# ------------------------------------------------ train at each resolution
@pytest.mark.parametrize('resolution', [128, 256, 512])
def test_train_builds_g_at_each_resolution(tmp_path, resolution):
    """choose_sr_module's head exists in the port, and the train command
    builds G (and D) at 128^2, 256^2 and 512^2 at narrow widths; at 256^2
    G's forward gives 256^2 images (4X resizes the 32^2 render to
    128^2)."""
    name = port_train.choose_sr_module(resolution)
    assert hasattr(tnn.superresolution, name)
    obj, _ = save_head(str(tmp_path / 'head.obj'))
    opts = vars(cli.build_parser().parse_args([
        'train', '--outdir', str(tmp_path / 'run'), '--data',
        str(tmp_path), '--resolution', str(resolution), '--cbase', '512',
        '--cmax', '8', '--plane-resolution', '64', '--topology-path', obj,
        '--neural-rendering-resolution-initial', '32', '--device', 'cpu']))
    opts.pop('command')
    G, D, G_ema, *_ = port_train.build_training(opts, torch.device('cpu'))
    assert type(G.superresolution).__name__ == name
    assert G.img_resolution == resolution
    assert D.block_resolutions[0] == resolution
    if resolution == 256:
        v = common.load_demo_verts(obj, obj[:-4] + '_kpt2d.txt')
        with torch.no_grad():
            out = G_ema(torch.randn(1, 512), t(_cameras(1)), t(v),
                        neural_rendering_resolution=32, noise_mode='const')
        assert out['image'].shape == (1, 3, 256, 256)
        assert torch.isfinite(out['image']).all()
