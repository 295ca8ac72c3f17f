"""The rasterizer selection of the port against the JAX package's:

- the dispatch of render/rasterizer.py rasterize_uv_with_alpha and
  rasterize_with_attributes, for every ``impl`` at image sizes that are
  multiples of 16 and not of 32 (48, 80), of 8 only (72) and of 32 (96),
  with JAX's 'auto' as on its accelerator (binned at a multiple of 32);
- the generators' construction-time check (JAX
  next3d_tpu/models/triplane_next3d.py:165-236): at ``plane_resolution``
  64, 96, 128, 256 and 1024 both packages' flagship and texture variant end
  with the same ``rasterizer_impl`` and ``rasterizer_tile_capacity``, or
  both raise; at 1024 'auto' falls back to 'tiled' (the port raised there);
- one forward of the flagship with 'tiled' at 128^2 planes against JAX's
  'tiled' on the same parameters, within the fp32 gate of ROADMAP.md
  (max-abs 2e-3, mean-abs 1e-4 on image and image_raw); the texture
  variant's runs in tests/test_torch_raster_tiled.py.

The JAX side runs on the CPU, its forwards under jax.jit."""

import math
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import next3d_tpu.ops.pallas_raster as jax_pallas
import next3d_tpu.render.rasterizer as jax_raster
import next3d_tpu_torch.render.rasterizer as port_raster
from next3d_tpu.models import TriPlaneGenerator as JaxGenerator
from next3d_tpu.models import TriPlaneTextureGenerator as JaxTexture
from next3d_tpu.render import camera_utils
from next3d_tpu_torch.models.triplane_next3d import TriPlaneGenerator
from next3d_tpu_torch.models.triplane_texture import TriPlaneTextureGenerator
from next3d_tpu_torch.render.rasterizer import IMPLS, select_impl
from next3d_tpu_torch.utils.synthetic_head import synthetic_head
from next3d_tpu_torch.utils.weights import load_jax_params

from test_torch_generator import _liven_w_avg
from torch_parity import n, t, to_jax_tree
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)


class _Reached(Exception):
    """Raised by a stand-in rasterizer: which one a call reached, with the
    options it was given."""

    def __init__(self, label, options):
        super().__init__(label)
        self.label, self.options = label, options


def _stand_in(label):
    def reached(*args, **kwargs):
        if label == 'K5':
            options = {'patch': kwargs.get('patch', args[3:4] or None)}
            if isinstance(options['patch'], tuple):
                options['patch'] = options['patch'][0]
        elif label == 'tiled':
            options = {'capacity': kwargs.get('capacity')}
        elif label == 'scatter':
            options = {'patch': kwargs.get('patch'),
                       'face_chunk': kwargs.get('face_chunk')}
        else:
            options = {}
        raise _Reached(label, options)
    return reached


def _reached(fn, *args, **kwargs):
    with pytest.raises(_Reached) as e:
        fn(*args, **kwargs)
    return e.value.label, e.value.options


@pytest.mark.parametrize('size', [48, 72, 80, 96])
@pytest.mark.parametrize('impl', IMPLS)
@pytest.mark.parametrize('attributes', [False, True], ids=['uv', 'attrs'])
def test_dispatch_matches_jax(monkeypatch, size, impl, attributes):
    """Each call reaches the same rasterizer with the same options in both
    packages: K1 / K2 / K3 / K5 stand for the JAX Pallas kernels and the
    port's CUDA kernels."""
    port = {'K1': 'rasterize_binned_uv', 'K2': 'rasterize_binned',
            'K3': 'rasterize_binned_uv16', 'K5': 'rasterize_zbuffer',
            'tiled': 'rasterize_mesh_tiled', 'scatter': 'rasterize_mesh'}
    jax_kernels = {'K1': 'rasterize_mesh_pallas_binned_uv',
                   'K2': 'rasterize_mesh_pallas_binned',
                   'K3': 'rasterize_mesh_pallas_binned_uv16',
                   'K5': 'rasterize_mesh_pallas'}
    for label, name in port.items():
        monkeypatch.setattr(port_raster, name, _stand_in(label))
    for label, name in jax_kernels.items():
        monkeypatch.setattr(jax_pallas, name, _stand_in(label))
    for label in ('tiled', 'scatter'):
        monkeypatch.setattr(jax_raster, port[label], _stand_in(label))
    # JAX's 'auto' as on its accelerator
    monkeypatch.setattr(jax, 'devices',
                        lambda *a, **k: [types.SimpleNamespace(platform='tpu')])

    verts = np.zeros((1, 3, 3), np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    attrs = np.zeros((1, 1, 3, 3 if attributes else 2), np.float32)
    fn = 'rasterize_with_attributes' if attributes \
        else 'rasterize_uv_with_alpha'
    kw = dict(patch=20, face_chunk=300, impl=impl, tile_capacity=99)
    got = _reached(getattr(port_raster, fn), t(verts), t(faces), t(attrs),
                   size, **kw)
    want = _reached(getattr(jax_raster, fn), jnp.asarray(verts),
                    jnp.asarray(faces), jnp.asarray(attrs), size, **kw)
    print(f'{fn}(impl={impl!r}) at {size}: {got}')
    assert got == want
    label = {'pallas_binned': 'K2' if attributes else 'K1',
             'pallas_binned16': 'K3', 'pallas': 'K5', 'tiled': 'tiled',
             'scatter': 'scatter'}[select_impl(impl, size, attributes)]
    assert got[0] == label


def test_select_impl_raises_for_an_unknown_name():
    with pytest.raises(ValueError, match='unknown rasterizer impl'):
        select_impl('binned', 256)


SMALL = dict(z_dim=16, c_dim=25, w_dim=32, img_resolution=128,
             img_channels=3, channel_base=2048, channel_max=8,
             rendering_kwargs=dict(
                 superresolution_module='SuperresolutionHybrid2X'))
IMPL_NAMES = ('auto', 'pallas_binned', 'pallas_binned16', 'tiled', 'scatter',
              'pallas')


def _selection(make):
    """(rasterizer_impl, rasterizer_tile_capacity) after construction, or
    the first words of the ValueError it raises."""
    try:
        G = make()
    except ValueError as e:
        return 'raise', str(e).split(':')[0]
    return G.rasterizer_impl, G.rasterizer_tile_capacity


@pytest.mark.parametrize('impl', IMPL_NAMES)
@pytest.mark.parametrize('resolution', [64, 128, 256, 1024])
@pytest.mark.parametrize('texture', [False, True],
                         ids=['flagship', 'texture'])
def test_selection_matches_jax(resolution, impl, texture):
    mesh, _ = synthetic_head()
    jax_cls, port_cls = ((JaxTexture, TriPlaneTextureGenerator) if texture
                         else (JaxGenerator, TriPlaneGenerator))
    kw = dict(topology_path=mesh, rasterizer_impl=impl,
              plane_resolution=resolution, **SMALL)
    want = _selection(lambda: jax_cls(**kw))
    got = _selection(lambda: port_cls(**kw))
    print(f'{port_cls.__name__} {impl!r} at {resolution}: {got}')
    assert got == want


@pytest.fixture(scope='module')
def built_64():
    mesh, _ = synthetic_head()
    return (mesh, JaxGenerator(topology_path=mesh, plane_resolution=64,
                               **SMALL),
            TriPlaneGenerator(topology_path=mesh, plane_resolution=64,
                              **SMALL))


@pytest.mark.parametrize('impl', IMPL_NAMES)
def test_selection_matches_jax_at_96(built_64, impl):
    """At 96 (a multiple of 32 whose 32-px segments overflow MAX_SEG) the
    StyleGAN2 backbones of both packages take only powers of two, so the
    check runs alone, on each package's view rotations and faces: 'auto'
    becomes 'tiled', 'pallas_binned' and 'pallas_binned16' raise."""
    mesh, jg, port = built_64

    def run(cls, G):
        ns = types.SimpleNamespace(
            view_tforms=G.view_tforms, faces=G.faces, uv_resolution=96,
            rasterizer_impl=impl, rasterizer_tile_capacity=448,
            rasterizer_patch=32)
        return _selection(lambda: (cls._validate_rasterizer_capacity(
            ns, mesh.verts), ns)[1])

    got, want = run(TriPlaneGenerator, port), run(JaxGenerator, jg)
    print(f'{impl!r} at 96: {got}')
    assert got == want
    if impl == 'auto':
        assert got == ('tiled', 448)


def test_auto_falls_back_to_tiled_at_1024():
    """The fault this closes: the neutral head's largest face spans
    27.4 px at 1024^2, above 80% of the binned kernels' 32-px tile. JAX's
    'auto' falls back to 'tiled' there with capacity max(448, 96 / 4); the
    port raised ValueError. Both generators now fall back, and the
    rasterize step selects 'tiled' at that size."""
    mesh, _ = synthetic_head()
    for cls in (TriPlaneGenerator, TriPlaneTextureGenerator):
        G = cls(topology_path=mesh, plane_resolution=1024, **SMALL)
        assert (G.rasterizer_impl, G.rasterizer_tile_capacity) == \
            ('tiled', 448)
        assert select_impl(G.rasterizer_impl, 1024) == 'tiled'


def test_build_generator_keeps_the_face_chunk():
    """A JAX config's ``rasterizer_face_chunk`` (__graft_entry__.py sets
    9976) reaches the generator built from it, as in the JAX package; the
    port dropped it."""
    from next3d_tpu.cli import common as jax_common
    from next3d_tpu_torch.cli import common
    mesh, _ = synthetic_head()
    kw = dict(SMALL, plane_resolution=64, rasterizer_face_chunk=9976,
              rasterizer_patch=12)
    port = common.build_generator_from_kwargs(kw, mesh, device='cpu')
    jg = jax_common.build_generator_from_kwargs(kw, mesh)
    assert port.rasterizer_face_chunk == jg.rasterizer_face_chunk == 9976
    assert port.rasterizer_patch == jg.rasterizer_patch == 12


RK = dict(ray_start=2.25, ray_end=3.3, box_warp=1.0, depth_resolution=8,
          depth_resolution_importance=8, disparity_space_sampling=False,
          clamp_mode='softplus', c_gen_conditioning_zero=False, c_scale=1.0,
          superresolution_module='SuperresolutionHybrid2X',
          superresolution_noise_mode='none', sr_antialias=True)
CFG = dict(z_dim=32, c_dim=25, w_dim=512, img_resolution=128, img_channels=3,
           rendering_kwargs=RK, channel_base=1024, channel_max=16,
           plane_resolution=128)


def assert_tiled_forward_matches_jax(texture):
    """'tiled' end to end at 128^2 planes in the flagship or the texture
    variant: the same pix_to_face as JAX's 'tiled' (bit for bit, so no
    expression seed is chosen), then the gate on image and image_raw."""
    mesh, lms = synthetic_head()
    jax_cls, port_cls = ((JaxTexture, TriPlaneTextureGenerator) if texture
                         else (JaxGenerator, TriPlaneGenerator))
    port = port_cls(topology_path=mesh, rasterizer_impl='tiled',
                    generator=torch.Generator().manual_seed(0), **CFG).eval()
    params = _liven_w_avg(to_jax_tree(port), np.random.RandomState(1))
    load_jax_params(port, params)
    jg = jax_cls(topology_path=mesh, rasterizer_impl='tiled', **CFG)
    assert port.rasterizer_impl == jg.rasterizer_impl == 'tiled'

    rng = np.random.RandomState(2)
    v = mesh.verts if texture else np.concatenate([mesh.verts, lms])
    v = v[None].astype(np.float32)
    v = np.concatenate([v, v + rng.randn(*v.shape).astype(np.float32)
                        * 0.002])
    cam = camera_utils.lookat_pose(math.pi / 2 + 0.2, math.pi / 2 - 0.05,
                                   jnp.asarray([0, 0, 0.2]), radius=2.7,
                                   batch_size=2)
    K = camera_utils.fov_to_intrinsics(18.837)
    c = np.concatenate([np.asarray(cam).reshape(2, 16),
                        np.tile(K.reshape(1, 9), (2, 1))], 1).astype(
                            np.float32)
    z = rng.randn(2, 32).astype(np.float32)
    with torch.no_grad():
        got = port(t(z), t(c), t(v), truncation_psi=0.7,
                   truncation_cutoff=14, noise_mode='const')

    def forward(p, z, c, v):
        ws = jg.mapping(p, z, c, truncation_psi=0.7, truncation_cutoff=14)
        return jg.synthesis(p, ws, c, v, noise_mode='const')

    want = jax.jit(forward)(params, z, c, v)
    for key, shape in (('image', (2, 3, 128, 128)),
                       ('image_raw', (2, 3, 64, 64))):
        a, b = n(got[key]), n(want[key])
        assert a.shape == b.shape == shape
        err = np.abs(a - b)
        print(f'{key}: max-abs {err.max():.3g} mean-abs {err.mean():.3g}')
        assert np.isfinite(a).all()
        assert err.max() <= 2e-3 and err.mean() <= 1e-4, key


def test_tiled_forward_matches_jax():
    """The flagship; tests/test_torch_raster_tiled.py runs the texture
    variant."""
    assert_tiled_forward_matches_jax(texture=False)
