"""The slice end to end: the port's inference CLIs and sampling entry
points against the JAX package's, on the same weights and the same files,
on the CPU.

The generator is tests/test_cli_snapshot.py's (128^2 output, 2X
super-resolution, 8+8 ray samples, 256^2 planes), built by each package's
build_generator_from_kwargs, on the synthetic head written to .obj and
_kpt2d.txt files. The port runs its kernels' plain versions. The JAX side
rasterizes with its TPU path's kernel, K1
(rasterize_mesh_pallas_binned_uv), in interpret mode, put in place of the
model's rasterize_uv_with_alpha for this module's tests: its 'auto' on the
CPU is 'tiled', which the port lacks, and its exact scatter golden
interpolates (u, v) in another form than K1, which on this random init
(planes up to about 100) moved sigma by up to 2.6e-3 through the textured
planes. Each test first asserts that the port's K1 and JAX's give the same
face and the same (u, v), bit for bit, at every pixel of the expressions it
renders (the port rounds K1 in the fused form XLA compiles it into).

Bounds: sigma and rgb within max-abs 2e-3 and mean-abs 1e-4 (the fp32 gate
of ROADMAP.md); written images within 1 level of 255 and differing in
under 1% of their pixels; the .mrc sigma grid within 2e-3 * max(1, |sigma|).
Both video writers are made to write PNG frames."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from next3d_tpu.cli import common as jax_common
from next3d_tpu.models import triplane_next3d as jax_model
from next3d_tpu.ops.pallas_raster import rasterize_mesh_pallas_binned_uv
from next3d_tpu_torch.cli import common
from next3d_tpu_torch.cli.gen_samples import generate_images
from next3d_tpu_torch.cli.gen_videos import generate_video
from next3d_tpu_torch.cli.reenact import load_driving_sequence, reenact
from next3d_tpu_torch.ops.raster import rasterize_binned_uv
from next3d_tpu_torch.utils.synthetic_head import save_head
from next3d_tpu_torch.utils.weights import load_jax_params

from test_torch_cli import _drive_dir, _hide_video_libraries
from test_torch_generator import _liven_w_avg
from torch_parity import n, t, to_jax_tree

G_KWARGS = dict(
    z_dim=64, c_dim=25, w_dim=512, img_resolution=128, img_channels=3,
    channel_base=2048, channel_max=64, plane_resolution=128,
    rendering_kwargs=dict(
        ray_start=2.25, ray_end=3.3, box_warp=1.0, depth_resolution=8,
        depth_resolution_importance=8, disparity_space_sampling=False,
        clamp_mode='softplus', c_gen_conditioning_zero=True, c_scale=1.0,
        superresolution_module='SuperresolutionHybrid2X',
        superresolution_noise_mode='none', sr_antialias=True))


def _k1_interpret(verts, faces, uv_attrs, image_size, **_):
    """JAX's rasterize_uv_with_alpha as its 'pallas_binned' path computes
    it, with the kernel in interpret mode."""
    pix_to_face, u, v = rasterize_mesh_pallas_binned_uv(
        verts, faces, uv_attrs, image_size, 4096, True)
    return jnp.stack([u, v, (pix_to_face >= 0).astype(u.dtype)], axis=1)


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_model, 'rasterize_uv_with_alpha', _k1_interpret)
    root = tmp_path_factory.mktemp('cli')
    obj, lms = save_head(str(root / 'head.obj'))
    torch.manual_seed(0)
    port = common.build_generator_from_kwargs(G_KWARGS, obj, device='cpu')
    params = _liven_w_avg(to_jax_tree(port), np.random.RandomState(5))
    load_jax_params(port, params)
    jg = jax_common.build_generator_from_kwargs(G_KWARGS, obj)
    # JAX's extract_shape builds its planes eagerly, op by op: one compiled
    # program instead (the same computation)
    jg.build_planes = jax.jit(jg.build_planes,
                              static_argnames=('noise_mode',))
    yield dict(root=root, obj=obj, lms=lms, port=port, jg=jg,
               params=params, v=common.load_demo_verts(obj, lms))
    patch.undo()


def _assert_same_visibility(pair, v):
    """The port's K1 and JAX's pick the same face, with the same (u, v), at
    every pixel of the 4 views of each expression in ``v``
    (N, 5023 + 68, 3)."""
    port = pair['port']
    with torch.no_grad():
        tv, _ = port.project_views(t(v[:, :5023]), t(v[:, 5023:]))
        got = rasterize_binned_uv(tv, port.faces, port.face_uv[None],
                                  port.uv_resolution)
    want = rasterize_mesh_pallas_binned_uv(
        jnp.asarray(n(tv)), jnp.asarray(n(port.faces)),
        jnp.asarray(n(port.face_uv[None])), port.uv_resolution, 4096, True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(n(a), np.asarray(b))


def _assert_gate(got, want):
    for key in ('sigma', 'rgb'):
        a, b = n(got[key]), n(want[key])
        assert a.shape == b.shape
        err = np.abs(a - b)
        print(f'{key}: max-abs {err.max():.3g} mean-abs {err.mean():.3g}')
        assert err.max() <= 2e-3 and err.mean() <= 1e-4, key


def _assert_images_close(got_path, want_path):
    a = np.asarray(Image.open(got_path)).astype(np.int16)
    b = np.asarray(Image.open(want_path)).astype(np.int16)
    assert a.shape == b.shape
    differ = a != b
    print(f'{os.path.basename(got_path)}: {int(differ.sum())} of {a.size} '
          f'values differ, by at most {int(np.abs(a - b).max())}')
    assert np.abs(a - b).max() <= 1 and differ.mean() < 0.01


def _points(n_points, seed):
    rng = np.random.RandomState(seed)
    coords = rng.uniform(-0.45, 0.45, (1, n_points, 3)).astype(np.float32)
    dirs = rng.randn(1, n_points, 3).astype(np.float32)
    return coords, dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


def test_sample_entry_points_match_jax(pair):
    """sample (z, c), sample_mixed (ws) and sample_with_planes (prebuilt
    planes, in the JAX layout) at random points in the box."""
    port, jg, params, v = pair['port'], pair['jg'], pair['params'], pair['v']
    _assert_same_visibility(pair, v)
    coords, dirs = _points(4096, 0)
    z = np.random.RandomState(1).randn(1, 64).astype(np.float32)
    c = jax_common.camera_label(0.2, -0.05)
    kw = dict(truncation_psi=0.7, truncation_cutoff=14)

    @jax.jit
    def jax_sample(p, z, c, v, coords, dirs):
        ws = jg.mapping(p, z, c, **kw)
        planes, _ = jg.build_planes(p, ws, v, noise_mode='const')
        return (jg.sample(p, coords, dirs, z, c, v, noise_mode='const', **kw),
                jg.sample_mixed(p, coords, dirs, ws, v, noise_mode='const'),
                jg.sample_with_planes(p, planes, coords, dirs), ws, planes)

    want = jax_sample(params, z, c, v, coords, dirs)
    with torch.no_grad():
        got = port.sample(t(coords), t(dirs), t(z), t(c), t(v),
                          noise_mode='const', **kw)
        _assert_gate(got, want[0])
        ws = t(n(want[3]))
        _assert_gate(port.sample_mixed(t(coords), t(dirs), ws, t(v),
                                       noise_mode='const'), want[1])
        planes = t(n(want[4]))
        assert planes.shape == (1, 3, 32, 128, 128)
        _assert_gate(port.sample_with_planes(planes, t(coords), t(dirs)),
                     want[2])


def test_generate_images_matches_jax(pair, tmp_path):
    from next3d_tpu.cli.gen_samples import generate_images as jax_generate
    _assert_same_visibility(pair, pair['v'])
    args = dict(seeds=[0], shapes=True, shape_res=32, max_batch=10000,
                obj_path=pair['obj'], lms_path=pair['lms'])
    stats = generate_images(None, outdir=str(tmp_path / 'port'),
                            generator=pair['port'], device='cpu', **args)
    jax_generate(None, outdir=str(tmp_path / 'jax'), generator=pair['jg'],
                 params=pair['params'], **args)
    assert len(stats['seconds_per_seed']) == 1
    assert stats['sigma_points'] == 32 ** 3
    assert sorted(os.listdir(tmp_path / 'port')) \
        == sorted(os.listdir(tmp_path / 'jax')) \
        == ['seed0000.mrc', 'seed0000.png']
    _assert_images_close(tmp_path / 'port' / 'seed0000.png',
                         tmp_path / 'jax' / 'seed0000.png')
    got, want = (np.fromfile(tmp_path / d / 'seed0000.mrc', np.float32,
                             offset=1024) for d in ('port', 'jax'))
    assert got.shape == want.shape == (32 ** 3,)
    err = np.abs(got - want) / np.maximum(1, np.abs(want))
    print(f'sigma grid: max relative error {err.max():.3g}, sigma in '
          f'[{want.min():.3g}, {want.max():.3g}]')
    assert err.max() <= 2e-3
    assert (want == -1000).mean() > 0.3 and want.max() > -1000


def test_reenact_matches_jax(pair, tmp_path, monkeypatch):
    from next3d_tpu.cli.reenact import reenact as jax_reenact
    _hide_video_libraries(monkeypatch)
    drive = _drive_dir(str(tmp_path / 'drive'), 3)
    _assert_same_visibility(pair, load_driving_sequence(drive)[1])
    stats = reenact(None, drive, seeds=[0], outdir=str(tmp_path / 'port'),
                    topology_path=pair['obj'], generator=pair['port'],
                    device='cpu')
    jax_reenact(None, drive, seeds=[0], outdir=str(tmp_path / 'jax'),
                topology_path=pair['obj'], generator=pair['jg'],
                params=pair['params'])
    assert stats['frames'] == 3
    assert stats['seconds'] >= stats['seconds_without_writes'] > 0
    frames = [sorted(os.listdir(tmp_path / d / 'reenact_seed0000_frames'))
              for d in ('port', 'jax')]
    assert frames[0] == frames[1] == [f'{i:06d}.png' for i in range(3)]
    for name in frames[0]:
        _assert_images_close(
            tmp_path / 'port' / 'reenact_seed0000_frames' / name,
            tmp_path / 'jax' / 'reenact_seed0000_frames' / name)


def test_generate_video_matches_jax(pair, tmp_path, monkeypatch):
    """The identity-cached branch: 4 seeds in a 2x2 grid, one keyframe a
    cell, 2 frames of one batched call each."""
    from next3d_tpu.cli.gen_videos import generate_video as jax_video
    _hide_video_libraries(monkeypatch)
    _assert_same_visibility(pair, pair['v'])
    args = dict(seeds=[0, 1, 2, 3], grid='2x2', w_frames=2, fps=10,
                obj_path=pair['obj'], lms_path=pair['lms'])
    stats = generate_video(None, outdir=str(tmp_path / 'port'),
                           generator=pair['port'], device='cpu', **args)
    jax_video(None, outdir=str(tmp_path / 'jax'), generator=pair['jg'],
              params=pair['params'], **args)
    assert stats['frames'] == 2
    for i in range(2):
        name = f'interpolation_frames/{i:06d}.png'
        assert np.asarray(Image.open(tmp_path / 'port' / name)).shape \
            == (256, 256, 3)
        _assert_images_close(tmp_path / 'port' / name,
                             tmp_path / 'jax' / name)


def _option_names(text):
    import re
    return set(re.findall(r'(--[a-z][a-z0-9-]*)', text)) - {'--help'}


@pytest.mark.parametrize('command', ['gen-samples', 'gen-videos', 'reenact'])
def test_cli_options_match_jax_commands(command):
    """``python -m next3d_tpu_torch.cli.main <command> --help`` lists the
    JAX click command's options, and --device."""
    from next3d_tpu.cli.main import main as jax_main
    want = {opt for p in jax_main.commands[command].params for opt in p.opts
            if opt.startswith('--')}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, '-m', 'next3d_tpu_torch.cli.main', command,
         '--help'], capture_output=True, text=True, check=True, timeout=120,
        cwd=root).stdout
    assert _option_names(out) == want | {'--device'}
