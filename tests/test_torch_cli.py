"""The port's copies behind its inference CLIs (next3d_tpu_torch/cli/ and
the utils and render modules they use) against their JAX originals, on the
same inputs, on the CPU: equal arrays, equal bytes, or equal pixels once
an imaging library decodes both files. camera_label is held to 1e-6
(float32 camera math in torch against XLA)."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from next3d_tpu.cli import common as jax_common
from next3d_tpu.cli import reenact as jax_reenact
from next3d_tpu.render import shape_utils as jax_shape_utils
from next3d_tpu.utils import checkpoint as jax_checkpoint
from next3d_tpu.utils import obj_io as jax_obj_io
from next3d_tpu.utils import pkl_import as jax_pkl_import
from next3d_tpu.utils import video as jax_video
from next3d_tpu_torch.cli import common
from next3d_tpu_torch.cli import reenact
from next3d_tpu_torch.render import shape_utils
from next3d_tpu_torch.utils import checkpoint, obj_io, video, weights
from next3d_tpu_torch.utils.png import write_png
from next3d_tpu_torch.utils.synthetic_head import save_head, synthetic_head

# tests/test_cli_snapshot.py's generator, with the knobs that
# build_generator_from_kwargs filters or maps
G_KWARGS = dict(
    z_dim=64, c_dim=25, w_dim=512, img_resolution=128, img_channels=3,
    channel_base=2048, channel_max=64, rasterizer_face_chunk=1024,
    class_name='training.triplane.TriPlaneGenerator', num_fp16_res=0,
    sr_kwargs=dict(channel_base=2048, channel_max=64,
                   fused_modconv_default='inference_only'),
    rendering_kwargs=dict(
        ray_start=2.25, ray_end=3.3, box_warp=1.0, depth_resolution=8,
        depth_resolution_importance=8, disparity_space_sampling=False,
        clamp_mode='softplus', c_gen_conditioning_zero=True, c_scale=1.0,
        superresolution_module='SuperresolutionHybrid2X',
        superresolution_noise_mode='none', sr_antialias=True))


def _decoded(path):
    return np.asarray(Image.open(path))


def _hide_video_libraries(monkeypatch):
    """Make ``import imageio`` and ``import cv2`` fail, so that both video
    writers fall back to PNG frames."""
    import sys
    for name in ('imageio', 'cv2'):
        monkeypatch.setitem(sys.modules, name, None)


@pytest.mark.parametrize('spec', ['0-3', '166', '1,2,5-7', '10-10,3',
                                  (4, 2)])
def test_parse_range_matches_jax(spec):
    assert common.parse_range(spec) == jax_common.parse_range(spec)


@pytest.mark.parametrize('yaw,pitch,fov', [(0, 0, 18.837), (0.4, 0, 18.837),
                                           (-0.35, 0.25, 12.0)])
def test_camera_label_matches_jax(yaw, pitch, fov):
    got = common.camera_label(yaw, pitch, fov=fov)
    want = jax_common.camera_label(yaw, pitch, fov=fov)
    assert got.shape == want.shape == (1, 25)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_smooth_cameras_matches_jax(rng):
    cs = rng.randn(7, 25).astype(np.float32)
    for window in (1, 3):
        np.testing.assert_array_equal(
            reenact.smooth_cameras(cs, window),
            jax_reenact.smooth_cameras(cs, window))


def _drive_dir(root, n=3):
    """A driving directory of ``n`` jittered frames of the head and their
    camera labels (tests/test_cli_snapshot.py's layout), written in an
    order its labels do not follow, with one label whose files are
    missing."""
    mesh, lms = synthetic_head()
    rng = np.random.RandomState(3)
    os.makedirs(root, exist_ok=True)
    labels = []
    for i in reversed(range(n)):
        stem = f'frame{i:03d}'
        verts = mesh.verts + rng.randn(*mesh.verts.shape).astype(
            np.float32) * 0.002
        save_head(os.path.join(root, stem + '.obj'),
                  mesh._replace(verts=verts), lms + 0.01 * i)
        labels.append([f'{stem}.png',
                       jax_common.camera_label(0.05 * i, 0.0)[0].tolist()])
    labels.append(['absent.png', labels[0][1]])
    with open(os.path.join(root, 'dataset.json'), 'w') as f:
        json.dump({'labels': labels}, f)
    return root


def test_load_driving_sequence_matches_jax(tmp_path):
    root = _drive_dir(str(tmp_path / 'drive'))
    got = reenact.load_driving_sequence(root)
    want = jax_reenact.load_driving_sequence(root)
    assert got[0].shape == (3, 25) and got[1].shape == (3, 5023 + 68, 3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_head_writer_reads_back_through_both_readers(tmp_path):
    """save_head writes the head so that the JAX package's readers and the
    port's give back its arrays bit for bit, and load_obj_verts its
    vertices."""
    mesh, lms = synthetic_head()
    obj, lms_path = save_head(str(tmp_path / 'head.obj'))
    assert lms_path == str(tmp_path / 'head_kpt2d.txt')
    for reader in (obj_io, jax_obj_io):
        got = reader.load_obj(obj)
        for a, b in zip(got, mesh):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(reader.load_lms(lms_path), lms)
        np.testing.assert_array_equal(reader.load_obj_verts(obj), mesh.verts)
    np.testing.assert_array_equal(common.load_demo_verts(obj, lms_path),
                                  jax_common.load_demo_verts(obj, lms_path))


@pytest.mark.parametrize('n,origin,length', [(5, (0, 0, 0), 2.0),
                                             (8, (0.1, -0.2, 0.3), 1.0)])
def test_create_samples_matches_jax(n, origin, length):
    got = shape_utils.create_samples(n, origin, length)
    want = jax_shape_utils.create_samples(n, origin, length)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _volume(n=12):
    """A smooth level set at 10 through an n^3 grid: a ball of sigma."""
    g = np.linspace(-1, 1, n)
    x, y, z = np.meshgrid(g, g, g, indexing='ij')
    return (20.0 * (1.0 - (x ** 2 + 1.3 * y ** 2 + 0.8 * z ** 2))
            + np.sin(5 * x)).astype(np.float32)


def test_save_mrc_bytes_match_jax(tmp_path):
    vol = _volume(12)
    shape_utils.save_mrc(tmp_path / 'port.mrc', vol)
    jax_shape_utils.save_mrc(tmp_path / 'jax.mrc', vol)
    got = (tmp_path / 'port.mrc').read_bytes()
    assert len(got) == 1024 + vol.nbytes
    assert got == (tmp_path / 'jax.mrc').read_bytes()


def test_marching_tetrahedra_and_ply_bytes_match_jax(tmp_path):
    vol = _volume(12)
    verts, faces = shape_utils.marching_tetrahedra(vol, level=10.0)
    want_v, want_f = jax_shape_utils.marching_tetrahedra(vol, level=10.0)
    assert len(faces) > 100
    np.testing.assert_array_equal(verts, want_v)
    np.testing.assert_array_equal(faces, want_f)
    shape_utils.save_ply_from_sigma(tmp_path / 'port.ply', vol)
    jax_shape_utils.save_ply_from_sigma(tmp_path / 'jax.ply', vol)
    assert (tmp_path / 'port.ply').read_bytes() \
        == (tmp_path / 'jax.ply').read_bytes()


@pytest.mark.parametrize('shape', [(5, 3, 16, 24), (2, 1, 9, 7),
                                   (3, 3, 1, 1)])
def test_save_image_grid_decodes_like_jax(tmp_path, rng, shape):
    img = rng.uniform(-1.2, 1.2, shape).astype(np.float32)
    common.save_image_grid(img, tmp_path / 'port.png')
    jax_common.save_image_grid(img, tmp_path / 'jax.png')
    got, want = _decoded(tmp_path / 'port.png'), _decoded(tmp_path / 'jax.png')
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_png_writer_rejects_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError, match='uint8'):
        write_png(tmp_path / 'a.png', np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match='H, W, 3'):
        write_png(tmp_path / 'a.png', np.zeros((2, 2, 4), np.uint8))


def test_video_writer_png_fallback_decodes_like_jax(tmp_path, rng,
                                                    monkeypatch):
    _hide_video_libraries(monkeypatch)
    frames = rng.randint(0, 256, (3, 20, 30, 3)).astype(np.uint8)
    outs = []
    for module, name in ((video, 'port'), (jax_video, 'jax')):
        writer = module.VideoWriter(str(tmp_path / f'{name}.mp4'), fps=10)
        for f in frames:
            writer.append(f)
        outs.append(writer.close())
    assert outs == [str(tmp_path / 'port_frames'), str(tmp_path / 'jax_frames')]
    for i, f in enumerate(frames):
        got = _decoded(os.path.join(outs[0], f'{i:06d}.png'))
        np.testing.assert_array_equal(got, f)
        np.testing.assert_array_equal(
            got, _decoded(os.path.join(outs[1], f'{i:06d}.png')))


def test_build_generator_from_kwargs_matches_jax_tree():
    """The port's generator from a reference-style init_kwargs (with the
    knobs that the JAX filter drops or the port maps) has exactly the
    state_dict names and shapes of the JAX generator's param tree."""
    mesh, _ = synthetic_head()
    port = common.build_generator_from_kwargs(G_KWARGS, mesh, device='cpu')
    assert not port.training
    assert port.rendering_kwargs['ray_end'] == 3.3
    assert port.rendering_kwargs['avg_camera_radius'] == 2.7
    jg = jax_common.build_generator_from_kwargs(G_KWARGS, mesh)
    shapes = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32),
        jax.eval_shape(jg.init, jax.random.PRNGKey(0)))
    want = {k: tuple(v.shape) for k, v in
            jax_pkl_import.params_to_state_dict(shapes).items()}
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want


def test_state_dict_to_params_matches_jax_package():
    sd = {'a.b.weight': np.arange(6.0, dtype=np.float32).reshape(2, 3),
          'a.b.resample_filter': np.ones((4, 4), np.float32),
          'a.up_filter': np.ones(4, np.float32),
          'c': torch.tensor([1.5, 2.5])}
    got = weights.state_dict_to_params(sd)
    want = jax_pkl_import.state_dict_to_params(
        {k: np.asarray(v) for k, v in sd.items()})
    assert jax.tree_util.tree_structure(got) \
        == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, np.asarray(b))


def _assert_trees_equal(got, want):
    assert jax.tree_util.tree_structure(got) \
        == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_snapshots_round_trip_between_the_packages(tmp_path):
    """A snapshot saved by the JAX package loads in the port, and one saved
    by the port loads in the JAX package, with equal trees and kwargs; the
    port refuses a file that is neither a snapshot nor a reference network
    pickle."""
    mesh, _ = synthetic_head()
    port = common.build_generator_from_kwargs(G_KWARGS, mesh, device='cpu')
    tree = weights.state_dict_to_params(port.state_dict())
    jax_tree = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    cfg = {'G_kwargs': G_KWARGS}

    jax_checkpoint.save_snapshot(str(tmp_path / 'jax.pkl'),
                                 params_G_ema=jax_tree, config=cfg)
    params, kwargs = checkpoint.load_any_generator(str(tmp_path / 'jax.pkl'))
    _assert_trees_equal(params, tree)
    assert kwargs == G_KWARGS
    weights.load_jax_params(port, params)

    checkpoint.save_snapshot(str(tmp_path / 'port.pkl'), params_G=tree,
                             cur_nimg=12, config=cfg)
    with open(tmp_path / 'port.json') as f:
        assert json.load(f)['G_kwargs']['z_dim'] == 64
    params, kwargs = jax_checkpoint.load_any_generator(
        str(tmp_path / 'port.pkl'))
    _assert_trees_equal(params, tree)
    assert kwargs == G_KWARGS
    assert checkpoint.load_snapshot(str(tmp_path / 'port.pkl'))['cur_nimg'] \
        == jax_checkpoint.load_snapshot(str(tmp_path / 'port.pkl'))['cur_nimg']

    (tmp_path / 'other.pkl').write_bytes(b'not a snapshot')
    with pytest.raises(ValueError, match='neither a format-1 snapshot'):
        checkpoint.load_any_generator(str(tmp_path / 'other.pkl'))
