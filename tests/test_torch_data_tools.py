"""The port's dataset tools against the JAX package's, on the same files:
data/preprocess.py, data/image_prep.py and data/lmdb_reader.py (copies of
the JAX modules), and the commands ``dataset-tool`` and ``preprocess
{align,crop,mirror,cameras}`` of next3d_tpu_torch/cli/main.py against the
JAX CLI's click commands. The inputs are built as tests/test_image_prep.py
and tests/test_lmdb_reader.py build theirs. A folder is compared file by
file, byte for byte; a zip by its member names and member bytes (a zip's
headers carry timestamps). The port's ``dataset-tool`` output is then read
through the port's data/dataset.py."""

import io
import json
import os
import pickle
import zipfile

import numpy as np
import PIL.Image
import pytest
from click.testing import CliRunner

from next3d_tpu.cli.main import main as jax_main
from next3d_tpu.data import image_prep as jax_prep
from next3d_tpu.data import preprocess as jax_pre
from next3d_tpu.data.lmdb_reader import LMDBFormatError as JaxFormatError
from next3d_tpu.data.lmdb_reader import LMDBReader as JaxReader
from next3d_tpu_torch.cli import main as port_cli
from next3d_tpu_torch.data import image_prep as port_prep
from next3d_tpu_torch.data import preprocess as port_pre
from next3d_tpu_torch.data.dataset import ImageFolderDataset
from next3d_tpu_torch.data.lmdb_reader import LMDBFormatError, LMDBReader
from next3d_tpu_torch.utils.synthetic_head import save_dataset, synthetic_head

from test_image_prep import _face_landmarks
from test_lmdb_reader import (BIG_VALUE, PSIZE, _leaf_page, _meta_page,
                              build_env)


def _files(root):
    """{relative path: bytes} of a folder, or of a zip's members."""
    if str(root).endswith('.zip'):
        with zipfile.ZipFile(root) as zf:
            return {name: zf.read(name) for name in zf.namelist()}
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            out[os.path.relpath(path, root)] = open(path, 'rb').read()
    return out


def _jax_cli(argv):
    result = CliRunner().invoke(jax_main, argv, catch_exceptions=False)
    assert result.exit_code == 0, result.output
    return result.output


def _both(tmp_path, argv_of, make_input=None):
    """Run the JAX command and the port's on copies of one input: argv_of
    (root) gives each command's argv under its own root, where make_input
    (root) first writes the input."""
    roots = [tmp_path / 'jax', tmp_path / 'port']
    for root in roots:
        root.mkdir()
        if make_input is not None:
            make_input(root)
    _jax_cli(argv_of(roots[0]))
    port_cli.run(argv_of(roots[1]))
    return roots


def _assert_same_files(a, b):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name] == fb[name], name
    return fa


# ----------------------------------------------------------- preprocess.py

def test_preprocess_functions_match_jax():
    rng = np.random.RandomState(0)
    for _ in range(5):
        pose = np.eye(4)
        pose[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
        pose[:3, 3] = rng.randn(3) * 2
        K = rng.rand(3, 3)
        for fn in ('fix_intrinsics',):
            np.testing.assert_array_equal(getattr(port_pre, fn)(K),
                                          getattr(jax_pre, fn)(K))
        for fn in ('fix_pose_orig', 'fix_pose_cor', 'flip_yaw'):
            np.testing.assert_array_equal(getattr(port_pre, fn)(pose),
                                          getattr(jax_pre, fn)(pose))
        expr = rng.randn(50)
        for e in (None, expr):
            np.testing.assert_array_equal(
                port_pre.camera_label(pose, K, e),
                jax_pre.camera_label(pose, K, e))
    assert port_pre.FFHQ_FOCAL == jax_pre.FFHQ_FOCAL


def _cameras(root):
    rng = np.random.RandomState(1)
    cams = {}
    for i in range(3):
        pose = np.eye(4)
        pose[:3, 3] = rng.randn(3) * 3
        cams[f'img{i:02d}.png'] = {'pose': pose.reshape(-1).tolist(),
                                   'intrinsics': rng.rand(9).tolist()}
    (root / 'src').mkdir()
    (root / 'src' / 'cameras.json').write_text(json.dumps(cams))
    (root / 'out').mkdir()


@pytest.mark.parametrize('mode', ['orig', 'cor'])
def test_cameras_command_matches_jax(tmp_path, mode):
    roots = _both(tmp_path, lambda r: [
        'preprocess', 'cameras', '--source', str(r / 'src'), '--dest',
        str(r / 'out'), '--mode', mode], _cameras)
    files = _assert_same_files(roots[0] / 'out', roots[1] / 'out')
    assert len(json.loads(files['dataset.json'])['labels']) == 3


# ----------------------------------------------------------- image_prep.py

def test_image_prep_geometry_matches_jax():
    for lm in (_face_landmarks(), _face_landmarks(cx=300, cy=140,
                                                  eye_dist=60)):
        for a, b in zip(port_prep.face_quad_from_landmarks(lm),
                        jax_prep.face_quad_from_landmarks(lm)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(port_prep.extract_5p(lm),
                                      jax_prep.extract_5p(lm))
        lm5 = port_prep.extract_5p(lm)
        for a, b in zip(port_prep.pos_similarity(lm5, port_prep.LM3D_STD),
                        jax_prep.pos_similarity(lm5, jax_prep.LM3D_STD)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port_prep.LM3D_STD, jax_prep.LM3D_STD)


def _face_image(rng, size=320):
    return rng.randint(0, 255, (size, size, 3), dtype=np.uint8)


@pytest.mark.parametrize('padding', [True, False])
def test_align_face_matches_jax(padding):
    """The quad crop near the border (reflect padding and its blended
    background) and in the middle of the image."""
    rng = np.random.RandomState(2)
    img = _face_image(rng)
    for lm in (_face_landmarks(cx=80, cy=90), _face_landmarks(cx=160,
                                                              cy=150)):
        kw = dict(output_size=48, transform_size=96, enable_padding=padding)
        a = np.asarray(port_prep.align_face(img, lm, **kw))
        b = np.asarray(jax_prep.align_face(img, lm, **kw))
        assert a.shape == (48, 48, 3)
        np.testing.assert_array_equal(a, b)


def test_align_crop_resize_matches_jax():
    rng = np.random.RandomState(3)
    img = PIL.Image.fromarray(_face_image(rng, 400))
    lm = _face_landmarks(cx=210, cy=180)
    a_img, a_lm = port_prep.align_crop_resize(img, lm, target_size=256.0,
                                              center_crop_size=180,
                                              output_size=64)
    b_img, b_lm = jax_prep.align_crop_resize(img, lm, target_size=256.0,
                                             center_crop_size=180,
                                             output_size=64)
    np.testing.assert_array_equal(np.asarray(a_img), np.asarray(b_img))
    np.testing.assert_array_equal(a_lm, b_lm)


def _wild(root):
    rng = np.random.RandomState(4)
    (root / 'wild').mkdir()
    lms = {}
    for i, (cx, cy) in enumerate(((90, 100), (160, 150))):
        PIL.Image.fromarray(_face_image(rng)).save(root / 'wild' /
                                                   f'w{i}.png')
        lms[f'w{i}.png'] = _face_landmarks(cx=cx, cy=cy).tolist()
    (root / 'lms.json').write_text(json.dumps(lms))


def test_align_command_matches_jax(tmp_path):
    roots = _both(tmp_path, lambda r: [
        'preprocess', 'align', '--source', str(r / 'wild'), '--dest',
        str(r / 'aligned'), '--landmarks', str(r / 'lms.json'),
        '--output-size', '40', '--transform-size', '80'], _wild)
    files = _assert_same_files(roots[0] / 'aligned', roots[1] / 'aligned')
    assert sorted(files) == ['w0.png', 'w1.png']


def _to_crop(root):
    rng = np.random.RandomState(5)
    (root / 'in').mkdir()
    params = {}
    for i, (cx, cy) in enumerate(((300, 140), (250, 260))):
        PIL.Image.fromarray(_face_image(rng, 600)).save(root / 'in' /
                                                        f'f{i}.png')
        params[f'f{i}.png'] = dict(
            lm=_face_landmarks(cx=cx, cy=cy).tolist(),
            lm3d_std=jax_prep.LM3D_STD.tolist(), rescale_factor=300.0,
            center_crop_size=700, output_size=64)
    (root / 'params.json').write_text(json.dumps(params))


def test_crop_command_matches_jax(tmp_path):
    roots = _both(tmp_path, lambda r: [
        'preprocess', 'crop', '--indir', str(r / 'in'), '--outdir',
        str(r / 'out'), '--cropping-params', str(r / 'params.json')],
        _to_crop)
    files = _assert_same_files(roots[0] / 'out', roots[1] / 'out')
    assert sorted(files) == ['f0.png', 'f1.png']


def _to_mirror(labels):
    def make(root):
        rng = np.random.RandomState(6)
        (root / 'imgs').mkdir()
        entries = []
        for i in range(2):
            PIL.Image.fromarray(rng.randint(0, 255, (16, 16, 3), np.uint8)
                                ).save(root / 'imgs' / f'img{i}.png')
            pose = np.eye(4)
            pose[:3, 3] = rng.randn(3)
            entries.append([f'img{i}.png', np.concatenate(
                [pose.reshape(-1), rng.rand(9), rng.randn(50)]).tolist()])
        if labels:
            (root / 'imgs' / 'dataset.json').write_text(
                json.dumps({'labels': entries}))
    return make


@pytest.mark.parametrize('labels', [True, False],
                         ids=['labels', 'no-labels'])
@pytest.mark.parametrize('in_place', [True, False],
                         ids=['in-place', 'to-dest'])
def test_mirror_command_matches_jax(tmp_path, labels, in_place):
    def argv(r):
        dest = [] if in_place else ['--dest', str(r / 'out')]
        return ['preprocess', 'mirror', '--source', str(r / 'imgs')] + dest

    roots = _both(tmp_path, argv, _to_mirror(labels))
    sub = 'imgs' if in_place else 'out'
    files = _assert_same_files(roots[0] / sub, roots[1] / sub)
    assert 'img1_mirror.png' in files


# ---------------------------------------------------------- lmdb_reader.py

def test_lmdb_reader_matches_jax(tmp_path):
    env = tmp_path / 'env'
    build_env(str(env))
    with LMDBReader(str(env)) as a, JaxReader(str(env / 'data.mdb')) as b:
        assert len(a) == len(b) == 4 and a.psize == b.psize == PSIZE
        items = list(a.items())
        assert items == list(b.items())
    assert dict(items)[b'c-big'] == BIG_VALUE
    p = env / 'data.mdb'
    p.write_bytes(p.read_bytes()[:-PSIZE])       # cut the overflow short
    for reader, error in ((LMDBReader, LMDBFormatError),
                          (JaxReader, JaxFormatError)):
        with reader(str(env)) as r:
            with pytest.raises(error, match='truncated'):
                list(r.items())
    garbage = tmp_path / 'garbage.mdb'
    garbage.write_bytes(b'\x00' * 8192)
    with pytest.raises(LMDBFormatError):
        LMDBReader(str(garbage))


# ----------------------------------------------------------- dataset-tool

def _head_dataset(root, n=3, size=24):
    """A training dataset of the synthetic head (images, meshes, lms and
    labels), as utils/synthetic_head.py save_dataset writes one."""
    mesh, lms = synthetic_head()
    rng = np.random.RandomState(7)
    v = np.concatenate([mesh.verts, lms])[None] + rng.randn(
        n, len(mesh.verts) + len(lms), 3) * 0.002
    images = rng.randint(0, 255, (n, size, size, 3), np.uint8)
    labels = rng.randn(n, 25).astype(np.float32)
    return save_dataset(str(root), images, v.astype(np.float32), labels)


def _cifar(root):
    rng = np.random.RandomState(8)
    root.mkdir(exist_ok=True)
    with open(root / 'data_batch_1', 'wb') as f:
        pickle.dump({'data': rng.randint(0, 255, (5, 3072), np.uint8),
                     'labels': [0, 1, 2, 3, 4]}, f)


def _lmdb(root):
    rng = np.random.RandomState(9)
    vals = {}
    for i in range(3):
        buf = io.BytesIO()
        PIL.Image.fromarray(rng.randint(0, 255, (12, 16, 3), np.uint8)
                            ).save(buf, format='PNG')
        vals[f'{i}-key'.encode()] = buf.getvalue()
    vals[b'z-junk'] = b'not an image'
    keys = sorted(vals)
    root.mkdir(exist_ok=True)
    (root / 'data.mdb').write_bytes(
        _meta_page(0, txnid=1, psize=PSIZE, main_root=-1, main_depth=0,
                   main_entries=0, last_pg=1)
        + _meta_page(1, txnid=2, psize=PSIZE, main_root=2, main_depth=1,
                     main_entries=len(vals), last_pg=2)
        + _leaf_page(2, [(k, vals[k]) for k in keys]))


def _zipped_head(root):
    _head_dataset(root / 'src_dir')
    with zipfile.ZipFile(root / 'src.zip', 'w') as zf:
        for name, data in sorted(_files(root / 'src_dir').items()):
            zf.writestr(name, data)


SOURCES = {
    # name: (make the source under root, source, dest, extra options)
    'folder-to-folder': (lambda r: _head_dataset(r / 'src'), 'src', 'out',
                         []),
    'folder-to-zip-scaled': (lambda r: _head_dataset(r / 'src'), 'src',
                             'out.zip', ['--resolution', '16']),
    'folder-center-crop': (lambda r: _head_dataset(r / 'src'), 'src',
                           'out.zip', ['--resolution', '16', '--transform',
                                       'center-crop', '--max-images', '2']),
    'zip-to-folder': (_zipped_head, 'src.zip', 'out', []),
    'cifar-to-zip': (lambda r: _cifar(r / 'cifar'), 'cifar', 'out.zip',
                     ['--max-images', '4']),
    'lmdb-center-crop-wide': (lambda r: _lmdb(r / 'lsun'), 'lsun',
                              'out.zip', ['--resolution', '8', '--transform',
                                          'center-crop-wide']),
}


@pytest.mark.parametrize('case', list(SOURCES))
def test_dataset_tool_matches_jax(tmp_path, case):
    make, source, dest, extra = SOURCES[case]
    roots = _both(tmp_path, lambda r: [
        'dataset-tool', '--source', str(r / source), '--dest',
        str(r / dest)] + extra, make)
    files = _assert_same_files(roots[0] / dest, roots[1] / dest)
    assert 'dataset.json' in files
    if not dest.endswith('.zip'):
        # the folder's meshes and landmarks, prebaked beside it
        for suffix in ('_verts.npy', '_lms.npy'):
            a, b = (np.load(str(r / dest) + suffix) for r in roots)
            np.testing.assert_array_equal(a, b)


def test_dataset_tool_output_reads_through_the_port_dataset(tmp_path):
    """A packed folder and zip open in the port's ImageFolderDataset with
    the source's images, labels, vertices and landmarks."""
    src = tmp_path / 'src'
    _head_dataset(src)
    want = ImageFolderDataset(str(src))
    for dest in ('out', 'out.zip'):
        port_cli.run(['dataset-tool', '--source', str(src), '--dest',
                      str(tmp_path / dest)])
        ds = ImageFolderDataset(str(tmp_path / dest))
        assert len(ds) == len(want) == 3 and ds.resolution == 24
        for i in range(len(ds)):
            img, label, verts = ds[i]
            img_w, label_w, verts_w = want[i]
            np.testing.assert_array_equal(img, img_w)
            np.testing.assert_array_equal(label, label_w)
            np.testing.assert_array_equal(verts, verts_w)
            assert verts.shape == (5023 + 68, 3)


def test_commands_take_the_jax_options():
    """Each new command's options, their destinations and defaults, are
    the JAX click command's; neither takes --device."""
    import argparse
    parser = port_cli.build_parser()
    sub = parser._subparsers._group_actions[0].choices

    def port_options(p):
        return {a.option_strings[-1]: (a.dest, a.required,
                                       None if a.required else a.default)
                for a in p._actions if a.option_strings and a.dest != 'help'}

    def jax_options(cmd):
        # a required option's default is None (click's sentinel), a flag's
        # False
        return {o.opts[-1]: (o.name, o.required,
                             None if o.required else
                             False if o.is_flag and not o.default
                             else o.default)
                for o in cmd.params}

    pairs = [(sub['dataset-tool'], jax_main.commands['dataset-tool'])]
    stages = sub['preprocess']._subparsers._group_actions[0].choices
    for name in ('align', 'crop', 'mirror', 'cameras'):
        pairs.append((stages[name],
                      jax_main.commands['preprocess'].commands[name]))
    for p, cmd in pairs:
        assert isinstance(p, argparse.ArgumentParser)
        assert '--device' not in port_options(p)
        assert port_options(p) == jax_options(cmd), cmd.name
