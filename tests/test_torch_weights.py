"""The weight bridge, the port's own copies of the JAX package's numpy
helpers, and the port's import hygiene: it imports neither JAX nor any
module of the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from next3d_tpu.models import EG3DTriPlaneGenerator as JaxEG3D
from next3d_tpu.models import TriPlaneGenerator as JaxGenerator
from next3d_tpu.nn import SG3Generator as JaxSG3
from next3d_tpu.utils import obj_io as jax_obj_io
from next3d_tpu.utils.pkl_import import params_to_state_dict
from next3d_tpu_torch.models.triplane_eg3d import EG3DTriPlaneGenerator
from next3d_tpu_torch.models.triplane_next3d import TriPlaneGenerator
from next3d_tpu_torch.nn.stylegan3 import SG3Generator
from next3d_tpu_torch.utils import obj_io, weights
from next3d_tpu_torch.utils.synthetic_head import synthetic_head
from next3d_tpu_torch.utils.weights import load_jax_params

from test_torch_eg3d import EG3D_CFG
from test_torch_generator import CFG
from test_torch_sg3 import SG3_CONFIGS

# the buffers of the SG3 and EG3D generators that the JAX package keeps
# as param leaves
SG3_BUFFERS = ('transform', 'freqs', 'phases', 'magnitude_ema', 'w_avg')


def _lands_strictly(jg, port):
    """The JAX tree of ``jg`` (shapes from jax.eval_shape of its init, values
    seeded) and ``port``'s state_dict have the same keys and shapes, and the
    whole tree loads under strict=True. Returns the tree and its flat
    form."""
    shapes = jax.eval_shape(jg.init, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    tree = jax.tree_util.tree_map(
        lambda s: np.asarray(rng.randn(*s.shape), np.float32), shapes)
    flat = params_to_state_dict(tree)
    assert set(flat) == set(port.state_dict())
    load_jax_params(port, tree)
    for key, value in port.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), flat[key])
    return tree, flat


def test_every_jax_param_lands_strictly():
    """The small flagship's JAX tree lands in the port's generator; so do
    the SG3 (T and R) and EG3D trees, SG3's buffers where JAX keeps them as
    param leaves; a missing or an unexpected key raises."""
    mesh, _ = synthetic_head()
    jg = JaxGenerator(topology_path=mesh, rasterizer_impl='scatter',
                      rasterizer_patch=16, **CFG)
    port = TriPlaneGenerator(topology_path=mesh, **CFG)
    tree, flat = _lands_strictly(jg, port)
    assert float(port.orth_scale) == float(flat['orth_scale'][0, 0])
    for cfg in SG3_CONFIGS.values():
        sg3 = SG3Generator(**cfg)
        _, sg3_flat = _lands_strictly(JaxSG3(**cfg), sg3)
        buffers = dict(sg3.named_buffers())
        for key in sg3_flat:
            if key.split('.')[-1] in SG3_BUFFERS:
                assert key in buffers, key
        assert torch.equal(sg3.synthesis.input.transform, torch.from_numpy(
            sg3_flat['synthesis.input.transform']))
    _lands_strictly(JaxEG3D(**EG3D_CFG), EG3DTriPlaneGenerator(**EG3D_CFG))

    # a missing or an unexpected key raises
    del tree['decoder']['net']['2']['bias']
    with pytest.raises(RuntimeError, match='Missing'):
        load_jax_params(port, tree)
    tree['decoder']['net']['2']['bias'] = np.zeros(33, np.float32)
    tree['extra'] = {'weight': np.zeros(3, np.float32)}
    with pytest.raises(RuntimeError, match='Unexpected'):
        load_jax_params(port, tree)


def test_params_to_state_dict_matches_jax_package():
    tree = {'a': {'b': np.arange(3.0), 'c': {'d': np.ones((2, 2))}},
            'e': np.float32(5)}
    want = params_to_state_dict(tree)
    got = weights.params_to_state_dict(tree)
    assert list(got) == list(want) == ['a.b', 'a.c.d', 'e']
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_obj_io_matches_jax_package(tmp_path):
    """A written .obj with UVs and a quad (split into a fan), one without
    UVs, and a landmark file: the port's readers return what the JAX
    package's do."""
    path = tmp_path / 'mesh.obj'
    path.write_text('# mesh\n'
                    'v 0 0 0\nv 1 0 0\nv 1 1 0.5\nv 0 1 -0.25\n'
                    'vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n'
                    'vn 0 0 1\n'
                    'f 1/1/1 2/2/1 3/3/1\n'
                    'f 1/1 3/3 4/4 2/2\n')
    got, want = obj_io.load_obj(path), jax_obj_io.load_obj(path)
    assert got.faces.shape == (3, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    bare = tmp_path / 'bare.obj'
    bare.write_text('v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n')
    got = obj_io.load_obj(bare)
    assert got.verts_uvs is None and got.faces_uvs is None
    np.testing.assert_array_equal(got.faces, jax_obj_io.load_obj(bare).faces)
    lms = tmp_path / 'mesh_kpt2d.txt'
    np.savetxt(lms, np.random.RandomState(0).randn(68, 3))
    np.testing.assert_array_equal(obj_io.load_lms(lms),
                                  jax_obj_io.load_lms(lms))


def test_port_imports_no_jax():
    """Every module of the port (its CLIs and its training path included,
    the augment pipe and the video dataset too, the checkpoint readers,
    the metrics, the bench, the data parallelism, the SG3 and EG3D
    families, the cross-section, the registry, the 'tiled' and 'scatter'
    rasterizers, the dataset tools and their commands, the logger and the
    profiling helpers), and each generator
    built from it, pull in neither JAX nor any module of
    the JAX package, nor optax, click or PIL, which the card machine
    lacks."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import next3d_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "next3d_tpu_torch.__path__, 'next3d_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'next3d_tpu_torch.nn.discriminator', "
        "'next3d_tpu_torch.train.loss', 'next3d_tpu_torch.train.train_step', "
        "'next3d_tpu_torch.train.training_loop', "
        "'next3d_tpu_torch.data.dataset', 'next3d_tpu_torch.cli.train', "
        "'next3d_tpu_torch.train.augment', "
        "'next3d_tpu_torch.data.video_dataset', "
        "'next3d_tpu_torch.utils.easydict', "
        "'next3d_tpu_torch.utils.pkl_import', "
        "'next3d_tpu_torch.utils.legacy', "
        "'next3d_tpu_torch.train.warm_start', "
        "'next3d_tpu_torch.utils.tensorboard', "
        "'next3d_tpu_torch.utils.checkpoint_cases', "
        "'next3d_tpu_torch.metrics.metric_utils', "
        "'next3d_tpu_torch.metrics.inception', "
        "'next3d_tpu_torch.metrics.frechet_inception_distance', "
        "'next3d_tpu_torch.metrics.kernel_inception_distance', "
        "'next3d_tpu_torch.metrics.precision_recall', "
        "'next3d_tpu_torch.metrics.inception_score', "
        "'next3d_tpu_torch.metrics.perceptual_path_length', "
        "'next3d_tpu_torch.metrics.reenactment_distance', "
        "'next3d_tpu_torch.metrics.equivariance', "
        "'next3d_tpu_torch.metrics.metric_main', "
        "'next3d_tpu_torch.cli.calc_metrics', "
        "'next3d_tpu_torch.bench', 'next3d_tpu_torch.parallel.dist', "
        "'next3d_tpu_torch.parallel.stats', "
        "'next3d_tpu_torch.ops.filtered_lrelu', "
        "'next3d_tpu_torch.nn.stylegan3', "
        "'next3d_tpu_torch.models.triplane_eg3d', "
        "'next3d_tpu_torch.render.crosssection', "
        "'next3d_tpu_torch.utils.registry', "
        "'next3d_tpu_torch.render.rasterizer', "
        "'next3d_tpu_torch.data.preprocess', "
        "'next3d_tpu_torch.data.image_prep', "
        "'next3d_tpu_torch.data.lmdb_reader', "
        "'next3d_tpu_torch.cli.dataset_tool', "
        "'next3d_tpu_torch.cli.preprocess_cli', "
        "'next3d_tpu_torch.utils.logger', "
        "'next3d_tpu_torch.utils.profiling'} "
        "<= set(names), names\n"
        "from next3d_tpu_torch.models import (triplane_next3d,"
        " triplane_texture)\n"
        "from next3d_tpu_torch.utils import synthetic_head\n"
        "mesh_, lms = synthetic_head.synthetic_head()\n"
        "for cls in (triplane_next3d.TriPlaneGenerator,"
        " triplane_texture.TriPlaneTextureGenerator):\n"
        "    cls(z_dim=8, c_dim=25, w_dim=16, "
        "img_resolution=128, img_channels=3, topology_path=mesh_, "
        "channel_base=64, channel_max=4, plane_resolution=64, "
        "rendering_kwargs={'superresolution_module': "
        "'SuperresolutionHybrid2X'})\n"
        "from next3d_tpu_torch.models import triplane_eg3d\n"
        "from next3d_tpu_torch.nn import stylegan3\n"
        "triplane_eg3d.EG3DTriPlaneGenerator(z_dim=8, c_dim=25, w_dim=512, "
        "img_resolution=128, img_channels=3, channel_base=1024, "
        "channel_max=4, rendering_kwargs={'superresolution_module': "
        "'SuperresolutionHybrid2X'})\n"
        "stylegan3.SG3Generator(z_dim=8, c_dim=0, w_dim=8, "
        "img_resolution=16, img_channels=3, channel_base=64, "
        "channel_max=4, num_layers=3, num_critical=1)\n"
        "import next3d_tpu_torch.cli.main\n"
        "import next3d_tpu_torch.bench\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'next3d_tpu', 'click', 'PIL', 'optax'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, '-c', code], check=True, timeout=120)


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py names no module of JAX, of optax or of the JAX
    package, and importing it and loading the head through it pulls in
    none."""
    root = Path(__file__).resolve().parents[1]
    tree = ast.parse((root / 'chip_smoke.py').read_text())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)]
    assert 'next3d_tpu_torch.utils.obj_io' in names
    for name in names:
        top = name.split('.')[0]
        assert top not in ('jax', 'jaxlib', 'next3d_tpu', 'optax'), name
    code = ("import sys\n"
            "import chip_smoke\n"
            "mesh, lms = chip_smoke.load_head()\n"
            "assert mesh.verts.shape == (5023, 3) and lms.shape == (68, 3)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'next3d_tpu', 'optax'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, '-c', code], check=True, timeout=120,
                   cwd=root, env={**os.environ, 'NEXT3D_TOPOLOGY': ''})
