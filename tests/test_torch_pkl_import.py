"""The port's reader of the reference's network pickles
(next3d_tpu_torch/utils/pkl_import.py) against the JAX package's
(next3d_tpu/utils/pkl_import.py), on pickles written in the reference's
wire format (utils/checkpoint_cases.py write_network_pkl: persistence-
wrapped modules holding their state, as tests/test_warm_start_pkl.py
builds one) from the weights of a small generator on the synthetic head,
with numpy leaves and with torch-tensor leaves, as the released files
have: the same key set, bit-equal arrays, the same init_kwargs; the
v13_neural_blending rename and dnnlib's EasyDict; the inference commands
from the .pkl against the same commands from a format-1 snapshot of the
same weights; entries that the port's generator does not have dropped and
named, a missing one raising; and what the JAX reader does not read."""

import collections
import os
import pickle

import numpy as np
import pytest
import torch

import jax

from next3d_tpu.utils import checkpoint as jax_checkpoint
from next3d_tpu.utils import pkl_import as jax_pkl_import
from next3d_tpu_torch.cli.common import build_generator_from_kwargs
from next3d_tpu_torch.cli.gen_samples import generate_images
from next3d_tpu_torch.cli.reenact import reenact
from next3d_tpu_torch.utils import checkpoint, checkpoint_cases, pkl_import
from next3d_tpu_torch.utils.easydict import EasyDict
from next3d_tpu_torch.utils.synthetic_head import save_head
from next3d_tpu_torch.utils.weights import (params_to_state_dict,
                                            state_dict_to_params)

from test_torch_cli import G_KWARGS as CLI_G_KWARGS
from test_torch_cli import _drive_dir, _hide_video_libraries
from torch_parity import one_thread  # noqa: F401 (a fixture)
from torch_parity import one_thread_module  # noqa: F401 (autouse: one torch thread)

# the reference-style init_kwargs of tests/test_torch_cli.py (class_name,
# fp16 and sr knobs that the port filters), at 64^2 planes and 4+4
# samples: the CPU commands below render from them
G_KWARGS = dict(CLI_G_KWARGS, plane_resolution=64, rendering_kwargs=dict(
    CLI_G_KWARGS['rendering_kwargs'], depth_resolution=4,
    depth_resolution_importance=4))
# a buffer of the reference's generator that the port's does not have
EXTRA = 'dense_faces'


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """The head, the generator's tree, and a reference-format pickle of it
    with numpy leaves and one with torch-tensor leaves, each with the
    reference's other keys and one extra buffer."""
    root = tmp_path_factory.mktemp('pkl')
    obj, lms = save_head(str(root / 'head.obj'))
    torch.manual_seed(3)
    G = build_generator_from_kwargs(G_KWARGS, obj, device='cpu')
    tree = state_dict_to_params(G.state_dict())
    paths = {}
    for leaves in ('numpy', 'torch'):
        paths[leaves] = str(root / f'network-{leaves}.pkl')
        checkpoint_cases.write_network_pkl(
            paths[leaves], {'G': tree, 'G_ema': tree, 'D': None},
            torch_leaves=leaves == 'torch',
            init_kwargs={'G': G_KWARGS, 'G_ema': G_KWARGS},
            buffers={'G_ema': {EXTRA: np.arange(6, dtype=np.int64)}},
            extra={'augment_pipe': None,
                   'training_set_kwargs': {'resolution': 128}})
    return dict(root=root, obj=obj, lms=lms, tree=tree, **paths)


@pytest.mark.parametrize('leaves', ['numpy', 'torch'])
def test_reader_matches_jax(files, leaves):
    """load_network_pkl gives the JAX reader's key set, each network's
    state_dict with the same names and bit-equal arrays and its
    init_kwargs; load_any_generator the JAX one's params and init_kwargs;
    the torch-tensor leaves come out as numpy arrays."""
    path = files[leaves]
    got = pkl_import.load_network_pkl(path)
    want = jax_pkl_import.load_network_pkl(path)
    assert set(got) == set(want) == {'G', 'G_ema', 'D', 'augment_pipe',
                                     'training_set_kwargs'}
    assert got['D'] is None and want['D'] is None
    assert got['training_set_kwargs'] == want['training_set_kwargs']
    for key in ('G', 'G_ema'):
        a, b = got[key].state_dict(), want[key].state_dict()
        assert list(a) == list(b)
        for name in a:
            assert isinstance(a[name], np.ndarray)
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name])
        assert got[key].init_kwargs == want[key].init_kwargs == G_KWARGS
        assert got[key].init_args == want[key].init_args == ()
    assert EXTRA in got['G_ema'].state_dict()

    params, kwargs = checkpoint.load_any_generator(path)
    jax_params, jax_kwargs = jax_checkpoint.load_any_generator(path)
    assert kwargs == jax_kwargs == G_KWARGS
    assert jax.tree_util.tree_structure(params) \
        == jax.tree_util.tree_structure(jax_params)
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(jax_params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    want_flat = params_to_state_dict(files['tree'])
    got_flat = params_to_state_dict(params)
    assert set(got_flat) == set(want_flat) | {EXTRA}
    for name, value in want_flat.items():
        np.testing.assert_array_equal(got_flat[name], value)


class Blender:
    """A class of the reference's old module path."""


def test_renamed_module_and_easydict(tmp_path):
    """A class pickled under ``v13_neural_blending`` loads from ``next3d``
    (reference legacy.py:71-72), and ``dnnlib``'s EasyDict as the port's
    EasyDict, in both readers."""
    Blender.__module__ = 'training.v13_neural_blending'
    old_name = type('EasyDict', (dict,), {'__module__': 'dnnlib.util'})
    path = str(tmp_path / 'renamed.pkl')
    with checkpoint_cases._stand_in_modules({
            'training.v13_neural_blending': {'Blender': Blender},
            'dnnlib.util': {'EasyDict': old_name}}), open(path, 'wb') as f:
        pickle.dump({'G_ema': None, 'blender': Blender(),
                     'training_set_kwargs': old_name(resolution=512,
                                                     xflip=False)}, f)

    class Renamed:
        pass

    for reader in (pkl_import, jax_pkl_import):
        with checkpoint_cases._stand_in_modules(
                {'training.next3d': {'Blender': Renamed}}):
            data = reader.load_network_pkl(path)
        assert type(data['blender']) is Renamed
        kwargs = data['training_set_kwargs']
        assert type(kwargs).__name__ == 'EasyDict'
        assert kwargs.resolution == 512 and kwargs == {'resolution': 512,
                                                       'xflip': False}
        assert data['augment_pipe'] is None
    assert isinstance(pkl_import.load_network_pkl(path)[
        'training_set_kwargs'], EasyDict)
    # without a module of that name, the port keeps the instance's state
    data = pkl_import.load_network_pkl(path)
    assert type(data['blender']).reference_name == 'training.next3d.Blender'


class OSGDecoder(torch.nn.Module):
    """A module of the reference's code that is not persistence-wrapped."""

    def __init__(self):
        super().__init__()
        self.net = torch.nn.Sequential(torch.nn.Linear(4, 8),
                                       torch.nn.Softplus())
        self.register_buffer('scale', torch.ones(2))
        self.register_buffer('cache', torch.zeros(3), persistent=False)


def test_reader_reads_what_the_jax_reader_does_not(tmp_path):
    """A network whose tree holds a plain torch module (the reference's
    decoder keeps a ``torch.nn.Sequential``) and an instance of a class of
    the reference's code that is not persistence-wrapped (pickled by a
    module name that does not import here): the port's reader gives their
    weights; the JAX reader raises on both."""
    OSGDecoder.__module__ = 'training.triplane'
    torch.manual_seed(0)
    decoder = OSGDecoder()
    meta = {'type': 'class', 'state': {
        '_parameters': collections.OrderedDict(
            w=torch.nn.Parameter(torch.ones(3))),
        '_buffers': {}, '_modules': {'decoder': decoder},
        '_init_args': (), '_init_kwargs': {}}}
    path = str(tmp_path / 'plain.pkl')
    with checkpoint_cases._stand_in_modules({
            **checkpoint_cases._PERSISTENCE,
            'training.triplane': {'OSGDecoder': OSGDecoder}}), \
            open(path, 'wb') as f:
        pickle.dump({'G_ema': checkpoint_cases._Persistent(meta)}, f)
    got = pkl_import.load_network_pkl(path)['G_ema'].state_dict()
    want = {'w': np.ones(3, np.float32), **{
        f'decoder.{k}': v.numpy() for k, v in decoder.state_dict().items()}}
    assert list(got) == list(want) == ['w', 'decoder.scale',
                                       'decoder.net.0.weight',
                                       'decoder.net.0.bias']
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ModuleNotFoundError, match='training'):
        jax_pkl_import.load_network_pkl(path)
    meta['state']['_modules'] = {'decoder': decoder.net}
    with checkpoint_cases._stand_in_modules(checkpoint_cases._PERSISTENCE), \
            open(path, 'wb') as f:
        pickle.dump({'G_ema': checkpoint_cases._Persistent(meta)}, f)
    got = pkl_import.load_network_pkl(path)['G_ema'].state_dict()
    assert list(got) == ['w', 'decoder.0.weight', 'decoder.0.bias']
    with pytest.raises(TypeError):
        jax_pkl_import.load_network_pkl(path)['G_ema'].state_dict()


def test_extra_entries_dropped_and_missing_raise(files, tmp_path, capsys):
    """load_generator drops the reference entries that the port's generator
    does not have, naming them, and loads the rest bit for bit; a format-1
    snapshot with the same extra entry and a .pkl that lacks an entry
    still raise."""
    from next3d_tpu_torch.cli.common import load_generator
    G = load_generator(files['torch'], files['obj'], 'cpu')
    assert f'dropped 1 entries it does not have: [{EXTRA!r}]' \
        in capsys.readouterr().out
    for k, v in params_to_state_dict(files['tree']).items():
        np.testing.assert_array_equal(G.state_dict()[k].numpy(), v)

    tree = dict(files['tree'], **{EXTRA: np.zeros(2, np.float32)})
    snap = str(tmp_path / 'extra.pkl')
    checkpoint.save_snapshot(snap, params_G_ema=tree,
                             config={'G_kwargs': G_KWARGS})
    with pytest.raises(RuntimeError, match='Unexpected'):
        load_generator(snap, files['obj'], 'cpu')

    missing = {k: v for k, v in files['tree'].items() if k != 'orth_scale'}
    path = str(tmp_path / 'missing.pkl')
    checkpoint_cases.write_network_pkl(path, {'G_ema': missing},
                                       init_kwargs={'G_ema': G_KWARGS})
    with pytest.raises(RuntimeError, match='Missing.*orth_scale'):
        load_generator(path, files['obj'], 'cpu')
    (tmp_path / 'other.pkl').write_bytes(b'not a checkpoint')
    with pytest.raises(ValueError, match='neither'):
        checkpoint.load_any_generator(str(tmp_path / 'other.pkl'))


def _outputs(root):
    """{path under root: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            out[os.path.relpath(path, root)] = open(path, 'rb').read()
    return out


@pytest.mark.usefixtures('one_thread')
def test_commands_from_pkl_equal_commands_from_snapshot(files, monkeypatch):
    """gen-samples of one seed and reenact over 2 driving frames (PNG
    frames) write the same bytes from the .pkl as from a format-1 snapshot
    of the same weights (the format-1 path is held to the JAX commands in
    tests/test_torch_cli_parity.py)."""
    _hide_video_libraries(monkeypatch)
    root = files['root']
    snap = str(root / 'snapshot.pkl')
    checkpoint.save_snapshot(snap, params_G_ema=files['tree'],
                             config={'G_kwargs': G_KWARGS})
    drive = _drive_dir(str(root / "drive"), n=2)
    outs = {}
    for name, network in (('pkl', files['torch']), ('snapshot', snap)):
        generate_images(network, [1], outdir=str(root / name / 'samples'),
                        obj_path=files['obj'], lms_path=files['lms'],
                        device='cpu')
        reenact(network, drive, seeds=[0], outdir=str(root / name / 'r'),
                topology_path=files['obj'], device='cpu')
        outs[name] = _outputs(str(root / name))
    assert sorted(outs['pkl']) == [
        'r/reenact_seed0000_frames/000000.png',
        'r/reenact_seed0000_frames/000001.png', 'samples/seed0001.png']
    assert outs['pkl'] == outs['snapshot']
