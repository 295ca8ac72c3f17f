"""The port's TensorBoard writer (next3d_tpu_torch/utils/tensorboard.py)
against the JAX package's (next3d_tpu/utils/tensorboard.py): the same
bytes for the same scalars at a fixed wall time, JAX's read_scalars reads
the port's file and the port's reads JAX's. (The training loop's events
file is held to its stats.jsonl in tests/test_torch_train_cli.py
test_train_resumes_bit_exact.)"""

import os
import time

import pytest

from next3d_tpu.utils import tensorboard as jax_tensorboard
from next3d_tpu_torch.utils import tensorboard

SCALARS = [('Loss/G/loss', 1.5, 0), ('Loss/D/loss', -0.25, 0),
           ('Progress/augment', 0.125, 3), ('tick', 7, 3),
           ('Timing/Gmain', 1e-3, 1 << 40), ('kimg', 0.004, 2 ** 63 - 1)]


def _write(module, log_dir):
    w = module.SummaryWriter(str(log_dir))
    for tag, value, step in SCALARS:
        w.add_scalar(tag, value, global_step=step)
    w.add_scalar('walltime', 2.0, global_step=1, walltime=12.5)
    w.flush()
    w.close()
    w.close()
    (name,) = os.listdir(log_dir)
    return os.path.join(log_dir, name)


def test_writer_bytes_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, 'time', lambda: 1700000000.25)
    got = _write(tensorboard, tmp_path / 'port')
    want = _write(jax_tensorboard, tmp_path / 'jax')
    assert os.path.basename(got) == os.path.basename(want) \
        == f'events.out.tfevents.1700000000.{os.getpid()}'
    with open(got, 'rb') as a, open(want, 'rb') as b:
        assert a.read() == b.read()
    for read in (tensorboard.read_scalars, jax_tensorboard.read_scalars):
        scalars = read(got)
        assert [(s, tag) for s, tag, _ in scalars] == [
            (step, tag) for tag, _, step in SCALARS] + [(1, 'walltime')]
        for (_, _, v), (_, value, _) in zip(scalars, SCALARS):
            assert v == pytest.approx(value, rel=1e-7)
        assert scalars == jax_tensorboard.read_scalars(want)


@pytest.mark.parametrize('data', [b'', b'123456789', bytes(32),
                                  bytes(range(256)) * 3])
def test_crc32c_matches_jax(data):
    assert tensorboard.crc32c(data) == jax_tensorboard.crc32c(data)
    assert tensorboard._masked_crc(data) == jax_tensorboard._masked_crc(data)
