"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the repository's root, on the CPU; the tests marked ``cuda`` skip without
a card and run on one (``python -m pytest benchmark/tests -m cuda``).
Small sizes only: the configurations' widths cut to a CPU test's size."""

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


def tiny(cfg_name, mix_name):
    """(config, traffic) of a cell cut to a CPU test's size: 128^2 images
    and planes, 8 + 8 ray samples, 2X super-resolution, narrow backbones
    and discriminator, z of 64."""
    cfg = copy.deepcopy(harness.config(cfg_name))
    rk = dict(cfg['G_kwargs']['rendering_kwargs'], depth_resolution=8,
              depth_resolution_importance=8,
              superresolution_module='SuperresolutionHybrid2X')
    cfg['G_kwargs'].update(z_dim=64, img_resolution=128, plane_resolution=128,
                           channel_base=2048, channel_max=64,
                           rendering_kwargs=rk, sr_num_fp16_res=0)
    cfg['D_kwargs'].update(img_resolution=128, channel_base=2048,
                           channel_max=64)
    mix = dict(harness.traffic(mix_name), z_dim=64)
    if mix['kind'] == 'train':
        mix['resolution'] = 128
        mix['batch'] = 2
    else:
        mix['batch'] = min(mix['batch'], 2)
    return cfg, mix


def tiny_ctx(cell_name, seed=2 ** 40 + 3, device='cpu', seconds=0.5,
             trace=False):
    cell, _ = harness.workload(cell_name)
    cfg, mix = tiny(cell['config'], cell['traffic'])
    return harness.Ctx(cell, cfg, mix, seed, device, seconds=seconds,
                       trace=trace, lim=harness.limits(cell_name))


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(4, saved))
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)
