"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: both run on the CPU, on the same numpy inputs and parameters."""

import numpy as np
import pytest
import torch

from next3d_tpu_torch.utils.weights import state_dict_to_params


def to_jax_tree(module):
    """A port module's state_dict as the JAX package's nested param tree of
    numpy arrays (dotted names -> one dict level per component)."""
    return state_dict_to_params(module.state_dict())


def t(a):
    """numpy -> torch (CPU)."""
    return torch.from_numpy(np.array(a))


def n(x):
    """torch or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@pytest.fixture
def one_thread():
    """Run a test on one torch intra-op thread. The suite runs in several
    worker processes, one a file, on the machine's cores, and torch's
    default of a thread a core in each of them oversubscribes the cores:
    the float64 emulation of K5's fused multiply-adds (ops/raster_zbuffer.py
    fma32, many mid-sized elementwise ops) then runs more than ten times
    slower than on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
