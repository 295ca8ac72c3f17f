"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with ``nvcc`` for Hopper (``sm_90a``) into
``csrc/build/lib<name>_<hash>.so`` (the hash is of the source, so an edit
rebuilds) and loaded with ``ctypes``. The compiler's output, including
``-Xptxas -v``'s register and shared-memory report, is kept beside the
library as ``.log``. Nothing here runs at import time: machines without
``nvcc`` import the package and use the kernels' plain versions on CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD = CSRC / 'build'
_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entry points of each library with their arguments (pointers and the
# stream as void *); each returns a cudaError_t as an int
SIGNATURES = {
    'triplane_sample': {
        entry: [_P] * 3 + [_I] * 5 + [ctypes.c_float, _P]
        for entry in ('triplane_sample', 'triplane_sample_bf16',
                      'triplane_sample_backward')},
    'triplane_backward_binned': {
        'triplane_backward_binned': [_P] * 7 + [_I] * 7
        + [ctypes.c_float, _P]},
    'raster_binned_uv': {
        entry: [_P] * 5 + [_I] * 4 + [_P]
        for entry in ('raster_binned_uv', 'raster_binned_uv16',
                      'raster_binned')},
    'raster_binned_prep': {
        'raster_binned_prep': [_P] * 3 + [_I] + [_P] * 3 + [_I] * 5 + [_P]},
    'raster_zbuffer': {
        'raster_zbuffer_prep': [_P] * 4 + [_I] * 5 + [_P],
        'raster_zbuffer': [_P] * 5 + [_I] * 6 + [_P]},
    'gather_row_blocks': {
        'gather_row_blocks': [_P] * 3 + [ctypes.c_longlong] + [_I] * 2
        + [_P]},
    'upfirdn2d': {
        'upfirdn2d': [_P] * 3 + [_I] * 22 + [ctypes.c_float, _P]},
}
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']


def _nvcc():
    nvcc = shutil.which('nvcc')
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    if nvcc is None and os.path.exists(os.path.join(home, 'bin', 'nvcc')):
        nvcc = os.path.join(home, 'bin', 'nvcc')
    if nvcc is None:
        raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')
    return nvcc


def _library(name):
    src = CSRC / f'{name}.cu'
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return src, BUILD / f'lib{name}_{digest}.so'


def build_all(names):
    """Compile the missing libraries of ``names``, one ``nvcc`` process per
    source, all started together; returns their paths in order."""
    libs = [_library(name) for name in names]
    running = []
    for src, so in libs:
        if so.exists():
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((src, so, tmp, proc))
    failed = []
    for src, so, tmp, proc in running:
        out, _ = proc.communicate()
        so.with_suffix('.log').write_text(out)
        if proc.returncode != 0:
            failed.append(f'nvcc failed on {src.name}:\n{out}')
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError('\n'.join(failed))
    return [so for _, so in libs]


def build(name):
    """Compile ``csrc/<name>.cu`` if its library is missing; returns the
    library's path."""
    return build_all([name])[0]


@functools.lru_cache(maxsize=None)
def load(name):
    """The ``ctypes`` handle of kernel library ``name`` (built on demand),
    with the signatures of its entry points (``SIGNATURES``) and of its
    ``<name>_error_string`` set."""
    lib = ctypes.CDLL(str(build(name)))
    for entry, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    fn = getattr(lib, f'{name}_error_string')
    fn.restype = ctypes.c_char_p
    fn.argtypes = [ctypes.c_int]
    return lib


def launch(name, entry, device, *args):
    """Call C entry point ``entry`` of library ``name`` with ``args`` and
    then the current stream of ``device``; raise if it returns a non-zero
    ``cudaError_t``."""
    lib = load(name)
    with torch.cuda.device(device):
        status = getattr(lib, entry)(
            *args, torch.cuda.current_stream().cuda_stream)
    if status != 0:
        message = getattr(lib, f'{name}_error_string')(status).decode()
        raise RuntimeError(f'{name}: CUDA error {status}: {message}')
