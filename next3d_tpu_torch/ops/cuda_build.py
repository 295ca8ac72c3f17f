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

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD = CSRC / 'build'
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
    """The ``ctypes`` handle of kernel library ``name`` (built on demand)."""
    return ctypes.CDLL(str(build(name)))


def check(name, status):
    """Raise if library ``name``'s C entry point returned a non-zero
    ``cudaError_t``; every library exports ``<name>_error_string``."""
    if status != 0:
        fn = getattr(load(name), f'{name}_error_string')
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f'{name}: CUDA error {status}: '
                           f'{fn(status).decode()}')
