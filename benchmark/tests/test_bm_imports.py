"""No process of the benchmark loads JAX or the JAX package: every module
of the benchmark loaded and a small cell run in a fresh interpreter, then
each loaded module's top-level name compared whole (``next3d_tpu_torch``
begins with ``next3d_tpu`` and is allowed)."""

import json
import subprocess
import sys

from conftest import ROOT

SCRIPT = r'''
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + '/benchmark/tests')
import benchmark
for m in pkgutil.walk_packages(benchmark.__path__, 'benchmark.'):
    if '.tests' not in m.name:
        importlib.import_module(m.name)
from benchmark import harness, run
for metric in harness.spec()['per_layer']:
    harness.reader(metric['name'])
from conftest import tiny_ctx
ctx = tiny_ctx('next3d_ffhq512.synth_b8', seconds=0.1)
spec = harness.spec()
run.run_cell(ctx, spec, harness.workload(ctx.cell['name'])[0], 0.0)
print(json.dumps([sorted(sys.modules), harness.banned_modules()]))
'''


def test_no_jax_in_a_run():
    out = subprocess.run([sys.executable, '-c', SCRIPT, str(ROOT)],
                         capture_output=True, text=True, check=True,
                         cwd=ROOT, timeout=600)
    loaded, banned = json.loads(out.stdout.strip().splitlines()[-1])
    tops = {name.split('.', 1)[0] for name in loaded}
    assert banned == []
    assert not tops & {'jax', 'jaxlib', 'flax', 'next3d_tpu'}
    assert 'next3d_tpu_torch' in tops


def test_whole_names_are_compared():
    from benchmark import harness
    saved = dict(sys.modules)
    try:
        sys.modules['next3d_tpu_torch_fake'] = sys
        sys.modules['jaxfake.sub'] = sys
        assert 'jaxfake.sub' not in harness.banned_modules()
        sys.modules['next3d_tpu.models'] = sys
        assert 'next3d_tpu.models' in harness.banned_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_the_reference_imports_nothing_of_the_port():
    script = ('import sys; sys.path.insert(0, sys.argv[1]); '
              'import benchmark.reference.models.triplane_next3d, '
              'benchmark.reference.models.triplane_texture, '
              'benchmark.reference.train.loss, '
              'benchmark.reference.train.train_step, '
              'benchmark.reference.nn.discriminator; '
              'print(sorted({m.split(".")[0] for m in sys.modules}))')
    out = subprocess.run([sys.executable, '-c', script, str(ROOT)],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    assert 'next3d_tpu_torch' not in out.stdout
    assert 'jax' not in out.stdout.split()
