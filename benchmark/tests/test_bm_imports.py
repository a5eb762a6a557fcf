"""No JAX in the benchmark: no file under `benchmark/` imports `jax`,
`jaxlib`, `flax` or the JAX package (top-level names compared whole, so
`evo_tpu_torch` is not `evo_tpu`), the reference imports nothing of the
port either, and a rehearsed run leaves none of them loaded."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(harness.HERE)
               for f in fs if f.endswith('.py'))


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize('path', FILES,
                         ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_jax_import(path):
    for mod in _imports(path):
        assert mod.split('.')[0] not in harness.FORBIDDEN, (path, mod)


@pytest.mark.parametrize('path', [p for p in FILES if os.sep + 'reference'
                                  + os.sep in p])
def test_reference_imports_nothing_of_the_port(path):
    for mod in _imports(path):
        assert mod.split('.')[0] not in ('evo_tpu_torch', 'benchmark'), \
            (path, mod)


def test_whole_name_comparison():
    sys.modules.setdefault('evo_tpu_torch_probe_only', sys)
    try:
        assert 'evo_tpu_torch_probe_only' not in harness.forbidden_modules()
    finally:
        del sys.modules['evo_tpu_torch_probe_only']


def test_a_rehearsed_run_loads_no_jax():
    code = ('import sys; sys.path.insert(0, %r)\n'
            'from benchmark.tests.tiny import run\n'
            'r = run("serve-8k-design")\n'
            'assert r["correct"]\n'
            'from benchmark import harness\n'
            'print(harness.forbidden_modules())\n') % harness.ROOT
    p = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=300, cwd=harness.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == '[]'
