"""Nothing under tal_bench imports JAX, flax or the JAX package, and the
plain reference imports nothing of the port either: every import of
every module, compared by whole top-level name (`opental_torch` begins
with `opental_`, and is not `opental_tpu`)."""

import ast
import os
import subprocess
import sys

from tal_bench import spec

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'opental_tpu'}
ROOT = os.path.dirname(spec.PKG)


def imported_tops(path):
    tree = ast.parse(open(path, encoding='utf-8').read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split('.')[0])
    return tops


def modules(under):
    for dirpath, _, files in os.walk(under):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(dirpath, f)


def test_no_jax_anywhere():
    found = {p: imported_tops(p) & FORBIDDEN for p in modules(spec.PKG)}
    assert not any(found.values()), found
    assert len(found) > 30


def test_reference_stands_alone():
    ref = os.path.join(spec.PKG, 'reference')
    found = {p: imported_tops(p) & (FORBIDDEN | {'opental_torch'})
             for p in modules(ref)}
    assert not any(found.values()), found
    assert 'opental_tpu' != 'opental_torch'[:len('opental_tpu')]


def test_reference_loads_nothing_of_the_program():
    code = ('import sys\n'
            'import tal_bench.reference.build, tal_bench.reference.post, '
            'tal_bench.reference.step, tal_bench.counting\n'
            'bad = sorted({m.split(".")[0] for m in sys.modules} & '
            '{"jax", "jaxlib", "flax", "opental_tpu", "opental_torch"})\n'
            'print(bad)\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'
