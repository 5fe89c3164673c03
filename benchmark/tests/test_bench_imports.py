"""Nothing the benchmark runs imports JAX or the JAX package: each
import's top-level name is compared whole (``montage_gan_tpu_torch`` is
the port and passes), in the sources and in a process that loads them."""

import ast
import subprocess
import sys

from benchmark import harness, spec

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'montage_gan_tpu'}


def _top_level_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def test_no_source_imports_jax_or_the_jax_package():
    found = {}
    for path in spec.BENCH_DIR.rglob('*.py'):
        bad = set(_top_level_imports(path)) & FORBIDDEN
        if bad:
            found[str(path)] = sorted(bad)
    assert found == {}


def test_a_process_loading_the_harness_and_the_port_holds_no_jax():
    code = ('import sys; sys.path.insert(0, %r)\n'
            'import benchmark.harness as h, benchmark.check, '
            'benchmark.reference.train_step\n'
            'import montage_gan_tpu_torch.training.train_step, '
            'montage_gan_tpu_torch.training.loop_aio\n'
            'for n in %r: h.load_reader(n)\n'
            'print(",".join(h.forbidden_modules()))') % (
        str(spec.ROOT), [m['name'] for m in spec.load_json(
            spec.ROOT / 'BENCHMARK.json')['per_layer']])
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ''

