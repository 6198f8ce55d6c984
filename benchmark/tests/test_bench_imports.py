"""Nothing a benchmark run imports is JAX, jaxlib, Flax or the JAX package
(top-level module names compared whole: the port's name begins with the
JAX package's), and the reference and the kind modules import nothing of
the port."""

import ast
import os
import subprocess
import sys

import pytest

import tiny

BENCH = os.path.join(tiny.ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "threestudio_3dgs_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        if ".cache" in d or ".runs" in d:
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax():
    for path in _sources():
        assert not set(_imports(path)) & FORBIDDEN, path


@pytest.mark.parametrize("sub", ["reference", "kinds"])
def test_reference_imports_nothing_of_the_program(sub):
    """The reference and the kind modules that hold its steps."""
    for path in _sources(sub):
        assert "threestudio_3dgs_tpu_torch" not in set(_imports(path)), path


def test_a_run_loads_no_jax():
    """A whole run of the tiny cell in a fresh process, then its modules."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import tiny\n"
        "from benchmark import harness\n"
        "tiny.run(tiny.cell('sd21.t2i'), seconds=0.2)\n"
        "print('FOUND', harness.forbidden_modules())\n"
        "print('PORT', 'threestudio_3dgs_tpu_torch' in sys.modules)\n"
    ) % (tiny.ROOT, os.path.dirname(__file__))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tiny.ROOT, env={**os.environ, "USE_FLAX": "0"})
    assert "FOUND []" in out.stdout, out.stdout[-2000:] + out.stderr[-3000:]
    assert "PORT True" in out.stdout
