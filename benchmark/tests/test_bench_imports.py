"""What the benchmark's modules may import, by whole top-level names (the
port's name begins with the JAX package's)."""

import ast
import os

import pytest

from benchmark.harness import manifest as mf

JAX = {"jax", "jaxlib", "flax", "seqoia_tpu"}


def _modules():
    for dirpath, dirs, files in os.walk(mf.BENCH_DIR):
        dirs[:] = [d for d in dirs if not d.startswith((".", "__"))]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_top_names_are_compared_whole():
    assert "seqoia_tpu_torch".split(".")[0] not in JAX
    assert "seqoia_tpu.codec".split(".")[0] in JAX


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, mf.BENCH_DIR))
def test_no_jax(path):
    assert not (_top_names(path) & JAX)


@pytest.mark.parametrize("sub", ["reference", "traffic"])
def test_reference_and_traffic_import_nothing_of_the_port(sub):
    paths = [p for p in _modules()
             if os.path.relpath(p, mf.BENCH_DIR).split(os.sep)[0] == sub]
    for p in paths:
        assert "seqoia_tpu_torch" not in _top_names(p), p
        assert "benchmark" not in _top_names(p) or sub == "traffic", p


def test_reference_import_leaves_the_port_unloaded(tmp_path):
    """Importing the reference in a fresh interpreter loads no module of
    the port or of JAX."""
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.codec, benchmark.reference.corpus; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'seqoia_tpu_torch', 'seqoia_tpu', 'jax', 'jaxlib', 'flax'}))"
            % mf.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=tmp_path)
    assert out.stdout.strip() == "[]"
