"""Nothing the benchmark runs imports JAX or the JAX package, compared
by whole top-level module names (the port, ``thrifty_tpu_torch``, is
allowed); the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark.harness import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "thrifty_tpu"}
SOURCES = sorted(
    os.path.join(d, f) for d, _, files in os.walk(cells.BENCH_DIR)
    for f in files if f.endswith(".py"))


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, cells.BENCH_DIR)
                              for p in SOURCES])
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(cells.BENCH_DIR, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            names = top_level_imports(os.path.join(ref, f))
            assert "thrifty_tpu_torch" not in names, f
            assert not names & FORBIDDEN, f


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, {repo!r})\n"
        "from benchmark.harness import session\n"
        "entry = {{'name': 'rx_fastdet.pipe_gated', 'config': 'rx_fastdet', "
        "'traffic': 'tx5_1hz_pipe_devunfold'}}\n"
        "r = session.run_cell(entry, 9, 0.3, False, device='cpu', "
        "sizes={{'base_blocks': 16, 'batch_size': 8, "
        "'warmup_batches': 1}})\n"
        "print(session.forbidden_modules(), r['correct'])\n"
    ).format(repo=cells.REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=cells.REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[] True"
