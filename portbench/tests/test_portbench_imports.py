"""No module the benchmark imports or runs has JAX or the JAX package as
its top-level name, none reads the JAX harness or the repository's test
helpers and scripts, and the reference imports nothing of the port."""

import ast
import os

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "taichi_3d_gaussian_splatting_tpu",
             "benchmark", "chip_smoke", "stage_times", "blend_kernel_times",
             "bench", "tests", "torch_chunk_fixtures"}
PORT = "taichi_3d_gaussian_splatting_torch"


def _sources(root, skip_tests=True):
    for dirpath, dirnames, files in os.walk(root):
        if skip_tests and os.path.basename(dirpath) == "tests":
            dirnames[:] = []
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(_sources(BENCH)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_forbidden_import(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources(os.path.join(BENCH, "reference"))),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    assert set(_imports(path)) <= {"__future__", "typing", "math", "numpy",
                                   "torch", "statistics"}


def test_the_scan_sees_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom taichi_3d_gaussian_splatting_tpu import x\n")
    assert set(_imports(str(p))) == {"jax", "taichi_3d_gaussian_splatting_tpu"}
    assert PORT.startswith("taichi_3d_gaussian_splatting_")
    assert PORT not in FORBIDDEN
