"""The port stands alone: importing any of its modules loads no JAX, the
blend wrapper counts only real kernel launches, and a request for anything
but the CPU path either launches the CUDA kernel or raises. Its layers
import one way (`ops/` under `training/` under `parallel/` under the
trainer), and only `ops/_build.py` touches the kernel library."""

import ast
import glob
import importlib
import os
import subprocess
import sys

import pytest
import torch

from taichi_3d_gaussian_splatting_torch.ops import _build
from taichi_3d_gaussian_splatting_torch.ops import blend_cuda as BC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "taichi_3d_gaussian_splatting_torch"
PORT_MODULES = [
    "taichi_3d_gaussian_splatting_torch",
    "taichi_3d_gaussian_splatting_torch.camera",
    "taichi_3d_gaussian_splatting_torch.ops.gaussian",
    "taichi_3d_gaussian_splatting_torch.ops.transforms",
    "taichi_3d_gaussian_splatting_torch.ops.sh",
    "taichi_3d_gaussian_splatting_torch.ops.projection",
    "taichi_3d_gaussian_splatting_torch.ops.projection_cuda",
    "taichi_3d_gaussian_splatting_torch.ops.tiling",
    "taichi_3d_gaussian_splatting_torch.ops._build",
    "taichi_3d_gaussian_splatting_torch.ops.blend_cuda",
    "taichi_3d_gaussian_splatting_torch.ops.rasterizer",
    "taichi_3d_gaussian_splatting_torch.models.scene",
    "taichi_3d_gaussian_splatting_torch.render",
    "taichi_3d_gaussian_splatting_torch.config",
    "taichi_3d_gaussian_splatting_torch.data.dataset",
    "taichi_3d_gaussian_splatting_torch.utils.visualization",
    "taichi_3d_gaussian_splatting_torch.training.adam",
    "taichi_3d_gaussian_splatting_torch.training.ssim",
    "taichi_3d_gaussian_splatting_torch.training.loss",
    "taichi_3d_gaussian_splatting_torch.training.controller",
    "taichi_3d_gaussian_splatting_torch.training.checkpoint",
    "taichi_3d_gaussian_splatting_torch.training.step",
    "taichi_3d_gaussian_splatting_torch.training.trainer",
    "taichi_3d_gaussian_splatting_torch.train",
    "taichi_3d_gaussian_splatting_torch.ops.geometry",
    "taichi_3d_gaussian_splatting_torch.parallel",
    "taichi_3d_gaussian_splatting_torch.parallel.sharding",
    "taichi_3d_gaussian_splatting_torch.parallel.dryrun",
    "taichi_3d_gaussian_splatting_torch.visualizer",
    "taichi_3d_gaussian_splatting_torch.parquet_to_ply",
    "taichi_3d_gaussian_splatting_torch.utils.profiling",
    "taichi_3d_gaussian_splatting_torch.ci",
    "taichi_3d_gaussian_splatting_torch.ci.run_experiment",
    "taichi_3d_gaussian_splatting_torch.tools",
    "taichi_3d_gaussian_splatting_torch.tools.prepare_kitti",
    "taichi_3d_gaussian_splatting_torch.bench",
    "taichi_3d_gaussian_splatting_torch.probes",
    "taichi_3d_gaussian_splatting_torch.probes._common",
    "taichi_3d_gaussian_splatting_torch.probes.perf_rgb_ablate2",
    "taichi_3d_gaussian_splatting_torch.probes.perf_exp2_probe",
    "taichi_3d_gaussian_splatting_torch.probes.perf_kernel_ablate",
    "taichi_3d_gaussian_splatting_torch.probes.perf_flip_proto",
    "taichi_3d_gaussian_splatting_torch.probes.perf_roll_micro",
    "taichi_3d_gaussian_splatting_torch.probes.roll_semantics_check",
]
PROBE_NAMES = ["perf_rgb_ablate2", "perf_exp2_probe", "perf_kernel_ablate",
               "perf_flip_proto", "perf_roll_micro", "roll_semantics_check"]


def test_port_modules_import_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m.startswith('jaxlib') "
        "or m.startswith('taichi_3d_gaussian_splatting_tpu') "
        "or m in ('pandas', 'PIL', 'triton', 'yaml', 'optax'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"


def test_cpu_blend_does_not_count_launches():
    _build.reset_launch_counts()
    ranges = torch.tensor([0, 1], dtype=torch.int32)
    slab = torch.zeros((16, 2))
    slab[BC.ROW_LOGW] = -1.0
    out = BC.blend_forward(slab, ranges, ranges + 1, num_tiles=2,
                           tiles_per_row=2, rgb_only=False)
    assert out[:, BC.OUT_ACC_ALPHA].max() > 0
    assert sum(_build.launch_counts.values()) == 0


def test_other_devices_raise_without_fallback():
    """A tensor that is neither on the CPU nor on a card never reaches the
    plain version: the wrapper raises."""
    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match="cpu or cuda"):
        BC.blend_forward(torch.empty((16, 4), device=meta),
                         torch.empty(2, dtype=torch.int32, device=meta),
                         torch.empty(2, dtype=torch.int32, device=meta),
                         num_tiles=2, tiles_per_row=2, rgb_only=True)
    assert sum(_build.launch_counts.values()) == 0


def test_backward_on_other_devices_raises():
    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match="cpu or cuda"):
        BC.blend_backward(torch.empty((16, 4), device=meta),
                          torch.empty(2, dtype=torch.int32, device=meta),
                          torch.empty(2, dtype=torch.int32, device=meta),
                          torch.empty((2, 8, 256), device=meta),
                          num_tiles=2, tiles_per_row=2)
    assert sum(_build.launch_counts.values()) == 0


class _OnCuda:
    """A CPU tensor that reports a CUDA device, so that the wrapper's CUDA
    branch runs on a machine without a card."""
    device = torch.device("cuda", 0)

    def __init__(self, tensor):
        self._tensor = tensor

    def __getattr__(self, name):
        return getattr(self._tensor, name)


def test_cuda_launch_without_cuda_raises(monkeypatch):
    """A CUDA input on a machine without the toolchain: the kernel build
    raises out of the wrapper, nothing falls back to the plain version and
    no launch is counted."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel builds and launches")
    with pytest.raises((RuntimeError, AssertionError)):
        torch.empty(1, device="cuda")
    monkeypatch.setattr(_build, "_library", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has a CUDA toolkit")
    _build.reset_launch_counts()
    ranges = _OnCuda(torch.zeros(2, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        BC.blend_forward(_OnCuda(torch.zeros((8, 4), dtype=torch.int32)),
                         ranges, ranges, num_tiles=2, tiles_per_row=2,
                         rgb_only=True)
    assert sum(_build.launch_counts.values()) == 0
    with pytest.raises(RuntimeError, match="nvcc not found"):
        BC.blend_backward(_OnCuda(torch.zeros((16, 4))), ranges, ranges,
                          _OnCuda(torch.zeros((2, 8, 256))), num_tiles=2,
                          tiles_per_row=2)
    assert sum(_build.launch_counts.values()) == 0
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()


def test_card_fixtures_import_no_jax():
    """chip_smoke.py's helpers from tests/ run where JAX is absent."""
    code = ("import sys\n"
            "import torch_port_fixtures, torch_train_fixtures, "
            "torch_chunk_fixtures, torch_capture_fixtures, "
            "torch_quality_fixtures\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') "
            "or m.startswith('taichi_3d_gaussian_splatting_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"


def _probes():
    return [importlib.import_module(
        f"taichi_3d_gaussian_splatting_torch.probes.{name}")
        for name in PROBE_NAMES]


def _probe_calls(make):
    """(module, call) per probe wrapper, its tensors made by make(tensor)."""
    S4, S1, S3, S2, S5, S6 = _probes()
    slab = make(torch.zeros((16, 128)))
    ranges = make(torch.zeros(2, dtype=torch.int32))
    kw = dict(mode="full", num_tiles=2, tiles_per_row=2)
    return [
        (S4, lambda: S4.rgb_ablate2(slab, ranges, ranges, **kw)),
        (S3, lambda: S3.kernel_ablate(slab, ranges, ranges, **kw)),
        (S2, lambda: S2.flip_proto(slab, ranges, ranges, **kw)),
        (S1, lambda: S1.exp2_probe(make(torch.zeros((8, 128))),
                                   make(torch.zeros((256, 8))),
                                   variant="exp")),
        (S5, lambda: S5.roll_micro(make(torch.zeros((1, 256, 128))),
                                   mode="lane", reps=1)),
        (S6, lambda: S6.roll_semantics(make(torch.zeros((8, 128))))),
        (S6, lambda: S6.work_list_scan(
            make(torch.zeros((1024, 2), dtype=torch.int32))))]


@pytest.mark.parametrize("name", PROBE_NAMES)
def test_probe_main_raises_without_a_card(name, monkeypatch):
    """A probe's entry point measures the card: without one it raises
    before it builds or times anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(
        f"taichi_3d_gaussian_splatting_torch.probes.{name}")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        module.main([])


def test_probe_wrappers_on_other_devices_raise():
    """A probe wrapper given neither CPU nor CUDA tensors raises; none
    counts a launch."""
    meta = torch.device("meta")
    for module, call in _probe_calls(lambda t: t.to(meta)):
        module.reset_launch_counts()
        with pytest.raises(RuntimeError, match="cpu or cuda"):
            call()
        assert sum(module.launch_counts.values()) == 0


def test_probe_cuda_launch_without_cuda_raises(monkeypatch):
    """CUDA inputs on a machine without the toolchain: the probe library's
    build raises out of each wrapper, nothing falls back to the plain
    version and no launch is counted."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernels build and launch")
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has a CUDA toolkit")
    monkeypatch.setattr(_build, "_probe_library", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    for module, call in _probe_calls(_OnCuda):
        module.reset_launch_counts()
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
        assert sum(module.launch_counts.values()) == 0
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_probe_library()


def _package_modules():
    """(dotted name, package, syntax tree) of every module of the port;
    package is the dotted name of the package the module's relative
    imports start from."""
    root = os.path.join(REPO, PACKAGE)
    for path in sorted(glob.glob(os.path.join(root, "**", "*.py"),
                                 recursive=True)):
        parts = os.path.relpath(path, REPO)[:-3].split(os.sep)
        package = ".".join(parts[:-1])
        if parts[-1] == "__init__":
            parts.pop()
        with open(path) as f:
            yield ".".join(parts), package, ast.parse(f.read(), path)


def _imported(package, tree):
    """Every module a module of `package` imports anywhere in its body, as
    an absolute name; `from m import x` gives both m and m.x (x may be a
    submodule)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module
            if node.level:
                parts = package.split(".")
                parts = parts[:len(parts) - node.level + 1]
                base = ".".join(parts + ([base] if base else []))
            yield base
            yield from (f"{base}.{a.name}" for a in node.names)


def _imports_of(prefixes):
    return {name: set(_imported(package, tree))
            for name, package, tree in _package_modules()
            if name.startswith(prefixes)}


def test_the_layers_below_the_trainer_do_not_import_it():
    """Nothing under parallel/ or ops/ imports the training loop: the batch
    step takes its per-view gradients and its update from
    training/step.py."""
    trainer = f"{PACKAGE}.training.trainer"
    found = _imports_of((f"{PACKAGE}.parallel", f"{PACKAGE}.ops"))
    bad = {name: sorted(m for m in mods if m.startswith(trainer))
           for name, mods in found.items()}
    assert not {k: v for k, v in bad.items() if v}
    assert f"{PACKAGE}.training.step" in found[f"{PACKAGE}.parallel.sharding"]


def test_ops_import_neither_training_nor_parallel():
    found = _imports_of((f"{PACKAGE}.ops",))
    assert f"{PACKAGE}.ops._build" in found
    bad = {name: sorted(m for m in mods if m.startswith(
        (f"{PACKAGE}.training", f"{PACKAGE}.parallel")))
        for name, mods in found.items()}
    assert not {k: v for k, v in bad.items() if v}


def test_only_the_build_module_touches_the_kernel_library():
    """Outside ops/_build.py (and the probes, which have a library of their
    own) no module names a `t3dgs_` symbol, loads the library, passes a
    stream or keeps a launch count: every wrapper goes through
    `_build.on_card` and `_build.launch`."""
    bad = []
    for name, _, tree in _package_modules():
        if name == f"{PACKAGE}.ops._build" or name.startswith(
                f"{PACKAGE}.probes"):
            continue
        for node in ast.walk(tree):
            text = (node.attr if isinstance(node, ast.Attribute)
                    else node.id if isinstance(node, ast.Name)
                    else node.value if isinstance(node, ast.Constant)
                    and isinstance(node.value, str) else None)
            if text is None:
                continue
            if (text.startswith("t3dgs_")
                    or text in ("load_library", "cuda_stream")
                    or (text == "launch_counts" and isinstance(
                        getattr(node, "ctx", None), ast.Store))):
                bad.append((name, node.lineno, text))
    assert not bad
    assert callable(_build.on_card) and callable(_build.launch)


@pytest.mark.parametrize("where", [torch.zeros(2), torch.device("cpu"),
                                   "cpu", torch.zeros(0, device="meta")],
                         ids=["cpu-tensor", "cpu-device", "cpu-name", "meta"])
def test_on_card_takes_a_tensor_or_a_device(where):
    """The CPU runs the plain version; any device but the CPU and CUDA
    raises, and neither loads the kernel library."""
    if str(getattr(where, "device", where)) == "cpu":
        assert _build.on_card(where, "test") is False
    else:
        with pytest.raises(RuntimeError, match="test runs on cpu or cuda"):
            _build.on_card(where, "test")


def test_smoke_launch_checks_read_a_snapshot_of_the_registry():
    """chip_smoke.py's launch checks take a copy of `_build.launch_counts`:
    a kernel that never launched reads 0 there (a render-only phase has
    launched no backward kernel), and counts out of step fail."""
    from chip_smoke import check_loss_launches, check_projection_launches

    def fail(msg):
        raise AssertionError(msg)

    render = _build.launch_counts.copy()
    render.update(blend_forward_rgb=3, project_forward=3)
    check_projection_launches(render, "render", fail)
    train = render.copy()
    train.update(blend_forward=2, project_forward=2, blend_backward=2,
                 project_backward=2, image_loss=2)
    check_projection_launches(train, "train", fail)
    check_loss_launches(train, "train", fail)
    train["project_backward"] += 1
    with pytest.raises(AssertionError, match="projection kernels"):
        check_projection_launches(train, "train", fail)
