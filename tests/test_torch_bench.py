"""The port's bench (`python -m taichi_3d_gaussian_splatting_torch.bench`)
against the repository's `bench.py`: the metric name and the baselines,
the scene it loads under each environment knob (bitwise), one training
step against bench.py's JAX composition (`bench.py:352-375`, rebuilt here
from the JAX package), the record's keys, and the exit codes without a
card, with a missing heavy-scene generator and after a failed training
measurement.

The training step is compared at rtol 1e-4 and an atol of 1e-5 times the
field's largest magnitude (the blends and the routing sum in other
orders), the tolerance of tests/test_torch_training.py."""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from taichi_3d_gaussian_splatting_tpu.camera import CameraInfo as JCamera
from taichi_3d_gaussian_splatting_tpu.ops.capacity import (
    auto_capacity_config)
from taichi_3d_gaussian_splatting_tpu.ops.rasterizer import (
    RasterizerConfig as JRasterizerConfig, rasterize_with_vjp as
    jrasterize_with_vjp)
from taichi_3d_gaussian_splatting_tpu.ops.sh import (
    feature_sh_band_mask as jfeature_sh_band_mask)
from taichi_3d_gaussian_splatting_tpu.training import controller as JC
from taichi_3d_gaussian_splatting_tpu.training import loss as JL
from taichi_3d_gaussian_splatting_torch import bench as tbench
from taichi_3d_gaussian_splatting_torch.models.scene import (
    GaussianPointCloudScene as TScene, SceneConfig as TSceneConfig)
from taichi_3d_gaussian_splatting_torch.ops import _build
from taichi_3d_gaussian_splatting_torch.ops.rasterizer import (
    RasterizerConfig as TRasterizerConfig)

from torch_train_fixtures import FOCAL, H, W, write_dataset

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(REPO, "bench.py")
CPU = torch.device("cpu")
PORT_KEYS = {"backend", "device", "power_limit_w"}


def _load_bench_py():
    """The repository's bench.py as a module (its top level imports no
    JAX; its functions import the JAX package when called)."""
    spec = importlib.util.spec_from_file_location("jax_bench", BENCH_PY)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jbench = _load_bench_py()


def _bench_py_keys(function):
    """The keys that bench.py's `function` writes: those of its dict
    literals and of its `record[...] = ...` assignments."""
    with open(BENCH_PY) as f:
        tree = ast.parse(f.read())
    fn = next(node for node in tree.body
              if isinstance(node, ast.FunctionDef) and node.name == function)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys}
        elif (isinstance(node, ast.Assign)
              and isinstance(node.targets[0], ast.Subscript)
              and getattr(node.targets[0].value, "id", None) == "record"):
            keys.add(node.targets[0].slice.value)
    return keys


def _clear_bench_env(monkeypatch):
    for key in list(os.environ):
        if key.startswith("BENCH_"):
            monkeypatch.delenv(key)


@pytest.mark.parametrize("points,kind", [
    (None, ""), (None, "heavy"), ("2000", ""), ("2000", "heavy"),
    ("430000", ""), ("700000", ""), ("1030000", ""), ("1600000", "heavy"),
    ("2080000", "heavy"), ("9000000", "")])
def test_names_and_baselines_match_bench_py(monkeypatch, points, kind):
    _clear_bench_env(monkeypatch)
    if points is not None:
        monkeypatch.setenv("BENCH_POINTS", points)
    monkeypatch.setenv("BENCH_SCENE_KIND", kind)
    assert tbench._bench_metric_name() == jbench._bench_metric_name()
    n = int(points or (1030000 if kind == "heavy" else 430000))
    for m in (n - 1, n, n + 1):
        assert tbench._baseline_points(m) == jbench._baseline_points(m)
        assert tbench._baseline_fps(m) == jbench._baseline_fps(m)
    assert tbench.BASELINE_FPS_BY_POINTS == jbench.BASELINE_FPS_BY_POINTS


def _write_scene_file(path):
    rng = np.random.default_rng(3)
    n = 200
    pc = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    feats = rng.normal(size=(n, 56)).astype(np.float32)
    scene = TScene.from_numpy(pc, feats, np.zeros(n), np.zeros(n), "cpu")
    (scene.to_ply if path.endswith(".ply") else scene.to_parquet)(path)


@pytest.mark.parametrize("case", ["synthetic", "heavy", "parquet", "ply",
                                  "synthetic sorted", "parquet sorted"])
def test_load_scene_matches_bench_py(monkeypatch, tmp_path, case):
    """Bitwise: the same positions and features, in the same order."""
    _clear_bench_env(monkeypatch)
    if case.startswith("synthetic"):
        monkeypatch.setenv("BENCH_POINTS", "2000")
    elif case == "heavy":
        monkeypatch.setenv("BENCH_SCENE_KIND", "heavy")
        monkeypatch.setenv("BENCH_POINTS", "3000")
    else:
        path = str(tmp_path / ("scene.ply" if case == "ply"
                               else "scene.parquet"))
        _write_scene_file(path)
        monkeypatch.setenv("BENCH_SCENE", path)
    if case.endswith("sorted"):
        monkeypatch.setenv("BENCH_SPATIAL_SORT", "1")
    t_pc, t_feats = tbench.load_scene(CPU)
    j_pc, j_feats = jbench.load_scene()
    for t, j in ((t_pc, j_pc), (t_feats, j_feats)):
        assert t.device == CPU and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    if case.endswith("sorted"):   # the sort moved the points
        monkeypatch.setenv("BENCH_SPATIAL_SORT", "0")
        assert not torch.equal(tbench.load_scene(CPU)[0], t_pc)


def _jax_bench_step(pc, feats, cam):
    """bench.py:333-375 with the JAX package: one step from Adam's and the
    controller's initial state. Returns (pc, feats, feature adam state,
    position adam state, controller state, loss)."""
    n = pc.shape[0]
    cfg = JRasterizerConfig(near_plane=0.4, far_plane=1000.0,
                            max_tiles_per_point=32)
    invalid = jnp.zeros((n,), jnp.int8)
    obj = jnp.zeros((n,), jnp.int32)
    q_cam = jnp.array([[0.0, 0.0, 0.0, 1.0]])
    t_cam = jnp.zeros((1, 3))
    cfg = auto_capacity_config(pc, feats, invalid, obj, [(q_cam, t_cam)],
                               cam, cfg, headroom=2.0)
    h, w = cam.camera_height, cam.camera_width
    gt = jnp.array(np.random.default_rng(1).uniform(0, 1, (h, w, 3)),
                   jnp.float32)
    loss_fn = JL.LossFunction(JL.LossFunctionConfig())
    fopt = optax.adam(1e-3)
    popt = optax.adam(1e-5)
    band_mask = jfeature_sh_band_mask(jnp.int32(3))

    @jax.jit
    def step(pc, feats, fstate, pstate, ctrl):
        qn = feats[:, 0:4] / jnp.maximum(jnp.linalg.norm(
            feats[:, 0:4], axis=1, keepdims=True), 1e-12)
        feats = feats.at[:, 0:4].set(qn)
        result, vjp_fn = jrasterize_with_vjp(
            pc, feats, invalid, obj, q_cam, t_cam, cam, cfg)

        def image_loss(image, features):
            img = jnp.clip(image, 0.0, 1.0)
            loss, l1, ld = loss_fn(img, gt, point_invalid_mask=invalid,
                                   pointcloud_features=features)
            return loss, (l1, ld, img)

        (loss, _), (g_image, g_feats_direct) = jax.value_and_grad(
            image_loss, argnums=(0, 1), has_aux=True)(result.image, feats)
        grad_pc, grad_feats_raster, stats = vjp_fn(g_image)
        grad_feats = grad_feats_raster * band_mask + g_feats_direct
        uf, fstate = fopt.update(grad_feats, fstate, feats)
        feats = optax.apply_updates(feats, uf)
        up, pstate = popt.update(grad_pc, pstate, pc)
        pc = optax.apply_updates(pc, up)
        ctrl = JC.update_stats(ctrl, stats, grad_pc, result.aux.in_frustum)
        return pc, feats, fstate, pstate, ctrl, loss

    return step(pc, feats, fopt.init(feats), popt.init(pc),
                JC.ControllerState.zeros(n))


def test_train_step_matches_bench_py(tmp_path):
    """One port bench step at 32x32 against bench.py's JAX step, on the
    init cloud of tests/torch_train_fixtures.py (depths on a ladder, so no
    keys tie) with anisotropic scales: the loss, positions, features, both
    Adam states and the controller statistics."""
    write_dataset(str(tmp_path))
    scene = TScene.from_parquet(str(tmp_path / "pc.parquet"),
                                TSceneConfig(initial_alpha=1.0), device="cpu")
    pc = scene.point_cloud.numpy()
    feats = scene.point_cloud_features.numpy().copy()
    feats[:, 4:7] += np.random.default_rng(5).uniform(
        -0.5, 0.5, (feats.shape[0], 3))
    intr = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]],
                    np.float32)

    j_pc, j_feats, j_fstate, j_pstate, j_ctrl, j_loss = _jax_bench_step(
        jnp.asarray(pc), jnp.asarray(feats), JCamera(intr, H, W))
    step = tbench.make_train_step(tbench.bench_camera(H, W, FOCAL), CPU)
    t_state, t_loss = step(tbench.initial_train_state(
        torch.tensor(pc), torch.tensor(feats)))

    pairs = {"loss": (t_loss, j_loss),
             "positions": (t_state.point_cloud, j_pc),
             "features": (t_state.point_cloud_features, j_feats),
             "feature mu": (t_state.opt_features.mu, j_fstate[0].mu),
             "feature nu": (t_state.opt_features.nu, j_fstate[0].nu),
             "position mu": (t_state.opt_positions.mu, j_pstate[0].mu),
             "position nu": (t_state.opt_positions.nu, j_pstate[0].nu)}
    for f in JC.ControllerState._fields:
        pairs[f] = (getattr(t_state.ctrl, f), getattr(j_ctrl, f))
    for name, (t, j) in pairs.items():
        j = np.asarray(j, np.float64)
        scale = max(np.abs(j).max(), 1e-30)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)
    # a step moves the positions by ~1e-5 (lr 1e-5), below rtol 1e-4 of
    # them: the displacement itself agrees to one float32 spacing
    np.testing.assert_allclose(
        t_state.point_cloud.numpy() - pc, np.asarray(j_pc) - pc, rtol=0,
        atol=np.spacing(np.abs(pc).max()), err_msg="position update")
    assert np.abs(np.asarray(j_pc) - pc).max() > 5e-6
    assert float(np.abs(np.asarray(j_ctrl.accumulated_num_pixels)).max()) > 0
    assert float(j_loss) > 0
    assert int(t_state.opt_features.count) == int(j_fstate[0].count) == 1


def test_record_at_64x48_on_the_cpu(monkeypatch):
    """The measuring functions at 64x48 on the CPU (plain blends, no
    launch counted) and `build_record`: exactly bench.py's keys plus
    backend, device and power_limit_w; the training keys only with a
    training measurement; counters 0."""
    _clear_bench_env(monkeypatch)
    monkeypatch.setenv("BENCH_POINTS", "2000")
    pc, feats = tbench.load_scene(CPU)
    cam = tbench.bench_camera(48, 64, tbench.FOCAL * 64 / tbench.W)
    cfg = TRasterizerConfig(near_plane=tbench.NEAR, far_plane=tbench.FAR,
                            rgb_only=True)
    _build.reset_launch_counts()
    frame_ms, aux = tbench.measure_render(pc, feats, cam, cfg, CPU, iters=2,
                                          warmup=1)
    train_ms = tbench.measure_train_step(pc, feats, cam, CPU, reps=1,
                                         warmup=1)
    assert sum(_build.launch_counts.values()) == 0
    assert frame_ms > 0 and all(ms > 0 for ms in train_ms)
    name, power = tbench.device_info(CPU)
    record = tbench.build_record(2000, frame_ms, "packed8", aux, "torch-cpu",
                                 name, power, train_ms)
    bench_keys = _bench_py_keys("main")
    assert set(record) == bench_keys | PORT_KEYS
    render_only = tbench.build_record(2000, frame_ms, "packed8", aux,
                                      "torch-cpu", name, power)
    train_keys = {"train_step_ms", "densify_ms", "train_step_amortized_ms",
                  "train_iters_per_sec"}
    assert set(render_only) == (bench_keys - train_keys) | PORT_KEYS
    assert record["metric"] == "render_fps_976x544_2k_points"
    assert record["value"] == round(1000.0 / frame_ms, 2)
    assert record["baseline_points"] == 430000
    assert (record["key_overflow"], record["big_point_overflow"],
            record["tile_cap_overflow"]) == (0, 0, 0)
    assert (record["backend"], record["device"],
            record["power_limit_w"]) == ("torch-cpu", "cpu", None)
    assert record["train_step_amortized_ms"] == round(
        train_ms[0] + train_ms[1] / 100.0, 2)
    json.dumps(record)


def test_no_card_prints_the_error_record_and_exits_2():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench runs on it")
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "taichi_3d_gaussian_splatting_torch.bench"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2, proc.stderr[-2000:]
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(record) == _bench_py_keys("_emit_error_record")
    assert record["metric"] == "render_fps_976x544_430k_points"
    assert record["value"] == 0.0 and record["vs_baseline"] == 0.0
    assert "torch.cuda.is_available() is False" in record["error"]


def test_missing_heavy_generator_exits_2(monkeypatch, tmp_path, capsys):
    _clear_bench_env(monkeypatch)
    monkeypatch.setenv("BENCH_SCENE_KIND", "heavy")
    monkeypatch.setattr(tbench, "REPO_ROOT", str(tmp_path))
    with pytest.raises(SystemExit) as exit_info:
        tbench.main(["--device", "cpu"])
    assert exit_info.value.code == 2
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["value"] == 0.0
    assert "synthetic_checkpoint.py" in record["error"]


def test_failed_training_prints_the_render_record_and_exits_1(monkeypatch,
                                                             capsys):
    _clear_bench_env(monkeypatch)
    monkeypatch.setenv("BENCH_POINTS", "300")
    monkeypatch.setenv("BENCH_ITERS", "1")

    def fail(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("out of memory in the test")

    monkeypatch.setattr(tbench, "measure_train_step", fail)
    with pytest.raises(SystemExit) as exit_info:
        tbench.main(["--device", "cpu"])
    assert exit_info.value.code == 1
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["value"] > 0
    assert record["train_error"] == "OutOfMemoryError: out of memory in the test"
    assert "train_step_ms" not in record
