"""The `densify` kind at a tiny size on the CPU (its own benchmark fixture,
`data/benchmark-densify.json`): the cell's pieces resolve by name, a sound
run is correct and reports the training cells' metrics, the reference's
round and the port's agree exactly here, and the control (the reference in
bfloat16) and a planted fault (the round's single-frame gradient threshold
ten times the configuration's) come out not correct."""

import contextlib
import dataclasses
import io
import json
import shutil
import tempfile
import time

import pytest
import torch

from conftest import DATA
from portbench.harness import spec
from portbench.reference import compare

BENCHMARK = DATA + "/benchmark-densify.json"
CELL = "tiny-train-densify"


def _run(seed=2147483999, seconds=0.5):
    from portbench.harness.main import main
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["--workload", CELL, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", "0"], time.time(),
                  require_card=False, benchmark_path=BENCHMARK, pieces=DATA)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def _fails(readings, limits):
    return any(not readings[k] <= v for k, v in limits.items())


def test_the_cells_pieces_resolve():
    for name in ("truck1m-train-densify", "truck1m-render-walk"):
        c = spec.load_cell(name)
        assert c.config["points"] == 1030000 and c.chips == 1
        assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    c = spec.load_cell("truck1m-train-densify")
    assert spec.driver(c.traffic["kind"]).run
    assert {m["name"] for m in c.end_to_end} == {"setup_s", "step_ms"}
    assert {m["name"] for m in c.per_layer} == {
        "device_idle_pct.train", "mfu.train", "blend_bwd_roofline.train",
        "binning_ms.train", "loss_ms.train", "adam_ms.train",
        "densify_ms.train", "densify_roofline.train",
        "densify_idle_ms.train"}
    from portbench.reference import densify as RD
    assert RD.controller(c.config["controller"])
    assert RD.due(int(c.traffic["checked_round"]),
                  RD.controller(c.config["controller"])) == (True, True)
    tiny = spec.load_cell(CELL, BENCHMARK, DATA)
    assert tiny.limits == c.limits


def test_the_new_readers_read_what_the_driver_gives():
    r = {"densify": {"ms": 2.0, "idle_ms": 0.5, "slots": 1000,
                     "filled": 10, "splits": 4, "resets": 1}}
    from portbench.work.densify import round_bound_ms
    assert spec.reader("densify_ms.train")(r) == 2.0
    assert spec.reader("densify_idle_ms.train")(r) == 0.5
    assert spec.reader("densify_roofline.train")(r) == pytest.approx(
        100.0 * round_bound_ms(1000, 10, 4, 1) / 2.0)
    for name in ("densify_ms.train", "densify_roofline.train",
                 "densify_idle_ms.train"):
        assert spec.reader(name)({"unit_ms": 3.0}) is None


def test_a_sound_run_is_correct():
    rc, line, err = _run()
    assert rc == 0 and line["correct"] is True, err[-2000:]
    assert set(line["metrics"]) == {"setup_s", "step_ms"}
    assert set(line["checks"]) == {
        "loss_gap", "grad_gap", "change_gap", "stats_gap", "count_gap",
        "validity_gap", "filled_gap", "pool_gap"}
    assert line["checks"]["count_gap"]["value"] == 0.0


def test_control_and_fault_fail():
    cell = spec.load_cell(CELL, BENCHMARK, DATA)
    drv = spec.driver("densify")
    device = torch.device("cpu")
    seed = 5
    x = drv.make_inputs(cell, seed, device)
    root = tempfile.mkdtemp()
    try:
        paths = drv.write_dataset(x, root)
        trainer, _, loop = drv.open_trainer(cell, seed, paths, root, device)
        prog = drv.program_side(cell, trainer, loop)
        trainer.logger.close()
    finally:
        shutil.rmtree(root)
    assert x.handover["round"]["counts"]["num_fillable"] > 0
    ref = drv.reference_side(cell, x, seed, device)
    ctl = drv.reference_side(cell, x, seed, device, dtype=torch.bfloat16)
    sound = {**compare.train_readings(prog, ref),
             **drv.round_checks(cell, x, device)}
    control = {**compare.train_readings(ctl, ref),
               **drv.control_round_checks(cell, x, device)}
    fault = drv.faulty_round_checks(cell, x, device)
    assert not _fails(sound, cell.limits)
    assert _fails(control, cell.limits)
    assert _fails(fault, {k: cell.limits[k] for k in fault})


def test_a_planted_threshold_fault_is_not_correct(monkeypatch):
    """The program's round with the single-frame gradient threshold ten
    times the configuration's."""
    from taichi_3d_gaussian_splatting_torch.training import trainer as T
    densify_step = T.densify_step

    def tenfold(*args):
        cfg = args[8]
        key = "densification_view_space_position_gradients_threshold"
        return densify_step(*args[:8], dataclasses.replace(
            cfg, **{key: getattr(cfg, key) * 10.0}), *args[9:])

    monkeypatch.setattr(T, "densify_step", tenfold)
    rc, line, _ = _run()
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["count_gap"]["value"] > 0.1


def test_the_inputs_are_a_scene_as_a_round_leaves_it():
    """No point of the true scene or of the one the trainer loads starts
    below the transparent threshold; the true scene is the base recipe's
    draws with those alphas folded above it."""
    cell = spec.load_cell(CELL, BENCHMARK, DATA)
    drv = spec.driver("densify")
    t = cell.config["controller"]["transparent_alpha_threshold"]
    x = drv.make_inputs(cell, 7, torch.device("cpu"))
    assert (x.feats[:, 7] >= t).all()
    params = drv.after_round(cell).config["scene"]
    assert params["base"] == cell.config["scene"]["recipe"]
    n = int(cell.config["points"])
    _, base = spec.recipe(params["base"]).make(
        n, params, torch.Generator().manual_seed(3))
    _, folded = spec.recipe("after_round").make(
        n, params, torch.Generator().manual_seed(3))
    assert (base[:, 7] < t).any() and (folded[:, 7] >= t).all()
    low = base[:, 7] < t
    assert torch.equal(folded[low, 7], 2.0 * t - base[low, 7])
    assert torch.equal(folded[~low], base[~low])
