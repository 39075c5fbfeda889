"""The port's experiment gate (taichi_3d_gaussian_splatting_torch/ci/
run_experiment.py) against the JAX package's ci/run_experiment.py: the
same metrics give byte-equal markdown and, with --skip_training, the same
exit codes and output; one gate run trains through the port's train CLI on
the CPU (`--device cpu`)."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from taichi_3d_gaussian_splatting_torch.ci import run_experiment as port_gate

from test_ci_experiment import _write_metrics
from torch_train_fixtures import config_dict, write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_gate():
    """ci/run_experiment.py as a module of its own name (its functions
    import no JAX; its main imports the JAX TrainConfig)."""
    spec = importlib.util.spec_from_file_location(
        "jax_ci_run_experiment", os.path.join(REPO, "ci", "run_experiment.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _write_long_metrics(path):
    """A run's worth of records: losses every step, validations with
    values that need rounding, keys logged once."""
    rng = np.random.default_rng(0)
    with open(path, "w") as f:
        for it in range(0, 60, 3):
            rec = {"iteration": it, "train/loss": float(rng.uniform(0, 1)),
                   "train/l1_loss": float(rng.uniform(0, 1) * 1e-5)}
            if it % 15 == 0 and it:
                rec.update({"val/psnr": float(rng.uniform(10, 40)),
                            "val/ssim": float(rng.uniform(0, 1)),
                            "val/inference_time": 1.234567891e-3})
            if it == 30:
                rec["densify/num_fillable"] = 123456789.0
            f.write(json.dumps(rec) + "\n")


@pytest.mark.parametrize("write", [_write_metrics, _write_long_metrics],
                         ids=["ci_records", "long_run"])
def test_markdown_is_byte_equal(tmp_path, write):
    path = str(tmp_path / "metrics.jsonl")
    write(path)
    jax_gate = _jax_gate()
    final, history = port_gate.read_metrics(path)
    assert (final, history) == jax_gate.read_metrics(path)
    assert port_gate.render_markdown(final, history).encode() == \
        jax_gate.render_markdown(final, history).encode()


@pytest.mark.parametrize("targets, code", [
    (("--target_psnr", "25.0", "--target_ssim", "0.86"), 0),
    ((), 0),
    (("--target_psnr", "30.0"), 1),
    (("--target_psnr", "25.0", "--target_ssim", "0.9"), 1),
], ids=["pass", "no_target", "psnr_missed", "ssim_missed"])
def test_skip_training_exit_codes_match_jax(tmp_path, targets, code):
    log_dir = tmp_path / "logs"
    os.makedirs(log_dir)
    _write_metrics(str(log_dir / "metrics.jsonl"))
    cfg = tmp_path / "c.yaml"
    cfg.write_text(f"summary-writer-log-dir: {log_dir}\n")

    def run(command, summary):
        return subprocess.run(
            command + ["--train_config", str(cfg), "--skip_training",
                       "--output", str(tmp_path / summary), *targets],
            capture_output=True, text=True, cwd=REPO,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})

    jax = run([sys.executable, os.path.join(REPO, "ci", "run_experiment.py")],
              "jax.md")
    port = run([sys.executable, "-m",
                "taichi_3d_gaussian_splatting_torch.ci.run_experiment"],
               "port.md")
    assert jax.returncode == code, jax.stdout + jax.stderr
    assert port.returncode == code, port.stdout + port.stderr
    assert port.stdout == jax.stdout
    assert (tmp_path / "port.md").read_bytes() == \
        (tmp_path / "jax.md").read_bytes()
    line = "quality gate passed" if code == 0 else "QUALITY GATE FAILED"
    assert line in port.stdout


def test_gate_trains_through_the_port_on_cpu(tmp_path, capsys):
    """4 iterations at 32x32 with a validation at 2 and the final one:
    the summary holds both, and a low PSNR target passes."""
    root = str(tmp_path)
    write_dataset(root)
    cfg = tmp_path / "train.yaml"
    with open(cfg, "w") as f:
        yaml.safe_dump(config_dict(root, num_iterations=4, val_interval=2),
                       f)
    summary = tmp_path / "summary.md"
    port_gate.main(["--train_config", str(cfg), "--device", "cpu",
                    "--target_psnr", "5.0", "--output", str(summary)])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("quality gate passed"), out
    text = summary.read_text()
    progression = text.split("## val/psnr progression")[1]
    rows = [line for line in progression.splitlines()
            if line.startswith("| ") and line[2].isdigit()]
    assert [int(r.split("|")[1]) for r in rows] == [2, 4], text
    assert "| train/loss | 3 |" in text


def test_gate_reports_a_failed_training(tmp_path, capsys, monkeypatch):
    """A training that fails: `training failed`, and the train CLI's return
    code as the gate's."""
    cfg = tmp_path / "train.yaml"
    with open(cfg, "w") as f:
        yaml.safe_dump(config_dict(str(tmp_path)), f)
    calls = []

    def failing_train(train_config, device):
        calls.append((train_config, device))
        return 3

    monkeypatch.setattr(port_gate, "train", failing_train)
    with pytest.raises(SystemExit) as exit_info:
        port_gate.main(["--train_config", str(cfg)])
    assert exit_info.value.code == 3
    assert calls == [(str(cfg), "cuda")]     # the card by default
    assert capsys.readouterr().out == "training failed\n"
