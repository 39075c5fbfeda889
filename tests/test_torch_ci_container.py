"""The port's experiment container, its GPU workflow and its quickstart
notebook, checked on the CPU (no docker, no card, no runner):

- taichi_3d_gaussian_splatting_torch/ci/entrypoint.sh: its syntax, and its
  run with a stub `python` on PATH that records its argv: the contract of
  ci/entrypoint.sh (exit 1 without TRAIN_CONFIG, the /data link, the
  defaults parsed out of ci/entrypoint.sh itself) on the port's gate with
  --device cuda;
- ci/Dockerfile.cuda: every COPY source and the ENTRYPOINT path in the
  tree, a CUDA devel image, every third-party module the port imports in
  its pip lines, and nothing of JAX;
- .github/workflows/run_experiment_cuda.yml: the JAX workflow's trigger,
  label step, bars and comment, a GPU runner, every command's flags
  accepted by the port CLI's own parser;
- tools/run_on_cuda_quickstart.ipynb: nbformat 4, the JAX notebook's cell
  kinds in its order and its commands' flags, every command's flags
  accepted by its CLI's parser, nothing of JAX;
- pyproject.toml's package data: every file of the port's csrc/, ci/ and
  tools/ that is not Python.

The image is not built and the workflow does not run here.
"""

import argparse
import ast
import importlib
import importlib.util
import json
import os
import pathlib
import re
import shlex
import subprocess
import sys
import tomllib

import pytest
import yaml

from chip_smoke import notebook_commands

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "taichi_3d_gaussian_splatting_torch"
ENTRYPOINT = PORT / "ci" / "entrypoint.sh"
DOCKERFILE = PORT / "ci" / "Dockerfile.cuda"
WORKFLOW = REPO / ".github" / "workflows" / "run_experiment_cuda.yml"
NOTEBOOK = PORT / "tools" / "run_on_cuda_quickstart.ipynb"
JAX_ENTRYPOINT = REPO / "ci" / "entrypoint.sh"
JAX_WORKFLOW = REPO / ".github" / "workflows" / "run_experiment.yml"
JAX_NOTEBOOK = REPO / "tools" / "run_on_tpu_quickstart.ipynb"
GATE = "taichi_3d_gaussian_splatting_torch.ci.run_experiment"
# pip's name of an imported top-level module where the two differ
PIP_NAMES = {"PIL": "pillow", "yaml": "pyyaml"}
# names of JAX's stack that none of the new files may carry
JAX_NAMES = ("jax", "taichi_3d_gaussian_splatting_tpu")


# ---- the entrypoint ----------------------------------------------------

def jax_entrypoint_defaults():
    """{variable: default} of the ${VAR:-default} expansions of
    ci/entrypoint.sh with a default (TRAIN_CONFIG's is empty)."""
    return dict(re.findall(r"\$\{(\w+):-([^}]+)\}",
                           JAX_ENTRYPOINT.read_text()))


def run_entrypoint(tmp_path, **env_vars):
    """bash ENTRYPOINT from an empty working directory with a stub `python`
    first on PATH that writes its argv, one per line, to a file; returns
    (process, the stub's argv or None, the working directory)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    argv_file = tmp_path / "argv"
    stub = bin_dir / "python"
    stub.write_text(f"#!/bin/bash\nprintf '%s\\n' \"$@\" > {argv_file}\n")
    stub.chmod(0o755)
    work = tmp_path / "work"
    work.mkdir()
    env = {k: v for k, v in os.environ.items()
           if k not in ("TRAIN_CONFIG", "TARGET_PSNR", "TARGET_SSIM",
                        "OUTPUT_SUMMARY")}
    env["PATH"] = f"{bin_dir}{os.pathsep}{env.get('PATH', '')}"
    env.update(env_vars)
    proc = subprocess.run(["bash", str(ENTRYPOINT)], cwd=work, env=env,
                          capture_output=True, text=True, timeout=60)
    argv = (argv_file.read_text().splitlines() if argv_file.exists()
            else None)
    return proc, argv, work


def test_entrypoint_shell_syntax():
    subprocess.run(["bash", "-n", str(ENTRYPOINT)], check=True, timeout=60)


def test_entrypoint_needs_train_config(tmp_path):
    proc, argv, _ = run_entrypoint(tmp_path)
    assert proc.returncode == 1
    assert "TRAIN_CONFIG is not set" in proc.stderr
    assert argv is None


def test_entrypoint_runs_the_port_gate_on_the_card(tmp_path):
    """The gate's module with --device cuda, the JAX entrypoint's
    defaults, and the data link where /data is a directory."""
    defaults = jax_entrypoint_defaults()
    assert set(defaults) == {"TARGET_PSNR", "TARGET_SSIM", "OUTPUT_SUMMARY"}
    proc, argv, work = run_entrypoint(tmp_path, TRAIN_CONFIG="exp.yaml")
    assert proc.returncode == 0, proc.stderr
    assert argv == ["-m", GATE, "--train_config", "exp.yaml",
                    "--target_psnr", defaults["TARGET_PSNR"],
                    "--target_ssim", defaults["TARGET_SSIM"],
                    "--output", defaults["OUTPUT_SUMMARY"],
                    "--device", "cuda"]
    assert (work / "data").is_symlink() == os.path.isdir("/data")
    args = parse_cli(argv)
    assert (args.device, args.target_psnr, args.target_ssim) == (
        "cuda", float(defaults["TARGET_PSNR"]),
        float(defaults["TARGET_SSIM"]))


def test_entrypoint_passes_the_variables(tmp_path):
    proc, argv, _ = run_entrypoint(
        tmp_path, TRAIN_CONFIG="a b.yaml", TARGET_PSNR="30.5",
        TARGET_SSIM="0.9", OUTPUT_SUMMARY="out/s.md")
    assert proc.returncode == 0, proc.stderr
    assert argv[argv.index("--train_config") + 1] == "a b.yaml"
    assert argv[argv.index("--target_psnr") + 1] == "30.5"
    assert argv[argv.index("--target_ssim") + 1] == "0.9"
    assert argv[argv.index("--output") + 1] == "out/s.md"
    assert argv[-2:] == ["--device", "cuda"]


# ---- the CLIs' own parsers ---------------------------------------------

class _Parsed(Exception):
    pass


def cli_main(target):
    """The `main` of a `python -m` module or of a script path under the
    repository (its directory on sys.path, as `python script` puts it)."""
    if target.endswith(".py"):
        path = REPO / target
        sys.path.insert(0, str(path.parent))
        try:
            spec = importlib.util.spec_from_file_location(
                f"_cli_{path.stem}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
        finally:
            sys.path.remove(str(path.parent))
        return module.main
    return importlib.import_module(target).main


def parse_cli(argv, target=None):
    """The namespace that the CLI's own argparse parser makes of `argv`
    (`argv` starts with `-m module` unless `target` is given): its main()
    runs up to its parse_args, which parses `argv` and stops it. An
    unknown or malformed flag exits through parser.error."""
    if target is None:
        assert argv[0] == "-m"
        target, argv = argv[1], argv[2:]
    main = cli_main(target)
    original = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        raise _Parsed(original(self, argv, namespace))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", parse)
        with pytest.raises(_Parsed) as parsed:
            main()
    return parsed.value.args[0]


def split_command(command):
    """(environment assignments, CLI target, argv) of one shell command
    `[VAR=value ...] python (-m module | script.py) args... [| ...]`."""
    tokens = shlex.split(command.split("|")[0])
    assignments = {}
    while "=" in tokens[0] and not tokens[0].startswith("-"):
        key, value = tokens.pop(0).split("=", 1)
        assignments[key] = value
    assert tokens[0] == "python", command
    if tokens[1] == "-m":
        return assignments, tokens[2], tokens[3:]
    return assignments, tokens[1], tokens[2:]


# ---- the Dockerfile ----------------------------------------------------

def dockerfile_instructions():
    """[(instruction, arguments)] with continuation lines joined."""
    text = DOCKERFILE.read_text().replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            word, _, rest = line.partition(" ")
            out.append((word.upper(), rest.strip()))
    return out


def pip_packages():
    """The package names of the Dockerfile's `pip install` commands."""
    names = set()
    for word, rest in dockerfile_instructions():
        if word != "RUN":
            continue
        for command in rest.split("&&"):
            tokens = command.split()
            if tokens[:2] != ["pip", "install"]:
                continue
            skip = False
            for token in tokens[2:]:
                if skip:
                    skip = False
                elif token in ("--index-url", "-f", "--extra-index-url"):
                    skip = True
                elif not token.startswith("-"):
                    names.add(re.split(r"[\[<>=~]", token.strip('"'))[0]
                              .lower())
    return names


def test_dockerfile_copy_and_entrypoint_exist():
    instructions = dockerfile_instructions()
    base = [rest for word, rest in instructions if word == "FROM"]
    assert len(base) == 1 and "devel" in base[0] and "12.8" in base[0]
    copies = [rest.split() for word, rest in instructions if word == "COPY"]
    assert copies
    for *sources, _ in copies:
        for source in sources:
            assert (REPO / source).exists(), source
    workdir = [rest for word, rest in instructions if word == "WORKDIR"][-1]
    assert [c[-1] for c in copies] == [workdir]
    entry = [json.loads(rest) for word, rest in instructions
             if word == "ENTRYPOINT"]
    assert entry == [["bash", str(ENTRYPOINT.relative_to(REPO))]]
    assert (REPO / entry[0][1]).is_file()


def port_third_party_modules():
    """Top-level modules the port imports that are neither the standard
    library, nor the port, nor a file of the repository (the bench puts
    benchmark/ on sys.path)."""
    modules = set()
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                modules |= {a.name.split(".")[0] for a in node.names}
            elif (isinstance(node, ast.ImportFrom) and node.level == 0
                  and node.module):
                modules.add(node.module.split(".")[0])
    first_party = {p.stem for p in REPO.glob("*/*.py")} | {PORT.name}
    return {m for m in modules
            if m not in sys.stdlib_module_names and m not in first_party}


def test_dockerfile_installs_the_port_imports_and_no_jax():
    modules = port_third_party_modules()
    assert {"torch", "numpy", "pandas", "PIL", "yaml"} <= modules
    packages = pip_packages()
    missing = {m for m in modules
               if PIP_NAMES.get(m, m).lower() not in packages}
    assert not missing, (missing, packages)
    # pandas reads and writes parquet through pyarrow
    assert "pyarrow" in packages
    assert not {"jax", "jaxlib", "optax"} & packages
    torch_line = [rest for word, rest in dockerfile_instructions()
                  if word == "RUN" and "torch" in rest][0]
    assert "download.pytorch.org/whl/cu128" in torch_line


def test_new_files_name_no_jax():
    for path in (ENTRYPOINT, DOCKERFILE, WORKFLOW, NOTEBOOK):
        text = path.read_text().lower()
        for name in JAX_NAMES:
            assert name not in text, (path, name)


# ---- the workflow -------------------------------------------------------

def workflow_commands(workflow, config):
    """{step name: [python command lines]} of the workflow's `run` steps,
    continuations joined and the label step's output as `config`."""
    out = {}
    for step in workflow["jobs"]["experiment"]["steps"]:
        run = step.get("run", "").replace("\\\n", " ").replace(
            "${{ steps.dataset.outputs.config }}", config)
        lines = [" ".join(line.split()) for line in run.splitlines()
                 if "python" in line]
        if lines:
            out[step["name"]] = lines
    return out


def test_workflow_mirrors_the_jax_workflow_on_a_gpu_runner():
    port = yaml.safe_load(WORKFLOW.read_text())
    ref = yaml.safe_load(JAX_WORKFLOW.read_text())
    # YAML 1.1 reads the key `on` as True
    assert port[True] == ref[True] == {"pull_request": {"types": ["labeled"]}}
    job, ref_job = port["jobs"]["experiment"], ref["jobs"]["experiment"]
    assert job["if"] == ref_job["if"]
    assert "gpu" in job["runs-on"] and "tpu" not in job["runs-on"]
    steps = {s.get("name"): s for s in job["steps"]}
    ref_steps = {s.get("name"): s for s in ref_job["steps"]}
    assert list(steps) == list(ref_steps)
    for name in ("Resolve dataset from label", "Comment results on PR"):
        assert steps[name] == ref_steps[name]
    assert steps[None] == ref_steps[None]       # the checkout

    config = "config/example.yaml"
    commands = workflow_commands(port, config)
    ref_commands = workflow_commands(ref, config)
    (gate,) = commands["Run experiment"]
    env, target, argv = split_command(gate)
    assert (env, target) == ({}, GATE)
    args = parse_cli(argv, target)
    assert (args.train_config, args.device, args.output) == (
        config, "cuda", "experiment_summary.md")
    # the JAX workflow's bars and flags, plus the device
    _, _, ref_argv = split_command(ref_commands["Run experiment"][0])
    assert argv == ref_argv + ["--device", "cuda"]
    (bench,) = commands["Run inference benchmark"]
    env, target, argv = split_command(bench)
    assert (env, target, argv) == (
        {"BENCH_ITERS": "100"}, "taichi_3d_gaussian_splatting_torch.bench",
        [])
    assert parse_cli(argv, target).device == "cuda"
    assert "| tee -a experiment_summary.md" in bench


# ---- the notebook --------------------------------------------------------

def test_notebook_is_nbformat_4_with_the_jax_notebooks_cells():
    nb = json.loads(NOTEBOOK.read_text())
    ref = json.loads(JAX_NOTEBOOK.read_text())
    assert nb["nbformat"] == 4
    assert ([c["cell_type"] for c in nb["cells"]]
            == [c["cell_type"] for c in ref["cells"]])
    for cell in nb["cells"]:
        assert isinstance(cell["source"], list)
        if cell["cell_type"] == "code":
            assert cell["outputs"] == [] and cell["execution_count"] is None
    clone = "".join(nb["cells"][1]["source"])
    assert "torch.cuda.get_device_name(0)" in clone
    assert "%cd " in clone and "!git clone " in clone
    try:
        import nbformat
    except ImportError:
        return
    nbformat.validate(nbformat.reads(NOTEBOOK.read_text(), as_version=4))


def test_notebook_commands_parse_and_follow_the_jax_notebook():
    """The shell commands after the clone cell, as chip_smoke.py phase 13
    reads them: each command's flags accepted by its CLI's parser; the same
    programs' flags as the JAX notebook's commands, the JAX CLIs replaced
    by the port's modules and the inference benchmark by the bench."""
    commands = notebook_commands(NOTEBOOK)
    ref_commands = notebook_commands(JAX_NOTEBOOK)
    assert len(commands) == len(ref_commands)
    replaced = {"gaussian_point_train.py":
                "taichi_3d_gaussian_splatting_torch.train",
                "gaussian_point_render.py":
                "taichi_3d_gaussian_splatting_torch.render"}
    targets = []
    for command, ref_command in zip(commands, ref_commands):
        env, target, argv = split_command(command)
        parse_cli(argv, target)
        targets.append(target)
        _, ref_target, ref_argv = split_command(ref_command)
        if ref_target == "benchmark/inference_benchmark.py":
            scene = ref_argv[ref_argv.index("--scene") + 1]
            assert (env, target, argv) == (
                {"BENCH_SCENE": scene},
                "taichi_3d_gaussian_splatting_torch.bench", [])
            continue
        assert env == {}
        assert target == replaced.get(ref_target, ref_target)
        assert argv == ref_argv
    assert targets == ["tools/prepare_colmap.py", "tools/prepare_config.py",
                       "taichi_3d_gaussian_splatting_torch.train",
                       "tools/generate_ellipse_path.py",
                       "taichi_3d_gaussian_splatting_torch.render",
                       "taichi_3d_gaussian_splatting_torch.bench"]


# ---- package data ------------------------------------------------------------

def test_package_data_ships_every_non_python_file():
    """Every file under the port's csrc/, ci/ and tools/ that is not
    Python (build outputs aside) matches a package-data glob of
    pyproject.toml, as setuptools matches them (no glob crosses a
    directory)."""
    with open(REPO / "pyproject.toml", "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            PORT.name]
    shipped = {p for pattern in globs for p in PORT.glob(pattern)}
    files = [p for d in ("csrc", "ci", "tools")
             for p in (PORT / d).rglob("*")
             if p.is_file() and p.suffix not in (".py", ".pyc")
             and "__pycache__" not in p.parts and "build" not in p.parts]
    assert {p.relative_to(PORT).as_posix() for p in files} >= {
        "csrc/probes/probe_common.cuh", "ci/entrypoint.sh",
        "ci/Dockerfile.cuda", "tools/run_on_cuda_quickstart.ipynb"}
    missing = [p.relative_to(PORT).as_posix() for p in files
               if p not in shipped]
    assert not missing, missing
