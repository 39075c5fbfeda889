"""Every piece of every cell resolves by name; an unknown name fails."""

import json
import os

import pytest

from conftest import ROOT
from portbench.harness import spec


def _benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in _benchmark()["workloads"]])
def test_cell_resolves(cell):
    c = spec.load_cell(cell)
    assert c.name == cell and c.chips in (1, 4)
    assert spec.driver(c.traffic["kind"]).run
    assert spec.recipe(c.config["scene"]["recipe"]).make
    assert c.limits
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", [m["name"] for m in _benchmark()["per_layer"]])
def test_metric_reader_resolves_and_reads_nothing_from_nothing(metric):
    assert spec.reader(metric)({}) is None


@pytest.mark.parametrize("name", ["no-such-cell", "truck430k-render"])
def test_unknown_cell_fails(name):
    with pytest.raises(KeyError):
        spec.load_cell(name)


@pytest.mark.parametrize("getter", [spec.driver, spec.recipe, spec.reader])
def test_unknown_piece_fails(getter):
    with pytest.raises(FileNotFoundError):
        getter("no_such_piece")


def test_every_config_and_cell_is_used_and_named_within_the_contract():
    b = _benchmark()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    import re
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for entry in b["configs"] + b["workloads"] + b["end_to_end"] + b["per_layer"]:
        assert name.match(entry["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))


@pytest.mark.parametrize("keys, value", [
    (("features",), 48), (("sh_degree",), 2), (("camera", "tile"), 8),
    (("render", "slab"), "wide32")])
def test_a_configuration_the_run_cannot_honour_is_refused(tiny, keys,
                                                           value):
    import copy
    cell = tiny("tiny-render")
    config = copy.deepcopy(cell.config)
    spec.honoured(config, cell.traffic)
    leaf = config
    for k in keys[:-1]:
        leaf = leaf[k]
    leaf[keys[-1]] = value
    with pytest.raises(ValueError):
        spec.honoured(config, cell.traffic)


def test_an_sh_band_above_the_degree_is_refused(tiny):
    cell = tiny("tiny-train")
    with pytest.raises(ValueError):
        spec.honoured(cell.config, dict(cell.traffic, sh_band=4))


def test_the_fixed_shapes_are_the_reference_s_and_the_program_s():
    import torch
    from portbench.reference import projection as RP
    from taichi_3d_gaussian_splatting_torch import camera
    from taichi_3d_gaussian_splatting_torch.ops.gaussian import NUM_FEATURES
    tile = spec.FIXED[("camera", "tile")]
    assert tile == RP.TILE == camera.TILE_WIDTH == camera.TILE_HEIGHT
    features = spec.FIXED[("features",)]
    assert features == NUM_FEATURES == 8 + 3 * (
        spec.FIXED[("sh_degree",)] + 1) ** 2
    for recipe in ("uniform", "heavy_tailed"):
        pc, feats = spec.recipe(recipe).make(
            64, {"layout_seed": 0}, torch.Generator().manual_seed(3))
        assert pc.shape == (64, 3) and feats.shape == (64, features)
        assert bool((feats[:, 9:24] != 0).any())
