"""The control, the plain reference computed in bfloat16 (the precision
below the configurations' float32) put in the program's place, comes out
not correct against each cell's limits; here at a tiny size on the CPU,
on the card at the cells' own sizes by `portbench/calibrate.py`."""

import shutil
import tempfile

import pytest
import torch

from portbench.harness import spec
from portbench.reference import compare

RENDER_CELLS = ("truck2m-render-walk", "truck430k-render-walk")
TRAIN_CELLS = ("truck430k-train-late", "truck2m-train-late")


def _fails(readings, limits):
    return any(not readings[k] <= v for k, v in limits.items())


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_render_control_fails(tiny, seed):
    cell = tiny("tiny-render")
    drv = spec.driver("render")
    s = drv.setup(cell, seed, torch.device("cpu"))
    ref = [drv.reference_image(s, p) for p in (0, 1, 2)]
    ctl = [drv.reference_image(s, p, dtype=torch.bfloat16) for p in (0, 1, 2)]
    prog = [s.frame(p) for p in (0, 1, 2)]
    for name in RENDER_CELLS:
        limits = spec.load_cell(name).limits
        assert _fails(compare.image_readings(ctl, ref), limits)
        assert not _fails(compare.image_readings(prog, ref), limits)


@pytest.mark.parametrize("seed", [3, 4])
def test_train_control_fails(tiny, seed):
    cell = tiny("tiny-train")
    drv = spec.driver("train")
    device = torch.device("cpu")
    x = drv.make_inputs(cell, seed, device)
    ref = drv.reference_side(cell, x, seed, device)
    ctl = drv.reference_side(cell, x, seed, device, dtype=torch.bfloat16)
    root = tempfile.mkdtemp()
    try:
        paths = drv.write_dataset(x, root)
        trainer, _, one_step = drv.open_trainer(cell, seed, paths, root,
                                                device)
        prog = drv.program_side(cell, trainer, one_step)
    finally:
        shutil.rmtree(root)
    for name in TRAIN_CELLS:
        limits = spec.load_cell(name).limits
        assert _fails(compare.train_readings(ctl, ref), limits)
        assert not _fails(compare.train_readings(prog, ref), limits)


def test_tiny_limits_are_the_cells():
    from conftest import BENCHMARK, DATA
    assert (spec.load_cell("tiny-render", BENCHMARK, DATA).limits
            == spec.load_cell("truck2m-render-walk").limits)
    assert (spec.load_cell("tiny-train", BENCHMARK, DATA).limits
            == spec.load_cell("truck430k-train-late").limits)
