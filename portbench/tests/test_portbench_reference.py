"""On the CPU at a tiny size, the plain reference agrees with the port's
plain path: the render of each pose, and the checked training steps
(losses, first gradients, the change of the scene, the statistics)."""

import shutil
import tempfile

import pytest
import torch

from portbench.harness import spec
from portbench.reference import compare


@pytest.mark.parametrize("pose", [0, 3, 5])
def test_render_matches_the_port(tiny, pose):
    cell = tiny("tiny-render")
    drv = spec.driver("render")
    s = drv.setup(cell, 7, torch.device("cpu"))
    prog = s.frame(pose)
    ref = drv.reference_image(s, pose)
    readings = compare.image_readings([prog], [ref])
    assert float(prog.abs().max()) > 0.05
    assert readings["image_max_abs"] < 1e-5


def test_training_steps_match_the_port(tiny):
    cell = tiny("tiny-train")
    drv = spec.driver("train")
    device = torch.device("cpu")
    x = drv.make_inputs(cell, 11, device)
    root = tempfile.mkdtemp()
    try:
        paths = drv.write_dataset(x, root)
        trainer, _, one_step = drv.open_trainer(cell, 11, paths, root, device)
        prog = drv.program_side(cell, trainer, one_step)
    finally:
        shutil.rmtree(root)
    ref = drv.reference_side(cell, x, 11, device)
    readings = compare.train_readings(prog, ref)
    assert all(v < 1e-5 for v in readings.values()), readings
    assert ref.losses[0] > 1e-3
    assert float(torch.linalg.norm(ref.end_pc - ref.start_pc)) > 0


def test_pair_counts_add_up(tiny):
    cell = tiny("tiny-render")
    drv = spec.driver("render")
    s = drv.setup(cell, 7, torch.device("cpu"))
    _, counts = drv.reference_image(s, 1, counts=True)
    assert counts.keys > 0 and counts.contributing > 0
    assert counts.contributing + counts.skipped <= 256 * counts.keys
    assert counts.below_last_skipped <= counts.skipped
