"""The frozen work counts equal those the port's kernels were held to
(`tests/torch_chunk_fixtures.py` work) on its long-segment fixture."""

import os
import sys

import pytest
import torch

from conftest import ROOT
from portbench.reference import raster as RR
from portbench.reference.projection import Camera
from portbench.work.blend import blend_work
from portbench.work.unit import frame_work, mfu_pct, step_work


@pytest.fixture(scope="module")
def fixture_work():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        import torch_chunk_fixtures as F
    finally:
        sys.path.remove(os.path.join(ROOT, "tests"))
    from taichi_3d_gaussian_splatting_torch.ops import blend_cuda as BC
    slabs, starts, ends = F.long_segment_slab(768)
    slab = slabs["wide16"]
    kw = dict(num_tiles=F.NUM_TILES, tiles_per_row=F.TILES_PER_ROW)
    _, last = BC.blend_forward_with_last_torch(slab, starts, ends, **kw)
    cols = [slab[r] for r in (BC.ROW_U, BC.ROW_V, BC.ROW_A, BC.ROW_B,
                              BC.ROW_C, BC.ROW_LOGW, BC.ROW_R, BC.ROW_G,
                              BC.ROW_B_COL)]
    binning = RR.Binning(torch.arange(slab.shape[1]), starts.long(),
                         ends.long())
    cam = Camera(1.0, 1.0, 0.0, 0.0, 16 * F.TILES_PER_ROW,
                 16 * (F.NUM_TILES // F.TILES_PER_ROW))
    _, counts = RR.render(cols, binning, cam, counts=True)
    theirs = {name: F.work(name, slab, starts, ends, F.NUM_TILES,
                           F.TILES_PER_ROW,
                           last=last if name == "blend_backward" else None)
              for name in ("blend_forward", "blend_backward")}
    return counts, theirs, F.NUM_TILES


@pytest.mark.parametrize("name", ["blend_forward", "blend_backward"])
def test_blend_work_equals_the_fixture(fixture_work, name):
    counts, theirs, num_tiles = fixture_work
    ours = blend_work(name, counts, num_tiles)
    for key in ("pairs", "contributing", "bytes", "ops", "bound_by"):
        assert ours[key] == theirs[name][key], key
    assert ours["bound_ms"] == pytest.approx(theirs[name]["bound_ms"])


def test_unit_work_adds_its_parts(fixture_work):
    counts, _, num_tiles = fixture_work
    f = frame_work(counts, 1000, num_tiles)
    assert f["flops"] == f["k1"]["ops"] + 420 * 1000
    s = step_work(counts, 1000, num_tiles, 2048)
    assert s["flops"] > s["k2"]["ops"] + s["k3"]["ops"] + 1530 * 2048
    assert mfu_pct(67e9, 1.0) == pytest.approx(100.0)
