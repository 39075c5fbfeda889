"""The port's density-control round (`training/controller.py`
densify_step) and alpha reset agree with the benchmark's plain reference
(`portbench/reference/densify.py`) on seeded random pools on the CPU:
the six counts exactly, the invalid mask, the object ids and the features
exactly, the positions to float32 rounding (the split draws' rotation is
summed in another order), and the generator left in the same state.
Cases: splits and clones with floaters after `iteration_start_remove_
floater`, the same pool before it, a pool with fewer free slots than
candidates, rows holding a NaN, no sampling."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench.reference import densify as RD
from taichi_3d_gaussian_splatting_torch.models.scene import (
    GaussianPointCloudScene as TScene)
from taichi_3d_gaussian_splatting_torch.ops.rasterizer import BackwardStats
from taichi_3d_gaussian_splatting_torch.training import controller as TC

N = 96


def _pool(seed, free_share=0.3, nan_rows=()):
    rng = np.random.default_rng(seed)
    pc = rng.normal(size=(N, 3)).astype(np.float32)
    feats = (rng.normal(size=(N, 56)) * 0.3).astype(np.float32)
    q = rng.normal(size=(N, 4))
    feats[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    feats[:, 4:7] = rng.uniform(-3, -1, (N, 3))
    feats[:, 7] = rng.uniform(-1, 3, N)
    for r in nan_rows:
        feats[r, 20] = np.nan
    invalid = (rng.random(N) < free_share).astype(np.int8)
    obj = rng.integers(0, 3, N).astype(np.int32)
    trig = dict(in_frustum=rng.random(N) < 0.8,
                depth=rng.uniform(1, 20, N).astype(np.float32),
                npix=rng.integers(0, 2000, N).astype(np.int32),
                mag=(rng.random(N) * 2e-5).astype(np.float32),
                before=(pc + rng.normal(size=(N, 3)) * 1e-3).astype(
                    np.float32))
    acc = [rng.integers(0, 3000, N).astype(np.int32),
           rng.integers(0, 5, N).astype(np.int32),
           (rng.random(N) * 1e-4).astype(np.float32),
           (rng.random(N) * 1e-7).astype(np.float32),
           (rng.normal(size=(N, 3)) * 1e-3).astype(np.float32),
           (rng.random(N) * 1e-3).astype(np.float32)]
    return (pc, feats, invalid, obj), trig, acc


BASE = dict(densification_view_space_position_gradients_threshold=3e-6,
            densification_multi_frame_view_space_position_gradients_threshold=4e-5,
            under_reconstructed_num_pixels_threshold=1500,
            floater_near_camrea_num_pixels_threshold=1800,
            floater_depth_threshold=10.0, iteration_start_remove_floater=50,
            transparent_alpha_threshold=-0.5)
CASES = {
    "split_clone_floaters": (dict(BASE), 100, {}),
    "before_floater_start": (dict(BASE), 50, {}),
    "pool_runs_out": (dict(BASE), 100, dict(free_share=0.05)),
    "nan_rows": (dict(BASE), 100, dict(nan_rows=(3, 40, 41))),
    "no_sampling": (dict(
        BASE, densification_multi_frame_position_gradients_threshold=1e-4,
        enable_sample_from_point=False), 100, {}),
}


def _both(case, seed):
    over, iteration, pool_kw = CASES[case]
    arrays, trig, acc = _pool(seed, **pool_kw)
    cfg = TC.AdaptiveControllerConfig(**over)
    c = RD.controller(dataclasses.asdict(cfg))
    scene = TScene.from_numpy(*arrays, device="cpu")
    stats = BackwardStats(torch.zeros(N, 2), torch.tensor(trig["mag"]),
                          torch.tensor(trig["npix"]), torch.zeros(4, 4, 2))
    g_port = torch.Generator().manual_seed(seed)
    new, zeroed, counts = TC.densify_step(
        scene, TC.ControllerState.from_numpy(acc, "cpu"), stats,
        torch.tensor(trig["in_frustum"]), torch.tensor(trig["depth"]),
        torch.tensor(trig["before"]), iteration, g_port, cfg)
    g_ref = torch.Generator().manual_seed(seed)
    ref = RD.densify_round(
        RD.Pool(*(torch.tensor(a) for a in arrays)),
        tuple(torch.tensor(a) for a in acc),
        RD.Trigger(torch.tensor(trig["npix"]), torch.tensor(trig["mag"]),
                   torch.tensor(trig["in_frustum"]),
                   torch.tensor(trig["depth"]), torch.tensor(trig["before"])),
        iteration, g_ref, c)
    return (new, zeroed, counts, g_port), (ref, g_ref), cfg, c


@pytest.mark.parametrize("seed", [7, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_round_matches_the_plain_reference(case, seed):
    (new, zeroed, counts, g_port), (ref, g_ref), cfg, c = _both(case, seed)
    got = {k: int(getattr(counts, k)) for k in RD.COUNTS}
    assert got == ref.counts
    assert got["num_fillable"] > 0
    if case == "split_clone_floaters":
        assert got["num_floaters"] > 0 and got["num_transparent"] > 0
        assert 0 < got["num_over_reconstructed"] < got["num_fillable"]
    if case == "before_floater_start":
        assert got["num_floaters"] == 0
    if case == "pool_runs_out":
        assert got["num_candidates"] > got["num_fillable"]
    if case == "nan_rows":
        # pruned; a slot filled again holds another row
        valid = new.point_invalid_mask == 0
        assert not bool(torch.isnan(new.point_cloud_features[valid]).any())
    assert torch.equal(new.point_invalid_mask, ref.pool.invalid)
    assert torch.equal(new.point_object_id, ref.pool.obj)
    assert torch.equal(torch.nan_to_num(new.point_cloud_features),
                       torch.nan_to_num(ref.pool.feats))
    torch.testing.assert_close(new.point_cloud, ref.pool.pc, rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(g_port.get_state(), g_ref.get_state())
    assert not any(bool(x.any()) for x in zeroed)
    # the round's own numbers read nothing between the two
    r = RD.readings(got, RD.Pool(new.point_cloud, new.point_cloud_features,
                                 new.point_invalid_mask,
                                 new.point_object_id), ref, ref.pool)
    assert r["count_gap"] == 0 and r["validity_gap"] == 0
    if case != "nan_rows":
        assert r["filled_gap"] < 1e-6 and r["pool_gap"] < 1e-6

    reset = TC.reset_alpha(new, cfg)
    assert torch.equal(
        torch.nan_to_num(reset.point_cloud_features),
        torch.nan_to_num(RD.reset_alpha(ref.pool, c).feats))


@pytest.mark.parametrize("iteration", [0, 400, 500, 600, 650, 4000, 8000])
def test_the_schedule_is_the_trainer_s(iteration):
    """`due` says what `train_iteration` does at an iteration under
    config/tat_truck.yaml's schedule: a round every 100 from 500, an alpha
    reset every 4000 from 500."""
    c = dict(num_iterations_warm_up=500, num_iterations_densify=100,
             num_iterations_reset_alpha=4000)
    rounds, resets = RD.due(iteration, c)
    assert rounds == (iteration >= 500 and iteration % 100 == 0)
    assert resets == (iteration in (4000, 8000))
