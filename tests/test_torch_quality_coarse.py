"""The port's trainer held against the JAX trainer through coarse-to-fine
training: tests/test_torch_quality_draws.py's run (the quality recipe, the
parity settings, the port drawing JAX's normals) on datasets written at
64x64, starting at downsample factor 2 and halving it at iteration 60. So
the trainers take 32x32 views up to iteration 59 and 64x64 views from 60
on, densify at 40 (statistics of 32x32 views), 80 (of both sizes) and 120
(of 64x64 views), and validate at 80 and 121 at 64x64.

The JAX GT render drops no key either (NO_DROP_BUDGETS): at 64x64 the
JAX test's budgets drop keys of the splats that cover many tiles, and its
GT PNGs then differ from the port's by up to 141 levels on about a third
of the pixels (ROADMAP.md queue 3, the JAX quality tests' budgets; at
32x32 they drop nothing).

Every shipped config trains coarse to fine (config/example.yaml:
initial-downsample-factor 4), so the controller builds its statistics at
one image size and densifies at another; the other parity tests train at
factor 1."""

import pytest

import torch_quality_fixtures as Q
from test_torch_quality import (NO_DROP_BUDGETS, run_jax, run_port,
                                write_datasets)
from test_torch_quality_draws import (LOSS_RTOL, VAL_PSNR_ATOL_DB,
                                      JaxDraws)

SIZE = 64
ITERATIONS = 121
DENSIFY_AT = (40, 80, 120)
COARSE = dict(initial_downsample_factor=2,
              half_downsample_factor_interval=60)
# Key counts: exact through the second densify round (iteration 80, the
# round whose statistics span both sizes). From there the float32 drift of
# the two runs (their losses up to 1.2e-4 apart by iteration 105) moves a
# few splats' bounding boxes across a tile edge: measured up to 2 of ~950
# keys (0.21%) from iteration 105 on
KEYS_EXACT_THROUGH = 80
KEYS_RTOL = 5e-3
DENSIFY_KEYS = ("densify/num_candidates", "densify/num_transparent",
                "densify/num_over_reconstructed", "densify/num_fillable",
                "densify/num_floaters", "value/num_valid_points")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = write_datasets(str(tmp_path_factory.mktemp("quality_coarse")),
                          size=SIZE, **NO_DROP_BUDGETS)
    jshapes, tshapes = [], []
    jax_run = run_jax(root, ITERATIONS, shapes=jshapes, **COARSE)
    port_run = run_port(root, ITERATIONS, sample_from_gaussian=JaxDraws(0),
                        shapes=tshapes, **COARSE)
    return jax_run, port_run, jshapes, tshapes


def test_coarse_to_fine_run_tracks_jax(runs):
    """Every step's image size identical (32x32 before iteration 60, 64x64
    from it); every iteration's loss at LOSS_RTOL; its key count exactly
    through KEYS_EXACT_THROUGH and at KEYS_RTOL after; each densify round's
    counts exactly; both validations' PSNR within VAL_PSNR_ATOL_DB."""
    (jrec, _, _), (trec, _, _, _), jshapes, tshapes = runs
    half = SIZE // 2
    assert tshapes == jshapes
    assert tshapes == ([(half, half, 3)] * COARSE[
        "half_downsample_factor_interval"] + [(SIZE, SIZE, 3)] * (
            ITERATIONS - COARSE["half_downsample_factor_interval"]))

    jloss = Q.series(jrec, "train/loss")
    tloss = Q.series(trec, "train/loss")
    assert sorted(tloss) == sorted(jloss) == list(range(ITERATIONS))
    for it in range(ITERATIONS):
        assert abs(tloss[it] - jloss[it]) <= LOSS_RTOL * abs(jloss[it]), (
            it, tloss[it], jloss[it])
    for key in ("train/big_point_overflow", "train/tile_cap_overflow"):
        assert max(Q.series(jrec, key).values()) == 0, key
    jkeys = Q.series(jrec, "train/total_keys")
    tkeys = Q.series(trec, "train/total_keys")
    assert sorted(tkeys) == sorted(jkeys) == list(range(ITERATIONS))
    for it in range(ITERATIONS):
        tol = 0 if it <= KEYS_EXACT_THROUGH else KEYS_RTOL * jkeys[it]
        assert abs(tkeys[it] - jkeys[it]) <= tol, (it, tkeys[it], jkeys[it])

    for key in DENSIFY_KEYS:
        j, t = Q.series(jrec, key), Q.series(trec, key)
        assert sorted(t) == list(DENSIFY_AT) and t == j, (key, t, j)
    # each round densified: the draws were exercised at both sizes
    for it in DENSIFY_AT:
        assert (Q.series(trec, "densify/num_over_reconstructed")[it]
                + Q.series(trec, "densify/num_fillable")[it]) > 0, it
    assert Q.series(trec, "value/num_valid_points")[120] > Q.series(
        trec, "value/num_valid_points")[40]

    jval, tval = Q.series(jrec, "val/psnr"), Q.series(trec, "val/psnr")
    assert sorted(tval) == sorted(jval) == [80, ITERATIONS]
    for it in tval:
        assert abs(tval[it] - jval[it]) <= VAL_PSNR_ATOL_DB, (it, tval, jval)
