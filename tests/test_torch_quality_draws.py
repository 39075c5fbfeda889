"""The port's trainer held against the JAX trainer over the whole of a
long run of tests/test_quality_synthetic.py's recipe at 32x32 on the CPU,
with the port drawing densify's split positions from JAX's own random
normals (the key sequence of the JAX trainer and of its densify_step).
Then nothing random differs, and the two runs must stay one computation
through three densify rounds (40, 80, 120), the SH band unlock at 100,
the position learning-rate decay and two validations (80, 121). The
recipe, the parity settings and the datasets are those of
tests/test_torch_quality.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taichi_3d_gaussian_splatting_torch.ops import gaussian as TG

import torch_quality_fixtures as Q
from test_torch_quality import run_jax, run_port, write_datasets

ITERATIONS = 121
DENSIFY_AT = (40, 80, 120)
# Per-iteration train/loss: float32 sums in other orders, compounded over
# 121 steps and three densify rounds (measured up to 1.1e-4 through
# iteration 120)
LOSS_RTOL = 1e-3
# the held-out PSNR of the two validations (measured 1.2e-4 dB at 80)
VAL_PSNR_ATOL_DB = 0.01


class JaxDraws:
    """`sample_from_gaussian` for the port that draws JAX's normals: the
    JAX trainer splits its key (PRNGKey(seed)) once per densify, and
    densify_step splits that subkey into one key for the new copies' draw
    and one for the originals' draw, in that order."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)
        self.pending = []

    def __call__(self, xyz, q, log_s, generator=None):
        if not self.pending:
            self.key, subkey = jax.random.split(self.key)
            self.pending = list(jax.random.split(subkey))
        z = np.array(jax.random.normal(self.pending.pop(0),
                                         tuple(xyz.shape), jnp.float32))
        return xyz + TG._mat3_vec(TG.rotation_matrix_from_quaternion(q),
                                  torch.exp(log_s) * torch.as_tensor(z))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = write_datasets(str(tmp_path_factory.mktemp("quality_draws")))
    return (run_jax(root, ITERATIONS),
            run_port(root, ITERATIONS, sample_from_gaussian=JaxDraws(0)))


def test_quality_run_tracks_jax_with_its_draws(runs):
    """Every iteration's loss at LOSS_RTOL and its key count exactly; each
    densify round's counts exactly; both validations' PSNR within
    VAL_PSNR_ATOL_DB; the SH band of every step exactly."""
    (jrec, jbands, _), (trec, tbands, _, _) = runs
    jloss = Q.series(jrec, "train/loss")
    tloss = Q.series(trec, "train/loss")
    assert sorted(tloss) == sorted(jloss) == list(range(ITERATIONS))
    for it in range(ITERATIONS):
        assert abs(tloss[it] - jloss[it]) <= LOSS_RTOL * abs(jloss[it]), (
            it, tloss[it], jloss[it])
    assert max(Q.series(jrec, "train/big_point_overflow").values()) == 0
    assert (Q.series(trec, "train/total_keys")
            == Q.series(jrec, "train/total_keys"))
    for key in ("densify/num_candidates", "densify/num_transparent",
                "densify/num_over_reconstructed", "densify/num_fillable",
                "densify/num_floaters", "value/num_valid_points"):
        j, t = Q.series(jrec, key), Q.series(trec, key)
        assert sorted(t) == list(DENSIFY_AT) and t == j, (key, t, j)
    # the rounds split, then filled the pool: the draws were exercised
    assert Q.series(trec, "densify/num_over_reconstructed")[40] > 0
    assert Q.series(trec, "value/num_valid_points")[120] > Q.series(
        trec, "value/num_valid_points")[40]
    jval, tval = Q.series(jrec, "val/psnr"), Q.series(trec, "val/psnr")
    assert sorted(tval) == sorted(jval) == [80, ITERATIONS]
    for it in tval:
        assert abs(tval[it] - jval[it]) <= VAL_PSNR_ATOL_DB, (it, tval, jval)
    assert tbands == jbands and tbands[-1] == 1
