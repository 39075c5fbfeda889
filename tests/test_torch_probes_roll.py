"""The last two probes of the port (taichi_3d_gaussian_splatting_torch/
probes/) against the TPU probes they replace, on the CPU: each plain
version against the TPU kernel in Pallas's interpret mode, on inputs made
with numpy from a seed or the TPU probe's own constants.

- S5 (scratch/perf_roll_micro.py) runs its measurements when it is
  imported: its definitions (the source before the first timeit call,
  :1-88) are executed into a namespace, and its own build(mode, shape) runs
  with pallas_call in interpret mode, at 2 programs and 1-3 repetitions.
- S6 (scratch/roll_semantics_check.py) needs a TPU when it is imported:
  its kernel (:21-28) is rebuilt here around the JAX package's
  _sub_cumprod_exclusive / _sub_cumsum_exclusive, and both of its branches
  run in interpret mode (pltpu.roll and jnp.roll).

What the interpret mode does otherwise than the TPU probe's source: XLA on
the CPU flushes subnormal results to zero (the TPU has none; the plain
version and the card keep them), and it contracts a * c + d into one fused
multiply-add (the plain version and the card's kernel round the product
and the sum each on its own, as the source writes them). The tests below
pin both differences exactly instead of hiding them in a tolerance.
"""

import functools
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from taichi_3d_gaussian_splatting_torch.ops import _build
from taichi_3d_gaussian_splatting_torch.probes import _common as C
from taichi_3d_gaussian_splatting_torch.probes import perf_roll_micro as S5
from taichi_3d_gaussian_splatting_torch.probes import (
    roll_semantics_check as S6)
from taichi_3d_gaussian_splatting_tpu.ops.blend_pallas import (
    _sub_cumprod_exclusive, _sub_cumsum_exclusive)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAMS = 2
# exp and the products against the interpret mode: XLA's expf and its
# product's order of sum round otherwise, and the difference compounds over
# the repetitions (measured at 3: 3.5e-7 relative, 4 ulp, for exp; 3.4e-7,
# 3 ulp, for mxu and mxu_t)
RTOL = {"exp": 5e-7, "mxu": 5e-7, "mxu_t": 5e-7}
# mul7 against the interpret mode, where each pair is one fused multiply-add
# (measured at 3 repetitions of uniform input: 7.8e-7, 13 ulp)
MUL7_RTOL = 1e-6
TINY = np.finfo(np.float32).tiny


def _s5_tpu():
    """scratch/perf_roll_micro.py's definitions, with pallas_call in
    interpret mode and PROGRAMS programs."""
    path = os.path.join(REPO, "scratch", "perf_roll_micro.py")
    with open(path) as f:
        src = f.read()
    ns = {"__name__": "scratch_perf_roll_micro"}
    exec(compile(src[:src.index("\ntimeit(")], path, "exec"), ns)
    ns["pl"] = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec,
        pallas_call=functools.partial(pl.pallas_call, interpret=True))
    ns["NUM_PROGRAMS"] = PROGRAMS
    return ns


def _s5_input(kind, shape):
    if kind == "fill":
        return S5.probe_input(shape, "cpu", PROGRAMS)
    return S5.random_input(shape, 0, "cpu", PROGRAMS)


def _s5_run_tpu(mode, shape, x, reps):
    ns = _s5_tpu()
    ns["REPS"] = reps
    return np.asarray(ns["build"](mode, shape)(jnp.asarray(x.numpy())))


def _flush(a):
    """Subnormals to zero, as XLA on the CPU flushes them."""
    return np.where(np.abs(a) < TINY, np.float32(0.0), a)


@pytest.mark.parametrize("reps", (1, 3))
@pytest.mark.parametrize("kind", ("fill", "uniform"))
@pytest.mark.parametrize("mode,shape", S5.RUNS)
def test_s5_plain_matches_tpu_probe(mode, shape, kind, reps):
    """Every run of S5 on 0.9999 and on uniform(0.5, 1): lane and sub
    bitwise once the plain version's subnormals are flushed (every normal
    value bitwise; the reference's zeros are the plain version's zeros or
    subnormals: the scans' products stay at most 1, so a subnormal never
    comes back); exp, mxu and mxu_t at RTOL; mul7 bitwise against the same
    chain with each pair fused, and within MUL7_RTOL of the reference."""
    x = _s5_input(kind, shape)
    ref = _s5_run_tpu(mode, shape, x, reps)
    got = S5.roll_micro_torch(x, mode=mode, reps=reps).numpy()
    assert got.shape == ref.shape == (PROGRAMS,) + shape
    assert np.isfinite(ref).all()
    if mode in ("lane", "sub"):
        np.testing.assert_array_equal(_flush(got), ref)
    elif mode == "mul7":
        fused = x.numpy().astype(np.float64)
        for _ in range(7 * reps):
            # a * c is exact in float64; one rounding to float32 after the
            # sum, as a fused multiply-add rounds
            fused = (fused * S5.MUL_C + S5.ADD_C).astype(np.float32).astype(
                np.float64)
        np.testing.assert_array_equal(fused.astype(np.float32), ref)
        np.testing.assert_allclose(got, ref, rtol=MUL7_RTOL, atol=0.0)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL[mode], atol=0.0)


@pytest.mark.parametrize("kind", ("fill", "uniform"))
def test_s5_mul7_plain_rounds_each_operation(kind):
    """mul7's plain version is bitwise the TPU probe's chain as written, one
    rounding an operation: numpy's float32 and JAX op by op (unfused)."""
    x = _s5_input(kind, S5.WIDE)
    a = x.numpy().copy()
    j = jnp.asarray(a)
    for _ in range(7 * 3):
        a = a * np.float32(0.9999) + np.float32(1e-6)
        j = j * 0.9999 + 1e-6
    got = S5.roll_micro_torch(x, mode="mul7", reps=3).numpy()
    np.testing.assert_array_equal(got, a)
    np.testing.assert_array_equal(got, np.asarray(j))


def test_s5_scans_keep_subnormals_and_match_numpy():
    """Two repetitions of lane on uniform input reach subnormals, which the
    plain version keeps (the card does too); one repetition is the running
    product along the row, within 1e-5 of numpy's sequential cumprod (up to
    128 products in another order, ~6e-8 each)."""
    x = S5.random_input(S5.WIDE, 0, "cpu", PROGRAMS)
    two = S5.roll_micro_torch(x, mode="lane", reps=2).numpy()
    assert ((two != 0) & (np.abs(two) < TINY)).sum() > 100
    one = S5.roll_micro_torch(x, mode="lane", reps=1)
    np.testing.assert_allclose(one.numpy(), np.cumprod(x.numpy(), axis=2),
                               rtol=1e-5, atol=0.0)
    sub = S5.roll_micro_torch(x.reshape((PROGRAMS,) + S5.TALL), mode="sub",
                              reps=1)
    np.testing.assert_allclose(
        sub.numpy(), np.cumprod(x.numpy().reshape(sub.shape), axis=1),
        rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("kind", ("fill", "uniform"))
def test_s5_mxu_and_mxu_t_agree(kind):
    """mxu and mxu_t sum the same 8 products in another order: within
    RTOL["mxu"] of each other over 3 repetitions, plain and TPU alike."""
    shape = S5.WIDE
    x = _s5_input(kind, shape)
    plain = {m: S5.roll_micro_torch(x, mode=m, reps=3).numpy()
             for m in ("mxu", "mxu_t")}
    np.testing.assert_allclose(plain["mxu_t"], plain["mxu"],
                               rtol=RTOL["mxu"], atol=0.0)
    tpu = {m: _s5_run_tpu(m, shape, x, 3) for m in ("mxu", "mxu_t")}
    np.testing.assert_allclose(tpu["mxu_t"], tpu["mxu"], rtol=RTOL["mxu"],
                               atol=0.0)


def test_s5_shapes_modes_and_reps_are_checked():
    x = S5.probe_input(S5.TALL, "cpu", 1)
    with pytest.raises(ValueError, match="lane"):
        S5.roll_micro(x, mode="lane", reps=1)
    with pytest.raises(ValueError, match="mxu"):
        S5.roll_micro(x, mode="mxu", reps=1)
    with pytest.raises(ValueError, match="sub"):
        S5.roll_micro(S5.probe_input(S5.WIDE, "cpu", 1), mode="sub", reps=1)
    with pytest.raises(ValueError, match="mode must be one of"):
        S5.roll_micro(x, mode="lane_x", reps=1)
    with pytest.raises(ValueError, match="reps"):
        S5.roll_micro(x, mode="exp", reps=-1)
    with pytest.raises(ValueError, match="contiguous float32"):
        S5.roll_micro(x.double(), mode="exp", reps=1)
    # zero repetitions return a copy of the input
    out = S5.roll_micro(x, mode="exp", reps=0)
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    assert {m for m, _ in S5.RUNS} == set(S5.MODES)


# ---- S6 -------------------------------------------------------------------

def _s6_tpu(interpret_helpers):
    """scratch/roll_semantics_check.py's kernel (:21-28) on its input, in
    interpret mode; `interpret_helpers` is its `interpret` argument: False
    takes the compiled branch (pltpu.roll), True jnp.roll."""
    def kernel(x_ref, o_ref):
        x = x_ref[...]
        roll1 = (jnp.roll(x, 1, 0) if interpret_helpers
                 else pltpu.roll(x, 1, 0))
        o_ref[0] = roll1
        o_ref[1] = _sub_cumprod_exclusive(x, interpret_helpers)
        o_ref[2] = _sub_cumsum_exclusive(x, interpret_helpers)

    import jax
    x = S6.probe_input("cpu")
    out = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((3, S6.ROWS, S6.COLS),
                                               jnp.float32),
        interpret=True)(jnp.asarray(x.numpy()))
    return np.asarray(out), x


@pytest.mark.parametrize("branch", ("pltpu.roll", "jnp.roll"))
def test_s6_planes_match_the_tpu_probe_bitwise(branch):
    """All three planes bitwise against the TPU kernel's branch; the roll
    exactly numpy's, the scans within 1e-6 of numpy's sequential ones
    (another order of the same products and sums)."""
    ref, x = _s6_tpu(branch == "jnp.roll")
    got = S6.roll_semantics_torch(x).numpy()
    for i, name in enumerate(S6.PLANES):
        np.testing.assert_array_equal(got[i], ref[i], err_msg=name)
    host = S6.numpy_planes(x.numpy())
    np.testing.assert_array_equal(got[0], host[0])
    np.testing.assert_allclose(got[1:], host[1:], rtol=1e-6, atol=0.0)
    assert not np.array_equal(got[1], host[1])   # the order shows


@pytest.mark.parametrize("draw", S6.SCAN_DRAWS, ids=("small", "sparse",
                                                     "zeros"))
def test_s6_work_list_scan_plain_is_exact(draw):
    """The plain scan against numpy's sequential exclusive sum, exactly, at
    every thread, lane 0, the edges of warps 0 and 1 and the last thread
    named; every thread's totals are the sums."""
    v = S6.scan_input(*draw, device="cpu")
    got = S6.work_list_scan_torch(v).numpy()
    host = v.numpy().astype(np.int64)
    excl = np.cumsum(host, axis=0) - host
    np.testing.assert_array_equal(got[:, :2], excl)
    np.testing.assert_array_equal(got[:, 2:], np.broadcast_to(
        host.sum(axis=0), (S6.SCAN_THREADS, 2)))
    assert got.dtype == np.int32
    for t in S6.EDGE_THREADS:
        np.testing.assert_array_equal(got[t, :2], host[:t].sum(axis=0))
    if draw[0] is None:
        assert not got.any()
    else:
        assert got[S6.SCAN_THREADS - 1, 2:].min() > 0


def test_s6_verdict_passes_and_fails():
    """check() on the CPU wrappers' outputs passes; one flipped bit of a
    plane or one wrong scan entry fails it."""
    x = S6.probe_input("cpu")
    draws = [S6.scan_input(*d, device="cpu") for d in S6.SCAN_DRAWS]
    result = {"planes": (0.0, S6.roll_semantics(x)),
              "work_list_scan": (0.0, [S6.work_list_scan(v) for v in draws])}
    verdict = S6.check(result)
    assert verdict["pass"] and verdict["bitwise"]
    assert verdict["planes"]["roll+1"] == (0.0, 0.0)
    assert [n for _, n, _ in verdict["scans"]] == [0, 0, 0]
    planes = result["planes"][1].clone()
    bits = planes.view(torch.int32)
    bits[1, 3, 5] ^= 1
    assert not S6.check({**result, "planes": (0.0, planes)})["pass"]
    scans = [s.clone() for s in result["work_list_scan"][1]]
    scans[2][32, 0] += 1
    verdict = S6.check({**result, "work_list_scan": (0.0, scans)})
    assert not verdict["pass"]
    assert verdict["scans"][2][1:] == (1, False)


# ---- the wrappers on the CPU and the probe library's hash -----------------

def test_wrappers_on_cpu_take_the_plain_versions():
    """A CPU tensor takes the plain version (bitwise) and counts no
    launch."""
    S5.reset_launch_counts()
    S6.reset_launch_counts()
    x = S5.random_input(S5.WIDE, 3, "cpu", 1)
    for mode in ("mul7", "lane", "exp", "mxu"):
        assert torch.equal(S5.roll_micro(x, mode=mode, reps=2),
                           S5.roll_micro_torch(x, mode=mode, reps=2))
    assert sum(S5.launch_counts.values()) == 0
    x6 = S6.probe_input("cpu")
    assert torch.equal(S6.roll_semantics(x6), S6.roll_semantics_torch(x6))
    v = S6.scan_input(*S6.SCAN_DRAWS[0], device="cpu")
    assert torch.equal(S6.work_list_scan(v), S6.work_list_scan_torch(v))
    assert sum(S6.launch_counts.values()) == 0
    with pytest.raises(ValueError, match="int32"):
        S6.work_list_scan(v.long())
    with pytest.raises(ValueError, match="float32"):
        S6.roll_semantics(x6.double())


def test_doubling_scan_matches_the_jax_helpers():
    """_common.doubling_scan, exclusive, is the JAX package's sublane scans
    (jnp.roll branch) bitwise on 16 rows; inclusive is the exclusive scan
    times (or plus) the row itself up to rounding."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0.5, 1.0, (16, 24)).astype(np.float32)
    t = torch.as_tensor(x)
    np.testing.assert_array_equal(
        C.doubling_scan(t, 0).numpy(),
        np.asarray(_sub_cumprod_exclusive(jnp.asarray(x), True)))
    np.testing.assert_array_equal(
        C.doubling_scan(t, 0, op="add").numpy(),
        np.asarray(_sub_cumsum_exclusive(jnp.asarray(x), True)))
    np.testing.assert_allclose(C.doubling_scan(t, 1, exclusive=False),
                               np.cumprod(x, axis=1), rtol=1e-6)
    with pytest.raises(ValueError, match="op"):
        C.doubling_scan(t, 0, op="max")


def test_probe_library_hash_covers_source_flags(monkeypatch):
    """Flags given to a probe source change the probe library's name, so
    that it is built anew; flags of a kernel source outside csrc/probes/ do
    not."""
    sources, digest = _build.probe_digest()
    names = [s.name for s in sources]
    assert "perf_roll_micro.cu" in names
    assert "roll_semantics_check.cu" in names
    assert _build.probe_digest()[1] == digest
    flags = dict(_build.SOURCE_FLAGS)
    monkeypatch.setattr(_build, "SOURCE_FLAGS",
                        {**flags, "blend_forward.cu": ("-lineinfo",)})
    assert _build.probe_digest()[1] == digest
    monkeypatch.setattr(_build, "SOURCE_FLAGS",
                        {**flags, "perf_roll_micro.cu": ("-fmad=false",)})
    changed = _build.probe_digest()[1]
    assert changed != digest
    monkeypatch.setattr(_build, "SOURCE_FLAGS",
                        {**flags, "perf_roll_micro.cu": ("-lineinfo",)})
    assert _build.probe_digest()[1] not in (digest, changed)
