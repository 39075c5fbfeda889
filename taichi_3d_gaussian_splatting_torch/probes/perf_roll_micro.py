"""S5: the instruction mixes of K1's inner loop priced one by one: a
cross-thread doubling scan, a scan through shared memory, exp, a multiply
chain and a small product on the tensor cores.

    python -m taichi_3d_gaussian_splatting_torch.probes.perf_roll_micro

Replaces the TPU probe scratch/perf_roll_micro.py:65 (the pl.pallas_call
built by build(mode, shape), :64, of make_kernel(mode), :13); the kernel is
csrc/probes/perf_roll_micro.cu. Each of NUM_PROGRAMS programs owns one
(rows, cols) float32 block and applies one step REPS times in a chain:
  ``mul7``   seven a = a * 0.9999 + 1e-6;
  ``lane``   an inclusive doubling product along axis 1 of (256, 128): for
             k = 1, 2, ..., 64, a = a * where(col < k, 1, roll(a, k, 1));
  ``sub``    the same along axis 0 of (128, 256);
  ``exp``    exp(a * 0.999) * 0.5, at (256, 128) and (128, 256);
  ``mxu``    a * 1e-3 + (a[:, 0:8] @ a[0:8, :]) * 1e-6 on (256, 128);
  ``mxu_t``  the same product formed transposed (the TPU probe defines it
             but never times it).
The input is filled with 0.9999, as the TPU probe's. `main` prints one JSON
line per run of RUNS (the TPU probe's six and mxu_t): ms over TIMED_CALLS
calls by CUDA events, ns per (program x repetition), the card's name and
power limit. It needs a card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import _common as C

REPLACES = "scratch/perf_roll_micro.py:65"
SOURCE = "taichi_3d_gaussian_splatting_torch/csrc/probes/perf_roll_micro.cu"
MODES = ("mul7", "lane", "sub", "exp", "mxu", "mxu_t")
WIDE, TALL = (256, 128), (128, 256)
# the TPU probe's timed runs (:90-95), then mxu_t at mxu's shape
RUNS = (("mul7", WIDE), ("lane", WIDE), ("sub", TALL), ("exp", WIDE),
        ("exp", TALL), ("mxu", WIDE), ("mxu_t", WIDE))
# the block shapes each mode takes: those of its runs
MODE_SHAPES = {mode: tuple(s for m, s in RUNS if m == mode) for mode in MODES}
NUM_PROGRAMS = 256
REPS = 300               # the TPU probe's chained repetitions a program
TIMED_CALLS = 20         # the TPU probe's timed calls a run
# the TPU probe's Python constants as float32 rounds them (JAX's weak types)
FILL = float(np.float32(0.9999))
MUL_C, ADD_C = float(np.float32(0.9999)), float(np.float32(1e-6))
EXP_C, HALF = float(np.float32(0.999)), 0.5
ACC_C, DOT_C = float(np.float32(1e-3)), float(np.float32(1e-6))

# kernel launches per mode, counted by the wrapper when it launches
launch_counts = {mode: 0 for mode in MODES}


def reset_launch_counts():
    for mode in launch_counts:
        launch_counts[mode] = 0


def probe_input(shape, device="cuda", programs=NUM_PROGRAMS):
    """(programs,) + shape float32 filled with 0.9999, the TPU probe's x0."""
    return torch.full((programs,) + tuple(shape), FILL, dtype=torch.float32,
                      device=device)


def random_input(shape, seed, device="cuda", programs=NUM_PROGRAMS):
    """(programs,) + shape float32 drawn uniform(0.5, 1) by numpy
    default_rng(seed): values the chain keeps finite and normal for a few
    repetitions (0.9999 underflows or overflows long before 300)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.5, 1.0, (programs,) + tuple(shape)).astype(np.float32)
    return torch.as_tensor(x, device=device)


def _check(name, x, mode, reps):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if (x.dim() != 3 or x.dtype != torch.float32
            or tuple(x.shape[1:]) not in MODE_SHAPES[mode]
            or x.shape[0] < 1 or not x.is_contiguous()):
        raise ValueError(f"{name}: x must be contiguous float32 of shape "
                         f"(programs,) + one of {MODE_SHAPES[mode]} for "
                         f"{mode}, got {x.dtype} {tuple(x.shape)}")
    if reps < 0:
        raise ValueError(f"{name}: reps must be >= 0, got {reps}")


def _step(a, mode):
    """One repetition of `mode` on a (programs, rows, cols) block, the TPU
    probe's operations in its order."""
    if mode == "mul7":
        for _ in range(7):
            a = a * MUL_C + ADD_C
        return a
    if mode in ("lane", "sub"):     # 128 lanes or rows: k < 128 as the TPU's
        return C.doubling_scan(a, 2 if mode == "lane" else 1,
                               exclusive=False)
    if mode == "exp":
        return torch.exp(a * EXP_C) * HALF
    if mode == "mxu":
        dot = torch.matmul(a[:, :, :8], a[:, :8, :])
    else:
        dot = torch.matmul(a[:, :8, :].transpose(1, 2),
                           a[:, :, :8].transpose(1, 2)).transpose(1, 2)
    return a * ACC_C + dot * DOT_C


def roll_micro_torch(x, *, mode, reps=REPS):
    """Plain version: `reps` repetitions of `mode` on x (programs, rows,
    cols) float32; torch.matmul in float32 for the products (the caller
    keeps TF32 off on the card). Returns a new tensor of x's shape."""
    _check("roll_micro_torch", x, mode, reps)
    a = x
    for _ in range(reps):
        a = _step(a, mode)
    return a.clone() if a is x else a


def roll_micro(x, *, mode, reps=REPS):
    """The probe on x (programs, rows, cols), float32, contiguous: CPU
    tensors take the plain version, CUDA tensors launch the kernel (and
    count the launch), any other device raises."""
    _check("roll_micro", x, mode, reps)
    if x.device.type == "cpu":
        return roll_micro_torch(x, mode=mode, reps=reps)
    if x.device.type != "cuda":
        raise RuntimeError(f"roll_micro runs on cpu or cuda tensors, got "
                           f"{x.device}")
    from ..ops._build import load_probe_library
    lib = load_probe_library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.t3dgs_probe_roll_micro(
            x.data_ptr(), x.shape[0], x.shape[1], x.shape[2], reps,
            MODES.index(mode), out.data_ptr(), C.stream_of(x))
    if err != 0:
        raise RuntimeError(f"roll_micro kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts[mode] += 1
    return out


def time_runs():
    """{(mode, shape): (ms a call, its output)} of the kernel on the TPU
    probe's input, every run of RUNS, by CUDA events over TIMED_CALLS."""
    result = {}
    for mode, shape in RUNS:
        x = probe_input(shape)
        ms = C.time_ms(lambda: roll_micro(x, mode=mode), TIMED_CALLS)
        result[(mode, shape)] = (ms, roll_micro(x, mode=mode))
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.parse_args(argv)
    C.require_card()
    name, limit = C.card()
    for (mode, shape), (ms, _) in time_runs().items():
        C.emit({"probe": "S5", "mode": mode, "shape": list(shape), "ms": ms,
                "ns_per_program_rep": ms / NUM_PROGRAMS / REPS * 1e6,
                "programs": NUM_PROGRAMS, "reps": REPS,
                "calls": TIMED_CALLS, "card": name, "power_limit": limit})


if __name__ == "__main__":
    main()
