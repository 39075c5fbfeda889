"""S6: does the card's data movement match the semantics the plain versions
assume? The roll and the doubling scans by warp shuffles, and the
production scan that places the blend kernels' work items.

    python -m taichi_3d_gaussian_splatting_torch.probes.roll_semantics_check

Replaces the TPU probe scratch/roll_semantics_check.py:34 (the
pl.pallas_call of kernel(x_ref, o_ref, *, interpret), :21, run by
run(interpret), :31), which held pltpu.roll on the chip against jnp.roll in
interpret mode; the kernels are csrc/probes/roll_semantics_check.cu. Modes:
  ``planes``          on x (8, 128) f32 drawn uniform(0.5, 1) by numpy
                      default_rng(0), as the TPU probe draws it: (3, 8, 128)
                      [roll(x, 1, 0), the exclusive doubling product along
                      axis 0, the exclusive doubling sum], by shuffles on
                      8-lane segments;
  ``work_list_scan``  block_exclusive_sum (csrc/blend_common.cuh, the scan
                      of the blend kernels' work list) on one int2 per
                      thread of 1,024: (1024, 4) int32 [exclusive x, y,
                      total x, total y].
`main` prints, per plane, max |kernel - plain| and max |kernel - numpy's
roll or sequential scan|, each work_list_scan draw against its sequential
sum, then PASS (every plane bitwise, every scan exact) or FAIL, and exits 1
on FAIL. It needs a card.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import _common as C

REPLACES = "scratch/roll_semantics_check.py:34"
SOURCE = ("taichi_3d_gaussian_splatting_torch/csrc/probes/"
          "roll_semantics_check.cu")
MODES = ("planes", "work_list_scan")
PLANES = ("roll+1", "cumprod_excl", "cumsum_excl")  # the TPU probe's names
ROWS, COLS = 8, 128
SCAN_THREADS = 1024      # blend_common.cuh kBuildThreads
# the draws of work_list_scan: (seed, high, share of zeros); seed None is
# the draw of zeros
SCAN_DRAWS = ((0, 64, 0.0), (1, 1 << 16, 0.5), (None, 1, 1.0))
# the threads checked by name: lane 0, the edges of warps 0 and 1, the last
EDGE_THREADS = (0, 31, 32, SCAN_THREADS - 1)
TIMED_CALLS = 20

# kernel launches per mode, counted by the wrapper when it launches
launch_counts = {mode: 0 for mode in MODES}


def reset_launch_counts():
    for mode in launch_counts:
        launch_counts[mode] = 0


def probe_input(device="cuda"):
    """x (8, 128) f32, uniform(0.5, 1) from default_rng(0), as the TPU
    probe draws it."""
    rng = np.random.default_rng(0)
    return torch.as_tensor(
        rng.uniform(0.5, 1.0, (ROWS, COLS)).astype(np.float32), device=device)


def scan_input(seed, high, zeros, device="cuda"):
    """(1024, 2) int32: integers in [0, high) from default_rng(seed), a
    share `zeros` of them set to 0; seed None gives all zeros."""
    if seed is None:
        return torch.zeros((SCAN_THREADS, 2), dtype=torch.int32,
                           device=device)
    rng = np.random.default_rng(seed)
    v = rng.integers(0, high, (SCAN_THREADS, 2)).astype(np.int32)
    v[rng.uniform(size=v.shape) < zeros] = 0
    return torch.as_tensor(v, device=device)


def roll_semantics_torch(x):
    """Plain version of `planes`: (3, 8, 128) from x (8, 128), the JAX
    package's helpers in interpret mode (roll as torch.roll)."""
    return torch.stack([torch.roll(x, 1, 0), C.doubling_scan(x, 0),
                        C.doubling_scan(x, 0, op="add")])


def work_list_scan_torch(v):
    """Plain version of `work_list_scan`: each row's exclusive sums of the
    rows before it and the totals, (1024, 4) int32."""
    inclusive = torch.cumsum(v, 0, dtype=torch.int32)
    total = inclusive[-1:].expand_as(v)
    return torch.cat([inclusive - v, total], dim=1)


def numpy_planes(x):
    """The TPU probe's own expectations on the host: numpy's roll, and
    sequential cumulative product and sum shifted by one row."""
    x = np.asarray(x)
    cp, cs = np.ones_like(x), np.zeros_like(x)
    cp[1:] = np.cumprod(x, axis=0)[:-1]
    cs[1:] = np.cumsum(x, axis=0)[:-1]
    return np.stack([np.roll(x, 1, 0), cp, cs])


def _device_kind(name, t):
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name} runs on cpu or cuda tensors, got "
                           f"{t.device}")
    return t.device.type


def _launch(symbol, inp, out_shape, dtype):
    """Launch the probe library's `symbol` (input, out, stream) on a CUDA
    input; returns its output, allocated after the library loads."""
    from ..ops._build import load_probe_library
    lib = load_probe_library()
    out = torch.empty(out_shape, dtype=dtype, device=inp.device)
    with torch.cuda.device(inp.device):
        err = getattr(lib, symbol)(inp.data_ptr(), out.data_ptr(),
                                   C.stream_of(inp))
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error "
                           f"{err}")
    return out


def roll_semantics(x):
    """`planes` on x (8, 128) float32, contiguous: CPU tensors take the
    plain version, CUDA tensors launch the kernel (and count the launch),
    any other device raises."""
    if (x.dtype != torch.float32 or tuple(x.shape) != (ROWS, COLS)
            or not x.is_contiguous()):
        raise ValueError(f"roll_semantics: x must be contiguous float32 of "
                         f"shape ({ROWS}, {COLS}), got {x.dtype} "
                         f"{tuple(x.shape)}")
    if _device_kind("roll_semantics", x) == "cpu":
        return roll_semantics_torch(x)
    out = _launch("t3dgs_probe_roll_planes", x, (3, ROWS, COLS),
                  torch.float32)
    launch_counts["planes"] += 1
    return out


def work_list_scan(v):
    """`work_list_scan` on v (1024, 2) int32, contiguous: CPU tensors take
    the plain version, CUDA tensors launch the kernel (and count the
    launch), any other device raises."""
    if (v.dtype != torch.int32 or tuple(v.shape) != (SCAN_THREADS, 2)
            or not v.is_contiguous()):
        raise ValueError(f"work_list_scan: v must be contiguous int32 of "
                         f"shape ({SCAN_THREADS}, 2), got {v.dtype} "
                         f"{tuple(v.shape)}")
    if _device_kind("work_list_scan", v) == "cpu":
        return work_list_scan_torch(v)
    out = _launch("t3dgs_probe_work_list_scan", v, (SCAN_THREADS, 4),
                  torch.int32)
    launch_counts["work_list_scan"] += 1
    return out


def time_modes():
    """{mode: (ms a call, its outputs)} of the kernels by CUDA events over
    TIMED_CALLS: `planes` on the TPU probe's x, `work_list_scan` timed on
    the first draw of SCAN_DRAWS and run on each (outputs: a list, one a
    draw)."""
    x = probe_input()
    draws = [scan_input(*d) for d in SCAN_DRAWS]
    return {"planes": (C.time_ms(lambda: roll_semantics(x), TIMED_CALLS),
                       roll_semantics(x)),
            "work_list_scan": (C.time_ms(lambda: work_list_scan(draws[0]),
                                         TIMED_CALLS),
                               [work_list_scan(v) for v in draws])}


def check(result):
    """The verdict on time_modes' outputs: {"planes": {name: (max |kernel -
    plain|, max |kernel - numpy|)}, "scans": [(draw, mismatched threads,
    edge threads exact)], "bitwise": planes all equal to the plain version,
    "pass": that and every scan exact}."""
    got = result["planes"][1]
    x = probe_input(device=got.device)
    plain = roll_semantics_torch(x)
    host = numpy_planes(x.cpu().numpy())
    planes = {name: (float((got[i] - plain[i]).abs().max()),
                     float(np.abs(got[i].cpu().numpy() - host[i]).max()))
              for i, name in enumerate(PLANES)}
    bitwise = bool(torch.equal(got, plain))
    scans = []
    for draw, out in zip(SCAN_DRAWS, result["work_list_scan"][1]):
        ref = work_list_scan_torch(scan_input(*draw, device=out.device))
        wrong = (out != ref).any(dim=1)
        scans.append((draw, int(wrong.sum()),
                      not bool(wrong[list(EDGE_THREADS)].any())))
    return {"planes": planes, "scans": scans, "bitwise": bitwise,
            "pass": bitwise and all(n == 0 for _, n, _ in scans)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.parse_args(argv)
    C.require_card()
    name, limit = C.card()
    result = time_modes()
    verdict = check(result)
    for plane, (d_plain, d_numpy) in verdict["planes"].items():
        C.emit({"probe": "S6", "plane": plane,
                "max_abs_diff_vs_plain": d_plain,
                "max_abs_diff_vs_numpy_sequential": d_numpy,
                "ms": result["planes"][0], "card": name,
                "power_limit": limit})
    for (seed, high, zeros), wrong, edges in verdict["scans"]:
        C.emit({"probe": "S6", "mode": "work_list_scan", "seed": seed,
                "high": high, "zeros": zeros, "mismatched_threads": wrong,
                "edge_threads_exact": edges,
                "ms": result["work_list_scan"][0], "card": name,
                "power_limit": limit})
    print("PASS" if verdict["pass"] else "FAIL", flush=True)
    if not verdict["pass"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
