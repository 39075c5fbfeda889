"""S1: the blend exponent three ways. Does exp2 on coefficient rows
prescaled by log2(e) save the per-pixel multiply that exp pays inside?

    python -m taichi_3d_gaussian_splatting_torch.probes.perf_exp2_probe

Replaces the TPU probe scratch/perf_exp2_probe.py:59 (the pl.pallas_call
of make_kernel(variant), :32); the kernel is csrc/probes/perf_exp2_probe.cu.
It computes out[c][p] = sum_{i < N_CHUNKS} f(e_i[c][p]) with
e_i = (coef + 1e-6 i)^T . mono for coef (8, 128) and mono (256, 8) drawn as
the TPU probe draws them (numpy default_rng(0): coef normal * 0.1, then mono
normal), and f:
  ``exp``      exp(e);
  ``exp2mul``  exp2(e * log2 e);
  ``exp2pre``  exp2 of the product with (coef + 1e-6 i) * log2 e.
`main` prints one JSON line per variant (ms over the TPU probe's 10
calls, ns a chunk, the card's name and power limit), then the largest
relative difference of exp2mul and exp2pre against exp. It needs a card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import _common as C

REPLACES = "scratch/perf_exp2_probe.py:59"
SOURCE = "taichi_3d_gaussian_splatting_torch/csrc/probes/perf_exp2_probe.cu"
VARIANTS = ("exp", "exp2mul", "exp2pre")
N_CHUNKS = 4096          # the TPU probe's steps (~ chunks of a frame)
PIX = C.PIXELS
REPS = 10                # the TPU probe's timed calls a variant
# float(np.log2(np.e)) rounded to float32, as the TPU probe's LOG2E is
LOG2E = float(np.float32(np.log2(np.e)))

# kernel launches per variant, counted by the wrapper when it launches
launch_counts = {variant: 0 for variant in VARIANTS}


def reset_launch_counts():
    for variant in launch_counts:
        launch_counts[variant] = 0


def probe_inputs(device="cuda"):
    """(coef (8, 128), mono (256, 8)) f32, drawn as the TPU probe draws
    them (its coef is (1, 8, 128))."""
    rng = np.random.default_rng(0)
    coef = rng.normal(size=(1, 8, C.CHUNK)).astype(np.float32) * 0.1
    mono = rng.normal(size=(PIX, 8)).astype(np.float32)
    return (torch.as_tensor(coef[0], device=device),
            torch.as_tensor(mono, device=device))


def exp2_probe_torch(coef, mono, *, variant, n_chunks=N_CHUNKS):
    """Plain version, step by step; the product is torch.matmul in float32
    (the caller keeps TF32 off on the card). Returns (128, 256) f32."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    acc = torch.zeros((C.CHUNK, PIX), dtype=torch.float32,
                      device=coef.device)
    # 1e-6 * i in float32, as the TPU probe forms it
    steps = torch.as_tensor(np.float32(1e-6)
                            * np.arange(n_chunks, dtype=np.float32),
                            device=coef.device)
    for i in range(n_chunks):
        c = coef + steps[i]
        if variant == "exp2pre":
            c = c * LOG2E
        e = torch.matmul(c.T, mono.T)
        if variant == "exp":
            a = torch.exp(e)
        elif variant == "exp2mul":
            a = torch.exp2(e * LOG2E)
        else:
            a = torch.exp2(e)
        acc = acc + a
    return acc


def exp2_probe(coef, mono, *, variant, n_chunks=N_CHUNKS):
    """The probe on coef (8, 128) and mono (256, 8), float32, contiguous:
    CPU tensors take the plain version, CUDA tensors launch the kernel (and
    count the launch), any other device raises."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    for name, t, shape in (("coef", coef, (8, C.CHUNK)),
                           ("mono", mono, (PIX, 8))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"exp2_probe: {name} must be contiguous float32 "
                             f"of shape {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if mono.device != coef.device:
        raise ValueError("exp2_probe: coef and mono lie on different devices")
    if coef.device.type == "cpu":
        return exp2_probe_torch(coef, mono, variant=variant,
                                n_chunks=n_chunks)
    if coef.device.type != "cuda":
        raise RuntimeError(f"exp2_probe runs on cpu or cuda tensors, got "
                           f"{coef.device}")
    from ..ops._build import load_probe_library
    lib = load_probe_library()
    out = torch.empty((C.CHUNK, PIX), dtype=torch.float32, device=coef.device)
    with torch.cuda.device(coef.device):
        err = lib.t3dgs_probe_exp2(coef.data_ptr(), mono.data_ptr(), n_chunks,
                                   VARIANTS.index(variant), out.data_ptr(),
                                   C.stream_of(coef))
    if err != 0:
        raise RuntimeError(f"exp2_probe kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts[variant] += 1
    return out


def max_rel_diff(ref, x):
    """The TPU probe's figure: max |ref - x| / max(|ref|, 1e-20)."""
    return float(((ref - x).abs() / ref.abs().clamp(min=1e-20)).max())


def time_variants(coef, mono, reps=REPS):
    """{variant: (ms a call, its output)} of the kernel, by CUDA events."""
    result = {}
    for variant in VARIANTS:
        ms = C.time_ms(lambda: exp2_probe(coef, mono, variant=variant), reps)
        result[variant] = (ms, exp2_probe(coef, mono, variant=variant))
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.parse_args(argv)
    C.require_card()
    name, limit = C.card()
    coef, mono = probe_inputs()
    result = time_variants(coef, mono)
    for variant, (ms, _) in result.items():
        C.emit({"probe": "S1", "variant": variant, "ms": ms,
                "ns_per_chunk": ms / N_CHUNKS * 1e6, "chunks": N_CHUNKS,
                "reps": REPS, "card": name, "power_limit": limit})
    ref = result["exp"][1]
    C.emit({"probe": "S1", "max_rel_diff_vs_exp": {
        v: max_rel_diff(ref, result[v][1]) for v in ("exp2mul", "exp2pre")},
        "card": name, "power_limit": limit})


if __name__ == "__main__":
    main()
