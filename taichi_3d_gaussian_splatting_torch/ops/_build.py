"""Build and load the package's CUDA kernels.

The sources in ``csrc/*.cu`` have a plain C interface. At first use each
is compiled by its own ``nvcc`` for sm_90a (with ``SOURCE_FLAGS`` added for
the sources listed there), all at once, and the objects
are linked into one shared library whose file name carries the hash of the
sources (headers included) and flags, under ``csrc/build/`` (listed in
``.gitignore``), and loaded with ``ctypes``. A second call in the same
process, or a later process with unchanged sources, reuses the library.

The probes' sources (``csrc/probes/*.cu``) build the same way into a
library of their own (``load_probe_library``), hashed over those sources,
every header they include and the flags they are given, so that the
kernel library's name does not depend on them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of single sources: the projection kernels round every product and
# sum on its own, as the plain version's torch ops do (no contraction into
# fused multiply-adds), so that their masks match it exactly
SOURCE_FLAGS = {"projection_forward.cu": ("-fmad=false",),
                "projection_backward.cu": ("-fmad=false",)}

_library = None
# what ptxas reported (registers, shared memory, spills) for the last build
# made in this process; empty when the library came from an earlier build
build_log = ""


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of taichi_3d_gaussian_splatting_torch are built at first "
        "use and have no fallback")


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.t3dgs_build_work_list
    # tile_starts, tile_ends, num_tiles, mk, chunk, counters, items,
    # num_items, stream
    fn.argtypes = [p, p, i, i, i, p, p, i, p]
    fn.restype = i
    fn = lib.t3dgs_blend_forward
    # data, tile_starts, tile_ends, num_tiles, chunk, items, num_items,
    # num_split_items, counters, tchunk, partial, part_last, out, last_out,
    # mk, tiles_per_row, packed8, rgb_only, stream
    fn.argtypes = [p, p, p, i, i, p, i, i, p, p, p, p, p, p, i, i, i, i, p]
    fn.restype = i
    fn = lib.t3dgs_blend_backward
    # data, tile_starts, tile_ends, num_tiles, chunk, items, num_items,
    # num_split_items, counters, pixel_in, last, tq, mag_part, grad, mag,
    # mk, tiles_per_row, stream
    fn.argtypes = [p, p, p, i, i, p, i, i, p, p, p, p, p, p, p, i, i, p]
    fn.restype = i
    f = ctypes.c_float
    fn = lib.t3dgs_project_forward
    # pointcloud, feats, invalid, object_id, n, table, edit, num_objects,
    # intrinsics, sh_mask, near, far, u_lo, u_hi, v_lo, v_hi, out, masks,
    # nonfinite, stream
    fn.argtypes = [p, p, p, p, i, p, p, i, p, p, f, f, f, f, f, f, p, p, p,
                   p]
    fn.restype = i
    fn = lib.t3dgs_project_backward
    # pointcloud, feats, object_id, n, table, edit, num_objects, intrinsics,
    # sh_mask, near, cot, cot_stride, grad_pc, grad_feats, stream
    fn.argtypes = [p, p, p, i, p, p, i, p, p, f, p, ctypes.c_longlong, p, p,
                   p]
    fn.restype = i
    return lib


def _compile(nvcc, sources, lib_path):
    """One nvcc per source, all started together, then one link; returns
    the compilers' output (ptxas -v). Raises on any failure."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources:
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()), "-c",
                   "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for cmd, _, proc in jobs:
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        # link under a temporary name and rename: a concurrent process
        # never loads a half-written library
        tmp_lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-shared", "-o", tmp_lib, *(obj for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp_lib, lib_path)
    return "".join(log)


def load_library():
    """Build (if needed) and load the kernel library; returns the CDLL."""
    global _library, build_log
    if _library is not None:
        return _library
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(repr((NVCC_FLAGS, sorted(SOURCE_FLAGS.items())))
                            .encode())
    for src in sorted(sources + list(CSRC_DIR.glob("*.cuh"))):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libt3dgs_kernels_{digest.hexdigest()[:16]}.so"
    if not lib_path.is_file():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        build_log = _compile(nvcc, sources, lib_path)
    _library = _declare(ctypes.CDLL(str(lib_path)))
    return _library


# The probes (taichi_3d_gaussian_splatting_torch/probes/): their
# sources in csrc/probes/, built into a library of their own, so that the
# kernel library above and its hash do not depend on them.
PROBE_DIR = CSRC_DIR / "probes"
_probe_library = None
# ptxas -v of the last probe build made in this process
probe_build_log = ""
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _included(path, seen):
    """`path` and every header it includes by a quoted #include, in the
    order first reached (headers are looked up beside their includer)."""
    path = path.resolve()
    if path in seen:
        return
    seen[path] = None
    for name in _INCLUDE.findall(path.read_text()):
        _included(path.parent / name, seen)


def _declare_probes(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    # data, tile_starts, tile_ends, num_tiles, mk, tiles_per_row, mode,
    # out, stream (perf_rgb_ablate2.cu, perf_kernel_ablate.cu,
    # perf_flip_proto.cu)
    for name in ("t3dgs_probe_rgb_ablate2", "t3dgs_probe_kernel_ablate",
                 "t3dgs_probe_flip_proto"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, i, i, i, i, p, p]
        fn.restype = i
    # coef, mono, n_chunks, variant, out, stream (perf_exp2_probe.cu)
    fn = lib.t3dgs_probe_exp2
    fn.argtypes = [p, p, i, i, p, p]
    fn.restype = i
    # x, programs, rows, cols, reps, mode, out, stream (perf_roll_micro.cu)
    fn = lib.t3dgs_probe_roll_micro
    fn.argtypes = [p, i, i, i, i, i, p, p]
    fn.restype = i
    # input, out, stream (roll_semantics_check.cu)
    for name in ("t3dgs_probe_roll_planes", "t3dgs_probe_work_list_scan"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p]
        fn.restype = i
    return lib


def probe_digest():
    """(sources, hash) of the probe library: csrc/probes/*.cu, and the hash
    of those sources, every header they include, NVCC_FLAGS and the
    SOURCE_FLAGS entries of the probe sources (a source given flags builds
    anew)."""
    sources = sorted(PROBE_DIR.glob("*.cu"))
    seen = {}
    for src in sources:
        _included(src, seen)
    flags = [(src.name, SOURCE_FLAGS[src.name]) for src in sources
             if src.name in SOURCE_FLAGS]
    digest = hashlib.sha256(repr((NVCC_FLAGS, flags)).encode())
    for path in sorted(seen):
        digest.update(str(path.relative_to(CSRC_DIR)).encode())
        digest.update(path.read_bytes())
    return sources, digest.hexdigest()[:16]


def load_probe_library():
    """Build (if needed) and load the probes' kernel library from
    csrc/probes/*.cu; returns the CDLL. Its file name carries the hash of
    probe_digest."""
    global _probe_library, probe_build_log
    if _probe_library is not None:
        return _probe_library
    sources, digest = probe_digest()
    lib_path = BUILD_DIR / f"libt3dgs_probes_{digest}.so"
    if not lib_path.is_file():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        probe_build_log = _compile(nvcc, sources, lib_path)
    _probe_library = _declare_probes(ctypes.CDLL(str(lib_path)))
    return _probe_library
