"""Build and load the package's CUDA kernels.

The sources in ``csrc/*.cu`` have a plain C interface. At first use each
is compiled by its own ``nvcc`` for sm_90a, all at once, and the objects
are linked into one shared library whose file name carries the hash of the
sources (headers included) and flags, under ``csrc/build/`` (listed in
``.gitignore``), and loaded with ``ctypes``. A second call in the same
process, or a later process with unchanged sources, reuses the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    # num_split_items, counters, tchunk, partial, out, mk, tiles_per_row,
    # packed8, rgb_only, stream
    fn.argtypes = [p, p, p, i, i, p, i, i, p, p, p, p, i, i, i, i, p]
    fn.restype = i
    fn = lib.t3dgs_blend_backward
    # data, tile_starts, tile_ends, num_tiles, chunk, items, num_items,
    # num_split_items, counters, pixel_in, tq, mag_part, grad, mag, mk,
    # tiles_per_row, stream
    fn.argtypes = [p, p, p, i, i, p, i, i, p, p, p, p, p, p, i, i, p]
    fn.restype = i
    return lib


def _compile(nvcc, sources, lib_path):
    """One nvcc per source, all started together, then one link; returns
    the compilers' output (ptxas -v). Raises on any failure."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources:
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
