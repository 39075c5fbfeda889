"""Build and load the package's CUDA kernels.

The sources in ``csrc/*.cu`` have a plain C interface. At first use they
are compiled by ``nvcc`` for sm_90a into one shared library whose file name
carries the hash of the sources and flags, under ``csrc/build/`` (listed in
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    fn = lib.t3dgs_blend_forward
    # data, tile_starts, tile_ends, out, mk, num_tiles, tiles_per_row,
    # packed8, rgb_only, stream
    fn.argtypes = [p, p, p, p, i, i, i, i, i, p]
    fn.restype = i
    return lib


def load_library():
    """Build (if needed) and load the kernel library; returns the CDLL."""
    global _library, build_log
    if _library is not None:
        return _library
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libt3dgs_kernels_{digest.hexdigest()[:16]}.so"
    if not lib_path.is_file():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name and rename: a concurrent process
        # never loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        build_log = proc.stdout + proc.stderr
        os.replace(tmp, lib_path)
    _library = _declare(ctypes.CDLL(str(lib_path)))
    return _library
