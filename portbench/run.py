"""Run one cell of BENCHMARK.json once (see harness/main.py):

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The program's caches live inside it, at
fixed paths: the port builds its kernels into its own `csrc/build/`, and
PyTorch's extension and Triton caches go under `.portbench_cache/`.
"""

import time

START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)
os.environ.setdefault("OMP_NUM_THREADS", "4")
sys.path.insert(0, ROOT)

from portbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], START))
