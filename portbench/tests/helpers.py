"""Drive a tiny cell's run on the CPU, as run.py does on the card."""

import contextlib
import io
import json
import time

from conftest import BENCHMARK, DATA


def run_tiny(cell, trace=0, seed=2147483999, seconds=0.5):
    """(exit code, the last line of standard output parsed, standard
    error) of a run of the tiny cell `cell` with the card's check off."""
    from portbench.harness.main import main
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], time.time(),
                  require_card=False, benchmark_path=BENCHMARK, pieces=DATA)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
