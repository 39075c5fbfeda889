"""A run's last line carries exactly the contract's keys, with the
comparison's numbers last; the checks are the last lines of standard
error; a run without a card prints no result."""

import pytest

from helpers import run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["tiny-render", "tiny-train"])
def test_trace0_line(cell):
    rc, line, err = run_tiny(cell)
    assert rc == 0
    assert list(line) == KEYS + ["checks"]
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert "setup_s" in line["metrics"]
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_trace1_line_has_no_end_to_end_metric():
    rc, line, _ = run_tiny("tiny-render", trace=1)
    assert rc == 0 and line["correct"] is True
    assert not {"setup_s", "frame_ms"} & set(line["metrics"])


def test_no_card_no_result(monkeypatch):
    import time
    from conftest import BENCHMARK, DATA
    from portbench.harness import main as M
    printed = []
    monkeypatch.setattr("builtins.print", lambda *a, **k: printed.append(a))
    rc = M.main(["--workload", "tiny-render", "--seed", "1", "--seconds",
                 "1"], time.time(), require_card=True,
                benchmark_path=BENCHMARK, pieces=DATA) \
        if M.card_count() == 0 else pytest.skip("a card is present")
    assert rc == M.NO_CARD
    assert not any(str(a[0]).startswith("{") for a in printed if a)


def test_forbidden_module_ends_the_run(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, line, err = run_tiny("tiny-render")
    assert rc == 4 and line is None and "jax" in err
