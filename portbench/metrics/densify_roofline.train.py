"""The densify round's share of its roofline, in %: the least bytes of the
stretch's round and reset (`work/densify.py`, from the pool's slots and
the slots the program's counters say the rounds filled and split) at the
peak bandwidth over `densify_ms`."""

from portbench.work.densify import round_bound_ms


def read(r):
    d = r.get("densify")
    if not d or not d.get("ms"):
        return None
    return 100.0 * round_bound_ms(d["slots"], d["filled"], d["splits"],
                                  d["resets"]) / d["ms"]
