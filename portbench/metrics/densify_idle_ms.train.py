"""Device-idle ms a densify round whose gap began inside the `densify`
span or one of its stages, from the port's `summarize_trace` span table
of the traced stretch, over the stretch and divided by the rounds the
schedule puts in it."""


def read(r):
    return r.get("densify", {}).get("idle_ms")
