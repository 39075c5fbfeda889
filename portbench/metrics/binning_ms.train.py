"""Device ms a step between the trainer's "projection" and "binning"
marks (CUDA events, untraced): tile binning, the sort and the slab
gather."""


def read(r):
    return r.get("stages_ms", {}).get("binning")
