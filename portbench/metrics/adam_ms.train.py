"""Device ms a step between the trainer's "projection backward" and
"adam" marks (CUDA events, untraced): gradient scaling and containment,
both Adam chains and the controller's statistics."""


def read(r):
    return r.get("stages_ms", {}).get("adam")
