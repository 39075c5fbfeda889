"""Device ms a step between the trainer's "forward blend" and "loss"
marks (CUDA events, untraced): the clip, L1 + SSIM and its image
gradient."""


def read(r):
    return r.get("stages_ms", {}).get("loss")
