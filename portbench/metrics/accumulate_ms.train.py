"""Device ms a batch step in its `accumulate` stage (CUDA events,
untraced): for each view, between the batch step's "projection backward"
and "accumulate" marks, the controller's statistics from the view's raw
position gradient, its feature gradients' scale and mask and the two
running sums; summed over the step's views."""


def read(r):
    return r.get("stages_ms", {}).get("accumulate")
