"""A scene as a density-control round leaves it: the `base` recipe's scene
with every alpha logit below `transparent_alpha_threshold` folded above it
(a -> 2 t - a), since a round prunes every valid point below the
threshold. The heavy-tailed recipe's translucent mode, N(-2, 1) with the
threshold at -2, becomes that mode truncated at its mean; the opaque mode
keeps its draws. The draws are the base recipe's, from the same
generator."""

from __future__ import annotations

import torch

from portbench.harness import spec


def fold_alpha(feats: torch.Tensor, threshold: float) -> torch.Tensor:
    """`feats` with each alpha logit below `threshold` folded above it."""
    out = feats.clone()
    a = out[:, 7]
    out[:, 7] = torch.where(a < threshold, 2.0 * threshold - a, a)
    return out


def make(n: int, params: dict, generator: torch.Generator):
    pc, feats = spec.recipe(params["base"]).make(n, params, generator)
    return pc, fold_alpha(feats, float(params["transparent_alpha_threshold"]))
