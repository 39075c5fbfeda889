"""Full training-state checkpoints: one .npz holding named arrays (the
scene, both Adam states, the controller accumulators, the random
generators' states), the iteration to resume from and the best validation
PSNR. It reads back exactly what it wrote."""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch


def save_checkpoint(path: str, arrays: Dict[str, torch.Tensor],
                    iteration: int, best_psnr: float = 0.0):
    """Write `arrays` (tensors or array-likes, any device) and the two
    counters; the file is replaced atomically."""
    flat = {name: (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                   else np.asarray(x)) for name, x in arrays.items()}
    flat["__iteration__"] = np.asarray(iteration, np.int64)
    flat["__best_psnr__"] = np.asarray(best_psnr, np.float64)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], int, float]:
    """(arrays by name, iteration, best PSNR) of a checkpoint."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files
                  if k not in ("__iteration__", "__best_psnr__")}
        return (arrays, int(data["__iteration__"]),
                float(data["__best_psnr__"]))
