"""Checkpoint / resume of a solution block.

Counterpart of ``blockcg_tpu/utils/checkpoint.py``, in the same ``.npz``
format, so a checkpoint written by either package loads in the other.
Resume is a warm start from the saved X; ``solve_refined`` checkpoints
between refinement cycles when given a path.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def save_checkpoint(path: str, X: torch.Tensor, *, iteration: int = 0,
                    meta: dict | None = None) -> None:
    """Atomic save of the current solution block (+ small metadata)."""
    tmp = path + ".tmp"
    arrs = {"X": X.detach().cpu().numpy(), "iteration": np.asarray(iteration)}
    for k, v in (meta or {}).items():
        arrs[f"meta_{k}"] = np.asarray(v)
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cuda"):
    """Returns (X on ``device``, iteration, meta) or None when no checkpoint
    exists. X goes to the card unless the caller names another device, as
    with every entry point of the package."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        X = torch.as_tensor(z["X"], device=device)
        it = int(z["iteration"])
        meta = {k[len("meta_"):]: z[k] for k in z.files if k.startswith("meta_")}
    return X, it, meta
