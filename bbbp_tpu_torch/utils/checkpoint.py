"""Checkpoint / resume of a state tree, the counterpart of
``bbbp_tpu/utils/checkpoint.py``.

The reference persists only final artifacts (SURVEY.md §5 checkpoint/resume:
'no mid-training checkpoints and no resume logic'). Here any state tree
(nested dicts of tensors or arrays: params, running statistics, optimizer
moments, step counters) checkpoints mid-training and restores for resume;
per-fold stacked states checkpoint as one tree.

The JAX package writes through orbax, which the card's machine does not
have. The format here is the port's own: a directory (``path`` or
``path/step_N``) holding ``state.pt``, the tree with every leaf a CPU
tensor, written by ``torch.save`` and read with ``weights_only=True`` (no
pickled code runs on load). The tree itself is the JAX package's: the same
paths and shapes (``run_regression``'s ``nn_checkpoint`` is flax's layout
with the fold axis, ``models/convert.py``).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Mapping, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {str(k): _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree))
    return tree


def save_checkpoint(path: str, state: Any, step: Optional[int] = None,
                    overwrite: bool = True) -> str:
    """Save a state tree; returns the checkpoint directory. An existing
    directory is replaced with ``overwrite``, refused without it."""
    path = os.path.abspath(path)
    if step is not None:
        path = os.path.join(path, f"step_{step}")
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(f"checkpoint {path} exists")
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(_to_cpu(state), os.path.join(path, STATE_FILE))
    return path


def _fit(tree: Any, target: Any, where: str) -> Any:
    """``tree`` shaped and typed as ``target``: every leaf of the same shape,
    cast to the target leaf's dtype and moved to its device."""
    if isinstance(target, Mapping):
        if not isinstance(tree, Mapping) or set(map(str, target)) != set(tree):
            raise ValueError(f"checkpoint at {where or '/'} has keys "
                             f"{sorted(tree) if isinstance(tree, Mapping) else tree!r}, "
                             f"the target {sorted(map(str, target))}")
        return {str(k): _fit(tree[str(k)], v, f"{where}/{k}") for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if len(tree) != len(target):
            raise ValueError(f"checkpoint at {where} holds {len(tree)} items, "
                             f"the target {len(target)}")
        return type(target)(_fit(a, b, f"{where}/{i}")
                            for i, (a, b) in enumerate(zip(tree, target)))
    if isinstance(target, (torch.Tensor, np.ndarray, np.generic)):
        want = torch.as_tensor(target) if not isinstance(target, torch.Tensor) else target
        if tuple(tree.shape) != tuple(want.shape):
            raise ValueError(f"checkpoint leaf {where} has shape {tuple(tree.shape)}, "
                             f"the target {tuple(want.shape)}")
        out = tree.to(device=want.device, dtype=want.dtype)
        return out if isinstance(target, torch.Tensor) else out.numpy()
    return tree


def restore_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    """Restore a state tree of CPU tensors; with ``target`` (a tree of the
    same structure) each leaf is checked against the target's shape, cast to
    its dtype and placed on its device (numpy targets give numpy arrays)."""
    tree = torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                      map_location="cpu", weights_only=True)
    return tree if target is None else _fit(tree, target, "")


def latest_step(root: str) -> Optional[int]:
    """Largest step_N subdirectory under root, or None."""
    if not os.path.isdir(root):
        return None
    steps = []
    for d in os.listdir(root):
        if d.startswith("step_"):
            try:
                steps.append(int(d[5:]))
            except ValueError:
                pass
    return max(steps) if steps else None
