"""Class-imbalance resampling: SMOTE, Tomek-link removal, SMOTETomek, the
counterpart of ``bbbp_tpu/ops/resample.py``.

The random draws are the JAX package's (numpy ``default_rng(seed)``, in the
same order); the pairwise distances max(|a|² + |b|² − 2a·b, 0) and the
neighbour searches run on ``device`` (f32, TF32 off). SMOTE's neighbour
lists take the lower index first among equal distances; Tomek's nearest
neighbour is the first of the least. Tomek's loop over rows is one
mutual-nearest-neighbour mask.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from bbbp_tpu_torch.ops.forest_train import resolve_device
from bbbp_tpu_torch.ops.linear import nearest
from bbbp_tpu_torch.ops.similarity import f32_matmul


def _pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aa = torch.sum(a * a, dim=1, keepdim=True)
    bb = torch.sum(b * b, dim=1)
    return torch.clamp(aa + bb - 2.0 * (a @ b.T), min=0.0)


def _self_dists(x: np.ndarray, device) -> torch.Tensor:
    """[n, n] squared distances of the rows of ``x``, +inf on the diagonal."""
    with f32_matmul():
        xd = torch.from_numpy(x).to(device)
        d = _pairwise_sq_dists(xd, xd)
    d.fill_diagonal_(float("inf"))
    return d


def smote_neighbors(xc: np.ndarray, kk: int, device) -> np.ndarray:
    """[nc, kk] indices of each row's kk nearest other rows of ``xc``."""
    return nearest(_self_dists(xc, device), kk).cpu().numpy()


def smote(x: np.ndarray, y: np.ndarray, k: int = 5, seed: int = 0,
          device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Oversample the minority class to parity by kNN interpolation."""
    dev = resolve_device(device)
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y).astype(np.int32)
    classes, counts = np.unique(y, return_counts=True)
    maj = classes[np.argmax(counts)]
    rng = np.random.default_rng(seed)
    new_x, new_y = [x], [y]
    for c in classes:
        if c == maj:
            continue
        need = int(counts.max() - (y == c).sum())
        if need <= 0:
            continue
        xc = x[y == c]
        if len(xc) < 2:
            continue
        kk = min(k, len(xc) - 1)
        nn = smote_neighbors(xc, kk, dev)             # [nc, kk]
        base = rng.integers(0, len(xc), size=need)
        pick = nn[base, rng.integers(0, kk, size=need)]
        gap = rng.random((need, 1), dtype=np.float32)
        synth = xc[base] + gap * (xc[pick] - xc[base])
        new_x.append(synth.astype(np.float32))
        new_y.append(np.full(need, c, dtype=np.int32))
    return np.concatenate(new_x), np.concatenate(new_y)


def tomek_nearest(x: np.ndarray, device) -> np.ndarray:
    """[n] each row's nearest other row (the first of equals)."""
    return torch.argmin(_self_dists(x, device), dim=1).cpu().numpy()


def tomek_links(x: np.ndarray, y: np.ndarray, device="cuda") -> np.ndarray:
    """Boolean keep-mask removing majority members of Tomek links
    (mutual nearest neighbors of opposite class)."""
    dev = resolve_device(device)
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y).astype(np.int32)
    nn = tomek_nearest(x, dev)
    classes, counts = np.unique(y, return_counts=True)
    maj = classes[np.argmax(counts)]
    link = (nn[nn] == np.arange(len(x))) & (y != y[nn])
    # each pair is seen from both ends: its majority member goes (the
    # imblearn default); a pair of two minority classes stays
    return ~(link & (y == maj))


def smote_tomek(x: np.ndarray, y: np.ndarray, k: int = 5, seed: int = 0,
                device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """SMOTE to parity then Tomek-link cleaning
    (reference: Models/model_opt_20250130.py:393-394)."""
    xs, ys = smote(x, y, k=k, seed=seed, device=device)
    keep = tomek_links(xs, ys, device=device)
    return xs[keep], ys[keep]
