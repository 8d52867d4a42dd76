"""PCA by eigendecomposition, the counterpart of ``bbbp_tpu/ops/pca.py::PCA``.

Primal path (d <= n): eigendecompose the d×d covariance. Dual path (d > n):
eigendecompose the n×n Gram matrix and recover V = Xᵀ U Σ⁻¹. Components carry
sklearn's sign convention (the largest-|.| element of each is positive), as
the JAX package's do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch


@dataclass
class PCA:
    n_components: Union[int, float, None] = None
    mean_: Optional[torch.Tensor] = None
    components_: Optional[torch.Tensor] = None          # [k, d]
    explained_variance_: Optional[torch.Tensor] = None  # [k]
    explained_variance_ratio_: Optional[torch.Tensor] = None

    def fit(self, x) -> "PCA":
        x = torch.as_tensor(x, dtype=torch.float32)
        n, d = x.shape
        self.mean_ = x.mean(dim=0)
        xc = x - self.mean_
        if d <= n:
            cov = (xc.T @ xc) / max(n - 1, 1)
            w, v = torch.linalg.eigh(cov)               # ascending
            w, v = w.flip(0), v.flip(1)
        else:
            gram = xc @ xc.T                            # [n, n]
            wg, u = torch.linalg.eigh(gram)             # ascending
            wg, u = wg.flip(0), u.flip(1)
            sigma = torch.sqrt(torch.clamp(wg, min=1e-12))
            v = xc.T @ (u / sigma[None, :])             # [d, n]
            w = wg / max(n - 1, 1)
        pos = torch.clamp(w, min=0.0)
        ratio = pos / torch.clamp(pos.sum(), min=1e-12)
        if self.n_components is None:
            k = min(n, d)
        elif isinstance(self.n_components, float):
            csum = torch.cumsum(ratio, 0).cpu()
            k = int(torch.searchsorted(csum, torch.tensor(self.n_components))) + 1
        else:
            k = int(min(self.n_components, min(n, d)))
        comp = v[:, :k].T                               # [k, d]
        idx = comp.abs().argmax(dim=1)
        signs = torch.sign(comp[torch.arange(k, device=comp.device), idx])
        signs = torch.where(signs == 0, torch.ones_like(signs), signs)
        self.components_ = comp * signs[:, None]
        self.explained_variance_ = w[:k]
        self.explained_variance_ratio_ = ratio[:k]
        return self

    def transform(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32)
        return (x - self.mean_) @ self.components_.T

    def fit_transform(self, x) -> torch.Tensor:
        return self.fit(x).transform(x)

    def inverse_transform(self, z) -> torch.Tensor:
        return torch.as_tensor(z, dtype=torch.float32) @ self.components_ + self.mean_


def pca_per_batch(x, n_components: int, batch_size: int = 100) -> torch.Tensor:
    """Compat mode: PCA re-fit per consecutive batch of rows (reference
    quirk, Descriptors/multi_input_data_preprocess_maccs_opt_IsolationForest_fixed_2.py:103-114),
    on the device of ``x``; a batch of fewer rows than ``n_components``
    leaves its last columns 0."""
    x = torch.as_tensor(x, dtype=torch.float32)
    out = torch.zeros((len(x), n_components), dtype=torch.float32, device=x.device)
    for start in range(0, len(x), batch_size):
        blk = x[start:start + batch_size]
        k = min(n_components, blk.shape[0], blk.shape[1])
        out[start:start + batch_size, :k] = PCA(k).fit_transform(blk)
    return out
