"""Dual-branch MLP regressor (model family B1/B3/B5) on the fold axis: the
counterpart of ``bbbp_tpu/models/mlp.py`` (``models/fold.py``).

Fingerprint branch fp→512→256→128, image branch flat→1024→256→128, fused head
concat(256)→256→128→64→1 with BatchNorm + Dropout
(reference: Models/multi_input_data_regression_opt.py:41-85). bfloat16
compute, an f32 last layer. Each branch layer is dense → BatchNorm → ReLU →
dropout; BatchNorm (``fold.BatchNorm``) normalises each fold over its own
batch and keeps its running statistics as [K, d] buffers, flax's
``batch_stats``. flax infers the input widths at init; here they are
``fp_dim`` and ``img_dim``. Submodules and parameters carry flax's names
(``fp_branch``, ``img_branch``, ``Dense_0`` ..., ``BatchNorm_0`` ...).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from bbbp_tpu_torch.models.fold import BatchNorm, Dense, dropout


class Branch(nn.Module):
    """flax ``_Branch``: ``Dense_i`` → ``BatchNorm_i`` → ReLU → dropout."""

    def __init__(self, folds: int, d_in: int, dims: Sequence[int], rate: float,
                 dtype: torch.dtype, device=None, generator=None):
        super().__init__()
        self.dtype, self.rate, self.n = dtype, rate, len(dims)
        for i, d in enumerate(dims):
            self.add_module(f"Dense_{i}", Dense(folds, d_in, d, dtype, device,
                                                generator))
            self.add_module(f"BatchNorm_{i}", BatchNorm(folds, d, dtype, device))
            d_in = d

    def forward(self, x, train: bool, generator=None):
        x = x.to(self.dtype)
        for i in range(self.n):
            x = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Dense_{i}")(x),
                                                train)
            x = dropout(torch.relu(x), self.rate, train, generator)
        return x


class DualBranchMLP(nn.Module):
    """K = ``folds`` independent models. fp [K, B, fp_dim] and img_flat
    [K, B, img_dim] (or both without K: the same rows through every model)
    → [K, B] ([B] for one fold given inputs without a fold axis)."""

    def __init__(self, fp_dim: int, img_dim: int,
                 fp_dims: Sequence[int] = (512, 256, 128),
                 img_dims: Sequence[int] = (1024, 256, 128),
                 head_dims: Sequence[int] = (256, 128, 64),
                 dropout: float = 0.2, dtype: torch.dtype = torch.bfloat16,
                 folds: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = dict(fp_dim=fp_dim, img_dim=img_dim, fp_dims=tuple(fp_dims),
                           img_dims=tuple(img_dims), head_dims=tuple(head_dims),
                           dropout=dropout, dtype=dtype)
        self.folds, self.dtype, self.rate = folds, dtype, dropout
        on = dict(device=device, generator=generator)
        self.fp_branch = Branch(folds, fp_dim, fp_dims, dropout, dtype, **on)
        self.img_branch = Branch(folds, img_dim, img_dims, dropout, dtype, **on)
        d = fp_dims[-1] + img_dims[-1]
        self.n_head = len(head_dims)
        for i, width in enumerate(head_dims):
            self.add_module(f"Dense_{i}", Dense(folds, d, width, dtype, **on))
            d = width
        self.add_module(f"Dense_{self.n_head}", Dense(folds, d, 1, torch.float32,
                                                      **on))

    def forward(self, fp: torch.Tensor, img_flat: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        k = self.folds
        single = fp.dim() == 2
        if single:
            fp, img_flat = fp.expand(k, *fp.shape), img_flat.expand(k, *img_flat.shape)
        f = self.fp_branch(fp, train, generator)
        g = self.img_branch(img_flat, train, generator)
        x = torch.cat([f, g], dim=-1)
        for i in range(self.n_head):
            x = dropout(torch.relu(getattr(self, f"Dense_{i}")(x)), self.rate,
                        train, generator)
        out = getattr(self, f"Dense_{self.n_head}")(x.float())[..., 0]
        return out[0] if single and k == 1 else out
