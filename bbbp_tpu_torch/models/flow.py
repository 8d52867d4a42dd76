"""Flow-MLP classifier (model family D / FL1-FL2) on the fold axis: the
counterpart of ``bbbp_tpu/models/flow.py`` (``models/fold.py``).

Stack of Linear+ReLU+Dropout blocks with an inverse path, CE classifier head
(reference: Descriptors/model_train_flow.py:30-75 FlowLayer/FlowModel). The
reference's ``reverse`` path is unused in training but part of the API; each
FlowLayer keeps square weight matrices so the reverse is a true
(pseudo-)inverse mapping: ``torch.linalg.pinv`` of the f32 kernel, as
``jnp.linalg.pinv``. bfloat16 compute, an f32 head.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bbbp_tpu_torch.models.fold import Dense, dropout


class FlowLayer(Dense):
    """flax ``FlowLayer``: ``kernel`` [K, dim, dim] (lecun-normal), ``bias``
    [K, dim]; relu(x·W + b) in ``dtype``, then dropout."""

    def __init__(self, folds: int, dim: int, rate: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16, device=None, generator=None):
        super().__init__(folds, dim, dim, dtype, device, generator)
        self.folds, self.rate = folds, rate

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(torch.relu(super().forward(x)), self.rate, train, generator)

    def reverse(self, y: torch.Tensor) -> torch.Tensor:
        """The inverse of y = relu(x·W + b) on the active set: x ≈ (y − b)·W⁺
        in f32, cast to ``dtype``; y [K, B, dim]."""
        w_inv = torch.linalg.pinv(self.kernel)
        return torch.bmm(y.float() - self.bias.unsqueeze(1), w_inv).to(self.dtype)


class FlowModel(nn.Module):
    """``in_proj`` (dense to ``hidden_dim``) → ``flow{i}`` × ``n_layers`` →
    ``head`` (f32 dense to ``n_classes``). ``d_in`` is the input width (flax
    infers it at init). x [K, B, d_in] or [B, d_in] → logits [K, B,
    n_classes] ([B, n_classes] for one fold given inputs without K)."""

    def __init__(self, d_in: int, hidden_dim: int = 128, n_layers: int = 3,
                 n_classes: int = 2, dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16, folds: int = 1,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = dict(d_in=d_in, hidden_dim=hidden_dim, n_layers=n_layers,
                           n_classes=n_classes, dropout=dropout, dtype=dtype)
        self.folds, self.n_layers = folds, n_layers
        on = dict(device=device, generator=generator)
        self.in_proj = Dense(folds, d_in, hidden_dim, dtype, **on)
        for i in range(n_layers):
            self.add_module(f"flow{i}", FlowLayer(folds, hidden_dim, dropout,
                                                  dtype, **on))
        self.head = Dense(folds, hidden_dim, n_classes, torch.float32, **on)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        single = x.dim() == 2
        if single:
            x = x.expand(self.folds, *x.shape)
        x = self.in_proj(x)
        for i in range(self.n_layers):
            x = getattr(self, f"flow{i}")(x, train, generator)
        out = self.head(x.float())
        return out[0] if single and self.folds == 1 else out
