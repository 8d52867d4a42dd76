"""Standardization, the counterpart of ``bbbp_tpu/ops/scaler.py::StandardScaler``.

Tensors stay on the device they arrive on; numpy input lands on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class StandardScaler:
    mean_: Optional[torch.Tensor] = None
    scale_: Optional[torch.Tensor] = None

    def fit(self, x) -> "StandardScaler":
        x = torch.as_tensor(x, dtype=torch.float32)
        self.mean_ = x.mean(dim=0)
        std = x.std(dim=0, correction=0)
        self.scale_ = torch.where(std < 1e-12, torch.ones_like(std), std)
        return self

    def transform(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32)
        return (x - self.mean_) / self.scale_

    def fit_transform(self, x) -> torch.Tensor:
        return self.fit(x).transform(x)

    def inverse_transform(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32) * self.scale_ + self.mean_


def standardize_per_batch(x, batch_size: int = 100) -> torch.Tensor:
    """Compat mode: an independent fit per consecutive batch of rows
    (reference quirk, Descriptors/..._fixed_1.py:86-103), on the device of
    ``x``."""
    x = torch.as_tensor(x, dtype=torch.float32)
    out = torch.empty_like(x)
    for start in range(0, len(x), batch_size):
        out[start:start + batch_size] = StandardScaler().fit_transform(
            x[start:start + batch_size])
    return out
