"""Degree-2 interaction-only polynomial features, the counterpart of
``bbbp_tpu/ops/interactions.py``.

Replaces ``PolynomialFeatures(degree=2, interaction_only=True,
include_bias=False)`` applied to the concatenated 30+30 PCA blocks
(reference: Descriptors/multi_input_data_preprocess_maccs_opt_IsolationForest_fixed_1.py:117-125).
Output layout matches sklearn: [x_1..x_d, x_1 x_2, x_1 x_3, ..., x_{d-1} x_d].
Each product is one f32 multiply, as in the JAX package, so the two agree
bit for bit. Tensors stay on their device; numpy input lands on the CPU.
"""

from __future__ import annotations

import torch


def interaction_features(x) -> torch.Tensor:
    """[N, d] → [N, d + d(d-1)/2] interaction-only degree-2 features."""
    x = torch.as_tensor(x, dtype=torch.float32)
    iu, ju = torch.triu_indices(x.shape[1], x.shape[1], offset=1,
                                device=x.device)
    return torch.cat([x, x[:, iu] * x[:, ju]], dim=1)


def interaction_dim(d: int) -> int:
    return d + d * (d - 1) // 2
