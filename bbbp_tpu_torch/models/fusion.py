"""Attention-fusion heads joining the fingerprint and image branches, the
counterparts of ``bbbp_tpu/models/fusion.py`` on the fold axis
(``models/fold.py``): activations are [K, B, ...], parameters [K, ...].

- ``MultiHeadAttentionFusion``: 4 additive-attention heads over the
  concatenated branch embeddings, softmax over heads, weighted sum;
- ``AttentionFusion``: a single additive gate, elementwise reweighting;
- ``MultiModalAttentionFusion``: per-modality attention scalars and a
  cross-modal projection, concat(w_fp·fp, w_img·img, cross).

Computation in ``dtype`` (bf16 by default) with f32 parameters, as the flax
modules. ``MultiHeadAttentionFusion`` keeps its heads' parameters side by
side in one tensor each (one product for the four first score layers, one
for the four values).
"""

from __future__ import annotations

import torch
from torch import nn

from bbbp_tpu_torch.models.fold import Dense, dense, lecun_normal

SCORE_DIM = 64


class MultiHeadAttentionFusion(nn.Module):
    """heads × (Linear→tanh→Linear→scalar) over the concat embedding;
    softmax over heads; output = Σ_h w_h · (V_h @ concat)."""

    def __init__(self, folds: int, d_in: int, num_heads: int = 4,
                 out_dim: int = 256, dtype: torch.dtype = torch.bfloat16,
                 device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.num_heads, self.out_dim = num_heads, out_dim
        h = num_heads
        self.score_1_kernel = nn.Parameter(lecun_normal(
            (folds, d_in, h * SCORE_DIM), d_in, device, generator))
        self.score_1_bias = nn.Parameter(torch.zeros(folds, h * SCORE_DIM,
                                                     device=device))
        self.score_2_kernel = nn.Parameter(lecun_normal(
            (folds, h, SCORE_DIM), SCORE_DIM, device, generator))
        self.score_2_bias = nn.Parameter(torch.zeros(folds, h, device=device))
        self.value_kernel = nn.Parameter(lecun_normal(
            (folds, d_in, h * out_dim), d_in, device, generator))
        self.value_bias = nn.Parameter(torch.zeros(folds, h * out_dim,
                                                   device=device))

    def forward(self, fp_emb: torch.Tensor, img_emb: torch.Tensor) -> torch.Tensor:
        dt, h = self.dtype, self.num_heads
        x = torch.cat([fp_emb, img_emb], dim=-1).to(dt)
        s = torch.tanh(dense(x, self.score_1_kernel, self.score_1_bias, dt))
        s = s.unflatten(-1, (h, SCORE_DIM))                         # [K, B, H, 64]
        scores = torch.einsum("kbhd,khd->kbh", s, self.score_2_kernel.to(dt))
        scores = scores + self.score_2_bias.to(dt).unsqueeze(1)     # [K, B, H]
        w = torch.softmax(scores, dim=-1).to(dt)
        v = self.values(x).unflatten(-1, (h, self.out_dim))          # [K, B, H, D]
        return torch.einsum("kbh,kbhd->kbd", w, v)

    def values(self, x: torch.Tensor) -> torch.Tensor:
        """The heads' values side by side, [K, B, H·D]."""
        return dense(x, self.value_kernel, self.value_bias, self.dtype)


class AttentionFusion(nn.Module):
    """Single additive gate: x · sigmoid(W2·tanh(W1·x)). flax names the
    outer layer ``Dense_0`` (it is built first) and the inner ``Dense_1``."""

    def __init__(self, folds: int, d_in: int, dtype: torch.dtype = torch.bfloat16,
                 device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = Dense(folds, 64, d_in, dtype, device, generator)
        self.Dense_1 = Dense(folds, d_in, 64, dtype, device, generator)

    def forward(self, fp_emb: torch.Tensor, img_emb: torch.Tensor) -> torch.Tensor:
        x = torch.cat([fp_emb, img_emb], dim=-1).to(self.dtype)
        g = self.Dense_0(torch.tanh(self.Dense_1(x)))
        return x * torch.sigmoid(g)


class MultiModalAttentionFusion(nn.Module):
    """Per-modality scalar attention + cross projection: softmax([a_fp,
    a_img]) weights each modality; a cross-modal projection of the concat is
    appended → concat(fp_w·fp, img_w·img, cross)."""

    def __init__(self, folds: int, emb_dim: int, cross_dim: int = 128,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator=None):
        super().__init__()
        self.dtype = dtype
        self.attn_fp = Dense(folds, emb_dim, 1, dtype, device, generator)
        self.attn_img = Dense(folds, emb_dim, 1, dtype, device, generator)
        self.cross = Dense(folds, 2 * emb_dim, cross_dim, dtype, device, generator)

    def forward(self, fp_emb: torch.Tensor, img_emb: torch.Tensor) -> torch.Tensor:
        fp_emb, img_emb = fp_emb.to(self.dtype), img_emb.to(self.dtype)
        a = torch.cat([self.attn_fp(torch.tanh(fp_emb)),
                       self.attn_img(torch.tanh(img_emb))], dim=-1)
        w = torch.softmax(a, dim=-1).to(self.dtype)
        cross = self.cross(torch.cat([fp_emb, img_emb], dim=-1))
        return torch.cat([fp_emb * w[..., :1], img_emb * w[..., 1:2], cross],
                         dim=-1)
