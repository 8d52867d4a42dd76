"""Multimodal Transformer+CNN regressor, the flagship model: the counterpart
of ``bbbp_tpu/models/transformer_cnn.py`` on the fold axis
(``models/fold.py``).

- fingerprint → ``n_layers`` encoder layers. With ``fp_tokens`` 1 the
  fingerprint is one token, so self-attention is the identity-weighted
  ``x + Wo·Wv·x`` and a layer is ``DegenerateEncoderLayer``'s two linears,
  LayerNorm, feed-forward residual, LayerNorm. With ``fp_tokens`` > 1 the
  fingerprint is cut into tokens with real self-attention
  (``TokenEncoderLayer``). Fingerprints wider than ``max_fp_width`` are
  projected down first (``fp_in_proj``).
- image 128×128×3 (NHWC, or flat) → ``ImageCNN``: conv 3→32, pool, conv
  32→64, pool, dense 128.
- fusion (``multihead`` | ``gate`` | ``crossmodal``) → head 256→128→64 →
  an f32 last layer.

Parameters are f32 with a leading fold axis [K, ...]; compute is ``dtype``
(bf16 by default). ``MultiModalRegressor(folds=K)`` is K independent
models: ``forward`` takes inputs with a fold axis ([K, B, ...], fold k's
rows through model k) or without one (the same rows through every model)
and returns [K, B]; a model of one fold given inputs without a fold axis
returns [B], as the flax module. Submodules and parameters carry flax's
names (``enc0``, ``cnn/Conv_0``, ``Dense_3``, ...), so that
``models/convert.py`` loads a flax params tree.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bbbp_tpu_torch.models.fold import (Conv3x3, Dense, LayerNorm, dropout,
                                        fold_rand)
from bbbp_tpu_torch.models.fusion import (AttentionFusion,
                                          MultiHeadAttentionFusion,
                                          MultiModalAttentionFusion)

FUSIONS = ("multihead", "gate", "crossmodal")


class DegenerateEncoderLayer(nn.Module):
    """A torch ``TransformerEncoderLayer`` at sequence length 1:
    self-attention is x + Wo·Wv·x (every head's probability is 1), then
    LayerNorm, then the feed-forward residual, then LayerNorm."""

    def __init__(self, folds: int, d_model: int, d_ff: int, dropout: float,
                 dtype: torch.dtype, device=None, generator=None):
        super().__init__()
        self.rate = dropout
        self.value = Dense(folds, d_model, d_model, dtype, device, generator)
        self.out = Dense(folds, d_model, d_model, dtype, device, generator)
        self.ff1 = Dense(folds, d_model, d_ff, dtype, device, generator)
        self.ff2 = Dense(folds, d_ff, d_model, dtype, device, generator)
        self.LayerNorm_0 = LayerNorm(folds, d_model, dtype, device)
        self.LayerNorm_1 = LayerNorm(folds, d_model, dtype, device)

    def forward(self, x, train: bool, generator=None):
        o = dropout(self.out(self.value(x)), self.rate, train, generator)
        x = self.LayerNorm_0(x + o)
        f = dropout(torch.relu(self.ff1(x)), self.rate, train, generator)
        return self.LayerNorm_1(x + self.ff2(f))


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (self-attention): query, key
    and value projections to heads × head_dim, queries scaled by
    1/√head_dim, scores where ``mask`` is False set to the compute dtype's
    most negative finite value (flax's ``finfo(dtype).min``, so a row with
    every key masked averages them uniformly, where −inf would give NaN),
    softmax over keys in the compute dtype, dropout on the weights (one
    mask for the batch and heads of a fold, flax's ``broadcast_dropout``),
    then ``out``.
    Its flax leaves are ``DenseGeneral``s ([in, heads, head_dim] and
    [heads, head_dim, out]); here they are dense layers of the same numbers
    (``models/convert.py`` reshapes them)."""

    def __init__(self, folds: int, d_model: int, n_heads: int, dropout: float,
                 dtype: torch.dtype, device=None, generator=None):
        super().__init__()
        self.n_heads, self.rate, self.dtype = n_heads, dropout, dtype
        for name in ("query", "key", "value", "out"):
            setattr(self, name, Dense(folds, d_model, d_model, dtype, device,
                                      generator))

    def forward(self, x, train: bool, generator=None, mask=None):
        """x [K, B, T, d]; ``mask``: None or bool, broadcastable to
        [K, B, H, T, T] (True where a query attends to a key)."""
        k, b, t, d = x.shape
        h = self.n_heads
        hd = d // h

        def heads(y):                                    # [K, B, H, T, hd]
            return y.view(k, b, t, h, hd).transpose(2, 3)

        q = heads(self.query(x)) / torch.tensor(math.sqrt(hd), dtype=self.dtype)
        s = q @ heads(self.key(x)).transpose(-1, -2)
        if mask is not None:
            s = torch.where(mask, s, torch.finfo(s.dtype).min)
        w = torch.softmax(s, dim=-1)
        if train and self.rate > 0.0:
            keep = 1.0 - self.rate
            kept = fold_rand((k, 1, 1, t, t), x.device, generator) < keep
            w = w * (kept.to(self.dtype) / torch.tensor(keep, dtype=self.dtype))
        a = (w.to(self.dtype) @ heads(self.value(x))).transpose(2, 3)
        return self.out(a.reshape(k, b, t, d))


class TokenEncoderLayer(nn.Module):
    """A self-attention encoder layer over fingerprint tokens
    (``fp_tokens`` > 1)."""

    def __init__(self, folds: int, d_model: int, n_heads: int, d_ff: int,
                 dropout: float, dtype: torch.dtype, device=None, generator=None):
        super().__init__()
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            folds, d_model, n_heads, dropout, dtype, device, generator)
        self.LayerNorm_0 = LayerNorm(folds, d_model, dtype, device)
        self.Dense_0 = Dense(folds, d_model, d_ff, dtype, device, generator)
        self.Dense_1 = Dense(folds, d_ff, d_model, dtype, device, generator)
        self.LayerNorm_1 = LayerNorm(folds, d_model, dtype, device)

    def forward(self, x, train: bool, generator=None):
        x = self.LayerNorm_0(x + self.MultiHeadDotProductAttention_0(
            x, train, generator))
        f = self.Dense_1(torch.relu(self.Dense_0(x)))
        return self.LayerNorm_1(x + f)


class ImageCNN(nn.Module):
    """3→32→64 conv/pool stack → dense ``out_dim``. Images [K, B, H, W, 3]
    (NHWC, as flax) go through each fold's convolutions in ``channels_last``
    memory, which is NHWC, so no copy turns them; the pooled maps are
    flattened in H, W, C order, as flax's reshape, so ``Dense_0``'s kernel
    is flax's as it is."""

    def __init__(self, folds: int, side: int, out_dim: int = 128,
                 dtype: torch.dtype = torch.bfloat16, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv3x3(folds, 3, 32, dtype, device, generator)
        self.Conv_1 = Conv3x3(folds, 32, 64, dtype, device, generator)
        flat = (side // 4) * (side // 4) * 64
        self.Dense_0 = Dense(folds, flat, out_dim, dtype, device, generator)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        b = img.shape[1]
        xs = img.permute(0, 1, 4, 2, 3).unbind(0)       # K × [B, 3, H, W], NHWC memory
        xs = [F.max_pool2d(torch.relu(x), 2, 2) for x in self.Conv_0(xs)]
        xs = [F.max_pool2d(torch.relu(x), 2, 2) for x in self.Conv_1(xs)]
        x = torch.stack([x.permute(0, 2, 3, 1).reshape(b, -1) for x in xs])
        return torch.relu(self.Dense_0(x))


class MultiModalRegressor(nn.Module):
    """Flagship multimodal model with selectable fusion ('multihead' |
    'gate' | 'crossmodal'), K = ``folds`` independent copies.

    ``image_size``: the side of the square images (128 in the repo's
    preprocessing); it fixes the width of ``cnn/Dense_0``, which flax infers
    at init. ``generator`` draws the initial parameters (flax's
    initializers; each fold its own draw), on ``device``."""

    def __init__(self, fp_dim: int = 167, n_layers: int = 6, fp_tokens: int = 1,
                 max_fp_width: int = 512, d_ff_mult: int = 4, emb_dim: int = 128,
                 fusion: str = "multihead", head_dims: Sequence[int] = (256, 128, 64),
                 dropout: float = 0.1, dtype: torch.dtype = torch.bfloat16,
                 image_size: int = 128, folds: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if fusion not in FUSIONS:
            raise ValueError(f"unknown fusion {fusion!r}")
        self.config = dict(fp_dim=fp_dim, n_layers=n_layers, fp_tokens=fp_tokens,
                           max_fp_width=max_fp_width, d_ff_mult=d_ff_mult,
                           emb_dim=emb_dim, fusion=fusion,
                           head_dims=tuple(head_dims), dropout=dropout,
                           dtype=dtype, image_size=image_size)
        self.folds, self.dtype, self.rate = folds, dtype, dropout
        self.fp_dim, self.fp_tokens, self.n_layers = fp_dim, fp_tokens, n_layers
        on = dict(device=device, generator=generator)
        if fp_tokens <= 1:
            d_model = fp_dim
            if d_model > max_fp_width:
                d_model = max_fp_width
                self.fp_in_proj = Dense(folds, fp_dim, d_model, dtype, **on)
            for i in range(n_layers):
                self.add_module(f"enc{i}", DegenerateEncoderLayer(
                    folds, d_model, d_ff_mult * d_model, dropout, dtype, **on))
        else:
            d_tok = -(-fp_dim // fp_tokens)
            d_model = max(64, d_tok)
            self.tok_proj = Dense(folds, d_tok, d_model, dtype, **on)
            self.pos_emb = nn.Parameter(nn.init.normal_(
                torch.empty(folds, 1, fp_tokens, d_model, device=device),
                0.0, 0.02, generator=generator))
            for i in range(n_layers):
                self.add_module(f"enc{i}", TokenEncoderLayer(
                    folds, d_model, max(1, d_model // 32), d_ff_mult * d_model,
                    dropout, dtype, **on))
        self.fp_fc = Dense(folds, d_model, emb_dim, dtype, **on)
        self.cnn = ImageCNN(folds, image_size, emb_dim, dtype, **on)
        if fusion == "multihead":
            self.MultiHeadAttentionFusion_0 = MultiHeadAttentionFusion(
                folds, 2 * emb_dim, out_dim=2 * emb_dim, dtype=dtype, **on)
            d = 2 * emb_dim
        elif fusion == "gate":
            self.AttentionFusion_0 = AttentionFusion(folds, 2 * emb_dim, dtype, **on)
            d = 2 * emb_dim
        else:
            self.MultiModalAttentionFusion_0 = MultiModalAttentionFusion(
                folds, emb_dim, dtype=dtype, **on)
            d = 2 * emb_dim + 128
        self.fusion_name = {"multihead": "MultiHeadAttentionFusion_0",
                            "gate": "AttentionFusion_0",
                            "crossmodal": "MultiModalAttentionFusion_0"}[fusion]
        dims = list(head_dims)
        for i, width in enumerate(dims):
            self.add_module(f"Dense_{i}", Dense(folds, d, width, dtype, **on))
            d = width
        self.add_module(f"Dense_{len(dims)}", Dense(folds, d, 1, torch.float32, **on))
        self.n_head = len(dims) + 1

    def forward(self, fp: torch.Tensor, img: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """fp [K, B, fp_dim] or [B, fp_dim]; img [K, B, H, W, 3] or
        [K, B, H·W·3] (without K where fp has none) → [K, B] (or [B] for one
        fold given inputs without a fold axis). ``generator`` draws the
        dropout masks when ``train``."""
        k = self.folds
        single = fp.dim() == 2
        if single:
            fp, img = fp.expand(k, *fp.shape), img.expand(k, *img.shape)
        x = fp.to(self.dtype)
        if self.fp_tokens <= 1:
            if hasattr(self, "fp_in_proj"):
                x = self.fp_in_proj(x)
            for i in range(self.n_layers):
                x = getattr(self, f"enc{i}")(x, train, generator)
        else:
            t = self.fp_tokens
            d_tok = -(-self.fp_dim // t)
            x = F.pad(x, (0, t * d_tok - self.fp_dim)).unflatten(-1, (t, d_tok))
            x = self.tok_proj(x) + self.pos_emb.to(self.dtype)
            for i in range(self.n_layers):
                x = getattr(self, f"enc{i}")(x, train, generator)
            x = x.mean(dim=2)
        fp_emb = torch.relu(self.fp_fc(x))
        if img.dim() == 3:                   # flat H·W·3, the reference's layout
            side = int(round((img.shape[-1] // 3) ** 0.5))
            img = img.reshape(*img.shape[:2], side, side, 3)
        h = getattr(self, self.fusion_name)(fp_emb, self.cnn(img))
        for i in range(self.n_head - 1):
            h = dropout(torch.relu(getattr(self, f"Dense_{i}")(h)), self.rate,
                        train, generator)
        out = getattr(self, f"Dense_{self.n_head - 1}")(h.float())[..., 0]
        return out[0] if single and k == 1 else out
