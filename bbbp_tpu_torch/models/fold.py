"""Layers whose parameters carry a leading fold axis, K copies of one layer.

``bbbp_tpu/train/loop.py`` trains K = folds × seeds models at once by
``jax.vmap`` over a leading axis of every parameter. The port writes that
axis out: a layer here holds its parameters as ``[K, ...]`` and maps
activations ``[K, B, ...]`` to ``[K, B, ...]``, fold k through copy k. A
dense layer is one batched matrix product (``torch.baddbmm``), a
convolution one cuDNN call a fold. A single model is the case K = 1.

Numerics follow flax as the JAX package's models call it:

- ``dtype`` is the compute type (flax's ``dtype=``): a dense layer or a
  convolution casts its input, kernel and bias to it and returns it;
  parameters stay f32. No autocast: its casts differ.
- LayerNorm reduces in f32 with epsilon 1e-6 (flax's default, torch's is
  1e-5) and returns ``dtype``.
- Dropout keeps an element where a uniform draw is below 1 − rate and
  scales it by 1 / (1 − rate), as ``flax.linen.Dropout``; the draws come
  from the ``torch.Generator`` the caller passes, so they are not
  ``jax.random``'s. A ``FoldBlock`` in its place draws for every fold of a
  run and keeps one block's (``train_cv`` over a mesh).
- Initializers are flax's: kernels lecun-normal (a normal of std
  sqrt(1/fan_in) / .8796 truncated at two std), biases 0, LayerNorm scale 1
  and bias 0.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
# std of a standard normal truncated to [-2, 2] (jax.nn.initializers'
# variance_scaling constant)
TRUNC_STD = .87962566103423978


def lecun_normal(shape: Sequence[int], fan_in: int, device=None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """f32 ``shape`` from flax's ``lecun_normal`` for a kernel of ``fan_in``
    inputs (every fold drawn independently)."""
    std = (1.0 / fan_in) ** 0.5 / TRUNC_STD
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` on the fold axis: x [K, ..., in],
    kernel [K, in, out], bias [K, out] → [K, ..., out] in ``dtype``."""
    k, d_in, d_out = kernel.shape
    y = torch.baddbmm(bias.to(dtype).unsqueeze(1),
                      x.to(dtype).reshape(k, -1, d_in), kernel.to(dtype))
    return y.reshape(*x.shape[:-1], d_out)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=dtype)`` over the last axis, per fold:
    statistics and affine in f32, the result cast to ``dtype``."""
    y = F.layer_norm(x.float(), x.shape[-1:], eps=LN_EPS)
    shape = (scale.shape[0],) + (1,) * (x.dim() - 2) + (scale.shape[-1],)
    return torch.addcmul(bias.view(shape), y, scale.view(shape)).to(dtype)


class FoldBlock:
    """Folds [start, stop) of a run of ``total``: the random draws of a
    layer are made for every fold from ``generator`` and the block's rows
    kept (``fold_rand``), so that a process training this block of folds
    draws what one process training all of them draws for these."""

    def __init__(self, generator: Optional[torch.Generator], total: int,
                 start: int, stop: int):
        self.generator, self.total, self.start, self.stop = generator, total, start, stop


def fold_rand(shape, device, generator) -> torch.Tensor:
    """Uniform [0, 1) draws of ``shape`` ([K, ...]) from ``generator``, a
    ``torch.Generator`` or a ``FoldBlock``."""
    if isinstance(generator, FoldBlock):
        full = torch.rand((generator.total, *shape[1:]), device=device,
                          generator=generator.generator)
        return full[generator.start:generator.stop]
    return torch.rand(shape, device=device, generator=generator)


def keep_fold_block(net: nn.Module, start: int, stop: int) -> None:
    """Keep folds [start, stop) of every parameter and buffer of ``net`` (a
    fold-axis model), and its modules' ``folds`` counts."""
    with torch.no_grad():
        for t in list(net.parameters()) + list(net.buffers()):
            t.data = t.data[start:stop].clone()
    for m in net.modules():
        if hasattr(m, "folds"):
            m.folds = stop - start


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout(rate)``: identity unless ``train``; each element
    (of every fold) kept with probability 1 − rate and divided by 1 − rate
    rounded to ``x``'s dtype, as flax divides by a weakly typed float (in
    bf16 by 0.8984375 at rate 0.1: a kept element grows by 1.1130, not
    1.1111)."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = fold_rand(x.shape, x.device, generator) < keep
    scaled = x / torch.tensor(keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, scaled, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))


class Dense(nn.Module):
    """flax ``nn.Dense`` on the fold axis: ``kernel`` [K, in, out] (flax's
    [in, out] a fold), ``bias`` [K, out]."""

    def __init__(self, folds: int, d_in: int, d_out: int, dtype: torch.dtype,
                 device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal((folds, d_in, d_out), d_in,
                                                device, generator))
        self.bias = nn.Parameter(torch.zeros(folds, d_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.kernel, self.bias, self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` on the fold axis: ``scale``, ``bias`` [K, d]."""

    def __init__(self, folds: int, d: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(folds, d, device=device))
        self.bias = nn.Parameter(torch.zeros(folds, d, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.dtype)


class Conv3x3(nn.Module):
    """flax ``nn.Conv(c_out, (3, 3), padding="SAME")`` on the fold axis:
    ``kernel`` [K, O, C, 3, 3] (torch's OIHW; flax keeps HWIO), ``bias``
    [K, O]. It maps K inputs [B, C, H, W] (in ``channels_last`` memory,
    i.e. flax's NHWC) to K outputs [B, O, H, W], one convolution a fold:
    cuDNN's grouped form (``groups=K`` over K·C channels) slices the
    channels apart in extra kernels and ran a training epoch 5% slower on
    an H100."""

    def __init__(self, folds: int, c_in: int, c_out: int, dtype: torch.dtype,
                 device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal((folds, c_out, c_in, 3, 3),
                                                9 * c_in, device, generator))
        self.bias = nn.Parameter(torch.zeros(folds, c_out, device=device))

    def forward(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        kernel, bias = self.kernel.to(self.dtype), self.bias.to(self.dtype)
        return [F.conv2d(x.to(self.dtype), kernel[f], bias[f], padding=1)
                for f, x in enumerate(xs)]


BN_MOMENTUM, BN_EPS = 0.99, 1e-5


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=not train, dtype=dtype)`` over
    the last axis, on the fold axis: ``scale``, ``bias`` [K, d] are
    parameters, the running statistics ``mean``, ``var`` [K, d] buffers
    (flax's ``batch_stats`` collection), so that no optimizer reaches them.

    With ``train`` each fold normalises over its own rows: the statistics
    in f32, the variance biased and computed as flax's fast variance,
    max(0, E[x²] − E[x]²); the running statistics then move by
    ``ra = 0.99 · ra + 0.01 · stat`` (torch's own update takes the unbiased
    variance). Without ``train`` the running statistics normalise.
    Epsilon 1e-5; the affine in f32, the result cast to ``dtype``."""

    def __init__(self, folds: int, d: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(folds, d, device=device))
        self.bias = nn.Parameter(torch.zeros(folds, d, device=device))
        self.register_buffer("mean", torch.zeros(folds, d, device=device))
        self.register_buffer("var", torch.ones(folds, d, device=device))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        """x [K, B, d] → [K, B, d] in ``dtype``."""
        xf = x.float()
        if train:
            mean = xf.mean(dim=1)
            var = torch.clamp((xf * xf).mean(dim=1) - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean
                                + (1.0 - BN_MOMENTUM) * mean.detach())
                self.var.copy_(BN_MOMENTUM * self.var
                               + (1.0 - BN_MOMENTUM) * var.detach())
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BN_EPS) * self.scale
        return ((xf - mean.unsqueeze(1)) * mul.unsqueeze(1)
                + self.bias.unsqueeze(1)).to(self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed(n, d, dtype=dtype)`` on the fold axis: ``embedding``
    [K, n, d] f32, initialised as flax's default (a normal of std
    sqrt(1/d)); ids [K, ...] look up fold k's table, cast to ``dtype``."""

    def __init__(self, folds: int, n: int, d: int, dtype: torch.dtype,
                 device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(nn.init.normal_(
            torch.empty(folds, n, d, device=device), 0.0, (1.0 / d) ** 0.5,
            generator=generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        k = self.embedding.shape[0]
        fold = torch.arange(k, device=ids.device).view(k, *([1] * (ids.dim() - 1)))
        return self.embedding[fold, ids.long()].to(self.dtype)
