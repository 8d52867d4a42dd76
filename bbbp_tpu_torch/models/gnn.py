"""Graph regressors over ``chem/graph_features.py``: the counterpart of
``bbbp_tpu/models/gnn.py`` on the fold axis (``models/fold.py``).

Beyond-parity model family: the reference's GPU featurizer (F3,
Descriptors/create_descriptors_gpu.py) produces DeepChem ConvMol atom features
but never trains a graph model on them; here a GCN consumes this framework's
equivalent featurization. Dense batched message passing over padded atoms
(static shapes), masked pooling, an MLP head.

K = ``folds`` independent models: ``forward`` takes inputs with a fold axis
([K, B, ...], fold k's rows through model k) or without one (the same rows
through every model) and returns [K, B] ([B] for one fold given inputs
without a fold axis). Parameters are f32 with a leading fold axis; compute
is ``dtype`` (bf16 by default), as flax's ``dtype=``. Submodules carry
flax's names, but for the MPNN's four bond-type message layers of a
message-passing layer, which are one kernel and one bias here
(``messages_{i}_kernel`` [K, H, 4H], ``messages_{i}_bias`` [K, 4H], the four
side by side): ``models/convert.py`` concatenates flax's ``Dense`` leaves
into them.

Numerics follow the flax modules as ``train_cv`` feeds them (atom features
and adjacencies in bf16, the mask in f32):

- the degree and its reciprocal are computed in the adjacency's dtype;
- an MPNN layer's messages are one product of the row-normalised
  adjacencies laid side by side, [A, 4A], with the four bond types'
  transforms stacked, [4A, H]: f32 accumulation over all four, one
  rounding, where flax rounds each type's product and their sum;
- padded atoms are masked out of the max pool by (1 − m)·(−1e4) in
  ``dtype`` (−9984 in bf16); the mean pool is a sum in ``dtype`` over the
  atoms;
- LayerNorm reduces in f32 with epsilon 1e-6 (``fold.layer_norm``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from bbbp_tpu_torch.models.fold import Dense, LayerNorm, dense, dropout, lecun_normal

N_BOND_TYPES = 4          # chem.graph_features: single, double, triple, aromatic


def _with_folds(k: int, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    return tuple(x.expand(k, *x.shape) for x in xs)


def _head(model: nn.Module, x: torch.Tensor, first: int, train: bool,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    """The MLP head: ``Dense_{first}`` ... relu, dropout, then the last
    dense layer in f32."""
    n = len(model.head_dims)
    for i in range(n):
        x = torch.relu(getattr(model, f"Dense_{first + i}")(x))
        x = dropout(x, model.rate, train, generator)
    return getattr(model, f"Dense_{first + n}")(x.float())


def _out(model: nn.Module, out: torch.Tensor, single: bool) -> torch.Tensor:
    out = out[..., 0] if model.n_out == 1 else out
    return out[0] if single and model.folds == 1 else out


class MPNNRegressor(nn.Module):
    """Edge-conditioned message passing: per-bond-type dense transforms
    (messages for single/double/triple/aromatic bonds use separate weights),
    residual + LayerNorm updates, masked mean+max readout. The stronger
    graph leg for the regression stack (GCNRegressor remains the plain-GCN
    variant).

    ``atom_features`` is the width of the atom features (flax infers it at
    init; ``chem/graph_features.py`` gives ``N_ATOM_FEATURES``)."""

    def __init__(self, atom_features: int, hidden: int = 128, n_layers: int = 4,
                 head: Sequence[int] = (128, 64), n_out: int = 1,
                 dropout: float = 0.1, dtype: torch.dtype = torch.bfloat16,
                 n_types: int = N_BOND_TYPES, folds: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = dict(atom_features=atom_features, hidden=hidden,
                           n_layers=n_layers, head=tuple(head), n_out=n_out,
                           dropout=dropout, dtype=dtype, n_types=n_types)
        self.folds, self.dtype, self.rate = folds, dtype, dropout
        self.hidden, self.n_layers, self.n_types = hidden, n_layers, n_types
        self.head_dims, self.n_out = tuple(head), n_out
        on = dict(device=device, generator=generator)
        self.Dense_0 = Dense(folds, atom_features, hidden, dtype, **on)
        for i in range(n_layers):
            # flax's Dense_{1 + i(T+1) + t}, t < T, side by side
            self.register_parameter(f"messages_{i}_kernel", nn.Parameter(
                lecun_normal((folds, hidden, n_types * hidden), hidden, device,
                             generator)))
            self.register_parameter(f"messages_{i}_bias", nn.Parameter(
                torch.zeros(folds, n_types * hidden, device=device)))
            self.add_module(self._self_name(i),
                            Dense(folds, hidden, hidden, dtype, **on))
            self.add_module(f"LayerNorm_{i}", LayerNorm(folds, hidden, dtype, device))
        d, first = 2 * hidden, self._head_first()
        for j, width in enumerate(self.head_dims):
            self.add_module(f"Dense_{first + j}", Dense(folds, d, width, dtype, **on))
            d = width
        self.add_module(f"Dense_{first + len(self.head_dims)}",
                        Dense(folds, d, n_out, torch.float32, **on))

    def message_dense(self, i: int) -> int:
        """The flax index of layer ``i``'s first bond-type ``Dense``."""
        return 1 + i * (self.n_types + 1)

    def _self_name(self, i: int) -> str:
        return f"Dense_{self.message_dense(i) + self.n_types}"

    def _head_first(self) -> int:
        return self.message_dense(self.n_layers)

    def forward(self, feats: torch.Tensor, adj_t: torch.Tensor, mask: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """feats [K, B, A, F], adj_t [K, B, T, A, A] (bond-type adjacencies,
        no self loops), mask [K, B, A], or all three without K → [K, B]."""
        k, dt = self.folds, self.dtype
        single = feats.dim() == 3
        if single:
            feats, adj_t, mask = _with_folds(k, feats, adj_t, mask)
        b, a, t = feats.shape[1], adj_t.shape[-1], self.n_types
        m3 = mask.unsqueeze(-1).to(dt)
        deg = torch.clamp(adj_t.sum((2, 4)), min=1.0)               # [K, B, A]
        dinv = (1.0 / deg).to(dt)
        # row-normalised, made once: adj_n[k·b, i, j·T + t] = adj_t[k, b, t,
        # i, j] / deg[k, b, i], so that the four types' transforms, [K, B,
        # A, T·H] as one product gives them, are its [j·T + t, H] operand
        adj_n = torch.empty((k, b, a, a, t), dtype=dt, device=adj_t.device)
        torch.mul(adj_t.to(dt).permute(0, 1, 3, 4, 2), dinv[..., None, None],
                  out=adj_n)
        adj_n = adj_n.view(k * b, a, a * t)
        h = self.Dense_0(feats.to(dt)) * m3
        for i in range(self.n_layers):
            ht = dense(h, getattr(self, f"messages_{i}_kernel"),
                       getattr(self, f"messages_{i}_bias"), dt)
            msgs = torch.bmm(adj_n, ht.reshape(k * b, a * t, self.hidden)
                             ).view(h.shape)
            upd = torch.relu(getattr(self, self._self_name(i))(h) + msgs)
            upd = dropout(upd, self.rate, train, generator)
            h = getattr(self, f"LayerNorm_{i}")(h + upd) * m3
        denom = torch.clamp(mask.sum(2, keepdim=True), min=1.0).to(dt)
        mean_pool = h.sum(2) / denom
        neg = (1.0 - m3) * torch.tensor(-1e4, dtype=dt)
        max_pool = (h + neg).amax(2)
        x = torch.cat([mean_pool, max_pool], dim=-1)
        return _out(self, _head(self, x, self._head_first(), train, generator),
                    single)


class GCNLayer(nn.Module):
    """flax ``GCNLayer``: Â H, then ``Dense_0``, then ReLU."""

    def __init__(self, folds: int, d_in: int, dim: int, dtype: torch.dtype,
                 device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = Dense(folds, d_in, dim, dtype, device, generator)

    def forward(self, h: torch.Tensor, adj_norm: torch.Tensor) -> torch.Tensor:
        # h: [K, B, A, F]; adj_norm: [K, B, A, A] (D^-1/2 (A+I) D^-1/2)
        m = torch.matmul(adj_norm.to(self.dtype), h.to(self.dtype))
        return torch.relu(self.Dense_0(m))


class GCNRegressor(nn.Module):
    """Symmetric-normalised graph convolutions (the adjacency carries self
    loops), masked mean pool, MLP head."""

    def __init__(self, atom_features: int, hidden: Sequence[int] = (128, 128, 128),
                 head: Sequence[int] = (128, 64), n_out: int = 1,
                 dropout: float = 0.1, dtype: torch.dtype = torch.bfloat16,
                 folds: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = dict(atom_features=atom_features, hidden=tuple(hidden),
                           head=tuple(head), n_out=n_out, dropout=dropout,
                           dtype=dtype)
        self.folds, self.dtype, self.rate = folds, dtype, dropout
        self.head_dims, self.n_out, self.n_gcn = tuple(head), n_out, len(hidden)
        on = dict(device=device, generator=generator)
        d = atom_features
        for i, width in enumerate(hidden):
            self.add_module(f"GCNLayer_{i}", GCNLayer(folds, d, width, dtype, **on))
            d = width
        for j, width in enumerate(self.head_dims):
            self.add_module(f"Dense_{j}", Dense(folds, d, width, dtype, **on))
            d = width
        self.add_module(f"Dense_{len(self.head_dims)}",
                        Dense(folds, d, n_out, torch.float32, **on))

    def forward(self, feats: torch.Tensor, adj: torch.Tensor, mask: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """feats [K, B, A, F], adj [K, B, A, A] (with self loops), mask
        [K, B, A], or all three without K → [K, B]."""
        single = feats.dim() == 3
        if single:
            feats, adj, mask = _with_folds(self.folds, feats, adj, mask)
        deg = torch.clamp(adj.sum(-1), min=1e-6)
        dinv = torch.rsqrt(deg)
        adj_norm = adj * dinv[..., :, None] * dinv[..., None, :]
        m3 = mask.unsqueeze(-1).to(self.dtype)
        h = feats
        for i in range(self.n_gcn):
            h = getattr(self, f"GCNLayer_{i}")(h, adj_norm) * m3
        pooled = h.sum(2) / torch.clamp(mask.sum(2, keepdim=True), min=1.0
                                        ).to(self.dtype)
        return _out(self, _head(self, pooled, 0, train, generator), single)
