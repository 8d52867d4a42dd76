"""Forest training on the device: level-wise histogram split search.

Counterpart of the trainer in ``bbbp_tpu/ops/forest_tpu.py``
(``_fit_forest_device``, ``fit_forest_launched`` and the ``TPU*`` estimator
classes) and of ``BinMapper`` in ``bbbp_tpu/ops/forest.py``. The estimators
here are the JAX package's ``TPUGBDTRegressor``, ``TPUGBDTClassifier``,
``TPURandomForestRegressor`` and ``TPURandomForestClassifier`` without the
prefix, with the same defaults; they add a ``device`` (``cuda`` unless the
caller asks for ``cpu``).

Features are quantile-binned once on the host (uint8, at most 64 bins).
Each tree grows level by level over the implicit full-binary layout. Three
kernels carry a tree, each a CUDA C++ kernel (``csrc/forest_train.cu``) on a
CUDA tensor and its plain PyTorch version on a CPU tensor:

- ``level_histogram`` (K3): the (g, h) histogram of one level over
  (node, feature, bin);
- ``best_splits`` (K4): cumulative sums over the bins, the XGBoost gain with
  the ``min_child`` and column masks, oblivious mode, and the first-index
  argmax per node;
- ``leaf_values`` (K5): the leaf sums, ``leaf = -G / (H + lambda)`` and
  ``preds += scale * leaf[pos]``.

Routing, gradients and the random draws stay torch ops on the fit's device,
and nothing is copied to the host inside the tree loop. The random streams
come from a ``torch.Generator`` seeded from ``seed``; they differ from
``jax.random``, so subsampled and random-forest fits match the JAX package
only statistically, while ``subsample=1, colsample=1`` boosting grows the
same trees. Not carried over, because they exist only for the TPU: the
feature chunking (``F_CHUNK``), the launch splitting
(``SCATTER_SEGMENT_BUDGET``) and ``ROW_BUCKETING``. The matmul histogram
engine computes the same function as the scatter engine; the one kernel K3
serves both.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from bbbp_tpu_torch._build import LaunchCounter, check_launch, kernels_lib
from bbbp_tpu_torch.ops.forest import MAX_DEPTH, DenseTreeEnsemble, raw_predict

MAX_BINS = 64
CUMSUM_CHUNK = 16       # the bin-sum order of the reference, see _cumsum_bins


# ---------------------------------------------------------------------------
# Binning (host, numpy): a copy of bbbp_tpu/ops/forest.py::BinMapper
# ---------------------------------------------------------------------------

class BinMapper:
    """Quantile binning to uint8 codes; thresholds are bin edges."""

    def __init__(self, n_bins: int = MAX_BINS):
        self.n_bins = n_bins
        self.edges_: List[np.ndarray] = []

    def fit(self, x: np.ndarray) -> "BinMapper":
        x = np.asarray(x, dtype=np.float32)
        self.edges_ = []
        qs = np.linspace(0, 1, self.n_bins + 1)[1:-1]
        for f in range(x.shape[1]):
            e = np.unique(np.quantile(x[:, f], qs))
            self.edges_.append(e.astype(np.float32))
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32)
        out = np.empty(x.shape, dtype=np.uint8)
        for f, e in enumerate(self.edges_):
            # side='left': bin(x) = #{edges < x}, so "bin <= b" ⟺ "x <= e[b]"
            out[:, f] = np.searchsorted(e, x[:, f], side="left")
        return out

    def edge_values(self) -> np.ndarray:
        """[F, MAX_BINS] f32: edge b of feature f, +inf past the last edge,
        so the threshold of a dead node (bin MAX_BINS − 1) is +inf."""
        out = np.full((len(self.edges_), MAX_BINS), np.inf, dtype=np.float32)
        for f, e in enumerate(self.edges_):
            out[f, :len(e)] = e
        return out


# ---------------------------------------------------------------------------
# Plain versions of the three kernels
# ---------------------------------------------------------------------------

def level_histogram_reference(xb: torch.Tensor, pos: torch.Tensor,
                              g: torch.Tensor, h: torch.Tensor,
                              n_nodes: int) -> torch.Tensor:
    """hist[node, f, b, {g, h}] = Σ_rows [pos = node ∧ xb[:, f] = b]·(g, h),
    summed in row order by ``index_add_`` (on the CPU the same order and
    result as the reference's ``jax.ops.segment_sum``)."""
    n, n_feat = xb.shape
    dev = xb.device
    keys = (pos.long()[:, None] * (n_feat * MAX_BINS)
            + torch.arange(n_feat, device=dev)[None, :] * MAX_BINS + xb.long())
    vals = torch.stack([g, h], dim=1)[:, None, :].expand(n, n_feat, 2)
    out = torch.zeros((n_nodes * n_feat * MAX_BINS, 2), dtype=g.dtype, device=dev)
    out.index_add_(0, keys.reshape(-1), vals.reshape(-1, 2))
    return out.view(n_nodes, n_feat, MAX_BINS, 2)


def _cumsum_bins(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis (the 64 bins) in the order the
    reference's ``jnp.cumsum`` takes on the CPU: sequential inside each
    16-bin chunk, then each chunk offset by the running total of the chunks
    before it (added last). The kernel sums in the same order."""
    chunks = x.unflatten(-1, (-1, CUMSUM_CHUNK))
    inner = torch.empty_like(chunks)
    acc = chunks[..., 0]
    inner[..., 0] = acc
    for i in range(1, CUMSUM_CHUNK):
        acc = acc + chunks[..., i]
        inner[..., i] = acc
    offset = torch.zeros_like(inner[..., 0, 0])
    out = torch.empty_like(inner)
    for k in range(chunks.shape[-2]):
        out[..., k, :] = inner[..., k, :] + offset[..., None]
        offset = offset + inner[..., k, -1]
    return out.flatten(-2)


def split_gains(hist: torch.Tensor, col_mask: torch.Tensor, lam: float,
                min_child: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gain, valid), each [nodes, F, 64], of splitting after bin b
    (``forest_tpu.py::_chunk_gains``): each feature's own total is its
    last cumulative sum."""
    gl = _cumsum_bins(hist[..., 0])
    hl = _cumsum_bins(hist[..., 1])
    tg, th = gl[..., -1:], hl[..., -1:]
    gr, hr = tg - gl, th - hl
    gain = gl * gl / (hl + lam) + gr * gr / (hr + lam) - tg * tg / (th + lam)
    valid = (hl >= min_child) & (hr >= min_child) & col_mask[None, :, None]
    return gain, valid


def best_splits_reference(hist: torch.Tensor, col_mask: torch.Tensor,
                          lam: float, min_child: float, oblivious: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(feat int32, bin int32, has_split bool), each [nodes]: the first
    index of the largest valid gain over the flat f·64 + b per node, or, in
    oblivious mode, over the gains summed across the level's nodes (invalid
    or non-positive entries count 0; a feature valid for no node stays
    −inf). A node without a positive finite gain gets (0, 63), which sends
    every row left."""
    nodes, n_feat = hist.shape[:2]
    gain, valid = split_gains(hist, col_mask, lam, min_child)
    neg_inf = gain.new_full((), -torch.inf)
    if oblivious:
        node_gain = torch.where(valid & (gain > 0), gain, torch.zeros_like(gain))
        total = torch.zeros_like(node_gain[0])
        for node in range(nodes):               # a fixed order, as the kernel
            total = total + node_gain[node]
        total = torch.where(valid.any(dim=0), total, neg_inf).reshape(-1)
        best = total.argmax().expand(nodes)
        best_gain = total[best]
    else:
        flat = torch.where(valid, gain, neg_inf).reshape(nodes, -1)
        best = flat.argmax(dim=1)
        best_gain = flat.gather(1, best[:, None])[:, 0]
    has_split = torch.isfinite(best_gain) & (best_gain > 0)
    feat = torch.where(has_split, best // MAX_BINS, 0).to(torch.int32)
    b = torch.where(has_split, best % MAX_BINS, MAX_BINS - 1).to(torch.int32)
    return feat, b, has_split


def leaf_values_reference(pos: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                          n_leaves: int, lam: float, scale: float,
                          preds: torch.Tensor) -> torch.Tensor:
    """Leaf sums in row order, ``leaf = -G / (H + lam)``, and
    ``preds = fma(scale, leaf[pos], preds)`` in place. Returns ``leaf``
    [n_leaves].

    The update is one fused multiply-add, as the reference's compiled tree
    step rounds it (XLA contracts ``preds + lr * leaf[pos]``); it is taken
    in float64, where the f32 product is exact, and rounded once more to
    f32, which equals the fused result except when the float64 sum lands
    exactly halfway between two f32 values."""
    idx = pos.long()
    gs = torch.zeros(n_leaves, dtype=g.dtype, device=g.device).index_add_(0, idx, g)
    hs = torch.zeros(n_leaves, dtype=h.dtype, device=h.device).index_add_(0, idx, h)
    leaf = -gs / (hs + lam)
    scale32 = float(np.float32(scale))
    preds.copy_(preds.double().add_(leaf[idx].double(), alpha=scale32))
    return leaf


# ---------------------------------------------------------------------------
# Kernel wrappers: the kernel on a CUDA tensor, the plain version on the CPU
# ---------------------------------------------------------------------------

def _check_rows(name: str, t: torch.Tensor, dtype: torch.dtype, n: int,
                device: torch.device) -> None:
    if t.dtype != dtype or t.shape != (n,):
        raise TypeError(f"{name} must be {dtype} [{n}], got {t.dtype} "
                        f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def gradient_bounds(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """f32 [2] (max |g|, max |h|) on the device of ``g``: the range K3 and
    K5 quantise the rows into. g and h do not change within a tree, so a
    fit takes it once a tree and passes it to every K3 and K5 call."""
    if g.numel() == 0:
        return torch.zeros(2, dtype=torch.float32, device=g.device)
    return torch.stack((g.abs().amax(), h.abs().amax()))


def _check_bounds(bounds: Optional[torch.Tensor], g: torch.Tensor,
                  h: torch.Tensor) -> torch.Tensor:
    if bounds is None:
        return gradient_bounds(g, h)
    _check_rows("bounds", bounds, torch.float32, 2, g.device)
    return bounds


def _kernel_device(t: torch.Tensor, kernel: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for {t.device}")
    return True


def level_histogram(xb: torch.Tensor, pos: torch.Tensor, g: torch.Tensor,
                    h: torch.Tensor, n_nodes: int,
                    bounds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3. xb uint8 [n, F] (bins < 64), pos int32 [n] in [0, n_nodes),
    g, h f32 [n] → hist f32 [n_nodes, F, 64, 2].

    On a CUDA tensor the kernel sums in 64-bit fixed point, so the result
    is the same from run to run whatever order the rows arrive in;
    ``bounds`` is ``gradient_bounds(g, h)``, taken here when not given. On a
    CPU tensor ``level_histogram_reference`` runs."""
    if xb.dtype != torch.uint8 or xb.dim() != 2:
        raise TypeError(f"xb must be a 2-D uint8 tensor, got {xb.dtype} "
                        f"{tuple(xb.shape)}")
    if not xb.is_contiguous():
        raise ValueError("xb must be contiguous")
    n, n_feat = xb.shape
    _check_rows("pos", pos, torch.int32, n, xb.device)
    _check_rows("g", g, torch.float32, n, xb.device)
    _check_rows("h", h, torch.float32, n, xb.device)
    if n_nodes < 1:
        raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
    if not _kernel_device(xb, "forest_level_histogram"):
        return level_histogram_reference(xb, pos, g, h, n_nodes)
    out = torch.empty((n_nodes, n_feat, MAX_BINS, 2), dtype=torch.float32,
                      device=xb.device)
    if out.numel() == 0:
        return out
    bounds = _check_bounds(bounds, g, h)
    acc = torch.empty(out.numel(), dtype=torch.int64, device=xb.device)
    with torch.cuda.device(xb.device):
        rc = kernels_lib().bbbp_forest_level_histogram(
            xb.data_ptr(), n, n_feat, pos.data_ptr(), g.data_ptr(),
            h.data_ptr(), n_nodes, bounds.data_ptr(), acc.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "forest_level_histogram")
    level_histogram.launches.add()
    return out


def best_splits(hist: torch.Tensor, col_mask: torch.Tensor, lam: float,
                min_child: float, oblivious: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4. hist f32 [nodes, F, 64, 2], col_mask bool [F] → (feat int32,
    bin int32, has_split bool), each [nodes]; see ``best_splits_reference``.
    The kernel computes the gains in the plain version's order with the
    same roundings, so both give the same splits on the same histogram."""
    if hist.dtype != torch.float32 or hist.dim() != 4 or \
            hist.shape[2:] != (MAX_BINS, 2):
        raise TypeError(f"hist must be float32 [nodes, F, {MAX_BINS}, 2], "
                        f"got {hist.dtype} {tuple(hist.shape)}")
    nodes, n_feat = hist.shape[:2]
    if col_mask.dtype != torch.bool or col_mask.shape != (n_feat,):
        raise TypeError(f"col_mask must be bool [{n_feat}], got "
                        f"{col_mask.dtype} {tuple(col_mask.shape)}")
    if col_mask.device != hist.device:
        raise ValueError(f"col_mask is on {col_mask.device}, hist on {hist.device}")
    if not (hist.is_contiguous() and col_mask.is_contiguous()):
        raise ValueError("hist and col_mask must be contiguous")
    if nodes < 1 or n_feat < 1:
        raise ValueError(f"hist needs a node and a feature, got {tuple(hist.shape)}")
    if not _kernel_device(hist, "forest_best_splits"):
        return best_splits_reference(hist, col_mask, lam, min_child, oblivious)
    feat = torch.empty(nodes, dtype=torch.int32, device=hist.device)
    b = torch.empty(nodes, dtype=torch.int32, device=hist.device)
    has_split = torch.empty(nodes, dtype=torch.bool, device=hist.device)
    with torch.cuda.device(hist.device):
        rc = kernels_lib().bbbp_forest_best_splits(
            hist.data_ptr(), nodes, n_feat, col_mask.data_ptr(), float(lam),
            float(min_child), int(bool(oblivious)), feat.data_ptr(),
            b.data_ptr(), has_split.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "forest_best_splits")
    best_splits.launches.add()
    return feat, b, has_split


def leaf_values(pos: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                n_leaves: int, lam: float, scale: float, preds: torch.Tensor,
                bounds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5. pos int32 [n] in [0, n_leaves), g, h f32 [n], preds f32 [n]
    (updated in place, as the reference's scan carry is replaced) →
    leaf f32 [n_leaves]. The kernel sums in 64-bit fixed point, as K3, with
    the same ``bounds``."""
    if pos.dim() != 1:
        raise TypeError(f"pos must be 1-D, got {tuple(pos.shape)}")
    n = pos.shape[0]
    for name, t, dtype in (("pos", pos, torch.int32), ("g", g, torch.float32),
                           ("h", h, torch.float32),
                           ("preds", preds, torch.float32)):
        _check_rows(name, t, dtype, n, pos.device)
    if not 1 <= n_leaves <= 1 << MAX_DEPTH:
        raise ValueError(f"n_leaves must be in [1, {1 << MAX_DEPTH}], got {n_leaves}")
    if not _kernel_device(pos, "forest_leaf_values"):
        return leaf_values_reference(pos, g, h, n_leaves, lam, scale, preds)
    bounds = _check_bounds(bounds, g, h)
    leaf = torch.empty(n_leaves, dtype=torch.float32, device=pos.device)
    acc = torch.empty(2 * n_leaves, dtype=torch.int64, device=pos.device)
    with torch.cuda.device(pos.device):
        rc = kernels_lib().bbbp_forest_leaf_values(
            pos.data_ptr(), n, g.data_ptr(), h.data_ptr(), n_leaves,
            float(lam), float(scale), bounds.data_ptr(), acc.data_ptr(),
            leaf.data_ptr(), preds.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "forest_leaf_values")
    leaf_values.launches.add()
    return leaf


level_histogram.launches = LaunchCounter()
best_splits.launches = LaunchCounter()
leaf_values.launches = LaunchCounter()


# ---------------------------------------------------------------------------
# The fit
# ---------------------------------------------------------------------------

def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``cpu`` or ``cuda``; ``cuda`` without a card raises. No fallback."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"training runs on cpu or cuda, not {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training on cuda needs a CUDA device, and torch "
                           "sees none")
    return device


def fit_forest(xb: torch.Tensor, edge_vals: torch.Tensor, y: torch.Tensor, *,
               lr: float, lam: float, min_child: float, subsample: float,
               colsample: float, base_score: float, seed: int, task: str,
               n_trees: int, depth: int, oblivious: bool, rf: bool,
               row_w: Optional[torch.Tensor] = None,
               preds0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Boosting (``task`` ``reg`` or ``cls``) or bagging (``rf``) on the
    device of ``xb`` [n, F] uint8, the counterpart of ``_fit_forest_device``
    and ``fit_forest_launched``. ``edge_vals`` [F, 64] f32, ``y`` [n] f32,
    ``row_w`` an optional [n] weight (rows of weight 0 contribute nothing),
    ``preds0`` an optional starting margin. Returns (preds [n],
    feats [T, 2^D − 1] int32, thrs [T, 2^D − 1] f32, leaves [T, 2^D] f32),
    all on the device; random forests accumulate unscaled leaves in preds."""
    if task not in ("reg", "cls"):
        raise ValueError(f"task must be 'reg' or 'cls', got {task!r}")
    if not 0 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth must be in [0, {MAX_DEPTH}], got {depth}")
    dev = xb.device
    n, n_feat = xb.shape
    n_internal, n_leaves = (1 << depth) - 1, 1 << depth
    y = y.to(dev, torch.float32)
    w_rows = (torch.ones(n, device=dev) if row_w is None
              else row_w.to(dev, torch.float32))
    preds = (torch.full((n,), float(base_score), dtype=torch.float32, device=dev)
             if preds0 is None else preds0.to(dev, torch.float32).clone())
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    feats = torch.zeros((n_trees, n_internal), dtype=torch.int32, device=dev)
    bins = torch.zeros((n_trees, n_internal), dtype=torch.int64, device=dev)
    leaves = torch.empty((n_trees, n_leaves), dtype=torch.float32, device=dev)
    feat_ids = torch.arange(n_feat, device=dev)
    scale = 1.0 if rf else float(lr)

    for t in range(n_trees):
        if rf:
            w = torch.poisson(torch.ones(n, device=dev), generator=gen) * w_rows
            g, h = -y * w, w
        else:
            if task == "reg":
                g, h = preds - y, torch.ones_like(y)
            else:
                p = torch.sigmoid(preds)
                g, h = p - y, torch.clamp(p * (1 - p), min=1e-6)
            m = (torch.rand(n, generator=gen, device=dev) < subsample).float()
            g, h = g * m * w_rows, h * m * w_rows
        col_mask = torch.rand(n_feat, generator=gen, device=dev) < colsample
        # at least one feature: the first drawn, else feature 0
        col_mask = col_mask | (feat_ids == col_mask.to(torch.uint8).argmax())
        bounds = gradient_bounds(g, h) if dev.type == "cuda" else None

        pos = torch.zeros(n, dtype=torch.int32, device=dev)
        for level in range(depth):
            nodes, off = 1 << level, (1 << level) - 1
            hist = level_histogram(xb, pos, g, h, nodes, bounds)
            f_l, b_l, _ = best_splits(hist, col_mask, lam, min_child, oblivious)
            feats[t, off:off + nodes] = f_l
            bins[t, off:off + nodes] = b_l
            row_f = f_l[pos].long()
            xf = xb.gather(1, row_f[:, None])[:, 0]
            pos = 2 * pos + (xf.int() > b_l[pos]).int()
        leaves[t] = leaf_values(pos, g, h, n_leaves, lam, scale, preds, bounds)

    thrs = edge_vals[feats.long(), bins]
    return preds, feats, thrs, leaves


# ---------------------------------------------------------------------------
# Estimators (the JAX package's TPU* classes, same defaults)
# ---------------------------------------------------------------------------

def _wmean(y, w) -> float:
    y = np.asarray(y, np.float64)
    if w is None:
        return float(y.mean())
    w = np.asarray(w, np.float64)
    return float((y * w).sum() / max(w.sum(), 1e-12))


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


class _ForestBase:
    def __init__(self, n_estimators=300, max_depth=6, learning_rate=0.1,
                 reg_lambda=1.0, min_child_weight=1.0, subsample=1.0,
                 colsample=1.0, oblivious=False, seed=0, device="cuda"):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.reg_lambda = reg_lambda
        self.min_child_weight = min_child_weight
        self.subsample = subsample
        self.colsample = colsample
        self.oblivious = oblivious
        self.seed = seed
        self.device = device
        self.ensemble_: Optional[DenseTreeEnsemble] = None

    def _prepare(self, x: np.ndarray, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Bin on the host; (xb uint8 [n, F], edge_vals f32 [F, 64]) on
        ``device``."""
        self.mapper_ = BinMapper().fit(x)
        xb = torch.from_numpy(self.mapper_.transform(x)).to(device)
        return xb, torch.from_numpy(self.mapper_.edge_values()).to(device)

    def _fit(self, x, y, task: str, rf: bool, base_score: float,
             sample_weight=None):
        device = resolve_device(self.device)
        xb, edge_vals = self._prepare(_host(x), device)
        row_w = (None if sample_weight is None else
                 torch.as_tensor(np.asarray(sample_weight, np.float32), device=device))
        _, feats, thrs, leaves = fit_forest(
            xb, edge_vals, torch.as_tensor(np.asarray(y, np.float32)),
            lr=self.learning_rate, lam=self.reg_lambda,
            min_child=self.min_child_weight, subsample=self.subsample,
            colsample=self.colsample, base_score=base_score, seed=self.seed,
            task=task, n_trees=self.n_estimators, depth=self.max_depth,
            oblivious=self.oblivious, rf=rf, row_w=row_w)
        scale = (1.0 / self.n_estimators) if rf else self.learning_rate
        self.ensemble_ = DenseTreeEnsemble(feats, thrs, leaves, self.max_depth,
                                           base_score, scale)
        return self

    def _margin(self, x) -> np.ndarray:
        z = torch.as_tensor(_host(x), device=self.ensemble_.device)
        return raw_predict(self.ensemble_, z.contiguous()).cpu().numpy()

    def get_params(self, deep=True):
        return {k: getattr(self, k) for k in
                ("n_estimators", "max_depth", "learning_rate", "reg_lambda",
                 "min_child_weight", "subsample", "colsample", "oblivious",
                 "seed", "device")}

    def set_params(self, **p):
        for k, v in p.items():
            setattr(self, k, v)
        return self


class GBDTRegressor(_ForestBase):
    def fit(self, x, y, sample_weight=None):
        return self._fit(x, y, "reg", rf=False,
                         base_score=_wmean(y, sample_weight),
                         sample_weight=sample_weight)

    def predict(self, x) -> np.ndarray:
        return self._margin(x)


class GBDTClassifier(_ForestBase):
    def fit(self, x, y, sample_weight=None):
        p0 = float(np.clip(_wmean(y, sample_weight), 1e-6, 1 - 1e-6))
        return self._fit(x, y, "cls", rf=False,
                         base_score=float(np.log(p0 / (1 - p0))),
                         sample_weight=sample_weight)

    def decision_function(self, x) -> np.ndarray:
        return self._margin(x)

    def predict_proba(self, x) -> np.ndarray:
        p = 1.0 / (1.0 + np.exp(-self.decision_function(x)))
        return np.stack([1 - p, p], axis=1)

    def predict(self, x) -> np.ndarray:
        return (self.decision_function(x) > 0).astype(np.int32)


class RandomForestRegressor(_ForestBase):
    def __init__(self, n_estimators=300, max_depth=10, colsample=1.0,
                 min_child_weight=1.0, **kw):
        kw.setdefault("reg_lambda", 1e-6)
        super().__init__(n_estimators=n_estimators, max_depth=max_depth,
                         colsample=colsample,
                         min_child_weight=min_child_weight, **kw)

    def fit(self, x, y, sample_weight=None):
        return self._fit(x, y, "reg", rf=True, base_score=0.0,
                         sample_weight=sample_weight)

    def predict(self, x) -> np.ndarray:
        return self._margin(x)


class RandomForestClassifier(RandomForestRegressor):
    def __init__(self, n_estimators=300, max_depth=10, colsample=0.5, **kw):
        super().__init__(n_estimators=n_estimators, max_depth=max_depth,
                         colsample=colsample, **kw)

    def predict_proba(self, x) -> np.ndarray:
        p = np.clip(self._margin(x), 0.0, 1.0)
        return np.stack([1 - p, p], axis=1)

    def predict(self, x) -> np.ndarray:
        return (np.clip(self._margin(x), 0, 1) > 0.5).astype(np.int32)
