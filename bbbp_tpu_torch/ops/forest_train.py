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
  ``preds += scale * leaf[pos]``; in boosting, the next tree's gradients
  and their bounds from the updated margins, in the same launch.

Routing, the first tree's gradients, the random forest's weights and the
random draws stay torch ops on the fit's device, and nothing is copied to
the host inside the tree loop. The random streams
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

import functools
from typing import List, NamedTuple, Optional, Tuple, Union

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

    def bin_counts(self) -> np.ndarray:
        """[F] uint8: the bins ``transform`` can give a feature, its edges
        + 1 (2 for a constant feature, 3 for a 0/1 feature, whose rows
        fill two of them)."""
        return np.array([len(e) + 1 for e in self.edges_], dtype=np.uint8)


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


def fixed_point_scales(bounds: torch.Tensor, n: int) -> torch.Tensor:
    """f64 [2]: the power of two 2^e with n · bound · 2^e < 2^62 that K3 and
    K5 quantise g and h by (``fixed_scale`` in ``csrc/forest_train.cu``);
    1 for a bound that is 0 or not finite."""
    limit = bounds.double() * n
    _, exponent = torch.frexp(limit)            # limit < 2^exponent
    scale = torch.ldexp(torch.ones_like(limit), 62 - exponent)
    return torch.where((bounds > 0) & torch.isfinite(bounds), scale,
                       torch.ones_like(scale))


def level_histogram_fixed_reference(xb: torch.Tensor, pos: torch.Tensor,
                                    g: torch.Tensor, h: torch.Tensor,
                                    n_nodes: int, bounds: torch.Tensor
                                    ) -> torch.Tensor:
    """K3's arithmetic in torch, on the CPU or the card, for tests: every
    g and h is quantised to a 64-bit integer at ``fixed_point_scales``
    (round half to even), the integers are summed by ``index_add_`` (exact
    in any order), and each sum is divided by the scale in float64 and
    rounded once to f32. ``bounds`` is ``gradient_bounds(g, h)``. The kernel
    returns these bits."""
    n, n_feat = xb.shape
    dev = xb.device
    scales = fixed_point_scales(bounds, n)
    q = torch.round(torch.stack([g, h], dim=1).double() * scales).to(torch.int64)
    keys = (pos.long()[:, None] * (n_feat * MAX_BINS)
            + torch.arange(n_feat, device=dev)[None, :] * MAX_BINS + xb.long())
    sums = torch.zeros((n_nodes * n_feat * MAX_BINS, 2), dtype=torch.int64,
                       device=dev)
    sums.index_add_(0, keys.reshape(-1),
                    q[:, None, :].expand(n, n_feat, 2).reshape(-1, 2))
    return (sums.double() / scales).float().view(n_nodes, n_feat, MAX_BINS, 2)


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


def _add_leaves(preds: torch.Tensor, leaf: torch.Tensor, idx: torch.Tensor,
                scale: float) -> None:
    """``preds = fma(scale, leaf[idx], preds)`` in place, taken in float64,
    where the f32 product is exact, and rounded once more to f32: the fused
    result except when the float64 sum lands exactly halfway between two
    f32 values."""
    scale32 = float(np.float32(scale))
    preds.copy_(preds.double().add_(leaf[idx].double(), alpha=scale32))


def leaf_values_reference(pos: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                          n_leaves: int, lam: float, scale: float,
                          preds: torch.Tensor) -> torch.Tensor:
    """Leaf sums in row order, ``leaf = -G / (H + lam)``, and
    ``preds = fma(scale, leaf[pos], preds)`` in place. Returns ``leaf``
    [n_leaves]. The update is one fused multiply-add, as the reference's
    compiled tree step rounds it (XLA contracts ``preds + lr * leaf[pos]``)."""
    idx = pos.long()
    gs = torch.zeros(n_leaves, dtype=g.dtype, device=g.device).index_add_(0, idx, g)
    hs = torch.zeros(n_leaves, dtype=h.dtype, device=h.device).index_add_(0, idx, h)
    leaf = -gs / (hs + lam)
    _add_leaves(preds, leaf, idx, scale)
    return leaf


def leaf_values_fixed_reference(pos: torch.Tensor, g: torch.Tensor,
                                h: torch.Tensor, n_leaves: int, lam: float,
                                scale: float, preds: torch.Tensor,
                                bounds: torch.Tensor) -> torch.Tensor:
    """K5's arithmetic in torch, for tests: the leaf sums in 64-bit fixed
    point at ``fixed_point_scales(bounds, n)`` as in
    ``level_histogram_fixed_reference``, then the leaves and the margin
    update of ``leaf_values_reference``. The kernel returns these bits."""
    scales = fixed_point_scales(bounds, pos.shape[0])
    q = torch.round(torch.stack([g, h], dim=1).double() * scales).to(torch.int64)
    idx = pos.long()
    sums = torch.zeros((n_leaves, 2), dtype=torch.int64, device=g.device)
    gs, hs = (sums.index_add_(0, idx, q).double() / scales).float().unbind(1)
    leaf = -gs / (hs + lam)
    _add_leaves(preds, leaf, idx, scale)
    return leaf


def next_gradients_reference(preds: torch.Tensor, y: torch.Tensor,
                             u: torch.Tensor, subsample: float,
                             w_rows: torch.Tensor, task: str
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A boosted tree's (g, h, bounds) from the margins, as the reference's
    tree step takes them (``forest_tpu.py:309-319``): ``reg`` g = preds − y,
    h = 1; ``cls`` g = p − y, h = max(p·(1 − p), 1e-6) with p = sigmoid(preds);
    both times the subsample mask ``u < subsample`` and ``w_rows``, as
    (g·m)·w. ``bounds`` is ``gradient_bounds(g, h)``. K5 computes the same
    for the next tree after its margin update."""
    if task == "reg":
        g, h = preds - y, torch.ones_like(y)
    else:
        p = torch.sigmoid(preds)
        g, h = p - y, torch.clamp(p * (1 - p), min=1e-6)
    m = (u < subsample).float()
    g, h = g * m * w_rows, h * m * w_rows
    return g, h, gradient_bounds(g, h)


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
    fit takes it once a tree (K5 takes the next tree's) and passes it to
    every K3 and K5 call."""
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


def check_bin_counts(n_bins: torch.Tensor, xb: torch.Tensor,
                     occupancy: bool = True) -> None:
    """Raises unless ``n_bins`` is uint8 [F] on the device of ``xb`` and,
    with ``occupancy``, every count lies in [1, 64] and above its feature's
    largest bin in ``xb`` (that part reads the device: once a fit)."""
    n_feat = xb.shape[1]
    if n_bins.dtype != torch.uint8 or n_bins.shape != (n_feat,):
        raise TypeError(f"n_bins must be uint8 [{n_feat}], got {n_bins.dtype} "
                        f"{tuple(n_bins.shape)}")
    if n_bins.device != xb.device:
        raise ValueError(f"n_bins is on {n_bins.device}, xb on {xb.device}")
    if not n_bins.is_contiguous():
        raise ValueError("n_bins must be contiguous")
    if not occupancy:
        return
    if n_feat and not bool(((n_bins >= 1) & (n_bins <= MAX_BINS)).all()):
        raise ValueError(f"n_bins must lie in [1, {MAX_BINS}]")
    if xb.shape[0] and n_feat:
        largest = xb.amax(dim=0)
        if bool((largest >= n_bins).any()):
            f = int(torch.nonzero(largest >= n_bins)[0])
            raise ValueError(f"n_bins[{f}] = {int(n_bins[f])}, but xb[:, {f}] "
                             f"holds bin {int(largest[f])}")


@functools.lru_cache(maxsize=256)
def histogram_plan(n: int, n_feat: int, n_nodes: int) -> dict:
    """How K3 cuts a level into blocks, and the scratch it needs. A feature
    tile is 8 features (F ≤ 64) or 16; a node of at most ``own_rows`` rows
    is one work item, a larger node is cut into items of ``rows_per_item``
    rows and takes one of ``acc_slots`` slots in an int64 accumulator; a
    block has 256 threads, or 128 where the nodes hold few rows each.
    The offsets (in int64 words) lay the accumulator, the plan (four f64
    scales, items as 4 × int32, the slots' nodes, two counts) and the row
    order out in one buffer of ``words``."""
    rows_per_item = max(256, 32 * -(-n // 2048))
    own_rows = 2 * rows_per_item
    max_items = n_nodes + n // rows_per_item
    acc_slots = min(n_nodes, n // (own_rows + 1))
    plan = acc_slots * n_feat * MAX_BINS * 2
    rows = plan + 4 + (4 * max_items + acc_slots + 2 + 1) // 2
    return {"tile_feats": 8 if n_feat <= 64 else 16,
            "threads": 256 if n >= 128 * n_nodes else 128,
            "rows_per_item": rows_per_item, "own_rows": own_rows,
            "max_items": max_items, "acc_slots": acc_slots,
            "plan": plan, "rows": rows,
            "words": rows + (n + 1) // 2}


def level_histogram(xb: torch.Tensor, pos: torch.Tensor, g: torch.Tensor,
                    h: torch.Tensor, n_nodes: int,
                    bounds: Optional[torch.Tensor] = None,
                    n_bins: Optional[torch.Tensor] = None, *,
                    bins_checked: bool = False) -> torch.Tensor:
    """K3. xb uint8 [n, F] (bins < 64), pos int32 [n] in [0, n_nodes),
    g, h f32 [n] → hist f32 [n_nodes, F, 64, 2].

    ``n_bins`` uint8 [F], optional: the occupied bins of each feature
    (``BinMapper.bin_counts``), so that the kernel keeps only those in
    shared memory and sums a feature of at most 4 bins in registers; the
    result does not depend on it. It is checked against ``xb`` unless the
    caller has done so (``check_bin_counts``) and says ``bins_checked``: a
    fit checks once, not at every level.

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
    if not 1 <= n_nodes <= 1 << MAX_DEPTH:
        raise ValueError(f"n_nodes must be in [1, {1 << MAX_DEPTH}], got {n_nodes}")
    if n_bins is not None:
        check_bin_counts(n_bins, xb, occupancy=not bins_checked)
    if not _kernel_device(xb, "forest_level_histogram"):
        return level_histogram_reference(xb, pos, g, h, n_nodes)
    out = torch.empty((n_nodes, n_feat, MAX_BINS, 2), dtype=torch.float32,
                      device=xb.device)
    if out.numel() == 0:
        return out
    bounds = _check_bounds(bounds, g, h)
    plan = histogram_plan(n, n_feat, n_nodes)
    scratch = torch.empty(plan["words"], dtype=torch.int64, device=xb.device)
    base = scratch.data_ptr()
    with torch.cuda.device(xb.device):
        rc = kernels_lib().bbbp_forest_level_histogram(
            xb.data_ptr(), n, n_feat, pos.data_ptr(), g.data_ptr(),
            h.data_ptr(), n_nodes, bounds.data_ptr(),
            None if n_bins is None else n_bins.data_ptr(),
            plan["tile_feats"], plan["threads"], plan["rows_per_item"],
            plan["own_rows"],
            base + 8 * plan["rows"], base + 8 * plan["plan"], base,
            out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
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
    # a (gain, index) candidate of each block: of 4 features in oblivious
    # mode, else of 64 features of a node (one block writes the split itself)
    n_cand = -(-n_feat // 4) if oblivious else nodes * -(-n_feat // 64)
    scratch = (torch.empty(2 * n_cand, dtype=torch.int32, device=hist.device)
               if oblivious or n_feat > 64 else None)
    with torch.cuda.device(hist.device):
        rc = kernels_lib().bbbp_forest_best_splits(
            hist.data_ptr(), nodes, n_feat, col_mask.data_ptr(), float(lam),
            float(min_child), int(bool(oblivious)),
            None if scratch is None else scratch.data_ptr(),
            feat.data_ptr(), b.data_ptr(), has_split.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "forest_best_splits")
    best_splits.launches.add()
    return feat, b, has_split


class NextTree(NamedTuple):
    """The next boosted tree's inputs for ``leaf_values``: the targets, the
    tree's subsample draw ``u`` (``torch.rand(n)``), the rate, the row
    weights (each f32 [n]) and the task, ``reg`` or ``cls``."""
    y: torch.Tensor
    u: torch.Tensor
    subsample: float
    w_rows: torch.Tensor
    task: str


LEAF_THREADS = 1024                     # kLeafThreads of csrc/forest_train.cu
LEAF_MAX_CLUSTER = 16


def leaf_plan(n: int) -> int:
    """Blocks of ``LEAF_THREADS`` in K5's one thread block cluster: a row a
    thread up to 16,384 rows, then 16 blocks (non-portable above 8; of 8
    and 16 the faster at 65,536 rows on the H100)."""
    return min(LEAF_MAX_CLUSTER, max(1, -(-n // LEAF_THREADS)))


def leaf_values(pos: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                n_leaves: int, lam: float, scale: float, preds: torch.Tensor,
                bounds: Optional[torch.Tensor] = None,
                next_tree: Optional[NextTree] = None):
    """K5. pos int32 [n] in [0, n_leaves), g, h f32 [n], preds f32 [n]
    (updated in place, as the reference's scan carry is replaced) →
    leaf f32 [n_leaves]. The kernel sums in 64-bit fixed point, as K3, with
    the same ``bounds``.

    With ``next_tree`` it returns (leaf, g, h, bounds) of the next boosted
    tree, ``next_gradients_reference`` of the updated margins, from the same
    launch. The kernel runs in one cluster of ``leaf_plan(n)`` blocks."""
    if pos.dim() != 1:
        raise TypeError(f"pos must be 1-D, got {tuple(pos.shape)}")
    n = pos.shape[0]
    rows = [("pos", pos, torch.int32), ("g", g, torch.float32),
            ("h", h, torch.float32), ("preds", preds, torch.float32)]
    if next_tree is not None:
        if next_tree.task not in ("reg", "cls"):
            raise ValueError(f"task must be 'reg' or 'cls', got {next_tree.task!r}")
        rows += [(name, getattr(next_tree, name), torch.float32)
                 for name in ("y", "u", "w_rows")]
    for name, t, dtype in rows:
        _check_rows(name, t, dtype, n, pos.device)
    if not 1 <= n_leaves <= 1 << MAX_DEPTH:
        raise ValueError(f"n_leaves must be in [1, {1 << MAX_DEPTH}], got {n_leaves}")
    if not _kernel_device(pos, "forest_leaf_values"):
        leaf = leaf_values_reference(pos, g, h, n_leaves, lam, scale, preds)
        if next_tree is None:
            return leaf
        return (leaf, *next_gradients_reference(preds, *next_tree))
    bounds = _check_bounds(bounds, g, h)
    dev = pos.device
    leaf = torch.empty(n_leaves, dtype=torch.float32, device=dev)
    nxt = None
    if next_tree is not None:
        nxt = (torch.empty(n, dtype=torch.float32, device=dev),
               torch.empty(n, dtype=torch.float32, device=dev),
               torch.empty(2, dtype=torch.float32, device=dev))
    with torch.cuda.device(dev):
        rc = kernels_lib().bbbp_forest_leaf_values(
            pos.data_ptr(), n, g.data_ptr(), h.data_ptr(), n_leaves,
            float(lam), float(scale), bounds.data_ptr(), leaf.data_ptr(),
            preds.data_ptr(),
            *((None, None, None, 1.0, 0) if next_tree is None else
              (next_tree.y.data_ptr(), next_tree.u.data_ptr(),
               next_tree.w_rows.data_ptr(), float(next_tree.subsample),
               int(next_tree.task == "cls"))),
            *((None, None, None) if nxt is None else (t.data_ptr() for t in nxt)),
            leaf_plan(n), torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "forest_leaf_values")
    leaf_values.launches.add()
    return leaf if nxt is None else (leaf, *nxt)


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
               preds0: Optional[torch.Tensor] = None,
               n_bins: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Boosting (``task`` ``reg`` or ``cls``) or bagging (``rf``) on the
    device of ``xb`` [n, F] uint8, the counterpart of ``_fit_forest_device``
    and ``fit_forest_launched``. ``edge_vals`` [F, 64] f32, ``y`` [n] f32,
    ``row_w`` an optional [n] weight (rows of weight 0 contribute nothing),
    ``preds0`` an optional starting margin, ``n_bins`` the optional uint8
    [F] occupied bins of each feature for K3 (``BinMapper.bin_counts``; it
    is checked against ``xb`` here, once; the trees do not depend on it).
    Returns (preds [n], feats [T, 2^D − 1] int32, thrs [T, 2^D − 1] f32,
    leaves [T, 2^D] f32), all on the device; random forests accumulate unscaled leaves in preds."""
    if task not in ("reg", "cls"):
        raise ValueError(f"task must be 'reg' or 'cls', got {task!r}")
    if not 0 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth must be in [0, {MAX_DEPTH}], got {depth}")
    dev = xb.device
    n, n_feat = xb.shape
    if n_bins is not None:
        check_bin_counts(n_bins, xb)
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

    def draw() -> torch.Tensor:                # a boosted tree's subsample draw
        return torch.rand(n, generator=gen, device=dev)

    if not rf and n_trees:                      # later trees' come from K5
        g, h, bounds = next_gradients_reference(preds, y, draw(), subsample,
                                                w_rows, task)
    for t in range(n_trees):
        if rf:
            w = torch.poisson(torch.ones(n, device=dev), generator=gen) * w_rows
            g, h = -y * w, w
            bounds = gradient_bounds(g, h)
        col_mask = torch.rand(n_feat, generator=gen, device=dev) < colsample
        # at least one feature: the first drawn, else feature 0
        col_mask = col_mask | (feat_ids == col_mask.to(torch.uint8).argmax())

        pos = torch.zeros(n, dtype=torch.int32, device=dev)
        for level in range(depth):
            nodes, off = 1 << level, (1 << level) - 1
            hist = level_histogram(xb, pos, g, h, nodes, bounds, n_bins,
                                   bins_checked=True)
            f_l, b_l, _ = best_splits(hist, col_mask, lam, min_child, oblivious)
            feats[t, off:off + nodes] = f_l
            bins[t, off:off + nodes] = b_l
            row_f = f_l[pos].long()
            xf = xb.gather(1, row_f[:, None])[:, 0]
            pos = 2 * pos + (xf.int() > b_l[pos]).int()
        # drawn after this tree's column draw: the generator gives the
        # draws in the order subsample, columns, tree by tree
        nxt = (None if rf or t == n_trees - 1 else
               NextTree(y, draw(), subsample, w_rows, task))
        out = leaf_values(pos, g, h, n_leaves, lam, scale, preds, bounds, nxt)
        if nxt is None:
            leaves[t] = out
        else:
            leaves[t], g, h, bounds = out

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
        n_bins = torch.from_numpy(self.mapper_.bin_counts()).to(device)
        row_w = (None if sample_weight is None else
                 torch.as_tensor(np.asarray(sample_weight, np.float32), device=device))
        _, feats, thrs, leaves = fit_forest(
            xb, edge_vals, torch.as_tensor(np.asarray(y, np.float32)),
            lr=self.learning_rate, lam=self.reg_lambda,
            min_child=self.min_child_weight, subsample=self.subsample,
            colsample=self.colsample, base_score=base_score, seed=self.seed,
            task=task, n_trees=self.n_estimators, depth=self.max_depth,
            oblivious=self.oblivious, rf=rf, row_w=row_w, n_bins=n_bins)
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
