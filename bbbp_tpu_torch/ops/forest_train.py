"""Forest training on the device: level-wise histogram split search.

Counterpart of the trainer in ``bbbp_tpu/ops/forest_tpu.py``
(``_fit_forest_device``, ``fit_forest_launched`` and the ``TPU*`` estimator
classes) and of ``BinMapper`` in ``bbbp_tpu/ops/forest.py``. The estimators
here are the JAX package's ``TPUGBDTRegressor``, ``TPUGBDTClassifier``,
``TPURandomForestRegressor`` and ``TPURandomForestClassifier`` without the
prefix, with the same defaults; they add a ``device`` (``cuda`` unless the
caller asks for ``cpu``).

Features are quantile-binned once on the host (uint8, at most 64 bins).
Each tree grows level by level over the implicit full-binary layout. Four
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

The routing (each row's next position from its node's split, and the
level's splits into the tree's flat arrays) has no launch of its own: the
call that next reads the positions takes the parent level's split
(``ParentSplit``) and routes each row as it reads it, K3's sort (or the
fused search's) at the next level, K5 after the last. ``route_rows_reference``
is its plain version.

``fit_forest_lanes`` runs L fits of one shape over one binned matrix (the
JAX package's vmapped ``_fit_forest_device``): each level's split search is
one fused pass over the lanes (``level_splits_lanes``: K3's sums and K4's
pick, with no histogram in device memory; in oblivious mode
``level_splits_oblivious_lanes``, which sums each gain over the level's
nodes as it walks them); K3 and K4 with a lane axis
(``level_histogram_lanes``, ``best_splits_lanes``) compute the same and
stay as the yardstick of both; K5 takes a lane axis (``leaf_values_lanes``:
a thread block cluster a lane where one wave of the card holds the lanes'
clusters, else a block a lane),
and each lane grows the trees of ``fit_forest`` with its seed bit for bit.

The first tree's gradients, the random forest's weights and the
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

import ctypes
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

def _check_rows(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
                device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise TypeError(f"{name} must be {dtype} {list(shape)}, got {t.dtype} "
                        f"{list(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def gradient_bounds(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """f32 [..., 2] (max |g|, max |h|) over the last axis, on the device of
    ``g``: the range K3 and K5 quantise the rows into ([2] for one fit's
    [n] rows, [L, 2] for lanes). g and h do not change within a tree, so a
    fit takes it once a tree (K5 takes the next tree's) and passes it to
    every K3 and K5 call."""
    if g.shape[-1] == 0:
        return torch.zeros((*g.shape[:-1], 2), dtype=torch.float32, device=g.device)
    return torch.stack((g.abs().amax(-1), h.abs().amax(-1)), dim=-1)


def _check_bounds(bounds: Optional[torch.Tensor], g: torch.Tensor,
                  h: torch.Tensor) -> torch.Tensor:
    if bounds is None:
        return gradient_bounds(g, h)
    _check_rows("bounds", bounds, torch.float32, (2,), g.device)
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


class ParentSplit(NamedTuple):
    """The parent level's splits, routed by the call that next reads the
    positions: ``f_l``, ``b_l`` int32 [2^level] (one fit) or [L, 2^level]
    (lanes), the splits of level ``level`` of tree ``tree``
    (``best_splits``); ``feats``, ``bins`` int32 [T, 2^D − 1] or [L, T,
    2^D − 1], the trees' flat arrays, which receive the pairs at nodes
    2^level − 1 onwards. A row at parent node p goes to
    ``2 p + (xb[row, f_l[p]] > b_l[p])`` (``route_rows_reference``)."""
    f_l: torch.Tensor
    b_l: torch.Tensor
    feats: torch.Tensor
    bins: torch.Tensor
    tree: int
    level: int


def route_rows_reference(xb: torch.Tensor, pos: torch.Tensor, f_l: torch.Tensor,
                         b_l: torch.Tensor, feats: torch.Tensor,
                         bins: torch.Tensor, tree: int, level: int) -> None:
    """The routing's plain version, the torch ops of one level, over lanes
    where the tensors have a lane axis: the level's (feature, bin) pairs
    into the tree's flat arrays, then ``pos = 2 * pos + (xb[row, f_l[pos]]
    > b_l[pos])`` in place (``forest_tpu.py:335-338``)."""
    n = xb.shape[0]
    nodes, off = 1 << level, (1 << level) - 1
    feats[..., tree, off:off + nodes] = f_l
    bins[..., tree, off:off + nodes] = b_l
    idx = pos.long()
    row_f = f_l.gather(-1, idx).long().reshape(-1, n)
    xf = xb.gather(1, row_f.T.contiguous()).T.reshape(pos.shape)
    pos.copy_(2 * pos + (xf.int() > b_l.gather(-1, idx)).int())


NO_PARENT = (None, None, 0, None, None)     # the C arguments of no parent split


def _parent_args(parent: Optional[ParentSplit], xb: torch.Tensor,
                 pos: torch.Tensor, children: int) -> Tuple[tuple, int]:
    """Checks a parent split against ``xb`` [n, F], ``pos`` [n] or [L, n]
    and the ``children`` nodes it leads to. Returns its C arguments (f_l,
    b_l, nodes, and feats and bins at the level's first node of the tree)
    and the words from one lane's trees to the next; (``NO_PARENT``, 0)
    for None."""
    if parent is None:
        return NO_PARENT, 0
    if xb.dtype != torch.uint8 or xb.dim() != 2 or not xb.is_contiguous():
        raise TypeError(f"xb must be a contiguous 2-D uint8 tensor, got "
                        f"{xb.dtype} {tuple(xb.shape)}")
    lead = tuple(pos.shape[:-1])
    level = parent.level
    if not 0 <= level < MAX_DEPTH:
        raise ValueError(f"level must be in [0, {MAX_DEPTH}), got {level}")
    nodes = 1 << level
    if 2 * nodes != children:
        raise ValueError(f"a parent split of level {level} leads to {2 * nodes} "
                         f"nodes, not {children}")
    _check_rows("f_l", parent.f_l, torch.int32, lead + (nodes,), xb.device)
    _check_rows("b_l", parent.b_l, torch.int32, lead + (nodes,), xb.device)
    feats, bins = parent.feats, parent.bins
    if feats.dim() != len(lead) + 2:
        raise TypeError(f"feats must be [{'L, ' if lead else ''}T, nodes], got "
                        f"{tuple(feats.shape)}")
    n_trees, n_internal = feats.shape[-2:]
    _check_rows("feats", feats, torch.int32, lead + (n_trees, n_internal), xb.device)
    _check_rows("bins", bins, torch.int32, lead + (n_trees, n_internal), xb.device)
    if not 0 <= parent.tree < n_trees or 2 * nodes - 1 > n_internal:
        raise ValueError(f"tree {parent.tree}, level {level} lie outside trees of "
                         f"shape {tuple(feats.shape[-2:])}")
    first = 4 * (parent.tree * n_internal + nodes - 1)
    return ((parent.f_l.data_ptr(), parent.b_l.data_ptr(), nodes,
             feats.data_ptr() + first, bins.data_ptr() + first),
            n_trees * n_internal)


def _plain_positions(xb: torch.Tensor, pos: torch.Tensor, n_nodes: int,
                     parent: Optional[ParentSplit], in_place: bool) -> torch.Tensor:
    """The positions a plain version reads, as the kernels take them: where
    they can only be 0 (a level of one node, or a parent split of level 0)
    pos is not read; with a parent split they are routed
    (``route_rows_reference``), in pos itself with ``in_place`` (K3 and the
    fused search), else in a copy (K5)."""
    single = n_nodes == 1 if parent is None else parent.level == 0
    if parent is None:
        return torch.zeros_like(pos) if single else pos
    if single:
        pos = pos.zero_() if in_place else torch.zeros_like(pos)
    elif not in_place:
        pos = pos.clone()
    route_rows_reference(xb, pos, *parent)
    return pos


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
    return {"tile_feats": 8 if n_feat <= 64 else 16,
            "threads": 256 if n >= 128 * n_nodes else 128,
            **_sort_layout(n, n_feat, n_nodes, rows_per_item, 2 * rows_per_item)}


def _sort_layout(n: int, n_feat: int, n_nodes: int, rows_per_item: int,
                 own_rows: int) -> dict:
    """The sort's scratch at these item sizes (``sort_plan`` in
    ``csrc/forest_train.cu``): offsets in int64 words of the accumulator
    (at 0), the plan and the row order, and the words in all."""
    max_items = n_nodes + n // rows_per_item
    acc_slots = min(n_nodes, n // (own_rows + 1))
    plan = acc_slots * n_feat * MAX_BINS * 2
    rows = plan + 4 + (4 * max_items + acc_slots + 2 + 1) // 2
    return {"rows_per_item": rows_per_item, "own_rows": own_rows,
            "max_items": max_items, "acc_slots": acc_slots,
            "plan": plan, "rows": rows, "words": rows + (n + 1) // 2}


@functools.lru_cache(maxsize=256)
def oblivious_plan(n: int, n_nodes: int) -> dict:
    """The scratch of the fused oblivious search's sort, which owns every
    node whole (rows_per_item = own_rows = n: an item a node, no
    accumulator); ``lane_words`` its words a lane, rounded up to even."""
    own = max(n, 1)
    plan = _sort_layout(n, 0, n_nodes, own, own)
    return {**plan, "lane_words": plan["words"] + (plan["words"] & 1)}


def _sort_scratch(scratch: Optional[torch.Tensor], words: int,
                  device: torch.device) -> torch.Tensor:
    """The caller's scratch, checked, or a new one of ``words`` int64."""
    if scratch is None:
        return torch.empty(words, dtype=torch.int64, device=device)
    _check_rows("scratch", scratch, torch.int64, (words,), device)
    return scratch


def sorted_rows(scratch: torch.Tensor, n: int, n_feat: int, n_nodes: int,
                lane: int = 0, oblivious: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the sort of K3 (or of a fused search: ``oblivious`` for
    ``level_splits_oblivious_lanes``'s) left in ``scratch`` for lane
    ``lane``: (node, row), each int32 [kept], the kept rows (weight not 0) in
    the order the sort placed them, and each one's node, read from the
    plan's items (node, first, end). For tests."""
    if oblivious:
        plan = oblivious_plan(n, n_nodes)
        stride = plan["lane_words"]
    else:
        plan = histogram_plan(n, n_feat, n_nodes)
        stride = lane_words(n, n_feat, n_nodes)
    part = scratch.view(-1, stride)[lane] if scratch.numel() != plan["words"] else scratch
    words = part[plan["plan"] + 4:plan["rows"]].cpu()
    ints = words.view(torch.int32)
    items = ints[:4 * plan["max_items"]].view(-1, 4)
    info = ints[4 * plan["max_items"] + plan["acc_slots"]:][:2]
    rows = part[plan["rows"]:].cpu().view(torch.int32)[:n]
    nodes, order = [], []
    for node, first, end, _ in items[:int(info[0])].tolist():
        nodes.append(torch.full((end - first,), node, dtype=torch.int32))
        order.append(rows[first:end])
    if not nodes:
        return torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.int32)
    return torch.cat(nodes), torch.cat(order)


def level_histogram(xb: torch.Tensor, pos: torch.Tensor, g: torch.Tensor,
                    h: torch.Tensor, n_nodes: int,
                    bounds: Optional[torch.Tensor] = None,
                    n_bins: Optional[torch.Tensor] = None, *,
                    bins_checked: bool = False,
                    parent: Optional[ParentSplit] = None,
                    scratch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3. xb uint8 [n, F] (bins < 64), pos int32 [n] in [0, n_nodes),
    g, h f32 [n] → hist f32 [n_nodes, F, 64, 2].

    With ``parent`` (the split of the level before, n_nodes / 2 nodes) pos
    holds the parent level's positions: the kernel's sort routes every row
    (weight 0 or not) as it reads it, writes the level's positions back to
    pos and the parent's pairs into its tree; no other launch. Where the
    positions can only be 0 (one node, or a parent of one) pos is not read.
    ``scratch``, optional: int64 [histogram_plan(...)["words"]], the sort's
    plan and row order, for a caller that reads them (``sorted_rows``).

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
    _check_rows("pos", pos, torch.int32, (n,), xb.device)
    _check_rows("g", g, torch.float32, (n,), xb.device)
    _check_rows("h", h, torch.float32, (n,), xb.device)
    if not 1 <= n_nodes <= 1 << MAX_DEPTH:
        raise ValueError(f"n_nodes must be in [1, {1 << MAX_DEPTH}], got {n_nodes}")
    if n_bins is not None:
        check_bin_counts(n_bins, xb, occupancy=not bins_checked)
    route, _ = _parent_args(parent, xb, pos, n_nodes)
    if not _kernel_device(xb, "forest_level_histogram"):
        return level_histogram_reference(
            xb, _plain_positions(xb, pos, n_nodes, parent, True), g, h, n_nodes)
    out = torch.empty((n_nodes, n_feat, MAX_BINS, 2), dtype=torch.float32,
                      device=xb.device)
    if out.numel() == 0:
        return out
    bounds = _check_bounds(bounds, g, h)
    plan = histogram_plan(n, n_feat, n_nodes)
    scratch = _sort_scratch(scratch, plan["words"], xb.device)
    base = scratch.data_ptr()
    with torch.cuda.device(xb.device):
        rc = kernels_lib().bbbp_forest_level_histogram(
            xb.data_ptr(), n, n_feat, pos.data_ptr(), g.data_ptr(),
            h.data_ptr(), n_nodes, bounds.data_ptr(),
            None if n_bins is None else n_bins.data_ptr(),
            plan["tile_feats"], plan["threads"], plan["rows_per_item"],
            plan["own_rows"],
            base + 8 * plan["rows"], base + 8 * plan["plan"], base,
            out.data_ptr(), *route,
            torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "forest_level_histogram")
    level_histogram.launches.add(xb.device)
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
    best_splits.launches.add(hist.device)
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


def _leaf_rows(xb: Optional[torch.Tensor], parent: Optional[ParentSplit],
               pos: torch.Tensor) -> tuple:
    """K5's (xb, F) C arguments: the binned rows a parent split routes."""
    if parent is None:
        return None, 0
    if xb is None:
        raise ValueError("a parent split needs xb, the rows it routes")
    if xb.dim() != 2 or xb.shape[0] != pos.shape[-1] or xb.device != pos.device:
        raise ValueError(f"xb must be [{pos.shape[-1]}, F] on {pos.device}, got "
                         f"{tuple(xb.shape)} on {xb.device}")
    return xb.data_ptr(), xb.shape[1]


def leaf_values(pos: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                n_leaves: int, lam: float, scale: float, preds: torch.Tensor,
                bounds: Optional[torch.Tensor] = None,
                next_tree: Optional[NextTree] = None, *,
                parent: Optional[ParentSplit] = None,
                xb: Optional[torch.Tensor] = None):
    """K5. pos int32 [n] in [0, n_leaves), g, h f32 [n], preds f32 [n]
    (updated in place, as the reference's scan carry is replaced) →
    leaf f32 [n_leaves]. The kernel sums in 64-bit fixed point, as K3, with
    the same ``bounds``.

    With ``next_tree`` it returns (leaf, g, h, bounds) of the next boosted
    tree, ``next_gradients_reference`` of the updated margins, from the same
    launch. The kernel runs in one cluster of ``leaf_plan(n)`` blocks.

    With ``parent`` (the last level's split, n_leaves / 2 nodes) and ``xb``
    [n, F], pos holds the last level's positions: each row is routed as it
    is read, the pairs go into the tree, and pos is left as it is. Where
    the positions can only be 0 pos is not read."""
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
        _check_rows(name, t, dtype, (n,), pos.device)
    if not 1 <= n_leaves <= 1 << MAX_DEPTH:
        raise ValueError(f"n_leaves must be in [1, {1 << MAX_DEPTH}], got {n_leaves}")
    xb_args = _leaf_rows(xb, parent, pos)
    route, _ = _parent_args(parent, xb, pos, n_leaves)
    if not _kernel_device(pos, "forest_leaf_values"):
        leaf = leaf_values_reference(
            _plain_positions(xb, pos, n_leaves, parent, False), g, h, n_leaves, lam,
            scale, preds)
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
            leaf_plan(n), *xb_args, *route, torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "forest_leaf_values")
    leaf_values.launches.add(dev)
    return leaf if nxt is None else (leaf, *nxt)


level_histogram.launches = LaunchCounter()
best_splits.launches = LaunchCounter()
leaf_values.launches = LaunchCounter()


# ---------------------------------------------------------------------------
# K3, K4 and K5 with a lane axis: L fits of one shape over one xb
# ---------------------------------------------------------------------------

def level_histogram_lanes_reference(xb: torch.Tensor, pos: torch.Tensor,
                                    g: torch.Tensor, h: torch.Tensor,
                                    n_nodes: int) -> torch.Tensor:
    """``level_histogram_reference`` of each lane: [L, n_nodes, F, 64, 2]."""
    return torch.stack([level_histogram_reference(xb, p, gl, hl, n_nodes)
                        for p, gl, hl in zip(pos, g, h)])


def level_histogram_lanes_fixed_reference(xb: torch.Tensor, pos: torch.Tensor,
                                          g: torch.Tensor, h: torch.Tensor,
                                          n_nodes: int, bounds: torch.Tensor
                                          ) -> torch.Tensor:
    """``level_histogram_fixed_reference`` of each lane, at its own bounds:
    the lane kernel's bits."""
    return torch.stack([level_histogram_fixed_reference(xb, p, gl, hl, n_nodes, bl)
                        for p, gl, hl, bl in zip(pos, g, h, bounds)])


def lane_words(n: int, n_feat: int, n_nodes: int) -> int:
    """int64 words from one lane's K3 scratch to the next: the plan's words,
    rounded up to even so that each lane's 16-byte parts stay aligned."""
    words = histogram_plan(n, n_feat, n_nodes)["words"]
    return words + (words & 1)


def level_histogram_lanes(xb: torch.Tensor, pos: torch.Tensor, g: torch.Tensor,
                          h: torch.Tensor, n_nodes: int,
                          bounds: Optional[torch.Tensor] = None,
                          n_bins: Optional[torch.Tensor] = None, *,
                          bins_checked: bool = False,
                          parent: Optional[ParentSplit] = None,
                          scratch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 over lanes. xb uint8 [n, F], every lane's; pos int32, g, h f32
    [L, n]; bounds f32 [L, 2] (``gradient_bounds(g, h)``, taken here when not
    given) → hist f32 [L, n_nodes, F, 64, 2]. Each lane sums in K3's fixed
    point at its own bounds, so lane l is bit-equal to ``level_histogram``
    of lane l's rows. ``n_bins``, ``parent`` (with a lane axis) and
    ``scratch`` (int64 [L · lane_words]) as in ``level_histogram``. On a CPU
    tensor ``level_histogram_lanes_reference`` runs, after
    ``route_rows_reference`` with a parent split."""
    if xb.dtype != torch.uint8 or xb.dim() != 2 or not xb.is_contiguous():
        raise TypeError(f"xb must be a contiguous 2-D uint8 tensor, got "
                        f"{xb.dtype} {tuple(xb.shape)}")
    if pos.dim() != 2:
        raise TypeError(f"pos must be [L, n], got {tuple(pos.shape)}")
    n, n_feat = xb.shape
    lanes = pos.shape[0]
    for name, t, dtype in (("pos", pos, torch.int32), ("g", g, torch.float32),
                           ("h", h, torch.float32)):
        _check_rows(name, t, dtype, (lanes, n), xb.device)
    if not 1 <= n_nodes <= 1 << MAX_DEPTH:
        raise ValueError(f"n_nodes must be in [1, {1 << MAX_DEPTH}], got {n_nodes}")
    if n_bins is not None:
        check_bin_counts(n_bins, xb, occupancy=not bins_checked)
    route, tree_lane = _parent_args(parent, xb, pos, n_nodes)
    if not _kernel_device(xb, "forest_level_histogram_lanes"):
        return level_histogram_lanes_reference(
            xb, _plain_positions(xb, pos, n_nodes, parent, True), g, h, n_nodes)
    out = torch.empty((lanes, n_nodes, n_feat, MAX_BINS, 2), dtype=torch.float32,
                      device=xb.device)
    if out.numel() == 0:
        return out
    if bounds is None:
        bounds = gradient_bounds(g, h)
    _check_rows("bounds", bounds, torch.float32, (lanes, 2), xb.device)
    plan = histogram_plan(n, n_feat, n_nodes)
    stride = lane_words(n, n_feat, n_nodes)
    scratch = _sort_scratch(scratch, lanes * stride, xb.device)
    base = scratch.data_ptr()
    with torch.cuda.device(xb.device):
        rc = kernels_lib().bbbp_forest_level_histogram_lanes(
            xb.data_ptr(), n, n_feat, pos.data_ptr(), g.data_ptr(),
            h.data_ptr(), n_nodes, bounds.data_ptr(),
            None if n_bins is None else n_bins.data_ptr(),
            plan["tile_feats"], plan["threads"], plan["rows_per_item"],
            plan["own_rows"],
            base + 8 * plan["rows"], base + 8 * plan["plan"], base,
            out.data_ptr(), *route, tree_lane, lanes, stride,
            torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "forest_level_histogram_lanes")
    level_histogram_lanes.launches.add(xb.device)
    return out


def _host_values(values) -> List[float]:
    """A lane parameter ([L] tensor or sequence) as host floats; a sequence
    is taken as it is, so that a caller can capture the plain versions in a
    CUDA graph (a tensor on the card is read with a synchronisation)."""
    return values.tolist() if isinstance(values, torch.Tensor) else list(values)


def best_splits_lanes_reference(hist: torch.Tensor, col_mask: torch.Tensor,
                                lam, min_child: float, oblivious: bool
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``best_splits_reference`` of each lane at its own lambda (``lam`` [L],
    a tensor or host floats): (feat, bin, has_split), each [L, nodes]."""
    per_lane = [best_splits_reference(hl, ml, lm, min_child, oblivious)
                for hl, ml, lm in zip(hist, col_mask, _host_values(lam))]
    return tuple(torch.stack(parts) for parts in zip(*per_lane))


def best_splits_lanes(hist: torch.Tensor, col_mask: torch.Tensor,
                      lam: torch.Tensor, min_child: float, oblivious: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 over lanes. hist f32 [L, nodes, F, 64, 2], col_mask bool [L, F],
    lam f32 [L] on the same device → (feat int32, bin int32, has_split bool),
    each [L, nodes]; lane l is ``best_splits`` of lane l at lam[l]. On a CPU
    tensor ``best_splits_lanes_reference`` runs."""
    if hist.dtype != torch.float32 or hist.dim() != 5 or \
            hist.shape[3:] != (MAX_BINS, 2):
        raise TypeError(f"hist must be float32 [L, nodes, F, {MAX_BINS}, 2], "
                        f"got {hist.dtype} {tuple(hist.shape)}")
    lanes, nodes, n_feat = hist.shape[:3]
    if not hist.is_contiguous():
        raise ValueError("hist must be contiguous")
    if nodes < 1 or n_feat < 1:
        raise ValueError(f"hist needs a node and a feature, got {tuple(hist.shape)}")
    _check_rows("col_mask", col_mask, torch.bool, (lanes, n_feat), hist.device)
    _check_rows("lam", lam, torch.float32, (lanes,), hist.device)
    if not _kernel_device(hist, "forest_best_splits_lanes"):
        return best_splits_lanes_reference(hist, col_mask, lam, min_child, oblivious)
    dev = hist.device
    feat = torch.empty((lanes, nodes), dtype=torch.int32, device=dev)
    b = torch.empty((lanes, nodes), dtype=torch.int32, device=dev)
    has_split = torch.empty((lanes, nodes), dtype=torch.bool, device=dev)
    if lanes == 0:
        return feat, b, has_split
    n_cand = -(-n_feat // 4) if oblivious else nodes * -(-n_feat // 64)
    scratch = (torch.empty(lanes * 2 * n_cand, dtype=torch.int32, device=dev)
               if oblivious or n_feat > 64 else None)
    with torch.cuda.device(dev):
        rc = kernels_lib().bbbp_forest_best_splits_lanes(
            hist.data_ptr(), nodes, n_feat, col_mask.data_ptr(), lam.data_ptr(),
            float(min_child), int(bool(oblivious)),
            None if scratch is None else scratch.data_ptr(),
            feat.data_ptr(), b.data_ptr(), has_split.data_ptr(), lanes,
            torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "forest_best_splits_lanes")
    best_splits_lanes.launches.add(dev)
    return feat, b, has_split


def level_splits_lanes_reference(xb: torch.Tensor, pos: torch.Tensor,
                                 g: torch.Tensor, h: torch.Tensor, n_nodes: int,
                                 col_mask: torch.Tensor, lam, min_child: float,
                                 oblivious: bool = False
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``best_splits_lanes_reference`` (per node, or ``oblivious``) of
    ``level_histogram_lanes_reference``: each lane's splits from its f32
    histogram, summed in row order."""
    return best_splits_lanes_reference(
        level_histogram_lanes_reference(xb, pos, g, h, n_nodes), col_mask, lam,
        min_child, oblivious)


def level_splits_lanes_fixed_reference(xb: torch.Tensor, pos: torch.Tensor,
                                       g: torch.Tensor, h: torch.Tensor,
                                       n_nodes: int, col_mask: torch.Tensor, lam,
                                       min_child: float, bounds: torch.Tensor,
                                       oblivious: bool = False
                                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``best_splits_lanes_reference`` (per node, or ``oblivious``) of
    ``level_histogram_lanes_fixed_reference``: K3's fixed-point sums at each
    lane's bounds, then K4's arithmetic, which is what the fused kernels
    compute."""
    return best_splits_lanes_reference(
        level_histogram_lanes_fixed_reference(xb, pos, g, h, n_nodes, bounds),
        col_mask, lam, min_child, oblivious)


SPLIT_GROUP = 8                     # features a unit of the fused split search
SPLIT_MAX_RUN = 8                   # units a warp walks
SPLIT_SM_WARPS = 24                 # warps an SM holds of the kernel: its launch
                                    # bounds, 3 blocks of 8 warps (kSplitBlocks)
SPLIT_ROUNDS = 4                    # rounds of the card's warps that take one unit


def split_run(lanes: int, units: int, sms: int) -> int:
    """Units a warp of the fused split search walks on a card of ``sms``
    SMs: one while the lanes' units fill ``SPLIT_ROUNDS`` rounds of the
    warps the SMs hold, else more, up to ``SPLIT_MAX_RUN``, so that several
    small nodes share a block's start-up (zeroing its 69 KB of tiles): 17%
    and 20% off the deep levels 9 and 11 at 250 lanes on an H100
    (``chip_smoke.py`` phase 14; the design comment in
    ``csrc/forest_train.cu``)."""
    return max(1, min(SPLIT_MAX_RUN,
                      lanes * units // (SPLIT_ROUNDS * sms * SPLIT_SM_WARPS)))


def _check_lane_level(xb: torch.Tensor, pos: torch.Tensor, g: torch.Tensor,
                      h: torch.Tensor, n_nodes: int, col_mask: torch.Tensor,
                      lam: torch.Tensor) -> Tuple[int, int, int]:
    """Checks a fused split search's inputs; returns (n, F, L)."""
    if xb.dtype != torch.uint8 or xb.dim() != 2 or not xb.is_contiguous():
        raise TypeError(f"xb must be a contiguous 2-D uint8 tensor, got "
                        f"{xb.dtype} {tuple(xb.shape)}")
    if pos.dim() != 2:
        raise TypeError(f"pos must be [L, n], got {tuple(pos.shape)}")
    n, n_feat = xb.shape
    lanes = pos.shape[0]
    if n_feat < 1:
        raise ValueError("xb needs a feature")
    for name, t, dtype in (("pos", pos, torch.int32), ("g", g, torch.float32),
                           ("h", h, torch.float32)):
        _check_rows(name, t, dtype, (lanes, n), xb.device)
    _check_rows("col_mask", col_mask, torch.bool, (lanes, n_feat), xb.device)
    _check_rows("lam", lam, torch.float32, (lanes,), xb.device)
    if not 1 <= n_nodes <= 1 << MAX_DEPTH:
        raise ValueError(f"n_nodes must be in [1, {1 << MAX_DEPTH}], got {n_nodes}")
    return n, n_feat, lanes


def _lane_splits_out(lanes: int, n_nodes: int, g: torch.Tensor, h: torch.Tensor,
                     bounds: Optional[torch.Tensor]):
    """A fused search's outputs (feat, bin, has_split [L, n_nodes]) and its
    bounds, checked, or taken from g and h when None."""
    dev = g.device
    feat = torch.empty((lanes, n_nodes), dtype=torch.int32, device=dev)
    b = torch.empty((lanes, n_nodes), dtype=torch.int32, device=dev)
    has_split = torch.empty((lanes, n_nodes), dtype=torch.bool, device=dev)
    if bounds is None:
        bounds = gradient_bounds(g, h)
    _check_rows("bounds", bounds, torch.float32, (lanes, 2), dev)
    return feat, b, has_split, bounds


def level_splits_lanes(xb: torch.Tensor, pos: torch.Tensor, g: torch.Tensor,
                       h: torch.Tensor, n_nodes: int,
                       bounds: Optional[torch.Tensor], col_mask: torch.Tensor,
                       lam: torch.Tensor, min_child: float,
                       n_bins: Optional[torch.Tensor] = None, *,
                       bins_checked: bool = False,
                       parent: Optional[ParentSplit] = None,
                       scratch: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One level's split search over lanes in one pass, the counterpart of
    ``_grow_level`` under ``jax.vmap`` (``forest_tpu.py:154-231``). xb uint8
    [n, F], every lane's; pos int32, g, h f32 [L, n]; bounds f32 [L, 2]
    (``gradient_bounds(g, h)``, taken here when None); col_mask bool [L, F];
    lam f32 [L]; ``n_bins`` as in ``level_histogram`` → (feat int32, bin
    int32, has_split bool), each [L, n_nodes].

    On a CUDA tensor the kernel (``forest_level_splits_lanes``) sums each
    node's rows in K3's fixed point and takes K4's per-node pick from the
    sums where they lie, so its result is ``best_splits_lanes`` of
    ``level_histogram_lanes`` on the same inputs, bit for bit, with no
    histogram in device memory. ``parent`` and ``scratch`` as in
    ``level_histogram_lanes``: the sort routes the parent level's positions
    in place. On a CPU tensor ``level_splits_lanes_reference`` runs, after
    ``route_rows_reference`` with a parent split."""
    n, n_feat, lanes = _check_lane_level(xb, pos, g, h, n_nodes, col_mask, lam)
    if n_bins is not None:
        check_bin_counts(n_bins, xb, occupancy=not bins_checked)
    route, tree_lane = _parent_args(parent, xb, pos, n_nodes)
    if not _kernel_device(xb, "forest_level_splits_lanes"):
        return level_splits_lanes_reference(
            xb, _plain_positions(xb, pos, n_nodes, parent, True), g, h, n_nodes,
            col_mask, lam, min_child)
    dev = xb.device
    feat, b, has_split, bounds = _lane_splits_out(lanes, n_nodes, g, h, bounds)
    if lanes == 0:
        return feat, b, has_split
    plan = histogram_plan(n, n_feat, n_nodes)
    stride = lane_words(n, n_feat, n_nodes)
    scratch = _sort_scratch(scratch, lanes * stride, dev)
    base = scratch.data_ptr()
    # a (gain, index) candidate of each node and group of 8 features
    groups = -(-n_feat // SPLIT_GROUP)
    cand = torch.empty(2 * lanes * n_nodes * groups, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = kernels_lib().bbbp_forest_level_splits_lanes(
            xb.data_ptr(), n, n_feat, pos.data_ptr(), g.data_ptr(), h.data_ptr(),
            n_nodes, bounds.data_ptr(), None if n_bins is None else n_bins.data_ptr(),
            col_mask.data_ptr(), lam.data_ptr(), float(min_child),
            plan["rows_per_item"], plan["own_rows"],
            split_run(lanes, plan["max_items"] * groups,
                      torch.cuda.get_device_properties(dev).multi_processor_count),
            base + 8 * plan["rows"], base + 8 * plan["plan"], base, cand.data_ptr(),
            feat.data_ptr(), b.data_ptr(), has_split.data_ptr(), *route, tree_lane,
            lanes, stride, torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "forest_level_splits_lanes")
    level_splits_lanes.launches.add(dev)
    return feat, b, has_split


OBLIVIOUS_GROUP = 32                # features a block of the fused oblivious search
# Levels from the root that ``fit_forest_lanes`` gives the fused oblivious
# search; deeper levels take K3 then K4 with lanes, faster there. By form
# (``oblivious_form``): (blocks a SM from which it holds, levels), the
# blocks being lanes x groups of features. torch_oblivious_profile.py on an
# H100 80GB HBM3 (700 W, 132 SMs) over real trees at n = 8,162, F = 30
# found the first level where the two kernels are faster at L = 10, 15, 33
# (form 2): 0, 3, 4; L = 34, 80, 131 (form 1): 2, 3, 4; L = 132, 250, 255
# (form 0): 5, 6, 7 (the times stand in forest_train.cu's design note).
OBLIVIOUS_FUSED_LEVELS = (((0.0, 5), (1.89, 6), (1.93, 7)),
                          ((0.0, 2), (2.42, 3), (3.96, 4)),
                          ((0.0, 0), (0.45, 3), (1.0, 4)))


def oblivious_form(lanes: int, n_feat: int, sms: int) -> int:
    """The form the fused oblivious search's launch takes on a card of
    ``sms`` SMs: 0, blocks of 32 features, where the lanes' blocks fill the
    SMs; else 1, blocks of 8 features; 2, the same in blocks of 1,024
    threads, where those do not fill the SMs either."""
    if lanes * -(-n_feat // OBLIVIOUS_GROUP) >= sms:
        return 0
    return 2 if lanes * -(-n_feat // (OBLIVIOUS_GROUP // 4)) <= sms else 1


def oblivious_fused_levels(lanes: int, n_feat: int, sms: int) -> int:
    """Levels from the root whose oblivious split search ``fit_forest_lanes``
    runs as the fused oblivious search on a card of ``sms`` SMs
    (``OBLIVIOUS_FUSED_LEVELS`` at the form's blocks a SM)."""
    form = oblivious_form(lanes, n_feat, sms)
    group = OBLIVIOUS_GROUP if form == 0 else OBLIVIOUS_GROUP // 4
    per_sm = lanes * -(-n_feat // group) / max(sms, 1)
    return [levels for start, levels in OBLIVIOUS_FUSED_LEVELS[form] if per_sm >= start][-1]


def level_splits_oblivious_lanes(xb: torch.Tensor, pos: torch.Tensor, g: torch.Tensor,
                                 h: torch.Tensor, n_nodes: int,
                                 bounds: Optional[torch.Tensor], col_mask: torch.Tensor,
                                 lam: torch.Tensor, min_child: float, *,
                                 parent: Optional[ParentSplit] = None,
                                 scratch: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One oblivious level's split search over lanes in one pass: the
    counterpart of ``_grow_level(..., oblivious=True)`` under ``jax.vmap``
    (``forest_tpu.py:135-146``, ``:154-231``). Inputs and outputs as
    ``level_splits_lanes``'s; each lane's split is one (feat, bin) for the
    whole level, written to every node, or (0, 63) where no gain summed
    over the nodes is finite and positive.

    On a CUDA tensor the kernel (``forest_level_splits_oblivious_lanes``)
    sorts each lane's rows by node (K3's sort, with ``parent`` routing the
    level before in place), and a block a (lane, group of 32 features, or of
    8 where the lanes are too few to fill the card) walks the nodes in
    order: each node's rows summed in K3's fixed point in shared memory, a
    warp lane a (row, feature), K4's gains of every bin added to a running
    total, K4's pick. Its result is
    ``best_splits_lanes(level_histogram_lanes(...), ..., oblivious=True)``
    on the same inputs, bit for bit, with no histogram in device memory.
    ``scratch``, optional: int64 [L · oblivious_plan(n, n_nodes)
    ["lane_words"]], the sort's plan and row order (``sorted_rows(...,
    oblivious=True)``). On a CPU tensor ``level_splits_lanes_reference``
    (oblivious) runs, after ``route_rows_reference`` with a parent split."""
    n, n_feat, lanes = _check_lane_level(xb, pos, g, h, n_nodes, col_mask, lam)
    route, tree_lane = _parent_args(parent, xb, pos, n_nodes)
    if not _kernel_device(xb, "forest_level_splits_oblivious_lanes"):
        return level_splits_lanes_reference(
            xb, _plain_positions(xb, pos, n_nodes, parent, True), g, h, n_nodes,
            col_mask, lam, min_child, oblivious=True)
    dev = xb.device
    feat, b, has_split, bounds = _lane_splits_out(lanes, n_nodes, g, h, bounds)
    if lanes == 0:
        return feat, b, has_split
    plan = oblivious_plan(n, n_nodes)
    stride = plan["lane_words"]
    scratch = _sort_scratch(scratch, lanes * stride, dev)
    base = scratch.data_ptr()
    # a (gain, index) candidate of each lane and group of features: 32 a
    # group, or 8 where the lanes' blocks would not fill the card
    cand = torch.empty(2 * lanes * -(-n_feat // 8), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = kernels_lib().bbbp_forest_level_splits_oblivious_lanes(
            xb.data_ptr(), n, n_feat, pos.data_ptr(), g.data_ptr(), h.data_ptr(),
            n_nodes, bounds.data_ptr(), col_mask.data_ptr(), lam.data_ptr(),
            float(min_child), base + 8 * plan["rows"], base + 8 * plan["plan"],
            cand.data_ptr(), feat.data_ptr(), b.data_ptr(), has_split.data_ptr(), *route,
            tree_lane, lanes, stride, torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "forest_level_splits_oblivious_lanes")
    level_splits_oblivious_lanes.launches.add(dev)
    return feat, b, has_split


def _with_next_gradients(leaves: torch.Tensor, preds: torch.Tensor,
                         next_tree: Optional[NextTree]):
    """``leaves`` alone, or with each lane's ``next_gradients_reference``
    of its updated margins: (leaves, g, h, bounds)."""
    if next_tree is None:
        return leaves
    nxt = [next_gradients_reference(pr, next_tree.y, u, sub, w, next_tree.task)
           for pr, u, sub, w in zip(preds, next_tree.u,
                                    _host_values(next_tree.subsample),
                                    next_tree.w_rows)]
    return (leaves, *(torch.stack(parts) for parts in zip(*nxt)))


def leaf_values_lanes_reference(pos, g, h, n_leaves: int, lam, scale,
                                preds: torch.Tensor,
                                next_tree: Optional[NextTree] = None):
    """``leaf_values_reference`` of each lane at its own lam and scale ([L]
    tensors or host floats; preds [L, n] updated in place) → leaf [L,
    n_leaves]; with ``next_tree`` also each lane's
    ``next_gradients_reference``: (leaf, g, h, bounds [L, 2])."""
    leaves = torch.stack([
        leaf_values_reference(p, gl, hl, n_leaves, lm, sc, pr)
        for p, gl, hl, lm, sc, pr in zip(pos, g, h, _host_values(lam),
                                         _host_values(scale), preds)])
    return _with_next_gradients(leaves, preds, next_tree)


def leaf_values_lanes_fixed_reference(pos, g, h, n_leaves: int, lam, scale,
                                      preds: torch.Tensor, bounds: torch.Tensor,
                                      next_tree: Optional[NextTree] = None):
    """``leaf_values_fixed_reference`` of each lane at its own bounds, lam
    and scale, and the next tree's gradients as in
    ``leaf_values_lanes_reference``: the lane kernel's bits."""
    leaves = torch.stack([
        leaf_values_fixed_reference(p, gl, hl, n_leaves, lm, sc, pr, bl)
        for p, gl, hl, lm, sc, pr, bl in zip(pos, g, h, _host_values(lam),
                                             _host_values(scale), preds, bounds)])
    return _with_next_gradients(leaves, preds, next_tree)


LEAF_SHAPES = {"auto": 0, "cluster": 1, "block": 2}     # the C entry's shape


def leaf_values_lanes(pos: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                      n_leaves: int, lam: torch.Tensor, scale: torch.Tensor,
                      preds: torch.Tensor, bounds: Optional[torch.Tensor] = None,
                      next_tree: Optional[NextTree] = None, *,
                      parent: Optional[ParentSplit] = None,
                      xb: Optional[torch.Tensor] = None, shape: str = "auto"):
    """K5 over lanes. pos int32, g, h, preds f32 [L, n] (preds updated in
    place); lam, scale f32 [L]; bounds f32 [L, 2] → leaf f32 [L, n_leaves].
    With ``next_tree`` (y [n], every lane's; u and w_rows [L, n]; subsample
    f32 [L]) it returns (leaf, g, h, bounds) of each lane's next boosted
    tree from the same launch. ``parent`` (with a lane axis) and ``xb`` as in
    ``leaf_values``. Lane l is ``leaf_values`` of lane l. On a CPU tensor
    ``leaf_values_lanes_reference`` runs.

    ``shape``: ``cluster`` launches a thread block cluster of
    ``leaf_plan(n)`` blocks a lane (the single fit's form), ``block`` one
    block a lane; ``auto`` takes the cluster form where one wave of the card
    holds every lane's cluster, else a block a lane. Both give the same
    bits."""
    if pos.dim() != 2:
        raise TypeError(f"pos must be [L, n], got {tuple(pos.shape)}")
    lanes, n = pos.shape
    dev = pos.device
    rows = [("pos", pos, torch.int32), ("g", g, torch.float32),
            ("h", h, torch.float32), ("preds", preds, torch.float32)]
    if next_tree is not None:
        if next_tree.task not in ("reg", "cls"):
            raise ValueError(f"task must be 'reg' or 'cls', got {next_tree.task!r}")
        rows += [("u", next_tree.u, torch.float32),
                 ("w_rows", next_tree.w_rows, torch.float32)]
        _check_rows("y", next_tree.y, torch.float32, (n,), dev)
        _check_rows("subsample", next_tree.subsample, torch.float32, (lanes,), dev)
    for name, t, dtype in rows:
        _check_rows(name, t, dtype, (lanes, n), dev)
    _check_rows("lam", lam, torch.float32, (lanes,), dev)
    _check_rows("scale", scale, torch.float32, (lanes,), dev)
    if not 1 <= n_leaves <= 1 << MAX_DEPTH:
        raise ValueError(f"n_leaves must be in [1, {1 << MAX_DEPTH}], got {n_leaves}")
    if shape not in LEAF_SHAPES:
        raise ValueError(f"shape must be one of {sorted(LEAF_SHAPES)}, got {shape!r}")
    xb_args = _leaf_rows(xb, parent, pos)
    route, tree_lane = _parent_args(parent, xb, pos, n_leaves)
    if not _kernel_device(pos, "forest_leaf_values_lanes"):
        return leaf_values_lanes_reference(
            _plain_positions(xb, pos, n_leaves, parent, False), g, h, n_leaves, lam,
            scale, preds, next_tree)
    if bounds is None:
        bounds = gradient_bounds(g, h)
    _check_rows("bounds", bounds, torch.float32, (lanes, 2), dev)
    leaf = torch.empty((lanes, n_leaves), dtype=torch.float32, device=dev)
    nxt = None
    if next_tree is not None:
        nxt = (torch.empty((lanes, n), dtype=torch.float32, device=dev),
               torch.empty((lanes, n), dtype=torch.float32, device=dev),
               torch.empty((lanes, 2), dtype=torch.float32, device=dev))
    if lanes == 0:
        return leaf if nxt is None else (leaf, *nxt)
    with torch.cuda.device(dev):
        rc = kernels_lib().bbbp_forest_leaf_values_lanes(
            pos.data_ptr(), n, g.data_ptr(), h.data_ptr(), n_leaves,
            lam.data_ptr(), scale.data_ptr(), bounds.data_ptr(), leaf.data_ptr(),
            preds.data_ptr(),
            *((None, None, None, None, 0) if next_tree is None else
              (next_tree.y.data_ptr(), next_tree.u.data_ptr(),
               next_tree.w_rows.data_ptr(), next_tree.subsample.data_ptr(),
               int(next_tree.task == "cls"))),
            *((None, None, None) if nxt is None else (t.data_ptr() for t in nxt)),
            leaf_plan(n), LEAF_SHAPES[shape], *xb_args, *route, tree_lane, lanes,
            torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "forest_leaf_values_lanes")
    leaf_values_lanes.launches.add(dev)
    return leaf if nxt is None else (leaf, *nxt)


level_histogram_lanes.launches = LaunchCounter()
best_splits_lanes.launches = LaunchCounter()
level_splits_lanes.launches = LaunchCounter()
level_splits_oblivious_lanes.launches = LaunchCounter()
leaf_values_lanes.launches = LaunchCounter()


# ---------------------------------------------------------------------------
# K9: the keyed draws of a tree, every lane's in one launch
# ---------------------------------------------------------------------------

DRAW_STREAMS = {"subsample": 0, "columns": 1, "poisson": 2}
DRAW_STREAM_WORDS = 4               # counter words a tree (kStreams in csrc/draws.cu)
_MASK32 = 0xFFFFFFFF
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32_reference(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                           x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds, JAX's generator, in torch int64 ops
    masked to 32 bits: the key (k0, k1) and the counter (x0, x1), int64
    tensors (or ints) of 32-bit values that broadcast together → both
    output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & _MASK32
    x1 = (x1 + k1) & _MASK32
    for group in range(5):
        for r in _THREEFRY_ROTATIONS[group % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK32) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & _MASK32
    return x0, x1


@functools.lru_cache(maxsize=1)
def poisson_thresholds() -> Tuple[int, ...]:
    """T_k = ⌊CDF(k) · 2^32⌋ of Poisson(1), computed once in float64, for
    every k whose T_k lies below 2^32 and above T_{k-1}: a 32-bit word w
    draws the count #{k : w ≥ T_k}, the inverse CDF of w / 2^32."""
    out: List[int] = []
    term, cdf, k = float(np.exp(-1.0)), 0.0, 0
    while True:
        cdf += term
        t = int(np.floor(cdf * 2.0 ** 32))
        if t >= 1 << 32 or (out and t == out[-1]):
            return tuple(out)
        out.append(t)
        k += 1
        term /= k


def draw_words_reference(seeds: torch.Tensor, tree: int, stream: str,
                         size: int) -> torch.Tensor:
    """The 32-bit words K9 draws, int64 [L, size]: Threefry-2x32 of the key
    (seed >> 32, seed & 0xffffffff) at the counter (tree · 4 + stream,
    index), its first word."""
    seeds = seeds.long()[:, None]
    k0, k1 = (seeds >> 32) & _MASK32, seeds & _MASK32
    x0 = (tree * DRAW_STREAM_WORDS + DRAW_STREAMS[stream]) & _MASK32
    x1 = torch.arange(size, dtype=torch.int64, device=seeds.device)[None, :]
    return threefry2x32_reference(k0, k1, x0, x1)[0]


def draws_from_words(words: torch.Tensor, stream: str) -> torch.Tensor:
    """f32 draws from 32-bit words: Poisson(1) counts (``poisson``,
    ``poisson_thresholds``), else uniforms (w >> 8) · 2^-24 in [0, 1)."""
    if stream == "poisson":
        t = torch.tensor(poisson_thresholds(), dtype=torch.int64, device=words.device)
        return (words[..., None] >= t).sum(-1).float()
    return (words >> 8).float() * 2.0 ** -24


def forest_draws_reference(seeds: torch.Tensor, tree: int, stream: str,
                           size: int) -> torch.Tensor:
    """K9's plain version: ``draws_from_words`` of ``draw_words_reference``,
    f32 [L, size]."""
    return draws_from_words(draw_words_reference(seeds, tree, stream, size), stream)


def forest_draws(seeds: torch.Tensor, tree: torch.Tensor, stream: str, size: int,
                 tree_offset: int = 0) -> torch.Tensor:
    """K9. seeds int64 [L], tree int64 [1] (the tree index, read on the
    device, so that a captured tree draws the tree the graph has reached),
    ``stream`` one of ``DRAW_STREAMS`` → f32 [L, size], the draws of tree
    tree[0] + ``tree_offset`` (``forest_tpu.py:303-320``, ``:356``): the
    subsample's and the columns' uniforms in [0, 1), rf's Poisson(1) row
    weights. Lane l's draws depend on seeds[l] alone. On a CPU tensor
    ``forest_draws_reference`` runs, with the same bits."""
    if stream not in DRAW_STREAMS:
        raise ValueError(f"stream must be one of {sorted(DRAW_STREAMS)}, got {stream!r}")
    if seeds.dim() != 1:
        raise TypeError(f"seeds must be [L], got {tuple(seeds.shape)}")
    lanes = seeds.shape[0]
    _check_rows("seeds", seeds, torch.int64, (lanes,), seeds.device)
    _check_rows("tree", tree, torch.int64, (1,), seeds.device)
    if size < 0:
        raise ValueError(f"size must be >= 0, got {size}")
    if not _kernel_device(seeds, "forest_draws"):
        return forest_draws_reference(seeds, int(tree[0]) + tree_offset, stream, size)
    out = torch.empty((lanes, size), dtype=torch.float32, device=seeds.device)
    thresholds = poisson_thresholds() if stream == "poisson" else ()
    table = (ctypes.c_uint32 * len(thresholds))(*thresholds) if thresholds else None
    with torch.cuda.device(seeds.device):
        rc = kernels_lib().bbbp_forest_draws(
            seeds.data_ptr(), lanes, tree.data_ptr(), int(tree_offset),
            DRAW_STREAMS[stream], size, table, len(thresholds), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "forest_draws")
    forest_draws.launches.add(seeds.device)
    return out


forest_draws.launches = LaunchCounter()


def seed_tensor(seeds, device: torch.device) -> torch.Tensor:
    """Seeds (ints) as int64 [L] on ``device``; a seed outside int64 raises."""
    seeds = [int(s) for s in seeds]
    if any(not -(1 << 63) <= s < 1 << 63 for s in seeds):
        raise ValueError(f"a seed must lie in int64, got {seeds}")
    return torch.tensor(seeds, dtype=torch.int64).to(device)


def column_mask(u: torch.Tensor, colsample) -> torch.Tensor:
    """A tree's column mask from its column draws u [..., F]: u < colsample
    (a float, or f32 [L, 1] over lanes), and at least one feature, the first
    drawn, else feature 0 (``forest_tpu.py:320-324``)."""
    mask = u < colsample
    first = mask.to(torch.uint8).argmax(dim=-1, keepdim=True)
    return mask | (torch.arange(u.shape[-1], device=u.device) == first)


# every counter of a kernel that a tree launches
TREE_KERNELS = (level_histogram, best_splits, leaf_values, level_histogram_lanes,
                best_splits_lanes, level_splits_lanes, level_splits_oblivious_lanes,
                leaf_values_lanes, forest_draws)


# each card's last captured tree: its memory pool is the next capture's
_TREE_GRAPHS: dict = {}
# False: every fit grows its trees eagerly, as with graph=False, however it
# was reached (``testing.eager_tree_loop`` sets it around an entry point)
REPLAY_TREES = True


def grow_trees(n_trees: int, tree: torch.Tensor, step, graph: bool) -> None:
    """Runs ``step`` ``n_trees`` times: one tree, which reads its index
    from ``tree`` [1] and advances it, keeping every tensor that the next
    tree reads at its address (the counterpart of ``jax.lax.scan`` over the
    trees, ``forest_tpu.py:359``).

    On a CUDA tensor with ``graph``: tree 0 eagerly (it also makes each
    kernel's one-time settings: the library, shared-memory limits, the
    card's wave sizes), then one tree captured into a CUDA graph and
    replayed for the rest, one host call a tree. Every fit's capture shares
    one memory pool a card, the last fit's graph's (kept in
    ``_TREE_GRAPHS``): a fit replays its graph to its end before the next
    fit captures, so a capture takes the blocks the last one freed, where a
    pool a fit would leave one more pool of freed blocks behind each fit.
    Fits on one card therefore do not run in two threads at once. Capturing
    launches nothing, so the launch counters take back what the capture
    added, and each replay adds its tree's launches. A capture or replay that fails
    raises; the fit synchronises once at the end, so that a fault of a
    replayed kernel raises here. Otherwise (the CPU, ``graph=False`` or
    ``REPLAY_TREES`` false) every tree runs eagerly."""
    if n_trees <= 0:
        return
    step()
    if n_trees == 1:
        return
    if tree.device.type != "cuda" or not (graph and REPLAY_TREES):
        for _ in range(n_trees - 1):
            step()
        return
    dev = tree.device
    before = [c.launches.count for c in TREE_KERNELS]
    cuda_graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    card = dev.index if dev.index is not None else torch.cuda.current_device()
    last = _TREE_GRAPHS.get(card)
    with torch.cuda.stream(side):
        cuda_graph.capture_begin(pool=None if last is None else last.pool(),
                                 capture_error_mode="thread_local")
        try:
            step()
        finally:
            cuda_graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    _TREE_GRAPHS[card] = cuda_graph
    per_tree = []
    for c, count in zip(TREE_KERNELS, before):
        added = c.launches.count - count
        c.launches.add(dev, -added)
        if added:
            per_tree.append((c.launches, added))
    for _ in range(n_trees - 1):
        cuda_graph.replay()
        for counter, added in per_tree:
            counter.add(dev, added)
    torch.cuda.synchronize(dev)


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
               n_bins: Optional[torch.Tensor] = None, graph: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Boosting (``task`` ``reg`` or ``cls``) or bagging (``rf``) on the
    device of ``xb`` [n, F] uint8, the counterpart of ``_fit_forest_device``
    and ``fit_forest_launched``. ``edge_vals`` [F, 64] f32, ``y`` [n] f32,
    ``row_w`` an optional [n] weight (rows of weight 0 contribute nothing),
    ``preds0`` an optional starting margin, ``n_bins`` the optional uint8
    [F] occupied bins of each feature for K3 (``BinMapper.bin_counts``; it
    is checked against ``xb`` here, once; the trees do not depend on it).
    Returns (preds [n], feats [T, 2^D − 1] int32, thrs [T, 2^D − 1] f32,
    leaves [T, 2^D] f32), all on the device; random forests accumulate
    unscaled leaves in preds.

    A tree is K9's draws (rf's weights, the columns, the next tree's
    subsample), K3 then K4 a level, each routing the level before, and K5,
    which routes the last level and gives the next boosted tree's gradients.
    Its draws are keyed by (``seed``, tree, stream), so the same fit draws
    the same numbers on the card and on the CPU. On the card the trees after
    the first replay one CUDA graph of a tree (``grow_trees``); ``graph=False``
    runs them eagerly, for comparison. Nothing is copied to the host."""
    if task not in ("reg", "cls"):
        raise ValueError(f"task must be 'reg' or 'cls', got {task!r}")
    if not 0 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth must be in [0, {MAX_DEPTH}], got {depth}")
    dev = xb.device
    n, n_feat = xb.shape
    if n_bins is not None:
        check_bin_counts(n_bins, xb)
    n_internal, n_leaves = (1 << depth) - 1, 1 << depth
    y = y.to(dev, torch.float32).contiguous()
    w_rows = (torch.ones(n, device=dev) if row_w is None
              else row_w.to(dev, torch.float32))
    preds = (torch.full((n,), float(base_score), dtype=torch.float32, device=dev)
             if preds0 is None else preds0.to(dev, torch.float32).clone())
    seeds = seed_tensor([seed], dev)
    tree = torch.zeros(1, dtype=torch.int64, device=dev)
    feats = torch.zeros((n_trees, n_internal), dtype=torch.int32, device=dev)
    bins = torch.zeros((n_trees, n_internal), dtype=torch.int32, device=dev)
    leaves = torch.empty((n_trees, n_leaves), dtype=torch.float32, device=dev)
    # the tree's own flat arrays, which the routing writes, copied into
    # feats[tree] and bins[tree] at its end
    tree_feats = torch.zeros((1, n_internal), dtype=torch.int32, device=dev)
    tree_bins = torch.zeros((1, n_internal), dtype=torch.int32, device=dev)
    scale = 1.0 if rf else float(lr)
    if not rf and n_trees:                      # later trees' come from K5
        g, h, bounds = next_gradients_reference(
            preds, y, forest_draws(seeds, tree, "subsample", n)[0], subsample,
            w_rows, task)
    # every level routes its parent's positions as it reads them, and
    # levels 0 and 1 read none: pos is never reset
    pos = torch.empty(n, dtype=torch.int32, device=dev)

    def step() -> None:
        if rf:
            w = forest_draws(seeds, tree, "poisson", n)[0] * w_rows
            g_t, h_t = -y * w, w
            b_t = gradient_bounds(g_t, h_t)
        else:
            g_t, h_t, b_t = g, h, bounds
        col_mask = column_mask(forest_draws(seeds, tree, "columns", n_feat)[0], colsample)
        parent = None
        for level in range(depth):
            hist = level_histogram(xb, pos, g_t, h_t, 1 << level, b_t, n_bins,
                                   bins_checked=True, parent=parent)
            f_l, b_l, _ = best_splits(hist, col_mask, lam, min_child, oblivious)
            parent = ParentSplit(f_l, b_l, tree_feats, tree_bins, 0, level)
        nxt = None if rf else NextTree(
            y, forest_draws(seeds, tree, "subsample", n, tree_offset=1)[0], subsample,
            w_rows, task)
        out = leaf_values(pos, g_t, h_t, n_leaves, lam, scale, preds, b_t, nxt,
                          parent=parent, xb=xb)
        if nxt is None:
            leaf = out
        else:                                   # the next tree's, at the same address
            leaf, g_n, h_n, b_n = out
            g.copy_(g_n)
            h.copy_(h_n)
            bounds.copy_(b_n)
        feats.index_copy_(0, tree, tree_feats)
        bins.index_copy_(0, tree, tree_bins)
        leaves.index_copy_(0, tree, leaf[None])
        tree.add_(1)

    grow_trees(n_trees, tree, step, graph)
    thrs = edge_vals[feats.long(), bins.long()]
    return preds, feats, thrs, leaves


def _per_lane(value, lanes: int, device: torch.device) -> torch.Tensor:
    """A scalar or [L] sequence as f32 [L] on ``device``."""
    t = torch.as_tensor(value, dtype=torch.float32)
    if t.dim() == 0:
        t = t.expand(lanes)
    if t.shape != (lanes,):
        raise ValueError(f"a lane parameter must be a scalar or [{lanes}], got "
                         f"{tuple(t.shape)}")
    return t.contiguous().to(device)


def lane_bytes(n: int, n_feat: int, depth: int, n_trees: int,
               oblivious: bool = False) -> int:
    """Device bytes one lane of ``fit_forest_lanes`` holds at its deepest
    level: its split search's scratch and candidates (per node: K3's scratch
    and 8 bytes a node and group of 8 features; oblivious: the fused
    search's sort scratch and at most 8 bytes a feature, and, where a form
    gives that level to K3 then K4 with lanes (``OBLIVIOUS_FUSED_LEVELS``),
    K3's scratch and the [nodes, F, 64, 2] histogram between them), the
    rows' [n] arrays (positions, margins, gradients, draws, weights, the
    next tree's) and the trees."""
    nodes = 1 << max(depth - 1, 0)
    internal, leaves = (1 << depth) - 1, 1 << depth
    if oblivious:
        search = 8 * oblivious_plan(n, nodes)["lane_words"] + 8 * n_feat
        if depth > min(lv for form in OBLIVIOUS_FUSED_LEVELS for _, lv in form):
            search += 8 * lane_words(n, n_feat, nodes) + nodes * n_feat * MAX_BINS * 8
    else:
        search = 8 * lane_words(n, n_feat, nodes) + nodes * -(-n_feat // SPLIT_GROUP) * 8
    return search + 4 * 12 * n + n_trees * (12 * internal + 4 * leaves)


def fit_forest_lanes(xb: torch.Tensor, edge_vals: torch.Tensor, y: torch.Tensor,
                     *, lr, lam, subsample, colsample, seeds, row_w: torch.Tensor,
                     base_score: float, task: str, n_trees: int, depth: int,
                     oblivious: bool, rf: bool, min_child: float = 1.0,
                     n_bins: Optional[torch.Tensor] = None, graph: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """L fits of one shape at once, the counterpart of ``_fit_forest_device``
    under ``jax.vmap`` (``batched_search.py:340-344``): xb uint8 [n, F],
    ``edge_vals`` and ``y`` [n] every lane's; ``lr``, ``lam``,
    ``subsample``, ``colsample`` a scalar or [L] each; ``seeds`` [L] ints;
    ``row_w`` [L, n] (rows of weight 0 contribute nothing; their margins
    still move along the trees); the statics and ``graph`` as
    ``fit_forest``'s. Returns (preds [L, n], feats [L, T, 2^D − 1] int32,
    thrs [L, T, 2^D − 1] f32, leaves [L, T, 2^D] f32).

    A tree's draws are one K9 launch a stream for every lane, keyed by the
    lane's seed, so lane l grows the trees, leaves and margins of
    ``fit_forest`` with ``seeds[l]`` and lane l's parameters bit for bit,
    whatever the lanes and their order: each tree level is one call of a
    fused split search over all lanes (``level_splits_lanes``, or
    ``level_splits_oblivious_lanes`` at an oblivious tree's first
    ``oblivious_fused_levels`` levels, K3 then K4 with lanes past them),
    which routes the level before, and each tree one of K5, which routes the
    last. On the card the trees after
    the first replay one CUDA graph of a tree."""
    if task not in ("reg", "cls"):
        raise ValueError(f"task must be 'reg' or 'cls', got {task!r}")
    if not 0 <= depth <= MAX_DEPTH:
        raise ValueError(f"depth must be in [0, {MAX_DEPTH}], got {depth}")
    dev = xb.device
    n, n_feat = xb.shape
    lanes = len(seeds)
    if n_bins is not None:
        check_bin_counts(n_bins, xb)
    lr, lam, subsample, colsample = (_per_lane(v, lanes, dev)
                                     for v in (lr, lam, subsample, colsample))
    n_internal, n_leaves = (1 << depth) - 1, 1 << depth
    y = y.to(dev, torch.float32).contiguous()
    w_rows = row_w.to(dev, torch.float32).contiguous()
    if w_rows.shape != (lanes, n):
        raise ValueError(f"row_w must be [{lanes}, {n}], got {tuple(w_rows.shape)}")
    preds = torch.full((lanes, n), float(base_score), dtype=torch.float32, device=dev)
    seed_t = seed_tensor(seeds, dev)
    tree = torch.zeros(1, dtype=torch.int64, device=dev)
    feats = torch.zeros((lanes, n_trees, n_internal), dtype=torch.int32, device=dev)
    bins = torch.zeros((lanes, n_trees, n_internal), dtype=torch.int32, device=dev)
    leaves = torch.empty((lanes, n_trees, n_leaves), dtype=torch.float32, device=dev)
    tree_feats = torch.zeros((lanes, 1, n_internal), dtype=torch.int32, device=dev)
    tree_bins = torch.zeros((lanes, 1, n_internal), dtype=torch.int32, device=dev)
    scale = torch.ones(lanes, device=dev) if rf else lr
    pos = torch.empty((lanes, n), dtype=torch.int32, device=dev)   # as fit_forest's
    # a CPU counts no SMs (the first form's levels): both ways run the plain
    # versions there
    fused_levels = oblivious_fused_levels(
        lanes, n_feat,
        torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda"
        else 0)
    if not rf and n_trees:                      # later trees' come from K5
        g, h, bounds = next_gradients_reference(
            preds, y, forest_draws(seed_t, tree, "subsample", n), subsample[:, None],
            w_rows, task)

    def step() -> None:
        if rf:
            w = forest_draws(seed_t, tree, "poisson", n) * w_rows
            g_t, h_t = -y * w, w
            b_t = gradient_bounds(g_t, h_t)
        else:
            g_t, h_t, b_t = g, h, bounds
        col_mask = column_mask(forest_draws(seed_t, tree, "columns", n_feat),
                               colsample[:, None])
        parent = None
        for level in range(depth):
            if oblivious and level < fused_levels:   # a level's gain sums over its nodes
                f_l, b_l, _ = level_splits_oblivious_lanes(
                    xb, pos, g_t, h_t, 1 << level, b_t, col_mask, lam, min_child,
                    parent=parent)
            elif oblivious:
                hist = level_histogram_lanes(xb, pos, g_t, h_t, 1 << level, b_t,
                                             n_bins, bins_checked=True, parent=parent)
                f_l, b_l, _ = best_splits_lanes(hist, col_mask, lam, min_child, True)
            else:
                f_l, b_l, _ = level_splits_lanes(xb, pos, g_t, h_t, 1 << level, b_t,
                                                 col_mask, lam, min_child, n_bins,
                                                 bins_checked=True, parent=parent)
            parent = ParentSplit(f_l, b_l, tree_feats, tree_bins, 0, level)
        nxt = None if rf else NextTree(
            y, forest_draws(seed_t, tree, "subsample", n, tree_offset=1), subsample,
            w_rows, task)
        out = leaf_values_lanes(pos, g_t, h_t, n_leaves, lam, scale, preds, b_t, nxt,
                                parent=parent, xb=xb)
        if nxt is None:
            leaf = out
        else:                                   # the next tree's, at the same address
            leaf, g_n, h_n, b_n = out
            g.copy_(g_n)
            h.copy_(h_n)
            bounds.copy_(b_n)
        feats.index_copy_(1, tree, tree_feats)
        bins.index_copy_(1, tree, tree_bins)
        leaves.index_copy_(1, tree, leaf[:, None])
        tree.add_(1)

    grow_trees(n_trees, tree, step, graph)
    thrs = edge_vals[feats.long(), bins.long()]
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
