"""Forest inference over the implicit full-binary tree layout.

Counterpart of ``bbbp_tpu/ops/forest_tpu.py::DenseTreeEnsemble`` inference.
Level l of each tree holds its internal nodes at flat [2^l − 1, 2^(l+1) − 1);
a row goes right iff ``x[feat] > thr`` in exact f32 (thresholds are data
values, so lower precision would flip decisions), and dead branches carry
``thr = +inf``, which always goes left.

``raw_predict`` launches the CUDA kernel ``csrc/dense_forest.cu`` on a CUDA
tensor and runs the plain gather traversal ``dense_predict_reference`` on a
CPU tensor. The TPU's gather-free "route" form is not carried over: it
exists only because gathers are slow on the TPU. The kernel reads the trees
as records (``pack_tree_records``), which the ensemble builds once from
``feat``/``thr``/``leaf``; those three stay its public fields and the pickle's.

``dense_to_tree_arrays`` turns the layout into explicit trees
(``_TreeArrays``, the JAX package's host-tree record) for exact TreeSHAP
(``reporting/attribution.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Union

import numpy as np
import torch

from bbbp_tpu_torch._build import LaunchCounter, check_launch, kernels_lib

MAX_DEPTH = 12


def pack_tree_records(feat: torch.Tensor, thr: torch.Tensor,
                      leaf: torch.Tensor, depth: int) -> torch.Tensor:
    """[T, R] int32 records, the kernel's layout, R = round_up(3·2^D, 4):
    internal node i is the pair (thr bits, feat) at words 2i, 2i+1, the pair
    slot 2^D − 1 is padding, and leaf p is word 2·2^D + p. A record is a
    multiple of 16 bytes, so whole trees copy in 16-byte pieces."""
    n_trees, n_leaves = feat.shape[0], 1 << depth
    width = -(-3 * n_leaves // 4) * 4
    rec = torch.zeros((n_trees, width), dtype=torch.int32, device=feat.device)
    nodes = rec[:, :2 * n_leaves].view(n_trees, n_leaves, 2)
    nodes[:, :n_leaves - 1, 0] = thr.view(torch.int32)
    nodes[:, :n_leaves - 1, 1] = feat
    rec[:, 2 * n_leaves:3 * n_leaves] = leaf.view(torch.int32)
    return rec


@dataclass
class DenseTreeEnsemble:
    """Implicit-layout forest, validated when it is built: ``feat`` must lie
    in [0, F) for the F columns it is applied to, which ``raw_predict``
    checks from ``min_features`` without reading the device."""

    feat: torch.Tensor    # [T, 2^D - 1] int32
    thr: torch.Tensor     # [T, 2^D - 1] f32 — go right iff x[feat] > thr
    leaf: torch.Tensor    # [T, 2^D] f32
    depth: int
    base_score: float
    tree_scale: float
    min_features: int = field(init=False)
    records: torch.Tensor = field(init=False, repr=False)   # pack_tree_records

    def __post_init__(self) -> None:
        if not 0 <= self.depth <= MAX_DEPTH:
            raise ValueError(f"depth must be in [0, {MAX_DEPTH}], got {self.depth}")
        n_trees, n_internal = self.feat.shape[0], (1 << self.depth) - 1
        for name, t, dtype, width in (
                ("feat", self.feat, torch.int32, n_internal),
                ("thr", self.thr, torch.float32, n_internal),
                ("leaf", self.leaf, torch.float32, n_internal + 1)):
            if t.dtype != dtype or tuple(t.shape) != (n_trees, width):
                raise ValueError(f"{name} must be {dtype} [{n_trees}, {width}], "
                                 f"got {t.dtype} {tuple(t.shape)}")
            if not t.is_contiguous() or t.device != self.feat.device:
                raise ValueError(f"{name} must be contiguous, on {self.feat.device}")
        if self.feat.numel() and int(self.feat.min()) < 0:
            raise ValueError("tree features must be >= 0")
        self.min_features = int(self.feat.max()) + 1 if self.feat.numel() else 0
        self.base_score = float(self.base_score)
        self.tree_scale = float(self.tree_scale)
        self.records = pack_tree_records(self.feat, self.thr, self.leaf,
                                         self.depth)

    @property
    def device(self) -> torch.device:
        return self.feat.device

    def to(self, device: Union[str, torch.device]) -> "DenseTreeEnsemble":
        return DenseTreeEnsemble(self.feat.to(device), self.thr.to(device),
                                 self.leaf.to(device), self.depth,
                                 self.base_score, self.tree_scale)

    @staticmethod
    def from_state(e: dict) -> "DenseTreeEnsemble":
        """From the ``ensemble`` dict of a screening pickle (numpy arrays)."""
        return DenseTreeEnsemble(
            torch.from_numpy(np.array(e["feat"], np.int32, order="C")),
            torch.from_numpy(np.array(e["thr"], np.float32, order="C")),
            torch.from_numpy(np.array(e["leaf"], np.float32, order="C")),
            int(e["depth"]), float(e["base_score"]), float(e["tree_scale"]))

    def to_state(self) -> dict:
        return {"feat": self.feat.cpu().numpy(), "thr": self.thr.cpu().numpy(),
                "leaf": self.leaf.cpu().numpy(), "depth": self.depth,
                "base_score": self.base_score, "tree_scale": self.tree_scale}


def dense_predict_reference(feat: torch.Tensor, thr: torch.Tensor,
                            leaf: torch.Tensor, x: torch.Tensor, depth: int,
                            base_score: float, tree_scale: float) -> torch.Tensor:
    """Plain gather traversal (``forest_tpu.py::_dense_predict``): margins [N]."""
    n, n_trees = x.shape[0], feat.shape[0]
    pos = torch.zeros((n, n_trees), dtype=torch.int64, device=x.device)
    t_idx = torch.arange(n_trees, device=x.device)[None, :]
    for level in range(depth):
        flat = (1 << level) - 1 + pos
        xv = torch.gather(x, 1, feat[t_idx, flat].long())
        pos = 2 * pos + (xv > thr[t_idx, flat]).long()
    return base_score + tree_scale * leaf[t_idx, pos].sum(dim=1)


def raw_predict(ens: DenseTreeEnsemble, x: torch.Tensor,
                apply_sigmoid: bool = False) -> torch.Tensor:
    """x [N, F] f32 → margins [N] f32, or probabilities with ``apply_sigmoid``.

    On a CUDA tensor this launches the kernel on the current stream, without
    synchronising; on a CPU tensor it runs ``dense_predict_reference``."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"x must be a 2-D float32 tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    n, n_feat = x.shape
    if n_feat < ens.min_features:
        raise ValueError(f"x has {n_feat} columns; the trees read column "
                         f"{ens.min_features - 1}")
    if x.device != ens.device:
        raise ValueError(f"x is on {x.device}, the ensemble on {ens.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type == "cpu":
        m = dense_predict_reference(ens.feat, ens.thr, ens.leaf, x, ens.depth,
                                    ens.base_score, ens.tree_scale)
        return torch.sigmoid(m) if apply_sigmoid else m
    if x.device.type != "cuda":
        raise ValueError(f"no dense_forest_predict kernel for {x.device}")
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        rc = kernels_lib().bbbp_dense_forest_predict(
            x.data_ptr(), n, n_feat, ens.records.data_ptr(),
            ens.records.shape[0], ens.depth, ens.base_score, ens.tree_scale,
            int(apply_sigmoid), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "dense_forest_predict")
    raw_predict.launches.add(x.device)
    return out


raw_predict.launches = LaunchCounter()


@dataclass
class _TreeArrays:
    """One explicit tree (``bbbp_tpu/ops/forest.py::_TreeArrays``)."""

    feature: np.ndarray    # [nodes] int32, -1 = leaf
    threshold: np.ndarray  # [nodes] float32 (x <= t goes left)
    left: np.ndarray       # [nodes] int32
    right: np.ndarray      # [nodes] int32
    value: np.ndarray      # [nodes] float32 (valid at leaves)
    cover: np.ndarray      # [nodes] float32 (sum of hessians; for TreeSHAP)


def dense_to_tree_arrays(ens: DenseTreeEnsemble, background: np.ndarray):
    """Convert the implicit layout to explicit _TreeArrays (for exact
    TreeSHAP), as ``bbbp_tpu/ops/forest_tpu.py::dense_to_tree_arrays``. Node
    cover comes from routing a background sample through each tree
    (interventional-style weighting; the dense layout stores no training
    hessian mass). Dead branches keep ``thr = +inf`` and go left."""
    feat = ens.feat.cpu().numpy()
    thr = ens.thr.cpu().numpy()
    leaf = ens.leaf.cpu().numpy()
    T = feat.shape[0]
    D = ens.depth
    bg = np.asarray(background, np.float32)
    trees = []
    n_internal = (1 << D) - 1
    n_total = n_internal + (1 << D)
    for t in range(T):
        feature = np.full(n_total, -1, np.int32)
        threshold = np.zeros(n_total, np.float32)
        left = np.full(n_total, -1, np.int32)
        right = np.full(n_total, -1, np.int32)
        value = np.zeros(n_total, np.float32)
        # implicit flat index: internal node i at level l occupies 2^l-1+pos;
        # leaves come after all internals
        feature[:n_internal] = feat[t]
        threshold[:n_internal] = thr[t]
        for i in range(n_internal):
            l = int(np.floor(np.log2(i + 1)))
            pos = i - ((1 << l) - 1)
            if l + 1 < D:
                child_base = (1 << (l + 1)) - 1
                left[i] = child_base + 2 * pos
                right[i] = child_base + 2 * pos + 1
            else:
                left[i] = n_internal + 2 * pos
                right[i] = n_internal + 2 * pos + 1
        value[n_internal:] = leaf[t]
        # cover by routing the background
        counts = np.zeros(n_total, np.float64)
        node = np.zeros(len(bg), np.int64)
        counts[0] = len(bg)
        for l in range(D):
            f = feature[node]
            go_left = bg[np.arange(len(bg)), np.maximum(f, 0)] <= threshold[node]
            node = np.where(go_left, left[node], right[node])
            np.add.at(counts, node, 1)
        trees.append(_TreeArrays(feature, threshold, left, right, value,
                                 np.maximum(counts, 1e-6).astype(np.float32)))
    return trees
