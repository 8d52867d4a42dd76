"""Isolation forest outlier detection: a copy of ``bbbp_tpu/ops/outliers.py``
(numpy; the trees are built and scored on the host).

Replaces ``sklearn.ensemble.IsolationForest(contamination=0.05)``
(reference: Descriptors/multi_input_data_preprocess_maccs_opt_IsolationForest_fixed_1.py:128-134).
Standard iForest: random split trees on subsamples; anomaly score
2^(-E[h(x)]/c(n)); labels +1 inlier / -1 outlier at the contamination
quantile, matching sklearn's ``fit_predict`` contract.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


def _c_factor(n: int) -> float:
    if n <= 1:
        return 0.0
    h = np.log(n - 1) + 0.5772156649
    return 2.0 * h - 2.0 * (n - 1) / n


@dataclass
class _Tree:
    feature: np.ndarray   # [nodes] int32, -1 = leaf
    threshold: np.ndarray  # [nodes] float32
    left: np.ndarray       # [nodes] int32
    right: np.ndarray
    size: np.ndarray       # [nodes] samples reaching node (for leaf depth adj.)
    depth: np.ndarray


class IsolationForest:
    def __init__(self, n_estimators: int = 100, max_samples: int = 256,
                 contamination: float = 0.05, seed: int = 0):
        self.n_estimators = n_estimators
        self.max_samples = max_samples
        self.contamination = contamination
        self.seed = seed
        self.trees: List[_Tree] = []
        self.offset_: Optional[float] = None

    def fit(self, x: np.ndarray) -> "IsolationForest":
        x = np.asarray(x, dtype=np.float32)
        rng = np.random.default_rng(self.seed)
        n = len(x)
        sub = min(self.max_samples, n)
        max_depth = int(np.ceil(np.log2(max(sub, 2))))
        self.trees = []
        self._sub = sub
        for _ in range(self.n_estimators):
            idx = rng.choice(n, size=sub, replace=False)
            self.trees.append(self._build(x[idx], rng, max_depth))
        scores = self.score_samples(x)
        self.offset_ = float(np.quantile(scores, 1.0 - self.contamination))
        return self

    def _build(self, x: np.ndarray, rng, max_depth: int) -> _Tree:
        feats, thrs, lefts, rights, sizes, depths = [], [], [], [], [], []

        def grow(rows: np.ndarray, depth: int) -> int:
            node = len(feats)
            feats.append(-1)
            thrs.append(0.0)
            lefts.append(-1)
            rights.append(-1)
            sizes.append(len(rows))
            depths.append(depth)
            if depth >= max_depth or len(rows) <= 1:
                return node
            span = x[rows].max(0) - x[rows].min(0)
            candidates = np.nonzero(span > 1e-12)[0]
            if len(candidates) == 0:
                return node
            f = int(rng.choice(candidates))
            lo, hi = x[rows, f].min(), x[rows, f].max()
            t = float(rng.uniform(lo, hi))
            mask = x[rows, f] < t
            if mask.all() or (~mask).all():
                return node
            feats[node] = f
            thrs[node] = t
            lefts[node] = grow(rows[mask], depth + 1)
            rights[node] = grow(rows[~mask], depth + 1)
            return node

        grow(np.arange(len(x)), 0)
        return _Tree(
            np.asarray(feats, np.int32), np.asarray(thrs, np.float32),
            np.asarray(lefts, np.int32), np.asarray(rights, np.int32),
            np.asarray(sizes, np.int32), np.asarray(depths, np.int32),
        )

    def _path_lengths(self, tree: _Tree, x: np.ndarray) -> np.ndarray:
        n = len(x)
        node = np.zeros(n, dtype=np.int32)
        active = tree.feature[node] >= 0
        while active.any():
            f = tree.feature[node[active]]
            t = tree.threshold[node[active]]
            go_left = x[active, f] < t
            nxt = np.where(go_left, tree.left[node[active]], tree.right[node[active]])
            node[active] = nxt
            active = tree.feature[node] >= 0
        return tree.depth[node] + np.array([_c_factor(s) for s in tree.size[node]])

    def score_samples(self, x: np.ndarray) -> np.ndarray:
        """Anomaly score in (0,1]; higher = more anomalous."""
        x = np.asarray(x, dtype=np.float32)
        depths = np.stack([self._path_lengths(t, x) for t in self.trees])
        e_h = depths.mean(0)
        return np.power(2.0, -e_h / max(_c_factor(self._sub), 1e-9))

    def fit_predict(self, x: np.ndarray) -> np.ndarray:
        """+1 inlier / -1 outlier (sklearn contract; reference keeps this as
        an ``Outliers`` column, ..._fixed_1.py:128-134)."""
        self.fit(x)
        scores = self.score_samples(np.asarray(x, dtype=np.float32))
        return np.where(scores > self.offset_, -1, 1).astype(np.int32)

    def predict(self, x: np.ndarray) -> np.ndarray:
        scores = self.score_samples(np.asarray(x, dtype=np.float32))
        return np.where(scores > self.offset_, -1, 1).astype(np.int32)
