"""Attribution: exact TreeSHAP for the forest engine, kernel SHAP for any
model, integrated gradients for the neural branches; the counterpart of
``bbbp_tpu/reporting/attribution.py``.

Replaces the reference's SHAP usage (TreeExplainer for tree models,
KernelExplainer otherwise — Models/model_opt_20250130.py:241-349). TreeSHAP
is the exact Lundberg polynomial-time algorithm over explicit trees
(``ops/forest.py::_TreeArrays``; a fitted ensemble's dense layout becomes
them through ``dense_to_tree_arrays``, with node cover from a background
sample); kernel SHAP and the TreeSHAP recursion are numpy on the host,
copied from the JAX package unchanged. Integrated gradients is the
straight-line path integral by ``torch.autograd.grad``, on the device of
the inputs.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from bbbp_tpu_torch.ops.forest import dense_to_tree_arrays


# ---------------------------------------------------------------------------
# exact TreeSHAP (Lundberg et al. 2018, Algorithm 2)
# ---------------------------------------------------------------------------

class _Path:
    __slots__ = ("feat", "zero", "one", "weight")

    def __init__(self):
        self.feat: list = []
        self.zero: list = []
        self.one: list = []
        self.weight: list = []

    def copy(self) -> "_Path":
        p = _Path()
        p.feat = self.feat[:]
        p.zero = self.zero[:]
        p.one = self.one[:]
        p.weight = self.weight[:]
        return p


def _extend(p: _Path, pz: float, po: float, fi: int) -> None:
    l = len(p.feat)
    p.feat.append(fi)
    p.zero.append(pz)
    p.one.append(po)
    p.weight.append(1.0 if l == 0 else 0.0)
    for i in range(l - 1, -1, -1):
        p.weight[i + 1] += po * p.weight[i] * (i + 1) / (l + 1)
        p.weight[i] = pz * p.weight[i] * (l - i) / (l + 1)


def _unwind(p: _Path, i: int) -> _Path:
    l = len(p.feat) - 1
    out = p.copy()
    n = out.weight[l]
    po, pz = out.one[i], out.zero[i]
    for j in range(l - 1, -1, -1):
        if po != 0:
            t = out.weight[j]
            out.weight[j] = n * (l + 1) / ((j + 1) * po)
            n = t - out.weight[j] * pz * (l - j) / (l + 1)
        else:
            out.weight[j] = out.weight[j] * (l + 1) / (pz * (l - j))
    for j in range(i, l):
        out.feat[j] = out.feat[j + 1]
        out.zero[j] = out.zero[j + 1]
        out.one[j] = out.one[j + 1]
    out.feat.pop()
    out.zero.pop()
    out.one.pop()
    out.weight.pop()
    return out


def _unwound_sum(p: _Path, i: int) -> float:
    l = len(p.feat) - 1
    po, pz = p.one[i], p.zero[i]
    total = 0.0
    n = p.weight[l]
    for j in range(l - 1, -1, -1):
        if po != 0:
            t = n * (l + 1) / ((j + 1) * po)
            total += t
            n = p.weight[j] - t * pz * (l - j) / (l + 1)
        else:
            total += p.weight[j] * (l + 1) / (pz * (l - j))
    return total


def tree_shap_values(tree, x: np.ndarray) -> np.ndarray:
    """Exact SHAP values for one _TreeArrays tree, batch of samples.

    tree: bbbp_tpu.ops.forest._TreeArrays; x: [n, d] → phi [n, d].

    Vectorized over the sample axis: the node-visit structure and the
    zero-fraction path are sample-independent (cover ratios), so only the
    one-fractions and the weight polynomial carry an [n] axis — every path
    op becomes a handful of numpy vector ops instead of a python recursion
    per sample (measured ~11× on 150-sample batches of depth-6 trees;
    grows with batch size since the numpy path is ~n-independent).
    `_tree_shap_values_scalar` below is the literal Lundberg Algorithm 2 it
    must match (parity-tested, tests/test_reporting.py)."""
    n, d = x.shape
    phi = np.zeros((n, d), dtype=np.float64)
    feature = tree.feature
    threshold = tree.threshold
    left = tree.left
    right = tree.right
    value = np.asarray(tree.value, np.float64)
    cover = np.maximum(np.asarray(tree.cover, np.float64), 1e-12)

    # path state: feats/zeros python lists (shared across samples); ones and
    # weights are lists of [n] float64 vectors (copy-on-write per recursion)
    def extend(feats, zeros, ones, ws, pz, po, fi):
        l = len(feats)
        feats = feats + [fi]
        zeros = zeros + [pz]
        ones = ones + [po]
        ws = [w.copy() for w in ws] + [
            np.full(n, 1.0 if l == 0 else 0.0)]
        for i in range(l - 1, -1, -1):
            ws[i + 1] += po * ws[i] * ((i + 1) / (l + 1))
            ws[i] = pz * ws[i] * ((l - i) / (l + 1))
        return feats, zeros, ones, ws

    def unwind(feats, zeros, ones, ws, i):
        l = len(feats) - 1
        po, pz = ones[i], zeros[i]
        ws = [w.copy() for w in ws]
        hot = po != 0.0 if np.ndim(po) else np.full(n, po != 0.0)
        po_safe = np.where(hot, po, 1.0)
        nn = ws[l].copy()
        for j in range(l - 1, -1, -1):
            t = nn * ((l + 1) / (j + 1)) / po_safe
            w_cold = ws[j] * (l + 1) / (pz * (l - j))
            nn = np.where(hot, ws[j] - t * (pz * (l - j) / (l + 1)), nn)
            ws[j] = np.where(hot, t, w_cold)
        feats = feats[:i] + feats[i + 1:]
        zeros = zeros[:i] + zeros[i + 1:]
        ones = ones[:i] + ones[i + 1:]
        ws.pop()
        return feats, zeros, ones, ws

    def unwound_sum(feats, zeros, ones, ws, i):
        l = len(feats) - 1
        po, pz = ones[i], zeros[i]
        hot = po != 0.0 if np.ndim(po) else np.full(n, po != 0.0)
        po_safe = np.where(hot, po, 1.0)
        total = np.zeros(n)
        nn = ws[l].copy()
        for j in range(l - 1, -1, -1):
            t = nn * ((l + 1) / (j + 1)) / po_safe
            cold = ws[j] * (l + 1) / (pz * (l - j))
            total += np.where(hot, t, cold)
            nn = np.where(hot, ws[j] - t * (pz * (l - j) / (l + 1)), nn)
        return total

    def recurse(node, feats, zeros, ones, ws, pz, po, pi):
        feats, zeros, ones, ws = extend(feats, zeros, ones, ws, pz, po, pi)
        if feature[node] < 0:
            for i in range(1, len(feats)):
                w = unwound_sum(feats, zeros, ones, ws, i)
                phi[:, feats[i]] += w * (ones[i] - zeros[i]) * value[node]
            return
        f = feature[node]
        go_left = x[:, f] <= threshold[node]
        iz, io = 1.0, np.ones(n)
        k = -1
        for i in range(1, len(feats)):
            if feats[i] == f:
                k = i
                break
        if k >= 0:
            iz, io = zeros[k], ones[k]
            feats, zeros, ones, ws = unwind(feats, zeros, ones, ws, k)
        # child c is the hot child for samples routed into it, cold otherwise
        lc, rc = left[node], right[node]
        recurse(lc, feats, zeros, ones, ws,
                iz * cover[lc] / cover[node], np.where(go_left, io, 0.0), f)
        recurse(rc, feats, zeros, ones, ws,
                iz * cover[rc] / cover[node], np.where(go_left, 0.0, io), f)

    recurse(0, [], [], [], [], 1.0, np.ones(n), -1)
    return phi


def _tree_shap_values_scalar(tree, x: np.ndarray) -> np.ndarray:
    """Literal per-sample Lundberg Algorithm 2 — the parity oracle for the
    vectorized `tree_shap_values` above."""
    n, d = x.shape
    phi = np.zeros((n, d), dtype=np.float64)
    feature = tree.feature
    threshold = tree.threshold
    left = tree.left
    right = tree.right
    value = np.asarray(tree.value, np.float64)
    cover = np.maximum(np.asarray(tree.cover, np.float64), 1e-12)

    for s in range(n):
        xs = x[s]

        def recurse(node: int, p: _Path, pz: float, po: float, pi: int) -> None:
            p = p.copy()
            _extend(p, pz, po, pi)
            if feature[node] < 0:
                for i in range(1, len(p.feat)):
                    w = _unwound_sum(p, i)
                    phi[s, p.feat[i]] += w * (p.one[i] - p.zero[i]) * value[node]
                return
            f = feature[node]
            hot, cold = (left[node], right[node]) if xs[f] <= threshold[node] \
                else (right[node], left[node])
            iz, io = 1.0, 1.0
            k = -1
            for i in range(1, len(p.feat)):
                if p.feat[i] == f:
                    k = i
                    break
            if k >= 0:
                iz, io = p.zero[k], p.one[k]
                p = _unwind(p, k)
            recurse(hot, p, iz * cover[hot] / cover[node], io, f)
            recurse(cold, p, iz * cover[cold] / cover[node], 0.0, f)

        root_path = _Path()
        recurse(0, root_path, 1.0, 1.0, -1)
    return phi


def forest_shap_values(estimator, x: np.ndarray,
                       max_samples: Optional[int] = 200,
                       seed: int = 0,
                       background: Optional[np.ndarray] = None) -> np.ndarray:
    """SHAP values for a fitted forest estimator (sum over trees × scale).
    Additivity: base_score + tree_scale·Σ tree-values + Σ phi = prediction.

    Reads the estimator's dense ensemble (``ensemble_``, on any device);
    node cover comes from ``background``, defaulting to x. The JAX
    package's host trainers, which record a training cover, are not
    ported."""
    x = np.asarray(x, dtype=np.float32)
    if max_samples is not None and len(x) > max_samples:
        idx = np.random.default_rng(seed).choice(len(x), max_samples, replace=False)
        x = x[idx]
    trees = dense_to_tree_arrays(estimator.ensemble_,
                                 x if background is None else background)
    phi = np.zeros((len(x), x.shape[1]), dtype=np.float64)
    for tree in trees:
        phi += tree_shap_values(tree, x)
    return phi * estimator.ensemble_.tree_scale


def forest_feature_importance(trees: Sequence) -> np.ndarray:
    """Gain-free cover-weighted split-count importance (quick global view)
    over explicit trees (``_TreeArrays``, e.g. ``dense_to_tree_arrays`` of
    an ensemble); the JAX package reads its host trainers' ``_host_trees``."""
    d = 0
    for t in trees:
        if len(t.feature):
            d = max(d, int(t.feature.max()) + 1)
    imp = np.zeros(max(d, 1))
    for t in trees:
        for nid, f in enumerate(t.feature):
            if f >= 0:
                imp[f] += t.cover[nid]
    s = imp.sum()
    return imp / s if s > 0 else imp


# ---------------------------------------------------------------------------
# kernel SHAP (any model)
# ---------------------------------------------------------------------------

def kernel_shap(predict_fn: Callable, x: np.ndarray, background: np.ndarray,
                n_samples: int = 512, n_background: int = 20,
                l2: float = 1e-3, seed: int = 0) -> np.ndarray:
    """Sampling KernelSHAP (Lundberg & Lee 2017) for model-agnostic
    attribution — the reference's KernelExplainer fallback for KNN/NB/SVC/MLP
    (Models/model_opt_20250130.py:241-349 shap_analysis else-branch).

    predict_fn: batch [m, d] -> [m] scalar output (e.g. positive-class proba).
    Coalition masks are sampled from the Shapley kernel's size distribution;
    hybrid rows substitute background values for absent features and average
    over ``n_background`` background rows; φ solves the kernel-weighted ridge
    with the efficiency constraint enforced by anchored all-on/all-off rows.
    All model evaluations run as a few big batched calls (device-friendly).
    Returns φ [n, d].
    """
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float32)
    bg = np.asarray(background, np.float32)
    bg = bg[rng.choice(len(bg), min(n_background, len(bg)), replace=False)]
    n, d = x.shape
    m = n_samples
    # coalition sizes ~ Shapley kernel: p(k) ∝ (d-1)/(k(d-k))
    ks = np.arange(1, d)
    pk = (d - 1) / (ks * (d - ks))
    pk = pk / pk.sum()
    sizes = rng.choice(ks, size=m, p=pk)
    z = np.zeros((m, d), np.float32)
    for i, k in enumerate(sizes):
        z[i, rng.choice(d, k, replace=False)] = 1.0
    # anchor rows: empty and full coalitions with dominant weight
    z_full = np.concatenate([z, np.zeros((1, d), np.float32),
                             np.ones((1, d), np.float32)])
    w = np.ones(m + 2, np.float32)
    w[-2:] = 1e6
    f_bg = float(np.mean(predict_fn(bg)))

    # weighted ridge with an explicit intercept column: the empty-coalition
    # anchor pins the intercept to ~0 and the full-coalition anchor pins
    # sum(phi) + intercept to f(x) - f_bg, so the efficiency constraint holds
    # to anchor-weight precision (an all-zero row without an intercept
    # contributes nothing to the normal equations). Intercept unregularized.
    design = np.concatenate([z_full, np.ones((m + 2, 1), np.float32)], axis=1)
    reg = l2 * np.eye(d + 1, dtype=np.float32)
    reg[d, d] = 0.0
    phis = np.zeros((n, d), np.float32)
    dw = design * w[:, None]
    a_inv = np.linalg.inv(dw.T @ design + reg)
    for i in range(n):
        # hybrids: [m+2, n_bg, d] -> flatten for one batched predict
        hyb = np.where(z_full[:, None, :] == 1.0, x[i][None, None, :],
                       bg[None, :, :])
        preds = np.asarray(predict_fn(hyb.reshape(-1, d)), np.float32)
        fz = preds.reshape(m + 2, len(bg)).mean(1)
        target = fz - f_bg
        phis[i] = (a_inv @ (dw.T @ target))[:d]
    return phis


def integrated_gradients(apply_fn: Callable, inputs, baseline=None,
                         steps: int = 64):
    """IG along the straight-line path.

    apply_fn: a tensor, or a tuple of tensors, → [batch] predictions.
    inputs/baseline: a tensor or a tuple of [batch, ...] tensors on their
    own device (baseline defaults to 0). At each of ``steps`` points
    ``alpha`` of ``linspace(0, 1, steps)`` the gradient of
    ``apply_fn(baseline + alpha · (inputs − baseline)).sum()`` is taken;
    the result is (inputs − baseline) × their mean, with the structure of
    ``inputs``.
    """
    single = isinstance(inputs, torch.Tensor)
    xs = (inputs,) if single else tuple(inputs)
    if baseline is None:
        bs = tuple(torch.zeros_like(x) for x in xs)
    else:
        bs = (baseline,) if single else tuple(baseline)
    alphas = torch.linspace(0.0, 1.0, steps, dtype=torch.float32)
    total = [torch.zeros_like(x) for x in xs]
    for alpha in alphas:
        point = tuple((b + alpha.to(x.device) * (x - b)).detach().requires_grad_(True)
                      for x, b in zip(xs, bs))
        out = apply_fn(point[0] if single else point).sum()
        for acc, g in zip(total, torch.autograd.grad(out, point)):
            acc += g
    attr = tuple((x - b) * (acc / steps) for x, b, acc in zip(xs, bs, total))
    return attr[0] if single else attr
