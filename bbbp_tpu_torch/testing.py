"""Test fixtures and checks. They are not features: the tests and
``chip_smoke.py`` use them to drive the screening and training paths at
their real shapes and to compare two forests.

- ``full_width_screening_state``: a screening model at the repo's default
  width, made from a seed without training;
- ``labelled_training_set``: molecules and labels at B3DB classification's
  size, made from a seed;
- ``near_tie_rows`` and ``compare_gbdt_fits``: comparisons of two
  implementations that sum in different orders;
- ``tanimoto_tie_case`` and ``count_case``: fingerprints with many equal
  rows (ties at the k-th place of a top-k search) and zero rows, and count
  vectors above the clip; ``tanimoto_equal_f32_case``: 65,536-bit rows whose
  distinct Tanimoto fractions round to one f32 at the k-th place;
- ``regression_molecules``: molecules and a target at B3DB regression's
  size, made from a seed;
- ``regression_legs``: the regression stack's three chemistry-kernel legs,
  driven fold by fold as ``bbbp_tpu/train/regression.py`` drives them;
- ``write_regression_tsv``: molecules and a target as a B3DB regression
  TSV, which ``run_regression`` and ``preprocess_regression`` read;
- ``b3db_env``: the loaders' directory and the preprocess and transfer
  caches pointed into one directory for the length of a ``with`` block;
- ``regression_nn_inputs``: the regressor's (fingerprint, image, target)
  inputs of those molecules, from ``preprocess_regression``;
- ``classification_inputs``: the MACCS features and labels of
  ``labelled_training_set``, the classification ensemble's input;
- ``mesh_train_cv_rank`` and ``mesh_layout_rank``: one rank of
  ``train_cv`` over a mesh, and one rank's view of ``make_mesh``, for
  ``parallel/mesh.py::launch``.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

N_TREES, DEPTH, PCA_DIM, N_BITS = 300, 6, 30, 2048
INF_SHARE = 0.05
B3DB_CLASSIFICATION_SIZE = 7809
B3DB_REGRESSION_SIZE = 1058
POSITIVE_SHARE = 2 / 3


def full_width_screening_state(seed: int = 0, n_molecules: int = 4096) -> dict:
    """Pickle-format dict of the default screening model's shape
    (``bbbp_tpu/pipelines/screen.py::ScreeningModel.train``): Morgan r=2 at
    2048 bits, PCA 30, 300 trees of depth 6.

    The scaler and PCA are fit by the port's own ``fit`` on the CPU, on the
    fingerprints of ``n_molecules`` ``synthetic_smiles``. Tree features are
    drawn from [0, 30); each threshold is the f32 midpoint of two
    neighbouring distinct projected values of its feature, so that no
    threshold equals a data value; ~5% of thresholds are +inf (dead
    branches). Leaves ~ N(0, 0.1²), ``tree_scale`` 0.1, ``base_score`` 0."""
    from bbbp_tpu_torch.data.zinc import synthetic_smiles
    from bbbp_tpu_torch.native.bindings import fingerprints
    from bbbp_tpu_torch.ops.pca import PCA
    from bbbp_tpu_torch.ops.scaler import StandardScaler

    x, bad = fingerprints(synthetic_smiles(n_molecules, seed=seed), "morgan",
                          N_BITS)
    x = np.delete(x, bad, axis=0)
    scaler = StandardScaler().fit(torch.from_numpy(x))
    xs = scaler.transform(torch.from_numpy(x))
    pca = PCA(PCA_DIM).fit(xs)
    z = pca.transform(xs).numpy()

    rng = np.random.default_rng(seed)
    n_internal = (1 << DEPTH) - 1
    feat = rng.integers(0, PCA_DIM, size=(N_TREES, n_internal)).astype(np.int32)
    thr = np.empty((N_TREES, n_internal), np.float32)
    for f in range(PCA_DIM):
        u = np.unique(z[:, f])
        mid = ((u[:-1].astype(np.float64) + u[1:]) / 2).astype(np.float32)
        mid = mid[(mid > u[:-1]) & (mid < u[1:])]
        sel = feat == f
        thr[sel] = mid[rng.integers(0, len(mid), size=int(sel.sum()))]
    thr[rng.random(thr.shape) < INF_SHARE] = np.inf
    leaf = rng.normal(0.0, 0.1, size=(N_TREES, n_internal + 1)).astype(np.float32)
    return {
        "scaler_mean": scaler.mean_.numpy(),
        "scaler_scale": scaler.scale_.numpy(),
        "pca_mean": pca.mean_.numpy(),
        "pca_components": pca.components_.numpy(),
        "fp_kind": "morgan",
        "n_bits": N_BITS,
        "threshold": 0.5,
        "ensemble": {"feat": feat, "thr": thr, "leaf": leaf, "depth": DEPTH,
                     "base_score": 0.0, "tree_scale": 0.1},
    }


def near_tie_rows(ensemble: dict, z: np.ndarray, tol: float = 1e-5) -> np.ndarray:
    """Rows of ``z`` [N, F] whose path through any tree of ``ensemble`` (the
    pickle's dict) meets a threshold within ``tol``. Two correct
    implementations that sum z in different orders may send such a row down
    different branches, so comparisons of whole predictions allow a
    mismatch there and nowhere else."""
    feat, thr, depth = ensemble["feat"], ensemble["thr"], ensemble["depth"]
    n, n_trees = len(z), feat.shape[0]
    t_idx = np.arange(n_trees)[None, :]
    pos = np.zeros((n, n_trees), np.int64)
    near = np.zeros(n, bool)
    for level in range(depth):
        flat = (1 << level) - 1 + pos
        xv = np.take_along_axis(z, feat[t_idx, flat], axis=1)
        t = thr[t_idx, flat]
        near |= (np.abs(xv - t) <= tol).any(axis=1)
        pos = 2 * pos + (xv > t)
    return near


def labelled_training_set(n: int = B3DB_CLASSIFICATION_SIZE, seed: int = 0
                          ) -> Tuple[List[str], np.ndarray]:
    """``n`` ``synthetic_smiles`` and int32 labels: each label is 1 where the
    molecule's Morgan bits (2048, r=2) score above a threshold under a
    seeded random ±1 weight vector, the threshold set so that two thirds
    are positive (B3DB classification has 7,809 molecules, 63% BBB+). The
    scores are integers; a seeded jitter in [0, 0.5) breaks their ties."""
    from bbbp_tpu_torch.data.zinc import synthetic_smiles
    from bbbp_tpu_torch.native.bindings import fingerprints

    smiles = synthetic_smiles(n, seed=seed)
    x, _ = fingerprints(smiles, "morgan", N_BITS)
    rng = np.random.default_rng(seed)
    w = rng.choice([-1.0, 1.0], size=N_BITS)
    score = x.astype(np.float64) @ w + 0.5 * rng.random(n)
    cut = np.quantile(score, 1 - POSITIVE_SHARE)
    return smiles, (score > cut).astype(np.int32)


def classification_inputs(n: int = B3DB_CLASSIFICATION_SIZE, seed: int = 0
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """(MACCS [n, 167] f32, labels [n] int32) of ``labelled_training_set``:
    ``run_classification``'s ``x`` and ``y`` at B3DB classification's size
    (B3DB is not in the repository)."""
    from bbbp_tpu_torch.native.bindings import fingerprints

    smiles, labels = labelled_training_set(n, seed)
    x, bad = fingerprints(smiles, "maccs")
    if bad:
        raise ValueError(f"labelled set holds invalid SMILES {bad[:5]}")
    return x, labels


@dataclass
class ForestComparison:
    """Node by node, in fit order, a boosting fit against the plain
    arithmetic replayed on the CPU.

    ``equal``: the reference's (feat, thr). ``equivalent``: another split
    that sends the node's training rows the same way (candidates of equal
    gain that another rounding orders differently). ``near_ties``: splits
    that send rows another way where the two candidates' gains lie within
    ``tol`` of the node's gain scale; ``first_near_tie`` is the (tree, node)
    of the first. ``mismatch``: (tree, node) of a split that differs and is
    no near tie; the comparison stops there. ``max_leaf_diff`` is taken over
    ``trees_compared``."""

    equal: int = 0
    equivalent: int = 0
    near_ties: int = 0
    trees_compared: int = 0
    first_near_tie: Optional[Tuple[int, int]] = None
    mismatch: Optional[Tuple[int, int]] = None
    max_leaf_diff: float = 0.0

    @property
    def ok(self) -> bool:
        return self.mismatch is None


def compare_gbdt_fits(z: np.ndarray, y: np.ndarray, ref: Optional[dict],
                      got: dict, *, task: str, lam: float, min_child: float,
                      learning_rate: float, base_score: float,
                      tol: float, oblivious: bool = False) -> ForestComparison:
    """Compare a boosting fit ``got`` (the pickle's ensemble dict, numpy) on
    its training matrix ``z`` [n, F] with a reference, for deterministic
    fits only (``subsample=1``, ``colsample=1``, no sample weights). Each
    level's histogram and gains are replayed with the plain versions on the
    CPU. A node's gain scale is the larger of its best gain and its parent
    term G²/(H + λ), so ``tol`` bounds the gap relative to the terms whose
    difference the gain is.

    With ``ref`` (another fit's dict) the replay follows ``ref``'s margins
    and ends at its first near tie, after which the two fits grow on other
    margins. With ``ref=None`` the replay follows ``got``'s own splits and
    margins and holds each split against the plain version's best split
    on that state, so every node of every tree is checked; its leaves are
    held against the plain leaf values.

    With ``oblivious`` the fits are oblivious ones: a level's nodes share
    one split, a candidate's score is its gain summed over the level's
    nodes (non-positive and invalid entries count 0), and the gain scale is
    the larger of the best score and the nodes' summed parent terms. Every
    node of a level is counted."""
    from bbbp_tpu_torch.ops.forest_train import (BinMapper, _cumsum_bins,
                                                 best_splits_reference,
                                                 level_histogram_reference,
                                                 split_gains)

    mapper = BinMapper().fit(z)
    xb = torch.from_numpy(mapper.transform(z))
    edges = mapper.edge_values()
    zt = torch.from_numpy(np.ascontiguousarray(z, np.float32))
    yt = torch.from_numpy(np.asarray(y, np.float32))
    n, n_feat = z.shape
    depth = got["depth"]
    follow = got if ref is None else ref
    out = ForestComparison()
    preds = torch.full((n,), float(base_score), dtype=torch.float32)
    every = torch.ones(n_feat, dtype=torch.bool)
    lr32 = float(np.float32(learning_rate))
    for t in range(got["feat"].shape[0]):
        if task == "reg":
            g, h = preds - yt, torch.ones_like(yt)
        else:
            p = torch.sigmoid(preds)
            g, h = p - yt, torch.clamp(p * (1 - p), min=1e-6)
        pos = torch.zeros(n, dtype=torch.int32)
        for level in range(depth):
            nodes, off = 1 << level, (1 << level) - 1
            hist = level_histogram_reference(xb, pos, g, h, nodes)
            gain, valid = split_gains(hist, every, lam, min_child)
            hl = _cumsum_bins(hist[..., 1])
            th = hl[..., -1]
            parent = _cumsum_bins(hist[..., 0])[..., -1] ** 2 / (th + lam)
            if oblivious:
                score = torch.where(valid & (gain > 0), gain,
                                    torch.zeros_like(gain)).sum(0)
                score = torch.where(valid.any(0), score, -torch.inf)
                level_scale = float(parent.abs().amax(dim=1).sum())
            if ref is None:
                bf, bb, bs = best_splits_reference(hist, every, lam, min_child,
                                                   oblivious)
                best_thr = torch.from_numpy(edges)[bf.long(), bb.long()]
            for k in range(nodes):
                i = off + k
                if ref is None:
                    rf, rt = int(bf[k]), float(best_thr[k])
                else:
                    rf, rt = int(ref["feat"][t, i]), float(ref["thr"][t, i])
                gf, gt = int(got["feat"][t, i]), float(got["thr"][t, i])
                if (rf, rt) == (gf, gt):
                    out.equal += 1
                    continue
                rows = pos == k
                if torch.equal(zt[rows, rf] > rt, zt[rows, gf] > gt):
                    out.equivalent += 1
                    continue

                def cand(f, thr):
                    """Gain of a split in the plain arithmetic; a dead node
                    (+inf) counts 0, as a split with no gain."""
                    if not np.isfinite(thr):
                        return 0.0, True
                    b = int((edges[f] < thr).sum())
                    at = slice(None) if oblivious else k
                    near_edge = bool((
                        ((hl[at, f, b] - min_child).abs() <= tol * min_child)
                        | ((th[at, f] - hl[at, f, b] - min_child).abs()
                           <= tol * min_child)).any())
                    if oblivious:
                        return float(score[f, b]), bool(valid[:, f, b].any()) or near_edge
                    return float(gain[k, f, b]), bool(valid[k, f, b]) or near_edge

                (rg, _), (cg, c_ok) = cand(rf, rt), cand(gf, gt)
                scale = max(abs(rg), level_scale if oblivious
                            else float(parent[k].abs().max()))
                if not (c_ok and abs(rg - cg) <= tol * scale):
                    out.mismatch = (t, i)
                    return out
                out.near_ties += 1
                out.first_near_tie = out.first_near_tie or (t, i)
                if ref is not None:
                    return out
            f_l = torch.tensor(follow["feat"][t, off:off + nodes]).long()
            thr_l = torch.tensor(follow["thr"][t, off:off + nodes])
            xv = zt.gather(1, f_l[pos.long()][:, None])[:, 0]
            pos = 2 * pos + (xv > thr_l[pos.long()]).int()
        if ref is None:
            idx = pos.long()
            gs = torch.zeros(1 << depth).index_add_(0, idx, g)
            hs = torch.zeros(1 << depth).index_add_(0, idx, h)
            want = (-gs / (hs + lam)).numpy()
        else:
            want = ref["leaf"][t]
        out.max_leaf_diff = max(out.max_leaf_diff,
                                float(np.abs(want - got["leaf"][t]).max()))
        out.trees_compared += 1
        leaf = torch.tensor(follow["leaf"][t])
        preds = preds.double().add_(leaf[pos.long()].double(), alpha=lr32).float()
    return out


def mixed_level_case(seed: int, n: int, n_feat: int, level: int,
                     one_node: bool = False, zero_share: float = 0.2
                     ) -> Tuple[np.ndarray, ...]:
    """One level's inputs with features of mixed occupancy, as the transfer
    path's matrix has them: (xb uint8 [n, F], pos int32 [n], g, h f32 [n],
    n_bins uint8 [F]). Feature f has 2 occupied bins when f % 3 == 0 (90%
    of its rows in bin 0, as a rare fingerprint bit), 3 when f % 3 == 1 and
    64 when f % 3 == 2; feature 0 is constant (1 bin). ``zero_share`` of
    the rows have g = h = 0. With ``one_node`` every row sits in the
    level's last node; otherwise the nodes' sizes are skewed (a third of
    the rows in node 0)."""
    r = np.random.default_rng(seed)
    n_bins = np.array([(2, 3, 64)[f % 3] for f in range(n_feat)], np.uint8)
    n_bins[0] = 1
    xb = (r.random((n, n_feat)) * n_bins[None, :]).astype(np.uint8)
    rare = (np.arange(n_feat) % 3 == 0) & (n_bins == 2)
    xb[:, rare] = r.random((n, int(rare.sum()))) < 0.1
    nodes = 1 << level
    if one_node:
        pos = np.full(n, nodes - 1, np.int32)
    else:
        pos = r.integers(0, nodes, n).astype(np.int32)
        pos[r.random(n) < 1 / 3] = 0
    g = r.normal(size=n).astype(np.float32)
    h = r.uniform(0.05, 0.3, n).astype(np.float32)
    zero = r.random(n) < zero_share
    g[zero] = 0.0
    h[zero] = 0.0
    return xb, pos, g, h, n_bins


def tanimoto_tie_case(seed: int, nq: int, nr: int, d: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """0/1 f32 (queries [nq, d], references [nr, d]). Rows are drawn from 12
    prototypes, so many reference rows are equal and most queries have
    several references tied at the k-th place; 2% of the query bits are
    flipped; where the sizes allow, two rows on each side are all zero."""
    rng = np.random.default_rng(seed)
    protos = (rng.random((12, d)) < 0.3).astype(np.float32)
    r = protos[rng.integers(0, len(protos), nr)]
    q = protos[rng.integers(0, len(protos), nq)]
    q = np.where(rng.random(q.shape) < 0.02, 1 - q, q).astype(np.float32)
    if nr > 4:
        r[[1, nr // 2]] = 0.0
    if nq > 4:
        q[[0, nq - 1]] = 0.0
    return q, r


EQUAL_F32_BITS = 2048 * 32        # the widest row the top-k kernel takes
EQUAL_F32_K = 25


def equal_f32_fractions(group: int, seed: int = 0
                        ) -> List[Tuple[int, int]]:
    """``group`` distinct fractions inter/union (unions 50,000-55,999, near
    0.6) that one f32 division rounds to one value, in ascending exact
    order. Found with numpy: every (inter, union) with inter within 3 of
    0.6·union, grouped by ``np.float32(inter) / np.float32(union)`` (an f32
    division, rounded to nearest as the kernel's); the ``seed``-th group
    of at least ``group`` distinct reduced fractions."""
    bins: dict = {}
    for u in range(50000, 56000):
        centre = round(0.6 * u)
        for i in range(centre - 3, centre + 4):
            g = int(np.gcd(i, u))
            bins.setdefault(float(np.float32(i) / np.float32(u)), {})[
                (i // g, u // g)] = (i, u)
    full = [v for _, v in sorted(bins.items()) if len(v) >= group]
    fracs = list(full[seed % len(full)].values())[:group]
    return sorted(fracs, key=lambda f: f[0] / f[1])


def tanimoto_equal_f32_case(seed: int = 0, nr: int = 300, group: int = 10
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """uint8 0/1 (queries [3, 65,536], references [nr, 65,536]) at the top-k
    kernel's widest rows. Queries 0 and 1 hold 40,000 bits; for them 20
    references lie above 0.7, a group of ``group`` references have distinct
    fractions that round to one f32 (``equal_f32_fractions``), and the rest
    lie near 0.3. The group sits at the k-th place for k = 25 and its exact
    fractions rise with the index, so an order by exact fraction would keep
    other indices than the order of the f32 key (similarity, then the lower
    index). Query 2 is random. Columns are permuted from ``seed``."""
    rng = np.random.default_rng(seed)
    n_bits, p = EQUAL_F32_BITS, 40000
    pairs = [(36000 + t, 50000) for t in range(20)]
    fracs = equal_f32_fractions(group, seed)
    rest = nr - 20 - group
    pairs += [(15000 + t, 50000) for t in range(rest)]
    slots = np.sort(rng.choice(np.arange(20, nr), group, replace=False))
    others = np.setdiff1d(np.arange(20, nr), slots)
    r = np.zeros((nr, n_bits), np.uint8)
    for j, (i, u) in zip(np.concatenate([rng.permutation(20), slots, others]),
                         pairs[:20] + fracs + pairs[20:]):
        r[j, :i] = 1                      # i bits shared with queries 0 and 1
        r[j, p:u] = 1                     # so that the union is u
    q = np.zeros((3, n_bits), np.uint8)
    q[:2, :p] = 1
    q[2] = rng.random(n_bits) < 0.3
    cols = rng.permutation(n_bits)
    return q[:, cols], r[:, cols]


def count_case(seed: int, n: int, d: int, high: int = 6) -> np.ndarray:
    """f32 [n, d] integer counts in [0, high), 60% of them zero, row 2 all
    zero (where n > 2) and one count of 40."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, high, (n, d)).astype(np.float32)
    c[rng.random((n, d)) < 0.6] = 0.0
    if n > 2:
        c[2] = 0.0
    c[-1, 0] = 40.0
    return c


def regression_molecules(n: int = B3DB_REGRESSION_SIZE, seed: int = 1
                         ) -> Tuple[List[str], np.ndarray]:
    """``n`` ``synthetic_smiles`` of another seed than the labelled set's
    (B3DB regression has 1,058 molecules) and an f32 target: a seeded random
    linear score of the MACCS bits plus N(0, 0.3²) noise, standardized."""
    from bbbp_tpu_torch.data.zinc import synthetic_smiles
    from bbbp_tpu_torch.native.bindings import fingerprints

    smiles = synthetic_smiles(n, seed=seed)
    x, _ = fingerprints(smiles, "maccs")
    rng = np.random.default_rng(seed)
    score = x.astype(np.float64) @ rng.normal(size=x.shape[1])
    score = (score - score.mean()) / max(score.std(), 1e-12)
    return smiles, (score + rng.normal(0, 0.3, n)).astype(np.float32)


def regression_legs(desc: np.ndarray, maccs: np.ndarray, counts: np.ndarray,
                    y: np.ndarray, device=None, n_folds: int = 10,
                    seed: int = 0, estimators=None) -> dict:
    """The ``tknn``, ``tkrr`` and ``ckrr`` legs of the regression stack over
    (descriptors, MACCS, Morgan counts) and a target, as
    ``bbbp_tpu/train/regression.py`` calls them with its defaults
    (``TanimotoKNNRegressor(10)``, ``TanimotoKernelRidge(0.1)``,
    ``ChemKernelRidge(0.06, weights=(0.25,) * 4)`` on each fold's training
    rows), plus the first fold once more with IDF bit weights and both
    ``full_gram``s (the fine-grained CV path, IDF-weighted for the combined
    kernel). Returns f32 arrays: out-of-fold predictions ``tknn``, ``tkrr``,
    ``ckrr`` [n], ``ckrr_idf`` [first fold], ``gram_tkrr`` and ``gram_ckrr``
    [n, n].

    ``estimators`` is the module that holds the classes (default: the
    port's ``ops.similarity``, which takes ``device``; the tests pass the
    JAX package's with ``device=None``)."""
    if estimators is None:
        from bbbp_tpu_torch.ops import similarity as estimators
    on = {} if device is None else {"device": device}
    n = len(y)
    folds = np.array_split(np.random.default_rng(seed).permutation(n), n_folds)
    fp_bits = (np.asarray(maccs) > 0).astype(np.float32)
    idf = estimators.ChemKernelRidge.idf_weights(maccs, counts)
    quarter = (0.25, 0.25, 0.25, 0.25)
    out = {leg: np.zeros(n, np.float32) for leg in ("tknn", "tkrr", "ckrr")}

    def ckrr(tr, te, bit_weights):
        model = estimators.ChemKernelRidge(0.06, weights=quarter,
                                           bit_weights=bit_weights, **on)
        model.fit(maccs[tr], counts[tr], desc[tr], y[tr])
        return model.predict(maccs[te], counts[te], desc[te])

    for te in folds:
        tr = np.setdiff1d(np.arange(n), te)
        out["tknn"][te] = estimators.TanimotoKNNRegressor(10, **on).fit(
            fp_bits[tr], y[tr]).predict(fp_bits[te])
        out["tkrr"][te] = estimators.TanimotoKernelRidge(0.1, **on).fit(
            fp_bits[tr], y[tr]).predict(fp_bits[te])
        out["ckrr"][te] = ckrr(tr, te, None)
    out["ckrr_idf"] = np.asarray(
        ckrr(np.setdiff1d(np.arange(n), folds[0]), folds[0], idf), np.float32)
    out["gram_tkrr"] = estimators.TanimotoKernelRidge.full_gram(fp_bits, **on)
    out["gram_ckrr"] = estimators.ChemKernelRidge(
        0.06, weights=quarter, bit_weights=idf, **on).full_gram(maccs, counts, desc)
    return out


def write_regression_tsv(path: str, smiles: List[str], y: np.ndarray) -> None:
    """A B3DB-format regression TSV (``NO.``, ``SMILES``, ``logBB``) that
    ``data/b3db.py::load_b3db_regression`` reads; each target is written so
    that it reads back as the same f32."""
    with open(path, "w") as f:
        f.write("NO.\tSMILES\tlogBB\n")
        for i, (s, v) in enumerate(zip(smiles, y)):
            f.write(f"{i + 1}\t{s}\t{float(np.float32(v))!r}\n")


@contextlib.contextmanager
def b3db_env(directory: str):
    """``BBBP_B3DB_DIR`` set to ``directory`` and the preprocess and
    transfer caches (``BBBP_PREPROCESS_CACHE``, ``BBBP_TRANSFER_CACHE``) to
    its ``preprocess`` and ``transfer`` subdirectories inside the block; the
    three variables are as they were after it. Yields the mapping."""
    env = {"BBBP_B3DB_DIR": directory,
           "BBBP_PREPROCESS_CACHE": os.path.join(directory, "preprocess"),
           "BBBP_TRANSFER_CACHE": os.path.join(directory, "transfer")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield env
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def write_classification_tsv(path: str, smiles: List[str], labels: np.ndarray
                             ) -> None:
    """A B3DB-format classification TSV (``NO.``, ``SMILES``,
    ``BBB+/BBB-``) that ``data/b3db.py::load_b3db_classification`` reads
    (and the JAX package's loader): label 1 is written ``BBB+``, 0
    ``BBB-``. No ``logBB`` or ``Inchi`` column, so the aux set
    (``train/transfer.py::aux_classification_set``) drops only molecules
    whose standardized SMILES the regression TSV holds too."""
    with open(path, "w") as f:
        f.write("NO.\tSMILES\tBBB+/BBB-\n")
        for i, (s, v) in enumerate(zip(smiles, labels)):
            f.write(f"{i + 1}\t{s}\t{'BBB+' if int(v) == 1 else 'BBB-'}\n")


def regression_nn_inputs(n: int = B3DB_REGRESSION_SIZE, seed: int = 1,
                         seconds: Optional[Dict[str, float]] = None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(nn_fp [n, 198] f32, img [n, 128, 128, 3] f32, y [n]) of
    ``regression_molecules(n, seed)``: ``pipelines/preprocess.py::
    preprocess_regression`` on the CPU at its defaults (MACCS, enriched)
    over a TSV of them, with ``logbb_min=None`` (the target is synthetic),
    and the regressor's inputs as ``run_regression`` takes them
    (``nn_fp_features()``: the MACCS bits standardized with the images, the
    31 descriptors apart). Molecules that do not parse or render are
    dropped. ``seconds``, if given, gets the wall time of the preprocessing
    under ``"preprocess"`` and the count of molecules dropped under
    ``"bad"``."""
    import os
    import tempfile
    import time

    from bbbp_tpu_torch.pipelines.preprocess import (PreprocessConfig,
                                                     preprocess_regression)

    smiles, y = regression_molecules(n, seed)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "B3DB_regression.tsv")
        write_regression_tsv(path, smiles, y)
        data = preprocess_regression(PreprocessConfig(logbb_min=None,
                                                      tsv_path=path),
                                     device="cpu")
    if seconds is not None:
        seconds["preprocess"] = time.perf_counter() - t0
        seconds["bad"] = n - len(data.y)
    side = data.config.image_size
    return (data.nn_fp_features(),
            data.img_norm.reshape(len(data.y), side, side, 3), data.y)


def mesh_train_cv_rank(model_kw: dict, inputs, y: np.ndarray, cv_kw: dict,
                       model_parallel: int = 1):
    """One rank of ``train_cv(MultiModalRegressor(**model_kw), inputs, y,
    mesh=make_mesh(model_parallel=...), **cv_kw)`` (the process group is
    ``launch``'s): the OOF predictions, the losses and the parameters
    ({name: [K, ...]}), numpy."""
    from bbbp_tpu_torch.models import MultiModalRegressor
    from bbbp_tpu_torch.parallel.mesh import make_mesh
    from bbbp_tpu_torch.train.loop import train_cv

    res = train_cv(MultiModalRegressor(**model_kw), inputs, y,
                   mesh=make_mesh(model_parallel=model_parallel), **cv_kw)
    return (res.oof_pred, res.train_losses,
            {name: t.float().cpu().numpy() for name, t in res.params.items()})


def mesh_layout_rank() -> dict:
    """One rank's view of ``make_mesh()`` and ``make_mesh(model_parallel=2)``
    (the process group is ``launch``'s): {model_parallel: (axis sizes, the
    local and global shape of a [16, 4] batch sharded over ``data``)}."""
    from bbbp_tpu_torch.parallel.mesh import make_mesh, shard_batch

    out = {}
    for mp in (1, 2):
        mesh = make_mesh(model_parallel=mp)
        x = shard_batch(mesh, np.ones((16, 4), np.float32))
        out[mp] = ({name: mesh[name].size() for name in mesh.mesh_dim_names},
                   tuple(x.to_local().shape), tuple(x.shape))
    return out


def mesh_prefetch_rank(n_items: int = 5) -> dict:
    """One rank of ``prefetch_to_device`` with ``sharding`` on a (data 2,
    model 2) mesh (the process group is ``launch``'s): every rank feeds the
    same items, item i a [8, 3] batch of i·100 + its row index and a [4]
    vector of i. Returns the rank's mesh coordinates, and for each item
    its batch's local rows under ``batch_sharding`` and its vector's local
    values under ``replicated``, with their global shapes."""
    from bbbp_tpu_torch.parallel.mesh import batch_sharding, make_mesh, replicated
    from bbbp_tpu_torch.parallel.prefetch import prefetch_to_device

    mesh = make_mesh(model_parallel=2)

    def items(sharding):
        for i in range(n_items):
            rows = (100.0 * i + np.arange(8, dtype=np.float32))[:, None]
            yield {"x": np.repeat(rows, 3, axis=1)} if sharding == "batch" else (
                np.full((4,), float(i), np.float32),)

    got = {}
    for name, sh in (("batch", batch_sharding(mesh)), ("replicated", replicated(mesh))):
        got[name] = []
        for item in prefetch_to_device(items(name), depth=2, device="cpu",
                                       sharding=sh):
            t = item["x"] if name == "batch" else item[0]
            got[name].append((t.to_local().numpy().copy(), tuple(t.shape)))
    return {"coords": (mesh["data"].get_local_rank(), mesh["model"].get_local_rank()),
            **got}
