"""Hyperparameter search with trials × folds as batched lanes, the
counterpart of ``bbbp_tpu/train/batched_search.py``.

The reference tunes every classification base model with
``RandomizedSearchCV(n_iter=50, StratifiedKFold(5), scoring={accuracy,
precision}, refit='accuracy')``: 250 sequential fits per model (reference:
Models/model_opt_20250130.py:557-561; GridSearchCV per model in the
baseline, Models/model.py:136-199). Here, for logreg, svc, bnb and mlp, all
(trial, fold) fits of a model are one set of lanes: the folds' train rows
are gathered once as x_tr [K, S, d] and shared by the T trials, the
parameters are [T, K, ...] (``ops/linear.py``'s lane functions), and each
optimiser step is one pass over all lanes. The MLP's lanes are grouped by
``hidden`` (one shape a group). kNN takes one top-k pass a fold and scores
every k from a cumulative sum.

Forest trials are sequential fits (``ops/forest_train.py::fit_forest``, its
kernels on ``cuda``) over one binned matrix shared by all trials, a fold's
validation rows given weight 0, scored by ``ops/forest.py::raw_predict``
(the forest kernel on ``cuda``). The fit of fold k of trial t is seeded
``t * 131 + k``, the index the JAX package folds into its key; the streams
differ (``torch.Generator`` against ``jax.random``), so subsampled,
column-sampled and random-forest trials match the JAX package only
statistically. With ``BBBP_FOREST_VMAP=1`` (off by default, as in the JAX
package) and at most ``FOREST_VMAP_MAX_F`` features, ``_forest_cv_vmapped``
runs instead: all (trial × fold) fits of one static shape as lanes of
``fit_forest_lanes`` (a tree level is one launch of K3, K4 and the routing
over every lane), each lane seeded as the sequential fit and growing its
trees bit for bit, the out-of-fold predictions read from the fit's final
margins at the validation rows.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bbbp_tpu_torch.ops.forest import DenseTreeEnsemble, raw_predict
from bbbp_tpu_torch.ops.forest_train import (BinMapper, fit_forest,
                                             fit_forest_lanes, lane_bytes,
                                             resolve_device)
from bbbp_tpu_torch.ops.linear import (init_mlp, lane_dot, logreg_newton,
                                       mlp_adam, mlp_lanes, nearest,
                                       sq_distances, svc_adam, with_bias)
from bbbp_tpu_torch.ops.similarity import f32_matmul
from bbbp_tpu_torch.train.search import _sample_params, stratified_kfold_indices

LOGREG_STEPS = 20
SVC_STEPS = 400
FOREST_FAMILIES = ("dt", "rf", "gb", "xgb", "cat")
# the lane-batched forest search, as the JAX package switches it
# (bbbp_tpu/train/batched_search.py:290-291): off unless BBBP_FOREST_VMAP=1,
# and only up to FOREST_VMAP_MAX_F features
FOREST_VMAP = os.environ.get("BBBP_FOREST_VMAP", "0") == "1"
FOREST_VMAP_MAX_F = 512
# device bytes of one block of lanes (``lane_bytes`` a lane): at the search
# matrix's 8,162 rows and 30 features each family's tuned group (250-255
# lanes) is one block, dt's depth 12 too (~1 MB a lane: no histogram is kept
# but cat's oblivious one, 0.49 MB a lane at depth 6)
FOREST_LANE_BUDGET = 4 << 30


# ---------------------------------------------------------------------------
# fold plumbing
# ---------------------------------------------------------------------------

def padded_cv_arrays(n: int, folds: List[np.ndarray]):
    """(tr_idx [K,S], va_idx [K,V], va_mask [K,V]) — wrap-padded to equal size."""
    k = len(folds)
    tr_sets = []
    for i in range(k):
        tr_sets.append(np.concatenate([folds[j] for j in range(k) if j != i]))
    s = max(len(t) for t in tr_sets)
    v = max(len(f) for f in folds)
    tr_idx = np.stack([np.resize(t, s) for t in tr_sets])
    va_idx = np.stack([np.resize(f, v) for f in folds])
    va_mask = np.stack([
        (np.arange(v) < len(f)).astype(np.float32) for f in folds])
    return tr_idx, va_idx, va_mask


def _grid_sum(t: torch.Tensor) -> torch.Tensor:
    return t.sum(dim=(-2, -1))


def _masked_scores(proba_kv, y_kv, mask_kv):
    """(accuracy, precision, f1) over the whole masked (fold, val) grid, for
    each leading index of ``proba_kv`` [..., K, V]. f1 serves the A1
    baseline's GridSearchCV(scoring='f1') protocol (reference
    Models/model.py:174, :199 …)."""
    pred = (proba_kv > 0.5).to(torch.float32)
    y_kv = y_kv.to(torch.float32)
    correct = (pred == y_kv).to(torch.float32) * mask_kv
    acc = _grid_sum(correct) / mask_kv.sum()
    tp = _grid_sum(pred * y_kv * mask_kv)
    fp = _grid_sum(pred * (1 - y_kv) * mask_kv)
    fn = _grid_sum((1 - pred) * y_kv * mask_kv)
    prec = tp / torch.clamp(tp + fp, min=1e-9)
    rec = tp / torch.clamp(tp + fn, min=1e-9)
    f1 = 2 * prec * rec / torch.clamp(prec + rec, min=1e-9)
    return acc, prec, f1


def _masked_r2(pred_kv, y_kv, mask_kv):
    """(R², -MSE, -MSE) over the whole masked (fold, val) grid — the
    out-of-fold metric the regression pipeline reports (third slot keeps the
    classification path's (acc, prec, f1) arity)."""
    m = mask_kv
    n = m.sum()
    mse = _grid_sum(((pred_kv - y_kv) ** 2) * m) / n
    mu = (y_kv * m).sum() / n
    var = (((y_kv - mu) ** 2) * m).sum() / n
    return 1.0 - mse / torch.clamp(var, min=1e-12), -mse, -mse


# ---------------------------------------------------------------------------
# per-family lane fits: x_tr [K, S, d], y_tr [K, S], x_va [K, V, d], each
# hyperparameter a [T] tensor → validation probabilities [T, K, V]
# ---------------------------------------------------------------------------

def _logreg_fit_predict(x_tr, y_tr, x_va, p):
    w = logreg_newton(with_bias(x_tr), y_tr, p["l2"], LOGREG_STEPS)
    return torch.sigmoid(lane_dot(x_va, w[..., :-1]) + w[..., -1:])


def _svc_fit_predict(x_tr, y_tr, x_va, p):
    w = svc_adam(x_tr, y_tr * 2 - 1, p["C"] / x_tr.shape[1], SVC_STEPS)
    return torch.sigmoid(lane_dot(x_va, w[..., :-1]) + w[..., -1:])


def _bnb_fit_predict(x_tr, y_tr, x_va, p):
    n = y_tr.shape[1]
    xb = (x_tr > 0).to(torch.float32)
    a = p["alpha"][:, None, None]
    n1 = y_tr.sum(1)                                  # [K]
    n0 = n - n1
    c1 = (xb * y_tr[..., None]).sum(1)                # [K, d]
    c0 = xb.sum(1) - c1
    lp1 = torch.log((c1 + a) / (n1[:, None] + 2 * a))          # [T, K, d]
    lp0 = torch.log((c0 + a) / (n0[:, None] + 2 * a))
    xv = (x_va > 0).to(torch.float32)

    def joint(lp, n_c):
        return (lane_dot(xv, lp) + lane_dot(1 - xv, torch.log1p(-torch.exp(lp)))
                + torch.log(n_c / n)[:, None])

    return torch.sigmoid(joint(lp1, n1) - joint(lp0, n0))


def _mlp_fit_predict(x_tr, y_tr, x_va, p, *, hidden: Tuple[int, ...],
                     n_steps: int):
    """Trial t starts from ``init_mlp(dims, seed_t)`` in all its folds."""
    dims = (x_tr.shape[2],) + hidden + (1,)
    n_sets = x_tr.shape[0]
    inits = [init_mlp(dims, int(s)) for s in p["seed"]]
    params = [(torch.stack([i[layer][0] for i in inits])[:, None]
               .expand(-1, n_sets, -1, -1).contiguous().to(x_tr.device),
               torch.stack([i[layer][1] for i in inits])[:, None]
               .expand(-1, n_sets, -1).contiguous().to(x_tr.device))
              for layer in range(len(dims) - 1)]
    params = mlp_adam(x_tr, y_tr, params, p["lr"], p["l2"], n_steps, True)
    return torch.sigmoid(mlp_lanes(x_va, params))


_FIT_KERNELS = {
    "logreg": _logreg_fit_predict,
    "svc": _svc_fit_predict,
    "bnb": _bnb_fit_predict,
}


def _batched_cv(x, y, tr_idx, va_idx, va_mask, params_t, kern):
    """[T] accuracy, precision, f1 of one model family, all lanes at once."""
    proba = kern(x[tr_idx], y[tr_idx], x[va_idx], params_t)      # [T, K, V]
    return _masked_scores(proba, y[va_idx], va_mask)


def _knn_cv(x, y, tr_idx, va_idx, va_mask, ks: Sequence[int]):
    """All k values from one shared top-k pass per fold."""
    max_k = int(max(ks))
    xt, xv = x[tr_idx], x[va_idx]                     # [K, S, d], [K, V, d]
    idx = nearest(sq_distances(xv, xt), max_k)        # [K, V, max_k]
    lbl = torch.gather(y[tr_idx][:, None, :].expand(-1, idx.shape[1], -1), 2, idx)
    csum = torch.cumsum(lbl, dim=-1)
    k_t = torch.as_tensor(list(ks), device=x.device)
    proba = csum[..., k_t - 1].permute(2, 0, 1) / k_t[:, None, None]
    return _masked_scores(proba, y[va_idx], va_mask)


# ---------------------------------------------------------------------------
# forest trials
# ---------------------------------------------------------------------------

def _forest_prep(x, y, folds, device):
    """Bin once on ALL rows (transductive ranking bins — see _forest_cv),
    build per-fold train-row weights. Returns a dict of device tensors."""
    x = np.asarray(x, np.float32)
    mapper = BinMapper().fit(x)
    tr_idx, va_idx, va_mask = padded_cv_arrays(len(x), folds)
    w_kn = np.zeros((len(folds), len(x)), np.float32)
    for i in range(len(folds)):
        w_kn[i][tr_idx[i]] = 1.0                      # wrap-pad dups collapse
    dev = device
    return {"xb": torch.from_numpy(mapper.transform(x)).to(dev),
            "edge_vals": torch.from_numpy(mapper.edge_values()).to(dev),
            "n_bins": torch.from_numpy(mapper.bin_counts()).to(dev),
            "y": torch.from_numpy(np.asarray(y, np.float32)).to(dev),
            "w_kn": torch.from_numpy(w_kn).to(dev),
            "x_va": torch.from_numpy(x[va_idx]).to(dev),      # [K, V, F]
            "va_idx": va_idx, "va_mask": va_mask}


def _forest_cv(x, y, folds, param_sets: List[Dict], classify: bool = True,
               verbose: bool = False, device="cuda"):
    """Forest trials: (trial × fold) fits through ``fit_forest`` on the
    SHARED binned matrix with per-fold row weights (validation rows weigh
    0), fold k of trial t seeded ``t * 131 + k``.

    The BinMapper is fit once on ALL rows (validation folds included): bin
    edges are transductive during the search. This is unsupervised quantile
    binning used only for trial RANKING, so it's acceptable here; the honest
    protocols' final fits bin on train rows only."""
    prep = _forest_prep(x, y, folds, device)
    y_np = np.asarray(y, np.float32)
    y_va = torch.from_numpy(y_np[prep["va_idx"]])
    va_mask = torch.from_numpy(prep["va_mask"])
    acc = np.zeros(len(param_sets))
    prec = np.zeros(len(param_sets))
    f1 = np.zeros(len(param_sets))
    base = _forest_base(y_np, classify)
    score_fn = _masked_scores if classify else _masked_r2
    for t, p in enumerate(param_sets):
        rf = bool(p.get("rf", False))
        n_est = int(p.get("n_estimators", 300))
        depth = int(p.get("max_depth", 6))
        lr = float(p.get("learning_rate", 0.1))
        base_t = 0.0 if rf else base
        raw_k = []
        for k in range(len(folds)):
            _, feats, thrs, leaves = fit_forest(
                prep["xb"], prep["edge_vals"], prep["y"], lr=lr,
                lam=float(p.get("reg_lambda", 1.0)), min_child=1.0,
                subsample=float(p.get("subsample", 1.0)),
                colsample=float(p.get("colsample", 1.0)), base_score=base_t,
                seed=t * 131 + k, task="cls" if classify else "reg",
                n_trees=n_est, depth=depth,
                oblivious=bool(p.get("oblivious", False)), rf=rf,
                row_w=prep["w_kn"][k], n_bins=prep["n_bins"])
            ens = DenseTreeEnsemble(feats, thrs, leaves, depth, base_t,
                                    (1.0 / n_est) if rf else lr)
            raw_k.append(raw_predict(ens, prep["x_va"][k]))
        raw = torch.stack(raw_k).cpu().numpy()                       # [K, V]
        if rf:
            proba = np.clip(raw, 0.0, 1.0) if classify else raw
        else:
            proba = 1 / (1 + np.exp(-raw)) if classify else raw
        a, pr, f = score_fn(torch.from_numpy(proba), y_va, va_mask)
        acc[t], prec[t], f1[t] = float(a), float(pr), float(f)
        if verbose:
            print(f"[search] forest trial {t+1}/{len(param_sets)} "
                  f"{'r2' if not classify else 'acc'}={acc[t]:.4f} {p}",
                  flush=True)
    return acc, prec, f1


def _forest_base(y_np: np.ndarray, classify: bool) -> float:
    """Every trial's starting margin: the log-odds of the positive share
    (classification) or the mean (regression), over all rows."""
    if classify:
        p0 = float(np.clip(y_np.mean(), 1e-6, 1 - 1e-6))
        return float(np.log(p0 / (1 - p0)))
    return float(y_np.mean())


def _forest_groups(param_sets: List[Dict]) -> Dict[Tuple, List[int]]:
    """Trial indices by static shape ``(rf, n_estimators, max_depth,
    oblivious)``: one lane group each."""
    groups: Dict[Tuple, List[int]] = {}
    for t, p in enumerate(param_sets):
        statics = (bool(p.get("rf", False)), int(p.get("n_estimators", 300)),
                   int(p.get("max_depth", 6)), bool(p.get("oblivious", False)))
        groups.setdefault(statics, []).append(t)
    return groups


def _fit_lane_block(prep: dict, param_sets: List[Dict], blk: List[Tuple[int, int]],
                    base: float, classify: bool = True):
    """``fit_forest_lanes`` of the lanes ``blk`` [(trial, fold)] of one
    group: trial t's parameters, fold k's row weights, seed t * 131 + k."""
    ps = [param_sets[t] for t, _ in blk]
    rf = bool(ps[0].get("rf", False))
    return fit_forest_lanes(
        prep["xb"], prep["edge_vals"], prep["y"],
        lr=[p.get("learning_rate", 0.1) for p in ps],
        lam=[p.get("reg_lambda", 1.0) for p in ps],
        subsample=[p.get("subsample", 1.0) for p in ps],
        colsample=[p.get("colsample", 1.0) for p in ps],
        seeds=[t * 131 + k for t, k in blk], row_w=prep["w_kn"][[k for _, k in blk]],
        base_score=0.0 if rf else base, task="cls" if classify else "reg",
        n_trees=int(ps[0].get("n_estimators", 300)),
        depth=int(ps[0].get("max_depth", 6)),
        oblivious=bool(ps[0].get("oblivious", False)), rf=rf, n_bins=prep["n_bins"])


def lane_block(n: int, n_feat: int, depth: int, n_trees: int,
               oblivious: bool) -> int:
    """Lanes in one block of a group of this static shape: as many as
    ``FOREST_LANE_BUDGET`` holds, at least one."""
    return max(1, FOREST_LANE_BUDGET // lane_bytes(n, n_feat, depth, n_trees,
                                                   oblivious))


def _forest_cv_vmapped(x, y, folds, param_sets: List[Dict],
                       classify: bool = True, verbose: bool = False,
                       device="cuda"):
    """All (trial × fold) forest fits of one static shape ``(rf,
    n_estimators, max_depth, oblivious)`` as lanes of ``fit_forest_lanes``
    over the shared binned matrix, in blocks of at most
    ``FOREST_LANE_BUDGET`` device bytes. Lane (t, k) has trial t's
    parameters, fold k's row weights (its validation rows weigh 0) and the
    sequential path's seed ``t * 131 + k``, so it grows ``_forest_cv``'s
    trees. Its validation rows' final margins are the out-of-fold
    predictions (rf: margin / n_estimators clipped to [0, 1]; boosting:
    sigmoid), with no second traversal; each trial is scored over its
    [K, V] grid as in ``_forest_cv``."""
    prep = _forest_prep(x, y, folds, device)
    n, n_feat = prep["xb"].shape
    n_folds = len(folds)
    y_np = np.asarray(y, np.float32)
    y_va = torch.from_numpy(y_np[prep["va_idx"]])
    va_mask = torch.from_numpy(prep["va_mask"])
    va_idx = torch.from_numpy(prep["va_idx"]).to(prep["xb"].device)
    base = _forest_base(y_np, classify)
    score_fn = _masked_scores if classify else _masked_r2
    acc = np.zeros(len(param_sets))
    prec = np.zeros(len(param_sets))
    f1 = np.zeros(len(param_sets))

    for (rf, n_est, depth, obl), t_ids in _forest_groups(param_sets).items():
        lanes = [(t, k) for t in t_ids for k in range(n_folds)]
        block = lane_block(n, n_feat, depth, n_est, obl)
        proba = np.zeros((len(lanes), va_idx.shape[1]), np.float32)
        for s in range(0, len(lanes), block):
            blk = lanes[s:s + block]
            preds, _, _, _ = _fit_lane_block(prep, param_sets, blk, base, classify)
            raw = (preds / n_est if rf else preds).gather(1, va_idx[[k for _, k in blk]])
            if classify:
                raw = raw.clamp(0.0, 1.0) if rf else torch.sigmoid(raw)
            proba[s:s + len(blk)] = raw.cpu().numpy()
        for j, t in enumerate(t_ids):
            a, pr, f = score_fn(torch.from_numpy(proba[j * n_folds:(j + 1) * n_folds]),
                                y_va, va_mask)
            acc[t], prec[t], f1[t] = float(a), float(pr), float(f)
        if verbose:
            print(f"[search] forest lanes rf={rf} T={n_est} d={depth} obl={obl}: "
                  f"{len(t_ids)} trials x {n_folds} folds in blocks of "
                  f"{min(block, len(lanes))}", flush=True)
    return acc, prec, f1


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

@dataclass
class BatchedSearchResult:
    best_params: Dict
    best_score: float
    trials: List[Dict]


def _score_param_sets(model_name: str, x: np.ndarray, y: np.ndarray,
                      params: List[Dict], cv: int, seed: int,
                      verbose: bool, device="cuda"
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(accuracy[T], precision[T], f1[T]) for explicit trial param sets —
    the shared core of batched_random_search / batched_grid_search."""
    dev = resolve_device(device)
    folds = stratified_kfold_indices(y, cv, seed)
    if model_name in FOREST_FAMILIES:
        cv_fn = (_forest_cv_vmapped
                 if FOREST_VMAP and np.shape(x)[1] <= FOREST_VMAP_MAX_F
                 else _forest_cv)
        return cv_fn(x, y, folds, params, classify=True, verbose=verbose,
                     device=dev)
    tr_idx, va_idx, va_mask = (torch.from_numpy(a).to(dev) for a in
                               padded_cv_arrays(len(y), folds))
    xd = torch.from_numpy(np.array(x, np.float32)).to(dev)

    def f32s(values):
        return torch.tensor(values, dtype=torch.float32, device=dev)

    with f32_matmul():
        if model_name in _FIT_KERNELS:
            key = {"logreg": "l2", "svc": "C", "bnb": "alpha"}[model_name]
            yd = torch.from_numpy(np.array(y, np.float32)).to(dev)
            scores = _batched_cv(xd, yd, tr_idx, va_idx, va_mask,
                                 {key: f32s([p[key] for p in params])},
                                 _FIT_KERNELS[model_name])
        elif model_name == "mlp":
            # lanes grouped by hidden (one shape a group); lr, l2, seed per lane
            yd = torch.from_numpy(np.array(y, np.float32)).to(dev)
            by_hidden: Dict[Tuple, List[int]] = {}
            for t, p in enumerate(params):
                by_hidden.setdefault(tuple(p.get("hidden", (128,))), []).append(t)
            scores = [torch.zeros(len(params), device=dev) for _ in range(3)]
            for hidden, t_ids in by_hidden.items():
                p_t = {"lr": f32s([params[t].get("lr", 1e-3) for t in t_ids]),
                       "l2": f32s([params[t].get("l2", 0.0) for t in t_ids]),
                       "seed": t_ids}

                def kern(a, b, c, p, hidden=hidden, t0=t_ids[0]):
                    return _mlp_fit_predict(
                        a, b, c, p, hidden=hidden,
                        n_steps=int(params[t0].get("n_steps", 500)))

                group = _batched_cv(xd, yd, tr_idx, va_idx, va_mask, p_t, kern)
                for out, s in zip(scores, group):
                    out[t_ids] = s
        elif model_name == "knn":
            yd = torch.from_numpy(np.array(y)).to(dev)
            scores = _knn_cv(xd, yd, tr_idx, va_idx, va_mask,
                             [int(p["n_neighbors"]) for p in params])
        else:
            raise ValueError(f"no batched search kernel for {model_name!r}")
    return tuple(s.cpu().numpy().astype(np.float64) for s in scores)


def _rank_and_wrap(model_name, params, acc, prec, f1, scoring, verbose,
                   rep_std: Optional[np.ndarray] = None):
    key = {"accuracy": acc, "precision": prec, "f1": f1}[scoring]
    trials = [{**p, "mean_accuracy": float(a), "mean_precision": float(pr),
               "mean_f1": float(f)}
              for p, a, pr, f in zip(params, acc, prec, f1)]
    if rep_std is not None:
        for t, s in zip(trials, rep_std):
            t["repeat_std"] = float(s)
    best_t = int(np.argmax(key))
    if verbose:
        print(f"[search] {model_name}: best {scoring}={key[best_t]:.4f} "
              f"params={params[best_t]}")
    return BatchedSearchResult(params[best_t], float(key[best_t]), trials)


def _search(model_name, x, y, params, cv, seed, verbose, scoring, n_repeats,
            device) -> BatchedSearchResult:
    """Score ``params`` at ``n_repeats`` fold seeds, rank on the mean."""
    reps = [_score_param_sets(model_name, x, y, params, cv, seed + 9973 * r,
                              verbose, device) for r in range(max(n_repeats, 1))]
    acc = np.mean([r[0] for r in reps], axis=0)
    prec = np.mean([r[1] for r in reps], axis=0)
    f1 = np.mean([r[2] for r in reps], axis=0)
    key_idx = {"accuracy": 0, "precision": 1, "f1": 2}[scoring]
    rep_std = (np.std([r[key_idx] for r in reps], axis=0)
               if len(reps) > 1 else None)
    return _rank_and_wrap(model_name, params, acc, prec, f1, scoring, verbose,
                          rep_std=rep_std)


def batched_random_search(model_name: str, x: np.ndarray, y: np.ndarray,
                          dists: Dict, n_iter: int = 50, cv: int = 5,
                          seed: int = 42, verbose: bool = False,
                          scoring: str = "accuracy",
                          extra_trials: Optional[List[Dict]] = None,
                          n_repeats: int = 1,
                          device="cuda") -> BatchedSearchResult:
    """RandomizedSearchCV(n_iter, StratifiedKFold(cv), scoring={accuracy,
    precision, f1}, refit=``scoring``) with the (trial, fold) grid batched
    as lanes. Families: logreg, svc, bnb, mlp, knn and the forests (dt, rf,
    gb, xgb, cat).

    ``extra_trials``: explicit param dicts prepended to the sampled ones —
    used to seed each search with the hand-set default config so the refit
    winner is never CV-worse than the default.

    ``n_repeats``: repeated-CV selection — score every trial at ``n_repeats``
    distinct fold seeds and rank on the per-trial MEAN."""
    rng = np.random.default_rng(seed)
    params = list(extra_trials or []) + [
        _sample_params(dists, rng) for _ in range(n_iter)]
    return _search(model_name, x, y, params, cv, seed, verbose, scoring,
                   n_repeats, device)


def batched_grid_search(model_name: str, x: np.ndarray, y: np.ndarray,
                        grid: Dict[str, Sequence], cv: int = 5,
                        seed: int = 42, verbose: bool = False,
                        scoring: str = "f1", n_repeats: int = 1,
                        device="cuda") -> BatchedSearchResult:
    """GridSearchCV on the batched (trial × fold) lanes — the A1 baseline's
    per-model tuning stage (reference Models/model.py:136-199:
    GridSearchCV(cv=5, scoring='f1') per model). The full Cartesian product
    of ``grid`` becomes the trial axis; same lane fits as the random search.
    ``n_repeats``: repeated-CV selection, as in batched_random_search."""
    keys = list(grid.keys())
    params = [dict(zip(keys, combo))
              for combo in itertools.product(*(grid[k] for k in keys))]
    return _search(model_name, x, y, params, cv, seed, verbose, scoring,
                   n_repeats, device)
