"""Final classification pipeline (family A6): PCA(30) → SMOTETomek → 10-model
zoo → stacking (voting-of-trees final) + AUC-weighted soft voting; the
counterpart of ``bbbp_tpu/train/classification.py`` with a ``device``
(``cuda`` unless the caller asks for ``cpu``).

Reference protocol (Models/model_opt_20250130.py:352-671): fingerprints →
StandardScaler → PCA(30) → SMOTETomek resampling (:393-394) →
train_test_split(0.2) → 10 base models (KNN, LogReg, SVC, BernoulliNB,
DecisionTree, RF, GradientBoosting, MLP, XGB, CatBoost) each tuned with
RandomizedSearchCV → StackingClassifier whose final estimator is a soft
VotingClassifier over the four tree models with passthrough=True (:596-642) →
AUC-weighted VotingClassifier over all 10 (:654-655) → 8-metric report per
model (metrics CSV).

The reference resamples **before** the train/test split — synthetic SMOTE
points reach the test set. ``protocol='reference'`` reproduces that for metric
parity with the published CSVs; ``protocol='honest'`` resamples only the train
split.

Every base model is the port's (``ops/linear.py``, ``ops/forest_train.py``:
"dt", "gb", "xgb" and "cat" are ``GBDTClassifier``s, "rf" a
``RandomForestClassifier``); the per-model RandomizedSearchCV runs its
(trial × fold) grid as lanes (``train/batched_search.py``). ``tune=False``
skips the search and uses the hand-set defaults below. A run with
``out_dir`` writes the JAX package's files: the CSVs, the figures, TreeSHAP
of the first forest and kernel SHAP of the first non-tree model
(``reporting/attribution.py``), and the fitted models' pickle. Where
matplotlib does not import, it says which figures it does not write and
writes the rest.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from bbbp_tpu_torch.ops import metrics
from bbbp_tpu_torch.ops.forest_train import (GBDTClassifier,
                                             RandomForestClassifier,
                                             resolve_device)
from bbbp_tpu_torch.ops.linear import (BernoulliNB, KNeighborsClassifier,
                                       LinearSVC, LogisticRegression,
                                       MLPClassifier)
from bbbp_tpu_torch.ops.pca import PCA
from bbbp_tpu_torch.ops.resample import smote, smote_tomek
from bbbp_tpu_torch.ops.scaler import StandardScaler
from bbbp_tpu_torch.ops.similarity import f32_matmul
from bbbp_tpu_torch.train.batched_search import FOREST_FAMILIES
from bbbp_tpu_torch.train.loop import kfold_indices


@dataclass
class ClassificationTrainConfig:
    fp_kind: str = "maccs"
    pca_dim: float = 30              # int dims, or a (0,1) variance fraction
                                     # like the A4 variant's PCA(0.95)
    test_size: float = 0.2
    protocol: str = "reference"     # reference | honest
    stack_folds: int = 5
    seed: int = 42
    workers: Optional[int] = None
    out_dir: Optional[str] = None
    resampler: str = "smotetomek"   # smotetomek | smote | none (A4/A6 variants)
    models: Tuple[str, ...] = (
        "knn", "logreg", "svc", "bnb", "dt", "rf", "gb", "mlp", "xgb", "cat")
    # per-model RandomizedSearchCV stage (reference :557-561); trials × folds
    # run as lanes (train/batched_search.py)
    tune: bool = True
    n_search_iter: int = 50
    # forest trials are sequential fits (lanes with BBBP_FOREST_VMAP=1, see
    # batched_search._forest_cv_vmapped), so they get their own budget;
    # None = same as n_search_iter
    n_search_iter_forest: Optional[int] = None
    search_folds: int = 5
    # repeated-CV selection: rank trials on the mean over this many fold
    # seeds (1 = classic single-CV argmax). See batched_random_search.
    search_repeats: int = 1
    # restrict which models get searched (None = all)
    tune_models: Optional[Tuple[str, ...]] = None
    # per-base-model learning curves in the out_dir (reference emits one per
    # model inside train_and_evaluate, model_opt_20250130.py:589-591)
    with_learning_curves: bool = True


# per-model search distributions mirroring the reference's param_distributions
# (Models/model_opt_20250130.py:461-556), adapted to this zoo's parameters;
# the JAX package's, unchanged
SEARCH_SPACES: Dict[str, Dict] = {
    "knn": {"n_neighbors": {"low": 3, "high": 30, "int": True}},
    "logreg": {"l2": {"low": 1e-3, "high": 1e2, "log": True}},
    "svc": {"C": {"low": 1e-2, "high": 1e2, "log": True}},
    "bnb": {"alpha": {"low": 1e-2, "high": 10.0, "log": True}},
    "dt": {"n_estimators": [1], "learning_rate": [1.0], "max_depth": [12],
           "colsample": {"low": 0.5, "high": 1.0},
           "reg_lambda": {"low": 0.1, "high": 10.0, "log": True}},
    "rf": {"rf": [True], "n_estimators": [300], "max_depth": [10],
           "colsample": {"low": 0.3, "high": 1.0},
           "reg_lambda": {"low": 1e-6, "high": 1.0, "log": True}},
    "gb": {"n_estimators": [300], "max_depth": [6],
           "learning_rate": {"low": 0.02, "high": 0.3, "log": True},
           "subsample": {"low": 0.6, "high": 1.0}},
    "xgb": {"n_estimators": [300], "max_depth": [6],
            "learning_rate": {"low": 0.02, "high": 0.3, "log": True},
            "subsample": {"low": 0.6, "high": 1.0},
            "colsample": {"low": 0.5, "high": 1.0},
            "reg_lambda": {"low": 0.1, "high": 10.0, "log": True}},
    "cat": {"oblivious": [True], "n_estimators": [300], "max_depth": [6],
            "learning_rate": {"low": 0.02, "high": 0.3, "log": True},
            "reg_lambda": {"low": 0.5, "high": 10.0, "log": True}},
    "mlp": {"hidden": [(64,), (128,), (256,), (128, 64)],
            "lr": {"low": 3e-4, "high": 1e-2, "log": True},
            "l2": {"low": 1e-6, "high": 1e-3, "log": True}, "n_steps": 800},
}


# the hand-set default config of every model (default_zoo below), expressed
# as a search trial: seeded into each RandomizedSearchCV so the refit winner
# is never CV-worse than the default
DEFAULT_TRIALS: Dict[str, Dict] = {
    "knn": {"n_neighbors": 5},
    "logreg": {"l2": 1.0},
    "svc": {"C": 1.0},
    "bnb": {"alpha": 1.0},
    "dt": {"n_estimators": 1, "learning_rate": 1.0, "max_depth": 12,
           "colsample": 1.0, "reg_lambda": 1.0},
    "rf": {"rf": True, "n_estimators": 200, "max_depth": 10,
           "colsample": 0.5, "reg_lambda": 1e-6},
    "gb": {"n_estimators": 200, "learning_rate": 0.1, "max_depth": 4,
           "subsample": 1.0},
    "mlp": {"hidden": (128,), "lr": 1e-3, "l2": 0.0, "n_steps": 800},
    "xgb": {"n_estimators": 300, "learning_rate": 0.1, "max_depth": 6,
            "subsample": 0.8, "colsample": 0.8, "reg_lambda": 1.0},
    "cat": {"oblivious": True, "n_estimators": 300, "learning_rate": 0.1,
            "max_depth": 6, "reg_lambda": 1.0},
}


def _factory_from_params(name: str, p: Dict, seed: int,
                         device="cuda") -> Callable[[], object]:
    """Best-trial params → zoo factory."""
    if name == "knn":
        return lambda: KNeighborsClassifier(n_neighbors=int(p["n_neighbors"]),
                                            device=device)
    if name == "logreg":
        return lambda: LogisticRegression(C=1.0 / float(p["l2"]), device=device)
    if name == "svc":
        return lambda: LinearSVC(C=float(p["C"]), device=device)
    if name == "bnb":
        return lambda: BernoulliNB(alpha=float(p["alpha"]))
    if name == "mlp":
        return lambda: MLPClassifier(hidden=tuple(p["hidden"]),
                                     n_steps=int(p.get("n_steps", 800)),
                                     lr=float(p.get("lr", 1e-3)),
                                     l2=float(p.get("l2", 0.0)), seed=seed,
                                     device=device)
    if name == "rf":
        return lambda: RandomForestClassifier(
            n_estimators=int(p.get("n_estimators", 300)),
            max_depth=int(p.get("max_depth", 10)),
            reg_lambda=float(p.get("reg_lambda", 1e-6)),
            colsample=float(p.get("colsample", 0.5)), seed=seed, device=device)
    # dt / gb / xgb / cat → GBDT surrogates
    return lambda: GBDTClassifier(
        n_estimators=int(p.get("n_estimators", 300)),
        learning_rate=float(p.get("learning_rate", 0.1)),
        max_depth=int(p.get("max_depth", 6)),
        subsample=float(p.get("subsample", 1.0)),
        colsample=float(p.get("colsample", 1.0)),
        reg_lambda=float(p.get("reg_lambda", 1.0)),
        oblivious=bool(p.get("oblivious", False)), seed=seed, device=device)


def tune_zoo(x_tr: np.ndarray, y_tr: np.ndarray, names, cfg,
             verbose: bool = True, device="cuda"):
    """RandomizedSearchCV(n_iter, StratifiedKFold, scoring={accuracy,
    precision}, refit='accuracy') per base model (reference :557-561), with
    the (trial, fold) grid batched as lanes. Returns (zoo factories,
    per-model trial records, per-model wall-clock)."""
    from bbbp_tpu_torch.train.batched_search import batched_random_search

    zoo = {}
    trials = {}
    walls = {}
    forest_iter = (cfg.n_search_iter if cfg.n_search_iter_forest is None
                   else cfg.n_search_iter_forest)
    for m in names:
        t0 = time.time()
        res = batched_random_search(
            m, x_tr, y_tr, SEARCH_SPACES[m],
            n_iter=(forest_iter if m in FOREST_FAMILIES else cfg.n_search_iter),
            cv=cfg.search_folds, seed=cfg.seed, verbose=False,
            extra_trials=[DEFAULT_TRIALS[m]] if m in DEFAULT_TRIALS else None,
            n_repeats=getattr(cfg, "search_repeats", 1), device=device)
        walls[m] = time.time() - t0
        zoo[m] = _factory_from_params(m, res.best_params, cfg.seed, device)
        trials[m] = res.trials
        if verbose:
            print(f"[classification] tuned {m}: cv_acc={res.best_score:.4f} "
                  f"{res.best_params} ({walls[m]:.1f}s for "
                  f"{len(res.trials)}x{cfg.search_folds} fits)")
    return zoo, trials, walls


def default_zoo(seed: int = 42, device="cuda") -> Dict[str, Callable[[], object]]:
    """The 10 base models (reference's estimator list :413-457), as factories."""
    return {
        "knn": lambda: KNeighborsClassifier(n_neighbors=5, device=device),
        "logreg": lambda: LogisticRegression(C=1.0, device=device),
        "svc": lambda: LinearSVC(C=1.0, device=device),
        "bnb": lambda: BernoulliNB(),
        "dt": lambda: GBDTClassifier(n_estimators=1, learning_rate=1.0,
                                     max_depth=12, seed=seed, device=device),
        "rf": lambda: RandomForestClassifier(n_estimators=200, max_depth=10,
                                             seed=seed, device=device),
        "gb": lambda: GBDTClassifier(n_estimators=200, learning_rate=0.1,
                                     max_depth=4, seed=seed, device=device),
        "mlp": lambda: MLPClassifier(hidden=(128,), n_steps=800, seed=seed,
                                     device=device),
        "xgb": lambda: GBDTClassifier(n_estimators=300, learning_rate=0.1,
                                      max_depth=6, subsample=0.8, colsample=0.8,
                                      seed=seed, device=device),
        "cat": lambda: GBDTClassifier(n_estimators=300, learning_rate=0.1,
                                      max_depth=6, oblivious=True, seed=seed,
                                      device=device),
    }


TREE_MODELS = ("rf", "gb", "xgb", "cat")


def stack_finals(seed: int, device="cuda") -> Dict[str, object]:
    """The stacking classifier's final estimator: a soft vote of four tree
    models over [OOF probabilities | passthrough features] (reference
    :596-642)."""
    return {
        "rf": RandomForestClassifier(n_estimators=200, max_depth=10, seed=seed,
                                     device=device),
        "gb": GBDTClassifier(n_estimators=200, learning_rate=0.1, max_depth=4,
                             seed=seed, device=device),
        "xgb": GBDTClassifier(n_estimators=200, learning_rate=0.1, max_depth=6,
                              subsample=0.8, seed=seed, device=device),
        "cat": GBDTClassifier(n_estimators=200, learning_rate=0.1, max_depth=6,
                              oblivious=True, seed=seed, device=device),
    }


def _proba(model, x) -> np.ndarray:
    return model.predict_proba(x)[:, 1]


@dataclass
class ClassificationRunResult:
    report: Dict[str, Dict[str, float]]   # per model + stacking + voting
    y_test: np.ndarray
    proba_test: Dict[str, np.ndarray]
    wall_time_s: float
    # wall seconds by stage: preprocess, resample, tune (and tune_<model>
    # within it), each base model's (stack_folds + 1) fits, finals, voting
    stage_s: Dict[str, float] = field(default_factory=dict)


def _fit_basis(x: np.ndarray, k, dev) -> Tuple[StandardScaler, PCA]:
    scaler = StandardScaler().fit(torch.from_numpy(x).to(dev))
    pca = PCA(k).fit(scaler.transform(torch.from_numpy(x).to(dev)))
    return scaler, pca


def _project(basis, x: np.ndarray, dev) -> np.ndarray:
    scaler, pca = basis
    z = pca.transform(scaler.transform(torch.from_numpy(x).to(dev)))
    return z.cpu().numpy()


def run_classification(cfg: ClassificationTrainConfig = ClassificationTrainConfig(),
                       x: Optional[np.ndarray] = None,
                       y: Optional[np.ndarray] = None,
                       verbose: bool = True,
                       device="cuda") -> ClassificationRunResult:
    dev = resolve_device(device)
    with f32_matmul():
        return _run(cfg, x, y, verbose, dev)


def _run(cfg, x, y, verbose, dev) -> ClassificationRunResult:
    t0 = time.time()
    stage_s: Dict[str, float] = {}
    clock = [time.time()]

    def lap(name: str) -> None:
        now = time.time()
        stage_s[name] = stage_s.get(name, 0.0) + now - clock[0]
        clock[0] = now

    if x is None:
        from bbbp_tpu_torch.chem.featurize import fingerprints
        from bbbp_tpu_torch.data.b3db import load_b3db_classification

        data = load_b3db_classification()
        fp = fingerprints(data.smiles, kind=cfg.fp_kind, workers=cfg.workers)
        x = fp.features[fp.ok_mask]
        y = data.labels[fp.ok_mask]
        lap("featurize")
    x = np.asarray(x, np.float32)
    rng = np.random.default_rng(cfg.seed)
    k = cfg.pca_dim if (isinstance(cfg.pca_dim, float) and 0 < cfg.pca_dim < 1) \
        else int(cfg.pca_dim)

    def _resample(xx, yy):
        if cfg.resampler == "smotetomek":
            return smote_tomek(xx, yy, seed=cfg.seed, device=dev)
        if cfg.resampler == "smote":
            return smote(xx, yy, seed=cfg.seed, device=dev)
        return xx, yy

    if cfg.protocol == "reference":
        # scale+PCA on everything, resample everything, then split
        # (reference :379-402 — synthetic SMOTE points reach the test set and
        # the scaler/PCA see test rows; kept verbatim for metric parity)
        x = _project(_fit_basis(x, k, dev), x, dev)
        lap("preprocess")
        xr, yr = _resample(x, y)
        lap("resample")
        perm = rng.permutation(len(yr))
        n_test = int(len(yr) * cfg.test_size)
        te, tr = perm[:n_test], perm[n_test:]
        x_tr, y_tr, x_te, y_te = xr[tr], yr[tr], xr[te], yr[te]
    else:
        # honest: split FIRST on raw features; scaler and PCA are fit on the
        # train split only; resampling touches the train split only
        perm = rng.permutation(len(y))
        n_test = int(len(y) * cfg.test_size)
        te, tr = perm[:n_test], perm[n_test:]
        basis = _fit_basis(x[tr], k, dev)
        x_tr = _project(basis, x[tr], dev)
        x_te = _project(basis, x[te], dev)
        y_te = y[te]
        lap("preprocess")
        x_tr, y_tr = _resample(x_tr, y[tr])
        lap("resample")

    zoo = default_zoo(cfg.seed, dev)
    names = [m for m in cfg.models if m in zoo]
    search_trials = None
    if cfg.tune:
        to_tune = [m for m in names
                   if cfg.tune_models is None or m in cfg.tune_models]
        tuned, search_trials, walls = tune_zoo(x_tr, y_tr, to_tune, cfg,
                                               verbose=verbose, device=dev)
        zoo.update(tuned)
        lap("tune")
        stage_s.update({f"tune_{m}": w for m, w in walls.items()})

    # --- out-of-fold probabilities on the training set (for stacking) ---
    folds = kfold_indices(len(y_tr), cfg.stack_folds, cfg.seed)
    oof = {m: np.zeros(len(y_tr), np.float32) for m in names}
    test_proba: Dict[str, np.ndarray] = {}
    fitted = {}
    for m in names:
        if verbose:
            print(f"[classification] base model {m}...")
        for i, va in enumerate(folds):
            tr_i = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
            mdl = zoo[m]()
            mdl.fit(x_tr[tr_i], y_tr[tr_i])
            oof[m][va] = _proba(mdl, x_tr[va])
        full = zoo[m]()
        full.fit(x_tr, y_tr)
        fitted[m] = full
        test_proba[m] = _proba(full, x_te)
        lap(f"fit_{m}")

    report: Dict[str, Dict[str, float]] = {}
    for m in names:
        p = test_proba[m]
        report[m] = metrics.classification_report(y_te, (p > 0.5).astype(int), p)

    # --- stacking: final estimator = soft voting of the 4 tree models over
    # [OOF probas | passthrough features] (reference :596-642) ---
    stack_train = np.concatenate(
        [np.stack([oof[m] for m in names], axis=1), x_tr], axis=1)
    stack_test = np.concatenate(
        [np.stack([test_proba[m] for m in names], axis=1), x_te], axis=1)
    finals = stack_finals(cfg.seed, dev)
    stack_p = np.zeros(len(y_te), np.float32)
    for f in finals.values():
        f.fit(stack_train, y_tr)
        stack_p += _proba(f, stack_test)
    stack_p /= len(finals)
    report["stacking"] = metrics.classification_report(
        y_te, (stack_p > 0.5).astype(int), stack_p)
    test_proba["stacking"] = stack_p
    lap("finals")

    # --- AUC-weighted soft voting over all 10 (reference :654-655) ---
    # The reference weights by TEST-set AUC (a quirk kept under
    # protocol='reference'); honest mode weights by the out-of-fold AUCs so
    # nothing about the test split tunes the ensemble.
    if cfg.protocol == "reference":
        aucs = np.array([report[m]["roc_auc"] for m in names])
    else:
        aucs = np.array([float(metrics.roc_auc(y_tr, oof[m])) for m in names])
    w = aucs / aucs.sum()
    vote_p = sum(wi * test_proba[m] for wi, m in zip(w, names))
    report["voting"] = metrics.classification_report(
        y_te, (vote_p > 0.5).astype(int), vote_p)
    test_proba["voting"] = vote_p
    lap("voting")

    if verbose:
        for m, r in report.items():
            print(f"[classification] {m:9s} acc={r['accuracy']:.4f} "
                  f"f1={r['f1']:.4f} mcc={r['mcc']:.4f} auc={r['roc_auc']:.4f}")
    if cfg.out_dir:
        _write_outputs(cfg, report, search_trials, zoo, names, fitted, x_tr, y_tr,
                       x_te, y_te, test_proba)
        lap("outputs")
    return ClassificationRunResult(report, y_te, test_proba, time.time() - t0,
                                   stage_s)


def _write_outputs(cfg, report, search_trials, zoo, names, fitted, x_tr, y_tr,
                   x_te, y_te, test_proba):
    """The files of ``bbbp_tpu/train/classification.py:372-460``: the metrics
    CSV and bar chart, the trial CSVs and their scatters, the stacking
    confusion matrix, the learning-score CSVs and curves, TreeSHAP of the
    first forest (150 test rows) and kernel SHAP of the first non-tree model
    (60 rows), and the fitted models' pickle. A figure that fails prints its
    exception; without matplotlib the figures and SHAP plots are skipped in
    one printed line."""
    from bbbp_tpu_torch.reporting import plots
    from bbbp_tpu_torch.reporting.metrics_io import (write_metrics_csv,
                                                     write_trials_csv)

    d = cfg.out_dir
    os.makedirs(d, exist_ok=True)
    draw = plots.available()
    forest = next((m for m in ("rf", "gb", "xgb", "cat") if m in fitted), None)
    other = next((m for m in ("mlp", "knn", "logreg", "svc", "bnb")
                  if m in fitted), None)
    if not draw:
        skipped = [f"performance_{cfg.fp_kind}.png", "confusion_stacking.png"]
        skipped += [f"hyperparam_search_{m}_*.png" for m in (search_trials or {})]
        if cfg.with_learning_curves:
            skipped += [f"{m}_learning_curve.png" for m in names]
        if forest:
            skipped += [f"shap_{forest}.png", f"shap_dependence_{forest}.png"]
        if other:
            skipped += [f"shap_kernel_{other}.png",
                        f"shap_kernel_dependence_{other}.png"]
        print(plots.skip_note("classification", d, skipped))
    write_metrics_csv(os.path.join(
        d, f"model_performance_metrics_{cfg.fp_kind}.csv"), report)
    if draw:
        plots.performance_bar_plot(report, os.path.join(
            d, f"performance_{cfg.fp_kind}.png"))
    for m, tr_rows in (search_trials or {}).items():
        write_trials_csv(os.path.join(d, f"hyperparam_search_{m}.csv"), tr_rows)
        if draw:
            try:
                plots.hyperparam_search_plots(
                    tr_rows, os.path.join(d, f"hyperparam_search_{m}"))
            except Exception as e:  # noqa: BLE001 — a figure, not a result
                print(f"[classification] hyperparameter plots for {m} "
                      f"FAILED: {e!r}")
    if draw:
        plots.confusion_matrix_plot(
            y_te, (test_proba["stacking"] > 0.5).astype(int),
            os.path.join(d, "confusion_stacking.png"))
    if cfg.with_learning_curves:
        # one learning curve per (tuned) base model, reference
        # model_opt_20250130.py:589-591
        from bbbp_tpu_torch.train.learning_curve import (
            learning_curve, save_learning_scores_csv)

        for m in names:
            try:
                sizes, trs, vas = learning_curve(
                    zoo[m], x_tr, y_tr, cv=3, train_sizes=(0.25, 0.5, 1.0),
                    seed=cfg.seed)
                save_learning_scores_csv(
                    os.path.join(d, f"{m}_learning_scores.csv"), sizes, trs, vas)
                if draw:
                    plots.learning_curve_plot(
                        sizes, trs, vas, os.path.join(d, f"{m}_learning_curve.png"))
            except Exception as e:  # noqa: BLE001 — curves are artifacts,
                # not results; disclose instead of silently skipping
                print(f"[classification] learning curve for {m} FAILED: {e!r}")
    if draw and forest:
        from bbbp_tpu_torch.reporting.attribution import forest_shap_values

        try:
            idx = np.random.default_rng(0).choice(
                len(x_te), min(150, len(x_te)), replace=False)
            phi = forest_shap_values(fitted[forest], x_te[idx], max_samples=None)
            plots.shap_summary_plot(phi, x_te[idx],
                                    os.path.join(d, f"shap_{forest}.png"))
            plots.shap_dependence_plot(
                phi, x_te[idx], int(np.abs(phi).mean(0).argmax()),
                os.path.join(d, f"shap_dependence_{forest}.png"))
        except Exception as e:  # noqa: BLE001 — a figure, not a result
            print(f"[classification] TreeSHAP plots for {forest} FAILED: {e!r}")
    if draw and other:
        # KernelSHAP for one non-tree model (reference's KernelExplainer
        # fallback, model_opt_20250130.py:241-349)
        from bbbp_tpu_torch.reporting.attribution import kernel_shap

        try:
            idx = np.random.default_rng(0).choice(
                len(x_te), min(60, len(x_te)), replace=False)
            mdl = fitted[other]
            phi = kernel_shap(lambda a: mdl.predict_proba(a)[:, 1],
                              x_te[idx], x_tr, n_samples=256)
            plots.shap_summary_plot(phi, x_te[idx],
                                    os.path.join(d, f"shap_kernel_{other}.png"))
            plots.shap_dependence_plot(
                phi, x_te[idx], int(np.abs(phi).mean(0).argmax()),
                os.path.join(d, f"shap_kernel_dependence_{other}.png"))
        except Exception as e:  # noqa: BLE001 — a figure, not a result
            print(f"[classification] kernel SHAP plots for {other} FAILED: {e!r}")
    with open(os.path.join(d, "fitted_models.pkl"), "wb") as f:
        pickle.dump(fitted, f)


def main():
    ap = argparse.ArgumentParser(description="B3DB classification ensemble (A6)")
    ap.add_argument("--fp-kind", default="maccs", choices=["morgan", "maccs", "rdkit"])
    ap.add_argument("--protocol", default="reference", choices=["reference", "honest"])
    ap.add_argument("--pca-dim", type=int, default=30)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--resampler", default="smotetomek",
                    choices=["smotetomek", "smote", "none"])
    ap.add_argument("--no-tune", action="store_true",
                    help="skip the per-model RandomizedSearchCV stage")
    ap.add_argument("--n-search-iter", type=int, default=50)
    ap.add_argument("--search-repeats", type=int, default=1,
                    help="repeated-CV selection: rank trials on the mean "
                    "over this many fold seeds")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    cfg = ClassificationTrainConfig(fp_kind=args.fp_kind, protocol=args.protocol,
                                    pca_dim=args.pca_dim, workers=args.workers,
                                    out_dir=args.out_dir, resampler=args.resampler,
                                    tune=not args.no_tune,
                                    n_search_iter=args.n_search_iter,
                                    search_repeats=args.search_repeats)
    res = run_classification(cfg, device=args.device)
    print(json.dumps(res.report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res.report, f, indent=2)


if __name__ == "__main__":
    main()
