"""Baseline 8-model comparison pipeline (family A1-A3), the counterpart of
``bbbp_tpu/train/baseline.py`` with a ``device`` (``cuda`` unless the
caller asks for ``cpu``).

Reference: ``Models/model.py:26-466`` ``morgan_train_model`` — Scale → PCA(100)
→ split → per-model GridSearchCV(cv=5, scoring='f1') over
KNN/LR/SVC/BernoulliNB/DT/RF/GB/MLP → learning curves → per-model metrics
→ per-model persistence → best model by Acc+AUC+BalAcc. Clones:
model_maccs.py / model_rdkit.py (fp kind), the Descriptors copies (A3).

The per-model grid runs on the batched (trial × fold) lanes
(``train/batched_search.py::batched_grid_search``). ``tune=False`` skips it.
With ``out_dir`` the run writes the JAX package's files: the pickles, the
CSVs, the learning curves and the bar chart; where matplotlib does not
import, it says which figures it does not write and writes the rest.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bbbp_tpu_torch.ops import metrics
from bbbp_tpu_torch.ops.forest_train import resolve_device
from bbbp_tpu_torch.ops.pca import PCA
from bbbp_tpu_torch.ops.scaler import StandardScaler
from bbbp_tpu_torch.ops.similarity import f32_matmul
from bbbp_tpu_torch.train.classification import _factory_from_params, default_zoo
from bbbp_tpu_torch.train.learning_curve import learning_curve, save_learning_scores_csv

# per-model grids mirroring the reference's param_grid_* dicts
# (Models/model.py:136-199 and the per-model blocks that follow), mapped to
# this zoo's parameters; the JAX package's, unchanged
GRID_SPACES: Dict[str, Dict] = {
    "knn": {"n_neighbors": [3, 5, 7, 9, 11]},                 # model.py:138-142
    "logreg": {"l2": [100.0, 10.0, 1.0, 0.1, 0.01]},          # C grid :195-198
    "svc": {"C": [0.01, 0.1, 1.0, 10.0, 100.0]},
    "bnb": {"alpha": [0.01, 0.1, 0.5, 1.0, 2.0]},
    "dt": {"n_estimators": [1], "learning_rate": [1.0], "max_depth": [12],
           "reg_lambda": [0.1, 1.0, 10.0], "colsample": [0.7, 1.0]},
    "rf": {"rf": [True], "n_estimators": [300], "max_depth": [10],
           "colsample": [0.5, 0.8, 1.0], "reg_lambda": [1e-6, 0.1]},
    "gb": {"n_estimators": [300], "max_depth": [6],
           "learning_rate": [0.05, 0.1, 0.2], "subsample": [0.8, 1.0]},
    "mlp": {"hidden": [(64,), (128,), (128, 64)],
            "lr": [1e-3, 3e-3], "l2": [1e-5], "n_steps": [800]},
}


@dataclass
class BaselineConfig:
    fp_kind: str = "morgan"
    pca_dim: int = 100
    test_size: float = 0.2
    with_learning_curves: bool = True
    models: Tuple[str, ...] = ("knn", "logreg", "svc", "bnb", "dt", "rf",
                               "gb", "mlp")
    seed: int = 42
    workers: Optional[int] = None
    out_dir: Optional[str] = None
    limit: Optional[int] = None
    # per-model GridSearchCV stage (reference model.py:136-199), run as
    # lanes. tune_models=None tunes every model in `models`.
    tune: bool = True
    grid_folds: int = 5
    # repeated-CV grid selection (batched_grid_search n_repeats)
    grid_repeats: int = 1
    tune_models: Optional[Tuple[str, ...]] = None


def _features(cfg: BaselineConfig):
    """B3DB classification's features and labels, ``limit`` rows at most."""
    from bbbp_tpu_torch.data.b3db import load_b3db_classification

    data = load_b3db_classification()
    smiles, y = data.smiles, data.labels
    if cfg.limit:
        smiles, y = smiles[: cfg.limit], y[: cfg.limit]
    if cfg.fp_kind == "graph":
        # pooled graph descriptors (gpu_features.npy path): reference trains
        # the same baseline zoo on DeepChem ConvMol atom features,
        # Descriptors/model_train_gpu.py:127-137.
        from bbbp_tpu_torch.chem.graph_features import pooled_graph_features

        feats, bad = pooled_graph_features(smiles)
        ok = np.ones(len(smiles), dtype=bool)
        ok[list(bad)] = False
        return feats[ok], y[ok]
    from bbbp_tpu_torch.chem.featurize import fingerprints

    fp = fingerprints(smiles, kind=cfg.fp_kind, workers=cfg.workers)
    return fp.features[fp.ok_mask], y[fp.ok_mask]


def run_baseline(cfg: BaselineConfig = BaselineConfig(),
                 verbose: bool = True,
                 device="cuda") -> Dict[str, Dict[str, float]]:
    dev = resolve_device(device)
    with f32_matmul():
        return _run(cfg, verbose, dev)


def _run(cfg, verbose, dev):
    t0 = time.time()
    x, y = _features(cfg)
    xd = torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    xd = StandardScaler().fit_transform(xd)
    x = PCA(min(cfg.pca_dim, *xd.shape)).fit_transform(xd).cpu().numpy()
    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(len(y))
    n_test = int(len(y) * cfg.test_size)
    te, tr = perm[:n_test], perm[n_test:]

    zoo = default_zoo(cfg.seed, dev)
    best_params: Dict[str, Dict] = {}
    if cfg.tune:
        from bbbp_tpu_torch.train.batched_search import batched_grid_search

        to_tune = [m for m in cfg.models if m in GRID_SPACES
                   and (cfg.tune_models is None or m in cfg.tune_models)]
        for name in to_tune:
            res = batched_grid_search(name, x[tr], y[tr], GRID_SPACES[name],
                                      cv=cfg.grid_folds, seed=cfg.seed,
                                      scoring="f1", n_repeats=cfg.grid_repeats,
                                      device=dev)
            zoo[name] = _factory_from_params(name, res.best_params, cfg.seed, dev)
            best_params[name] = {**res.best_params,
                                 "cv_f1": float(res.best_score)}
            if verbose:
                print(f"[baseline] grid {name}: cv_f1={res.best_score:.4f} "
                      f"{res.best_params}")
    report: Dict[str, Dict[str, float]] = {}
    draw = False
    if cfg.out_dir:
        from bbbp_tpu_torch.reporting import plots

        os.makedirs(cfg.out_dir, exist_ok=True)
        draw = plots.available()
        if not draw:
            print(plots.skip_note("baseline", cfg.out_dir, [
                f"{m}_learning_curve.png" for m in cfg.models if m in zoo
                and cfg.with_learning_curves] + [f"performance_{cfg.fp_kind}.png"]))
        if best_params:
            with open(os.path.join(cfg.out_dir, "grid_best_params.json"),
                      "w") as f:
                json.dump({m: {k: (list(v) if isinstance(v, tuple) else v)
                               for k, v in p.items()}
                           for m, p in best_params.items()}, f, indent=1)
    for name in cfg.models:
        if name not in zoo:
            continue
        if verbose:
            print(f"[baseline] {name}...")
        est = zoo[name]()
        est.fit(x[tr], y[tr])
        proba = est.predict_proba(x[te])[:, 1]
        report[name] = metrics.classification_report(
            y[te], (proba > 0.5).astype(int), proba)
        if cfg.out_dir:
            with open(os.path.join(cfg.out_dir, f"{name}_model.pkl"), "wb") as f:
                pickle.dump(est, f)
            if cfg.with_learning_curves:
                sizes, trs, vas = learning_curve(
                    zoo[name], x[tr], y[tr], cv=3,
                    train_sizes=(0.2, 0.5, 1.0), seed=cfg.seed)
                save_learning_scores_csv(
                    os.path.join(cfg.out_dir, f"{name}_learning_scores.csv"),
                    sizes, trs, vas)
                if draw:
                    plots.learning_curve_plot(sizes, trs, vas, os.path.join(
                        cfg.out_dir, f"{name}_learning_curve.png"))

    # best model by Acc + AUC + BalancedAcc (reference model.py:440-466)
    def score(r):
        return r["accuracy"] + r["roc_auc"] + r["balanced_accuracy"]

    best = max(report, key=lambda m: score(report[m]))
    report["_best"] = {"model": best, "score": score(report[best])}  # type: ignore
    if cfg.out_dir:
        from bbbp_tpu_torch.reporting.metrics_io import write_metrics_csv

        clean = {k: v for k, v in report.items() if not k.startswith("_")}
        write_metrics_csv(os.path.join(cfg.out_dir,
                                       f"model_performance_metrics_{cfg.fp_kind}.csv"),
                          clean)
        if draw:
            plots.performance_bar_plot(clean, os.path.join(
                cfg.out_dir, f"performance_{cfg.fp_kind}.png"))
    if verbose:
        for m, r in report.items():
            if m.startswith("_"):
                continue
            print(f"[baseline] {m:8s} acc={r['accuracy']:.4f} auc={r['roc_auc']:.4f}")
        print(f"[baseline] best={best} wall={time.time()-t0:.0f}s")
    return report


def main():
    ap = argparse.ArgumentParser(description="Baseline 8-model comparison (A1)")
    ap.add_argument("--fp-kind", default="morgan",
                    choices=["morgan", "maccs", "rdkit", "graph"])
    ap.add_argument("--out-dir", default="baseline_output")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--no-curves", action="store_true")
    ap.add_argument("--no-tune", action="store_true",
                    help="skip the per-model GridSearchCV stage")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    rep = run_baseline(BaselineConfig(fp_kind=args.fp_kind, out_dir=args.out_dir,
                                      with_learning_curves=not args.no_curves,
                                      limit=args.limit, tune=not args.no_tune),
                       device=args.device)
    print(json.dumps(rep, indent=2))


if __name__ == "__main__":
    main()
