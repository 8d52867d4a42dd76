"""Learning curves: score vs training-set size with CV bands, the
counterpart of ``bbbp_tpu/train/learning_curve.py`` (a copy; the scores go
through the port's ``train/search.py::_score``).

Replaces sklearn ``learning_curve`` usage (reference: Models/model.py:26-62,
Models/model_opt_20250130.py:119-158 — 5 sizes × 5-fold refits, scores CSV +
plot). Works with any estimator exposing fit/predict(_proba).
"""

from __future__ import annotations

import csv
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from bbbp_tpu_torch.train.search import _score, stratified_kfold_indices
from bbbp_tpu_torch.train.loop import kfold_indices


def learning_curve(estimator_factory: Callable[[], object],
                   x: np.ndarray, y: np.ndarray,
                   train_sizes: Sequence[float] = (0.1, 0.33, 0.55, 0.78, 1.0),
                   cv: int = 5, scoring: str = "accuracy",
                   stratified: bool = True, seed: int = 42
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (sizes [S], train_scores [S, cv], val_scores [S, cv])."""
    x = np.asarray(x)
    y = np.asarray(y)
    folds = (stratified_kfold_indices(y, cv, seed) if stratified
             else kfold_indices(len(y), cv, seed))
    rng = np.random.default_rng(seed)
    sizes_abs = []
    train_scores = np.zeros((len(train_sizes), cv))
    val_scores = np.zeros((len(train_sizes), cv))
    for si, frac in enumerate(train_sizes):
        for fi, va in enumerate(folds):
            tr = np.concatenate([folds[j] for j in range(cv) if j != fi])
            k = max(8, int(len(tr) * frac))
            sub = rng.permutation(tr)[:k]
            est = estimator_factory()
            est.fit(x[sub], y[sub])
            train_scores[si, fi] = _score(est, x[sub], y[sub], scoring)
            val_scores[si, fi] = _score(est, x[va], y[va], scoring)
        sizes_abs.append(max(8, int(len(tr) * frac)))
    return np.asarray(sizes_abs), train_scores, val_scores


def save_learning_scores_csv(path: str, sizes, train_scores, val_scores) -> None:
    """reference's *_learning_scores.csv layout (model_opt_20250130.py:151-158)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["train_size", "train_score_mean", "train_score_std",
                    "val_score_mean", "val_score_std"])
        for s, tr, va in zip(sizes, np.asarray(train_scores), np.asarray(val_scores)):
            w.writerow([s, f"{tr.mean():.4f}", f"{tr.std():.4f}",
                        f"{va.mean():.4f}", f"{va.std():.4f}"])
