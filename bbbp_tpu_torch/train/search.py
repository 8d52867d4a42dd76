"""Hyperparameter search: randomized and grid CV search over the zoo, the
counterpart of ``bbbp_tpu/train/search.py``.

Replaces sklearn ``RandomizedSearchCV(n_iter=50, StratifiedKFold(5),
scoring={accuracy, precision}, refit='accuracy')`` and ``GridSearchCV``
(reference: Models/model_opt_20250130.py:557-561). Works with any estimator
exposing fit/predict(_proba)/get_params/set_params; trials and folds run one
after the other (``train/batched_search.py`` runs them as lanes). The fold
and sampling code is numpy, copied.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from bbbp_tpu_torch.ops import metrics as M
from bbbp_tpu_torch.train.loop import kfold_indices


def stratified_kfold_indices(y: np.ndarray, k: int, seed: int = 42) -> List[np.ndarray]:
    """StratifiedKFold: per-class round-robin assignment after shuffling."""
    y = np.asarray(y)
    rng = np.random.default_rng(seed)
    folds: List[List[int]] = [[] for _ in range(k)]
    for c in np.unique(y):
        idx = np.nonzero(y == c)[0]
        rng.shuffle(idx)
        for i, j in enumerate(idx):
            folds[i % k].append(j)
    return [np.asarray(sorted(f)) for f in folds]


def _score(est, x, y, scoring: str) -> float:
    if scoring == "accuracy":
        return float(M.accuracy(y, est.predict(x)))
    if scoring == "precision":
        return float(M.precision(y, est.predict(x)))
    if scoring == "f1":
        return float(M.f1_score(y, est.predict(x)))
    if scoring == "roc_auc":
        return float(M.roc_auc(y, est.predict_proba(x)[:, 1]))
    if scoring == "r2":
        return float(M.r2_score(y, est.predict(x)))
    if scoring == "neg_mse":
        return -float(M.mse(y, est.predict(x)))
    raise ValueError(f"unknown scoring {scoring!r}")


def _sample_params(dists: Dict, rng) -> Dict:
    out = {}
    for k, v in dists.items():
        if isinstance(v, (list, tuple)):
            out[k] = v[rng.integers(0, len(v))]
        elif isinstance(v, dict) and "low" in v:
            if v.get("log"):
                out[k] = float(np.exp(rng.uniform(np.log(v["low"]), np.log(v["high"]))))
            elif v.get("int"):
                out[k] = int(rng.integers(v["low"], v["high"] + 1))
            else:
                out[k] = float(rng.uniform(v["low"], v["high"]))
        else:
            out[k] = v
    return out


@dataclass
class SearchResult:
    best_params: Dict
    best_score: float
    best_estimator: object
    trials: List[Dict] = field(default_factory=list)   # params + mean scores


class RandomizedSearchCV:
    """Random sampling from distributions; dict-valued scoring with refit key,
    matching the reference's usage pattern."""

    def __init__(self, estimator_factory: Callable[..., object],
                 param_distributions: Dict, n_iter: int = 20, cv: int = 5,
                 scoring="accuracy", refit: Optional[str] = None,
                 stratified: bool = True, seed: int = 42, verbose: bool = False):
        self.factory = estimator_factory
        self.dists = param_distributions
        self.n_iter = n_iter
        self.cv = cv
        self.scoring = scoring if isinstance(scoring, (list, tuple)) else [scoring]
        self.refit = refit or self.scoring[0]
        self.stratified = stratified
        self.seed = seed
        self.verbose = verbose

    def _param_iter(self, rng):
        for _ in range(self.n_iter):
            yield _sample_params(self.dists, rng)

    def fit(self, x, y) -> SearchResult:
        x = np.asarray(x)
        y = np.asarray(y)
        rng = np.random.default_rng(self.seed)
        folds = (stratified_kfold_indices(y, self.cv, self.seed)
                 if self.stratified else kfold_indices(len(y), self.cv, self.seed))
        trials = []
        best = (-np.inf, None)
        for t, params in enumerate(self._param_iter(rng)):
            scores = {s: [] for s in self.scoring}
            for i, va in enumerate(folds):
                tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
                est = self.factory()
                est.set_params(**params)
                est.fit(x[tr], y[tr])
                for s in self.scoring:
                    scores[s].append(_score(est, x[va], y[va], s))
            mean_scores = {s: float(np.mean(v)) for s, v in scores.items()}
            trials.append({**params, **{f"mean_{s}": v for s, v in mean_scores.items()}})
            if self.verbose:
                print(f"[search] trial {t+1}/{self.n_iter} {params} -> {mean_scores}")
            if mean_scores[self.refit] > best[0]:
                best = (mean_scores[self.refit], params)
        final = self.factory()
        final.set_params(**best[1])
        final.fit(x, y)
        return SearchResult(best[1], best[0], final, trials)


class GridSearchCV(RandomizedSearchCV):
    """Exhaustive grid (reference: GridSearchCV for BERT/Flow,
    model_train_bert.py:226-236)."""

    def __init__(self, estimator_factory, param_grid: Dict, cv: int = 3,
                 scoring="accuracy", refit=None, stratified=True, seed=42,
                 verbose=False):
        super().__init__(estimator_factory, param_grid, n_iter=0, cv=cv,
                         scoring=scoring, refit=refit, stratified=stratified,
                         seed=seed, verbose=verbose)

    def _param_iter(self, rng):
        keys = list(self.dists)
        for combo in itertools.product(*[self.dists[k] for k in keys]):
            yield dict(zip(keys, combo))
