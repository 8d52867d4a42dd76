"""Hyperparameter search for the CV-trained NN legs: trials ride the
seed-replica axis of ``train_cv``; the counterpart of
``bbbp_tpu/train/nn_search.py``.

``train_cv`` trains folds × seed replicas as one batched model;
``replica_hparams`` gives each replica its own AdamW ``learning_rate`` /
``weight_decay`` (columns of the optimizer's [K, 1] buffers), so the
replica axis becomes a TRIAL axis — T trials × K folds train in one call,
each trial scored by its own out-of-fold R².

Static architecture hyperparameters (layers/width/fusion) change the model,
so trials are grouped by their static part — one model definition per
group, the lr / weight-decay trials of a group batched.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from bbbp_tpu_torch.ops import metrics
from bbbp_tpu_torch.train.loop import train_cv
from bbbp_tpu_torch.train.search import _sample_params

TRACED_KEYS = ("learning_rate", "weight_decay")


@dataclass
class NNSearchResult:
    best_params: Dict          # static + traced params of the best trial
    best_score: float          # out-of-fold R² of the best trial
    trials: List[Dict]         # every trial's params + oof_r2
    best_oof: np.ndarray       # [N] the best trial's OOF prediction


def search_nn_cv(model_ctor: Callable[..., object],
                 inputs: Sequence[np.ndarray],
                 y: np.ndarray,
                 space: Dict,
                 n_iter: int = 16,
                 n_folds: int = 5,
                 epochs: int = 30,
                 batch_size: int = 32,
                 snapshot_from: Optional[int] = None,
                 seed: int = 0,
                 fold_affine=None,
                 warm_start=None,
                 max_replicas: int = 16,
                 extra_trials: Optional[List[Dict]] = None,
                 verbose: bool = False,
                 device: Union[str, torch.device] = "cuda") -> NNSearchResult:
    """Randomized search over ``space`` for a train_cv-trained model.

    ``space`` keys in TRACED_KEYS sample per-trial optimizer hyperparameters
    (batched on the replica axis); every other key is passed to
    ``model_ctor`` (which returns a port model, e.g. ``functools.partial(
    DualBranchMLP, fp_dim, img_dim)``) and defines a static group. Scoring:
    per-trial OOF R² over the ``n_folds``-fold split.

    ``max_replicas`` caps the folds × trials replica count of one
    ``train_cv`` call: trials chunk to ``max_replicas // n_folds`` a call.
    """
    rng = np.random.default_rng(seed)
    params = list(extra_trials or []) + [
        _sample_params(space, rng) for _ in range(n_iter)]
    n_iter = len(params)
    groups: Dict[Tuple, List[int]] = {}
    for t, p in enumerate(params):
        static = tuple(sorted((k, v) for k, v in p.items()
                              if k not in TRACED_KEYS))
        groups.setdefault(static, []).append(t)

    per_launch = max(1, max_replicas // n_folds)
    scores = np.full(n_iter, -np.inf, np.float32)
    oofs: List[Optional[np.ndarray]] = [None] * n_iter
    for static, t_ids in groups.items():
        static_kw = dict(static)
        model = model_ctor(**static_kw)
        for c0 in range(0, len(t_ids), per_launch):
            chunk = t_ids[c0:c0 + per_launch]
            hp = {k: np.asarray([params[t].get(k, 0.0) for t in chunk],
                                np.float32)
                  for k in TRACED_KEYS
                  if any(k in params[t] for t in chunk)}
            lr0 = float(hp.get("learning_rate", [3e-4])[0])
            if verbose:
                print(f"[nn-search] group {static_kw} x {len(chunk)} trials "
                      f"({n_folds} folds, {epochs} epochs, one train_cv)",
                      flush=True)
            res = train_cv(model, tuple(inputs), y, n_folds=n_folds,
                           epochs=epochs, batch_size=batch_size, lr=lr0,
                           seed=seed, split_seed=seed, n_seeds=len(chunk),
                           snapshot_from=snapshot_from,
                           fold_affine=fold_affine, warm_start=warm_start,
                           replica_hparams=hp, device=device)
            for j, t in enumerate(chunk):
                oof_t = res.oof_seeds[j]
                scores[t] = metrics.regression_report(y, oof_t)["r2"]
                oofs[t] = oof_t
                if verbose:
                    print(f"[nn-search] trial {t}: r2={scores[t]:.4f} "
                          f"{params[t]}", flush=True)

    best = int(np.argmax(scores))
    trials = [{**p, "oof_r2": float(s)} for p, s in zip(params, scores)]
    return NNSearchResult(params[best], float(scores[best]), trials,
                          oofs[best])
