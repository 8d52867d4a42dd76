"""Weighted-ensemble regression variants (families B2/B4): the counterpart
of ``bbbp_tpu/train/weighted_ensemble.py`` on ``device``.

Reference: ``Models/multi_input_data_regression_opt.py:140-156`` — final
prediction 0.7·NN + 0.1·RF + 0.2·XGB over 5-fold CV — and the B4 variant
(``Models/multi_input_data_regression_opt_round_2.py:97-98,170-193``) with
weights 0.4/0.3/0.3 and a 'rounding accuracy' metric (prediction counted
correct when it matches the label rounded to 2 decimals).

The NN is ``models/mlp.py::DualBranchMLP`` through ``train_cv`` (all folds
at once, BatchNorm's running statistics per fold); the RF and XGB legs are
the device forest trainer's ``RandomForestRegressor`` and ``GBDTRegressor``
(``ops/forest_train.py``: K3, K4, K5, predictions through the forest
kernel). At the defaults the image branch's first layer is 49,152 → 1,024
on 5 folds: ~250 M f32 parameters, ~4 GB with AdamW's moments and the
gradients.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from bbbp_tpu_torch.models.mlp import DualBranchMLP
from bbbp_tpu_torch.ops import metrics
from bbbp_tpu_torch.ops.forest_train import (GBDTRegressor,
                                             RandomForestRegressor,
                                             resolve_device)
from bbbp_tpu_torch.pipelines.preprocess import (PreprocessConfig, ProcessedData,
                                                 preprocess_regression)
from bbbp_tpu_torch.train.loop import train_multimodal_cv


def rounding_accuracy(y_true, y_pred, decimals: int = 2) -> float:
    """The B4 'accuracy' quirk: exact match after rounding
    (reference: ..._round_2.py:97-98)."""
    return float(np.mean(np.round(y_pred, decimals) == np.round(y_true, decimals)))


@dataclass
class WeightedEnsembleConfig:
    weights: Tuple[float, float, float] = (0.7, 0.1, 0.2)   # NN, RF, XGB (B2)
    n_folds: int = 5
    epochs: int = 40
    lr: float = 3e-4
    fp_kind: str = "maccs"
    image_size: int = 128
    seed: int = 42
    workers: Optional[int] = None


def run_weighted_ensemble(cfg: WeightedEnsembleConfig = WeightedEnsembleConfig(),
                          data: Optional[ProcessedData] = None,
                          verbose: bool = True,
                          device: Union[str, torch.device] = "cuda"
                          ) -> Dict[str, Dict[str, float]]:
    dev = resolve_device(device)
    if data is None:
        data = preprocess_regression(PreprocessConfig(
            fp_kind=cfg.fp_kind, image_size=cfg.image_size,
            workers=cfg.workers, seed=cfg.seed), device=dev)
    n = len(data.y)
    y = data.y
    img_flat = data.img_norm
    model = DualBranchMLP(data.fp_norm.shape[1], img_flat.shape[1])
    nn_res = train_multimodal_cv(model, data.fp_norm, img_flat, y,
                                 n_folds=cfg.n_folds, epochs=cfg.epochs,
                                 batch_size=32, lr=cfg.lr, seed=cfg.seed,
                                 device=dev)
    folds = nn_res.fold_test_idx
    xt = np.concatenate([data.fp_norm, data.fp_pca, data.img_pca], 1).astype(np.float32)
    rf_oof = np.zeros(n, np.float32)
    xgb_oof = np.zeros(n, np.float32)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        rf_oof[te] = RandomForestRegressor(
            n_estimators=200, max_depth=10, seed=cfg.seed + i, device=dev
        ).fit(xt[tr], y[tr]).predict(xt[te])
        xgb_oof[te] = GBDTRegressor(
            n_estimators=300, learning_rate=0.03, max_depth=6, subsample=0.8,
            seed=cfg.seed + i, device=dev
        ).fit(xt[tr], y[tr]).predict(xt[te])
    w = cfg.weights
    blend = w[0] * nn_res.oof_pred + w[1] * rf_oof + w[2] * xgb_oof
    report = {
        "nn": metrics.regression_report(y, nn_res.oof_pred),
        "rf": metrics.regression_report(y, rf_oof),
        "xgb": metrics.regression_report(y, xgb_oof),
        "ensemble": {**metrics.regression_report(y, blend),
                     "rounding_accuracy": rounding_accuracy(y, blend)},
    }
    if verbose:
        for k, r in report.items():
            print(f"[weighted] {k:9s} " + " ".join(f"{kk}={vv:.4f}" for kk, vv in r.items()))
    return report


def main():
    ap = argparse.ArgumentParser(description="Weighted ensemble regression (B2/B4)")
    ap.add_argument("--weights", nargs=3, type=float, default=[0.7, 0.1, 0.2])
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    rep = run_weighted_ensemble(WeightedEnsembleConfig(
        weights=tuple(args.weights), n_folds=args.folds, epochs=args.epochs),
        device=args.device)
    print(json.dumps(rep, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=2)


if __name__ == "__main__":
    main()
