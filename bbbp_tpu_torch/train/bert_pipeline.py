"""SMILES-BERT training pipeline (family C entry point): the counterpart of
``bbbp_tpu/train/bert_pipeline.py`` on ``device``.

Reference protocol (Models/model_train_bert.py:189-254 ``do_bert_train``):
fingerprints → StandardScaler → PCA(100) → **stringified vectors** into the
tokenizer (the C3 quirk) → train_test_split → GridSearchCV over
{epochs, batch, lr} with 3-fold CV → 8-metric evaluation + learning curve →
save_pretrained.

Default here trains on **raw SMILES** (the sensible input);
``input_mode='compat_vector'`` reproduces the quirk: the tokenizer reads
``str(row)`` of a numpy float32 row, as the JAX package's does (a tensor,
or f64, prints other text), so the PCA's output comes back to the host as
f32 numpy before it is stringified.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch

from bbbp_tpu_torch.chem.featurize import fingerprints
from bbbp_tpu_torch.data.b3db import load_b3db_classification
from bbbp_tpu_torch.models.bert import BertClassifier
from bbbp_tpu_torch.ops.forest_train import resolve_device
from bbbp_tpu_torch.ops.pca import PCA
from bbbp_tpu_torch.ops.scaler import StandardScaler
from bbbp_tpu_torch.train.search import GridSearchCV


@dataclass
class BertTrainConfig:
    input_mode: str = "smiles"          # smiles | compat_vector
    fp_kind: str = "morgan"             # used by compat_vector mode
    pca_dim: int = 100
    test_size: float = 0.2
    grid: Optional[Dict] = None         # e.g. {"epochs":[3,5], "lr":[2e-4]}
    cv: int = 3
    epochs: int = 4
    batch_size: int = 32
    lr: float = 2e-4
    seed: int = 42
    workers: Optional[int] = None
    limit: Optional[int] = None
    pretrained_dir: Optional[str] = None   # MLM-pretrained encoder directory
                                           # (train.bert_pretrain); smiles mode


def run_bert(cfg: BertTrainConfig = BertTrainConfig(), verbose: bool = True,
             device: Union[str, torch.device] = "cuda"):
    dev = resolve_device(device)
    t0 = time.time()
    data = load_b3db_classification()
    smiles = data.smiles
    y = data.labels
    if cfg.limit:
        smiles, y = smiles[: cfg.limit], y[: cfg.limit]

    if cfg.input_mode == "compat_vector":
        fp = fingerprints(smiles, kind=cfg.fp_kind, workers=cfg.workers)
        with torch.no_grad():
            x_feats = StandardScaler().fit_transform(
                torch.as_tensor(fp.features[fp.ok_mask], device=dev))
            x = PCA(cfg.pca_dim).fit_transform(x_feats).cpu().numpy()
        y = y[fp.ok_mask]
    else:
        x = np.asarray(smiles, dtype=object)

    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(len(y))
    n_test = int(len(y) * cfg.test_size)
    te, tr = perm[:n_test], perm[n_test:]

    def factory():
        return BertClassifier(epochs=cfg.epochs, batch_size=cfg.batch_size,
                              lr=cfg.lr, input_mode=cfg.input_mode,
                              seed=cfg.seed,
                              pretrained_dir=cfg.pretrained_dir, device=dev)

    if cfg.grid:
        search = GridSearchCV(factory, cfg.grid, cv=cfg.cv,
                              scoring=["accuracy"], seed=cfg.seed,
                              verbose=verbose)
        res = search.fit(x[tr], y[tr])
        clf = res.best_estimator
        if verbose:
            print(f"[bert] best params {res.best_params} cv_acc={res.best_score:.4f}")
    else:
        clf = factory().fit(x[tr], y[tr])

    report = clf.evaluate(x[te], y[te])
    if verbose:
        print("[bert] test: " + " ".join(f"{k}={v:.4f}" for k, v in report.items()))
    return clf, report, time.time() - t0


def main():
    ap = argparse.ArgumentParser(description="SMILES-BERT classifier (C1-C3)")
    ap.add_argument("--input-mode", default="smiles",
                    choices=["smiles", "compat_vector"])
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--save", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--pretrained", default=None,
                    help="MLM-pretrained encoder dir (train.bert_pretrain)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    cfg = BertTrainConfig(input_mode=args.input_mode, epochs=args.epochs,
                          lr=args.lr, limit=args.limit,
                          pretrained_dir=args.pretrained)
    clf, report, wall = run_bert(cfg, device=args.device)
    print(json.dumps(report, indent=2))
    if args.save:
        clf.save(args.save)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)


if __name__ == "__main__":
    main()
