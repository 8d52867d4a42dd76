"""Flow-MLP classifier pipeline (family D, FL1-FL2): the counterpart of
``bbbp_tpu/train/flow_pipeline.py`` on ``device``.

Reference (Descriptors/model_train_flow.py:108-302): sklearn-compatible
``FlowClassifier`` (fit/predict/evaluate/save/load/get_params/set_params)
around the FlowModel, trained via GridSearchCV over
{hidden_dim, n_layers, epochs, batch, lr}; ``do_flow_train`` runs
fingerprints → scaler → PCA(100) → split → search → metrics.

One model (K = 1, ``models/flow.py``): plain Adam (AdamW with weight decay
0, as ``optax.adam``), softmax cross-entropy, batches from numpy's
``default_rng(seed)`` as the JAX package draws them, the initial parameters
and dropout from a ``torch.Generator``. ``save`` writes the JAX package's
pickle ({"config", "params": a flax-layout numpy tree}); ``load`` reads
either package's.
"""

from __future__ import annotations

import argparse
import json
import pickle
import time
from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from bbbp_tpu_torch.models.flow import FlowModel
from bbbp_tpu_torch.ops.forest_train import resolve_device
from bbbp_tpu_torch.ops.pca import PCA
from bbbp_tpu_torch.ops.scaler import StandardScaler


class FlowClassifier:
    """fit/predict wrapper over models.flow.FlowModel (reference FL2).
    ``device`` is not a parameter of ``get_params``: the saved config stays
    the JAX package's."""

    PARAMS = ("hidden_dim", "n_layers", "epochs", "batch_size", "lr",
              "dropout", "seed")

    def __init__(self, hidden_dim: int = 128, n_layers: int = 3,
                 epochs: int = 20, batch_size: int = 64, lr: float = 1e-3,
                 dropout: float = 0.1, seed: int = 0, device="cuda"):
        self.hidden_dim = hidden_dim
        self.n_layers = n_layers
        self.epochs = epochs
        self.batch_size = batch_size
        self.lr = lr
        self.dropout = dropout
        self.seed = seed
        self.device = device
        self.model: Optional[FlowModel] = None

    def get_params(self, deep=True):
        return {k: getattr(self, k) for k in self.PARAMS}

    def set_params(self, **p):
        for k, v in p.items():
            setattr(self, k, v)
        return self

    def fit(self, x, y) -> "FlowClassifier":
        from bbbp_tpu_torch.train.loop import AdamW

        dev = resolve_device(self.device)
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.int32)
        n_classes = int(y.max()) + 1
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.model = model = FlowModel(
            x.shape[1], hidden_dim=self.hidden_dim, n_layers=self.n_layers,
            n_classes=max(2, n_classes), dropout=self.dropout, device=dev,
            generator=gen)
        params = list(model.parameters())
        opt = AdamW(params, self.lr, weight_decay=0.0)

        n = len(y)
        bs = min(self.batch_size, n)
        steps = max(1, n // bs)
        host_rng = np.random.default_rng(self.seed)
        xd = torch.as_tensor(x, device=dev)
        yd = torch.as_tensor(y, dtype=torch.int64, device=dev)
        for _ in range(self.epochs):
            perm = host_rng.permutation(n)[: steps * bs].reshape(steps, bs)
            perm = torch.as_tensor(perm, device=dev)
            for s in range(steps):
                b = perm[s]
                logits = model(xd[b], train=True, generator=gen)
                loss = F.cross_entropy(logits, yd[b])
                opt.step(torch.autograd.grad(loss, params))
        return self

    @torch.no_grad()
    def _logits(self, x) -> np.ndarray:
        xd = torch.as_tensor(np.asarray(x, np.float32),
                             device=self.model.head.kernel.device)
        return self.model(xd).cpu().numpy()

    def predict_proba(self, x) -> np.ndarray:
        z = self._logits(x)
        e = np.exp(z - z.max(1, keepdims=True))
        return e / e.sum(1, keepdims=True)

    def predict(self, x) -> np.ndarray:
        return self._logits(x).argmax(1)

    def evaluate(self, x, y) -> Dict[str, float]:
        from bbbp_tpu_torch.ops import metrics

        proba = self.predict_proba(x)[:, 1]
        pred = self.predict(x)
        return metrics.classification_report(np.asarray(y), pred, proba)

    @property
    def params_(self):
        """The trained parameters as a flax params tree of numpy arrays."""
        from bbbp_tpu_torch.models.convert import flax_from_params

        return flax_from_params(self.model)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump({"config": self.get_params(), "params": self.params_}, f)

    @staticmethod
    def load(path: str, device="cuda") -> "FlowClassifier":
        from bbbp_tpu_torch.models.convert import load_flax

        with open(path, "rb") as f:
            d = pickle.load(f)
        clf = FlowClassifier(**d["config"], device=device)
        d_in = np.asarray(d["params"]["in_proj"]["kernel"]).shape[0]
        clf.model = load_flax(FlowModel(
            d_in, hidden_dim=clf.hidden_dim, n_layers=clf.n_layers, n_classes=2,
            dropout=clf.dropout, device=resolve_device(device)), d["params"])
        return clf


@dataclass
class FlowTrainConfig:
    fp_kind: str = "morgan"
    pca_dim: int = 100
    test_size: float = 0.2
    grid: Optional[Dict] = None
    cv: int = 3
    seed: int = 42
    workers: Optional[int] = None
    limit: Optional[int] = None


def do_flow_train(cfg: FlowTrainConfig = FlowTrainConfig(), verbose: bool = True,
                  device: Union[str, torch.device] = "cuda"):
    """The reference's do_flow_train (:225-302) on ``device``."""
    from bbbp_tpu_torch.chem.featurize import fingerprints
    from bbbp_tpu_torch.data.b3db import load_b3db_classification
    from bbbp_tpu_torch.train.search import GridSearchCV

    dev = resolve_device(device)
    t0 = time.time()
    data = load_b3db_classification()
    smiles, y = data.smiles, data.labels
    if cfg.limit:
        smiles, y = smiles[: cfg.limit], y[: cfg.limit]
    fp = fingerprints(smiles, kind=cfg.fp_kind, workers=cfg.workers)
    with torch.no_grad():
        x = StandardScaler().fit_transform(
            torch.as_tensor(fp.features[fp.ok_mask], device=dev))
        x = PCA(min(cfg.pca_dim, x.shape[0], x.shape[1])).fit_transform(x
                                                                        ).cpu().numpy()
    y = y[fp.ok_mask]
    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(len(y))
    n_test = int(len(y) * cfg.test_size)
    te, tr = perm[:n_test], perm[n_test:]

    def factory():
        return FlowClassifier(device=dev)

    if cfg.grid:
        search = GridSearchCV(factory, cfg.grid, cv=cfg.cv,
                              scoring=["accuracy"], seed=cfg.seed,
                              verbose=verbose)
        res = search.fit(x[tr], y[tr])
        clf = res.best_estimator
    else:
        clf = factory().fit(x[tr], y[tr])
    report = clf.evaluate(x[te], y[te])
    if verbose:
        print("[flow] " + " ".join(f"{k}={v:.4f}" for k, v in report.items()))
    return clf, report, time.time() - t0


def main():
    ap = argparse.ArgumentParser(description="Flow-MLP classifier (FL1-FL2)")
    ap.add_argument("--fp-kind", default="morgan")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    _, report, _ = do_flow_train(FlowTrainConfig(fp_kind=args.fp_kind,
                                                 limit=args.limit),
                                 device=args.device)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)


if __name__ == "__main__":
    main()
