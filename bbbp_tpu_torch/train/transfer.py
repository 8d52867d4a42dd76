"""Cross-task transfer features: P(BBB+) learned on the B3DB classification
set, predicted for regression molecules.

Counterpart of ``bbbp_tpu/train/transfer.py``, with the same configuration,
result and ``.npz`` cache files (either package reads what the other
wrote); ``transfer_features`` adds a ``device`` (``cuda`` unless the caller
asks for ``cpu``).

The classification set is ~6.4x the regression set and mostly disjoint from
it. Models trained on the disjoint part carry extra information about the
BBB boundary that no regression-set leg can learn from ~1,000 rows.

Leak hygiene: the aux training set excludes every molecule that could be a
regression row, matched three ways (any hit drops the row):
  1. a non-empty numeric ``logBB`` value in the classification TSV (B3DB's
     own marker that the row came from the regression table),
  2. exact InChI match against the regression TSV's ``Inchi`` column,
  3. standardized canonical SMILES match (chem.standardize strips salts and
     neutralizes, so salt/charge variants of a regression molecule are
     caught too).
The aux models never see any regression molecule or label, so their
probability outputs on regression molecules are pure functions of structure.

Aux models (one fit each, on the device):
  gbdt / oblivious / rf  — ops.forest_train classifiers on
                           [physchem descriptors | MACCS bits | PCA-128 of
                           Morgan counts]
  tknn                   — Tanimoto-kNN classifier on raw MACCS bits
                           (ops.similarity)

A 10% holdout AUC per model is reported (then the model is refit on the
full aux set) so the transfer quality is measured, not asserted.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from bbbp_tpu_torch.chem.featurize import descriptors, fingerprints
from bbbp_tpu_torch.data.b3db import (is_numeric, load_b3db_classification,
                                      load_b3db_regression)
from bbbp_tpu_torch.ops.forest_train import resolve_device
from bbbp_tpu_torch.ops.pca import PCA
from bbbp_tpu_torch.ops.scaler import StandardScaler


@dataclass
class TransferConfig:
    models: Tuple[str, ...] = ("gbdt", "oblivious", "rf", "tknn")
    morgan_pca_dim: int = 128
    trees: int = 400
    depth: int = 6
    learning_rate: float = 0.08
    rf_trees: int = 300
    rf_depth: int = 10
    tknn_k: int = 25
    holdout_frac: float = 0.1     # honest aux-quality AUC; 0 disables
    seed: int = 7
    cache_dir: Optional[str] = None   # also via BBBP_TRANSFER_CACHE


@dataclass
class TransferResult:
    features: np.ndarray          # [N_reg, K] P(BBB+) columns
    names: List[str]
    holdout_auc: Dict[str, float]
    n_aux: int                    # aux rows after exclusion
    n_excluded: int
    # wall seconds by stage (featurize, basis, <model>_holdout, <model>_fit,
    # <model>_predict); empty for a result read from the cache
    seconds: Dict[str, float] = field(default_factory=dict)


def _auc(y: np.ndarray, s: np.ndarray) -> float:
    """Rank AUC (Mann-Whitney)."""
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(len(s))
    ranks[order] = np.arange(1, len(s) + 1)
    # average ties
    s_sorted = s[order]
    i = 0
    while i < len(s):
        j = i
        while j + 1 < len(s) and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j + 2) / 2.0
        i = j + 1
    pos = y > 0
    n1, n0 = int(pos.sum()), int((~pos).sum())
    if n1 == 0 or n0 == 0:
        return float("nan")
    return float((ranks[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def _std_smiles(smiles: Sequence[str]) -> List[Optional[str]]:
    from bbbp_tpu_torch.chem.standardize import standardize_smiles

    out = []
    for s in smiles:
        try:
            out.append(standardize_smiles(s))
        except Exception:  # noqa: BLE001 - quarantine semantics
            out.append(None)
    return out


def aux_classification_set(verbose: bool = False):
    """(smiles, labels, n_excluded): the classification set minus every
    possible regression-set molecule (see module doc for the 3 matchers)."""
    cls = load_b3db_classification()
    reg = load_b3db_regression()
    # 1. B3DB's own provenance marker: numeric logBB => regression-derived row
    drop = np.asarray([is_numeric(v) for v in cls.logbb], dtype=bool)
    # 2. exact InChI match
    reg_inchi = {v for v in reg.inchi if v is not None}
    drop |= np.asarray([v is not None and v in reg_inchi for v in cls.inchi],
                       dtype=bool)
    # 3. standardized canonical SMILES match (salt/charge variants)
    reg_std = {c for c in _std_smiles(reg.smiles) if c}
    cls_std = _std_smiles(cls.smiles)
    drop |= np.asarray([c is not None and c in reg_std for c in cls_std],
                       dtype=bool)
    keep = ~drop
    smiles = [s for s, k in zip(cls.smiles, keep) if k]
    labels = cls.labels[keep]
    if verbose:
        print(f"[transfer] aux set: {len(smiles)} molecules "
              f"({int(drop.sum())} excluded as possible regression rows; "
              f"{labels.mean():.3f} BBB+)")
    return smiles, labels.astype(np.float32), int(drop.sum())


def raw_transfer_features(smiles: Sequence[str],
                          workers: Optional[int] = None,
                          cache_dir: Optional[str] = None):
    """(descriptors, maccs, morgan_counts) for a molecule list, disk-cached
    by content hash. The descriptors and the counts come from the Python
    featurizer, over ``workers`` processes (None: one a core)."""
    cache_dir = cache_dir or os.environ.get("BBBP_TRANSFER_CACHE")
    cpath = None
    smiles = list(smiles)
    if cache_dir:
        key = hashlib.sha1(("\n".join(smiles)).encode()).hexdigest()[:16]
        cpath = os.path.join(cache_dir, f"rawfeat_{key}.npz")
        if os.path.exists(cpath):
            z = np.load(cpath)
            return z["desc"], z["maccs"], z["counts"]
    desc = descriptors(smiles, workers=workers).features
    maccs = fingerprints(smiles, kind="maccs", workers=workers).features
    counts = fingerprints(smiles, kind="morgan_counts",
                          workers=workers).features.astype(np.float32)
    if cpath:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(cpath, desc=desc, maccs=maccs, counts=counts)
    return desc, maccs, counts


def _aux_feature_basis(smiles: Sequence[str], morgan_pca_dim: int,
                       workers: Optional[int] = None,
                       cache_dir: Optional[str] = None,
                       device: Union[str, torch.device] = "cuda", raw=None):
    """Fit the aux feature transform (scaler + Morgan-count PCA) on the aux
    molecules, on ``device``, and return (x, maccs, apply). ``apply``
    re-applies the same transform to any other molecule list (the
    regression set): everything is fit on aux rows only. ``raw`` is a list's
    ``raw_transfer_features`` where the caller already has them."""
    device = resolve_device(device)
    desc, maccs, counts = raw or raw_transfer_features(smiles, workers,
                                                       cache_dir)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    dsc = StandardScaler().fit(dev(desc))
    csc = StandardScaler().fit(dev(counts))
    k = min(morgan_pca_dim, counts.shape[0], counts.shape[1])
    pca = PCA(k).fit(csc.transform(dev(counts)))

    def assemble(d2, m2, c2):
        return np.concatenate(
            [dsc.transform(dev(d2)).cpu().numpy(), m2.astype(np.float32),
             pca.transform(csc.transform(dev(c2))).cpu().numpy()],
            axis=1).astype(np.float32)

    def apply(s2: Sequence[str], raw=None):
        d2, m2, c2 = raw or raw_transfer_features(s2, workers, cache_dir)
        return assemble(d2, m2, c2), m2
    return assemble(desc, maccs, counts), maccs, apply


def _make_model(name: str, cfg: TransferConfig, seed: int,
                device: Union[str, torch.device] = "cuda"):
    from bbbp_tpu_torch.ops.forest_train import (GBDTClassifier,
                                                 RandomForestClassifier)
    from bbbp_tpu_torch.ops.similarity import TanimotoKNNClassifier

    if name == "gbdt":
        return GBDTClassifier(n_estimators=cfg.trees,
                              learning_rate=cfg.learning_rate,
                              max_depth=cfg.depth, subsample=0.8,
                              seed=seed, device=device)
    if name == "oblivious":
        return GBDTClassifier(n_estimators=cfg.trees,
                              learning_rate=cfg.learning_rate,
                              max_depth=cfg.depth, oblivious=True,
                              subsample=0.8, seed=seed, device=device)
    if name == "rf":
        return RandomForestClassifier(n_estimators=cfg.rf_trees,
                                      max_depth=cfg.rf_depth, seed=seed,
                                      device=device)
    if name == "tknn":
        return TanimotoKNNClassifier(n_neighbors=cfg.tknn_k, device=device)
    raise ValueError(f"unknown transfer model {name!r}")


def transfer_features(reg_smiles: Sequence[str],
                      cfg: TransferConfig = TransferConfig(),
                      workers: Optional[int] = None,
                      aux_data: Optional[Tuple[Sequence[str], np.ndarray]] = None,
                      verbose: bool = True,
                      device: Union[str, torch.device] = "cuda"
                      ) -> TransferResult:
    """Train the aux models on ``device`` and return their P(BBB+) for
    ``reg_smiles``.

    ``aux_data`` overrides the aux training set (smiles, labels); the
    default is the leak-screened B3DB classification set.

    Results are cached (keyed by config + molecules) because the output is
    deterministic; the key does not name the device."""
    device = resolve_device(device)
    reg_smiles = list(reg_smiles)
    cache_dir = cfg.cache_dir or os.environ.get("BBBP_TRANSFER_CACHE")
    cpath = None
    if cache_dir:
        key = hashlib.sha1(
            (repr(sorted(cfg.__dict__.items())) + "\n".join(reg_smiles)
             ).encode()).hexdigest()[:16]
        cpath = os.path.join(cache_dir, f"transfer_{key}.npz")
        if os.path.exists(cpath):
            z = np.load(cpath, allow_pickle=True)
            return TransferResult(z["features"], list(z["names"]),
                                  json.loads(str(z["auc"])),
                                  int(z["n_aux"]), int(z["n_excluded"]))
    t0 = time.time()
    seconds: Dict[str, float] = {}

    def timed(stage: str, since: float) -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.time()
        seconds[stage] = seconds.get(stage, 0.0) + now - since
        return now

    if aux_data is not None:
        aux_smiles, aux_y, n_excl = (list(aux_data[0]),
                                     np.asarray(aux_data[1], np.float32), 0)
    else:
        aux_smiles, aux_y, n_excl = aux_classification_set(verbose=verbose)
    # both lists are featurized before the device is touched
    raw_aux = raw_transfer_features(aux_smiles, workers, cache_dir)
    raw_reg = raw_transfer_features(reg_smiles, workers, cache_dir)
    t = timed("featurize", t0)
    aux_x, aux_maccs, apply_basis = _aux_feature_basis(
        aux_smiles, cfg.morgan_pca_dim, workers, cache_dir, device,
        raw=raw_aux)
    reg_x, reg_maccs = apply_basis(reg_smiles, raw=raw_reg)
    aux_bits = (aux_maccs > 0).astype(np.float32)
    reg_bits = (reg_maccs > 0).astype(np.float32)
    t = timed("basis", t)
    if verbose:
        print(f"[transfer] aux features {aux_x.shape} "
              f"({time.time()-t0:.0f}s featurize)")

    rng = np.random.default_rng(cfg.seed)
    n = len(aux_y)
    perm = rng.permutation(n)
    n_hold = int(round(cfg.holdout_frac * n))
    hold, tr = perm[:n_hold], perm[n_hold:]

    cols, names, aucs = [], [], {}
    w_tr = np.ones(n, np.float32)
    w_tr[hold] = 0.0
    for name in cfg.models:
        x, xb = (aux_bits, reg_bits) if name == "tknn" else (aux_x, reg_x)
        t = time.time()
        if n_hold:
            # forest models: holdout via sample_weight=0 on the full matrix,
            # as the reference fits them
            if name == "tknn":
                m = _make_model(name, cfg, cfg.seed, device).fit(x[tr], aux_y[tr])
            else:
                m = _make_model(name, cfg, cfg.seed, device).fit(
                    x, aux_y, sample_weight=w_tr)
            p_hold = m.predict_proba(x[hold])[:, 1]
            aucs[name] = _auc(aux_y[hold], p_hold)
            t = timed(f"{name}_holdout", t)
            if verbose:
                print(f"[transfer] {name}: holdout AUC={aucs[name]:.4f} "
                      f"({n_hold} held out)")
        m = _make_model(name, cfg, cfg.seed, device).fit(x, aux_y)
        t = timed(f"{name}_fit", t)
        cols.append(m.predict_proba(xb)[:, 1].astype(np.float32))
        timed(f"{name}_predict", t)
        names.append(f"transfer_{name}")
    feats = np.stack(cols, axis=1)
    res = TransferResult(feats, names, aucs, n, n_excl, seconds)
    if cpath:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(cpath, features=feats, names=np.asarray(names),
                 auc=json.dumps(aucs), n_aux=n, n_excluded=n_excl)
    if verbose:
        print(f"[transfer] done: {feats.shape} in {time.time()-t0:.0f}s")
    return res
