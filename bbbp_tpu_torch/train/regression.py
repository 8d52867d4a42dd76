"""Final regression pipeline (family B7): 10-fold CV of the multimodal NN +
graph NN + forest surrogates, OOF stacking with a linear meta-learner; the
counterpart of ``bbbp_tpu/train/regression.py`` with a ``device`` (``cuda``
unless the caller asks for ``cpu``), which every estimator, the
preprocessing and ``train_cv`` get.

Reference protocol (Models/multi_input_data_regression_opt_transformer_cnn_20250113.py:130-415):
per fold train the Transformer+CNN net (50 epochs), RF(300, d30),
XGBoost(300, lr .01, d30, hist) and CatBoost(300, lr .01, d10); write each
model's test-fold predictions into OOF arrays; fit
StackingRegressor(final=LinearRegression) on the [N, 4] OOF matrix; report
MSE/R² of the stacked prediction over the whole OOF set.

Here the NN trains all folds at once (``train/loop.py``); an edge-featured
MPNN graph leg (``models/gnn.py``) trains the same way; the tree legs use
the device forest trainer (``ops/forest_train.py``: RF / GBDT /
oblivious-GBDT as the XGB / CatBoost surrogates, K3, K4 and K5, predictions
through the forest kernel), seed-bagged; the chemistry-kernel legs run K6,
K7 and K8 (``ops/similarity.py``); the meta-learner is the closed-form
LinearRegression (``ops/linear.py``). The run computes its f32 products
with TF32 off (``ops/similarity.py::f32_matmul``); ``train_cv`` computes in
bf16.

Protocols (SURVEY §2.3 quirks + ADVICE round-1 leakage findings):
- ``compat``  — per-100-row standardization on the label-correlated row order
  (the reference's published-artifact pipeline; leaks heavily, kept for parity).
- ``honest``  — one global scaler/PCA fit over all rows before the fold split
  (the reference's *structure* minus the per-batch quirk; the remaining
  transductive leak is unsupervised-only). Meta-learner fit in-sample on the
  OOF matrix like the reference (:394-403); a cross-fitted stacked metric is
  reported alongside.
- ``strict``  — NO test-row influence anywhere: scaler/PCA/aux-PCA are re-fit
  per fold on train rows only (NN inputs via per-fold affine transforms inside
  the batched loop — no K data copies), the kernel legs re-fit every statistic
  (descriptor scaler, RBF bandwidth, IDF weights) per fold, and the reported
  stacked metric is the cross-fitted one.

Options beyond the defaults, as the JAX package has them: the SMILES-encoder
leg (``bert_leg``: ``models/bert.py::BertRegressor`` through ``train_cv``,
warm-started from an MLM-pretrained directory of either package,
``train/bert_pretrain.py``) and the NN and graph legs' warm starts from aux
pretraining (``nn_pretrained``, ``graph_pretrained``: pickles of
``train/aux_pretrain.py``, the output layer dropped). ``out_dir`` gets the
metrics CSV and the OOF pickle; the figures and the NN checkpoint wait for
``reporting/plots.py`` and ``utils/checkpoint.py``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pickle
import time
import traceback
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from bbbp_tpu_torch.chem.featurize import fingerprints
from bbbp_tpu_torch.chem.graph_features import graph_features
from bbbp_tpu_torch.models.bert import BertRegressor, SmilesTokenizer, read_pretrained
from bbbp_tpu_torch.models.gnn import MPNNRegressor
from bbbp_tpu_torch.models.transformer_cnn import MultiModalRegressor
from bbbp_tpu_torch.ops import metrics
from bbbp_tpu_torch.ops.forest_train import (GBDTRegressor,
                                             RandomForestRegressor,
                                             resolve_device)
from bbbp_tpu_torch.ops.linear import (KNeighborsRegressor, LinearRegression,
                                       NonNegativeLinearRegression, Ridge,
                                       RidgeCV)
from bbbp_tpu_torch.ops.pca import PCA
from bbbp_tpu_torch.ops.scaler import StandardScaler
from bbbp_tpu_torch.ops.similarity import (ChemKernelRidge, TanimotoKernelRidge,
                                           TanimotoKNNRegressor, f32_matmul)
from bbbp_tpu_torch.pipelines.preprocess import (PreprocessConfig,
                                                 ProcessedData,
                                                 preprocess_regression)
from bbbp_tpu_torch.train.aux_pretrain import load_warm_start
from bbbp_tpu_torch.train.loop import kfold_indices, train_cv
from bbbp_tpu_torch.train.transfer import raw_transfer_features

@dataclass
class RegressionTrainConfig:
    fp_kind: str = "maccs"
    protocol: str = "honest"     # compat | honest | strict (see module doc)
    n_folds: int = 10
    epochs: int = 50
    batch_size: int = 32
    lr: float = 3e-4
    n_layers: int = 4
    fusion: str = "multihead"
    fp_tokens: int = 1
    nn_input: str = "norm"       # norm | pca — B8's PCA-compressed variant
    nn_seeds: int = 3            # deep-ensemble width on the batched fold axis
    snapshot_from: Optional[int] = 30   # SWA-style epoch snapshot averaging
    patience: Optional[int] = None      # B3 early stopping (disables snapshots)
    seed: int = 42
    # graph leg: edge-featured MPNN over the own graph featurizer
    # (round-2 sweep: hidden 192 × 5 layers × 100 epochs @ 7e-4 beat the
    # 128×4×60 default by +0.026 OOF R²)
    graph_leg: bool = True
    graph_epochs: int = 100
    graph_seeds: int = 2
    graph_hidden: int = 192
    graph_layers: int = 5
    graph_lr: float = 7e-4
    max_atoms: int = 128
    # supervised aux-classification pretraining (train/aux_pretrain.py):
    # paths to pretrained-trunk pickles; folds warm-start from the trunk
    # with the output head dropped (same mechanism as the MLM-pretrained
    # SMILES leg)
    graph_pretrained: Optional[str] = None
    nn_pretrained: Optional[str] = None
    # SMILES-encoder leg (MLM-pretrained transformer, models/bert.py)
    bert_leg: bool = False
    bert_pretrained_dir: Optional[str] = None
    bert_epochs: int = 40
    bert_seeds: int = 2
    bert_lr: float = 2e-4
    bert_d_model: int = 128
    bert_layers: int = 4
    # forest legs (reference hyperparameters :262-391, re-tuned for the
    # engine by the round-2 on-device sweep: 32-config CV search favored
    # lr 0.05 d6 for the GBDT and lr 0.08 d6 oblivious for the CatBoost
    # surrogate on the enriched features)
    rf_trees: int = 300
    rf_depth: int = 10
    rf_colsample: float = 1.0
    rf_lambda: float = 1e-6
    gbdt_trees: int = 400
    gbdt_lr: float = 0.05
    gbdt_depth: int = 6
    gbdt_subsample: float = 0.8
    gbdt_colsample: float = 1.0
    gbdt_lambda: float = 1.0
    cat_trees: int = 400
    cat_lr: float = 0.08
    cat_depth: int = 6
    cat_subsample: float = 0.8
    cat_colsample: float = 1.0
    cat_lambda: float = 1.0
    tree_seeds: int = 3          # seed-bagged forests per fold
    # extra GBDT legs on alternative fingerprint bit spaces (+ raw
    # descriptors): trees on a different bit space split differently, so
    # the OOF errors decorrelate from the maccs-matrix forests. Features
    # are raw bits + raw physchem descriptors (no fitted transforms), hence
    # valid under every protocol.
    fp_tree_legs: tuple = ()     # e.g. ("morgan",); leg name "gbdt_<kind>"
    tree_raw_fp: bool = False    # feed trees the raw wide fingerprint bits
                                 # instead of a PCA-256 compression
    meta: str = "linear"          # linear | ridge | ridgecv | nnls
    split_repeats: int = 1        # repeated-CV averaging for the tree/kernel/
                                  # shallow legs: extra kfold splits (new
                                  # seeds) whose OOF predictions average into
                                  # the leg columns. Every repeat's prediction
                                  # for row i comes from a model that never
                                  # saw row i, so the average stays honest;
                                  # it removes fold-assignment variance.
                                  # honest/compat only (strict per-fold
                                  # features are built for the primary split)
    extra_legs: bool = True       # + kNN and ridge OOF legs (B9-style pool)
    tanimoto_leg: bool = True     # + Tanimoto-kNN similarity leg on the raw
                                  # fingerprint bits (K6)
    tknn_k: int = 10
    tkrr_leg: bool = True         # + Tanimoto kernel-ridge leg (full-gram
                                  # KRR, ops.similarity.TanimotoKernelRidge)
    tkrr_lam: float = 0.1
    kernel_n_folds: Optional[int] = None
                                  # finer CV split for the kernel-ridge legs
                                  # (tkrr/ckrr). honest/compat: the full gram
                                  # is label-independent and computed once
                                  # (device), so 50-fold (~LOO) costs only
                                  # host sub-matrix solves.
                                  # IGNORED under strict: a non-nested fine
                                  # split feeds the cross-fitted meta
                                  # train-row predictions from models that
                                  # saw that meta-fold's test labels, so
                                  # strict keeps kernel fits on the main
                                  # folds.
    nn_split_mix: bool = False    # NN/graph seed replicas rotate over
                                  # split_repeats different kfold splits
                                  # (replica 0 keeps the canonical split, so
                                  # downstream fold bookkeeping is unchanged);
                                  # honest/compat only.
    # combined chemistry-kernel ridge leg (ops.similarity.ChemKernelRidge):
    # Tanimoto(MACCS) + Tanimoto(Morgan bits) + minmax(Morgan counts) +
    # RBF(descriptors)
    ckrr_leg: bool = True
    ckrr_lam: float = 0.06
    ckrr_weights: tuple = (0.25, 0.25, 0.25, 0.25)
    ckrr_idf: bool = False            # IDF per-bit weights log(N/df) in the
                                      # Tanimoto/minmax blocks
    # cross-task transfer: P(BBB+) columns from models trained on the
    # leak-screened classification set (train.transfer). Fold-independent
    # pure functions of structure -> appended to the tree/shallow-leg
    # features under every protocol, plus their own calibration stack leg.
    transfer_leg: bool = False
    transfer_models: tuple = ("gbdt", "oblivious", "tknn")
    transfer_to_nn: bool = False  # also append to the NN fp branch
    out_dir: Optional[str] = None  # write the metrics CSV and OOF pickle here
    image_size: int = 128
    compat_batch: Optional[int] = None   # set automatically for protocol=compat
    workers: Optional[int] = None


@dataclass
class RegressionRunResult:
    oof: Dict[str, np.ndarray]
    stacked_pred: np.ndarray
    y: np.ndarray
    report: Dict[str, Dict[str, float]]
    wall_time_s: float
    # wall seconds by stage: preprocess, transfer, nn, kernel_features (the
    # bits and raw features of the kernel legs, the full grams), smiles
    # (the SMILES-encoder leg; 0 without it), graph,
    # tree_features (the tree matrices), trees (rf, gbdt, cat, gbdt_<kind>),
    # shallow (knn, ridge, the transfer calibration), kernels (tknn, tkrr,
    # ckrr), stacking
    stage_s: Dict[str, float] = field(default_factory=dict)


def _dev(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _tree_features_global(d: ProcessedData, raw_fp: bool = False,
                          device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Tree-leg feature matrix, transforms fit globally (honest/compat
    protocols). The reference feeds trees hstack(fp, flat 49k image) (:263);
    here: physchem descriptors + normalized fp + aux-fp PCA + image PCA.

    Wide fingerprints (Morgan/path 2048) default to a PCA-256 compression for
    the tree legs, fit on ``device``; ``raw_fp=True`` feeds the raw bits."""
    x = d.tree_features()
    if d.fp_norm.shape[1] > 1024 and not raw_fp:
        dev = resolve_device(device)
        with f32_matmul():
            fp_c = _host(PCA(256).fit_transform(_dev(d.fp_norm, dev)))
        blocks = [fp_c, d.fp_pca, d.img_pca]
        if d.desc_norm is not None:
            blocks.insert(0, d.desc_norm)
        if d.aux_fp_pca is not None:
            blocks.append(d.aux_fp_pca)
        x = np.concatenate(blocks, axis=1).astype(np.float32)
    return x


def _tree_features_strict(d: ProcessedData, folds: List[np.ndarray],
                          pca_dim: int, aux_pca_dim: int,
                          raw_fp: bool = False,
                          device: Union[str, torch.device] = "cuda"
                          ) -> List[np.ndarray]:
    """Per-fold tree features: scaler + PCA fit on that fold's TRAIN rows
    only, then applied to all rows, on ``device`` (TF32 off). Returns one
    [N, D] matrix per fold."""
    dev = resolve_device(device)
    with f32_matmul():
        joint = _dev(np.concatenate([d.fp_raw, d.img_raw], axis=1), dev)
        desc = None if d.desc_raw is None else _dev(d.desc_raw, dev)
        aux = {k: _dev(v, dev) for k, v in (d.aux_fp_raw or {}).items()}
        d_fp = d.fp_raw.shape[1]
        out = []
        for i in range(len(folds)):
            tr = torch.from_numpy(np.concatenate(
                [folds[j] for j in range(len(folds)) if j != i])).to(dev)
            jn = StandardScaler().fit(joint[tr]).transform(joint)
            fp_n, img_n = jn[:, :d_fp], jn[:, d_fp:]
            fp_p = PCA(pca_dim).fit(fp_n[tr]).transform(fp_n)
            img_p = PCA(pca_dim).fit(img_n[tr]).transform(img_n)
            blocks = []
            if desc is not None:
                blocks.append(StandardScaler().fit(desc[tr]).transform(desc))
            if fp_n.shape[1] > 1024 and not raw_fp:
                blocks.append(PCA(256).fit(fp_n[tr]).transform(fp_n))
            else:
                blocks.append(fp_n)
            blocks += [fp_p, img_p]
            for raw in aux.values():
                an = StandardScaler().fit(raw[tr]).transform(raw)
                k = min(aux_pca_dim, len(tr), an.shape[1])
                blocks.append(PCA(k).fit(an[tr]).transform(an))
            out.append(_host(torch.cat(blocks, dim=1)))
    return out


def _fold_affine_from(raw_blocks, folds, n_seedless_folds):
    """Per-fold (mean, 1/std) for each raw input block (train rows only)."""
    aff = []
    for raw in raw_blocks:
        if raw is None:
            aff.append(None)
            continue
        flat = raw.reshape(len(raw), -1)
        means, inv = [], []
        for i in range(n_seedless_folds):
            tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
            mu = flat[tr].mean(0)
            sd = flat[tr].std(0)
            means.append(mu)
            # StandardScaler semantics: zero-variance train columns pass
            # through unscaled (inv=1) instead of 1/eps — rare fp bits /
            # flat image pixels constant in one fold's train rows otherwise
            # get scaled 1e6x on test rows and blow up the NN leg. inv is
            # additionally capped at 1e3: features that near-constant carry
            # no signal worth a larger dynamic range.
            inv.append(np.where(sd < 1e-6, 1.0,
                                1.0 / np.maximum(sd, 1e-3)).astype(np.float32))
        shape = raw.shape[1:]
        aff.append((np.stack(means).reshape((-1,) + shape),
                    np.stack(inv).reshape((-1,) + shape)))
    return tuple(aff)


def _crossfit_stack(stack_x: np.ndarray, y: np.ndarray,
                    folds: List[np.ndarray], meta_ctor) -> np.ndarray:
    """Cross-fitted meta-learner: fold i's stacked prediction comes from a
    meta model fit on the OTHER folds' OOF rows (no in-sample meta fit)."""
    out = np.zeros(len(y), np.float32)
    for i, te in enumerate(folds):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        m = meta_ctor().fit(stack_x[tr], y[tr])
        out[te] = np.asarray(m.predict(stack_x[te]))
    return out


def _reference_stack_meta(stack_x: np.ndarray, y: np.ndarray, seed: int,
                          n_estimators: int = 300, depth: int = 10,
                          cv: int = 5,
                          device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """The reference's meta-learner, reproduced structurally: a sklearn
    StackingRegressor whose BASE estimators are deep forests fit on the
    leg-OOF matrix — RF(300, depth 30), XGB(300, lr 0.01, depth 30),
    CatBoost(300, lr 0.01, depth 10) with a LinearRegression final — and
    whose published numbers come from predicting the SAME rows the meta was
    fit on (Models/multi_input_data_regression_opt_transformer_cnn_20250113.py:394-403).
    Depth-10+ forests over an [N, n_legs] matrix memorize most of y, which
    is where the reference's 0.86-class stacked R² lives; this reproduction
    exists for compat-protocol parity accounting, never as a headline.

    sklearn semantics (final estimator fit on each base's cross_val_predict,
    bases then refit on all rows) with the port's forests on ``device``;
    depth caps at 10. The CV fits pass fold masks as ``sample_weight``, as
    the JAX package's do."""
    x = np.asarray(stack_x, np.float32)
    bases = [
        RandomForestRegressor(n_estimators=n_estimators, max_depth=depth,
                              colsample=1.0, seed=seed, device=device),
        GBDTRegressor(n_estimators=n_estimators, learning_rate=0.01,
                      max_depth=depth, seed=seed, device=device),
        GBDTRegressor(n_estimators=n_estimators, learning_rate=0.01,
                      max_depth=depth, oblivious=True, seed=seed, device=device),
    ]
    folds = kfold_indices(len(y), cv, seed)
    z_cv = np.zeros((len(y), len(bases)), np.float32)
    for j, proto in enumerate(bases):
        for i, va in enumerate(folds):
            w = np.ones(len(y), np.float32)
            w[va] = 0.0
            m = type(proto)(**proto.get_params())
            m.fit(x, y, sample_weight=w)
            z_cv[va, j] = m.predict(x[va])
    final = LinearRegression(device=device).fit(z_cv, y)
    z_full = np.stack([b.fit(x, y).predict(x) for b in bases], axis=1)
    return np.asarray(final.predict(z_full))


def meta_learners(device: Union[str, torch.device] = "cuda") -> Dict[str, object]:
    """The stacking meta-learners by name, as factories on ``device``."""
    return {"linear": lambda: LinearRegression(device=device),
            "ridge": lambda: Ridge(1.0, device=device),
            "ridgecv": lambda: RidgeCV(device=device),
            "nnls": NonNegativeLinearRegression}


def run_regression(cfg: RegressionTrainConfig = RegressionTrainConfig(),
                   data: Optional[ProcessedData] = None,
                   verbose: bool = True,
                   device: Union[str, torch.device] = "cuda") -> RegressionRunResult:
    """The regression stack on ``device``. Without ``data`` it preprocesses
    B3DB regression (``$BBBP_B3DB_DIR/B3DB_regression.tsv``) there first."""
    dev = resolve_device(device)
    with f32_matmul():
        return _run(cfg, data, verbose, dev)


def _run(cfg: RegressionTrainConfig, data: Optional[ProcessedData],
         verbose: bool, dev: torch.device) -> RegressionRunResult:
    t0 = time.time()
    stage_s: Dict[str, float] = {}
    clock = [time.time()]

    def lap(name: str) -> None:
        now = time.time()
        stage_s[name] = stage_s.get(name, 0.0) + now - clock[0]
        clock[0] = now

    strict = cfg.protocol == "strict"
    compat_batch = cfg.compat_batch
    if cfg.protocol == "compat" and compat_batch is None:
        compat_batch = 100
    if data is None:
        data = preprocess_regression(PreprocessConfig(
            fp_kind=cfg.fp_kind, image_size=cfg.image_size,
            compat_batch=compat_batch, workers=cfg.workers, seed=cfg.seed,
            keep_raw=strict), device=dev)
        lap("preprocess")
    n = len(data.y)
    y = data.y
    folds = kfold_indices(n, cfg.n_folds, cfg.seed)

    # ---------------- cross-task transfer features (train.transfer) --------
    transfer = None
    if cfg.transfer_leg:
        from bbbp_tpu_torch.train.transfer import TransferConfig, transfer_features

        # The transfer cache ($BBBP_TRANSFER_CACHE) is keyed by the config
        # and the molecules, not by the device: a cpu run reads the columns
        # a cuda run wrote. Their forest columns are not bit-equal across
        # devices (the card's histograms sum in fixed point, the plain
        # versions in f32), so a cached run on the other device differs
        # from an uncached one by those roundings.
        transfer = transfer_features(
            data.smiles, TransferConfig(models=tuple(cfg.transfer_models)),
            workers=cfg.workers, verbose=verbose, device=dev)
        lap("transfer")

    # ---------------- NN leg (Transformer+CNN, batched folds) --------------
    fold_affine = None
    if strict:
        if data.fp_raw is None:
            raise ValueError("strict protocol needs preprocess(keep_raw=True)")
        nn_fp = (np.concatenate([data.fp_raw, data.desc_raw], axis=1)
                 if data.desc_raw is not None else data.fp_raw)
        img = data.img_raw.reshape(n, cfg.image_size, cfg.image_size, 3)
        if transfer is not None and cfg.transfer_to_nn:
            nn_fp = np.concatenate([nn_fp, transfer.features], axis=1)
        fold_affine = _fold_affine_from([nn_fp, img], folds, cfg.n_folds)
    else:
        nn_fp = (np.concatenate([data.fp_pca, data.img_pca], axis=1
                                ).astype(np.float32)
                 if cfg.nn_input == "pca" else data.nn_fp_features())
        img = data.img_norm.reshape(n, cfg.image_size, cfg.image_size, 3)
        if transfer is not None and cfg.transfer_to_nn:
            # probabilities standardized to match the normalized fp block
            t = transfer.features
            nn_fp = np.concatenate(
                [nn_fp, (t - t.mean(0)) / np.maximum(t.std(0), 1e-6)],
                axis=1).astype(np.float32)
    model = MultiModalRegressor(
        fp_dim=nn_fp.shape[1], n_layers=cfg.n_layers, fusion=cfg.fusion,
        fp_tokens=cfg.fp_tokens, image_size=cfg.image_size)
    if verbose:
        print(f"[regression] N={n} fp={nn_fp.shape} protocol={cfg.protocol} "
              f"training NN ({cfg.n_folds} folds x {cfg.epochs} epochs, "
              f"all folds batched) on {dev}...")

    # split rotation (nn_split_mix): replica r trains on split
    # seed + 7700*(r mod split_repeats) — replica 0 is always the canonical
    # split. Disabled under strict (fold_affine is built for the primary
    # split only).
    def _split_seed(r: int) -> int:
        if not cfg.nn_split_mix or strict:
            return cfg.seed
        return cfg.seed + 7700 * (r % max(1, cfg.split_repeats))

    nn_warm = None
    if cfg.nn_pretrained:
        nn_warm, nn_auc = load_warm_start(cfg.nn_pretrained)
        if verbose:
            print(f"[regression] NN warm start from {cfg.nn_pretrained} "
                  f"(aux AUC {nn_auc:.4f})")
    nn_res = None
    oof_acc = None
    # per-seed OOF columns kept for the `meta_perseed` diagnostic (each seed's
    # column is fully out-of-fold for its own split, so exposing members as
    # separate meta features is textbook stacked generalization — zero extra
    # fits; the crossfit report shows whether it generalizes)
    seed_cols: dict = {}
    for r in range(max(1, cfg.nn_seeds)):
        res_r = train_cv(
            model, (nn_fp, img), y, n_folds=cfg.n_folds, epochs=cfg.epochs,
            batch_size=cfg.batch_size, lr=cfg.lr, seed=cfg.seed + 1000 * r,
            split_seed=_split_seed(r),
            snapshot_from=None if cfg.patience else cfg.snapshot_from,
            patience=cfg.patience, fold_affine=fold_affine,
            warm_start=nn_warm,
            log_every=(10 if verbose and r == 0 else 0), device=dev)
        oof_acc = res_r.oof_pred if oof_acc is None else oof_acc + res_r.oof_pred
        seed_cols.setdefault("nn", []).append(np.asarray(res_r.oof_pred))
        if nn_res is None:
            nn_res = res_r            # canonical split's fold bookkeeping
    nn_res.oof_pred = oof_acc / max(1, cfg.nn_seeds)
    folds = nn_res.fold_test_idx
    lap("nn")

    leg_names = ["nn", "rf", "gbdt", "cat"]
    if cfg.graph_leg:
        leg_names.insert(1, "graph")
    if cfg.bert_leg:
        leg_names.insert(1, "smiles")
    if cfg.extra_legs:
        leg_names += ["knn", "ridge"]
    if cfg.tanimoto_leg:
        leg_names.append("tknn")
    if cfg.tkrr_leg:
        leg_names.append("tkrr")
    if cfg.ckrr_leg:
        leg_names.append("ckrr")
    leg_names += [f"gbdt_{k}" for k in cfg.fp_tree_legs]
    if transfer is not None:
        leg_names.append("transfer")
    oof = {m: np.zeros(n, np.float32) for m in leg_names}
    oof["nn"] = nn_res.oof_pred

    fp_bits = None
    if cfg.tanimoto_leg or cfg.tkrr_leg:
        # raw binary bits recomputed from SMILES (the normalized matrices in
        # ProcessedData are real-valued); the kernels pack them on the device
        fp_bits = (fingerprints(data.smiles, kind=cfg.fp_kind).features > 0
                   ).astype(np.float32)
    if cfg.ckrr_leg:
        # the chemistry-native feature trio for the combined kernel,
        # independent of cfg.fp_kind (disk-cached by content hash)
        ck_desc, ck_maccs, ck_counts = raw_transfer_features(
            data.smiles, workers=cfg.workers)
        # IDF bit weights are document frequencies — label-independent, so
        # global under honest/compat like the grams themselves
        # (ChemKernelRidge.full_gram doc). strict re-fits them per fold on
        # train rows only (no test-row influence, by the strict definition).
        ck_bw = (ChemKernelRidge.idf_weights(ck_maccs, ck_counts)
                 if cfg.ckrr_idf and not strict else None)

    # fine-grained CV for the kernel-ridge legs: under honest/compat the
    # grams are label-independent, so compute each FULL gram once (device)
    # and run kernel_n_folds (~LOO at 50) as host sub-matrix solves — more
    # train rows per fold. Under STRICT the fine split is IGNORED and the
    # kernel legs fit on the MAIN folds: a kernel OOF column built on a
    # non-nested 50-fold split hands the cross-fitted meta train-row
    # predictions from models that saw that meta-fold's test labels.
    fine_kernels = bool(cfg.kernel_n_folds) and not strict
    K_tk_full = K_ck_full = None
    if fine_kernels and cfg.tkrr_leg:
        K_tk_full = TanimotoKernelRidge.full_gram(fp_bits, device=dev)
    if fine_kernels and cfg.ckrr_leg:
        K_ck_full = ChemKernelRidge(
            cfg.ckrr_lam, weights=tuple(cfg.ckrr_weights),
            bit_weights=ck_bw, device=dev).full_gram(ck_maccs, ck_counts, ck_desc)
    lap("kernel_features")

    def _gram_cv_oof(K: np.ndarray, lam: float, folds_k) -> np.ndarray:
        out = np.zeros(n, np.float32)
        for te in folds_k:
            trm = np.ones(n, bool)
            trm[te] = False
            tr = np.arange(n)[trm]
            ym = float(y[tr].mean())
            a = np.linalg.solve(
                K[np.ix_(tr, tr)] + lam * np.eye(len(tr), dtype=K.dtype),
                y[tr] - ym)
            out[te] = K[np.ix_(te, tr)] @ a + ym
        return out

    # --- resumable leg/tree checkpoint ----------------------------------
    # The deep legs (graph) and the tree stage are the long tail of a run.
    # Each completed deep leg's OOF column (and seed columns) and the tree
    # accumulators after every (repeat, fold) are checkpointed, keyed by a
    # config+data fingerprint so that a stale file from a different run can
    # never leak in. The NN leg always reruns (downstream needs its full
    # CVResult). Enabled whenever out_dir is set (disable with
    # BBBP_TREE_CKPT=0); deleted on run completion. The key does not name
    # the device.
    ck_path = None
    ck = {"cells": set(), "oof_r": {}, "legs": {}, "reps_done": set()}
    ck_key = None
    if cfg.out_dir and os.environ.get("BBBP_TREE_CKPT", "1") == "1":
        os.makedirs(cfg.out_dir, exist_ok=True)
        ck_path = os.path.join(cfg.out_dir, "tree_ckpt.pkl")
        ck_key = hashlib.sha256(
            (repr(sorted(asdict(cfg).items())) + f"|n={n}").encode()
        ).hexdigest()
        if os.path.exists(ck_path):
            try:
                with open(ck_path, "rb") as f:
                    old = pickle.load(f)
                if old.get("key") == ck_key:
                    ck = old["state"]
                    ck.setdefault("legs", {})
                    if verbose:
                        print(f"[regression] ckpt RESUMED: "
                              f"legs {sorted(ck['legs'])}, "
                              f"{len(ck['cells'])} tree folds + "
                              f"{len(ck['reps_done'])} repeats done")
                elif verbose:
                    print("[regression] stale tree_ckpt ignored (key "
                          "mismatch)")
            except (OSError, EOFError, pickle.UnpicklingError, AttributeError,
                    KeyError, TypeError) as e:
                # a bad ckpt must never be fatal: the run starts afresh
                print(f"[regression] unreadable tree_ckpt ignored: {e!r}")

    def _ck_save():
        if ck_path is None:
            return
        tmp = ck_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"key": ck_key, "state": ck}, f)
        os.replace(tmp, ck_path)

    # ---------------- SMILES-encoder leg (pretrained transformer) ----------
    if cfg.bert_leg and "smiles" in ck["legs"]:
        oof["smiles"], seed_cols["smiles"] = ck["legs"]["smiles"]
        if verbose:
            print("[regression] SMILES-encoder leg restored from ckpt")
    elif cfg.bert_leg:
        warm = None
        if cfg.bert_pretrained_dir:
            tok, pcfg, params = read_pretrained(cfg.bert_pretrained_dir)
            warm = {"enc": params}
            d_model, b_layers = pcfg["d_model"], pcfg["n_layers"]
            max_len = pcfg["max_len"]
        else:
            tok = SmilesTokenizer(128).fit(data.smiles)
            d_model, b_layers, max_len = cfg.bert_d_model, cfg.bert_layers, 128
        ids = tok.encode_batch(data.smiles)
        bmodel = BertRegressor(vocab_size=tok.vocab_size, n_layers=b_layers,
                               d_model=d_model, max_len=max_len)
        if verbose:
            print(f"[regression] SMILES-encoder leg "
                  f"(pretrained={'yes' if warm else 'no'})...")
        b_acc = None
        for r in range(max(1, cfg.bert_seeds)):
            b_res = train_cv(
                bmodel, (ids,), y, n_folds=cfg.n_folds,
                epochs=cfg.bert_epochs, batch_size=cfg.batch_size,
                lr=cfg.bert_lr, seed=cfg.seed + 3000 + 1000 * r,
                split_seed=cfg.seed, warm_start=warm,
                snapshot_from=None if cfg.patience else max(
                    1, cfg.bert_epochs - 10),
                patience=cfg.patience,
                log_every=(20 if verbose and r == 0 else 0), device=dev)
            b_acc = b_res.oof_pred if b_acc is None else b_acc + b_res.oof_pred
            seed_cols.setdefault("smiles", []).append(np.asarray(b_res.oof_pred))
        oof["smiles"] = b_acc / max(1, cfg.bert_seeds)
        ck["legs"]["smiles"] = (np.asarray(oof["smiles"]),
                                list(seed_cols["smiles"]))
        _ck_save()
    lap("smiles")

    # ---------------- graph leg (edge-featured MPNN) -----------------------
    if cfg.graph_leg and "graph" in ck["legs"]:
        oof["graph"], seed_cols["graph"] = ck["legs"]["graph"]
        if verbose:
            print("[regression] graph leg restored from ckpt")
    elif cfg.graph_leg:
        if verbose:
            print("[regression] graph leg (MPNN, batched folds)...")
        feats, _, adj_t, mask, bad = graph_features(
            data.smiles, max_atoms=cfg.max_atoms, edge_types=True)
        gmodel = MPNNRegressor(feats.shape[-1], hidden=cfg.graph_hidden,
                               n_layers=cfg.graph_layers)
        g_warm = None
        if cfg.graph_pretrained:
            g_warm, g_auc = load_warm_start(cfg.graph_pretrained)
            if verbose:
                print(f"[regression] MPNN warm start from "
                      f"{cfg.graph_pretrained} (aux AUC {g_auc:.4f})")
        g_acc = None
        for r in range(max(1, cfg.graph_seeds)):
            g_res = train_cv(
                gmodel, (feats, adj_t, mask), y, n_folds=cfg.n_folds,
                epochs=cfg.graph_epochs, batch_size=cfg.batch_size,
                lr=cfg.graph_lr,
                seed=cfg.seed + 2000 + 1000 * r, split_seed=_split_seed(r),
                snapshot_from=None if cfg.patience else max(
                    1, cfg.graph_epochs - 15),
                patience=cfg.patience, warm_start=g_warm,
                log_every=(20 if verbose and r == 0 else 0), device=dev)
            g_acc = g_res.oof_pred if g_acc is None else g_acc + g_res.oof_pred
            seed_cols.setdefault("graph", []).append(np.asarray(g_res.oof_pred))
        oof["graph"] = g_acc / max(1, cfg.graph_seeds)
        ck["legs"]["graph"] = (np.asarray(oof["graph"]),
                               list(seed_cols["graph"]))
        _ck_save()
    lap("graph")

    # ---------------- tree + shallow legs (per fold) -----------------------
    if strict:
        xt_folds = _tree_features_strict(
            data, folds, data.config.pca_dim, data.config.aux_pca_dim,
            raw_fp=cfg.tree_raw_fp, device=dev)
        if transfer is not None:
            # fold-independent structure-only columns (module doc,
            # train.transfer) — appended to every fold's matrix
            xt_folds = [np.concatenate([x, transfer.features], axis=1)
                        for x in xt_folds]
    else:
        xt_global = _tree_features_global(data, raw_fp=cfg.tree_raw_fp,
                                          device=dev)
        if transfer is not None:
            xt_global = np.concatenate([xt_global, transfer.features], axis=1)
    # alternative-fingerprint tree matrices: raw bits + raw descriptors —
    # label-independent and transform-free, so one global matrix serves every
    # protocol (strict included)
    fp_tree_mats = {}
    if cfg.fp_tree_legs:
        ft_desc, _, _ = raw_transfer_features(data.smiles, workers=cfg.workers)
        for kind in cfg.fp_tree_legs:
            bits = (fingerprints(data.smiles, kind=kind, workers=cfg.workers
                                 ).features > 0).astype(np.float32)
            fp_tree_mats[kind] = np.concatenate([bits, ft_desc], axis=1)
            if verbose:
                print(f"[regression] fp-tree leg gbdt_{kind}: "
                      f"features {fp_tree_mats[kind].shape}")
    lap("tree_features")
    # repeated-CV averaging (config doc): repeat the whole fold loop on extra
    # splits and average the leg columns — honest/compat only
    n_rep = 1 if strict else max(1, cfg.split_repeats)
    rep_legs = [m for m in leg_names if m not in ("nn", "graph", "smiles")]
    rep_acc = {m: np.zeros(n, np.float32) for m in rep_legs}
    n_ts = max(1, cfg.tree_seeds)
    # per-seed forest columns (averaged over repeats) for meta_perseed
    tree_seed_acc = {m: np.zeros((n_ts, n), np.float32)
                     for m in ("rf", "gbdt", "cat")}
    # tree accumulators live in the run checkpoint (set up before the deep
    # legs above): restore from a resumed ckpt, or register the fresh ones
    if ck.get("rep_acc") is not None:
        rep_acc = ck["rep_acc"]
        tree_seed_acc = ck["tree_seed_acc"]
        if verbose and ck["cells"]:
            print(f"[regression] tree stage RESUMED: "
                  f"{len(ck['cells'])} folds + "
                  f"{len(ck['reps_done'])} repeats done")
    else:
        ck["rep_acc"] = rep_acc
        ck["tree_seed_acc"] = tree_seed_acc

    def gbdt(sd: int) -> GBDTRegressor:
        return GBDTRegressor(n_estimators=cfg.gbdt_trees,
                             learning_rate=cfg.gbdt_lr,
                             max_depth=cfg.gbdt_depth,
                             subsample=cfg.gbdt_subsample,
                             colsample=cfg.gbdt_colsample,
                             reg_lambda=cfg.gbdt_lambda, seed=sd, device=dev)

    for rep in range(n_rep):
        if rep in ck["reps_done"]:
            continue
        folds_r = (folds if rep == 0
                   else kfold_indices(n, cfg.n_folds, cfg.seed + 7700 * rep))
        oof_r = ck["oof_r"].get(rep)
        if oof_r is None:
            oof_r = {m: np.zeros(n, np.float32) for m in rep_legs}
        for i, te in enumerate(folds_r):
            if (rep, i) in ck["cells"]:
                continue
            tr = np.concatenate([folds_r[j] for j in range(len(folds_r))
                                 if j != i])
            xt = xt_folds[i] if strict else xt_global
            if verbose:
                print(f"[regression] fold {i+1}/{len(folds_r)} tree legs"
                      f"{f' (repeat {rep+1}/{n_rep})' if n_rep > 1 else ''}...")
            for s in range(n_ts):
                sd = cfg.seed + i + 101 * s + 31 * rep
                rf = RandomForestRegressor(n_estimators=cfg.rf_trees,
                                           max_depth=cfg.rf_depth,
                                           colsample=cfg.rf_colsample,
                                           reg_lambda=cfg.rf_lambda,
                                           seed=sd, device=dev).fit(xt[tr], y[tr])
                p_rf = np.asarray(rf.predict(xt[te]))
                oof_r["rf"][te] += p_rf
                tree_seed_acc["rf"][s, te] += p_rf / n_rep
                gb = gbdt(sd).fit(xt[tr], y[tr])
                p_gb = np.asarray(gb.predict(xt[te]))
                oof_r["gbdt"][te] += p_gb
                tree_seed_acc["gbdt"][s, te] += p_gb / n_rep
                cat = GBDTRegressor(n_estimators=cfg.cat_trees,
                                    learning_rate=cfg.cat_lr,
                                    max_depth=cfg.cat_depth, oblivious=True,
                                    subsample=cfg.cat_subsample,
                                    colsample=cfg.cat_colsample,
                                    reg_lambda=cfg.cat_lambda,
                                    seed=sd, device=dev).fit(xt[tr], y[tr])
                p_cat = np.asarray(cat.predict(xt[te]))
                oof_r["cat"][te] += p_cat
                tree_seed_acc["cat"][s, te] += p_cat / n_rep
            for m in ("rf", "gbdt", "cat"):
                oof_r[m][te] /= n_ts
            for kind, xk in fp_tree_mats.items():
                for s in range(n_ts):
                    gbk = gbdt(cfg.seed + i + 101 * s + 31 * rep
                               ).fit(xk[tr], y[tr])
                    oof_r[f"gbdt_{kind}"][te] += np.asarray(
                        gbk.predict(xk[te])) / n_ts
            lap("trees")
            if cfg.extra_legs:
                oof_r["knn"][te] = KNeighborsRegressor(10, device=dev).fit(
                    xt[tr], y[tr]).predict(xt[te])
                oof_r["ridge"][te] = Ridge(10.0, device=dev).fit(
                    xt[tr], y[tr]).predict(xt[te])
            if transfer is not None:
                # calibration leg: linear map transfer-probas -> logBB, fit on
                # this fold's train rows (gives the meta a dedicated column)
                oof_r["transfer"][te] = LinearRegression(device=dev).fit(
                    transfer.features[tr], y[tr]).predict(transfer.features[te])
            lap("shallow")
            if cfg.tanimoto_leg:
                oof_r["tknn"][te] = TanimotoKNNRegressor(
                    cfg.tknn_k, device=dev).fit(fp_bits[tr], y[tr]
                                                ).predict(fp_bits[te])
            if cfg.tkrr_leg and not fine_kernels:
                oof_r["tkrr"][te] = TanimotoKernelRidge(
                    cfg.tkrr_lam, device=dev).fit(fp_bits[tr], y[tr]
                                                  ).predict(fp_bits[te])
            if cfg.ckrr_leg and not fine_kernels:
                bw_i = (ChemKernelRidge.idf_weights(ck_maccs[tr], ck_counts[tr])
                        if (strict and cfg.ckrr_idf) else ck_bw)
                m = ChemKernelRidge(cfg.ckrr_lam,
                                    weights=tuple(cfg.ckrr_weights),
                                    bit_weights=bw_i, device=dev).fit(
                    ck_maccs[tr], ck_counts[tr], ck_desc[tr], y[tr])
                oof_r["ckrr"][te] = m.predict(ck_maccs[te], ck_counts[te],
                                              ck_desc[te])
            lap("kernels")
            ck["cells"].add((rep, i))
            ck["oof_r"][rep] = oof_r
            _ck_save()

        if fine_kernels:
            # honest/compat only — strict keeps the kernel legs on the main
            # folds above so the OOF columns stay aligned with the meta's
            # cross-fitting (see fine_kernels definition).
            folds_k = kfold_indices(n, cfg.kernel_n_folds,
                                    cfg.seed + 7700 * rep)
            if cfg.tkrr_leg:
                oof_r["tkrr"] = _gram_cv_oof(K_tk_full, cfg.tkrr_lam, folds_k)
            if cfg.ckrr_leg:
                oof_r["ckrr"] = _gram_cv_oof(K_ck_full, cfg.ckrr_lam, folds_k)
            lap("kernels")
        for m in rep_legs:
            rep_acc[m] += oof_r[m] / n_rep
        ck["reps_done"].add(rep)
        ck["oof_r"].pop(rep, None)
        _ck_save()
    if ck_path is not None and os.path.exists(ck_path):
        os.unlink(ck_path)           # stage complete; nothing to resume
    for m in rep_legs:
        oof[m] = rep_acc[m]
    if n_ts > 1:
        for m in ("rf", "gbdt", "cat"):
            seed_cols[m] = list(tree_seed_acc[m])

    # ---------------- stacking ---------------------------------------------
    metas = meta_learners(dev)
    stack_x = np.stack([oof[k] for k in leg_names], axis=1)
    meta_ctor = metas[cfg.meta]
    meta = meta_ctor().fit(stack_x, y)
    stacked_insample = np.asarray(meta.predict(stack_x))
    stacked_cv = _crossfit_stack(stack_x, y, folds, meta_ctor)
    # the headline "stacked" prediction: in-sample meta fit for compat/honest
    # (the reference's protocol, :394-403), cross-fitted for strict
    stacked = stacked_cv if strict else stacked_insample

    report = {k: metrics.regression_report(y, v) for k, v in oof.items()}
    report["stacked"] = metrics.regression_report(y, stacked)
    report["stacked_insample"] = metrics.regression_report(y, stacked_insample)
    report["stacked_crossfit"] = metrics.regression_report(y, stacked_cv)
    # all meta-learner variants on the same OOF matrix (diagnostic — the
    # headline remains cfg.meta; in-sample fit like the reference :394-403,
    # plus the cross-fitted version of each)
    for mname in ("linear", "ridge", "ridgecv", "nnls"):
        ctor = metas[mname]
        m_in = np.asarray(ctor().fit(stack_x, y).predict(stack_x))
        report[f"meta_{mname}"] = metrics.regression_report(y, m_in)
        m_cv = _crossfit_stack(stack_x, y, folds, ctor)
        report[f"meta_{mname}_crossfit"] = metrics.regression_report(y, m_cv)
    if cfg.protocol == "compat":
        # compat-only parity diagnostic: the reference's own meta structure
        # (forest stack over the OOF matrix, predicted in-sample) — see
        # _reference_stack_meta. Reported as meta_refstack; the headline
        # stays cfg.meta.
        try:
            rs = _reference_stack_meta(stack_x, y, cfg.seed, device=dev)
            report["meta_refstack"] = metrics.regression_report(y, rs)
        except Exception:  # noqa: BLE001 — a diagnostic, never fatal
            print("[regression] refstack meta FAILED:\n"
                  + traceback.format_exc())
    # meta over per-seed member columns (diagnostic; headline unchanged):
    # every ensemble member's OOF column as its own meta feature
    perseed_cols = []
    for k in leg_names:
        cols_k = seed_cols.get(k)
        perseed_cols += ([np.asarray(c, np.float32) for c in cols_k]
                         if cols_k and len(cols_k) > 1 else [oof[k]])
    if len(perseed_cols) > len(leg_names):
        ps_x = np.stack(perseed_cols, axis=1)
        ps_in = np.asarray(metas["linear"]().fit(ps_x, y).predict(ps_x))
        report["meta_perseed"] = metrics.regression_report(y, ps_in)
        ps_cv = _crossfit_stack(ps_x, y, folds, metas["linear"])
        report["meta_perseed_crossfit"] = metrics.regression_report(y, ps_cv)
    if transfer is not None:
        report["transfer_quality"] = {
            **{f"auc_{k}": v for k, v in transfer.holdout_auc.items()},
            "n_aux": float(transfer.n_aux),
            "n_excluded": float(transfer.n_excluded)}
    lap("stacking")
    if verbose:
        for k, r in report.items():
            if "r2" in r:
                print(f"[regression] {k:17s} R2={r['r2']:.4f} "
                      f"MSE={r['mse']:.4f}")
        if transfer is not None:
            print(f"[regression] transfer aux: {transfer.n_aux} molecules, "
                  f"holdout AUC {transfer.holdout_auc}")
    if cfg.out_dir:
        _write_artifacts(cfg, model, nn_res, oof, stacked, y, report,
                         seed_cols=seed_cols)
    return RegressionRunResult(oof, stacked, y, report, time.time() - t0,
                               stage_s)


def _write_artifacts(cfg, model, nn_res, oof, stacked, y, report,
                     seed_cols=None):
    """The reference's artifact set (SURVEY §2.8 S2), as
    ``bbbp_tpu/train/regression.py:889-918`` writes it: metrics CSV, loss
    curves, pred-vs-actual scatter with metrics in the filename,
    distribution plot, the OOF pickle and the NN checkpoint: the first seed
    replica's ``{"params", "batch_stats"}`` in flax's layout with the fold
    axis (``models/convert.py``), the tree the JAX package saves."""
    from bbbp_tpu_torch.models.convert import (flax_from_params,
                                               flax_stats_from_buffers,
                                               stack_folds)
    from bbbp_tpu_torch.reporting import plots
    from bbbp_tpu_torch.reporting.metrics_io import write_metrics_csv
    from bbbp_tpu_torch.utils.checkpoint import save_checkpoint

    d = cfg.out_dir
    os.makedirs(d, exist_ok=True)
    write_metrics_csv(os.path.join(d, "regression_metrics.csv"), report)
    r2, mse = report["stacked"]["r2"], report["stacked"]["mse"]
    scatter = f"stacked_predict_r2_{r2:.4f}_MSE_{mse:.4f}.png"
    if plots.available():
        plots.loss_curve_plot(nn_res.train_losses,
                              os.path.join(d, "nn_loss_curves.png"))
        plots.pred_vs_actual_plot(y, stacked, os.path.join(d, scatter),
                                  r2=r2, mse=mse)
        plots.distribution_plot(y, stacked,
                                os.path.join(d, "prediction_distribution.png"))
    else:
        print(plots.skip_note("regression", d, [
            "nn_loss_curves.png", scatter, "prediction_distribution.png"]))
    with open(os.path.join(d, "oof_predictions.pkl"), "wb") as f:
        payload = {"y": y, **oof, "stacked": stacked}
        for k, cols in (seed_cols or {}).items():
            for i, c in enumerate(cols):
                payload[f"{k}_seed{i}"] = np.asarray(c)
        pickle.dump(payload, f)
    k = nn_res.train_losses.shape[0]
    save_checkpoint(os.path.join(d, "nn_checkpoint"), {
        "params": stack_folds([flax_from_params(model, i, nn_res.params)
                               for i in range(k)]),
        "batch_stats": stack_folds([flax_stats_from_buffers(
            model, i, nn_res.batch_stats) for i in range(k)])})


def main():
    ap = argparse.ArgumentParser(description="B3DB multimodal regression (B7)")
    ap.add_argument("--fp-kind", default="maccs", choices=["morgan", "maccs", "rdkit"])
    ap.add_argument("--protocol", default="honest",
                    choices=["compat", "honest", "strict"])
    ap.add_argument("--folds", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--fusion", default="multihead",
                    choices=["multihead", "gate", "crossmodal"])
    ap.add_argument("--meta", default="linear",
                    choices=["linear", "ridge", "ridgecv", "nnls"])
    ap.add_argument("--patience", type=int, default=None)
    ap.add_argument("--no-graph-leg", action="store_true")
    ap.add_argument("--bert-leg", action="store_true",
                    help="add the SMILES-encoder leg")
    ap.add_argument("--bert-pretrained", default=None,
                    help="MLM-pretrained dir (train.bert_pretrain)")
    ap.add_argument("--tree-seeds", type=int, default=3)
    ap.add_argument("--fp-tree-legs", default="",
                    help="comma-separated fp kinds for extra GBDT legs on "
                         "raw bits + descriptors (e.g. 'morgan')")
    ap.add_argument("--nn-seeds", type=int, default=3)
    ap.add_argument("--compat-batch", type=int, default=None,
                    help="per-batch scaler quirk (implied by --protocol compat)")
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--out", default=None, help="write metrics JSON here")
    ap.add_argument("--out-dir", default=None,
                    help="write the metrics CSV and OOF pickle here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    cfg = RegressionTrainConfig(fp_kind=args.fp_kind, protocol=args.protocol,
                                n_folds=args.folds,
                                epochs=args.epochs, lr=args.lr,
                                fusion=args.fusion, meta=args.meta,
                                patience=args.patience,
                                graph_leg=not args.no_graph_leg,
                                bert_leg=args.bert_leg,
                                bert_pretrained_dir=args.bert_pretrained,
                                tree_seeds=args.tree_seeds,
                                fp_tree_legs=tuple(
                                    k for k in args.fp_tree_legs.split(",")
                                    if k),
                                nn_seeds=args.nn_seeds,
                                compat_batch=args.compat_batch,
                                out_dir=args.out_dir, workers=args.workers)
    res = run_regression(cfg, device=args.device)
    print(json.dumps({k: v for k, v in res.report.items()}, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res.report, f, indent=2)


if __name__ == "__main__":
    main()
