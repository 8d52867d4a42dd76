"""Regression preprocessing pipeline (L3): featurize → standardize → PCA →
interactions → isolation forest → logBB filter. The counterpart of
``bbbp_tpu/pipelines/preprocess.py``, with its configuration, its
``ProcessedData`` and its options; ``preprocess_regression`` adds a
``device`` (``cuda`` unless the caller asks for ``cpu``).

Reproduces the reference's final preprocessors P6-P8
(reference: Descriptors/multi_input_data_preprocess_maccs_opt_IsolationForest_fixed_1.py:86-141):
standardize fp+image jointly, PCA(30) per modality on the normalized blocks,
degree-2 interaction-only features of the two PCA blocks, IsolationForest(0.05)
labels on the PCA blocks (stored, not filtered on), drop logBB < −2.0.

Differences, deliberate (SURVEY.md §2.3 quirks): the reference fits the scaler
(and in P7/P8 even the PCA) per consecutive 100-row batch; default here is a
global fit, with ``compat_batch=100`` reproducing the quirk exactly.

Two stages: ``featurize_regression`` reads the TSV and featurizes on the
host (``RegressionFeatures``, numpy); ``transform_regression`` runs the
scalers, the PCAs and the interactions on the device in f32 with TF32 off
(``ops/similarity.py::f32_matmul``: a TF32 product moves a PCA column by
~1e-3, enough to turn a tree's split), and the isolation forest on the
host. The result holds numpy arrays, as the JAX package's does.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from bbbp_tpu_torch.chem.featurize import descriptors, fingerprints, images
from bbbp_tpu_torch.data.b3db import load_b3db_regression
from bbbp_tpu_torch.ops.forest_train import resolve_device
from bbbp_tpu_torch.ops.interactions import interaction_features
from bbbp_tpu_torch.ops.outliers import IsolationForest
from bbbp_tpu_torch.ops.pca import PCA, pca_per_batch
from bbbp_tpu_torch.ops.scaler import StandardScaler, standardize_per_batch
from bbbp_tpu_torch.ops.similarity import f32_matmul

AUX_KINDS = ("morgan_counts", "rdkit")


@dataclass
class PreprocessConfig:
    fp_kind: str = "maccs"            # morgan | maccs | rdkit
    image_size: int = 128
    pca_dim: int = 30
    contamination: float = 0.05
    logbb_min: Optional[float] = -2.0
    compat_batch: Optional[int] = None  # 100 → reference per-batch quirk
    compat_batch_pca: bool = False      # P7/P8 also refit PCA per batch
    workers: Optional[int] = None
    seed: int = 42
    tsv_path: Optional[str] = None
    # beyond-parity enrichment: physchem descriptors + the other two
    # fingerprint kinds PCA-compressed (SURVEY §7 "don't stop at parity")
    enrich: bool = True
    aux_pca_dim: int = 100
    # strict leak-free protocol support: also keep the UNnormalized feature
    # blocks so the trainer can fit scaler/PCA per CV fold (train rows only)
    keep_raw: bool = False
    # per-sample scaler quirk of the P1 base variant (reference:
    # Descriptors/multi_input_data_preprocess.py:68-73 fits a StandardScaler
    # per ROW, i.e. normalizes each sample over its own feature values)
    compat_per_sample: bool = False


@dataclass
class ProcessedData:
    smiles: list
    y: np.ndarray               # logBB after filtering
    fp_norm: np.ndarray         # [N, d_fp] standardized fingerprints
    img_norm: np.ndarray        # [N, H*W*3] standardized flat images
    fp_pca: np.ndarray          # [N, pca_dim]
    img_pca: np.ndarray         # [N, pca_dim]
    interactions: np.ndarray    # [N, 2d + C(2d,2)]
    outliers: np.ndarray        # [N] +1/-1
    numbers: np.ndarray
    config: PreprocessConfig
    desc_norm: Optional[np.ndarray] = None   # [N, 31] physchem descriptors
    aux_fp_pca: Optional[np.ndarray] = None  # [N, 2*aux_pca_dim] other fps
    # raw (pre-normalization) blocks for the strict per-fold protocol
    fp_raw: Optional[np.ndarray] = None
    img_raw: Optional[np.ndarray] = None
    desc_raw: Optional[np.ndarray] = None
    aux_fp_raw: Optional[Dict] = None        # kind -> [N, n_bits]

    def tree_features(self) -> np.ndarray:
        """Enriched tree-leg matrix: descriptors + fp + aux-fp PCA + img PCA."""
        blocks = [self.fp_norm, self.fp_pca, self.img_pca]
        if self.desc_norm is not None:
            blocks.insert(0, self.desc_norm)
        if self.aux_fp_pca is not None:
            blocks.append(self.aux_fp_pca)
        return np.concatenate(blocks, axis=1).astype(np.float32)

    def nn_fp_features(self) -> np.ndarray:
        """NN fingerprint-branch input: fp + descriptors when enriched."""
        if self.desc_norm is not None:
            return np.concatenate([self.fp_norm, self.desc_norm], axis=1
                                  ).astype(np.float32)
        return self.fp_norm

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path: str) -> "ProcessedData":
        with open(path, "rb") as f:
            return pickle.load(f)


@dataclass
class RegressionFeatures:
    """The host stage's output: the rows that featurize and render, before
    any fitted transform."""
    smiles: List[str]
    y: np.ndarray               # f32 [N] logBB
    numbers: np.ndarray
    fp: np.ndarray              # f32 [N, d_fp]
    img: np.ndarray             # f32 [N, H*W*3]
    desc: Optional[np.ndarray] = None        # f32 [N, 31] when enriched
    aux: Optional[Dict[str, np.ndarray]] = None   # kind -> f32 [N, n_bits]


def featurize_regression(cfg: PreprocessConfig = PreprocessConfig()
                         ) -> RegressionFeatures:
    """Read the B3DB regression TSV (``cfg.tsv_path``, else
    ``$BBBP_B3DB_DIR/B3DB_regression.tsv``) and featurize it: fingerprints,
    depictions, and when ``enrich`` the descriptors and the other two
    fingerprint kinds. Rows whose fingerprint or image fails are dropped."""
    data = load_b3db_regression(cfg.tsv_path)
    fp_res = fingerprints(data.smiles, kind=cfg.fp_kind, workers=cfg.workers)
    img_res = images(data.smiles, size=cfg.image_size, workers=cfg.workers)
    ok = fp_res.ok_mask & img_res.ok_mask
    smiles = [s for s, m in zip(data.smiles, ok) if m]
    out = RegressionFeatures(
        smiles=smiles, y=data.logbb[ok], numbers=data.numbers[ok],
        fp=fp_res.features[ok].astype(np.float32),
        img=img_res.features[ok].reshape(int(ok.sum()), -1).astype(np.float32))
    if cfg.enrich:
        out.desc = descriptors(smiles, workers=cfg.workers).features
        out.aux = {kind: fingerprints(smiles, kind=kind, workers=cfg.workers
                                      ).features.astype(np.float32)
                   for kind in AUX_KINDS if kind != cfg.fp_kind}
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def transform_regression(feats: RegressionFeatures,
                         cfg: PreprocessConfig = PreprocessConfig(),
                         device: Union[str, torch.device] = "cuda"
                         ) -> ProcessedData:
    """The fitted transforms of ``preprocess_regression`` on ``device`` (f32,
    TF32 off), the isolation forest on the host, then the logBB floor."""
    dev = resolve_device(device)
    with f32_matmul():
        return _transform(feats, cfg, dev)


def _transform(feats: RegressionFeatures, cfg: PreprocessConfig,
               dev: torch.device) -> ProcessedData:
    fp, img = feats.fp, feats.img
    # joint standardization of [fp | image] like the reference (:86-103)
    joint = torch.from_numpy(np.concatenate([fp, img], axis=1)).to(dev)
    if cfg.compat_per_sample:
        # P1 quirk: StandardScaler fit per SAMPLE — each row normalized over
        # its own feature values (multi_input_data_preprocess.py:68-73)
        mu = joint.mean(dim=1, keepdim=True)
        sd = joint.std(dim=1, correction=0, keepdim=True)
        joint_n = (joint - mu) / torch.clamp(sd, min=1e-8)
    elif cfg.compat_batch:
        joint_n = standardize_per_batch(joint, cfg.compat_batch)
    else:
        joint_n = StandardScaler().fit_transform(joint)
    del joint
    d_fp = fp.shape[1]
    fp_n, img_n = joint_n[:, :d_fp], joint_n[:, d_fp:]

    if cfg.compat_batch and cfg.compat_batch_pca:
        fp_p = pca_per_batch(fp_n, cfg.pca_dim, cfg.compat_batch)
        img_p = pca_per_batch(img_n, cfg.pca_dim, cfg.compat_batch)
    else:
        fp_p = PCA(cfg.pca_dim).fit_transform(fp_n)
        img_p = PCA(cfg.pca_dim).fit_transform(img_n)
    pcs = torch.cat([fp_p, img_p], dim=1)
    inter = _host(interaction_features(pcs))
    outl = IsolationForest(contamination=cfg.contamination,
                           seed=cfg.seed).fit_predict(_host(pcs))

    desc_n = aux = None
    if cfg.enrich:
        desc_n = _host(StandardScaler().fit_transform(
            torch.from_numpy(feats.desc).to(dev)))
        blocks = []
        for raw in feats.aux.values():
            xn = StandardScaler().fit_transform(torch.from_numpy(raw).to(dev))
            k = min(cfg.aux_pca_dim, xn.shape[0], xn.shape[1])
            blocks.append(_host(PCA(k).fit_transform(xn)))
        if blocks:
            aux = np.concatenate(blocks, axis=1)

    y = feats.y
    keep = (y >= cfg.logbb_min if cfg.logbb_min is not None
            else np.ones(len(y), dtype=bool))
    raw = cfg.keep_raw
    return ProcessedData(
        smiles=[s for s, m in zip(feats.smiles, keep) if m],
        y=y[keep].astype(np.float32),
        fp_norm=_host(fp_n)[keep],
        img_norm=_host(img_n)[keep],
        fp_pca=_host(fp_p)[keep],
        img_pca=_host(img_p)[keep],
        interactions=inter[keep],
        outliers=outl[keep],
        numbers=feats.numbers[keep],
        config=cfg,
        desc_norm=desc_n[keep] if desc_n is not None else None,
        aux_fp_pca=aux[keep] if aux is not None else None,
        fp_raw=fp[keep] if raw else None,
        img_raw=img[keep] if raw else None,
        desc_raw=feats.desc[keep] if raw and feats.desc is not None else None,
        aux_fp_raw=({k: v[keep] for k, v in feats.aux.items()}
                    if raw and feats.aux else None),
    )


def cache_path(cfg: PreprocessConfig, cache_dir: str) -> str:
    """The pickle of ``cfg``'s result under ``cache_dir``: keyed by the
    config's fields as the JAX package keys it, under another prefix (the
    JAX package's pickle holds its own classes)."""
    key = hashlib.sha1(repr(sorted(cfg.__dict__.items())).encode()
                       ).hexdigest()[:16]
    return os.path.join(cache_dir, f"preproc_reg_torch_{key}.pkl")


def preprocess_regression(cfg: PreprocessConfig = PreprocessConfig(),
                          cache_dir: Optional[str] = None,
                          device: Union[str, torch.device] = "cuda"
                          ) -> ProcessedData:
    """``cache_dir``: optional directory to memoize the full ProcessedData
    (pickle keyed by the config fields). Featurization + depiction of the
    B3DB set runs minutes on the single host core; experiment sweeps that
    reuse one preprocessing config should pass a cache_dir (also via env
    BBBP_PREPROCESS_CACHE). The key does not name the device: a cpu run
    reads what a cuda run wrote, whose PCA columns differ from its own by
    rounding (within 1e-4)."""
    dev = resolve_device(device)
    cache_dir = cache_dir or os.environ.get("BBBP_PREPROCESS_CACHE")
    cpath = cache_path(cfg, cache_dir) if cache_dir else None
    if cpath and os.path.exists(cpath):
        return ProcessedData.load(cpath)
    out = transform_regression(featurize_regression(cfg), cfg, dev)
    if cpath:
        os.makedirs(cache_dir, exist_ok=True)
        out.save(cpath)
    return out


def main():
    ap = argparse.ArgumentParser(description="B3DB regression preprocessing")
    ap.add_argument("--fp-kind", default="maccs", choices=["morgan", "maccs", "rdkit"])
    ap.add_argument("--image-size", type=int, default=128)
    ap.add_argument("--pca-dim", type=int, default=30)
    ap.add_argument("--logbb-min", type=float, default=-2.0)
    ap.add_argument("--compat-batch", type=int, default=None)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--output", default="processed_regression.pkl")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    cfg = PreprocessConfig(
        fp_kind=args.fp_kind, image_size=args.image_size, pca_dim=args.pca_dim,
        logbb_min=args.logbb_min, compat_batch=args.compat_batch,
        workers=args.workers,
    )
    out = preprocess_regression(cfg, device=args.device)
    out.save(args.output)
    print(f"saved {len(out.y)} molecules to {args.output} "
          f"(fp={out.fp_norm.shape}, img={out.img_norm.shape})")


if __name__ == "__main__":
    main()
