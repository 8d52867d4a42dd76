"""Chemical-space PCA visualization (F6/F7), the counterpart of
``bbbp_tpu/pipelines/chemspace.py``.

Reference: ``Descriptors/create_descriptors_PCA_classification.py:14-94``
(fingerprints all three kinds for the classification set, 2-D PCA scatter by
BBB label) and ``create_descriptors_PCA_regression_{1,2,3}.py`` (regression
set: fingerprint / image / interaction feature spaces, per fp kind).
The fingerprints are computed on the host, the scaler and the PCA on
``device`` (``cuda`` unless the caller asks for ``cpu``); the regression
spaces come from the port's ``preprocess_regression`` on ``device``. Each
function returns the scatters' paths and their coordinates (``coords``);
where matplotlib does not import it says which scatters it does not write.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Union

import numpy as np
import torch

from bbbp_tpu_torch.chem.featurize import FP_KINDS, fingerprints
from bbbp_tpu_torch.data.b3db import load_b3db_classification
from bbbp_tpu_torch.ops.forest_train import resolve_device
from bbbp_tpu_torch.pipelines.analyze import pca_2d
from bbbp_tpu_torch.reporting import plots


def _scatters(out_dir: str, spaces: dict, labels: dict,
              label_names=("BBB-", "BBB+")) -> None:
    """One PCA scatter a space ({path: coordinates}), where matplotlib
    imports."""
    if plots.available():
        for path, z in spaces.items():
            plots.pca_space_plot(z, labels[path], path, label_names=label_names)
            print(f"saved {path}")
    else:
        print(plots.skip_note("chemspace", out_dir,
                              [os.path.basename(p) for p in spaces]))


def classification_space(out_dir: str = ".", kinds=FP_KINDS,
                         workers: Optional[int] = None,
                         device: Union[str, torch.device] = "cuda") -> dict:
    dev = resolve_device(device)
    data = load_b3db_classification()
    os.makedirs(out_dir, exist_ok=True)
    spaces, labels, out = {}, {}, {}
    for kind in kinds:
        res = fingerprints(data.smiles, kind=kind, workers=workers)
        path = os.path.join(out_dir, f"pca_space_classification_{kind}.png")
        spaces[path] = pca_2d(res.features[res.ok_mask], dev)
        labels[path] = data.labels[res.ok_mask]
        out[kind] = path
    _scatters(out_dir, spaces, labels)
    return {**out, "coords": {k: spaces[p] for k, p in out.items()}}


def regression_space(out_dir: str = ".", kind: str = "maccs",
                     workers: Optional[int] = None,
                     device: Union[str, torch.device] = "cuda") -> dict:
    """Fingerprint / image / interaction spaces colored by logBB sign."""
    from bbbp_tpu_torch.pipelines.preprocess import (PreprocessConfig,
                                                     preprocess_regression)

    dev = resolve_device(device)
    d = preprocess_regression(PreprocessConfig(fp_kind=kind, workers=workers),
                              device=dev)
    y = (d.y > 0).astype(int)      # BBB+ proxy: logBB > 0
    os.makedirs(out_dir, exist_ok=True)
    spaces, labels, out = {}, {}, {}
    for name, feats in (("fingerprint", d.fp_norm), ("image", d.img_pca),
                        ("interaction", d.interactions)):
        path = os.path.join(out_dir, f"pca_space_regression_{kind}_{name}.png")
        spaces[path] = pca_2d(feats, dev, scale=False)
        labels[path] = y
        out[name] = path
    _scatters(out_dir, spaces, labels, label_names=("logBB<=0", "logBB>0"))
    return {**out, "coords": {k: spaces[p] for k, p in out.items()}}


def main() -> dict:
    ap = argparse.ArgumentParser(description="PCA chemical-space plots (F6/F7)")
    ap.add_argument("--mode", default="classification",
                    choices=["classification", "regression"])
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--fp-kind", default="maccs")
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if args.mode == "classification":
        return classification_space(args.out_dir, workers=args.workers,
                                    device=args.device)
    return regression_space(args.out_dir, kind=args.fp_kind, workers=args.workers,
                            device=args.device)


if __name__ == "__main__":
    main()
