"""Featurization CLI (L2): B3DB / .smi inputs → fingerprint .npy + image dirs.

Mirrors the reference's artifact contracts: ``generate_all_fingerprints``
writes morgan/maccs/rdkit ``.npy`` matrices row-aligned with the TSV
(reference: Descriptors/create_descriptors.py:55-58), the ZINC batch
fingerprinter walks tranche dirs and writes fp .npy + CSV
(reference: Descriptors/create_descriptors_zinc.py:34-71), and the image
renderer writes ``<NO.>.png`` files (reference: Descriptors/convert_smiles_2_img.py:27-28).

A copy of ``bbbp_tpu/pipelines/featurize.py`` over the port's loaders and
featurizer, on the host (it has no device work). The PNG writer imports PIL
when it runs.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np

from bbbp_tpu_torch.chem.featurize import FP_KINDS, fingerprints, images
from bbbp_tpu_torch.data.b3db import load_b3db_classification, load_b3db_regression


def featurize_b3db(dataset: str = "regression", out_dir: str = ".",
                   kinds=FP_KINDS, image_size: int = 0,
                   workers: Optional[int] = None) -> dict:
    data = load_b3db_regression() if dataset == "regression" \
        else load_b3db_classification()
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for kind in kinds:
        res = fingerprints(data.smiles, kind=kind, workers=workers)
        path = os.path.join(out_dir, f"{kind}_fingerprints.npy")
        np.save(path, res.features)
        out[kind] = path
        print(f"saved {path} {res.features.shape} "
              f"({len(res.bad_indices)} invalid quarantined)")
    if image_size:
        img_dir = os.path.join(out_dir, "img_output")
        os.makedirs(img_dir, exist_ok=True)
        res = images(data.smiles, size=image_size, workers=workers)
        from PIL import Image

        for i, no in enumerate(data.numbers):
            if i in set(res.bad_indices.tolist()):
                continue
            arr = (res.features[i] * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(img_dir, f"{no}.png"))
        out["images"] = img_dir
        print(f"saved {len(data.numbers) - len(res.bad_indices)} PNGs to {img_dir}")
    return out


def featurize_smi(path: str, out_dir: str = ".", kind: str = "morgan",
                  n_bits: int = 2048, workers: Optional[int] = None) -> dict:
    """ZINC tranche batch fingerprinting (F2)."""
    from bbbp_tpu_torch.data.zinc import iter_smi_dir, iter_smi_file
    import csv

    it = iter_smi_dir(path) if os.path.isdir(path) else iter_smi_file(path)
    pairs = list(it)
    smiles = [p[0] for p in pairs]
    res = fingerprints(smiles, kind=kind, n_bits=n_bits, workers=workers)
    os.makedirs(out_dir, exist_ok=True)
    npy = os.path.join(out_dir, f"{kind}_fingerprints.npy")
    np.save(npy, res.features)
    csv_path = os.path.join(out_dir, "fingerprint_results.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["SMILES", "ID", "valid"])
        bad = set(res.bad_indices.tolist())
        for i, (smi, mid) in enumerate(pairs):
            w.writerow([smi, mid, int(i not in bad)])
    print(f"saved {npy} {res.features.shape} + {csv_path}")
    return {"npy": npy, "csv": csv_path}


def featurize_graph_b3db(dataset: str = "classification", out_dir: str = ".",
                         max_atoms: int = 128,
                         limit: Optional[int] = None) -> dict:
    """Graph-descriptor featurization writing the ``gpu_features.npy``
    contract (reference: Descriptors/create_descriptors_gpu.py:51 — DeepChem
    ConvMol atom features per molecule; here pooled to one static-width row
    per molecule, see chem.graph_features.pooled_graph_features)."""
    from bbbp_tpu_torch.chem.graph_features import pooled_graph_features

    data = load_b3db_regression() if dataset == "regression" \
        else load_b3db_classification()
    smiles = data.smiles[:limit] if limit else data.smiles
    os.makedirs(out_dir, exist_ok=True)
    feats, bad = pooled_graph_features(smiles, max_atoms=max_atoms)
    path = os.path.join(out_dir, "gpu_features.npy")
    np.save(path, feats)
    # row-aligned contract (like the repo's other featurizers): the matrix
    # keeps one row per input molecule; invalid SMILES become zero rows and
    # are listed in bad_indices for the caller to mask
    print(f"saved {path} {feats.shape} "
          f"({len(bad)} invalid -> zero rows, listed in bad_indices)")
    return {"npy": path, "bad_indices": bad}


def main():
    ap = argparse.ArgumentParser(description="Featurization (L2)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("b3db", help="fingerprint a B3DB dataset")
    b.add_argument("--dataset", default="regression",
                   choices=["regression", "classification"])
    b.add_argument("--out-dir", default=".")
    b.add_argument("--kinds", nargs="+", default=list(FP_KINDS))
    b.add_argument("--image-size", type=int, default=0)
    b.add_argument("--workers", type=int, default=None)
    z = sub.add_parser("smi", help="fingerprint .smi file/dir (ZINC tranches)")
    z.add_argument("path")
    z.add_argument("--out-dir", default=".")
    z.add_argument("--kind", default="morgan")
    z.add_argument("--workers", type=int, default=None)
    g = sub.add_parser("graph", help="pooled graph descriptors "
                       "(gpu_features.npy contract)")
    g.add_argument("--dataset", default="classification",
                   choices=["regression", "classification"])
    g.add_argument("--out-dir", default=".")
    g.add_argument("--max-atoms", type=int, default=128)
    g.add_argument("--limit", type=int, default=None)
    args = ap.parse_args()
    if args.cmd == "b3db":
        featurize_b3db(args.dataset, args.out_dir, tuple(args.kinds),
                       args.image_size, args.workers)
    elif args.cmd == "graph":
        featurize_graph_b3db(args.dataset, args.out_dir, args.max_atoms,
                             args.limit)
    else:
        featurize_smi(args.path, args.out_dir, args.kind, workers=args.workers)


if __name__ == "__main__":
    main()
