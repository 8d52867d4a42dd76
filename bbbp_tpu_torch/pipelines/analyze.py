"""Dataset analysis (D11 equivalent): property distributions + chemical-space
projections, as a CLI instead of notebooks; the counterpart of
``bbbp_tpu/pipelines/analyze.py``.

Reference: ``B3DB/notebooks/*.ipynb`` — PCA projection of descriptors/ECFP6
and property distributions. Outputs: per-descriptor histograms split by
BBB+/BBB− (or logBB sign), a descriptor-space PCA scatter, and a summary CSV.
The descriptors are computed on the host; the scaler and the PCA run on
``device`` (the port's ``ops/scaler.py``, ``ops/pca.py``; ``cuda`` unless
the caller asks for ``cpu``). Where matplotlib does not import, the run
writes the summary CSV and says which figures it does not write.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Optional, Union

import numpy as np
import torch

from bbbp_tpu_torch.chem.descriptors import DESCRIPTOR_NAMES, descriptor_matrix
from bbbp_tpu_torch.data.b3db import load_b3db_classification, load_b3db_regression
from bbbp_tpu_torch.ops.forest_train import resolve_device
from bbbp_tpu_torch.ops.pca import PCA
from bbbp_tpu_torch.ops.scaler import StandardScaler
from bbbp_tpu_torch.ops.similarity import f32_matmul
from bbbp_tpu_torch.reporting import plots


def pca_2d(x: np.ndarray, device: torch.device, scale: bool = True) -> np.ndarray:
    """The rows' first two principal components (standardized first with
    ``scale``), computed on ``device`` with TF32 off."""
    with f32_matmul():
        xd = torch.as_tensor(np.asarray(x, np.float32)).to(device)
        if scale:
            xd = StandardScaler().fit_transform(xd)
        return PCA(2).fit_transform(xd).cpu().numpy()


def analyze(dataset: str = "classification", out_dir: str = "analysis_output",
            workers: Optional[int] = None,
            device: Union[str, torch.device] = "cuda") -> dict:
    """The summary CSV, the distributions and the PCA scatter; returns their
    paths and the PCA coordinates (``coords``)."""
    dev = resolve_device(device)
    if dataset == "classification":
        data = load_b3db_classification()
        labels = data.labels
        label_names = ("BBB-", "BBB+")
    else:
        data = load_b3db_regression()
        labels = (data.logbb > 0).astype(int)
        label_names = ("logBB<=0", "logBB>0")
    desc, bad = descriptor_matrix(data.smiles)
    ok = np.ones(len(desc), bool)
    ok[bad] = False
    desc, labels = desc[ok], labels[ok]
    os.makedirs(out_dir, exist_ok=True)

    # per-descriptor distributions by class
    summary_path = os.path.join(out_dir, f"descriptor_summary_{dataset}.csv")
    with open(summary_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["descriptor", "mean_neg", "mean_pos", "std_neg", "std_pos"])
        for i, name in enumerate(DESCRIPTOR_NAMES):
            neg, pos = desc[labels == 0, i], desc[labels == 1, i]
            w.writerow([name, f"{neg.mean():.3f}", f"{pos.mean():.3f}",
                        f"{neg.std():.3f}", f"{pos.std():.3f}"])

    # descriptor-space PCA
    z = pca_2d(desc, dev)
    dist_path = os.path.join(out_dir, f"descriptor_distributions_{dataset}.png")
    pca_path = os.path.join(out_dir, f"descriptor_pca_{dataset}.png")
    out = {"summary": summary_path, "coords": z}
    if not plots.available():
        print(plots.skip_note("analyze", out_dir, [os.path.basename(dist_path),
                                                   os.path.basename(pca_path)]))
        print(f"saved {summary_path}")
        return out
    plt = plots._pyplot()
    ncols = 5
    nrows = -(-len(DESCRIPTOR_NAMES) // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 2.2 * nrows))
    for i, name in enumerate(DESCRIPTOR_NAMES):
        ax = axes.flat[i]
        lo, hi = np.percentile(desc[:, i], [1, 99])
        bins = np.linspace(lo, max(hi, lo + 1e-6), 30)
        ax.hist(desc[labels == 0, i], bins=bins, alpha=0.5, density=True,
                label=label_names[0])
        ax.hist(desc[labels == 1, i], bins=bins, alpha=0.5, density=True,
                label=label_names[1])
        ax.set_title(name, fontsize=7)
        ax.tick_params(labelsize=5)
    for j in range(len(DESCRIPTOR_NAMES), nrows * ncols):
        axes.flat[j].axis("off")
    axes.flat[0].legend(fontsize=6)
    fig.savefig(dist_path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    plots.pca_space_plot(z, labels, pca_path, label_names=label_names)
    print(f"saved {summary_path}, {dist_path}, {pca_path}")
    return {**out, "distributions": dist_path, "pca": pca_path}


def main() -> dict:
    ap = argparse.ArgumentParser(description="Dataset analysis (D11)")
    ap.add_argument("--dataset", default="classification",
                    choices=["classification", "regression"])
    ap.add_argument("--out-dir", default="analysis_output")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    return analyze(args.dataset, args.out_dir, device=args.device)


if __name__ == "__main__":
    main()
