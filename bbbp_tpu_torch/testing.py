"""Test fixture: a screening model at the repo's default width, made from a
seed without training. It is not a feature: the tests and ``chip_smoke.py``
use it to drive the screening path at its real shapes.
"""

from __future__ import annotations

import numpy as np
import torch

N_TREES, DEPTH, PCA_DIM, N_BITS = 300, 6, 30, 2048
INF_SHARE = 0.05


def full_width_screening_state(seed: int = 0, n_molecules: int = 4096) -> dict:
    """Pickle-format dict of the default screening model's shape
    (``bbbp_tpu/pipelines/screen.py::ScreeningModel.train``): Morgan r=2 at
    2048 bits, PCA 30, 300 trees of depth 6.

    The scaler and PCA are fit by the port's own ``fit`` on the CPU, on the
    fingerprints of ``n_molecules`` ``synthetic_smiles``. Tree features are
    drawn from [0, 30); each threshold is the f32 midpoint of two
    neighbouring distinct projected values of its feature, so that no
    threshold equals a data value; ~5% of thresholds are +inf (dead
    branches). Leaves ~ N(0, 0.1²), ``tree_scale`` 0.1, ``base_score`` 0."""
    from bbbp_tpu_torch.data.zinc import synthetic_smiles
    from bbbp_tpu_torch.native.bindings import fingerprints
    from bbbp_tpu_torch.ops.pca import PCA
    from bbbp_tpu_torch.ops.scaler import StandardScaler

    x, bad = fingerprints(synthetic_smiles(n_molecules, seed=seed), "morgan",
                          N_BITS)
    x = np.delete(x, bad, axis=0)
    scaler = StandardScaler().fit(torch.from_numpy(x))
    xs = scaler.transform(torch.from_numpy(x))
    pca = PCA(PCA_DIM).fit(xs)
    z = pca.transform(xs).numpy()

    rng = np.random.default_rng(seed)
    n_internal = (1 << DEPTH) - 1
    feat = rng.integers(0, PCA_DIM, size=(N_TREES, n_internal)).astype(np.int32)
    thr = np.empty((N_TREES, n_internal), np.float32)
    for f in range(PCA_DIM):
        u = np.unique(z[:, f])
        mid = ((u[:-1].astype(np.float64) + u[1:]) / 2).astype(np.float32)
        mid = mid[(mid > u[:-1]) & (mid < u[1:])]
        sel = feat == f
        thr[sel] = mid[rng.integers(0, len(mid), size=int(sel.sum()))]
    thr[rng.random(thr.shape) < INF_SHARE] = np.inf
    leaf = rng.normal(0.0, 0.1, size=(N_TREES, n_internal + 1)).astype(np.float32)
    return {
        "scaler_mean": scaler.mean_.numpy(),
        "scaler_scale": scaler.scale_.numpy(),
        "pca_mean": pca.mean_.numpy(),
        "pca_components": pca.components_.numpy(),
        "fp_kind": "morgan",
        "n_bits": N_BITS,
        "threshold": 0.5,
        "ensemble": {"feat": feat, "thr": thr, "leaf": leaf, "depth": DEPTH,
                     "base_score": 0.0, "tree_scale": 0.1},
    }


def near_tie_rows(ensemble: dict, z: np.ndarray, tol: float = 1e-5) -> np.ndarray:
    """Rows of ``z`` [N, F] whose path through any tree of ``ensemble`` (the
    pickle's dict) meets a threshold within ``tol``. Two correct
    implementations that sum z in different orders may send such a row down
    different branches, so comparisons of whole predictions allow a
    mismatch there and nowhere else."""
    feat, thr, depth = ensemble["feat"], ensemble["thr"], ensemble["depth"]
    n, n_trees = len(z), feat.shape[0]
    t_idx = np.arange(n_trees)[None, :]
    pos = np.zeros((n, n_trees), np.int64)
    near = np.zeros(n, bool)
    for level in range(depth):
        flat = (1 << level) - 1 + pos
        xv = np.take_along_axis(z, feat[t_idx, flat], axis=1)
        t = thr[t_idx, flat]
        near |= (np.abs(xv - t) <= tol).any(axis=1)
        pos = 2 * pos + (xv > t)
    return near
