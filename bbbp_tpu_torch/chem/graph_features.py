"""Graph featurizer (F3 equivalent): per-atom feature matrices for GNN-style
models. A copy of ``bbbp_tpu/chem/graph_features.py`` (numpy only).

Reference: ``Descriptors/create_descriptors_gpu.py:17-34`` uses DeepChem's
ConvMolFeaturizer (per-atom feature vectors) saved as gpu_features.npy.
DeepChem is not in the image; this produces the equivalent atom-feature
representation from this framework's own molecular graph: one-hot element,
degree, total H, formal charge, aromaticity, ring membership, hybridization
proxy — padded to [max_atoms, n_feat] with an atom mask, TPU-ready static
shapes, plus the padded adjacency for message passing.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from bbbp_tpu_torch.chem.mol import Mol, BOND_DOUBLE, BOND_TRIPLE, BOND_AROMATIC
from bbbp_tpu_torch.chem.smiles import MolFromSmiles

ELEMENTS = (6, 7, 8, 16, 9, 17, 35, 53, 15, 5, 14, 34)  # one-hot slots + other
N_ATOM_FEATURES = len(ELEMENTS) + 1 + 6 + 5 + 3 + 1 + 1 + 3


def atom_features(mol: Mol, i: int) -> np.ndarray:
    a = mol.atoms[i]
    f = np.zeros(N_ATOM_FEATURES, dtype=np.float32)
    k = 0
    if a.z in ELEMENTS:
        f[k + ELEMENTS.index(a.z)] = 1
    else:
        f[k + len(ELEMENTS)] = 1
    k += len(ELEMENTS) + 1
    deg = min(len(mol.neighbors[i]), 5)
    f[k + deg] = 1
    k += 6
    h = min(mol.total_h(i), 4)
    f[k + h] = 1
    k += 5
    f[k] = float(np.clip(a.charge, -1, 1) == -1)
    f[k + 1] = float(a.charge == 0)
    f[k + 2] = float(np.clip(a.charge, -1, 1) == 1)
    k += 3
    f[k] = float(a.aromatic)
    k += 1
    f[k] = float(a.in_ring)
    k += 1
    # hybridization proxy: triple→sp, double/aromatic→sp2, else sp3
    orders = [mol.bonds[bi].order for bi in mol.neighbors[i]]
    if BOND_TRIPLE in orders:
        f[k] = 1
    elif BOND_DOUBLE in orders or BOND_AROMATIC in orders or a.aromatic:
        f[k + 1] = 1
    else:
        f[k + 2] = 1
    return f


N_BOND_TYPES = 4   # single, double, triple, aromatic


def graph_features(smiles: Sequence[str], max_atoms: int = 128,
                   edge_types: bool = False):
    """SMILES batch → (features [N, max_atoms, F], adjacency [N, max_atoms,
    max_atoms], mask [N, max_atoms], bad_indices). Oversized molecules are
    truncated; invalid ones zeroed + reported.

    ``edge_types=True`` additionally returns a bond-type adjacency stack
    [N, N_BOND_TYPES, max_atoms, max_atoms] (single/double/triple/aromatic)
    for edge-conditioned message passing (models.gnn.MPNNRegressor)."""
    n = len(smiles)
    feats = np.zeros((n, max_atoms, N_ATOM_FEATURES), dtype=np.float32)
    adj = np.zeros((n, max_atoms, max_atoms), dtype=np.float32)
    adj_t = (np.zeros((n, N_BOND_TYPES, max_atoms, max_atoms), dtype=np.float32)
             if edge_types else None)
    mask = np.zeros((n, max_atoms), dtype=np.float32)
    bad: List[int] = []
    order_slot = {1: 0, BOND_DOUBLE: 1, BOND_TRIPLE: 2, BOND_AROMATIC: 3}
    for idx, s in enumerate(smiles):
        mol = MolFromSmiles(s)
        if mol is None:
            bad.append(idx)
            continue
        na = min(mol.num_atoms, max_atoms)
        for i in range(na):
            feats[idx, i] = atom_features(mol, i)
            mask[idx, i] = 1.0
            adj[idx, i, i] = 1.0
        for b in mol.bonds:
            if b.a1 < max_atoms and b.a2 < max_atoms:
                adj[idx, b.a1, b.a2] = 1.0
                adj[idx, b.a2, b.a1] = 1.0
                if adj_t is not None:
                    t = order_slot.get(b.order, 0)
                    adj_t[idx, t, b.a1, b.a2] = 1.0
                    adj_t[idx, t, b.a2, b.a1] = 1.0
    if edge_types:
        return feats, adj, adj_t, mask, bad
    return feats, adj, mask, bad


def pooled_graph_features(smiles: Sequence[str], max_atoms: int = 128
                          ) -> Tuple[np.ndarray, List[int]]:
    """Per-molecule fixed-width descriptor from the atom-feature graph:
    [sum-pool | mean-pool | max-pool] over atoms plus atom/bond counts.

    This is the classification-side consumer contract for the reference's
    DeepChem ConvMol atom features (``Descriptors/create_descriptors_gpu.py:26-29``,
    saved as ``gpu_features.npy`` at ``:51`` and trained on by
    ``Descriptors/model_train_gpu.py:127-137``). The reference keeps ragged
    per-atom rows; pooling to one static [N, 3*F+2] matrix is the TPU-native
    form — fixed shapes feed the scaler/PCA/model zoo directly with no
    per-molecule dynamic dims.

    Returns (features [N, 3*N_ATOM_FEATURES+2], bad_indices).
    """
    feats, _adj, mask, bad = graph_features(smiles, max_atoms=max_atoms)
    n_atoms = mask.sum(axis=1, keepdims=True)           # [N, 1]
    denom = np.maximum(n_atoms, 1.0)
    s = feats.sum(axis=1)                                # [N, F]
    m = s / denom
    mx = np.where(mask[:, :, None] > 0, feats, -np.inf).max(axis=1)
    mx = np.where(np.isfinite(mx), mx, 0.0)
    # bond count proxy: off-diagonal adjacency entries / 2
    n_bonds = (_adj.sum(axis=(1, 2)) - n_atoms[:, 0]) / 2.0
    out = np.concatenate(
        [s, m, mx, n_atoms, n_bonds[:, None]], axis=1).astype(np.float32)
    return out, bad
