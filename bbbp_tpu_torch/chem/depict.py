"""2-D molecule depiction: coordinate generation + rasterization to HxWx3.

Replaces the reference's RDKit rendering of per-molecule PNGs consumed by the
image CNN branch (reference: Descriptors/convert_smiles_2_img.py:19-28 renders
SMILES → PNG; Descriptors/multi_input_data_preprocess_maccs_opt_IsolationForest_fixed_1.py:56-73
loads them resized to 128×128×3 and flattened).

Coordinates: classical MDS (eigendecomposition of the double-centered squared
graph-distance matrix) seeded layout, refined by a few Fruchterman-Reingold
spring iterations — deterministic, template-free. Rasterization: vectorized
numpy distance-to-segment bond strokes + element-colored atom disks, CPK-style
coloring like RDKit's default palette.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from bbbp_tpu_torch.chem.mol import Mol, BOND_DOUBLE, BOND_TRIPLE, BOND_AROMATIC

# CPK-ish palette matching RDKit defaults (C drawn as black skeleton).
ELEMENT_COLORS = {
    6: (0.0, 0.0, 0.0),
    7: (0.0, 0.0, 1.0),
    8: (1.0, 0.0, 0.0),
    16: (0.8, 0.8, 0.0),
    9: (0.2, 0.8, 0.2),
    17: (0.0, 0.8, 0.0),
    35: (0.6, 0.15, 0.0),
    53: (0.4, 0.0, 0.73),
    15: (1.0, 0.5, 0.0),
    5: (1.0, 0.7, 0.7),
}
DEFAULT_COLOR = (0.3, 0.3, 0.3)


def graph_distances(mol: Mol) -> np.ndarray:
    """All-pairs shortest-path (BFS per atom), hop counts, inf→n for disconnected."""
    n = mol.num_atoms
    dist = np.full((n, n), n, dtype=np.float64)
    adj = [mol.atom_neighbors(i) for i in range(n)]
    for s in range(n):
        dist[s, s] = 0
        frontier = [s]
        d = 0
        seen = {s}
        while frontier:
            d += 1
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if v not in seen:
                        seen.add(v)
                        dist[s, v] = d
                        nxt.append(v)
            frontier = nxt
    return dist


def compute_coords(mol: Mol, spring_iters: int = 60, seed: int = 0) -> np.ndarray:
    """[N,2] layout coordinates, bond length ≈ 1."""
    n = mol.num_atoms
    if n == 1:
        return np.zeros((1, 2))
    d = graph_distances(mol)
    # classical MDS
    d2 = d ** 2
    j = np.eye(n) - np.full((n, n), 1.0 / n)
    b = -0.5 * j @ d2 @ j
    w, v = np.linalg.eigh(b)
    order = np.argsort(w)[::-1][:2]
    coords = v[:, order] * np.sqrt(np.maximum(w[order], 1e-9))
    if coords.shape[1] < 2:
        coords = np.pad(coords, ((0, 0), (0, 2 - coords.shape[1])))
    rng = np.random.default_rng(seed)
    coords = coords + 0.01 * rng.standard_normal(coords.shape)
    # spring refinement: ideal distance = graph distance, stronger pull on bonds
    adj_pairs = np.array([[bd.a1, bd.a2] for bd in mol.bonds], dtype=np.int64) \
        if mol.bonds else np.zeros((0, 2), dtype=np.int64)
    for it in range(spring_iters):
        delta = coords[:, None, :] - coords[None, :, :]          # [n,n,2]
        dist = np.sqrt((delta ** 2).sum(-1)) + 1e-9
        # repulsion ~ 1/dist within cutoff
        rep = np.minimum(0.2 / (dist ** 2), 2.0)
        np.fill_diagonal(rep, 0.0)
        force = (delta / dist[..., None] * rep[..., None]).sum(1)
        if len(adj_pairs):
            a1, a2 = adj_pairs[:, 0], adj_pairs[:, 1]
            dvec = coords[a1] - coords[a2]
            dlen = np.sqrt((dvec ** 2).sum(-1, keepdims=True)) + 1e-9
            pull = (dlen - 1.0) * dvec / dlen
            np.add.at(force, a1, -0.5 * pull)
            np.add.at(force, a2, 0.5 * pull)
        step = 0.1 * (1.0 - it / spring_iters) + 0.01
        coords = coords + step * np.clip(force, -1.0, 1.0)
    return coords


def rasterize(mol: Mol, coords: Optional[np.ndarray] = None, size: int = 128,
              pad: float = 0.08, bond_width: float = 1.4,
              atom_radius: float = 2.6) -> np.ndarray:
    """Render to [size,size,3] float32 in [0,1], white background."""
    n = mol.num_atoms
    if coords is None:
        coords = compute_coords(mol)
    img = np.ones((size, size, 3), dtype=np.float32)
    lo = coords.min(0)
    hi = coords.max(0)
    span = max((hi - lo).max(), 1e-6)
    scale = size * (1 - 2 * pad) / span
    offset = (size - scale * (hi - lo)) / 2.0
    pix = (coords - lo) * scale + offset                      # [n,2] pixel coords
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)

    # bonds: stroke distance-to-segment; double/triple drawn thicker,
    # aromatic drawn with a lighter inner tone to stay distinguishable.
    for b in mol.bonds:
        p1, p2 = pix[b.a1], pix[b.a2]
        v = p2 - p1
        L2 = (v ** 2).sum() + 1e-9
        t = np.clip(((xx - p1[0]) * v[0] + (yy - p1[1]) * v[1]) / L2, 0, 1)
        px = p1[0] + t * v[0]
        py = p1[1] + t * v[1]
        dist = np.sqrt((xx - px) ** 2 + (yy - py) ** 2)
        w = bond_width
        if b.order == BOND_DOUBLE:
            w = bond_width * 1.9
        elif b.order == BOND_TRIPLE:
            w = bond_width * 2.6
        elif b.order == BOND_AROMATIC:
            w = bond_width * 1.45
        alpha = np.clip(w + 0.5 - dist, 0.0, 1.0)
        shade = 0.25 if b.order == BOND_AROMATIC else 0.0
        color = np.array([shade, shade, shade], dtype=np.float32)
        img = img * (1 - alpha[..., None]) + color * alpha[..., None]

    # heteroatom disks (carbon left as skeleton, like chemical drawings)
    for i in range(n):
        a = mol.atoms[i]
        if a.z == 6 or a.z <= 1:
            continue
        color = np.array(ELEMENT_COLORS.get(a.z, DEFAULT_COLOR), dtype=np.float32)
        dist = np.sqrt((xx - pix[i][0]) ** 2 + (yy - pix[i][1]) ** 2)
        alpha = np.clip(atom_radius + 0.5 - dist, 0.0, 1.0)
        img = img * (1 - alpha[..., None]) + color * alpha[..., None]
    return img


def depict(smiles_or_mol, size: int = 128) -> Optional[np.ndarray]:
    """SMILES or Mol → [size,size,3] float32 image, or None on parse failure."""
    from bbbp_tpu_torch.chem.smiles import MolFromSmiles

    mol = smiles_or_mol
    if isinstance(smiles_or_mol, str):
        mol = MolFromSmiles(smiles_or_mol)
    if mol is None:
        return None
    return rasterize(mol, size=size)
