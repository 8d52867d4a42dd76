"""Graph distances of a molecule, the one function of
``bbbp_tpu/chem/depict.py`` that the fingerprints and descriptors use."""

from __future__ import annotations

import numpy as np

from bbbp_tpu_torch.chem.mol import Mol


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
