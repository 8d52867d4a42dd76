"""Physicochemical molecular descriptors from the molecular graph.

Beyond-parity featurization: the reference uses only fingerprints + images
(SURVEY.md §2.2), but logBB is physically driven by polarity/lipophilicity/
size. This module computes the classic descriptor set from this framework's
own graph:

- size/composition: MW, heavy atoms, rings, aromatic rings/atoms, halogens
- polarity: Ertl-style TPSA (topological polar surface area; published
  N/O/S/P environment contributions, J. Med. Chem. 43 (2000) 3714 — public
  parameter table), HBD/HBA counts
- lipophilicity: additive atom-contribution logP proxy (coarse
  Crippen-inspired atom classes)
- flexibility/shape: rotatable bonds, fraction sp3 carbons, Bertz-like
  complexity proxy, Wiener-index proxy over graph distances
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from bbbp_tpu_torch.chem.mol import (
    Mol, BOND_SINGLE, BOND_DOUBLE, BOND_TRIPLE, BOND_AROMATIC)
from bbbp_tpu_torch.chem.smiles import MolFromSmiles

ATOMIC_MASS = {
    1: 1.008, 5: 10.81, 6: 12.011, 7: 14.007, 8: 15.999, 9: 18.998,
    11: 22.99, 12: 24.305, 14: 28.085, 15: 30.974, 16: 32.06, 17: 35.45,
    19: 39.098, 20: 40.078, 26: 55.845, 29: 63.546, 30: 65.38, 34: 78.971,
    35: 79.904, 53: 126.904,
}

DESCRIPTOR_NAMES = [
    "mw", "heavy_atoms", "n_rings", "n_aromatic_rings", "aromatic_fraction",
    "tpsa", "hbd", "hba", "logp", "rotatable_bonds", "frac_sp3",
    "n_halogens", "n_heteroatoms", "formal_charge_abs", "wiener_proxy",
    "complexity", "n_o_count", "amide_count", "max_ring_size", "n_fragments",
    # Crippen-family and ionization descriptors (round 2): logBB is classically
    # modeled as a·clogP + b·TPSA + c (SURVEY.md §7 beyond-parity featurization)
    "cmr", "n_basic_n", "n_acidic", "n_arom_hetero",
    # Kier-Hall connectivity / shape indices (classic QSPR topology terms)
    "chi0", "chi1", "chi0v", "chi1v", "kappa1", "kappa2", "zagreb",
]
N_DESCRIPTORS = len(DESCRIPTOR_NAMES)

# Kier-Hall valence-delta parameters: (Zv - h) / (Z - Zv - 1); Zv = valence
# electrons. Simple-delta uses heavy-atom degree.
_VALENCE_ELECTRONS = {5: 3, 6: 4, 7: 5, 8: 6, 9: 7, 14: 4, 15: 5, 16: 6,
                      17: 7, 35: 7, 53: 7}


def _connectivity_indices(mol: Mol):
    """(chi0, chi1, chi0v, chi1v, kappa1, kappa2, zagreb)."""
    heavy = [a for a in mol.atoms if a.z > 1]
    n = len(heavy)
    if n == 0:
        return (0.0,) * 7
    deg = {}
    dval = {}
    for a in heavy:
        i = a.idx
        d = sum(1 for j in mol.atom_neighbors(i) if mol.atoms[j].z > 1)
        deg[i] = d
        zv = _VALENCE_ELECTRONS.get(a.z, 4)
        h = mol.total_h(i)
        denom = a.z - zv - 1
        dv = (zv - h) / denom if denom > 0 else float(max(zv - h, 1))
        dval[i] = max(dv, 1e-6)
    chi0 = sum(1.0 / np.sqrt(d) for d in deg.values() if d > 0)
    chi0v = sum(1.0 / np.sqrt(dval[i]) for i in deg)
    chi1 = 0.0
    chi1v = 0.0
    n_bonds = 0
    for b in mol.bonds:
        if mol.atoms[b.a1].z > 1 and mol.atoms[b.a2].z > 1:
            n_bonds += 1
            if deg[b.a1] > 0 and deg[b.a2] > 0:
                chi1 += 1.0 / np.sqrt(deg[b.a1] * deg[b.a2])
            chi1v += 1.0 / np.sqrt(dval[b.a1] * dval[b.a2])
    p2 = 0
    for a in heavy:
        d = deg[a.idx]
        p2 += d * (d - 1) // 2              # paths of length 2
    kappa1 = n * (n - 1) ** 2 / max(n_bonds, 1) ** 2
    kappa2 = (n - 1) * (n - 2) ** 2 / max(p2, 1) ** 2 if n > 2 else 0.0
    zagreb = float(sum(d * d for d in deg.values()))
    return (chi0, chi1, chi0v, chi1v, kappa1, kappa2, zagreb)


def _tpsa(mol: Mol) -> float:
    """Ertl TPSA main contributions by N/O/S/P environment."""
    total = 0.0
    for a in mol.atoms:
        i = a.idx
        h = mol.total_h(i)
        deg = sum(1 for j in mol.atom_neighbors(i) if mol.atoms[j].z > 1)
        orders = [mol.bonds[bi].order for bi in mol.neighbors[i]]
        n_double = orders.count(BOND_DOUBLE)
        n_triple = orders.count(BOND_TRIPLE)
        if a.z == 7:
            if a.aromatic:
                if h == 0:
                    total += 12.89 if deg == 3 else 12.36
                else:
                    total += 15.79
            elif a.charge == 1:
                total += {0: 27.64, 1: 16.61, 2: 4.44, 3: 0.0}.get(3 - deg, 4.44) \
                    if h == 0 else (27.64 if h >= 3 else 16.61 if h == 2 else 4.44)
            elif n_triple:
                total += 23.79
            elif n_double:
                total += 12.36 if h == 0 else 23.85
            else:
                total += {0: 3.24, 1: 12.03, 2: 26.02}.get(h, 26.02)
        elif a.z == 8:
            if a.aromatic:
                total += 13.14
            elif a.charge == -1:
                total += 23.06
            elif n_double:
                total += 17.07
            elif h >= 1:
                total += 20.23
            else:
                total += 9.23
        elif a.z == 16:
            if a.aromatic:
                total += 28.24
            elif n_double:
                total += 32.09
            elif h >= 1:
                total += 38.80
            else:
                total += 25.30
        elif a.z == 15:
            total += 13.59 if n_double else 9.81
    return total


def _basic_nitrogens(mol: Mol) -> int:
    """Aliphatic amine nitrogens (protonatable at pH 7.4) — no adjacent
    carbonyl (amide), not aromatic, no double/triple bonds on N."""
    n = 0
    for a in mol.atoms:
        if a.z != 7 or a.aromatic or a.charge < 0:
            continue
        orders = [mol.bonds[bi].order for bi in mol.neighbors[a.idx]]
        if any(o in (BOND_DOUBLE, BOND_TRIPLE, BOND_AROMATIC) for o in orders):
            continue
        amide = False
        for j in mol.atom_neighbors(a.idx):
            if mol.atoms[j].z == 6:
                for bi in mol.neighbors[j]:
                    b = mol.bonds[bi]
                    if b.order == BOND_DOUBLE and mol.atoms[b.other(j)].z in (7, 8, 16):
                        amide = True
        if not amide:
            n += 1
    return n


def _acidic_groups(mol: Mol) -> int:
    """Carboxylic/sulfonic acid groups (deprotonatable at pH 7.4)."""
    n = 0
    for a in mol.atoms:
        if a.z not in (6, 16):
            continue
        has_dbl_o = False
        has_oh = False
        for j in mol.atom_neighbors(a.idx):
            if mol.atoms[j].z != 8:
                continue
            b = mol.get_bond(a.idx, j)
            if b.order == BOND_DOUBLE:
                has_dbl_o = True
            elif b.order == BOND_SINGLE and (
                    mol.total_h(j) > 0 or mol.atoms[j].charge < 0):
                has_oh = True
        if has_dbl_o and has_oh:
            n += 1
    return n


# coarse additive logP atom contributions (Crippen-inspired classes);
# superseded as the 'logp' descriptor by chem.crippen but kept for tests/compat
def _logp(mol: Mol) -> float:
    total = 0.0
    for a in mol.atoms:
        i = a.idx
        h = mol.total_h(i)
        if a.z == 6:
            if a.aromatic:
                total += 0.29
            else:
                hetero_nbr = any(mol.atoms[j].z not in (1, 6)
                                 for j in mol.atom_neighbors(i))
                total += -0.02 if hetero_nbr else 0.14
            total += 0.12 * h
        elif a.z == 7:
            total += -0.60 if h else -0.30
        elif a.z == 8:
            total += -0.45 if h else -0.20
        elif a.z == 16:
            total += 0.45
        elif a.z == 9:
            total += 0.22
        elif a.z == 17:
            total += 0.65
        elif a.z == 35:
            total += 0.86
        elif a.z == 53:
            total += 1.10
        elif a.z == 15:
            total += -0.20
        if a.charge != 0:
            total -= 1.0 * abs(a.charge)
    return total


def compute_descriptors(mol: Mol) -> np.ndarray:
    n = mol.num_atoms
    heavy = [a for a in mol.atoms if a.z > 1]
    mw = sum(ATOMIC_MASS.get(a.z, 50.0) for a in mol.atoms) + \
        sum(mol.total_h(a.idx) for a in mol.atoms if a.z > 1) * 1.008
    arom_atoms = sum(1 for a in heavy if a.aromatic)
    arom_rings = sum(1 for r in mol.rings
                     if all(mol.atoms[i].aromatic for i in r))
    hbd = sum(1 for a in heavy if a.z in (7, 8) and mol.total_h(a.idx) > 0)
    hba = sum(1 for a in heavy if a.z in (7, 8) and a.charge <= 0)
    rot = 0
    for b in mol.bonds:
        if b.order != 1 or b.in_ring:
            continue
        d1 = sum(1 for j in mol.atom_neighbors(b.a1) if mol.atoms[j].z > 1)
        d2 = sum(1 for j in mol.atom_neighbors(b.a2) if mol.atoms[j].z > 1)
        if d1 > 1 and d2 > 1:
            rot += 1
    carbons = [a for a in heavy if a.z == 6]
    sp3 = sum(1 for a in carbons if not a.aromatic and not any(
        mol.bonds[bi].order in (BOND_DOUBLE, BOND_TRIPLE, BOND_AROMATIC)
        for bi in mol.neighbors[a.idx]))
    frac_sp3 = sp3 / max(len(carbons), 1)
    halogens = sum(1 for a in heavy if a.z in (9, 17, 35, 53))
    hetero = sum(1 for a in heavy if a.z not in (1, 6))
    # Wiener proxy on up-to-60 heavy atoms (O(n^2) BFS)
    from bbbp_tpu_torch.chem.graph import graph_distances

    if n <= 80:
        d = graph_distances(mol)
        wiener = float(np.triu(np.minimum(d, n)).sum()) / max(n, 1)
    else:
        wiener = float(n)
    complexity = mol.num_bonds + 2.0 * len(mol.rings) + 0.5 * hetero
    amide = 0
    for b in mol.bonds:
        z1, z2 = mol.atoms[b.a1].z, mol.atoms[b.a2].z
        if b.order == 1 and {z1, z2} == {6, 7}:
            c = b.a1 if z1 == 6 else b.a2
            if any(mol.bonds[bi].order == BOND_DOUBLE
                   and mol.atoms[mol.bonds[bi].other(c)].z == 8
                   for bi in mol.neighbors[c]):
                amide += 1
    n_frag = 1
    seen = set()
    for s in range(n):
        if s in seen:
            continue
        if seen:
            n_frag += 1
        stack = [s]
        seen.add(s)
        while stack:
            u = stack.pop()
            for v in mol.atom_neighbors(u):
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
    from bbbp_tpu_torch.chem.crippen import crippen_logp_mr

    clogp, cmr = crippen_logp_mr(mol)
    vals = [
        mw, len(heavy), len(mol.rings), arom_rings,
        arom_atoms / max(len(heavy), 1),
        _tpsa(mol), hbd, hba, clogp, rot, frac_sp3,
        halogens, hetero, float(sum(abs(a.charge) for a in mol.atoms)),
        wiener, complexity,
        sum(1 for a in heavy if a.z in (7, 8)), amide,
        max((len(r) for r in mol.rings), default=0), n_frag,
        cmr, _basic_nitrogens(mol), _acidic_groups(mol),
        sum(1 for a in heavy if a.aromatic and a.z != 6),
        *_connectivity_indices(mol),
    ]
    return np.asarray(vals, dtype=np.float32)


def descriptor_matrix(smiles: Sequence[str]) -> tuple:
    """SMILES batch → ([N, N_DESCRIPTORS] float32, bad indices)."""
    out = np.zeros((len(smiles), N_DESCRIPTORS), dtype=np.float32)
    bad = []
    for i, s in enumerate(smiles):
        mol = MolFromSmiles(s)
        if mol is None:
            bad.append(i)
            continue
        out[i] = compute_descriptors(mol)
    return out, bad
