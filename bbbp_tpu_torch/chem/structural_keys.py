"""167-bit MACCS-style structural keys from graph predicates.

The original MACCS key SMARTS are MDL-proprietary; this module defines an
equivalent-information 167-key set (bit 0 unused, 166 keys) from direct graph
predicates: element counts at thresholds, ring topology, bonded-pair and
three-atom motifs, donors/acceptors, and charge features. Serves the same role
as ``MACCSkeys.GenMACCSKeys`` in the reference
(reference: Descriptors/create_descriptors.py:24-25). The key definitions are
frozen — the C++ fast path mirrors them index-for-index.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

from bbbp_tpu_torch.chem.mol import (
    Mol,
    BOND_SINGLE,
    BOND_DOUBLE,
    BOND_TRIPLE,
    BOND_AROMATIC,
)

HALOGENS = (9, 17, 35, 53)
METALS = tuple(
    z for z in (3, 4, 11, 12, 13, 19, 20, 26, 27, 28, 29, 30, 47, 48, 50, 78, 79, 80, 82, 83)
)


def _count_z(mol: Mol, zs) -> int:
    if isinstance(zs, int):
        zs = (zs,)
    return sum(1 for a in mol.atoms if a.z in zs)


def _bond_pairs(mol: Mol) -> List[Tuple[int, int, int]]:
    """(z1, z2, order) per bond, z1<=z2."""
    out = []
    for b in mol.bonds:
        z1, z2 = mol.atoms[b.a1].z, mol.atoms[b.a2].z
        out.append((min(z1, z2), max(z1, z2), b.order))
    return out


def _count_bond(mol: Mol, z1: int, z2: int, order: int) -> int:
    lo, hi = min(z1, z2), max(z1, z2)
    return sum(1 for (a, b, o) in _bond_pairs(mol) if a == lo and b == hi and o == order)


def _count_motif3(mol: Mol, z_center: int, z_a: int, order_a: int,
                  z_b: int, order_b: int) -> int:
    """Count center atoms of element z_center bonded to (z_a via order_a) and
    (z_b via order_b) through two distinct bonds."""
    count = 0
    for i, atom in enumerate(mol.atoms):
        if atom.z != z_center:
            continue
        bonds = [(mol.bonds[bi].other(i), mol.bonds[bi].order, bi) for bi in mol.neighbors[i]]
        for (ja, oa, ba) in bonds:
            if mol.atoms[ja].z != z_a or oa != order_a:
                continue
            for (jb, ob, bb) in bonds:
                if bb == ba:
                    continue
                if mol.atoms[jb].z == z_b and ob == order_b:
                    count += 1
                    break
            else:
                continue
            break
    return count


def _ring_sizes(mol: Mol) -> List[int]:
    return [len(r) for r in mol.rings]


def _aromatic_ring_count(mol: Mol) -> int:
    return sum(1 for r in mol.rings if all(mol.atoms[i].aromatic for i in r))


def _hetero_ring_count(mol: Mol) -> int:
    return sum(1 for r in mol.rings if any(mol.atoms[i].z not in (6,) for i in r))


def _donor_count(mol: Mol) -> int:
    return sum(1 for i, a in enumerate(mol.atoms) if a.z in (7, 8) and mol.total_h(i) > 0)


def _acceptor_count(mol: Mol) -> int:
    return sum(1 for a in mol.atoms if a.z in (7, 8) and a.charge <= 0)


def _rotatable_count(mol: Mol) -> int:
    n = 0
    for b in mol.bonds:
        if b.order != BOND_SINGLE or b.in_ring:
            continue
        d1 = sum(1 for j in mol.atom_neighbors(b.a1) if mol.atoms[j].z > 1)
        d2 = sum(1 for j in mol.atom_neighbors(b.a2) if mol.atoms[j].z > 1)
        if d1 > 1 and d2 > 1:
            n += 1
    return n


def _fused_ring_pairs(mol: Mol) -> int:
    n = 0
    for i in range(len(mol.rings)):
        for j in range(i + 1, len(mol.rings)):
            if len(set(mol.rings[i]) & set(mol.rings[j])) >= 2:
                n += 1
    return n


def _quaternary_c(mol: Mol) -> int:
    n = 0
    for i, a in enumerate(mol.atoms):
        if a.z == 6 and sum(1 for j in mol.atom_neighbors(i) if mol.atoms[j].z > 1) >= 4:
            n += 1
    return n


def _aromatic_n(mol: Mol) -> int:
    return sum(1 for a in mol.atoms if a.z == 7 and a.aromatic)


def _in_ring_z(mol: Mol, z: int) -> int:
    return sum(1 for a in mol.atoms if a.z == z and a.in_ring)


def _methyl_count(mol: Mol) -> int:
    n = 0
    for i, a in enumerate(mol.atoms):
        if a.z == 6 and mol.total_h(i) >= 3:
            n += 1
    return n


def _build_keys() -> List[Callable[[Mol], int]]:
    """166 key predicates, each returning a count; bit set iff count >= 1
    (threshold keys bake the threshold into the predicate)."""
    K: List[Callable[[Mol], int]] = []

    def ge(fn: Callable[[Mol], int], t: int) -> Callable[[Mol], int]:
        return lambda m: 1 if fn(m) >= t else 0

    # --- element presence / thresholds (keys 1-40) ---
    for z in (3, 5, 14, 15, 16, 34, 33, 52):        # Li B Si P S Se As Te
        K.append(lambda m, z=z: _count_z(m, z))
    K.append(lambda m: _count_z(m, METALS))          # any metal
    for z, ts in ((7, (1, 2, 3, 4)), (8, (1, 2, 3, 4, 5)), (16, (2, 3)),
                  (9, (1, 2)), (17, (1, 2)), (35, (1,)), (53, (1,))):
        for t in ts:
            K.append(ge(lambda m, z=z: _count_z(m, z), t))
    K.append(lambda m: _count_z(m, HALOGENS))        # any halogen
    K.append(ge(lambda m: _count_z(m, HALOGENS), 2))
    K.append(ge(lambda m: _count_z(m, HALOGENS), 3))
    K.append(ge(lambda m: _count_z(m, (7, 8)), 3))
    K.append(ge(lambda m: _count_z(m, (7, 8)), 5))
    K.append(ge(lambda m: _count_z(m, (7, 8)), 7))
    K.append(ge(lambda m: m.heavy_atom_count(), 10))
    K.append(ge(lambda m: m.heavy_atom_count(), 20))
    K.append(ge(lambda m: m.heavy_atom_count(), 30))
    K.append(ge(lambda m: m.heavy_atom_count(), 40))

    # --- charge features (41-44) ---
    K.append(lambda m: sum(1 for a in m.atoms if a.charge > 0))
    K.append(lambda m: sum(1 for a in m.atoms if a.charge < 0))
    K.append(lambda m: 1 if any(a.charge != 0 for a in m.atoms) else 0)
    K.append(lambda m: 1 if sum(a.charge for a in m.atoms) != 0 else 0)

    # --- ring topology (45-76) ---
    for size in (3, 4, 5, 6, 7, 8):
        K.append(lambda m, s=size: sum(1 for r in _ring_sizes(m) if r == s))
        K.append(ge(lambda m, s=size: sum(1 for r in _ring_sizes(m) if r == s), 2))
    K.append(lambda m: len(m.rings))
    K.append(ge(lambda m: len(m.rings), 2))
    K.append(ge(lambda m: len(m.rings), 3))
    K.append(ge(lambda m: len(m.rings), 4))
    K.append(_aromatic_ring_count)
    K.append(ge(_aromatic_ring_count, 2))
    K.append(ge(_aromatic_ring_count, 3))
    K.append(_hetero_ring_count)
    K.append(ge(_hetero_ring_count, 2))
    K.append(_fused_ring_pairs)
    K.append(ge(_fused_ring_pairs, 2))
    K.append(lambda m: _in_ring_z(m, 7))
    K.append(ge(lambda m: _in_ring_z(m, 7), 2))
    K.append(lambda m: _in_ring_z(m, 8))
    K.append(lambda m: _in_ring_z(m, 16))
    K.append(_aromatic_n)
    K.append(ge(_aromatic_n, 2))
    K.append(lambda m: sum(1 for a in m.atoms if a.z == 8 and a.aromatic))
    K.append(lambda m: sum(1 for a in m.atoms if a.z == 16 and a.aromatic))

    # --- bonded pairs (77-116) ---
    pair_specs = [
        (6, 6, BOND_DOUBLE), (6, 6, BOND_TRIPLE), (6, 7, BOND_SINGLE),
        (6, 7, BOND_DOUBLE), (6, 7, BOND_TRIPLE), (6, 8, BOND_SINGLE),
        (6, 8, BOND_DOUBLE), (7, 7, BOND_SINGLE), (7, 7, BOND_DOUBLE),
        (7, 8, BOND_SINGLE), (7, 8, BOND_DOUBLE), (8, 8, BOND_SINGLE),
        (6, 16, BOND_SINGLE), (6, 16, BOND_DOUBLE), (16, 8, BOND_DOUBLE),
        (16, 8, BOND_SINGLE), (16, 16, BOND_SINGLE), (6, 9, BOND_SINGLE),
        (6, 17, BOND_SINGLE), (6, 35, BOND_SINGLE), (6, 53, BOND_SINGLE),
        (6, 15, BOND_SINGLE), (15, 8, BOND_DOUBLE), (15, 8, BOND_SINGLE),
        (7, 16, BOND_SINGLE), (7, 15, BOND_SINGLE), (16, 7, BOND_DOUBLE),
        (6, 6, BOND_AROMATIC), (6, 7, BOND_AROMATIC), (6, 8, BOND_AROMATIC),
        (6, 16, BOND_AROMATIC), (7, 7, BOND_AROMATIC),
    ]
    for z1, z2, o in pair_specs:
        K.append(lambda m, z1=z1, z2=z2, o=o: _count_bond(m, z1, z2, o))
    K.append(ge(lambda m: _count_bond(m, 6, 8, BOND_DOUBLE), 2))   # >=2 C=O
    K.append(ge(lambda m: _count_bond(m, 6, 7, BOND_SINGLE), 2))
    K.append(ge(lambda m: _count_bond(m, 6, 8, BOND_SINGLE), 2))
    K.append(ge(lambda m: _count_bond(m, 16, 8, BOND_DOUBLE), 2))  # sulfone
    K.append(ge(lambda m: _count_bond(m, 6, 6, BOND_DOUBLE), 2))
    K.append(ge(lambda m: _count_bond(m, 6, 6, BOND_AROMATIC), 7))
    K.append(ge(lambda m: _count_bond(m, 6, 6, BOND_AROMATIC), 12))
    K.append(lambda m: _count_bond(m, 7, 8, BOND_DOUBLE) and _count_z(m, 7))

    # --- three-atom motifs (117-146) ---
    motif_specs = [
        (6, 7, BOND_SINGLE, 8, BOND_DOUBLE),   # amide C(-N)(=O)
        (6, 8, BOND_SINGLE, 8, BOND_DOUBLE),   # ester/acid C(-O)(=O)
        (6, 7, BOND_SINGLE, 7, BOND_SINGLE),   # aminal / guanidine arm
        (6, 8, BOND_SINGLE, 8, BOND_SINGLE),   # acetal
        (6, 7, BOND_DOUBLE, 7, BOND_SINGLE),   # amidine
        (7, 8, BOND_DOUBLE, 8, BOND_DOUBLE),   # nitro
        (16, 8, BOND_DOUBLE, 8, BOND_DOUBLE),  # sulfonyl
        (16, 7, BOND_SINGLE, 8, BOND_DOUBLE),  # sulfonamide
        (6, 6, BOND_DOUBLE, 8, BOND_SINGLE),   # enol ether arm
        (6, 6, BOND_DOUBLE, 7, BOND_SINGLE),   # enamine
        (6, 16, BOND_SINGLE, 16, BOND_SINGLE), # dithioacetal
        (7, 6, BOND_SINGLE, 6, BOND_SINGLE),   # secondary+ amine
        (8, 6, BOND_SINGLE, 6, BOND_SINGLE),   # ether
        (15, 8, BOND_DOUBLE, 8, BOND_SINGLE),  # phosphate arm
        (6, 9, BOND_SINGLE, 9, BOND_SINGLE),   # CF2
        (6, 17, BOND_SINGLE, 17, BOND_SINGLE), # CCl2
    ]
    for zc, za, oa, zb, ob in motif_specs:
        K.append(lambda m, zc=zc, za=za, oa=oa, zb=zb, ob=ob:
                 _count_motif3(m, zc, za, oa, zb, ob))
    K.append(lambda m: _count_motif3(m, 6, 9, BOND_SINGLE, 9, BOND_SINGLE)
             and sum(1 for i, a in enumerate(m.atoms) if a.z == 6 and sum(
                 1 for j in m.atom_neighbors(i) if m.atoms[j].z == 9) >= 3))  # CF3
    K.append(ge(lambda m: _count_motif3(m, 6, 7, BOND_SINGLE, 8, BOND_DOUBLE), 2))
    K.append(ge(lambda m: _count_motif3(m, 6, 8, BOND_SINGLE, 8, BOND_DOUBLE), 2))
    # hydroxyl / thiol / primary amine on carbon
    K.append(lambda m: sum(1 for i, a in enumerate(m.atoms)
                           if a.z == 8 and m.total_h(i) >= 1 and not a.aromatic))
    K.append(lambda m: sum(1 for i, a in enumerate(m.atoms)
                           if a.z == 16 and m.total_h(i) >= 1))
    K.append(lambda m: sum(1 for i, a in enumerate(m.atoms)
                           if a.z == 7 and m.total_h(i) >= 2))
    K.append(lambda m: sum(1 for i, a in enumerate(m.atoms)
                           if a.z == 7 and m.total_h(i) == 1))
    K.append(lambda m: sum(1 for i, a in enumerate(m.atoms)
                           if a.z == 7 and m.total_h(i) == 0 and not a.aromatic))

    # --- global descriptors at thresholds (147-166) ---
    K.append(_donor_count)
    K.append(ge(_donor_count, 2))
    K.append(ge(_donor_count, 4))
    K.append(_acceptor_count)
    K.append(ge(_acceptor_count, 4))
    K.append(ge(_acceptor_count, 7))
    K.append(_rotatable_count)
    K.append(ge(_rotatable_count, 3))
    K.append(ge(_rotatable_count, 6))
    K.append(ge(_rotatable_count, 9))
    K.append(_quaternary_c)
    K.append(_methyl_count)
    K.append(ge(_methyl_count, 2))
    K.append(ge(_methyl_count, 3))
    K.append(lambda m: sum(1 for b in m.bonds if b.order == BOND_TRIPLE))
    K.append(lambda m: sum(1 for a in m.atoms if a.isotope))
    K.append(lambda m: sum(1 for a in m.atoms if a.chirality))
    K.append(ge(lambda m: sum(1 for a in m.atoms if a.chirality), 2))
    K.append(lambda m: 1 if any(b.stereo for b in m.bonds) else 0)
    K.append(lambda m: max(0, len([1 for r in m.rings if len(r) >= 9])))
    # --- supplemental keys to 166 ---
    K.append(lambda m: sum(1 for a in m.atoms if a.z == 6 and a.aromatic))
    K.append(ge(lambda m: sum(1 for a in m.atoms if a.z == 6 and a.aromatic), 10))
    K.append(lambda m: sum(1 for i, a in enumerate(m.atoms)
                           if a.z == 6 and not a.in_ring and not a.aromatic))
    K.append(ge(lambda m: sum(1 for i, a in enumerate(m.atoms)
                              if a.z == 6 and not a.in_ring), 6))
    K.append(lambda m: sum(1 for b in m.bonds if b.order == BOND_DOUBLE and not b.in_ring))
    K.append(ge(lambda m: sum(1 for b in m.bonds if b.order == BOND_DOUBLE), 3))
    K.append(lambda m: sum(1 for i, a in enumerate(m.atoms) if a.z == 8 and m.total_h(i) >= 1
                           and any(m.atoms[j].aromatic for j in m.atom_neighbors(i))))  # phenol
    K.append(lambda m: sum(1 for i, a in enumerate(m.atoms) if a.z == 7
                           and any(m.atoms[j].aromatic for j in m.atom_neighbors(i))
                           and not a.aromatic))  # aniline-type N
    K.append(lambda m: sum(1 for r in m.rings if len(r) == 5
                           and all(m.atoms[i].aromatic for i in r)))  # 5-arom ring
    K.append(lambda m: sum(1 for r in m.rings if len(r) == 6
                           and all(m.atoms[i].aromatic for i in r)))  # 6-arom ring
    K.append(lambda m: sum(1 for r in m.rings
                           if not any(m.atoms[i].z != 6 for i in r)
                           and not all(m.atoms[i].aromatic for i in r)))  # saturated carbocycle

    assert len(K) == 166, f"expected 166 keys, got {len(K)}"
    return K


_KEYS = _build_keys()


def compute_structural_keys(mol: Mol) -> np.ndarray:
    """167-length 0/1 vector; index 0 unused (matches RDKit MACCS layout)."""
    out = np.zeros(167, dtype=np.float32)
    for k, fn in enumerate(_KEYS):
        try:
            if fn(mol):
                out[k + 1] = 1.0
        except Exception:
            pass
    return out
