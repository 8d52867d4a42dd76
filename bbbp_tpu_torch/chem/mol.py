"""Molecular graph: atoms, bonds, ring perception, aromaticity, implicit H.

Built from scratch for this framework (no RDKit in the image). Capabilities
mirror what the reference obtains from RDKit ``Chem.MolFromSmiles`` sanitization
(reference: Descriptors/create_descriptors.py:13-36): valence-based implicit-H
assignment, SSSR-style ring perception, and Hückel-style aromaticity perception
so kekulé and aromatic input forms of the same molecule featurize identically.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# Atomic numbers for the symbols we accept. Covers the full organic subset and
# every element appearing in B3DB / ZINC drug-like molecules, plus common salts.
SYMBOL_TO_Z: Dict[str, int] = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8, "F": 9,
    "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15, "S": 16,
    "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Sc": 21, "Ti": 22, "V": 23,
    "Cr": 24, "Mn": 25, "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29, "Zn": 30,
    "Ga": 31, "Ge": 32, "As": 33, "Se": 34, "Br": 35, "Kr": 36, "Rb": 37,
    "Sr": 38, "Y": 39, "Zr": 40, "Nb": 41, "Mo": 42, "Tc": 43, "Ru": 44,
    "Rh": 45, "Pd": 46, "Ag": 47, "Cd": 48, "In": 49, "Sn": 50, "Sb": 51,
    "Te": 52, "I": 53, "Xe": 54, "Cs": 55, "Ba": 56, "La": 57, "Gd": 64,
    "Pt": 78, "Au": 79, "Hg": 80, "Tl": 81, "Pb": 82, "Bi": 83, "Ra": 88,
    "*": 0,
}
Z_TO_SYMBOL: Dict[int, str] = {v: k for k, v in SYMBOL_TO_Z.items()}

# Default valence lists (Daylight organic-subset rules): the implicit hydrogen
# count fills the smallest listed valence >= current bond-order sum.
DEFAULT_VALENCES: Dict[int, Tuple[int, ...]] = {
    5: (3,),          # B
    6: (4,),          # C
    7: (3, 5),        # N
    8: (2,),          # O
    15: (3, 5),       # P
    16: (2, 4, 6),    # S
    9: (1,), 17: (1,), 35: (1,), 53: (1,),  # halogens
}

# Bond order encodings. Aromatic uses 1.5 for valence math; a distinct code for
# hashing/fingerprints.
BOND_SINGLE, BOND_DOUBLE, BOND_TRIPLE, BOND_AROMATIC, BOND_QUAD = 1, 2, 3, 12, 4
BOND_ORDER_VALUE = {
    BOND_SINGLE: 1.0,
    BOND_DOUBLE: 2.0,
    BOND_TRIPLE: 3.0,
    BOND_QUAD: 4.0,
    BOND_AROMATIC: 1.5,
}


@dataclass
class Atom:
    z: int                      # atomic number (0 = wildcard '*')
    aromatic: bool = False
    charge: int = 0
    isotope: int = 0
    n_h: int = -1               # -1 = to be inferred from valence rules
    explicit_h: bool = False    # True if H count was given in brackets
    chirality: int = 0          # 0 none, 1 @, 2 @@
    atom_map: int = 0
    idx: int = -1
    # filled by Mol.finalize():
    in_ring: bool = False
    min_ring_size: int = 0
    degree: int = 0             # heavy-atom degree

    @property
    def symbol(self) -> str:
        return Z_TO_SYMBOL.get(self.z, "?")


@dataclass
class Bond:
    a1: int
    a2: int
    order: int = BOND_SINGLE    # BOND_* code
    stereo: int = 0             # 0 none, 1 '/', 2 '\'
    idx: int = -1
    in_ring: bool = False

    def other(self, i: int) -> int:
        return self.a2 if i == self.a1 else self.a1

    @property
    def order_value(self) -> float:
        return BOND_ORDER_VALUE[self.order]


class Mol:
    """A molecular graph. Call ``finalize()`` after construction."""

    def __init__(self) -> None:
        self.atoms: List[Atom] = []
        self.bonds: List[Bond] = []
        self.neighbors: List[List[int]] = []     # atom idx -> [bond idx]
        self.rings: List[List[int]] = []         # SSSR-style rings (atom idx lists)
        self._bond_map: Dict[Tuple[int, int], int] = {}

    # -- construction -----------------------------------------------------
    def add_atom(self, atom: Atom) -> int:
        atom.idx = len(self.atoms)
        self.atoms.append(atom)
        self.neighbors.append([])
        return atom.idx

    def add_bond(self, a1: int, a2: int, order: int = BOND_SINGLE, stereo: int = 0) -> int:
        if a1 == a2:
            raise ValueError("self-bond")
        key = (min(a1, a2), max(a1, a2))
        if key in self._bond_map:
            raise ValueError(f"duplicate bond {key}")
        bond = Bond(a1, a2, order, stereo, idx=len(self.bonds))
        self.bonds.append(bond)
        self._bond_map[key] = bond.idx
        self.neighbors[a1].append(bond.idx)
        self.neighbors[a2].append(bond.idx)
        return bond.idx

    def get_bond(self, a1: int, a2: int) -> Optional[Bond]:
        i = self._bond_map.get((min(a1, a2), max(a1, a2)))
        return self.bonds[i] if i is not None else None

    @property
    def num_atoms(self) -> int:
        return len(self.atoms)

    @property
    def num_bonds(self) -> int:
        return len(self.bonds)

    def atom_neighbors(self, i: int) -> List[int]:
        return [self.bonds[b].other(i) for b in self.neighbors[i]]

    # -- perception --------------------------------------------------------
    def finalize(self) -> "Mol":
        """Ring perception → implicit H → aromaticity perception.

        H must be inferred BEFORE aromatization: kekulé inputs carry the H
        count in their explicit bond orders (pyrrole N with two ring singles
        → 1 H); once ring bonds become order-1.5 that information is gone.
        Aromatic-form inputs are unaffected (their bonds parse as aromatic
        already, so the 1.5 arithmetic applies either way).
        """
        self._perceive_rings()
        self._assign_implicit_h()
        self._perceive_aromaticity()
        # sanitize: an aromatic bond outside any ring (biaryl linkage written
        # without the explicit '-') cannot be aromatic — demote to single
        for b in self.bonds:
            if b.order == BOND_AROMATIC and not b.in_ring:
                b.order = BOND_SINGLE
        for a in self.atoms:
            a.degree = len(self.neighbors[a.idx])
        return self

    def _perceive_rings(self) -> None:
        """Atom-order-INVARIANT ring perception.

        Ring bonds = non-bridge bonds (bridge set is a graph invariant, unlike
        a spanning-tree cycle basis whose chord choice depends on atom order —
        the original cause of canonicalization mismatches in fused systems).
        For every ring bond, the smallest cycle through it (BFS excluding the
        bond) supplies ring membership and per-atom minimum ring size; its
        LENGTH is invariant even when the particular shortest path is tied.
        """
        n = self.num_atoms
        bridges = self._find_bridges()
        rings: List[List[int]] = []
        seen_ringsets = set()
        ring_bond_cycle_len: Dict[int, int] = {}
        for bi, b in enumerate(self.bonds):
            if bridges[bi]:
                continue
            path = self._shortest_path_excluding(b.a1, b.a2, bi)
            if path is None:
                continue
            ring_bond_cycle_len[bi] = len(path)
            key = frozenset(path)
            if key not in seen_ringsets:
                seen_ringsets.add(key)
                rings.append(path)
        self.rings = rings
        for b in self.bonds:
            b.in_ring = b.idx in ring_bond_cycle_len
        for a in self.atoms:
            sizes = [ring_bond_cycle_len[bi] for bi in self.neighbors[a.idx]
                     if bi in ring_bond_cycle_len]
            a.in_ring = bool(sizes)
            a.min_ring_size = min(sizes) if sizes else 0

    def _find_bridges(self) -> List[bool]:
        """Tarjan bridge finding (iterative); True = bridge (not on any cycle)."""
        n = self.num_atoms
        disc = [-1] * n
        low = [0] * n
        is_bridge = [False] * self.num_bonds
        timer = [0]
        for root in range(n):
            if disc[root] != -1:
                continue
            stack = [(root, -1, iter(self.neighbors[root]))]
            disc[root] = low[root] = timer[0]
            timer[0] += 1
            while stack:
                u, pbond, it = stack[-1]
                advanced = False
                for bi in it:
                    if bi == pbond:
                        continue
                    v = self.bonds[bi].other(u)
                    if disc[v] == -1:
                        disc[v] = low[v] = timer[0]
                        timer[0] += 1
                        stack.append((v, bi, iter(self.neighbors[v])))
                        advanced = True
                        break
                    else:
                        low[u] = min(low[u], disc[v])
                if not advanced:
                    stack.pop()
                    if stack:
                        parent = stack[-1][0]
                        low[parent] = min(low[parent], low[u])
                        if low[u] > disc[parent]:
                            is_bridge[pbond] = True
        return is_bridge

    def _shortest_path_excluding(self, src: int, dst: int, skip_bond: int) -> Optional[List[int]]:
        from collections import deque

        prev = {src: -1}
        q = deque([src])
        while q:
            u = q.popleft()
            if u == dst:
                path = []
                while u != -1:
                    path.append(u)
                    u = prev[u]
                return path
            for bi in self.neighbors[u]:
                if bi == skip_bond:
                    continue
                v = self.bonds[bi].other(u)
                if v not in prev:
                    prev[v] = u
                    q.append(v)
        return None

    def _perceive_aromaticity(self) -> None:
        """Hückel-style perception so kekulé inputs gain aromatic flags.

        Per ring (sizes 5-7, then a second pass for fused systems): every atom
        must be sp2-capable; π-electron count over the ring must be 4n+2.
        Contributions: atom in a ring double bond → 1; exocyclic double bond
        → 0; heteroatom (N,O,S with single bonds only) → 2 (lone pair);
        carbanion → 2; carbocation → 0.
        """
        # Atoms already flagged aromatic (from aromatic SMILES) keep their flag;
        # bonds between two aromatic atoms within a ring become aromatic below.
        changed = True
        passes = 0
        while changed and passes < 6:
            changed = False
            passes += 1
            for ring in self.rings:
                if not (3 <= len(ring) <= 7):
                    continue
                if all(self.atoms[i].aromatic for i in ring):
                    continue
                pi = self._ring_pi_electrons(ring)
                if pi is None:
                    continue
                if pi % 4 == 2:
                    for i in ring:
                        if not self.atoms[i].aromatic:
                            self.atoms[i].aromatic = True
                            changed = True
            # fused systems: a kekulé resonance form may place doubles across
            # the fusion so no single ring passes Hückel while the union does
            # (quinoxaline, naphthalene alt-forms); evaluate bond-fused unions
            for union in self._fused_ring_unions():
                if all(self.atoms[i].aromatic for i in union):
                    continue
                pi = self._ring_pi_electrons(sorted(union))
                if pi is not None and pi % 4 == 2:
                    for i in union:
                        if not self.atoms[i].aromatic:
                            self.atoms[i].aromatic = True
                            changed = True
        # Mark ring bonds between aromatic atoms as aromatic.
        for ring in self.rings:
            if all(self.atoms[i].aromatic for i in ring):
                for i in range(len(ring)):
                    b = self.get_bond(ring[i], ring[(i + 1) % len(ring)])
                    if b is not None:
                        b.order = BOND_AROMATIC

    def _fused_ring_unions(self) -> List[set]:
        """Connected components of size-3..7 rings sharing a bond → atom unions."""
        # only π-capable rings join a union: a fused sp3 ring (e.g. the
        # tetrahydro ring of a carboline) must not veto the aromatic part
        small = [r for r in self.rings if 3 <= len(r) <= 7
                 and self._ring_pi_electrons(r) is not None]
        if len(small) < 2:
            return []
        ring_bondsets = []
        for r in small:
            bs = set()
            for i in range(len(r)):
                a1, a2 = r[i], r[(i + 1) % len(r)]
                bs.add((min(a1, a2), max(a1, a2)))
            ring_bondsets.append(bs)
        parent = list(range(len(small)))

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        for i in range(len(small)):
            for j in range(i + 1, len(small)):
                if ring_bondsets[i] & ring_bondsets[j]:
                    parent[find(i)] = find(j)
        comps: Dict[int, set] = {}
        counts: Dict[int, int] = {}
        for i, r in enumerate(small):
            root = find(i)
            comps.setdefault(root, set()).update(r)
            counts[root] = counts.get(root, 0) + 1
        return [atoms for k, atoms in comps.items() if counts[k] > 1]

    def _ring_pi_electrons(self, ring: List[int]) -> Optional[int]:
        ring_set = set(ring)
        total = 0
        for i in ring:
            atom = self.atoms[i]
            contrib = self._pi_contribution(atom, ring_set)
            if contrib is None:
                return None
            total += contrib
        return total

    def _pi_contribution(self, atom: Atom, ring_set: set) -> Optional[int]:
        in_ring_double = False
        exo_double = False
        has_triple = False
        for bi in self.neighbors[atom.idx]:
            b = self.bonds[bi]
            other = b.other(atom.idx)
            if b.order == BOND_DOUBLE:
                if other in ring_set:
                    in_ring_double = True
                else:
                    exo_double = True
            elif b.order == BOND_AROMATIC:
                # canonical rule: an aromatic bond means this atom's π electron
                # is delocalized in an (already perceived) aromatic system —
                # count it like an exocyclic double regardless of direction, so
                # fused-ring evaluation is identical for kekulé and aromatic
                # input forms (kekulé evaluation happens before any bond is
                # converted to aromatic, where such bonds read as exo doubles)
                exo_double = True
            elif b.order == BOND_TRIPLE:
                has_triple = True
        if has_triple:
            return None
        if in_ring_double:
            return 1
        z = atom.z
        if exo_double:
            # e.g. ring C=O carbon contributes 0 π electrons (tropone-style)
            return 0
        if z == 6:
            if atom.charge == -1:
                return 2
            if atom.charge == 1:
                return 0
            # sp3 carbon with no double bond cannot be aromatic
            return None
        if z in (7, 15):  # N, P with three single bonds: lone pair in ring
            return 2
        if z in (8, 16, 34):  # O, S, Se
            return 2
        return None

    def _assign_implicit_h(self) -> None:
        import math

        for atom in self.atoms:
            if atom.explicit_h or atom.n_h >= 0:
                continue  # bracket atoms: H count is exactly as written
            valences = DEFAULT_VALENCES.get(atom.z)
            if valences is None:
                atom.n_h = 0
                continue
            order_sum = 0.0
            for bi in self.neighbors[atom.idx]:
                order_sum += self.bonds[bi].order_value
            # An aromatic atom written in lowercase with no ring double bonds
            # still sits in an aromatic system: aromatic bonds at 1.5 handle it.
            used = math.ceil(order_sum - 1e-9)
            # charge adjustment per common organic rules
            adj = atom.charge if atom.z in (7, 15) else -abs(atom.charge)
            nh = 0
            for v in valences:
                if v + adj >= used:
                    nh = v + adj - used
                    break
            atom.n_h = max(0, nh)

    # -- convenience -------------------------------------------------------
    def heavy_atom_count(self) -> int:
        return sum(1 for a in self.atoms if a.z > 1)

    def total_h(self, i: int) -> int:
        """Implicit + neighboring explicit hydrogens."""
        atom = self.atoms[i]
        nh = max(atom.n_h, 0)
        for j in self.atom_neighbors(i):
            if self.atoms[j].z == 1:
                nh += 1
        return nh

    def __repr__(self) -> str:
        return f"Mol(atoms={self.num_atoms}, bonds={self.num_bonds}, rings={len(self.rings)})"
