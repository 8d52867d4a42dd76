"""Fingerprints: Morgan/ECFP, topological path, and MACCS-style structural keys.

Functional equivalents of the reference's RDKit calls
(reference: Descriptors/create_descriptors.py:19-36 —
``AllChem.GetMorganFingerprintAsBitVect(mol, 2, nBits=2048)``,
``MACCSkeys.GenMACCSKeys(mol)`` (167 bits), ``Chem.RDKFingerprint(mol)``
(2048-bit path fingerprint)). Bit layouts are this framework's own (RDKit is
not in the image to match bit-for-bit); predictive content is equivalent, and
the hashing scheme is fixed so the C++ fast path (bbbpchem.cpp) reproduces
these bits exactly.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from bbbp_tpu_torch.chem.mol import (
    Mol,
    BOND_SINGLE,
    BOND_DOUBLE,
    BOND_TRIPLE,
    BOND_AROMATIC,
)

_MASK64 = (1 << 64) - 1


def _mix(h: int, v: int) -> int:
    """64-bit hash combine (splitmix64-style). Must match native/bbbpchem.cpp."""
    h = (h ^ (v & _MASK64)) * 0x100000001B3 & _MASK64
    h ^= h >> 29
    h = (h * 0xBF58476D1CE4E5B9) & _MASK64
    h ^= h >> 32
    return h


def _bond_code(order: int) -> int:
    return {BOND_SINGLE: 1, BOND_DOUBLE: 2, BOND_TRIPLE: 3, BOND_AROMATIC: 4}.get(order, 5)


def _atom_invariant(mol: Mol, i: int) -> int:
    """Initial ECFP invariant: (Z, heavy degree, total H, charge, ring, aromatic, isotope)."""
    a = mol.atoms[i]
    heavy_deg = sum(1 for j in mol.atom_neighbors(i) if mol.atoms[j].z > 1)
    h = 0xcbf29ce484222325
    h = _mix(h, a.z)
    h = _mix(h, heavy_deg)
    h = _mix(h, mol.total_h(i))
    h = _mix(h, a.charge & 0xFF)
    h = _mix(h, 1 if a.in_ring else 0)
    h = _mix(h, 1 if a.aromatic else 0)
    h = _mix(h, a.isotope)
    return h


def morgan_environments(mol: Mol, radius: int = 2) -> List[Tuple[int, int, frozenset]]:
    """ECFP environments: list of (invariant_hash, radius, bond-set) per atom/radius.

    The bond-set is used for RDKit-style deduplication: two environments with
    identical bond sets at the same radius keep only the lower invariant.
    """
    n = mol.num_atoms
    inv = [_atom_invariant(mol, i) for i in range(n)]
    # bond neighborhood per atom per radius
    env_bonds: List[Set[int]] = [set() for _ in range(n)]
    out: List[Tuple[int, int, frozenset]] = [
        (inv[i], 0, frozenset()) for i in range(n) if mol.atoms[i].z > 1
    ]
    for r in range(1, radius + 1):
        new_inv = list(inv)
        new_env: List[Set[int]] = [set(e) for e in env_bonds]
        for i in range(n):
            if mol.atoms[i].z <= 1:
                continue
            nbrs = []
            for bi in mol.neighbors[i]:
                b = mol.bonds[bi]
                j = b.other(i)
                if mol.atoms[j].z <= 1:
                    continue
                nbrs.append((_bond_code(b.order), inv[j], bi))
            nbrs.sort(key=lambda t: (t[0], t[1]))
            h = 0x9e3779b97f4a7c15
            h = _mix(h, r)
            h = _mix(h, inv[i])
            for code, nh, bi in nbrs:
                h = _mix(h, code)
                h = _mix(h, nh)
                new_env[i].add(bi)
                new_env[i] |= env_bonds[mol.bonds[bi].other(i)]
            new_inv[i] = h
        inv, env_bonds = new_inv, new_env
        for i in range(n):
            if mol.atoms[i].z > 1:
                out.append((inv[i], r, frozenset(env_bonds[i])))
    return out


def morgan_bits(mol: Mol, radius: int = 2, n_bits: int = 2048) -> Set[int]:
    envs = morgan_environments(mol, radius)
    # dedupe identical environments (same bond set, same radius>0)
    best: Dict[Tuple[int, frozenset], int] = {}
    bits: Set[int] = set()
    for h, r, bset in envs:
        if r == 0:
            bits.add(h % n_bits)
        else:
            key = (r, bset)
            if key not in best or h < best[key]:
                best[key] = h
    for h in best.values():
        bits.add(h % n_bits)
    return bits


def morgan_fingerprint(mol: Mol, radius: int = 2, n_bits: int = 2048,
                       dtype=np.float32) -> np.ndarray:
    """Dense Morgan/ECFP bit vector (reference: create_descriptors.py:21-22)."""
    fp = np.zeros(n_bits, dtype=dtype)
    idx = list(morgan_bits(mol, radius, n_bits))
    if idx:
        fp[np.asarray(idx, dtype=np.int64)] = 1
    return fp


def morgan_count_fingerprint(mol: Mol, radius: int = 2, n_bits: int = 2048,
                             dtype=np.float32) -> np.ndarray:
    """Hashed Morgan COUNT vector (ECFC): each unique environment adds 1 to its
    folded bucket per occurrence. Counts carry repeated-substructure signal the
    binary bits discard (beyond-parity input for the regression tree legs)."""
    fp = np.zeros(n_bits, dtype=dtype)
    seen: Dict[Tuple[int, frozenset], int] = {}
    for h, r, bset in morgan_environments(mol, radius):
        if r == 0:
            fp[h % n_bits] += 1
        else:
            key = (r, bset)
            if key not in seen or h < seen[key]:
                seen[key] = h
    for h in seen.values():
        fp[h % n_bits] += 1
    return fp


# ---------------------------------------------------------------------------
# Path (RDKit-topological-style) fingerprint
# ---------------------------------------------------------------------------

def _path_atom_code(mol: Mol, i: int) -> int:
    a = mol.atoms[i]
    return (a.z << 2) | (2 if a.aromatic else 0) | (1 if a.in_ring else 0)


def path_bits(mol: Mol, min_path: int = 1, max_path: int = 7,
              n_bits: int = 2048, bits_per_hash: int = 2) -> Set[int]:
    """Enumerate simple bond paths of length min..max, hash canonical direction."""
    bits: Set[int] = set()
    seen_paths: Set[frozenset] = set()
    n = mol.num_atoms

    def dfs(path_bonds: List[int], path_atoms: List[int]) -> None:
        L = len(path_bonds)
        if L >= min_path:
            key = frozenset(path_bonds)
            if key not in seen_paths:
                seen_paths.add(key)
                h = _hash_path(mol, path_atoms, path_bonds)
                rng = h
                for _ in range(bits_per_hash):
                    rng = _mix(rng, 0x2545F4914F6CDD1D)
                    bits.add(rng % n_bits)
        if L == max_path:
            return
        last = path_atoms[-1]
        for bi in mol.neighbors[last]:
            if bi in path_bonds:
                continue
            j = mol.bonds[bi].other(last)
            if j in path_atoms:
                # allow ring closure as final step
                if j == path_atoms[0] and len(path_atoms) > 2:
                    pass
                else:
                    continue
            path_bonds.append(bi)
            path_atoms.append(j)
            dfs(path_bonds, path_atoms)
            path_bonds.pop()
            path_atoms.pop()

    for start in range(n):
        if mol.atoms[start].z <= 1:
            continue
        dfs([], [start])
    return bits


def _hash_path(mol: Mol, atoms: List[int], bonds: List[int]) -> int:
    def direction_hash(a_seq: List[int], b_seq: List[int]) -> int:
        h = 0x27d4eb2f165667c5
        for k, ai in enumerate(a_seq):
            h = _mix(h, _path_atom_code(mol, ai))
            if k < len(b_seq):
                h = _mix(h, _bond_code(mol.bonds[b_seq[k]].order))
        return h

    fwd = direction_hash(atoms, bonds)
    rev = direction_hash(atoms[::-1], bonds[::-1])
    return min(fwd, rev)


def path_fingerprint(mol: Mol, n_bits: int = 2048, min_path: int = 1,
                     max_path: int = 7, dtype=np.float32) -> np.ndarray:
    """RDKFingerprint equivalent (reference: create_descriptors.py:27-28)."""
    fp = np.zeros(n_bits, dtype=dtype)
    idx = list(path_bits(mol, min_path, max_path, n_bits))
    if idx:
        fp[np.asarray(idx, dtype=np.int64)] = 1
    return fp


# ---------------------------------------------------------------------------
# Atom-pair fingerprint (beyond-parity: topological-distance information
# orthogonal to circular/path fingerprints)
# ---------------------------------------------------------------------------

def _pair_atom_code(mol: Mol, i: int) -> int:
    """Carhart-style atom code: element, pi-participation, heavy degree."""
    a = mol.atoms[i]
    heavy_deg = min(sum(1 for j in mol.atom_neighbors(i) if mol.atoms[j].z > 1), 7)
    pi = 1 if a.aromatic or any(
        mol.bonds[bi].order in (BOND_DOUBLE, BOND_TRIPLE, BOND_AROMATIC)
        for bi in mol.neighbors[i]) else 0
    return (a.z << 4) | (pi << 3) | heavy_deg


def atom_pair_bits(mol: Mol, n_bits: int = 2048, max_dist: int = 30) -> Set[int]:
    from bbbp_tpu_torch.chem.depict import graph_distances

    n = mol.num_atoms
    if n < 2:
        return set()
    dist = graph_distances(mol)
    bits: Set[int] = set()
    codes = [_pair_atom_code(mol, i) for i in range(n)]
    for i in range(n):
        if mol.atoms[i].z <= 1:
            continue
        for j in range(i + 1, n):
            if mol.atoms[j].z <= 1:
                continue
            d = int(dist[i, j])
            if d <= 0 or d > max_dist:
                continue
            c1, c2 = sorted((codes[i], codes[j]))
            h = 0x6a09e667f3bcc909
            h = _mix(h, c1)
            h = _mix(h, d)
            h = _mix(h, c2)
            bits.add(h % n_bits)
    return bits


def atom_pair_fingerprint(mol: Mol, n_bits: int = 2048,
                          dtype=np.float32) -> np.ndarray:
    fp = np.zeros(n_bits, dtype=dtype)
    idx = list(atom_pair_bits(mol, n_bits))
    if idx:
        fp[np.asarray(idx, dtype=np.int64)] = 1
    return fp


# ---------------------------------------------------------------------------
# Avalon-style substructure-class fingerprint
# ---------------------------------------------------------------------------

def avalon_bits(mol: Mol, n_bits: int = 512) -> Set[int]:
    """Avalon-style fingerprint: hashed union of several substructure feature
    CLASSES, following the design of Gedeck's Avalon FP (augmented atoms,
    short paths, atom pairs, ring features). The reference's optional 4th
    fingerprint kind is pyAvalonTools.GetAvalonFP — None when uninstalled
    (reference: Descriptors/create_descriptors.py:26-31); this is a
    functional stand-in over the same feature classes, NOT a bit-exact port
    of the proprietary enumeration."""
    bits: Set[int] = set()

    def add(cls: int, h: int) -> None:
        bits.add(_mix(cls * 0x9E3779B1 + 1, h) % n_bits)

    # augmented atoms: atom invariant + sorted (bond code, neighbor invariant)
    inv = [_atom_invariant(mol, i) for i in range(len(mol.atoms))]
    for i in range(len(mol.atoms)):
        env = sorted(
            _mix(_bond_code(mol.bonds[b].order),
                 inv[mol.bonds[b].other(i)])
            for b in mol.neighbors[i])
        h = inv[i]
        for e in env:
            h = _mix(h, e)
        add(1, h)
    # short linear paths (the dominant Avalon class)
    for b in path_bits(mol, min_path=1, max_path=5, n_bits=1 << 30):
        add(2, b)
    # topological atom pairs at short range
    for b in atom_pair_bits(mol, n_bits=1 << 30, max_dist=7):
        add(3, b)
    # ring features: (size, n_aromatic_members, n_hetero_members) per ring
    for ring in mol.rings:
        n_arom = sum(1 for a in ring if mol.atoms[a].aromatic)
        n_het = sum(1 for a in ring if mol.atoms[a].symbol not in ("C", "H"))
        add(4, _mix(_mix(len(ring), n_arom), n_het))
    return bits


def avalon_fingerprint(mol: Mol, n_bits: int = 512,
                       dtype=np.float32) -> np.ndarray:
    fp = np.zeros(n_bits, dtype=dtype)
    idx = list(avalon_bits(mol, n_bits))
    if idx:
        fp[np.asarray(idx, dtype=np.int64)] = 1
    return fp


# ---------------------------------------------------------------------------
# MACCS-style 167-bit structural keys
# ---------------------------------------------------------------------------

def maccs_fingerprint(mol: Mol, dtype=np.float32) -> np.ndarray:
    """167-bit structural-key fingerprint in the spirit of MACCS keys
    (reference: create_descriptors.py:24-25). Key definitions are this
    framework's own graph predicates (the proprietary MACCS SMARTS are
    approximated); bit 0 unused like RDKit's.
    """
    from bbbp_tpu_torch.chem.structural_keys import compute_structural_keys

    return compute_structural_keys(mol).astype(dtype)
