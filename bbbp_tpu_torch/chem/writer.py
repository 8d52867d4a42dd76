"""SMILES writer with canonical atom ranking.

Counterpart of the parser (no RDKit in image): Morgan-style iterative
invariant refinement produces canonical ranks; DFS emission in rank order
yields a canonical-form SMILES usable for deduplication — the role InChI plays
in the reference's curation (B3DB/grouping/regression_grouping.py:13 dedupes
by InChI; this framework dedupes by canonical SMILES, documented difference).
Stereochemistry markers are not emitted (parity with fingerprinting, which is
stereo-agnostic like ECFP defaults).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from bbbp_tpu_torch.chem.mol import (
    Mol,
    Z_TO_SYMBOL,
    DEFAULT_VALENCES,
    BOND_SINGLE,
    BOND_DOUBLE,
    BOND_TRIPLE,
    BOND_QUAD,
    BOND_AROMATIC,
)

_ORGANIC = {5, 6, 7, 8, 15, 16, 9, 17, 35, 53}
_BOND_SYM = {BOND_SINGLE: "", BOND_DOUBLE: "=", BOND_TRIPLE: "#",
             BOND_QUAD: "$", BOND_AROMATIC: ""}


def canonical_ranks(mol: Mol) -> List[int]:
    """Iterative refinement canonical ranks (lower = earlier in output)."""
    n = mol.num_atoms

    # deep Morgan hashes as initial keys: atoms tied after full-diameter
    # refinement are (near-certainly) true symmetry orbits, so the index
    # tie-break below yields the same string from any input atom order
    from bbbp_tpu_torch.chem.fingerprints import _atom_invariant, _mix, _bond_code

    inv = [_atom_invariant(mol, i) for i in range(n)]
    for _ in range(n):
        new_inv = []
        for i in range(n):
            nbrs = sorted(
                (_bond_code(mol.bonds[bi].order), inv[mol.bonds[bi].other(i)])
                for bi in mol.neighbors[i]
            )
            h = inv[i]
            for code, nh in nbrs:
                h = _mix(h, code)
                h = _mix(h, nh)
            new_inv.append(h)
        if len(set(new_inv)) == len(set(inv)) and new_inv == inv:
            break
        stable = len(set(new_inv)) == len(set(inv))
        inv = new_inv
        if stable:
            break
    keys = list(inv)
    ranks = _keys_to_ranks(keys)
    for _ in range(n):
        new_keys = []
        for i in range(n):
            nbr = sorted(
                (ranks[mol.bonds[bi].other(i)], mol.bonds[bi].order)
                for bi in mol.neighbors[i]
            )
            new_keys.append((ranks[i], tuple(nbr)))
        new_ranks = _keys_to_ranks(new_keys)
        if new_ranks == ranks:
            break
        ranks = new_ranks
    # break remaining ties deterministically
    while len(set(ranks)) < n:
        seen: Dict[int, List[int]] = {}
        for i, r in enumerate(ranks):
            seen.setdefault(r, []).append(i)
        tied = next(v for v in seen.values() if len(v) > 1)
        chosen = min(tied)
        keys2 = [(ranks[i], 0 if i == chosen else 1) for i in range(n)]
        ranks = _keys_to_ranks(keys2)
        for _ in range(n):
            new_keys = []
            for i in range(n):
                nbr = sorted(
                    (ranks[mol.bonds[bi].other(i)], mol.bonds[bi].order)
                    for bi in mol.neighbors[i]
                )
                new_keys.append((ranks[i], tuple(nbr)))
            new_ranks = _keys_to_ranks(new_keys)
            if new_ranks == ranks:
                break
            ranks = new_ranks
    return ranks


def _keys_to_ranks(keys) -> List[int]:
    order = sorted(set(keys))
    lookup = {k: i for i, k in enumerate(order)}
    return [lookup[k] for k in keys]


def _needs_bracket(mol: Mol, i: int) -> bool:
    a = mol.atoms[i]
    if a.z not in _ORGANIC or a.charge != 0 or a.isotope:
        return True
    # implicit-H inference must reproduce the actual H count
    valences = DEFAULT_VALENCES.get(a.z)
    if valences is None:
        return True
    order_sum = 0.0
    for bi in mol.neighbors[i]:
        order_sum += mol.bonds[bi].order_value
    import math

    used = math.ceil(order_sum - 1e-9)
    nh_implied = 0
    for v in valences:
        if v >= used:
            nh_implied = v - used
            break
    # compare against IMPLICIT H only: explicit [H] neighbors are emitted as
    # their own atoms (their bond is already inside order_sum)
    return nh_implied != max(mol.atoms[i].n_h, 0)


def _atom_token(mol: Mol, i: int) -> str:
    a = mol.atoms[i]
    sym = Z_TO_SYMBOL.get(a.z, "*")
    if a.aromatic and a.z in (5, 6, 7, 8, 15, 16, 34):
        sym_out = sym.lower()
    else:
        sym_out = sym
    if not _needs_bracket(mol, i):
        return sym_out
    h = max(a.n_h, 0)   # implicit only; explicit [H] neighbors are own atoms
    htxt = "" if h == 0 else ("H" if h == 1 else f"H{h}")
    if a.charge == 0:
        ctxt = ""
    elif a.charge == 1:
        ctxt = "+"
    elif a.charge == -1:
        ctxt = "-"
    else:
        ctxt = f"{'+' if a.charge > 0 else '-'}{abs(a.charge)}"
    iso = str(a.isotope) if a.isotope else ""
    return f"[{iso}{sym_out}{htxt}{ctxt}]"


def _kekule_copy(mol: Mol, kmap: Dict[int, int]) -> Mol:
    """Clone with aromatic bonds replaced by the kekulé assignment and
    aromatic flags cleared (for uppercase emission)."""
    import copy as _copy

    out = Mol()
    for a in mol.atoms:
        na = _copy.copy(a)
        na.aromatic = False
        out.atoms.append(na)
        out.neighbors.append(list(mol.neighbors[a.idx]))
    for b in mol.bonds:
        nb = _copy.copy(b)
        if nb.idx in kmap:
            nb.order = kmap[nb.idx]
        out.bonds.append(nb)
    return out


def MolToSmiles(mol: Mol, canonical: bool = True, kekule: bool = True) -> str:
    """Emit SMILES; canonical ranks order the traversal by default.

    Kekulé emission (default) keeps write→parse on the single deterministic
    aromaticity-perception path, making canonical forms stable; falls back to
    aromatic-lowercase emission when no kekulé assignment exists."""
    n = mol.num_atoms
    if n == 0:
        return ""
    ranks = canonical_ranks(mol) if canonical else list(range(n))
    if kekule:
        from bbbp_tpu_torch.chem.kekulize import kekulize

        kmap = kekulize(mol, ranks)
        if kmap is not None:
            if kmap:
                mol = _kekule_copy(mol, kmap)
        # None → unmatched aromatic system; emit aromatic form as fallback
    visited: Set[int] = set()
    # ring-closure bookkeeping: bond idx -> digit
    closure_digit: Dict[int, int] = {}
    next_digit = [1]
    ring_bonds: Set[int] = set()

    # find ring-closure bonds via DFS spanning tree per fragment
    parent_bond: Dict[int, int] = {}

    def assign_ring_bonds(start: int) -> None:
        stack = [(start, -1)]
        seen = {start}
        while stack:
            u, pbond = stack.pop()
            nbrs = sorted(mol.neighbors[u],
                          key=lambda bi: ranks[mol.bonds[bi].other(u)])
            for bi in nbrs:
                if bi == pbond:
                    continue
                v = mol.bonds[bi].other(u)
                if v in seen:
                    if bi not in ring_bonds and bi not in parent_bond.values():
                        ring_bonds.add(bi)
                else:
                    seen.add(v)
                    parent_bond[v] = bi
                    stack.append((v, bi))

    def emit(u: int, pbond: int) -> str:
        visited.add(u)
        parts = [_atom_token(mol, u)]
        # ring closures at this atom, ordered by the partner's canonical rank
        # (bond indices are input-order dependent and would break canonicality)
        for bi in sorted((b for b in mol.neighbors[u] if b in ring_bonds),
                         key=lambda bi: ranks[mol.bonds[bi].other(u)]):
            if True:
                b = mol.bonds[bi]
                if b.order == BOND_AROMATIC:
                    sym = ""
                elif (b.order == BOND_SINGLE and mol.atoms[b.a1].aromatic
                      and mol.atoms[b.a2].aromatic):
                    sym = "-"   # else re-parse would default it to aromatic
                else:
                    sym = _BOND_SYM[b.order]
                if bi not in closure_digit:
                    closure_digit[bi] = next_digit[0]
                    next_digit[0] += 1
                d = closure_digit[bi]
                dtxt = str(d) if d < 10 else f"%{d:02d}"
                parts.append(sym + dtxt)
        children = []
        for bi in sorted(mol.neighbors[u],
                         key=lambda bi: ranks[mol.bonds[bi].other(u)]):
            if bi == pbond or bi in ring_bonds:
                continue
            v = mol.bonds[bi].other(u)
            if v in visited:
                continue
            b = mol.bonds[bi]
            if b.order == BOND_AROMATIC:
                sym = ""
            elif (b.order == BOND_SINGLE and mol.atoms[u].aromatic
                  and mol.atoms[v].aromatic):
                sym = "-"   # explicit single between two aromatic atoms
            else:
                sym = _BOND_SYM[b.order]
            children.append(sym + emit(v, bi))
        if children:
            for c in children[:-1]:
                parts.append(f"({c})")
            parts.append(children[-1])
        return "".join(parts)

    fragments = []
    starts = sorted(range(n), key=lambda i: ranks[i])
    for s in starts:
        if s in visited:
            continue
        assign_ring_bonds(s)
        fragments.append(emit(s, -1))
    return ".".join(fragments)
