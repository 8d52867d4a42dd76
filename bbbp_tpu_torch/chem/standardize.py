"""Structure standardization (D7 equivalent).

Reference: ``B3DB/cleaning/02_clean_smiles_chembl_way_20210215.py:43-335``
(class CleanMoleculesFromDataFrame over the chembl_structure_pipeline):
exclusion flags for restricted atoms, salt/solvent stripping, standardize,
neutralize charges. Re-implemented on this framework's own molecular graph:

- ``has_restricted_atoms``: metals / non-organic elements flag
- ``strip_salts``: keep the largest organic fragment (salt/solvent removal)
- ``neutralize``: protonate/deprotonate simple charged centers ([NH+]→N,
  [O-]→OH etc.) when that yields a valid neutral valence
- ``standardize_smiles``: the full pipeline → canonical SMILES
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from bbbp_tpu_torch.chem.mol import Mol, Atom, DEFAULT_VALENCES
from bbbp_tpu_torch.chem.smiles import MolFromSmiles
from bbbp_tpu_torch.chem.writer import MolToSmiles

# atoms allowed in 'organic' drug-like molecules (reference's allowed set is
# H,B,C,N,O,F,Si,P,S,Cl,Se,Br,I)
ALLOWED_Z = {1, 5, 6, 7, 8, 9, 14, 15, 16, 17, 34, 35, 53}


def has_restricted_atoms(mol: Mol) -> bool:
    return any(a.z not in ALLOWED_Z and a.z != 0 for a in mol.atoms)


def _fragments(mol: Mol) -> List[List[int]]:
    n = mol.num_atoms
    seen = [False] * n
    frags = []
    for s in range(n):
        if seen[s]:
            continue
        comp = []
        stack = [s]
        seen[s] = True
        while stack:
            u = stack.pop()
            comp.append(u)
            for v in mol.atom_neighbors(u):
                if not seen[v]:
                    seen[v] = True
                    stack.append(v)
        frags.append(comp)
    return frags


def _extract_fragment(mol: Mol, atoms: List[int]) -> Mol:
    remap = {a: i for i, a in enumerate(atoms)}
    out = Mol()
    import copy as _copy

    for a in atoms:
        na = _copy.copy(mol.atoms[a])
        na.idx = remap[a]
        out.atoms.append(na)
        out.neighbors.append([])
    atom_set = set(atoms)
    for b in mol.bonds:
        if b.a1 in atom_set and b.a2 in atom_set:
            out.add_bond(remap[b.a1], remap[b.a2], b.order, b.stereo)
    out._perceive_rings()
    return out


def strip_salts(mol: Mol) -> Mol:
    """Keep the largest fragment by heavy-atom count, preferring carbon-
    containing (organic) fragments — salt/solvent stripping."""
    frags = _fragments(mol)
    if len(frags) <= 1:
        return mol

    def score(comp):
        heavy = sum(1 for i in comp if mol.atoms[i].z > 1)
        has_c = any(mol.atoms[i].z == 6 for i in comp)
        return (int(has_c), heavy)

    best = max(frags, key=score)
    return _extract_fragment(mol, best)


def neutralize(mol: Mol) -> Mol:
    """Neutralize simple charge centers in place (graph copy):
    cation with H (e.g. [NH3+]) → remove charge and one H;
    anion on O/S/N (e.g. [O-]) → remove charge, add one H.
    Quaternary cations and stabilized systems are left unchanged."""
    import copy as _copy

    out = Mol()
    for a in mol.atoms:
        out.atoms.append(_copy.copy(a))
        out.neighbors.append(list(mol.neighbors[a.idx]))
    out.bonds = [_copy.copy(b) for b in mol.bonds]
    out.rings = [list(r) for r in mol.rings]
    for a in out.atoms:
        if a.charge > 0 and a.n_h > 0:
            a.charge -= 1
            a.n_h -= 1
        elif a.charge < 0 and a.z in (7, 8, 16):
            a.charge += 1
            a.n_h = max(a.n_h, 0) + 1
    return out


def standardize_smiles(smiles: str, neutralize_charges: bool = True
                       ) -> Optional[str]:
    """Full pipeline: parse → restricted-atom check → strip salts →
    neutralize → canonical SMILES. Returns None for unparseable or
    restricted molecules (the reference's exclusion-flag semantics)."""
    mol = MolFromSmiles(smiles)
    if mol is None:
        return None
    mol = strip_salts(mol)           # counter-ions removed before the
    if has_restricted_atoms(mol):    # restricted check (parent judged alone)
        return None
    if neutralize_charges:
        mol = neutralize(mol)
    return MolToSmiles(mol)
