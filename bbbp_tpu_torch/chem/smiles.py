"""SMILES parser (OpenSMILES subset) built from scratch — no RDKit in image.

Replaces the reference's ``Chem.MolFromSmiles`` calls
(reference: Descriptors/create_descriptors.py:20, Descriptors/convert_smiles_2_img.py:21).
Supports: organic subset + bracket atoms (isotope, chirality @/@@ (+TH/AL/SP forms),
H count, charge, atom map), single/double/triple/quadruple/aromatic bonds,
cis-trans markers (/ \\), branches, ring closures (digit and %nn), dots
(disconnected fragments), and wildcards. Aromatic lowercase atoms: b c n o p s
and bracketed se/as/te.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from bbbp_tpu_torch.chem.mol import (
    Atom,
    Mol,
    SYMBOL_TO_Z,
    BOND_SINGLE,
    BOND_DOUBLE,
    BOND_TRIPLE,
    BOND_QUAD,
    BOND_AROMATIC,
)


class SmilesParseError(ValueError):
    pass


_ORGANIC_TWO = ("Cl", "Br")
_ORGANIC_ONE = set("BCNOPSFI")
_AROMATIC_ORGANIC = set("bcnops")
_AROMATIC_BRACKET = {"b", "c", "n", "o", "p", "s", "se", "as", "te", "si"}
_BOND_CODES = {
    "-": BOND_SINGLE,
    "=": BOND_DOUBLE,
    "#": BOND_TRIPLE,
    "$": BOND_QUAD,
    ":": BOND_AROMATIC,
}


def MolFromSmiles(smiles: str, sanitize: bool = True) -> Optional[Mol]:
    """Parse SMILES → finalized Mol. Returns None on failure (RDKit-style)."""
    try:
        return _parse(smiles, sanitize)
    except SmilesParseError:
        return None
    except (IndexError, KeyError, ValueError):
        return None


def mol_from_smiles_strict(smiles: str, sanitize: bool = True) -> Mol:
    """Like MolFromSmiles but raises SmilesParseError with a message."""
    try:
        return _parse(smiles, sanitize)
    except SmilesParseError:
        raise
    except (IndexError, KeyError, ValueError) as e:
        raise SmilesParseError(f"{smiles!r}: {e}") from e


def _parse(smiles: str, sanitize: bool) -> Mol:
    if not smiles or not smiles.strip():
        raise SmilesParseError("empty SMILES")
    s = smiles.strip()
    mol = Mol()
    prev_atom: int = -1
    pending_bond: Optional[int] = None   # explicit bond code for next bond
    pending_stereo: int = 0
    stack: List[Tuple[int, Optional[int], int]] = []
    # ring-closure table: number -> (atom idx, bond code or None, stereo)
    ring_open: dict = {}
    i, n = 0, len(s)

    def make_bond(a1: int, a2: int, code: Optional[int], stereo: int) -> None:
        if code is None:
            if mol.atoms[a1].aromatic and mol.atoms[a2].aromatic:
                code = BOND_AROMATIC
            else:
                code = BOND_SINGLE
        mol.add_bond(a1, a2, code, stereo)

    while i < n:
        c = s[i]
        if c == "(":
            if prev_atom < 0:
                raise SmilesParseError("branch before any atom")
            stack.append((prev_atom, pending_bond, pending_stereo))
            pending_bond, pending_stereo = None, 0
            i += 1
        elif c == ")":
            if not stack:
                raise SmilesParseError("unmatched ')'")
            prev_atom, pending_bond, pending_stereo = stack.pop()
            pending_bond, pending_stereo = None, 0
            i += 1
        elif c in _BOND_CODES:
            pending_bond = _BOND_CODES[c]
            i += 1
        elif c == "/":
            pending_bond = BOND_SINGLE
            pending_stereo = 1
            i += 1
        elif c == "\\":
            pending_bond = BOND_SINGLE
            pending_stereo = 2
            i += 1
        elif c == ".":
            prev_atom = -1
            pending_bond, pending_stereo = None, 0
            i += 1
        elif c.isdigit() or c == "%":
            if prev_atom < 0:
                raise SmilesParseError("ring closure before any atom")
            if c == "%":
                if i + 2 >= n or not (s[i + 1].isdigit() and s[i + 2].isdigit()):
                    raise SmilesParseError("bad %nn ring closure")
                num = int(s[i + 1 : i + 3])
                i += 3
            else:
                num = int(c)
                i += 1
            if num in ring_open:
                open_atom, open_code, open_stereo = ring_open.pop(num)
                code = pending_bond if pending_bond is not None else open_code
                stereo = pending_stereo or open_stereo
                if open_atom == prev_atom:
                    raise SmilesParseError("ring closure to self")
                make_bond(open_atom, prev_atom, code, stereo)
            else:
                ring_open[num] = (prev_atom, pending_bond, pending_stereo)
            pending_bond, pending_stereo = None, 0
        elif c == "[":
            j = s.find("]", i)
            if j < 0:
                raise SmilesParseError("unclosed bracket atom")
            atom = _parse_bracket(s[i + 1 : j])
            idx = mol.add_atom(atom)
            if prev_atom >= 0:
                make_bond(prev_atom, idx, pending_bond, pending_stereo)
            prev_atom = idx
            pending_bond, pending_stereo = None, 0
            i = j + 1
        else:
            sym, aromatic, adv = _read_organic_symbol(s, i)
            atom = Atom(z=SYMBOL_TO_Z[sym], aromatic=aromatic)
            idx = mol.add_atom(atom)
            if prev_atom >= 0:
                make_bond(prev_atom, idx, pending_bond, pending_stereo)
            prev_atom = idx
            pending_bond, pending_stereo = None, 0
            i += adv

    if stack:
        raise SmilesParseError("unmatched '('")
    if ring_open:
        raise SmilesParseError(f"unclosed ring bonds: {sorted(ring_open)}")
    if mol.num_atoms == 0:
        raise SmilesParseError("no atoms")
    if sanitize:
        mol.finalize()
    return mol


def _read_organic_symbol(s: str, i: int) -> Tuple[str, bool, int]:
    two = s[i : i + 2]
    if two in _ORGANIC_TWO:
        return two, False, 2
    c = s[i]
    if c in _ORGANIC_ONE:
        return c, False, 1
    if c in _AROMATIC_ORGANIC:
        return c.upper(), True, 1
    if c == "*":
        return "*", False, 1
    raise SmilesParseError(f"unexpected character {c!r} at {i}")


def _parse_bracket(body: str) -> Atom:
    """Parse bracket-atom body: isotope? symbol chiral? hcount? charge? map?"""
    if not body:
        raise SmilesParseError("empty bracket atom")
    k, m = 0, len(body)
    isotope = 0
    while k < m and body[k].isdigit():
        isotope = isotope * 10 + int(body[k])
        k += 1
    # element symbol: try two-letter (incl. aromatic two-letter), then one.
    aromatic = False
    sym = None
    if k + 1 < m:
        two = body[k : k + 2]
        if two in _AROMATIC_BRACKET:
            sym, aromatic = two.capitalize(), True
        elif two[0].isupper() and two[1].islower() and two in SYMBOL_TO_Z:
            sym = two
    if sym is None:
        one = body[k : k + 1]
        if one in _AROMATIC_BRACKET:
            sym, aromatic = one.upper(), True
        elif one in SYMBOL_TO_Z:
            sym = one
        elif one == "*":
            sym = "*"
        else:
            raise SmilesParseError(f"unknown element in bracket: {body!r}")
    k += len(sym) if sym != "*" else 1
    atom = Atom(z=SYMBOL_TO_Z[sym], aromatic=aromatic, isotope=isotope)
    atom.n_h = 0
    atom.explicit_h = True
    while k < m:
        c = body[k]
        if c == "@":
            if body[k : k + 2] == "@@":
                atom.chirality = 2
                k += 2
            else:
                atom.chirality = 1
                k += 1
                # named chirality classes: @TH1 @AL1 @SP1 @TB1 @OH1 ...
                for tag in ("TH", "AL", "SP", "TB", "OH"):
                    if body[k : k + 2] == tag:
                        k += 2
                        while k < m and body[k].isdigit():
                            k += 1
                        break
        elif c == "H":
            k += 1
            h = 1
            if k < m and body[k].isdigit():
                h = 0
                while k < m and body[k].isdigit():
                    h = h * 10 + int(body[k])
                    k += 1
            atom.n_h = h
        elif c in "+-":
            sign = 1 if c == "+" else -1
            k += 1
            if k < m and body[k].isdigit():
                mag = 0
                while k < m and body[k].isdigit():
                    mag = mag * 10 + int(body[k])
                    k += 1
            else:
                mag = 1
                while k < m and body[k] == c:
                    mag += 1
                    k += 1
            atom.charge = sign * mag
        elif c == ":":
            k += 1
            mp = 0
            while k < m and body[k].isdigit():
                mp = mp * 10 + int(body[k])
                k += 1
            atom.atom_map = mp
        else:
            raise SmilesParseError(f"unexpected {c!r} in bracket atom {body!r}")
    return atom
