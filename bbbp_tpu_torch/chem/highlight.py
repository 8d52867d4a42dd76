"""Fingerprint-highlight depiction (F5): draw a molecule three ways with the
atoms that drive each fingerprint colored. A copy of
``bbbp_tpu/chem/highlight.py`` over the port's ``chem/``; only the imports
differ. ``save_fingerprint_highlights`` imports PIL when it is called.

Reference: ``Descriptors/draw_fingerprints_morgan.py:14-70`` — one molecule
rendered 3× with Morgan-bit atom environments in blue, MACCS SMARTS hits in
green, ring/path hits in red via rdMolDraw2D.

Here the highlight sets come from this framework's own fingerprint internals:
Morgan environments (atom + bond radius sets), structural-key predicate
support atoms (ring atoms / heteroatoms / matched motif centers), and path-
fingerprint atom paths; rendering reuses chem.depict with per-atom halo
colors.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from bbbp_tpu_torch.chem.depict import compute_coords, rasterize
from bbbp_tpu_torch.chem.fingerprints import morgan_environments
from bbbp_tpu_torch.chem.mol import Mol
from bbbp_tpu_torch.chem.smiles import MolFromSmiles

BLUE = (0.3, 0.5, 1.0)
GREEN = (0.2, 0.85, 0.3)
RED = (1.0, 0.35, 0.3)


def morgan_highlight_atoms(mol: Mol, radius: int = 2) -> Set[int]:
    """Atoms participating in any radius>=1 Morgan environment (i.e. centers
    of multi-atom circular substructures)."""
    out: Set[int] = set()
    envs = morgan_environments(mol, radius)
    for h, r, bset in envs:
        if r >= 1 and bset:
            for bi in bset:
                b = mol.bonds[bi]
                out.add(b.a1)
                out.add(b.a2)
    return out


def structural_key_atoms(mol: Mol) -> Set[int]:
    """Atoms that drive structural keys: heteroatoms, charged atoms, and
    double/triple-bond termini (the motif centers of chem.structural_keys)."""
    out: Set[int] = set()
    for a in mol.atoms:
        if a.z not in (1, 6) or a.charge != 0:
            out.add(a.idx)
    from bbbp_tpu_torch.chem.mol import BOND_DOUBLE, BOND_TRIPLE

    for b in mol.bonds:
        if b.order in (BOND_DOUBLE, BOND_TRIPLE):
            out.add(b.a1)
            out.add(b.a2)
    return out


def ring_atoms(mol: Mol) -> Set[int]:
    return {a.idx for a in mol.atoms if a.in_ring}


def _overlay_halos(img: np.ndarray, pix: np.ndarray, atoms: Set[int],
                   color: Tuple[float, float, float], radius: float = 6.0
                   ) -> np.ndarray:
    size = img.shape[0]
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    col = np.asarray(color, np.float32)
    for i in atoms:
        dist = np.sqrt((xx - pix[i][0]) ** 2 + (yy - pix[i][1]) ** 2)
        alpha = np.clip(radius + 0.5 - dist, 0.0, 1.0) * 0.45
        img = img * (1 - alpha[..., None]) + col * alpha[..., None]
    return img


def draw_fingerprint_highlights(smiles: str, size: int = 256
                                ) -> Optional[Dict[str, np.ndarray]]:
    """Three renderings: morgan (blue), structural keys (green), rings (red).
    Returns dict of [size,size,3] arrays, or None on parse failure."""
    mol = MolFromSmiles(smiles)
    if mol is None:
        return None
    coords = compute_coords(mol)
    lo = coords.min(0)
    hi = coords.max(0)
    span = max((hi - lo).max(), 1e-6)
    pad = 0.08
    scale = size * (1 - 2 * pad) / span
    offset = (size - scale * (hi - lo)) / 2.0
    pix = (coords - lo) * scale + offset

    out = {}
    for name, atoms, color in (
        ("morgan", morgan_highlight_atoms(mol), BLUE),
        ("structural", structural_key_atoms(mol), GREEN),
        ("rings", ring_atoms(mol), RED),
    ):
        base = rasterize(mol, coords, size=size)
        out[name] = _overlay_halos(base, pix, atoms, color)
    return out


def save_fingerprint_highlights(smiles: str, out_prefix: str,
                                size: int = 256) -> List[str]:
    from PIL import Image

    imgs = draw_fingerprint_highlights(smiles, size)
    if imgs is None:
        raise ValueError(f"unparseable SMILES: {smiles!r}")
    paths = []
    for name, arr in imgs.items():
        p = f"{out_prefix}_{name}.png"
        Image.fromarray((arr * 255).astype(np.uint8)).save(p)
        paths.append(p)
    return paths
