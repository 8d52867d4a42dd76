"""B3DB-style dataset curation: PubChem resolution, combining, label
reconciliation (components D4-D6, D8-D10); the counterpart of
``bbbp_tpu/data/curation.py`` without pandas.

Reference scripts re-implemented:
- D4/D6/D8 ``B3DB/preprocessing/preprocessing.py:13-160``,
  ``B3DB/cleaning/01_combine_clean_rest_api_v4.py``, ``03_update_CID.py`` —
  PubChem REST lookups (name→CID/SMILES, CID→SMILES, SMILES→CID). The client
  is constructed and testable offline and performs I/O only when the network
  exists (without one, every lookup returns None).
- D5 ``B3DB/preprocessing/combine_clean.py:22-73`` — merge per-reference
  tables, drop missing SMILES, canonical-SMILES identity (the reference uses
  InChI; no InChI generator exists without RDKit — canonical SMILES from
  chem.writer plays that role), split regression/classification.
- D9 ``B3DB/grouping/regression_grouping.py:13-180`` — merge multi-source
  logBB per molecule: tolerance/mode rules, quality groups A-D, drop
  irreconcilable ranges.
- D10 ``B3DB/grouping/classification_grouping.py:24-158`` — label voting.

A table is a list of rows, each a dict from column name to value (what
``csv.DictReader`` gives). A missing cell is an absent key, ``None`` or a
float NaN, as pandas' ``dropna`` treats NaN and None. The functions return
what the JAX package's pandas versions return, as rows: the same columns in
the same order (an output row holds every column of the result, ``None``
where pandas has NaN), the same rows in the same order, groups in sorted
key order as ``groupby`` gives them, and numbers parsed as
``pd.to_numeric(errors="coerce")`` parses them.
"""

from __future__ import annotations

import json
import math
import urllib.parse
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bbbp_tpu_torch.chem.smiles import MolFromSmiles
from bbbp_tpu_torch.chem.writer import MolToSmiles

Row = Dict[str, object]


def _missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _numeric(v) -> Optional[float]:
    """``pd.to_numeric(v, errors="coerce")`` of one cell: a number, or None
    for a missing or non-numeric cell (NaN included)."""
    if _missing(v):
        return None
    if isinstance(v, str):
        if "_" in v:                      # Python's float reads 1_000; pandas not
            return None
        try:
            v = float(v)
        except ValueError:
            return None
    try:
        v = float(v)
    except (TypeError, ValueError):
        return None
    return None if math.isnan(v) else v


def _columns(rows: Sequence[Row]) -> List[str]:
    """Every column of ``rows``, in order of first appearance."""
    seen: Dict[str, None] = {}
    for r in rows:
        seen.update(dict.fromkeys(r))
    return list(seen)


def _complete(rows: Sequence[Row], columns: Sequence[str]) -> List[Row]:
    return [{c: (None if _missing(r.get(c)) else r[c]) for c in columns}
            for r in rows]


# ---------------------------------------------------------------------------
# D4/D6/D8 — PubChem REST client (zero-egress gated)
# ---------------------------------------------------------------------------

PUBCHEM_BASE = "https://pubchem.ncbi.nlm.nih.gov/rest/pug"


class PubChemClient:
    """name→CID/SMILES, CID→SMILES, SMILES→CID lookups via PUG REST."""

    def __init__(self, timeout: float = 10.0):
        self.timeout = timeout

    # URL builders (pure; unit-testable offline)
    def url_name_to_cid(self, name: str) -> str:
        return (f"{PUBCHEM_BASE}/compound/name/"
                f"{urllib.parse.quote(name)}/cids/JSON")

    def url_cid_to_smiles(self, cid: int) -> str:
        return (f"{PUBCHEM_BASE}/compound/cid/{int(cid)}/property/"
                f"IsomericSMILES,CanonicalSMILES/JSON")

    def url_smiles_to_cid(self, smiles: str) -> str:
        return (f"{PUBCHEM_BASE}/compound/smiles/"
                f"{urllib.parse.quote(smiles)}/cids/JSON")

    def _get(self, url: str) -> Optional[dict]:
        import urllib.request

        try:
            with urllib.request.urlopen(url, timeout=self.timeout) as r:
                return json.loads(r.read().decode())
        except Exception:
            return None

    def name_to_cid(self, name: str) -> Optional[int]:
        d = self._get(self.url_name_to_cid(name))
        try:
            return int(d["IdentifierList"]["CID"][0])
        except Exception:
            return None

    def cid_to_smiles(self, cid: int) -> Optional[str]:
        d = self._get(self.url_cid_to_smiles(cid))
        try:
            p = d["PropertyTable"]["Properties"][0]
            return p.get("IsomericSMILES") or p.get("CanonicalSMILES")
        except Exception:
            return None

    def smiles_to_cid(self, smiles: str) -> Optional[int]:
        d = self._get(self.url_smiles_to_cid(smiles))
        try:
            return int(d["IdentifierList"]["CID"][0])
        except Exception:
            return None


# ---------------------------------------------------------------------------
# D5 — combining per-reference tables
# ---------------------------------------------------------------------------

def canonical_key(smiles: str) -> Optional[str]:
    """Molecule identity key (canonical SMILES; the reference's InChI role)."""
    mol = MolFromSmiles(smiles)
    return MolToSmiles(mol) if mol is not None else None


def combine_tables(tables: Sequence[Sequence[Row]],
                   smiles_col: str = "SMILES") -> List[Row]:
    """Concatenate source tables, drop rows without parseable SMILES, attach
    canonical identity + source index (reference combine_excels + remove_nan
    + update_inchi, combine_clean.py:22-60)."""
    columns: List[str] = []
    rows: List[Row] = []
    for si, t in enumerate(tables):
        for c in _columns(t) + ["source"]:
            if c not in columns:
                columns.append(c)
        rows += [{**r, "source": si} for r in t]
    out = []
    for r in _complete(rows, columns):
        if r[smiles_col] is None:
            continue
        key = canonical_key(str(r[smiles_col]))
        if key is not None:
            out.append({**r, "canonical_smiles": key})
    return out


def split_regression_classification(rows: Sequence[Row],
                                    logbb_col: str = "logBB",
                                    label_col: str = "BBB+/BBB-"
                                    ) -> Tuple[List[Row], List[Row]]:
    """Rows with numeric logBB → regression; rows with only labels →
    classification (reference combine_clean.py:61-73)."""
    rows = _complete(rows, _columns(rows))
    reg = [r for r in rows if _numeric(r.get(logbb_col)) is not None]
    cls = [r for r in rows if _numeric(r.get(logbb_col)) is None
           and not _missing(r.get(label_col))]
    return reg, cls


def _groups(rows: Sequence[Row], key_col: str) -> List[Tuple[object, List[Row]]]:
    """``groupby(key_col)``: rows by key, keys sorted, missing keys dropped."""
    groups: Dict[object, List[Row]] = {}
    for r in rows:
        key = r.get(key_col)
        if not _missing(key):
            groups.setdefault(key, []).append(r)
    return sorted(groups.items(), key=lambda kv: kv[0])


# ---------------------------------------------------------------------------
# D9 — regression label reconciliation
# ---------------------------------------------------------------------------

def reconcile_regression_labels(rows: Sequence[Row],
                                key_col: str = "canonical_smiles",
                                value_col: str = "logBB",
                                tolerance: float = 0.3,
                                max_range: float = 1.0) -> List[Row]:
    """Merge multi-source logBB per molecule with the reference's rules
    (regression_grouping.py:160-180):

    - single source → group A
    - all values within ``tolerance`` → mean, group B
    - range ≤ ``max_range`` → median, group C
    - range > ``max_range`` → dropped (group D, irreconcilable)
    """
    out = []
    for key, grp in _groups(rows, key_col):
        vals = np.array([v for v in (_numeric(r.get(value_col)) for r in grp)
                         if v is not None], dtype=np.float64)
        if len(vals) == 0:
            continue
        if len(vals) == 1:
            out.append((key, float(vals[0]), "A", len(vals)))
            continue
        rng = float(vals.max() - vals.min())
        if rng <= tolerance:
            out.append((key, float(vals.mean()), "B", len(vals)))
        elif rng <= max_range:
            out.append((key, float(np.median(vals)), "C", len(vals)))
        # else: dropped
    return [dict(zip((key_col, value_col, "group", "n_sources"), r)) for r in out]


# ---------------------------------------------------------------------------
# D10 — classification label reconciliation (voting)
# ---------------------------------------------------------------------------

def reconcile_classification_labels(rows: Sequence[Row],
                                    key_col: str = "canonical_smiles",
                                    label_col: str = "BBB+/BBB-"
                                    ) -> List[Row]:
    """Majority vote per molecule; unanimous → group A, majority → B,
    ties dropped (classification_grouping.py:24-158 voting loop)."""
    out = []
    for key, grp in _groups(rows, key_col):
        labels = [str(r[label_col]).strip() for r in grp
                  if not _missing(r.get(label_col))]
        pos = labels.count("BBB+")
        neg = labels.count("BBB-")
        total = pos + neg
        if total == 0 or pos == neg:
            continue
        label = "BBB+" if pos > neg else "BBB-"
        group = "A" if (pos == 0 or neg == 0) else "B"
        out.append((key, label, group, total))
    return [dict(zip((key_col, label_col, "group", "n_sources"), r)) for r in out]
