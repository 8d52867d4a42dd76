"""The port's curation (``bbbp_tpu_torch/data/curation.py``, rows of dicts)
against the JAX package's pandas versions, on tables with duplicates,
missing and non-numeric cells, ties and a group-D range. The results are
equal: the same rows, columns and order, pandas' NaN read as None, the
numbers bit-equal (float64 means and medians in the same order)."""

import math

import numpy as np
import pytest

pd = pytest.importorskip("pandas")

from bbbp_tpu.data import curation as jc  # noqa: E402
from bbbp_tpu_torch.data import curation as tc  # noqa: E402

NAN = float("nan")

# three sources; benzene and ethanol in several spellings, a missing SMILES,
# an unparseable one, non-numeric and missing logBB cells, label ties
T0 = [
    {"SMILES": "c1ccccc1", "logBB": 0.10, "BBB+/BBB-": "BBB+"},
    {"SMILES": "CCO", "logBB": "-0.2", "BBB+/BBB-": "BBB+"},
    {"SMILES": None, "logBB": 0.5, "BBB+/BBB-": "BBB-"},
    {"SMILES": "C1CC", "logBB": 0.3, "BBB+/BBB-": "BBB+"},
    {"SMILES": "CCN", "logBB": "n/a", "BBB+/BBB-": " BBB- "},
    {"SMILES": "CC(=O)O", "logBB": NAN, "BBB+/BBB-": "BBB+"},
]
T1 = [
    {"SMILES": "C1=CC=CC=C1", "logBB": 0.30, "BBB+/BBB-": "BBB+", "ref": "b"},
    {"SMILES": "OCC", "logBB": "1e-1", "BBB+/BBB-": "BBB-", "ref": "b"},
    {"SMILES": "CCN", "logBB": None, "BBB+/BBB-": "BBB+", "ref": "b"},
    {"SMILES": "CC(=O)O", "logBB": "", "BBB+/BBB-": NAN, "ref": "b"},
    {"SMILES": "CCCl", "logBB": 1.2, "BBB+/BBB-": "BBB+", "ref": "b"},
    {"SMILES": "CCCCO", "logBB": -1.0, "BBB+/BBB-": "BBB-", "ref": "b"},
]
T2 = [
    {"SMILES": "c1ccccc1", "logBB": 0.2, "BBB+/BBB-": "BBB-"},
    {"SMILES": "C(C)O", "logBB": 0.05, "BBB+/BBB-": "BBB+"},
    {"SMILES": "ClCC", "logBB": -1.0, "BBB+/BBB-": "BBB-"},   # range 2.2: group D
    {"SMILES": "CCCCO", "logBB": "1_000", "BBB+/BBB-": "BBB-"},
    {"SMILES": "CCN", "logBB": "inf?", "BBB+/BBB-": "BBB+"},
]


def _rows(df) -> list:
    """A DataFrame's rows as dicts, NaN as None."""
    return [{k: (None if isinstance(v, float) and math.isnan(v) else
                 (v.item() if isinstance(v, np.generic) else v))
             for k, v in r.items()} for r in df.to_dict("records")]


def _frames():
    return [pd.DataFrame(t) for t in (T0, T1, T2)]


def _equal(got, want_df):
    want = _rows(want_df)
    assert len(got) == len(want)
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        assert g == w, (g, w)


def test_combine_tables_equal_pandas():
    got = tc.combine_tables([T0, T1, T2])
    _equal(got, jc.combine_tables(_frames()))
    assert {r["canonical_smiles"] for r in got} >= {tc.canonical_key("CCO")}


def test_split_equal_pandas():
    got_reg, got_cls = tc.split_regression_classification(tc.combine_tables([T0, T1, T2]))
    want_reg, want_cls = jc.split_regression_classification(jc.combine_tables(_frames()))
    _equal(got_reg, want_reg)
    _equal(got_cls, want_cls)
    assert got_reg and got_cls


@pytest.mark.parametrize("tolerance,max_range", [(0.3, 1.0), (0.05, 0.15), (1.0, 3.0)])
def test_reconcile_regression_equal_pandas(tolerance, max_range):
    got = tc.reconcile_regression_labels(tc.combine_tables([T0, T1, T2]),
                                         tolerance=tolerance, max_range=max_range)
    want = jc.reconcile_regression_labels(jc.combine_tables(_frames()),
                                          tolerance=tolerance, max_range=max_range)
    _equal(got, want)
    keys = [r["canonical_smiles"] for r in got]
    assert keys == sorted(keys)


def test_regression_groups_cover_every_rule():
    got = tc.reconcile_regression_labels(tc.combine_tables([T0, T1, T2]))
    groups = {r["group"] for r in got}
    assert {"A", "B", "C"} <= groups
    # the chloroethane range (2.2) is group D: dropped
    assert tc.canonical_key("CCCl") not in {r["canonical_smiles"] for r in got}


def test_reconcile_classification_equal_pandas():
    got = tc.reconcile_classification_labels(tc.combine_tables([T0, T1, T2]))
    want = jc.reconcile_classification_labels(jc.combine_tables(_frames()))
    _equal(got, want)
    # benzene's vote (2 BBB+, 1 BBB-) is a majority; acetic acid's NaN label
    # counts no vote; a 1-1 tie (chloroethane) is dropped
    by_key = {r["canonical_smiles"]: r for r in got}
    assert by_key[tc.canonical_key("c1ccccc1")]["group"] == "B"
    assert by_key[tc.canonical_key("CC(=O)O")]["n_sources"] == 1
    assert tc.canonical_key("CCCl") not in by_key


def test_empty_results_equal_pandas():
    assert tc.reconcile_regression_labels([]) == []
    assert tc.reconcile_classification_labels([]) == []
    assert len(jc.reconcile_regression_labels(
        pd.DataFrame(columns=["canonical_smiles", "logBB"]))) == 0


def test_pubchem_urls_equal_jax():
    """The URL builders only: no lookup is made (there is no network)."""
    got, want = tc.PubChemClient(), jc.PubChemClient()
    for name in ("caffeine", "N,N-dimethyl tryptamine"):
        assert got.url_name_to_cid(name) == want.url_name_to_cid(name)
    assert got.url_cid_to_smiles(2519) == want.url_cid_to_smiles(2519)
    assert got.url_smiles_to_cid("C[C@H](N)O") == want.url_smiles_to_cid("C[C@H](N)O")
