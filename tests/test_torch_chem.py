"""The port's copy of the Python featurizer (bbbp_tpu_torch.chem) against
bbbp_tpu.chem: the same SMILES give the same bits, counts, descriptors and
canonical SMILES, bit for bit (tolerance 0: the modules are copies and only
their imports differ)."""

import difflib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bbbp_tpu.chem.featurize as jfeat  # noqa: E402
import bbbp_tpu_torch.chem.featurize as tfeat  # noqa: E402
from bbbp_tpu.data.zinc import synthetic_smiles  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIED = ("mol", "kekulize", "smiles", "writer", "standardize",
          "structural_keys", "fingerprints", "crippen", "descriptors")
# the inline molecules of tests/test_transfer.py, salts and charged forms,
# and three strings that do not parse
INLINE = ["CCO", "CCN", "CCC", "CCCC", "CCOC", "CC(=O)O", "c1ccccc1",
          "c1ccccc1C", "CCCCO", "NCCN", "OCCO", "CCCCC", "c1ccncc1", "CC(C)C",
          "CCS", "CCCl", "NCCO", "CCCCCC", "CC(=O)[O-].[Na+]", "C[NH3+].[Cl-]",
          "OC(=O)c1ccccc1O", "CN1CCC[C@H]1c1cccnc1", "C/C=C/C", "[O-][N+](=O)c1ccccc1"]
INVALID = ["NOT_A_SMILES((", "C1CC", "[Xx]"]


@pytest.fixture(scope="module")
def molecules():
    s = synthetic_smiles(150, seed=5) + INLINE
    s.insert(3, INVALID[0])
    s.insert(77, INVALID[1])
    s.append(INVALID[2])
    return s


@pytest.mark.parametrize("module", COPIED)
def test_module_is_a_copy_but_for_its_imports(module):
    """Every line of the copy that differs from the original names the
    port's package (an import, or a comment's path) or is one of the two
    comment lines of fingerprints.py that name a file."""
    with open(os.path.join(REPO, "bbbp_tpu", "chem", module + ".py")) as f:
        ours = f.read().splitlines()
    with open(os.path.join(REPO, "bbbp_tpu_torch", "chem", module + ".py")) as f:
        theirs = f.read().splitlines()
    assert len(ours) == len(theirs)
    changed = [b for a, b in zip(ours, theirs) if a != b]
    for line in changed:
        assert ("bbbp_tpu_torch" in line or "bbbpchem.cpp" in line
                or "create_descriptors.py" in line), line
    assert len(changed) <= 8, "\n".join(difflib.unified_diff(ours, theirs, lineterm=""))


@pytest.mark.parametrize("kind,native", [
    ("morgan", True), ("maccs", True), ("rdkit", True), ("morgan", False),
    ("maccs", False), ("rdkit", False), ("pairs", False),
    ("morgan_counts", False), ("avalon", False)])
def test_fingerprints_equal_jax_package(kind, native, molecules):
    want = jfeat.fingerprints(molecules, kind, workers=1, use_native=native)
    got = tfeat.fingerprints(molecules, kind, workers=1, use_native=native)
    assert got.features.dtype == np.float32
    assert got.features.shape == (len(molecules), tfeat.fp_dim(kind))
    assert np.array_equal(got.features, want.features)
    assert np.array_equal(got.bad_indices, want.bad_indices)
    assert list(got.bad_indices) == [3, 77, len(molecules) - 1]
    assert not got.features[got.bad_indices].any()          # quarantined rows
    assert got.ok_mask.sum() == len(molecules) - 3
    if kind == "morgan_counts":
        assert got.features.max() > 1                         # counts, not bits


def test_descriptors_equal_jax_package(molecules):
    from bbbp_tpu.chem.descriptors import descriptor_matrix as want_fn
    from bbbp_tpu_torch.chem.descriptors import descriptor_matrix

    want, want_bad = want_fn(molecules)
    got, bad = descriptor_matrix(molecules)
    assert got.shape[1] == 31
    assert np.array_equal(got, want) and bad == want_bad == [3, 77, len(molecules) - 1]
    for workers in (1, 2):                  # the pooled form of the same
        pooled = tfeat.descriptors(molecules, workers=workers)
        assert np.array_equal(pooled.features, want)
        assert list(pooled.bad_indices) == want_bad
    assert tfeat.descriptors([]).features.shape == (0, 31)


def test_standardize_and_canonical_smiles_equal_jax_package(molecules):
    from bbbp_tpu.chem.smiles import MolFromSmiles as jparse
    from bbbp_tpu.chem.standardize import standardize_smiles as want_fn
    from bbbp_tpu.chem.writer import MolToSmiles as jwrite
    from bbbp_tpu_torch.chem.smiles import MolFromSmiles
    from bbbp_tpu_torch.chem.standardize import standardize_smiles
    from bbbp_tpu_torch.chem.writer import MolToSmiles

    def guarded(fn, s):
        try:
            return fn(s)
        except Exception as e:  # noqa: BLE001 — the same failure on both sides
            return type(e).__name__

    for s in molecules:
        assert guarded(standardize_smiles, s) == guarded(want_fn, s), s
        mol, jmol = MolFromSmiles(s), jparse(s)
        assert (mol is None) == (jmol is None)
        if mol is not None:
            assert MolToSmiles(mol) == jwrite(jmol)
    assert standardize_smiles("CC(=O)[O-].[Na+]") == standardize_smiles("CC(=O)O")


@pytest.mark.parametrize("kind", ["morgan_counts", "pairs"])
def test_process_pool_matches_one_process(kind, molecules):
    """The pool's processes are spawned (this process has threads, and on
    the card a CUDA context); they give the serial result, bad indices in
    input order."""
    serial = tfeat.fingerprints(molecules, kind, workers=1)
    pooled = tfeat.fingerprints(molecules, kind, workers=2)
    assert np.array_equal(serial.features, pooled.features)
    assert np.array_equal(serial.bad_indices, pooled.bad_indices)


def test_empty_batch_and_unknown_kind():
    for kind in tfeat.FP_KINDS:
        out = tfeat.fingerprints([], kind)
        assert out.features.shape == (0, tfeat.fp_dim(kind))
    assert tfeat.FP_KINDS == jfeat.FP_KINDS and tfeat.FP_SIZES == jfeat.FP_SIZES
    with pytest.raises(ValueError):
        tfeat.fingerprints(["CCO"], "ecfp9")
