"""Port parity of the transfer slice: bbbp_tpu_torch.train.transfer and
bbbp_tpu_torch.data.b3db against the JAX package on the CPU.

Tolerances: the raw features, the loaders and the rank AUC are exact (the
same host arithmetic); the ``transfer_tknn`` column within 1e-6 (equal
neighbours, a few f32 roundings in the weighted mean); the forest columns
only statistically (both packages fix ``subsample=0.8`` and draw other
random rows): correlation above 0.85 with the JAX column and a holdout AUC
within 0.1 of it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bbbp_tpu.data.b3db as jb3db  # noqa: E402
import bbbp_tpu.train.transfer as jtr  # noqa: E402
import bbbp_tpu_torch.data.b3db as tb3db  # noqa: E402
import bbbp_tpu_torch.train.transfer as ttr  # noqa: E402
from bbbp_tpu_torch.data.zinc import synthetic_smiles  # noqa: E402
from bbbp_tpu_torch.testing import labelled_training_set  # noqa: E402

SMALL = dict(trees=30, depth=4, rf_trees=20, rf_depth=5, morgan_pca_dim=16,
             tknn_k=7)


def _aux(n_rep=4):
    """The aux set of tests/test_transfer.py: polar against apolar."""
    s = ["CCO", "CCN", "CCC", "CCCC", "CCOC", "CC(=O)O", "c1ccccc1",
         "c1ccccc1C", "CCCCO", "NCCN", "OCCO", "CCCCC", "c1ccncc1",
         "CC(C)C", "CCS", "CCCl"] * n_rep
    y = np.array([1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 1, 0, 0, 0] * n_rep,
                 np.float32)
    return s, y


@pytest.fixture(scope="module")
def both_runs():
    """transfer_features of both packages at a small size: 400 labelled
    molecules, 60 queries, all four models."""
    aux = labelled_training_set(400, seed=1)
    queries = synthetic_smiles(60, seed=9)
    want = jtr.transfer_features(queries, jtr.TransferConfig(**SMALL),
                                 aux_data=aux, verbose=False, workers=1)
    got = ttr.transfer_features(queries, ttr.TransferConfig(**SMALL),
                                aux_data=aux, verbose=False, workers=1,
                                device="cpu")
    return want, got


# -- pieces --------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auc_equals_jax_package(seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, 200)
    s = np.round(rng.random(200), 1 + seed)          # many tied scores
    assert ttr._auc(y, s) == jtr._auc(y, s)
    assert np.isnan(ttr._auc(np.ones(5), rng.random(5)))


def test_config_and_cache_key_fields_equal_jax_package():
    """The cache key hashes ``cfg.__dict__``: the fields, their order and
    their defaults must be the JAX package's, so the device is an argument
    of ``transfer_features`` and no field."""
    a, b = jtr.TransferConfig(), ttr.TransferConfig()
    assert repr(sorted(a.__dict__.items())) == repr(sorted(b.__dict__.items()))
    assert list(a.__dict__) == list(b.__dict__)


def test_raw_transfer_features_equal_jax_package_and_share_the_cache(tmp_path):
    smiles = synthetic_smiles(90, seed=4) + ["C1CC", "CC(=O)[O-].[Na+]"]
    want = jtr.raw_transfer_features(smiles, workers=1)
    got = ttr.raw_transfer_features(smiles, workers=1, cache_dir=str(tmp_path))
    pooled = ttr.raw_transfer_features(smiles, workers=2)
    for a, b, c in zip(want, got, pooled):
        assert a.dtype == b.dtype and np.array_equal(a, b) and np.array_equal(b, c)
    assert got[0].shape == (92, 31) and got[1].shape == (92, 167)
    assert got[2].shape == (92, 2048) and not got[2][90].any()
    # the file the port wrote is the one the JAX package looks for
    files = [p.name for p in tmp_path.iterdir()]
    assert len(files) == 1 and files[0].startswith("rawfeat_")
    cached = jtr.raw_transfer_features(smiles, workers=1,
                                       cache_dir=str(tmp_path))
    for a, b in zip(want, cached):
        assert np.array_equal(a, b)
    assert [p.name for p in tmp_path.iterdir()] == files


@pytest.mark.parametrize("name,cls,oblivious", [
    ("gbdt", "GBDTClassifier", False), ("oblivious", "GBDTClassifier", True),
    ("rf", "RandomForestClassifier", False), ("tknn", "TanimotoKNNClassifier", None)])
def test_make_model_builds_the_ports_estimators(name, cls, oblivious):
    cfg = ttr.TransferConfig()
    m = ttr._make_model(name, cfg, 7, "cpu")
    ref = jtr._make_model(name, jtr.TransferConfig(), 7)
    assert type(m).__name__ == cls and m.device == "cpu"
    if name == "tknn":
        assert m.n_neighbors == ref.n_neighbors == 25
    else:
        assert m.oblivious == oblivious
        for key in ("n_estimators", "max_depth", "learning_rate", "subsample",
                    "colsample", "reg_lambda", "min_child_weight", "seed"):
            assert getattr(m, key) == getattr(ref, key), key
    with pytest.raises(ValueError):
        ttr._make_model("svm", cfg, 7, "cpu")


# -- the loaders and the aux set ---------------------------------------------

CLS_ROWS = [
    # NO., SMILES, BBB+/BBB-, logBB, Inchi
    ("1", "CCO", "BBB+", "", "InChI=1S/C2H6O"),
    ("2", "CCN", "BBB-", "-0.5", "InChI=1S/C2H7N"),           # numeric logBB
    ("3", "CCC", " BBB+ ", "NA", "InChI=1S/C3H8"),
    ("4", "CCCC", "BBB-", "1e-1", ""),                          # numeric logBB
    ("5", "c1ccccc1", "BBB+", "n.d.", "InChI=1S/C6H6"),         # InChI match
    ("6", "CC(=O)[O-].[Na+]", "BBB-", "", "InChI=1S/other"),    # std SMILES match
    ("7", "", "BBB+", "", "InChI=1S/gone"),                     # no SMILES
    ("8", "CCS", "", "", "InChI=1S/gone2"),                     # no label
    ("9", "CCCl", "BBB+", "nan", "nan"),
    ("10", "OCCO", "BBB-", "1_0", "InChI=1S/C2H6O2"),           # not numeric
    ("11", "NOT_A_SMILES((", "BBB+", "", ""),
]
REG_ROWS = [
    ("1", "c1ccccc1C", "0.3", "InChI=1S/C6H6"),
    ("2", "CC(=O)O", "-1.2", "InChI=1S/C2H4O2"),
    ("3", "CCCCC", "", "InChI=1S/C5H12"),                       # no logBB
    ("4", "NCCN", "0.05", "NA"),
]


@pytest.fixture
def b3db_dir(tmp_path, monkeypatch):
    with open(tmp_path / tb3db.CLASSIFICATION_TSV, "w") as f:
        f.write("NO.\tSMILES\tBBB+/BBB-\tlogBB\tInchi\n")
        f.writelines("\t".join(r) + "\n" for r in CLS_ROWS)
    with open(tmp_path / tb3db.REGRESSION_TSV, "w") as f:
        f.write("NO.\tSMILES\tlogBB\tInchi\n")
        f.writelines("\t".join(r) + "\n" for r in REG_ROWS)
    monkeypatch.setenv(tb3db.ENV_DIR, str(tmp_path))
    monkeypatch.setattr(jb3db, "B3DB_CLASSIFICATION_TSV",
                        str(tmp_path / tb3db.CLASSIFICATION_TSV))
    monkeypatch.setattr(jb3db, "B3DB_REGRESSION_TSV",
                        str(tmp_path / tb3db.REGRESSION_TSV))
    return tmp_path


def test_loaders_equal_jax_package(b3db_dir):
    want, got = jb3db.load_b3db_regression(), tb3db.load_b3db_regression()
    assert got.smiles == want.smiles == ["c1ccccc1C", "CC(=O)O", "NCCN"]
    assert got.logbb.dtype == np.float32 and np.array_equal(got.logbb, want.logbb)
    assert np.array_equal(got.numbers, want.numbers)
    assert got.inchi == [None if v != v else v for v in want.frame["Inchi"]]
    want, got = jb3db.load_b3db_classification(), tb3db.load_b3db_classification()
    assert got.smiles == want.smiles and len(got) == 9
    assert np.array_equal(got.labels, want.labels)
    assert np.array_equal(got.numbers, want.numbers)
    assert [v is None for v in got.inchi] == list(want.frame["Inchi"].isna())
    assert [v is None for v in got.logbb] == list(want.frame["logBB"].isna())


@pytest.mark.parametrize("text", ["-0.5", "1e-1", " 0.3 ", "12", "+4.", "inf",
                                  "", "NA", "nan", "n.d.", "1_0", "0x10", "1,5",
                                  "--1", "None"])
def test_is_numeric_agrees_with_pandas_to_numeric(text):
    pd = pytest.importorskip("pandas")
    import io

    frame = pd.read_csv(io.StringIO(f"v\tw\n{text}\tx\nabc\ty\n"), sep="\t")
    want = bool(pd.to_numeric(frame["v"], errors="coerce").notna()[0])
    assert tb3db.is_numeric(text) == want
    assert not tb3db.is_numeric(None)


def test_aux_classification_set_equals_jax_package(b3db_dir):
    want = jtr.aux_classification_set()
    got = ttr.aux_classification_set()
    assert got[0] == want[0] == ["CCO", "CCC", "CCCl", "OCCO", "NOT_A_SMILES(("]
    assert got[1].dtype == np.float32 and np.array_equal(got[1], want[1])
    assert got[2] == want[2] == 4      # two by logBB, one by InChI, one by SMILES


def test_loaders_name_what_is_missing(tmp_path, monkeypatch):
    monkeypatch.delenv(tb3db.ENV_DIR, raising=False)
    with pytest.raises(FileNotFoundError, match=tb3db.ENV_DIR):
        tb3db.load_b3db_regression()
    bad = tmp_path / "bad.tsv"
    bad.write_text("NO.\tSMILES\n1\tCCO\n")
    with pytest.raises(ValueError, match="logBB"):
        tb3db.load_b3db_regression(str(bad))


# -- the slice as a whole ------------------------------------------------------

def test_transfer_tknn_column_within_1e_6_of_jax(both_runs):
    want, got = both_runs
    assert got.names == want.names == ["transfer_gbdt", "transfer_oblivious",
                                       "transfer_rf", "transfer_tknn"]
    assert got.features.shape == want.features.shape == (60, 4)
    assert got.features.dtype == np.float32
    np.testing.assert_allclose(got.features[:, 3], want.features[:, 3],
                               rtol=0, atol=1e-6)
    assert abs(got.holdout_auc["tknn"] - want.holdout_auc["tknn"]) < 1e-9
    assert (got.n_aux, got.n_excluded) == (want.n_aux, want.n_excluded) == (400, 0)


@pytest.mark.parametrize("col,name", [(0, "gbdt"), (1, "oblivious"), (2, "rf")])
def test_transfer_forest_columns_agree_statistically(col, name, both_runs):
    want, got = both_runs
    a, b = got.features[:, col], want.features[:, col]
    assert np.all((a >= 0) & (a <= 1))
    corr = float(np.corrcoef(a, b)[0, 1])
    print(f"{name}: correlation {corr:.4f}, holdout AUC {got.holdout_auc[name]:.4f} "
          f"against {want.holdout_auc[name]:.4f}")
    assert corr > 0.85
    assert abs(got.holdout_auc[name] - want.holdout_auc[name]) < 0.1
    assert got.holdout_auc[name] > 0.7
    assert {f"{name}_holdout", f"{name}_fit", f"{name}_predict"} <= set(got.seconds)


def test_features_learn_polarity_and_shapes():
    """tests/test_transfer.py's check of the JAX function, on the port."""
    s, y = _aux()
    cfg = ttr.TransferConfig(models=("gbdt", "tknn"), trees=24, depth=3,
                             morgan_pca_dim=8, holdout_frac=0.2, tknn_k=5)
    res = ttr.transfer_features(["CCO", "NCCO", "CCCC", "CCCCCC"], cfg,
                                aux_data=(s, y), verbose=False, workers=1,
                                device="cpu")
    assert res.features.shape == (4, 2)
    assert res.names == ["transfer_gbdt", "transfer_tknn"]
    assert set(res.holdout_auc) == {"gbdt", "tknn"}
    assert res.features[:2].mean() > res.features[2:].mean()
    assert np.all(res.features >= 0) and np.all(res.features <= 1)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_files_are_read_both_ways(writer, tmp_path):
    """One package writes ``transfer_*.npz`` and ``rawfeat_*.npz``; the other,
    given poisoned labels, must return the cached features."""
    s, y = _aux(2)
    q = ["CCO", "CCCC"]
    kw = dict(models=("tknn",), morgan_pca_dim=4, holdout_frac=0.0, tknn_k=3,
              cache_dir=str(tmp_path))

    def run(package, labels):
        if package == "jax":
            return jtr.transfer_features(q, jtr.TransferConfig(**kw),
                                         aux_data=(s, labels), verbose=False,
                                         workers=1)
        return ttr.transfer_features(q, ttr.TransferConfig(**kw),
                                     aux_data=(s, labels), verbose=False,
                                     workers=1, device="cpu")

    reader = "port" if writer == "jax" else "jax"
    first = run(writer, y)
    files = sorted(p.name for p in tmp_path.iterdir())
    assert [f.split("_")[0] for f in files] == ["rawfeat", "rawfeat", "transfer"]
    second = run(reader, 1 - y)
    assert np.array_equal(first.features, second.features)
    assert second.names == first.names and second.holdout_auc == first.holdout_auc
    assert sorted(p.name for p in tmp_path.iterdir()) == files


def test_transfer_features_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.transfer_features(["CCO"], aux_data=_aux(1), verbose=False)


def test_aux_feature_basis_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = (np.zeros((4, 3), np.float32), np.zeros((4, 167), np.float32),
           np.zeros((4, 8), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr._aux_feature_basis(["C"] * 4, 2, raw=raw)
    x, maccs, _ = ttr._aux_feature_basis(["C"] * 4, 2, raw=raw, device="cpu")
    assert x.shape == (4, 3 + 167 + 2) and maccs.shape == (4, 167)
