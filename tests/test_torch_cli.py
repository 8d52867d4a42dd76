"""The port's featurize, analyze and chemspace CLIs
(``bbbp_tpu_torch/pipelines/``) and its six alias CLIs against the JAX
package's, on the CPU, over B3DB-format TSVs that ``testing.write_*_tsv``
writes inside ``testing.b3db_env`` (the JAX package's loaders pointed at
the same files).

- ``featurize``: every ``.npy`` bit-equal to the JAX package's (the same
  featurizer code, C++ for morgan / maccs / rdkit), the ZINC CSV and the
  PNGs of ``image_size`` equal byte for byte;
- ``analyze``: the summary CSV equal; its PCA coordinates, and each of
  ``chemspace``'s, within 3e-4 of max(1, their scale) of the JAX package's
  (the coordinates the JAX package hands its scatter; the two PCAs share a
  sign convention, ``tests/test_torch_scaler_pca.py``), f32 on the CPU;
- each alias CLI's ``--help`` runs and names the module it aliases.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from bbbp_tpu.data import b3db as jb3  # noqa: E402
from bbbp_tpu_torch.testing import (b3db_env, labelled_training_set,  # noqa: E402
                                    regression_molecules, write_classification_tsv,
                                    write_regression_tsv)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PCA_TOL = 3e-4
N_REG, N_CLS = 40, 60
ALIASES = {"screen_ensemble": "weighted_ensemble", "train_baseline": "baseline",
           "train_bert": "bert_pipeline", "train_classify": "classification",
           "train_flow": "flow_pipeline", "train_regress": "regression"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops: one intra-op thread, as the test workers share
    the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def b3db(tmp_path, monkeypatch):
    """Both TSVs in ``tmp_path/b3db``; both packages' loaders read them."""
    d = tmp_path / "b3db"
    d.mkdir()
    smiles, y = regression_molecules(N_REG)
    smiles[3] = "NOT_A_SMILES(("
    write_regression_tsv(str(d / "B3DB_regression.tsv"), smiles, y)
    write_classification_tsv(str(d / "B3DB_classification.tsv"),
                             *labelled_training_set(N_CLS, seed=4))
    monkeypatch.setattr(jb3, "B3DB_REGRESSION_TSV", str(d / "B3DB_regression.tsv"))
    monkeypatch.setattr(jb3, "B3DB_CLASSIFICATION_TSV",
                        str(d / "B3DB_classification.tsv"))
    with b3db_env(str(d)):
        yield d


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            with open(os.path.join(root, n), "rb") as f:
                out[os.path.relpath(os.path.join(root, n), d)] = f.read()
    return out


def _same_files(got_dir, want_dir):
    got, want = _files(got_dir), _files(want_dir)
    assert sorted(got) == sorted(want)
    for name, data in want.items():
        if name.endswith(".npy"):
            a = np.load(os.path.join(got_dir, name))
            b = np.load(os.path.join(want_dir, name))
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        else:
            assert got[name] == data, name


def test_featurize_b3db_equal_jax(b3db, tmp_path):
    from bbbp_tpu.pipelines import featurize as jf
    from bbbp_tpu_torch.pipelines import featurize as tf

    got = tf.featurize_b3db("regression", str(tmp_path / "t"), image_size=16, workers=1)
    want = jf.featurize_b3db("regression", str(tmp_path / "j"), image_size=16, workers=1)
    assert sorted(got) == sorted(want)
    _same_files(tmp_path / "t", tmp_path / "j")
    assert len(os.listdir(tmp_path / "t" / "img_output")) == N_REG - 1


def test_featurize_smi_and_graph_equal_jax(b3db, tmp_path):
    from bbbp_tpu.pipelines import featurize as jf
    from bbbp_tpu_torch.pipelines import featurize as tf

    smi = tmp_path / "tranche.smi"
    smiles, _ = regression_molecules(N_REG)
    smi.write_text("smiles zinc_id\n" + "".join(
        f"{s} ZINC{i:06d}\n" for i, s in enumerate(smiles[:20] + ["C1CC"])))
    for kind in ("morgan", "pairs"):
        tf.featurize_smi(str(smi), str(tmp_path / "t" / kind), kind=kind, workers=1)
        jf.featurize_smi(str(smi), str(tmp_path / "j" / kind), kind=kind, workers=1)
    g = tf.featurize_graph_b3db("classification", str(tmp_path / "t" / "graph"))
    w = jf.featurize_graph_b3db("classification", str(tmp_path / "j" / "graph"))
    assert list(g["bad_indices"]) == list(w["bad_indices"])
    _same_files(tmp_path / "t", tmp_path / "j")


def _capture(monkeypatch, module, name="pca_space_plot"):
    """The coordinates the JAX package hands its scatter, by path."""
    seen = {}

    def record(z, labels, path, **kw):
        seen[os.path.basename(path)] = np.asarray(z)
        return path

    monkeypatch.setattr(module, name, record)
    return seen


def _near(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= PCA_TOL * scale


@pytest.mark.parametrize("dataset", ["classification", "regression"])
def test_analyze_equal_jax(b3db, tmp_path, monkeypatch, dataset):
    from bbbp_tpu.pipelines import analyze as ja
    from bbbp_tpu.reporting import plots as jp
    from bbbp_tpu_torch.pipelines import analyze as ta

    seen = _capture(monkeypatch, jp)
    want = ja.analyze(dataset, str(tmp_path / "j"))
    got = ta.analyze(dataset, str(tmp_path / "t"), device="cpu")
    with open(got["summary"]) as f, open(want["summary"]) as g:
        assert f.read() == g.read()
    _near(got["coords"], seen[f"descriptor_pca_{dataset}.png"])
    assert os.path.exists(got["distributions"]) and os.path.exists(got["pca"])


def test_chemspace_classification_equal_jax(b3db, tmp_path, monkeypatch):
    from bbbp_tpu.pipelines import chemspace as jc
    from bbbp_tpu_torch.pipelines import chemspace as tc

    seen = _capture(monkeypatch, jc)
    kinds = ("morgan", "maccs", "rdkit")
    jc.classification_space(str(tmp_path / "j"), kinds=kinds, workers=1)
    got = tc.classification_space(str(tmp_path / "t"), kinds=kinds, workers=1,
                                  device="cpu")
    for kind in kinds:
        _near(got["coords"][kind], seen[f"pca_space_classification_{kind}.png"])
        assert os.path.exists(got[kind])


def test_chemspace_regression_equal_jax(b3db, tmp_path, monkeypatch):
    from bbbp_tpu.pipelines import chemspace as jc
    from bbbp_tpu_torch.pipelines import chemspace as tc

    seen = _capture(monkeypatch, jc)
    jc.regression_space(str(tmp_path / "j"), kind="maccs", workers=1)
    got = tc.regression_space(str(tmp_path / "t"), kind="maccs", workers=1,
                              device="cpu")
    for name in ("fingerprint", "image", "interaction"):
        _near(got["coords"][name], seen[f"pca_space_regression_maccs_{name}.png"])


@pytest.mark.parametrize("module", ["analyze", "chemspace"])
def test_cli_defaults_to_cuda(module, monkeypatch, b3db, tmp_path):
    import importlib

    mod = importlib.import_module(f"bbbp_tpu_torch.pipelines.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [module, "--out-dir", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main()


def test_featurize_main_runs(b3db, tmp_path, monkeypatch):
    from bbbp_tpu_torch.pipelines import featurize as tf

    monkeypatch.setattr(sys, "argv", ["featurize", "b3db", "--dataset", "classification",
                                      "--kinds", "maccs", "--out-dir",
                                      str(tmp_path / "o")])
    tf.main()
    assert np.load(tmp_path / "o" / "maccs_fingerprints.npy").shape == (N_CLS, 167)


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_alias_cli_help(alias):
    proc = subprocess.run([sys.executable, "-m", f"bbbp_tpu_torch.pipelines.{alias}",
                           "--help"], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "usage:" in proc.stdout
    with open(os.path.join(REPO, "bbbp_tpu_torch", "pipelines", f"{alias}.py")) as f:
        assert f"from bbbp_tpu_torch.train.{ALIASES[alias]} import main" in f.read()
