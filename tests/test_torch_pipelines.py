"""Port parity and wiring of the classification and baseline pipelines
around the search (bbbp_tpu_torch.train.classification's ``tune_zoo``,
outputs and CLI; bbbp_tpu_torch.train.baseline; the copied
chem.graph_features), on the CPU at toy size.

Forest classes are patched in the classification modules of both packages
to at most 16 trees of depth at most 4, as in test_torch_classification.py.
Tolerances: a search's best CV accuracy within two rows and the same best
trial; the baseline's reports for knn, logreg, svc and bnb within 1e-6
(their probabilities agree to ~5e-7 and no label turns); the graph
features bit-equal (numpy copies).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from bbbp_tpu.ops import linear as jl  # noqa: E402
from bbbp_tpu.train import classification as jc  # noqa: E402
from bbbp_tpu_torch.models.convert import mlp_from_jax  # noqa: E402
from bbbp_tpu_torch.ops import linear as tl  # noqa: E402
from bbbp_tpu_torch.testing import classification_inputs, labelled_training_set  # noqa: E402
from bbbp_tpu_torch.train import classification as tc  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's torch work is many small ops: one intra-op thread each,
    as the test workers share the machine's cores (OpenMP teams that
    outnumber the cores spin against each other)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


N_MOLECULES, PCA_DIM = 600, 8
TREE_CAP, DEPTH_CAP = 16, 4
REPORT_TOL = 1e-6


class _Capped:
    def __init__(self, n_estimators=300, max_depth=6, **kw):
        super().__init__(n_estimators=min(n_estimators, TREE_CAP),
                         max_depth=min(max_depth, DEPTH_CAP), **kw)


# module level, so that a pickle of the fitted models can name them
class JaxGBDT(_Capped, jc.GBDTClassifier):
    pass


class JaxForest(_Capped, jc.RandomForestClassifier):
    pass


class PortGBDT(_Capped, tc.GBDTClassifier):
    pass


class PortForest(_Capped, tc.RandomForestClassifier):
    pass


def _patch(mp):
    for mod, gbdt, forest in ((jc, JaxGBDT, JaxForest), (tc, PortGBDT, PortForest)):
        mp.setattr(mod, "GBDTClassifier", gbdt)
        mp.setattr(mod, "RandomForestClassifier", forest)
    mp.setattr(tl, "init_mlp", lambda dims, seed: mlp_from_jax(
        jl._init_mlp(jax.random.PRNGKey(seed), tuple(dims))))


@pytest.fixture(scope="module")
def inputs():
    return classification_inputs(N_MOLECULES)


def _stand_in_b3db(monkeypatch, n, seed):
    """Both packages' B3DB classification loaders return ``n`` labelled
    molecules."""
    from bbbp_tpu.data import b3db as jb3
    from bbbp_tpu.train import baseline as jbase
    from bbbp_tpu_torch.data import b3db as tb3

    smiles, labels = labelled_training_set(n, seed=seed)
    port = tb3.ClassificationData(smiles, labels, np.arange(n), [None] * n,
                                  [None] * n)
    monkeypatch.setattr(tb3, "load_b3db_classification", lambda: port)
    jax_data = jb3.ClassificationData(smiles, labels, np.arange(n), None)
    monkeypatch.setattr(jbase, "load_b3db_classification", lambda: jax_data)


def test_tune_zoo_picks_the_jax_winners(inputs, monkeypatch):
    """The per-model search on the reference protocol's training rows: the
    same best trial for the lane-batched families."""
    _patch(monkeypatch)
    x, y = inputs
    x8 = np.asarray(jc.PCA(PCA_DIM).fit_transform(
        np.asarray(jc.StandardScaler().fit_transform(x))))
    names = ["knn", "logreg", "svc", "bnb"]
    cfg = dict(n_search_iter=5, search_folds=3)
    _, want, _ = jc.tune_zoo(x8, y, names, jc.ClassificationTrainConfig(**cfg),
                             verbose=False)
    zoo, got, walls = tc.tune_zoo(x8, y, names,
                                  tc.ClassificationTrainConfig(**cfg),
                                  verbose=False, device="cpu")
    assert set(zoo) == set(names) == set(walls)
    for m in names:
        best = [max(t, key=lambda r: r["mean_accuracy"]) for t in (want[m], got[m])]
        assert best[1]["mean_accuracy"] == pytest.approx(
            best[0]["mean_accuracy"], abs=2 / len(y)), m
        assert {k: v for k, v in best[1].items() if not k.startswith("mean")} == \
            {k: v for k, v in best[0].items() if not k.startswith("mean")}, m


def test_tuned_run_writes_its_outputs(inputs, tmp_path, capsys, monkeypatch):
    """tune=True, the honest protocol, SMOTE alone, three models, an out_dir:
    the metrics, trial and learning-score CSVs, the pickle and the figures,
    the search scatters among them. (Until the figures were ported this
    test held the line that said none were written.)"""
    import pickle

    from bbbp_tpu_torch.reporting.metrics_io import read_metrics_csv

    _patch(monkeypatch)
    x, y = inputs
    cfg = tc.ClassificationTrainConfig(
        pca_dim=PCA_DIM, protocol="honest", resampler="smote",
        models=("knn", "logreg", "gb"), n_search_iter=2,
        n_search_iter_forest=1, search_folds=3, out_dir=str(tmp_path))
    res = tc.run_classification(cfg, x, y, verbose=False, device="cpu")
    out = capsys.readouterr().out
    assert "FAILED" not in out and "does not import" not in out
    for name in ("performance_maccs.png", "confusion_stacking.png",
                 "shap_gb.png", "shap_kernel_knn.png"):
        assert (tmp_path / name).exists(), name
    table = read_metrics_csv(str(tmp_path / "model_performance_metrics_maccs.csv"))
    assert list(table) == ["knn", "logreg", "gb", "stacking", "voting"]
    for m in cfg.models:
        assert (tmp_path / f"hyperparam_search_{m}.csv").exists()
        assert (tmp_path / f"{m}_learning_scores.csv").exists()
        assert (tmp_path / f"{m}_learning_curve.png").exists()
        assert list(tmp_path.glob(f"hyperparam_search_{m}_*.png")), m
    with open(tmp_path / "fitted_models.pkl", "rb") as f:
        fitted = pickle.load(f)
    assert fitted["logreg"].predict_proba(np.zeros((3, PCA_DIM), np.float32)
                                          ).shape == (3, 2)
    assert res.stage_s["tune"] > 0 and "outputs" in res.stage_s


def test_main_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    """``python -m bbbp_tpu_torch.train.classification --device cpu`` over a
    stand-in for the B3DB loader."""
    import json
    import sys

    from bbbp_tpu_torch.data import b3db
    from bbbp_tpu_torch.testing import labelled_training_set

    _patch(monkeypatch)
    smiles, labels = labelled_training_set(150, seed=2)
    monkeypatch.setattr(b3db, "load_b3db_classification", lambda: b3db.ClassificationData(
        smiles, labels, np.arange(len(smiles)), [None] * len(smiles),
        [None] * len(smiles)))
    out = tmp_path / "report.json"
    monkeypatch.setattr(sys, "argv", ["classification", "--no-tune", "--pca-dim", "4",
                                      "--device", "cpu", "--out", str(out)])
    tc.main()
    report = json.loads(out.read_text())
    assert set(report) == set(tc.default_zoo()) | {"stacking", "voting"}
    assert '"voting"' in capsys.readouterr().out




@pytest.mark.parametrize("tune", [True, False])
def test_baseline_equals_jax(monkeypatch, tune):
    """``run_baseline`` over 300 stand-in molecules, MACCS, PCA 8, the four
    non-forest families of the A1 zoo (GridSearchCV on f1 when tuned)."""
    from bbbp_tpu.train import baseline as jbase
    from bbbp_tpu_torch.train import baseline as tbase

    _stand_in_b3db(monkeypatch, 300, 4)
    kw = dict(fp_kind="maccs", pca_dim=PCA_DIM, tune=tune,
              models=("knn", "logreg", "svc", "bnb"), grid_folds=3)
    want = jbase.run_baseline(jbase.BaselineConfig(**kw), verbose=False)
    got = tbase.run_baseline(tbase.BaselineConfig(**kw), verbose=False,
                             device="cpu")
    assert got["_best"]["model"] == want["_best"]["model"]
    for m in kw["models"]:
        assert list(got[m]) == list(want[m])
        for k, v in want[m].items():
            assert abs(got[m][k] - v) <= REPORT_TOL, (m, k, got[m], want[m])


def test_baseline_writes_its_outputs(monkeypatch, tmp_path, capsys):
    from bbbp_tpu_torch.reporting.metrics_io import read_metrics_csv
    from bbbp_tpu_torch.train import baseline as tbase

    _stand_in_b3db(monkeypatch, 200, 5)
    monkeypatch.setattr(tbase, "default_zoo", lambda seed, device: {
        m: f for m, f in tc.default_zoo(seed, device).items()
        if m in ("knn", "bnb", "dt")})
    monkeypatch.setattr(tbase, "GRID_SPACES", {"knn": {"n_neighbors": [3, 5]},
                                               "dt": {"n_estimators": [2],
                                                      "max_depth": [3]}})
    rep = tbase.run_baseline(tbase.BaselineConfig(
        fp_kind="maccs", pca_dim=PCA_DIM, out_dir=str(tmp_path), grid_folds=3),
        verbose=False, device="cpu")
    assert "does not import" not in capsys.readouterr().out
    assert (tmp_path / "performance_maccs.png").exists()
    assert rep["_best"]["model"] in ("knn", "bnb", "dt")
    assert list(read_metrics_csv(str(
        tmp_path / "model_performance_metrics_maccs.csv"))) == ["knn", "bnb", "dt"]
    for m in ("knn", "bnb", "dt"):
        assert (tmp_path / f"{m}_model.pkl").exists()
        assert (tmp_path / f"{m}_learning_scores.csv").exists()
        assert (tmp_path / f"{m}_learning_curve.png").exists()
    assert (tmp_path / "grid_best_params.json").exists()


def test_graph_features_are_a_copy():
    from bbbp_tpu.chem import graph_features as jg
    from bbbp_tpu_torch.chem import graph_features as tg

    smiles, _ = labelled_training_set(60, seed=6)
    smiles = smiles + ["NOT_A_SMILES((", "c1ccccc1C#N", "C=CC(=O)[O-]"]
    for a, b in zip(jg.graph_features(smiles, max_atoms=48, edge_types=True),
                    tg.graph_features(smiles, max_atoms=48, edge_types=True)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    (fa, ba), (fb, bb) = jg.pooled_graph_features(smiles), \
        tg.pooled_graph_features(smiles)
    assert np.array_equal(fa, fb) and list(ba) == list(bb) == [60]
