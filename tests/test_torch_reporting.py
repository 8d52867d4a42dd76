"""The port's figures and highlights (``bbbp_tpu_torch/reporting/plots.py``,
``chem/highlight.py``) against the JAX package's, and the artifact sets the
port's pipelines write.

- ``draw_fingerprint_highlights``: bit-equal arrays (the same numpy code
  over the port's copy of the featurizer); the PNGs bit-equal bytes.
- Each of the 13 plot functions, on the same inputs, writes the same PNG
  bytes as the JAX package's (both at 100 dpi here, for time: the modules'
  own 600 are held equal), or where the bytes differ the same decoded
  pixels.
- ``run_classification(out_dir)`` (the MACCS rows of 600 labelled
  molecules, PCA 8, five models, forests cut to 16 trees of depth 4),
  ``run_baseline`` and ``run_regression`` (a 72-row ``ProcessedData``, 3
  folds) write the file names that the JAX package's code writes
  (``bbbp_tpu/train/classification.py:372-460``, ``baseline.py:149-161``,
  ``regression.py:889-918``), listed here; the JAX pipelines are not run.
- With matplotlib and PIL hidden (``sys.modules`` entries set to None), each
  pipeline prints one line naming the figures it does not write, and writes
  its CSVs, pickles and checkpoint.
"""

import io
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("matplotlib")
PIL_Image = pytest.importorskip("PIL.Image")

from bbbp_tpu.chem import highlight as jh  # noqa: E402
from bbbp_tpu.reporting import plots as jp  # noqa: E402
from bbbp_tpu_torch.chem import highlight as th  # noqa: E402
from bbbp_tpu_torch.reporting import plots as tp  # noqa: E402

SMILES = ["c1ccccc1O", "CC(=O)Nc1ccc(O)cc1", "C[N+](C)(C)CCO", "N#CC=CC(=O)O",
          "C1CC2CCC1C2"]
FIGURE_DPI = 100
PCA_DIM = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops: one intra-op thread, as the test workers share
    the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("smiles", SMILES)
def test_highlights_bit_equal_jax(smiles):
    got = th.draw_fingerprint_highlights(smiles, size=96)
    want = jh.draw_fingerprint_highlights(smiles, size=96)
    assert list(got) == list(want) == ["morgan", "structural", "rings"]
    for name in want:
        assert got[name].dtype == want[name].dtype
        assert np.array_equal(got[name], want[name]), name


def test_highlight_pngs_equal_jax(tmp_path):
    got = th.save_fingerprint_highlights(SMILES[1], str(tmp_path / "t"), size=64)
    want = jh.save_fingerprint_highlights(SMILES[1], str(tmp_path / "j"), size=64)
    for g, w in zip(got, want):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read()
    assert th.draw_fingerprint_highlights("NOT((") is None
    with pytest.raises(ValueError, match="unparseable"):
        th.save_fingerprint_highlights("NOT((", str(tmp_path / "x"))


def _plot_calls():
    rng = np.random.default_rng(3)
    y = rng.integers(0, 2, 60)
    pred = (y + rng.random(60) > 0.9).astype(int)
    report = {"rf": {"accuracy": .9, "precision": .8, "recall": .7, "f1": .75,
                     "roc_auc": .95},
              "knn": {"accuracy": .8, "precision": .7, "recall": .6, "f1": .65}}
    yt = rng.standard_normal(50)
    yp = yt + 0.2 * rng.standard_normal(50)
    trials = [{"lr": float(a), "depth": int(b), "trees": int(c),
               "mean_accuracy": float(s)}
              for a, b, c, s in zip(rng.random(6), rng.integers(2, 8, 6),
                                    rng.integers(10, 90, 6), rng.random(6))]
    sv, xs = rng.standard_normal((40, 6)), rng.standard_normal((40, 6))
    return {
        "confusion_matrix_plot": ((y, pred), {}),
        "performance_bar_plot": ((report,), {}),
        "learning_curve_plot": (([10, 30, 50], rng.random((3, 4)), rng.random((3, 4))), {}),
        "loss_curve_plot": ((rng.random((4, 12)),), {}),
        "pred_vs_actual_plot": ((yt, yp), {"r2": 0.8, "mse": 0.1}),
        "distribution_plot": ((yt, yp), {}),
        "feature_importance_plot": ((rng.random(12),), {"top": 8}),
        "hyperparam_scatter_plot": ((trials, "lr", "depth", "mean_accuracy"),
                                    {"z_key": "trees"}),
        "hyperparam_search_plots": ((trials,), {}),
        "shap_dependence_plot": ((sv, xs, 2), {}),
        "pca_space_plot": ((rng.standard_normal((40, 2)), y[:40]), {}),
        "shap_summary_plot": ((sv, xs), {"top": 5}),
        "_save": None,
    }


def _same_image(a: str, b: str) -> None:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        ba, bb = fa.read(), fb.read()
    if ba != bb:
        pa = np.asarray(PIL_Image.open(io.BytesIO(ba)))
        pb = np.asarray(PIL_Image.open(io.BytesIO(bb)))
        assert pa.shape == pb.shape and np.array_equal(pa, pb), (a, b)


PLOTS = [name for name, call in _plot_calls().items() if call is not None]


def test_plot_module_is_the_jax_packages():
    assert tp.DPI == jp.DPI == 600
    public = sorted(n for n in vars(jp) if n.endswith(("_plot", "_plots")))
    assert public == sorted(PLOTS)


@pytest.mark.parametrize("name", PLOTS)
def test_plot_writes_the_jax_packages_png(name, tmp_path, monkeypatch):
    monkeypatch.setattr(tp, "DPI", FIGURE_DPI)
    monkeypatch.setattr(jp, "DPI", FIGURE_DPI)
    args, kw = _plot_calls()[name]
    if name == "hyperparam_search_plots":
        got = tp.hyperparam_search_plots(*args, str(tmp_path / "t"), **kw)
        want = jp.hyperparam_search_plots(*args, str(tmp_path / "j"), **kw)
        assert [os.path.basename(p)[1:] for p in got] == \
            [os.path.basename(p)[1:] for p in want] == ["_2d.png", "_3d.png"]
        pairs = list(zip(got, want))
    else:
        got = getattr(tp, name)(*args, str(tmp_path / "t.png"), **kw)
        want = getattr(jp, name)(*args, str(tmp_path / "j.png"), **kw)
        pairs = [(got, want)]
    for g, w in pairs:
        _same_image(g, w)


def _hide_matplotlib(monkeypatch):
    for mod in [m for m in sys.modules if m.split(".")[0] in ("matplotlib", "PIL")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "PIL", None)


def test_available_without_matplotlib(monkeypatch):
    assert tp.available()
    _hide_matplotlib(monkeypatch)
    assert not tp.available()
    with pytest.raises(ImportError):
        tp.loss_curve_plot(np.ones((2, 3)), "x.png")


# --- the pipelines' artifact sets ------------------------------------------

CLS_MODELS = ("knn", "logreg", "rf", "gb", "mlp")


def _cls_files(fp_kind="maccs", models=CLS_MODELS):
    """What ``bbbp_tpu/train/classification.py:372-460`` writes for an
    untuned run of ``models`` with learning curves."""
    forest = next(m for m in ("rf", "gb", "xgb", "cat") if m in models)
    other = next(m for m in ("mlp", "knn", "logreg", "svc", "bnb") if m in models)
    figures = ({f"performance_{fp_kind}.png", "confusion_stacking.png",
                f"shap_{forest}.png", f"shap_dependence_{forest}.png",
                f"shap_kernel_{other}.png", f"shap_kernel_dependence_{other}.png"}
               | {f"{m}_learning_curve.png" for m in models})
    data = ({f"model_performance_metrics_{fp_kind}.csv", "fitted_models.pkl"}
            | {f"{m}_learning_scores.csv" for m in models})
    return figures, data


def _run_classification(out_dir, monkeypatch):
    from bbbp_tpu_torch.testing import classification_inputs
    from bbbp_tpu_torch.train import classification as tc
    from tests.test_torch_pipelines import _patch

    _patch(monkeypatch)
    x, y = classification_inputs(600)
    cfg = tc.ClassificationTrainConfig(pca_dim=PCA_DIM, tune=False,
                                       models=CLS_MODELS, out_dir=str(out_dir))
    return tc.run_classification(cfg, x, y, verbose=False, device="cpu")


def test_classification_writes_the_jax_packages_files(tmp_path, monkeypatch, capsys):
    _run_classification(tmp_path, monkeypatch)
    figures, data = _cls_files()
    assert set(os.listdir(tmp_path)) == figures | data
    out = capsys.readouterr().out
    assert "FAILED" not in out and "does not import" not in out


def test_classification_without_matplotlib(tmp_path, monkeypatch, capsys):
    _hide_matplotlib(monkeypatch)
    _run_classification(tmp_path, monkeypatch)
    figures, data = _cls_files()
    assert set(os.listdir(tmp_path)) == data
    lines = [l for l in capsys.readouterr().out.splitlines() if "does not import" in l]
    assert len(lines) == 1 and all(f in lines[0] for f in figures)


def _run_baseline(out_dir, monkeypatch):
    from bbbp_tpu_torch.train import baseline as tbase
    from bbbp_tpu_torch.train import classification as tc
    from tests.test_torch_pipelines import _stand_in_b3db

    _stand_in_b3db(monkeypatch, 200, 5)
    monkeypatch.setattr(tbase, "default_zoo", lambda seed, device: {
        m: f for m, f in tc.default_zoo(seed, device).items() if m in ("knn", "bnb")})
    return tbase.run_baseline(tbase.BaselineConfig(
        fp_kind="maccs", pca_dim=PCA_DIM, out_dir=str(out_dir), tune=False),
        verbose=False, device="cpu")


BASELINE_FIGURES = {"knn_learning_curve.png", "bnb_learning_curve.png",
                    "performance_maccs.png"}
BASELINE_DATA = {"knn_model.pkl", "bnb_model.pkl", "knn_learning_scores.csv",
                 "bnb_learning_scores.csv", "model_performance_metrics_maccs.csv"}


def test_baseline_writes_the_jax_packages_files(tmp_path, monkeypatch):
    _run_baseline(tmp_path, monkeypatch)
    assert set(os.listdir(tmp_path)) == BASELINE_FIGURES | BASELINE_DATA


def test_baseline_without_matplotlib(tmp_path, monkeypatch, capsys):
    _hide_matplotlib(monkeypatch)
    _run_baseline(tmp_path, monkeypatch)
    assert set(os.listdir(tmp_path)) == BASELINE_DATA
    lines = [l for l in capsys.readouterr().out.splitlines() if "does not import" in l]
    assert len(lines) == 1 and all(f in lines[0] for f in BASELINE_FIGURES)


def _run_regression(out_dir):
    from bbbp_tpu_torch.train import regression as R
    from tests.test_torch_regression import SMALL, _tiny_processed

    return R.run_regression(R.RegressionTrainConfig(**SMALL, out_dir=str(out_dir)),
                            data=_tiny_processed(), verbose=False, device="cpu")


REG_DATA = {"regression_metrics.csv", "oof_predictions.pkl", "nn_checkpoint"}


def test_regression_writes_the_jax_packages_files(tmp_path):
    res = _run_regression(tmp_path)
    r2, mse = res.report["stacked"]["r2"], res.report["stacked"]["mse"]
    figures = {"nn_loss_curves.png", "prediction_distribution.png",
               f"stacked_predict_r2_{r2:.4f}_MSE_{mse:.4f}.png"}
    assert set(os.listdir(tmp_path)) == figures | REG_DATA


def test_regression_without_matplotlib(tmp_path, monkeypatch, capsys):
    _hide_matplotlib(monkeypatch)
    _run_regression(tmp_path)
    assert set(os.listdir(tmp_path)) == REG_DATA
    lines = [l for l in capsys.readouterr().out.splitlines() if "does not import" in l]
    assert len(lines) == 1 and "nn_loss_curves.png" in lines[0] \
        and "stacked_predict_r2_" in lines[0]
