"""The port's regression stack (``bbbp_tpu_torch/train/regression.py``)
against the JAX package's (``bbbp_tpu/train/regression.py``) on the CPU, on
a 72-row ``ProcessedData`` made from a seed (the port's copy of
``tests/test_round3.py::_tiny_processed``; the JAX side is built by that
function, imported).

- ``run_regression`` under ``honest``, ``strict`` and ``compat`` in both
  packages (3 folds; forests of 8–30 trees): the same report keys; the
  deterministic legs (knn, ridge, tknn, tkrr, ckrr) within 1e-4; gbdt and
  cat with ``subsample=colsample=1`` within 1e-5 (their fits grow the same
  trees; a near tie that turned a split would show as a larger gap, and
  none does here); the NN leg and the random forest, whose random streams
  differ, by their OOF R² (within 0.1 and 0.06; the port's NN spreads
  0.27-0.37 over seeds on this set). The graph leg's statistical hold is
  in ``tests/test_torch_gnn.py``.
- The helpers on the same numpy: ``_tree_features_strict`` within 3e-4 of
  the blocks' scale, ``_fold_affine_from`` bit-equal, ``_crossfit_stack``
  within 1e-4, ``_reference_stack_meta`` by R² within 0.05.
- The port alone: the resumed checkpoint is bit-identical, a restored deep
  leg skips training, tree seeds average, ``strict`` ignores
  ``kernel_n_folds``, ``fp_tree_legs`` adds its column, the CLI, and the
  legs not ported yet raise ``NotImplementedError``.

The JAX package's three runs compile their own closures (~10-30 s of XLA
each on this CPU), so ``jax_runs`` starts them together in threads.
"""

import functools
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu.train import regression as JR  # noqa: E402
from bbbp_tpu_torch.pipelines.preprocess import PreprocessConfig, ProcessedData  # noqa: E402
from bbbp_tpu_torch.train import regression as R  # noqa: E402
from tests.test_round3 import _tiny_processed as jax_tiny_processed  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tiny_processed(n=72, d_fp=24, img=8, seed=0):
    """The port's ``ProcessedData`` of ``tests/test_round3.py::_tiny_processed``:
    the same draws, the port's classes."""
    rng = np.random.default_rng(seed)
    fp = rng.normal(size=(n, d_fp)).astype(np.float32)
    im = rng.normal(size=(n, img * img * 3)).astype(np.float32)
    y = (fp[:, 0] - fp[:, 1] + 0.1 * rng.normal(size=n)).astype(np.float32)
    pca = rng.normal(size=(n, 5)).astype(np.float32)
    return ProcessedData(
        smiles=["C"] * n, y=y, fp_norm=fp, img_norm=im, fp_pca=pca,
        img_pca=pca.copy(), interactions=None, outliers=np.zeros(n, bool),
        numbers=np.arange(n), config=PreprocessConfig(image_size=img),
        desc_norm=None, aux_fp_pca=None, fp_raw=fp, img_raw=im,
        desc_raw=None, aux_fp_raw=None)


TINY = dict(n_folds=3, epochs=10, batch_size=8, lr=1e-3, nn_seeds=1, graph_leg=False,
            snapshot_from=None, image_size=8, workers=1, tree_seeds=3,
            rf_trees=30, rf_depth=6, gbdt_trees=8, cat_trees=8,
            gbdt_subsample=1.0, cat_subsample=1.0)
DETERMINISTIC = {"knn": 1e-4, "ridge": 1e-4, "tknn": 1e-4, "tkrr": 1e-4,
                 "ckrr": 1e-4, "gbdt": 1e-5, "cat": 1e-5}
STATISTICAL = {"nn": 0.1, "rf": 0.06}
PROTOCOLS = ("honest", "strict", "compat")
# compat's meta_refstack diagnostic fits 3 x 6 forests of 300 trees of depth
# 10 (minutes on this CPU); both packages' are cut to 8 trees of depth 4 here
REFSTACK_CUT = dict(n_estimators=8, depth=4)


def _r2(y, pred):
    return 1.0 - float(((y - pred) ** 2).sum() / ((y - y.mean()) ** 2).sum())


def test_tiny_processed_equals_the_jax_packages():
    want, got = jax_tiny_processed(), _tiny_processed()
    for name in ("y", "fp_norm", "img_norm", "fp_pca", "img_pca", "fp_raw",
                 "img_raw", "numbers"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert got.smiles == want.smiles and got.config.image_size == 8


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's run_regression under each protocol, in threads."""
    cut = functools.partial(JR._reference_stack_meta, **REFSTACK_CUT)
    orig = JR._reference_stack_meta
    JR._reference_stack_meta = cut
    try:
        with ThreadPoolExecutor(len(PROTOCOLS)) as pool:
            futures = {p: pool.submit(JR.run_regression, JR.RegressionTrainConfig(
                protocol=p, **TINY), data=jax_tiny_processed(), verbose=False)
                for p in PROTOCOLS}
            return {p: f.result() for p, f in futures.items()}
    finally:
        JR._reference_stack_meta = orig


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_run_regression_equals_jax(protocol, jax_runs, monkeypatch):
    monkeypatch.setattr(R, "_reference_stack_meta", functools.partial(
        R._reference_stack_meta, **REFSTACK_CUT))
    want = jax_runs[protocol]
    got = R.run_regression(R.RegressionTrainConfig(protocol=protocol, **TINY),
                           data=_tiny_processed(), verbose=False, device="cpu")
    assert set(got.report) == set(want.report)
    assert list(got.oof) == list(want.oof)
    assert ("meta_refstack" in got.report) == (protocol == "compat")
    for leg, tol in DETERMINISTIC.items():
        err = float(np.abs(got.oof[leg] - want.oof[leg]).max())
        assert err <= tol, (leg, err)
    y = want.y
    for leg, tol in STATISTICAL.items():
        assert abs(_r2(y, got.oof[leg]) - _r2(y, want.oof[leg])) <= tol, leg
    assert _r2(y, want.oof["nn"]) > 0.15 and _r2(y, want.oof["rf"]) > 0.5
    for k, r in got.report.items():
        assert np.isfinite(r["r2"]), k
    assert abs(got.report["stacked"]["r2"] - want.report["stacked"]["r2"]) <= 0.05
    assert {"nn", "trees", "kernels", "stacking"} <= set(got.stage_s)


def _strict_data():
    d = _tiny_processed()
    rng = np.random.default_rng(5)
    d.desc_raw = rng.normal(size=(72, 6)).astype(np.float32)
    d.aux_fp_raw = {"rdkit": (rng.random((72, 40)) < 0.3).astype(np.float32)}
    return d


def test_tree_features_strict_equals_jax():
    d = _strict_data()
    folds = R.kfold_indices(72, 3, 0)
    want = JR._tree_features_strict(d, folds, 5, 10)
    got = R._tree_features_strict(d, folds, 5, 10, device="cpu")
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.shape == b.shape == (72, 6 + 24 + 5 + 5 + 10)
        assert float(np.abs(a - b).max()) <= 3e-4 * max(1.0, float(np.abs(b).max()))


def test_fold_affine_from_bit_equal():
    d = _tiny_processed()
    folds = R.kfold_indices(72, 3, 0)
    img = d.img_raw.reshape(72, 8, 8, 3)
    img[:, 0, 0, :] = 0.5                         # a constant pixel: inv 1
    want = JR._fold_affine_from([d.fp_raw, img, None], folds, 3)
    got = R._fold_affine_from([d.fp_raw, img, None], folds, 3)
    assert got[2] is None and want[2] is None
    for a, b in zip(got[:2], want[:2]):
        for u, v in zip(a, b):
            assert u.shape == v.shape and np.array_equal(u, v)
    assert (got[1][1][:, 0, 0, :] == 1.0).all()


def test_crossfit_stack_equals_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(90, 6)).astype(np.float32)
    y = (x @ rng.normal(size=6) + 0.2 * rng.normal(size=90)).astype(np.float32)
    folds = R.kfold_indices(90, 5, 1)
    from bbbp_tpu.ops.linear import LinearRegression as JaxLinear

    want = JR._crossfit_stack(x, y, folds, JaxLinear)
    got = R._crossfit_stack(x, y, folds, R.meta_learners("cpu")["linear"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_reference_stack_meta_learns_as_jax():
    """The forest stack over a 6-leg OOF matrix (30 trees of depth 4; the
    random forest's stream differs): in-sample R² within 0.05."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(120, 6)).astype(np.float32)
    y = (x[:, 0] + np.sin(2 * x[:, 1]) + 0.2 * rng.normal(size=120)).astype(np.float32)
    want = JR._reference_stack_meta(x, y, 7, n_estimators=30, depth=4)
    got = R._reference_stack_meta(x, y, 7, n_estimators=30, depth=4, device="cpu")
    assert got.shape == (120,)
    assert abs(_r2(y, got) - _r2(y, want)) <= 0.05


SMALL = dict(protocol="honest", n_folds=3, epochs=2, nn_seeds=1, graph_leg=False,
             tree_seeds=1, snapshot_from=None, rf_trees=8, rf_depth=4,
             gbdt_trees=8, cat_trees=8, image_size=8, workers=1)


def test_interrupted_tree_stage_resumes_bit_identical(tmp_path, monkeypatch):
    """Kill the tree stage mid-fold, rerun: bit-identical OOF columns against
    an uninterrupted run, and the checkpoint removed at the end (as
    tests/test_round5.py holds the JAX package's)."""
    common = dict(SMALL, split_repeats=2)
    d = _tiny_processed()
    ref = R.run_regression(R.RegressionTrainConfig(out_dir=str(tmp_path / "ref"),
                                                   **common),
                           data=d, verbose=False, device="cpu")
    calls = {"n": 0}
    orig = R.GBDTRegressor.fit

    def dying_fit(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] > 4:
            raise RuntimeError("injected worker wedge")
        return orig(self, *a, **kw)

    out = str(tmp_path / "resume")
    monkeypatch.setattr(R.GBDTRegressor, "fit", dying_fit)
    with pytest.raises(RuntimeError, match="injected"):
        R.run_regression(R.RegressionTrainConfig(out_dir=out, **common),
                         data=d, verbose=False, device="cpu")
    monkeypatch.setattr(R.GBDTRegressor, "fit", orig)
    assert os.path.exists(os.path.join(out, "tree_ckpt.pkl"))
    res = R.run_regression(R.RegressionTrainConfig(out_dir=out, **common),
                           data=d, verbose=True, device="cpu")
    for m in ("rf", "gbdt", "cat", "knn", "ridge", "tknn", "tkrr", "ckrr"):
        np.testing.assert_array_equal(res.oof[m], ref.oof[m], err_msg=m)
    assert not os.path.exists(os.path.join(out, "tree_ckpt.pkl"))
    # the artifact set (the figures and the NN checkpoint since they are
    # ported), and no tree-stage checkpoint left beside it
    r2, mse = res.report["stacked"]["r2"], res.report["stacked"]["mse"]
    assert sorted(os.listdir(out)) == sorted([
        "nn_checkpoint", "oof_predictions.pkl", "regression_metrics.csv",
        "nn_loss_curves.png", "prediction_distribution.png",
        f"stacked_predict_r2_{r2:.4f}_MSE_{mse:.4f}.png"])
    with open(os.path.join(out, "oof_predictions.pkl"), "rb") as f:
        payload = pickle.load(f)
    np.testing.assert_array_equal(payload["stacked"], res.stacked_pred)


def test_deep_leg_restored_from_checkpoint(tmp_path, monkeypatch):
    """A retry after a tree-stage wedge does not retrain the graph leg: its
    column comes from the checkpoint (a poisoned MPNN proves it) and equals
    the uninterrupted run's."""
    import bbbp_tpu_torch.models.gnn as gnn

    common = dict(SMALL, graph_leg=True, graph_epochs=2, graph_hidden=8,
                  graph_layers=1, graph_seeds=1, max_atoms=16)
    d = _tiny_processed()
    ref = R.run_regression(R.RegressionTrainConfig(out_dir=str(tmp_path / "ref"),
                                                   **common),
                           data=d, verbose=False, device="cpu")
    calls = {"n": 0}
    orig = R.GBDTRegressor.fit

    def dying_fit(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] > 2:
            raise RuntimeError("injected worker wedge")
        return orig(self, *a, **kw)

    out = str(tmp_path / "resume")
    monkeypatch.setattr(R.GBDTRegressor, "fit", dying_fit)
    with pytest.raises(RuntimeError, match="injected"):
        R.run_regression(R.RegressionTrainConfig(out_dir=out, **common),
                         data=d, verbose=False, device="cpu")
    monkeypatch.setattr(R.GBDTRegressor, "fit", orig)
    assert os.path.exists(os.path.join(out, "tree_ckpt.pkl"))

    def poisoned_init(self, *a, **kw):  # noqa: ARG001
        raise AssertionError("graph leg retrained despite ckpt")

    monkeypatch.setattr(gnn.MPNNRegressor, "__init__", poisoned_init)
    res = R.run_regression(R.RegressionTrainConfig(out_dir=out, **common),
                           data=d, verbose=False, device="cpu")
    np.testing.assert_array_equal(res.oof["graph"], ref.oof["graph"])
    np.testing.assert_array_equal(res.oof["rf"], ref.oof["rf"])


def test_stale_checkpoint_ignored(tmp_path):
    """A checkpoint written under another config is ignored, not merged."""
    out = str(tmp_path)
    with open(os.path.join(out, "tree_ckpt.pkl"), "wb") as f:
        pickle.dump({"key": "another run", "state": {
            "cells": {(0, 0)}, "oof_r": {}, "legs": {"graph": None},
            "reps_done": set()}}, f)
    ref = R.run_regression(R.RegressionTrainConfig(**SMALL), data=_tiny_processed(),
                           verbose=False, device="cpu")
    res = R.run_regression(R.RegressionTrainConfig(out_dir=out, **SMALL),
                           data=_tiny_processed(), verbose=False, device="cpu")
    np.testing.assert_array_equal(res.oof["gbdt"], ref.oof["gbdt"])


def test_tree_seeds_average_not_sum():
    """With tree_seeds > 1 the forest columns stay on the label's scale."""
    d = _tiny_processed()
    r1 = R.run_regression(R.RegressionTrainConfig(**SMALL), data=d,
                          verbose=False, device="cpu")
    r2 = R.run_regression(R.RegressionTrainConfig(**dict(SMALL, tree_seeds=2)),
                          data=d, verbose=False, device="cpu")
    for m in ("rf", "gbdt", "cat"):
        assert np.abs(r2.oof[m]).mean() < 1.5 * np.abs(r1.oof[m]).mean() + 1e-3, m
    # the per-seed columns enter meta_perseed
    assert "meta_perseed" in r2.report and "meta_perseed" not in r1.report


def test_strict_ignores_kernel_n_folds():
    d = _tiny_processed()
    base = dict(SMALL, protocol="strict")
    plain = R.run_regression(R.RegressionTrainConfig(**base), data=d,
                             verbose=False, device="cpu")
    fine = R.run_regression(R.RegressionTrainConfig(**base, kernel_n_folds=8),
                            data=d, verbose=False, device="cpu")
    for m in ("tkrr", "ckrr"):
        np.testing.assert_array_equal(fine.oof[m], plain.oof[m], err_msg=m)
    honest = R.run_regression(R.RegressionTrainConfig(**SMALL, kernel_n_folds=8),
                              data=d, verbose=False, device="cpu")
    assert np.isfinite(honest.oof["tkrr"]).all()


def test_fp_tree_legs_add_their_column():
    cfg = R.RegressionTrainConfig(**dict(SMALL, gbdt_trees=2),
                                  fp_tree_legs=("morgan",))
    res = R.run_regression(cfg,
                           data=_tiny_processed(), verbose=False, device="cpu")
    assert "gbdt_morgan" in res.oof and "gbdt_morgan" in res.report
    assert np.isfinite(res.oof["gbdt_morgan"]).all()


@pytest.mark.parametrize("field,value", [("bert_leg", True),
                                         ("nn_pretrained", "trunk.pkl"),
                                         ("graph_pretrained", "trunk.pkl")])
def test_legs_not_ported_raise(field, value):
    """Each of the three options is taken: it reads its artifact (here
    absent) and fails only for want of it (``FileNotFoundError``). The
    name is what the test held before the SMILES encoder and aux
    pretraining were ported (each option raised ``NotImplementedError``);
    it stays, so that a run can be compared test by test with earlier
    ones."""
    cfg = R.RegressionTrainConfig(**dict(SMALL, graph_leg=True,
                                         bert_pretrained_dir="absent_dir"),
                                  **{field: value})
    with pytest.raises(FileNotFoundError, match="trunk.pkl|absent_dir"):
        R.run_regression(cfg, data=_tiny_processed(), device="cpu")


def test_run_regression_on_cuda_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        R.run_regression(R.RegressionTrainConfig(**SMALL), data=_tiny_processed())


def test_cli_help():
    proc = subprocess.run([sys.executable, "-m", "bbbp_tpu_torch.train.regression",
                           "--help"], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "--protocol" in proc.stdout


def test_cli_tiny_run_on_cpu(tmp_path, monkeypatch, capsys):
    """``main()`` with ``--device cpu`` over a B3DB TSV of 30 molecules in
    ``$BBBP_B3DB_DIR``, the config's widths cut (images 16 px, forests of 4
    trees, one MPNN epoch) by a stand-in for ``RegressionTrainConfig``."""
    from bbbp_tpu_torch.testing import regression_molecules, write_regression_tsv

    smiles, y = regression_molecules(30)
    write_regression_tsv(str(tmp_path / "B3DB_regression.tsv"), smiles, y)
    monkeypatch.setenv("BBBP_B3DB_DIR", str(tmp_path))
    monkeypatch.setattr(R, "RegressionTrainConfig", functools.partial(
        R.RegressionTrainConfig, image_size=16, rf_trees=4, rf_depth=3,
        gbdt_trees=4, cat_trees=4, graph_epochs=1, graph_hidden=8,
        graph_layers=1, max_atoms=32, snapshot_from=None))
    out = tmp_path / "report.json"
    monkeypatch.setattr(sys, "argv", [
        "regression", "--device", "cpu", "--folds", "2", "--epochs", "1",
        "--nn-seeds", "1", "--tree-seeds", "1", "--workers", "1",
        "--out", str(out), "--out-dir", str(tmp_path / "artifacts")])
    R.main()
    assert "does not import" not in capsys.readouterr().out
    import json

    with open(out) as f:
        report = json.load(f)
    assert {"nn", "graph", "rf", "stacked", "ckrr"} <= set(report)
    for name in ("regression_metrics.csv", "oof_predictions.pkl", "nn_checkpoint",
                 "nn_loss_curves.png", "prediction_distribution.png"):
        assert os.path.exists(tmp_path / "artifacts" / name), name


def test_reference_script_builds_phase_11s_rows(tmp_path):
    """``regression_reference.py`` makes ``regression_molecules()``'s
    molecules and target with the JAX package alone, writes the same TSV,
    and runs at ``chip_smoke.py``'s phase 11 cuts."""
    import chip_smoke
    import regression_reference
    from bbbp_tpu_torch.testing import regression_molecules, write_regression_tsv

    smiles, y = regression_molecules()
    ref_smiles, ref_y = regression_reference.molecules()
    assert ref_smiles == smiles and np.array_equal(ref_y, y)
    regression_reference.write_tsv(str(tmp_path / "a.tsv"), smiles, y)
    write_regression_tsv(str(tmp_path / "b.tsv"), smiles, y)
    assert (tmp_path / "a.tsv").read_text() == (tmp_path / "b.tsv").read_text()
    assert regression_reference.CUTS == chip_smoke.REG_CUTS


def test_fitted_transforms_run_with_tf32_off(monkeypatch):
    """Every PCA the strict protocol fits per fold, and every estimator's
    products, run with TF32 off, whatever the caller set; the caller's
    setting comes back afterwards (TF32 moves a PCA column by ~1e-3, enough
    to turn a tree's split)."""
    seen = []

    class SpyPCA(R.PCA):
        def fit(self, x):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return super().fit(x)

    monkeypatch.setattr(R, "PCA", SpyPCA)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    R.run_regression(R.RegressionTrainConfig(**dict(SMALL, protocol="strict")),
                     data=_strict_data(), verbose=False, device="cpu")
    assert len(seen) == 3 * 3 and not any(seen)
    assert torch.backends.cuda.matmul.allow_tf32


def test_transfer_leg_reads_its_cache(tmp_path, monkeypatch):
    """``transfer_leg`` trains the aux models on B3DB classification (a TSV
    in ``$BBBP_B3DB_DIR``), adds its calibration column, and a second run
    reads the columns from ``$BBBP_TRANSFER_CACHE`` without training (the
    cache's key names no device: the comment where ``run_regression`` reads
    it says so)."""
    from bbbp_tpu_torch.train import transfer as ttr
    from tests.test_torch_transfer import _aux

    smiles, labels = _aux()
    with open(tmp_path / "B3DB_classification.tsv", "w") as f:
        f.write("NO.\tSMILES\tBBB+/BBB-\tlogBB\tInchi\n")
        for i, (s, y) in enumerate(zip(smiles, labels)):
            f.write(f"{i + 1}\t{s}\t{'BBB+' if y else 'BBB-'}\t\t\n")
    with open(tmp_path / "B3DB_regression.tsv", "w") as f:
        f.write("NO.\tSMILES\tlogBB\tInchi\n1\tC\t0.1\t\n")
    monkeypatch.setenv("BBBP_B3DB_DIR", str(tmp_path))
    monkeypatch.setenv("BBBP_TRANSFER_CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(ttr, "TransferConfig", functools.partial(
        ttr.TransferConfig, trees=8, depth=3, rf_trees=8, rf_depth=3,
        morgan_pca_dim=8, tknn_k=5))
    cfg = R.RegressionTrainConfig(**SMALL, transfer_leg=True)
    first = R.run_regression(cfg, data=_tiny_processed(), verbose=False,
                             device="cpu")
    assert "transfer" in first.oof and "transfer_quality" in first.report
    assert len(os.listdir(tmp_path / "cache")) >= 1

    def poisoned(*a, **kw):  # noqa: ARG001
        raise AssertionError("aux models trained despite the cache")

    monkeypatch.setattr(ttr, "_make_model", poisoned)
    again = R.run_regression(cfg, data=_tiny_processed(), verbose=False,
                             device="cpu")
    np.testing.assert_array_equal(again.oof["transfer"], first.oof["transfer"])
