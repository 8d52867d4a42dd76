"""Port parity: the classification ensemble end to end
(bbbp_tpu_torch.train.classification against bbbp_tpu.train.classification
on the CPU), at toy size: the MACCS rows of 600 labelled molecules
(``testing.classification_inputs``), PCA 8, both protocols.

Both packages' forest classes are patched, in their classification
modules only, to at most 16 trees of depth at most 4 (the JAX package
compiles every forest shape), and their MLPs to 200 Adam steps, before the
two runs part (test_torch_linear.py); the port's MLP starts from the JAX
package's initial parameters. Tolerances (what was seen in brackets, with
one and with eight torch threads):

- knn, logreg, svc, bnb: every test probability within 1e-4 (6.0e-7) and
  every metric of their reports within 1e-6 (0);
- the MLP: probabilities within 1e-3 (4.0e-4: its inputs, the two
  packages' PCA projections, differ by up to 6e-5), accuracy within two
  test rows (0), ROC AUC within 0.01 (0);
- dt, gb, cat (subsample 1, colsample 1) grow the JAX package's trees on
  the same rows (``test_torch_search.py``), but those PCA differences can
  turn a near tie of two splits: accuracy and ROC AUC within 0.03 (equal
  under the reference protocol; under the honest one dt 1 and gb 2 test
  rows apart, ROC AUC 0.013 / 0.014);
- stacking and voting read the random forest's and xgb's probabilities,
  drawn from another random stream than JAX's (16 trees: rf alone 0.026
  apart in accuracy and 0.058 in ROC AUC): accuracy and ROC AUC within
  0.05 (0.025 / 0.010).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from bbbp_tpu.ops import linear as jl  # noqa: E402
from bbbp_tpu.train import classification as jc  # noqa: E402
from bbbp_tpu_torch.models.convert import mlp_from_jax  # noqa: E402
from bbbp_tpu_torch.ops import linear as tl  # noqa: E402
from bbbp_tpu_torch.testing import classification_inputs  # noqa: E402
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
MLP_STEPS = 200
DETERMINISTIC = ("knn", "logreg", "svc", "bnb")
NEAR_TIE_FORESTS = ("dt", "gb", "cat")
PROBA_TOL, REPORT_TOL = 1e-4, 1e-6
MLP_PROBA_TOL, MLP_AUC_TOL = 1e-3, 0.01
NEAR_TIE_TOL, ENSEMBLE_TOL = 0.03, 0.05


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


class _Short:
    def __init__(self, n_steps=500, **kw):
        super().__init__(n_steps=min(n_steps, MLP_STEPS), **kw)


class JaxMLP(_Short, jc.MLPClassifier):
    pass


class PortMLP(_Short, tc.MLPClassifier):
    pass


def _patch(mp):
    for mod, gbdt, forest, mlp in ((jc, JaxGBDT, JaxForest, JaxMLP),
                                   (tc, PortGBDT, PortForest, PortMLP)):
        mp.setattr(mod, "GBDTClassifier", gbdt)
        mp.setattr(mod, "RandomForestClassifier", forest)
        mp.setattr(mod, "MLPClassifier", mlp)
    mp.setattr(tl, "init_mlp", lambda dims, seed: mlp_from_jax(
        jl._init_mlp(jax.random.PRNGKey(seed), tuple(dims))))


@pytest.fixture(scope="module")
def inputs():
    return classification_inputs(N_MOLECULES)


@pytest.fixture(scope="module", params=["reference", "honest"])
def runs(request, inputs):
    x, y = inputs
    kw = dict(pca_dim=PCA_DIM, tune=False, protocol=request.param)
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp)
        want = jc.run_classification(jc.ClassificationTrainConfig(**kw), x, y,
                                     verbose=False)
        got = tc.run_classification(tc.ClassificationTrainConfig(**kw), x, y,
                                    verbose=False, device="cpu")
    return want, got


def test_split_and_report_layout_equal_jax(runs):
    want, got = runs
    assert np.array_equal(got.y_test, want.y_test)     # same resampled split
    assert list(got.report) == list(want.report)
    assert all(list(got.report[m]) == list(want.report[m]) for m in want.report)
    assert set(got.stage_s) >= {"preprocess", "resample", "finals", "voting",
                                *(f"fit_{m}" for m in tc.default_zoo())}


@pytest.mark.parametrize("model", DETERMINISTIC)
def test_deterministic_models_equal_jax(runs, model):
    want, got = runs
    np.testing.assert_allclose(got.proba_test[model], want.proba_test[model],
                               rtol=0, atol=PROBA_TOL)
    for k, v in want.report[model].items():
        assert abs(got.report[model][k] - v) <= REPORT_TOL, (k, got.report[model])


def test_mlp_equals_jax(runs):
    want, got = runs
    n = len(want.y_test)
    assert np.abs(got.proba_test["mlp"] - want.proba_test["mlp"]).max() <= MLP_PROBA_TOL
    assert abs(got.report["mlp"]["accuracy"] - want.report["mlp"]["accuracy"]) \
        <= 2 / n
    assert abs(got.report["mlp"]["roc_auc"] - want.report["mlp"]["roc_auc"]) \
        <= MLP_AUC_TOL


@pytest.mark.parametrize("model", NEAR_TIE_FORESTS + ("stacking", "voting"))
def test_forests_and_ensembles_equal_jax_statistically(runs, model):
    want, got = runs
    tol = NEAR_TIE_TOL if model in NEAR_TIE_FORESTS else ENSEMBLE_TOL
    for k in ("accuracy", "roc_auc"):
        assert abs(got.report[model][k] - want.report[model][k]) <= tol, \
            (k, got.report[model], want.report[model])
    assert got.report[model]["roc_auc"] > 0.55           # it learned


def test_run_classification_refuses_cuda_without_a_card(monkeypatch, inputs):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.run_classification(tc.ClassificationTrainConfig(tune=False), *inputs)


def test_classification_inputs_are_the_jax_featurizers_maccs():
    from bbbp_tpu.chem.featurize import fingerprints
    from bbbp_tpu_torch.testing import labelled_training_set

    smiles, labels = labelled_training_set(300)
    x, y = classification_inputs(300)
    assert x.shape == (300, 167) and x.dtype == np.float32
    assert np.array_equal(y, labels) and 0.6 < y.mean() < 0.7
    assert np.array_equal(x, fingerprints(smiles, kind="maccs").features)


def test_reference_script_feeds_the_same_rows():
    """``classification_reference.py`` (the JAX package's run behind
    chip_smoke's learning check) makes these rows with the JAX package."""
    import classification_reference as ref

    x, y = classification_inputs(300)
    xr, yr = ref.inputs(300)
    assert np.array_equal(x, xr) and np.array_equal(y, yr)
