"""Port parity: evaluation metrics (bbbp_tpu_torch.ops.metrics against
bbbp_tpu.ops.metrics on the CPU), on labels and scores made from a seed.

Tolerance 1e-6 absolute: both compute in f32 from counts that are exact
integers; the rank statistic's sums run in another order (seen: 0)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu.ops import metrics as jm  # noqa: E402
from bbbp_tpu_torch.ops import metrics as tm  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's torch work is many small ops: one intra-op thread each,
    as the test workers share the machine's cores (OpenMP teams that
    outnumber the cores spin against each other)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = 1e-6
LABEL_METRICS = ("accuracy", "precision", "recall", "f1_score",
                 "balanced_accuracy", "mcc", "cohen_kappa")


def _labels(seed, n=257, share=0.6):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < share).astype(np.int32)
    # the prediction agrees with y on ~70% of rows
    pred = np.where(rng.random(n) < 0.7, y, 1 - y).astype(np.int32)
    return y, pred


@pytest.mark.parametrize("name", LABEL_METRICS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_label_metrics_equal_jax(name, seed):
    y, pred = _labels(seed)
    want = float(getattr(jm, name)(y, pred))
    got = getattr(tm, name)(y, pred)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert abs(float(got) - want) <= TOL


@pytest.mark.parametrize("name", LABEL_METRICS)
@pytest.mark.parametrize("case", ["all_negative_pred", "all_positive_pred",
                                  "one_class"])
def test_label_metrics_at_the_edges_equal_jax(name, case):
    """No positive predictions, no negative ones, and a single class: the
    1e-12 floors of the denominators decide."""
    y, pred = _labels(3, n=40)
    if case == "all_negative_pred":
        pred = np.zeros_like(pred)
    elif case == "all_positive_pred":
        pred = np.ones_like(pred)
    else:
        y = np.ones_like(y)
    assert abs(float(getattr(tm, name)(y, pred))
               - float(getattr(jm, name)(y, pred))) <= TOL


@pytest.mark.parametrize("decimals", [None, 1, 0])
def test_roc_auc_with_ties_equals_jax(decimals):
    """Continuous scores, scores rounded to tenths (many ties across both
    labels), and scores in {0, 1} (two tied groups)."""
    rng = np.random.default_rng(5)
    y = (rng.random(400) < 0.4).astype(np.int32)
    s = (0.3 * y + rng.random(400)).astype(np.float32)
    if decimals is not None:
        s = np.round(s, decimals).astype(np.float32)
    want = float(jm.roc_auc(y, s))
    assert abs(float(tm.roc_auc(y, s)) - want) <= TOL
    assert 0.5 < want < 1.0


def test_regression_metrics_equal_jax():
    rng = np.random.default_rng(7)
    y = rng.normal(size=300).astype(np.float32)
    pred = (y + 0.3 * rng.normal(size=300)).astype(np.float32)
    for name in ("mse", "r2_score"):
        assert abs(float(getattr(tm, name)(y, pred))
                   - float(getattr(jm, name)(y, pred))) <= TOL
    got, want = tm.regression_report(y, pred), jm.regression_report(y, pred)
    assert got.keys() == want.keys()
    assert all(isinstance(v, float) and abs(v - want[k]) <= TOL
               for k, v in got.items())


def test_classification_report_equals_jax():
    y, pred = _labels(11)
    score = np.where(pred == 1, 0.7, 0.3).astype(np.float32)
    got = tm.classification_report(y, pred, score)
    want = jm.classification_report(y, pred, score)
    assert list(got) == list(want)
    assert all(isinstance(v, float) and abs(v - want[k]) <= TOL
               for k, v in got.items())
    assert "roc_auc" not in tm.classification_report(y, pred)


def test_metrics_follow_the_tensors_device():
    """Tensor arguments keep their device; numpy lands on the CPU."""
    y, pred = _labels(2)
    out = tm.f1_score(torch.from_numpy(y), pred)
    assert out.device.type == "cpu"
    assert abs(float(out) - float(jm.f1_score(y, pred))) <= TOL
