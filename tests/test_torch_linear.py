"""Port parity: the classical zoo (bbbp_tpu_torch.ops.linear against
bbbp_tpu.ops.linear on the CPU), on data made from a seed.

Tolerances (what was seen in brackets):

- closed-form regressors: predictions within 1e-4 relative to their scale
  (1e-6);
- ``NonNegativeLinearRegression``, ``GaussianNB``, ``BernoulliNB``: copies of
  the numpy code, bit-equal;
- ``LogisticRegression`` (25 f32 Newton steps, a Cholesky against XLA's
  solve): probabilities within 1e-4 (2.4e-7);
- ``LinearSVC`` (400 Adam steps, then Platt scaling): within 1e-3 (1.8e-7);
- the MLP, started from JAX's initial parameters (``mlp_from_jax``): within
  1e-5 after 200 Adam steps (1.8e-7). Past ~300 steps the two runs part:
  where a gradient is near 0, Adam's step lr·m/(√v + ε) turns on the last
  bits of g, and the difference doubles every ~50 steps (800 steps, 600
  rows: 1.4e-3). At the zoo's 800 steps probabilities are held within 1e-2
  and predicted labels equal but for rows within 1e-2 of 0.5;
- kNN: the neighbours' labels equal, ties at the k-th place included (the
  lower index first, ``jax.lax.top_k``'s order).

The CUDA test at the end runs every estimator on the card against the CPU
with the same tolerances but for the MLP's (see its docstring); JAX is
imported by fixtures, so that it also runs where JAX is absent.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu_torch.models.convert import mlp_from_jax  # noqa: E402
from bbbp_tpu_torch.ops import linear as tl  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's torch work is many small ops: one intra-op thread each,
    as the test workers share the machine's cores (OpenMP teams that
    outnumber the cores spin against each other)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


REG_RTOL = 1e-4
LOGREG_TOL = 1e-4
SVC_TOL = 1e-3
MLP_TOL_EXACT, MLP_EXACT_STEPS = 1e-5, 200
MLP_TOL_CHAOTIC = 1e-2


@pytest.fixture(scope="module")
def jl():
    return pytest.importorskip("bbbp_tpu.ops.linear")


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data(seed, n=300, d=8, n_test=100):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d)
    y = (x @ w + 0.5 * rng.normal(size=n) > 0.3).astype(np.int32)
    t = (x @ w + 0.2 * rng.normal(size=n)).astype(np.float32)
    return x, y, t, rng.normal(size=(n_test, d)).astype(np.float32)


def _jax_init(jax, jl, monkeypatch):
    """The port's MLPs start from the JAX package's initial parameters."""
    monkeypatch.setattr(tl, "init_mlp", lambda dims, seed: mlp_from_jax(
        jl._init_mlp(jax.random.PRNGKey(seed), tuple(dims))))


@pytest.mark.parametrize("cls,kw", [("LinearRegression", {}),
                                    ("Ridge", {"alpha": 3.0}),
                                    ("LinearRegression", {"fit_intercept": False}),
                                    ("RidgeCV", {})])
def test_closed_form_regressors_equal_jax(jl, cls, kw):
    x, _, t, xt = _data(0)
    want = getattr(jl, cls)(**kw).fit(x, t).predict(xt)
    got = getattr(tl, cls)(device="cpu", **kw).fit(x, t).predict(xt)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=REG_RTOL * scale)
    if cls == "RidgeCV":
        assert getattr(tl, cls)(device="cpu").fit(x, t).alpha_ == \
            getattr(jl, cls)().fit(x, t).alpha_


def test_numpy_estimators_are_bit_equal(jl):
    x, y, t, xt = _data(1)
    legs = np.stack([t + 0.1 * i * x[:, i] for i in range(4)], axis=1)
    a, b = jl.NonNegativeLinearRegression().fit(legs, t), \
        tl.NonNegativeLinearRegression().fit(legs, t)
    assert np.array_equal(a.coef_, b.coef_) and a.intercept_ == b.intercept_
    assert np.array_equal(a.predict(legs), b.predict(legs))
    for cls, kw in (("GaussianNB", {}), ("BernoulliNB", {"alpha": 0.5})):
        a, b = getattr(jl, cls)(**kw).fit(x, y), getattr(tl, cls)(**kw).fit(x, y)
        assert np.array_equal(a.predict_proba(xt), b.predict_proba(xt))
        assert np.array_equal(a.predict(xt), b.predict(xt))


@pytest.mark.parametrize("C", [1.0, 0.01, 100.0])
def test_logistic_regression_equals_jax(jl, C):
    x, y, _, xt = _data(2)
    a = jl.LogisticRegression(C=C).fit(x, y)
    b = tl.LogisticRegression(C=C, device="cpu").fit(x, y)
    np.testing.assert_allclose(b.predict_proba(xt), a.predict_proba(xt),
                               rtol=0, atol=LOGREG_TOL)
    np.testing.assert_allclose(b.w_.numpy(), np.asarray(a.w_), rtol=0,
                               atol=LOGREG_TOL * np.abs(np.asarray(a.w_)).max())


@pytest.mark.parametrize("C", [1.0, 0.01, 100.0])
def test_linear_svc_equals_jax(jl, C):
    x, y, _, xt = _data(3)
    a = jl.LinearSVC(C=C).fit(x, y)
    b = tl.LinearSVC(C=C, device="cpu").fit(x, y)
    np.testing.assert_allclose(b.decision_function(xt), a.decision_function(xt),
                               rtol=0, atol=SVC_TOL)
    np.testing.assert_allclose(b.predict_proba(xt), a.predict_proba(xt),
                               rtol=0, atol=SVC_TOL)


def _near_half_ok(got, want, tol):
    """Labels equal, but for rows within ``tol`` of 0.5."""
    differ = (got > 0.5) != (want > 0.5)
    return not (differ & (np.abs(want - 0.5) > tol)).any()


@pytest.mark.parametrize("hidden,lr,l2", [((16, 8), 3e-3, 1e-4),
                                          ((32,), 1e-3, 0.0)])
def test_mlp_classifier_equals_jax(jl, jax, monkeypatch, hidden, lr, l2):
    x, y, _, xt = _data(4)
    _jax_init(jax, jl, monkeypatch)
    kw = dict(hidden=hidden, n_steps=MLP_EXACT_STEPS, seed=3, lr=lr, l2=l2)
    a = jl.MLPClassifier(**kw).fit(x, y)
    b = tl.MLPClassifier(device="cpu", **kw).fit(x, y)
    np.testing.assert_allclose(b.predict_proba(xt), a.predict_proba(xt),
                               rtol=0, atol=MLP_TOL_EXACT)
    for (wa, ba), (wb, bb) in zip(a.params_, b.params_):
        np.testing.assert_allclose(wb.numpy(), np.asarray(wa), rtol=0,
                                   atol=MLP_TOL_EXACT)


def test_mlp_at_the_zoo_steps_equals_jax_up_to_adam_drift(jl, jax, monkeypatch):
    """``default_zoo``'s MLP: hidden 128, 800 steps, lr 1e-3."""
    x, y, _, xt = _data(5, n=600)
    _jax_init(jax, jl, monkeypatch)
    kw = dict(hidden=(128,), n_steps=800, seed=42)
    want = jl.MLPClassifier(**kw).fit(x, y).predict_proba(xt)[:, 1]
    got = tl.MLPClassifier(device="cpu", **kw).fit(x, y).predict_proba(xt)[:, 1]
    assert np.abs(got - want).max() <= MLP_TOL_CHAOTIC
    assert _near_half_ok(got, want, MLP_TOL_CHAOTIC)


def test_mlp_regressor_equals_jax(jl, jax, monkeypatch):
    x, _, t, xt = _data(6)
    _jax_init(jax, jl, monkeypatch)
    kw = dict(hidden=(16,), n_steps=MLP_EXACT_STEPS, seed=1, lr=3e-3)
    want = jl.MLPRegressor(**kw).fit(x, t).predict(xt)
    got = tl.MLPRegressor(device="cpu", **kw).fit(x, t).predict(xt)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=MLP_TOL_EXACT * np.abs(want).max())


def test_mlp_from_jax_keeps_the_layout(jl, jax):
    params = jl._init_mlp(jax.random.PRNGKey(0), (5, 7, 1))
    got = mlp_from_jax(params)
    assert [tuple(w.shape) for w, _ in got] == [(5, 7), (7, 1)]
    assert all(np.array_equal(w.numpy(), np.asarray(a)) and
               np.array_equal(b.numpy(), np.asarray(c))
               for (w, b), (a, c) in zip(got, params))
    with pytest.raises(ValueError, match="chain"):
        mlp_from_jax([params[0], params[0]])
    with pytest.raises(ValueError, match="layer"):
        mlp_from_jax([(np.zeros((3, 2)), np.zeros(3))])


def test_init_mlp_is_he_normal_from_the_seed():
    a, b = tl.init_mlp((30, 128, 1), 7), tl.init_mlp((30, 128, 1), 7)
    assert all(torch.equal(p, q) for (p, _), (q, _) in zip(a, b))
    assert not torch.equal(a[0][0], tl.init_mlp((30, 128, 1), 8)[0][0])
    assert abs(float(a[0][0].std()) - np.sqrt(2 / 30)) < 0.02
    assert not a[0][1].any()


def _knn_tie_case():
    """Train rows: 12 exact copies of one point, half of each label, among
    random rows; queries at that point and near it, so the k-th place of a
    k = 5 / 7 search falls inside the tied group."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(200, 6)).astype(np.float32)
    y = (rng.random(200) < 0.5).astype(np.int32)
    dup = rng.choice(200, 12, replace=False)
    x[dup] = x[dup[0]]
    y[dup] = np.arange(12) % 2
    q = np.concatenate([x[dup[:1]], x[dup[:1]] + 1e-3,
                        rng.normal(size=(50, 6)).astype(np.float32)])
    return x, y, q


@pytest.mark.parametrize("k", [1, 5, 7, 15])
def test_knn_neighbor_labels_equal_jax_with_ties(jl, jax, k):
    x, y, q = _knn_tie_case()
    want = np.asarray(jl._knn_neighbor_labels(x, y, q, k))
    est = tl.KNeighborsClassifier(k, device="cpu").fit(x, y)
    assert np.array_equal(est._neighbor_labels(q), want)
    if k in (5, 7):        # the tie order decides: the other order differs
        tied = np.sort(np.nonzero((x == q[0]).all(1))[0])
        assert not np.array_equal(want[0], y[tied[::-1][:k]])
    np.testing.assert_array_equal(
        est.predict_proba(q), jl.KNeighborsClassifier(k).fit(x, y).predict_proba(q))
    xr, _, t, qr = _data(9)
    np.testing.assert_array_equal(
        tl.KNeighborsRegressor(k, device="cpu").fit(xr, t).predict(qr),
        jl.KNeighborsRegressor(k).fit(xr, t).predict(qr))


def test_estimators_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, _, _ = _data(0, n=20)
    for est in (tl.LogisticRegression(), tl.LinearSVC(), tl.MLPClassifier(),
                tl.KNeighborsClassifier(), tl.LinearRegression()):
        with pytest.raises(RuntimeError, match="CUDA"):
            est.fit(x, y)


@pytest.mark.cuda
def test_estimators_on_cuda_equal_cpu(cuda_device):
    """Every torch estimator fit on the card against the CPU (the MLPs from
    one ``init_mlp`` draw): the tolerances above, but for the MLP, whose two
    runs part the sooner the more rows (on an H100 at 8,162 rows: 6.7e-5
    after 200 steps, 0.077 after 800; ``chip_smoke.py`` phase 10): within
    1e-3 after 200 steps, and after 800 by what it learned, accuracy within
    1% and ROC AUC within 0.01."""
    from bbbp_tpu_torch.ops import metrics as tm

    x, y, t, xt = _data(10, n=2000, d=30, n_test=500)
    yt = (xt @ np.random.default_rng(10).normal(size=30) > 0).astype(np.int32)
    cases = [("LogisticRegression", {}, LOGREG_TOL),
             ("LinearSVC", {}, SVC_TOL),
             ("KNeighborsClassifier", {"n_neighbors": 5}, 0.0),
             ("MLPClassifier", {"hidden": (128,), "n_steps": MLP_EXACT_STEPS}, 1e-3)]
    for cls, kw, tol in cases:
        a = getattr(tl, cls)(device="cpu", **kw).fit(x, y)
        b = getattr(tl, cls)(device="cuda", **kw).fit(x, y)
        pa, pb = a.predict_proba(xt)[:, 1], b.predict_proba(xt)[:, 1]
        assert np.abs(pa - pb).max() <= tol, cls
        assert _near_half_ok(pb, pa, tol), cls
    kw = {"hidden": (128,), "n_steps": 800}
    pa = tl.MLPClassifier(device="cpu", **kw).fit(x, y).predict_proba(xt)[:, 1]
    pb = tl.MLPClassifier(device="cuda", **kw).fit(x, y).predict_proba(xt)[:, 1]
    assert abs(float(tm.accuracy(yt, pa > 0.5)) - float(tm.accuracy(yt, pb > 0.5))) <= 0.01
    assert abs(float(tm.roc_auc(yt, pa)) - float(tm.roc_auc(yt, pb))) <= 0.01
    for cls, kw in (("LinearRegression", {}), ("Ridge", {}), ("RidgeCV", {}),
                    ("KNeighborsRegressor", {"n_neighbors": 5}),
                    ("MLPRegressor", {"hidden": (64,), "n_steps": MLP_EXACT_STEPS})):
        a = getattr(tl, cls)(device="cpu", **kw).fit(x, t).predict(xt)
        b = getattr(tl, cls)(device="cuda", **kw).fit(x, t).predict(xt)
        np.testing.assert_allclose(b, a, rtol=0, atol=REG_RTOL * np.abs(a).max())
