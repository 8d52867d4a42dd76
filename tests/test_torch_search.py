"""Port parity: hyperparameter search (bbbp_tpu_torch.train.search,
.batched_search and .learning_curve against the JAX package's on the CPU),
and the metrics CSVs of bbbp_tpu_torch.reporting.metrics_io.

Tolerances:

- folds, sampled parameters, padded CV index arrays: bit-equal (numpy
  copies);
- a batched search's per-trial CV scores within two validation rows of the
  JAX package's, and the same winner. The MLP's lanes start from JAX's
  initial parameters (``init_mlp`` patched to the JAX package's
  ``fold_in(PRNGKey(0), trial)`` draw); forests count as deterministic at
  subsample 1 and colsample 1;
- subsampled, column-sampled and random-forest trials draw from another
  random stream than JAX's: their mean accuracy over 3 fold seeds within
  0.03 of the JAX package's.
"""

import csv

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bbbp_tpu.train import batched_search as jb  # noqa: E402
from bbbp_tpu.train import learning_curve as jlc  # noqa: E402
from bbbp_tpu.train import search as js  # noqa: E402
from bbbp_tpu.train.classification import DEFAULT_TRIALS, SEARCH_SPACES  # noqa: E402
from bbbp_tpu.reporting import metrics_io as jio  # noqa: E402
from bbbp_tpu_torch.models.convert import mlp_from_jax  # noqa: E402
from bbbp_tpu_torch.ops import linear as tl  # noqa: E402
from bbbp_tpu_torch.reporting import metrics_io as tio  # noqa: E402
from bbbp_tpu_torch.train import batched_search as tb  # noqa: E402
from bbbp_tpu_torch.train import learning_curve as tlc  # noqa: E402
from bbbp_tpu_torch.train import search as ts  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's torch work is many small ops: one intra-op thread each,
    as the test workers share the machine's cores (OpenMP teams that
    outnumber the cores spin against each other)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ROWS_TOL = 2                       # validation rows
STAT_TOL = 0.03


def _data(seed=0, n=300, d=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x @ rng.normal(size=d) + 0.5 * rng.normal(size=n) > 0.3).astype(np.int32)
    return x, y


def _jax_mlp_init(dims, seed):
    """``_mlp_fit_predict``'s initial parameters of trial ``seed``."""
    key = jax.random.fold_in(jax.random.PRNGKey(0), jnp.asarray(seed, jnp.int32))
    params = []
    for i in range(len(dims) - 1):
        key, k1 = jax.random.split(key)
        params.append((jax.random.normal(k1, (dims[i], dims[i + 1]))
                       * jnp.sqrt(2.0 / dims[i]), jnp.zeros(dims[i + 1])))
    return mlp_from_jax(params)


def _same_trials(want, got, n_rows):
    assert got.best_params == want.best_params
    assert abs(got.best_score - want.best_score) <= ROWS_TOL / n_rows
    assert [{k: v for k, v in t.items() if not k.startswith("mean_")}
            for t in got.trials] == \
        [{k: v for k, v in t.items() if not k.startswith("mean_")}
         for t in want.trials]
    for a, b in zip(want.trials, got.trials):
        for key in ("mean_accuracy", "mean_precision", "mean_f1"):
            assert abs(a[key] - b[key]) <= ROWS_TOL / n_rows, (key, a, b)


@pytest.mark.parametrize("n,k,seed", [(300, 5, 42), (101, 3, 0), (7, 3, 1)])
def test_folds_and_padding_equal_jax(n, k, seed):
    y = (np.random.default_rng(seed).random(n) < 0.35).astype(np.int32)
    want, got = js.stratified_kfold_indices(y, k, seed), \
        ts.stratified_kfold_indices(y, k, seed)
    assert all(np.array_equal(a, b) for a, b in zip(want, got))
    for a, b in zip(jb.padded_cv_arrays(n, want), tb.padded_cv_arrays(n, got)):
        assert np.array_equal(a, b)


def test_padded_train_sets_count_some_rows_twice():
    """A fault of the JAX package that the port keeps for parity: the
    shorter folds' train sets are padded with their own first rows, so a
    lane fit counts those rows twice."""
    y = np.zeros(302, np.int32)
    folds = ts.stratified_kfold_indices(y, 5, 0)
    tr_idx, _, _ = tb.padded_cv_arrays(len(y), folds)
    assert np.array_equal(tr_idx, jb.padded_cv_arrays(len(y), folds)[0])
    twice = [len(row) - len(np.unique(row)) for row in tr_idx]
    assert sorted(twice) == [0, 0, 0, 1, 1]      # folds of 61 rows leave 241


def test_sampled_params_equal_jax():
    for name, dists in SEARCH_SPACES.items():
        ra, rb = np.random.default_rng(3), np.random.default_rng(3)
        want = [js._sample_params(dists, ra) for _ in range(20)]
        assert [ts._sample_params(dists, rb) for _ in range(20)] == want, name


def test_masked_scores_equal_jax():
    rng = np.random.default_rng(1)
    proba = rng.random((3, 4, 25)).astype(np.float32)
    y = (rng.random((4, 25)) < 0.5).astype(np.float32)
    mask = (rng.random((4, 25)) < 0.8).astype(np.float32)
    got = tb._masked_scores(*(torch.from_numpy(a) for a in (proba, y, mask)))
    got_r2 = tb._masked_r2(*(torch.from_numpy(a) for a in (proba, y, mask)))
    for t in range(3):
        want = jb._masked_scores(proba[t], y, mask)
        want_r2 = jb._masked_r2(proba[t], y, mask)
        for g, w in zip(got, want):
            assert abs(float(g[t]) - float(w)) <= 1e-6
        for g, w in zip(got_r2, want_r2):
            assert abs(float(g[t]) - float(w)) <= 1e-6


@pytest.mark.parametrize("model,n_iter", [("logreg", 12), ("svc", 12),
                                          ("bnb", 12), ("knn", 12)])
def test_batched_random_search_equals_jax(model, n_iter):
    x, y = _data(2)
    x[:, 0] = np.abs(x[:, 0])                      # a column BernoulliNB sees as 1s
    kw = dict(n_iter=n_iter, cv=3, extra_trials=[DEFAULT_TRIALS[model]])
    want = jb.batched_random_search(model, x, y, SEARCH_SPACES[model], **kw)
    got = tb.batched_random_search(model, x, y, SEARCH_SPACES[model],
                                   device="cpu", **kw)
    _same_trials(want, got, len(y))


def test_batched_mlp_search_equals_jax(monkeypatch):
    """Two hidden groups (lanes grouped by shape), 200 steps."""
    monkeypatch.setattr(tb, "init_mlp", _jax_mlp_init)
    x, y = _data(3)
    space = {**SEARCH_SPACES["mlp"], "hidden": [(16,), (8, 4)], "n_steps": 200}
    kw = dict(n_iter=5, cv=3, extra_trials=[{**DEFAULT_TRIALS["mlp"],
                                             "hidden": (16,), "n_steps": 200}])
    want = jb.batched_random_search("mlp", x, y, space, **kw)
    got = tb.batched_random_search("mlp", x, y, space, device="cpu", **kw)
    assert len({t["hidden"] for t in got.trials}) == 2
    _same_trials(want, got, len(y))


def test_batched_grid_search_equals_jax():
    """f1 scoring (the baseline's), two repeats of the folds."""
    x, y = _data(4)
    grid = {"C": [0.01, 1.0, 100.0]}
    want = jb.batched_grid_search("svc", x, y, grid, cv=3, n_repeats=2)
    got = tb.batched_grid_search("svc", x, y, grid, cv=3, n_repeats=2,
                                 device="cpu")
    _same_trials(want, got, len(y))
    assert all(abs(a["repeat_std"] - b["repeat_std"]) <= 2 * ROWS_TOL / len(y)
               for a, b in zip(want.trials, got.trials))


DETERMINISTIC_FORESTS = {
    "dt": [{"n_estimators": 1, "learning_rate": 1.0, "max_depth": 8,
            "colsample": 1.0, "reg_lambda": 1.0}],
    "gb": [{"n_estimators": 6, "learning_rate": 0.3, "max_depth": 3,
            "subsample": 1.0}],
    "cat": [{"oblivious": True, "n_estimators": 6, "learning_rate": 0.3,
             "max_depth": 3, "reg_lambda": 2.0}],
}


@pytest.mark.parametrize("model", sorted(DETERMINISTIC_FORESTS))
def test_deterministic_forest_search_equals_jax(model):
    x, y = _data(5)
    grid = {k: [v] for k, v in DETERMINISTIC_FORESTS[model][0].items()}
    want = jb.batched_grid_search(model, x, y, grid, cv=3, scoring="accuracy")
    got = tb.batched_grid_search(model, x, y, grid, cv=3, scoring="accuracy",
                                 device="cpu")
    _same_trials(want, got, len(y))


@pytest.mark.parametrize("model,params", [
    ("rf", {"rf": True, "n_estimators": 8, "max_depth": 4, "colsample": 0.5,
            "reg_lambda": 1e-6}),
    ("xgb", {"n_estimators": 6, "learning_rate": 0.3, "max_depth": 3,
             "subsample": 0.8, "colsample": 0.8, "reg_lambda": 1.0})])
def test_stochastic_forest_search_learns_as_jax(model, params):
    """Mean CV accuracy over 3 fold seeds within 0.03."""
    x, y = _data(6)
    grid = {k: [v] for k, v in params.items()}
    kw = dict(cv=3, scoring="accuracy", n_repeats=3)
    want = jb.batched_grid_search(model, x, y, grid, **kw).best_score
    got = tb.batched_grid_search(model, x, y, grid, device="cpu", **kw).best_score
    assert abs(got - want) <= STAT_TOL, (got, want)
    assert got > max(y.mean(), 1 - y.mean())          # it learned


def test_forest_cv_seeds_each_fold_by_the_stated_rule(monkeypatch):
    """Fold k of trial t is fit with seed t * 131 + k."""
    seen = []
    real = tb.fit_forest

    def spy(*a, **kw):
        seen.append(kw["seed"])
        return real(*a, **kw)

    monkeypatch.setattr(tb, "fit_forest", spy)
    x, y = _data(7, n=60)
    tb.batched_grid_search("xgb", x, y, {"n_estimators": [2], "max_depth": [2],
                                         "learning_rate": [0.1, 0.2]},
                           cv=3, device="cpu")
    assert seen == [0, 1, 2, 131, 132, 133]


def _close_records(got, want, tol=1e-6):
    assert [list(t) for t in got] == [list(t) for t in want]
    for a, b in zip(got, want):
        assert all(a[k] == pytest.approx(b[k], abs=tol) for k in a), (a, b)


def test_sequential_searches_equal_jax():
    """RandomizedSearchCV (two scorings, refit on precision) and
    GridSearchCV over the port's estimators against the JAX package's."""
    from bbbp_tpu.ops import linear as jl

    x, y = _data(8, n=200)
    dists = {"C": {"low": 1e-2, "high": 1e2, "log": True}}
    want = js.RandomizedSearchCV(jl.LogisticRegression, dists, n_iter=4, cv=3,
                                 scoring=["accuracy", "precision"],
                                 refit="precision").fit(x, y)
    got = ts.RandomizedSearchCV(lambda: tl.LogisticRegression(device="cpu"),
                                dists, n_iter=4, cv=3,
                                scoring=["accuracy", "precision"],
                                refit="precision").fit(x, y)
    assert got.best_params == want.best_params
    _close_records(got.trials, want.trials)
    want = js.GridSearchCV(jl.KNeighborsClassifier, {"n_neighbors": [1, 5, 9]},
                           scoring="roc_auc").fit(x, y)
    got = ts.GridSearchCV(lambda: tl.KNeighborsClassifier(device="cpu"),
                          {"n_neighbors": [1, 5, 9]}, scoring="roc_auc").fit(x, y)
    assert got.best_params == want.best_params
    _close_records(got.trials, want.trials)


def test_learning_curve_equals_jax():
    from bbbp_tpu.ops import linear as jl

    x, y = _data(9, n=200)
    want = jlc.learning_curve(lambda: jl.LogisticRegression(C=0.5), x, y,
                              train_sizes=(0.25, 1.0), cv=3)
    got = tlc.learning_curve(lambda: tl.LogisticRegression(C=0.5, device="cpu"),
                             x, y, train_sizes=(0.25, 1.0), cv=3)
    assert np.array_equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_metrics_files_equal_jax(tmp_path):
    report = {"knn": {"accuracy": 0.8125, "roc_auc": 0.9}, "voting": {"f1": 0.5}}
    trials = [{"hidden": (64,), "lr": 1e-3, "mean_accuracy": 0.8},
              {"hidden": (8, 4), "lr": 3e-3, "mean_accuracy": 0.7}]
    for mod, tag in ((jio, "jax"), (tio, "port")):
        mod.write_metrics_csv(str(tmp_path / f"m_{tag}.csv"), report)
        mod.write_trials_csv(str(tmp_path / f"t_{tag}.csv"), trials)
        tlc.save_learning_scores_csv(str(tmp_path / f"l_{tag}.csv"), [10, 20],
                                     np.ones((2, 3)), np.zeros((2, 3))) \
            if tag == "port" else jlc.save_learning_scores_csv(
                str(tmp_path / f"l_{tag}.csv"), [10, 20], np.ones((2, 3)),
                np.zeros((2, 3)))
    for stem in ("m", "t", "l"):
        assert (tmp_path / f"{stem}_port.csv").read_text() == \
            (tmp_path / f"{stem}_jax.csv").read_text()
    assert tio.read_metrics_csv(str(tmp_path / "m_port.csv"))["knn"]["accuracy"] \
        == 0.8125
    with open(tmp_path / "t_port.csv") as f:
        assert next(csv.reader(f)) == ["hidden", "lr", "mean_accuracy"]
