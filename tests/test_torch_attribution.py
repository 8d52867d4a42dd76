"""The port's attribution (``bbbp_tpu_torch/reporting/attribution.py``,
``ops/forest.py::dense_to_tree_arrays``) against the JAX package's.

Inputs are made with numpy from a seed; the forests are fitted by the port
on the CPU (its plain versions) and loaded into the JAX package's
``DenseTreeEnsemble`` as they are. Tolerances:

- ``dense_to_tree_arrays``: equal arrays (the same numpy code on the same
  numbers);
- TreeSHAP (vectorised, per forest): rtol 1e-12 against the JAX package's
  (float64 arithmetic in the same order); the vectorised form against the
  literal Algorithm 2 rtol 1e-9, atol 1e-12, as ``tests/test_reporting.py``
  holds the JAX package's;
- additivity: base + scale · Σ(cover-weighted tree means) + Σφ equals the
  plain ``raw_predict`` margin within 1e-4 × max(1, |margin|) (f32
  thresholds and leaves, float64 sums);
- kernel SHAP: bit-equal (numpy, one seed, one numpy ``predict_fn``);
- integrated gradients: a linear model exact within 1e-4; ``tanh``
  complete within 5e-3 at 256 steps; the f32 regressor within 1e-4 of
  max(1, scale) of the JAX package's over ``model.apply`` (64 steps, both
  sum 64 gradients in f32).
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from bbbp_tpu.ops import forest_tpu as jft  # noqa: E402
from bbbp_tpu.reporting import attribution as ja  # noqa: E402
from bbbp_tpu_torch.ops.forest import (DenseTreeEnsemble,  # noqa: E402
                                       dense_to_tree_arrays, raw_predict)
from bbbp_tpu_torch.ops.forest_train import (GBDTClassifier,  # noqa: E402
                                             RandomForestClassifier)
from bbbp_tpu_torch.reporting import attribution as ta  # noqa: E402

FIELDS = ("feature", "threshold", "left", "right", "value", "cover")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops: one intra-op thread, as the test workers share
    the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _data(seed, n=240, d=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = ((x[:, 0] * 2 - x[:, 3] ** 2 + x[:, 0] * x[:, 5]) > 0).astype(np.float32)
    return x, y


def _forests():
    """Depth 6 with repeated features (boosted, every feature), and a random
    forest fitted on 40 rows, whose trees end in dead branches."""
    x, y = _data(0)
    gb = GBDTClassifier(n_estimators=6, max_depth=6, device="cpu").fit(x, y)
    rf = RandomForestClassifier(n_estimators=5, max_depth=6, device="cpu"
                                ).fit(x[:40], y[:40])
    return {"gbdt_depth6": (gb, x), "rf_dead_branches": (rf, x)}


@pytest.fixture(scope="module")
def forests():
    return _forests()


def _jax_estimator(est):
    e = est.ensemble_
    return SimpleNamespace(ensemble_=jft.DenseTreeEnsemble(
        jnp.asarray(e.feat.numpy()), jnp.asarray(e.thr.numpy()),
        jnp.asarray(e.leaf.numpy()), e.depth, e.base_score, e.tree_scale))


def test_rf_fixture_has_dead_branches(forests):
    rf = forests["rf_dead_branches"][0].ensemble_
    assert bool(torch.isinf(rf.thr).any())


@pytest.mark.parametrize("case", ["gbdt_depth6", "rf_dead_branches"])
def test_dense_to_tree_arrays_equal_jax(forests, case):
    est, x = forests[case]
    got = dense_to_tree_arrays(est.ensemble_, x[:50])
    want = jft.dense_to_tree_arrays(_jax_estimator(est).ensemble_, x[:50])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in FIELDS:
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("case", ["gbdt_depth6", "rf_dead_branches"])
def test_shap_values_equal_jax(forests, case):
    est, x = forests[case]
    xs, bg = x[:17], x[100:160]
    for g, w in zip(dense_to_tree_arrays(est.ensemble_, bg),
                    jft.dense_to_tree_arrays(_jax_estimator(est).ensemble_, bg)):
        np.testing.assert_allclose(ta.tree_shap_values(g, xs),
                                   ja.tree_shap_values(w, xs), rtol=1e-12, atol=0)
    got = ta.forest_shap_values(est, x, max_samples=30, seed=3, background=bg)
    want = ja.forest_shap_values(_jax_estimator(est), x, max_samples=30, seed=3,
                                 background=bg)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("case", ["gbdt_depth6", "rf_dead_branches"])
def test_vectorized_matches_scalar_oracle(forests, case):
    est, x = forests[case]
    xs = x[:17]
    for t in dense_to_tree_arrays(est.ensemble_, x):
        np.testing.assert_allclose(ta.tree_shap_values(t, xs),
                                   ta._tree_shap_values_scalar(t, xs),
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("case", ["gbdt_depth6", "rf_dead_branches"])
def test_additivity_against_raw_predict(forests, case):
    """Σφ + E[f] over the cover (here the rows themselves) is the margin of
    the forest's plain version."""
    est, x = forests[case]
    xs = x[:60]
    ens = est.ensemble_
    phi = ta.forest_shap_values(est, xs, max_samples=None)
    trees = dense_to_tree_arrays(ens, xs)
    base = ens.base_score + ens.tree_scale * sum(
        float((t.value.astype(np.float64) * t.cover)[t.feature < 0].sum() / t.cover[0])
        for t in trees)
    margin = raw_predict(ens, torch.from_numpy(xs)).numpy().astype(np.float64)
    err = np.abs(base + phi.sum(1) - margin)
    assert np.all(err <= 1e-4 * np.maximum(1.0, np.abs(margin))), err.max()


def test_feature_importance_equal_jax(forests):
    est, x = forests["gbdt_depth6"]
    trees = dense_to_tree_arrays(est.ensemble_, x)
    jtrees = jft.dense_to_tree_arrays(_jax_estimator(est).ensemble_, x)
    got = ta.forest_feature_importance(trees)
    want = ja.forest_feature_importance(SimpleNamespace(_host_trees=jtrees))
    assert np.array_equal(got, want)
    assert got.sum() == pytest.approx(1.0)


def test_kernel_shap_bit_equal_jax():
    rng = np.random.default_rng(5)
    w = rng.standard_normal(6).astype(np.float32)

    def predict(a):
        return 1.0 / (1.0 + np.exp(-(np.asarray(a, np.float32) @ w)))

    x = rng.standard_normal((4, 6)).astype(np.float32)
    bg = rng.standard_normal((50, 6)).astype(np.float32)
    got = ta.kernel_shap(predict, x, bg, n_samples=128, seed=7)
    want = ja.kernel_shap(predict, x, bg, n_samples=128, seed=7)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_integrated_gradients_linear_exact():
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    attr = ta.integrated_gradients(lambda a: a @ w, x)
    np.testing.assert_allclose(attr.numpy(), (x * w).numpy(), rtol=0, atol=1e-4)


def test_integrated_gradients_complete():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    attr = ta.integrated_gradients(lambda a: torch.tanh(a).sum(-1), x, steps=256)
    np.testing.assert_allclose(attr.sum(-1).numpy(), torch.tanh(x).sum(-1).numpy(),
                               atol=5e-3)


def test_integrated_gradients_tuple_and_baseline():
    """A tuple of inputs keeps its structure; a baseline shifts the path."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 2)).astype(np.float32))
    base = (torch.ones_like(a), torch.zeros_like(b))
    got = ta.integrated_gradients(lambda t: t[0].sum(-1) * 2 + t[1].sum(-1), (a, b),
                                  baseline=base, steps=8)
    assert isinstance(got, tuple) and len(got) == 2
    np.testing.assert_allclose(got[0].numpy(), 2 * (a - 1).numpy(), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), b.numpy(), atol=1e-5)


def test_integrated_gradients_regressor_equal_jax():
    """The f32 ``MultiModalRegressor`` (one fold, toy width) from one flax
    params tree, IG of both inputs against the JAX package's over
    ``model.apply``."""
    from bbbp_tpu.models.transformer_cnn import MultiModalRegressor as Flax
    from bbbp_tpu_torch.models import MultiModalRegressor
    from bbbp_tpu_torch.models.convert import load_flax

    cfg = dict(fp_dim=24, n_layers=1, emb_dim=16, head_dims=(16,), dropout=0.0)
    rng = np.random.default_rng(9)
    fp = rng.normal(size=(3, 24)).astype(np.float32)
    img = rng.random((3, 8, 8, 3)).astype(np.float32)
    flax_model = Flax(dtype=jnp.float32, **cfg)
    shapes = jax.eval_shape(flax_model.init, jax.random.PRNGKey(0), fp[:2], img[:2])

    def fill(path, leaf):
        shape = leaf.shape
        if path[-1].key == "kernel":
            return (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
                    ).astype(np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.1 * rng.normal(size=shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes["params"])
    want = ja.integrated_gradients(
        lambda xs: flax_model.apply({"params": params}, xs[0], xs[1]),
        (jnp.asarray(fp), jnp.asarray(img)))
    model = MultiModalRegressor(dtype=torch.float32, image_size=8, **cfg)
    load_flax(model, jax.tree_util.tree_map(np.asarray, params))
    got = ta.integrated_gradients(lambda xs: model(xs[0], xs[1]),
                                  (torch.from_numpy(fp), torch.from_numpy(img)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.detach().numpy() - w).max() <= 1e-4 * max(1.0, np.abs(w).max())
