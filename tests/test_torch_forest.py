"""Port parity: dense forest inference (bbbp_tpu_torch.ops.forest against
bbbp_tpu.ops.forest_tpu on the CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu_torch.ops import forest as tf  # noqa: E402


# The JAX package is the reference; it is imported by fixtures so that the
# CUDA test below also runs where JAX is absent (on the card's machine).
@pytest.fixture(scope="module")
def jnp():
    return pytest.importorskip("jax.numpy")


@pytest.fixture(scope="module")
def jft():
    return pytest.importorskip("bbbp_tpu.ops.forest_tpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _random_state(rng, n_trees, depth, n_feat, inf_share=0.1):
    n_int = (1 << depth) - 1
    thr = rng.standard_normal((n_trees, n_int)).astype(np.float32)
    thr[rng.random(thr.shape) < inf_share] = np.inf      # dead branches
    return {"feat": rng.integers(0, n_feat, (n_trees, n_int)).astype(np.int32),
            "thr": thr,
            "leaf": rng.normal(0, 0.1, (n_trees, n_int + 1)).astype(np.float32),
            "depth": depth, "base_score": 0.25, "tree_scale": 0.1}


def _jax_ensemble(jft, jnp, s):
    return jft.DenseTreeEnsemble(jnp.asarray(s["feat"]), jnp.asarray(s["thr"]),
                                 jnp.asarray(s["leaf"]), s["depth"],
                                 s["base_score"], s["tree_scale"])


@pytest.mark.parametrize("depth", [1, 6])
def test_reference_matches_jax_route_and_gather(depth, jnp, jft):
    """T=50 with +inf thresholds on identical x; atol 1e-5 because the sum
    over trees is taken in another order (comparisons are exact f32)."""
    rng = np.random.default_rng(depth)
    s = _random_state(rng, 50, depth, 12)
    x = rng.standard_normal((200, 12)).astype(np.float32)
    je = _jax_ensemble(jft, jnp, s)
    ens = tf.DenseTreeEnsemble.from_state(s)
    got = tf.dense_predict_reference(ens.feat, ens.thr, ens.leaf,
                                     torch.from_numpy(x), depth,
                                     s["base_score"], s["tree_scale"]).numpy()
    np.testing.assert_allclose(got, np.asarray(je.raw_predict(jnp.asarray(x))),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(je.raw_predict_gather(jnp.asarray(x))),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        tf.raw_predict(ens, torch.from_numpy(x)).numpy(), got)


def test_jax_trained_ensemble_carried_through_state(jft):
    """An ensemble fit by TPUGBDTClassifier predicts the same through the
    port after a trip through the pickle's dict; thresholds are quantile
    edges of x itself, so this also checks the exact f32 comparison."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((256, 6)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] ** 2 > 0.3).astype(np.float32)
    clf = jft.TPUGBDTClassifier(n_estimators=10, max_depth=3, seed=0).fit(x, y)
    e = clf.ensemble_
    state = {"feat": np.asarray(e.feat), "thr": np.asarray(e.thr),
             "leaf": np.asarray(e.leaf), "depth": e.depth,
             "base_score": e.base_score, "tree_scale": e.tree_scale}
    ens = tf.DenseTreeEnsemble.from_state(state)
    got = tf.raw_predict(ens, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, clf.decision_function(x), atol=1e-5, rtol=0)
    proba = tf.raw_predict(ens, torch.from_numpy(x), apply_sigmoid=True).numpy()
    np.testing.assert_allclose(proba, clf.predict_proba(x)[:, 1], atol=1e-6, rtol=0)


def test_state_roundtrip_is_exact():
    s = _random_state(np.random.default_rng(8), 20, 4, 9)
    back = tf.DenseTreeEnsemble.from_state(s).to_state()
    for key in ("feat", "thr", "leaf"):
        assert back[key].dtype == s[key].dtype
        assert np.array_equal(back[key], s[key])
    assert (back["depth"], back["base_score"], back["tree_scale"]) == (4, 0.25, 0.1)


@pytest.mark.parametrize("case", ["negative_feat", "too_deep", "leaf_shape",
                                  "narrow_x", "f64_x"])
def test_rejects_what_the_kernel_does_not_take(case):
    s = _random_state(np.random.default_rng(9), 5, 3, 9)
    x = torch.zeros((4, 9))
    if case == "negative_feat":
        s["feat"][0, 0] = -1
    elif case == "too_deep":
        s = _random_state(np.random.default_rng(9), 1, tf.MAX_DEPTH + 1, 9)
    elif case == "leaf_shape":
        s["leaf"] = s["leaf"][:, :-1]
    elif case == "narrow_x":
        s["feat"][0, 0] = 8
        x = torch.zeros((4, 8))
    elif case == "f64_x":
        x = x.double()
    with pytest.raises((TypeError, ValueError)):
        tf.raw_predict(tf.DenseTreeEnsemble.from_state(s), x)


def test_wrapper_on_cpu_runs_plain_version_without_launch():
    rng = np.random.default_rng(10)
    ens = tf.DenseTreeEnsemble.from_state(_random_state(rng, 30, 6, 30))
    x = torch.from_numpy(rng.standard_normal((64, 30)).astype(np.float32))
    tf.raw_predict.launches.reset()
    tf.raw_predict(ens, x, apply_sigmoid=True)
    assert tf.raw_predict.launches.count == 0


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_cuda(cuda_device):
    """The CUDA kernel against its plain version on the card, through both
    of its x layouts (rows staged in shared memory for F <= 64, read from
    global memory above); margins within atol 2e-5 (sum order differs)."""
    rng = np.random.default_rng(11)
    for depth, n_feat in ((6, 30), (8, 2048), (1, 65)):
        ens = tf.DenseTreeEnsemble.from_state(
            _random_state(rng, 300, depth, n_feat)).to(cuda_device)
        x = torch.from_numpy(rng.standard_normal((16385, n_feat)).astype(np.float32)
                             ).to(cuda_device)
        before = tf.raw_predict.launches.count
        got = tf.raw_predict(ens, x)
        assert tf.raw_predict.launches.count == before + 1
        want = tf.dense_predict_reference(ens.feat, ens.thr, ens.leaf, x, depth,
                                          ens.base_score, ens.tree_scale)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
        torch.testing.assert_close(tf.raw_predict(ens, x, apply_sigmoid=True),
                                   torch.sigmoid(want), rtol=0, atol=2e-5)
