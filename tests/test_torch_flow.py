"""The flow classifier in the port (``bbbp_tpu_torch/models/flow.py``,
``train/flow_pipeline.py``) against the JAX package's
(``bbbp_tpu/models/flow.py``, ``bbbp_tpu/train/flow_pipeline.py``), at toy
width (16 inputs, hidden 24, 2 flow layers).

- Forward from one flax tree (leaves drawn from a seed into the shapes of
  ``jax.eval_shape`` of the flax init): f32 within 1e-5, bf16 within 2e-2.
- ``FlowLayer.reverse`` (``torch.linalg.pinv`` of the f32 kernel) against
  flax's (``jnp.linalg.pinv``): within 1e-4 of the larger of 1 and the
  output's scale (two SVDs of a 24 × 24 kernel).
- ``FlowClassifier``'s test accuracy within 0.05 of the JAX package's on a
  toy task; saved classifiers load across the packages.
- ``do_flow_train`` through ``$BBBP_B3DB_DIR`` on a TSV of 160 molecules.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu_torch.models.convert import load_flax  # noqa: E402
from bbbp_tpu_torch.models.flow import FlowLayer, FlowModel  # noqa: E402
from bbbp_tpu_torch.train import flow_pipeline as FP  # noqa: E402


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from bbbp_tpu.models import flow as jflow
    from bbbp_tpu.train import flow_pipeline as jfp

    return SimpleNamespace(jax=jax, jnp=jnp, flow=jflow, fp=jfp)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


D_IN, HIDDEN, LAYERS = 16, 24, 2
FWD_TOL = {"f32": 1e-5, "bf16": 2e-2}


def _tree(J, model, x, seed=0, **kw):
    shapes = J.jax.eval_shape(lambda: model.init(
        {"params": J.jax.random.PRNGKey(0), "dropout": J.jax.random.PRNGKey(1)},
        x, **kw))["params"]
    rng = np.random.default_rng(seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (rng.normal(size=v.shape) / np.sqrt(v.shape[0])).astype(np.float32)
                for k, v in tree.items()}
    return walk(dict(shapes))


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(0).normal(size=(40, D_IN)).astype(np.float32)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_forward_equals_flax(x, name, J):
    jdt, tdt = {"f32": (J.jnp.float32, torch.float32),
                "bf16": (J.jnp.bfloat16, torch.bfloat16)}[name]
    fm = J.flow.FlowModel(hidden_dim=HIDDEN, n_layers=LAYERS, dtype=jdt)
    params = _tree(J, fm, x)
    want = np.asarray(fm.apply({"params": params}, x), np.float32)
    model = load_flax(FlowModel(D_IN, HIDDEN, LAYERS, dtype=tdt, folds=2), params)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).float().numpy()
    assert got.shape == (2, 40, 2) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, np.broadcast_to(want, got.shape), rtol=0,
                               atol=FWD_TOL[name])


def test_reverse_equals_flax(J):
    layer = J.flow.FlowLayer(HIDDEN, dtype=J.jnp.float32)
    y = np.random.default_rng(1).normal(size=(12, HIDDEN)).astype(np.float32)
    params = _tree(J, layer, y, seed=2)
    want = np.asarray(layer.apply({"params": params}, y, reverse=True))
    port = load_flax(FlowLayer(1, HIDDEN, dtype=torch.float32), params)
    with torch.no_grad():
        got = port.reverse(torch.from_numpy(y)[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))
    # the inverse of the forward on its active set: a square kernel of full
    # rank and no ReLU clipping gives the input back
    with torch.no_grad():
        xin = torch.from_numpy(y)[None]
        lin = torch.bmm(xin, port.kernel) + port.bias[:, None]
        back = port.reverse(lin)
    torch.testing.assert_close(back, xin, rtol=0, atol=1e-3)


def _toy(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D_IN)).astype(np.float32)
    w = rng.normal(size=D_IN)
    return x, (x @ w + 0.3 * x[:, 0] * x[:, 1] > 0).astype(np.int32)


CLF = dict(hidden_dim=HIDDEN, n_layers=LAYERS, epochs=10, batch_size=32, lr=3e-3)


SEEDS = (0, 1, 2)


@pytest.fixture(scope="module")
def jax_clfs(J):
    x, y = _toy(640, 3)
    return [J.fp.FlowClassifier(**CLF, seed=s).fit(x[:512], y[:512]) for s in SEEDS]


def test_classifier_accuracy_as_jax(jax_clfs):
    """The mean test accuracy over seeds 0-2 (one seed's spreads by up to
    0.06 between the packages on 128 test rows: 0.930 / 0.992 at seed 0,
    0.969 / 0.930 at seed 2)."""
    x, y = _toy(640, 3)
    want = np.mean([(c.predict(x[512:]) == y[512:]).mean() for c in jax_clfs])
    ours = [FP.FlowClassifier(**CLF, seed=s, device="cpu").fit(x[:512], y[:512])
            for s in SEEDS]
    got = np.mean([(c.predict(x[512:]) == y[512:]).mean() for c in ours])
    assert want > 0.8
    assert abs(got - want) <= 0.05, (got, want)
    assert set(ours[0].evaluate(x[512:], y[512:])) >= {"accuracy", "roc_auc"}
    assert ours[0].get_params() == jax_clfs[0].get_params()


def test_saved_classifiers_load_across(jax_clfs, tmp_path, J):
    """bf16 logits within 2e-2 of the larger of 1 and their scale."""
    x, y = _toy(64, 4)

    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-2 * max(1.0, np.abs(want).max()))

    jax_clfs[0].save(str(tmp_path / "jax.pkl"))
    ported = FP.FlowClassifier.load(str(tmp_path / "jax.pkl"), device="cpu")
    close(ported._logits(x), jax_clfs[0]._logits(x))
    ours = FP.FlowClassifier(**dict(CLF, epochs=2), device="cpu").fit(*_toy(128, 5))
    ours.save(str(tmp_path / "port.pkl"))
    theirs = J.fp.FlowClassifier.load(str(tmp_path / "port.pkl"))
    close(theirs._logits(x), ours._logits(x))


def test_do_flow_train_through_b3db_tsv(tmp_path, monkeypatch):
    from bbbp_tpu_torch.testing import labelled_training_set, write_classification_tsv

    smiles, labels = labelled_training_set(160, seed=3)
    write_classification_tsv(str(tmp_path / "B3DB_classification.tsv"), smiles, labels)
    monkeypatch.setenv("BBBP_B3DB_DIR", str(tmp_path))
    clf, report, wall = FP.do_flow_train(FP.FlowTrainConfig(pca_dim=20, workers=1),
                                         verbose=False, device="cpu")
    assert clf.model.config["d_in"] == 20
    assert 0.5 <= report["accuracy"] <= 1.0 and wall > 0
    grid = FP.FlowTrainConfig(pca_dim=8, workers=1, grid={"epochs": [1, 2]}, cv=2)
    clf, report, _ = FP.do_flow_train(grid, verbose=False, device="cpu")
    assert clf.epochs in (1, 2) and "roc_auc" in report
