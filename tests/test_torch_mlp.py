"""The dual-branch MLP (``bbbp_tpu_torch/models/mlp.py``), BatchNorm on the
fold axis in ``train_cv``, the NN search (``train/nn_search.py``) and the
weighted ensemble (``train/weighted_ensemble.py``) against the JAX
package's, at toy width (branches 16 → 8, head 16 → 8, 24 fingerprint
columns, 48 flat image columns).

- Forward from one flax tree (params and ``batch_stats`` drawn from a seed
  into the shapes of ``jax.eval_shape`` of the flax init), in eval mode (the
  running statistics) and in train mode (each fold's batch statistics, f32,
  biased fast variance): f32 within 1e-5, bf16 within 2e-2; the running
  statistics after one train-mode forward within 1e-6 (f32).
- ``train_cv`` from one flax init with dropout 0 against the JAX package's
  (``test_train_cv_equals_jax`` says what holds to 1e-5, why the dense
  biases in front of a BatchNorm do not, and how the OOF predictions are
  held against the JAX run's); with ``patience``, each fold's statistics
  of its best epoch.
- ``search_nn_cv`` picks a working learning rate, as
  ``tests/test_round3.py::TestNNSearch`` holds the JAX package's.
"""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu_torch.models.convert import (flatten_tree,  # noqa: E402
                                           flax_from_params,
                                           flax_stats_from_buffers, load_flax,
                                           params_from_flax, stats_from_flax,
                                           unflatten_tree)
from bbbp_tpu_torch.models.fold import BatchNorm, Dense  # noqa: E402
from bbbp_tpu_torch.models.mlp import DualBranchMLP  # noqa: E402
from bbbp_tpu_torch.train import loop as tloop  # noqa: E402


@pytest.fixture(scope="module")
def J():
    """The JAX package's side, imported here so that the ``cuda``-marked
    test also runs where JAX is absent."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from bbbp_tpu.models.mlp import DualBranchMLP as FlaxMLP
    from bbbp_tpu.train import loop as jloop
    from bbbp_tpu.train import nn_search as jsearch
    from bbbp_tpu.train import weighted_ensemble as jwe

    return SimpleNamespace(jax=jax, jnp=jnp, MLP=FlaxMLP, loop=jloop,
                           search=jsearch, we=jwe)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


D_FP, D_IMG, FOLDS = 24, 48, 3
WIDTHS = dict(fp_dims=(16, 8), img_dims=(16, 8), head_dims=(16, 8))
FWD_TOL = {"f32": 1e-5, "bf16": 2e-2}


@pytest.fixture(scope="module")
def data():
    """fp [120, 24], img [120, 48], y: a target linear in both."""
    rng = np.random.default_rng(0)
    fp = rng.normal(size=(120, D_FP)).astype(np.float32)
    img = rng.normal(size=(120, D_IMG)).astype(np.float32)
    y = (fp[:, :4].sum(1) / 2 + img[:, 0] + 0.1 * rng.normal(size=120)
         ).astype(np.float32)
    return fp, img, y


def _flax(J, dtype, dropout=0.0):
    return J.MLP(dtype=dtype, dropout=dropout, **WIDTHS)


def _port(dtype, folds=FOLDS, dropout=0.0, **kw):
    return DualBranchMLP(D_FP, D_IMG, dtype=dtype, dropout=dropout, folds=folds,
                         **WIDTHS, **kw)


def _trees(J, data, seed=0):
    """(params, batch_stats) of the flax MLP's shapes, drawn from ``seed``."""
    fp, img, _ = data
    shapes = J.jax.eval_shape(lambda: _flax(J, J.jnp.float32).init(
        J.jax.random.PRNGKey(0), fp[:2], img[:2]))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape, name = tuple(leaf.shape), path[-1]
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, size=shape).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        return (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)

    def walk(tree, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else draw(path + (k,), v)
                for k, v in tree.items()}
    return walk(dict(shapes["params"])), walk(dict(shapes["batch_stats"]))


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("train", [False, True])
def test_forward_equals_flax(data, name, train, J):
    jnp = J.jnp
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[name]
    fp, img, _ = data
    params, stats = _trees(J, data)
    fm = _flax(J, jdt)
    rows = np.arange(32)
    out = fm.apply({"params": params, "batch_stats": stats}, fp[rows], img[rows],
                   train=train, mutable=["batch_stats"] if train else False)
    want, new_stats = (out if train else (out, None))
    want = np.asarray(want, np.float32)
    model = load_flax(_port(tdt), params, stats)
    with torch.no_grad():
        got = model(torch.from_numpy(fp[rows]), torch.from_numpy(img[rows]),
                    train=train).float().numpy()
    assert got.shape == (FOLDS, 32) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, np.broadcast_to(want, got.shape), rtol=0,
                               atol=FWD_TOL[name])
    if train and name == "f32":
        theirs = stats_from_flax(model, J.jax.tree.map(np.asarray,
                                                       dict(new_stats["batch_stats"])))
        for key, b in model.named_buffers():
            torch.testing.assert_close(b, theirs[key], rtol=0, atol=1e-6)
    elif not train:
        # eval mode leaves the running statistics as they were
        ours = flatten_tree(flax_stats_from_buffers(model, FOLDS - 1))
        for key, v in flatten_tree(stats).items():
            assert np.array_equal(ours[key], v), key


def test_batch_norm_statistics_are_per_fold_biased_f32():
    """Each fold's rows alone, E[x²] − E[x]² (biased), momentum 0.99,
    epsilon 1e-5; not torch's BatchNorm1d over K·B rows."""
    bn = BatchNorm(2, 3, torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 10, 3, generator=g) * torch.tensor([1.0, 5.0]).view(2, 1, 1)
    out = bn(x.to(torch.bfloat16), train=True)
    xf = x.to(torch.bfloat16).float()
    mean, var = xf.mean(1), xf.var(1, correction=0)
    torch.testing.assert_close(bn.mean, 0.01 * mean, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(bn.var, 0.99 + 0.01 * var, rtol=1e-5, atol=1e-7)
    want = (xf - mean[:, None]) / torch.sqrt(var[:, None] + 1e-5)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), want, rtol=0, atol=2e-2)
    assert [n for n, _ in bn.named_parameters()] == ["scale", "bias"]
    assert [n for n, _ in bn.named_buffers()] == ["mean", "var"]


def test_running_statistics_stay_out_of_the_optimizer(data):
    model = _port(torch.float32, generator=torch.Generator().manual_seed(0))
    opt = tloop.AdamW(list(model.parameters()))
    n_params = sum(p[0].numel() for p in model.parameters())
    assert opt.flat.shape == (FOLDS, n_params)
    buffers = dict(model.named_buffers())
    assert set(buffers) == {f"{b}.BatchNorm_{i}.{s}" for b in ("fp_branch", "img_branch")
                            for i in range(2) for s in ("mean", "var")}
    assert all(b.shape == (FOLDS, 16 if "_0." in k else 8) for k, b in buffers.items())


KW = dict(n_folds=FOLDS, epochs=4, batch_size=16, lr=3e-3, seed=0)
STEPS = 4 * (80 // 16)                  # epochs × steps of an epoch
# the dense layers in front of a BatchNorm: their biases get no gradient
# but rounding (BatchNorm subtracts the batch mean), which Adam turns into
# steps of up to lr; each package's rounding differs
PRE_BN_BIASES = {f"{b}.Dense_{i}.bias" for b in ("fp_branch", "img_branch")
                 for i in range(2)}


DROPOUT_KW = dict(n_folds=FOLDS, epochs=12, batch_size=32, lr=3e-3, n_seeds=4)
DROPOUT_SEEDS = (0, 1, 2)


def _dropout_data():
    """480 rows of ``data``'s kind, from another seed."""
    rng = np.random.default_rng(1)
    fp = rng.normal(size=(480, D_FP)).astype(np.float32)
    img = rng.normal(size=(480, D_IMG)).astype(np.float32)
    y = (fp[:, :4].sum(1) / 2 + img[:, 0] + 0.1 * rng.normal(size=480)
         ).astype(np.float32)
    return fp, img, y


@pytest.fixture(scope="module")
def jax_runs(data, J):
    """The JAX package's train_cv runs from one flax init (f32 and bf16),
    and three with its own init and dropout 0.2 (bf16, seeds 0-2), started
    together so that their compiles overlap."""
    fp, img, y = data
    params, _ = _trees(J, data, seed=1)
    jnp = J.jnp
    calls = {name: (lambda dt=dt: J.loop.train_cv(_flax(J, dt), (fp, img), y,
                                                  warm_start=params, **KW))
             for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16))}
    fp_d, img_d, y_d = _dropout_data()
    for seed in DROPOUT_SEEDS:
        calls[f"dropout{seed}"] = lambda seed=seed: J.loop.train_cv(
            _flax(J, jnp.bfloat16, dropout=0.2), (fp_d, img_d), y_d, seed=seed,
            **DROPOUT_KW)
    with ThreadPoolExecutor(len(calls)) as pool:
        futures = {k: pool.submit(f) for k, f in calls.items()}
        return params, {k: f.result() for k, f in futures.items()}


def _fold_tree(stacked, k):
    """Fold k of a flax tree whose leaves carry a leading fold axis."""
    return {key: (_fold_tree(v, k) if hasattr(v, "items") else np.asarray(v)[k])
            for key, v in stacked.items()}


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_train_cv_equals_jax(data, jax_runs, name, J):
    """The same folds and losses (f32 1e-4 relative, bf16 1e-2). The four
    dense biases in front of a BatchNorm (``PRE_BN_BIASES``) and the running
    means they shift part from the JAX run's by up to lr × steps (0.06;
    seen 0.035 and 0.0037 in f32). Then:

    - f32: every other parameter and the running variances within 1e-5 of
      the JAX run's; the OOF predictions within 1e-4 of flax's eval-mode
      forward of the JAX run's final state with only those biases and
      running means taken from the port (seen 2.4e-7), and within
      lr × steps of the JAX run's own (seen 0.0096);
    - bf16: every other parameter's update (final − initial) within 0.25
      of the JAX run's in L2 norm, relative, a tensor (seen at most 0.157,
      0.115 over them all), and the OOF predictions within lr × steps of
      the JAX run's (seen 0.040);
    - both: the OOF predictions equal flax's eval-mode forward of the
      port's own final parameters and statistics (f32 1e-5, bf16 2e-2)."""
    fp, img, y = data
    params, runs = jax_runs
    want = runs[name]
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[name]
    got = tloop.train_cv(_port(dtype, folds=1), (fp, img), y, warm_start=params,
                         device="cpu", **KW)
    assert all(np.array_equal(a, b) for a, b in zip(got.fold_test_idx,
                                                    want.fold_test_idx))
    np.testing.assert_allclose(got.train_losses, want.train_losses,
                               rtol=1e-4 if name == "f32" else 1e-2)
    model = _port(dtype)
    drift = KW["lr"] * STEPS
    theirs = params_from_flax(model, [_fold_tree(want.params, k)
                                      for k in range(FOLDS)])
    stats = stats_from_flax(model, [_fold_tree(want.batch_stats, k)
                                    for k in range(FOLDS)])
    assert set(got.params) == set(theirs) and set(got.batch_stats) == set(stats)
    if name == "f32":
        for key, value in got.params.items():
            tol = drift if key in PRE_BN_BIASES else 1e-5
            torch.testing.assert_close(value, theirs[key], rtol=0, atol=tol)
        for key, value in got.batch_stats.items():
            tol = drift if key.endswith("mean") else 1e-5
            torch.testing.assert_close(value, stats[key], rtol=0, atol=tol)
    else:
        init = params_from_flax(model, [params] * FOLDS)
        for key, value in got.params.items():
            if key in PRE_BN_BIASES:
                continue
            ours, jax_update = value - init[key], theirs[key] - init[key]
            rel = float((ours - jax_update).norm() / jax_update.norm())
            assert rel <= 0.25, (key, rel)
    fm = _flax(J, {"f32": J.jnp.float32, "bf16": J.jnp.bfloat16}[name])
    swapped = np.zeros_like(want.oof_pred)
    for i, te in enumerate(got.fold_test_idx):
        variables = {"params": flax_from_params(model, i, got.params),
                     "batch_stats": flax_stats_from_buffers(model, i, got.batch_stats)}
        pred = np.asarray(fm.apply(variables, fp[te], img[te]), np.float32)
        np.testing.assert_allclose(got.oof_pred[te], pred, rtol=0,
                                   atol=FWD_TOL[name])
        # the JAX run's fold i with the port's drifting leaves
        jp, js = (flatten_tree(_fold_tree(t, i)) for t in (want.params,
                                                           want.batch_stats))
        ours_p, ours_s = (flatten_tree(v) for v in variables.values())
        jp.update({k: ours_p[k] for k in jp if k.replace("/", ".") in PRE_BN_BIASES})
        js.update({k: ours_s[k] for k in js if k.endswith("mean")})
        swapped[te] = np.asarray(fm.apply({"params": unflatten_tree(jp),
                                           "batch_stats": unflatten_tree(js)},
                                          fp[te], img[te]), np.float32)
    if name == "f32":
        np.testing.assert_allclose(got.oof_pred, swapped, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.oof_pred, want.oof_pred, rtol=0, atol=drift)
    assert np.abs(got.oof_pred - got.oof_pred.mean()).max() > 0.5


def _r2(y, pred):
    return 1.0 - float(((y - pred) ** 2).sum() / ((y - y.mean()) ** 2).sum())


def test_mlp_learns_as_jax(jax_runs):
    """The random stream (init and dropout from a ``torch.Generator``, not
    ``jax.random``): bf16, dropout 0.2, each package its own init, 3 folds
    x 4 seed replicas, 480 rows: the mean OOF R² over seeds 0-2 within 0.06
    of the JAX package's, as ``tests/test_torch_gnn.py`` holds the graph
    leg. One seed's R² spreads more: 0.339-0.473 in the port and
    0.370-0.406 in the JAX package over these seeds (0.08 apart at seed 2);
    without dropout, from one init, the two are within 0.008."""
    fp, img, y = _dropout_data()
    r2_jax = np.mean([_r2(y, jax_runs[1][f"dropout{s}"].oof_pred)
                      for s in DROPOUT_SEEDS])
    r2_port = np.mean([_r2(y, tloop.train_cv(
        _port(torch.bfloat16, folds=1, dropout=0.2), (fp, img), y, seed=s,
        device="cpu", **DROPOUT_KW).oof_pred) for s in DROPOUT_SEEDS])
    assert r2_jax > 0.3
    assert abs(r2_port - r2_jax) <= 0.06, (r2_port, r2_jax)


def test_early_stopping_keeps_best_statistics(data, monkeypatch):
    """patience 2 at lr 3e-2: the run stops before its 30 epochs, and each
    fold comes back with the parameters and running statistics of its own
    best epoch (val loss below the best so far − 1e-5), recorded epoch by
    epoch as the run went."""
    fp, img, y = data
    seen = []
    real_val = tloop.FoldTrainer.val_losses

    def recording(self, val_idx):
        vl = real_val(self, val_idx)
        seen.append((vl, self.state(), self.stats()))
        return vl

    monkeypatch.setattr(tloop.FoldTrainer, "val_losses", recording)
    got = tloop.train_cv(_port(torch.float32, folds=1), (fp, img), y,
                         device="cpu", n_folds=FOLDS, epochs=30, batch_size=16,
                         lr=3e-2, seed=1, patience=2)
    assert len(seen) < 30
    best = np.full(FOLDS, np.inf)
    best_epoch = np.zeros(FOLDS, int)
    for e, (vl, _, _) in enumerate(seen):
        improved = vl < best - 1e-5
        best = np.where(improved, vl, best)
        best_epoch = np.where(improved, e, best_epoch)
    assert len(set(best_epoch.tolist()) | {len(seen) - 1}) > 1
    for k in range(FOLDS):
        _, state, stats = seen[best_epoch[k]]
        for key, value in got.batch_stats.items():
            assert torch.equal(value[k], stats[key][k]), (k, key)
        for key, value in got.params.items():
            assert torch.equal(value[k], state[key][k]), (k, key)


class TinyReg(torch.nn.Module):
    """``tests/test_round3.py::TinyReg`` on the fold axis: dense → relu →
    dense to 1."""

    def __init__(self, hidden=16, d_in=8, folds=1, device=None, generator=None):
        super().__init__()
        self.config = dict(hidden=hidden, d_in=d_in)
        self.Dense_0 = Dense(folds, d_in, hidden, torch.float32, device, generator)
        self.Dense_1 = Dense(folds, hidden, 1, torch.float32, device, generator)

    def forward(self, x, train=False, generator=None):
        return self.Dense_1(torch.relu(self.Dense_0(x)))[..., 0]


def test_search_finds_working_lr():
    from bbbp_tpu_torch.train.nn_search import search_nn_cv
    from tests.test_round3 import _toy

    x, y = _toy()
    res = search_nn_cv(
        lambda hidden=16: TinyReg(hidden=hidden), (x,), y,
        space={"learning_rate": {"low": 1e-6, "high": 3e-2, "log": True},
               "hidden": [8, 16]},
        n_iter=6, n_folds=3, epochs=25, batch_size=32, seed=0, device="cpu")
    assert len(res.trials) == 6
    assert res.best_score > 0.5          # linear task: good lr learns it
    assert res.best_params["learning_rate"] > 1e-4
    assert res.best_oof.shape == (len(y),)


def test_search_trials_and_chunks_equal_jax(J):
    """The same trials in the same groups and chunks: one train_cv a chunk
    of max_replicas // n_folds trials, each trial's lr on its replica."""
    from bbbp_tpu_torch.train import nn_search as S
    from tests.test_round3 import _toy

    x, y = _toy(60)
    calls = []

    def spy(model, inputs, y_, **kw):
        calls.append((model.config["hidden"], kw["replica_hparams"]["learning_rate"]))
        n = len(y_)
        return SimpleNamespace(oof_seeds=np.zeros((kw["n_seeds"], n), np.float32))

    space = {"learning_rate": {"low": 1e-4, "high": 1e-2, "log": True},
             "hidden": [8, 16]}
    orig = S.train_cv
    S.train_cv = spy
    try:
        res = S.search_nn_cv(lambda hidden=16: TinyReg(hidden=hidden), (x,), y,
                             space, n_iter=7, n_folds=3, max_replicas=6,
                             extra_trials=[{"learning_rate": 1e-3, "hidden": 8}])
    finally:
        S.train_cv = orig
    rng = np.random.default_rng(0)
    want = [{"learning_rate": 1e-3, "hidden": 8}] + [
        J.search._sample_params(space, rng) for _ in range(7)]
    assert [{k: t[k] for k in ("learning_rate", "hidden")} for t in res.trials] == want
    assert all(len(lr) <= 2 for _, lr in calls)
    assert sorted(float(v) for _, lr in calls for v in lr) == sorted(
        float(np.float32(t["learning_rate"])) for t in want)


def test_rounding_accuracy_equals_jax(J):
    from bbbp_tpu_torch.train.weighted_ensemble import rounding_accuracy

    rng = np.random.default_rng(0)
    y = np.round(rng.normal(size=500), 2).astype(np.float32)
    pred = (y + rng.choice([0.0, 0.001, 0.004, 0.02], size=500)).astype(np.float32)
    assert rounding_accuracy(y, pred) == J.we.rounding_accuracy(y, pred)
    assert rounding_accuracy(y, pred, 1) == J.we.rounding_accuracy(y, pred, 1)
    assert 0.2 < rounding_accuracy(y, pred) < 0.8


def test_weighted_ensemble_runs_at_toy_size(monkeypatch):
    """``run_weighted_ensemble`` on cpu over the tiny ProcessedData of
    ``tests/test_torch_regression.py``, the forests cut to 8 trees of depth
    3 and the MLP's widths to toy ones: every report, the blend's weights."""
    import functools

    from bbbp_tpu_torch.ops import forest_train as FT
    from bbbp_tpu_torch.train import weighted_ensemble as W
    from tests.test_torch_regression import _tiny_processed

    monkeypatch.setattr(W, "RandomForestRegressor", lambda **kw: FT.RandomForestRegressor(
        **dict(kw, n_estimators=8, max_depth=3)))
    monkeypatch.setattr(W, "GBDTRegressor", lambda **kw: FT.GBDTRegressor(
        **dict(kw, n_estimators=8, max_depth=3)))
    monkeypatch.setattr(W, "DualBranchMLP", functools.partial(DualBranchMLP, **WIDTHS))
    data = _tiny_processed()
    rep = W.run_weighted_ensemble(W.WeightedEnsembleConfig(epochs=3, n_folds=3),
                                  data=data, verbose=False, device="cpu")
    assert set(rep) == {"nn", "rf", "xgb", "ensemble"}
    assert set(rep["ensemble"]) == {"mse", "r2", "rounding_accuracy"}
    assert all(np.isfinite(v) for r in rep.values() for v in r.values())
    assert rep["rf"]["r2"] > 0.3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_batch_norm_mlp_on_cuda_equals_cpu(data, cuda_device):
    """The same parameters on the card and the CPU, train and eval mode:
    outputs f32 (TF32 off) within 1e-4, bf16 within 2e-2; the running
    statistics after one train-mode forward within 1e-5."""
    from bbbp_tpu_torch.ops.similarity import f32_matmul

    fp, img, _ = (torch.from_numpy(a[:32]) for a in data)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for train in (False, True):
            model = _port(dtype, generator=torch.Generator().manual_seed(0))
            card = _port(dtype, device=cuda_device)
            card.load_state_dict(model.state_dict())
            with torch.no_grad(), f32_matmul():
                want = model(fp, img, train=train).float()
                got = card(fp.to(cuda_device), img.to(cuda_device),
                           train=train).float().cpu()
            assert float((got - want).abs().max()) <= tol
            for (_, a), (_, b) in zip(model.named_buffers(), card.named_buffers()):
                assert float((a - b.cpu()).abs().max()) <= 1e-5
