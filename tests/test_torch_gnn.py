"""The port's graph regressors (``bbbp_tpu_torch/models/gnn.py``) against
the JAX package's flax modules (``bbbp_tpu/models/gnn.py``), at toy width
(hidden 16, 2 layers, 24 atoms, 3 folds) on the graphs of
``regression_molecules``.

- Forward from one flax init loaded through ``convert.load_flax`` (the
  MPNN's four bond-type ``Dense``s concatenate into one kernel): f32 within
  1e-5, bf16 within 2e-2 (bf16 inputs as ``train_cv`` feeds them; the port
  sums the four types' messages in one f32-accumulated product where flax
  rounds each to bf16), with inputs with and without the fold axis.
- One f32 step's gradients, fold by fold, against ``jax.grad``: within 1e-5
  of each parameter's largest |g|.
- ``train_cv`` of the MPNN from one flax init with dropout 0, f32, against
  the JAX package's: OOF predictions within 1e-4 (as tests/test_torch_loop.py
  holds the regressor).
- The graph leg's random stream (init and dropout from a
  ``torch.Generator``, not ``jax.random``): bf16, dropout 0.1, each side its
  own init, 3 folds x 2 seed replicas: OOF R² within 0.06 of the JAX
  package's.
"""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu_torch.chem.graph_features import graph_features  # noqa: E402
from bbbp_tpu_torch.models.convert import load_flax, params_from_flax  # noqa: E402
from bbbp_tpu_torch.models.gnn import GCNRegressor, MPNNRegressor  # noqa: E402
from bbbp_tpu_torch.testing import regression_molecules  # noqa: E402
from bbbp_tpu_torch.train import loop as tloop  # noqa: E402


@pytest.fixture(scope="module")
def J():
    """The JAX package's side, imported here so that the ``cuda``-marked
    test also runs where JAX is absent."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from bbbp_tpu.chem.graph_features import graph_features as jax_graph_features
    from bbbp_tpu.models.gnn import GCNRegressor as FlaxGCN
    from bbbp_tpu.models.gnn import MPNNRegressor as FlaxMPNN
    from bbbp_tpu.train import loop as jloop

    return SimpleNamespace(jax=jax, jnp=jnp, graph_features=jax_graph_features,
                           MPNN=FlaxMPNN, GCN=FlaxGCN, loop=jloop)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ATOMS, FOLDS = 24, 3
MPNN = dict(hidden=16, n_layers=2)
GCN = dict(hidden=(16, 16), head=(16, 8))
FWD_TOL = {"f32": 1e-5, "bf16": 2e-2}


@pytest.fixture(scope="module")
def graphs():
    """(feats, adj, adj_t, mask, y) of 96 molecules at 24 atoms."""
    smiles, y = regression_molecules(96)
    feats, adj, adj_t, mask, bad = graph_features(smiles, max_atoms=ATOMS,
                                                  edge_types=True)
    assert bad == []
    return feats, adj, adj_t, mask, y


def test_graph_features_equal_jax(graphs, J):
    smiles, _ = regression_molecules(96)
    theirs = J.graph_features(smiles, max_atoms=ATOMS, edge_types=True)
    for a, b in zip(graphs[:4], theirs[:4]):
        assert np.array_equal(a, b)


def _flax(J, kind, dtype, dropout=0.0):
    if kind == "mpnn":
        return J.MPNN(dtype=dtype, dropout=dropout, **MPNN)
    return J.GCN(dtype=dtype, dropout=dropout, **GCN)


def _port(kind, n_feat, dtype, folds=FOLDS, dropout=0.0, **kw):
    if kind == "mpnn":
        return MPNNRegressor(n_feat, dtype=dtype, dropout=dropout, folds=folds,
                             **MPNN, **kw)
    return GCNRegressor(n_feat, dtype=dtype, dropout=dropout, folds=folds, **GCN, **kw)


def _inputs(graphs, kind):
    feats, adj, adj_t, mask, _ = graphs
    return (feats, adj_t if kind == "mpnn" else adj, mask)


def _init(J, kind, graphs, seed=0):
    model = _flax(J, kind, J.jnp.float32)
    x = [a[:2] for a in _inputs(graphs, kind)]
    return J.jax.tree.map(np.asarray, J.jax.jit(model.init)(
        J.jax.random.PRNGKey(seed), *x)["params"])


@pytest.mark.parametrize("kind", ["mpnn", "gcn"])
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_forward_equals_flax(graphs, kind, name, J):
    """Rows 0-15 through every fold, and fold k's own 8 rows through fold
    k: each within its tolerance of flax's apply on the same rows."""
    jnp = J.jnp
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[name]
    params = _init(J, kind, graphs)
    flax_model = _flax(J, kind, jdt)
    feats, adj, mask = _inputs(graphs, kind)
    model = load_flax(_port(kind, feats.shape[-1], tdt), params)

    def flax_out(rows):
        return np.asarray(flax_model.apply(
            {"params": params}, jnp.asarray(feats[rows], jdt),
            jnp.asarray(adj[rows], jdt), mask[rows]), np.float32)

    def port(*x):
        t = [torch.from_numpy(a) for a in x]
        with torch.no_grad():
            return model(t[0].to(tdt), t[1].to(tdt), t[2]).float().numpy()

    rows = np.arange(16)
    want = flax_out(rows)
    got = port(feats[rows], adj[rows], mask[rows])
    assert got.shape == (FOLDS, 16)
    assert np.abs(want).max() > 0.05                    # not a vacuous match
    np.testing.assert_allclose(got, np.broadcast_to(want, got.shape), rtol=0,
                               atol=FWD_TOL[name])
    idx = np.random.default_rng(1).integers(0, len(feats), (FOLDS, 8))
    got = port(feats[idx], adj[idx], mask[idx])
    for k in range(FOLDS):
        np.testing.assert_allclose(got[k], flax_out(idx[k]), rtol=0,
                                   atol=FWD_TOL[name])


def test_single_fold_without_fold_axis_returns_rows(graphs):
    feats, adj_t, mask = (torch.from_numpy(a[:5]) for a in _inputs(graphs, "mpnn"))
    model = _port("mpnn", feats.shape[-1], torch.float32, folds=1,
                  generator=torch.Generator().manual_seed(0))
    assert model(feats, adj_t, mask).shape == (5,)
    assert set(model.config) == {"atom_features", "hidden", "n_layers", "head",
                                 "n_out", "dropout", "dtype", "n_types"}


@pytest.mark.parametrize("kind", ["mpnn", "gcn"])
def test_step_gradients_equal_jax_grad(graphs, kind, J):
    """f32, dropout 0: the gradient of Σ_k mean((f_k(x_k) − y_k)²) with
    respect to each fold's parameters, against ``jax.grad`` of fold k's
    loss, carried to the port's layout by ``params_from_flax``."""
    jax, jnp = J.jax, J.jnp
    params = _init(J, kind, graphs)
    flax_model = _flax(J, kind, jnp.float32)
    feats, adj, mask = _inputs(graphs, kind)
    y = graphs[4]
    idx = np.random.default_rng(2).integers(0, len(feats), (FOLDS, 16))

    def loss(p, f, a, m, t):
        return jnp.mean((flax_model.apply({"params": p}, f, a, m) - t) ** 2)

    grad = jax.jit(jax.grad(loss))
    want_trees = [jax.tree.map(np.asarray, grad(
        params, feats[r], adj[r].astype(np.float32), mask[r], y[r])) for r in idx]
    model = load_flax(_port(kind, feats.shape[-1], torch.float32), params)
    want = params_from_flax(model, want_trees)
    x = [torch.from_numpy(a[idx]) for a in (feats, adj, mask)]
    pred = model(*x, train=True)
    total = ((pred - torch.from_numpy(y[idx])) ** 2).mean(dim=1).sum()
    names = [n for n, _ in model.named_parameters()]
    got = torch.autograd.grad(total, list(model.parameters()))
    assert len(names) == len(want)
    for name, g in zip(names, got):
        w = want[name]
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-5 * max(scale, 1e-6), name


def _r2(y, pred):
    return 1.0 - float(((y - pred) ** 2).sum() / ((y - y.mean()) ** 2).sum())


DETERMINISTIC_KW = dict(n_folds=FOLDS, epochs=4, batch_size=16, lr=1e-3, seed=0,
                        snapshot_from=3)
DROPOUT_KW = dict(n_folds=FOLDS, epochs=12, batch_size=16, lr=3e-3, seed=0,
                  n_seeds=2)


@pytest.fixture(scope="module")
def jax_runs(graphs, J):
    """The JAX package's two train_cv runs of the MPNN, started together so
    that their XLA compiles overlap."""
    params = _init(J, "mpnn", graphs)
    x, y = _inputs(graphs, "mpnn"), graphs[4]
    calls = {
        "deterministic": lambda: J.loop.train_cv(
            _flax(J, "mpnn", J.jnp.float32), x, y, warm_start=params,
            **DETERMINISTIC_KW),
        "dropout": lambda: J.loop.train_cv(
            J.MPNN(dropout=0.1, **MPNN), x, y, **DROPOUT_KW),
    }
    with ThreadPoolExecutor(len(calls)) as pool:
        futures = {k: pool.submit(f) for k, f in calls.items()}
        return params, {k: f.result() for k, f in futures.items()}


def test_mpnn_train_cv_equals_jax(graphs, jax_runs):
    """3 folds, 4 epochs, snapshots from epoch 3, f32, dropout 0, both from
    one flax init (``warm_start``): the same folds, losses within 1e-4
    relative, OOF predictions within 1e-4."""
    params, runs = jax_runs
    want = runs["deterministic"]
    x, y = _inputs(graphs, "mpnn"), graphs[4]
    got = tloop.train_cv(_port("mpnn", x[0].shape[-1], torch.float32, folds=1),
                         x, y, warm_start=params, device="cpu", **DETERMINISTIC_KW)
    assert all(np.array_equal(a, b) for a, b in zip(got.fold_test_idx,
                                                    want.fold_test_idx))
    np.testing.assert_allclose(got.train_losses, want.train_losses, rtol=1e-4)
    np.testing.assert_allclose(got.oof_pred, want.oof_pred, rtol=0, atol=1e-4)
    assert np.abs(want.oof_pred - want.oof_pred.mean()).max() > 0.1


def test_graph_leg_learns_as_jax(graphs, jax_runs):
    """bf16, dropout 0.1, 3 folds x 2 seed replicas, each package its own
    init and dropout masks: OOF R² within 0.06 of the JAX package's."""
    x, y = _inputs(graphs, "mpnn"), graphs[4]
    want = jax_runs[1]["dropout"]
    got = tloop.train_cv(MPNNRegressor(x[0].shape[-1], dropout=0.1, **MPNN), x, y,
                         device="cpu", **DROPOUT_KW)
    r2_jax, r2_port = _r2(y, want.oof_pred), _r2(y, got.oof_pred)
    assert r2_jax > 0.2
    assert abs(r2_port - r2_jax) <= 0.06, (r2_port, r2_jax)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mpnn", "gcn"])
def test_forward_on_cuda_equals_cpu(graphs, kind, cuda_device):
    """The same parameters on the card and the CPU: f32 (TF32 off) within
    1e-5, bf16 within 2e-2."""
    from bbbp_tpu_torch.ops.similarity import f32_matmul

    feats, adj, mask = (torch.from_numpy(a[:16]) for a in _inputs(graphs, kind))
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        model = _port(kind, feats.shape[-1], dtype,
                      generator=torch.Generator().manual_seed(0))
        x = (feats.to(dtype), adj.to(dtype), mask)
        with torch.no_grad(), f32_matmul():
            want = model(*x).float()
            got = model.to(cuda_device)(*(a.to(cuda_device) for a in x)).float().cpu()
        assert float((got - want).abs().max()) <= tol
