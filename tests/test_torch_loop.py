"""The port's fold-batched ``train_cv`` (bbbp_tpu_torch.train.loop) against
the JAX package's (bbbp_tpu.train.loop), at toy width (2 layers, 32 wide,
16 × 16 images), on numpy inputs made from a seed.

With dropout 0, an f32 model and ``warm_start`` from one flax init, both
sides start from the same parameters, draw the same folds and the same
batches (numpy's ``default_rng``), and take the same AdamW steps, so their
out-of-fold predictions agree up to f32 rounding that compounds over the
steps: within 1e-4 absolute after 4-6 epochs (differences seen ~1e-5 on
predictions of size ~1). Losses within 1e-4 relative.

With dropout on (bf16, each side its own random init and masks) the two
learn alike: OOF R² within 0.06 of the JAX run's (the port's spreads ±0.03
over seeds on that set).

Each JAX ``train_cv`` call compiles its own jitted closures (~8-14 s of XLA
on this CPU, most of a call), and no two of the file's calls share their
shapes (3 or 6 lanes, f32 or bf16, 96 or 240 rows), so no compile can
serve two of them: the ``jax_runs`` fixture starts the three together in
threads, so that their compiles overlap.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bbbp_tpu.models.transformer_cnn import MultiModalRegressor as FlaxRegressor  # noqa: E402
from bbbp_tpu.train import loop as jloop  # noqa: E402
from bbbp_tpu_torch.models import MultiModalRegressor  # noqa: E402
from bbbp_tpu_torch.train import loop as tloop  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's torch work is many small ops: one intra-op thread each,
    as the test workers share the machine's cores (OpenMP teams that
    outnumber the cores spin against each other)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SIDE = 16
CFG = dict(fp_dim=32, n_layers=2, emb_dim=32, head_dims=(32, 16), dropout=0.0)
OOF_TOL, LOSS_RTOL = 1e-4, 1e-4


@pytest.mark.parametrize("n,k,seed", [(96, 3, 0), (1058, 10, 42), (101, 7, 5),
                                      (10, 10, 1)])
def test_folds_and_train_sets_equal_jax(n, k, seed):
    want, got = jloop.kfold_indices(n, k, seed), tloop.kfold_indices(n, k, seed)
    assert len(got) == k and all(np.array_equal(a, b) for a, b in zip(got, want))
    (w_sets, w_s), (g_sets, g_s) = (jloop._padded_train_sets(n, want),
                                    tloop._padded_train_sets(n, got))
    assert g_s == w_s and np.array_equal(g_sets, w_sets)


@pytest.fixture(scope="module")
def toy():
    """(fp [96, 32], img [96, 16, 16, 3], y, flax model, its init, a
    target of noise alone)."""
    rng = np.random.default_rng(0)
    n, d = 96, CFG["fp_dim"]
    fp = rng.normal(size=(n, d)).astype(np.float32)
    img = rng.random((n, SIDE, SIDE, 3)).astype(np.float32)
    y = (fp @ rng.normal(size=d) / np.sqrt(d) + 0.1 * rng.normal(size=n)
         ).astype(np.float32)
    noise = rng.normal(size=n).astype(np.float32)
    jm = FlaxRegressor(dtype=jnp.float32, **CFG)
    init = jax.jit(jm.init)(jax.random.PRNGKey(3), fp[:2], img[:2])
    return fp, img, y, jm, jax.tree.map(np.asarray, init["params"]), noise


def _affine(fp):
    rng = np.random.default_rng(1)
    shift = (0.1 * rng.normal(size=(3, fp.shape[1]))).astype(np.float32)
    scale = (1.0 + 0.1 * rng.random((3, fp.shape[1]))).astype(np.float32)
    return ((shift, scale), None)


def _deterministic_kw(fp):
    return dict(n_folds=3, epochs=5, batch_size=16, lr=1e-3, seed=0,
                snapshot_from=3, fold_affine=_affine(fp))


BOOKKEEPING_KW = dict(n_folds=3, epochs=10, batch_size=16, lr=1e-3, seed=0,
                      n_seeds=2, patience=2, val_frac=0.2,
                      replica_hparams={"learning_rate": np.array([3e-3, 1e-3]),
                                       "weight_decay": np.array([1e-4, 1e-1])})
DROPOUT_KW = dict(n_folds=3, epochs=8, batch_size=16, lr=1e-3, n_seeds=2, seed=0)


def _dropout_set():
    """240 rows whose target is linear in the fingerprint, and the config."""
    rng = np.random.default_rng(0)
    n, d = 240, 32
    fp = rng.normal(size=(n, d)).astype(np.float32)
    img = rng.random((n, SIDE, SIDE, 3)).astype(np.float32)
    y = (fp @ rng.normal(size=d) / np.sqrt(d) + 0.3 * rng.normal(size=n)
         ).astype(np.float32)
    return fp, img, y, {**CFG, "dropout": 0.1}


@pytest.fixture(scope="module")
def jax_runs(toy):
    """The JAX package's three train_cv runs of this file, started together
    so that their XLA compiles overlap: {"deterministic", "bookkeeping",
    "dropout"} → CVResult."""
    fp, img, y, jm, warm, noise = toy
    d_fp, d_img, d_y, d_cfg = _dropout_set()
    calls = {
        "deterministic": lambda: jloop.train_cv(jm, (fp, img), y, warm_start=warm,
                                                **_deterministic_kw(fp)),
        "bookkeeping": lambda: jloop.train_cv(jm, (fp, img), noise,
                                              warm_start=warm, **BOOKKEEPING_KW),
        "dropout": lambda: jloop.train_cv(FlaxRegressor(**d_cfg), (d_fp, d_img),
                                          d_y, **DROPOUT_KW),
    }
    with ThreadPoolExecutor(len(calls)) as pool:
        futures = {k: pool.submit(f) for k, f in calls.items()}
        return {k: f.result() for k, f in futures.items()}


def _both(toy, want, noise=False, **kw):
    fp, img, y, jm, warm, y_noise = toy
    if noise:
        y = y_noise
    got = tloop.train_cv(MultiModalRegressor(dtype=torch.float32, image_size=SIDE,
                                             **CFG),
                         (fp, img), y, warm_start=warm, device="cpu", **kw)
    assert np.array_equal(got.fold_of, want.fold_of)
    assert all(np.array_equal(a, b) for a, b in zip(got.fold_test_idx,
                                                    want.fold_test_idx))
    return want, got


def test_deterministic_train_cv_equals_jax(toy, jax_runs):
    """3 folds, 5 epochs, snapshots from epoch 3, a per-fold affine on the
    fingerprints: OOF predictions and every fold's epoch losses agree."""
    want, got = _both(toy, jax_runs["deterministic"], **_deterministic_kw(toy[0]))
    assert got.train_losses.shape == (3, 5)
    np.testing.assert_allclose(got.train_losses, want.train_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got.oof_pred, want.oof_pred, rtol=0, atol=OOF_TOL)
    assert np.abs(want.oof_pred).max() > 0.3          # not a vacuous match
    assert {k: tuple(v.shape) for k, v in got.params.items()}[
        "cnn.Conv_0.kernel"] == (3, 32, 3, 3, 3)


def test_bookkeeping_equals_jax(toy, jax_runs):
    """Early stopping (patience 2, a fifth of each train split held out)
    on a target of noise, which the folds overfit within a few epochs; 2
    seed replicas with their own learning rate and weight decay on the fold
    axis: the same rows in each fold, the same epoch at which every fold
    had stopped improving (the losses' zero columns), each replica's OOF
    predictions from each fold's best parameters. (At learning rates that
    make the loss jump, e.g. 1e-2, the two runs' roundings part within a
    few epochs, so the replicas' rates stay at 3e-3 and 1e-3.)"""
    want, got = _both(toy, jax_runs["bookkeeping"], noise=True, **BOOKKEEPING_KW)
    stopped = (want.train_losses == 0).all(axis=0)
    assert stopped.any() and not stopped[0]              # it stopped early
    assert np.array_equal((got.train_losses == 0).all(axis=0), stopped)
    ran = ~stopped
    np.testing.assert_allclose(got.train_losses[:, ran], want.train_losses[:, ran],
                               rtol=LOSS_RTOL)
    assert got.oof_seeds.shape == (2, 96)
    np.testing.assert_allclose(got.oof_seeds, want.oof_seeds, rtol=0, atol=OOF_TOL)
    np.testing.assert_allclose(got.oof_pred, want.oof_pred, rtol=0, atol=OOF_TOL)


def _r2(y, pred):
    return 1.0 - float(((y - pred) ** 2).sum() / ((y - y.mean()) ** 2).sum())


def test_train_cv_with_dropout_learns_as_jax(jax_runs):
    """bf16, dropout 0.1, each side its own random init and dropout masks:
    the OOF R² of 3 folds × 2 seed replicas (8 epochs) within 0.06 of the
    JAX package's on a set whose target is linear in the fingerprint."""
    fp, img, y, cfg = _dropout_set()
    want = jax_runs["dropout"]
    got = tloop.train_cv(MultiModalRegressor(image_size=SIDE, **cfg), (fp, img), y,
                         device="cpu", **DROPOUT_KW)
    assert np.array_equal(got.fold_of, want.fold_of)
    r2_jax, r2_port = _r2(y, want.oof_pred), _r2(y, got.oof_pred)
    assert r2_jax > 0.5
    assert abs(r2_port - r2_jax) <= 0.06, (r2_port, r2_jax)


def test_train_cv_refuses_what_it_cannot_do(toy, monkeypatch):
    fp, img, y = toy[:3]
    model = MultiModalRegressor(image_size=SIDE, **CFG)
    with pytest.raises(ValueError, match="mesh"):
        tloop.train_cv(model, (fp, img), y, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="replica_hparams"):
        tloop.train_cv(model, (fp, img), y, n_folds=3, epochs=1, device="cpu",
                       replica_hparams={"b1": np.array([0.9])})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tloop.train_cv(model, (fp, img), y)


def test_train_multimodal_cv_is_train_cv(toy):
    fp, img, y, _, warm, _ = toy
    model = MultiModalRegressor(dtype=torch.float32, image_size=SIDE, **CFG)
    kw = dict(n_folds=3, epochs=2, batch_size=16, seed=0, warm_start=warm, device="cpu")
    a = tloop.train_multimodal_cv(model, fp, img, y, **kw)
    b = tloop.train_cv(model, (fp, img), y, **kw)
    assert np.array_equal(a.oof_pred, b.oof_pred)        # deterministic on the CPU


def test_inputs_keep_the_reference_device_types():
    assert tloop._device_dtype(np.zeros((4, 3), np.int64)) == torch.int32
    assert tloop._device_dtype(np.zeros((4, 3, 2), np.float32)) == torch.bfloat16
    assert tloop._device_dtype(np.zeros((4, 3), np.float64)) == torch.float32
