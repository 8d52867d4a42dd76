"""The port's meshes (``bbbp_tpu_torch/parallel/mesh.py``), ``train_cv``
over a mesh and the dry run (``entry.dryrun_multichip``), on the CPU with
gloo: each test starts 2 or 4 processes through ``launch``, under its own
time limit.

- ``make_mesh`` shapes as ``tests/test_models.py:101-111`` holds the JAX
  package's (4 ranks: data 4; model_parallel 2: data 2 × model 2), and a
  batch sharded over ``data`` keeps a quarter (a half) of its rows a rank.
- ``train_cv(mesh=dp 2)`` with dropout on equals the unsharded run within
  1e-6 (f32 model): OOF predictions, losses and final parameters. With K
  no multiple of the data axis every rank trains all K and says so.
- The dry run's 2 × 2 step (folds over ``data``, the wide dense kernels
  column-sharded over ``model``) equals one unsharded step of the same
  folds: in f32 the losses and every updated parameter within 1e-5. In
  bf16 (the dry run's default) the losses within 1e-5; a first AdamW step
  moves an element by ±lr · sign(g), and where a gradient is within bf16
  rounding of 0 the two runs' partial sums round it to either sign, so
  the parameters are held element by element within 1e-5 or within one
  step's flip (2 · lr + 1e-5), with the flips counted and at most 0.5%.
- Against the JAX package: the dry run's model from JAX's vmapped init
  (fold count 2, f32, dropout off), one sharded 2 × 2 step: per-fold losses
  within 1e-5; every parameter after the step within 1e-5 of its leaf's
  scale (the largest |value| of the leaf, at least 1) where JAX's gradient
  of it is at least 1e-6 in size. Below that a gradient is the two
  packages' rounding (one kernel element of the second convolution had
  3.7e-9 in JAX), which Adam's first step, lr · g / (|g| + 1e-8), turns
  into a step of either size and sign: those are held within one flip
  (2 · lr) and counted (at most 0.1%; seen 1).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
optax = pytest.importorskip("optax")

from bbbp_tpu_torch import entry  # noqa: E402
from bbbp_tpu_torch.parallel.mesh import launch, make_mesh  # noqa: E402
from bbbp_tpu_torch.testing import (mesh_layout_rank, mesh_prefetch_rank,  # noqa: E402
                                    mesh_train_cv_rank)

LIMIT_S = 240.0
GRAD_FLOOR = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops: one intra-op thread, as the test workers share
    the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_make_mesh_shapes():
    ranks = launch(mesh_layout_rank, 4, timeout=LIMIT_S)
    for view in ranks:
        assert view[1] == ({"data": 4, "model": 1}, (4, 4), (16, 4))
        assert view[2] == ({"data": 2, "model": 2}, (8, 4), (16, 4))


def test_prefetch_to_device_shards_over_the_mesh():
    """``prefetch_to_device(sharding=...)`` on a 2 × 2 gloo mesh: items in
    order; under ``batch_sharding`` each rank holds its data-rank's half of
    the rows (both model-ranks the same), under ``replicated`` all of it."""
    ranks = launch(mesh_prefetch_rank, 4, timeout=LIMIT_S)
    assert sorted(r["coords"] for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        d = r["coords"][0]
        assert len(r["batch"]) == len(r["replicated"]) == 5
        for i, (local, shape) in enumerate(r["batch"]):
            rows = 100.0 * i + np.arange(4 * d, 4 * d + 4, dtype=np.float32)
            assert shape == (8, 3)
            np.testing.assert_array_equal(local, np.repeat(rows[:, None], 3, axis=1))
        for i, (local, shape) in enumerate(r["replicated"]):
            assert shape == (4,)
            np.testing.assert_array_equal(local, np.full((4,), float(i), np.float32))


def test_shard_columns_turns_layers_into_their_sharded_forms():
    """``shard_columns`` keeps a model-rank's columns and turns each owning
    layer into its sharded form (``models/fold.py::dense`` holds no mesh
    logic); a kernel whose layer has no sharded form, or whose width the
    model axis does not divide, is refused before anything is sliced."""
    from bbbp_tpu_torch.models import MultiModalRegressor
    from bbbp_tpu_torch.parallel import mesh as pm

    net = MultiModalRegressor(**entry.DRYRUN_MODEL, image_size=entry.DRYRUN_SIDE,
                              folds=1, device="cpu")
    kernels = pm.wide_dense_kernels(net)
    assert kernels == ["enc0.ff1.kernel", "enc1.ff1.kernel",
                       "MultiHeadAttentionFusion_0.value_kernel", "Dense_0.kernel"]
    widths = {name: net.get_parameter(name).shape[-1] for name in kernels}
    whole = {name: net.get_parameter(name).detach().clone() for name in kernels}
    for bad, match in (("MultiHeadAttentionFusion_0.score_1_kernel",
                        "no column-sharded form"),
                       ("cnn.Conv_0.kernel", "no column-sharded form")):
        with pytest.raises(ValueError, match=match):
            pm.shard_columns(net, ["Dense_0.kernel", bad], None, 0, 2)
    with pytest.raises(ValueError, match="not a multiple of 3"):
        pm.shard_columns(net, ["Dense_0.kernel"], None, 0, 3)
    pm.shard_columns(net, kernels, None, 1, 2)
    for name in kernels:
        owner = net.get_submodule(name.rpartition(".")[0])
        want = (pm.ShardedHeadsFusion if name.startswith("MultiHead")
                else pm.ShardedDense)
        assert type(owner) is want and owner.column_shard.rank == 1, name
        w = widths[name] // 2
        assert torch.equal(net.get_parameter(name), whole[name][..., w:]), name


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()


def test_launch_raises_a_ranks_error():
    with pytest.raises(RuntimeError, match="not divisible"):
        launch(make_mesh, 2, None, 3, timeout=LIMIT_S)


def _cv_case(n_folds):
    rng = np.random.default_rng(0)
    n = 48
    fp = rng.standard_normal((n, 8)).astype(np.float32)
    img = rng.standard_normal((n, 8, 8, 3)).astype(np.float32)
    y = (fp[:, 0] - 0.5 * fp[:, 1]).astype(np.float32)
    model_kw = dict(fp_dim=8, n_layers=1, emb_dim=8, head_dims=(8,), image_size=8,
                    dtype=torch.float32, dropout=0.1)
    cv_kw = dict(n_folds=n_folds, epochs=3, batch_size=8, lr=1e-3, seed=0,
                 device="cpu", patience=2, snapshot_from=2)
    return model_kw, (fp, img), y, cv_kw


@pytest.mark.parametrize("n_folds", [4, 3])
def test_train_cv_over_a_mesh_equals_unsharded(n_folds, capfd):
    from bbbp_tpu_torch.models import MultiModalRegressor
    from bbbp_tpu_torch.train.loop import train_cv

    model_kw, inputs, y, cv_kw = _cv_case(n_folds)
    ranks = launch(mesh_train_cv_rank, 2, model_kw, inputs, y, cv_kw, timeout=LIMIT_S)
    want = train_cv(MultiModalRegressor(**model_kw), inputs, y, **cv_kw)
    for oof, losses, params in ranks:
        assert np.abs(oof - want.oof_pred).max() <= 1e-6
        assert np.abs(losses - want.train_losses).max() <= 1e-6
        assert set(params) == set(want.params)
        for name, value in params.items():
            assert value.shape == tuple(want.params[name].shape), name
            assert np.abs(value - want.params[name].numpy()).max() <= 1e-6, name
    printed = capfd.readouterr().out
    assert ("every rank trains all 3" in printed) == (n_folds == 3)


def _unsharded(dtype, params=None, dropout=None):
    return entry.dryrun_step(2, params=params, dropout=dropout, dtype=dtype,
                             device="cpu")


def test_dryrun_f32_2x2_equals_unsharded():
    loss, params = launch(entry.dryrun_rank, 4, 4, None, None, torch.float32,
                          timeout=LIMIT_S)[0]
    want_loss, want = _unsharded(torch.float32)
    assert np.abs(loss - want_loss).max() <= 1e-5
    assert set(params) == set(want)
    for name, value in params.items():
        assert value.shape == want[name].shape, name
        assert np.abs(value - want[name]).max() <= 1e-5, name


def test_dryrun_multichip_equals_unsharded(capfd):
    """``dryrun_multichip(4)`` as it runs here: 4 gloo processes, bf16,
    dropout on."""
    res = entry.dryrun_multichip(4, timeout=LIMIT_S)
    printed = capfd.readouterr().out
    assert "running 4 gloo processes on the CPU" in printed
    assert "dryrun_multichip(4): mesh={'data': 2, 'model': 2} loss=[" in printed
    assert res["mesh"] == {"data": 2, "model": 2} and res["backend"] == "gloo"
    want_loss, want = _unsharded(torch.bfloat16)
    assert np.abs(res["loss"] - want_loss).max() <= 1e-5
    flips, total = 0, 0
    for name, value in res["params"].items():
        d = np.abs(value - want[name])
        assert d.max() <= 2 * entry.DRYRUN_LR + 1e-5, name
        flips += int((d > 1e-5).sum())
        total += d.size
    assert flips <= 0.005 * total, (flips, total)


def test_dryrun_equals_jax_step():
    from bbbp_tpu.models.transformer_cnn import MultiModalRegressor as Flax
    from bbbp_tpu_torch.models import MultiModalRegressor
    from bbbp_tpu_torch.models.convert import flatten_tree, flax_from_params

    k, side, batch = 2, entry.DRYRUN_SIDE, entry.DRYRUN_BATCH
    model = Flax(dtype=jnp.float32, dropout=0.0, **entry.DRYRUN_MODEL)
    tx = optax.adamw(1e-3)
    fp1 = jnp.ones((2, entry.DRYRUN_MODEL["fp_dim"]))
    img1 = jnp.ones((2, side, side, 3))

    def init_one(key):
        return model.init({"params": key, "dropout": key}, fp1, img1, train=True)["params"]

    params = jax.jit(jax.vmap(init_one))(jax.random.split(jax.random.PRNGKey(0), k))
    fp = jnp.ones((k, batch, entry.DRYRUN_MODEL["fp_dim"]))
    img = jnp.ones((k, batch, side, side, 3))

    def fold_step(p, fp_b, img_b):
        def loss_fn(p):
            pred = model.apply({"params": p}, fp_b, img_b, train=False)
            return jnp.mean(pred ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return optax.apply_updates(p, updates), loss, grads

    new_params, want_loss, grads = jax.jit(jax.vmap(fold_step))(params, fp, img)
    init_np = jax.tree_util.tree_map(np.asarray, params)
    loss, got = launch(entry.dryrun_rank, 4, 4, init_np, 0.0, torch.float32,
                       timeout=LIMIT_S)[0]
    assert np.abs(loss - np.asarray(want_loss)).max() <= 1e-5

    port = MultiModalRegressor(dtype=torch.float32, dropout=0.0,
                               image_size=side, **entry.DRYRUN_MODEL)
    got_t = {name: torch.from_numpy(v) for name, v in got.items()}
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, new_params))
    g = flatten_tree(jax.tree_util.tree_map(np.asarray, grads))
    noise, total = 0, 0
    for i in range(k):
        fold = flatten_tree(flax_from_params(port, i, got_t))
        assert set(fold) == set(want)
        for path, value in fold.items():
            w = want[path][i]
            scale = max(1.0, float(np.abs(w).max()))
            d = np.abs(value - w)
            held = np.abs(g[path][i]) >= GRAD_FLOOR
            assert d[held].max(initial=0.0) <= 1e-5 * scale, path
            assert d.max() <= 2 * entry.DRYRUN_LR + 1e-5 * scale, path
            noise += int((d[~held] > 1e-5 * scale).sum())
            total += d.size
    assert noise <= 1e-3 * total, (noise, total)
