"""The port's flagship regressor (bbbp_tpu_torch.models) against the JAX
package's flax modules, at toy width (2 layers, 32 wide, 16 × 16 images).

Parameters made by flax from a seed are loaded into the port through
``models/convert.py``; inputs are made with numpy from a seed. Tolerances:

- forward, f32: 1e-5 absolute (outputs are O(0.1–1); the two sum in other
  orders, and the differences seen are ~3e-7);
- forward, bf16: 1e-2 absolute (flax and torch round bf16 at other places:
  flax's softmax runs in bf16, torch's in f32; a bias add rounds once in
  ``baddbmm`` and twice in flax; differences seen ~1e-3);
- one AdamW step against ``optax.adamw``: losses within 1e-6 relative;
  gradients within 1e-5 of the parameter's largest |gradient|; every
  parameter whose gradient is above 1e-4 in size within 1e-6 absolute (lr
  1e-3: 1e-3 of a step), the others within two steps (a first Adam step
  is lr·g/(|g| + 1e-8), so where g is near 0 it follows g's last bits: one
  element of 19,200 in a ReLU layer's kernel moved 2e-5 apart);
- the optimizer alone against optax over 12 steps: 1e-6 relative.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu_torch.models import MultiModalRegressor  # noqa: E402
from bbbp_tpu_torch.models.convert import (load_flax, matching_params,  # noqa: E402
                                           params_from_flax)
from bbbp_tpu_torch.train import loop as tloop  # noqa: E402

TOY = dict(fp_dim=40, n_layers=2, emb_dim=32, head_dims=(32, 16))
SIDE = 16
CASES = {
    "multihead": dict(fusion="multihead"),
    "gate": dict(fusion="gate"),
    "crossmodal": dict(fusion="crossmodal"),
    "multihead_tokens": dict(fusion="multihead", fp_tokens=4),
    "gate_tokens": dict(fusion="gate", fp_tokens=4),
    "crossmodal_tokens": dict(fusion="crossmodal", fp_tokens=4),
    "wide_fp": dict(fusion="multihead", fp_dim=600, max_fp_width=64),
    "flat_image": dict(fusion="crossmodal", flat=True),
}
DTYPES = {"f32": ("float32", torch.float32, 1e-5),
          "bf16": ("bfloat16", torch.bfloat16, 1e-2)}
STEP_CFG = {**TOY, "fusion": "multihead", "dropout": 0.0}


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported by a fixture so that the CUDA test below also
    runs where JAX is absent (the card's machine)."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    optax = pytest.importorskip("optax")
    from bbbp_tpu.models.transformer_cnn import MultiModalRegressor as Flax
    from bbbp_tpu.train import loop as jloop

    step_model = Flax(dtype=jnp.float32, **STEP_CFG)

    @jax.jit
    def optax_step(p, fp, img, y, lr, wd):
        """One fold's loss, gradients and parameters after one
        ``optax.adamw`` step."""
        def loss_fn(p):
            pred = step_model.apply({"params": p}, fp, img, train=True,
                                    rngs={"dropout": jax.random.PRNGKey(0)})
            return jnp.mean((pred - y) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        tx = optax.inject_hyperparams(optax.adamw)(learning_rate=lr, weight_decay=wd)
        updates, _ = tx.update(grads, tx.init(p), p)
        return loss, grads, optax.apply_updates(p, updates)

    return SimpleNamespace(jax=jax, jnp=jnp, optax=optax, Flax=Flax, jloop=jloop,
                           step_model=step_model, optax_step=optax_step)


def _config(case):
    cfg = {**TOY, **CASES[case]}
    flat = cfg.pop("flat", False)
    return cfg, flat


def _inputs(cfg, n, seed, flat=False):
    rng = np.random.default_rng(seed)
    fp = rng.normal(size=(n, cfg["fp_dim"])).astype(np.float32)
    img = rng.random((n, SIDE, SIDE, 3)).astype(np.float32)
    return fp, (img.reshape(n, -1) if flat else img)


def _flax_params(jx, model, fp, img, seed):
    """A params tree of ``model``'s structure (``jax.eval_shape`` of its
    init, no compile) filled from numpy: kernels ~ N(0, 1/fan_in), LayerNorm
    scales ~ 1 + N(0, 0.1²), biases and ``pos_emb`` ~ N(0, 0.1²)."""
    jax = jx.jax
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), fp[:2], img[:2])
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes["params"])


def _flax_apply(jx, model, params, fp, img):
    return np.asarray(jx.jax.jit(model.apply)({"params": params}, fp, img), np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_equals_flax(jx, case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    cfg, flat = _config(case)
    fp, img = _inputs(cfg, 6, 0, flat)
    jm = jx.Flax(dtype=getattr(jx.jnp, jdt), **cfg)
    params = _flax_params(jx, jm, fp, img, 1)
    want = _flax_apply(jx, jm, params, fp, img)
    model = load_flax(MultiModalRegressor(dtype=tdt, image_size=SIDE, **cfg), params)
    with torch.no_grad():
        got = model(torch.from_numpy(fp), torch.from_numpy(img))
    assert got.dtype == torch.float32 and tuple(got.shape) == (6,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("case", ["multihead", "gate_tokens", "wide_fp"])
def test_each_fold_is_its_own_flax_model(jx, case):
    """K = 3 trees stacked on the fold axis: fold k of [K, B, ...] inputs is
    tree k on its own rows; inputs without a fold axis go to every fold."""
    cfg, _ = _config(case)
    jm = jx.Flax(dtype=jx.jnp.float32, **cfg)
    fp, img = _inputs(cfg, 3 * 5, 2)
    trees = [_flax_params(jx, jm, fp, img, key) for key in (3, 4, 5)]
    model = load_flax(MultiModalRegressor(dtype=torch.float32, image_size=SIDE,
                                          folds=3, **cfg), trees)
    fp_k, img_k = fp.reshape(3, 5, -1), img.reshape(3, 5, SIDE, SIDE, 3)
    with torch.no_grad():
        own = model(torch.from_numpy(fp_k), torch.from_numpy(img_k)).numpy()
        shared = model(torch.from_numpy(fp_k[0]), torch.from_numpy(img_k[0])).numpy()
    apply = jx.jax.jit(jm.apply)
    for k, tree in enumerate(trees):
        want = np.asarray(apply({"params": tree}, fp_k[k], img_k[k]))
        np.testing.assert_allclose(own[k], want, rtol=0, atol=1e-5)
        want0 = np.asarray(apply({"params": tree}, fp_k[0], img_k[0]))
        np.testing.assert_allclose(shared[k], want0, rtol=0, atol=1e-5)


def _toy_tree(jx, case="multihead_tokens"):
    cfg, _ = _config(case)
    fp, img = _inputs(cfg, 2, 0)
    return cfg, _flax_params(jx, jx.Flax(**cfg), fp, img, 0)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "count"])
def test_loader_refuses_a_tree_that_does_not_fit(jx, fault):
    cfg, tree = _toy_tree(jx)
    model = MultiModalRegressor(image_size=SIDE, folds=2, **cfg)
    if fault == "missing":
        del tree["enc1"]["MultiHeadDotProductAttention_0"]["key"]["bias"]
    elif fault == "extra":
        tree["fp_fc"]["scale"] = np.ones(32, np.float32)
    elif fault == "shape":
        tree["cnn"]["Conv_1"]["kernel"] = tree["cnn"]["Conv_1"]["kernel"][:, :, :16]
    trees = [tree] * 3 if fault == "count" else tree
    with pytest.raises(ValueError):
        params_from_flax(model, trees)
    if fault == "missing":     # a warm start takes the rest
        got = matching_params(model, tree)
        assert "enc1.MultiHeadDotProductAttention_0.key.bias" not in got
        assert len(got) == len(list(model.parameters())) - 1


def test_loader_layouts(jx):
    """Dense kernels stay [in, out], convolutions turn HWIO → OIHW, the
    fusion's heads lie side by side; one tree fills every fold."""
    cfg, tree = _toy_tree(jx, "multihead")
    p = params_from_flax(MultiModalRegressor(image_size=SIDE, folds=2, **cfg), tree)
    conv = tree["cnn"]["Conv_0"]["kernel"]                  # [3, 3, 3, 32]
    assert np.array_equal(p["cnn.Conv_0.kernel"][1].numpy(), conv.transpose(3, 2, 0, 1))
    assert np.array_equal(p["enc0.ff1.kernel"][0].numpy(), tree["enc0"]["ff1"]["kernel"])
    fusion = tree["MultiHeadAttentionFusion_0"]
    v = p["MultiHeadAttentionFusion_0.value_kernel"][0].numpy()
    assert np.array_equal(v[:, 64:128], fusion["value1"]["kernel"])
    s2 = p["MultiHeadAttentionFusion_0.score_2_kernel"][0].numpy()
    assert np.array_equal(s2[3], fusion["score3_2"]["kernel"][:, 0])


def test_initializers_are_flax_initializers(jx):
    """Every parameter's mean and spread are flax's at init (lecun-normal
    kernels, zero biases, unit LayerNorm scales, pos_emb normal(0.02)), 4
    folds against 4 flax inits: means within 5 standard errors, spreads
    within 10% + 3/√n (n the parameter's size)."""
    cfg = {**TOY, "fp_tokens": 4, "fusion": "multihead"}
    fp, img = _inputs(cfg, 2, 0)
    jax = jx.jax
    init = jax.jit(jax.vmap(jx.Flax(**cfg).init, in_axes=(0, None, None)))
    stacked = init(jax.random.split(jax.random.PRNGKey(0), 4), fp, img)["params"]
    trees = [jax.tree.map(lambda a, k=k: np.asarray(a[k]), stacked) for k in range(4)]
    model = MultiModalRegressor(image_size=SIDE, folds=4,
                                generator=torch.Generator().manual_seed(0), **cfg)
    want = params_from_flax(model, trees)
    for name, p in model.named_parameters():
        w, n = want[name], p.numel()
        spread = float(w.std())
        assert float(p.detach().mean()) == pytest.approx(
            float(w.mean()), abs=5 * spread / n ** 0.5 + 1e-7), name
        assert float(p.detach().std()) == pytest.approx(
            spread, rel=0.1 + 3 / n ** 0.5, abs=1e-7), name


@pytest.mark.parametrize("per_replica", [False, True])
def test_one_adamw_step_equals_optax(jx, per_replica):
    """K = 3 folds, each its own flax tree and batch, dropout 0, f32: the
    folds' losses and every parameter after one step of the port's AdamW
    equal ``optax.adamw``'s, with one lr / wd or one a fold."""
    fp, img = _inputs(STEP_CFG, 3 * 8, 7)
    y = np.random.default_rng(8).normal(size=24).astype(np.float32)
    trees = [_flax_params(jx, jx.step_model, fp, img, key) for key in (1, 2, 3)]
    lrs = [1e-3, 3e-4, 2e-3] if per_replica else [1e-3] * 3
    wds = [1e-5, 1e-2, 0.0] if per_replica else [1e-5] * 3
    fp_k, img_k, y_k = fp.reshape(3, 8, -1), img.reshape(3, 8, SIDE, SIDE, 3), y.reshape(3, 8)
    want_loss, want_grads, want_trees = [], [], []
    for k, tree in enumerate(trees):
        loss, grads, new = jx.optax_step(tree, fp_k[k], img_k[k], y_k[k], lrs[k], wds[k])
        want_loss.append(float(loss))
        want_grads.append(jx.jax.tree.map(np.asarray, grads))
        want_trees.append(jx.jax.tree.map(np.asarray, new))

    model = load_flax(MultiModalRegressor(dtype=torch.float32, image_size=SIDE,
                                          folds=3, **STEP_CFG), trees)
    params = list(model.parameters())
    opt = tloop.AdamW(params, torch.tensor(lrs), torch.tensor(wds))
    pred = model(torch.from_numpy(fp_k), torch.from_numpy(img_k), train=True)
    loss = ((pred - torch.from_numpy(y_k)) ** 2).mean(dim=1)
    grads = torch.autograd.grad(loss.sum(), params)
    opt.step(grads)
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, rtol=1e-6)
    want_g, want = params_from_flax(model, want_grads), params_from_flax(model, want_trees)
    step = np.asarray(lrs, np.float32).reshape(3, *[1] * 4)
    for (name, p), g in zip(model.named_parameters(), grads):
        wg = want_g[name].numpy()
        np.testing.assert_allclose(g.numpy(), wg, rtol=0,
                                   atol=1e-5 * np.abs(wg).max(), err_msg=name)
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        steady = np.abs(wg) > 1e-4
        assert diff[steady].max(initial=0) <= 1e-6, name
        assert (diff <= 2 * step.reshape(3, *[1] * (diff.ndim - 1))).all(), name


@pytest.mark.parametrize("period", [0, 3])
def test_optimizer_equals_optax_over_steps(jx, period):
    """``make_optimizer`` (and its cosine warm restarts) against the JAX
    package's over 12 steps of random gradients, on [K, ...] parameters."""
    rng = np.random.default_rng(period)
    shapes = [(3, 5, 4), (3, 4), (3, 2, 3, 3, 3)]
    ps = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = jx.jloop.make_optimizer(2e-3, 1e-2, warm_restart_period=period)
    state = tx.init(ps)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in ps]
    opt = tloop.make_optimizer(2e-3, 1e-2, warm_restart_period=period)(params)
    for _ in range(12):
        gs = [rng.normal(size=s).astype(np.float32) * 1e-2 for s in shapes]
        updates, state = tx.update(gs, state, ps)
        ps = [np.asarray(a) for a in jx.optax.apply_updates(ps, updates)]
        opt.step([torch.from_numpy(g) for g in gs])
    for p, want in zip(params, ps):
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6, atol=1e-7)


def test_entry_runs_on_cpu_and_defaults_to_cuda(monkeypatch):
    from bbbp_tpu_torch.entry import entry

    forward, args = entry("cpu")
    out = forward(*args)
    assert tuple(out.shape) == (8,) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert sum(p.numel() for p in args[0].parameters()) > 9_000_000
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_forward_and_step_on_cuda_equal_cpu(cuda_device):
    """With TF32 off, the port's forward on the card equals the CPU's (f32
    within 1e-5, bf16 within 1e-2) for every case, and one f32 training
    step of 3 folds (loss, gradients and every parameter) under the
    tolerances of the optax comparison above."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for case in sorted(CASES):
        cfg, flat = _config(case)
        fp, img = (torch.from_numpy(a) for a in _inputs(cfg, 6, 0, flat))
        for _, tdt, tol in DTYPES.values():
            model = MultiModalRegressor(dtype=tdt, image_size=SIDE,
                                        generator=torch.Generator().manual_seed(1), **cfg)
            with torch.no_grad():
                want = model(fp, img)
                got = model.to(cuda_device)(fp.to(cuda_device), img.to(cuda_device))
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                                       atol=tol, err_msg=case)
    cfg = {**TOY, "dropout": 0.0}
    fp, img = _inputs(cfg, 3 * 8, 7)
    y = torch.from_numpy(np.random.default_rng(8).normal(size=(3, 8)).astype(np.float32))
    fp_k = torch.from_numpy(fp.reshape(3, 8, -1))
    img_k = torch.from_numpy(img.reshape(3, 8, SIDE, SIDE, 3))
    results = []
    for dev in (torch.device("cpu"), cuda_device):
        model = MultiModalRegressor(dtype=torch.float32, image_size=SIDE, folds=3,
                                    generator=torch.Generator().manual_seed(2), **cfg).to(dev)
        params = list(model.parameters())
        opt = tloop.AdamW(params, 1e-3, 1e-5)
        loss = ((model(fp_k.to(dev), img_k.to(dev), train=True) - y.to(dev)) ** 2).mean(1)
        grads = torch.autograd.grad(loss.sum(), params)
        opt.step(grads)
        g = torch.cat([gr.reshape(3, -1) for gr in grads], 1)
        results.append((loss.detach().cpu(), g.cpu(), opt.flat.cpu()))
    (loss0, g0, p0), (loss1, g1, p1) = results
    np.testing.assert_allclose(loss1.numpy(), loss0.numpy(), rtol=1e-6)
    assert float((g1 - g0).abs().max()) <= 1e-5 * float(g0.abs().max())
    diff = (p1 - p0).abs()
    assert float(diff[g0.abs() > 1e-4].max()) <= 1e-6
    assert float(diff.max()) <= 2e-3
