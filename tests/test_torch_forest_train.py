"""Port parity: forest training (bbbp_tpu_torch.ops.forest_train against
bbbp_tpu.ops.forest_tpu and bbbp_tpu.ops.forest on the CPU), the kernel
wrappers' checks, and one CUDA test of the three kernels."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu_torch.ops import forest_train as tr  # noqa: E402
from bbbp_tpu_torch.testing import compare_gbdt_fits, mixed_level_case  # noqa: E402


# The JAX package is the reference; it is imported by fixtures so that the
# CUDA test below also runs where JAX is absent (on the card's machine).
@pytest.fixture(scope="module")
def jnp():
    return pytest.importorskip("jax.numpy")


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def jft():
    return pytest.importorskip("bbbp_tpu.ops.forest_tpu")


@pytest.fixture
def jft_exact(jft, monkeypatch):
    """The JAX trainer at exact row counts (no power-of-2 row padding)."""
    monkeypatch.setattr(jft, "ROW_BUCKETING", False)
    return jft


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _features(rng, n, n_feat, n_constant=0):
    x = rng.normal(size=(n, n_feat)).astype(np.float32)
    x[:, 1::3] = np.round(x[:, 1::3], 1)          # repeated values: ties
    x[:, :n_constant] = 0.5                       # constant: every gain ties
    return x


def _regression(seed, n=500, n_feat=16):
    rng = np.random.default_rng(seed)
    x = _features(rng, n, n_feat)
    y = (np.sin(x[:, 0]) + x[:, 1] * x[:, 2] + 0.5 * x[:, 3]
         + 0.3 * rng.normal(size=n)).astype(np.float32)
    return x, y


# -- binning -------------------------------------------------------------------

@pytest.mark.parametrize("seed,n,n_feat", [(0, 500, 8), (1, 37, 5), (2, 3000, 3)])
def test_bin_mapper_and_edge_values_equal_to_jax(seed, n, n_feat, jft):
    """Bit-equal codes, edges and the [F, 64] edge table (+inf past each
    feature's last edge) on features with ties and a constant column."""
    x = _features(np.random.default_rng(seed), n, n_feat, n_constant=1)
    ours = tr.BinMapper().fit(x)
    ref = jft.TPUGBDTRegressor()
    ref_xb, ref_edges = ref._prepare(x)
    assert np.array_equal(ours.transform(x), np.asarray(ref_xb))
    for a, b in zip(ours.edges_, ref.mapper_.edges_):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    table = ours.edge_values()
    assert np.array_equal(table, np.asarray(ref_edges))
    assert np.isinf(table[0, tr.MAX_BINS - 1])


# -- K3 and K4 plain versions against one JAX level ------------------------------

def _level_inputs(seed, n, n_feat, level, n_constant=0, zero_share=0.2):
    rng = np.random.default_rng(seed)
    xb = rng.integers(0, tr.MAX_BINS, size=(n, n_feat)).astype(np.uint8)
    xb[:, :n_constant] = 7
    pos = rng.integers(0, 1 << level, size=n).astype(np.int32)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.05, 0.3, size=n).astype(np.float32)
    zero = rng.random(n) < zero_share               # zero-weight rows
    g[zero] = 0.0
    h[zero] = 0.0
    return xb, pos, g, h


def _jax_chunks(jft, jnp, xb, col_mask):
    """xb and the column mask as _fit_forest_device pads and chunks them."""
    n, n_feat = xb.shape
    fc = min(jft.F_CHUNK, jft._pad128(n_feat))
    pad = (-n_feat) % fc
    xb_chunks = jnp.pad(jnp.asarray(xb, jnp.int32), ((0, 0), (0, pad)))
    xb_chunks = xb_chunks.reshape(n, -1, fc).transpose(1, 0, 2)
    mask = jnp.pad(jnp.asarray(col_mask), (0, pad)).reshape(-1, fc)
    return xb_chunks, mask, fc


@pytest.mark.parametrize("n,n_feat,level", [(300, 5, 0), (1000, 16, 3),
                                            (200, 300, 1), (64, 30, 5)])
def test_level_histogram_reference_equals_jax_scatter(n, n_feat, level, jft,
                                                      jax, jnp):
    """Exact equality with the scatter engine's segment_sum (both sum each
    bin in row order in f32), zero-weight rows included; F = 300 spans two
    of the reference's feature chunks."""
    xb, pos, g, h = _level_inputs(n + n_feat, n, n_feat, level)
    xb_chunks, _, fc = _jax_chunks(jft, jnp, xb, np.ones(n_feat, bool))
    nodes = 1 << level
    local = jnp.arange(fc, dtype=jnp.int32)[None, :] * tr.MAX_BINS
    vals = jnp.broadcast_to(jnp.stack([g, h], axis=1)[:, None, :], (n, fc, 2))
    ref = []
    for c in range(xb_chunks.shape[0]):
        keys = jnp.asarray(pos)[:, None] * (fc * tr.MAX_BINS) + local + xb_chunks[c]
        hist = jax.ops.segment_sum(vals.reshape(-1, 2), keys.ravel(),
                                   num_segments=nodes * fc * tr.MAX_BINS)
        ref.append(np.asarray(hist).reshape(nodes, fc, tr.MAX_BINS, 2))
    ref = np.concatenate(ref, axis=1)[:, :n_feat]
    got = tr.level_histogram_reference(torch.from_numpy(xb), torch.from_numpy(pos),
                                       torch.from_numpy(g), torch.from_numpy(h),
                                       nodes)
    assert np.array_equal(got.numpy(), ref)


def test_cumsum_order_equals_jax(jnp):
    """The bin sums are taken in the reference's order, bit for bit, at the
    shapes the reference's chunks have."""
    rng = np.random.default_rng(5)
    for shape in ((32, 30, 64), (4, 128, 64), (1, 256, 64)):
        x = (rng.normal(size=shape) * rng.random(shape) ** 4).astype(np.float32)
        want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=2))
        assert np.array_equal(tr._cumsum_bins(torch.from_numpy(x)).numpy(), want)


LEVEL_CASES = {
    # name: (seed, n, F, level, n_constant, lam, min_child, col share, oblivious)
    "plain": (0, 2000, 12, 3, 0, 1.0, 1.0, 1.0, False),
    "constant_features": (1, 800, 6, 2, 6, 1.0, 1.0, 1.0, False),
    "some_constant": (2, 800, 9, 4, 3, 1.0, 0.0, 1.0, False),
    "min_child": (3, 400, 8, 3, 0, 1.0, 2.5, 1.0, False),
    "col_mask": (4, 1000, 20, 2, 0, 1.0, 1.0, 0.3, False),
    "oblivious": (5, 1500, 10, 3, 0, 1.0, 1.0, 1.0, True),
    "oblivious_masks": (6, 600, 10, 4, 2, 0.5, 4.0, 0.5, True),
    "rf_lambda": (7, 700, 16, 5, 0, 1e-6, 1.0, 1.0, False),
}


@pytest.mark.parametrize("case", list(LEVEL_CASES))
def test_best_splits_reference_equals_jax_grow_level(case, jft, jnp):
    """Same feat, bin and has_split as ``_grow_level`` on the same pos, g
    and h, at every node; exact ties (constant features) go to the first
    index in both. Zero-weight rows are in every case."""
    seed, n, n_feat, level, n_const, lam, min_child, share, obl = LEVEL_CASES[case]
    xb, pos, g, h = _level_inputs(seed, n, n_feat, level, n_const)
    mask = np.random.default_rng(seed).random(n_feat) < share
    mask[n_feat - 1] = True
    xb_chunks, mask_chunks, _ = _jax_chunks(jft, jnp, xb, mask)
    jf, jb, js = jft._grow_level(jnp.asarray(pos), xb_chunks, jnp.asarray(g),
                                 jnp.asarray(h), level, tr.MAX_BINS, lam,
                                 min_child, mask_chunks, obl)
    hist = tr.level_histogram_reference(torch.from_numpy(xb), torch.from_numpy(pos),
                                        torch.from_numpy(g), torch.from_numpy(h),
                                        1 << level)
    f, b, s = tr.best_splits(hist, torch.from_numpy(mask), lam, min_child, obl)
    assert np.array_equal(f.numpy(), np.asarray(jf))
    assert np.array_equal(b.numpy(), np.asarray(jb))
    assert np.array_equal(s.numpy(), np.asarray(js))
    if case == "constant_features":
        assert not s.any()
        assert (b.numpy() == tr.MAX_BINS - 1).all()
    if not obl:
        assert s.any() or case == "constant_features"


# -- whole fits ----------------------------------------------------------------

def _state(ens):
    return {"feat": np.asarray(ens.feat), "thr": np.asarray(ens.thr),
            "leaf": np.asarray(ens.leaf), "depth": ens.depth}


@pytest.mark.parametrize("kind", ["regressor", "classifier"])
def test_deterministic_fit_grows_the_jax_trees(kind, jft_exact):
    """500 × 16, 20 trees of depth 4, subsample = colsample = 1. All 20
    trees are compared and every one of their 300 nodes has the reference's
    (feat, thr): the port sums bins and margins in the reference's order, so
    no near tie is allowed here. Leaves within 1e-5; margins within 1e-5."""
    x, y = _regression(11)
    if kind == "classifier":
        y = (y > np.median(y)).astype(np.float32)
    kw = dict(n_estimators=20, max_depth=4, learning_rate=0.3, seed=3,
              subsample=1.0, colsample=1.0)
    ref_cls, our_cls = ((jft_exact.TPUGBDTRegressor, tr.GBDTRegressor)
                        if kind == "regressor" else
                        (jft_exact.TPUGBDTClassifier, tr.GBDTClassifier))
    ref = ref_cls(**kw).fit(x, y)
    ours = our_cls(device="cpu", **kw).fit(x, y)
    assert ours.ensemble_.base_score == ref.ensemble_.base_score
    assert ours.ensemble_.tree_scale == ref.ensemble_.tree_scale
    cmp = compare_gbdt_fits(
        x, y, _state(ref.ensemble_), _state(ours.ensemble_),
        task="reg" if kind == "regressor" else "cls", lam=1.0, min_child=1.0,
        learning_rate=0.3, base_score=ref.ensemble_.base_score, tol=1e-6)
    assert cmp.ok and cmp.trees_compared == 20, cmp
    assert cmp.equal == 20 * 15, cmp
    assert cmp.max_leaf_diff <= 1e-5
    q = _regression(12, n=200)[0]
    got = ours.decision_function(q) if kind == "classifier" else ours.predict(q)
    want = (ref.decision_function(q) if kind == "classifier" else ref.predict(q))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_audit_along_a_fit_checks_every_node():
    """``compare_gbdt_fits(ref=None)`` replays a fit along its own splits:
    the port's CPU fit is the plain best split at every node, and a split
    moved to another feature is found as a mismatch at that node."""
    x, y = _regression(13, n=400, n_feat=6)
    kw = dict(n_estimators=8, max_depth=3, learning_rate=0.3, subsample=1.0)
    fit = tr.GBDTRegressor(device="cpu", **kw).fit(x, y)
    state = fit.ensemble_.to_state()
    args = dict(task="reg", lam=1.0, min_child=1.0, learning_rate=0.3,
                base_score=fit.ensemble_.base_score, tol=1e-6)
    audit = compare_gbdt_fits(x, y, None, state, **args)
    assert audit.ok and audit.trees_compared == 8
    assert audit.equal == 8 * 7 and audit.near_ties == 0
    assert audit.max_leaf_diff <= 1e-6
    bad = {**state, "feat": state["feat"].copy(), "thr": state["thr"].copy()}
    bad["feat"][5, 0] = (bad["feat"][5, 0] + 1) % 6
    bad["thr"][5, 0] = np.float32(np.median(x[:, bad["feat"][5, 0]]))
    assert compare_gbdt_fits(x, y, None, bad, **args).mismatch == (5, 0)


def _r2(y, p):
    return 1 - ((y - p) ** 2).sum() / ((y - y.mean()) ** 2).sum()


STAT_CASES = {
    "rf_regressor": ("RandomForestRegressor", dict(n_estimators=40, max_depth=6)),
    "rf_classifier": ("RandomForestClassifier", dict(n_estimators=100, max_depth=6)),
    "gbdt_subsample": ("GBDTRegressor", dict(n_estimators=40, max_depth=4,
                                             learning_rate=0.2, subsample=0.7,
                                             colsample=0.6)),
    "gbdt_classifier_subsample": ("GBDTClassifier", dict(
        n_estimators=40, max_depth=4, learning_rate=0.2, subsample=0.8)),
    "gbdt_oblivious": ("GBDTRegressor", dict(n_estimators=40, max_depth=4,
                                             learning_rate=0.2, oblivious=True)),
}
STAT_SEEDS = (0, 1, 2)


@pytest.mark.parametrize("case", list(STAT_CASES))
def test_random_fits_match_jax_statistically(case, jft_exact):
    """Random forests, subsampled and oblivious fits on 800 training rows:
    held-out R² (or accuracy, 400 rows) averaged over three seeds within
    0.03 of the JAX fits'. The two RNG streams differ, so the trees do not;
    the same seed gives the same model on the port."""
    name, kw = STAT_CASES[case]
    rng = np.random.default_rng(21)
    x = _features(rng, 1200, 10)
    y = (2 * np.sin(x[:, 0]) + x[:, 3] + 0.5 * x[:, 1]
         + 0.2 * rng.normal(size=1200)).astype(np.float32)
    cls = "Classifier" in name
    if cls:
        y = (y > np.median(y)).astype(np.float32)
    xt, yt, x, y = x[800:], y[800:], x[:800], y[:800]

    def score(model):
        if cls:
            assert np.allclose(model.predict_proba(xt).sum(axis=1), 1.0)
            return (model.predict(xt) == yt).mean()
        return _r2(yt, model.predict(xt))

    ours = [getattr(tr, name)(seed=s, device="cpu", **kw).fit(x, y)
            for s in STAT_SEEDS]
    again = getattr(tr, name)(seed=STAT_SEEDS[0], device="cpu", **kw).fit(x, y)
    for key in ("feat", "thr", "leaf"):
        assert torch.equal(getattr(ours[0].ensemble_, key),
                           getattr(again.ensemble_, key))
    port = np.mean([score(m) for m in ours])
    ref = np.mean([score(getattr(jft_exact, "TPU" + name)(seed=s, **kw).fit(x, y))
                   for s in STAT_SEEDS])
    print(f"{case}: port {port:.4f}, jax {ref:.4f}")
    assert abs(port - ref) <= 0.03
    assert port > (0.8 if cls else 0.85)


def test_zero_weight_rows_are_ignored():
    """As tests/test_forest_tpu.py checks the JAX trainer: rows of weight 0
    with wild labels change nothing; without the weights they do."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(120, 6)).astype(np.float32)
    y = (x[:, 0] - 2 * x[:, 1]).astype(np.float32)
    w = np.ones(120, np.float32)
    w[80:] = 0.0
    kw = dict(n_estimators=30, max_depth=3, learning_rate=0.3, seed=5,
              subsample=1.0, device="cpu")
    q = rng.normal(size=(20, 6)).astype(np.float32)
    p_w = tr.GBDTRegressor(**kw).fit(x, y, sample_weight=w).predict(q)
    y2 = y.copy()
    y2[80:] = 100.0
    p_w2 = tr.GBDTRegressor(**kw).fit(x, y2, sample_weight=w).predict(q)
    np.testing.assert_allclose(p_w, p_w2, rtol=1e-5, atol=1e-5)
    p_all = tr.GBDTRegressor(**kw).fit(x, y2).predict(q)
    assert np.abs(p_all - p_w).max() > 1.0


def test_estimator_defaults_and_params_match_jax(jft):
    pairs = [(tr.GBDTRegressor(), jft.TPUGBDTRegressor()),
             (tr.GBDTClassifier(), jft.TPUGBDTClassifier()),
             (tr.RandomForestRegressor(), jft.TPURandomForestRegressor()),
             (tr.RandomForestClassifier(), jft.TPURandomForestClassifier())]
    for ours, ref in pairs:
        params = ours.get_params()
        assert params.pop("device") == "cuda"
        assert params == ref.get_params()
    assert tr.RandomForestClassifier().set_params(seed=9).seed == 9


def test_depth_zero_fit_is_the_mean():
    x, y = _regression(4, n=50, n_feat=4)
    m = tr.GBDTRegressor(n_estimators=3, max_depth=0, learning_rate=1.0,
                         device="cpu").fit(x, y)
    np.testing.assert_allclose(m.predict(x[:5]), np.full(5, y.mean()), atol=1e-5)



# -- K3's fixed-point arithmetic, in torch -------------------------------------

def _level_tensors(args):
    return [torch.from_numpy(a) for a in args]


FIXED_CASES = [(300, 5, 0), (1000, 16, 3), (200, 300, 1), (64, 30, 5)]


@pytest.mark.parametrize("n,n_feat,level", FIXED_CASES)
def test_fixed_point_histogram_within_stated_error_of_float64_sum(n, n_feat, level):
    """K3's stated error: one f32 rounding of the exact sum (2.4e-7 |sum|)
    plus the quantisation of n values at 2^-62 of n max|v| (far below
    1e-9 n max|v|)."""
    xb, pos, g, h = _level_tensors(_level_inputs(n + n_feat, n, n_feat, level))
    nodes = 1 << level
    got = tr.level_histogram_fixed_reference(xb, pos, g, h, nodes,
                                             tr.gradient_bounds(g, h))
    exact = tr.level_histogram_reference(xb, pos, g.double(), h.double(), nodes)
    assert got.dtype == torch.float32 and got.shape == (nodes, n_feat, 64, 2)
    vmax = max(float(g.abs().max()), float(h.abs().max()))
    assert ((got.double() - exact).abs()
            <= 2.4e-7 * exact.abs() + 1e-9 * n * vmax).all()
    assert torch.equal(got == 0, exact == 0)        # empty bins read 0


@pytest.mark.parametrize("seed", [0, 1])
def test_fixed_point_histogram_bit_equal_under_row_permutation(seed):
    """Integer sums do not depend on the order of the rows; the plain f32
    sum does (which is why the kernel is not held against it bit for bit)."""
    xb, pos, g, h = _level_tensors(_level_inputs(seed, 4000, 6, 2))
    bounds = tr.gradient_bounds(g, h)
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(4000))
    a = tr.level_histogram_fixed_reference(xb, pos, g, h, 4, bounds)
    b = tr.level_histogram_fixed_reference(xb[perm].contiguous(), pos[perm],
                                           g[perm], h[perm], 4, bounds)
    assert torch.equal(a, b)
    plain = tr.level_histogram_reference(xb, pos, g, h, 4)
    plain_perm = tr.level_histogram_reference(xb[perm].contiguous(), pos[perm],
                                              g[perm], h[perm], 4)
    assert not torch.equal(plain, plain_perm)


@pytest.mark.parametrize("n,n_feat,level", FIXED_CASES)
def test_fixed_point_histogram_equals_jax_scatter(n, n_feat, level, jax, jnp):
    """Against the scatter engine's segment_sum on the inputs of
    ``test_level_histogram_reference_equals_jax_scatter``. That test holds
    the plain version to exact equality because both sum in f32 in row
    order; the fixed-point sum is exact, so the two differ by the f32 sum's
    own rounding, at most (k - 1) 2^-24 sum|v| over a bin's k rows, plus one
    rounding of the result."""
    xb, pos, g, h = _level_inputs(n + n_feat, n, n_feat, level)
    nodes = 1 << level
    keys = (pos[:, None].astype(np.int64) * (n_feat * 64)
            + np.arange(n_feat)[None, :] * 64 + xb)
    vals = np.broadcast_to(np.stack([g, h], 1)[:, None, :], (n, n_feat, 2))
    ref = np.asarray(jax.ops.segment_sum(
        jnp.asarray(vals.reshape(-1, 2)), jnp.asarray(keys.ravel(), jnp.int32),
        num_segments=nodes * n_feat * 64)).reshape(nodes, n_feat, 64, 2)
    t = _level_tensors((xb, pos, g, h))
    got = tr.level_histogram_fixed_reference(*t, nodes, tr.gradient_bounds(t[2], t[3]))
    mass = tr.level_histogram_reference(t[0], t[1], t[2].abs().double(),
                                        t[3].abs().double(), nodes).numpy()
    rows = tr.level_histogram_reference(t[0], t[1], torch.ones(n).double(),
                                        torch.ones(n).double(), nodes).numpy()
    limit = np.maximum(rows - 1, 0) * 2.0 ** -24 * mass + 2.4e-7 * np.abs(ref)
    assert (np.abs(got.numpy().astype(np.float64) - ref) <= limit).all()


def test_fixed_point_scales_are_the_kernels():
    """2^e with n · bound · 2^e < 2^62 ≤ 2 n · bound · 2^e; 1 for a bound
    of 0, inf or nan."""
    bounds = torch.tensor([3.25, 1e-6, 0.0, float("inf"), float("nan"), 2.0 ** -149])
    for n in (1, 7809, 65536):
        s = tr.fixed_point_scales(bounds, n)
        assert s.dtype == torch.float64
        assert s[2:5].tolist() == [1.0, 1.0, 1.0]
        for k in (0, 1, 5):
            top = float(bounds[k].double()) * n * float(s[k])
            assert 2.0 ** 61 <= top < 2.0 ** 62
            assert float(torch.log2(s[k])) == round(float(torch.log2(s[k])))


# -- occupied bins (n_bins) ------------------------------------------------------

@pytest.mark.parametrize("seed,n,n_feat", [(0, 500, 8), (1, 37, 5), (2, 3000, 3)])
def test_bin_counts_bound_the_occupied_bins(seed, n, n_feat):
    """``bin_counts`` is len(edges) + 1, uint8 in [1, 64] (a constant
    feature has one edge, a 0/1 feature two, and more where a quantile
    falls between its 0s and 1s); on the fitted rows and on
    rows outside their range no bin reaches it, and the largest bin of
    unbounded rows is exactly count - 1."""
    rng = np.random.default_rng(seed)
    x = _features(rng, n, n_feat, n_constant=1)
    x[:, -1] = rng.random(n) < 0.1                   # a 0/1 feature
    mapper = tr.BinMapper().fit(x)
    counts = mapper.bin_counts()
    assert counts.dtype == np.uint8 and counts.shape == (n_feat,)
    assert counts.tolist() == [len(e) + 1 for e in mapper.edges_]
    assert counts[0] == 2 and 3 <= counts[-1] <= 6 and counts.max() <= tr.MAX_BINS
    assert (mapper.transform(x).max(0).astype(int) + 1 <= counts).all()
    wide = np.concatenate([x, x + 1e6, x - 1e6])
    assert (mapper.transform(wide).max(0).astype(int) + 1 == counts).all()
    tr.check_bin_counts(torch.from_numpy(counts), torch.from_numpy(mapper.transform(wide)))


def test_level_histogram_rejects_a_wrong_n_bins():
    xb, pos, g, h = _tensors()
    good = (xb.amax(0) + 1).to(torch.uint8)
    want = tr.level_histogram_reference(xb, pos, g, h, 4)
    assert torch.equal(tr.level_histogram(xb, pos, g, h, 4, None, good), want)
    assert torch.equal(tr.level_histogram(xb, pos, g, h, 4, None,
                                          torch.full((7,), 64, dtype=torch.uint8)), want)
    with pytest.raises(TypeError):
        tr.level_histogram(xb, pos, g, h, 4, None, good.int())
    with pytest.raises(TypeError):
        tr.level_histogram(xb, pos, g, h, 4, None, good[:-1])
    with pytest.raises(ValueError, match="n_bins is on"):
        tr.level_histogram(xb, pos, g, h, 4, None, good.to("meta"))
    with pytest.raises(ValueError, match="contiguous"):
        tr.level_histogram(xb, pos, g, h, 4, None, good.repeat_interleave(2)[::2])
    low = good.clone()
    low[3] -= 1
    with pytest.raises(ValueError, match=r"n_bins\[3\]"):
        tr.level_histogram(xb, pos, g, h, 4, None, low)
    with pytest.raises(ValueError, match=r"n_bins\[3\]"):
        tr.fit_forest(xb, torch.zeros(7, 64), g, lr=0.1, lam=1.0, min_child=1.0,
                      subsample=1.0, colsample=1.0, base_score=0.0, seed=0,
                      task="reg", n_trees=1, depth=2, oblivious=False, rf=False,
                      n_bins=low)
    for bad in (0, 65):
        with pytest.raises(ValueError, match="must lie in"):
            tr.level_histogram(xb, pos, g, h, 4, None,
                               torch.full((7,), bad, dtype=torch.uint8))
    # a caller that has checked says so, and the shape checks stay
    tr.check_bin_counts(good, xb)
    assert torch.equal(tr.level_histogram(xb, pos, g, h, 4, None, good,
                                          bins_checked=True), want)
    with pytest.raises(TypeError):
        tr.level_histogram(xb, pos, g, h, 4, None, good[:-1], bins_checked=True)


@pytest.mark.parametrize("kind", ["gbdt", "oblivious", "rf"])
def test_fit_forest_grows_the_same_trees_with_and_without_n_bins(kind):
    """``n_bins`` only tells K3 where bins are empty: the estimator passes
    the mapper's counts, ``fit_forest`` without them grows the same trees."""
    rng = np.random.default_rng(8)
    x = _features(rng, 600, 9, n_constant=1)
    x[:, 3] = rng.random(600) < 0.2
    y = (x[:, 1] + x[:, 3] - x[:, 5] > 0).astype(np.float32)
    kw = dict(n_estimators=6, max_depth=3, seed=4, device="cpu")
    model = (tr.RandomForestClassifier(**kw) if kind == "rf" else
             tr.GBDTClassifier(oblivious=kind == "oblivious", subsample=0.8, **kw))
    model.fit(x, y)
    xb = torch.from_numpy(model.mapper_.transform(x))
    args = dict(lr=model.learning_rate, lam=model.reg_lambda,
                min_child=model.min_child_weight, subsample=model.subsample,
                colsample=model.colsample, base_score=model.ensemble_.base_score,
                seed=4, task="reg" if kind == "rf" else "cls", n_trees=6, depth=3,
                oblivious=model.oblivious, rf=kind == "rf")
    edges = torch.from_numpy(model.mapper_.edge_values())
    n_bins = torch.from_numpy(model.mapper_.bin_counts())
    assert n_bins[0] == 2 and n_bins[3] <= 4 and n_bins.max() > 4
    with_bins = tr.fit_forest(xb, edges, torch.from_numpy(y), n_bins=n_bins, **args)
    without = tr.fit_forest(xb, edges, torch.from_numpy(y), **args)
    for a, b in zip(with_bins, without):
        assert torch.equal(a, b)
    assert torch.equal(with_bins[1], model.ensemble_.feat)
    assert torch.equal(with_bins[3], model.ensemble_.leaf)


@pytest.mark.parametrize("n,n_feat,nodes", [(0, 30, 1), (1, 30, 1), (7809, 30, 32),
                                            (7809, 326, 512), (65536, 167, 32),
                                            (1000000, 2048, 4096)])
def test_histogram_plan_holds_every_layout_of_the_rows(n, n_feat, nodes):
    """The scratch K3's plan reserves is enough for any split of the rows
    over the nodes: items when every large node has one row more than a
    multiple of ``rows_per_item``, slots when as many nodes as can be are
    larger than ``own_rows``; the regions are 16-byte aligned where the
    kernel reads 16 bytes, do not overlap, and the accumulator stays small."""
    plan = tr.histogram_plan(n, n_feat, nodes)
    r, own = plan["rows_per_item"], plan["own_rows"]
    assert own >= r >= 256 and plan["tile_feats"] in (8, 16, 32)
    big = own + 1                                   # smallest node that is cut
    n_big = min(nodes, n // big)
    assert plan["acc_slots"] >= n_big and plan["acc_slots"] <= 32
    rest = n - n_big * big                          # all into one more node
    worst_items = n_big * -(-big // r) + (nodes - n_big)
    if rest:
        worst_items = max(worst_items, (nodes - 1) + -(-n // r))
    assert plan["max_items"] >= min(worst_items, nodes + n // r)
    assert plan["plan"] == plan["acc_slots"] * n_feat * 128 and plan["plan"] % 2 == 0
    assert 2 * (plan["rows"] - plan["plan"] - 4) >= 4 * plan["max_items"] + plan["acc_slots"] + 2
    assert plan["threads"] in (128, 256)
    assert 2 * (plan["words"] - plan["rows"]) >= n


def test_oblivious_audit_counts_every_node():
    """``compare_gbdt_fits(oblivious=True)`` replays an oblivious fit along
    its own splits: every node of a level carries the level's best summed
    gain, and a level moved to another feature is found."""
    x, y = _regression(14, n=400, n_feat=6)
    kw = dict(n_estimators=6, max_depth=3, learning_rate=0.3, subsample=1.0,
              oblivious=True)
    fit = tr.GBDTRegressor(device="cpu", **kw).fit(x, y)
    state = fit.ensemble_.to_state()
    assert (state["feat"][:, 1] == state["feat"][:, 2]).all()
    args = dict(task="reg", lam=1.0, min_child=1.0, learning_rate=0.3,
                base_score=fit.ensemble_.base_score, tol=1e-6, oblivious=True)
    audit = compare_gbdt_fits(x, y, None, state, **args)
    assert audit.ok and audit.trees_compared == 6
    assert audit.equal == 6 * 7 and audit.near_ties == 0
    bad = {**state, "feat": state["feat"].copy(), "thr": state["thr"].copy()}
    bad["feat"][2, 1:3] = (bad["feat"][2, 1:3] + 1) % 6
    bad["thr"][2, 1:3] = np.float32(np.median(x[:, bad["feat"][2, 1]]))
    assert compare_gbdt_fits(x, y, None, bad, **args).mismatch == (2, 1)
    assert not compare_gbdt_fits(x, y, None, state, **{**args, "oblivious": False}).ok


# -- wrappers --------------------------------------------------------------------

def _tensors(seed=0, n=200, n_feat=7, level=2):
    xb, pos, g, h = _level_inputs(seed, n, n_feat, level)
    return (torch.from_numpy(xb), torch.from_numpy(pos), torch.from_numpy(g),
            torch.from_numpy(h))


def _counts():
    return (tr.level_histogram.launches.count, tr.best_splits.launches.count,
            tr.leaf_values.launches.count)


def test_wrappers_run_the_plain_versions_on_cpu_without_a_launch():
    xb, pos, g, h = _tensors()
    before = _counts()
    hist = tr.level_histogram(xb, pos, g, h, 4)
    assert torch.equal(hist, tr.level_histogram_reference(xb, pos, g, h, 4))
    mask = torch.ones(7, dtype=torch.bool)
    for got, want in zip(tr.best_splits(hist, mask, 1.0, 1.0, False),
                         tr.best_splits_reference(hist, mask, 1.0, 1.0, False)):
        assert torch.equal(got, want)
    p1, p2 = torch.zeros(200), torch.zeros(200)
    leaf = tr.leaf_values(pos, g, h, 4, 1.0, 0.1, p1)
    assert torch.equal(leaf, tr.leaf_values_reference(pos, g, h, 4, 1.0, 0.1, p2))
    assert torch.equal(p1, p2) and p1.abs().sum() > 0
    assert _counts() == before


def test_gradient_bounds():
    """(max |g|, max |h|) exactly, as f32; zeros for no rows."""
    g = torch.tensor([0.5, -3.25, 1.0])
    h = torch.tensor([0.25, 0.125, 2.5])
    b = tr.gradient_bounds(g, h)
    assert b.dtype == torch.float32 and b.tolist() == [3.25, 2.5]
    assert tr.gradient_bounds(g[:0], h[:0]).tolist() == [0.0, 0.0]


def test_wrappers_reject_wrong_dtypes_shapes_and_devices():
    xb, pos, g, h = _tensors()
    with pytest.raises(TypeError):
        tr.level_histogram(xb.int(), pos, g, h, 4)
    with pytest.raises(TypeError):
        tr.level_histogram(xb, pos.long(), g, h, 4)
    with pytest.raises(TypeError):
        tr.level_histogram(xb, pos, g[:-1], h, 4)
    with pytest.raises(ValueError):
        tr.level_histogram(xb, pos, g, h, 0)
    with pytest.raises(ValueError):
        tr.level_histogram(xb.t().contiguous().t(), pos, g, h, 4)
    hist = tr.level_histogram(xb, pos, g, h, 4)
    with pytest.raises(TypeError):
        tr.best_splits(hist.double(), torch.ones(7, dtype=torch.bool), 1.0, 1.0, False)
    with pytest.raises(TypeError):
        tr.best_splits(hist, torch.ones(6, dtype=torch.bool), 1.0, 1.0, False)
    with pytest.raises(TypeError):
        tr.best_splits(hist, torch.ones(7), 1.0, 1.0, False)
    with pytest.raises(TypeError):
        tr.leaf_values(pos, g, h.double(), 4, 1.0, 0.1, torch.zeros(200))
    with pytest.raises(ValueError):
        tr.leaf_values(pos, g, h, 1 << 13, 1.0, 0.1, torch.zeros(200))
    meta = [t.to("meta") for t in (xb, pos, g, h)]
    with pytest.raises(ValueError, match="no forest_level_histogram kernel"):
        tr.level_histogram(*meta, 4)
    with pytest.raises(ValueError, match="no forest_best_splits kernel"):
        tr.best_splits(hist.to("meta"), torch.ones(7, dtype=torch.bool,
                                                   device="meta"), 1.0, 1.0, False)
    with pytest.raises(ValueError, match="no forest_leaf_values kernel"):
        tr.leaf_values(meta[1], meta[2], meta[3], 4, 1.0, 0.1,
                       torch.zeros(200, device="meta"))
    with pytest.raises(ValueError):                 # mixed devices
        tr.level_histogram(xb, pos, g.to("meta"), h, 4)


def test_training_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _regression(0, n=40, n_feat=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.GBDTRegressor(n_estimators=2).fit(x, y)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tr.GBDTRegressor(n_estimators=2, device="meta").fit(x, y)


# -- K5: the leaves and the next tree's gradients -------------------------------

def _gradient_inputs(seed, n=3000):
    rng = np.random.default_rng(seed)
    preds = (rng.normal(size=n) * 4).astype(np.float32)
    y = (rng.random(n) < 0.4).astype(np.float32)
    u = rng.random(n).astype(np.float32)
    w = rng.uniform(0.0, 2.0, n).astype(np.float32)
    w[:n // 10] = 0.0                           # rows of weight 0
    return preds, y, u, w


@pytest.mark.parametrize("task,subsample", [("reg", 0.7), ("reg", 1.0),
                                            ("cls", 0.7), ("cls", 1.0)])
def test_next_gradients_reference_equals_jax_tree_step(task, subsample, jax, jnp):
    """The gradient ops of the reference's tree step (``forest_tpu.py``
    ``tree_step``: sigmoid, g, h, the subsample mask, (g·m)·w) on the same
    draws: bit-equal for ``reg``; for ``cls`` within 2.4e-7 in g and 6e-8 in
    h (two f32 ulps at 1 and at 0.5: XLA's logistic and torch's sigmoid
    differ by an ulp). ``bounds`` is (max |g|, max |h|)."""
    preds, y, u, w = _gradient_inputs(7)
    if task == "reg":
        y = np.random.default_rng(8).normal(size=y.shape).astype(np.float32)
    g, h, bounds = tr.next_gradients_reference(
        torch.from_numpy(preds), torch.from_numpy(y), torch.from_numpy(u),
        subsample, torch.from_numpy(w), task)
    pj, yj = jnp.asarray(preds), jnp.asarray(y)
    if task == "reg":
        gj, hj = pj - yj, jnp.ones_like(yj)
    else:
        p = jax.nn.sigmoid(pj)
        gj, hj = p - yj, jnp.maximum(p * (1 - p), 1e-6)
    m = (jnp.asarray(u) < subsample).astype(jnp.float32)
    gj, hj = np.asarray(gj * m * jnp.asarray(w)), np.asarray(hj * m * jnp.asarray(w))
    if task == "reg":
        assert np.array_equal(g.numpy(), gj) and np.array_equal(h.numpy(), hj)
    else:
        np.testing.assert_allclose(g.numpy(), gj, rtol=0, atol=2.4e-7)
        np.testing.assert_allclose(h.numpy(), hj, rtol=0, atol=6e-8)
    assert bounds.tolist() == [float(g.abs().max()), float(h.abs().max())]
    assert (g[:300] == 0).all() and (h[:300] == 0).all()
    if subsample < 1:
        assert bool(((torch.from_numpy(u) >= subsample) <= (h == 0)).all())


@pytest.mark.parametrize("task", ["reg", "cls"])
def test_leaf_values_with_the_next_tree_on_cpu(task):
    """On CPU tensors the wrapper returns the plain version's leaves and
    margins and ``next_gradients_reference`` of the updated margins, and
    counts no launch; without the next tree it returns the leaves alone."""
    xb, pos, g, h = _tensors(seed=3)
    preds, y, u, w = (torch.from_numpy(a) for a in _gradient_inputs(4, 200))
    before = _counts()
    p1, p2 = preds.clone(), preds.clone()
    leaf, gn, hn, bounds = tr.leaf_values(
        pos, g, h, 4, 1.0, 0.1, p1, None, tr.NextTree(y, u, 0.8, w, task))
    assert torch.equal(leaf, tr.leaf_values_reference(pos, g, h, 4, 1.0, 0.1, p2))
    assert torch.equal(p1, p2) and not torch.equal(p1, preds)
    for got, want in zip((gn, hn, bounds),
                         tr.next_gradients_reference(p2, y, u, 0.8, w, task)):
        assert torch.equal(got, want)
    p3 = preds.clone()
    assert torch.equal(tr.leaf_values(pos, g, h, 4, 1.0, 0.1, p3), leaf)
    assert torch.equal(p3, p1) and _counts() == before


def _fit_forest_before(xb, edge_vals, y, *, lr, lam, min_child, subsample,
                       colsample, base_score, seed, task, n_trees, depth,
                       oblivious, rf):
    """The tree loop as it was before K5 took the gradients: every draw and
    every gradient op a tree, in that order, on the plain versions."""
    n, n_feat = xb.shape
    n_internal, n_leaves = (1 << depth) - 1, 1 << depth
    w_rows = torch.ones(n)
    preds = torch.full((n,), float(base_score), dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    feats = torch.zeros((n_trees, n_internal), dtype=torch.int32)
    bins = torch.zeros((n_trees, n_internal), dtype=torch.int64)
    leaves = torch.empty((n_trees, n_leaves), dtype=torch.float32)
    feat_ids = torch.arange(n_feat)
    for t in range(n_trees):
        if rf:
            w = torch.poisson(torch.ones(n), generator=gen) * w_rows
            g, h = -y * w, w
        else:
            if task == "reg":
                g, h = preds - y, torch.ones_like(y)
            else:
                p = torch.sigmoid(preds)
                g, h = p - y, torch.clamp(p * (1 - p), min=1e-6)
            m = (torch.rand(n, generator=gen) < subsample).float()
            g, h = g * m * w_rows, h * m * w_rows
        col_mask = torch.rand(n_feat, generator=gen) < colsample
        col_mask = col_mask | (feat_ids == col_mask.to(torch.uint8).argmax())
        pos = torch.zeros(n, dtype=torch.int32)
        for level in range(depth):
            nodes, off = 1 << level, (1 << level) - 1
            hist = tr.level_histogram_reference(xb, pos, g, h, nodes)
            f_l, b_l, _ = tr.best_splits_reference(hist, col_mask, lam, min_child,
                                                   oblivious)
            feats[t, off:off + nodes] = f_l
            bins[t, off:off + nodes] = b_l
            xf = xb.gather(1, f_l[pos].long()[:, None])[:, 0]
            pos = 2 * pos + (xf.int() > b_l[pos]).int()
        leaves[t] = tr.leaf_values_reference(pos, g, h, n_leaves, lam,
                                             1.0 if rf else lr, preds)
    return preds, feats, edge_vals[feats.long(), bins], leaves


@pytest.mark.parametrize("task,colsample,rf", [("reg", 1.0, False),
                                               ("cls", 0.6, False),
                                               ("reg", 0.5, True)])
def test_fit_forest_draws_as_the_loop_before(task, colsample, rf):
    """With the next tree's gradients taken in K5's call, ``fit_forest``
    on the CPU still draws the generator's numbers in the old order
    (subsample, columns, tree by tree) and grows the same trees, bit for
    bit, at a subsample of 0.8."""
    x, y = _regression(17, n=400, n_feat=7)
    if task == "cls":
        y = (y > np.median(y)).astype(np.float32)
    mapper = tr.BinMapper().fit(x)
    xb = torch.from_numpy(mapper.transform(x))
    edges = torch.from_numpy(mapper.edge_values())
    args = dict(lr=0.3, lam=1.0, min_child=1.0, subsample=0.8,
                colsample=colsample, base_score=float(y.mean()), seed=9,
                task=task, n_trees=12, depth=3, oblivious=False, rf=rf)
    before = _fit_forest_before(xb, edges, torch.from_numpy(y), **args)
    now = tr.fit_forest(xb, edges, torch.from_numpy(y), **args)
    for a, b in zip(now, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed,n,n_leaves", [(0, 3000, 64), (1, 500, 1024),
                                             (2, 1, 1)])
def test_fixed_point_leaf_values_within_stated_error(seed, n, n_leaves):
    """K5's arithmetic in torch: the leaves within one f32 rounding of the
    leaf of the float64 sums (5e-7 |leaf| + 1e-9), the same under any order
    of the rows, and the margins moved by ``scale`` times them."""
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.integers(0, n_leaves, n).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0.05, 0.3, n).astype(np.float32))
    g[::5], h[::5] = 0.0, 0.0
    start = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    bounds = tr.gradient_bounds(g, h)
    p_fix, p_64 = start.clone(), start.double()
    leaf = tr.leaf_values_fixed_reference(pos, g, h, n_leaves, 1.0, 0.1, p_fix,
                                          bounds)
    exact = tr.leaf_values_reference(pos, g.double(), h.double(), n_leaves, 1.0,
                                     0.1, p_64)
    assert leaf.dtype == torch.float32 and leaf.shape == (n_leaves,)
    assert ((leaf.double() - exact).abs() <= 5e-7 * exact.abs() + 1e-9).all()
    assert ((p_fix.double() - p_64).abs()
            <= 1e-6 * (p_64.abs() + exact[pos.long()].abs()) + 1e-9).all()
    perm = torch.from_numpy(rng.permutation(n))
    p_perm = start[perm].clone()
    again = tr.leaf_values_fixed_reference(pos[perm], g[perm], h[perm], n_leaves,
                                           1.0, 0.1, p_perm, bounds)
    assert torch.equal(again, leaf) and torch.equal(p_perm, p_fix[perm])


def test_leaf_plan_and_next_tree_checks():
    """A row a thread up to 16,384 rows, at most 16 blocks; the wrapper
    refuses a wrong task, wrong next-tree rows and a leaf count outside
    [1, 2^MAX_DEPTH]."""
    assert [tr.leaf_plan(n) for n in (0, 1, 1024, 1025, 7809, 16384, 65536)] == \
        [1, 1, 1, 2, 8, 16, 16]
    xb, pos, g, h = _tensors()
    y, u, w = torch.zeros(200), torch.zeros(200), torch.ones(200)
    preds = torch.zeros(200)
    with pytest.raises(ValueError, match="task"):
        tr.leaf_values(pos, g, h, 4, 1.0, 0.1, preds, None,
                       tr.NextTree(y, u, 0.8, w, "rank"))
    with pytest.raises(TypeError):
        tr.leaf_values(pos, g, h, 4, 1.0, 0.1, preds, None,
                       tr.NextTree(y.double(), u, 0.8, w, "reg"))
    with pytest.raises(TypeError):
        tr.leaf_values(pos, g, h, 4, 1.0, 0.1, preds, None,
                       tr.NextTree(y, u[:-1], 0.8, w, "reg"))
    for n_leaves in (0, (1 << tr.MAX_DEPTH) + 1):
        with pytest.raises(ValueError, match="n_leaves"):
            tr.leaf_values(pos, g, h, n_leaves, 1.0, 0.1, preds)


# -- the kernels on the card ---------------------------------------------------

@pytest.mark.cuda
def test_kernels_match_plain_versions_on_cuda(cuda_device):
    """K3 bit-equal to its fixed-point plain version, with and without
    ``n_bins``, with its bounds taken inside and passed in, bit-identical
    over two runs, and within one f32 rounding of the float64 sum
    (|err| ≤ 2.4e-7·|sum| + 1e-9·n·max|v|); three of the cases have
    features of 1, 2, 3 and 64 occupied bins in one matrix, skewed node
    sizes, one holds every row in one node of level 9, one has 4,096 nodes
    and one 70,000 rows in 4 nodes (the sort beyond its register and
    shared-memory sizes). K4 equal to the
    plain version on the kernel's histogram (same arithmetic), per node and
    oblivious (levels 0, 2, 5, 9 and 12), with a column mask; K5 leaves and
    margins within 1e-5 of the plain version, bit-equal to its fixed-point
    plain version at 1 to 65,536 rows and 1 to 1,024 leaves, and the next
    tree's gradients bit-equal to the torch ops. The routing, inside the
    next level's sort (after each case's split) and inside K5 (the last
    level's split): positions, trees and sums as route_rows_reference then
    the plain version, each node's sorted rows as a set."""
    rng = np.random.default_rng(0)
    cases = [("uniform", 1, 30, 0), ("uniform", 7809, 30, 5),
             ("uniform", 65536, 167, 5), ("uniform", 7809, 300, 9),
             ("mixed", 7809, 326, 5), ("mixed", 7809, 30, 9),
             ("one_node", 7809, 326, 9),
             # 4,096 nodes and 10,000 rows: the sort's largest shared-memory use
             ("uniform", 10000, 3, 12), ("mixed", 70000, 5, 2)]
    for kind, n, n_feat, level in cases:
        if kind == "uniform":
            arrays = _level_inputs(n_feat + level, n, n_feat, level, n_constant=2)
            counts = arrays[0].max(0) + 1
        else:
            *arrays, counts = mixed_level_case(n_feat + level, n, n_feat, level,
                                               one_node=kind == "one_node")
        xb, pos, g, h = (torch.from_numpy(a).to(cuda_device) for a in arrays)
        n_bins = torch.from_numpy(counts.astype(np.uint8)).to(cuda_device)
        bounds = tr.gradient_bounds(g, h)
        nodes = 1 << level
        hist = tr.level_histogram(xb, pos, g, h, nodes)
        again = tr.level_histogram(xb, pos, g, h, nodes, bounds)
        with_bins = tr.level_histogram(xb, pos, g, h, nodes, bounds, n_bins)
        fixed = tr.level_histogram_fixed_reference(xb, pos, g, h, nodes, bounds)
        exact = tr.level_histogram_reference(xb, pos, g.double(), h.double(), nodes)
        torch.cuda.synchronize()
        assert torch.equal(hist, again), (kind, n, n_feat, level)
        assert torch.equal(hist, fixed), (kind, n, n_feat, level)
        assert torch.equal(with_bins, fixed), (kind, n, n_feat, level)
        limit = (2.4e-7 * exact.abs()
                 + 1e-9 * n * max(float(g.abs().max()), float(h.abs().max())))
        assert ((hist.double() - exact).abs() <= limit).all()
        mask = torch.from_numpy(rng.random(n_feat) < 0.6).to(cuda_device)
        for obl in (False, True):
            split = tr.best_splits(hist, mask, 1.0, 1.0, obl)
            for got, want in zip(split, tr.best_splits_reference(hist, mask, 1.0, 1.0,
                                                                 obl)):
                assert torch.equal(got, want), (kind, n, n_feat, level, obl)
        # the next level's sort routes this split: positions as
        # route_rows_reference's, each node's rows as a set, the histogram
        # bit-equal to the fixed-point plain version on the routed rows
        if level < tr.MAX_DEPTH - 1:
            children = 2 * nodes
            feats = torch.zeros((2, (2 << level) - 1), dtype=torch.int32,
                                device=cuda_device)
            bins = torch.zeros_like(feats)
            routed, f_r, b_r = pos.clone(), feats.clone(), bins.clone()
            tr.route_rows_reference(xb, routed, split[0], split[1], f_r, b_r, 1, level)
            scratch = torch.empty(tr.histogram_plan(n, n_feat, children)["words"],
                                  dtype=torch.int64, device=cuda_device)
            p_k = pos.clone()
            hist = tr.level_histogram(
                xb, p_k, g, h, children, bounds, n_bins,
                parent=tr.ParentSplit(split[0], split[1], feats, bins, 1, level),
                scratch=scratch)
            fixed = tr.level_histogram_fixed_reference(xb, routed, g, h, children, bounds)
            torch.cuda.synchronize()
            assert torch.equal(p_k, routed), (kind, n, n_feat, level)
            assert torch.equal(feats, f_r) and torch.equal(bins, b_r)
            assert torch.equal(hist, fixed), (kind, n, n_feat, level)
            node, row = tr.sorted_rows(scratch, n, n_feat, children)
            kept = torch.nonzero(((g != 0) | (h != 0)).cpu()).flatten()
            assert sorted(zip(node.tolist(), row.tolist())) == \
                sorted(zip(routed.cpu()[kept].tolist(), kept.tolist()))
        leaf_pos = torch.from_numpy(rng.integers(0, 64, n).astype(np.int32)).to(cuda_device)
        p_k, p_p = torch.zeros(n, device=cuda_device), torch.zeros(n, device=cuda_device)
        leaf_k = tr.leaf_values(leaf_pos, g, h, 64, 1.0, 0.1, p_k)
        leaf_p = tr.leaf_values_reference(leaf_pos, g, h, 64, 1.0, 0.1, p_p)
        torch.cuda.synchronize()
        assert torch.allclose(leaf_k, leaf_p, rtol=1e-5, atol=1e-5)
        assert torch.allclose(p_k, p_p, rtol=1e-5, atol=1e-5)
    low = n_bins.clone()
    low[2] = 1                                  # feature 2 fills 64 bins
    with pytest.raises(ValueError, match=r"n_bins\[2\]"):
        tr.level_histogram(xb, pos, g, h, nodes, bounds, low)
    none = tr.level_histogram(xb[:0], pos[:0], g[:0], h[:0], 4, bounds)
    assert none.shape == (4, xb.shape[1], 64, 2) and not none.any()
    # K5 at 1 / 7,809 / 65,536 rows and 1 / 64 / 1,024 leaves, 20% of the
    # rows of weight 0: bit-equal to its fixed-point plain version, the
    # same with the next tree, whose g, h and bounds equal the torch ops
    for n in (1, 7809, 65536):
        for n_leaves in (1, 64, 1024):
            _, _, g, h = (torch.from_numpy(a).to(cuda_device)
                          for a in _level_inputs(n + n_leaves, n, 1, 0))
            pos = torch.from_numpy(rng.integers(0, n_leaves, n).astype(np.int32)
                                   ).to(cuda_device)
            start = torch.from_numpy(rng.normal(size=n).astype(np.float32)
                                     ).to(cuda_device)
            bounds = tr.gradient_bounds(g, h)
            p_k, p_f = start.clone(), start.clone()
            leaf_k = tr.leaf_values(pos, g, h, n_leaves, 1.0, 0.1, p_k, bounds)
            leaf_f = tr.leaf_values_fixed_reference(pos, g, h, n_leaves, 1.0, 0.1,
                                                    p_f, bounds)
            assert torch.equal(leaf_k, leaf_f) and torch.equal(p_k, p_f), (n, n_leaves)
            if n_leaves > 1:                    # routing the last level's split
                last = n_leaves.bit_length() - 2
                xb = torch.from_numpy(rng.integers(0, 64, (n, 9)).astype(np.uint8)
                                      ).to(cuda_device)
                half = n_leaves // 2
                f_l = torch.from_numpy(rng.integers(0, 9, half).astype(np.int32)
                                       ).to(cuda_device)
                b_l = torch.from_numpy(rng.integers(0, 64, half).astype(np.int32)
                                       ).to(cuda_device)
                feats = torch.zeros((1, n_leaves - 1), dtype=torch.int32,
                                    device=cuda_device)
                bins = torch.zeros_like(feats)
                parents = pos // 2
                routed, f_r, b_r = parents.clone(), feats.clone(), bins.clone()
                tr.route_rows_reference(xb, routed, f_l, b_l, f_r, b_r, 0, last)
                p_r, p_k = start.clone(), start.clone()
                want = tr.leaf_values_fixed_reference(routed, g, h, n_leaves, 1.0, 0.1,
                                                      p_r, bounds)
                got = tr.leaf_values(parents, g, h, n_leaves, 1.0, 0.1, p_k, bounds,
                                     parent=tr.ParentSplit(f_l, b_l, feats, bins, 0, last),
                                     xb=xb)
                torch.cuda.synchronize()
                assert torch.equal(got, want) and torch.equal(p_k, p_r), (n, n_leaves)
                assert torch.equal(parents, pos // 2)
                assert torch.equal(feats, f_r) and torch.equal(bins, b_r)
            for task, sub in (("reg", 1.0), ("cls", 0.8)):
                y = torch.from_numpy((rng.random(n) < 0.4).astype(np.float32)
                                     ).to(cuda_device)
                u = torch.from_numpy(rng.random(n).astype(np.float32)).to(cuda_device)
                w = torch.from_numpy((rng.random(n) > 0.2).astype(np.float32)
                                     ).to(cuda_device)
                p_n = start.clone()
                got = tr.leaf_values(pos, g, h, n_leaves, 1.0, 0.1, p_n, bounds,
                                     tr.NextTree(y, u, sub, w, task))
                want = tr.next_gradients_reference(p_f, y, u, sub, w, task)
                assert torch.equal(got[0], leaf_f) and torch.equal(p_n, p_f)
                for a, b in zip(got[1:], want):
                    assert torch.equal(a, b), (n, n_leaves, task, sub)
