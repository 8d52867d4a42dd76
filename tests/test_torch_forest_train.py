"""Port parity: forest training (bbbp_tpu_torch.ops.forest_train against
bbbp_tpu.ops.forest_tpu and bbbp_tpu.ops.forest on the CPU), the kernel
wrappers' checks, and one CUDA test of the three kernels."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu_torch.ops import forest_train as tr  # noqa: E402
from bbbp_tpu_torch.testing import compare_gbdt_fits  # noqa: E402


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


# -- the kernels on the card ---------------------------------------------------

@pytest.mark.cuda
def test_kernels_match_plain_versions_on_cuda(cuda_device):
    """K3 against the plain version summed in float64 (|err| ≤ 2.4e-7·|sum|
    + 1e-9·n·max|v|: one f32 rounding of the exact sum) and bit-identical
    over two runs, with its bounds taken inside and passed in; K4 equal to the plain version on the kernel's histogram
    (same arithmetic), oblivious mode and a column mask included; K5 leaves
    and margins within 1e-5 of the plain version."""
    rng = np.random.default_rng(0)
    for n, n_feat, level in [(1, 30, 0), (7809, 30, 5), (65536, 167, 5),
                             (7809, 300, 9)]:
        xb_np, pos_np, g_np, h_np = _level_inputs(n_feat + level, n, n_feat, level,
                                                  n_constant=2)
        xb, pos, g, h = (torch.from_numpy(a).to(cuda_device)
                         for a in (xb_np, pos_np, g_np, h_np))
        hist = tr.level_histogram(xb, pos, g, h, 1 << level)
        again = tr.level_histogram(xb, pos, g, h, 1 << level,
                                   tr.gradient_bounds(g, h))
        exact = tr.level_histogram_reference(xb, pos, g.double(), h.double(),
                                             1 << level)
        torch.cuda.synchronize()
        assert torch.equal(hist, again)
        limit = (2.4e-7 * exact.abs()
                 + 1e-9 * n * max(float(g.abs().max()), float(h.abs().max())))
        assert ((hist.double() - exact).abs() <= limit).all()
        mask = torch.from_numpy(rng.random(n_feat) < 0.6).to(cuda_device)
        for obl in (False, True):
            for got, want in zip(tr.best_splits(hist, mask, 1.0, 1.0, obl),
                                 tr.best_splits_reference(hist, mask, 1.0, 1.0, obl)):
                assert torch.equal(got, want)
        leaf_pos = torch.from_numpy(rng.integers(0, 64, n).astype(np.int32)).to(cuda_device)
        p_k, p_p = torch.zeros(n, device=cuda_device), torch.zeros(n, device=cuda_device)
        leaf_k = tr.leaf_values(leaf_pos, g, h, 64, 1.0, 0.1, p_k)
        leaf_p = tr.leaf_values_reference(leaf_pos, g, h, 64, 1.0, 0.1, p_p)
        torch.cuda.synchronize()
        assert torch.allclose(leaf_k, leaf_p, rtol=1e-5, atol=1e-5)
        assert torch.allclose(p_k, p_p, rtol=1e-5, atol=1e-5)
