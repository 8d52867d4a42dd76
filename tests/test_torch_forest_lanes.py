"""Port parity: the lane-batched forest search (bbbp_tpu_torch's
``_forest_cv_vmapped`` and ``fit_forest_lanes`` against the JAX package's
``_forest_cv_vmapped`` and the port's sequential fits on the CPU), the
routing kernel's plain version, and CUDA tests of the lane kernels.

Tolerances:

- deterministic trials (subsample = colsample = 1) against the JAX
  package's vmapped search: accuracy and F1 within 0.01, the bound the JAX
  package holds its own vmapped search to
  (``tests/test_round4.py::test_vmapped_forest_search_matches_sequential``);
- the random forest, whose Poisson weights come from another stream than
  JAX's: mean accuracy over 3 fold seeds within 0.03;
- a lane of ``fit_forest_lanes`` against ``fit_forest`` with the same seed
  and parameters: bit-equal trees, thresholds, leaves and margins (the same
  draws, sums and roundings, lane by lane);
- the lane search against the sequential search: the same score but for
  validation rows whose margin lies within 1e-5 of the decision threshold
  (the lanes read the fit's margins, the sequential search ``raw_predict``,
  which sums the same leaves in another order), and the same winner;
- the routing (in the sort of the next level's split search and in K5):
  integers, equal; the wrappers given a parent split against
  ``route_rows_reference`` then the plain version: bit-equal.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu_torch.ops import forest_train as tr  # noqa: E402
from bbbp_tpu_torch.train import batched_search as tb  # noqa: E402
from bbbp_tpu_torch.train.search import stratified_kfold_indices  # noqa: E402


# The JAX package is the reference; it is imported by fixtures so that the
# CUDA tests below also run where JAX is absent (on the card's machine).
@pytest.fixture(scope="module")
def jb():
    return pytest.importorskip("bbbp_tpu.train.batched_search")


@pytest.fixture(scope="module")
def jft():
    return pytest.importorskip("bbbp_tpu.ops.forest_tpu")


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one intra-op thread, as the test workers share
    the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


ACC_TOL = 0.01
STAT_TOL = 0.03
MARGIN_TOL = 1e-5

# tests/test_round4.py's inputs and trials (n = 300, 3 folds)
PARAMS = [
    {"n_estimators": 30, "max_depth": 4, "learning_rate": 0.1, "subsample": 1.0},
    {"n_estimators": 30, "max_depth": 4, "learning_rate": 0.05, "subsample": 1.0},
    {"rf": True, "n_estimators": 30, "max_depth": 4, "colsample": 1.0,
     "reg_lambda": 1e-6},
    {"oblivious": True, "n_estimators": 30, "max_depth": 4, "learning_rate": 0.1,
     "reg_lambda": 1.0},
]
DETERMINISTIC = [0, 1, 3]


def _data(n=300, f=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y_reg = (x[:, 0] * 2 - x[:, 1] + 0.1 * rng.normal(size=n)).astype(np.float32)
    return x, (y_reg > 0).astype(np.float32)


def _binned(x):
    mapper = tr.BinMapper().fit(x)
    return (torch.from_numpy(mapper.transform(x)),
            torch.from_numpy(mapper.edge_values()),
            torch.from_numpy(mapper.bin_counts()))


# -- the search against the JAX package's --------------------------------------

def test_deterministic_lane_search_equals_jax(jb):
    x, y = _data()
    folds = stratified_kfold_indices(y, 3, 7)
    params = [PARAMS[t] for t in DETERMINISTIC]
    a_j, _, f_j = jb._forest_cv_vmapped(x, y, folds, params, classify=True)
    a_t, _, f_t = tb._forest_cv_vmapped(x, y, folds, params, device="cpu")
    np.testing.assert_allclose(a_t, a_j, atol=ACC_TOL)
    np.testing.assert_allclose(f_t, f_j, atol=ACC_TOL)


def test_random_forest_lane_search_learns_as_jax(jb):
    """Mean accuracy over 3 fold seeds within 0.03."""
    x, y = _data()
    rf = [PARAMS[2]]
    got, want = [], []
    for seed in (7, 8, 9):
        folds = stratified_kfold_indices(y, 3, seed)
        want.append(jb._forest_cv_vmapped(x, y, folds, rf, classify=True)[0][0])
        got.append(tb._forest_cv_vmapped(x, y, folds, rf, device="cpu")[0][0])
    assert abs(np.mean(got) - np.mean(want)) <= STAT_TOL, (got, want)
    assert np.mean(got) > max(y.mean(), 1 - y.mean())          # it learned


# -- a lane is a sequential fit --------------------------------------------------

LANE_CASES = {
    # name: (task, rf, oblivious, depth, n_trees, lr, lam, subsample, colsample)
    "boost_sub_col": ("cls", False, False, 4, 8, [0.1, 0.3, 0.05],
                      [1.0, 3.0, 0.2], [0.7, 0.9, 1.0], [0.5, 0.8, 1.0]),
    "rf": ("cls", True, False, 5, 6, 1.0, [1e-6, 0.5, 1e-3], 1.0, [0.3, 0.7, 1.0]),
    "oblivious": ("cls", False, True, 4, 6, [0.1, 0.2, 0.15], [0.5, 2.0, 8.0],
                  1.0, [1.0, 0.6, 0.9]),
    "regression": ("reg", False, False, 3, 7, [0.2, 0.1, 0.3], 1.0, 0.8, 1.0),
    "depth0": ("cls", False, False, 0, 4, [0.1, 0.5, 1.0], [1.0, 0.1, 4.0],
               0.8, 1.0),
    "dt_depth12": ("cls", False, False, 12, 1, 1.0, [0.1, 1.0, 9.0], 1.0,
                   [0.5, 0.75, 1.0]),
}


@pytest.mark.parametrize("case", sorted(LANE_CASES))
def test_every_lane_equals_fit_forest(case):
    task, rf, obl, depth, n_trees, lr, lam, sub, col = LANE_CASES[case]
    x, y = _data(n=260, f=9, seed=3)
    if task == "reg":
        y = (x[:, 0] - x[:, 2] ** 2).astype(np.float32)
    xb, edges, n_bins = _binned(x)
    rng = np.random.default_rng(4)
    row_w = torch.from_numpy((rng.random((3, len(y))) > 0.3).astype(np.float32))
    seeds = [11, 12, 131]
    base = 0.0 if rf else 0.2
    lanes = tr.fit_forest_lanes(
        xb, edges, torch.from_numpy(y), lr=lr, lam=lam, subsample=sub,
        colsample=col, seeds=seeds, row_w=row_w, base_score=base, task=task,
        n_trees=n_trees, depth=depth, oblivious=obl, rf=rf, n_bins=n_bins)

    def at(v, i):
        return v[i] if isinstance(v, list) else v

    for i, seed in enumerate(seeds):
        one = tr.fit_forest(
            xb, edges, torch.from_numpy(y), lr=at(lr, i), lam=at(lam, i),
            min_child=1.0, subsample=at(sub, i), colsample=at(col, i),
            base_score=base, seed=seed, task=task, n_trees=n_trees, depth=depth,
            oblivious=obl, rf=rf, row_w=row_w[i], n_bins=n_bins)
        for name, a, b in zip(("preds", "feats", "thrs", "leaves"), lanes, one):
            assert torch.equal(a[i], b), (case, i, name)
    assert lanes[1].shape == (3, n_trees, (1 << depth) - 1)
    assert lanes[3].shape == (3, n_trees, 1 << depth)


def test_lane_parameters_are_checked():
    x, y = _data(n=40, f=3)
    xb, edges, _ = _binned(x)
    kw = dict(lr=0.1, lam=1.0, subsample=1.0, colsample=1.0, seeds=[0, 1],
              base_score=0.0, task="cls", n_trees=1, depth=1, oblivious=False,
              rf=False)
    with pytest.raises(ValueError, match="row_w"):
        tr.fit_forest_lanes(xb, edges, torch.from_numpy(y),
                            row_w=torch.ones(3, 40), **kw)
    with pytest.raises(ValueError, match="lane parameter"):
        tr.fit_forest_lanes(xb, edges, torch.from_numpy(y),
                            row_w=torch.ones(2, 40), **{**kw, "lr": [0.1, 0.2, 0.3]})


# -- the lane search against the sequential search ------------------------------

def _near_threshold_rows(x, y, folds, params):
    """Per trial, the validation rows whose lane margin lies within
    MARGIN_TOL of the decision threshold (0 for boosting, 0.5 for rf)."""
    prep = tb._forest_prep(x, y, folds, "cpu")
    base = tb._forest_base(np.asarray(y, np.float32), True)
    va = torch.from_numpy(prep["va_idx"])
    live = torch.from_numpy(prep["va_mask"]).bool()
    near = []
    for t, p in enumerate(params):
        blk = [(t, k) for k in range(len(folds))]
        preds = tb._fit_lane_block(prep, params, blk, base)[0]
        raw = preds / p["n_estimators"] - 0.5 if p.get("rf") else preds
        near.append(int(((raw.gather(1, va).abs() <= MARGIN_TOL) & live).sum()))
    return np.array(near)


@pytest.mark.parametrize("extra", [
    {"n_estimators": 12, "max_depth": 3, "learning_rate": 0.3, "subsample": 0.7,
     "colsample": 0.6, "reg_lambda": 2.0},
    {"rf": True, "n_estimators": 10, "max_depth": 5, "colsample": 0.5,
     "reg_lambda": 1e-6}])
def test_lane_search_scores_as_the_sequential_search(extra):
    x, y = _data(n=240, seed=5)
    folds = stratified_kfold_indices(y, 3, 11)
    params = PARAMS + [extra]
    seq = tb._forest_cv(x, y, folds, params, device="cpu")
    lanes = tb._forest_cv_vmapped(x, y, folds, params, device="cpu")
    near = _near_threshold_rows(x, y, folds, params)
    for a, b in zip(seq, lanes):
        assert (np.abs(a - b) <= near / len(y) + 1e-12).all(), (a, b, near)
    assert int(np.argmax(seq[0])) == int(np.argmax(lanes[0]))


def test_lane_blocks_give_the_same_scores(monkeypatch):
    """A group cut into blocks of lanes by the device-byte budget scores as
    one block."""
    x, y = _data(n=120, seed=6)
    folds = stratified_kfold_indices(y, 3, 1)
    params = [PARAMS[0], {**PARAMS[1], "subsample": 0.8, "colsample": 0.7}]
    whole = tb._forest_cv_vmapped(x, y, folds, params, device="cpu")
    monkeypatch.setattr(tb, "FOREST_LANE_BUDGET",
                        2 * tr.lane_bytes(len(y), x.shape[1], 4, 30))
    blocks = tb._forest_cv_vmapped(x, y, folds, params, device="cpu")
    for a, b in zip(whole, blocks):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("on,max_f,want", [(False, 512, "seq"), (True, 512, "lanes"),
                                           (True, 11, "seq")])
def test_score_param_sets_takes_the_lanes_only_when_on_and_narrow(
        monkeypatch, on, max_f, want):
    """As the JAX package: BBBP_FOREST_VMAP on and F <= FOREST_VMAP_MAX_F
    (12 features here)."""
    taken = []
    monkeypatch.setattr(tb, "FOREST_VMAP", on)
    monkeypatch.setattr(tb, "FOREST_VMAP_MAX_F", max_f)
    monkeypatch.setattr(tb, "_forest_cv", lambda *a, **k: taken.append("seq")
                        or (np.zeros(1),) * 3)
    monkeypatch.setattr(tb, "_forest_cv_vmapped", lambda *a, **k: taken.append(
        "lanes") or (np.zeros(1),) * 3)
    x, y = _data(n=60)
    tb._score_param_sets("xgb", x, y, [PARAMS[0]], 3, 0, False, "cpu")
    assert taken == [want]


def test_forest_vmap_reads_the_jax_packages_switch(jb):
    """The same variable, default (off) and feature bound."""
    assert tb.FOREST_VMAP == jb.FOREST_VMAP == (
        os.environ.get("BBBP_FOREST_VMAP", "0") == "1")
    assert tb.FOREST_VMAP_MAX_F == jb.FOREST_VMAP_MAX_F == 512


# -- the routing's plain version -------------------------------------------------

def _route_inputs(seed, n=200, n_feat=6, lanes=None, level=3, depth=5, n_trees=4):
    rng = np.random.default_rng(seed)
    lead = () if lanes is None else (lanes,)
    nodes = 1 << level
    xb = torch.from_numpy(rng.integers(0, 64, (n, n_feat)).astype(np.uint8))
    pos = torch.from_numpy(rng.integers(0, nodes, lead + (n,)).astype(np.int32))
    f_l = torch.from_numpy(rng.integers(0, n_feat, lead + (nodes,)).astype(np.int32))
    b_l = torch.from_numpy(rng.integers(0, 64, lead + (nodes,)).astype(np.int32))
    shape = lead + (n_trees, (1 << depth) - 1)
    return xb, pos, f_l, b_l, torch.zeros(shape, dtype=torch.int32), \
        torch.zeros(shape, dtype=torch.int32)


def _torch_ops(xb, pos, f_l, b_l, feats, bins, t, level):
    """The routing as fit_forest ran it before the kernel."""
    nodes, off = 1 << level, (1 << level) - 1
    feats[t, off:off + nodes] = f_l
    bins[t, off:off + nodes] = b_l
    row_f = f_l[pos].long()
    xf = xb.gather(1, row_f[:, None])[:, 0]
    return 2 * pos + (xf.int() > b_l[pos]).int()


@pytest.mark.parametrize("level", [0, 3, 4])
def test_route_rows_reference_equals_the_torch_ops(level):
    xb, pos, f_l, b_l, feats, bins = _route_inputs(level, level=level)
    want_f, want_b = feats.clone(), bins.clone()
    want = _torch_ops(xb, pos, f_l, b_l, want_f, want_b, 2, level)
    tr.route_rows_reference(xb, pos, f_l, b_l, feats, bins, 2, level)
    assert torch.equal(pos, want) and torch.equal(feats, want_f) \
        and torch.equal(bins, want_b)
    # with a lane axis, as the sort of the next level's K3 with lanes routes
    # it on the CPU: each lane as the ops on its own rows
    xb, pos, f_l, b_l, feats, bins = _route_inputs(9 + level, lanes=3, level=level)
    before = pos.clone()
    launched = tr.level_histogram_lanes.launches.count
    g = torch.ones(pos.shape)
    tr.level_histogram_lanes(xb, pos, g, g, 2 << level,
                             parent=tr.ParentSplit(f_l, b_l, feats, bins, 1, level))
    assert tr.level_histogram_lanes.launches.count == launched   # the CPU: no kernel
    for i in range(3):
        want_f, want_b = torch.zeros_like(feats[i]), torch.zeros_like(bins[i])
        want = _torch_ops(xb, before[i], f_l[i], b_l[i], want_f, want_b, 1, level)
        assert torch.equal(pos[i], want)
        assert torch.equal(feats[i], want_f) and torch.equal(bins[i], want_b)


def test_route_rows_rejects_wrong_shapes():
    xb, pos, f_l, b_l, feats, bins = _route_inputs(0, lanes=2)
    g = torch.ones(pos.shape)

    def sort(f_l, b_l, feats, bins, tree, level):
        tr.level_histogram_lanes(xb, pos, g, g, 2 << level,
                                 parent=tr.ParentSplit(f_l, b_l, feats, bins, tree, level))

    with pytest.raises(TypeError, match="f_l"):
        sort(f_l[:, :3].contiguous(), b_l, feats, bins, 0, 3)
    with pytest.raises(TypeError, match="bins"):
        sort(f_l, b_l, feats, bins.long(), 0, 3)
    with pytest.raises(ValueError, match="outside"):
        sort(f_l, b_l, feats, bins, 4, 3)


def _parent_case(kind, lanes, seed=5, n=280, n_feat=7, depth=4):
    """A tree's last two levels as a fit reaches them: the positions of
    level depth - 2, its split, the positions' children, g and h of the
    kind's draws (boosting: the next tree too; rf: Poisson weights)."""
    rng = np.random.default_rng(seed)
    lead = (lanes,) if lanes else ()
    level = depth - 2
    xb = torch.from_numpy(rng.integers(0, 64, (n, n_feat)).astype(np.uint8))
    pos = torch.from_numpy(rng.integers(0, 1 << level, lead + (n,)).astype(np.int32))
    f_l = torch.from_numpy(rng.integers(0, n_feat, lead + (1 << level,)).astype(np.int32))
    b_l = torch.from_numpy(rng.integers(0, 64, lead + (1 << level,)).astype(np.int32))
    if kind == "rf":
        w = torch.from_numpy(rng.poisson(1.0, lead + (n,)).astype(np.float32))
        g, h = -torch.from_numpy((rng.random(n) < 0.4).astype(np.float32)) * w, w
    else:
        g = torch.from_numpy(rng.normal(size=lead + (n,)).astype(np.float32))
        h = torch.from_numpy(rng.uniform(0.05, 0.3, lead + (n,)).astype(np.float32))
        zero = torch.from_numpy(rng.random(lead + (n,)) < 0.2)
        g[zero], h[zero] = 0.0, 0.0
    shape = lead + (3, (1 << depth) - 1)
    return xb, pos, f_l, b_l, g, h, torch.zeros(shape, dtype=torch.int32), \
        torch.zeros(shape, dtype=torch.int32)


@pytest.mark.parametrize("lanes", [None, 3])
@pytest.mark.parametrize("kind", ["gbdt", "oblivious", "rf"])
def test_wrappers_with_a_parent_split_route_then_run_the_plain_version(kind, lanes):
    """The split search of level depth - 1 and K5 after it, each given the
    level before's split (the fit's calls), equal route_rows_reference then
    the plain version without one, bit for bit: the level's histogram or
    splits, the routed positions and the trees' arrays; K5's leaves,
    margins and, in boosting, the next tree's gradients, with pos left as it
    was."""
    xb, pos, f_l, b_l, g, h, feats, bins = _parent_case(kind, lanes)
    depth, n = 4, xb.shape[0]
    level, nodes = depth - 2, 1 << (depth - 1)
    lam = torch.tensor([1.0, 0.3, 5.0]) if lanes else 1.0
    routed, f_r, b_r = pos.clone(), feats.clone(), bins.clone()
    tr.route_rows_reference(xb, routed, f_l, b_l, f_r, b_r, 1, level)
    parent = tr.ParentSplit(f_l, b_l, feats, bins, 1, level)
    got_pos = pos.clone()
    if kind == "gbdt" and lanes:
        mask = torch.from_numpy(np.random.default_rng(2).random((lanes, 7)) < 0.7)
        got = tr.level_splits_lanes(xb, got_pos, g, h, nodes, None, mask, lam, 1.0,
                                    parent=parent)
        want = tr.level_splits_lanes_reference(xb, routed, g, h, nodes, mask, lam, 1.0)
    elif lanes:
        got = (tr.level_histogram_lanes(xb, got_pos, g, h, nodes, parent=parent),)
        want = (tr.level_histogram_lanes_reference(xb, routed, g, h, nodes),)
    else:
        got = (tr.level_histogram(xb, got_pos, g, h, nodes, parent=parent),)
        want = (tr.level_histogram_reference(xb, routed, g, h, nodes),)
    for a, b in zip(got, want):
        assert torch.equal(a, b), kind
    assert torch.equal(got_pos, routed)
    assert torch.equal(feats, f_r) and torch.equal(bins, b_r)

    # K5 after the last level: its split routes pos without changing it
    lead = (lanes,) if lanes else ()
    rng = np.random.default_rng(9)
    f_last = torch.from_numpy(rng.integers(0, 7, lead + (nodes,)).astype(np.int32))
    b_last = torch.from_numpy(rng.integers(0, 64, lead + (nodes,)).astype(np.int32))
    leaf_pos, f_r2, b_r2 = routed.clone(), f_r.clone(), b_r.clone()
    tr.route_rows_reference(xb, leaf_pos, f_last, b_last, f_r2, b_r2, 1, depth - 1)
    start = torch.from_numpy(rng.normal(size=lead + (n,)).astype(np.float32))
    nxt = None
    if kind != "rf":
        y = torch.from_numpy((rng.random(n) < 0.4).astype(np.float32))
        u = torch.from_numpy(rng.random(lead + (n,)).astype(np.float32))
        w = torch.from_numpy((rng.random(lead + (n,)) > 0.2).astype(np.float32))
        sub = torch.tensor([0.8, 1.0, 0.6]) if lanes else 0.8
        nxt = tr.NextTree(y, u, sub, w, "cls")
    scale = (torch.tensor([0.1, 0.2, 1.0]) if lanes else 0.1) if kind != "rf" else (
        torch.ones(3) if lanes else 1.0)
    p_got, p_want = start.clone(), start.clone()
    last = tr.ParentSplit(f_last, b_last, feats, bins, 1, depth - 1)
    kept = got_pos.clone()
    if lanes:
        got = tr.leaf_values_lanes(got_pos, g, h, 2 * nodes, lam, scale, p_got,
                                   next_tree=nxt, parent=last, xb=xb)
        want = tr.leaf_values_lanes_reference(leaf_pos, g, h, 2 * nodes, lam, scale,
                                              p_want, nxt)
    else:
        got = tr.leaf_values(got_pos, g, h, 2 * nodes, lam, scale, p_got,
                             next_tree=nxt, parent=last, xb=xb)
        want = tr.leaf_values_reference(leaf_pos, g, h, 2 * nodes, lam, scale, p_want)
        if nxt is not None:
            want = (want, *tr.next_gradients_reference(p_want, *nxt))
    for a, b in zip(got if nxt is not None else (got,),
                    want if nxt is not None else (want,)):
        assert torch.equal(a, b), kind
    assert torch.equal(p_got, p_want)
    assert torch.equal(got_pos, kept)                   # K5 leaves pos as it is
    assert torch.equal(feats, f_r2) and torch.equal(bins, b_r2)


# -- the lane wrappers on the CPU --------------------------------------------------

def _lane_level(seed, lanes=3, n=300, n_feat=7, level=3):
    rng = np.random.default_rng(seed)
    xb = torch.from_numpy(rng.integers(0, 64, (n, n_feat)).astype(np.uint8))
    pos = torch.from_numpy(rng.integers(0, 1 << level, (lanes, n)).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(lanes, n)).astype(np.float32))
    h = torch.from_numpy(rng.uniform(0.05, 0.3, (lanes, n)).astype(np.float32))
    zero = torch.from_numpy(rng.random((lanes, n)) < 0.2)
    g[zero], h[zero] = 0.0, 0.0
    return xb, pos, g, h


def test_lane_wrappers_run_each_lane_as_the_single_wrapper_on_cpu():
    xb, pos, g, h = _lane_level(1)
    lanes, nodes = pos.shape[0], 8
    counts = [c.launches.count for c in (tr.level_histogram_lanes,
                                         tr.best_splits_lanes, tr.leaf_values_lanes)]
    hist = tr.level_histogram_lanes(xb, pos, g, h, nodes)
    lam = torch.tensor([1.0, 0.3, 5.0])
    mask = torch.from_numpy(np.random.default_rng(2).random((lanes, 7)) < 0.7)
    for obl in (False, True):
        split = tr.best_splits_lanes(hist, mask, lam, 1.0, obl)
        for i in range(lanes):
            assert torch.equal(hist[i], tr.level_histogram(xb, pos[i], g[i], h[i], nodes))
            for a, b in zip(split, tr.best_splits(hist[i], mask[i], float(lam[i]),
                                                  1.0, obl)):
                assert torch.equal(a[i], b)
    scale = torch.tensor([0.1, 0.2, 1.0])
    y = (torch.rand(300) < 0.4).float()
    u = torch.rand(lanes, 300)
    w = (torch.rand(lanes, 300) > 0.2).float()
    sub = torch.tensor([0.8, 1.0, 0.5])
    preds = torch.randn(lanes, 300)
    one = preds.clone()
    got = tr.leaf_values_lanes(pos, g, h, nodes, lam, scale, preds,
                               next_tree=tr.NextTree(y, u, sub, w, "cls"))
    for i in range(lanes):
        want = tr.leaf_values(pos[i], g[i], h[i], nodes, float(lam[i]),
                              float(scale[i]), one[i],
                              next_tree=tr.NextTree(y, u[i], float(sub[i]), w[i], "cls"))
        for a, b in zip(got, want):
            assert torch.equal(a[i], b)
        assert torch.equal(preds[i], one[i])
    assert [c.launches.count for c in (tr.level_histogram_lanes, tr.best_splits_lanes,
                                       tr.leaf_values_lanes)] == counts


def test_lane_wrappers_reject_wrong_inputs():
    xb, pos, g, h = _lane_level(3)
    with pytest.raises(TypeError, match="pos"):
        tr.level_histogram_lanes(xb, pos[0], g[0], h[0], 8)
    with pytest.raises(TypeError, match="g must be"):
        tr.level_histogram_lanes(xb, pos, g[:2].contiguous(), h, 8)
    hist = tr.level_histogram_lanes(xb, pos, g, h, 8)
    with pytest.raises(TypeError, match="lam"):
        tr.best_splits_lanes(hist, torch.ones(3, 7, dtype=torch.bool),
                             torch.ones(2), 1.0, False)
    with pytest.raises(TypeError, match="scale"):
        tr.leaf_values_lanes(pos, g, h, 8, torch.ones(3), torch.ones(3, dtype=torch.float64),
                             torch.zeros(3, 300))


def test_gradient_bounds_over_lanes():
    g = torch.tensor([[1.0, -3.0, 2.0], [0.5, 0.25, -0.125]])
    h = torch.tensor([[0.1, 0.2, 0.3], [0.0, 0.0, 0.0]])
    assert torch.equal(tr.gradient_bounds(g, h),
                       torch.tensor([[3.0, 0.3], [0.5, 0.0]]))
    assert torch.equal(tr.gradient_bounds(g[1], h[1]), torch.tensor([0.5, 0.0]))
    assert tr.gradient_bounds(g[:, :0], h[:, :0]).shape == (2, 2)


# -- the fused split search against the JAX package's _grow_level ---------------

SPLIT_LANES = 6
SPLIT_LAMBDAS = [0.1, 0.5, 1.0, 2.0, 5.0, 10.0]


def _split_level(seed, level, n_feat, integer, n=300, empty=False, col_share=1.0):
    """One level over SPLIT_LANES lanes: a fifth of each lane's rows of
    weight 0; integer-valued g and h (sums exact in any order) or random
    f32; with ``empty``, only even nodes hold rows."""
    rng = np.random.default_rng(seed)
    lanes, nodes = SPLIT_LANES, 1 << level
    xb = rng.integers(0, tr.MAX_BINS, (n, n_feat)).astype(np.uint8)
    xb[:, 1] = rng.integers(0, 3, n)                # a feature of three bins
    pos = rng.integers(0, nodes, (lanes, n)).astype(np.int32)
    if empty:
        pos &= ~1
    if integer:
        g = rng.integers(-3, 4, (lanes, n)).astype(np.float32)
        h = rng.integers(0, 4, (lanes, n)).astype(np.float32)
    else:
        g = rng.normal(size=(lanes, n)).astype(np.float32)
        h = rng.uniform(0.05, 0.4, (lanes, n)).astype(np.float32)
    zero = rng.random((lanes, n)) < 0.2
    g[zero], h[zero] = 0.0, 0.0
    g[1] *= 40.0                                     # a lane of other bounds
    mask = rng.random((lanes, n_feat)) < col_share
    mask[np.arange(lanes), rng.integers(0, n_feat, lanes)] = True
    return xb, pos, g, h, mask


def _jax_level_splits(jft, jax, xb, pos, g, h, mask, level, lam, min_child):
    """``jax.vmap`` of ``_grow_level(..., hist="matmul")`` over the lanes, as
    the JAX package's vmapped search runs it, with xb and the masks padded
    and chunked as ``_fit_forest_device`` does."""
    jnp = jax.numpy
    n, n_feat = xb.shape
    fc = min(jft.F_CHUNK, jft._pad128(n_feat))
    pad = (-n_feat) % fc
    xb_chunks = jnp.pad(jnp.asarray(xb, jnp.int32), ((0, 0), (0, pad)))
    xb_chunks = xb_chunks.reshape(n, -1, fc).transpose(1, 0, 2)
    masks = jnp.pad(jnp.asarray(mask), ((0, 0), (0, pad))).reshape(len(mask), -1, fc)

    def one(p, gl, hl, lm, m):
        return jft._grow_level(p, xb_chunks, gl, hl, level, tr.MAX_BINS, lm,
                               min_child, m, False, hist_mode="matmul")

    out = jax.vmap(one)(jnp.asarray(pos), jnp.asarray(g), jnp.asarray(h),
                        jnp.asarray(lam, jnp.float32), masks)
    return [np.asarray(a) for a in out]


def _near_tie(hist, mask, lam, min_child, got, want, node):
    """Whether two picks of one node are a near tie: their gains (from the
    port's plain arithmetic on its histogram) within 1e-5 of the larger
    magnitude, or both at most 1e-5 of it from 0 where one side has no
    split."""
    gain, valid = tr.split_gains(hist[node:node + 1], torch.from_numpy(mask), lam,
                                 min_child)
    flat = torch.where(valid, gain, torch.tensor(-np.inf)).reshape(-1)

    def at(pick):
        f, b, has = (int(v[node]) for v in pick)
        return float(flat[f * tr.MAX_BINS + b]) if has else 0.0

    a, b = at(got), at(want)
    return abs(a - b) <= 1e-5 * max(1.0, abs(a), abs(b))


@pytest.mark.parametrize("level,n_feat,min_child,col_share,empty", [
    (0, 5, 1.0, 1.0, False), (1, 12, 0.0, 0.6, False), (2, 9, 1.0, 0.5, True),
    (3, 7, 0.0, 1.0, True), (4, 12, 1.0, 0.7, False), (4, 6, 0.0, 0.4, True)])
def test_level_splits_equal_vmapped_grow_level_exactly(level, n_feat, min_child,
                                                        col_share, empty, jft, jax):
    """Integer-valued g and h: every bin sum is exact in either package, so
    each lane's (feat, bin, has_split) equals the vmapped ``_grow_level``'s
    at every node; per-lane lambda 0.1-10, a lane of 40x gradients, column
    masks, zero-weight rows and, where ``empty``, empty nodes."""
    xb, pos, g, h, mask = _split_level(level * 10 + n_feat, level, n_feat, True,
                                       empty=empty, col_share=col_share)
    counts = [c.launches.count for c in (tr.level_splits_lanes,
                                         tr.level_histogram_lanes,
                                         tr.best_splits_lanes)]
    got = tr.level_splits_lanes(torch.from_numpy(xb), torch.from_numpy(pos),
                                torch.from_numpy(g), torch.from_numpy(h), 1 << level,
                                None, torch.from_numpy(mask),
                                torch.tensor(SPLIT_LAMBDAS), min_child)
    want = _jax_level_splits(jft, jax, xb, pos, g, h, mask, level, SPLIT_LAMBDAS,
                             min_child)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)
    assert got[2].any()
    if empty:
        assert not got[2][:, 1::2].any()
        assert (got[1][:, 1::2] == tr.MAX_BINS - 1).all()
    assert [c.launches.count for c in (tr.level_splits_lanes, tr.level_histogram_lanes,
                                       tr.best_splits_lanes)] == counts   # the CPU


@pytest.mark.parametrize("min_child", [0.0, 1.0])
def test_level_splits_equal_vmapped_grow_level_but_near_ties(min_child, jft, jax):
    """Random f32 g and h at levels 0-4: the two packages sum the bins in
    other orders (row order here, a matmul there), so a node may pick
    another split of an equal gain; at most 1% of the nodes differ, each a
    counted near tie."""
    nodes = near = 0
    for level in range(5):
        xb, pos, g, h, mask = _split_level(100 + level, level, 11, False,
                                           col_share=0.7)
        got = tr.level_splits_lanes(torch.from_numpy(xb), torch.from_numpy(pos),
                                    torch.from_numpy(g), torch.from_numpy(h),
                                    1 << level, None, torch.from_numpy(mask),
                                    torch.tensor(SPLIT_LAMBDAS), min_child)
        want = _jax_level_splits(jft, jax, xb, pos, g, h, mask, level,
                                 SPLIT_LAMBDAS, min_child)
        for i in range(SPLIT_LANES):
            hist = tr.level_histogram_reference(
                torch.from_numpy(xb), torch.from_numpy(pos[i]), torch.from_numpy(g[i]),
                torch.from_numpy(h[i]), 1 << level)
            lane_got = [a[i] for a in got]
            lane_want = [torch.from_numpy(b[i].copy()) for b in want]
            for node in range(1 << level):
                nodes += 1
                if all(bool(a[node] == b[node]) for a, b in zip(lane_got, lane_want)):
                    continue
                assert _near_tie(hist, mask[i], SPLIT_LAMBDAS[i], min_child,
                                 lane_got, lane_want, node), (level, i, node)
                near += 1
    assert near <= 0.01 * nodes, (near, nodes)


@pytest.mark.parametrize("min_child", [0.0, 1.0])
def test_level_splits_plain_versions_agree(min_child):
    """On the CPU the wrapper is the composition of K3's and K4's lane plain
    versions; with integer-valued sums the fixed-point plain version (the
    kernel's arithmetic) gives the same splits."""
    xb, pos, g, h, mask = _split_level(7, 3, 10, True, empty=True, col_share=0.6)
    args = [torch.from_numpy(a) for a in (xb, pos, g, h)]
    lam = torch.tensor(SPLIT_LAMBDAS)
    col = torch.from_numpy(mask)
    got = tr.level_splits_lanes(*args, 8, None, col, lam, min_child,
                                torch.full((10,), 64, dtype=torch.uint8))
    two = tr.best_splits_lanes(tr.level_histogram_lanes(*args, 8), col, lam,
                               min_child, False)
    fixed = tr.level_splits_lanes_fixed_reference(*args, 8, col, lam, min_child,
                                                  tr.gradient_bounds(*args[2:]))
    for a, b, c in zip(got, two, fixed):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_level_splits_reject_wrong_inputs():
    xb, pos, g, h, mask = (torch.from_numpy(a) for a in _split_level(1, 2, 5, True))
    lam = torch.tensor(SPLIT_LAMBDAS)
    with pytest.raises(TypeError, match="col_mask"):
        tr.level_splits_lanes(xb, pos, g, h, 4, None, mask[:, :3].contiguous(), lam, 1.0)
    with pytest.raises(TypeError, match="lam"):
        tr.level_splits_lanes(xb, pos, g, h, 4, None, mask, lam[:2].contiguous(), 1.0)
    with pytest.raises(TypeError, match="pos"):
        tr.level_splits_lanes(xb, pos[0], g, h, 4, None, mask, lam, 1.0)
    with pytest.raises(ValueError, match="n_bins"):
        tr.level_splits_lanes(xb, pos, g, h, 4, None, mask, lam, 1.0,
                              torch.full((5,), 2, dtype=torch.uint8))


def test_each_familys_tuned_group_is_one_lane_block():
    """The blocks ``_forest_cv_vmapped`` cuts each tuned group into (50
    sampled trials and the default, 5 folds) at the search matrix's 8,162
    rows and 30 features: one block each. Only cat's oblivious lanes keep a
    histogram; with one kept, dt's depth-12 group would take two."""
    from bbbp_tpu_torch.train import classification as cl
    from bbbp_tpu_torch.train.search import _sample_params

    n, n_feat, folds = 8162, 30, 5
    blocks = {}
    for m in tb.FOREST_FAMILIES:
        rng = np.random.default_rng(42)
        params = [cl.DEFAULT_TRIALS[m]] + [_sample_params(cl.SEARCH_SPACES[m], rng)
                                           for _ in range(50)]
        for (rf, n_est, depth, obl), t_ids in tb._forest_groups(params).items():
            lanes = len(t_ids) * folds
            block = tb.lane_block(n, n_feat, depth, n_est, obl)
            blocks[(m, n_est, depth)] = -(-lanes // block)
    assert blocks == {("dt", 1, 12): 1, ("rf", 200, 10): 1, ("rf", 300, 10): 1,
                      ("gb", 200, 4): 1, ("gb", 300, 6): 1, ("xgb", 300, 6): 1,
                      ("cat", 300, 6): 1}
    assert -(-255 // tb.lane_block(n, n_feat, 12, 1, True)) == 2


def test_level_splits_bound_counts_the_occupied_cells():
    """``timing.level_splits_bound`` counts xb once, each lane's rows, mask,
    lambda and splits, and K4's 15 operations at the occupied cells only;
    ``chip_smoke.occupied_cells`` counts those cells from xb and pos over
    the rows of non-zero weight."""
    import chip_smoke
    from bbbp_tpu_torch.timing import level_splits_bound

    xb = torch.tensor([[0, 5], [0, 5], [1, 5], [3, 6]], dtype=torch.uint8)
    pos = torch.tensor([[0, 0, 1, 1], [1, 1, 1, 0]], dtype=torch.int32)
    g = torch.tensor([[1.0, 2.0, 0.0, -1.0], [0.5, 0.0, 1.0, 1.0]])
    h = torch.tensor([[1.0, 1.0, 0.0, 1.0], [1.0, 0.0, 1.0, 1.0]])
    # lane 0: node 0 {(0, 0), (1, 5)}, node 1 {(0, 3), (1, 6)} (row 2 weighs 0);
    # lane 1: node 1 {(0, 0), (0, 1), (1, 5)}, node 0 {(0, 3), (1, 6)}
    assert chip_smoke.occupied_cells(xb, pos, g, h, 2) == 9
    bound = level_splits_bound(4, 2, 2, 2, 9)
    assert bound["bytes"] == 4 * 2 + 2 * (12 * 4 + 2 + 4 + 9 * 2)
    assert bound["ops"] == 2 * 4 * 2 * 2 + 15 * 9
    assert bound["bound_by"] == "bytes"


# -- the kernels on the card -----------------------------------------------------

def _hold_sort(scratch, n, n_feat, nodes, pos, g, h):
    """The sort's row order in ``scratch``, lane by lane: each node's rows,
    as a set, are the rows of weight not 0 that ``pos`` puts there."""
    for i in range(pos.shape[0]):
        node, row = tr.sorted_rows(scratch, n, n_feat, nodes, i)
        kept = torch.nonzero(((g[i] != 0) | (h[i] != 0)).cpu()).flatten()
        want = sorted(zip(pos[i].cpu()[kept].tolist(), kept.tolist()))
        assert sorted(zip(node.tolist(), row.tolist())) == want, i


@pytest.mark.cuda
def test_lane_kernels_match_plain_versions_on_cuda(cuda_device):
    """K3 with lanes bit-equal to its fixed-point plain version lane by lane
    (each lane at its own bounds); K4 with lanes equal to the plain version
    on the kernel's histogram at per-lane lambdas, per node and oblivious;
    the sort with routing (K3's, one fit and lanes, and the fused search's)
    given that split: positions equal to route_rows_reference's, each
    node's rows as a set, the histogram and the splits bit-equal to the
    calls on the routed positions; K5 with lanes, the next tree and routing,
    in both launch shapes, bit-equal to route_rows_reference then its
    fixed-point plain version, at 5 and at 250 lanes."""
    for level, n_feat in ((0, 30), (5, 30), (9, 30), (11, 30), (5, 167)):
        xb, pos, g, h = (t.to(cuda_device) for t in _lane_level(
            level, lanes=5, n=8162, n_feat=n_feat, level=level))
        g[1] *= 40.0                            # lanes of other bounds
        nodes = 1 << level
        bounds = tr.gradient_bounds(g, h)
        hist = tr.level_histogram_lanes(xb, pos, g, h, nodes, bounds)
        fixed = tr.level_histogram_lanes_fixed_reference(xb, pos, g, h, nodes, bounds)
        torch.cuda.synchronize()
        assert torch.equal(hist, fixed), (level, n_feat)
        lam = torch.tensor([1.0, 0.1, 3.0, 9.0, 0.5], device=cuda_device)
        mask = torch.rand(5, n_feat, device=cuda_device) < 0.7
        mask[:, 0] = True
        for obl in (False, True):
            got = tr.best_splits_lanes(hist, mask, lam, 1.0, obl)
            want = tr.best_splits_lanes_reference(hist, mask, lam, 1.0, obl)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (level, n_feat, obl)
        # the next level's sort routes this level's split
        f_l, b_l = got[0], got[1]
        feats = torch.zeros((5, 3, 4095), dtype=torch.int32, device=cuda_device)
        bins = torch.zeros_like(feats)
        routed, f_r, b_r = pos.clone(), feats.clone(), bins.clone()
        tr.route_rows_reference(xb, routed, f_l, b_l, f_r, b_r, 2, level)
        parent = tr.ParentSplit(f_l, b_l, feats, bins, 2, level)
        n, children = xb.shape[0], 2 * nodes
        scratch = torch.empty(5 * tr.lane_words(n, n_feat, children), dtype=torch.int64,
                              device=cuda_device)
        p_k = pos.clone()
        hist = tr.level_histogram_lanes(xb, p_k, g, h, children, bounds, parent=parent,
                                        scratch=scratch)
        want = tr.level_histogram_lanes_fixed_reference(xb, routed, g, h, children, bounds)
        torch.cuda.synchronize()
        assert torch.equal(p_k, routed) and torch.equal(feats, f_r) \
            and torch.equal(bins, b_r), (level, n_feat)
        assert torch.equal(hist, want), (level, n_feat)
        _hold_sort(scratch, n, n_feat, children, routed, g, h)
        p_k = pos.clone()
        got = tr.level_splits_lanes(xb, p_k, g, h, children, bounds, mask, lam, 1.0,
                                    parent=parent, scratch=scratch)
        want = tr.level_splits_lanes(xb, routed.clone(), g, h, children, bounds, mask,
                                     lam, 1.0)
        torch.cuda.synchronize()
        assert torch.equal(p_k, routed)
        for a, b in zip(got, want):
            assert torch.equal(a, b), (level, n_feat)
        _hold_sort(scratch, n, n_feat, children, routed, g, h)
        p1 = pos[0].clone()
        one = tr.level_histogram(xb, p1, g[0], h[0], children, bounds[0],
                                 parent=tr.ParentSplit(f_l[0].contiguous(),
                                                       b_l[0].contiguous(),
                                                       feats[0].clone(), bins[0].clone(),
                                                       2, level))
        torch.cuda.synchronize()
        assert torch.equal(p1, routed[0]) and torch.equal(one, hist[0]), (level, n_feat)
    n, leaves = 8162, 64
    for lanes in (5, 250):
        xb, pos, g, h = (t.to(cuda_device) for t in _lane_level(
            7, lanes=lanes, n=n, level=5))
        bounds = tr.gradient_bounds(g, h)
        lam = torch.logspace(-1, 1, lanes, device=cuda_device)
        scale = torch.linspace(0.02, 1.0, lanes, device=cuda_device)
        y = (torch.rand(n, device=cuda_device) < 0.4).float()
        nxt = tr.NextTree(y, torch.rand(lanes, n, device=cuda_device),
                          torch.linspace(0.6, 1.0, lanes, device=cuda_device),
                          (torch.rand(lanes, n, device=cuda_device) > 0.2).float(), "cls")
        f_l = torch.randint(0, xb.shape[1], (lanes, 32), dtype=torch.int32,
                            device=cuda_device)
        b_l = torch.randint(0, 64, (lanes, 32), dtype=torch.int32, device=cuda_device)
        feats = torch.zeros((lanes, 2, 63), dtype=torch.int32, device=cuda_device)
        bins = torch.zeros_like(feats)
        routed, f_r, b_r = pos.clone(), feats.clone(), bins.clone()
        tr.route_rows_reference(xb, routed, f_l, b_l, f_r, b_r, 1, 5)
        start = torch.randn(lanes, n, device=cuda_device)
        p_f = start.clone()
        want = tr.leaf_values_lanes_fixed_reference(routed, g, h, leaves, lam, scale, p_f,
                                                    bounds, nxt)
        for shape in ("cluster", "block", "auto"):
            p_k, kept = start.clone(), pos.clone()
            got = tr.leaf_values_lanes(kept, g, h, leaves, lam, scale, p_k, bounds, nxt,
                                       parent=tr.ParentSplit(f_l, b_l, feats, bins, 1, 5),
                                       xb=xb, shape=shape)
            torch.cuda.synchronize()
            assert torch.equal(p_k, p_f), (lanes, shape)
            assert torch.equal(kept, pos), (lanes, shape)
            assert torch.equal(feats, f_r) and torch.equal(bins, b_r), (lanes, shape)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (lanes, shape)


@pytest.mark.cuda
def test_lanes_equal_fit_forest_on_cuda(cuda_device):
    """Each lane of a fit on the card equals ``fit_forest`` on the card with
    its seed, bit for bit."""
    x, y = _data(n=2000, f=30, seed=8)
    xb, edges, n_bins = (t.to(cuda_device) for t in _binned(x))
    row_w = (torch.rand(4, 2000, device=cuda_device) > 0.2).float()
    yt = torch.from_numpy(y).to(cuda_device)
    kw = dict(base_score=0.1, task="cls", n_trees=20, depth=6, oblivious=False,
              rf=False, n_bins=n_bins)
    lr, lam, sub, col = [0.1, 0.3, 0.05, 0.2], [1.0, 0.2, 4.0, 1.0], \
        [0.8, 1.0, 0.6, 0.9], [0.5, 1.0, 0.8, 0.6]
    lanes = tr.fit_forest_lanes(xb, edges, yt, lr=lr, lam=lam, subsample=sub,
                                colsample=col, seeds=[0, 1, 131, 132], row_w=row_w, **kw)
    for i, seed in enumerate([0, 1, 131, 132]):
        one = tr.fit_forest(xb, edges, yt, lr=lr[i], lam=lam[i], min_child=1.0,
                            subsample=sub[i], colsample=col[i], seed=seed,
                            row_w=row_w[i], **kw)
        for a, b in zip(lanes, one):
            assert torch.equal(a[i], b), i


@pytest.mark.cuda
def test_level_splits_equal_two_kernels_on_cuda(cuda_device):
    """The fused split search equals K3 with lanes then K4 with lanes bit for
    bit (feat, bin, has_split), and the fixed-point plain version, at levels
    0-11 over 8,162 rows and 30 features (the node rows of the shallow
    levels cut into items and summed in slots, the deep ones a warp a node),
    with column masks, zero-weight rows, a lane of 40x gradients, per-lane
    lambda and min_child 0 and 1."""
    for level, n_feat, lanes in ((0, 30, 5), (3, 30, 5), (5, 30, 5), (9, 30, 5),
                                 (11, 30, 3), (5, 167, 3), (2, 7, 7)):
        xb, pos, g, h = (t.to(cuda_device) for t in _lane_level(
            level, lanes=lanes, n=8162, n_feat=n_feat, level=level))
        g[1] *= 40.0
        nodes = 1 << level
        bounds = tr.gradient_bounds(g, h)
        lam = torch.logspace(-1, 1, lanes, device=cuda_device)
        mask = torch.rand(lanes, n_feat, device=cuda_device) < 0.7
        mask[:, 0] = True
        for min_child in (0.0, 1.0):
            got = tr.level_splits_lanes(xb, pos, g, h, nodes, bounds, mask, lam,
                                        min_child)
            hist = tr.level_histogram_lanes(xb, pos, g, h, nodes, bounds)
            two = tr.best_splits_lanes(hist, mask, lam, min_child, False)
            fixed = tr.level_splits_lanes_fixed_reference(xb, pos, g, h, nodes, mask,
                                                          lam, min_child, bounds)
            torch.cuda.synchronize()
            for a, b, c in zip(got, two, fixed):
                assert torch.equal(a, b), (level, n_feat, min_child)
                assert torch.equal(a, c), (level, n_feat, min_child)
