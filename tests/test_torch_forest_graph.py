"""The tree loop as one device program: K9's keyed draws
(``ops/forest_train.py::forest_draws``, ``csrc/draws.cu``) against JAX's
Threefry-2x32 and the Poisson(1) inverse CDF, a lane's draws against a
single fit's, and the restructured loop (``grow_trees``: a tree that reads
its index from the device and keeps every tensor the next tree reads at its
address) against a copy of the host loop it replaced, on the CPU. The
``cuda`` tests hold K9 against its plain version and the replayed CUDA graph
against the eager loop on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu_torch.ops import forest_train as tr  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


# -- K9's plain version ---------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threefry_reference_equals_jax(seed):
    """Both output words bit-equal to ``jax.extend.random.threefry_2x32`` on
    seeded keys and counters (JAX takes the counter pairs as the two halves
    of one array)."""
    jnp = pytest.importorskip("jax.numpy")
    threefry_2x32 = pytest.importorskip("jax.extend.random").threefry_2x32
    rng = np.random.default_rng(seed)
    for _ in range(8):
        key = rng.integers(0, 1 << 32, 2, dtype=np.uint64)
        count = rng.integers(0, 1 << 32, (2, 64), dtype=np.uint64)
        count[:, :3] = [[0, 1, 0xFFFFFFFF], [0, 0, 0xFFFFFFFF]]
        want = np.asarray(threefry_2x32(jnp.asarray(key, dtype=jnp.uint32),
                                        jnp.asarray(count.reshape(-1), dtype=jnp.uint32)))
        y0, y1 = tr.threefry2x32_reference(
            torch.tensor(int(key[0])), torch.tensor(int(key[1])),
            torch.from_numpy(count[0].astype(np.int64)),
            torch.from_numpy(count[1].astype(np.int64)))
        got = np.concatenate([y0.numpy(), y1.numpy()])
        assert got.min() >= 0 and got.max() < 1 << 32
        np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_draw_words_are_threefry_of_the_key_layout():
    """A word is Threefry-2x32's first word of the key (seed >> 32, seed &
    0xffffffff) at the counter (tree · 4 + stream, index), for the seeds
    the callers pass: ``t * 131 + k``, an estimator's, ``cfg.seed`` and its
    offsets, a negative one and the ends of int64."""
    seeds = [0, 1, 42, 7 * 131 + 4, 42 + 7700 * 3 + 2031, -1, -(1 << 63), (1 << 63) - 1]
    words = tr.draw_words_reference(torch.tensor(seeds), 5, "columns", 9)
    for lane, seed in enumerate(seeds):
        k0, k1 = (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF
        want, _ = tr.threefry2x32_reference(torch.tensor(k0), torch.tensor(k1),
                                            torch.tensor(5 * 4 + 1), torch.arange(9))
        assert torch.equal(words[lane], want)
    assert len({tuple(w.tolist()) for w in words}) == len(seeds)
    for bad in (1 << 63, -(1 << 63) - 1):
        with pytest.raises(ValueError, match="int64"):
            tr.seed_tensor([0, bad], torch.device("cpu"))


def test_uniforms_lie_in_zero_one():
    words = torch.tensor([0, 255, 256, (1 << 32) - 257, (1 << 32) - 1])
    u = tr.draws_from_words(words, "subsample")
    assert u.dtype == torch.float32
    assert u.tolist() == [0.0, 0.0, 2.0 ** -24, 1 - 2.0 ** -23, 1 - 2.0 ** -24]
    draws = tr.forest_draws(torch.tensor([3, 4]), torch.tensor([2]), "columns", 50_000)
    assert float(draws.min()) >= 0.0 and float(draws.max()) < 1.0
    assert abs(float(draws.mean()) - 0.5) < 0.01


def test_poisson_counts_are_the_inverse_cdf():
    """The count of a word w is the least k with (w + 1) / 2^32 ≤ CDF(k)
    (Poisson(1)'s CDF by scipy, away from the thresholds' float64 roundings);
    at a threshold's own word the count steps up by one; the thresholds'
    masses equal the probabilities within 2^-32; the draws' mean and
    variance are 1."""
    stats = pytest.importorskip("scipy.stats")
    t = np.array(tr.poisson_thresholds(), np.int64)
    assert len(t) == 13 and (np.diff(t) > 0).all() and t[-1] < 1 << 32
    cdf = stats.poisson.cdf(np.arange(len(t)), 1.0)
    assert np.abs(t - np.floor(cdf * 2.0 ** 32)).max() <= 1
    mass = np.diff(np.concatenate([[0], t])) / 2.0 ** 32
    assert np.abs(mass - stats.poisson.pmf(np.arange(len(t)), 1.0)).max() <= 2.0 ** -31
    rng = np.random.default_rng(5)
    words = rng.integers(0, 1 << 32, 200_000, dtype=np.int64)
    words = words[np.abs(words[:, None] - t[None, :]).min(axis=1) > 2]
    want = np.searchsorted(cdf * 2.0 ** 32, words + 1, side="left")
    got = tr.draws_from_words(torch.from_numpy(words), "poisson").numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))
    edge = torch.from_numpy(np.stack([t - 1, t]))
    counts = tr.draws_from_words(edge, "poisson")
    assert counts[0].tolist() == list(range(len(t)))
    assert counts[1].tolist() == list(range(1, len(t) + 1))
    draws = tr.forest_draws(torch.tensor([11]), torch.tensor([0]), "poisson", 200_000)
    assert abs(float(draws.mean()) - 1) < 0.01 and abs(float(draws.var()) - 1) < 0.02


@pytest.mark.parametrize("stream", list(tr.DRAW_STREAMS))
def test_a_lane_draws_what_a_single_fit_draws(stream):
    """Lane l of one launch equals the launch of seeds[l] alone, whatever
    the lanes around it and their order; the tree offset reads the next
    tree; trees and streams differ."""
    seeds = [5, 0, 131, 262 + 4, 42]
    tree = torch.tensor([3])
    alone = {s: tr.forest_draws(torch.tensor([s]), tree, stream, 77)[0] for s in seeds}
    for order in (seeds, seeds[::-1], [seeds[2], seeds[0]]):
        draws = tr.forest_draws(torch.tensor(order), tree, stream, 77)
        assert draws.shape == (len(order), 77)
        for lane, s in enumerate(order):
            assert torch.equal(draws[lane], alone[s])
    nxt = tr.forest_draws(torch.tensor([5]), torch.tensor([2]), stream, 77, tree_offset=1)
    assert torch.equal(nxt[0], alone[5])
    other = [tr.forest_draws(torch.tensor([5]), torch.tensor([4]), stream, 77)[0]] + [
        tr.forest_draws(torch.tensor([5]), tree, s, 77)[0]
        for s in tr.DRAW_STREAMS if s != stream]
    assert all(not torch.equal(o, alone[5]) for o in other)


def test_forest_draws_rejects_wrong_inputs():
    seeds, tree = torch.tensor([1, 2]), torch.tensor([0])
    with pytest.raises(ValueError, match="stream"):
        tr.forest_draws(seeds, tree, "rows", 4)
    with pytest.raises(TypeError, match="seeds"):
        tr.forest_draws(seeds.int(), tree, "columns", 4)
    with pytest.raises(TypeError, match="tree"):
        tr.forest_draws(seeds, torch.tensor([0, 1]), "columns", 4)
    with pytest.raises(ValueError, match="size"):
        tr.forest_draws(seeds, tree, "columns", -1)
    assert tr.forest_draws(seeds, tree, "columns", 0).shape == (2, 0)


# -- the restructured loop against the host loop it replaced ------------------------

def _fit_forest_host_loop(xb, edge_vals, y, *, lr, lam, min_child, subsample,
                          colsample, base_score, seed, task, n_trees, depth,
                          oblivious, rf):
    """A copy of ``fit_forest``'s loop before the tree became one device
    program: the tree index a host integer baked into the routing's
    pointers, the trees' rows written by the routing itself, the last tree
    without the next tree's gradients, K5's new gradients rebound, not
    copied; its draws the keyed draws of tree t."""
    n, n_feat = xb.shape
    n_internal, n_leaves = (1 << depth) - 1, 1 << depth
    w_rows = torch.ones(n)
    preds = torch.full((n,), float(base_score), dtype=torch.float32)
    seeds = torch.tensor([seed])
    feats = torch.zeros((n_trees, n_internal), dtype=torch.int32)
    bins = torch.zeros((n_trees, n_internal), dtype=torch.int32)
    leaves = torch.empty((n_trees, n_leaves), dtype=torch.float32)
    feat_ids = torch.arange(n_feat)
    scale = 1.0 if rf else float(lr)

    def draw(t):
        return tr.forest_draws_reference(seeds, t, "subsample", n)[0]

    if not rf and n_trees:
        g, h, bounds = tr.next_gradients_reference(preds, y, draw(0), subsample,
                                                   w_rows, task)
    pos = torch.empty(n, dtype=torch.int32)
    for t in range(n_trees):
        if rf:
            w = tr.forest_draws_reference(seeds, t, "poisson", n)[0] * w_rows
            g, h = -y * w, w
            bounds = tr.gradient_bounds(g, h)
        col_mask = tr.forest_draws_reference(seeds, t, "columns", n_feat)[0] < colsample
        col_mask = col_mask | (feat_ids == col_mask.to(torch.uint8).argmax())
        parent = None
        for level in range(depth):
            hist = tr.level_histogram(xb, pos, g, h, 1 << level, bounds,
                                      parent=parent)
            f_l, b_l, _ = tr.best_splits(hist, col_mask, lam, min_child, oblivious)
            parent = tr.ParentSplit(f_l, b_l, feats, bins, t, level)
        nxt = (None if rf or t == n_trees - 1 else
               tr.NextTree(y, draw(t + 1), subsample, w_rows, task))
        out = tr.leaf_values(pos, g, h, n_leaves, lam, scale, preds, bounds, nxt,
                             parent=parent, xb=xb)
        if nxt is None:
            leaves[t] = out
        else:
            leaves[t], g, h, bounds = out
    return preds, feats, edge_vals[feats.long(), bins.long()], leaves


LOOP_CASES = {
    "gbdt_reg": dict(task="reg", rf=False, oblivious=False),
    "gbdt_cls": dict(task="cls", rf=False, oblivious=False),
    "rf": dict(task="reg", rf=True, oblivious=False),
    "oblivious": dict(task="reg", rf=False, oblivious=True),
}


def _case_data(task, seed=23, n=360, n_feat=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, n_feat)).astype(np.float32)
    x[:, 2] = np.round(x[:, 2], 1)
    y = (np.sin(x[:, 0]) + x[:, 1] * x[:, 3] + 0.3 * rng.normal(size=n)).astype(np.float32)
    if task == "cls":
        y = (y > np.median(y)).astype(np.float32)
    mapper = tr.BinMapper().fit(x)
    return (torch.from_numpy(mapper.transform(x)), torch.from_numpy(mapper.edge_values()),
            torch.from_numpy(y), torch.from_numpy(mapper.bin_counts()))


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_restructured_loop_equals_the_host_loop(case):
    """``fit_forest`` (one tree as a step that reads its index from a
    tensor, writes its own flat arrays and copies them into the trees,
    copies K5's gradients into the next tree's buffers) equals the host
    loop it replaced on the same keyed draws, bit for bit: margins, trees,
    thresholds and leaves, at subsample 0.8 and colsample 0.6."""
    kw = LOOP_CASES[case]
    xb, edges, y, n_bins = _case_data(kw["task"])
    args = dict(lr=0.3, lam=1.0, min_child=1.0, subsample=0.8, colsample=0.6,
                base_score=0.0 if kw["rf"] else float(y.mean()), seed=77,
                n_trees=9, depth=4, **kw)
    want = _fit_forest_host_loop(xb, edges, y, **args)
    got = tr.fit_forest(xb, edges, y, n_bins=n_bins, **args)
    for name, a, b in zip(("preds", "feats", "thrs", "leaves"), got, want):
        assert torch.equal(a, b), name
    assert (got[1] > 0).any()


@pytest.mark.parametrize("case", ["gbdt_cls", "rf", "oblivious"])
def test_lanes_equal_single_fits_in_any_order(case):
    """``fit_forest_lanes`` over L = 1, 3 and the same lanes reversed:
    each lane equals ``fit_forest`` with its seed and parameters, bit for
    bit, at subsample 0.8 and colsample 0.6."""
    kw = LOOP_CASES[case]
    xb, edges, y, n_bins = _case_data(kw["task"], seed=29, n=300, n_feat=8)
    seeds = [131 * 2 + 1, 0, 42]
    lr, sub, col = [0.3, 0.1, 0.2], [0.8, 1.0, 0.7], [0.6, 1.0, 0.5]
    w = torch.ones(3, 300)
    w[1, ::4] = 0.0
    base = 0.0 if kw["rf"] else float(y.mean())
    one = {}
    for i, s in enumerate(seeds):
        one[s] = tr.fit_forest(xb, edges, y, lr=lr[i], lam=1.0, min_child=1.0,
                               subsample=sub[i], colsample=col[i], base_score=base,
                               seed=s, n_trees=6, depth=3, row_w=w[i], n_bins=n_bins,
                               **kw)
    for order in ([0, 1, 2], [2, 1, 0], [1]):
        lanes = tr.fit_forest_lanes(
            xb, edges, y, lr=[lr[i] for i in order], lam=1.0,
            subsample=[sub[i] for i in order], colsample=[col[i] for i in order],
            seeds=[seeds[i] for i in order], row_w=w[order], base_score=base,
            n_trees=6, depth=3, n_bins=n_bins, **kw)
        for j, i in enumerate(order):
            for name, a, b in zip(("preds", "feats", "thrs", "leaves"), lanes,
                                  one[seeds[i]]):
                assert torch.equal(a[j], b), (order, i, name)


def test_zero_and_one_tree_fits():
    xb, edges, y, _ = _case_data("reg", n=50, n_feat=4)
    kw = dict(lr=0.3, lam=1.0, min_child=1.0, subsample=0.8, colsample=1.0,
              base_score=0.5, seed=1, task="reg", depth=2, oblivious=False, rf=False)
    preds, feats, thrs, leaves = tr.fit_forest(xb, edges, y, n_trees=0, **kw)
    assert torch.equal(preds, torch.full((50,), 0.5)) and feats.shape == (0, 3)
    assert leaves.shape == (0, 4) and thrs.shape == (0, 3)
    one = tr.fit_forest(xb, edges, y, n_trees=1, **kw)
    two = tr.fit_forest(xb, edges, y, n_trees=2, **kw)
    assert torch.equal(one[1][0], two[1][0]) and torch.equal(one[3][0], two[3][0])


def test_eager_tree_loop_sets_graph_false_and_restores():
    """``testing.eager_tree_loop`` turns off ``forest_train.REPLAY_TREES``,
    the one switch ``grow_trees`` reads, so that a tree loop on a CUDA
    tree index runs eagerly as with ``graph=False`` however its fit was
    imported (the lane search's too), and puts the switch back on leaving,
    after an error too; a fit inside it is the fit outside."""
    from types import SimpleNamespace

    from bbbp_tpu_torch.testing import eager_tree_loop

    on_card = SimpleNamespace(device=torch.device("cuda", 0))   # read, never used
    steps = []
    xb, edges, y, _ = _case_data("reg", n=80, n_feat=4)
    kw = dict(lr=0.3, lam=1.0, min_child=1.0, subsample=0.8, colsample=0.6,
              base_score=0.0, seed=3, task="reg", n_trees=3, depth=2,
              oblivious=False, rf=False)
    want = tr.fit_forest(xb, edges, y, **kw)
    assert tr.REPLAY_TREES
    with pytest.raises(RuntimeError, match="inside"):
        with eager_tree_loop():
            assert not tr.REPLAY_TREES
            tr.grow_trees(3, on_card, lambda: steps.append(1), graph=True)
            got = tr.fit_forest(xb, edges, y, **kw)
            raise RuntimeError("inside")
    assert tr.REPLAY_TREES and steps == [1, 1, 1]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["gbdt", "rf"])
def test_audit_of_a_keyed_stochastic_fit_checks_every_node(kind):
    """``compare_gbdt_fits`` with the fit's seed replays its keyed draws: a
    CPU fit at subsample 0.8 and colsample 0.6 (a random forest: Poisson
    weights, colsample 0.5) is the plain best split at every node, another
    fit with its own seed equals it node by node, a split moved to another
    feature is found, and without the seed the replay refuses."""
    from bbbp_tpu_torch.testing import compare_gbdt_fits

    rng = np.random.default_rng(31)
    x = rng.normal(size=(400, 6)).astype(np.float32)
    y = (x[:, 0] - 2 * x[:, 1] + 0.3 * rng.normal(size=400) > 0).astype(np.float32)
    if kind == "gbdt":
        fit = tr.GBDTClassifier(n_estimators=8, max_depth=3, learning_rate=0.3,
                                subsample=0.8, colsample=0.6, seed=4,
                                device="cpu").fit(x, y)
        args = dict(task="cls", lam=1.0, learning_rate=0.3, subsample=0.8,
                    colsample=0.6, base_score=fit.ensemble_.base_score)
    else:
        fit = tr.RandomForestClassifier(n_estimators=8, max_depth=3, seed=4,
                                        device="cpu").fit(x, y)
        args = dict(task="reg", lam=1e-6, learning_rate=1.0, colsample=0.5, rf=True,
                    base_score=0.0)
    args.update(min_child=1.0, tol=1e-6, seed=4)
    state = fit.ensemble_.to_state()
    audit = compare_gbdt_fits(x, y, None, state, **args)
    assert audit.ok and audit.trees_compared == 8, audit
    assert audit.equal == 8 * 7 and audit.near_ties == 0
    assert audit.max_leaf_diff <= 1e-5
    cmp = compare_gbdt_fits(x, y, state, state, **args)
    assert cmp.ok and cmp.equal == 8 * 7 and cmp.max_leaf_diff == 0.0
    bad = {**state, "feat": state["feat"].copy(), "thr": state["thr"].copy()}
    bad["feat"][5, 0] = (bad["feat"][5, 0] + 1) % 6
    bad["thr"][5, 0] = np.float32(np.median(x[:, bad["feat"][5, 0]]))
    assert compare_gbdt_fits(x, y, None, bad, **args).mismatch == (5, 0)
    with pytest.raises(ValueError, match="seed"):
        compare_gbdt_fits(x, y, None, state, **{**args, "seed": None})


# -- on the card ---------------------------------------------------------------------

@pytest.mark.cuda
def test_forest_draws_match_plain_version_on_cuda(cuda_device):
    seeds = [0, 1, 131 * 7 + 3, -1, (1 << 63) - 1, 42 + 7700]
    for stream, size in (("subsample", 8162), ("columns", 458), ("poisson", 8162)):
        for lanes in (1, len(seeds)):
            s = torch.tensor(seeds[:lanes])
            for tree, offset in ((0, 0), (299, 1)):
                got = tr.forest_draws(s.to(cuda_device), torch.tensor(
                    [tree], device=cuda_device), stream, size, tree_offset=offset)
                want = tr.forest_draws_reference(s, tree + offset, stream, size)
                assert torch.equal(got.cpu(), want), (stream, lanes, tree)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_graph_equals_eager_on_cuda(case, cuda_device):
    """The replayed CUDA graph against the eager loop on the card: one fit
    and three lanes, bit for bit, with each kernel's launches the same, and
    the cuda fit's draws those of the CPU fit (the first tree's column mask
    equal)."""
    kw = LOOP_CASES[case]
    xb, edges, y, n_bins = (t.to(cuda_device) for t in _case_data(kw["task"], n=2000,
                                                                 n_feat=30))
    base = 0.0 if kw["rf"] else float(y.mean())
    args = dict(lr=0.3, lam=1.0, min_child=1.0, subsample=0.8, colsample=0.6,
                base_score=base, seed=5, n_trees=12, depth=5, n_bins=n_bins, **kw)
    lane_args = dict(lr=0.3, lam=1.0, subsample=0.8, colsample=0.6, seeds=[5, 6, 7],
                     row_w=torch.ones(3, 2000, device=cuda_device), base_score=base,
                     n_trees=12, depth=5, n_bins=n_bins, **kw)
    for fit, fit_args in ((tr.fit_forest, args), (tr.fit_forest_lanes, lane_args)):
        counts = []
        outs = []
        for graph in (False, True):
            for c in tr.TREE_KERNELS:
                c.launches.reset()
            outs.append(fit(xb, edges, y, graph=graph, **fit_args))
            counts.append([c.launches.count for c in tr.TREE_KERNELS])
        assert counts[0] == counts[1] and counts[0][-1] > 0
        for name, a, b in zip(("preds", "feats", "thrs", "leaves"), *outs):
            assert torch.equal(a, b), (fit.__name__, name)
