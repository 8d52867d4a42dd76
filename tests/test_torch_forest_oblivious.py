"""Port parity: the fused oblivious split search over lanes
(``level_splits_oblivious_lanes``) against the JAX package's
``_grow_level(..., oblivious=True, hist_mode="matmul")`` under ``jax.vmap``
on the CPU, its plain versions, its plan and bound, and CUDA tests
of the kernel against K3 then K4 with lanes and of K9's row alignments.

Tolerances:

- integer-valued g and h: every bin sum is exact in either package, so each
  lane's (feat, bin, has_split) equals the vmapped ``_grow_level``'s;
- random f32 g and h: the two packages sum the bins in other orders (row
  order here, a matmul there), so a lane may pick another split of an equal
  summed gain: at most 1% of the (lane, level) picks differ, each a counted
  near tie (the two picks' summed gains within 1e-5 of the larger);
- on the card: bit-equal to K3 with lanes then K4 with lanes (oblivious);
  a lane of ``fit_forest_lanes`` bit-equal to ``fit_forest``; K9 bit-equal
  to its plain version.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu_torch.ops import forest_train as tr  # noqa: E402
from bbbp_tpu_torch.timing import level_splits_oblivious_bound  # noqa: E402


# The JAX package is the reference; it is imported by fixtures so that the
# CUDA tests below also run where JAX is absent (on the card's machine).
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


LANES = 6
LAMBDAS = [0.1, 0.5, 1.0, 2.0, 5.0, 10.0]
NEAR_TIE_SHARE = 0.01


def _level(seed, level, n_feat, integer, lanes=LANES, n=300, empty=False,
           col_share=1.0):
    """One level over ``lanes`` lanes: a fifth of each lane's rows of weight
    0; integer-valued g and h (sums exact in any order) or random f32; a
    feature of three bins; with ``empty``, only even nodes hold rows."""
    rng = np.random.default_rng(seed)
    nodes = 1 << level
    xb = rng.integers(0, tr.MAX_BINS, (n, n_feat)).astype(np.uint8)
    xb[:, 1 % n_feat] = rng.integers(0, 3, n)
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
    g[1 % lanes] *= 40.0                             # a lane of other bounds
    mask = rng.random((lanes, n_feat)) < col_share
    mask[np.arange(lanes), rng.integers(0, n_feat, lanes)] = True
    return xb, pos, g, h, mask


def _jax_oblivious(jft, jax, xb, pos, g, h, mask, level, lam, min_child):
    """``jax.vmap`` of ``_grow_level(..., oblivious=True, hist="matmul")``
    over the lanes, as the JAX package's vmapped search runs it, with xb and
    the masks padded and chunked as ``_fit_forest_device`` does."""
    jnp = jax.numpy
    n, n_feat = xb.shape
    fc = min(jft.F_CHUNK, jft._pad128(n_feat))
    pad = (-n_feat) % fc
    xb_chunks = jnp.pad(jnp.asarray(xb, jnp.int32), ((0, 0), (0, pad)))
    xb_chunks = xb_chunks.reshape(n, -1, fc).transpose(1, 0, 2)
    masks = jnp.pad(jnp.asarray(mask), ((0, 0), (0, pad))).reshape(len(mask), -1, fc)

    def one(p, gl, hl, lm, m):
        return jft._grow_level(p, xb_chunks, gl, hl, level, tr.MAX_BINS, lm,
                               min_child, m, True, hist_mode="matmul")

    out = jax.vmap(one)(jnp.asarray(pos), jnp.asarray(g), jnp.asarray(h),
                        jnp.asarray(lam, jnp.float32), masks)
    return [np.asarray(a) for a in out]


def _splits(xb, pos, g, h, mask, level, lam, min_child, **kw):
    return tr.level_splits_oblivious_lanes(
        torch.from_numpy(xb), torch.from_numpy(pos), torch.from_numpy(g),
        torch.from_numpy(h), 1 << level, None, torch.from_numpy(mask),
        torch.tensor(lam, dtype=torch.float32), min_child, **kw)


def _summed_gains(xb, pos, g, h, mask, nodes, lam, min_child):
    """A lane's oblivious scores over f · 64 + b from its f32 histogram, as
    ``best_splits_reference`` sums them (-inf where no node is valid)."""
    hist = tr.level_histogram_reference(torch.from_numpy(xb), torch.from_numpy(pos),
                                        torch.from_numpy(g), torch.from_numpy(h), nodes)
    gain, valid = tr.split_gains(hist, torch.from_numpy(mask), lam, min_child)
    score = torch.where(valid & (gain > 0), gain, torch.zeros_like(gain)).sum(0)
    return torch.where(valid.any(0), score, -torch.inf).reshape(-1)


# -- against the JAX package's _grow_level ----------------------------------------

@pytest.mark.parametrize("level,n_feat,min_child,col_share,empty", [
    (0, 5, 1.0, 1.0, False), (1, 12, 0.0, 0.6, False), (2, 9, 1.0, 0.5, True),
    (3, 7, 0.0, 1.0, True), (4, 12, 1.0, 0.7, False), (4, 6, 0.0, 0.4, True),
    (3, 40, 1.0, 0.8, False)])
def test_oblivious_splits_equal_vmapped_grow_level_exactly(level, n_feat, min_child,
                                                           col_share, empty, jft, jax):
    """Integer-valued g and h: each lane's split, written to every node,
    equals the vmapped ``_grow_level``'s at per-lane lambda 0.1-10, with a
    lane of 40x gradients, column masks, zero-weight rows and, where
    ``empty``, empty nodes; no launch is counted on the CPU."""
    xb, pos, g, h, mask = _level(level * 10 + n_feat, level, n_feat, True,
                                 empty=empty, col_share=col_share)
    before = tr.level_splits_oblivious_lanes.launches.count
    got = _splits(xb, pos, g, h, mask, level, LAMBDAS, min_child)
    want = _jax_oblivious(jft, jax, xb, pos, g, h, mask, level, LAMBDAS, min_child)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)
    assert got[2].any()
    for a in got:                                   # one split a level
        assert torch.equal(a, a[:, :1].expand_as(a))
    assert tr.level_splits_oblivious_lanes.launches.count == before


@pytest.mark.parametrize("min_child", [0.0, 1.0])
def test_oblivious_splits_equal_vmapped_grow_level_but_near_ties(min_child, jft, jax):
    """Random f32 g and h at levels 0-5: at most 1% of the (lane, level)
    picks differ from the vmapped ``_grow_level``'s, each a near tie."""
    picks = near = 0
    for level in range(6):
        xb, pos, g, h, mask = _level(200 + level, level, 11, False, col_share=0.7)
        got = _splits(xb, pos, g, h, mask, level, LAMBDAS, min_child)
        want = _jax_oblivious(jft, jax, xb, pos, g, h, mask, level, LAMBDAS, min_child)
        for i in range(LANES):
            picks += 1
            a = [int(t[i, 0]) for t in got]
            b = [int(t[i, 0]) for t in want]
            if a == b:
                continue
            score = _summed_gains(xb, pos[i], g[i], h[i], mask[i], 1 << level,
                                  LAMBDAS[i], min_child)
            sa = float(score[a[0] * 64 + a[1]]) if a[2] else 0.0
            sb = float(score[b[0] * 64 + b[1]]) if b[2] else 0.0
            assert abs(sa - sb) <= 1e-5 * max(1.0, abs(sa), abs(sb)), (level, i, a, b)
            near += 1
    assert near <= NEAR_TIE_SHARE * picks, (near, picks)


@pytest.mark.parametrize("min_child", [0.0, 1.0])
def test_oblivious_plain_versions_agree(min_child):
    """On the CPU the wrapper is K3's then K4's lane plain versions in
    oblivious mode; with integer-valued sums the fixed-point plain version
    (the kernel's arithmetic) gives the same splits."""
    xb, pos, g, h, mask = (torch.from_numpy(a) for a in _level(
        7, 3, 10, True, empty=True, col_share=0.6))
    lam = torch.tensor(LAMBDAS)
    got = tr.level_splits_oblivious_lanes(xb, pos, g, h, 8, None, mask, lam, min_child)
    two = tr.best_splits_lanes(tr.level_histogram_lanes(xb, pos, g, h, 8), mask, lam,
                               min_child, True)
    fixed = tr.level_splits_lanes_fixed_reference(xb, pos, g, h, 8, mask, lam, min_child,
                                                  tr.gradient_bounds(g, h),
                                                  oblivious=True)
    for a, b, c in zip(got, two, fixed):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_a_dead_level_sends_every_row_left():
    """No feature live for any node at min_child above every node's hessian:
    (0, 63, False) for every node, K4's dead-level rule."""
    xb, pos, g, h, mask = (torch.from_numpy(a) for a in _level(9, 2, 6, True))
    got = tr.level_splits_oblivious_lanes(xb, pos, g, h, 4, None, mask,
                                          torch.tensor(LAMBDAS), 1e9)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.equal(got[1], torch.full_like(got[1], tr.MAX_BINS - 1))
    assert not got[2].any()


@pytest.mark.parametrize("lanes", [1, 3])
def test_a_parent_split_is_routed_then_the_plain_version_runs(lanes):
    """With a parent split the positions are routed in place
    (``route_rows_reference``), the parent's pairs written into the tree,
    and the splits are those of the call on the routed positions."""
    xb, pos, g, h, mask = (torch.from_numpy(a) for a in _level(
        11, 2, 7, True, lanes=lanes))
    lam = torch.tensor(LAMBDAS[:lanes])
    f_l, b_l, _ = tr.level_splits_oblivious_lanes(xb, pos, g, h, 4, None, mask, lam, 1.0)
    feats = torch.zeros((lanes, 2, 15), dtype=torch.int32)
    bins = torch.zeros_like(feats)
    routed, f_r, b_r = pos.clone(), feats.clone(), bins.clone()
    tr.route_rows_reference(xb, routed, f_l, b_l, f_r, b_r, 1, 2)
    p = pos.clone()
    got = tr.level_splits_oblivious_lanes(
        xb, p, g, h, 8, None, mask, lam, 1.0,
        parent=tr.ParentSplit(f_l, b_l, feats, bins, 1, 2))
    want = tr.level_splits_oblivious_lanes(xb, routed.clone(), g, h, 8, None, mask, lam,
                                           1.0)
    assert torch.equal(p, routed)
    assert torch.equal(feats, f_r) and torch.equal(bins, b_r)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_oblivious_splits_reject_wrong_inputs():
    xb, pos, g, h, mask = (torch.from_numpy(a) for a in _level(1, 2, 5, True))
    lam = torch.tensor(LAMBDAS)
    with pytest.raises(TypeError, match="col_mask"):
        tr.level_splits_oblivious_lanes(xb, pos, g, h, 4, None, mask[:, :3].contiguous(),
                                        lam, 1.0)
    with pytest.raises(TypeError, match="lam"):
        tr.level_splits_oblivious_lanes(xb, pos, g, h, 4, None, mask,
                                        lam[:2].contiguous(), 1.0)
    with pytest.raises(TypeError, match="pos"):
        tr.level_splits_oblivious_lanes(xb, pos[0], g, h, 4, None, mask, lam, 1.0)
    with pytest.raises(ValueError, match="n_nodes"):
        tr.level_splits_oblivious_lanes(xb, pos, g, h, 0, None, mask, lam, 1.0)
    with pytest.raises(ValueError, match="parent split of level 1"):
        tr.level_splits_oblivious_lanes(
            xb, pos, g, h, 8, None, mask, lam, 1.0,
            parent=tr.ParentSplit(torch.zeros(LANES, 2, dtype=torch.int32),
                                  torch.zeros(LANES, 2, dtype=torch.int32),
                                  torch.zeros(LANES, 1, 7, dtype=torch.int32),
                                  torch.zeros(LANES, 1, 7, dtype=torch.int32), 0, 1))
    with pytest.raises(ValueError, match="no forest_level_splits_oblivious_lanes kernel"):
        tr.level_splits_oblivious_lanes(*(t.to("meta") for t in (xb, pos, g, h)), 4, None,
                                        mask.to("meta"), lam.to("meta"), 1.0)


# -- the plan, the bound and the lane block ------------------------------------------

@pytest.mark.parametrize("n,nodes", [(8162, 1), (8162, 32), (8162, 2048), (0, 4), (1, 1)])
def test_oblivious_plan_owns_every_node(n, nodes):
    """The oblivious sort owns every node whole: an item a node, no
    accumulator; its words lie inside the per-node plan's, and a lane's
    words are even."""
    plan = tr.oblivious_plan(n, nodes)
    assert plan["acc_slots"] == 0 and plan["plan"] == 0
    assert plan["max_items"] == nodes + (1 if n else 0)
    assert plan["rows_per_item"] == plan["own_rows"] == max(n, 1)
    assert plan["lane_words"] % 2 == 0 and plan["lane_words"] >= plan["words"]
    if n > 256:                             # past one item of the per-node plan
        assert plan["words"] <= tr.histogram_plan(n, 30, nodes)["words"]


def test_oblivious_bound_counts_every_bin():
    """Bytes as ``level_splits_bound``'s; operations two adds a (row,
    feature, lane) and K4's 15 a (lane, node, feature, bin) over all 64 bins;
    a parent split adds its routing."""
    from bbbp_tpu_torch.timing import level_splits_bound

    bound = level_splits_oblivious_bound(4, 2, 2, 3)
    assert bound["bytes"] == level_splits_bound(4, 2, 2, 3, 0)["bytes"]
    assert bound["ops"] == 3 * (2 * 4 * 2 + 15 * 2 * 2 * 64)
    routed = level_splits_oblivious_bound(4, 2, 2, 3, parent_nodes=1)
    assert routed["bytes"] == bound["bytes"] + 3 * (4 * 4 + 16)
    assert routed["ops"] == bound["ops"] + 3 * 2 * 4
    # cat's group, L = 250 at 8,162 rows and 30 features: level 5 reads more
    # than it computes, level 9 the other way round
    assert level_splits_oblivious_bound(8162, 30, 32, 250)["bound_by"] == "bytes"
    assert level_splits_oblivious_bound(8162, 30, 512, 250)["bound_by"] == "operations"


def test_an_oblivious_lane_counts_a_histogram_past_the_cut_over():
    """``lane_bytes`` counts the [nodes, F, 64, 2] histogram of an oblivious
    lane where some form of the fused search gives its deepest level to K3
    then K4 with lanes (``OBLIVIOUS_FUSED_LEVELS``; a lane of few lanes
    takes them at every level): so a 255-lane depth-12 oblivious group
    takes two blocks of ``FOREST_LANE_BUDGET`` and cat's depth-6 group of
    300 trees one; a depth-0 lane (no level) holds no more than a per-node
    one."""
    from bbbp_tpu_torch.train import batched_search as tb

    cut = min(lv for form in tr.OBLIVIOUS_FUSED_LEVELS for _, lv in form)
    assert tr.lane_bytes(8162, 30, 0, 5, True) <= tr.lane_bytes(8162, 30, 0, 5, False)
    for depth in (cut + 1, 6, 12):
        nodes = 1 << (depth - 1)
        assert (tr.lane_bytes(8162, 30, depth, 1, True)
                - tr.lane_bytes(8162, 30, depth, 1, False)
                >= nodes * 30 * tr.MAX_BINS * 8 - nodes * 4 * 8)
    assert -(-255 // tb.lane_block(8162, 30, 12, 1, True)) == 2
    assert -(-255 // tb.lane_block(8162, 30, 6, 300, True)) == 1


@pytest.mark.parametrize("lanes, n_feat, sms, form", [
    (255, 30, 132, 0), (132, 30, 132, 0), (131, 30, 132, 1), (34, 30, 132, 1),
    (33, 30, 132, 2), (10, 30, 132, 2), (1, 30, 132, 2), (5, 167, 132, 2),
    (20, 167, 132, 1), (22, 167, 132, 0), (1, 30, 0, 0)])
def test_oblivious_form_follows_the_lanes_blocks_against_the_sms(lanes, n_feat, sms, form):
    """The fused oblivious search's form as its launch picks it: blocks of 32
    features where the lanes' blocks fill the SMs, else of 8, in blocks of
    1,024 threads where even those do not fill them."""
    assert tr.oblivious_form(lanes, n_feat, sms) == form


@pytest.mark.parametrize("lanes, levels", [
    (1, 0), (10, 0), (14, 0), (15, 3), (33, 4), (34, 2), (79, 2), (80, 3), (131, 4),
    (132, 5), (249, 5), (250, 6), (255, 7)])
def test_oblivious_cut_over_is_the_measured_one(lanes, levels):
    """At 132 SMs and 30 features the fused oblivious search takes the
    levels before the first one where torch_oblivious_profile.py measured K3
    then K4 with lanes faster (L = 10, 15, 33, 34, 80, 131, 132, 250, 255),
    and between two measured lane counts the lower one's."""
    assert tr.oblivious_fused_levels(lanes, 30, 132) == levels


@pytest.mark.parametrize("fused_levels", [0, 1, 2, 3])
def test_fit_forest_lanes_takes_the_fused_oblivious_search(monkeypatch, fused_levels):
    """An oblivious lane fit calls the fused oblivious search once at each of
    its first ``oblivious_fused_levels`` levels and K3 then K4 with lanes
    at each level past them, and fits the same trees whatever the cut (the
    plain versions on the CPU count no launch, so the calls are counted
    around the functions; a CPU counts no SMs, the first form's levels)."""
    x = np.random.default_rng(5).normal(size=(120, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    mapper = tr.BinMapper().fit(x)
    xb = torch.from_numpy(mapper.transform(x))
    kw = dict(lr=0.1, lam=[1.0, 2.0], subsample=1.0, colsample=1.0, seeds=[1, 2],
              row_w=torch.ones(2, 120), base_score=0.0, task="cls", n_trees=2, depth=3,
              oblivious=True, rf=False)
    every = tr.fit_forest_lanes(xb, torch.from_numpy(mapper.edge_values()),
                                torch.from_numpy(y), **kw)
    calls = []

    def counted(name, fn):
        def call(*args, **kw):
            calls.append((name, args[4] if name != "K4" else None))
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(tr, "OBLIVIOUS_FUSED_LEVELS",
                        (((0.0, fused_levels),), ((0.0, 9),), ((0.0, 9),)))
    monkeypatch.setattr(tr, "level_splits_oblivious_lanes",
                        counted("fused", tr.level_splits_oblivious_lanes))
    monkeypatch.setattr(tr, "level_histogram_lanes", counted("K3", tr.level_histogram_lanes))
    monkeypatch.setattr(tr, "best_splits_lanes", counted("K4", tr.best_splits_lanes))
    got = tr.fit_forest_lanes(xb, torch.from_numpy(mapper.edge_values()),
                              torch.from_numpy(y), **kw)
    want = []
    for lv in range(3):
        want += ([("fused", 1 << lv)] if lv < fused_levels
                 else [("K3", 1 << lv), ("K4", None)])
    assert calls == want * 2
    for a, b in zip(got, every):
        assert torch.equal(a, b)


@pytest.mark.parametrize("poisson", [False, True])
def test_forest_draws_bound_counts_both_integer_pipes(poisson):
    """K9's bound counts a Threefry block's 31 adds, which either integer
    pipe issues, and its 40 shifts and xors, which only the ALU pipe issues
    (a uniform adds a shift and a scale, a Poisson count 8 compares and
    selects on the ALU pipe): the larger of the ALU pipe's share at the
    LOP3 rate and all of it at the two pipes' rate, which lies below all of
    it at the LOP3 rate alone."""
    from bbbp_tpu_torch import timing

    draws = 255 * 8162
    ops = draws * (71 + (8 if poisson else 2))
    alu = draws * (40 + (8 if poisson else 1))
    bound = timing.forest_draws_bound(255, 8162, poisson)
    assert bound["ops"] == ops and bound["bytes"] == 4 * draws + 8 * 255 + 8
    assert bound["bound_by"] == "operations"
    want = max(alu / timing.INT32_OPS_PER_S, ops / timing.INT32_TWO_PIPES_OPS_PER_S) * 1e3
    assert bound["bound_ms"] == pytest.approx(want, rel=1e-12)
    assert alu / timing.INT32_OPS_PER_S * 1e3 <= bound["bound_ms"]
    assert bound["bound_ms"] < ops / timing.INT32_OPS_PER_S * 1e3


# -- on the card -----------------------------------------------------------------------

def _card_level(seed, lanes, level, device, n=8162, n_feat=30):
    rng = np.random.default_rng(seed)
    nodes = 1 << level
    xb = rng.integers(0, 64, (n, n_feat)).astype(np.uint8)
    xb[:, 1] = rng.integers(0, 3, n)
    pos = rng.integers(0, nodes, (lanes, n)).astype(np.int32)
    g = rng.normal(size=(lanes, n)).astype(np.float32)
    h = rng.uniform(0.05, 0.3, (lanes, n)).astype(np.float32)
    zero = rng.random((lanes, n)) < 0.2
    g[zero], h[zero] = 0.0, 0.0
    g[rng.integers(0, lanes)] *= 40.0
    return [torch.from_numpy(a).to(device) for a in (xb, pos, g, h)]


@pytest.mark.cuda
def test_oblivious_splits_equal_two_kernels_on_cuda(cuda_device):
    """The fused oblivious search equals K3 with lanes then K4 with lanes
    (oblivious) bit for bit at L = 1, 15 and 250, levels 0-5, 9 and 11 over
    8,162 rows and 30 features, with the parent level routed in place,
    per-lane lambda, column masks, min_child 0 and 1, zero-weight rows and
    empty nodes (half the parents send every row left); its sort keeps each
    node's rows."""
    n, n_feat = 8162, 30
    for lanes in (1, 15, 250):
        for level in (0, 1, 2, 3, 4, 5, 9, 11):
            xb, pos, g, h = _card_level(lanes * 100 + level, lanes, level, cuda_device)
            nodes = 1 << level
            bounds = tr.gradient_bounds(g, h)
            lam = torch.logspace(-1, 1, lanes, device=cuda_device)
            mask = torch.rand(lanes, n_feat, device=cuda_device) < 0.7
            mask[:, 0] = True
            # the parent level's split (random) routes pos into this level
            parent_nodes = max(nodes // 2, 1)
            f_p = torch.randint(0, n_feat, (lanes, parent_nodes), dtype=torch.int32,
                                device=cuda_device)
            b_p = torch.randint(0, 64, (lanes, parent_nodes), dtype=torch.int32,
                                device=cuda_device)
            b_p[:, ::2] = 63                    # every row left: empty nodes
            start = (pos >> 1) if level else pos
            feats = torch.zeros((lanes, 1, 4095), dtype=torch.int32, device=cuda_device)
            bins = torch.zeros_like(feats)
            routed = start.clone()
            if level:
                tr.route_rows_reference(xb, routed, f_p, b_p, feats.clone(), bins.clone(),
                                        0, level - 1)
            for min_child in (0.0, 1.0):
                p_k = start.clone()
                parent = (tr.ParentSplit(f_p, b_p, feats, bins, 0, level - 1)
                          if level else None)
                scratch = torch.empty(lanes * tr.oblivious_plan(n, nodes)["lane_words"],
                                      dtype=torch.int64, device=cuda_device)
                got = tr.level_splits_oblivious_lanes(xb, p_k, g, h, nodes, bounds, mask,
                                                      lam, min_child, parent=parent,
                                                      scratch=scratch)
                hist = tr.level_histogram_lanes(xb, routed.clone(), g, h, nodes, bounds)
                two = tr.best_splits_lanes(hist, mask, lam, min_child, True)
                torch.cuda.synchronize()
                assert torch.equal(p_k, routed), (lanes, level)
                for a, b in zip(got, two):
                    assert torch.equal(a, b), (lanes, level, min_child)
                del hist
                for i in range(0, lanes, 50):
                    node, row = tr.sorted_rows(scratch, n, n_feat, nodes, i, oblivious=True)
                    kept = torch.nonzero(((g[i] != 0) | (h[i] != 0)).cpu()).flatten()
                    want = sorted(zip(routed[i].cpu()[kept].tolist(), kept.tolist()))
                    assert sorted(zip(node.tolist(), row.tolist())) == want


@pytest.mark.cuda
def test_oblivious_feature_groups_give_the_same_bits_on_cuda(cuda_device):
    """Every form of the kernel gives the bits of K3 then K4 with lanes: F =
    167, 32 and 7 (groups partly filled) over 5 lanes (8 features a block,
    1,024 threads), F = 30 over 50 lanes (8 features, 512 threads) and over
    200 (32 features)."""
    for n_feat, level, lanes in ((167, 5, 5), (32, 3, 5), (7, 0, 5), (30, 4, 50),
                                 (30, 2, 200)):
        xb, pos, g, h = _card_level(n_feat, lanes, level, cuda_device, n_feat=n_feat)
        nodes = 1 << level
        bounds = tr.gradient_bounds(g, h)
        lam = torch.logspace(-1, 1, lanes, device=cuda_device)
        mask = torch.rand(lanes, n_feat, device=cuda_device) < 0.7
        mask[:, 0] = True
        hist = tr.level_histogram_lanes(xb, pos, g, h, nodes, bounds)
        want = tr.best_splits_lanes(hist, mask, lam, 1.0, True)
        got = tr.level_splits_oblivious_lanes(xb, pos.clone(), g, h, nodes, bounds, mask,
                                              lam, 1.0)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), n_feat


@pytest.mark.cuda
@pytest.mark.parametrize("cut", ["measured", "every level fused", "three levels fused"])
def test_oblivious_lanes_equal_fit_forest_on_cuda(cuda_device, monkeypatch, cut):
    """Each oblivious lane of a fit on the card equals ``fit_forest`` on the
    card with its seed, bit for bit, and the fused search ran at the levels
    ``oblivious_fused_levels`` gives 4 lanes, K3 then K4 with lanes at the
    others: the measured cut-over (4 lanes: none), and the fused search at
    every level or at the first three."""
    if cut != "measured":
        levels = tr.MAX_DEPTH if cut == "every level fused" else 3
        monkeypatch.setattr(tr, "OBLIVIOUS_FUSED_LEVELS",
                            tuple(((0.0, levels),) for _ in range(3)))
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2000, 30)).astype(np.float32)
    y = (x[:, 0] - x[:, 3] > 0).astype(np.float32)
    mapper = tr.BinMapper().fit(x)
    xb = torch.from_numpy(mapper.transform(x)).to(cuda_device)
    edges = torch.from_numpy(mapper.edge_values()).to(cuda_device)
    n_bins = torch.from_numpy(mapper.bin_counts()).to(cuda_device)
    row_w = (torch.rand(4, 2000, device=cuda_device) > 0.2).float()
    yt = torch.from_numpy(y).to(cuda_device)
    kw = dict(base_score=0.1, task="cls", n_trees=20, depth=6, oblivious=True,
              rf=False, n_bins=n_bins)
    lr, lam, sub, col = [0.1, 0.3, 0.05, 0.2], [1.0, 0.2, 4.0, 1.0], \
        [0.8, 1.0, 0.6, 0.9], [0.5, 1.0, 0.8, 0.6]
    for c in tr.TREE_KERNELS:
        c.launches.reset()
    lanes = tr.fit_forest_lanes(xb, edges, yt, lr=lr, lam=lam, subsample=sub,
                                colsample=col, seeds=[0, 1, 131, 132], row_w=row_w, **kw)
    fused = min(6, tr.oblivious_fused_levels(
        4, 30, torch.cuda.get_device_properties(cuda_device).multi_processor_count))
    assert tr.level_splits_oblivious_lanes.launches.count == 20 * fused
    assert tr.level_histogram_lanes.launches.count == 20 * (6 - fused)
    assert tr.best_splits_lanes.launches.count == 20 * (6 - fused)
    for i, seed in enumerate([0, 1, 131, 132]):
        one = tr.fit_forest(xb, edges, yt, lr=lr[i], lam=lam[i], min_child=1.0,
                            subsample=sub[i], colsample=col[i], seed=seed,
                            row_w=row_w[i], **kw)
        for a, b in zip(lanes, one):
            assert torch.equal(a[i], b), i


@pytest.mark.cuda
def test_forest_draws_every_row_alignment_on_cuda(cuda_device):
    """K9 bit-equal to its plain version at sizes whose lanes' rows start at
    every offset from a 16-byte boundary, rows shorter than 4 draws
    included."""
    seeds = torch.tensor([3, 5, 7, 11, 13, 17, -2])
    for stream in ("subsample", "columns", "poisson"):
        for size in (1, 2, 3, 4, 5, 7, 30, 457, 8162):
            got = tr.forest_draws(seeds.to(cuda_device),
                                  torch.tensor([4], device=cuda_device), stream, size)
            want = tr.forest_draws_reference(seeds, 4, stream, size)
            assert torch.equal(got.cpu(), want), (stream, size)
