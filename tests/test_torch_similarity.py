"""Port parity of the similarity slice: bbbp_tpu_torch.ops.similarity against
bbbp_tpu.ops.similarity on the CPU (the port runs its kernels' plain
versions there; the JAX functions are plain XLA code). Inputs come from
numpy seeds. Tolerances: the top-k indices and similarities, and the
unweighted grams, are exact (integer sums, one f32 division); the weighted
grams agree within 1e-5 (sums in another order); kernel-ridge predictions
within 2e-3 (two f32 Cholesky solves; the JAX package's own test holds its
solve to float64 with the same bound)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu_torch.ops import bitops as tbit  # noqa: E402
from bbbp_tpu_torch.ops import similarity as tsim  # noqa: E402
from bbbp_tpu_torch.testing import (EQUAL_F32_K, count_case,  # noqa: E402
                                    tanimoto_equal_f32_case, tanimoto_tie_case)

RIDGE_TOL = dict(rtol=2e-3, atol=2e-3)


# The JAX package is imported by fixtures so that the CUDA test below also
# runs where JAX is absent.
@pytest.fixture(scope="module")
def jnp():
    return pytest.importorskip("jax.numpy")


@pytest.fixture(scope="module")
def jsim():
    return pytest.importorskip("bbbp_tpu.ops.similarity")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _packed_unpadded(dense, device):
    """Packed words of 0/1 rows, ceil(d / 32) a row, as the kernels take
    them from any caller (``packed_bits`` pads rows to 4 words)."""
    return torch.from_numpy(tbit.pack_bits(dense).view(np.int32)).to(device)


def _bits(rng, n, d, density=0.3):
    return (rng.random((n, d)) < density).astype(np.float32)


def _maccs_case():
    from bbbp_tpu_torch.chem.featurize import fingerprints
    from bbbp_tpu_torch.data.zinc import synthetic_smiles

    x = fingerprints(synthetic_smiles(600, seed=8), "maccs").features
    return x[:80], x[80:]


# -- packing ---------------------------------------------------------------

@pytest.mark.parametrize("d", [24, 30, 40, 167, 2048])
def test_pack_bits_pads_to_words_and_tensor_form_is_equal(d):
    dense = _bits(np.random.default_rng(d), 37, d, 0.5)
    dense[3] = 1.0
    words = tbit.pack_bits(dense)
    assert words.shape == (37, -(-d // 32)) and words.dtype == np.uint32
    back = tbit.unpack_bits_reference(torch.from_numpy(words.view(np.int32)),
                                      words.shape[1] * 32).numpy()
    assert np.array_equal(back[:, :d], dense)
    assert not back[:, d:].any()                      # pad bits stay zero
    on_tensor = tbit.pack_bits_tensor(torch.from_numpy(dense))
    assert on_tensor.dtype == torch.int32
    assert np.array_equal(on_tensor.numpy().view(np.uint32), words)


def test_pack_counts_clips_before_the_byte_cast():
    c = np.array([[40.0, 1.0, 300.0, 0.0, 7.0]], np.float32)
    words = tsim.pack_counts(c, 16)
    assert words.shape == (1, 2) and words.dtype == torch.int32
    assert tsim.unpack_counts_reference(words).tolist() == [
        [16.0, 1.0, 16.0, 0.0, 7.0, 0.0, 0.0, 0.0]]
    with pytest.raises(ValueError):
        tsim.pack_counts(c, 256)


# -- the functions -----------------------------------------------------------

@pytest.mark.parametrize("case", ["ties_d40", "ties_d167", "maccs_k25",
                                  "k_equals_nr", "k1_single_query"])
def test_tanimoto_topk_indices_and_similarities_equal_jax(case, jnp, jsim):
    if case == "maccs_k25":
        (q, r), k = _maccs_case(), 25
    elif case == "k_equals_nr":
        (q, r), k = tanimoto_tie_case(3, 9, 33, 24), 33
    elif case == "k1_single_query":
        (q, r), k = tanimoto_tie_case(4, 1, 50, 30), 1
    else:
        d = int(case.split("_d")[1])
        (q, r), k = tanimoto_tie_case(d, 60, 400, d), 10
    want_sim, want_idx = (np.asarray(a) for a in jsim.tanimoto_topk(
        jnp.asarray(q), jnp.asarray(r), k))
    sim, idx = tsim.tanimoto_topk(q, r, k, device="cpu")
    assert sim.dtype == torch.float32 and idx.dtype == torch.int64
    if case in ("ties_d40", "ties_d167", "maccs_k25"):
        # the case does hold ties at the k-th place, where a sort that is
        # not stable returns other indices
        full = np.asarray(jsim.tanimoto_matrix(jnp.asarray(q), jnp.asarray(r)))
        kth = np.sort(full, axis=1)[:, ::-1][:, k - 1]
        assert ((full == kth[:, None]).sum(1) > (want_sim == kth[:, None]).sum(1)
                ).mean() > 0.2
    assert np.array_equal(idx.numpy(), want_idx)
    assert np.array_equal(sim.numpy(), want_sim)


@pytest.mark.parametrize("d", [24, 30, 40, 167, 2048])
def test_tanimoto_matrix_bit_equal_and_weighted_close(d, jnp, jsim):
    rng = np.random.default_rng(d)
    q, r = _bits(rng, 31, d, 0.2), _bits(rng, 45, d, 0.2)
    q[5] = 0.0
    r[7] = 0.0
    w = rng.uniform(0.1, 3.0, d).astype(np.float32)
    want = np.asarray(jsim.tanimoto_matrix(jnp.asarray(q), jnp.asarray(r)))
    got = tsim.tanimoto_matrix(torch.from_numpy(q), r, device="cpu")
    assert np.array_equal(got.numpy(), want)
    assert got[5].abs().max() == 0 and got[:, 7].abs().max() == 0
    want_w = np.asarray(jsim.tanimoto_matrix_w(jnp.asarray(q), jnp.asarray(r),
                                               jnp.asarray(w)))
    got_w = tsim.tanimoto_matrix_w(q, r, w, device="cpu")
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d,levels,high", [(40, 16, 6), (30, 8, 41),
                                           (2048, 16, 30), (167, 3, 6)])
def test_minmax_matrix_bit_equal_and_weighted_close(d, levels, high, jnp, jsim):
    """``high`` above ``levels``: counts are clipped before the byte cast, on
    both sides alike."""
    rng = np.random.default_rng(d + levels)
    qc, rc = count_case(d, 23, d, high), count_case(d + 1, 19, d, high)
    w = rng.uniform(0.1, 3.0, d).astype(np.float32)
    want = np.asarray(jsim.minmax_matrix(jnp.asarray(qc), jnp.asarray(rc), levels))
    got = tsim.minmax_matrix(qc, torch.from_numpy(rc), levels, device="cpu")
    assert np.array_equal(got.numpy(), want)
    want_w = np.asarray(jsim.minmax_matrix_w(jnp.asarray(qc), jnp.asarray(rc),
                                             jnp.asarray(w), levels))
    got_w = tsim.minmax_matrix_w(qc, rc, w, levels, device="cpu")
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("levels", [8, 16])
@pytest.mark.parametrize("d", [4, 168, 2048])
def test_minmax_absdiff_identity_bit_equal_to_reference(levels, d):
    """The kernel's form, Σ min = (Σa + Σb − Σ|a − b|) / 2, in torch, equals
    the level decomposition bit for bit on counts clipped at ``levels``
    (all integer sums below 2^24), with a zero row on each side."""
    q = count_case(d + levels, 29, d, levels + 9)
    r = count_case(d + 2 * levels, 41, d, levels + 9)
    q[3], r[5] = 0, 0
    qc, rc = tsim.pack_counts(q, levels), tsim.pack_counts(r, levels)
    got = tsim.minmax_gram_absdiff_reference(qc, rc)
    assert torch.equal(got, tsim.minmax_gram_reference(qc, rc, levels=levels))
    assert got[3].abs().max() == 0 and got[:, 5].abs().max() == 0


@pytest.mark.parametrize("words,weighted,split", [
    (512, False, 8), (512, True, 8), (42, False, 1), (42, True, 4), (64, False, 2),
    (1, False, 1), (1, True, 1), (8, True, 1), (16, True, 2)])
def test_minmax_split_gives_each_block_two_stages(words, weighted, split):
    """K8's cluster size along the words: 8, halved until each block of
    the cluster gets two stages of 16 elements or more."""
    assert tsim.minmax_split(words, weighted) == split
    stages = -(-(4 * words if weighted else words) // tsim.GRAM_STAGE)
    assert split == 1 or stages >= 2 * split
    assert split == 8 or stages < 4 * split


@pytest.mark.parametrize("words,split", [(1, 1), (6, 1), (7, 1), (42, 1), (64, 2),
                                         (128, 4), (255, 8), (2048, 8)])
def test_tanimoto_split_gives_each_block_two_slabs(words, split):
    """K7's cluster size along the words: 8, halved until each block of the
    cluster gets two slabs of 16 words or more."""
    assert tsim.tanimoto_split(words) == split
    slabs = -(-words // tsim.SLAB_WORDS)
    assert split == 1 or slabs >= 2 * split
    assert split == 8 or slabs < 4 * split


@pytest.mark.parametrize("nq,nr,k,plan", [
    (1, 1, 1, (1, 1)), (1, 7809, 1, (8, 1)), (106, 952, 10, (8, 1)),
    (1058, 7809, 25, (2, 1)), (1058, 255, 25, (2, 1)), (9, 7809, 33, (8, 2)),
    (60, 400, 64, (4, 2)), (9, 1024, 1024, (8, 32)), (9, 1031, 1024, (8, 32)),
    (5000, 10 ** 6, 1024, (1, 32)), (4097, 7809, 513, (1, 32))])
@pytest.mark.parametrize("words", [1, 2048])
def test_topk_plan_fits_the_kernel(nq, nr, k, plan, words):
    """K6's plan at the contract's edges (k 1 and 1,024, the widest and
    narrowest rows): the warp's list holds k in the fewest rows of 32, each
    block of the cluster gets a chunk of references, the launch stays
    within its block count, and the split is the largest that does. The
    words of a row do not enter the plan."""
    split, rows = got = tsim.topk_plan(nq, nr, k)
    assert got == plan
    chunks = -(-nr // tsim.TILE_R)
    tiles = -(-nq // tsim.TOPK_Q)
    assert rows & (rows - 1) == 0 and 32 * rows >= k and (rows == 1 or 16 * rows < k)
    assert split in (1, 2, 4, 8)
    assert split == 1 or (chunks >= split and tiles * split <= tsim.TOPK_BLOCKS)
    assert split == 8 or chunks < 2 * split or tiles * 2 * split > tsim.TOPK_BLOCKS
    assert words <= tsim.MAX_WORDS and k <= tsim.MAX_TOPK_K


def test_tanimoto_topk_orders_equal_f32_fractions_by_index(jnp, jsim):
    """At 65,536 bits distinct fractions round to one f32: the case puts
    ten of them at the k-th place, their exact order against their index
    order. The port's top-k equals JAX's (f32 similarity, then the lower
    index), which keeps other indices than an order by exact fraction."""
    q, r = tanimoto_equal_f32_case(0)
    k = EQUAL_F32_K
    inter = q.astype(np.float64) @ r.T.astype(np.float64)
    union = q.sum(1)[:, None] + r.sum(1)[None, :] - inter
    sims = (inter.astype(np.float32) / union.astype(np.float32))[0]
    kth = np.sort(sims)[::-1][k - 1]
    tied = np.flatnonzero(sims == kth)
    assert len({inter[0, j] / union[0, j] for j in tied}) == len(tied) == 10
    exact = sorted(range(r.shape[0]), key=lambda j: (-inter[0, j] / union[0, j], j))[:k]
    want_sim, want_idx = (np.asarray(a) for a in jsim.tanimoto_topk(
        jnp.asarray(q, jnp.float32), jnp.asarray(r, jnp.float32), k))
    sim, idx = tsim.tanimoto_topk(q, r, k, device="cpu")
    assert np.array_equal(idx.numpy(), want_idx)
    assert np.array_equal(sim.numpy(), want_sim)
    assert sorted(idx[0].tolist()) != sorted(exact)
    assert (sim[0] == kth).sum() == 5 and idx[0, -1] == tied[4]


def test_minmax_identical_rows_above_the_clip_are_similarity_one():
    a = torch.tensor([[40.0, 1.0]])
    assert abs(float(tsim.minmax_matrix(a, a, 8, device="cpu")[0, 0]) - 1.0) < 1e-6


def test_rbf_matrix_matches_jax(jnp, jsim):
    """atol 1e-6: both take the same f32 products; the sums may differ in
    order."""
    rng = np.random.default_rng(6)
    a = rng.normal(size=(40, 9)).astype(np.float32)
    b = rng.normal(size=(25, 9)).astype(np.float32)
    want = np.asarray(jsim.rbf_matrix(jnp.asarray(a), jnp.asarray(b),
                                      jnp.float32(0.07)))
    got = tsim.rbf_matrix(a, b, np.float32(0.07), device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# -- the estimators ----------------------------------------------------------

def _ckrr_data(seed, n, d_maccs=50, d_counts=64, d_desc=10):
    rng = np.random.default_rng(seed)
    maccs = _bits(rng, n, d_maccs)
    counts = count_case(seed, n, d_counts, 20)
    desc = rng.normal(size=(n, d_desc)).astype(np.float32)
    y = (desc[:, 0] + counts[:, :3].sum(1) * 0.1).astype(np.float32)
    return maccs, counts, desc, y


@pytest.mark.parametrize("cls", ["TanimotoKNNRegressor", "TanimotoKNNClassifier"])
def test_tknn_predictions_match_jax(cls, jsim):
    """atol 1e-6: the neighbours and similarities are equal; the weighted
    mean rounds a few f32 operations."""
    q, r = tanimoto_tie_case(11, 40, 300, 167)
    rng = np.random.default_rng(11)
    y = (rng.integers(0, 2, 300) if cls.endswith("Classifier")
         else rng.standard_normal(300)).astype(np.float32)
    want = getattr(jsim, cls)(7).fit(r, y)
    got = getattr(tsim, cls)(7, device="cpu").fit(r, y)
    np.testing.assert_allclose(got.predict(q), want.predict(q), rtol=0, atol=1e-6)
    if cls.endswith("Classifier"):
        np.testing.assert_allclose(got.predict_proba(q), want.predict_proba(q),
                                   rtol=0, atol=1e-6)
    # n_neighbors above the row count is clamped by the class
    few = getattr(tsim, cls)(50, device="cpu").fit(r[:5], y[:5]).predict(q)
    np.testing.assert_allclose(few, getattr(jsim, cls)(50).fit(r[:5], y[:5]
                                                               ).predict(q),
                               rtol=0, atol=1e-6)


def test_tanimoto_kernel_ridge_matches_jax(jsim):
    rng = np.random.default_rng(2)
    x = _bits(rng, 90, 167, 0.25)
    y = rng.standard_normal(90).astype(np.float32)
    want = jsim.TanimotoKernelRidge(0.3).fit(x[:70], y[:70])
    got = tsim.TanimotoKernelRidge(0.3, device="cpu").fit(x[:70], y[:70])
    np.testing.assert_allclose(got.predict(x[70:]), want.predict(x[70:]),
                               **RIDGE_TOL)
    assert np.array_equal(tsim.TanimotoKernelRidge.full_gram(x, device="cpu"),
                          jsim.TanimotoKernelRidge.full_gram(x))


@pytest.mark.parametrize("n,idf,weights", [
    (80, False, (0.15, 0.2, 0.45, 0.2)),       # gamma by the broadcast path
    (80, True, (0.15, 0.2, 0.45, 0.2)),
    (530, True, (0.15, 0.2, 0.45, 0.2)),       # gamma by the matmul identity
    (80, False, (0.5, 0.0, 0.5, 0.0)),         # blocks switched off
])
def test_chem_kernel_ridge_matches_jax(n, idf, weights, jsim):
    maccs, counts, desc, y = _ckrr_data(n, n)
    bw = jsim.ChemKernelRidge.idf_weights(maccs, counts) if idf else None
    if idf:
        for a, b in zip(bw, tsim.ChemKernelRidge.idf_weights(maccs, counts)):
            assert np.array_equal(a, b)
    cut = n - 20
    want = jsim.ChemKernelRidge(0.06, weights, bit_weights=bw).fit(
        maccs[:cut], counts[:cut], desc[:cut], y[:cut])
    got = tsim.ChemKernelRidge(0.06, weights, bit_weights=bw, device="cpu").fit(
        maccs[:cut], counts[:cut], desc[:cut], y[:cut])
    np.testing.assert_allclose(float(got._gamma), float(want._gamma), rtol=1e-5)
    np.testing.assert_allclose(
        got.predict(maccs[cut:], counts[cut:], desc[cut:]),
        want.predict(maccs[cut:], counts[cut:], desc[cut:]), **RIDGE_TOL)
    g_want = jsim.ChemKernelRidge(0.06, weights, bit_weights=bw).full_gram(
        maccs, counts, desc)
    g_got = tsim.ChemKernelRidge(0.06, weights, bit_weights=bw, device="cpu"
                                 ).full_gram(maccs, counts, desc)
    np.testing.assert_allclose(g_got, g_want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["tknn_regressor", "tknn_classifier", "tkrr",
                                  "ckrr"])
def test_jax_fitted_estimator_predicts_through_the_port(kind, jsim):
    """A model fitted in JAX, carried over as numpy arrays: the kNN
    predictions within 1e-6, the ridge ones within 1e-5 (the same alpha, so
    only the gram's and the product's summation order differ)."""
    maccs, counts, desc, y = _ckrr_data(21, 70)
    q = slice(50, 70)
    if kind.startswith("tknn"):
        cls = ("TanimotoKNNRegressor" if kind == "tknn_regressor"
               else "TanimotoKNNClassifier")
        target = (y > y.mean()).astype(np.float32) if "class" in kind else y
        j = getattr(jsim, cls)(5, 1.5).fit(maccs[:50], target[:50])
        state = {"x": np.asarray(j._x), "y": np.asarray(j._y),
                 "n_neighbors": j.n_neighbors, "power": j.power}
        want, tol = j.predict(maccs[q]), 1e-6
        got = tsim.estimator_from_state(kind, state, "cpu").predict(maccs[q])
    elif kind == "tkrr":
        j = jsim.TanimotoKernelRidge(0.2).fit(maccs[:50], y[:50])
        state = {"x": np.asarray(j._x), "alpha": np.asarray(j._alpha),
                 "mean": j._mean, "lam": j.lam}
        want, tol = j.predict(maccs[q]), 1e-5
        got = tsim.estimator_from_state(kind, state, "cpu").predict(maccs[q])
    else:
        bw = jsim.ChemKernelRidge.idf_weights(maccs, counts)
        j = jsim.ChemKernelRidge(0.06, bit_weights=bw).fit(
            maccs[:50], counts[:50], desc[:50], y[:50])
        state = {"train": [np.asarray(a) for a in j._train], "mu": j._mu,
                 "inv": j._inv, "gamma": np.asarray(j._gamma),
                 "alpha": np.asarray(j._alpha), "mean": j._mean, "lam": j.lam,
                 "weights": j.weights, "levels": j.levels,
                 "bit_weights": j.bit_weights}
        want, tol = j.predict(maccs[q], counts[q], desc[q]), 1e-5
        got = tsim.estimator_from_state(kind, state, "cpu").predict(
            maccs[q], counts[q], desc[q])
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("leg,atol", [("tknn", 1e-6), ("tkrr", 2e-3),
                                      ("ckrr", 2e-3), ("ckrr_idf", 2e-3),
                                      ("gram_tkrr", 0.0), ("gram_ckrr", 1e-5)])
def test_regression_legs_as_a_whole_match_jax(leg, atol, both_legs):
    """The three legs driven fold by fold as the regression stack drives
    them, through both packages' classes on the same rows."""
    want, got = both_legs
    assert got[leg].shape == want[leg].shape and np.isfinite(got[leg]).all()
    np.testing.assert_allclose(got[leg], want[leg], rtol=0, atol=atol)


@pytest.fixture(scope="module")
def both_legs(jsim):
    from bbbp_tpu_torch.testing import regression_legs

    maccs, counts, desc, y = _ckrr_data(31, 120, d_maccs=167, d_counts=256,
                                        d_desc=12)
    return (regression_legs(desc, maccs, counts, y, n_folds=4, estimators=jsim),
            regression_legs(desc, maccs, counts, y, device="cpu", n_folds=4))


# -- the wrappers ------------------------------------------------------------

def test_wrappers_on_cpu_run_plain_versions_without_launch():
    q, r = tanimoto_tie_case(5, 8, 40, 40)
    qw, rw = (tsim.packed_bits(a, "cpu") for a in (q, r))
    qc = tsim.pack_counts(q * 3)
    rc = tsim.pack_counts(r * 2)
    for fn in (tsim.tanimoto_topk_packed, tsim.tanimoto_gram, tsim.minmax_gram):
        fn.launches.reset()
    sim, idx = tsim.tanimoto_topk_packed(qw, rw, 5)
    want = tsim.tanimoto_topk_reference(qw, rw, 5)
    assert torch.equal(sim, want[0]) and torch.equal(idx, want[1])
    assert torch.equal(tsim.tanimoto_gram(qw, rw),
                       tsim.tanimoto_gram_reference(qw, rw))
    assert torch.equal(tsim.minmax_gram(qc, rc),
                       tsim.minmax_gram_reference(qc, rc))
    assert [fn.launches.count for fn in (
        tsim.tanimoto_topk_packed, tsim.tanimoto_gram, tsim.minmax_gram)] == [0, 0, 0]


@pytest.mark.parametrize("case", ["float_words", "word_mismatch", "strided",
                                  "k_zero", "k_above_nr", "bad_weights",
                                  "f64_weights"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    qw = torch.zeros((4, 6), dtype=torch.int32)
    rw = torch.zeros((9, 6), dtype=torch.int32)
    k, w = 3, None
    if case == "float_words":
        qw = qw.float()
    elif case == "word_mismatch":
        rw = torch.zeros((9, 5), dtype=torch.int32)
    elif case == "strided":
        rw = torch.zeros((9, 12), dtype=torch.int32)[:, ::2]
    elif case == "k_zero":
        k = 0
    elif case == "k_above_nr":
        k = 10
    elif case == "bad_weights":
        w = torch.zeros(167)
    elif case == "f64_weights":
        w = torch.zeros(192, dtype=torch.float64)
    with pytest.raises((TypeError, ValueError)):
        if w is None:
            tsim.tanimoto_topk_packed(qw, rw, k)
        else:
            tsim.tanimoto_gram(qw, rw, w)


@pytest.mark.parametrize("cls", ["TanimotoKNNRegressor", "TanimotoKNNClassifier",
                                 "TanimotoKernelRidge", "ChemKernelRidge"])
def test_estimators_on_cuda_raise_without_a_card(cls, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    maccs, counts, desc, y = _ckrr_data(1, 12)
    est = getattr(tsim, cls)()
    assert est.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        if cls == "ChemKernelRidge":
            est.fit(maccs, counts, desc, y)
        else:
            est.fit(maccs, y)


@pytest.mark.parametrize("fn", ["tanimoto_topk", "tanimoto_matrix",
                                "tanimoto_matrix_w", "minmax_matrix",
                                "minmax_matrix_w", "rbf_matrix"])
def test_functions_default_to_cuda_and_raise_without_a_card(fn, monkeypatch):
    """Arrays are moved to the device asked for; none runs the plain
    version on the CPU because its input happened to lie there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q, r = tanimoto_tie_case(5, 8, 40, 40)
    w = np.ones(40, np.float32)
    args = {"tanimoto_topk": (q, r, 3), "tanimoto_matrix": (q, r),
            "tanimoto_matrix_w": (q, r, w), "minmax_matrix": (q, r),
            "minmax_matrix_w": (q, r, w), "rbf_matrix": (q, r, 0.1)}[fn]
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(tsim, fn)(*args)
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(tsim, fn)(*(torch.from_numpy(a) if isinstance(a, np.ndarray)
                            else a for a in args))
    out = getattr(tsim, fn)(*args, device="cpu")
    assert (out[0] if fn == "tanimoto_topk" else out).device.type == "cpu"


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_cuda(cuda_device):
    """K6, K7 and K8 against their plain versions on the card: the top-k
    indices equal and similarities bit-equal (ties, zero rows, k = 1, k = Nr,
    Nq = 1, Nr above one candidate buffer, distinct fractions equal in f32
    at 65,536 bits, k = 1,024), the unweighted grams bit-equal (also at 36
    ragged shapes), the weighted ones within 1e-5; each call adds one
    launch. K8 also at
    ragged shapes (Nq, Nr in 1 / 33 / 127 / 1,058, 1 / 42 / 512 words,
    counts clipped at 16 and at 255) and at widths its plan gives clusters
    of 1, 2, 4 and 8 blocks, weighted twice bit-identical."""
    rng = np.random.default_rng(9)
    for nq, nr, d, k in ((60, 400, 167, 25), (1, 5000, 167, 64), (33, 40, 40, 40),
                         (17, 1, 30, 1), (50, 3000, 2048, 10)):
        q, r = tanimoto_tie_case(nq + nr, nq, nr, d)
        qw, rw = (tsim.packed_bits(a, cuda_device) for a in (q, r))
        before = tsim.tanimoto_topk_packed.launches.count
        sim, idx = tsim.tanimoto_topk_packed(qw, rw, k)
        assert tsim.tanimoto_topk_packed.launches.count == before + 1
        want_sim, want_idx = tsim.tanimoto_topk_reference(qw, rw, k)
        assert torch.equal(idx, want_idx) and torch.equal(sim, want_sim)
        w = torch.from_numpy(rng.uniform(0.1, 3.0, qw.shape[1] * 32
                                         ).astype(np.float32)).to(cuda_device)
        assert torch.equal(tsim.tanimoto_gram(qw, rw),
                           tsim.tanimoto_gram_reference(qw, rw))
        torch.testing.assert_close(tsim.tanimoto_gram(qw, rw, w),
                                   tsim.tanimoto_gram_reference(qw, rw, w),
                                   rtol=0, atol=1e-5)
        qc = tsim.pack_counts(count_case(nq, nq, d, 40), 16, cuda_device)
        rc = tsim.pack_counts(count_case(nr, nr, d, 40), 16, cuda_device)
        wc = w[:qc.shape[1] * 4].contiguous()
        assert torch.equal(tsim.minmax_gram(qc, rc),
                           tsim.minmax_gram_reference(qc, rc, levels=16))
        torch.testing.assert_close(tsim.minmax_gram(qc, rc, wc),
                                   tsim.minmax_gram_reference(qc, rc, wc, 16),
                                   rtol=0, atol=1e-5)
    # K7 without weights at ragged shapes: rows that fill no tile, slabs
    # padded with zeros (1, 6, 7 words), rows not 16-byte aligned (6, 7,
    # 42), clusters of 1, 2 and 8 blocks (tanimoto_split)
    for nq, nr in ((1, 1), (33, 127), (127, 33), (1058, 1), (1, 1058), (127, 1058)):
        for words in (1, 6, 7, 42, 64, 2048):
            q = (rng.random((nq, 32 * words)) < 0.3).astype(np.float32)
            r = (rng.random((nr, 32 * words)) < 0.3).astype(np.float32)
            q[0] = 0.0
            qw, rw = (_packed_unpadded(a, cuda_device) for a in (q, r))
            before = tsim.tanimoto_gram.launches.count
            got = tsim.tanimoto_gram(qw, rw)
            assert tsim.tanimoto_gram.launches.count == before + 1
            assert torch.equal(got, tsim.tanimoto_gram_reference(qw, rw)), (nq, nr, words)
    # K6 where distinct fractions round to one f32 at the k-th place, and at
    # k = 1, 25, 1,024 with Nr no multiple of a chunk or a split
    q, r = tanimoto_equal_f32_case(0)
    cases = [(q, r, EQUAL_F32_K)]
    for k, nr in ((1, 1031), (25, 7813), (1024, 1031), (1024, 3001)):
        q, r = tanimoto_tie_case(k + nr, 37, nr, 167)
        cases.append((q, r, k))
    for i, (q, r, k) in enumerate(cases):       # the last one with 6-word rows
        pack = _packed_unpadded if i == len(cases) - 1 else tsim.packed_bits
        qw, rw = (pack(a, cuda_device) for a in (q, r))
        sim, idx = tsim.tanimoto_topk_packed(qw, rw, k)
        want_sim, want_idx = tsim.tanimoto_topk_reference(qw, rw, k)
        assert torch.equal(idx, want_idx) and torch.equal(sim, want_sim), (k, r.shape)
    # K8 at ragged shapes: rows that fill no tile, words that fill no stage,
    # rows that are not 16-byte aligned (42 words), counts to the byte's top
    for nq, nr, words in ((1, 1, 1), (33, 127, 42), (127, 33, 512),
                          (1058, 1, 42), (1, 1058, 512), (127, 1058, 1),
                          (65, 64, 64), (100, 70, 16)):      # clusters of 2
        for levels in (16, 255):
            qc = tsim.pack_counts(count_case(nq + words, nq, 4 * words, 300),
                                  levels, cuda_device)
            rc = tsim.pack_counts(count_case(nr + words, nr, 4 * words, 300),
                                  levels, cuda_device)
            wc = torch.from_numpy(rng.uniform(0.1, 3.0, 4 * words).astype(np.float32)
                                  ).to(cuda_device)
            assert torch.equal(tsim.minmax_gram(qc, rc),
                               tsim.minmax_gram_reference(qc, rc, levels=levels))
            got_w = tsim.minmax_gram(qc, rc, wc)
            assert torch.equal(got_w, tsim.minmax_gram(qc, rc, wc))
            if levels == 16:    # the plain version's 255 weighted level sums
                torch.testing.assert_close(   # round by more than 1e-5
                    got_w, tsim.minmax_gram_reference(qc, rc, wc, levels),
                    rtol=0, atol=1e-5)
