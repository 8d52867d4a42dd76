"""Port parity: SMOTE, Tomek links, SMOTETomek (bbbp_tpu_torch.ops.resample
against bbbp_tpu.ops.resample on the CPU).

The numpy draws are the same; the distances are summed by XLA on one side
and by torch on the other, so they may differ in the last bits. On data
without near ties the neighbour lists, hence the rows, are equal. Exact
ties between duplicate rows pick a row equal to the one JAX picks, so a
duplicate-row case is held equal too. On the classification path's own
rows (MACCS → PCA of ``testing.classification_inputs``), the neighbour lists
are held equal wherever JAX's distances have no two entries within 1e-5
relative among the first kk + 1 places, and the rest are counted.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu.ops import resample as jr  # noqa: E402
from bbbp_tpu_torch.ops import resample as tr  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's torch work is many small ops: one intra-op thread each,
    as the test workers share the machine's cores (OpenMP teams that
    outnumber the cores spin against each other)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


NEAR_TIE_RTOL = 1e-5


def _data(seed, n=400, d=6, share=0.3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (rng.random(n) < share).astype(np.int32)
    x[y == 1] += 0.7                      # classes overlap: Tomek links exist
    return x, y


def _duplicated(seed):
    """Every minority row twice and a block of majority rows copied onto
    minority rows: exact ties at every neighbour place, and Tomek pairs at
    distance 0 (each row's nearest neighbour is its copy)."""
    x, y = _data(seed, n=200)
    mino = np.nonzero(y == 1)[0]
    maj = np.nonzero(y == 0)[0][:20]
    x[maj] = x[mino[:20]]
    return np.concatenate([x, x[mino]]), np.concatenate([y, y[mino]])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [5, 3])
def test_smote_equals_jax(seed, k):
    x, y = _data(seed)
    xa, ya = jr.smote(x, y, k=k, seed=seed)
    xb, yb = tr.smote(x, y, k=k, seed=seed, device="cpu")
    assert np.array_equal(ya, yb) and np.array_equal(xa, xb)
    assert (ya == 1).sum() == (ya == 0).sum()


@pytest.mark.parametrize("case", ["plain", "duplicated"])
def test_tomek_links_equal_jax(case):
    x, y = _data(4) if case == "plain" else _duplicated(4)
    want = jr.tomek_links(x, y)
    got = tr.tomek_links(x, y, device="cpu")
    assert got.dtype == bool and np.array_equal(got, want)
    assert (~want).sum() > 0                     # some links were cut


@pytest.mark.parametrize("case", ["plain", "duplicated"])
def test_smote_tomek_equals_jax(case):
    x, y = _data(5) if case == "plain" else _duplicated(5)
    xa, ya = jr.smote_tomek(x, y, seed=3)
    xb, yb = tr.smote_tomek(x, y, seed=3, device="cpu")
    assert np.array_equal(xa, xb) and np.array_equal(ya, yb)


def test_three_classes_keep_minority_pairs():
    """A link between two minority classes stays (the loop's rule)."""
    x, _ = _data(6, n=300)
    y = np.random.default_rng(6).integers(0, 3, 300).astype(np.int32)
    y[:150] = 0
    assert np.array_equal(tr.tomek_links(x, y, device="cpu"), jr.tomek_links(x, y))


def test_neighbors_on_the_classification_rows_equal_jax_but_near_ties():
    """SMOTE's neighbour lists (kk = 5) and Tomek's nearest neighbours over
    PCA(30) of the MACCS rows of 1,200 labelled molecules' minority class
    and all rows."""
    from bbbp_tpu_torch.ops.pca import PCA
    from bbbp_tpu_torch.ops.scaler import StandardScaler
    from bbbp_tpu_torch.testing import classification_inputs

    x, y = classification_inputs(1200)
    z = PCA(30).fit_transform(StandardScaler().fit_transform(
        torch.from_numpy(x))).numpy()
    for rows, kk in ((z[y == 0], 5), (z, 0)):
        d = np.array(jr._pairwise_sq_dists(rows, rows))
        np.fill_diagonal(d, np.inf)
        srt = np.sort(d, axis=1)[:, :kk + 2]
        gap = np.diff(srt, axis=1) <= NEAR_TIE_RTOL * np.maximum(srt[:, 1:], 1e-30)
        # exact ties (duplicate rows) keep their order; near ones may not
        near = (gap & (np.diff(srt, axis=1) > 0)).any(axis=1)
        if kk:
            want = np.argsort(d, axis=1)[:, :kk]
            got = tr.smote_neighbors(rows, kk, "cpu")
            same = (np.sort(d[np.arange(len(d))[:, None], got], 1)
                    == np.sort(d[np.arange(len(d))[:, None], want], 1)).all(1)
        else:
            want, got = d.argmin(axis=1), tr.tomek_nearest(rows, "cpu")
            same = d[np.arange(len(d)), got] == d[np.arange(len(d)), want]
        # a row off the near ties has the same neighbours (distance for
        # distance: exact ties between duplicates may swap equal rows)
        assert same[~near].all(), np.nonzero(~same & ~near)[0][:10]
        assert near.sum() <= 0.01 * len(rows)      # counted: 1% at most
