"""The port's regression preprocessing (``bbbp_tpu_torch/pipelines/
preprocess.py`` and the ops it calls) against the JAX package's, on the CPU.

- ``interaction_features``: bit-equal (each product is one f32 multiply);
- ``IsolationForest``: a numpy copy, scores and labels bit-equal;
- ``standardize_per_batch`` within 1e-5, ``pca_per_batch`` within 3e-4;
- ``preprocess_regression`` over a TSV of 140 ``regression_molecules``
  (the target scaled so that some rows fall under the logBB floor of −2) at
  image size 32, with a global fit, ``compat_batch=100`` with and without
  ``compat_batch_pca``, and ``compat_per_sample``, each with ``keep_raw``:
  SMILES, target, numbers and raw blocks equal; the standardized blocks
  within 1e-5 and the PCA blocks and interactions within 3e-4, each times
  the larger of 1 and the block's largest |value| (f32 column means that
  differ by an ulp, over a near-constant pixel column's small std, move a
  standardized value by up to 3.2e-5 at this size; PCA projections reach
  ~50); the outlier labels equal (phase 11 of ``chip_smoke.py`` allows
  labels to turn on rows whose score lies near the threshold; at this size
  none does).

The featurizer runs in this process (``workers=1``) on both sides.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu.ops import interactions as jint  # noqa: E402
from bbbp_tpu.ops import outliers as jout  # noqa: E402
from bbbp_tpu.ops.pca import pca_per_batch as jax_pca_per_batch  # noqa: E402
from bbbp_tpu.ops.scaler import standardize_per_batch as jax_standardize  # noqa: E402
from bbbp_tpu.pipelines import preprocess as jpre  # noqa: E402
from bbbp_tpu_torch.ops import interactions as tint  # noqa: E402
from bbbp_tpu_torch.ops import outliers as tout  # noqa: E402
from bbbp_tpu_torch.ops.pca import pca_per_batch  # noqa: E402
from bbbp_tpu_torch.ops.scaler import standardize_per_batch  # noqa: E402
from bbbp_tpu_torch.pipelines import preprocess as tpre  # noqa: E402
from bbbp_tpu_torch.testing import (regression_molecules,  # noqa: E402
                                    regression_nn_inputs, write_regression_tsv)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


N_MOLECULES, SIDE = 140, 32
SCALED = ("fp_norm", "img_norm", "desc_norm")
PROJECTED = ("fp_pca", "img_pca", "aux_fp_pca", "interactions")
SCALED_TOL, PROJECTED_TOL = 1e-5, 3e-4
OPTIONS = {"global": {}, "compat_batch": {"compat_batch": 100},
           "compat_batch_pca": {"compat_batch": 100, "compat_batch_pca": True},
           "compat_per_sample": {"compat_per_sample": True}}


def test_interaction_features_bit_equal():
    x = np.random.default_rng(0).normal(size=(50, 12)).astype(np.float32)
    want = np.asarray(jint.interaction_features(x))
    got = tint.interaction_features(x).numpy()
    assert got.shape == (50, tint.interaction_dim(12)) == want.shape
    assert tint.interaction_dim(60) == jint.interaction_dim(60) == 1830
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3])
def test_isolation_forest_bit_equal(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(300, 6)).astype(np.float32)
    x[:5] += 6.0                                  # a few clear outliers
    j = jout.IsolationForest(seed=seed).fit(x)
    t = tout.IsolationForest(seed=seed).fit(x)
    assert t.offset_ == j.offset_
    assert np.array_equal(t.score_samples(x), j.score_samples(x))
    labels = t.fit_predict(x)
    assert np.array_equal(labels, j.fit_predict(x))
    assert (labels[:5] == -1).all() and (labels == -1).sum() == 15


def test_per_batch_scaler_and_pca():
    """250 rows in batches of 100 (the last one 50): the scaler within 1e-5;
    8 components a batch within 3e-4; a batch of fewer rows than components
    leaves its last columns 0 in both."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(250, 20)) * rng.uniform(0.5, 3, 20) + 1).astype(np.float32)
    np.testing.assert_allclose(standardize_per_batch(x, 100).numpy(),
                               jax_standardize(x, 100), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pca_per_batch(x, 8, 100).numpy(),
                               jax_pca_per_batch(x, 8, 100), rtol=0, atol=3e-4)
    short = pca_per_batch(x[:105], 8, 100).numpy()
    assert np.array_equal(short[100:, 5:], np.zeros((5, 3), np.float32))


@pytest.fixture(scope="module")
def tsv(tmp_path_factory):
    smiles, y = regression_molecules(N_MOLECULES)
    path = str(tmp_path_factory.mktemp("b3db") / "B3DB_regression.tsv")
    write_regression_tsv(path, smiles, 1.5 * y - 0.5)
    return path


@pytest.fixture(scope="module")
def port_features(tsv):
    """The port's host stage, once: what ``preprocess_regression`` runs
    before its transforms."""
    return tpre.featurize_regression(tpre.PreprocessConfig(
        image_size=SIDE, workers=1, tsv_path=tsv))


@pytest.mark.parametrize("option", list(OPTIONS))
def test_preprocess_regression_equals_jax(option, tsv, port_features):
    kw = dict(image_size=SIDE, workers=1, keep_raw=True, tsv_path=tsv,
              **OPTIONS[option])
    want = jpre.preprocess_regression(jpre.PreprocessConfig(**kw))
    pcfg = tpre.PreprocessConfig(**kw)
    if option == "global":
        got = tpre.preprocess_regression(pcfg, device="cpu")
    else:
        got = tpre.transform_regression(port_features, pcfg, "cpu")
    y_all = regression_molecules(N_MOLECULES)[1]
    assert (1.5 * y_all - 0.5 < -2).sum() > 5       # the floor drops rows
    assert 0 < len(got.y) < N_MOLECULES
    assert got.smiles == want.smiles
    assert np.array_equal(got.y, want.y) and np.array_equal(got.numbers, want.numbers)
    for name in ("fp_raw", "img_raw", "desc_raw"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert sorted(got.aux_fp_raw) == sorted(want.aux_fp_raw)
    for k, v in want.aux_fp_raw.items():
        assert np.array_equal(got.aux_fp_raw[k], v), k
    for names, tol in ((SCALED, SCALED_TOL), (PROJECTED, PROJECTED_TOL)):
        for name in names:
            a, b = getattr(got, name), getattr(want, name)
            assert a.shape == b.shape, name
            err = float(np.abs(a - b).max())
            assert err <= tol * max(1.0, float(np.abs(b).max())), (name, err)
    # phase 11 allows rows near the threshold to turn; here none does
    assert np.array_equal(got.outliers, want.outliers)
    np.testing.assert_array_equal(got.tree_features().shape, want.tree_features().shape)
    assert got.nn_fp_features().shape == (len(got.y), 167 + 31)


def test_preprocess_cache_round_trip(tsv, tmp_path):
    """A second call with the same config reads the pickle the first wrote
    (under the port's own prefix, so that it never reads the JAX package's)."""
    pcfg = tpre.PreprocessConfig(image_size=SIDE, workers=1, tsv_path=tsv,
                                 enrich=False)
    first = tpre.preprocess_regression(pcfg, cache_dir=str(tmp_path), device="cpu")
    path = tpre.cache_path(pcfg, str(tmp_path))
    assert os.path.basename(path).startswith("preproc_reg_torch_")
    assert os.path.exists(path)
    again = tpre.preprocess_regression(pcfg, cache_dir=str(tmp_path), device="cpu")
    assert again.smiles == first.smiles
    assert np.array_equal(again.fp_pca, first.fp_pca)
    assert again.desc_norm is None and again.aux_fp_pca is None


def test_preprocess_on_cuda_raises_without_cuda(monkeypatch, tsv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpre.preprocess_regression(tpre.PreprocessConfig(tsv_path=tsv))


def _nn_inputs_as_before(n, seed=1):
    """``regression_nn_inputs``' former steps: the joint scaler over [MACCS |
    flat images], the descriptors' own, nn_fp = [MACCS | descriptors]."""
    from bbbp_tpu_torch.chem.featurize import descriptors, images
    from bbbp_tpu_torch.native.bindings import fingerprints
    from bbbp_tpu_torch.ops.scaler import StandardScaler

    smiles, y = regression_molecules(n, seed)
    fp, fp_bad = fingerprints(smiles, "maccs")
    img_res = images(smiles, workers=1)
    ok = img_res.ok_mask
    ok[np.asarray(fp_bad, np.int64)] = False
    fp, img, y = fp[ok], img_res.features[ok], y[ok]
    desc = descriptors([s for s, m in zip(smiles, ok) if m], workers=1).features
    joint = StandardScaler().fit_transform(
        np.concatenate([fp, img.reshape(len(img), -1)], axis=1))
    desc_n = StandardScaler().fit_transform(desc)
    nn_fp = torch.cat([joint[:, :fp.shape[1]], desc_n], dim=1).numpy()
    return nn_fp, joint[:, fp.shape[1]:].reshape(img.shape).numpy(), y


def test_regression_nn_inputs_unchanged(monkeypatch):
    """``regression_nn_inputs`` now calls ``preprocess_regression``; its
    output (phase 9's inputs) is bit-equal to its former steps'."""
    from bbbp_tpu_torch.chem import featurize

    monkeypatch.setattr(featurize, "default_workers", lambda: 1)
    seconds = {}
    got = regression_nn_inputs(24, seconds=seconds)
    want = _nn_inputs_as_before(24)
    assert got[0].shape == (24, 198) and got[1].shape == (24, 128, 128, 3)
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    assert seconds["bad"] == 0 and seconds["preprocess"] > 0


def test_transforms_run_with_tf32_off(port_features, monkeypatch):
    """The scalers' and PCAs' products run with TF32 off whatever the
    caller set, and the caller's setting comes back afterwards."""
    seen = []

    class SpyPCA(tpre.PCA):
        def fit(self, x):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return super().fit(x)

    monkeypatch.setattr(tpre, "PCA", SpyPCA)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    tpre.transform_regression(port_features, tpre.PreprocessConfig(image_size=SIDE),
                              "cpu")
    assert len(seen) == 4 and not any(seen)       # fp, img, two aux kinds
    assert torch.backends.cuda.matmul.allow_tf32
