"""Port parity: StandardScaler and PCA fit/transform (bbbp_tpu_torch.ops
against bbbp_tpu.ops on the CPU, both in f32)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu.ops.pca import PCA as JaxPCA  # noqa: E402
from bbbp_tpu.ops.scaler import StandardScaler as JaxScaler  # noqa: E402
from bbbp_tpu_torch.ops.pca import PCA  # noqa: E402
from bbbp_tpu_torch.ops.scaler import StandardScaler  # noqa: E402


def test_scaler_matches_jax():
    """atol 1e-5: f32 means and population stds summed in different orders.
    The all-zero column (a fingerprint bit no molecule sets) takes scale 1."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((120, 10)) * 3 + 1).astype(np.float32)
    x[:, 4] = 0.0
    js, ts = JaxScaler().fit(x), StandardScaler().fit(x)
    np.testing.assert_allclose(ts.mean_.numpy(), np.asarray(js.mean_), atol=1e-5)
    np.testing.assert_allclose(ts.scale_.numpy(), np.asarray(js.scale_), atol=1e-5)
    assert ts.scale_[4].item() == 1.0
    np.testing.assert_allclose(ts.transform(x).numpy(), np.asarray(js.transform(x)),
                               atol=1e-5)
    np.testing.assert_allclose(ts.inverse_transform(ts.transform(x)).numpy(), x,
                               atol=1e-5)


def _separated(rng, n, d, scales):
    """Data whose top principal axes have well-separated variances."""
    q, _ = np.linalg.qr(rng.standard_normal((d, len(scales))))
    z = rng.standard_normal((n, len(scales))) * np.asarray(scales)
    return (z @ q.T + 0.01 * rng.standard_normal((n, d)) + 2.0).astype(np.float32)


@pytest.mark.parametrize("n,d", [(400, 16), (30, 64)], ids=["primal", "dual"])
def test_pca_matches_jax(n, d):
    """Components after the shared sign convention, within atol 1e-4 (f32
    eigensolvers from two libraries); variances and projections too."""
    x = _separated(np.random.default_rng(n), n, d, [16.0, 8.0, 4.0, 2.0])
    jp, tp = JaxPCA(4).fit(x), PCA(4).fit(x)
    np.testing.assert_allclose(tp.components_.numpy(), np.asarray(jp.components_),
                               atol=1e-4)
    np.testing.assert_allclose(tp.explained_variance_.numpy(),
                               np.asarray(jp.explained_variance_), rtol=1e-4)
    np.testing.assert_allclose(tp.explained_variance_ratio_.numpy(),
                               np.asarray(jp.explained_variance_ratio_), atol=1e-5)
    np.testing.assert_allclose(tp.transform(x).numpy(), np.asarray(jp.transform(x)),
                               atol=1e-3)
    comp = tp.components_.numpy()
    assert (comp[np.arange(4), np.abs(comp).argmax(axis=1)] > 0).all()


def test_pca_variance_fraction_picks_same_k():
    x = _separated(np.random.default_rng(5), 300, 12, [10.0, 5.0, 2.0, 1.0])
    jp, tp = JaxPCA(0.9).fit(x), PCA(0.9).fit(x)
    assert tp.components_.shape == np.asarray(jp.components_).shape
