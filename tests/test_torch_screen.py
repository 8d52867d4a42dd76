"""Port parity of the screening slice: bbbp_tpu_torch.pipelines.screen
against bbbp_tpu.pipelines.screen on the CPU, with models carried across in
the screening pickle, plus the port's own pipeline behaviour."""

import csv
import pickle
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import bbbp_tpu.pipelines.screen as jscr  # noqa: E402
import bbbp_tpu_torch.pipelines.screen as tscr  # noqa: E402
from bbbp_tpu.data.zinc import synthetic_smiles  # noqa: E402
from bbbp_tpu_torch.chem.featurize import fingerprints as chem_fingerprints  # noqa: E402
from bbbp_tpu_torch.native.bindings import fingerprints, fingerprints_packed  # noqa: E402
from bbbp_tpu_torch.ops.bitops import packed_project_reference  # noqa: E402
from bbbp_tpu_torch.testing import full_width_screening_state, near_tie_rows  # noqa: E402

PROBA_ATOL = 1e-4 + 1e-9      # the CSV rounds to 4 decimals: one step apart


def _jax_trained(fp_kind):
    smiles = synthetic_smiles(120, seed=11)
    labels = np.random.default_rng(11).integers(0, 2, len(smiles))
    return jscr.ScreeningModel.train(smiles, labels, fp_kind=fp_kind, pca_dim=8,
                                     n_estimators=10, workers=1)


@pytest.fixture(scope="module")
def jax_morgan():
    return _jax_trained("morgan")


@pytest.fixture(scope="module")
def jax_maccs():
    return _jax_trained("maccs")


@pytest.fixture(scope="module", params=["pairs", "morgan_counts", "avalon"])
def jax_python_kind(request):
    return _jax_trained(request.param)


@pytest.fixture(scope="module")
def port_model(jax_morgan, tmp_path_factory):
    path = tmp_path_factory.mktemp("model") / "jax.pkl"
    jax_morgan.save(str(path))
    return tscr.ScreeningModel.load(str(path))


def _z(model, smiles):
    """Projected features the port computes for ``smiles`` (plain versions)."""
    if model.fp_kind in tscr.PACKED_KINDS:
        packed, _ = fingerprints_packed(smiles, model.fp_kind, model.n_bits)
        return packed_project_reference(torch.from_numpy(packed.view(np.int32)),
                                        model.proj_w, model.proj_c0).numpy()
    x = chem_fingerprints(smiles, model.fp_kind, model.n_bits, workers=1).features
    return ((x - model.scaler_mean) / model.scaler_scale - model.pca_mean
            ) @ model.pca_components.T


def _rows(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["ID", "SMILES", "Prediction", "Probability"]
    return rows[1:]


def _assert_same_screen(jax_csv, port_csv, port_model_, smiles):
    """Same ID, SMILES and invalid rows; same Prediction and Probability
    within one rounding step of the CSV, except on rows whose path meets a
    threshold within 1e-5 (at most 1% of rows)."""
    j, t = _rows(jax_csv), _rows(port_csv)
    assert [r[:2] for r in j] == [r[:2] for r in t]
    assert [r[2] == "invalid" for r in j] == [r[2] == "invalid" for r in t]
    near = near_tie_rows(port_model_.ensemble.to_state(), _z(port_model_, smiles))
    differ = [i for i, (a, b) in enumerate(zip(j, t)) if a[2] != "invalid" and
              (a[2] != b[2] or abs(float(a[3]) - float(b[3])) > PROBA_ATOL)]
    print(f"{len(differ)} of {len(j)} rows differ, all at near ties "
          f"({int(near.sum())} near-tie rows)")
    assert all(near[i] for i in differ)
    assert len(differ) <= 0.01 * len(j)


def test_pickle_carries_models_both_ways(jax_morgan, tmp_path):
    a, b = tmp_path / "jax.pkl", tmp_path / "port.pkl"
    jax_morgan.save(str(a))
    port = tscr.ScreeningModel.load(str(a))
    port.save(str(b))
    back = jscr.ScreeningModel.load(str(b))
    for m in (port, back):
        for key in ("scaler_mean", "scaler_scale", "pca_mean", "pca_components"):
            assert np.array_equal(getattr(m, key), getattr(jax_morgan, key))
        assert (m.fp_kind, m.n_bits, m.threshold) == ("morgan", 2048, 0.5)
    for key in ("feat", "thr", "leaf"):
        want = np.asarray(getattr(jax_morgan.ensemble, key))
        assert np.array_equal(getattr(port.ensemble, key).numpy(), want)
        assert np.array_equal(np.asarray(getattr(back.ensemble, key)), want)
    assert back.ensemble.depth == jax_morgan.ensemble.depth
    assert back.ensemble.tree_scale == jax_morgan.ensemble.tree_scale


@pytest.mark.parametrize("kind", ["morgan", "maccs"], ids=["packed", "dense"])
def test_screen_csv_matches_jax(kind, jax_morgan, jax_maccs, tmp_path):
    jm = jax_morgan if kind == "morgan" else jax_maccs
    jm.save(str(tmp_path / "m.pkl"))
    tm = tscr.ScreeningModel.load(str(tmp_path / "m.pkl"))
    smiles = synthetic_smiles(200, seed=2)
    smiles.insert(57, "NOT_A_SMILES((")
    mols = [(s, f"ID{i}") for i, s in enumerate(smiles)]
    jscr.screen(jm, iter(mols), out_csv=str(tmp_path / "jax.csv"), chunk_size=64)
    stats = tscr.screen(tm, iter(mols), out_csv=str(tmp_path / "port.csv"),
                        chunk_size=64, device="cpu")
    assert (stats.n_molecules, stats.n_invalid) == (201, 1)
    assert _rows(tmp_path / "port.csv")[57][2:] == ["invalid", ""]
    _assert_same_screen(tmp_path / "jax.csv", tmp_path / "port.csv", tm, smiles)


def test_full_width_model_through_both_device_fns(tmp_path):
    """The default model's widths (2048 bits, PCA 30, 300 trees of depth 6)
    at N=256: each device function of the port against the JAX package's,
    probabilities within atol 1e-5 off near-tie rows."""
    state = full_width_screening_state(0)
    with open(tmp_path / "fw.pkl", "wb") as f:
        pickle.dump(state, f)
    jm = jscr.ScreeningModel.load(str(tmp_path / "fw.pkl"))
    tm = tscr.ScreeningModel.from_state(state)
    smiles = synthetic_smiles(256, seed=3)
    packed, _ = fingerprints_packed(smiles)
    dense, _ = fingerprints(smiles, "morgan")
    pairs = {
        "packed": (jscr._make_packed_device_fn(jm)(jnp.asarray(packed)),
                   tscr._make_packed_device_fn(tm)(torch.from_numpy(packed.view(np.int32)))),
        "dense": (jscr._make_device_fn(jm)(jnp.asarray(dense)),
                  tscr._make_device_fn(tm)(torch.from_numpy(dense))),
    }
    near = near_tie_rows(state["ensemble"], _z(tm, smiles))
    assert near.mean() <= 0.01
    for name, (want, got) in pairs.items():
        differ = np.abs(np.asarray(want) - got.numpy()) > 1e-5
        print(f"{name}: {int(differ.sum())} rows differ; {int(near.sum())} near ties")
        assert not (differ & ~near).any(), name


def test_screen_csv_matches_jax_for_python_featurizer_kinds(jax_python_kind,
                                                            tmp_path):
    """pairs, morgan_counts and avalon come from the Python featurizer and
    go through the dense path, in both packages."""
    jm = jax_python_kind
    jm.save(str(tmp_path / "m.pkl"))
    tm = tscr.ScreeningModel.load(str(tmp_path / "m.pkl"))
    smiles = synthetic_smiles(200, seed=2)
    smiles.insert(31, "C1CC")
    mols = [(s, f"ID{i}") for i, s in enumerate(smiles)]
    jscr.screen(jm, iter(mols), out_csv=str(tmp_path / "jax.csv"), chunk_size=32,
                workers=1)
    stats = tscr.screen(tm, iter(mols), out_csv=str(tmp_path / "port.csv"),
                        chunk_size=32, workers=1, device="cpu")
    assert (stats.n_molecules, stats.n_invalid) == (201, 1)
    assert _rows(tmp_path / "port.csv")[31][2:] == ["invalid", ""]
    _assert_same_screen(tmp_path / "jax.csv", tmp_path / "port.csv", tm, smiles)


def test_unported_fingerprint_kind_names_the_roadmap(port_model):
    """No kind of the JAX package is left unported, so nothing names the
    roadmap any more: every one of its kinds gets a featurizer, and a kind
    it does not have is a ValueError."""
    import dataclasses

    for kind in ("morgan", "rdkit", "maccs", "pairs", "morgan_counts", "avalon"):
        tscr._featurizer(dataclasses.replace(port_model, fp_kind=kind), 1)
    other = dataclasses.replace(port_model, fp_kind="ecfp9")
    with pytest.raises(ValueError, match="ecfp9"):
        tscr.screen(other, iter([("CCO", "a")]), out_csv=None, device="cpu")


def test_main_screens_a_smi_file(port_model, tmp_path):
    smi = tmp_path / "in.smi"
    smi.write_text("smiles zinc_id\n" + "".join(
        f"{s} Z{i}\n" for i, s in enumerate(synthetic_smiles(40, seed=4))))
    port_model.save(str(tmp_path / "m.pkl"))
    out = tmp_path / "out.csv"
    tscr.main([str(smi), "--model", str(tmp_path / "m.pkl"), "--out", str(out),
               "--chunk-size", "16", "--device", "cpu"])
    rows = _rows(out)
    assert [r[0] for r in rows] == [f"Z{i}" for i in range(40)]


# -- the pipeline's own behaviour (as tests/test_round5.py checks the JAX one)

def _stream(n):
    mols = ["CCO", "CCN", "c1ccccc1", "CCS", "CC(C)O", "CCCl"]
    return iter((mols[i % len(mols)], f"M{i:04d}") for i in range(n))


class _BoomOnFetch:
    """A result whose fetch fails, as a dead device's would."""

    def __array__(self, dtype=None, copy=None):
        raise RuntimeError("CUDA error: an illegal memory access (injected)")


def _wait_for_threads(before):
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_failed_fetch_raises_with_chunk_index_and_no_threads_left(
        port_model, monkeypatch):
    calls = []

    def fake_factory(model):
        def run(arr):
            calls.append(len(calls))
            return _BoomOnFetch() if calls[-1] == 1 else np.zeros(arr.shape[0], np.float32)
        return run

    monkeypatch.setattr(tscr, "_make_packed_device_fn", fake_factory)
    before = threading.active_count()
    # one dispatcher: device calls run in sequence order, so chunk 1 fails
    with pytest.raises(tscr.ScreenBackendError) as ei:
        tscr.screen(port_model, _stream(48), out_csv=None, chunk_size=8,
                    dispatch_workers=1, device="cpu")
    assert ei.value.chunk_index == 1
    assert "illegal memory access" in str(ei.value)
    _wait_for_threads(before)


def test_every_fetch_failing_with_three_dispatchers_does_not_hang(
        port_model, monkeypatch):
    monkeypatch.setattr(tscr, "_make_packed_device_fn",
                        lambda model: (lambda arr: _BoomOnFetch()))
    before = threading.active_count()
    with pytest.raises(tscr.ScreenBackendError):
        tscr.screen(port_model, _stream(64), out_csv=None, chunk_size=8,
                    dispatch_workers=3, device="cpu")
    _wait_for_threads(before)


def test_csv_in_input_order_with_three_dispatchers(port_model, tmp_path):
    one, three = tmp_path / "d1.csv", tmp_path / "d3.csv"
    stats = tscr.screen(port_model, _stream(100), out_csv=str(three),
                        chunk_size=16, dispatch_workers=3, device="cpu")
    assert stats.n_molecules == 100
    assert [r[0] for r in _rows(three)] == [f"M{i:04d}" for i in range(100)]
    tscr.screen(port_model, _stream(100), out_csv=str(one), chunk_size=16,
                dispatch_workers=1, device="cpu")
    assert one.read_text() == three.read_text()
