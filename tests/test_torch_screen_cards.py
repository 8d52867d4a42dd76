"""Screening over several devices: ``bbbp_tpu_torch.pipelines.screen.screen(
devices=[...])``, the port's counterpart of the JAX package's
``screen(mesh=...)``. On the CPU the shards run the kernels' plain versions
(a device listed k times is k shards); the JAX package is imported in
fixtures, so the ``cuda`` test also runs where JAX is absent."""

import csv
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bbbp_tpu_torch.pipelines.screen as tscr  # noqa: E402
from bbbp_tpu_torch.data.zinc import synthetic_smiles  # noqa: E402
from bbbp_tpu_torch.native.bindings import fingerprints_packed  # noqa: E402
from bbbp_tpu_torch.ops.bitops import packed_project, packed_project_reference  # noqa: E402
from bbbp_tpu_torch.ops.forest import raw_predict  # noqa: E402
from bbbp_tpu_torch.testing import full_width_screening_state, near_tie_rows  # noqa: E402

CHUNK = 64
PROBA_ATOL = 1e-4 + 1e-9      # the CSV rounds to 4 decimals: one step apart


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: one intra-op thread, as the test workers share the
    machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _train_smiles():
    smiles = synthetic_smiles(120, seed=11)
    return smiles, np.random.default_rng(11).integers(0, 2, len(smiles))


@pytest.fixture(scope="module")
def port_models():
    """Toy models of both kinds (PCA 8, 20 trees), trained by the port on
    the CPU."""
    smiles, labels = _train_smiles()
    return {kind: tscr.ScreeningModel.train(smiles, labels, fp_kind=kind,
                                            pca_dim=8, n_estimators=20,
                                            workers=1, device="cpu")
            for kind in ("morgan", "maccs")}


@pytest.fixture(scope="module")
def jax_model_pickle(tmp_path_factory):
    """A toy morgan model trained by the JAX package, in the pickle both
    packages read."""
    jscr = pytest.importorskip("bbbp_tpu.pipelines.screen")
    smiles, labels = _train_smiles()
    model = jscr.ScreeningModel.train(smiles, labels, pca_dim=8,
                                      n_estimators=20, workers=1)
    path = tmp_path_factory.mktemp("model") / "jax.pkl"
    model.save(str(path))
    return path


def _mols():
    """201 molecules, an invalid SMILES at 57: three chunks of 64 and a
    ragged last chunk of 9."""
    smiles = synthetic_smiles(200, seed=2)
    smiles.insert(57, "NOT_A_SMILES((")
    return [(s, f"ID{i}") for i, s in enumerate(smiles)]


def _rows(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["ID", "SMILES", "Prediction", "Probability"]
    return rows[1:]


@pytest.mark.parametrize("kind", ["morgan", "maccs"], ids=["packed", "dense"])
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_sharded_csv_equals_one_device(k, kind, port_models, tmp_path):
    model = port_models[kind]
    one, sharded = tmp_path / "one.csv", tmp_path / "sharded.csv"
    tscr.screen(model, iter(_mols()), out_csv=str(one), chunk_size=CHUNK,
                workers=1, device="cpu")
    stats = tscr.screen(model, iter(_mols()), out_csv=str(sharded),
                        chunk_size=CHUNK, workers=1, devices=["cpu"] * k)
    assert (stats.n_molecules, stats.n_invalid) == (201, 1)
    assert _rows(sharded)[57][2:] == ["invalid", ""]
    assert sharded.read_text() == one.read_text()


def test_port_over_8_shards_matches_jax_mesh(jax_model_pickle, tmp_path):
    """The JAX package over its 8-device CPU mesh against the port over 8
    CPU shards, one pickled model and one stream: same ID, SMILES and
    invalid rows; Prediction and Probability within one rounding step of
    the CSV but on rows whose path meets a threshold within 1e-5 (at most
    1% of rows)."""
    jax = pytest.importorskip("jax")
    from jax.sharding import Mesh

    jscr = pytest.importorskip("bbbp_tpu.pipelines.screen")
    jm = jscr.ScreeningModel.load(str(jax_model_pickle))
    tm = tscr.ScreeningModel.load(str(jax_model_pickle))
    mols = _mols()
    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("data",))
    jax_csv, port_csv = tmp_path / "jax.csv", tmp_path / "port.csv"
    jscr.screen(jm, iter(mols), out_csv=str(jax_csv), chunk_size=CHUNK,
                workers=1, mesh=mesh)
    tscr.screen(tm, iter(mols), out_csv=str(port_csv), chunk_size=CHUNK,
                workers=1, devices=["cpu"] * 8)
    j, t = _rows(jax_csv), _rows(port_csv)
    assert [r[:2] for r in j] == [r[:2] for r in t]
    assert [r[2] == "invalid" for r in j] == [r[2] == "invalid" for r in t]
    packed, _ = fingerprints_packed([s for s, _ in mols])
    z = packed_project_reference(torch.from_numpy(packed.view(np.int32)),
                                 tm.proj_w, tm.proj_c0).numpy()
    near = near_tie_rows(tm.ensemble.to_state(), z)
    differ = [i for i, (a, b) in enumerate(zip(j, t)) if a[2] != "invalid" and
              (a[2] != b[2] or abs(float(a[3]) - float(b[3])) > PROBA_ATOL)]
    assert all(near[i] for i in differ)
    assert len(differ) <= 0.01 * len(j)


def test_chunk_size_that_does_not_divide_raises_the_reference_error(
        jax_model_pickle):
    jax = pytest.importorskip("jax")
    from jax.sharding import Mesh

    jscr = pytest.importorskip("bbbp_tpu.pipelines.screen")
    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("data",))
    with pytest.raises(ValueError) as want:
        jscr.screen(jscr.ScreeningModel.load(str(jax_model_pickle)),
                    iter(_mols()), out_csv=None, chunk_size=60, mesh=mesh)
    with pytest.raises(ValueError) as got:
        tscr.screen(tscr.ScreeningModel.load(str(jax_model_pickle)),
                    iter(_mols()), out_csv=None, chunk_size=60,
                    devices=["cpu"] * 8)
    assert str(got.value) == str(want.value) == \
        "chunk_size must divide the mesh 'data' axis"


@pytest.mark.parametrize("devices, error, match", [
    (["cpu", "cuda"], ValueError, "mixes cpu and cuda"),
    (["cuda:0", "cpu"], ValueError, "mixes cpu and cuda"),
    (["meta"], ValueError, "cpu or cuda, not meta"),
    (["cpu", "meta"], ValueError, "cpu or cuda, not meta"),
    ([], ValueError, "at least one device"),
], ids=["cpu-cuda", "cuda-cpu", "meta", "cpu-meta", "empty"])
def test_unusable_devices_raise(devices, error, match, port_models):
    with pytest.raises(error, match=match):
        tscr.screen(port_models["morgan"], iter(_mols()), out_csv=None,
                    chunk_size=CHUNK, devices=devices)


def test_cuda_card_torch_does_not_see_raises(port_models):
    """``cuda:k`` that torch does not see raises; nothing falls back."""
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        with pytest.raises(ValueError, match=f"torch sees {n}"):
            tscr.screen(port_models["morgan"], iter(_mols()), out_csv=None,
                        chunk_size=CHUNK, devices=["cuda:0", f"cuda:{n}"])
        return
    for devices in (["cuda:0"], ["cuda"] * 2, None):
        with pytest.raises(RuntimeError, match="torch sees none"):
            tscr.screen(port_models["morgan"], iter(_mols()), out_csv=None,
                        chunk_size=CHUNK, devices=devices, device="cuda")


# -- the pipeline with a fake device function ---------------------------------

class _BoomOnFetch:
    """A result whose fetch fails, as a dead device's would."""

    def __array__(self, dtype=None, copy=None):
        raise RuntimeError("CUDA error: an illegal memory access (injected)")


def _stream(n):
    mols = ["CCO", "CCN", "c1ccccc1", "CCS", "CC(C)O", "CCCl"]
    return iter((mols[i % len(mols)], f"M{i:04d}") for i in range(n))


def _wait_for_threads(before):
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


@pytest.mark.parametrize("fails", ["raise", "fetch"])
def test_failing_shard_raises_with_chunk_index_and_no_threads_left(
        fails, port_models, monkeypatch):
    """Shard 2 of 4 in chunk 1 fails, in the device function itself or when
    its result is fetched."""
    calls = []

    def fake_factory(model):
        def run(arr):
            calls.append(len(calls))
            if calls[-1] == 4 + 2:               # one dispatcher: in order
                if fails == "raise":
                    raise RuntimeError("CUDA error: launch failed (injected)")
                return _BoomOnFetch()
            return np.zeros(arr.shape[0], np.float32)
        return run

    monkeypatch.setattr(tscr, "_make_packed_device_fn", fake_factory)
    before = threading.active_count()
    with pytest.raises(tscr.ScreenBackendError) as ei:
        tscr.screen(port_models["morgan"], _stream(48), out_csv=None,
                    chunk_size=8, dispatch_workers=1, devices=["cpu"] * 4)
    assert ei.value.chunk_index == 1
    assert "(injected)" in str(ei.value)
    _wait_for_threads(before)


@pytest.mark.parametrize("fails", ["raise", "fetch"])
def test_every_shard_failing_with_three_dispatchers_does_not_hang(
        fails, port_models, monkeypatch):
    def run(arr):
        if fails == "raise":
            raise RuntimeError("injected")
        return _BoomOnFetch()

    monkeypatch.setattr(tscr, "_make_packed_device_fn", lambda model: run)
    before = threading.active_count()
    with pytest.raises(tscr.ScreenBackendError):
        tscr.screen(port_models["morgan"], _stream(64), out_csv=None,
                    chunk_size=8, dispatch_workers=3, devices=["cpu"] * 2)
    _wait_for_threads(before)


@pytest.mark.parametrize("k", [2, 4])
def test_every_shard_reaches_its_device_function(k, port_models, monkeypatch):
    """Each chunk is cut into k shards of chunk_size / k rows, in order,
    each given to the device function built for its device's replica; the
    shards laid end to end are the padded chunk the unsharded run sees."""
    seen = []

    def fake_factory(model):
        def run(arr):
            assert arr.device == model.device
            seen.append(arr.clone())
            return np.zeros(arr.shape[0], np.float32)
        return run

    monkeypatch.setattr(tscr, "_make_packed_device_fn", fake_factory)
    model = port_models["morgan"]
    tscr.screen(model, _stream(40), out_csv=None, chunk_size=16,
                dispatch_workers=1, device="cpu")
    whole, seen[:] = list(seen), []
    tscr.screen(model, _stream(40), out_csv=None, chunk_size=16,
                dispatch_workers=1, devices=["cpu"] * k)
    assert [len(a) for a in whole] == [16] * 3          # 16, 16 and 8 padded
    assert [len(a) for a in seen] == [16 // k] * (3 * k)
    for c, chunk in enumerate(whole):
        assert torch.equal(torch.cat(seen[c * k:(c + 1) * k]), chunk)


def test_launch_counter_counts_by_card():
    from bbbp_tpu_torch._build import LaunchCounter

    counter = LaunchCounter()
    for card, launches in ((0, 1), (1, 5), (0, 2), (3, 1), (1, -5)):
        counter.add(torch.device("cuda", card), launches)
    assert (counter.count, counter.by_device) == (4, {0: 3, 1: 0, 3: 1})
    counter.reset()
    assert (counter.count, counter.by_device) == (0, {})


@pytest.mark.cuda
def test_two_shards_on_one_card_equal_one_card(tmp_path):
    """The default model's widths over ["cuda:0", "cuda:0"] (and over every
    card where torch sees more than one): the CSV byte-equal to one card's,
    each kernel launched once a shard of every chunk, counted by card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    model = tscr.ScreeningModel.from_state(full_width_screening_state(0))
    smiles = synthetic_smiles(5000, seed=5)
    smiles.insert(4321, "NOT_A_SMILES((")
    mols = [(s, f"M{i}") for i, s in enumerate(smiles)]
    one = tmp_path / "one.csv"
    tscr.screen(model, iter(mols), out_csv=str(one), chunk_size=2048,
                device="cuda:0")
    n = torch.cuda.device_count()
    for devices in (["cuda:0", "cuda:0"],) + ((
            [f"cuda:{i}" for i in range(n)],) if n > 1 else ()):
        for counter in (packed_project, raw_predict):
            counter.launches.reset()
        chunk = 1024 * len(devices)
        chunks = -(-len(mols) // chunk)
        out = tmp_path / f"{len(devices)}.csv"
        tscr.screen(model, iter(mols), out_csv=str(out), chunk_size=chunk,
                    devices=devices)
        assert out.read_text() == one.read_text(), devices
        want = {}
        for d in devices:
            i = torch.device(d).index
            want[i] = want.get(i, 0) + chunks
        for counter in (packed_project, raw_predict):
            assert counter.launches.count == len(devices) * chunks
            assert counter.launches.by_device == want
