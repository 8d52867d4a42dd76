"""Port parity of training the screening model (slice B):
bbbp_tpu_torch.pipelines.screen.ScreeningModel.train against the JAX
package's on the CPU, the B3DB loader, and main() without --model."""

import csv

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bbbp_tpu.pipelines.screen as jscr  # noqa: E402
import bbbp_tpu_torch.pipelines.screen as tscr  # noqa: E402
from bbbp_tpu.data.b3db import load_b3db_classification as jax_load  # noqa: E402
from bbbp_tpu_torch.data import b3db  # noqa: E402
from bbbp_tpu_torch.data.zinc import synthetic_smiles  # noqa: E402
from bbbp_tpu_torch.native.bindings import fingerprints, fingerprints_packed  # noqa: E402
from bbbp_tpu_torch.ops.bitops import packed_project_reference  # noqa: E402
from bbbp_tpu_torch.testing import labelled_training_set, near_tie_rows  # noqa: E402

N_TRAIN = 400
SMALL = dict(pca_dim=8, n_estimators=10, workers=1)


@pytest.fixture(scope="module")
def labelled():
    """Molecules labelled 1 where their Morgan bit count is above its lower
    third: a label PCA 8 can see, so that two fits agree beyond chance
    (``labelled_training_set``'s random linear labels are mostly lost in 8
    components, and two JAX fits with different seeds agree on only ~85%
    of held-out molecules there)."""
    smiles = synthetic_smiles(N_TRAIN + 200, seed=21)
    x, bad = fingerprints(smiles, "morgan", 2048)
    assert not bad
    count = x.sum(axis=1)
    return smiles, (count > np.quantile(count, 1 / 3)).astype(np.int32)


@pytest.fixture(scope="module")
def port_trained(labelled):
    smiles, labels = labelled
    return tscr.ScreeningModel.train(smiles[:N_TRAIN], labels[:N_TRAIN],
                                     device="cpu", **SMALL)


@pytest.fixture(scope="module")
def jax_trained(labelled):
    smiles, labels = labelled
    return jscr.ScreeningModel.train(smiles[:N_TRAIN], labels[:N_TRAIN], **SMALL)


def _rows(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["ID", "SMILES", "Prediction", "Probability"]
    return rows[1:]


def test_labelled_set_is_seeded_and_two_thirds_positive():
    smiles, labels = labelled_training_set(900, seed=3)
    again = labelled_training_set(900, seed=3)
    assert smiles == again[0] and np.array_equal(labels, again[1])
    assert labels.dtype == np.int32 and abs(labels.mean() - 2 / 3) < 0.02


def test_trained_model_has_the_default_shape_and_loads_in_jax(port_trained,
                                                               tmp_path):
    m = port_trained
    assert m.pca_components.shape == (8, 2048) and m.fp_kind == "morgan"
    ens = m.ensemble
    assert (ens.depth, ens.feat.shape[0], ens.tree_scale) == (6, 10, 0.1)
    m.save(str(tmp_path / "port.pkl"))
    back = jscr.ScreeningModel.load(str(tmp_path / "port.pkl"))
    for key in ("scaler_mean", "scaler_scale", "pca_mean", "pca_components"):
        assert np.array_equal(getattr(back, key), getattr(m, key))
    for key in ("feat", "thr", "leaf"):
        assert np.array_equal(np.asarray(getattr(back.ensemble, key)),
                              getattr(ens, key).numpy())
    assert back.ensemble.base_score == ens.base_score


def test_both_packages_screen_the_port_trained_model_alike(port_trained,
                                                          tmp_path):
    """Same Prediction, Probability within one CSV rounding step, except on
    rows whose path meets a threshold within 1e-5 (at most 1%)."""
    port_trained.save(str(tmp_path / "m.pkl"))
    jm = jscr.ScreeningModel.load(str(tmp_path / "m.pkl"))
    smiles = synthetic_smiles(300, seed=8)
    smiles.insert(31, "NOT_A_SMILES((")
    mols = [(s, f"ID{i}") for i, s in enumerate(smiles)]
    jscr.screen(jm, iter(mols), out_csv=str(tmp_path / "jax.csv"), chunk_size=64)
    tscr.screen(port_trained, iter(mols), out_csv=str(tmp_path / "port.csv"),
                chunk_size=64, device="cpu")
    j, t = _rows(tmp_path / "jax.csv"), _rows(tmp_path / "port.csv")
    assert [r[:2] for r in j] == [r[:2] for r in t]
    assert j[31][2] == t[31][2] == "invalid"
    packed, _ = fingerprints_packed(smiles)
    z = packed_project_reference(torch.from_numpy(packed.view(np.int32)),
                                 port_trained.proj_w, port_trained.proj_c0)
    near = near_tie_rows(port_trained.ensemble.to_state(), z.numpy())
    differ = [i for i, (a, b) in enumerate(zip(j, t)) if a[2] != "invalid" and
              (a[2] != b[2] or abs(float(a[3]) - float(b[3])) > 1e-4 + 1e-9)]
    assert all(near[i] for i in differ)
    assert len(differ) <= 0.01 * len(j)


def test_port_and_jax_trained_models_agree_on_held_out(port_trained,
                                                       jax_trained, labelled,
                                                       tmp_path):
    """The two fits draw their subsamples from different RNG streams, so
    they agree statistically: the same Prediction on at least 90% of 200
    held-out molecules, and similar held-out accuracy."""
    smiles, labels = labelled
    held = [(s, f"H{i}") for i, s in enumerate(smiles[N_TRAIN:])]
    jscr.screen(jax_trained, iter(held), out_csv=str(tmp_path / "j.csv"),
                chunk_size=64)
    tscr.screen(port_trained, iter(held), out_csv=str(tmp_path / "t.csv"),
                chunk_size=64, device="cpu")
    pj = np.array([int(r[2]) for r in _rows(tmp_path / "j.csv")])
    pt = np.array([int(r[2]) for r in _rows(tmp_path / "t.csv")])
    y = labels[N_TRAIN:]
    print(f"agree {np.mean(pj == pt):.3f}; accuracy port {np.mean(pt == y):.3f}, "
          f"jax {np.mean(pj == y):.3f}")
    assert np.mean(pj == pt) >= 0.9
    assert abs(np.mean(pt == y) - np.mean(pj == y)) <= 0.05


def _write_b3db(directory, rows):
    path = directory / b3db.CLASSIFICATION_TSV
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(["NO.", "compound_name", "SMILES", "BBB+/BBB-", "group"])
        w.writerows(rows)
    return path


def _b3db_rows(n, seed):
    smiles, labels = labelled_training_set(n, seed=seed)
    rows = [[i + 1, f"c{i}", s, " BBB+" if y else "BBB-", "A"]
            for i, (s, y) in enumerate(zip(smiles, labels))]
    rows[3][2] = "NA"                       # pandas reads both as missing
    rows[5][3] = ""
    return rows


def test_b3db_loader_equals_jax_loader(tmp_path, monkeypatch):
    path = _write_b3db(tmp_path, _b3db_rows(40, seed=4))
    monkeypatch.setenv(b3db.ENV_DIR, str(tmp_path))
    ours, ref = b3db.load_b3db_classification(), jax_load(str(path))
    assert len(ours) == len(ref) == 38
    assert ours.smiles == ref.smiles
    assert np.array_equal(ours.labels, ref.labels) and ours.labels.dtype == np.int32
    assert np.array_equal(ours.numbers, ref.numbers)


def test_b3db_loader_needs_its_directory(monkeypatch, tmp_path):
    monkeypatch.delenv(b3db.ENV_DIR, raising=False)
    with pytest.raises(FileNotFoundError, match=b3db.ENV_DIR):
        b3db.load_b3db_classification()
    bad = tmp_path / b3db.CLASSIFICATION_TSV
    bad.write_text("NO.\tSMILES\n1\tCCO\n")
    with pytest.raises(ValueError, match="missing columns"):
        b3db.load_b3db_classification(str(bad))


def test_main_without_model_trains_the_default_model(tmp_path, monkeypatch,
                                                     capsys):
    _write_b3db(tmp_path, _b3db_rows(120, seed=5))
    monkeypatch.setenv(b3db.ENV_DIR, str(tmp_path))
    smi = tmp_path / "in.smi"
    smi.write_text("".join(f"{s} Z{i}\n" for i, s in
                           enumerate(synthetic_smiles(30, seed=6))))
    out = tmp_path / "out.csv"
    tscr.main([str(smi), "--out", str(out), "--chunk-size", "16",
               "--device", "cpu", "--workers", "1"])
    assert "training the default B3DB screening model on cpu" in capsys.readouterr().out
    rows = _rows(out)
    assert [r[0] for r in rows] == [f"Z{i}" for i in range(30)]
    assert all(0.0 <= float(r[3]) <= 1.0 for r in rows)


def test_train_on_cuda_without_a_card_raises(labelled, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    smiles, labels = labelled
    with pytest.raises(RuntimeError, match="CUDA"):
        tscr.ScreeningModel.train(smiles[:50], labels[:50], **SMALL)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tscr.ScreeningModel.train(smiles[:50], labels[:50], device="meta", **SMALL)
