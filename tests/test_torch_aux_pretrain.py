"""Aux pretraining in the port (``bbbp_tpu_torch/train/aux_pretrain.py``)
against the JAX package's (``bbbp_tpu/train/aux_pretrain.py``), and the
three options of ``run_regression`` that it and MLM pretraining enable
(``bert_leg``, ``nn_pretrained``, ``graph_pretrained``).

- The cache key names the device, under a prefix of the port's own: a cpu
  call never reads a trunk trained on the card.
- ``drop_output_dense`` equal to the JAX package's.
- ``_fit_binary`` of a toy MPNN (hidden 16, 2 layers, 24 atoms) on 600
  labelled molecules: the mean holdout AUC over three seeds within 0.05 of
  the JAX package's;
  the port's pickle has the paths and shapes of the flax init, so the JAX
  package's ``load_warm_start`` and ``train_cv(warm_start=...)`` take every
  leaf; the JAX package's pickle warm-starts every port parameter but the
  output layer.
- ``run_regression`` at toy size with all three options: each deep leg gets
  its warm start, and the SMILES leg's column is written.
"""

import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu_torch.chem.graph_features import graph_features  # noqa: E402
from bbbp_tpu_torch.models.convert import (flatten_tree, flax_from_params,  # noqa: E402
                                           matching_params)
from bbbp_tpu_torch.models.gnn import MPNNRegressor  # noqa: E402
from bbbp_tpu_torch.testing import labelled_training_set  # noqa: E402
from bbbp_tpu_torch.train import aux_pretrain as A  # noqa: E402


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")

    from bbbp_tpu.models.gnn import MPNNRegressor as FlaxMPNN
    from bbbp_tpu.train import aux_pretrain as jaux

    return SimpleNamespace(jax=jax, aux=jaux, MPNN=FlaxMPNN)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_cache_key_names_the_device(tmp_path, monkeypatch, J):
    cfg = A.AuxPretrainConfig(cache_dir=str(tmp_path))
    cpu, cuda = A._cache_path(cfg, "cpu"), A._cache_path(cfg, "cuda")
    assert cpu != cuda
    assert os.path.basename(cpu).startswith("aux_pretrained_torch_graph_")
    assert os.path.basename(cuda).startswith("aux_pretrained_torch_graph_")
    assert J.aux._cache_path(J.aux.AuxPretrainConfig(cache_dir=str(tmp_path))) \
        not in (cpu, cuda)
    # a trunk trained on the card is not what a cpu call reads: with only
    # the cuda file there, the cpu call trains (and needs B3DB to)
    with open(cuda, "wb") as f:
        pickle.dump({"params": {}, "auc": 0.9, "config": {}}, f)
    monkeypatch.delenv("BBBP_B3DB_DIR", raising=False)
    with pytest.raises(FileNotFoundError, match="BBBP_B3DB_DIR"):
        A.pretrain_aux(cfg, verbose=False, device="cpu")
    with open(cpu, "wb") as f:
        pickle.dump({"params": {}, "auc": 0.9, "config": {}}, f)
    assert A.pretrain_aux(cfg, verbose=False, device="cpu") == cpu


def test_drop_output_dense_equals_jax(J):
    tree = {f"Dense_{i}": {"kernel": np.zeros((2, 2))} for i in (0, 3, 11, 7)}
    tree.update(LayerNorm_0={"scale": np.ones(2)}, messages={"x": np.ones(1)})
    ours, theirs = A.drop_output_dense(tree), J.aux.drop_output_dense(tree)
    assert set(ours) == set(theirs) == set(tree) - {"Dense_11"}
    assert A.drop_output_dense({"a": 1}) == J.aux.drop_output_dense({"a": 1})


ATOMS = 24
MPNN = dict(hidden=16, n_layers=2)
FIT = dict(epochs=10, batch_size=32, lr=3e-3, val_frac=0.25, seed=17)


@pytest.fixture(scope="module")
def graphs():
    smiles, y = labelled_training_set(600, seed=4)
    feats, _, adj_t, mask, bad = graph_features(smiles, max_atoms=ATOMS,
                                                edge_types=True)
    ok = np.ones(len(smiles), bool)
    ok[list(bad)] = False
    return (feats[ok], adj_t[ok], mask[ok]), y[ok].astype(np.float32)


SEEDS = (17, 3, 5)


@pytest.fixture(scope="module")
def fits(graphs, J):
    """Seed by seed, (port params, port AUC), (JAX params, JAX AUC) of one
    toy fit each (the seed draws the holdout too, the same in both)."""
    inputs, y = graphs
    out = []
    for seed in SEEDS:
        fit = dict(FIT, seed=seed)
        ours = A._fit_binary(MPNNRegressor(inputs[0].shape[-1], **MPNN), inputs, y,
                             A.AuxPretrainConfig(**fit), False, "cpu")
        params, auc = J.aux._fit_binary(J.MPNN(**MPNN), inputs, y,
                                        J.aux.AuxPretrainConfig(**fit), False)
        out.append((ours, (J.jax.tree.map(np.asarray, params), auc)))
    return out


def test_fit_binary_auc_as_jax(fits):
    """The mean holdout AUC over seeds 17, 3 and 5 within 0.05 of the JAX
    package's (seed by seed the port's read 0.755 / 0.856 / 0.805 and the
    JAX package's 0.728 / 0.802 / 0.792)."""
    ours = np.mean([f[0][1] for f in fits])
    want = np.mean([f[1][1] for f in fits])
    assert want > 0.6
    assert abs(ours - want) <= 0.05, (ours, want)


def test_port_pickle_warm_starts_the_jax_package(fits, graphs, tmp_path, J):
    """The port's pickle: the flax init's paths and shapes, every leaf;
    the JAX package's load_warm_start drops the same output layer."""
    (params, auc), (jax_params, _) = fits[0]
    path = str(tmp_path / "port.pkl")
    with open(path, "wb") as f:
        pickle.dump({"params": params, "auc": auc, "config": {}}, f)
    theirs, their_auc = J.aux.load_warm_start(path)
    ours, our_auc = A.load_warm_start(path)
    assert their_auc == our_auc == auc
    shapes = {k: v.shape for k, v in flatten_tree(jax_params).items()}
    assert {k: v.shape for k, v in flatten_tree(params).items()} == shapes
    assert set(flatten_tree(theirs)) == set(flatten_tree(ours))
    out = f"Dense_{1 + 2 * (4 + 1) + 2}"             # MPNN(n_layers=2)'s last
    assert out in params and out not in theirs


def test_jax_pickle_warm_starts_the_port(fits, graphs, tmp_path):
    """Every port parameter but the output layer's takes the JAX package's
    pretrained value, in every fold."""
    _, (jax_params, auc) = fits[0]
    path = str(tmp_path / "jax.pkl")
    with open(path, "wb") as f:
        pickle.dump({"params": jax_params, "auc": auc, "config": {}}, f)
    warm, _ = A.load_warm_start(path)
    model = MPNNRegressor(graphs[0][0].shape[-1], folds=2, **MPNN)
    taken = matching_params(model, warm)
    names = {n for n, _ in model.named_parameters()}
    assert set(taken) == names - {"Dense_13.kernel", "Dense_13.bias"}
    got = flatten_tree(flax_from_params(model, 1, {
        **{n: p.detach() for n, p in model.named_parameters()}, **taken}))
    for k, v in flatten_tree(warm).items():
        assert np.array_equal(got[k], v), k


def test_run_regression_with_every_option(tmp_path, monkeypatch):
    """``run_regression`` on cpu over the tiny ProcessedData of
    ``tests/test_torch_regression.py`` with ``bert_leg`` (an MLM-pretrained
    directory of the port), ``nn_pretrained`` and ``graph_pretrained``
    (pickles of the run's own NN and MPNN widths): each deep leg's train_cv
    gets its warm start, the SMILES leg's columns are written."""
    from bbbp_tpu_torch.data.zinc import synthetic_smiles
    from bbbp_tpu_torch.models.transformer_cnn import MultiModalRegressor
    from bbbp_tpu_torch.train import bert_pretrain as P
    from bbbp_tpu_torch.train import regression as R
    from tests.test_torch_regression import SMALL, _tiny_processed

    data = _tiny_processed()
    data.smiles = synthetic_smiles(len(data.y), seed=8)
    pre = P.pretrain(P.MLMPretrainConfig(
        corpus_size=200, include_b3db=False, epochs=1, batch_size=50, n_layers=1,
        d_model=16, n_heads=2, max_len=40, out_dir=str(tmp_path / "bert")),
        corpus=synthetic_smiles(200, seed=9) + data.smiles, verbose=False,
        device="cpu")
    cfg_kw = dict(SMALL, graph_leg=True, graph_epochs=2, graph_hidden=8,
                  graph_layers=1, max_atoms=48, bert_leg=True, bert_epochs=2,
                  bert_seeds=2, out_dir=str(tmp_path / "out"))
    trunks = {}
    for kind, model in (("nn", MultiModalRegressor(fp_dim=24, n_layers=4,
                                                      image_size=8)),
                        ("graph", MPNNRegressor(graph_features(["C"], 48, True)[0]
                                                .shape[-1], hidden=8, n_layers=1))):
        trunks[kind] = str(tmp_path / f"{kind}.pkl")
        with open(trunks[kind], "wb") as f:
            pickle.dump({"params": flax_from_params(model), "auc": 0.75,
                         "config": {}}, f)
    seen = []
    real = R.train_cv

    def spy(model, inputs, y, **kw):
        seen.append((type(model).__name__, kw.get("warm_start")))
        return real(model, inputs, y, **kw)

    monkeypatch.setattr(R, "train_cv", spy)
    res = R.run_regression(R.RegressionTrainConfig(
        nn_pretrained=trunks["nn"], graph_pretrained=trunks["graph"],
        bert_pretrained_dir=pre, **cfg_kw), data=data, verbose=False,
        device="cpu")
    kinds = [k for k, _ in seen]
    assert kinds == ["MultiModalRegressor", "BertRegressor", "BertRegressor",
                     "MPNNRegressor", "MPNNRegressor"]      # graph_seeds 2
    warm = dict(seen)
    assert "Dense_3" not in warm["MultiModalRegressor"]       # the head dropped
    assert "Dense_2" in warm["MultiModalRegressor"]
    assert "Dense_8" not in warm["MPNNRegressor"]              # 1 layer: Dense_6-8
    assert "Dense_7" in warm["MPNNRegressor"]
    assert set(warm["BertRegressor"]) == {"enc"}
    assert "mlm_head" in warm["BertRegressor"]["enc"]
    assert np.isfinite(res.oof["smiles"]).all() and "smiles" in res.report
    with open(os.path.join(cfg_kw["out_dir"], "oof_predictions.pkl"), "rb") as f:
        payload = pickle.load(f)
    assert {"smiles", "smiles_seed0", "smiles_seed1"} <= set(payload)
    np.testing.assert_allclose(payload["smiles"], (payload["smiles_seed0"]
                                                   + payload["smiles_seed1"]) / 2,
                               rtol=1e-6, atol=1e-6)


def test_b3db_env_points_the_loaders_and_caches_and_restores(tmp_path, monkeypatch):
    """``testing.b3db_env``: the three variables inside the block, each as it
    was after it (set or unset), also when the block raises."""
    from bbbp_tpu_torch.testing import b3db_env

    monkeypatch.setenv("BBBP_B3DB_DIR", "before")
    monkeypatch.delenv("BBBP_PREPROCESS_CACHE", raising=False)
    monkeypatch.delenv("BBBP_TRANSFER_CACHE", raising=False)
    with pytest.raises(RuntimeError):
        with b3db_env(str(tmp_path)) as env:
            assert env == {k: os.environ[k] for k in env}
            assert os.environ["BBBP_B3DB_DIR"] == str(tmp_path)
            assert os.environ["BBBP_PREPROCESS_CACHE"] == str(tmp_path / "preprocess")
            assert os.environ["BBBP_TRANSFER_CACHE"] == str(tmp_path / "transfer")
            raise RuntimeError
    assert os.environ["BBBP_B3DB_DIR"] == "before"
    assert "BBBP_PREPROCESS_CACHE" not in os.environ
    assert "BBBP_TRANSFER_CACHE" not in os.environ
