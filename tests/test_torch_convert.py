"""``models/convert.py`` both ways: a flax parameter tree (and a
``batch_stats`` tree) of every model the port has, loaded into the port's
model and written back by ``flax_from_params`` / ``flax_stats_from_buffers``,
comes back bit-equal, for every fold. This holds the inverse that writes
the artifacts the JAX package reads (a pretrained directory's
``params.pkl``, an aux-pretraining pickle, a saved flow classifier).

The trees have the paths and shapes of ``jax.eval_shape`` of each flax
init (nothing compiles) and leaves drawn from a seed, a different draw a
fold."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu_torch.models import convert  # noqa: E402
from bbbp_tpu_torch.models.bert import BertEncoder, BertRegressor  # noqa: E402
from bbbp_tpu_torch.models.flow import FlowModel  # noqa: E402
from bbbp_tpu_torch.models.gnn import GCNRegressor, MPNNRegressor  # noqa: E402
from bbbp_tpu_torch.models.mlp import DualBranchMLP  # noqa: E402
from bbbp_tpu_torch.models.transformer_cnn import MultiModalRegressor  # noqa: E402

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bbbp_tpu.models import bert as jbert  # noqa: E402
from bbbp_tpu.models import flow as jflow  # noqa: E402
from bbbp_tpu.models import gnn as jgnn  # noqa: E402
from bbbp_tpu.models import mlp as jmlp  # noqa: E402
from bbbp_tpu.models import transformer_cnn as jtc  # noqa: E402

FOLDS = 3


def _cases():
    """(name, flax module, its init inputs, init kwargs, port model)."""
    fp = np.zeros((2, 40), np.float32)
    img = np.zeros((2, 16, 16, 3), np.float32)
    ids = np.ones((2, 24), np.int32)
    feats = np.zeros((2, 12, 7), np.float32)
    adj_t = np.zeros((2, 4, 12, 12), np.float32)
    adj = np.zeros((2, 12, 12), np.float32)
    mask = np.ones((2, 12), np.float32)
    small = dict(n_layers=2, emb_dim=32, head_dims=(32, 16))
    out = []
    for fusion in ("multihead", "gate", "crossmodal"):
        for tokens in (1, 4):
            out.append((f"regressor-{fusion}-{tokens}",
                        jtc.MultiModalRegressor(fp_dim=40, fusion=fusion,
                                                fp_tokens=tokens, **small),
                        (fp, img), {},
                        MultiModalRegressor(fp_dim=40, fusion=fusion, fp_tokens=tokens,
                                            image_size=16, folds=FOLDS, **small)))
    out.append(("regressor-in-proj", jtc.MultiModalRegressor(
        fp_dim=40, max_fp_width=32, **small), (fp, img), {},
        MultiModalRegressor(fp_dim=40, max_fp_width=32, image_size=16,
                            folds=FOLDS, **small)))
    out.append(("mpnn", jgnn.MPNNRegressor(hidden=16, n_layers=2),
                (feats, adj_t, mask), {},
                MPNNRegressor(7, hidden=16, n_layers=2, folds=FOLDS)))
    out.append(("gcn", jgnn.GCNRegressor(hidden=(16, 8), head=(8,)),
                (feats, adj, mask), {},
                GCNRegressor(7, hidden=(16, 8), head=(8,), folds=FOLDS)))
    enc = dict(n_layers=2, d_model=32, n_heads=4, d_ff=64, max_len=24)
    for mlm in (False, True):
        out.append((f"bert-mlm-{mlm}", jbert.BertEncoder(vocab_size=30, **enc),
                    (ids,), {"mlm": mlm},
                    BertEncoder(30, mlm=mlm, folds=FOLDS, **enc)))
    out.append(("bert-regressor", jbert.BertRegressor(
        vocab_size=30, n_layers=1, d_model=32, n_heads=4, max_len=24), (ids,), {},
        BertRegressor(30, n_layers=1, d_model=32, n_heads=4, max_len=24,
                      folds=FOLDS)))
    widths = dict(fp_dims=(16, 8), img_dims=(16, 8), head_dims=(16, 8))
    out.append(("mlp", jmlp.DualBranchMLP(**widths),
                (fp, np.zeros((2, 48), np.float32)), {},
                DualBranchMLP(40, 48, folds=FOLDS, **widths)))
    out.append(("flow", jflow.FlowModel(hidden_dim=24, n_layers=2), (fp,), {},
                FlowModel(40, 24, 2, folds=FOLDS)))
    return out


CASES = _cases()


def _draw(shapes, rng):
    return {k: _draw(v, rng) if isinstance(v, dict) else
            rng.normal(size=tuple(v.shape)).astype(np.float32)
            for k, v in shapes.items()}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flax_tree_round_trips_bit_equal(case):
    _, flax_model, inputs, kw, model = case
    variables = jax.eval_shape(lambda: flax_model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *(jnp.asarray(a) for a in inputs), **kw))
    rng = np.random.default_rng(0)
    params = [_draw(dict(variables["params"]), rng) for _ in range(FOLDS)]
    stats = ([_draw(dict(variables["batch_stats"]), rng) for _ in range(FOLDS)]
             if "batch_stats" in variables else None)
    convert.load_flax(model, params, stats)
    for k in range(FOLDS):
        back = convert.flatten_tree(convert.flax_from_params(model, k))
        want = convert.flatten_tree(params[k])
        assert set(back) == set(want)
        for path, v in want.items():
            assert back[path].dtype == np.float32
            assert np.array_equal(back[path], v), path
        if stats is not None:
            back = convert.flatten_tree(convert.flax_stats_from_buffers(model, k))
            want = convert.flatten_tree(stats[k])
            assert set(back) == set(want)
            assert all(np.array_equal(back[p], v) for p, v in want.items())
    assert (stats is not None) == (len(list(model.buffers())) > 0)


def test_stats_from_flax_refuses_a_missing_leaf():
    model = DualBranchMLP(4, 6, fp_dims=(3,), img_dims=(3,), head_dims=(2,))
    stats = convert.flax_stats_from_buffers(model)
    del stats["img_branch"]["BatchNorm_0"]["var"]
    with pytest.raises(ValueError, match="img_branch/BatchNorm_0/var"):
        convert.stats_from_flax(model, stats)


def test_unflatten_inverts_flatten():
    tree = {"a": {"b": np.ones(2), "c": {"d": np.zeros(1)}}, "e": np.ones(3)}
    back = convert.unflatten_tree(convert.flatten_tree(tree))
    assert convert.flatten_tree(back).keys() == convert.flatten_tree(tree).keys()
