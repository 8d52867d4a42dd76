"""SMILES-BERT in the port (``bbbp_tpu_torch/models/bert.py``,
``train/bert_pretrain.py``, ``train/bert_pipeline.py``) against the JAX
package's (``bbbp_tpu/models/bert.py``, ``bbbp_tpu/train/bert_pretrain.py``),
at toy width (1-2 layers, d_model 32, 4 heads, sequences of 48 tokens).

- The tokenizers are copies: ids bit-equal over 2,000 ``synthetic_smiles``
  and over stringified f32 vectors; each package reads the other's JSON.
- Forward from one flax parameter tree (leaves drawn from a seed into the
  shapes of ``jax.eval_shape`` of the flax init), on batches that hold PAD
  rows, an all-PAD row among them: f32 within 1e-5; bf16 within 2e-2 of
  the larger of 1 and the output's scale (flax's own bf16 MLM logits differ
  from its f32 ones by 0.051 at a scale of 3.0 at this width, so no
  absolute 2e-2 holds two independent bf16 roundings of them); finite
  everywhere.
- One MLM loss and its gradient against the JAX package's ``loss_fn`` on
  the same ``inp`` / ``sel`` (f32, dropout 0): loss within 1e-6 relative,
  every gradient element within 1e-5 of its parameter's largest |g|.
- The warmup-cosine schedule against optax's at every step (1e-6 relative).
- ``train_cv`` of ``BertRegressor`` from one flax init with dropout 0
  against the JAX package's: f32 OOF within 1e-4, losses within 1e-4
  relative; bf16 (the JAX package's own ``BertRegressor``) OOF within 1e-3.
- Pretrained directories across the packages, both ways, and the saved
  classifier; ``BertClassifier``'s mean test accuracy over four seeds
  within 0.05 of the JAX package's on a toy task, both from one flax init;
  the port's init against flax's, leaf by leaf.
- Dropout: the classifier's loss under each kind of dropout over 2,000
  draws in each package, mean and spread (``bert_dropout_reference.py``);
  ``fold.dropout``'s scale equal to flax's in f32 and bf16.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bbbp_tpu_torch.data.zinc import synthetic_smiles  # noqa: E402
from bbbp_tpu_torch.models import bert as B  # noqa: E402
from bbbp_tpu_torch.models.convert import (flatten_tree, load_flax,  # noqa: E402
                                           params_from_flax, unflatten_tree)
from bbbp_tpu_torch.train import bert_pretrain as P  # noqa: E402
from bbbp_tpu_torch.train import loop as tloop  # noqa: E402


@pytest.fixture(scope="module")
def J():
    """The JAX package's side, imported here so that the ``cuda``-marked
    test also runs where JAX is absent."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import optax
    from flax import linen as nn

    from bbbp_tpu.models import bert as jbert
    from bbbp_tpu.train import bert_pretrain as jpre
    from bbbp_tpu.train import loop as jloop

    class F32Regressor(nn.Module):
        """``BertRegressor`` of the JAX package with an f32 encoder (the
        package's own is bf16): the same names, so one tree serves both."""
        vocab_size: int
        n_layers: int = 1
        d_model: int = 32
        n_heads: int = 4
        max_len: int = 48
        dropout: float = 0.0

        @nn.compact
        def __call__(self, ids, train: bool = False):
            z = jbert.BertEncoder(
                vocab_size=self.vocab_size, n_layers=self.n_layers,
                d_model=self.d_model, n_heads=self.n_heads,
                d_ff=4 * self.d_model, max_len=self.max_len, n_classes=1,
                dropout=self.dropout, dtype=jnp.float32, name="enc")(ids, train=train)
            return z[..., 0]

    return SimpleNamespace(jax=jax, jnp=jnp, optax=optax, bert=jbert,
                           pre=jpre, loop=jloop, F32Regressor=F32Regressor)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


L = 48
ENC = dict(n_layers=2, d_model=32, n_heads=4, d_ff=64, max_len=L)
FWD_TOL = {"f32": 1e-5, "bf16": 2e-2}


@pytest.fixture(scope="module")
def corpus():
    return synthetic_smiles(2000, seed=5)


@pytest.fixture(scope="module")
def tok(corpus):
    return B.SmilesTokenizer(L).fit(corpus)


def test_tokenizer_ids_equal_jax(corpus, tok, J):
    theirs = J.bert.SmilesTokenizer(L).fit(corpus)
    assert tok.vocab == theirs.vocab
    assert np.array_equal(tok.encode_batch(corpus), theirs.encode_batch(corpus))
    assert tok.to_json() == theirs.to_json()
    # each package reads the other's JSON
    back = B.SmilesTokenizer.from_json(theirs.to_json())
    assert np.array_equal(back.encode_batch(corpus[:50]), tok.encode_batch(corpus[:50]))
    assert J.bert.SmilesTokenizer.from_json(tok.to_json()).vocab == tok.vocab


def test_number_string_tokenizer_equal_jax(J):
    rows = np.random.default_rng(0).normal(size=(60, 12)).astype(np.float32)
    texts = [str(np.asarray(r)) for r in rows]
    ours = B.NumberStringTokenizer(64).fit(texts)
    theirs = J.bert.NumberStringTokenizer(64).fit(texts)
    assert ours.vocab == theirs.vocab
    assert np.array_equal(ours.encode_batch(texts), theirs.encode_batch(texts))
    clf = B.BertClassifier(input_mode="compat_vector")
    assert clf._texts(rows) == texts


def random_tree(shapes, seed: int):
    """A flax tree of the shapes of ``shapes`` (``jax.eval_shape`` of an
    init), every leaf drawn from ``seed``: kernels and embeddings normal of
    std 0.3/sqrt(fan_in) (0.3 for the embeddings), biases 0.05, LayerNorm
    scales 1 ± 0.1."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape = tuple(leaf.shape)
        name = path[-1]
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name in ("bias", "pos_emb"):
            return (0.05 * rng.normal(size=shape)).astype(np.float32)
        fan_in = shape[0] if name == "kernel" else 1
        std = 0.3 / np.sqrt(fan_in) if name == "kernel" else 0.3
        return (std * rng.normal(size=shape)).astype(np.float32)

    def walk(tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else draw(path + (k,), v)
                for k, v in tree.items()}
    return walk(shapes, ())


def flax_tree(J, model, ids, seed=0, **kw):
    shapes = J.jax.eval_shape(lambda: model.init(
        {"params": J.jax.random.PRNGKey(0), "dropout": J.jax.random.PRNGKey(1)},
        ids, **kw))["params"]
    return random_tree(J.jax.tree.map(lambda s: s, shapes,
                                      is_leaf=lambda x: hasattr(x, "shape")), seed)


@pytest.fixture(scope="module")
def batch(corpus, tok):
    """14 rows: 11 encoded SMILES, three joined by "." and truncated at 48
    tokens, a row of CLS alone and a row of PAD alone."""
    ids = tok.encode_batch(corpus[:11] + [".".join(corpus[2:5]), "", ""])
    ids[13] = B.PAD
    lengths = (ids != B.PAD).sum(1)
    assert lengths.max() == L and lengths.min() == 0 and (lengths == 1).any()
    return ids


@pytest.mark.parametrize("mlm", [False, True])
@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_encoder_forward_equals_flax(batch, tok, mlm, name, J):
    jnp = J.jnp
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[name]
    V = tok.vocab_size
    fm = J.bert.BertEncoder(vocab_size=V, dtype=jdt, **ENC)
    params = flax_tree(J, fm, batch, mlm=mlm)
    want = np.asarray(J.jax.jit(lambda p, x: fm.apply({"params": p}, x, mlm=mlm))(
        params, batch), np.float32)
    model = load_flax(B.BertEncoder(V, dtype=tdt, mlm=mlm, folds=3, **ENC), params)
    with torch.no_grad():
        got = model(torch.from_numpy(batch)).float().numpy()
        one = B.BertEncoder(V, dtype=tdt, mlm=mlm, **ENC)
        single = load_flax(one, params)(torch.from_numpy(batch)).float().numpy()
    assert got.shape == (3,) + want.shape and single.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(want).max() > 0.1                     # not a vacuous match
    np.testing.assert_allclose(got, np.broadcast_to(want, got.shape), rtol=0,
                               atol=FWD_TOL[name] * scale)
    np.testing.assert_allclose(single, want, rtol=0, atol=FWD_TOL[name] * scale)


def test_pad_rows_average_uniformly_not_nan(batch, tok):
    """A PAD query row has every key masked: its attention weights are
    uniform (flax's finfo.min fill), where a -inf fill gives NaN."""
    from bbbp_tpu_torch.models.transformer_cnn import MultiHeadDotProductAttention

    attn = MultiHeadDotProductAttention(1, 8, 2, 0.0, torch.float32,
                                        generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 1, 4, 8, generator=torch.Generator().manual_seed(1))
    mask = torch.zeros(1, 1, 1, 4, 4, dtype=torch.bool)
    with torch.no_grad():
        out = attn(x, False, mask=mask)
        v = attn.value(x).mean(dim=2, keepdim=True)
        want = attn.out(v.expand_as(x).contiguous())
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)


def test_regressor_forward_equals_flax(batch, tok, J):
    V = tok.vocab_size
    fm = J.bert.BertRegressor(vocab_size=V, n_layers=1, d_model=32, n_heads=4,
                              max_len=L)
    params = flax_tree(J, fm, batch, seed=3)
    want = np.asarray(J.jax.jit(lambda p, x: fm.apply({"params": p}, x))(
        params, batch), np.float32)
    model = load_flax(B.BertRegressor(V, n_layers=1, d_model=32, n_heads=4,
                                      max_len=L, folds=2), params)
    with torch.no_grad():
        got = model(torch.from_numpy(batch)).float().numpy()
    assert got.shape == (2, len(batch))
    np.testing.assert_allclose(got, np.broadcast_to(want, got.shape), rtol=0,
                               atol=FWD_TOL["bf16"] * max(1.0, np.abs(want).max()))


def test_mask_tokens_selects_as_bert(tok, corpus):
    ids = torch.from_numpy(tok.encode_batch(corpus[:600]))
    gen = torch.Generator().manual_seed(0)
    inp, sel = P.mask_tokens(ids, tok.vocab_size, 0.15, gen)
    special = (ids == B.PAD) | (ids == B.CLS)
    assert not (sel & special).any()
    assert torch.equal(inp[~sel], ids[~sel])
    share = float(sel.sum() / (~special).sum())
    assert abs(share - 0.15) < 0.01
    changed = inp[sel]
    masked = float((changed == B.MASK).float().mean())
    assert abs(masked - 0.8) < 0.03
    assert int(changed.min()) >= B.MASK and int(changed.max()) < tok.vocab_size


def test_mlm_loss_and_gradient_equal_jax(batch, tok, J):
    """f32, dropout 0, the same ``inp`` and ``sel`` on both sides."""
    jax, jnp = J.jax, J.jnp
    V = tok.vocab_size
    fm = J.bert.BertEncoder(vocab_size=V, dtype=jnp.float32, dropout=0.0, **ENC)
    params = flax_tree(J, fm, batch, seed=4, mlm=True)
    ids = torch.from_numpy(batch)
    inp, sel = P.mask_tokens(ids, V, 0.3, torch.Generator().manual_seed(2))
    inp_n, sel_n = inp.numpy(), sel.numpy()

    def loss_fn(p):     # bert_pretrain.py's, given inp and sel
        logits = fm.apply({"params": p}, inp_n, train=True, mlm=True,
                          rngs={"dropout": jax.random.PRNGKey(0)})
        logp = jax.nn.log_softmax(logits)
        ll = jnp.take_along_axis(logp, batch[..., None], axis=-1)[..., 0]
        m = sel_n.astype(jnp.float32)
        return -(ll * m).sum() / jnp.maximum(m.sum(), 1.0)

    want_loss, want_g = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = load_flax(B.BertEncoder(V, dtype=torch.float32, dropout=0.0,
                                    mlm=True, **ENC), params)
    loss = P.mlm_loss(model, ids, inp, sel)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-6)
    want = params_from_flax(model, jax.tree.map(np.asarray, want_g))
    got = torch.autograd.grad(loss, list(model.parameters()))
    for (name, _), g in zip(model.named_parameters(), got):
        scale = float(want[name].abs().max())
        # floor 1e-4: the key bias's gradient is 0 but for rounding (~1e-10)
        assert float((g[0] - want[name][0]).abs().max()) <= 1e-5 * max(scale, 1e-4), name


@pytest.mark.parametrize("warmup,decay", [(1, 2), (5, 100), (37, 750)])
def test_schedule_equals_optax(warmup, decay, J):
    """Within 1e-6 relative, or 1e-7 of the peak where optax's f32
    arithmetic cancels (−peak · (1 − t/w) + peak near t = 0)."""
    peak = 3e-4
    want = J.optax.warmup_cosine_decay_schedule(0.0, peak, warmup, decay)
    factor = tloop.warmup_cosine(warmup, decay)
    for t in range(decay + 3):
        np.testing.assert_allclose(peak * factor(t), float(want(t)), rtol=1e-6,
                                   atol=1e-7 * peak)


def test_adamw_schedule_counts_steps_as_optax(J):
    """AdamW(schedule=...) against optax.adamw(schedule) over 5 steps: the
    first step's learning rate is the schedule at count 0."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(6,)).astype(np.float32)
    grads = rng.normal(size=(5, 6)).astype(np.float32)
    sched = J.optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 5)
    tx = J.optax.adamw(sched, weight_decay=0.01)
    p, st = J.jnp.asarray(p0), None
    st = tx.init(p)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()).unsqueeze(0))
    opt = tloop.AdamW([param], 1e-2, 0.01, schedule=tloop.warmup_cosine(2, 5))
    for g in grads:
        upd, st = tx.update(J.jnp.asarray(g), st, p)
        p = J.optax.apply_updates(p, upd)
        opt.step([torch.from_numpy(g).unsqueeze(0)])
        np.testing.assert_allclose(param.detach()[0].numpy(), np.asarray(p),
                                   rtol=0, atol=1e-7)


TRAIN_KW = dict(n_folds=3, epochs=3, batch_size=16, lr=1e-3, seed=0,
                snapshot_from=2)


@pytest.fixture(scope="module")
def regression_set(corpus, tok):
    """96 molecules' ids and a target of their token counts."""
    ids = tok.encode_batch(corpus[100:196])
    n_tok = (ids != B.PAD).sum(1).astype(np.float32)
    y = ((n_tok - n_tok.mean()) / n_tok.std()).astype(np.float32)
    return ids, y


@pytest.fixture(scope="module")
def jax_train_runs(regression_set, tok, J):
    """The JAX package's train_cv of the f32 stand-in and of its own bf16
    BertRegressor, from one tree, started together (compiles overlap)."""
    ids, y = regression_set
    V = tok.vocab_size
    f32 = J.F32Regressor(vocab_size=V)
    bf16 = J.bert.BertRegressor(vocab_size=V, n_layers=1, d_model=32, n_heads=4,
                                max_len=L, dropout=0.0)
    params = flax_tree(J, f32, ids[:2], seed=6)
    calls = {"f32": lambda: J.loop.train_cv(f32, (ids,), y, warm_start=params,
                                            **TRAIN_KW),
             "bf16": lambda: J.loop.train_cv(bf16, (ids,), y, warm_start=params,
                                             **TRAIN_KW)}
    with ThreadPoolExecutor(2) as pool:
        futures = {k: pool.submit(f) for k, f in calls.items()}
        return params, {k: f.result() for k, f in futures.items()}


@pytest.mark.parametrize("name,tol", [("f32", 1e-4), ("bf16", 1e-3)])
def test_regressor_train_cv_equals_jax(regression_set, tok, jax_train_runs, name, tol):
    ids, y = regression_set
    params, runs = jax_train_runs
    want = runs[name]
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[name]
    model = B.BertRegressor(tok.vocab_size, n_layers=1, d_model=32, n_heads=4,
                            max_len=L, dropout=0.0, dtype=dtype)
    got = tloop.train_cv(model, (ids,), y, warm_start=params, device="cpu",
                         **TRAIN_KW)
    assert all(np.array_equal(a, b) for a, b in zip(got.fold_test_idx,
                                                    want.fold_test_idx))
    np.testing.assert_allclose(got.train_losses, want.train_losses,
                               rtol=1e-4 if name == "f32" else 1e-2)
    np.testing.assert_allclose(got.oof_pred, want.oof_pred, rtol=0, atol=tol)
    assert np.abs(want.oof_pred - want.oof_pred.mean()).max() > 0.05


def _ref():
    """``bert_dropout_reference.py`` at the repository's root: the toy task,
    the classifier's widths and the dropout draws of both packages."""
    import bert_dropout_reference
    return bert_dropout_reference


def _toy_task(n, seed):
    """SMILES labelled 1 where they hold two or more oxygens (40%)."""
    return _ref().toy_task(n, seed)


ACC_SEEDS = (0, 1, 2, 3)
N_TEST = 1024


@pytest.fixture(scope="module")
def accuracy_runs(J, tmp_path_factory):
    """For each seed of ``ACC_SEEDS``: a flax init of the classifier
    (``PRNGKey(100 + seed)``) written as a pretrained directory, and both
    packages' ``BertClassifier(seed=seed)`` at ``CLF`` (dropout 0.1, the
    classifier's own) fine-tuned from it on the toy task's training rows;
    the JAX package's fits run in threads while the port's run here."""
    ref = _ref()
    x, y = ref.toy_task(ref.N_TRAIN + N_TEST, 11)
    train = slice(0, ref.N_TRAIN)
    dirs = ref.write_init_dir(str(tmp_path_factory.mktemp("init")), x[train],
                              ACC_SEEDS)

    def fit(seed):
        return J.bert.BertClassifier(**ref.CLF, seed=seed, pretrained_dir=dirs[seed]
                                     ).fit(x[train], y[train])

    with ThreadPoolExecutor(len(ACC_SEEDS)) as pool:
        futures = {s: pool.submit(fit, s) for s in ACC_SEEDS}
        ours = {s: B.BertClassifier(**ref.CLF, seed=s, pretrained_dir=dirs[s],
                                    device="cpu").fit(x[train], y[train])
                for s in ACC_SEEDS}
        fits = {s: f.result() for s, f in futures.items()}
    return x[ref.N_TRAIN:], y[ref.N_TRAIN:], fits, ours


@pytest.fixture(scope="module")
def jax_classifier(accuracy_runs, tmp_path_factory):
    clf = accuracy_runs[2][ACC_SEEDS[0]]
    path = str(tmp_path_factory.mktemp("jax_clf"))
    clf.save(path)
    return clf, path


def test_classifier_accuracy_as_jax(accuracy_runs):
    """The mean test accuracy over ``ACC_SEEDS`` within 0.05 of the JAX
    package's, each seed's fit in both packages from one flax init, so
    that the training path (dropout, AdamW under the schedule, batches) is
    compared; ``test_encoder_init_as_flax`` holds the port's own init.

    Each fit of either package spreads over seeds, so one seed is no
    comparison. ``python3 bert_dropout_reference.py accuracy`` (12 seeds,
    this test set): from one init the two packages' accuracies differed by
    up to 0.10 on a seed (sd 0.033) and their means by -0.009 ± 0.010,
    seeds 0-3's by 0.010; from their own inits (not held here) the means
    differed by 0.008 ± 0.017, and seeds 0-3 alone, where the port led by
    0.054, are the draw that looked like a gap.
    ``test_dropout_moments_equal_jax`` holds the dropout itself."""
    x_test, y_test, fits, ours = accuracy_runs
    want = np.mean([fits[s].score(x_test, y_test) for s in ACC_SEEDS])
    got = np.mean([ours[s].score(x_test, y_test) for s in ACC_SEEDS])
    assert want > 0.85
    assert abs(got - want) <= 0.05, (got, want)
    assert set(ours[0].evaluate(x_test, y_test)) >= {"accuracy", "roc_auc"}


def test_encoder_init_as_flax(J):
    """The port's initial classifier against flax's init over 40 seeds,
    leaf by leaf: zeros and ones where flax has them, and elsewhere the
    standard deviation within 5% (truncated normals of std 1/sqrt(fan_in)
    for kernels, a normal of std 1/sqrt(d) for the embedding, 0.02 for the
    positions), the mean within 0.05 of it, and kernels bounded at 2·std of
    the untruncated normal, as flax truncates them."""
    V = 30
    fm = J.bert.BertEncoder(vocab_size=V, n_layers=1, d_model=32, n_heads=4,
                            d_ff=128, max_len=L)
    ids = np.ones((2, L), np.int32)
    keys = J.jax.random.split(J.jax.random.PRNGKey(0), 40)
    theirs = flatten_tree(J.jax.tree.map(np.asarray, J.jax.jit(J.jax.vmap(
        lambda k: fm.init({"params": k, "dropout": k}, ids, train=True)["params"]))(keys)))
    model = B.BertEncoder(V, n_layers=1, d_model=32, n_heads=4, d_ff=128,
                          max_len=L, folds=40,
                          generator=torch.Generator().manual_seed(0))
    ours = params_from_flax(model, [unflatten_tree({k: v[i] for k, v in theirs.items()})
                                    for i in range(40)])
    assert set(ours) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        a, b = ours[name].numpy(), p.detach().numpy()
        if a.std() == 0:
            assert np.array_equal(a, b), name
            continue
        assert abs(b.std() / a.std() - 1) <= 0.05, (name, b.std(), a.std())
        assert abs(b.mean() - a.mean()) <= 0.05 * a.std(), name
        if name.endswith("kernel"):
            bound = 2.0 / np.sqrt(b.shape[1]) / 0.87962566103423978
            assert max(np.abs(a).max(), np.abs(b).max()) <= bound * (1 + 1e-6), name


@pytest.mark.parametrize("which", ["both", "attention", "residual"])
def test_dropout_moments_equal_jax(which, J):
    """The classifier's loss on 8 rows of the toy task under dropout 0.1
    (f32, one layer, 32 tokens, one flax init), over 2,000 draws in each
    package (``bert_dropout_reference.loss_draws``): the means within 4
    standard errors and the standard deviations within 10%. ``attention``
    keeps only the attention weights' dropout (one [L, L] mask a draw for
    every row and head), ``residual`` only the elementwise dropout of the
    embeddings and the feed-forward output. A mask drawn per row or head, a
    missing rescale or a wrong keep probability moves one moment or the
    other."""
    want, got = _ref().loss_draws(which, "f32", 2000, seed=9)
    se = np.sqrt(want.var() / len(want) + got.var() / len(got))
    assert want.std() > 5e-3                          # dropout moves the loss
    assert abs(got.mean() - want.mean()) <= 4 * se, (got.mean(), want.mean(), se)
    assert abs(got.std() / want.std() - 1) <= 0.10, (got.std(), want.std())


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_dropout_scales_as_flax(name, J):
    """``fold.dropout`` divides by 1 − rate rounded to the tensor's dtype, as
    flax's ``nn.Dropout`` divides by a weakly typed float: every element
    that both keep is equal (in bf16 x / 0.8984375, not x / 0.9)."""
    from flax import linen as nn

    from bbbp_tpu_torch.models.fold import dropout

    jax, jnp = J.jax, J.jnp
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[name]
    x = np.random.default_rng(0).normal(size=(64, 48)).astype(np.float32)
    want = np.asarray(nn.Dropout(0.1).apply(
        {}, jnp.asarray(x, jdt), deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(0)}), np.float32)
    got = dropout(torch.from_numpy(x).to(tdt), 0.1, True,
                  torch.Generator().manual_seed(0)).float().numpy()
    both = (want != 0) & (got != 0)
    assert both.mean() > 0.75
    assert np.array_equal(got[both], want[both])


def test_saved_classifiers_load_across(jax_classifier, tmp_path, J):
    """A classifier the JAX package saved predicts in the port as there, and
    one the port saved predicts in the JAX package as in the port: logits
    within the bf16 forward's tolerance (2e-2 of the larger of 1 and their
    scale)."""
    clf, path = jax_classifier
    x, _ = _toy_task(64, 12)

    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-2 * max(1.0, np.abs(want).max()))

    ported = B.BertClassifier.load(path, device="cpu")
    close(ported._logits(x), clf._logits(x))
    ours = B.BertClassifier(**dict(_ref().CLF, epochs=1), device="cpu").fit(
        *_toy_task(96, 13))
    ours.save(str(tmp_path / "port"))
    theirs = J.bert.BertClassifier.load(str(tmp_path / "port"))
    close(theirs._logits(x), ours._logits(x))
    assert (theirs.predict(x) == ours.predict(x)).mean() >= 0.95


PRE = dict(corpus_size=300, include_b3db=False, epochs=1, batch_size=64,
           n_layers=1, d_model=32, n_heads=4, max_len=L, seed=3)


def _trunk(tree):
    return {k: v for k, v in flatten_tree(tree).items()
            if not k.startswith(("mlm_", "pooler", "head"))}


def test_port_pretrained_dir_loads_in_jax(tmp_path, J):
    """The port's pretrain writes the JAX package's directory; the JAX
    package's BertClassifier takes every trunk leaf of it."""
    out = P.pretrain(P.MLMPretrainConfig(out_dir=str(tmp_path / "pre"), **PRE),
                     verbose=False, device="cpu")
    with open(os.path.join(out, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["final_mlm_loss"] < cfg["first_mlm_loss"]
    _, _, params = B.read_pretrained(out)
    x, y = _toy_task(64, 14)
    clf = J.bert.BertClassifier(epochs=0, pretrained_dir=out).fit(x, y)
    theirs = flatten_tree(J.jax.tree.map(np.asarray, clf.params_))
    trunk = _trunk(params)
    assert len(trunk) > 10 and set(trunk) <= set(theirs)
    for k, v in trunk.items():
        assert np.array_equal(theirs[k], v), k


def test_jax_pretrained_dir_fine_tunes_in_port(tmp_path, J):
    cfg = J.pre.MLMPretrainConfig(out_dir=str(tmp_path / "jax_pre"), **PRE)
    out = J.pre.pretrain(cfg, verbose=False)
    _, _, params = B.read_pretrained(out)
    x, y = _toy_task(96, 15)
    clf = B.BertClassifier(epochs=0, pretrained_dir=out, device="cpu").fit(x, y)
    ours = flatten_tree(clf.params_)
    for k, v in _trunk(params).items():
        assert np.array_equal(ours[k], np.asarray(v)), k
    tuned = B.BertClassifier(epochs=2, pretrained_dir=out, device="cpu").fit(x, y)
    assert np.isfinite(tuned.loss_history_).all()
    assert not np.array_equal(flatten_tree(tuned.params_)["ln_out/scale"],
                              np.asarray(params["ln_out"]["scale"]))


def test_run_bert_through_b3db_tsv(tmp_path, monkeypatch):
    """``run_bert`` on cpu over a B3DB-format TSV of 120 labelled
    molecules, both input modes (compat_vector: Morgan → scaler → PCA 16
    → str of numpy f32 rows)."""
    from bbbp_tpu_torch.testing import labelled_training_set, write_classification_tsv
    from bbbp_tpu_torch.train.bert_pipeline import BertTrainConfig, run_bert

    smiles, labels = labelled_training_set(120, seed=2)
    write_classification_tsv(str(tmp_path / "B3DB_classification.tsv"), smiles, labels)
    monkeypatch.setenv("BBBP_B3DB_DIR", str(tmp_path))
    for mode in ("smiles", "compat_vector"):
        clf, report, wall = run_bert(BertTrainConfig(input_mode=mode, pca_dim=16,
                                                     epochs=1, workers=1),
                                     verbose=False, device="cpu")
        assert 0.0 <= report["accuracy"] <= 1.0 and wall > 0
        assert isinstance(clf.tokenizer, B.NumberStringTokenizer) == (mode != "smiles")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mlm", [False, True])
def test_encoder_on_cuda_equals_cpu(batch, tok, mlm, cuda_device):
    """The same parameters on the card and the CPU, on the PAD-holding
    batch: f32 (TF32 off) within 1e-4, bf16 within 2e-2 of the larger of 1
    and the output's scale; finite everywhere."""
    from bbbp_tpu_torch.ops.similarity import f32_matmul

    ids = torch.from_numpy(batch)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        model = B.BertEncoder(tok.vocab_size, dtype=dtype, mlm=mlm, folds=2,
                              generator=torch.Generator().manual_seed(0), **ENC)
        with torch.no_grad(), f32_matmul():
            want = model(ids).float()
            got = model.to(cuda_device)(ids.to(cuda_device)).float().cpu()
        assert torch.isfinite(got).all()
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol * scale
