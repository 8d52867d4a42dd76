#!/usr/bin/env python3
"""The BERT classifier's training under dropout in the PyTorch port against
the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python3 bert_dropout_reference.py accuracy \\
        [--init same|own] [--seeds 12] [--n-test 1024]
    JAX_PLATFORMS=cpu python3 bert_dropout_reference.py moments \\
        [--dtype f32|bf16] [--which both|attention|residual|none] \\
        [--draws 10000] [--repeats 3]

``accuracy``: the toy task of ``tests/test_torch_bert.py`` (SMILES with
two or more oxygens; 512 training molecules, ``--n-test`` test molecules
after them) and ``BertClassifier`` at ``CLF`` (one layer, d_model 32, 6
epochs, dropout 0.1) in both packages, seed by seed: both fine-tuned from
one flax init (``PRNGKey(100 + seed)``) written as a pretrained directory
(``same``), or each from its own init (``own``). Prints each seed's test
accuracies, then the means and their difference with its standard error.

``moments``: the classifier's loss on 8 rows of the toy task under dropout
0.1, from one flax init, over ``--draws`` dropout draws in each package,
with both kinds of dropout, one (``attention``: the attention weights'
dropout alone, one [L, L] mask a draw for every row and head;
``residual``: the elementwise dropout of the embeddings and the
feed-forward output alone; the JAX side's other kind is switched off by
patching its flax module) or none (every draw the same loss: the two
packages' arithmetic alone). Prints, for each of ``--repeats`` pairs of
random streams, the two means, their difference in standard errors, and
the two standard deviations. ``tests/test_torch_bert.py`` runs both at a
small size through ``write_init_dir``, ``toy_task`` and ``loss_draws``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pickle
import tempfile

import numpy as np

L = 48
CLF = dict(epochs=6, batch_size=32, lr=2e-3, n_layers=1, d_model=32,
           n_heads=4, max_len=L)
N_TRAIN = 512
MOMENT_WIDTHS = dict(n_layers=1, d_model=32, n_heads=4, d_ff=64, max_len=32)


def toy_task(n: int, seed: int):
    """(SMILES as an object array, labels): 1 where a SMILES holds two or
    more oxygens (40% of ``synthetic_smiles``)."""
    from bbbp_tpu_torch.data.zinc import synthetic_smiles

    smiles = synthetic_smiles(n, seed=seed)
    y = np.array([int(s.count("O") + s.count("o") >= 2) for s in smiles], np.int32)
    return np.asarray(smiles, dtype=object), y


def write_init_dir(path: str, texts, seeds):
    """One pretrained directory a seed under ``path`` (the JAX package's
    format: its tokenizer fit on ``texts``, ``CLF``'s widths, the flax init
    of the classifier from ``PRNGKey(100 + seed)``); returns {seed: dir}."""
    import jax

    from bbbp_tpu.models import bert as jbert

    tok = jbert.SmilesTokenizer(L).fit(list(texts))
    fm = jbert.BertEncoder(vocab_size=tok.vocab_size, n_layers=CLF["n_layers"],
                           d_model=CLF["d_model"], n_heads=CLF["n_heads"],
                           d_ff=4 * CLF["d_model"], max_len=L)
    sample = tok.encode_batch(list(texts[:2]))
    init = jax.jit(lambda key: fm.init({"params": key, "dropout": key}, sample,
                                       train=True)["params"])
    dirs = {}
    for seed in seeds:
        d = os.path.join(path, f"init{seed}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "tokenizer.json"), "w") as f:
            f.write(tok.to_json())
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump({k: CLF[k] for k in ("n_layers", "d_model", "n_heads",
                                           "max_len")}, f)
        with open(os.path.join(d, "params.pkl"), "wb") as f:
            pickle.dump(jax.tree.map(np.asarray,
                                     init(jax.random.PRNGKey(100 + seed))), f)
        dirs[seed] = d
    return dirs


def accuracy(init: str, seeds, n_test: int):
    """Each seed's (JAX, port) test accuracy of the toy task."""
    from bbbp_tpu.models import bert as jbert
    from bbbp_tpu_torch.models import bert as B

    x, y = toy_task(N_TRAIN + n_test, 11)
    train, test = slice(0, N_TRAIN), slice(N_TRAIN, None)
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        dirs = (write_init_dir(tmp, x[train], seeds) if init == "same"
                else dict.fromkeys(seeds))
        for seed in seeds:
            theirs = jbert.BertClassifier(**CLF, seed=seed, pretrained_dir=dirs[seed]
                                          ).fit(x[train], y[train])
            ours = B.BertClassifier(**CLF, seed=seed, pretrained_dir=dirs[seed],
                                    device="cpu").fit(x[train], y[train])
            out.append((theirs.score(x[test], y[test]), ours.score(x[test], y[test])))
            print(f"seed {seed}: jax {out[-1][0]:.4f} port {out[-1][1]:.4f}", flush=True)
    return np.array(out)


@contextlib.contextmanager
def jax_dropout_only(which: str):
    """The JAX package's ``BertEncoder`` with dropout switched off in part
    inside the block (``attention`` keeps the attention weights',
    ``residual`` the elementwise one, ``none`` neither, ``both`` changes
    nothing), by patching the flax classes that ``bbbp_tpu/models/bert.py``
    calls."""
    from flax import linen as nn

    saved = nn.MultiHeadDotProductAttention, nn.Dropout
    if which in ("residual", "none"):
        class Attention(nn.MultiHeadDotProductAttention):
            def __post_init__(self):
                object.__setattr__(self, "dropout_rate", 0.0)
                super().__post_init__()
        nn.MultiHeadDotProductAttention = Attention
    if which in ("attention", "none"):
        class Dropout(nn.Dropout):
            def __call__(self, inputs, deterministic=None, rng=None):
                return inputs
        nn.Dropout = Dropout
    try:
        yield
    finally:
        nn.MultiHeadDotProductAttention, nn.Dropout = saved


def loss_draws(which: str, dtype: str, draws: int, seed: int, chunk: int = 250):
    """(JAX losses, port losses) [draws] f64: the classifier's loss on 8
    rows of the toy task under dropout 0.1 (``which`` kinds of it), one
    flax init at ``MOMENT_WIDTHS`` in ``dtype``, one draw of the masks a
    loss; the JAX side's keys and the port's generator from ``seed``."""
    import jax
    import jax.numpy as jnp
    import torch

    from bbbp_tpu.models import bert as jbert
    from bbbp_tpu_torch.data.zinc import synthetic_smiles
    from bbbp_tpu_torch.models import bert as B
    from bbbp_tpu_torch.models.convert import load_flax

    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    smiles, labels = toy_task(8, 7)
    tok = B.SmilesTokenizer(MOMENT_WIDTHS["max_len"]).fit(synthetic_smiles(2000, seed=5))
    ids = tok.encode_batch(list(smiles))
    with jax_dropout_only(which):
        fm = jbert.BertEncoder(vocab_size=tok.vocab_size, dtype=jdt, dropout=0.1,
                               **MOMENT_WIDTHS)
        params = jax.jit(lambda k: fm.init({"params": k, "dropout": k}, ids,
                                           train=True)["params"])(jax.random.PRNGKey(7))

        def loss(key):
            logits = fm.apply({"params": params}, ids, train=True,
                              rngs={"dropout": key})
            return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                                 labels[:, None], axis=1))

        batched = jax.jit(jax.vmap(loss))
        keys = jax.random.split(jax.random.PRNGKey(seed), draws).reshape(-1, chunk, 2)
        want = np.concatenate([np.asarray(batched(k), np.float64) for k in keys])
    model = load_flax(B.BertEncoder(tok.vocab_size, dtype=tdt, dropout=0.1,
                                    folds=chunk, **MOMENT_WIDTHS),
                      [jax.tree.map(np.asarray, params)] * chunk)
    if which in ("attention", "none"):
        model.rate = 0.0
    for i in range(MOMENT_WIDTHS["n_layers"]):
        getattr(model, f"attn{i}").rate = 0.0 if which in ("residual", "none") else 0.1
    gen = torch.Generator().manual_seed(seed)
    ids_t = torch.from_numpy(ids)
    y_t = torch.from_numpy(labels).long().repeat(chunk)
    with torch.no_grad():
        got = np.concatenate([torch.nn.functional.cross_entropy(
            model(ids_t, train=True, generator=gen).reshape(-1, 2), y_t,
            reduction="none").view(chunk, -1).mean(1).double().numpy()
            for _ in range(draws // chunk)])
    return want, got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    acc = sub.add_parser("accuracy")
    acc.add_argument("--init", choices=("same", "own"), default="same")
    acc.add_argument("--seeds", type=int, default=12)
    acc.add_argument("--n-test", type=int, default=1024)
    mom = sub.add_parser("moments")
    mom.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    mom.add_argument("--which", choices=("both", "attention", "residual", "none"),
                     default="both")
    mom.add_argument("--draws", type=int, default=10_000)
    mom.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if args.mode == "accuracy":
        a = accuracy(args.init, range(args.seeds), args.n_test)
        d = a[:, 1] - a[:, 0]
        print(f"{args.init} init, {len(a)} seeds, {args.n_test} test molecules: "
              f"jax {a[:, 0].mean():.4f} (sd {a[:, 0].std(ddof=1):.4f}), port "
              f"{a[:, 1].mean():.4f} (sd {a[:, 1].std(ddof=1):.4f}), port - jax "
              f"{d.mean():+.4f} ± {d.std(ddof=1) / np.sqrt(len(d)):.4f} "
              f"(sd a seed {d.std(ddof=1):.4f})")
        return 0
    for r in range(args.repeats):
        want, got = loss_draws(args.which, args.dtype, args.draws, seed=1000 * r + 9)
        se = np.sqrt(want.var() / len(want) + got.var() / len(got))
        diff = got.mean() - want.mean()
        print(f"{args.dtype} {args.which} draws {args.draws} stream {r}: mean jax "
              f"{want.mean():.5f} port {got.mean():.5f} diff {diff:+.5f}"
              + (f" ({diff / se:+.2f} se)" if se > 0 else "")
              + f"; sd jax {want.std():.5f} port {got.std():.5f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
