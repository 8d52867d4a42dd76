"""SMILES-BERT masked-language-model pretraining: the counterpart of
``bbbp_tpu/train/bert_pretrain.py``.

MLM-pretrain the encoder (``models/bert.py``, one fold) on a large SMILES
corpus — generated drug-like molecules (``data/zinc.py::synthetic_smiles``)
plus the B3DB sets where ``$BBBP_B3DB_DIR`` holds them — then fine-tune via
``BertClassifier(pretrained_dir=...)`` or the regression stack's SMILES leg.
The saved directory (``tokenizer.json``, ``config.json``, ``params.pkl``)
is the JAX package's: ``params.pkl`` holds a flax-layout numpy tree
(``models/convert.py::flax_from_params``), so either package reads either's.

BERT-style masking (80% [MASK] / 10% random / 10% keep on 15% of non-special
tokens) is drawn on the device from a generator there, one step at a time;
the batches come from numpy's ``default_rng(seed)`` as the JAX package
draws them. AdamW (weight decay 0.01) under optax's warmup-cosine schedule
(``train/loop.py::warmup_cosine``: warmup a twentieth of the steps).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from bbbp_tpu_torch.models.bert import CLS, MASK, PAD, BertEncoder, SmilesTokenizer
from bbbp_tpu_torch.ops.forest_train import resolve_device


@dataclass
class MLMPretrainConfig:
    corpus_size: int = 200_000        # generated molecules
    include_b3db: bool = True
    epochs: int = 3
    batch_size: int = 256
    lr: float = 3e-4
    n_layers: int = 4
    d_model: int = 128
    n_heads: int = 4
    max_len: int = 128
    mask_prob: float = 0.15
    seed: int = 0
    out_dir: str = "bert_pretrained"


def build_corpus(cfg: MLMPretrainConfig) -> List[str]:
    from bbbp_tpu_torch.data.zinc import synthetic_smiles

    corpus = synthetic_smiles(cfg.corpus_size, seed=cfg.seed)
    if cfg.include_b3db:
        try:
            from bbbp_tpu_torch.data.b3db import (load_b3db_classification,
                                                  load_b3db_regression)

            corpus += list(load_b3db_classification().smiles)
            corpus += list(load_b3db_regression().smiles)
        except Exception:
            pass
    return corpus


def mask_tokens(ids: torch.Tensor, vocab_size: int, mask_prob: float,
                generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inp, sel) of a batch of ids: ``sel`` marks ``mask_prob`` of the
    non-special tokens (not PAD, not CLS); of those, a draw below 0.8
    becomes [MASK], below 0.9 a random token in [4, vocab), else stays."""
    special = (ids == PAD) | (ids == CLS)
    sel = (torch.rand(ids.shape, device=ids.device, generator=generator)
           < mask_prob) & ~special
    mode = torch.rand(ids.shape, device=ids.device, generator=generator)
    rand_tok = torch.randint(4, vocab_size, ids.shape, device=ids.device,
                             generator=generator, dtype=ids.dtype)
    masked = torch.where(mode < 0.8, torch.full_like(ids, MASK),
                         torch.where(mode < 0.9, rand_tok, ids))
    return torch.where(sel, masked, ids), sel


def mlm_loss(model: BertEncoder, ids: torch.Tensor, inp: torch.Tensor,
             sel: torch.Tensor, generator: Optional[torch.Generator] = None,
             train: bool = True) -> torch.Tensor:
    """The mean negative log-likelihood of the original tokens at the
    selected positions (``bert_pretrain.py``'s ``loss_fn``): the sum of
    ``ll · sel`` over every position over max(Σ sel, 1)."""
    logits = model(inp, train=train, generator=generator)
    ll = torch.gather(F.log_softmax(logits, dim=-1), -1,
                      ids.long().unsqueeze(-1))[..., 0]
    m = sel.float()
    return -(ll * m).sum() / torch.clamp(m.sum(), min=1.0)


def pretrain(cfg: MLMPretrainConfig = MLMPretrainConfig(),
             corpus: Optional[List[str]] = None, verbose: bool = True,
             device: Union[str, torch.device] = "cuda") -> str:
    """Run MLM pretraining on ``device``; returns the saved
    pretrained-directory path. The result's ``config.json`` also records
    ``first_mlm_loss`` (the first step's) beside ``final_mlm_loss``."""
    from bbbp_tpu_torch.models.convert import flax_from_params
    from bbbp_tpu_torch.train.loop import AdamW, warmup_cosine

    dev = resolve_device(device)
    t0 = time.time()
    if corpus is None:
        corpus = build_corpus(cfg)
    tok = SmilesTokenizer(cfg.max_len).fit(corpus)
    ids = tok.encode_batch(corpus)
    if verbose:
        print(f"[pretrain] corpus={len(corpus)} vocab={tok.vocab_size} "
              f"tokenized in {time.time()-t0:.1f}s")

    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    model = BertEncoder(vocab_size=tok.vocab_size, n_layers=cfg.n_layers,
                        d_model=cfg.d_model, n_heads=cfg.n_heads,
                        d_ff=4 * cfg.d_model, max_len=cfg.max_len, mlm=True,
                        device=dev, generator=gen)
    n = len(ids)
    bs = min(cfg.batch_size, n)
    steps_per_epoch = max(1, n // bs)
    total = cfg.epochs * steps_per_epoch
    params = list(model.parameters())
    opt = AdamW(params, cfg.lr, weight_decay=0.01,
                schedule=warmup_cosine(max(1, total // 20), max(2, total)))

    host_rng = np.random.default_rng(cfg.seed)
    ids_d = torch.as_tensor(ids, device=dev)
    first = loss = None
    for epoch in range(cfg.epochs):
        perm = host_rng.permutation(n)[: steps_per_epoch * bs]
        perm = torch.as_tensor(perm.reshape(steps_per_epoch, bs), device=dev)
        t_ep = time.time()
        for s in range(steps_per_epoch):
            batch = ids_d[perm[s]]
            inp, sel = mask_tokens(batch, tok.vocab_size, cfg.mask_prob, gen)
            loss = mlm_loss(model, batch, inp, sel, gen)
            opt.step(torch.autograd.grad(loss, params))
            if first is None:
                first = loss.detach()
        if verbose:
            print(f"[pretrain] epoch {epoch+1}/{cfg.epochs} "
                  f"mlm_loss={float(loss.detach()):.4f} ({time.time()-t_ep:.1f}s)")

    os.makedirs(cfg.out_dir, exist_ok=True)
    with open(os.path.join(cfg.out_dir, "tokenizer.json"), "w") as f:
        f.write(tok.to_json())
    with open(os.path.join(cfg.out_dir, "config.json"), "w") as f:
        json.dump({"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                   "n_heads": cfg.n_heads, "max_len": cfg.max_len,
                   "vocab_size": tok.vocab_size, "corpus_size": len(corpus),
                   "epochs": cfg.epochs, "final_mlm_loss": float(loss.detach()),
                   "first_mlm_loss": float(first)}, f)
    with open(os.path.join(cfg.out_dir, "params.pkl"), "wb") as f:
        pickle.dump(flax_from_params(model), f)
    if verbose:
        print(f"[pretrain] saved {cfg.out_dir} ({time.time()-t0:.1f}s total)")
    return cfg.out_dir


def main():
    ap = argparse.ArgumentParser(description="SMILES-BERT MLM pretraining")
    ap.add_argument("--corpus-size", type=int, default=200_000)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--out-dir", default="bert_pretrained")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    pretrain(MLMPretrainConfig(
        corpus_size=args.corpus_size, epochs=args.epochs,
        batch_size=args.batch_size, lr=args.lr, n_layers=args.n_layers,
        d_model=args.d_model, out_dir=args.out_dir), device=args.device)


if __name__ == "__main__":
    main()
