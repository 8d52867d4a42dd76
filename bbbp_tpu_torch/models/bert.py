"""SMILES-BERT, a compact BERT-style encoder on the fold axis: the
counterpart of ``bbbp_tpu/models/bert.py`` (``models/fold.py``).

The tokenizers are the JAX package's, copied (pure Python; a tokenizer's
JSON loads in either package). ``BertEncoder`` and ``BertRegressor`` carry
a leading fold axis on every parameter, as the port's other models, so
that ``train_cv`` trains the regression stack's SMILES leg with all folds
at once; ``BertClassifier`` and MLM pretraining (``train/bert_pretrain.py``)
are the case K = 1.

Numerics follow flax 0.12 as the JAX package calls it (bf16 compute):

- ``tok_emb`` looks up an f32 table and casts to bf16; ``pos_emb`` is an
  f32 ``normal(0.02)`` parameter [1, max_len, d], cast to bf16 and added;
- pre-LN blocks: LayerNorm (f32 statistics, epsilon 1e-6) → self-attention
  under the mask ``m[:, None, :] & m[:, :, None]`` of non-PAD tokens, with
  masked scores set to ``finfo(bf16).min`` (a PAD query row, every key
  masked, averages every value uniformly, as flax; a −inf fill, or
  ``scaled_dot_product_attention``'s boolean mask, gives NaN there) and one
  dropout mask [L, L] a fold for every row and head; then LayerNorm → dense
  → tanh-approximated GELU (``nn.gelu``'s default) → dense → dropout;
- the MLM head (dense, GELU, LayerNorm, an f32 dense to the vocabulary) or
  the classifier head (a tanh pooler over the CLS token, an f32 dense).

flax creates only the parameters of the head it is called with, so a
pretrained tree holds ``mlm_*`` and no ``pooler``/``head``, a classifier's
the reverse; here the head is a constructor argument (``mlm``), and
``models/convert.py`` loads either tree into the matching model.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bbbp_tpu_torch.models.fold import Dense, Embed, LayerNorm, dropout
from bbbp_tpu_torch.models.transformer_cnn import MultiHeadDotProductAttention

PAD, CLS, UNK, MASK = 0, 1, 2, 3
_SMILES_TOKEN_RE = re.compile(
    r"(\[[^\]]+\]|Br|Cl|Si|Se|se|@@|@|==|[BCNOPSFIbcnops]|\d|%\d\d|[=#$:\-+\\/().*~])"
)
_NUM_RE = re.compile(r"(-?\d+\.?\d*(?:e-?\d+)?|\S)")


class SmilesTokenizer:
    """Atom-level regex tokenizer with corpus-built vocabulary."""

    def __init__(self, max_len: int = 128):
        self.max_len = max_len
        self.vocab: Dict[str, int] = {"[PAD]": PAD, "[CLS]": CLS, "[UNK]": UNK,
                                      "[MASK]": MASK}

    def _split(self, text: str) -> List[str]:
        return _SMILES_TOKEN_RE.findall(text)

    def fit(self, texts: Sequence[str]) -> "SmilesTokenizer":
        for t in texts:
            for tok in self._split(t):
                if tok not in self.vocab:
                    self.vocab[tok] = len(self.vocab)
        return self

    def encode(self, text: str) -> np.ndarray:
        ids = [CLS] + [self.vocab.get(t, UNK) for t in self._split(text)]
        ids = ids[: self.max_len]
        out = np.full(self.max_len, PAD, dtype=np.int32)
        out[: len(ids)] = ids
        return out

    def encode_batch(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self.encode(t) for t in texts])

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def to_json(self) -> str:
        return json.dumps({"max_len": self.max_len, "vocab": self.vocab})

    @staticmethod
    def from_json(s: str) -> "SmilesTokenizer":
        d = json.loads(s)
        tok = SmilesTokenizer(d["max_len"])
        tok.vocab = {k: int(v) for k, v in d["vocab"].items()}
        return tok


class NumberStringTokenizer(SmilesTokenizer):
    """compat_vector mode: tokenizes str(np.ndarray)-style number strings —
    the reference's stringified-PCA-vector quirk (model_train_bert.py:39)."""

    def _split(self, text: str) -> List[str]:
        return _NUM_RE.findall(text)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class BertEncoder(nn.Module):
    """K = ``folds`` encoders. ``mlm`` picks the head: per-position token
    logits [K, B, L, vocab] (MLM pretraining) or class logits [K, B,
    n_classes] from the CLS pooler. ids [K, B, L] (fold k's rows through
    encoder k) or [B, L] (the same rows through every encoder; one encoder
    then returns no fold axis). L must be ``max_len``, as flax's
    ``pos_emb`` broadcast needs."""

    def __init__(self, vocab_size: int, n_layers: int = 4, d_model: int = 128,
                 n_heads: int = 4, d_ff: int = 512, max_len: int = 128,
                 n_classes: int = 2, dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16, mlm: bool = False,
                 folds: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = dict(vocab_size=vocab_size, n_layers=n_layers,
                           d_model=d_model, n_heads=n_heads, d_ff=d_ff,
                           max_len=max_len, n_classes=n_classes,
                           dropout=dropout, dtype=dtype, mlm=mlm)
        self.folds, self.dtype, self.rate = folds, dtype, dropout
        self.n_layers, self.mlm = n_layers, mlm
        on = dict(device=device, generator=generator)
        self.tok_emb = Embed(folds, vocab_size, d_model, dtype, **on)
        self.pos_emb = nn.Parameter(nn.init.normal_(
            torch.empty(folds, 1, max_len, d_model, device=device), 0.0, 0.02,
            generator=generator))
        for i in range(n_layers):
            self.add_module(f"ln_a{i}", LayerNorm(folds, d_model, dtype, device))
            self.add_module(f"attn{i}", MultiHeadDotProductAttention(
                folds, d_model, n_heads, dropout, dtype, **on))
            self.add_module(f"ln_f{i}", LayerNorm(folds, d_model, dtype, device))
            self.add_module(f"ff{i}_1", Dense(folds, d_model, d_ff, dtype, **on))
            self.add_module(f"ff{i}_2", Dense(folds, d_ff, d_model, dtype, **on))
        self.ln_out = LayerNorm(folds, d_model, dtype, device)
        if mlm:
            self.mlm_dense = Dense(folds, d_model, d_model, dtype, **on)
            self.mlm_ln = LayerNorm(folds, d_model, dtype, device)
            self.mlm_head = Dense(folds, d_model, vocab_size, torch.float32, **on)
        else:
            self.pooler = Dense(folds, d_model, d_model, dtype, **on)
            self.head = Dense(folds, d_model, n_classes, torch.float32, **on)

    def trunk(self, ids: torch.Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """ids [K, B, L] → the final LayerNorm's output [K, B, L, d]."""
        mask = ids != PAD
        x = self.tok_emb(ids) + self.pos_emb.to(self.dtype)
        x = dropout(x, self.rate, train, generator)
        attn_mask = (mask.unsqueeze(-2) & mask.unsqueeze(-1)).unsqueeze(2)
        for i in range(self.n_layers):
            h = getattr(self, f"ln_a{i}")(x)
            x = x + getattr(self, f"attn{i}")(h, train, generator, attn_mask)
            h = getattr(self, f"ln_f{i}")(x)
            f = _gelu(getattr(self, f"ff{i}_1")(h))
            f = dropout(getattr(self, f"ff{i}_2")(f), self.rate, train, generator)
            x = x + f
        return self.ln_out(x)

    def forward(self, ids: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        single = ids.dim() == 2
        if single:
            ids = ids.expand(self.folds, *ids.shape)
        x = self.trunk(ids, train, generator)
        if self.mlm:
            h = self.mlm_ln(_gelu(self.mlm_dense(x)))
            out = self.mlm_head(h.float())
        else:
            pooled = torch.tanh(self.pooler(x[:, :, 0]))
            out = self.head(pooled.float())
        return out[0] if single and self.folds == 1 else out


class BertRegressor(nn.Module):
    """Scalar-output encoder for the regression stack's SMILES leg: a
    ``BertEncoder`` named ``enc`` (d_ff 4·d_model, one output), so that an
    MLM-pretrained trunk warm-starts it through
    ``train_cv(warm_start={"enc": pretrained_params})``. ids [K, B, L] or
    [B, L] → [K, B] (or [B] for one fold without the fold axis)."""

    def __init__(self, vocab_size: int, n_layers: int = 4, d_model: int = 128,
                 n_heads: int = 4, max_len: int = 128, dropout: float = 0.1,
                 dtype: torch.dtype = torch.bfloat16, folds: int = 1,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = dict(vocab_size=vocab_size, n_layers=n_layers,
                           d_model=d_model, n_heads=n_heads, max_len=max_len,
                           dropout=dropout, dtype=dtype)
        self.folds = folds
        self.enc = BertEncoder(vocab_size, n_layers, d_model, n_heads,
                               4 * d_model, max_len, n_classes=1,
                               dropout=dropout, dtype=dtype, folds=folds,
                               device=device, generator=generator)

    def forward(self, ids: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.enc(ids, train, generator)[..., 0]


def merge_pretrained(init_params, pretrained):
    """Copy every pretrained leaf whose path+shape matches into a freshly
    initialised tree (the trunk transfers; absent heads stay fresh)."""
    def merge(a, b):
        if isinstance(a, dict):
            return {k: (merge(a[k], b[k]) if isinstance(b, dict) and k in b
                        else a[k]) for k in a}
        if hasattr(a, "shape") and hasattr(b, "shape") and a.shape == b.shape:
            return b
        return a
    return merge(init_params, pretrained)


def read_pretrained(path: str):
    """(tokenizer, config dict, flax params tree) of a pretrained directory
    (``tokenizer.json``, ``config.json``, ``params.pkl``) that either
    package's ``pretrain`` wrote."""
    import pickle

    with open(os.path.join(path, "tokenizer.json")) as f:
        tok = SmilesTokenizer.from_json(f.read())
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(path, "params.pkl"), "rb") as f:
        params = pickle.load(f)
    return tok, cfg, params


class BertClassifier:
    """sklearn-compatible wrapper (fit/predict/predict_proba/score/evaluate/
    save/load/get_params/set_params) — the SklearnBertClassifier equivalent
    (reference: Models/model_train_bert.py:57-158). ``pretrained_dir`` loads
    an MLM-pretrained encoder directory (train.bert_pretrain) and fine-tunes
    it. One encoder (K = 1) on ``device``; AdamW (weight decay 0.01 on every
    parameter) under optax's warmup-cosine schedule; batches from numpy's
    ``default_rng(seed)`` as the JAX package draws them, the initial
    parameters and dropout from a ``torch.Generator`` seeded with ``seed``.
    ``device`` is not a parameter of ``get_params``: ``config.json`` stays
    the JAX package's."""

    PARAMS = ("epochs", "batch_size", "lr", "n_layers", "d_model", "n_heads",
              "max_len", "input_mode", "warmup_frac", "seed", "pretrained_dir")

    def __init__(self, epochs: int = 3, batch_size: int = 32, lr: float = 2e-4,
                 n_layers: int = 4, d_model: int = 128, n_heads: int = 4,
                 max_len: int = 128, input_mode: str = "smiles",
                 warmup_frac: float = 0.1, seed: int = 0,
                 pretrained_dir: Optional[str] = None, device="cuda"):
        self.epochs = epochs
        self.batch_size = batch_size
        self.lr = lr
        self.n_layers = n_layers
        self.d_model = d_model
        self.n_heads = n_heads
        self.max_len = max_len
        self.input_mode = input_mode     # smiles | compat_vector
        self.warmup_frac = warmup_frac
        self.seed = seed
        self.pretrained_dir = pretrained_dir
        self.device = device
        self.tokenizer: Optional[SmilesTokenizer] = None
        self.model: Optional[BertEncoder] = None

    # -- sklearn plumbing for grid search --
    def get_params(self, deep: bool = True):
        return {k: getattr(self, k) for k in self.PARAMS}

    def set_params(self, **p):
        for k, v in p.items():
            setattr(self, k, v)
        return self

    def _texts(self, x) -> List[str]:
        if self.input_mode == "compat_vector":
            # reproduce str(vector) feeding (reference :39)
            return [str(np.asarray(row)) for row in x]
        return list(x)

    def _encoder(self, dev, generator=None) -> BertEncoder:
        return BertEncoder(
            vocab_size=self.tokenizer.vocab_size, n_layers=self.n_layers,
            d_model=self.d_model, n_heads=self.n_heads, d_ff=4 * self.d_model,
            max_len=self.max_len, device=dev, generator=generator)

    def fit(self, x, y) -> "BertClassifier":
        from bbbp_tpu_torch.models.convert import matching_params
        from bbbp_tpu_torch.ops.forest_train import resolve_device
        from bbbp_tpu_torch.train.loop import AdamW, warmup_cosine

        dev = resolve_device(self.device)
        texts = self._texts(x)
        y = np.asarray(y, np.int32)
        pretrained_params = None
        if self.pretrained_dir:
            # fixed vocabulary + architecture from the pretrained directory
            self.tokenizer, pcfg, pretrained_params = read_pretrained(
                self.pretrained_dir)
            for k in ("n_layers", "d_model", "n_heads", "max_len"):
                setattr(self, k, pcfg[k])
        else:
            tok_cls = (NumberStringTokenizer
                       if self.input_mode == "compat_vector" else SmilesTokenizer)
            self.tokenizer = tok_cls(self.max_len).fit(texts)
        ids = self.tokenizer.encode_batch(texts)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.model = model = self._encoder(dev, gen)
        if pretrained_params is not None:
            with torch.no_grad():
                for name, v in matching_params(model, pretrained_params).items():
                    model.get_parameter(name).copy_(v)
        n = len(y)
        bs = min(self.batch_size, n)
        steps_per_epoch = max(1, n // bs)
        total_steps = self.epochs * steps_per_epoch
        params = list(model.parameters())
        opt = AdamW(params, self.lr, weight_decay=0.01, schedule=warmup_cosine(
            max(1, int(self.warmup_frac * total_steps)), max(2, total_steps)))

        host_rng = np.random.default_rng(self.seed)
        ids_d = torch.as_tensor(ids, device=dev)
        y_d = torch.as_tensor(y, dtype=torch.int64, device=dev)
        self.loss_history_ = []
        for epoch in range(self.epochs):
            perm = host_rng.permutation(n)[: steps_per_epoch * bs]
            perm = torch.as_tensor(perm.reshape(steps_per_epoch, bs), device=dev)
            ep_loss = torch.zeros((), device=dev)
            for step in range(steps_per_epoch):
                b = perm[step]
                logits = model(ids_d[b], train=True, generator=gen)
                loss = F.cross_entropy(logits, y_d[b])
                opt.step(torch.autograd.grad(loss, params))
                ep_loss += loss.detach()
            self.loss_history_.append(float(ep_loss) / steps_per_epoch)
        return self

    @torch.no_grad()
    def _logits(self, x) -> np.ndarray:
        ids = self.tokenizer.encode_batch(self._texts(x))
        dev = self.model.pos_emb.device
        outs = []
        for start in range(0, len(ids), 256):
            b = torch.as_tensor(ids[start:start + 256], device=dev)
            outs.append(self.model(b).cpu().numpy())
        return np.concatenate(outs)

    def predict_proba(self, x) -> np.ndarray:
        z = self._logits(x)
        e = np.exp(z - z.max(1, keepdims=True))
        return e / e.sum(1, keepdims=True)

    def predict(self, x) -> np.ndarray:
        return self._logits(x).argmax(1)

    def score(self, x, y) -> float:
        return float((self.predict(x) == np.asarray(y)).mean())

    def evaluate(self, x, y) -> Dict[str, float]:
        from bbbp_tpu_torch.ops import metrics

        proba = self.predict_proba(x)[:, 1]
        pred = (proba > 0.5).astype(int)
        return metrics.classification_report(np.asarray(y), pred, proba)

    @property
    def params_(self):
        """The trained parameters as the JAX package keeps them: a flax
        params tree of numpy arrays."""
        from bbbp_tpu_torch.models.convert import flax_from_params

        return flax_from_params(self.model)

    def save(self, path: str) -> None:
        import pickle

        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "tokenizer.json"), "w") as f:
            f.write(self.tokenizer.to_json())
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(self.get_params(), f)
        with open(os.path.join(path, "params.pkl"), "wb") as f:
            pickle.dump(self.params_, f)

    @staticmethod
    def load(path: str, device="cuda") -> "BertClassifier":
        import pickle

        from bbbp_tpu_torch.models.convert import load_flax
        from bbbp_tpu_torch.ops.forest_train import resolve_device

        with open(os.path.join(path, "config.json")) as f:
            cfg = json.load(f)
        clf = BertClassifier(**cfg, device=device)
        with open(os.path.join(path, "tokenizer.json")) as f:
            tok_cls = NumberStringTokenizer if cfg["input_mode"] == "compat_vector" \
                else SmilesTokenizer
            clf.tokenizer = tok_cls.from_json(f.read())
        with open(os.path.join(path, "params.pkl"), "rb") as f:
            params = pickle.load(f)
        clf.model = load_flax(clf._encoder(resolve_device(device)), params)
        return clf
