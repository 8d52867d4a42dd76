"""Supervised pretraining of the regression NN legs on the aux
classification set (representation transfer): the counterpart of
``bbbp_tpu/train/aux_pretrain.py``.

Train the SAME architectures used by the regression legs
(``models/gnn.py::MPNNRegressor``, ``models/transformer_cnn.py::
MultiModalRegressor``) as binary BBB+/- classifiers on the leak-screened aux
molecules (``train/transfer.py::aux_classification_set`` — no regression
molecule is ever seen), then warm-start the regression fold training from
the learned trunk (``train_cv(warm_start=...)`` sets every matching
parameter in every fold; the output head is dropped so each fold keeps its
random regression head). A validation holdout AUC is reported so the
pretraining quality is measured, not asserted.

One model (K = 1) on ``device``: sigmoid BCE, AdamW (``weight_decay``)
under optax's warmup-cosine schedule, batches from numpy's
``default_rng(seed)`` as the JAX package draws them, the initial
parameters and dropout from a ``torch.Generator``. The artifact is the JAX
package's: a pickle of {"params": a flax-layout numpy tree, "auc",
"config"}, so either package's ``load_warm_start`` reads either's.

The cache (``cache_dir`` or ``$BBBP_TRANSFER_CACHE``) is keyed by the
config and the device's type, under a prefix of its own: a cpu call never
reads a trunk trained on the card (another training trajectory, not an
ulp), nor a file of the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import re
import tempfile
import time
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from bbbp_tpu_torch.ops.forest_train import resolve_device
from bbbp_tpu_torch.train.transfer import aux_classification_set


@dataclass
class AuxPretrainConfig:
    kind: str = "graph"             # graph | multimodal
    epochs: int = 30
    batch_size: int = 64
    lr: float = 5e-4
    weight_decay: float = 1e-5
    val_frac: float = 0.1
    seed: int = 17
    # graph leg shape (must match RegressionTrainConfig.graph_*)
    max_atoms: int = 128
    graph_hidden: int = 192
    graph_layers: int = 5
    # multimodal leg shape (must match the regression NN config)
    fp_dim: int = 198               # maccs 167 + 31 descriptors
    nn_layers: int = 4
    fusion: str = "multihead"
    fp_tokens: int = 1
    image_size: int = 128
    cache_dir: Optional[str] = None  # also via BBBP_TRANSFER_CACHE


def _cache_path(cfg: AuxPretrainConfig, device: Union[str, torch.device]
                ) -> Optional[str]:
    """The cache file of ``cfg`` trained on ``device``: the JAX package's
    key over the config, with the device's type (``cpu`` or ``cuda``) in
    it, under the prefix ``aux_pretrained_torch_``."""
    d = cfg.cache_dir or os.environ.get("BBBP_TRANSFER_CACHE")
    if not d:
        return None
    dev = torch.device(device).type
    key = hashlib.sha1((repr(sorted(dataclasses.asdict(cfg).items()))
                        + f"|device={dev}").encode()).hexdigest()[:16]
    return os.path.join(d, f"aux_pretrained_torch_{cfg.kind}_{key}.pkl")


def drop_output_dense(params: dict) -> dict:
    """Remove the highest-numbered top-level anonymous ``Dense_k`` (the
    output layer in both MPNNRegressor and MultiModalRegressor) so the
    warm-started regression folds keep their random regression head."""
    dense = [(int(m.group(1)), k) for k in params
             for m in [re.match(r"Dense_(\d+)$", k)] if m]
    if not dense:
        return params
    _, drop = max(dense)
    return {k: v for k, v in params.items() if k != drop}


def _fit_binary(model, inputs, y, cfg: AuxPretrainConfig, verbose: bool,
                device: Union[str, torch.device] = "cuda"):
    """Fit one port model of ``model``'s definition (``type(model)(**
    model.config)``, initialised from ``cfg.seed``) with sigmoid BCE on
    (inputs, y); returns (flax-layout numpy params, holdout AUC). The whole
    dataset lives on the device; each step gathers its rows there."""
    from bbbp_tpu_torch.models.convert import flax_from_params
    from bbbp_tpu_torch.train.loop import AdamW, _device_dtype, warmup_cosine
    from bbbp_tpu_torch.train.transfer import _auc

    dev = resolve_device(device)
    n = len(y)
    rng = np.random.default_rng(cfg.seed)
    perm = rng.permutation(n)
    n_val = int(round(cfg.val_frac * n))
    val_idx, tr_idx = perm[:n_val], perm[n_val:]

    inputs_d = tuple(torch.as_tensor(np.asarray(a)).to(dev, _device_dtype(a))
                     for a in inputs)
    y_d = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    bs = min(cfg.batch_size, len(tr_idx))
    steps = max(1, len(tr_idx) // bs)
    total = cfg.epochs * steps
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    net = type(model)(**model.config, folds=1, device=dev, generator=gen)
    params = list(net.parameters())
    opt = AdamW(params, cfg.lr, weight_decay=cfg.weight_decay,
                schedule=warmup_cosine(max(1, total // 20), max(2, total)))

    loss = torch.tensor(float("nan"))
    for epoch in range(cfg.epochs):
        ep_perm = rng.permutation(len(tr_idx))[: steps * bs]
        order = torch.as_tensor(tr_idx[ep_perm].reshape(steps, bs), device=dev)
        t_ep = time.time()
        for s in range(steps):
            idx = order[s]
            logits = net(*(a[idx] for a in inputs_d), train=True, generator=gen)
            loss = F.binary_cross_entropy_with_logits(logits, y_d[idx])
            opt.step(torch.autograd.grad(loss, params))
        if verbose and ((epoch + 1) % 5 == 0 or epoch == cfg.epochs - 1):
            print(f"[aux-pretrain] epoch {epoch+1}/{cfg.epochs} "
                  f"bce={float(loss):.4f} ({time.time()-t_ep:.1f}s)",
                  flush=True)
    with torch.no_grad():
        idx = torch.as_tensor(val_idx, device=dev)
        logits_val = net(*(a[idx] for a in inputs_d)).float().cpu().numpy()
    auc = _auc(np.asarray(y)[val_idx], logits_val)
    if verbose:
        print(f"[aux-pretrain] holdout AUC={auc:.4f} ({n_val} molecules)")
    return flax_from_params(net), float(auc)


def _aux_images(smiles, size, cache_dir):
    from bbbp_tpu_torch.chem.featurize import images

    cpath = None
    if cache_dir:
        key = hashlib.sha1(("img%d\n" % size + "\n".join(smiles)).encode()
                           ).hexdigest()[:16]
        cpath = os.path.join(cache_dir, f"auximg_{key}.npz")
        if os.path.exists(cpath):
            z = np.load(cpath)
            return z["img"], z["ok"]
    res = images(smiles, size=size)
    img = res.features.astype(np.float32)
    ok = res.ok_mask
    if cpath:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez_compressed(cpath, img=img, ok=ok)
    return img, ok


def pretrain_aux(cfg: AuxPretrainConfig = AuxPretrainConfig(),
                 verbose: bool = True,
                 device: Union[str, torch.device] = "cuda") -> str:
    """Pretrain on the aux set on ``device``; returns the saved artifact
    path (pickle with {"params", "auc", "config"}). Cached by config and
    device (module doc); without a cache directory the pickle goes to the
    temporary directory."""
    dev = resolve_device(device)
    cpath = _cache_path(cfg, dev)
    if cpath and os.path.exists(cpath):
        return cpath
    t0 = time.time()
    cache_dir = cfg.cache_dir or os.environ.get("BBBP_TRANSFER_CACHE")
    aux_smiles, aux_y, _ = aux_classification_set(verbose=verbose)
    if cfg.kind == "graph":
        from bbbp_tpu_torch.chem.graph_features import graph_features
        from bbbp_tpu_torch.models.gnn import MPNNRegressor

        feats, _, adj_t, mask, bad = graph_features(
            aux_smiles, max_atoms=cfg.max_atoms, edge_types=True)
        ok = np.ones(len(aux_smiles), bool)
        ok[list(bad)] = False
        inputs = (feats[ok], adj_t[ok], mask[ok])
        yv = aux_y[ok]
        model = MPNNRegressor(feats.shape[-1], hidden=cfg.graph_hidden,
                              n_layers=cfg.graph_layers)
    elif cfg.kind == "multimodal":
        from bbbp_tpu_torch.models.transformer_cnn import MultiModalRegressor
        from bbbp_tpu_torch.ops.scaler import StandardScaler
        from bbbp_tpu_torch.train.transfer import raw_transfer_features

        desc, maccs, _ = raw_transfer_features(aux_smiles, cache_dir=cache_dir)
        img, ok = _aux_images(aux_smiles, cfg.image_size, cache_dir)
        fp = np.concatenate([maccs.astype(np.float32), desc], axis=1)
        if fp.shape[1] != cfg.fp_dim:
            raise ValueError(f"aux fp dim {fp.shape[1]} != cfg.fp_dim "
                             f"{cfg.fp_dim} (regression leg shape mismatch)")
        with torch.no_grad():
            fp = StandardScaler().fit_transform(
                torch.as_tensor(fp[ok], device=dev)).cpu().numpy()
            img_n = StandardScaler().fit_transform(torch.as_tensor(
                img[ok].reshape(ok.sum(), -1), device=dev)).cpu().numpy()
        img_n = img_n.reshape(ok.sum(), cfg.image_size, cfg.image_size, 3)
        inputs = (fp, img_n)
        yv = aux_y[ok]
        model = MultiModalRegressor(fp_dim=cfg.fp_dim, n_layers=cfg.nn_layers,
                                    fusion=cfg.fusion, fp_tokens=cfg.fp_tokens,
                                    image_size=cfg.image_size)
    else:
        raise ValueError(f"unknown kind {cfg.kind!r}")
    if verbose:
        print(f"[aux-pretrain] {cfg.kind}: {len(yv)} molecules "
              f"({time.time()-t0:.0f}s featurize) on {dev}", flush=True)
    params, auc = _fit_binary(model, inputs, yv, cfg, verbose, dev)
    out = cpath or os.path.join(tempfile.gettempdir(),
                                f"aux_pretrained_torch_{cfg.kind}.pkl")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "wb") as f:
        pickle.dump({"params": params, "auc": auc,
                     "config": dataclasses.asdict(cfg)}, f)
    if verbose:
        print(f"[aux-pretrain] saved {out} ({time.time()-t0:.0f}s total)")
    return out


def load_warm_start(path: str, drop_output: bool = True) -> Tuple[dict, float]:
    """(warm-start params pytree, pretraining holdout AUC)."""
    with open(path, "rb") as f:
        d = pickle.load(f)
    params = dict(d["params"])
    if drop_output:
        params = drop_output_dense(params)
    return params, float(d.get("auc", float("nan")))
