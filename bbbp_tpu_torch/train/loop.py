"""K-fold neural-net training with the fold axis as a batched dimension: the
counterpart of ``bbbp_tpu/train/loop.py``.

All folds (× seed replicas, K in all) train at once. The reference stacks
K copies of the parameters with ``jax.vmap`` and runs an epoch as one
``lax.scan``; here the model itself carries the fold axis
(``models/fold.py``: every parameter is [K, ...], a dense layer is one
batched product, a convolution one call a fold), and an epoch is a Python
loop of steps. A step gathers each fold's batch on the device
([K, B, ...] from the inputs, which live on the device once), runs one
forward and one backward for all folds (the loss is the sum of the folds'
mean squared errors, so each fold's gradient is its own), and makes one
AdamW update.

``AdamW`` keeps every fold's parameters in one f32 buffer [K, P] and its
moments beside it, so the update is a few elementwise passes whatever the
model, with the learning rate and weight decay as [K] columns. The seed
replicas' own ``learning_rate`` / ``weight_decay`` (``replica_hparams``, the
JAX package's ``optax.inject_hyperparams``) are those columns; there is no
second path.

The folds, the batches of each epoch and the bookkeeping (OOF predictions,
snapshots, early stopping) are the reference's, drawn from numpy's
``default_rng`` in the same order. The initial parameters and the dropout
masks come from one ``torch.Generator`` seeded with ``seed``, so they are
not ``jax.random``'s. The reference recomputes the forward in the backward
(``jax.checkpoint``); the port keeps the activations, which fit the card.

A model with BatchNorm (``models/mlp.py``) keeps its running statistics as
[K, d] buffers, flax's ``batch_stats``: each fold's move with its own
batches in the step's forward, outside AdamW's buffer; evaluation reads
them, early stopping keeps each fold's best beside its best parameters,
and ``CVResult.batch_stats`` returns them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from bbbp_tpu_torch.models.convert import matching_params
from bbbp_tpu_torch.models.fold import FoldBlock, keep_fold_block
from bbbp_tpu_torch.ops.forest_train import resolve_device
from bbbp_tpu_torch.parallel.mesh import fold_block, gather_folds

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
RESTARTS = 64                        # make_optimizer's cosine cycles


@dataclass
class CVResult:
    oof_pred: np.ndarray          # [N] out-of-fold predictions
    fold_of: np.ndarray           # [N] fold id per sample
    params: Any                   # {name: [K, ...] tensor} (leading fold axis)
    batch_stats: Any              # {name: [K, d] tensor}: running statistics
    train_losses: np.ndarray      # [K, epochs]
    fold_test_idx: list           # list of K index arrays
    oof_seeds: Optional[np.ndarray] = None   # [n_seeds, N] per-replica OOF
                                  # (the replica axis doubles as a TRIAL axis
                                  # for hyperparameter search — see
                                  # replica_hparams in train_cv)


def kfold_indices(n: int, k: int, seed: int = 42) -> list:
    """Shuffled K-fold split (reference: KFold(10, shuffle=True, random_state=42))."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [perm[i::k] for i in range(k)]


def _padded_train_sets(n: int, folds: list) -> Tuple[np.ndarray, int]:
    """[K, S] train-index matrix; folds padded to equal size by wrapping."""
    sets = []
    for i in range(len(folds)):
        tr = np.concatenate([folds[j] for j in range(len(folds)) if j != i])
        sets.append(tr)
    s = max(len(t) for t in sets)
    out = np.stack([np.resize(t, s) for t in sets])
    return out, s


def cosine_restarts(period: int):
    """``make_optimizer``'s schedule as a factor of the learning rate at
    step t (0-based): 64 cosine decays of ``period`` steps each
    (``optax.join_schedules`` of ``cosine_decay_schedule``), 0 after the
    last."""
    def factor(t: int) -> float:
        cycle = min(t // period, RESTARTS - 1)
        s = min(t - cycle * period, period)
        return 0.5 * (1.0 + math.cos(math.pi * s / period))
    return factor


def warmup_cosine(warmup_steps: int, decay_steps: int):
    """``optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps)`` as a factor of the peak at step t (0-based): a linear
    rise from 0 over ``warmup_steps``, then a cosine decay to 0 over the
    remaining ``decay_steps − warmup_steps``, 0 after. Shared by MLM
    pretraining, aux pretraining and ``BertClassifier``."""
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps "
                         f"{warmup_steps}")

    def factor(t: int) -> float:
        if t < warmup_steps:
            return t / warmup_steps
        c = min(t - warmup_steps, span)
        return 0.5 * (1.0 + math.cos(math.pi * c / span))
    return factor


def _bias_correction(decay: float, count: int) -> float:
    """1 − decay^count as optax computes it: in f32, from decay rounded to
    f32 (1 − f32(0.999) is 0.00099998713, not the 0.001 of the moment's
    update, so optax's second moment comes out 1.3e-5 larger at step 1)."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class AdamW:
    """``optax.adamw`` over parameters that carry a leading fold axis of K:
    Adam (b1 0.9, b2 0.999, eps 1e-8 added outside the square root) with
    the decay ``weight_decay · p`` added to the update before it is scaled
    by the learning rate.

    The parameters move into one f32 buffer ``flat`` [K, P]; each becomes a
    view of its columns, so an update of ``flat`` is an update of the
    model. ``lr`` and ``weight_decay`` are numbers or [K] tensors (one value
    a fold); ``schedule`` (a factor of ``lr`` at step t, counted from 0 as
    optax counts: ``cosine_restarts``, ``warmup_cosine``) scales ``lr`` at
    each step. ``weight_decay`` 0 is ``optax.adam``."""

    def __init__(self, params: Sequence[torch.nn.Parameter],
                 lr: Union[float, torch.Tensor] = 1e-4,
                 weight_decay: Union[float, torch.Tensor] = 1e-5,
                 schedule: Optional[Callable[[int], float]] = None):
        self.params = list(params)
        k = self.params[0].shape[0]
        dev = self.params[0].device
        with torch.no_grad():
            self.flat = torch.cat([p.detach().reshape(k, -1).float()
                                   for p in self.params], dim=1)
            off = 0
            for p in self.params:
                n = p[0].numel()
                p.data = self.flat[:, off:off + n].view(p.shape)
                off += n
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = 0

        def column(v):
            return torch.as_tensor(v, dtype=torch.float32, device=dev
                                   ).expand(k).reshape(k, 1).clone()

        self.lr, self.weight_decay = column(lr), column(weight_decay)
        self.schedule = schedule

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update from ``grads``, one a parameter, in order."""
        k = self.flat.shape[0]
        g = torch.cat([gr.reshape(k, -1) for gr in grads], dim=1)
        lr = self.lr if self.schedule is None else self.lr * self.schedule(self.count)
        self.count += 1
        self.mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
        self.nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
        u = self.mu / _bias_correction(ADAM_B1, self.count)
        denom = (self.nu / _bias_correction(ADAM_B2, self.count)
                 ).sqrt_().add_(ADAM_EPS)
        u.div_(denom).addcmul_(self.flat, self.weight_decay)
        self.flat.addcmul_(u, lr, value=-1.0)


def make_optimizer(lr: float = 1e-4, weight_decay: float = 1e-5,
                   warm_restart_period: int = 0):
    """AdamW(1e-4, wd=1e-5) like the reference (:178), with optional cosine
    warm restarts (reference B1 uses CosineAnnealingWarmRestarts,
    Models/multi_input_data_regression_opt.py:109-124). Returns the
    optimizer unbound: call it with the parameters."""
    def bind(params: Sequence[torch.nn.Parameter]) -> AdamW:
        return AdamW(params, lr, weight_decay, schedule=(
            cosine_restarts(warm_restart_period) if warm_restart_period > 0
            else None))
    return bind


def _device_dtype(a: np.ndarray) -> torch.dtype:
    if np.issubdtype(np.asarray(a).dtype, np.integer):
        return torch.int32                      # token ids etc.
    return torch.bfloat16 if np.ndim(a) >= 3 else torch.float32


class FoldTrainer:
    """The state of ``train_cv``: K models of ``model``'s definition
    (``type(model)(**model.config, folds=K)``, initialised from ``seed``;
    ``model``'s own parameters are not read), the inputs on the device, and
    the optimizer. ``fold_affine``: per input None or (shift [K, ...],
    scale [K, ...]) applied as (x − shift) · scale to fold k's rows.
    ``block`` (start, stop): this trainer keeps folds [start, stop) of the
    K, drawing their init and dropout as a trainer of all K would."""

    def __init__(self, model, inputs: Sequence[np.ndarray], y: np.ndarray, k: int,
                 device: torch.device, seed: int = 42,
                 lr: Union[float, torch.Tensor] = 1e-4,
                 weight_decay: Union[float, torch.Tensor] = 1e-5,
                 fold_affine=None, warm_start=None, block=None):
        start, stop = block or (0, k)
        self.k, self.device = stop - start, device
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.net = type(model)(**model.config, folds=k, device=device,
                               generator=self.generator)
        if warm_start is not None:
            with torch.no_grad():
                for name, value in matching_params(self.net, warm_start).items():
                    self.net.get_parameter(name).copy_(value)
        self.draws = self.generator
        if block is not None:
            # the K folds' init and dropout draws, this block's rows of them
            keep_fold_block(self.net, start, stop)
            self.draws = FoldBlock(self.generator, k, start, stop)
            lr, weight_decay = (v[start:stop] if isinstance(v, torch.Tensor) else v
                                for v in (lr, weight_decay))
            if fold_affine is not None:
                fold_affine = tuple(None if fa is None else
                                    tuple(np.asarray(v)[start:stop] for v in fa)
                                    for fa in fold_affine)
        self.params = list(self.net.parameters())
        self.opt = AdamW(self.params, lr, weight_decay)
        self.inputs = tuple(torch.as_tensor(np.asarray(a)).to(device, _device_dtype(a))
                            for a in inputs)
        self.y = torch.as_tensor(np.asarray(y, np.float32), device=device)
        self.n = len(y)
        self.affine = None if fold_affine is None else tuple(
            None if fa is None else tuple(
                torch.as_tensor(np.asarray(v)).to(device, self.inputs[i].dtype)
                for v in fa)
            for i, fa in enumerate(fold_affine))

    def _batch(self, rows: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
        """[K, B, ...] per input, with each fold's affine applied."""
        if self.affine is None:
            return rows
        return tuple(b if a is None else
                     (b - a[0].unsqueeze(1)) * a[1].unsqueeze(1)
                     for b, a in zip(rows, self.affine))

    def step(self, idx: torch.Tensor) -> torch.Tensor:
        """One update of every fold on its rows ``idx`` [K, B]; the folds'
        losses [K] (on the device)."""
        batch = self._batch(tuple(a[idx] for a in self.inputs))
        pred = self.net(*batch, train=True, generator=self.draws)
        loss = ((pred - self.y[idx]) ** 2).mean(dim=1)
        grads = torch.autograd.grad(loss.sum(), self.params)
        self.opt.step(grads)
        return loss.detach()

    def train_epoch(self, perms: np.ndarray) -> np.ndarray:
        """The steps of ``perms`` [K, steps, B] in order; each fold's mean
        loss over them."""
        idx = torch.as_tensor(perms, dtype=torch.int64).to(self.device)
        total = torch.zeros(self.k, device=self.device)
        for s in range(idx.shape[1]):
            total += self.step(idx[:, s])
        return (total / idx.shape[1]).cpu().numpy()

    @torch.no_grad()
    def predict_all(self) -> torch.Tensor:
        """Every fold's predictions of every row, [K, N], in chunks of
        ``max(32, 4096 // K)`` rows, so that K × chunk stays near constant."""
        chunk = max(32, 4096 // self.k)
        outs = []
        for start in range(0, self.n, chunk):
            rows = tuple(a[start:start + chunk].expand(self.k, -1, *a.shape[1:])
                         for a in self.inputs)
            outs.append(self.net(*self._batch(rows), train=False))
        return torch.cat(outs, dim=1)

    @torch.no_grad()
    def val_losses(self, val_idx: torch.Tensor) -> np.ndarray:
        """Each fold's mean squared error on its rows ``val_idx`` [K, V]."""
        pred = self.net(*self._batch(tuple(a[val_idx] for a in self.inputs)),
                        train=False)
        return ((pred - self.y[val_idx]) ** 2).mean(dim=1).cpu().numpy()

    def state(self) -> Dict[str, torch.Tensor]:
        return {name: p.detach().clone() for name, p in self.net.named_parameters()}

    def stats(self) -> Dict[str, torch.Tensor]:
        """The running statistics ([K, d] buffers: BatchNorm's ``mean`` and
        ``var``, flax's ``batch_stats``), copied; {} for a model without."""
        return {name: b.clone() for name, b in self.net.named_buffers()}

    def keep_stats(self, best: Dict[str, torch.Tensor], keep: torch.Tensor) -> None:
        """``best[name]`` ← the current statistics in the folds where
        ``keep`` [K, 1] is True."""
        for name, b in self.net.named_buffers():
            best[name].copy_(torch.where(keep, b, best[name]))

    def set_stats(self, stats: Dict[str, torch.Tensor]) -> None:
        for name, b in self.net.named_buffers():
            b.copy_(stats[name])


def train_cv(
    model,
    inputs,
    y: np.ndarray,
    n_folds: int = 10,
    epochs: int = 50,
    batch_size: int = 32,
    lr: float = 1e-4,
    weight_decay: float = 1e-5,
    seed: int = 42,
    mesh=None,
    log_every: int = 0,
    n_seeds: int = 1,
    snapshot_from: Optional[int] = None,
    split_seed: Optional[int] = None,
    patience: Optional[int] = None,
    val_frac: float = 0.1,
    fold_affine=None,
    warm_start=None,
    replica_hparams: Optional[Dict[str, np.ndarray]] = None,
    device: Union[str, torch.device] = "cuda",
) -> CVResult:
    """Train ``model(*inputs, train=)`` on all folds at once; return OOF
    predictions. ``model`` is a port model (``models/``) that gives the
    definition; K = ``n_folds`` × ``n_seeds`` copies of it are trained.

    inputs: tuple of [N, ...] arrays (e.g. (fp, img) for the multimodal
    model); y: [N] float32. They go to ``device`` once: integer arrays as
    int32, arrays of three or more axes as bf16, the rest as f32.

    ``n_seeds`` replicates every fold with independent inits on the same
    batched axis (OOF = seed-average); ``snapshot_from`` additionally
    averages end-of-epoch prediction snapshots from that epoch onward.

    ``patience``: each fold carves ``val_frac`` of its own train split as a
    validation set, keeps its best parameters and running statistics
    (improved = val loss < best − 1e-5), and training stops when every fold
    has gone ``patience`` epochs without improving. Final predictions use
    each fold's best parameters and statistics.

    ``fold_affine``: optional tuple of per-input, per-fold (shift [K, ...],
    scale [K, ...]) pairs (entries may be None); applied as (x - shift) *
    scale inside the step.

    ``warm_start``: optional flax params tree WITHOUT a fold axis (nested
    dicts of arrays). Every parameter whose flax leaves match it in path and
    shape is set to it in every fold (``models/convert.matching_params``);
    the others keep their random init.

    ``replica_hparams``: optional dict of per-replica ``learning_rate`` /
    ``weight_decay``, each a length-``n_seeds`` (or length-K) float array;
    replica r of fold i is row r·n_folds + i.

    ``mesh`` (``parallel/mesh.py::make_mesh``, this process one rank of it):
    the K folds shard over its ``data`` axis. Data-rank r trains the
    contiguous block [r·K/dp, (r+1)·K/dp), drawing its folds' init and
    dropout as a run of all K does, and the losses, predictions and final
    parameters are all-gathered, so every rank returns what one process
    training all K returns. Where K is no multiple of the data axis every
    rank trains all K, and says so."""
    dev = resolve_device(device)
    n = len(y)
    folds = kfold_indices(n, n_folds, split_seed if split_seed is not None else seed)
    base_train_idx, s0 = _padded_train_sets(n, folds)          # [F, S]
    val_idx = None
    if patience is not None:
        # carve a per-fold validation block from the END of each train set
        # (train sets are permutation-ordered, so this is a random subset)
        n_val = max(8, int(s0 * val_frac))
        val_idx = base_train_idx[:, s0 - n_val:]               # [F, n_val]
        base_train_idx = base_train_idx[:, : s0 - n_val]
        val_idx = np.concatenate([val_idx] * n_seeds, axis=0)  # [K, n_val]
    s = base_train_idx.shape[1]
    # replicate folds across seeds along the same batched axis
    train_idx = np.concatenate([base_train_idx] * n_seeds, axis=0)  # [K, S]
    k = n_folds * n_seeds
    steps = s // batch_size

    hparams = {"learning_rate": np.full(k, lr, np.float32),
               "weight_decay": np.full(k, weight_decay, np.float32)}
    for name, v in (replica_hparams or {}).items():
        if name not in hparams:
            raise ValueError(f"replica_hparams takes learning_rate and "
                             f"weight_decay, not {name!r}")
        v = np.asarray(v, np.float32)
        if v.shape == (n_seeds,):                 # one value per replica
            v = np.repeat(v, n_folds)             # row s*n_folds+i layout
        if v.shape != (k,):
            raise ValueError(f"replica_hparams[{name!r}] has shape {v.shape}, "
                             f"expected ({n_seeds},) or ({k},)")
        hparams[name] = v
    if fold_affine is not None:
        fold_affine = tuple(
            None if fa is None else tuple(
                np.concatenate([np.asarray(v)] * n_seeds, axis=0) for v in fa)
            for fa in fold_affine)
    block, group = None, None
    if mesh is not None:
        block = fold_block(k, mesh)
        if block is None:
            print(f"train_cv: {k} folds do not divide the mesh's data axis "
                  f"({mesh['data'].size()}): every rank trains all {k}")
        else:
            group = mesh.get_group("data")
    start, stop = block or (0, k)

    def gather(t: torch.Tensor) -> torch.Tensor:
        """[k_local, ...] → [K, ...] over the data axis."""
        return t if group is None else gather_folds(t, group)

    def gather_np(a: np.ndarray) -> np.ndarray:
        return gather(torch.as_tensor(a, device=dev)).cpu().numpy()

    trainer = FoldTrainer(
        model, inputs, y, k, dev, seed,
        lr=torch.from_numpy(hparams["learning_rate"]),
        weight_decay=torch.from_numpy(hparams["weight_decay"]),
        fold_affine=fold_affine, warm_start=warm_start, block=block)

    if patience is not None:
        val_idx_d = torch.as_tensor(val_idx[start:stop], dtype=torch.int64,
                                    device=dev)
        best_val = np.full(k, np.inf, np.float32)
        since_best = np.zeros(k, np.int32)
        best_flat = trainer.opt.flat.clone()
        best_stats = trainer.stats()

    host_rng = np.random.default_rng(seed)
    losses_hist = np.zeros((k, epochs), dtype=np.float32)
    snap_sum = torch.zeros((stop - start, n), dtype=torch.float32, device=dev)
    snap_count = 0
    for epoch in range(epochs):
        perms = np.stack([
            host_rng.permutation(train_idx[i])[: steps * batch_size]
            for i in range(k)
        ]).reshape(k, steps, batch_size)
        mean_loss = gather_np(trainer.train_epoch(perms[start:stop]))
        losses_hist[:, epoch] = mean_loss
        if patience is not None:
            vl = gather_np(trainer.val_losses(val_idx_d))
            improved = vl < best_val - 1e-5
            best_val = np.where(improved, vl, best_val)
            since_best = np.where(improved, 0, since_best + 1)
            keep = torch.as_tensor(improved[start:stop], device=dev).unsqueeze(1)
            best_flat.copy_(torch.where(keep, trainer.opt.flat, best_flat))
            trainer.keep_stats(best_stats, keep)
            if np.all(since_best >= patience):
                if log_every:
                    print(f"early stop at epoch {epoch+1} "
                          f"(patience {patience}; val/fold "
                          f"{best_val.round(4).tolist()})")
                break
        if snapshot_from is not None and epoch + 1 >= snapshot_from:
            snap_sum += trainer.predict_all()
            snap_count += 1
        if log_every and (epoch + 1) % log_every == 0:
            print(f"epoch {epoch+1}/{epochs} loss/fold: "
                  f"{mean_loss.round(4).tolist()}")

    if patience is not None:
        with torch.no_grad():
            trainer.opt.flat.copy_(best_flat)
            trainer.set_stats(best_stats)
    if snap_count:
        preds_kn = gather(snap_sum / snap_count).cpu().numpy()
    else:
        preds_kn = gather(trainer.predict_all()).cpu().numpy()
    # average over seed replicas: replica r of fold i sits at row r*n_folds+i
    preds_sn = preds_kn.reshape(n_seeds, n_folds, n)
    preds_fn = preds_sn.mean(axis=0)                                # [F, N]
    oof = np.zeros(n, dtype=np.float32)
    fold_of = np.zeros(n, dtype=np.int32)
    oof_seeds = np.zeros((n_seeds, n), dtype=np.float32)
    for i, te in enumerate(folds):
        oof[te] = preds_fn[i, te]
        oof_seeds[:, te] = preds_sn[:, i, te]
        fold_of[te] = i
    params = {name: gather(t) for name, t in trainer.state().items()}
    stats = {name: gather(t) for name, t in trainer.stats().items()}
    return CVResult(oof, fold_of, params, stats, losses_hist, folds,
                    oof_seeds=oof_seeds)


def train_multimodal_cv(model, fp, img, y, **kw) -> CVResult:
    """Back-compat wrapper: the (fingerprint, image) special case of train_cv."""
    return train_cv(model, (fp, img), y, **kw)
