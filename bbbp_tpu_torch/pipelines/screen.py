"""Virtual screening on one CUDA card or several: SMILES stream → packed
fingerprints → projection kernel → forest kernel → probability → results CSV.

Counterpart of ``bbbp_tpu/pipelines/screen.py``. The same three-stage thread
pipeline overlaps host and device: the C++ featurizer fills chunks (the GIL
is released while it runs), dispatcher threads pad each chunk in pinned host
memory and copy it to the device on their own CUDA stream, where both
kernels run, and the drain waits on each chunk's events, puts chunks back in
input order and writes the CSV. ``screen(devices=[...])`` splits each chunk
over several cards, as the JAX package's ``screen(mesh=...)`` does.

``ScreeningModel.train`` fits the model on the device: fingerprints on the
host, then the scaler, PCA and the boosted forest (``ops/forest_train.py``)
on the card, as ``bbbp_tpu/pipelines/screen.py::ScreeningModel.train``.

Run: ``python -m bbbp_tpu_torch.pipelines.screen in.smi --model m.pkl``;
without ``--model`` it trains the default model on B3DB classification
(``BBBP_B3DB_DIR``) first. The model pickle is the JAX package's format;
either package reads what the other writes.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import pickle
import threading
import time
from dataclasses import dataclass, field
from queue import Queue
from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from bbbp_tpu_torch.data.zinc import chunked, iter_smi_dir, iter_smi_file
from bbbp_tpu_torch.chem.featurize import FP_KINDS, fingerprints
from bbbp_tpu_torch.native.bindings import fingerprints_packed
from bbbp_tpu_torch.ops.bitops import packed_project, project_weights
from bbbp_tpu_torch.ops.forest import DenseTreeEnsemble, raw_predict
from bbbp_tpu_torch.ops.forest_train import GBDTClassifier, resolve_device
from bbbp_tpu_torch.ops.pca import PCA
from bbbp_tpu_torch.ops.scaler import StandardScaler

PACKED_KINDS = ("morgan", "rdkit")


@dataclass
class ScreeningModel:
    """Scaler + PCA + forest. The arrays stay numpy as the pickle holds them;
    ``device`` holds the folded projection W′, c0 and the tree tensors."""

    scaler_mean: np.ndarray
    scaler_scale: np.ndarray
    pca_mean: np.ndarray
    pca_components: np.ndarray        # [k, d]
    ensemble: DenseTreeEnsemble
    fp_kind: str = "morgan"
    n_bits: int = 2048
    threshold: float = 0.5
    device: Union[str, torch.device] = "cpu"
    proj_w: torch.Tensor = field(init=False, repr=False)    # [d, k]
    proj_c0: torch.Tensor = field(init=False, repr=False)   # [k]

    def __post_init__(self) -> None:
        self.device = torch.device(self.device)
        k = self.pca_components.shape[0]
        if self.ensemble.min_features > k:
            raise ValueError(f"the trees read feature {self.ensemble.min_features - 1}"
                             f" but PCA gives {k}")
        self.ensemble = self.ensemble.to(self.device)
        w, c0 = project_weights(self.scaler_mean, self.scaler_scale,
                                self.pca_mean, self.pca_components)
        self.proj_w = torch.from_numpy(w).to(self.device)
        self.proj_c0 = torch.from_numpy(c0).to(self.device)

    def to(self, device: Union[str, torch.device]) -> "ScreeningModel":
        return dataclasses.replace(self, device=device)

    @staticmethod
    def train(smiles: List[str], labels: np.ndarray, fp_kind: str = "morgan",
              n_bits: int = 2048, pca_dim: int = 30, n_estimators: int = 300,
              seed: int = 42, workers: Optional[int] = None,
              device: Union[str, torch.device] = "cuda") -> "ScreeningModel":
        """Fingerprints (host) → StandardScaler → PCA → GBDT classifier
        (300 trees of depth 6, lr 0.1, subsample 0.8, 64 quantile bins), the
        fits on ``device``. Molecules that fail to parse are left out."""
        device = resolve_device(device)
        fp = fingerprints(smiles, fp_kind, n_bits, workers=workers)
        ok = fp.ok_mask
        xt = torch.from_numpy(fp.features[ok]).to(device)
        scaler = StandardScaler().fit(xt)
        xs = scaler.transform(xt)
        pca = PCA(pca_dim).fit(xs)
        z = pca.transform(xs)
        clf = GBDTClassifier(n_estimators=n_estimators, learning_rate=0.1,
                             max_depth=6, subsample=0.8, seed=seed,
                             device=device).fit(z, np.asarray(labels)[ok])

        def host(t):
            return t.cpu().numpy()

        return ScreeningModel(host(scaler.mean_), host(scaler.scale_),
                              host(pca.mean_), host(pca.components_),
                              clf.ensemble_, fp_kind, n_bits, device=device)

    @staticmethod
    def from_state(s: dict) -> "ScreeningModel":
        """From the dict the screening pickle holds (on the CPU)."""
        return ScreeningModel(
            s["scaler_mean"], s["scaler_scale"], s["pca_mean"],
            s["pca_components"], DenseTreeEnsemble.from_state(s["ensemble"]),
            s["fp_kind"], s["n_bits"], s["threshold"])

    def to_state(self) -> dict:
        return {
            "scaler_mean": self.scaler_mean,
            "scaler_scale": self.scaler_scale,
            "pca_mean": self.pca_mean,
            "pca_components": self.pca_components,
            "fp_kind": self.fp_kind,
            "n_bits": self.n_bits,
            "threshold": self.threshold,
            "ensemble": self.ensemble.to_state(),
        }

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.to_state(), f)

    @staticmethod
    def load(path: str) -> "ScreeningModel":
        with open(path, "rb") as f:
            return ScreeningModel.from_state(pickle.load(f))


def _make_device_fn(model: ScreeningModel) -> Callable:
    """Dense path (every kind but morgan and rdkit): standardize → PCA as a
    plain matmul → forest kernel with the sigmoid in its epilogue."""
    def dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=model.device)

    sm, ss, pm = dev(model.scaler_mean), dev(model.scaler_scale), dev(model.pca_mean)
    pc = dev(model.pca_components).T                   # [d, k]
    ens = model.ensemble

    def run(fp_chunk):
        z = ((fp_chunk - sm) / ss - pm) @ pc
        return raw_predict(ens, z, apply_sigmoid=True)

    return run


def _make_packed_device_fn(model: ScreeningModel) -> Callable:
    """Packed path (morgan/rdkit): projection kernel → forest kernel."""
    w, c0, ens = model.proj_w, model.proj_c0, model.ensemble

    def run(packed_chunk):
        return raw_predict(ens, packed_project(packed_chunk, w, c0),
                           apply_sigmoid=True)

    return run


def _featurizer(model: ScreeningModel, workers: Optional[int]):
    """(packed?, fn(smiles) → (features, bad indices)) for the model's
    kind: packed words from C++ for morgan and rdkit, dense rows from C++
    for maccs and from the Python featurizer for the other kinds."""
    if model.fp_kind in PACKED_KINDS:
        return True, lambda smiles: fingerprints_packed(
            smiles, model.fp_kind, model.n_bits, threads=workers or 0)
    if model.fp_kind not in FP_KINDS:
        raise ValueError(f"unknown fingerprint kind {model.fp_kind!r}")

    def dense(smiles):
        fp = fingerprints(smiles, model.fp_kind, model.n_bits, workers=workers)
        return fp.features, fp.bad_indices
    return False, dense


class ScreenBackendError(RuntimeError):
    """The device failed while a chunk's result was awaited. Carries which
    chunk, so a supervisor can log or retry precisely."""

    def __init__(self, chunk_index: int, cause: BaseException):
        super().__init__(
            f"device failed on screening chunk {chunk_index}: {cause!r}")
        self.chunk_index = chunk_index


@dataclass
class ScreenStats:
    n_molecules: int
    n_invalid: int
    wall_s: float
    featurize_s: float
    device_s: float

    @property
    def mol_per_s(self) -> float:
        return self.n_molecules / max(self.wall_s, 1e-9)


def _shard_devices(device: Union[str, torch.device],
                   devices: Optional[Sequence[Union[str, torch.device]]]
                   ) -> List[torch.device]:
    """The card of each shard of a chunk: ``devices``, or ``[device]``.
    Raises on a device that is neither cpu nor cuda, on a list that mixes
    the two, and on a CUDA card that torch does not see; nothing falls
    back. ``cuda`` without an index is the current card."""
    listed = [torch.device(d) for d in ([device] if devices is None else devices)]
    if not listed:
        raise ValueError("devices must name at least one device")
    for d in listed:
        if d.type not in ("cpu", "cuda"):
            raise ValueError(f"screen runs on cpu or cuda, not {d}")
    kinds = {d.type for d in listed}
    if len(kinds) > 1:
        raise ValueError(f"devices mixes cpu and cuda: {listed}")
    if kinds == {"cpu"}:
        return listed
    if not torch.cuda.is_available():
        raise RuntimeError("screen(device='cuda') needs a CUDA device, and "
                           "torch sees none")
    cards = torch.cuda.device_count()
    out = [torch.device("cuda", torch.cuda.current_device() if d.index is None
                        else d.index) for d in listed]
    for d in out:
        if d.index >= cards:
            raise ValueError(f"{d}: torch sees {cards} CUDA device(s)")
    return out


def screen(model: ScreeningModel, smiles_iter: Iterable[Tuple[str, str]],
           out_csv: Optional[str] = "virtual_screening_results.csv",
           chunk_size: int = 8192, workers: Optional[int] = None,
           pipeline_depth: int = 3, dispatch_workers: int = 2,
           device: Union[str, torch.device] = "cuda",
           devices: Optional[Sequence[Union[str, torch.device]]] = None
           ) -> ScreenStats:
    """Screen (smiles, id) pairs through a featurize → dispatch → drain
    thread pipeline; each stage hands off through a queue bounded by
    ``pipeline_depth``.

    ``dispatch_workers`` threads pad chunks and launch the device work, each
    with its own CUDA stream on every card, so one chunk's copy overlaps
    another's kernels. The drain re-orders chunks by sequence number, so the
    CSV stays in input order. ``workers`` is the featurizer's thread count
    (0 or None: all cores). On ``device="cpu"`` the kernels' plain versions
    run instead.

    ``devices``: the JAX package's ``mesh`` (``screen(mesh=...)``, its
    'data' axis) in one process: each chunk's molecule axis is cut into
    ``len(devices)`` equal shards, shard i screened on ``devices[i]``, each
    card holding one replica of the model. A card may be listed more than
    once. Rows are independent, so the CSV does not depend on the shards.
    ``None`` is ``[device]``.

    Raises ScreenBackendError (with the failing chunk index) when a shard's
    device work or the wait for a chunk's result fails, after unblocking
    every pipeline thread."""
    devs = _shard_devices(device, devices)
    n_shards = len(devs)
    if chunk_size % n_shards != 0:
        raise ValueError("chunk_size must divide the mesh 'data' axis")
    rows = chunk_size // n_shards
    packed_mode, featurize = _featurizer(model, workers)
    cards = list(dict.fromkeys(devs))          # each distinct card, in order
    make = _make_packed_device_fn if packed_mode else _make_device_fn
    # one replica a card; a tensor's device names its card's index
    runs = {d: make(model if model.proj_w.device == d else model.to(d))
            for d in cards}
    on_cuda = devs[0].type == "cuda"
    t_start = time.time()
    feat_time = 0.0
    n_total = 0
    n_bad = 0
    n_disp = max(1, int(dispatch_workers))

    q_feat: Queue = Queue(maxsize=pipeline_depth)
    q_dev: Queue = Queue(maxsize=pipeline_depth + n_disp)
    _END = object()
    errors: List[BaseException] = []
    dev_times: List[float] = []        # one entry per dispatcher thread
    _time_lock = threading.Lock()

    def producer():
        nonlocal feat_time, n_bad
        try:
            for seq, chunk in enumerate(chunked(smiles_iter, chunk_size)):
                smiles = [c[0] for c in chunk]
                ids = [c[1] for c in chunk]
                t0 = time.time()
                feats, bad_list = featurize(smiles)
                feat_time += time.time() - t0
                n_bad += len(bad_list)
                q_feat.put((seq, smiles, ids, feats, bad_list))
        except BaseException as e:  # noqa: BLE001 — re-raised in main thread
            errors.append(e)
        finally:
            q_feat.put(_END)

    def dispatcher():
        """Pad the chunk into (pinned) host memory; then shard by shard, on
        this thread's stream of the shard's card: H2D from the shard's
        slice, both kernels, D2H into the shard's slice of the chunk's
        pinned output, an event. The queue item keeps every tensor of the
        chunk alive until the drain has waited on its events."""
        dt = 0.0
        streams = ({d: torch.cuda.Stream(d) for d in cards} if on_cuda
                   else None)
        try:
            while True:
                item = q_feat.get()
                if item is _END:
                    q_feat.put(_END)   # wake the sibling dispatchers too
                    break
                seq, smiles, ids, feats, bad = item
                t0 = time.time()
                src = torch.from_numpy(feats.view(np.int32) if packed_mode
                                       else feats)
                # fixed-size chunks let the pinned allocator reuse blocks
                host = torch.empty((chunk_size,) + tuple(src.shape[1:]),
                                   dtype=src.dtype, pin_memory=on_cuda)
                host[:len(src)].copy_(src)
                host[len(src):].zero_()
                try:
                    if streams is None:
                        outs = [runs[d](host[i * rows:(i + 1) * rows])
                                for i, d in enumerate(devs)]
                        done, held = [], ()
                    else:
                        out = torch.empty(chunk_size, dtype=torch.float32,
                                          pin_memory=True)
                        outs, done, held = [out], [], [host]
                        for i, d in enumerate(devs):
                            part = slice(i * rows, (i + 1) * rows)
                            with torch.cuda.device(d), torch.cuda.stream(streams[d]):
                                x = host[part].to(d, non_blocking=True)
                                proba = runs[d](x)
                                out[part].copy_(proba, non_blocking=True)
                                ev = torch.cuda.Event()
                                ev.record(streams[d])
                            done.append(ev)
                            held += [x, proba]
                except Exception as e:  # noqa: BLE001 — attributed to its chunk
                    raise ScreenBackendError(seq, e) from e
                dt += time.time() - t0
                q_dev.put((seq, smiles, ids, bad, outs, done, held))
        except BaseException as e:  # noqa: BLE001 — re-raised in main thread
            errors.append(e)
            # keep draining q_feat so the producer never blocks on a full
            # queue after this stage has died
            while True:
                item = q_feat.get()
                if item is _END:
                    q_feat.put(_END)
                    break
        finally:
            with _time_lock:
                dev_times.append(dt)
            q_dev.put(_END)

    threads = [threading.Thread(target=producer, daemon=True)]
    threads += [threading.Thread(target=dispatcher, daemon=True)
                for _ in range(n_disp)]
    for th in threads:
        th.start()

    def drain_all_ends(ends_seen: int) -> None:
        """Unblock every dispatcher (and so the producer) after a drain
        failure, so that no thread is left blocked."""
        while ends_seen < n_disp:
            if q_dev.get() is _END:
                ends_seen += 1

    fout = open(out_csv, "w", newline="") if out_csv else None
    try:
        writer = csv.writer(fout) if fout is not None else None
        if writer is not None:
            writer.writerow(["ID", "SMILES", "Prediction", "Probability"])

        def write_rows(smiles, ids, proba, bad):
            bad_set = set(int(b) for b in bad)
            writer.writerows(
                [sid, smi, "invalid", ""] if i in bad_set else
                [sid, smi, int(proba[i] > model.threshold), f"{proba[i]:.4f}"]
                for i, (sid, smi) in enumerate(zip(ids, smiles)))

        drain_time = 0.0
        ends = 0
        pending = {}
        next_seq = 0
        try:
            while ends < n_disp:
                item = q_dev.get()
                if item is _END:
                    ends += 1
                    continue
                seq, smiles, ids, bad, outs, done, _held = item
                t0 = time.time()
                try:
                    for ev in done:
                        ev.synchronize()
                    proba = np.concatenate([np.asarray(o) for o in outs])
                except Exception as e:  # noqa: BLE001 — classify + attribute
                    raise ScreenBackendError(seq, e) from e
                drain_time += time.time() - t0
                n_total += len(smiles)
                pending[seq] = (smiles, ids, proba, bad)
                while next_seq in pending:
                    s_, i_, p_, b_ = pending.pop(next_seq)
                    if writer is not None:
                        write_rows(s_, i_, p_, b_)
                    next_seq += 1
        except BaseException:
            drain_all_ends(ends)
            raise
        for th in threads:
            th.join()
    finally:
        if fout is not None:
            fout.close()
    if errors:
        raise errors[0]
    # dispatch time is concurrent across dispatchers: take the slowest lane
    # (the critical path) plus the drain's waits
    dev_time = (max(dev_times) if dev_times else 0.0) + drain_time
    return ScreenStats(n_total, n_bad, time.time() - t_start, feat_time, dev_time)


def train_default_model(workers: Optional[int] = None, seed: int = 42,
                        device: Union[str, torch.device] = "cuda"
                        ) -> ScreeningModel:
    """The default screening classifier trained on B3DB classification
    (BBB+ = 1; the TSV under ``BBBP_B3DB_DIR``)."""
    from bbbp_tpu_torch.data.b3db import load_b3db_classification

    data = load_b3db_classification()
    return ScreeningModel.train(data.smiles, data.labels, workers=workers,
                                seed=seed, device=device)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Virtual screening on a CUDA device")
    ap.add_argument("input", help=".smi file or directory of tranches")
    ap.add_argument("--model", default=None,
                    help="ScreeningModel pickle, written by either package; "
                         "without it the default model is trained on B3DB "
                         "classification ($BBBP_B3DB_DIR) on --device")
    ap.add_argument("--out", default="virtual_screening_results.csv")
    ap.add_argument("--chunk-size", type=int, default=8192)
    ap.add_argument("--workers", type=int, default=None,
                    help="featurizer threads (default: all cores)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.model:
        model = ScreeningModel.load(args.model)
    else:
        print(f"training the default B3DB screening model on {args.device}...")
        model = train_default_model(workers=args.workers, device=args.device)
    it = (iter_smi_dir(args.input) if os.path.isdir(args.input)
          else iter_smi_file(args.input))
    stats = screen(model, it, out_csv=args.out, chunk_size=args.chunk_size,
                   workers=args.workers, device=args.device)
    print(f"screened {stats.n_molecules} molecules "
          f"({stats.n_invalid} invalid) in {stats.wall_s:.1f}s "
          f"= {stats.mol_per_s:.0f} mol/s on {args.device} → {args.out}")


if __name__ == "__main__":
    main()
