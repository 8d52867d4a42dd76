"""Virtual screening on one CUDA card: SMILES stream → packed fingerprints →
projection kernel → forest kernel → probability → results CSV.

Counterpart of ``bbbp_tpu/pipelines/screen.py``. The same three-stage thread
pipeline overlaps host and device: the C++ featurizer fills chunks (the GIL
is released while it runs), dispatcher threads pad each chunk in pinned host
memory and copy it to the device on their own CUDA stream, where both
kernels run, and the drain waits on each chunk's event, puts chunks back in
input order and writes the CSV.

Run: ``python -m bbbp_tpu_torch.pipelines.screen in.smi --model m.pkl``.
The model pickle is the JAX package's format; either package reads what the
other writes. Training the model is not ported yet.
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
from typing import Callable, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from bbbp_tpu_torch.data.zinc import chunked, iter_smi_dir, iter_smi_file
from bbbp_tpu_torch.native.bindings import fingerprints, fingerprints_packed
from bbbp_tpu_torch.ops.bitops import packed_project, project_weights
from bbbp_tpu_torch.ops.forest import DenseTreeEnsemble, raw_predict

PACKED_KINDS = ("morgan", "rdkit")
DENSE_KINDS = ("maccs",)


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
    """Dense path (maccs): standardize → PCA as a plain matmul → forest
    kernel with the sigmoid in its epilogue."""
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
    """(packed?, fn(smiles) → (features, bad indices)) for the model's kind."""
    threads = workers or 0
    if model.fp_kind in PACKED_KINDS:
        return True, lambda smiles: fingerprints_packed(
            smiles, model.fp_kind, model.n_bits, threads=threads)
    if model.fp_kind in DENSE_KINDS:
        return False, lambda smiles: fingerprints(
            smiles, model.fp_kind, model.n_bits, threads=threads)
    raise NotImplementedError(
        f"fingerprint kind {model.fp_kind!r} needs the Python featurizer, "
        "which the port has not carried over yet (ROADMAP.md, queue 1: "
        "'Featurizer kinds outside the C++ library')")


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


def screen(model: ScreeningModel, smiles_iter: Iterable[Tuple[str, str]],
           out_csv: Optional[str] = "virtual_screening_results.csv",
           chunk_size: int = 8192, workers: Optional[int] = None,
           pipeline_depth: int = 3, dispatch_workers: int = 2,
           device: Union[str, torch.device] = "cuda") -> ScreenStats:
    """Screen (smiles, id) pairs through a featurize → dispatch → drain
    thread pipeline; each stage hands off through a queue bounded by
    ``pipeline_depth``.

    ``dispatch_workers`` threads pad chunks and launch the device work, each
    on its own CUDA stream, so one chunk's copy overlaps another's kernels.
    The drain re-orders chunks by sequence number, so the CSV stays in input
    order. ``workers`` is the featurizer's thread count (0 or None: all
    cores). On ``device="cpu"`` the kernels' plain versions run instead.

    Raises ScreenBackendError (with the failing chunk index) when waiting
    for a chunk's result fails, after unblocking every pipeline thread."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("screen(device='cuda') needs a CUDA device, and "
                           "torch sees none")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"screen runs on cpu or cuda, not {device}")
    packed_mode, featurize = _featurizer(model, workers)
    if model.device != device:
        model = model.to(device)
    run = (_make_packed_device_fn(model) if packed_mode
           else _make_device_fn(model))
    on_cuda = device.type == "cuda"
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
        """Pad into (pinned) host memory → H2D → both kernels → D2H into
        pinned memory → record an event, all on this thread's stream; the
        queue item keeps every tensor of the chunk alive until the drain
        has waited on the event."""
        dt = 0.0
        stream = torch.cuda.Stream(device) if on_cuda else None
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
                if stream is None:
                    out, done, held = run(host), None, ()
                else:
                    with torch.cuda.stream(stream):
                        x = host.to(device, non_blocking=True)
                        proba = run(x)
                        out = torch.empty(proba.shape, dtype=proba.dtype,
                                          pin_memory=True)
                        out.copy_(proba, non_blocking=True)
                        done = torch.cuda.Event()
                        done.record(stream)
                    held = (host, x, proba)
                dt += time.time() - t0
                q_dev.put((seq, smiles, ids, bad, out, done, held))
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
                seq, smiles, ids, bad, out, done, _held = item
                t0 = time.time()
                try:
                    if done is not None:
                        done.synchronize()
                    proba = np.asarray(out)
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


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Virtual screening on a CUDA device")
    ap.add_argument("input", help=".smi file or directory of tranches")
    ap.add_argument("--model", required=True,
                    help="ScreeningModel pickle, written by either package")
    ap.add_argument("--out", default="virtual_screening_results.csv")
    ap.add_argument("--chunk-size", type=int, default=8192)
    ap.add_argument("--workers", type=int, default=None,
                    help="featurizer threads (default: all cores)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    model = ScreeningModel.load(args.model)
    it = (iter_smi_dir(args.input) if os.path.isdir(args.input)
          else iter_smi_file(args.input))
    stats = screen(model, it, out_csv=args.out, chunk_size=args.chunk_size,
                   workers=args.workers, device=args.device)
    print(f"screened {stats.n_molecules} molecules "
          f"({stats.n_invalid} invalid) in {stats.wall_s:.1f}s "
          f"= {stats.mol_per_s:.0f} mol/s on {args.device} → {args.out}")


if __name__ == "__main__":
    main()
