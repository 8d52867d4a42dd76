"""Batch featurization: SMILES lists → fingerprint and descriptor matrices
and image tensors.

Counterpart of ``fingerprints()`` and ``images()`` in
``bbbp_tpu/chem/featurize.py``. The ``morgan``, ``rdkit`` and ``maccs``
kinds come from the C++ featurizer (``native/bindings.py``), the other
kinds from the Python code in a process pool. Invalid SMILES are quarantined: a zero row and a reported index.
``descriptors()`` runs ``descriptors.descriptor_matrix`` and ``images()``
runs ``depict.depict`` over the same pool.
This module imports numpy only, so a pool process starts quickly.

The pool's processes are spawned, not forked: the caller may hold a CUDA
context and the screening threads, neither of which survives a fork. The
children never touch the card. A script that featurizes through the pool
therefore needs the usual ``if __name__ == "__main__":`` guard.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

FP_KINDS = ("morgan", "maccs", "rdkit", "pairs", "morgan_counts", "avalon")
NATIVE_KINDS = ("morgan", "rdkit", "maccs")
FP_SIZES = {"morgan": 2048, "maccs": 167, "rdkit": 2048, "pairs": 2048,
            "morgan_counts": 2048}
MAX_WORKERS = 32


def fp_dim(kind: str, n_bits: int = 2048) -> int:
    return {"maccs": 167, "avalon": 512}.get(kind, n_bits)


def _featurize_chunk(args) -> Tuple[np.ndarray, List[int]]:
    smiles_chunk, kind, n_bits, radius = args
    from bbbp_tpu_torch.chem.smiles import MolFromSmiles
    from bbbp_tpu_torch.chem.fingerprints import (
        avalon_fingerprint,
        morgan_fingerprint,
        morgan_count_fingerprint,
        maccs_fingerprint,
        path_fingerprint,
        atom_pair_fingerprint,
    )

    out = np.zeros((len(smiles_chunk), fp_dim(kind, n_bits)), dtype=np.float32)
    bad: List[int] = []
    for i, s in enumerate(smiles_chunk):
        mol = MolFromSmiles(s)
        if mol is None:
            bad.append(i)
            continue
        if kind == "morgan":
            out[i] = morgan_fingerprint(mol, radius=radius, n_bits=n_bits)
        elif kind == "morgan_counts":
            out[i] = morgan_count_fingerprint(mol, radius=radius, n_bits=n_bits)
        elif kind == "maccs":
            out[i] = maccs_fingerprint(mol)
        elif kind == "rdkit":
            out[i] = path_fingerprint(mol, n_bits=n_bits)
        elif kind == "pairs":
            out[i] = atom_pair_fingerprint(mol, n_bits=n_bits)
        elif kind == "avalon":
            out[i] = avalon_fingerprint(mol)
        else:
            raise ValueError(f"unknown fingerprint kind {kind!r}")
    return out, bad


def _depict_chunk(args) -> Tuple[np.ndarray, List[int]]:
    smiles_chunk, size = args
    from bbbp_tpu_torch.chem.depict import depict

    out = np.zeros((len(smiles_chunk), size, size, 3), dtype=np.float32)
    bad: List[int] = []
    for i, s in enumerate(smiles_chunk):
        img = depict(s, size=size)
        if img is None:
            bad.append(i)
        else:
            out[i] = img
    return out, bad


@dataclass
class FeaturizeResult:
    features: np.ndarray
    bad_indices: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int64))

    @property
    def ok_mask(self) -> np.ndarray:
        mask = np.ones(len(self.features), dtype=bool)
        mask[self.bad_indices] = False
        return mask


def default_workers() -> int:
    return min(os.cpu_count() or 1, MAX_WORKERS)


def pool_map(fn, jobs, workers: Optional[int]) -> List:
    """``[fn(j) for j in jobs]`` over ``workers`` spawned processes (None:
    one a core, at most 32); in this process for one worker or one job."""
    workers = workers if workers is not None else default_workers()
    if workers <= 1 or len(jobs) == 1:
        return [fn(j) for j in jobs]
    with ProcessPoolExecutor(max_workers=min(workers, len(jobs)),
                             mp_context=multiprocessing.get_context("spawn")
                             ) as ex:
        return list(ex.map(fn, jobs))


def _chunked(smiles: List[str], payload: tuple, least: int = 64):
    """(jobs, offsets): ``smiles`` cut into at most 128 chunks of at least
    ``least``, each with ``payload`` appended."""
    chunk = max(least, (len(smiles) + 127) // 128)
    offsets = list(range(0, len(smiles), chunk))
    return [(smiles[o : o + chunk],) + payload for o in offsets], offsets


def _gather(results, offsets) -> FeaturizeResult:
    feats = np.concatenate([r[0] for r in results], axis=0)
    bad = np.asarray(
        [off + i for off, r in zip(offsets, results) for i in r[1]], dtype=np.int64
    )
    return FeaturizeResult(feats, bad)


def _descriptor_chunk(args) -> Tuple[np.ndarray, List[int]]:
    from bbbp_tpu_torch.chem.descriptors import descriptor_matrix

    return descriptor_matrix(args[0])


def descriptors(smiles: Sequence[str],
                workers: Optional[int] = None) -> FeaturizeResult:
    """Physchem descriptors of a SMILES batch → [N, 31] float32 + quarantined
    indices: ``descriptor_matrix`` over the process pool."""
    smiles = list(smiles)
    if not smiles:
        return _gather([_descriptor_chunk(([],))], [0])
    jobs, offsets = _chunked(smiles, ())
    return _gather(pool_map(_descriptor_chunk, jobs, workers), offsets)


def fingerprints(smiles: Sequence[str], kind: str = "morgan", n_bits: int = 2048,
                 radius: int = 2, workers: Optional[int] = None,
                 use_native: bool = True) -> FeaturizeResult:
    """Featurize a SMILES batch → [N, dim] float32 + quarantined indices.
    ``use_native=False`` sends the C++ kinds through the Python code too."""
    if kind not in FP_KINDS:
        raise ValueError(f"kind must be one of {FP_KINDS}")
    smiles = list(smiles)
    if not smiles:
        return FeaturizeResult(np.zeros((0, fp_dim(kind, n_bits)), dtype=np.float32))
    if use_native and kind in NATIVE_KINDS:
        from bbbp_tpu_torch.native import bindings as nb

        feats, bad = nb.fingerprints(smiles, kind, n_bits, radius,
                                     threads=workers or 0)
        return FeaturizeResult(feats, np.asarray(bad, dtype=np.int64))
    jobs, offsets = _chunked(smiles, (kind, n_bits, radius))
    return _gather(pool_map(_featurize_chunk, jobs, workers), offsets)


def images(smiles: Sequence[str], size: int = 128,
           workers: Optional[int] = None) -> FeaturizeResult:
    """Render a SMILES batch → [N, size, size, 3] float32 images (white
    background, a zero image for an invalid SMILES) + quarantined indices."""
    smiles = list(smiles)
    if not smiles:
        return FeaturizeResult(np.zeros((0, size, size, 3), dtype=np.float32))
    jobs, offsets = _chunked(smiles, (size,), least=16)
    return _gather(pool_map(_depict_chunk, jobs, workers), offsets)
