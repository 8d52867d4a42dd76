"""ctypes bindings for the port's build of the C++ featurizer.

Counterpart of ``bbbp_tpu/native/bindings.py``: the same C entry points of
``bbbpchem.cpp``, compiled into ``bbbp_tpu_torch/_build/`` by ``_build.py``.
A failed build raises; there is no pure-Python fallback in the port.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np

from bbbp_tpu_torch._build import chem_lib

_DENSE_KINDS = {"morgan": 0, "maccs": 1, "rdkit": 2}
_PACKED_KINDS = {"morgan": 0, "rdkit": 2}
MACCS_DIM = 167


def _smiles_array(smiles: Sequence[str]):
    return (ctypes.c_char_p * len(smiles))(*[s.encode("utf-8") for s in smiles])


def fingerprints(smiles: Sequence[str], kind: str, n_bits: int = 2048,
                 radius: int = 2, threads: int = 0
                 ) -> Tuple[np.ndarray, List[int]]:
    """Dense {0,1} fingerprints ``[N, dim]`` f32 (dim 167 for maccs) and the
    indices of SMILES that failed to parse (their rows stay zero)."""
    if kind not in _DENSE_KINDS:
        raise ValueError(f"native fingerprints cover {sorted(_DENSE_KINDS)}, "
                         f"not {kind!r}")
    dim = MACCS_DIM if kind == "maccs" else n_bits
    n = len(smiles)
    out = np.zeros((n, dim), dtype=np.float32)
    bad = np.zeros(n, dtype=np.int32)
    rc = chem_lib().bbbp_fingerprints(
        _smiles_array(smiles), n, _DENSE_KINDS[kind], n_bits, radius,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        bad.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), threads)
    if rc != 0:
        raise RuntimeError(f"bbbp_fingerprints failed: rc={rc}")
    return out, list(np.nonzero(bad)[0])


def fingerprints_packed(smiles: Sequence[str], kind: str = "morgan",
                        n_bits: int = 2048, radius: int = 2, threads: int = 0
                        ) -> Tuple[np.ndarray, List[int]]:
    """Packed fingerprints ``[N, n_bits/32]`` uint32 (little-endian bit
    order, as ``ops.bitops.pack_bits``) straight from C++, and the indices of
    SMILES that failed to parse — the screening path's input."""
    if kind not in _PACKED_KINDS:
        raise ValueError(f"packed fingerprints cover {sorted(_PACKED_KINDS)}, "
                         f"not {kind!r}")
    if n_bits % 32 != 0:
        raise ValueError(f"n_bits must be a multiple of 32, got {n_bits}")
    n = len(smiles)
    out = np.zeros((n, n_bits // 32), dtype=np.uint32)
    bad = np.zeros(n, dtype=np.int32)
    rc = chem_lib().bbbp_fingerprints_packed(
        _smiles_array(smiles), n, _PACKED_KINDS[kind], n_bits, radius,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        bad.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), threads)
    if rc != 0:
        raise RuntimeError(f"bbbp_fingerprints_packed failed: rc={rc}")
    return out, list(np.nonzero(bad)[0])
