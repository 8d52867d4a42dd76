"""Build and load the port's two native libraries at first use.

- ``kernels``: every ``csrc/*.cu`` compiled by ``nvcc`` for ``sm_90a`` (one
  ``nvcc`` a source, all started together) and linked into one shared
  library with a plain C interface, loaded with ``ctypes``.
  Pointers and the CUDA stream go in as ``c_void_p``; each entry point
  returns ``cudaGetLastError()``, which ``check_launch`` turns into an
  exception.
- ``chem``: the JAX package's C++ featurizer, ``bbbp_tpu/native/bbbpchem.cpp``,
  read from its path (not imported) and compiled with that package's own
  ``g++`` line.

Both land in ``bbbp_tpu_torch/_build/`` as ``<name>-<key>.so``, where the key
hashes the sources and the command, so a changed source builds a new file and
an unchanged one is reused. A failed build raises. Builds are serialised by a
file lock, because test workers in several processes may ask at once.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import glob
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Callable, List

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")
CSRC_DIR = os.path.join(_PKG, "csrc")
CHEM_SRC = os.path.join(os.path.dirname(_PKG), "bbbp_tpu", "native",
                        "bbbpchem.cpp")

COMPILE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC"]
NVCC_FLAGS = COMPILE_FLAGS + ["-shared"]         # one command, all sources
# the same line as bbbp_tpu/native/build.py
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread"]


class BuildError(RuntimeError):
    """A native library failed to compile."""


class LaunchCounter:
    """Number of times a wrapper launched its kernel. Thread-safe, because
    ``screen()`` launches from several dispatcher threads."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0

    def add(self, launches: int = 1) -> None:
        with self._lock:
            self.count += launches

    def reset(self) -> None:
        with self._lock:
            self.count = 0


def _run(cmd: List[str], name: str) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise BuildError(f"building {name} failed ({' '.join(cmd)}):\n"
                         f"{proc.stdout}{proc.stderr}")


def _build(name: str, sources: List[str], cmd: List[str],
           make: Callable[[str], None]) -> str:
    """``make(tmp)`` builds the library into ``tmp`` unless ``out`` for this
    key (the sources and ``cmd``, every command ``make`` runs) exists."""
    h = hashlib.sha256(" ".join(cmd).encode())
    h.update(platform.machine().encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):             # built by another process meanwhile
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        make(tmp)
        os.replace(tmp, out)
    return out


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_HOME:
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None or not os.path.exists(nvcc):
        raise BuildError("nvcc not found: the CUDA kernels need the CUDA "
                         "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def build_kernels() -> str:
    """Path of the CUDA kernel library, built from ``csrc/*.cu``: one
    ``nvcc -c`` a source, run at once, then one link."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not sources:
        raise BuildError(f"no CUDA sources under {CSRC_DIR}")
    nvcc = _nvcc()

    def make(tmp: str) -> None:
        objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
        try:
            procs = [subprocess.Popen([nvcc] + COMPILE_FLAGS + ["-c", src, "-o", obj],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for src, obj in zip(sources, objs)]
            outputs = [proc.communicate()[0] for proc in procs]
            failed = [f"{src}:\n{text}"
                      for src, proc, text in zip(sources, procs, outputs)
                      if proc.returncode != 0]
            if failed:
                raise BuildError("building kernels failed:\n" + "\n".join(failed))
            _run([nvcc] + NVCC_FLAGS + objs + ["-o", tmp], "kernels")
        finally:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)

    key = [nvcc] + COMPILE_FLAGS + ["-c"] + sources + ["&&"] + NVCC_FLAGS
    return _build("kernels", sources, key, make)


def build_chem() -> str:
    """Path of the port's own build of the C++ featurizer."""
    if not os.path.exists(CHEM_SRC):
        raise BuildError(f"C++ featurizer source missing: {CHEM_SRC}")
    cmd = ["g++"] + GXX_FLAGS + [CHEM_SRC]
    return _build("bbbpchem", [CHEM_SRC], cmd,
                  lambda tmp: _run(cmd + ["-o", tmp], "bbbpchem"))


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# a parent split: f_l, b_l [(L,) nodes] int32, nodes (0: none), feats and bins
# int32 at the parent level's first node of the tree (of lane 0)
_PARENT = (_P, _P, _I, _P, _P)


@functools.lru_cache(maxsize=None)
def kernels_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_kernels())
    lib.bbbp_packed_project.restype = _I
    lib.bbbp_packed_project.argtypes = [
        _P, _I, _I,            # packed [n, words] uint32
        _P, _P, _I, _I,        # w [d, k] f32, c0 [k] f32, d, k
        _P, _P,                # out [n, k] f32, stream
    ]
    lib.bbbp_dense_forest_predict.restype = _I
    lib.bbbp_dense_forest_predict.argtypes = [
        _P, _I, _I,            # x [n, F] f32
        _P, _I, _I,            # tree records [T, R] int32, T, depth
        _F, _F, _I,            # base_score, tree_scale, apply_sigmoid
        _P, _P,                # out [n] f32, stream
    ]
    lib.bbbp_forest_level_histogram.restype = _I
    lib.bbbp_forest_level_histogram.argtypes = [
        _P, _I, _I,            # xb [n, F] uint8
        _P, _P, _P, _I,        # pos [n] int32, g, h [n] f32, n_nodes
        _P, _P,                # bounds [2] f32, n_bins [F] uint8 or null
        _I, _I, _I, _I,        # tile_feats, threads, rows_per_item, own_rows
        _P, _P, _P,            # scratch: rows, plan, acc
        _P,                    # out [nodes, F, 64, 2] f32
        *_PARENT,              # the parent split (no lane stride)
        _P,                    # stream
    ]
    lib.bbbp_forest_best_splits.restype = _I
    lib.bbbp_forest_best_splits.argtypes = [
        _P, _I, _I,            # hist [nodes, F, 64, 2] f32
        _P, _F, _F, _I,        # col_mask [F] bool, lambda, min_child, oblivious
        _P,                    # scratch int32 [2·candidates] or null
        _P, _P, _P, _P,        # feat, bin [nodes] int32, has_split bool, stream
    ]
    lib.bbbp_forest_leaf_values.restype = _I
    lib.bbbp_forest_leaf_values.argtypes = [
        _P, _I, _P, _P,        # pos [n] int32, g, h [n] f32
        _I, _F, _F, _P,        # n_leaves, lambda, scale, bounds [2] f32
        _P, _P,                # leaf [n_leaves] f32, preds [n] f32 (in place)
        _P, _P, _P, _F, _I,    # next tree: y, u, w_rows [n] f32 or null, subsample, cls
        _P, _P, _P,            # next g, h [n] f32, bounds [2] f32
        _I,                    # cluster (blocks of 1,024 threads)
        _P, _I,                # xb [n, F] uint8 (for the parent split)
        *_PARENT,              # the parent split (no lane stride)
        _P,                    # stream
    ]
    lib.bbbp_forest_level_histogram_lanes.restype = _I
    lib.bbbp_forest_level_histogram_lanes.argtypes = (
        lib.bbbp_forest_level_histogram.argtypes[:-1] + [
            _L,                     # words from one lane's trees to the next
            _I, _L,                 # lanes, scratch words a lane
            _P])                    # stream
    lib.bbbp_forest_best_splits_lanes.restype = _I
    lib.bbbp_forest_best_splits_lanes.argtypes = [
        _P, _I, _I,            # hist [L, nodes, F, 64, 2] f32
        _P, _P, _F, _I,        # col_mask [L, F] bool, lambda [L] f32, min_child, oblivious
        _P,                    # scratch int32 [L, 2·candidates] or null
        _P, _P, _P, _I, _P,    # feat, bin [L, nodes] int32, has_split bool, L, stream
    ]
    lib.bbbp_forest_level_splits_lanes.restype = _I
    lib.bbbp_forest_level_splits_lanes.argtypes = [
        _P, _I, _I,            # xb [n, F] uint8
        _P, _P, _P, _I,        # pos [L, n] int32, g, h [L, n] f32, n_nodes
        _P, _P,                # bounds [L, 2] f32, n_bins [F] uint8 or null
        _P, _P, _F,            # col_mask [L, F] bool, lambda [L] f32, min_child
        _I, _I, _I,            # rows_per_item, own_rows, units a warp
        _P, _P, _P, _P,        # scratch: rows, plan, acc, candidates
        _P, _P, _P,            # feat, bin [L, nodes] int32, has_split bool
        *_PARENT, _L,          # the parent split, words from one lane's trees to the next
        _I, _L,                # L, scratch words a lane
        _P,                    # stream
    ]
    lib.bbbp_forest_leaf_values_lanes.restype = _I
    lib.bbbp_forest_leaf_values_lanes.argtypes = [
        _P, _I, _P, _P,        # pos [L, n] int32, g, h [L, n] f32
        _I, _P, _P, _P,        # n_leaves, lambda [L], scale [L], bounds [L, 2] f32
        _P, _P,                # leaf [L, n_leaves] f32, preds [L, n] f32 (in place)
        _P, _P, _P, _P, _I,    # next tree: y [n], u, w_rows [L, n] or null, subsample [L], cls
        _P, _P, _P,            # next g, h [L, n] f32, bounds [L, 2] f32
        _I, _I,                # cluster (the cluster form's blocks a lane), shape
        _P, _I,                # xb [n, F] uint8 (for the parent split)
        *_PARENT, _L,          # the parent split, words from one lane's trees to the next
        _I, _P,                # L, stream
    ]
    lib.bbbp_forest_draws.restype = _I
    lib.bbbp_forest_draws.argtypes = [
        _P, _I,                # seeds [L] int64
        _P, _I, _I, _I,        # tree [1] int64, tree offset, stream, size
        ctypes.POINTER(ctypes.c_uint32), _I,   # Poisson thresholds (host) or null, count
        _P, _P,                # out [L, size] f32, stream
    ]
    lib.bbbp_tanimoto_topk.restype = _I
    lib.bbbp_tanimoto_topk.argtypes = [
        _P, _I, _P, _I, _I,    # q [nq, words], r [nr, words] packed bits
        _I, _I, _I,            # k, split, rows (topk_plan)
        _P, _P, _P,            # sim [nq, k] f32, idx [nq, k] int64, stream
    ]
    lib.bbbp_tanimoto_gram.restype = _I
    lib.bbbp_tanimoto_gram.argtypes = [
        _P, _I, _P, _I, _I,    # q [nq, words], r [nr, words] uint32
        _P, _P, _P,            # w f32 or null, scratch sq [nq], sr [nr] (weighted)
        _P, _I, _P,            # out [nq, nr] f32, split (tanimoto_split), stream
    ]
    lib.bbbp_minmax_gram.restype = _I
    lib.bbbp_minmax_gram.argtypes = [
        _P, _I, _P, _I, _I,    # q [nq, words], r [nr, words] uint32
        _P, _P, _P,            # w f32 or null, scratch sq [nq], sr [nr]
        _P, _I, _P,            # out [nq, nr] f32, split (1, 2, 4, 8), stream
    ]
    return lib


@functools.lru_cache(maxsize=None)
def chem_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_chem())
    for fn, out_t in ((lib.bbbp_fingerprints, ctypes.c_float),
                      (lib.bbbp_fingerprints_packed, ctypes.c_uint32)):
        fn.restype = _I
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),  # smiles
            _I, _I, _I, _I,                   # n, kind, n_bits, radius
            ctypes.POINTER(out_t),            # out
            ctypes.POINTER(ctypes.c_int32),   # bad flags [n]
            _I,                               # threads (0 = all cores)
        ]
    return lib


def check_launch(rc: int, kernel: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {rc}")
