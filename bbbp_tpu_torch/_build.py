"""Build and load the port's two native libraries at first use.

- ``kernels``: every ``csrc/*.cu`` compiled by ``nvcc`` for ``sm_90a`` into
  one shared library with a plain C interface, loaded with ``ctypes``.
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
from typing import List

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")
CSRC_DIR = os.path.join(_PKG, "csrc")
CHEM_SRC = os.path.join(os.path.dirname(_PKG), "bbbp_tpu", "native",
                        "bbbpchem.cpp")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
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

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


def _build(name: str, sources: List[str], cmd: List[str]) -> str:
    """Compile ``cmd + [-o out]`` unless ``out`` for this key exists."""
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
        proc = subprocess.run(cmd + ["-o", tmp], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise BuildError(f"building {name} failed ({' '.join(cmd)}):\n"
                             f"{proc.stdout}{proc.stderr}")
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
    """Path of the CUDA kernel library, built from ``csrc/*.cu``."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not sources:
        raise BuildError(f"no CUDA sources under {CSRC_DIR}")
    return _build("kernels", sources, [_nvcc()] + NVCC_FLAGS + sources)


def build_chem() -> str:
    """Path of the port's own build of the C++ featurizer."""
    if not os.path.exists(CHEM_SRC):
        raise BuildError(f"C++ featurizer source missing: {CHEM_SRC}")
    return _build("bbbpchem", [CHEM_SRC], ["g++"] + GXX_FLAGS + [CHEM_SRC])


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


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
        _P, _P, _P, _I, _I,    # feat, thr, leaf, T, depth
        _F, _F, _I,            # base_score, tree_scale, apply_sigmoid
        _P, _P,                # out [n] f32, stream
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
