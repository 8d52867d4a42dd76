"""Chemistry similarity kernels and the estimators built on them.

Counterpart of ``bbbp_tpu/ops/similarity.py``, with its names, arguments
and defaults; the estimators add a ``device`` (``cuda`` unless the caller
asks for ``cpu``). The JAX package takes every intersection as a float
matmul of 0/1 matrices. Here fingerprints are packed to 32-bit words and
counts clipped into bytes on the way in, and three CUDA kernels
(``csrc/similarity.cu``) do the work on a CUDA tensor, their plain PyTorch
versions on a CPU tensor:

- ``tanimoto_topk_packed`` (K6): the k most similar reference rows a query,
  the lower index first among equal similarities, as ``jax.lax.top_k``;
- ``tanimoto_gram`` (K7): the full Tanimoto matrix, optionally with a
  weight a bit;
- ``minmax_gram`` (K8): Σ min / Σ max over clipped counts, optionally
  weighted.

``tanimoto_topk``, ``tanimoto_matrix``, ``tanimoto_matrix_w``,
``minmax_matrix`` and ``minmax_matrix_w`` take dense matrices (arrays or
tensors) as the JAX functions do, move them to ``device`` (``cuda`` unless
the caller asks for ``cpu``), pack them there and call the wrappers.
``rbf_matrix`` and the ridge solves are plain f32 torch ops (TF32 off).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple, Union

import numpy as np
import torch

from bbbp_tpu_torch._build import LaunchCounter, check_launch, kernels_lib
from bbbp_tpu_torch.ops.bitops import (PACKED_DTYPES, pack_bits_tensor,
                                       unpack_bits_reference)
from bbbp_tpu_torch.ops.forest_train import resolve_device

MAX_TOPK_K = 1024         # the top-k kernel's lists: 32 rows of 32 keys
MAX_WORDS = 2048          # the top-k kernel's widest row
MAX_LEVELS = 255          # counts travel as bytes
MAX_GRAM_ROWS = 65535 * 32
TILE_R = 128              # K6 and K7: reference rows of a tile
SLAB_WORDS = 16           # K6 and K7: words of a row a stage
TOPK_Q = 8                # K6: queries a block, one a warp
TOPK_BLOCKS = 512         # K6: blocks a launch, about four an SM


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

def pack_counts(counts, levels: int = 16, device=None) -> torch.Tensor:
    """[N, d] non-negative integer counts (array or tensor) → [N, ceil(d/4)]
    int32 words of four uint8 counts clipped at ``levels``, pad counts zero,
    on ``device`` (default: where ``counts`` lies)."""
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"levels must be in [1, {MAX_LEVELS}], got {levels}")
    if isinstance(counts, torch.Tensor):
        c = torch.clamp(counts.to(device), min=0, max=levels).to(torch.uint8)
    else:                           # clipped on the host: bytes cross over
        c = torch.from_numpy(np.clip(np.asarray(counts), 0, levels
                                     ).astype(np.uint8)).to(device)
    if c.dim() != 2:
        raise ValueError(f"counts must be [N, d], got {tuple(c.shape)}")
    if c.shape[1] % 4 != 0:
        c = torch.nn.functional.pad(c, (0, -c.shape[1] % 4))
    return c.contiguous().view(torch.int32)


def unpack_counts_reference(words: torch.Tensor) -> torch.Tensor:
    """[N, W] words of four uint8 counts → [N, 4·W] f32 counts."""
    return words.contiguous().view(torch.uint8).to(torch.float32)


def pad_weights(w, width: int, device) -> torch.Tensor:
    """f32 [width] weights on ``device``, zero past ``len(w)``."""
    w = torch.as_tensor(w, dtype=torch.float32, device=device).reshape(-1)
    if w.shape[0] > width:
        raise ValueError(f"{w.shape[0]} weights for {width} columns")
    return torch.nn.functional.pad(w, (0, width - w.shape[0])).contiguous()


@contextlib.contextmanager
def f32_matmul():
    """Full-f32 matrix products on the card (TF32 off) inside the block."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


# ---------------------------------------------------------------------------
# Plain versions of the three kernels
# ---------------------------------------------------------------------------

def _bits(words: torch.Tensor) -> torch.Tensor:
    return unpack_bits_reference(words, words.shape[1] * 32)


def _ratio(inter: torch.Tensor, sq: torch.Tensor, sr: torch.Tensor) -> torch.Tensor:
    union = sq[:, None] + sr[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def tanimoto_gram_reference(qw: torch.Tensor, rw: torch.Tensor,
                            w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``tanimoto_gram``: unpack, one f32 matmul (exact
    without weights: the sums are integers below 2^24), row sums, division."""
    q, r = _bits(qw), _bits(rw)
    with f32_matmul():
        if w is None:
            return _ratio(q @ r.T, q.sum(1), r.sum(1))
        qv = q * w[None, :]
        return _ratio(qv @ r.T, qv.sum(1), (r * w[None, :]).sum(1))


def tanimoto_topk_reference(qw: torch.Tensor, rw: torch.Tensor, k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``tanimoto_topk_packed``: the full matrix, then a
    stable descending sort, which keeps the lower index first among equal
    similarities as ``jax.lax.top_k`` does (``torch.topk`` does not)."""
    sim, idx = torch.sort(tanimoto_gram_reference(qw, rw), dim=1,
                          descending=True, stable=True)
    return sim[:, :k].contiguous(), idx[:, :k].contiguous()


def minmax_gram_reference(qc: torch.Tensor, rc: torch.Tensor,
                          w: Optional[torch.Tensor] = None,
                          levels: Optional[int] = None) -> torch.Tensor:
    """Plain version of ``minmax_gram``, by the reference's level
    decomposition: Σ min(a, b) = Σ_t (a ≥ t)·(b ≥ t)ᵀ over t = 1..levels
    (default: the largest count present, read on the host)."""
    q, r = unpack_counts_reference(qc), unpack_counts_reference(rc)
    if levels is None:
        levels = int(max(q.max().item() if q.numel() else 0,
                         r.max().item() if r.numel() else 0))
    inter = torch.zeros((q.shape[0], r.shape[0]), dtype=torch.float32,
                        device=q.device)
    with f32_matmul():
        for t in range(1, levels + 1):
            qa = (q >= t).to(torch.float32)
            if w is not None:
                qa = qa * w[None, :]
            inter = inter + qa @ (r >= t).to(torch.float32).T
    if w is None:
        return _ratio(inter, q.sum(1), r.sum(1))
    return _ratio(inter, (q * w[None, :]).sum(1), (r * w[None, :]).sum(1))


def minmax_gram_absdiff_reference(qc: torch.Tensor, rc: torch.Tensor
                                  ) -> torch.Tensor:
    """``minmax_gram`` without weights by the identity the kernel uses:
    Σ min(a, b) = (Σa + Σb − Σ|a − b|) / 2. Every sum is an integer below
    2^24, exact in f32 in any order, so this equals
    ``minmax_gram_reference`` bit for bit."""
    q, r = unpack_counts_reference(qc), unpack_counts_reference(rc)
    sq, sr = q.sum(1), r.sum(1)
    inter = (sq[:, None] + sr[None, :] - torch.cdist(q, r, p=1)) / 2
    return _ratio(inter, sq, sr)


# ---------------------------------------------------------------------------
# Kernel wrappers: the kernel on a CUDA tensor, the plain version on the CPU
# ---------------------------------------------------------------------------

def _check_pair(name: str, q: torch.Tensor, r: torch.Tensor,
                w: Optional[torch.Tensor], per_word: int) -> bool:
    """Checks a kernel's operands; True for CUDA tensors (launch), False
    for CPU tensors (plain version)."""
    for label, t in (("q", q), ("r", r)):
        if t.dtype not in PACKED_DTYPES or t.dim() != 2:
            raise TypeError(f"{name}: {label} must be a 2-D int32 or uint32 "
                            f"tensor, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if q.shape[1] != r.shape[1] or q.shape[1] < 1:
        raise ValueError(f"{name}: q has {q.shape[1]} words a row, r "
                         f"{r.shape[1]}")
    if q.device != r.device:
        raise ValueError(f"{name}: q is on {q.device}, r on {r.device}")
    if max(q.shape[0], r.shape[0]) > MAX_GRAM_ROWS:
        raise ValueError(f"{name}: at most {MAX_GRAM_ROWS} rows")
    if w is not None:
        width = q.shape[1] * per_word
        if w.dtype != torch.float32 or w.shape != (width,):
            raise TypeError(f"{name}: w must be float32 [{width}], got "
                            f"{w.dtype} {tuple(w.shape)}")
        if w.device != q.device or not w.is_contiguous():
            raise ValueError(f"{name}: w must be contiguous on {q.device}")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no {name} kernel for {q.device}")
    return True


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def topk_plan(nq: int, nr: int, k: int) -> Tuple[int, int]:
    """K6's launch plan (split, rows): a warp keeps a query's 32·``rows``
    best keys in its registers, the power of two that holds k; a cluster of
    ``split`` blocks shares the references, 8 halved while a block would get
    no whole chunk of ``TILE_R`` or the launch would pass ``TOPK_BLOCKS``
    blocks. Measured on the H100 at the transfer shape (133 blocks of
    queries) 2 was the fastest of 1, 2, 4 and 8, at the folds' (14) 8. The
    words of a row do not enter: they only lengthen the tile loop."""
    rows = _pow2_at_least(-(-k // 32))
    chunks = -(-nr // TILE_R)
    tiles = -(-nq // TOPK_Q)
    split = 8
    while split > 1 and (chunks < split or tiles * split > TOPK_BLOCKS):
        split //= 2
    return split, rows


def tanimoto_split(words: int) -> int:
    """Blocks of K7's cluster that share a tile's slabs of ``SLAB_WORDS``
    words: 8, halved until each block gets two slabs or more (1 at MACCS's
    6 words, 2 at Morgan's 64, 8 from 256)."""
    slabs = -(-words // SLAB_WORDS)
    split = 8
    while split > 1 and slabs < 2 * split:
        split //= 2
    return split


def tanimoto_topk_packed(qw: torch.Tensor, rw: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6. qw [Nq, W], rw [Nr, W] packed bits (pad bits zero) → (sim [Nq, k]
    f32, idx [Nq, k] int64): the k largest Tanimoto similarities a query in
    descending order, the lower index first among equal ones. 1 ≤ k ≤ Nr.
    The kernel takes k ≤ 1,024 and W ≤ 2,048 and raises beyond; Nr is not
    bounded. One launch, planned by ``topk_plan``."""
    on_cuda = _check_pair("tanimoto_topk", qw, rw, None, 32)
    nq, words = qw.shape
    nr = rw.shape[0]
    if not 1 <= k <= nr:
        raise ValueError(f"k must be in [1, Nr={nr}], got {k}")
    if not on_cuda:
        return tanimoto_topk_reference(qw, rw, k)
    if k > MAX_TOPK_K or words > MAX_WORDS:
        raise ValueError(f"the tanimoto_topk kernel takes k <= {MAX_TOPK_K} "
                         f"and {MAX_WORDS} words a row, got k={k}, {words} words")
    dev = qw.device
    sim = torch.empty((nq, k), dtype=torch.float32, device=dev)
    idx = torch.empty((nq, k), dtype=torch.int64, device=dev)
    if nq == 0:
        return sim, idx
    with torch.cuda.device(dev):
        rc = kernels_lib().bbbp_tanimoto_topk(
            qw.data_ptr(), nq, rw.data_ptr(), nr, words, k, *topk_plan(nq, nr, k),
            sim.data_ptr(), idx.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "tanimoto_topk")
    tanimoto_topk_packed.launches.add(dev)
    return sim, idx


def _gram(name: str, entry: str, q: torch.Tensor, r: torch.Tensor,
          w: Optional[torch.Tensor], split: int, row_sums: bool) -> torch.Tensor:
    """One call of a gram kernel; ``row_sums``: it takes scratch for them."""
    nq, words = q.shape
    nr = r.shape[0]
    dev = q.device
    out = torch.empty((nq, nr), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    sq = torch.empty(nq, dtype=torch.float32, device=dev) if row_sums else None
    sr = torch.empty(nr, dtype=torch.float32, device=dev) if row_sums else None
    with torch.cuda.device(dev):
        rc = getattr(kernels_lib(), entry)(
            q.data_ptr(), nq, r.data_ptr(), nr, words,
            None if w is None else w.data_ptr(),
            None if sq is None else sq.data_ptr(),
            None if sr is None else sr.data_ptr(),
            out.data_ptr(), split, torch.cuda.current_stream().cuda_stream)
    check_launch(rc, name)
    return out


GRAM_STAGE = 16           # K8's 32-bit elements of a row a stage


def minmax_split(words: int, weighted: bool) -> int:
    """Blocks of K8's cluster that share a result tile's words: 8, or fewer
    where a block would get under two stages (16 words, or 4 weighted).
    Measured on the H100 at the legs' shapes, 8 was the fastest of 1, 2, 4
    and 8 at each of them."""
    stages = -(-(4 * words if weighted else words) // GRAM_STAGE)
    split = 8
    while split > 1 and stages < 2 * split:
        split //= 2
    return split


def tanimoto_gram(qw: torch.Tensor, rw: torch.Tensor,
                  w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7. qw [Nq, W], rw [Nr, W] packed bits → [Nq, Nr] f32 Tanimoto
    similarities; ``w`` f32 [32·W] weighs each bit (zero on pad bits).
    Exact without weights (one launch, a cluster of ``tanimoto_split``
    blocks); with them the kernel adds in ascending bit order after two row
    sum launches, and agrees with the plain version's matmul within 1e-5."""
    if not _check_pair("tanimoto_gram", qw, rw, w, 32):
        return tanimoto_gram_reference(qw, rw, w)
    weighted = w is not None
    out = _gram("tanimoto_gram", "bbbp_tanimoto_gram", qw, rw, w,
                1 if weighted else tanimoto_split(qw.shape[1]), weighted)
    if out.numel():
        tanimoto_gram.launches.add(out.device)
    return out


def minmax_gram(qc: torch.Tensor, rc: torch.Tensor,
                w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8. qc [Nq, W], rc [Nr, W] words of four uint8 counts already clipped
    (``pack_counts``) → [Nq, Nr] f32, Σ min(a, b) / Σ max(a, b); ``w`` f32
    [4·W] weighs each count. Exact without weights (the kernel takes Σ min
    as ``minmax_gram_absdiff_reference`` does), within 1e-5 with; the
    blocks that share a result tile's words are ``minmax_split``'s."""
    if not _check_pair("minmax_gram", qc, rc, w, 4):
        return minmax_gram_reference(qc, rc, w)
    out = _gram("minmax_gram", "bbbp_minmax_gram", qc, rc, w,
                minmax_split(qc.shape[1], w is not None), True)
    if out.numel():
        minmax_gram.launches.add(out.device)
    return out


tanimoto_topk_packed.launches = LaunchCounter()
tanimoto_gram.launches = LaunchCounter()
minmax_gram.launches = LaunchCounter()


# ---------------------------------------------------------------------------
# The JAX package's functions, on dense matrices
# ---------------------------------------------------------------------------

Device = Union[str, torch.device]


ROW_BITS = 128             # packed rows are padded to 16 bytes


def packed_bits(x, device: Device) -> torch.Tensor:
    """Fingerprints (array or tensor; anything > 0 is a set bit) → packed
    words on ``device``, rows padded with zero bits to a multiple of
    ``ROW_BITS`` (MACCS's 167 bits to 8 words), so that K6 and K7 stage them
    in 16-byte copies. The bits cross to the device as bytes and are packed
    there."""
    bits = x > 0 if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x) > 0)
    bits = bits.to(device)
    if bits.dim() == 2 and bits.shape[1] % ROW_BITS:
        bits = torch.nn.functional.pad(bits, (0, -bits.shape[1] % ROW_BITS))
    return pack_bits_tensor(bits)


def tanimoto_topk(q, r, k: int, device: Device = "cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(similarities [Nq, k], indices [Nq, k]) of the k most similar
    reference rows per query. q, r are 0/1 [N, d] matrices (arrays or
    tensors), moved to ``device``."""
    dev = resolve_device(device)
    return tanimoto_topk_packed(packed_bits(q, dev), packed_bits(r, dev), k)


def tanimoto_matrix(q, r, device: Device = "cuda") -> torch.Tensor:
    """Full [Nq, Nr] Tanimoto similarity matrix of 0/1 matrices."""
    dev = resolve_device(device)
    return tanimoto_gram(packed_bits(q, dev), packed_bits(r, dev))


def tanimoto_matrix_w(q, r, w, device: Device = "cuda") -> torch.Tensor:
    """Per-bit-weighted Tanimoto on binary matrices:
    K = Σ w_i a_i b_i / (Σ w_i a_i + Σ w_i b_i − Σ w_i a_i b_i)."""
    dev = resolve_device(device)
    qw, rw = packed_bits(q, dev), packed_bits(r, dev)
    return tanimoto_gram(qw, rw, pad_weights(w, qw.shape[1] * 32, dev))


def minmax_matrix(qc, rc, levels: int = 16, device: Device = "cuda"
                  ) -> torch.Tensor:
    """Min-max (generalized Tanimoto) kernel for count fingerprints:
    K = Σ_k min(a_k, b_k) / Σ_k max(a_k, b_k), counts clipped at ``levels``
    on both sides."""
    dev = resolve_device(device)
    return minmax_gram(pack_counts(qc, levels, dev), pack_counts(rc, levels, dev))


def minmax_matrix_w(qc, rc, w, levels: int = 16, device: Device = "cuda"
                    ) -> torch.Tensor:
    """Per-bit-weighted min-max kernel on count vectors:
    K = Σ w_i min(a_i, b_i) / Σ w_i max(a_i, b_i)."""
    dev = resolve_device(device)
    qp, rp = pack_counts(qc, levels, dev), pack_counts(rc, levels, dev)
    return minmax_gram(qp, rp, pad_weights(w, qp.shape[1] * 4, dev))


def rbf_matrix(qd, rd, gamma, device: Device = "cuda") -> torch.Tensor:
    """RBF kernel on dense descriptor vectors (pairwise distances via the
    norm + cross-matmul identity), in f32 with TF32 off."""
    dev = resolve_device(device)
    qd = torch.as_tensor(qd, dtype=torch.float32).to(dev)
    rd = torch.as_tensor(rd, dtype=torch.float32).to(dev)
    with f32_matmul():
        d2 = ((qd ** 2).sum(1, keepdim=True) + (rd ** 2).sum(1)[None, :]
              - 2.0 * qd @ rd.T)
    return torch.exp(-float(gamma) * torch.clamp(d2, min=0.0))


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------

def _ridge_solve(k: torch.Tensor, lam: float, resid: torch.Tensor) -> torch.Tensor:
    """alpha = (K + lam·I)⁻¹ resid by an f32 Cholesky factorisation, as the
    reference's ``solve(assume_a="pos")``."""
    n = k.shape[0]
    with f32_matmul():
        chol = torch.linalg.cholesky(
            k + lam * torch.eye(n, dtype=k.dtype, device=k.device))
        return torch.cholesky_solve(resid[:, None], chol)[:, 0]


def _apply(k: torch.Tensor, alpha: torch.Tensor, mean: float) -> np.ndarray:
    with f32_matmul():
        return (k @ alpha + mean).cpu().numpy()


class TanimotoKNNRegressor:
    """Similarity-weighted k-nearest-neighbor regression over binary
    fingerprints: pred = Σ sim_i·y_i / Σ sim_i over the top-k Tanimoto
    neighbors. sklearn-style fit/predict."""

    def __init__(self, n_neighbors: int = 10, power: float = 2.0,
                 device: Union[str, torch.device] = "cuda"):
        self.n_neighbors = n_neighbors
        self.power = power              # sim^power sharpens the weighting
        self.device = device
        self._x: Optional[torch.Tensor] = None      # packed words
        self._y: Optional[torch.Tensor] = None

    def fit(self, x, y) -> "TanimotoKNNRegressor":
        dev = resolve_device(self.device)
        self._x = packed_bits(x, dev)
        self._y = torch.as_tensor(np.asarray(y, np.float32), device=dev)
        return self

    def predict(self, x) -> np.ndarray:
        q = packed_bits(x, self._x.device)
        k = min(self.n_neighbors, self._x.shape[0])
        sim, idx = tanimoto_topk_packed(q, self._x, k)
        w = torch.clamp(sim, min=1e-6) ** self.power
        return ((w * self._y[idx]).sum(1) / w.sum(1)).cpu().numpy()


class TanimotoKNNClassifier(TanimotoKNNRegressor):
    def fit(self, x, y):
        return super().fit(x, np.asarray(y, np.float32))

    def predict_proba(self, x) -> np.ndarray:
        p = np.clip(super().predict(x), 0.0, 1.0)
        return np.stack([1 - p, p], axis=1)

    def predict(self, x) -> np.ndarray:
        return (super().predict(x) > 0.5).astype(np.int32)


class TanimotoKernelRidge:
    """Kernel ridge regression with the Tanimoto kernel (a valid PSD kernel
    on bit sets). Unlike the top-k kNN leg this uses the full similarity
    structure: alpha = (K + lam*I)^-1 (y - mean), pred = K(q, X) @ alpha +
    mean. The gram matrix is one kernel launch and the solve a small
    Cholesky."""

    def __init__(self, lam: float = 0.1,
                 device: Union[str, torch.device] = "cuda"):
        self.lam = lam
        self.device = device
        self._x: Optional[torch.Tensor] = None      # packed words
        self._alpha: Optional[torch.Tensor] = None
        self._mean = 0.0

    def fit(self, x, y) -> "TanimotoKernelRidge":
        dev = resolve_device(self.device)
        self._x = packed_bits(x, dev)
        y = torch.as_tensor(np.asarray(y, np.float32), device=dev)
        self._mean = float(y.mean())
        self._alpha = _ridge_solve(tanimoto_gram(self._x, self._x), self.lam,
                                   y - self._mean)
        return self

    def predict(self, x) -> np.ndarray:
        q = packed_bits(x, self._x.device)
        return _apply(tanimoto_gram(q, self._x), self._alpha, self._mean)

    @staticmethod
    def full_gram(x, device: Union[str, torch.device] = "cuda") -> np.ndarray:
        """Label-independent full N x N Tanimoto gram (one launch). Lets a
        caller run arbitrarily fine CV as cheap host sub-matrix solves
        instead of N gram recomputations."""
        b = packed_bits(x, resolve_device(device))
        return tanimoto_gram(b, b).cpu().numpy()


class ChemKernelRidge:
    """Kernel ridge over a weighted combination of chemistry kernels:
    w0·Tanimoto(MACCS bits) + w1·Tanimoto(Morgan bits) +
    w2·minmax(Morgan counts) + w3·RBF(physchem descriptors).

    Each term is PSD so the combination is a valid kernel; the mix sees
    substructure presence, substructure multiplicity, and global physchem
    geometry at once. The descriptor block is standardized on the fit rows
    only and the RBF bandwidth is the median train pairwise distance, so
    per-fold fits are leak-free by construction."""

    def __init__(self, lam: float = 0.06,
                 weights=(0.15, 0.2, 0.45, 0.2), levels: int = 16,
                 bit_weights=None, device: Union[str, torch.device] = "cuda"):
        self.lam = lam
        self.weights = weights
        self.levels = levels
        # optional per-bit weights (w_maccs, w_bits, w_counts) for the three
        # fingerprint blocks — e.g. idf_weights() for IDF-weighted kernels
        self.bit_weights = bit_weights
        self.device = device

    @staticmethod
    def idf_weights(maccs, counts) -> tuple:
        """IDF per-bit weights log(N / df) from the (label-independent)
        document frequency of each substructure bit over the given rows.
        Returns (w_maccs, w_bits, w_counts) with w_counts sharing the
        binary-bits weights."""
        mk = (np.asarray(maccs) > 0).astype(np.float64)
        bt = (np.asarray(counts) > 0).astype(np.float64)
        n = float(len(mk))
        w_keys = np.log(n / np.maximum(mk.sum(0), 1.0)).astype(np.float32)
        w_bits = np.log(n / np.maximum(bt.sum(0), 1.0)).astype(np.float32)
        return (w_keys, w_bits, w_bits)

    def _kernel(self, q, r) -> torch.Tensor:
        qm, qb, qc, qd = q
        rm, rb, rc, rd = r
        w = self.weights
        bw = self.bit_weights or (None, None, None)
        dev = qm.device

        def padded(i, block, per_word):
            return (None if bw[i] is None else
                    pad_weights(bw[i], block.shape[1] * per_word, dev))

        k = torch.zeros((qm.shape[0], rm.shape[0]), dtype=torch.float32,
                        device=dev)
        if w[0]:
            k = k + w[0] * tanimoto_gram(qm, rm, padded(0, qm, 32))
        if w[1]:
            k = k + w[1] * tanimoto_gram(qb, rb, padded(1, qb, 32))
        if w[2]:
            k = k + w[2] * minmax_gram(qc, rc, padded(2, qc, 4))
        if w[3]:
            k = k + w[3] * rbf_matrix(qd, rd, self._gamma, dev)
        return k

    def _standardize(self, desc: np.ndarray) -> None:
        self._mu = desc.mean(0)
        sd = desc.std(0)
        self._inv = (1.0 / np.where(sd < 1e-12, 1.0, sd)).astype(np.float32)

    def _blocks(self, maccs, counts, desc):
        dev = resolve_device(self.device)
        return (packed_bits(maccs, dev), packed_bits(counts, dev),
                pack_counts(counts, self.levels, dev),
                torch.as_tensor(np.asarray(
                    (np.asarray(desc) - self._mu) * self._inv, np.float32),
                    device=dev))

    def fit(self, maccs, counts, desc, y) -> "ChemKernelRidge":
        desc = np.asarray(desc, np.float32)
        self._standardize(desc)
        self._train = self._blocks(maccs, counts, desc)
        if self.weights[3]:
            dd = self._train[3]
            if len(dd) <= 512:
                d = dd.cpu().numpy()
                d2 = ((d[:, None, :] - d[None, :, :]) ** 2).sum(-1)
            else:
                # matmul identity for larger N (device-side)
                with f32_matmul():
                    sq = (dd ** 2).sum(1)
                    d2 = (sq[:, None] + sq[None, :] - 2.0 * (dd @ dd.T)
                          ).cpu().numpy()
            self._gamma = np.float32(1.0 / (2.0 * max(np.median(d2), 1e-6)))
        else:
            self._gamma = np.float32(1.0)
        y = torch.as_tensor(np.asarray(y, np.float32), device=self._train[3].device)
        self._mean = float(y.mean())
        self._alpha = _ridge_solve(self._kernel(self._train, self._train),
                                   self.lam, y - self._mean)
        return self

    def predict(self, maccs, counts, desc) -> np.ndarray:
        q = self._blocks(maccs, counts, desc)
        return _apply(self._kernel(q, self._train), self._alpha, self._mean)

    def full_gram(self, maccs, counts, desc) -> np.ndarray:
        """Label-independent full N x N combined-kernel gram. Descriptor
        standardization and the RBF bandwidth are fit on all rows, which is
        valid under the honest protocol (unsupervised transforms are
        global) and makes fine-grained CV cost only host sub-matrix solves."""
        desc = np.asarray(desc, np.float32)
        self._standardize(desc)
        blocks = self._blocks(maccs, counts, desc)
        if self.weights[3]:
            d = blocks[3].cpu().numpy()
            sq = (d ** 2).sum(1)
            d2 = sq[:, None] + sq[None, :] - 2.0 * (d @ d.T)
            self._gamma = np.float32(1.0 / (2.0 * max(np.median(d2), 1e-6)))
        else:
            self._gamma = np.float32(1.0)
        return self._kernel(blocks, blocks).cpu().numpy()


def estimator_from_state(kind: str, state: dict,
                         device: Union[str, torch.device] = "cuda"):
    """A fitted estimator of this module from the state of the JAX package's
    one, as numpy arrays and the constructor's arguments:

    - ``tknn_regressor`` / ``tknn_classifier``: ``x`` (0/1 [N, d]), ``y``,
      ``n_neighbors``, ``power``;
    - ``tkrr``: ``x``, ``alpha``, ``mean``, ``lam``;
    - ``ckrr``: ``train`` (MACCS bits, Morgan bits, raw counts, standardized
      descriptors), ``mu``, ``inv``, ``gamma``, ``alpha``, ``mean``, ``lam``,
      ``weights``, ``levels``, ``bit_weights``.
    """
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    if kind in ("tknn_regressor", "tknn_classifier"):
        cls = (TanimotoKNNRegressor if kind == "tknn_regressor"
               else TanimotoKNNClassifier)
        est = cls(state["n_neighbors"], state["power"], device=dev)
        est._x, est._y = packed_bits(state["x"], dev), f32(state["y"])
        return est
    if kind == "tkrr":
        est = TanimotoKernelRidge(state["lam"], device=dev)
        est._x, est._alpha = packed_bits(state["x"], dev), f32(state["alpha"])
        est._mean = float(state["mean"])
        return est
    if kind == "ckrr":
        est = ChemKernelRidge(state["lam"], tuple(state["weights"]),
                              state["levels"], state["bit_weights"], device=dev)
        maccs, bits, counts, desc = state["train"]
        est._train = (packed_bits(maccs, dev), packed_bits(bits, dev),
                      pack_counts(counts, est.levels, dev),
                      f32(desc))
        est._mu = np.asarray(state["mu"], np.float32)
        est._inv = np.asarray(state["inv"], np.float32)
        est._gamma = np.float32(state["gamma"])
        est._alpha, est._mean = f32(state["alpha"]), float(state["mean"])
        return est
    raise ValueError(f"unknown estimator kind {kind!r}")
