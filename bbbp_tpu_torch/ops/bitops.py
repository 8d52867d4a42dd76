"""Packed-bit fingerprint ops: the screening projection over uint32 words.

Counterpart of ``bbbp_tpu/ops/bitops.py``. For x ∈ {0,1} the scaler and PCA
fold into one affine map, z = ((x−μ)/σ − μ_p)·Cᵀ = x·W′ + c0, so the device
receives 256 B of packed words per molecule instead of 8 KB of floats.

``packed_project`` launches the CUDA kernel ``csrc/packed_project.cu`` on a
CUDA tensor and runs its plain version, ``packed_project_reference``
(unpack + f32 matmul), on a CPU tensor.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from bbbp_tpu_torch._build import LaunchCounter, check_launch, kernels_lib

PACKED_DTYPES = (torch.int32, torch.uint32)
MAX_BITS = 65_536                 # the kernel's bit indices are uint16


def pack_bits(dense: np.ndarray) -> np.ndarray:
    """[N, n_bits] {0,1} float/int → [N, ceil(n_bits/32)] uint32
    (little-endian bits). A width that is no multiple of 32 (MACCS has 167
    bits) is padded with zero bits to the next one."""
    n, d = dense.shape
    b = (np.asarray(dense) > 0.5).astype(np.uint8)
    if d % 32 != 0:
        b = np.pad(b, ((0, 0), (0, -d % 32)))
        d = b.shape[1]
    packed = np.packbits(b.reshape(n, d // 8, 8)[:, :, ::-1], axis=-1)
    return np.ascontiguousarray(packed.reshape(n, d // 8)).view(np.uint32)


def pack_bits_tensor(dense: torch.Tensor) -> torch.Tensor:
    """``pack_bits`` with torch ops, on the device of ``dense``: [N, n_bits]
    {0,1} → [N, ceil(n_bits/32)] int32 words, pad bits zero."""
    n, d = dense.shape
    bits = (dense > 0.5).to(torch.int64)
    if d % 32 != 0:
        bits = torch.nn.functional.pad(bits, (0, -d % 32))
    shifts = torch.arange(32, dtype=torch.int64, device=dense.device)
    words = (bits.view(n, -1, 32) << shifts).sum(dim=-1)     # in [0, 2^32)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def project_weights(scaler_mean: np.ndarray, scaler_scale: np.ndarray,
                    pca_mean: np.ndarray, pca_components: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Fold scaler+PCA into (W′ [d, k], c0 [k]) for binary inputs."""
    c = pca_components.T                               # [d, k]
    w = c / scaler_scale[:, None]
    c0 = -((scaler_mean / scaler_scale + pca_mean) @ c)
    return np.ascontiguousarray(w, np.float32), c0.astype(np.float32)


def unpack_bits_reference(packed: torch.Tensor, n_bits: int) -> torch.Tensor:
    """[N, W] int32/uint32 words → [N, n_bits] f32 bits (plain version)."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed.view(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1)[:, :n_bits].to(torch.float32)


def packed_project_reference(packed: torch.Tensor, w: torch.Tensor,
                             c0: torch.Tensor) -> torch.Tensor:
    """Plain version of ``packed_project``: unpack, then an f32 matmul."""
    return unpack_bits_reference(packed, w.shape[0]) @ w + c0


def _check_args(packed: torch.Tensor, w: torch.Tensor, c0: torch.Tensor) -> None:
    if packed.dtype not in PACKED_DTYPES or packed.dim() != 2:
        raise TypeError("packed must be a 2-D int32 or uint32 tensor, got "
                        f"{packed.dtype} {tuple(packed.shape)}")
    if w.dim() != 2:
        raise ValueError(f"w must be [d, k], got {tuple(w.shape)}")
    d, k = w.shape
    if w.dtype != torch.float32 or c0.dtype != torch.float32:
        raise TypeError("w and c0 must be float32")
    if c0.shape != (k,):
        raise ValueError(f"c0 must have shape ({k},), got {tuple(c0.shape)}")
    if packed.shape[1] * 32 < d:
        raise ValueError(f"{packed.shape[1]} words hold fewer than d={d} bits")
    if d > MAX_BITS:
        raise ValueError(f"d={d} bits: the kernel takes at most {MAX_BITS}")
    if not (packed.device == w.device == c0.device):
        raise ValueError("packed, w and c0 must be on one device")
    if not (packed.is_contiguous() and w.is_contiguous() and c0.is_contiguous()):
        raise ValueError("packed, w and c0 must be contiguous")


def packed_project(packed: torch.Tensor, w: torch.Tensor,
                   c0: torch.Tensor) -> torch.Tensor:
    """[N, W] packed bits → [N, k] f32 projected features, z = bits·W′ + c0.

    On a CUDA tensor this launches the kernel on the current stream, without
    synchronising; on a CPU tensor it runs ``packed_project_reference``."""
    _check_args(packed, w, c0)
    if packed.device.type == "cpu":
        return packed_project_reference(packed, w, c0)
    if packed.device.type != "cuda":
        raise ValueError(f"no packed_project kernel for {packed.device}")
    n, words = packed.shape
    d, k = w.shape
    out = torch.empty((n, k), dtype=torch.float32, device=packed.device)
    if n == 0 or k == 0:
        return out
    with torch.cuda.device(packed.device):
        rc = kernels_lib().bbbp_packed_project(
            packed.data_ptr(), n, words, w.data_ptr(), c0.data_ptr(), d, k,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check_launch(rc, "packed_project")
    packed_project.launches.add(packed.device)
    return out


packed_project.launches = LaunchCounter()
