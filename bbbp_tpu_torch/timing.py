"""Device timing and roofline bounds of the port's kernels, for
``chip_smoke.py``. Nothing here runs on the main path.

A bound is the least time the card could take for a kernel's work: the
larger of the bytes it must move (each input read once, each output written
once) over the memory rate, and its operations over the peak rate for their
type. Peaks are NVIDIA's published H100 SXM figures at the 700 W limit.
"""

from __future__ import annotations

import subprocess
from typing import Callable, Dict

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def nvidia_smi() -> str:
    """The card's ``name, power.limit`` as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def device_ms(fn: Callable[[], object], calls: int = 10,
              replays: int = 20) -> float:
    """Device milliseconds per call of ``fn``: ``calls`` calls captured in a
    CUDA graph and replayed, so host launch overhead is not in the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def _bound(n_bytes: float, ops: float) -> Dict[str, object]:
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return {"bytes": int(n_bytes), "ops": int(ops),
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def forest_bound(n: int, n_feat: int, n_trees: int, depth: int) -> Dict[str, object]:
    """x [n, F] and the trees (feat, thr, leaf) read once, margins written
    once; n·T·D f32 compares and n·T adds."""
    internal = (1 << depth) - 1
    trees = n_trees * (internal * 8 + (internal + 1) * 4)
    return _bound(n * n_feat * 4 + trees + n * 4,
                  n * n_trees * depth + n * n_trees)


def project_bound(n: int, words: int, d: int, k: int,
                  set_bits: int) -> Dict[str, object]:
    """Words, W′ and c0 read once, z written once; one f32 add per set bit
    below d and column (what these inputs need), and one per c0 term."""
    return _bound(n * words * 4 + d * k * 4 + k * 4 + n * k * 4,
                  set_bits * k + n * k)
