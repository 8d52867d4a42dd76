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


def event_ms(fn: Callable[[], object], calls: int = 50) -> float:
    """Device milliseconds per call of ``fn`` between two CUDA events, for
    a call that synchronises with the host and so cannot be captured in a
    graph (``torch.bincount`` reads its input's maximum); host gaps between
    the calls are in the number."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def level_histogram_bound(n: int, n_feat: int, n_nodes: int) -> Dict[str, object]:
    """xb (one byte a value), pos, g and h read once, the f32 (g, h)
    histogram written once; two adds per row and feature."""
    return _bound(n * n_feat + 12 * n + n_nodes * n_feat * 64 * 8,
                  2 * n * n_feat)


def best_splits_bound(n_nodes: int, n_feat: int) -> Dict[str, object]:
    """The histogram and the column mask read once, (feat, bin, has_split)
    written once; per (node, feature, bin) 15 f32 operations: two running
    sums, the gain's two subtractions, two lambda adds, two squares, two
    divisions, one add and one subtraction, two min_child compares and the
    argmax compare."""
    return _bound(n_nodes * n_feat * 64 * 8 + n_feat + 9 * n_nodes,
                  15 * n_nodes * n_feat * 64)


def leaf_values_bound(n: int, n_leaves: int,
                      next_tree: bool = False) -> Dict[str, object]:
    """pos, g and h read once, the margins read and written once, the leaves
    written once; two adds and one fused multiply-add (two operations) per
    row, an add and a division per leaf. With ``next_tree`` also y, u and
    the row weights read once, the next g and h written once with their two
    maxima, and 14 operations a row (the sigmoid's exp, add and division,
    p − y, 1 − p, the product, the clamp, the mask's compare, four products,
    two maxima)."""
    extra_bytes, extra_ops = (20 * n + 8, 14 * n) if next_tree else (0, 0)
    return _bound(12 * n + 8 * n + 4 * n_leaves + extra_bytes,
                  4 * n + 2 * n_leaves + extra_ops)


def topk_bound(nq: int, nr: int, words: int, k: int) -> Dict[str, object]:
    """The packed queries and references read once, (sim f32, idx int64)
    [nq, k] written once; per pair three integer operations a word (AND,
    popcount, add) and five for the epilogue (add, subtract, max, division,
    one compare of the selection). The table of peaks has no integer rate;
    the f32 rate stands in for it."""
    return _bound((nq + nr) * words * 4 + nq * k * 12,
                  nq * nr * (3 * words + 5))


def gram_bound(nq: int, nr: int, words: int, values_per_word: int = 32,
               weighted_terms: int = 0) -> Dict[str, object]:
    """Both packed operands (and the weights, where given) read once, the f32
    [nq, nr] result written once. Per pair and word: AND, popcount and add
    for 32 bits (three integer operations), or a byte-wise minimum and a dot
    product with ones for four counts (two); four more a pair for the
    epilogue. ``weighted_terms`` is what a weighted call's data needs
    besides: the number of (pair, set bit of a AND b) terms for bits, or of
    (pair, count) products for counts, one multiply-add (two operations)
    each.

    The count of a byte-wise minimum as one operation is kept, though on
    sm_90a ``__vminu4`` is not one instruction: ``cuobjdump -sass`` shows it
    as about six (three or four LOP3, SHF, PRMT, IMAD.IADD) before the
    IDP.4A, while ``__vsadu4`` is one instruction (VABSDIFF4.U8.ACC, Σ|a − b|
    over four bytes with an accumulator), which K8 uses instead."""
    per_word = 3 if values_per_word == 32 else 2
    w_bytes = words * values_per_word * 4 if weighted_terms else 0
    return _bound((nq + nr) * words * 4 + w_bytes + nq * nr * 4,
                  nq * nr * (per_word * words + 4) + 2 * weighted_terms)


def profile_summary(prof, classify: Callable[[str], str]) -> Dict[str, object]:
    """Device time of a ``torch.profiler`` run: ms and count by
    ``classify(event name)``, and the busy ms (the union of the device
    intervals)."""
    import torch

    by_name: Dict[str, Dict[str, float]] = {}
    spans = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        entry = by_name.setdefault(classify(ev.name), {"ms": 0.0, "count": 0})
        entry["ms"] += ev.time_range.elapsed_us() / 1e3
        entry["count"] += 1
        spans.append((ev.time_range.start, ev.time_range.end))
    spans.sort()
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return {"device": by_name, "device_busy_ms": busy_us / 1e3}


def host_launch_calls(prof) -> int:
    """The host's calls that enqueue work on the card in a ``torch.profiler``
    run: kernel launches (``cudaLaunchKernel`` and its ``Ex`` form, which
    cluster launches take), memsets and copies."""
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
               or e.key in ("cudaMemsetAsync", "cudaMemcpyAsync"))


def profiler_table(prof, path: str) -> None:
    """The profiler's table, sorted by device time, into ``path``."""
    sort_key = ("self_device_time_total"
                if hasattr(prof.key_averages()[0], "self_device_time_total")
                else "self_cuda_time_total")
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by=sort_key, row_limit=25))
