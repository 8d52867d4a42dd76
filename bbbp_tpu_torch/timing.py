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
# Issue rates measured by torch_rate_profile.py on an NVIDIA H100 80GB HBM3
# at 700.00 W (one block of 1,024 threads an SM, clock64 cycles and CUDA
# events): POPC 15.87 a clock an SM, LOP3 61.83, and the b1 tensor-core
# product mma.m16n8k256.b1.and.popc (BMMA.168256.AND.POPC in the SASS) 0.666
# a clock an SM, i.e. 21,837 bit pairs ANDed and counted.
POPC_PER_S = 4.173e12
INT32_OPS_PER_S = 1.628e13
BMMA_BIT_PAIRS_PER_S = 5.229e15


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


def _bound(n_bytes: float, ops: float, ops_ms: float = None) -> Dict[str, object]:
    """``ops_ms``: the operations' least time where they are not all f32
    operations (default: ``ops`` at the f32 rate)."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3 if ops_ms is None else ops_ms
    return {"bytes": int(n_bytes), "ops": int(ops),
            "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _intersections_ms(word_pairs: float) -> float:
    """Least time of ``word_pairs`` 32-bit ANDs and popcounts: on the faster
    of POPC (one a word pair) and the b1 tensor-core product (32 bit pairs a
    word pair), at their measured rates."""
    return min(word_pairs / POPC_PER_S, 32 * word_pairs / BMMA_BIT_PAIRS_PER_S) * 1e3


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


def _routing(n: int, parent_nodes: int) -> tuple:
    """What routing a parent split adds to a lane of a sort: the routed
    positions written (4 bytes a row), the parent's (feature, bin) table read
    and written into the tree (16 bytes a node); a compare and a
    multiply-add a row. Its xb byte a row is within the sort's xb."""
    return (4 * n + 16 * parent_nodes, 2 * n) if parent_nodes else (0, 0)


def routing_bound(n: int, parent_nodes: int, lanes: int = 1) -> Dict[str, object]:
    """What routing a parent split adds to the sort that carries it
    (``_routing``), for each lane."""
    route_bytes, route_ops = _routing(n, parent_nodes)
    return _bound(lanes * route_bytes, lanes * route_ops)


def level_histogram_bound(n: int, n_feat: int, n_nodes: int,
                          lanes: int = 1, parent_nodes: int = 0) -> Dict[str, object]:
    """xb (one byte a value, every lane's) read once; each lane's pos, g and
    h read once and its f32 (g, h) histogram written once; two adds per
    row, feature and lane; with a parent split of ``parent_nodes`` nodes,
    its routing (``_routing``)."""
    route_bytes, route_ops = _routing(n, parent_nodes)
    return _bound(n * n_feat + lanes * (12 * n + n_nodes * n_feat * 64 * 8 + route_bytes),
                  lanes * (2 * n * n_feat + route_ops))


def best_splits_bound(n_nodes: int, n_feat: int, lanes: int = 1) -> Dict[str, object]:
    """Each lane's histogram, column mask (and lambda) read once, its
    (feat, bin, has_split) written once; per (node, feature, bin) 15 f32
    operations: two running sums, the gain's two subtractions, two lambda
    adds, two squares, two divisions, one add and one subtraction, two
    min_child compares and the argmax compare."""
    return _bound(lanes * (n_nodes * n_feat * 64 * 8 + n_feat + 9 * n_nodes
                           + (4 if lanes > 1 else 0)),
                  15 * n_nodes * n_feat * 64 * lanes)


def level_splits_bound(n: int, n_feat: int, n_nodes: int, lanes: int,
                       occupied: int, parent_nodes: int = 0) -> Dict[str, object]:
    """The fused split search of one level over lanes: xb (one byte a
    value, every lane's) read once; each lane's pos, g and h (12 bytes a
    row), column mask (a byte a feature) and lambda read once, and its
    (feat, bin, has_split) written once (9 bytes a node). Operations: two
    adds per (row, feature, lane), and K4's 15 f32 operations (see
    ``best_splits_bound``) per occupied (lane, node, feature, bin), the
    ``occupied`` cells that this level's rows reach: an empty bin's gain
    repeats the bin before it, so the inputs need no more. With a parent
    split, its routing (``_routing``)."""
    route_bytes, route_ops = _routing(n, parent_nodes)
    return _bound(n * n_feat + lanes * (12 * n + n_feat + 4 + 9 * n_nodes + route_bytes),
                  lanes * (2 * n * n_feat + route_ops) + 15 * occupied)


def leaf_values_bound(n: int, n_leaves: int, next_tree: bool = False,
                      lanes: int = 1, n_feat: int = 0) -> Dict[str, object]:
    """pos, g and h read once, the margins read and written once, the leaves
    written once; two adds and one fused multiply-add (two operations) per
    row, an add and a division per leaf. With ``next_tree`` also y (every
    lane's), u and the row weights read once, the next g and h written once
    with their two maxima, and 14 operations a row (the sigmoid's exp, add
    and division, p − y, 1 − p, the product, the clamp, the mask's compare,
    four products, two maxima). Lanes: each lane's share, y once. With
    ``n_feat`` (K5 routing the last level's split, n_leaves / 2 nodes, over
    xb [n, n_feat]): the parent's table read and written into the tree (16
    bytes a node and lane), xb's byte a row and lane at the column its node
    picks, at most all of xb, and a compare and a multiply-add a row."""
    extra_bytes, extra_ops = (16 * n + 8, 14 * n) if next_tree else (0, 0)
    lane_params = 12 if lanes > 1 else 0           # lam, scale, subsample
    route_bytes, route_ops = (
        (min(lanes, n_feat) * n + lanes * 8 * n_leaves, 2 * n * lanes) if n_feat
        else (0, 0))
    return _bound(lanes * (12 * n + 8 * n + 4 * n_leaves + extra_bytes + lane_params)
                  + (4 * n if next_tree else 0) + route_bytes,
                  lanes * (4 * n + 2 * n_leaves + extra_ops) + route_ops)


# what a Threefry-2x32 block needs a draw, with what is fixed for a lane
# and a tree counted once (the first word's key add, the injections'
# constants): the second word's key add, 20 rounds of an add, a funnel
# shift and a xor, and 5 key injections of one add to each word
THREEFRY_OPS = 1 + 20 * 3 + 5 * 2
# a uniform's shift and scale; a Poisson count's binary search over the 13
# thresholds, ceil(log2(14)) = 4 compares and 4 selects
UNIFORM_OPS, POISSON_OPS = 2, 8


def forest_draws_bound(lanes: int, size: int, poisson: bool) -> Dict[str, object]:
    """K9: the seeds and the tree index read once, the f32 draws written
    once; a Threefry block a draw and its output, as 32-bit integer
    operations at the rate ``torch_rate_profile.py`` measured (LOP3)."""
    draws = lanes * size
    ops = draws * (THREEFRY_OPS + (POISSON_OPS if poisson else UNIFORM_OPS))
    return _bound(4 * draws + 8 * lanes + 8, ops, ops / INT32_OPS_PER_S * 1e3)


def topk_bound(nq: int, nr: int, words: int, k: int) -> Dict[str, object]:
    """The packed queries and references read once, (sim f32, idx int64)
    [nq, k] written once. The intersections and the row popcounts, (nq·nr +
    nq + nr)·words word pairs, on the faster unit (``_intersections_ms``:
    on an NVIDIA H100 80GB HBM3 at 700.00 W, POPC 15.87 a clock an SM and
    the b1 product 21,837 bit pairs, 43x); five f32-rate operations a pair for the
    epilogue and the selection (add, subtract, max, the threshold's
    multiply-add and compare), at the same time on the ALUs: the bound is
    the busier of the two."""
    pairs = nq * nr
    alu_ms = 5 * pairs / F32_OPS_PER_S * 1e3
    inter_ms = _intersections_ms((pairs + nq + nr) * words)
    return _bound((nq + nr) * words * 4 + nq * k * 12,
                  (pairs + nq + nr) * words + 5 * pairs, max(alu_ms, inter_ms))


def gram_bound(nq: int, nr: int, words: int, values_per_word: int = 32,
               weighted_terms: int = 0) -> Dict[str, object]:
    """Both packed operands (and the weights, where given) read once, the f32
    [nq, nr] result written once; four f32-rate operations a pair for the
    epilogue.

    Bits without weights: the intersections and row popcounts, (nq·nr + nq
    + nr)·words word pairs, on the faster unit (``_intersections_ms``: on an
    NVIDIA H100 80GB HBM3 at 700.00 W, POPC 15.87 a clock an SM and the b1
    product 21,837 bit pairs, 43x), the epilogue on the ALUs at the same
    time. Bits with weights
    (``weighted_terms``: the (pair, set bit of a AND b) terms, one f32
    multiply-add, two operations, each): the b1 product cannot weigh, so an
    AND a word pair at the integer rate beside the terms and the epilogue
    at the f32 rate.

    Counts (K8: four a word; ``weighted_terms`` the (pair, count)
    products): a byte-wise minimum and a dot product with ones a word pair
    (two operations) at the f32 rate. The minimum is counted
    as one operation, though on sm_90a ``__vminu4`` is about six
    instructions (LOP3, SHF, PRMT, IMAD.IADD before the IDP.4A, by
    ``cuobjdump -sass``), while ``__vsadu4`` (VABSDIFF4.U8.ACC) is one,
    which K8 uses instead."""
    pairs = nq * nr
    w_bytes = words * values_per_word * 4 if weighted_terms else 0
    n_bytes = (nq + nr) * words * 4 + w_bytes + pairs * 4
    if values_per_word != 32:
        return _bound(n_bytes, pairs * (2 * words + 4) + 2 * weighted_terms)
    alu_ms = (4 * pairs + 2 * weighted_terms) / F32_OPS_PER_S * 1e3
    if weighted_terms:
        and_ms = pairs * words / INT32_OPS_PER_S * 1e3
        return _bound(n_bytes, pairs * (words + 4) + 2 * weighted_terms,
                      max(alu_ms, and_ms))
    inter_ms = _intersections_ms((pairs + nq + nr) * words)
    return _bound(n_bytes, (pairs + nq + nr) * words + 4 * pairs,
                  max(alu_ms, inter_ms))


def topk_bound_old(nq: int, nr: int, words: int, k: int) -> Dict[str, object]:
    """K6's former bound, kept beside ``topk_bound`` so that both yardsticks
    can be read: per pair three integer operations a word
    (AND, popcount, add) and five for the epilogue, all at the f32 rate."""
    return _bound((nq + nr) * words * 4 + nq * k * 12,
                  nq * nr * (3 * words + 5))


def gram_bound_old(nq: int, nr: int, words: int,
                   weighted_terms: int = 0) -> Dict[str, object]:
    """K7's former bound, kept beside ``gram_bound`` so that both yardsticks
    can be read: three integer operations a pair and word, four
    for the epilogue and two a weighted term, all at the f32 rate."""
    w_bytes = words * 32 * 4 if weighted_terms else 0
    return _bound((nq + nr) * words * 4 + w_bytes + nq * nr * 4,
                  nq * nr * (3 * words + 4) + 2 * weighted_terms)


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
    cluster launches take), memsets, copies and CUDA graph launches (a
    replay)."""
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel",
                                    "cudaGraphLaunch"))
               or e.key in ("cudaMemsetAsync", "cudaMemcpyAsync"))


def profiler_table(prof, path: str) -> None:
    """The profiler's table, sorted by device time, into ``path``."""
    sort_key = ("self_device_time_total"
                if hasattr(prof.key_averages()[0], "self_device_time_total")
                else "self_cuda_time_total")
    with open(path, "w") as f:
        f.write(prof.key_averages().table(sort_by=sort_key, row_limit=25))
