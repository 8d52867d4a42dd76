#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``bbbp_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (a failing check raises, so the script exits non-zero
before its last line):

1. environment: the card, torch and CUDA versions, TF32 off; builds both
   native libraries from the checkout's sources and prints the seconds;
2. kernel 1 (``packed_project``) against its plain version on the card
   (k = 30, 50 and 64, one column pair a lane and two; k = 31, unaligned
   pairs; k = 200 and 1001, two and eight column slices; d = 2000;
   all-ones and all-zero rows), then timed on 5%-random words and on the
   fingerprints of ``synthetic_smiles(16384, seed=1)``;
3. kernel 2 (``dense_forest_predict``, via ``raw_predict``) against its
   plain version on the card (depth 0, 1, 6, 8 and 12, F = 30 and 2048,
   T = 300 and 301; the aux forests' F = 326 with 400 trees of depth 6 and
   300 of depth 10), then timed on the z of the random words and of the
   fingerprints, and at F = 326 on 1,058 and 7,809 rows;
4. the slice: ``screen()`` on ``cuda`` with the full-width fixture model over
   65,536 + a ragged tail of ``synthetic_smiles`` and 3 invalid SMILES; both
   kernels' launch counters must move, and the first 2,048 rows must match
   ``screen(device="cpu")``;
5. the trainer's kernels (``ops/forest_train.py``: K3 ``level_histogram``,
   K4 ``best_splits``, K5 ``leaf_values``) against their plain versions on
   the card, for n = 1, 7,809 and 65,536 rows, F = 30, 167, 300 and 326
   features (and F = 1) and levels 0, 5 and 9, with zero-weight rows,
   constant features (exact ties), column masks, oblivious mode and
   min_child masking, then matrices whose features have 1, 2, 3 and 64
   occupied bins with skewed node sizes, every row in one node of level 9,
   and rows that all weigh 0: K3 bit-equal to its fixed-point plain version
   with and without ``n_bins``, within one f32 rounding of the exact
   (float64) sum and bit-identical over two runs, a wrong ``n_bins``
   refused; K4 equal to the plain version but at counted near ties (their
   largest score gap is K4's max_abs_err), also with the best feature
   masked out and with no valid split in the level; K5 at n = 1, 7,809
   and 65,536 with 1, 64 and 1,024 leaves bit-equal to its fixed-point
   plain version and within 1e-6 relative of the float64 sums, and with
   the next tree (reg and cls, subsample 1 and 0.8, weights 0 and 1) its
   g, h and bounds bit-equal to the torch ops; then each timed at the
   training path's shapes (n = 7,809 and 65,536, F = 30, every level of
   depth 6; K5 alone and with the next tree's gradients) and the transfer
   path's (n = 7,809, F = 326, levels 0, 5 and
   9; K4 also in oblivious mode; K5 with 1,024 leaves) beside its plain
   version, its bound and, for K3, ``index_add_`` (the one PyTorch call for
   the same function) and ``torch.bincount`` twice;
6. training: ``ScreeningModel.train`` on ``cuda`` at full width over the
   7,809-molecule labelled set (``testing.labelled_training_set``), with
   every trainer kernel's launch count (300 trees × 6 levels); a second fit
   with the same seed must grow the same trees; the host's launch calls of
   one fit of its forest under ``torch.profiler``; ``GBDTClassifier
   (subsample=1)`` on the same z on ``cuda`` and ``cpu`` must grow the same
   trees up to equivalent splits and a counted near tie; training accuracy
   above the majority share; and ``screen()`` with the trained model on
   ``cuda`` against ``cpu`` on a prefix of molecules not in the training
   set, under phase 4's near-tie rule (at most 1% near-tie rows);
7. the similarity kernels (``ops/similarity.py``: K6 ``tanimoto_topk``,
   K7 ``tanimoto_gram``, K8 ``minmax_gram``) against their plain versions
   on the card, on the MACCS bits, Morgan bits and Morgan counts of the
   7,809 labelled molecules and of 1,058 further ones
   (``testing.regression_molecules``): the transfer path's shapes (1,058
   queries against 7,809 rows, d = 167, k = 25), a regression fold's
   (106 against 952, d = 167 and 2048, k = 10), the full grams (1,058 x
   1,058), Nq = 1, Nr = 1, k = 1, k = Nr, k = 1,024, zero rows, forced
   ties, distinct fractions equal in f32 at the k-th place (65,536 bits),
   k = 1 / 25 / 1,024 with Nr no multiple of a chunk, rows of 6 words that
   are not 16-byte aligned (``packed_bits`` pads to 4 words), IDF weights, counts
   above the clip, for K7 36 ragged shapes (Nq, Nr in 1 / 33 / 127 / 1,058,
   1 / 6 / 7 / 42 / 64 / 2,048 words) and for K8 18 (1 / 42 / 512 words).
   K6's indices equal and its similarities bit-equal, K7 and K8 bit-equal
   without weights and within 1e-5 with (weighted twice bit-identical); the
   host's launch calls of one profiled call (K6 and unweighted K7: one);
   then each timed beside its plain version, its bound (and for K6 and K7
   the former count's), and a
   library form (one ``torch.matmul`` on operands already unpacked, with
   the epilogue; for K6 followed by ``torch.topk``, which orders ties
   otherwise);
8. the transfer path: first a ``GBDTClassifier(subsample=1)`` fit of 30
   trees on ``cuda`` over the aux molecules' 326 features, audited node by
   node along its own splits against the plain arithmetic as in phase 6,
   the same for an oblivious fit of 30 trees (a level's summed gains),
   its margins through the forest kernel against the plain version, and
   K3 (bit-equal to its fixed-point plain version there too) and K4 timed
   on its own binned rows (MACCS bits fill two bins a feature) at levels 0,
   5 and 9;
   then ``transfer_features`` on ``cuda`` at full width (all
   four models, 400/400/300 trees, k = 25, holdout 0.1) with the labelled
   set as the aux data and the 1,058 molecules as the regression set: the
   launches of every kernel, the four holdout AUCs (each above 0.6), the
   wall time by stage, the ``transfer_tknn`` column within 1e-6 of a
   ``cpu`` run, and the cache file read back. Then the regression stack's
   three chemistry-kernel legs on the 1,058 molecules with a seeded target,
   10 folds (``TanimotoKNNRegressor``, ``TanimotoKernelRidge``,
   ``ChemKernelRidge``, one fold more with IDF weights, and both
   ``full_gram``s), ``cuda`` against ``cpu``: kNN within 1e-5, ridge within
   2e-3 (two f32 Cholesky solves), grams within 1e-5.

Then one JSON line for the kernels (each with its time and its plain
version's, its bound from ``bbbp_tpu_torch/timing.py`` and a library
yardstick where one PyTorch call computes the same function; the
projection's ``torch.addmm`` on bits already unpacked is the product alone,
and the ``*_fingerprints`` keys hold its times on the fingerprints), the
card's ``nvidia-smi`` line, and as the last line
``{"ok": true, "device": {...}}``. There is no CPU fallback: without a CUDA
device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import csv
import ctypes
import json
import os
import signal
import sys
import tempfile
import time

import numpy as np

SLICE_N = 65536 + 1000            # 4 full chunks of 16,384 and a ragged tail
CHUNK = 16384
PREFIX = 2048
INVALID = ("NOT_A_SMILES((", "C1CC", "[Xx]")
TRAIN_ROWS = (7809, 65536)        # B3DB classification's size, and a larger one
TRAIN_DEPTH = 6
TRAIN_F = 30
WIDE_F = 326                      # the transfer path's aux features
WIDE_LEVELS = (0, 5, 9)           # depth 6 (gbdt, oblivious) and depth 10 (rf)
WIDE_FORESTS = ((6, 400), (10, 300))      # (depth, trees) of the aux forests
AUDIT_TREES = 30

REG_FOLDS = 10
FOLD_ROWS = 106                   # a tenth of B3DB regression's 1,058 rows
AUC_FLOOR = 0.6
LEVELS = 16


def read_csv(path: str):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if rows[0] != ["ID", "SMILES", "Prediction", "Probability"]:
        raise AssertionError(f"bad CSV header {rows[0]}")
    return rows[1:]


def screen_against_cpu(model, ensemble_state, mols, gpu_csv, cpu_csv,
                       max_near_share=0.01):
    """Runs ``screen(device="cpu")`` over the first PREFIX molecules and
    holds the cuda run's rows against it: rows may differ only where a path
    meets a threshold within 1e-5 (the two sum z in different orders), and
    such rows are at most ``max_near_share`` (None: no cap). Returns (rows
    that differ, near-tie rows, largest |dProbability| elsewhere)."""
    import torch

    from bbbp_tpu_torch.native.bindings import fingerprints_packed
    from bbbp_tpu_torch.ops.bitops import packed_project_reference
    from bbbp_tpu_torch.pipelines.screen import screen
    from bbbp_tpu_torch.testing import near_tie_rows

    screen(model, iter(mols[:PREFIX]), out_csv=cpu_csv, chunk_size=PREFIX,
           device="cpu")
    gpu_rows, cpu_rows = read_csv(gpu_csv), read_csv(cpu_csv)
    packed_np, _ = fingerprints_packed([s for s, _ in mols[:PREFIX]])
    z_cpu = packed_project_reference(torch.from_numpy(packed_np.view(np.int32)),
                                     model.proj_w.cpu(), model.proj_c0.cpu())
    near = near_tie_rows(ensemble_state, z_cpu.numpy())
    mism, worst = [], 0.0
    for i, (g, c) in enumerate(zip(gpu_rows[:PREFIX], cpu_rows)):
        if g[2] == "invalid" or c[2] == "invalid":
            if g[2:] != c[2:]:
                mism.append(i)
            continue
        diff = abs(float(g[3]) - float(c[3]))
        if g[2] != c[2] or diff > 1e-4 + 1e-9:
            mism.append(i)
        else:
            worst = max(worst, diff)
    if any(not near[i] for i in mism) or (
            max_near_share is not None and near.mean() > max_near_share):
        raise AssertionError(f"cuda vs cpu prefix: rows {mism} differ; near-tie "
                             f"rows {int(near.sum())}")
    return mism, int(near.sum()), worst


def ulp_gap(a, b) -> int:
    """Largest distance of two f32 tensors in units in the last place."""
    import torch

    if not a.numel():
        return 0
    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


def fmt(values):
    return "[" + ", ".join(f"{v:.4f}" for v in values) + "]"


def level_case(n, n_feat, level, seed, device):
    """Binned rows (two constant features, so whole features tie exactly),
    node positions, and gradients/hessians with 20% zero-weight rows."""
    import torch

    r = np.random.default_rng(seed)
    xb = r.integers(0, 64, (n, n_feat), dtype=np.uint8)
    xb[:, :2] = 9
    pos = r.integers(0, 1 << level, n).astype(np.int32)
    g = r.normal(size=n).astype(np.float32)
    h = r.uniform(0.05, 0.3, n).astype(np.float32)
    zero = r.random(n) < 0.2
    g[zero] = 0.0
    h[zero] = 0.0
    return [torch.from_numpy(a).to(device) for a in (xb, pos, g, h)]


def index_add_call(xb, pos, g, h, nodes):
    """One ``index_add_`` that computes K3's function, its keys and values
    made beforehand (the call ``level_histogram_reference`` ends in)."""
    import torch

    n, n_feat = xb.shape
    keys = (pos.long()[:, None] * (n_feat * 64)
            + torch.arange(n_feat, device=xb.device)[None, :] * 64
            + xb.long()).reshape(-1)
    vals = torch.stack([g, h], dim=1)[:, None, :].expand(n, n_feat, 2).reshape(-1, 2)
    return lambda: torch.zeros((nodes * n_feat * 64, 2), device=xb.device
                               ).index_add_(0, keys, vals)


def split_mismatches(tr, hist, mask, min_child, oblivious, got, want):
    """Nodes where the kernel's split differs from the plain version's; each
    must be a near tie (the two candidates' scores within 1e-6 of the
    node's largest |score|), or this raises. Returns their count and the
    largest |score(kernel split) - score(plain split)| among them (0 when
    every node is equal)."""
    import torch

    differ = ~((got[0] == want[0]) & (got[1] == want[1]) & (got[2] == want[2]))
    if not bool(differ.any()):
        return 0, 0.0
    gain, valid = tr.split_gains(hist, mask, 1.0, min_child)
    if oblivious:
        score = torch.where(valid & (gain > 0), gain, torch.zeros_like(gain)).sum(0)
        score = torch.where(valid.any(0), score, -torch.inf).reshape(1, -1)
    else:
        score = torch.where(valid, gain, -torch.inf).reshape(hist.shape[0], -1)
    worst = 0.0
    for node in torch.nonzero(differ).flatten().tolist():
        row = score[0 if oblivious else node]
        a = row[int(got[0][node]) * 64 + int(got[1][node])]
        b = row[int(want[0][node]) * 64 + int(want[1][node])]
        scale = float(row[torch.isfinite(row)].abs().max())
        if not (got[2][node] and want[2][node]) or abs(float(a - b)) > 1e-6 * scale:
            raise AssertionError(f"best_splits node {node}: kernel "
                                 f"{[int(t[node]) for t in got]}, plain "
                                 f"{[int(t[node]) for t in want]}")
        worst = max(worst, abs(float(a - b)))
    return int(differ.sum()), worst


def hold_level(tr, label, xb, pos, g, h, n_bins, nodes, rng, held):
    """K3 and K4 on one level's inputs against their plain versions.
    K3: bit-equal to the fixed-point plain version with and without
    ``n_bins``, two runs bit-identical, within one f32 rounding of the
    float64 sum. K4 on K3's histogram: per node and oblivious, with column
    masks and min_child, with the plain version's best feature masked out,
    and with a min_child no bin reaches; equal to the plain version but at
    near ties, which ``split_mismatches`` counts."""
    import torch

    n, n_feat = xb.shape
    bounds = tr.gradient_bounds(g, h)
    hist = tr.level_histogram(xb, pos, g, h, nodes)
    again = tr.level_histogram(xb, pos, g, h, nodes, bounds)
    with_bins = tr.level_histogram(xb, pos, g, h, nodes, bounds, n_bins)
    fixed = tr.level_histogram_fixed_reference(xb, pos, g, h, nodes, bounds)
    torch.cuda.synchronize()
    if not torch.equal(hist, again):
        raise AssertionError(f"level_histogram {label}: two runs differ")
    if not (torch.equal(hist, fixed) and torch.equal(with_bins, fixed)):
        raise AssertionError(
            f"level_histogram {label}: differs from its fixed-point plain version "
            f"in {int((hist != fixed).sum())} bins, with n_bins in "
            f"{int((with_bins != fixed).sum())}")
    del again, with_bins, fixed
    exact = tr.level_histogram_reference(xb, pos, g.double(), h.double(), nodes)
    plain = tr.level_histogram_reference(xb, pos, g, h, nodes)
    vmax = max(float(g.abs().max()), float(h.abs().max()))
    err = (hist.double() - exact).abs()
    if bool((err > 2.4e-7 * exact.abs() + 1e-9 * n * vmax).any()):
        raise AssertionError(f"level_histogram {label}: max |err| "
                             f"{float(err.max()):.3g}")
    held["k3_cases"] += 1
    held["k3_err"] = max(held["k3_err"], float(err.max()))
    held["k3_err_plain"] = max(held["k3_err_plain"], float((hist - plain).abs().max()))
    del exact, plain, err

    def hold_splits(mask, min_child, obl):
        got = tr.best_splits(hist, mask, 1.0, min_child, obl)
        want = tr.best_splits_reference(hist, mask, 1.0, min_child, obl)
        near, worst = split_mismatches(tr, hist, mask, min_child, obl, got, want)
        held["k4_near"] += near
        held["k4_err"] = max(held["k4_err"], worst)
        held["k4_calls"] += 1
        return want

    every = torch.ones(n_feat, dtype=torch.bool, device=xb.device)
    for share, obl, min_child in ((1.0, False, 1.0), (0.5, False, 1.0),
                                  (1.0, False, 4.0), (1.0, True, 1.0),
                                  (0.5, True, 4.0)):
        mask = torch.from_numpy(rng.random(n_feat) < share)
        mask[-1] = True
        want = hold_splits(mask.to(xb.device), min_child, obl)
        if share == 1.0 and min_child == 1.0 and n_feat > 1:
            without_best = every.clone()        # the level's (or node 0's) winner
            without_best[int(want[0][0])] = False
            hold_splits(without_best, min_child, obl)
    for obl in (False, True):                   # no bin holds this much
        want = hold_splits(every, 1e9, obl)
        if bool(want[2].any()):
            raise AssertionError(f"best_splits {label}: a split at min_child 1e9")


def time_leaf_values(tr, pos, g, h, n_leaves, bounds):
    """K5's times on one tree's rows: the leaves alone (as the random forest
    and a fit's last tree call it) and with the next boosted tree's
    gradients (every other tree of a boosted fit), each beside its plain
    version and its bound."""
    import torch

    from bbbp_tpu_torch.timing import device_ms, leaf_values_bound

    n = pos.shape[0]
    margins = torch.zeros(n, device=pos.device)
    y = (torch.rand(n, device=pos.device) < 0.4).float()
    nxt = tr.NextTree(y, torch.rand(n, device=pos.device), 0.8,
                      torch.ones(n, device=pos.device), "cls")
    return {"k5": device_ms(lambda: tr.leaf_values(pos, g, h, n_leaves, 1.0, 0.1,
                                                   margins, bounds)),
            "k5_plain": device_ms(lambda: tr.leaf_values_reference(
                pos, g, h, n_leaves, 1.0, 0.1, margins)),
            "k5_bound": leaf_values_bound(n, n_leaves),
            "k5_next": device_ms(lambda: tr.leaf_values(pos, g, h, n_leaves, 1.0, 0.1,
                                                        margins, bounds, nxt)),
            "k5_next_plain": device_ms(lambda: (
                tr.leaf_values_reference(pos, g, h, n_leaves, 1.0, 0.1, margins),
                tr.next_gradients_reference(margins, *nxt))),
            "k5_next_bound": leaf_values_bound(n, n_leaves, next_tree=True)}


def similarity_phase(cuda, card, aux_raw, reg_raw):
    """Phase 7. ``aux_raw`` and ``reg_raw`` are (descriptors, MACCS, Morgan
    counts) of the labelled and the regression molecules. Returns the
    kernels' errors, times and bounds."""
    import torch

    from torch.profiler import ProfilerActivity, profile

    from bbbp_tpu_torch.ops import similarity as sm
    from bbbp_tpu_torch.ops.bitops import pack_bits
    from bbbp_tpu_torch.testing import (EQUAL_F32_K, count_case,
                                        tanimoto_equal_f32_case, tanimoto_tie_case)
    from bbbp_tpu_torch.timing import (device_ms, gram_bound, gram_bound_old,
                                       host_launch_calls, topk_bound, topk_bound_old)

    aux_m, reg_m = sm.packed_bits(aux_raw[1], cuda), sm.packed_bits(reg_raw[1], cuda)
    reg_b = sm.packed_bits(reg_raw[2], cuda)              # Morgan bits, 64 words
    reg_c = sm.pack_counts(reg_raw[2], LEVELS, cuda)    # counts, 512 words
    w_m, w_b, _ = sm.ChemKernelRidge.idf_weights(reg_raw[1], reg_raw[2])
    w_m = sm.pad_weights(w_m, reg_m.shape[1] * 32, cuda)
    w_b = sm.pad_weights(w_b, reg_b.shape[1] * 32, cuda)
    n = reg_m.shape[0]
    fold = FOLD_ROWS

    def tied_queries(q, r, k, sim):
        """Queries with more references at the k-th similarity than the
        top k hold: there the tie order decides the indices."""
        full = sm.tanimoto_gram_reference(q, r)
        kth = sim[:, k - 1:k]
        return int(((full == kth).sum(1) > (sim == kth).sum(1)).sum())

    tie_q, tie_r = (sm.packed_bits(a, cuda) for a in tanimoto_tie_case(7, 60, 3000, 167))
    small_q, small_r = (sm.packed_bits(a, cuda) for a in tanimoto_tie_case(8, 33, 40, 40))
    topk_cases = [("transfer", reg_m, aux_m, 25),
                  ("fold d=167", reg_m[:fold], reg_m[fold:], 10),
                  ("fold d=2048", reg_b[:fold], reg_b[fold:], 10),
                  ("Nq=1 k=64", reg_m[:1], aux_m, 64),
                  ("Nr=1 k=1", reg_m[:17], aux_m[:1], 1),
                  ("k=Nr=40", small_q, small_r, 40),
                  ("forced ties", tie_q, tie_r, 25),
                  ("k=1024", reg_m[:9], aux_m, 1024)]
    # distinct fractions that round to one f32 at the k-th place (65,536
    # bits); k = 1, 25, 1,024 with Nr no multiple of a chunk or a split
    eq_q, eq_r = (sm.packed_bits(a, cuda) for a in tanimoto_equal_f32_case(0))
    topk_cases.append(("equal f32 d=65536", eq_q, eq_r, EQUAL_F32_K))
    for k, nr in ((1, 1031), (25, 7813), (1024, 3001)):
        q, r = (sm.packed_bits(a, cuda) for a in tanimoto_tie_case(k + nr, 37, nr, 167))
        topk_cases.append((f"k={k} Nr={nr}", q, r, k))
    # rows of 6 words, not 16-byte aligned, as a caller may pass them
    q, r = (torch.from_numpy(pack_bits(a).view(np.int32)).to(cuda)
            for a in tanimoto_tie_case(9, 37, 7813, 167))
    topk_cases.append(("6-word rows k=25 Nr=7813", q, r, 25))
    ties = {}
    k6_err = 0.0
    for name, q, r, k in topk_cases:
        sim, idx = sm.tanimoto_topk_packed(q, r, k)
        want_sim, want_idx = sm.tanimoto_topk_reference(q, r, k)
        torch.cuda.synchronize()
        k6_err = max(k6_err, float((sim - want_sim).abs().max()))
        if not (torch.equal(idx, want_idx) and torch.equal(sim, want_sim)):
            raise AssertionError(
                f"tanimoto_topk {name}: {int((idx != want_idx).sum())} indices "
                f"differ, max |dsim| {float((sim - want_sim).abs().max()):.3g}")
        if name in ("transfer", "forced ties"):
            ties[name] = (tied_queries(q, r, k, want_sim), q.shape[0])
    if min(t for t, _ in ties.values()) == 0:
        raise AssertionError(f"no ties at the k-th place to decide: {ties}")

    def held(name, fn, ref, q, r, w):
        """max |kernel - plain|: 0 demanded without weights, 1e-5 with."""
        got, want = fn(q, r, w), ref(q, r, w)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        if (w is None and not torch.equal(got, want)) or err > 1e-5:
            raise AssertionError(f"{name} {tuple(got.shape)}: max |err| {err:.3g}")
        return err

    k7_err = k8_err = 0.0
    gram_cases = [(reg_m, reg_m, w_m), (reg_b, reg_b, w_b),
                  (reg_b[:fold], reg_b[fold:], w_b), (reg_m[:1], aux_m, w_m),
                  (reg_m[:17], aux_m[:1], w_m), (tie_q, tie_r, w_m)]
    for q, r, w in gram_cases:
        held("tanimoto_gram", sm.tanimoto_gram, sm.tanimoto_gram_reference, q, r, None)
        k7_err = max(k7_err, held("tanimoto_gram (weighted)", sm.tanimoto_gram,
                                  sm.tanimoto_gram_reference, q, r, w))
        if not torch.equal(sm.tanimoto_gram(q, r, w), sm.tanimoto_gram(q, r, w)):
            raise AssertionError(f"tanimoto_gram (weighted) {tuple(q.shape)} x "
                                 f"{tuple(r.shape)}: two runs differ")
    # unweighted at ragged shapes: rows that fill no tile, slabs padded with
    # zeros (1, 6, 7 words), rows not 16-byte aligned, clusters of 1, 2, 8
    k7_ragged = [(nq, nr, words) for nq, nr in ((1, 1), (33, 127), (127, 33),
                                                (1058, 1), (1, 1058), (127, 1058))
                 for words in (1, 6, 7, 42, 64, 2048)]
    rng_k7 = np.random.default_rng(17)
    for nq, nr, words in k7_ragged:
        q, r = (torch.from_numpy(pack_bits(rng_k7.random((n, 32 * words)) < 0.3
                                           ).view(np.int32)).to(cuda) for n in (nq, nr))
        q[0] = 0
        held("tanimoto_gram", sm.tanimoto_gram, sm.tanimoto_gram_reference, q, r, None)

    def launch_calls(fn):
        """The host's launch calls of one call of ``fn``, from the profiler."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return host_launch_calls(prof)

    calls = {"tanimoto_topk": launch_calls(lambda: sm.tanimoto_topk_packed(reg_m, aux_m, 25)),
             "tanimoto_gram": launch_calls(lambda: sm.tanimoto_gram(reg_b, reg_b)),
             "tanimoto_gram_weighted": launch_calls(lambda: sm.tanimoto_gram(reg_b, reg_b, w_b))}
    if calls["tanimoto_topk"] != 1 or calls["tanimoto_gram"] != 1:
        raise AssertionError(f"host launch calls a call {calls}: K6 and unweighted K7 "
                             f"must be one launch")

    def minmax_ref(levels):
        return lambda q, r, w: sm.minmax_gram_reference(q, r, w, levels)

    high = [sm.pack_counts(count_case(s, rows, d, 41), 8, cuda)
            for s, rows, d in ((1, 70, 2048), (2, 45, 2048), (3, 23, 30), (4, 19, 30))]
    w_c = sm.pad_weights(sm.ChemKernelRidge.idf_weights(reg_raw[1], reg_raw[2])[2],
                          reg_c.shape[1] * 4, cuda)
    count_cases = [(reg_c, reg_c, w_c, LEVELS), (reg_c[:fold], reg_c[fold:], w_c, LEVELS),
                   (reg_c[:1], reg_c, w_c, LEVELS), (high[0], high[1], w_c, 8),
                   (high[2], high[3], w_c[:high[2].shape[1] * 4].contiguous(), 8)]
    # ragged shapes: rows that fill no 64-row tile, words that fill no
    # 16-word stage or are not 16-byte aligned (42 words)
    ragged = [(nq, nr, words) for nq, nr in ((1, 1), (33, 127), (127, 33),
                                             (1058, 1), (1, 1058), (127, 1058))
              for words in (1, 42, 512)]
    rng7 = np.random.default_rng(7)
    for nq, nr, words in ragged:
        q = sm.pack_counts(count_case(nq + words, nq, 4 * words, 20), LEVELS, cuda)
        r = sm.pack_counts(count_case(nr + 2 * words, nr, 4 * words, 20), LEVELS, cuda)
        w = torch.from_numpy(rng7.uniform(0.1, 3.0, 4 * words).astype(np.float32)
                             ).to(cuda)
        count_cases.append((q, r, w, LEVELS))
    for q, r, w, levels in count_cases:
        held("minmax_gram", sm.minmax_gram, minmax_ref(levels), q, r, None)
        k8_err = max(k8_err, held("minmax_gram (weighted)", sm.minmax_gram,
                                  minmax_ref(levels), q, r, w))
        if not torch.equal(sm.minmax_gram(q, r, w), sm.minmax_gram(q, r, w)):
            raise AssertionError(f"minmax_gram (weighted) {tuple(q.shape)} x "
                                 f"{tuple(r.shape)}: two runs differ")

    # -- times: the kernel, its plain version, a library form, the bound
    def floats(words_, d):
        from bbbp_tpu_torch.ops.bitops import unpack_bits_reference
        return unpack_bits_reference(words_, d).contiguous()

    def library_tanimoto(qf, rf, k=None):
        inter = qf @ rf.T
        union = qf.sum(1)[:, None] + rf.sum(1)[None, :] - inter
        sim = inter / torch.clamp(union, min=1e-9)
        return sim if k is None else torch.topk(sim, k, dim=1)

    timed = {}
    aux_mf, reg_mf, reg_bf = floats(aux_m, 167), floats(reg_m, 167), floats(reg_b, 2048)
    k6_shapes = {"transfer": (reg_m, aux_m, reg_mf, aux_mf, 25),
                 "fold_d167": (reg_m[:fold], reg_m[fold:], reg_mf[:fold], reg_mf[fold:], 10),
                 "fold_d2048": (reg_b[:fold], reg_b[fold:], reg_bf[:fold], reg_bf[fold:], 10)}
    for name, (q, r, qf, rf, k) in k6_shapes.items():
        timed["k6", name] = {
            "ms": device_ms(lambda: sm.tanimoto_topk_packed(q, r, k)),
            "plain_ms": device_ms(lambda: sm.tanimoto_topk_reference(q, r, k)),
            "library_ms": device_ms(lambda: library_tanimoto(qf, rf, k)),
            "bound": topk_bound(q.shape[0], r.shape[0], q.shape[1], k),
            "bound_old": topk_bound_old(q.shape[0], r.shape[0], q.shape[1], k),
            "shape": f"Nq={q.shape[0]}, Nr={r.shape[0]}, d={qf.shape[1]}, k={k}"}
    # the full grams (weighted too), then a fold's fit (952²) and prediction
    # (106 x 952) grams
    k7_shapes = {"gram_d2048": (reg_b, reg_b, reg_bf, reg_bf, w_b),
                 "gram_d167": (reg_m, reg_m, reg_mf, reg_mf, w_m),
                 "fold_fit_d2048": (reg_b[fold:], reg_b[fold:], reg_bf[fold:], reg_bf[fold:], None),
                 "fold_predict_d2048": (reg_b[:fold], reg_b[fold:], reg_bf[:fold], reg_bf[fold:], None),
                 "fold_fit_d167": (reg_m[fold:], reg_m[fold:], reg_mf[fold:], reg_mf[fold:], None),
                 "fold_predict_d167": (reg_m[:fold], reg_m[fold:], reg_mf[:fold], reg_mf[fold:], None)}
    for name, (q, r, qf, rf, w) in k7_shapes.items():
        nq, nr = q.shape[0], r.shape[0]
        timed["k7", name] = {
            "ms": device_ms(lambda: sm.tanimoto_gram(q, r)),
            "plain_ms": device_ms(lambda: sm.tanimoto_gram_reference(q, r)),
            "library_ms": device_ms(lambda: library_tanimoto(qf, rf)),
            "bound": gram_bound(nq, nr, q.shape[1]),
            "bound_old": gram_bound_old(nq, nr, q.shape[1]),
            "shape": f"Nq={nq}, Nr={nr}, d={qf.shape[1]}"}
        if w is not None:
            set_terms = int((qf @ rf.T).sum().item())
            timed["k7", name].update({
                "ms_weighted": device_ms(lambda: sm.tanimoto_gram(q, r, w)),
                "plain_ms_weighted": device_ms(
                    lambda: sm.tanimoto_gram_reference(q, r, w)),
                "bound_weighted": gram_bound(nq, nr, q.shape[1], 32, set_terms)})
    counts_f = sm.unpack_counts_reference(reg_c)
    level_rows = torch.cat([(counts_f >= t).float() for t in range(1, LEVELS + 1)],
                           dim=1)                       # [n, 16 * 2048]
    row_sums = counts_f.sum(1)

    def library_minmax():
        inter = level_rows @ level_rows.T
        union = row_sums[:, None] + row_sums[None, :] - inter
        return inter / torch.clamp(union, min=1e-9)

    if not torch.equal(library_minmax(), sm.minmax_gram(reg_c, reg_c)):
        raise AssertionError("the level-stacked matmul differs from minmax_gram")
    nonzero_terms = int((level_rows[:, :2048] @ level_rows[:, :2048].T).sum().item())
    timed["k8", "gram"] = {
        "ms": device_ms(lambda: sm.minmax_gram(reg_c, reg_c)),
        "plain_ms": device_ms(lambda: sm.minmax_gram_reference(reg_c, reg_c, None,
                                                                LEVELS)),
        "library_ms": device_ms(library_minmax),
        "bound": gram_bound(n, n, reg_c.shape[1], 4),
        "ms_weighted": device_ms(lambda: sm.minmax_gram(reg_c, reg_c, w_c)),
        "plain_ms_weighted": device_ms(
            lambda: sm.minmax_gram_reference(reg_c, reg_c, w_c, LEVELS)),
        "bound_weighted": gram_bound(n, n, reg_c.shape[1], 4, nonzero_terms),
        "shape": f"Nq=Nr={n}, d=2048 counts clipped at {LEVELS}"}

    def line(t):
        return (f"{t['shape']}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f}, "
                f"library {t['library_ms']:.4f}, bound {t['bound']['bound_ms']:.5f} "
                f"({t['bound']['bound_by']})" + (
                    f", former bound {t['bound_old']['bound_ms']:.5f}"
                    if "bound_old" in t else "") + (
                    f"; weighted kernel {t['ms_weighted']:.4f}, plain "
                    f"{t['plain_ms_weighted']:.4f}, bound "
                    f"{t['bound_weighted']['bound_ms']:.5f}" if "ms_weighted" in t else ""))

    print(f"[7 similarity kernels] tanimoto_topk {len(topk_cases)} cases "
          f"({[c[0] for c in topk_cases]}): indices equal, similarities "
          f"bit-equal; queries with ties at the k-th place "
          f"{ {k: f'{a} of {b}' for k, (a, b) in ties.items()} } | tanimoto_gram "
          f"{len(gram_cases)} cases bit-equal without weights, max |err| "
          f"{k7_err:.3g} with IDF weights (limit 1e-5), weighted twice "
          f"bit-identical; {len(k7_ragged)} ragged unweighted (Nq, Nr in 1 / 33 / "
          f"127 / 1,058, words in 1 / 6 / 7 / 42 / 64 / 2,048) bit-equal | host "
          f"launch calls a call {calls} | minmax_gram "
          f"{len(count_cases)} cases (counts up to 40, clip 16 and 8; "
          f"{len(ragged)} ragged: Nq, Nr in 1 / 33 / 127 / 1,058, words in "
          f"1 / 42 / 512) bit-equal without weights, max |err| {k8_err:.3g} "
          f"with (limit 1e-5), weighted twice bit-identical | on {card}",
          flush=True)
    for (kernel, shape), t in timed.items():
        print(f"[7 similarity kernels] {kernel} {shape}: {line(t)}", flush=True)
    return {"k6_err": k6_err, "k7_err": k7_err, "k8_err": k8_err, "timed": timed,
            "launch_calls": calls}


def r2(y, pred):
    return 1.0 - float(((y - pred) ** 2).sum() / ((y - y.mean()) ** 2).sum())


def wide_fit_audit(card, aux, aux_raw):
    """Phase 8, first part: the trainer's kernels and the forest kernel on
    the transfer path's own 326-feature matrix. A deterministic
    ``GBDTClassifier`` fit on ``cuda`` is replayed on the CPU along its own
    splits (every node against the plain best split, every leaf against the
    plain leaf values), its margins come through the forest kernel and
    the plain version, and K3 and K4 are timed on its binned rows."""
    import torch

    from bbbp_tpu_torch.ops.forest import dense_predict_reference, raw_predict
    from bbbp_tpu_torch.ops import forest_train as tr
    from bbbp_tpu_torch.ops.forest_train import (GBDTClassifier,
                                                 RandomForestClassifier)
    from bbbp_tpu_torch.testing import compare_gbdt_fits
    from bbbp_tpu_torch.timing import (best_splits_bound, device_ms,
                                       level_histogram_bound)
    from bbbp_tpu_torch.train.transfer import TransferConfig, _aux_feature_basis

    cfg = TransferConfig()
    labels = np.asarray(aux[1], np.float32)
    aux_x, _, _ = _aux_feature_basis(aux[0], cfg.morgan_pca_dim, device="cuda",
                                     raw=aux_raw)
    if aux_x.shape != (len(labels), WIDE_F):
        raise AssertionError(f"aux features {aux_x.shape}, expected F={WIDE_F}")
    t0 = time.time()
    fit = GBDTClassifier(n_estimators=AUDIT_TREES, learning_rate=cfg.learning_rate,
                         max_depth=cfg.depth, subsample=1.0, seed=cfg.seed,
                         device="cuda").fit(aux_x, labels)
    fit_s = time.time() - t0
    ens = fit.ensemble_
    t0 = time.time()
    audit = compare_gbdt_fits(aux_x, labels, None, ens.to_state(), task="cls",
                              lam=1.0, min_child=1.0,
                              learning_rate=cfg.learning_rate,
                              base_score=ens.base_score, tol=1e-5)
    audit_s = time.time() - t0
    n_nodes = AUDIT_TREES * ((1 << cfg.depth) - 1)
    if not audit.ok or audit.trees_compared != AUDIT_TREES or \
            audit.near_ties > 0.01 * n_nodes or audit.max_leaf_diff > 1e-4:
        raise AssertionError(f"GBDTClassifier(cuda) at F={WIDE_F} along its own "
                             f"splits: {audit}")
    t0 = time.time()
    obl_fit = GBDTClassifier(n_estimators=AUDIT_TREES, oblivious=True,
                             learning_rate=cfg.learning_rate, max_depth=cfg.depth,
                             subsample=1.0, seed=cfg.seed, device="cuda"
                             ).fit(aux_x, labels)
    obl_fit_s = time.time() - t0
    t0 = time.time()
    obl_audit = compare_gbdt_fits(aux_x, labels, None, obl_fit.ensemble_.to_state(),
                                  task="cls", lam=1.0, min_child=1.0,
                                  learning_rate=cfg.learning_rate,
                                  base_score=obl_fit.ensemble_.base_score,
                                  tol=1e-5, oblivious=True)
    obl_audit_s = time.time() - t0
    if not obl_audit.ok or obl_audit.trees_compared != AUDIT_TREES or \
            obl_audit.equal + obl_audit.equivalent + obl_audit.near_ties != n_nodes or \
            obl_audit.equal < 0.99 * n_nodes or \
            obl_audit.near_ties > 0.01 * n_nodes or obl_audit.max_leaf_diff > 1e-4:
        raise AssertionError(f"oblivious GBDTClassifier(cuda) at F={WIDE_F} along "
                             f"its own splits: {obl_audit}")
    x = torch.from_numpy(aux_x).to("cuda")
    got = raw_predict(ens, x)
    want = dense_predict_reference(ens.feat, ens.thr, ens.leaf, x, ens.depth,
                                   ens.base_score, ens.tree_scale)
    forest_err = float((got - want).abs().max())
    if forest_err > 2e-5:
        raise AssertionError(f"dense_forest on the fitted F={WIDE_F} forest: max "
                             f"|err| {forest_err:.3g}")

    # K3 and K4 timed on the path's own rows: the fit's binned matrix (167
    # of its features are MACCS bits, two bins each), the first tree's
    # gradients, and the rows' nodes under the first tree of the fit (levels
    # 0 and 5) and of a depth-10 random forest (level 9)
    xb = torch.from_numpy(fit.mapper_.transform(aux_x)).to("cuda")
    y = torch.from_numpy(labels).to("cuda")
    p0 = torch.sigmoid(torch.full_like(y, float(ens.base_score)))
    g, h = p0 - y, torch.clamp(p0 * (1 - p0), min=1e-6)
    bounds = tr.gradient_bounds(g, h)
    n_bins = torch.from_numpy(fit.mapper_.bin_counts()).to("cuda")
    tr.check_bin_counts(n_bins, xb)
    few_bins = int((n_bins <= 4).sum())
    rf = RandomForestClassifier(n_estimators=2, max_depth=cfg.rf_depth,
                                seed=cfg.seed, device="cuda").fit(aux_x, labels)
    every = torch.ones(WIDE_F, dtype=torch.bool, device="cuda")
    rows = torch.arange(len(labels), device="cuda")
    fitted = {}
    for level in WIDE_LEVELS:
        trees = ens if level < cfg.depth else rf.ensemble_
        pos = torch.zeros(len(labels), dtype=torch.int64, device="cuda")
        for lv in range(level):
            node = (1 << lv) - 1 + pos
            pos = 2 * pos + (x[rows, trees.feat[0, node].long()]
                             > trees.thr[0, node]).long()
        pos, nodes = pos.int(), 1 << level
        hist = tr.level_histogram(xb, pos, g, h, nodes, bounds, n_bins,
                                  bins_checked=True)
        fixed = tr.level_histogram_fixed_reference(xb, pos, g, h, nodes, bounds)
        if not (torch.equal(hist, fixed) and torch.equal(
                tr.level_histogram(xb, pos, g, h, nodes, bounds), fixed)):
            raise AssertionError(f"level_histogram on the fit's rows, level {level}: "
                                 f"not its fixed-point plain version")
        del fixed
        index_add = index_add_call(xb, pos, g, h, nodes)
        fitted[level] = {
            "k3": device_ms(lambda: tr.level_histogram(
                xb, pos, g, h, nodes, bounds, n_bins, bins_checked=True)),
            "k3_no_bins": device_ms(lambda: tr.level_histogram(
                xb, pos, g, h, nodes, bounds)),
            "k3_plain": device_ms(lambda: tr.level_histogram_reference(
                xb, pos, g, h, nodes)),
            "k3_library": device_ms(index_add),
            "k3_bound_ms": level_histogram_bound(len(labels), WIDE_F, nodes)["bound_ms"],
            "k4": device_ms(lambda: tr.best_splits(hist, every, 1.0, 1.0, False)),
            "k4_plain": device_ms(lambda: tr.best_splits_reference(
                hist, every, 1.0, 1.0, False)),
            "k4_oblivious": device_ms(lambda: tr.best_splits(
                hist, every, 1.0, 1.0, True)),
            "k4_oblivious_plain": device_ms(lambda: tr.best_splits_reference(
                hist, every, 1.0, 1.0, True)),
            "k4_bound_ms": best_splits_bound(nodes, WIDE_F)["bound_ms"],
            "occupied_nodes": int(torch.unique(pos).numel())}

    def over_levels(key):
        return fmt([fitted[lv][key] for lv in WIDE_LEVELS])

    print(f"[8 wide fit] on the fit's own binned rows, levels {WIDE_LEVELS} "
          f"(occupied nodes {[fitted[lv]['occupied_nodes'] for lv in WIDE_LEVELS]}; "
          f"{few_bins} of {WIDE_F} features have at most 4 bins; ms): "
          f"level_histogram {over_levels('k3')} (bit-equal to its fixed-point "
          f"plain version), without n_bins {over_levels('k3_no_bins')}, plain "
          f"{over_levels('k3_plain')}, index_add_ {over_levels('k3_library')}, "
          f"bound {over_levels('k3_bound_ms')}; "
          f"best_splits {over_levels('k4')}, plain {over_levels('k4_plain')}, "
          f"oblivious {over_levels('k4_oblivious')}, plain "
          f"{over_levels('k4_oblivious_plain')}, bound "
          f"{over_levels('k4_bound_ms')}", flush=True)
    print(f"[8 wide fit] GBDTClassifier(subsample=1, {AUDIT_TREES} trees of "
          f"depth {cfg.depth}) on cuda over {aux_x.shape[0]} x {WIDE_F} aux "
          f"features: {fit_s:.3f} s; along its own splits {audit.equal} of "
          f"{n_nodes} nodes equal to the plain best split, {audit.equivalent} "
          f"equivalent, {audit.near_ties} near ties (limit 1%), max |dleaf| "
          f"{audit.max_leaf_diff:.3g} (limit 1e-4), replayed on the CPU in "
          f"{audit_s:.1f} s | the same fit oblivious: {obl_fit_s:.3f} s; "
          f"{obl_audit.equal} of {n_nodes} nodes carry the level's best summed "
          f"gain, {obl_audit.equivalent} equivalent, {obl_audit.near_ties} near "
          f"ties (limit 1%), max |dleaf| {obl_audit.max_leaf_diff:.3g}, replayed "
          f"in {obl_audit_s:.1f} s | its margins, forest kernel against plain: max "
          f"|err| {forest_err:.3g} (atol 2e-5) | on {card}", flush=True)
    return {"forest_err": forest_err, "fitted": fitted,
            "audit": {"trees": AUDIT_TREES, "nodes": n_nodes, "equal": audit.equal,
                      "equivalent": audit.equivalent,
                      "near_ties": audit.near_ties,
                      "max_leaf_diff": audit.max_leaf_diff},
            "audit_oblivious": {"trees": AUDIT_TREES, "nodes": n_nodes,
                                "equal": obl_audit.equal,
                                "equivalent": obl_audit.equivalent,
                                "near_ties": obl_audit.near_ties,
                                "max_leaf_diff": obl_audit.max_leaf_diff}}


def transfer_phase(card, counters, aux, reg, reg_raw, cache_dir):
    """Phase 8. ``aux`` and ``reg`` are (smiles, labels or target);
    ``counters`` maps a kernel's name to its wrapper. Returns the launches
    of the transfer run and of the legs."""
    import torch

    from bbbp_tpu_torch.testing import regression_legs
    from bbbp_tpu_torch.train.transfer import TransferConfig, transfer_features

    def reset():
        for fn in counters.values():
            fn.launches.reset()

    def read():
        return {name: fn.launches.count for name, fn in counters.items()}

    reg_smiles, y = reg
    cfg = TransferConfig(cache_dir=cache_dir)
    reset()
    torch.cuda.synchronize()
    t0 = time.time()
    res = transfer_features(reg_smiles, cfg, aux_data=aux, verbose=False,
                            device="cuda")
    wall = time.time() - t0
    launched = read()
    per_level = 2 * (2 * cfg.trees * cfg.depth + cfg.rf_trees * cfg.rf_depth)
    want = {"packed_project": 0, "dense_forest_predict": 6,
            "forest_level_histogram": per_level, "forest_best_splits": per_level,
            "forest_leaf_values": 2 * (2 * cfg.trees + cfg.rf_trees),
            "tanimoto_topk": 2, "tanimoto_gram": 0, "minmax_gram": 0}
    if launched != want:
        raise AssertionError(f"transfer_features launches {launched}, expected {want}")
    f = res.features
    if f.shape != (len(reg_smiles), 4) or not np.isfinite(f).all() or \
            f.min() < 0 or f.max() > 1 or res.names != [
                f"transfer_{m}" for m in cfg.models]:
        raise AssertionError(f"transfer features {f.shape} {res.names}")
    if min(res.holdout_auc.values()) <= AUC_FLOOR or set(res.holdout_auc) != set(cfg.models):
        raise AssertionError(f"holdout AUCs {res.holdout_auc}, floor {AUC_FLOOR}")
    again = transfer_features(reg_smiles, cfg, aux_data=aux, verbose=False,
                              device="cuda")
    if not np.array_equal(again.features, f) or read() != launched:
        raise AssertionError("the transfer cache file was not read back")
    on_cpu = transfer_features(
        reg_smiles, TransferConfig(models=("tknn",), cache_dir=cache_dir),
        aux_data=aux, verbose=False, device="cpu")
    tknn_err = float(np.abs(on_cpu.features[:, 0] - f[:, 3]).max())
    if tknn_err > 1e-6 or abs(on_cpu.holdout_auc["tknn"]
                              - res.holdout_auc["tknn"]) > 1e-9:
        raise AssertionError(f"transfer_tknn cuda vs cpu: max |err| {tknn_err:.3g}")
    stages = {k: round(v, 3) for k, v in res.seconds.items()}
    print(f"[8 transfer] transfer_features(cuda) {len(aux[0])} aux molecules, "
          f"{len(reg_smiles)} regression molecules, "
          f"{reg_raw[0].shape[1] + reg_raw[1].shape[1] + cfg.morgan_pca_dim} "
          f"features, models "
          f"{cfg.models} ({cfg.trees}/{cfg.trees}/{cfg.rf_trees} trees, k "
          f"{cfg.tknn_k}): {wall:.3f} s wall with the raw features cached | "
          f"stage s {stages} | launches {launched} | holdout AUC "
          f"{ {k: round(v, 4) for k, v in res.holdout_auc.items()} } (floor "
          f"{AUC_FLOOR}) | transfer_tknn cuda vs cpu max |err| {tknn_err:.3g} "
          f"(limit 1e-6) | cache file read back | on {card}", flush=True)

    # -- the regression stack's chemistry-kernel legs -----------------------
    n = len(y)

    def legs(device):
        return regression_legs(*reg_raw, y, device=device, n_folds=REG_FOLDS)

    reset()
    torch.cuda.synchronize()
    t0 = time.time()
    on_cuda = legs("cuda")
    cuda_s = time.time() - t0
    leg_launches = read()
    want = {"tanimoto_topk": REG_FOLDS, "tanimoto_gram": 6 * REG_FOLDS + 4 + 3,
            "minmax_gram": 2 * REG_FOLDS + 2 + 1}
    if {k: leg_launches[k] for k in want} != want:
        raise AssertionError(f"the legs' launches {leg_launches}, expected {want}")
    t0 = time.time()
    on_cpu = legs("cpu")
    cpu_s = time.time() - t0
    limits = {"tknn": 1e-5, "tkrr": 2e-3, "ckrr": 2e-3, "ckrr_idf": 2e-3,
              "gram_tkrr": 1e-5, "gram_ckrr": 1e-5}
    errs = {k: float(np.abs(on_cuda[k] - on_cpu[k]).max()) for k in limits}
    scores = {k: r2(y, on_cuda[k]) for k in ("tknn", "tkrr", "ckrr")}
    if any(not np.isfinite(on_cuda[k]).all() or errs[k] > limits[k] for k in limits):
        raise AssertionError(f"the legs cuda vs cpu: max |err| {errs}, limits {limits}")
    if min(scores.values()) <= 0 or on_cuda["gram_ckrr"].shape != (n, n):
        raise AssertionError(f"out-of-fold R2 of the legs {scores}")
    print(f"[8 legs] {REG_FOLDS} folds over {n} molecules (MACCS k=10 kNN, "
          f"Tanimoto ridge lam 0.1, combined-kernel ridge lam 0.06, one fold "
          f"with IDF weights, both full grams): cuda {cuda_s:.3f} s, cpu "
          f"{cpu_s:.3f} s wall | launches "
          f"{ {k: leg_launches[k] for k in want} } | out-of-fold R2 "
          f"{ {k: round(v, 4) for k, v in scores.items()} } | cuda vs cpu max "
          f"|err| { {k: float(f'{v:.3g}') for k, v in errs.items()} } (limits "
          f"{limits}) | on {card}", flush=True)
    return launched, leg_launches


def own_children() -> list:
    """PIDs of this process's children, zombies included, from ``/proc``."""
    me, pids = str(os.getpid()), []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # "pid (comm) state ppid ...": comm may hold spaces and parentheses
        if stat[stat.rindex(")") + 2:].split()[1] == me:
            pids.append(int(entry))
    return pids


def command_line(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace").strip()
    except OSError:
        return "?"


def stop_children() -> None:
    """Stop and reap every process this run started that is still alive.

    The featurizer's spawned pool leaves multiprocessing's resource tracker
    running until the interpreter exits, so it is stopped first, the way
    the interpreter would. Any other child is sent SIGTERM, then SIGKILL
    after 5 s. ``main`` makes this process the subreaper of its
    descendants, so a grandchild whose parent has exited is found here
    too. What was stopped goes to stderr."""
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    if tracker._pid is not None:
        print(f"chip_smoke: stopping multiprocessing's resource tracker "
              f"(pid {tracker._pid})", file=sys.stderr, flush=True)
        tracker._stop()
    for sig, grace in ((signal.SIGTERM, 5.0), (signal.SIGKILL, 30.0)):
        pids = own_children()
        if not pids:
            return
        print(f"chip_smoke: sending {sig.name} to "
              f"{[(pid, command_line(pid)) for pid in pids]}",
              file=sys.stderr, flush=True)
        for pid in pids:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.time() + grace
        while pids and time.time() < deadline:
            for pid in list(pids):
                try:
                    done, _ = os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:
                    done = pid
                if done:
                    pids.remove(pid)
            time.sleep(0.05)


def main() -> int:
    # PR_SET_CHILD_SUBREAPER: orphaned descendants become this process's
    # children, so that stop_children() finds them
    ctypes.CDLL(None).prctl(36, 1, 0, 0, 0)
    try:
        return run()
    finally:
        stop_children()


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    from bbbp_tpu_torch import _build
    from bbbp_tpu_torch.data.zinc import synthetic_smiles
    from bbbp_tpu_torch.native.bindings import fingerprints, fingerprints_packed
    from bbbp_tpu_torch.ops import forest_train as tr
    from bbbp_tpu_torch.ops.bitops import (pack_bits, packed_project,
                                           packed_project_reference,
                                           unpack_bits_reference)
    from bbbp_tpu_torch.ops.forest import (DenseTreeEnsemble,
                                           dense_predict_reference, raw_predict)
    from bbbp_tpu_torch.ops.forest_train import GBDTClassifier
    from bbbp_tpu_torch.pipelines.screen import ScreeningModel, screen
    from bbbp_tpu_torch.testing import (N_TREES, compare_gbdt_fits,
                                        full_width_screening_state,
                                        labelled_training_set, mixed_level_case)
    from bbbp_tpu_torch.timing import (best_splits_bound, device_ms, event_ms,
                                       forest_bound, host_launch_calls,
                                       level_histogram_bound, nvidia_smi,
                                       project_bound)

    cuda = torch.device("cuda")
    card = nvidia_smi()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    t0 = time.time()
    _build.kernels_lib()
    t_kernels = time.time() - t0
    t0 = time.time()
    _build.chem_lib()
    t_chem = time.time() - t0
    print(f"[1 env] card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | allow_tf32={tf32} | build s: kernels "
          f"{t_kernels:.1f}, chem {t_chem:.1f}", flush=True)
    if tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 must be False")

    state = full_width_screening_state(0)
    model = ScreeningModel.from_state(state).to(cuda)
    rng = np.random.default_rng(0)

    # -- phase 2: kernel 1 against its plain version ----------------------
    w, c0 = model.proj_w, model.proj_c0
    k1_err = 0.0
    cases = [(n, 2048, 30) for n in (1, 255, 16384, 16385)]
    cases += [(16385, 2048, 64), (16385, 2048, 50), (16385, 2048, 31),
              (16385, 2048, 200), (255, 2048, 1001), (255, 2000, 30),
              (16385, 2000, 30)]
    for n, d, k in cases:
        if (d, k) == (2048, 30):
            wk, ck = w, c0
        else:
            wk = torch.from_numpy((rng.standard_normal((d, k)) / np.sqrt(d)
                                   ).astype(np.float32)).to(cuda)
            ck = torch.from_numpy(rng.standard_normal(k).astype(np.float32)
                                  ).to(cuda)
        dense = rng.random((n, 2048)) < 0.05
        dense[-1] = True                        # an all-ones row
        if n > 1:
            dense[0] = False                    # an all-zero row
        packed = torch.from_numpy(pack_bits(dense).view(np.int32)).to(cuda)
        got = packed_project(packed, wk, ck)
        want = packed_project_reference(packed, wk, ck)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        k1_err = max(k1_err, err)
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-4):
            raise AssertionError(f"packed_project N={n} d={d} k={k}: "
                                 f"max |err| {err:.3g}")
        if (n, d, k) == (CHUNK + 1, 2048, 30):
            random_words = packed[:CHUNK]       # 5%-random, first row zero
    fp_words, _ = fingerprints_packed(synthetic_smiles(CHUNK, seed=1))
    fp_words = torch.from_numpy(fp_words.view(np.int32)).to(cuda)
    set_bits = {name: int(unpack_bits_reference(words, w.shape[0]).sum().item())
                for name, words in (("random", random_words),
                                    ("fingerprints", fp_words))}
    k1_ms = device_ms(lambda: packed_project(random_words, w, c0))
    k1_plain_ms = device_ms(lambda: packed_project_reference(random_words, w,
                                                             c0))
    random_bits = unpack_bits_reference(random_words, w.shape[0])
    k1_lib_ms = device_ms(lambda: torch.addmm(c0, random_bits, w))
    k1_fp_ms = device_ms(lambda: packed_project(fp_words, w, c0))
    k1_fp_plain_ms = device_ms(lambda: packed_project_reference(fp_words, w,
                                                                c0))
    k1_bound, k1_fp_bound = (
        project_bound(CHUNK, random_words.shape[1], w.shape[0], w.shape[1],
                      set_bits[name]) for name in ("random", "fingerprints"))
    print(f"[2 packed_project] (N, d, k) in {cases}: max |err| {k1_err:.3g} "
          f"(atol 1e-4, rtol 1e-5) | N=16384, W=64, k=30: 5%-random words "
          f"({set_bits['random'] / CHUNK:.2f} set bits a row) kernel "
          f"{k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, addmm on unpacked "
          f"bits {k1_lib_ms:.4f} ms, bound {k1_bound['bound_ms']:.5f} ms "
          f"({k1_bound['bound_by']}); fingerprints "
          f"({set_bits['fingerprints'] / CHUNK:.2f} set bits a row) kernel "
          f"{k1_fp_ms:.4f} ms, plain {k1_fp_plain_ms:.4f} ms, bound "
          f"{k1_fp_bound['bound_ms']:.5f} ms ({k1_fp_bound['bound_by']})",
          flush=True)

    # -- phase 3: kernel 2 against its plain version -----------------------
    k2_err = 0.0
    n = 16384
    cases = [(depth, n_feat, 300) for depth in (0, 1, 6, 8, 12)
             for n_feat in (30, 2048)] + [(6, 30, 301)]
    cases += [(depth, WIDE_F, n_trees) for depth, n_trees in WIDE_FORESTS]
    wide = {}
    for depth, n_feat, n_trees in cases:
        x = torch.from_numpy(
            rng.standard_normal((n, n_feat)).astype(np.float32)).to(cuda)
        n_int = (1 << depth) - 1
        thr = rng.standard_normal((n_trees, n_int)).astype(np.float32)
        thr[rng.random(thr.shape) < 0.05] = np.inf
        ens = DenseTreeEnsemble.from_state({
            "feat": rng.integers(0, n_feat, (n_trees, n_int)), "thr": thr,
            "leaf": rng.normal(0, 0.1, (n_trees, n_int + 1)),
            "depth": depth, "base_score": 0.3, "tree_scale": 0.1}).to(cuda)
        want = dense_predict_reference(ens.feat, ens.thr, ens.leaf, x, depth,
                                       ens.base_score, ens.tree_scale)
        got = raw_predict(ens, x)
        got_p = raw_predict(ens, x, apply_sigmoid=True)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        err_p = (got_p - torch.sigmoid(want)).abs().max().item()
        k2_err = max(k2_err, err, err_p)
        if err > 2e-5 or err_p > 2e-5:
            raise AssertionError(f"dense_forest D={depth} F={n_feat} "
                                 f"T={n_trees}: max |err| {err:.3g}, "
                                 f"sigmoid {err_p:.3g}")
        if n_feat == WIDE_F:
            wide[depth, n_trees] = (ens, x)
    k2_wide = {}
    for (depth, n_trees), (e, x) in wide.items():
        for rows in (1058, TRAIN_ROWS[0]):
            xr = x[:rows].contiguous()
            bound = forest_bound(rows, WIDE_F, n_trees, depth)
            k2_wide[f"n{rows}_T{n_trees}_D{depth}"] = {
                "ms": device_ms(lambda: raw_predict(e, xr, apply_sigmoid=True)),
                "plain_ms": device_ms(lambda: torch.sigmoid(
                    dense_predict_reference(e.feat, e.thr, e.leaf, xr, depth,
                                            e.base_score, e.tree_scale))),
                "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
    ens = model.ensemble

    def forest_ms(z):
        return (device_ms(lambda: raw_predict(ens, z, apply_sigmoid=True)),
                device_ms(lambda: torch.sigmoid(dense_predict_reference(
                    ens.feat, ens.thr, ens.leaf, z, ens.depth, ens.base_score,
                    ens.tree_scale))))

    k2_ms, k2_plain_ms = forest_ms(packed_project(random_words, w, c0))
    k2_fp_ms, k2_fp_plain_ms = forest_ms(packed_project(fp_words, w, c0))
    k2_bound = forest_bound(CHUNK, w.shape[1], ens.feat.shape[0], ens.depth)
    print(f"[3 dense_forest_predict] N=16384, (D, F, T) in {cases}, +inf "
          f"thresholds: max |err| {k2_err:.3g} (atol 2e-5) | F=30, T=300, "
          f"D=6: z of the random words kernel {k2_ms:.4f} ms, plain "
          f"{k2_plain_ms:.4f} ms; z of the fingerprints kernel "
          f"{k2_fp_ms:.4f} ms, plain {k2_fp_plain_ms:.4f} ms; bound "
          f"{k2_bound['bound_ms']:.5f} ms ({k2_bound['bound_by']}) | F={WIDE_F} "
          f"(rows, trees, depth; kernel / plain / bound ms): " + "; ".join(
              f"{k} {t['ms']:.4f} / {t['plain_ms']:.4f} / {t['bound_ms']:.5f}"
              for k, t in k2_wide.items()), flush=True)

    # -- phase 4: the slice --------------------------------------------------
    smiles = synthetic_smiles(SLICE_N, seed=1)
    bad_at = (10, SLICE_N // 2, SLICE_N + 2)
    for pos, bad in zip(bad_at, INVALID):
        smiles.insert(pos, bad)
    mols = [(s, f"M{i:06d}") for i, s in enumerate(smiles)]
    with tempfile.TemporaryDirectory() as tmp:
        gpu_csv = os.path.join(tmp, "cuda.csv")
        cpu_csv = os.path.join(tmp, "cpu.csv")
        packed_project.launches.reset()
        raw_predict.launches.reset()
        stats = screen(model, iter(mols), out_csv=gpu_csv, chunk_size=CHUNK,
                       dispatch_workers=2, device="cuda")
        launches = {"packed_project": packed_project.launches.count,
                    "dense_forest_predict": raw_predict.launches.count}
        gpu_rows = read_csv(gpu_csv)
        mism, n_near, worst = screen_against_cpu(model, state["ensemble"], mols,
                                                 gpu_csv, cpu_csv)
    if len(gpu_rows) != len(mols) or stats.n_molecules != len(mols):
        raise AssertionError(f"{len(gpu_rows)} rows for {len(mols)} molecules")
    invalid = [i for i, r in enumerate(gpu_rows) if r[2] == "invalid"]
    if invalid != list(bad_at) or stats.n_invalid != len(bad_at):
        raise AssertionError(f"invalid rows {invalid}, expected {list(bad_at)}")
    if [r[:2] for r in gpu_rows] != [[m[1], m[0]] for m in mols]:
        raise AssertionError("CSV rows are not in input order")
    proba = np.array([float(r[3]) for r in gpu_rows if r[2] != "invalid"])
    if not (np.isfinite(proba).all() and (proba >= 0).all() and (proba <= 1).all()):
        raise AssertionError("probabilities outside [0, 1]")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched by screen(): {launches}")
    print(f"[4 slice] screen(cuda) {stats.n_molecules} molecules "
          f"({stats.n_invalid} invalid), chunk {CHUNK}, 2 dispatchers: "
          f"{stats.mol_per_s:.1f} mol/s (wall {stats.wall_s:.3f} s, featurize "
          f"{stats.featurize_s:.3f} s) on {card} | launches {launches} | "
          f"first {PREFIX} vs screen(cpu): {len(mism)} rows differ, all "
          f"near ties ({n_near} near-tie rows), max |dProbability| "
          f"{worst:.3g} (limit 1e-4)", flush=True)

    # -- phase 5: the trainer's kernels against their plain versions --------
    t5 = time.time()
    k5_err, k5_cases, k5_grad_cases = 0.0, 0, 0
    held = {"k3_err": 0.0, "k3_err_plain": 0.0, "k4_err": 0.0, "k4_calls": 0,
            "k4_near": 0, "k3_cases": 0}
    feats = (1, 30, 167, 300, WIDE_F)
    for n in (1, 7809, 65536):
        for n_feat in feats:
            for level in (0, 5, 9):
                xb, pos, g, h = level_case(n, n_feat, level, n + n_feat + level,
                                           cuda)
                hold_level(tr, f"n={n} F={n_feat} level {level}", xb, pos, g, h,
                           (xb.amax(0) + 1).to(torch.uint8), 1 << level, rng, held)
        for n_leaves in (1, 64, 1024):
            k5_cases += 1
            _, pos, g, h = level_case(n, 1, 0, n + n_leaves, cuda)   # 20% weigh 0
            pos = torch.randint(0, n_leaves, (n,), dtype=torch.int32, device=cuda)
            start = torch.randn(n, device=cuda)
            bounds = tr.gradient_bounds(g, h)
            p_k, p_again, p_64, p_fix = (start.clone(), start.clone(),
                                         start.double(), start.clone())
            leaf_k = tr.leaf_values(pos, g, h, n_leaves, 1.0, 0.1, p_k)
            leaf_again = tr.leaf_values(pos, g, h, n_leaves, 1.0, 0.1, p_again)
            leaf_fix = tr.leaf_values_fixed_reference(pos, g, h, n_leaves, 1.0, 0.1,
                                                      p_fix, bounds)
            leaf_64 = tr.leaf_values_reference(pos, g.double(), h.double(),
                                               n_leaves, 1.0, 0.1, p_64)
            torch.cuda.synchronize()
            if not (torch.equal(leaf_k, leaf_again) and torch.equal(p_k, p_again)):
                raise AssertionError(f"leaf_values n={n}: two runs differ")
            if not (torch.equal(leaf_k, leaf_fix) and torch.equal(p_k, p_fix)):
                raise AssertionError(f"leaf_values n={n} L={n_leaves}: not its "
                                     f"fixed-point plain version")
            leaf_err = (leaf_k.double() - leaf_64).abs()
            pred_err = (p_k.double() - p_64).abs()
            if bool((leaf_err > 5e-7 * leaf_64.abs() + 1e-9).any()) or bool(
                    (pred_err > 1e-6 * (p_64.abs() + leaf_64[pos.long()].abs())
                     + 1e-9).any()):
                raise AssertionError(f"leaf_values n={n} L={n_leaves}: max |err| "
                                     f"leaf {float(leaf_err.max()):.3g}, margins "
                                     f"{float(pred_err.max()):.3g}")
            k5_err = max(k5_err, float(leaf_err.max()), float(pred_err.max()))
            # the next tree's gradients from the same launch, against the
            # torch ops on the same margins, draws and weights (some 0)
            for task, sub in (("reg", 1.0), ("reg", 0.8), ("cls", 1.0), ("cls", 0.8)):
                y = (torch.randn(n, device=cuda) if task == "reg"
                     else (torch.rand(n, device=cuda) < 0.4).float())
                u = torch.rand(n, device=cuda)
                w = (torch.rand(n, device=cuda) > 0.2).float()
                p_n, p_ref = start.clone(), start.clone()
                got = tr.leaf_values(pos, g, h, n_leaves, 1.0, 0.1, p_n, bounds,
                                     tr.NextTree(y, u, sub, w, task))
                tr.leaf_values_fixed_reference(pos, g, h, n_leaves, 1.0, 0.1, p_ref,
                                               bounds)
                want = tr.next_gradients_reference(p_ref, y, u, sub, w, task)
                torch.cuda.synchronize()
                k5_grad_cases += 1
                if not (torch.equal(got[0], leaf_fix) and torch.equal(p_n, p_ref)
                        and all(torch.equal(a, b) for a, b in zip(got[1:], want))):
                    raise AssertionError(
                        f"leaf_values with the next tree n={n} L={n_leaves} {task} "
                        f"subsample {sub}: g, h, bounds differ from the torch ops by "
                        f"{[ulp_gap(a, b) for a, b in zip(got[1:], want)]} ulp")

    # features of 1, 2, 3 and 64 occupied bins in one matrix, skewed nodes;
    # every row in one node of level 9; rows that all weigh 0 (or nearly all)
    mixed = [(n, n_feat, level, False, 0.2) for n, n_feat in
             ((7809, WIDE_F), (7809, TRAIN_F), (65536, 167)) for level in (0, 5, 9)]
    mixed += [(7809, WIDE_F, 9, True, 0.2), (65536, TRAIN_F, 9, True, 0.0),
              (7809, WIDE_F, 5, False, 1.0), (7809, TRAIN_F, 9, False, 0.97)]
    for n, n_feat, level, one_node, zero_share in mixed:
        *arrays, counts = mixed_level_case(n + n_feat + level, n, n_feat, level,
                                           one_node, zero_share)
        xb, pos, g, h, n_bins = (torch.from_numpy(a).to(cuda)
                                 for a in (*arrays, counts))
        hold_level(tr, f"mixed bins n={n} F={n_feat} level {level} one_node="
                   f"{one_node} zero share {zero_share}", xb, pos, g, h, n_bins,
                   1 << level, rng, held)
    low = n_bins.clone()
    low[2] = 1                                  # feature 2 fills 64 bins
    try:
        tr.level_histogram(xb, pos, g, h, 1 << level, None, low)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("level_histogram took an n_bins below an occupied bin")
    k3_err, k3_err_plain, k4_err = held["k3_err"], held["k3_err_plain"], held["k4_err"]
    k4_calls, k4_near, k3_cases = held["k4_calls"], held["k4_near"], held["k3_cases"]

    timed = {}
    shapes = [(n, TRAIN_F, tuple(range(TRAIN_DEPTH))) for n in TRAIN_ROWS]
    shapes.append((TRAIN_ROWS[0], WIDE_F, WIDE_LEVELS))
    for n, n_feat, shape_levels in shapes:
        every = torch.ones(n_feat, dtype=torch.bool, device=cuda)
        for level in shape_levels:
            nodes = 1 << level
            xb, pos, g, h = level_case(n, n_feat, level, level, cuda)
            bounds = tr.gradient_bounds(g, h)      # once a tree in a fit
            n_bins = (xb.amax(0) + 1).to(torch.uint8)       # as is a fit's n_bins
            tr.check_bin_counts(n_bins, xb)
            hist = tr.level_histogram(xb, pos, g, h, nodes, bounds, n_bins,
                                      bins_checked=True)
            index_add = index_add_call(xb, pos, g, h, nodes)
            keys = (pos.long()[:, None] * (n_feat * 64)
                    + torch.arange(n_feat, device=cuda)[None, :] * 64
                    + xb.long()).reshape(-1)
            wg = g[:, None].expand(n, n_feat).reshape(-1)
            wh = h[:, None].expand(n, n_feat).reshape(-1)
            length = nodes * n_feat * 64
            timed[n, n_feat, level] = {
                "k3": device_ms(lambda: tr.level_histogram(
                    xb, pos, g, h, nodes, bounds, n_bins, bins_checked=True)),
                "k3_plain": device_ms(lambda: tr.level_histogram_reference(
                    xb, pos, g, h, nodes)),
                "k3_library": device_ms(index_add),
                "k3_bincount": event_ms(lambda: (
                    torch.bincount(keys, weights=wg, minlength=length),
                    torch.bincount(keys, weights=wh, minlength=length))),
                "k3_bound": level_histogram_bound(n, n_feat, nodes),
                "k4": device_ms(lambda: tr.best_splits(hist, every, 1.0, 1.0, False)),
                "k4_plain": device_ms(lambda: tr.best_splits_reference(
                    hist, every, 1.0, 1.0, False)),
                "k4_oblivious": device_ms(lambda: tr.best_splits(
                    hist, every, 1.0, 1.0, True)),
                "k4_oblivious_plain": device_ms(lambda: tr.best_splits_reference(
                    hist, every, 1.0, 1.0, True)),
                "k4_bound": best_splits_bound(nodes, n_feat),
            }
        if n_feat != TRAIN_F:
            continue
        leaf_pos = torch.randint(0, 1 << TRAIN_DEPTH, (n,), dtype=torch.int32,
                                 device=cuda)
        timed[n, "k5"] = time_leaf_values(tr, leaf_pos, g, h, 1 << TRAIN_DEPTH,
                                          bounds)
    n = TRAIN_ROWS[0]                          # rf: 1,024 leaves
    _, _, g, h = level_case(n, 1, 0, 10, cuda)
    leaf_pos = torch.randint(0, 1024, (n,), dtype=torch.int32, device=cuda)
    timed[n, "k5_1024"] = time_leaf_values(tr, leaf_pos, g, h, 1024,
                                           tr.gradient_bounds(g, h))

    def levels(n, key, field=None, n_feat=TRAIN_F):
        return [timed[n, n_feat, lv][key][field] if field
                else timed[n, n_feat, lv][key]
                for lv in (range(TRAIN_DEPTH) if n_feat == TRAIN_F else WIDE_LEVELS)]

    def leaf_line(t):
        return (f"{t['k5']:.4f}, plain {t['k5_plain']:.4f}, bound "
                f"{t['k5_bound']['bound_ms']:.6f}; with the next tree's gradients "
                f"{t['k5_next']:.4f}, plain {t['k5_next_plain']:.4f}, bound "
                f"{t['k5_next_bound']['bound_ms']:.6f}")

    for n in TRAIN_ROWS:
        print(f"[5 trainer kernels] n={n}, F={TRAIN_F}, levels 0-5 (ms): "
              f"level_histogram {fmt(levels(n, 'k3'))}, plain "
              f"{fmt(levels(n, 'k3_plain'))}, index_add_ "
              f"{fmt(levels(n, 'k3_library'))}, bincount x2 "
              f"{fmt(levels(n, 'k3_bincount'))}, bound "
              f"{fmt(levels(n, 'k3_bound', 'bound_ms'))}; best_splits "
              f"{fmt(levels(n, 'k4'))}, plain {fmt(levels(n, 'k4_plain'))}, "
              f"oblivious {fmt(levels(n, 'k4_oblivious'))}, plain "
              f"{fmt(levels(n, 'k4_oblivious_plain'))}, "
              f"bound {fmt(levels(n, 'k4_bound', 'bound_ms'))}; leaf_values "
              f"(64 leaves) {leaf_line(timed[n, 'k5'])}", flush=True)
    head = TRAIN_ROWS[0]

    def wide_levels(key, field=None):
        return fmt(levels(head, key, field, WIDE_F))

    print(f"[5 trainer kernels] n={head}, F={WIDE_F}, levels {WIDE_LEVELS} (ms): "
          f"level_histogram {wide_levels('k3')}, plain {wide_levels('k3_plain')}, "
          f"index_add_ {wide_levels('k3_library')}, bincount x2 "
          f"{wide_levels('k3_bincount')}, bound "
          f"{wide_levels('k3_bound', 'bound_ms')}; best_splits "
          f"{wide_levels('k4')}, plain {wide_levels('k4_plain')}, oblivious "
          f"{wide_levels('k4_oblivious')}, plain "
          f"{wide_levels('k4_oblivious_plain')}, bound "
          f"{wide_levels('k4_bound', 'bound_ms')}; leaf_values (1,024 leaves) "
          f"{leaf_line(timed[head, 'k5_1024'])}", flush=True)
    print(f"[5 trainer kernels] {k3_cases} (n, F, level) cases, F in {feats}, "
          f"{len(mixed)} of them with features of 1, 2, 3 and 64 occupied bins "
          f"(skewed nodes, one node holding every row of level 9, all rows of "
          f"weight 0): level_histogram bit-equal to its fixed-point plain "
          f"version with and without n_bins, max "
          f"|err| {k3_err:.3g} against the exact sum (limit 2.4e-7 |sum| + "
          f"1e-9 n max|v|), {k3_err_plain:.3g} against the plain f32 sum, "
          f"two runs bit-identical, a low n_bins refused ({refused}); "
          f"best_splits {k4_calls} calls (per node and oblivious, column masks, "
          f"the best feature masked out, no valid split) equal to the "
          f"plain version but {k4_near} counted near-tie nodes (max |dscore| "
          f"{k4_err:.3g}); leaf_values {k5_cases} cases (n in 1 / 7,809 / "
          f"65,536, 1 / 64 / 1,024 leaves, 20% of rows of weight 0) bit-equal "
          f"to its fixed-point plain version, max |err| {k5_err:.3g} against "
          f"the float64 sums (limit 5e-7 |leaf|, 1e-6 of the margin terms), "
          f"two runs bit-identical; with the next tree ({k5_grad_cases} cases: "
          f"reg and cls, subsample 1 and 0.8, weights 0 and 1) g, h and "
          f"bounds bit-equal to the torch ops; {time.time() - t5:.1f} s on {card}",
          flush=True)

    # -- phase 6: training the screening model --------------------------------
    smiles, labels = labelled_training_set()
    for counter in (tr.level_histogram, tr.best_splits, tr.leaf_values):
        counter.launches.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    trained = ScreeningModel.train(smiles, labels, device="cuda")
    torch.cuda.synchronize()
    train_s = time.time() - t0
    train_launches = {"forest_level_histogram": tr.level_histogram.launches.count,
                      "forest_best_splits": tr.best_splits.launches.count,
                      "forest_leaf_values": tr.leaf_values.launches.count}
    want_launches = {"forest_level_histogram": N_TREES * TRAIN_DEPTH,
                     "forest_best_splits": N_TREES * TRAIN_DEPTH,
                     "forest_leaf_values": N_TREES}
    if train_launches != want_launches:
        raise AssertionError(f"ScreeningModel.train launches {train_launches}, "
                             f"expected {want_launches}")
    twice = ScreeningModel.train(smiles, labels, device="cuda")
    for key in ("feat", "thr", "leaf"):
        if not torch.equal(getattr(trained.ensemble, key),
                           getattr(twice.ensemble, key)):
            raise AssertionError(f"two cuda fits with one seed differ in {key}")
    same_projection = all(np.array_equal(getattr(trained, k), getattr(twice, k))
                          for k in ("scaler_mean", "scaler_scale", "pca_mean",
                                    "pca_components"))

    x_fp, bad = fingerprints(smiles, "morgan", 2048)
    if bad:
        raise AssertionError(f"labelled set holds invalid SMILES {bad[:5]}")
    x_dev = torch.from_numpy(x_fp).to(cuda)
    z = ((x_dev - torch.from_numpy(trained.scaler_mean).to(cuda))
         / torch.from_numpy(trained.scaler_scale).to(cuda)
         - torch.from_numpy(trained.pca_mean).to(cuda)
         ) @ torch.from_numpy(trained.pca_components).to(cuda).T
    proba = raw_predict(trained.ensemble, z.contiguous(), apply_sigmoid=True)
    train_acc = float(((proba > 0.5).cpu().numpy() == labels).mean())
    majority = max(labels.mean(), 1 - labels.mean())
    if not train_acc > majority:
        raise AssertionError(f"training accuracy {train_acc:.4f} is not above "
                             f"the majority share {majority:.4f}")

    z_np = z.cpu().numpy()
    # the host's calls that enqueue device work in one fit of the default
    # model's forest (torch_train_profile.py's fit)
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        GBDTClassifier(n_estimators=N_TREES, learning_rate=0.1, max_depth=TRAIN_DEPTH,
                       subsample=0.8, seed=42, device="cuda").fit(z_np, labels)
        torch.cuda.synchronize()
    fit_calls = host_launch_calls(prof)
    del prof
    kw = dict(n_estimators=N_TREES, learning_rate=0.1, max_depth=TRAIN_DEPTH,
              subsample=1.0, seed=42)
    torch.cuda.synchronize()
    t0 = time.time()
    on_cuda = GBDTClassifier(device="cuda", **kw).fit(z_np, labels)
    cuda_fit_s = time.time() - t0
    t0 = time.time()
    on_cpu = GBDTClassifier(device="cpu", **kw).fit(z_np, labels)
    cpu_fit_s = time.time() - t0
    fit_kw = dict(task="cls", lam=1.0, min_child=1.0, learning_rate=0.1,
                  base_score=on_cpu.ensemble_.base_score, tol=1e-5)
    cuda_state = on_cuda.ensemble_.to_state()
    cmp = compare_gbdt_fits(z_np, labels, on_cpu.ensemble_.to_state(),
                            cuda_state, **fit_kw)
    audit = compare_gbdt_fits(z_np, labels, None, cuda_state, **fit_kw)
    n_nodes = N_TREES * ((1 << TRAIN_DEPTH) - 1)
    if not (cmp.ok and audit.ok) or audit.near_ties > 0.01 * n_nodes or \
            audit.max_leaf_diff > 1e-4:
        raise AssertionError(f"GBDTClassifier cuda vs cpu: {cmp}; along the "
                             f"cuda fit's own splits: {audit}")

    # molecules the fit has not seen: a trained model's thresholds are the z
    # of training molecules, so a repeated fingerprint sits on a threshold
    seen = {row.tobytes() for row in fingerprints_packed(smiles)[0]}
    stream6 = synthetic_smiles(2 * CHUNK, seed=3)
    fresh6 = [row.tobytes() not in seen for row in fingerprints_packed(stream6)[0]]
    smiles6 = [s for s, new in zip(stream6, fresh6) if new][:CHUNK + 500]
    smiles6.insert(7, INVALID[0])
    mols6 = [(s, f"T{i:06d}") for i, s in enumerate(smiles6)]
    with tempfile.TemporaryDirectory() as tmp:
        gpu_csv = os.path.join(tmp, "cuda.csv")
        stats6 = screen(trained, iter(mols6), out_csv=gpu_csv, chunk_size=8192,
                        device="cuda")
        rows6 = read_csv(gpu_csv)
        mism6, near6, worst6 = screen_against_cpu(
            trained.to("cpu"), trained.ensemble.to_state(), mols6, gpu_csv,
            os.path.join(tmp, "cpu.csv"))
    if len(smiles6) != CHUNK + 501:
        raise AssertionError(f"{len(smiles6)} molecules not in the training set")
    if len(rows6) != len(mols6) or rows6[7][2] != "invalid":
        raise AssertionError("screen() with the trained model lost rows")
    print(f"[6 train] ScreeningModel.train(cuda) on {len(smiles)} molecules "
          f"(Morgan 2048, PCA 30, {N_TREES} trees of depth {TRAIN_DEPTH}, "
          f"subsample 0.8): {train_s:.3f} s wall | launches {train_launches} | "
          f"a second fit grew the same trees (scaler and PCA identical: "
          f"{same_projection}) | host launch calls of its forest fit "
          f"{fit_calls} | training "
          f"accuracy {train_acc:.4f}, majority "
          f"share {majority:.4f} | GBDTClassifier(subsample=1) on z: cuda "
          f"{cuda_fit_s:.3f} s, cpu {cpu_fit_s:.3f} s wall; against the cpu "
          f"fit: {cmp.trees_compared} trees equal ({cmp.equal} nodes equal, "
          f"{cmp.equivalent} equivalent), first near tie at "
          f"{cmp.first_near_tie}, max |dleaf| {cmp.max_leaf_diff:.3g}; along "
          f"the cuda fit's own splits, all {audit.trees_compared} trees: "
          f"{audit.equal} nodes equal to the plain best split, "
          f"{audit.equivalent} equivalent, {audit.near_ties} near ties (limit "
          f"1%), max |dleaf| {audit.max_leaf_diff:.3g} (limit 1e-4) | "
          f"screen(cuda) with the trained model on molecules not in the "
          f"training set ({fresh6.count(False)} of {len(stream6)} drawn were "
          f"dropped) {stats6.mol_per_s:.1f} mol/s, first {PREFIX} vs cpu: "
          f"{len(mism6)} rows differ, all near ties ({near6} near-tie rows, "
          f"limit 1%), max |dProbability| {worst6:.3g}", flush=True)

    # -- phases 7 and 8: the similarity kernels and the transfer path ---------
    from bbbp_tpu_torch.ops import similarity as sm
    from bbbp_tpu_torch.testing import regression_molecules
    from bbbp_tpu_torch.train.transfer import raw_transfer_features

    reg_smiles, reg_y = regression_molecules()
    counters = {"packed_project": packed_project,
                "dense_forest_predict": raw_predict,
                "forest_level_histogram": tr.level_histogram,
                "forest_best_splits": tr.best_splits,
                "forest_leaf_values": tr.leaf_values,
                "tanimoto_topk": sm.tanimoto_topk_packed,
                "tanimoto_gram": sm.tanimoto_gram, "minmax_gram": sm.minmax_gram}
    with tempfile.TemporaryDirectory() as cache:
        t0 = time.time()
        aux_raw = raw_transfer_features(smiles, cache_dir=cache)
        reg_raw = raw_transfer_features(reg_smiles, cache_dir=cache)
        print(f"[7 featurize] descriptors, MACCS and Morgan counts of "
              f"{len(smiles)} + {len(reg_smiles)} molecules (Python featurizer "
              f"over {os.cpu_count()} cores, MACCS from C++): "
              f"{time.time() - t0:.3f} s wall", flush=True)
        p7 = similarity_phase(cuda, card, aux_raw, reg_raw)
        wide_audit = wide_fit_audit(card, (smiles, labels), aux_raw)
        transfer_launches, leg_launches = transfer_phase(
            card, counters, (smiles, labels), (reg_smiles, reg_y), reg_raw, cache)

    kernels = [
        {"name": "packed_project", "route": "cuda",
         "source": "bbbp_tpu_torch/csrc/packed_project.cu",
         "replaces": "bbbp_tpu/ops/bitops.py:57",
         "launches": launches["packed_project"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound["bound_ms"], "bound_by": k1_bound["bound_by"],
         "bound_share": k1_bound["bound_ms"] / k1_ms,
         "library_ms": k1_lib_ms,
         "library_call": "torch.addmm(c0, bits, w) on bits already unpacked: "
                         "the product alone, not the same function",
         "ms_fingerprints": k1_fp_ms, "plain_ms_fingerprints": k1_fp_plain_ms,
         "bound_ms_fingerprints": k1_fp_bound["bound_ms"],
         "bound_share_fingerprints": k1_fp_bound["bound_ms"] / k1_fp_ms},
        {"name": "dense_forest_predict", "route": "cuda",
         "source": "bbbp_tpu_torch/csrc/dense_forest.cu",
         "replaces": "bbbp_tpu/ops/forest_tpu.py:85",
         "launches": launches["dense_forest_predict"],
         "launches_transfer": transfer_launches["dense_forest_predict"],
         "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound["bound_ms"], "bound_by": k2_bound["bound_by"],
         "bound_share": k2_bound["bound_ms"] / k2_ms, "library_ms": None,
         "ms_fingerprints": k2_fp_ms, "plain_ms_fingerprints": k2_fp_plain_ms,
         "bound_share_fingerprints": k2_bound["bound_ms"] / k2_fp_ms,
         "max_abs_err_fitted_f326": wide_audit["forest_err"],
         "f326": k2_wide},
    ]
    # the trainer's kernels at n = 7,809, F = 30: K3 and K4 at level 5 (the
    # widest level of depth 6), K5 over 64 leaves; every level in *_levels
    head, last = TRAIN_ROWS[0], TRAIN_DEPTH - 1
    train_kernels = (
        ("forest_level_histogram", "k3", "bbbp_tpu/ops/forest_tpu.py:154",
         k3_err, "torch.zeros(...).index_add_(0, keys, (g, h) values), keys and "
         "values made beforehand; bincount: torch.bincount(keys, weights=g) "
         "and (keys, weights=h), timed between events, as it synchronises"),
        ("forest_best_splits", "k4", "bbbp_tpu/ops/forest_tpu.py:125", k4_err,
         None),
        ("forest_leaf_values", "k5", "bbbp_tpu/ops/forest_tpu.py:340", k5_err,
         None))
    for name, key, replaces, err, library in train_kernels:
        t = timed[head, "k5"] if key == "k5" else timed[head, TRAIN_F, last]
        entry = {"name": name, "route": "cuda",
                 "source": "bbbp_tpu_torch/csrc/forest_train.cu",
                 "replaces": replaces, "launches": train_launches[name],
                 "launches_transfer": transfer_launches[name],
                 "max_abs_err": err, "ms": t[key], "plain_ms": t[key + "_plain"],
                 "bound_ms": t[key + "_bound"]["bound_ms"],
                 "bound_by": t[key + "_bound"]["bound_by"],
                 "bound_share": t[key + "_bound"]["bound_ms"] / t[key],
                 "library_ms": t.get(key + "_library")}
        if library:
            entry["library_call"] = library
        if key == "k5":
            entry["shape"] = f"n={head}, 64 leaves"
            entry["ms_n65536"] = timed[65536, "k5"]["k5"]
            entry["plain_ms_n65536"] = timed[65536, "k5"]["k5_plain"]
            deep = timed[head, "k5_1024"]
            entry["ms_1024_leaves"] = deep["k5"]
            entry["plain_ms_1024_leaves"] = deep["k5_plain"]
            entry["bound_ms_1024_leaves"] = deep["k5_bound"]["bound_ms"]
            for suffix, tt in (("", t), ("_1024_leaves", deep)):
                entry["ms_with_next_tree" + suffix] = tt["k5_next"]
                entry["plain_ms_with_next_tree" + suffix] = tt["k5_next_plain"]
                entry["bound_ms_with_next_tree" + suffix] = tt["k5_next_bound"]["bound_ms"]
            entry["fit_host_launch_calls"] = fit_calls
            entry["gradient_cases_bit_equal"] = k5_grad_cases
        else:
            entry["shape"] = f"n={head}, F={TRAIN_F}, level {last}"
            for n in TRAIN_ROWS:
                suffix = "_levels" if n == head else f"_levels_n{n}"
                entry["ms" + suffix] = levels(n, key)
                entry["plain_ms" + suffix] = levels(n, key + "_plain")
                entry["bound_ms" + suffix] = levels(n, key + "_bound", "bound_ms")
                if library:
                    entry["library_ms" + suffix] = levels(n, key + "_library")
                    entry["bincount_ms" + suffix] = levels(n, key + "_bincount")
            # the transfer path's width, at levels WIDE_LEVELS
            entry["levels_f326"] = list(WIDE_LEVELS)
            fields = ["", "_plain"] + (
                ["_library", "_bincount", "_no_bins"] if library else []) + (
                ["_oblivious", "_oblivious_plain"] if key == "k4" else [])
            names = {"": "ms", "_plain": "plain_ms", "_library": "library_ms",
                     "_bincount": "bincount_ms", "_no_bins": "ms_without_n_bins",
                     "_oblivious": "ms_oblivious",
                     "_oblivious_plain": "plain_ms_oblivious"}
            for field in fields:
                if field != "_no_bins":
                    entry[names[field] + "_f326_levels"] = levels(
                        head, key + field, n_feat=WIDE_F)
            entry["bound_ms_f326_levels"] = levels(head, key + "_bound",
                                                   "bound_ms", WIDE_F)
            # the same on the aux molecules' own binned rows
            for field in fields:
                if field != "_bincount":
                    entry[names[field] + "_f326_fitted_levels"] = [
                        wide_audit["fitted"][lv][key + field] for lv in WIDE_LEVELS]
        if key == "k4":
            entry["near_tie_nodes"] = k4_near
            entry["audit_f326"] = wide_audit["audit"]
            entry["audit_f326_oblivious"] = wide_audit["audit_oblivious"]
            for n in TRAIN_ROWS:
                suffix = "_levels" if n == head else f"_levels_n{n}"
                entry["ms_oblivious" + suffix] = levels(n, "k4_oblivious")
                entry["plain_ms_oblivious" + suffix] = levels(n, "k4_oblivious_plain")
        kernels.append(entry)
    # the similarity kernels: K6 at the transfer path's shape, K7 and K8 at
    # the full gram of the regression set, d = 2048; other shapes beside
    similarity_kernels = (
        ("tanimoto_topk", "k6", "transfer", "bbbp_tpu/ops/similarity.py:24",
         p7["k6_err"],
         "torch.matmul on bits already unpacked, the epilogue, torch.topk: "
         "orders ties otherwise"),
        ("tanimoto_gram", "k7", "gram_d2048", "bbbp_tpu/ops/similarity.py:60",
         p7["k7_err"], "torch.matmul on bits already unpacked, and the epilogue"),
        ("minmax_gram", "k8", "gram", "bbbp_tpu/ops/similarity.py:106",
         p7["k8_err"], "one torch.matmul of the 16 level indicators stacked to "
         "[N, 16 * 2048], already expanded, and the epilogue"))
    for name, key, main_shape, replaces, err, library in similarity_kernels:
        t = p7["timed"][key, main_shape]
        entry = {"name": name, "route": "cuda",
                 "source": "bbbp_tpu_torch/csrc/similarity.cu",
                 "replaces": replaces,
                 "launches": (transfer_launches if key == "k6" else leg_launches)[name],
                 "launches_legs": leg_launches[name], "max_abs_err": err,
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound"]["bound_ms"],
                 "bound_by": t["bound"]["bound_by"],
                 "bound_share": t["bound"]["bound_ms"] / t["ms"],
                 "library_ms": t["library_ms"], "library_call": library,
                 "shape": t["shape"]}
        if key in ("k6", "k7"):
            entry["host_launch_calls_a_call"] = p7["launch_calls"][name]
        if key == "k7":
            entry["host_launch_calls_a_weighted_call"] = \
                p7["launch_calls"]["tanimoto_gram_weighted"]
        for (k, shape), other in p7["timed"].items():
            if k != key:
                continue
            suffix = "" if shape == main_shape else "_" + shape
            for field in ("ms", "plain_ms", "library_ms", "ms_weighted",
                          "plain_ms_weighted"):
                if field in other and (suffix or field.endswith("weighted")):
                    entry[field + suffix] = other[field]
            if suffix:
                entry["bound_ms" + suffix] = other["bound"]["bound_ms"]
            if "bound_old" in other:
                entry["bound_ms_old" + suffix] = other["bound_old"]["bound_ms"]
            if "bound_weighted" in other:
                entry["bound_ms_weighted" + suffix] = other["bound_weighted"]["bound_ms"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {nvidia_smi()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
