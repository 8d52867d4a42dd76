#!/usr/bin/env python3
"""The PyTorch port's classification ensemble at its defaults on one CUDA
card, timed by stage.

    python3 torch_classification_profile.py [--forest-lanes | --groups] [--out FILE]

``run_classification`` at ``ClassificationTrainConfig()``'s defaults (MACCS
→ PCA 30 → SMOTE-Tomek → the 10-model zoo, each tuned by a 50-trial + default
randomized search over 5 folds, forests included → 5-fold stacking →
AUC-weighted voting) over ``testing.classification_inputs()`` (7,809
labelled molecules): wall seconds by stage (each model's search among them), peak
allocated memory, the forest kernels' launches and the 12-row report
(``chip_smoke.py`` phase 10 runs ``tune=False``). Prints one JSON object and
writes it to ``--out``.

``--forest-lanes`` sets ``batched_search.FOREST_VMAP`` (``BBBP_FOREST_VMAP=1``)
for the run, so each forest family's search runs as lanes
(``_forest_cv_vmapped``); then, on the run's own search rows (the training
split after SMOTE-Tomek), it times xgb's search sequentially and as lanes,
one after the other, since wall seconds differ between hosts, and rf's and
dt's tuned searches with each form of the lanes' split search (the fused
``level_splits_lanes``, and K3 then K4 with lanes) in turns: wall s, peak
memory, scores equal, and rf's lanes' first 10 trees under
``torch.profiler`` (device busy ms, host launch calls, largest kernels);
and xgb's and rf's tuned groups as ``--groups`` times them.

``--groups`` runs only xgb's and rf's tuned lane groups over the search rows
(50 trials and the default x 5 folds: 255 lanes of 300 trees of depth 6 and
250 of 300 of depth 10 with the default trial's 5 lanes of 200, as
``chip_smoke.py`` phase 14 runs them), each with
its trees as a replayed CUDA graph (the default) and eagerly
(``graph=False``), after a warm-up of each, in turns (eager, graph, graph,
eager): wall s, peak and reserved memory and scores equal, then each loop
over the whole group under ``torch.profiler``: device busy share, host
launch calls a tree step.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


PROFILED_TREES = 10


def search_rows(x, y, cfg):
    """``run_classification``'s own search rows: projection, SMOTE-Tomek and
    the training split as it takes them."""
    import numpy as np
    import torch

    from bbbp_tpu_torch.ops import resample as rs
    from bbbp_tpu_torch.ops.similarity import f32_matmul
    from bbbp_tpu_torch.train import classification as cl

    cuda = torch.device("cuda")
    with f32_matmul():
        z = cl._project(cl._fit_basis(x, cfg.pca_dim, cuda), x, cuda)
    xs, ys = rs.smote_tomek(z, y, seed=cfg.seed, device=cuda)
    perm = np.random.default_rng(cfg.seed).permutation(len(ys))
    keep = perm[int(len(ys) * cfg.test_size):]
    return xs[keep], ys[keep]


def xgb_search_both_ways(xs, ys, cfg) -> dict:
    """Wall seconds of xgb's tuned search over the search rows,
    sequentially and then as lanes, and the largest difference of their
    trials' CV accuracies."""
    import numpy as np
    import torch

    from bbbp_tpu_torch.train import batched_search as bs
    from bbbp_tpu_torch.train import classification as cl

    cuda = torch.device("cuda")
    out, accs = {}, {}
    for mode, on in (("sequential", False), ("lanes", True)):
        bs.FOREST_VMAP = on
        torch.cuda.synchronize()
        t0 = time.time()
        _, trials, _ = cl.tune_zoo(xs, ys, ("xgb",), cfg, verbose=False, device=cuda)
        torch.cuda.synchronize()
        out[mode + "_s"] = time.time() - t0
        accs[mode] = np.array([t["mean_accuracy"] for t in trials["xgb"]])
    out["trials"] = len(accs["lanes"])
    out["max_accuracy_diff"] = float(np.abs(accs["lanes"] - accs["sequential"]).max())
    return out


def search_both_forms(xs, ys, cfg) -> dict:
    """rf's tuned search as lanes (50 trials and the default x 5 folds: a
    250-lane group of 300 trees of depth 10) and dt's (255 lanes of one tree
    of depth up to 12), each with the fused split search and with K3 then K4
    with lanes behind ``level_splits_lanes``'s name, in turns (fused, two,
    two, fused): wall s, peak allocated memory, scores equal; then each form
    over rf's lanes' first ``PROFILED_TREES`` trees under
    ``torch.profiler``."""
    import numpy as np
    import torch

    from bbbp_tpu_torch.ops import forest_train as tr
    from bbbp_tpu_torch.timing import host_launch_calls, profile_summary
    from bbbp_tpu_torch.train import batched_search as bs
    from bbbp_tpu_torch.train import classification as cl

    def two_kernels(xb, pos, g, h, n_nodes, bounds, col_mask, lam, min_child,
                    n_bins=None, *, bins_checked=False):
        hist = tr.level_histogram_lanes(xb, pos, g, h, n_nodes, bounds, n_bins,
                                        bins_checked=bins_checked)
        return tr.best_splits_lanes(hist, col_mask, lam, min_child, False)

    cuda = torch.device("cuda")
    n_iter = (cfg.n_search_iter if cfg.n_search_iter_forest is None
              else cfg.n_search_iter_forest)
    forms = {"fused": tr.level_splits_lanes, "two": two_kernels}
    bs.FOREST_VMAP = True
    out = {"rf_profile": {}}
    try:
        for m in ("rf", "dt"):
            runs, scores = [], {}
            for form in ("fused", "two", "two", "fused"):
                tr.level_splits_lanes = forms[form]
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.time()
                res = bs.batched_random_search(
                    m, xs, ys, cl.SEARCH_SPACES[m], n_iter=n_iter,
                    cv=cfg.search_folds, seed=cfg.seed,
                    extra_trials=[cl.DEFAULT_TRIALS[m]], device=cuda)
                torch.cuda.synchronize()
                runs.append({"form": form, "wall_s": time.time() - t0,
                             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
                scores.setdefault(form, [t["mean_accuracy"] for t in res.trials])
            out[m] = {"trials": len(scores["fused"]), "runs": runs,
                      "scores_equal": bool(np.array_equal(scores["fused"],
                                                          scores["two"]))}
            if m == "rf":
                trials = res.trials
        window = [{**{k: v for k, v in t.items()
                      if not k.startswith("mean_") and k != "repeat_std"},
                   "n_estimators": PROFILED_TREES} for t in trials]
        for form in ("fused", "two"):
            tr.level_splits_lanes = forms[form]
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.time()
                bs._score_param_sets("rf", xs, ys, window, cfg.search_folds, cfg.seed,
                                     False, cuda)
                torch.cuda.synchronize()
                wall = time.time() - t0
            summary = profile_summary(prof, lambda name: name)
            top = sorted(summary["device"].items(), key=lambda kv: -kv[1]["ms"])[:6]
            out["rf_profile"][form] = {
                "trees": PROFILED_TREES, "wall_s": wall,
                "busy_ms": summary["device_busy_ms"],
                "host_launch_calls": host_launch_calls(prof),
                "largest_kernels_ms": [[name[:70], v["ms"], v["count"]]
                                       for name, v in top]}
    finally:
        tr.level_splits_lanes = forms["fused"]
    return out


def groups_both_loops(xs, ys, cfg) -> dict:
    """xgb's and rf's tuned lane groups with the replayed graph of a tree
    and with the eager loop, in turns, then each loop under the profiler
    over the whole group."""
    import contextlib

    import numpy as np
    import torch

    from bbbp_tpu_torch.testing import eager_tree_loop
    from bbbp_tpu_torch.timing import host_launch_calls, profile_summary
    from bbbp_tpu_torch.train import batched_search as bs
    from bbbp_tpu_torch.train import classification as cl

    cuda = torch.device("cuda")
    bs.FOREST_VMAP = True
    out = {}
    for m in ("xgb", "rf"):
        kw = dict(n_iter=50, cv=cfg.search_folds, seed=cfg.seed,
                  extra_trials=[cl.DEFAULT_TRIALS[m]], device=cuda)
        runs, scores = {"eager": [], "graph": []}, {}
        for graph in (False, True):               # a warm-up of each loop
            with contextlib.nullcontext() if graph else eager_tree_loop():
                bs.batched_random_search(m, xs, ys, cl.SEARCH_SPACES[m], **kw)
        for graph in (False, True, True, False):
            loop = "graph" if graph else "eager"
            with contextlib.nullcontext() if graph else eager_tree_loop():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                live = torch.cuda.memory_allocated()
                t0 = time.time()
                res = bs.batched_random_search(m, xs, ys, cl.SEARCH_SPACES[m], **kw)
                torch.cuda.synchronize()
                runs[loop].append({
                    "wall_s": time.time() - t0,
                    "peak_gib_above_live": (torch.cuda.max_memory_allocated() - live)
                    / 2 ** 30,
                    "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30})
            scores.setdefault(loop, [t["mean_accuracy"] for t in res.trials])
        params = [{k: v for k, v in t.items()
                   if not k.startswith("mean_") and k != "repeat_std"} for t in res.trials]
        # a tree step is one tree of one group of lanes (one replay)
        trees = sum(n_est for _, n_est, _, _ in bs._forest_groups(params))
        for graph in (False, True):
            loop = "graph" if graph else "eager"
            with contextlib.nullcontext() if graph else eager_tree_loop():
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    t0 = time.time()
                    bs.batched_random_search(m, xs, ys, cl.SEARCH_SPACES[m], **kw)
                    torch.cuda.synchronize()
                    wall = time.time() - t0
            busy = profile_summary(prof, lambda name: name)["device_busy_ms"]
            calls = host_launch_calls(prof)
            runs[loop + "_profiled"] = {
                "wall_s": wall, "busy_ms": busy, "busy_share": busy / 1e3 / wall,
                "host_launch_calls": calls, "host_launch_calls_a_tree_step": calls / trees,
                "generator_draws": sum(e.count for e in prof.key_averages()
                                       if e.key in ("aten::rand", "aten::poisson"))}
        out[m] = {"trials": len(scores["graph"]), "tree_steps": trees, **runs,
                  "scores_equal": bool(np.array_equal(scores["graph"], scores["eager"]))}
    return out


def run(forest_lanes: bool) -> dict:
    import torch

    from bbbp_tpu_torch.ops import forest as fo
    from bbbp_tpu_torch.ops import forest_train as tr
    from bbbp_tpu_torch.testing import classification_inputs
    from bbbp_tpu_torch.train import batched_search as bs
    from bbbp_tpu_torch.train import classification as cl

    counters = {"dense_forest_predict": fo.raw_predict,
                "forest_level_histogram": tr.level_histogram,
                "forest_best_splits": tr.best_splits,
                "forest_leaf_values": tr.leaf_values,
                "forest_level_histogram_lanes": tr.level_histogram_lanes,
                "forest_best_splits_lanes": tr.best_splits_lanes,
                "forest_level_splits_lanes": tr.level_splits_lanes,
                "forest_leaf_values_lanes": tr.leaf_values_lanes}
    bs.FOREST_VMAP = forest_lanes or bs.FOREST_VMAP
    cfg = cl.ClassificationTrainConfig()
    x, y = classification_inputs()
    for c in counters.values():
        c.launches.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = cl.run_classification(cfg, x, y, verbose=True, device="cuda")
    torch.cuda.synchronize()
    result = {"molecules": len(y), "forest_lanes": bs.FOREST_VMAP,
              "wall_s": time.time() - t0, "stage_s": res.stage_s,
              "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "launches": {k: c.launches.count for k, c in counters.items()},
              "report": res.report}
    if forest_lanes:
        xs, ys = search_rows(x, y, cfg)
        result["xgb_search"] = xgb_search_both_ways(xs, ys, cfg)
        result["split_search_forms"] = search_both_forms(xs, ys, cfg)
        result["groups"] = groups_both_loops(xs, ys, cfg)
    return result


def groups_only() -> dict:
    from bbbp_tpu_torch.testing import classification_inputs
    from bbbp_tpu_torch.train import classification as cl

    cfg = cl.ClassificationTrainConfig()
    x, y = classification_inputs()
    xs, ys = search_rows(x, y, cfg)
    return {"search_rows": len(ys), "groups": groups_both_loops(xs, ys, cfg)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--forest-lanes", action="store_true",
                    help="run the forest searches as lanes (BBBP_FOREST_VMAP=1), "
                         "time xgb's search both ways and rf's and dt's with both "
                         "split search forms")
    ap.add_argument("--groups", action="store_true",
                    help="time only xgb's and rf's tuned lane groups, with the "
                         "graph of a tree and eagerly")
    ap.add_argument("--out", default="chiprun_out/classification_profile.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_classification_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from bbbp_tpu_torch.timing import nvidia_smi

    result = {"card": nvidia_smi(), "torch": torch.__version__,
              "cuda": torch.version.cuda}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    result["run"] = groups_only() if args.groups else run(args.forest_lanes)
    result["card_after"] = nvidia_smi()
    text = json.dumps(result, indent=1)
    print(text)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
