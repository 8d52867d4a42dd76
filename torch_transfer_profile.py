#!/usr/bin/env python3
"""A ``torch.profiler`` run of the PyTorch port's transfer path and of the
regression stack's chemistry-kernel legs on one CUDA card.

    python3 torch_transfer_profile.py [--out FILE]

The 7,809-molecule labelled set and the 1,058 regression molecules of
``bbbp_tpu_torch/testing.py``: the wall seconds of the Python featurizer
(descriptors, MACCS, Morgan counts; nothing cached), then
``transfer_features`` on ``cuda`` with ``TransferConfig()`` defaults and its
wall seconds by stage, then under the profiler one full fit of each aux
forest at the transfer path's 326 features (``gbdt``, ``oblivious``,
``rf``), a whole ``transfer_features`` call (raw features cached) and the
10-fold legs: device ms by kernel, the device's busy share of the wall time
and the host's launch calls. Each aux forest's fit runs with its trees as a
replayed CUDA graph (the default) and eagerly (``graph=False``), in turns
(eager, graph, graph, eager), each with its wall seconds, busy share, host
launch calls a tree and peak memory. Prints one JSON object and
writes it to ``--out``; the profiler's tables go beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import sys
import tempfile
import time

KERNELS = ("hist_group_kernel", "level_hist_kernel", "hist_finish_kernel",
           "oblivious_pick_kernel", "best_splits", "draws_kernel",
           "leaf_values_kernel", "dense_forest_kernel",
           "tanimoto_topk_kernel", "tanimoto_gram_kernel", "weighted_gram_kernel",
           "minmax_gram_kernel", "row_sums_kernel")


def classify(name: str) -> str:
    for kernel in KERNELS:
        if kernel in name:
            return kernel
    return "Memset" if "Memset" in name else "torch ops"


def profile(out_stem: str):
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from bbbp_tpu_torch.testing import (eager_tree_loop, labelled_training_set,
                                        regression_legs, regression_molecules)
    from bbbp_tpu_torch.timing import (host_launch_calls, profile_summary,
                                       profiler_table)
    from bbbp_tpu_torch.train import transfer as tf

    aux = labelled_training_set()
    reg_smiles, reg_y = regression_molecules()
    result = {"aux_molecules": len(aux[0]), "regression_molecules": len(reg_smiles)}
    torch.zeros(1, device="cuda")            # the pool spawns once CUDA is up

    def profiled(name, fn):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        summary = profile_summary(prof, classify)
        profiler_table(prof, f"{out_stem}_{name}_table.txt")
        calls = host_launch_calls(prof)
        return {"wall_s_profiled": wall, **summary,
                "busy_share": summary["device_busy_ms"] / 1e3 / wall,
                "host_launch_calls": calls}

    with tempfile.TemporaryDirectory() as cache:
        t0 = time.perf_counter()
        tf.raw_transfer_features(aux[0], cache_dir=cache)
        reg_raw = tf.raw_transfer_features(reg_smiles, cache_dir=cache)
        result["featurize_s"] = time.perf_counter() - t0
        cfg = tf.TransferConfig(cache_dir=cache)
        t0 = time.perf_counter()
        res = tf.transfer_features(reg_smiles, cfg, aux_data=aux, verbose=False,
                                   device="cuda")
        result["transfer_wall_s"] = time.perf_counter() - t0
        result["transfer_stage_s"] = res.seconds
        result["holdout_auc"] = res.holdout_auc
        aux_x, _, _ = tf._aux_feature_basis(aux[0], cfg.morgan_pca_dim,
                                            cache_dir=cache, device="cuda")
        # the whole call once more, profiled, its result file removed (the
        # raw features stay cached)
        for path in glob.glob(os.path.join(cache, "transfer_*.npz")):
            os.remove(path)
        result["transfer_features"] = profiled("transfer", lambda: tf.transfer_features(
            reg_smiles, cfg, aux_data=aux, verbose=False, device="cuda"))
    aux_y = aux[1].astype("float32")
    for name in ("gbdt", "oblivious", "rf"):
        trees = tf._make_model(name, cfg, cfg.seed, "cuda").n_estimators
        runs = {"eager": [], "graph": []}
        for turn, graph in enumerate((False, True, True, False)):
            with contextlib.nullcontext() if graph else eager_tree_loop():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                live = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                tf._make_model(name, cfg, cfg.seed, "cuda").fit(aux_x, aux_y)
                torch.cuda.synchronize()
                run = {"wall_s": time.perf_counter() - t0,
                       "peak_mib_above_live": (torch.cuda.max_memory_allocated()
                                               - live) / 2 ** 20}
                run.update(profiled(f"{name}_{'graph' if graph else 'eager'}{turn}",
                                    lambda: tf._make_model(name, cfg, cfg.seed,
                                                           "cuda").fit(aux_x, aux_y)))
            run["host_launch_calls_a_tree"] = run["host_launch_calls"] / trees
            runs["graph" if graph else "eager"].append(run)
        result[f"{name}_fit"] = {"trees": trees, **runs}
    t0 = time.perf_counter()
    regression_legs(*reg_raw, reg_y, device="cuda")
    torch.cuda.synchronize()
    unprofiled = time.perf_counter() - t0
    result["legs"] = {"wall_s": unprofiled, **profiled(
        "legs", lambda: regression_legs(*reg_raw, reg_y, device="cuda"))}
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/transfer_profile.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_transfer_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from bbbp_tpu_torch.timing import nvidia_smi

    result = {"card": nvidia_smi(), "torch": torch.__version__,
              "cuda": torch.version.cuda}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    result["profile"] = profile(os.path.splitext(args.out)[0])
    result["card_after"] = nvidia_smi()
    text = json.dumps(result, indent=1)
    print(text)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
