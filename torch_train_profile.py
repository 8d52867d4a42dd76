#!/usr/bin/env python3
"""A ``torch.profiler`` run of the PyTorch port's training path on one CUDA
card.

    python3 torch_train_profile.py [--out FILE]

``ScreeningModel.train`` at the default width (Morgan 2048, PCA 30, 300
trees of depth 6, subsample 0.8) over the 7,809-molecule labelled set of
``bbbp_tpu_torch/testing.py``, after a warm-up: the wall seconds of its
stages (fingerprints on the host, scaler + PCA on the card, the forest fit),
then the forest fit under the profiler: device ms by kernel, the trainer
kernels' launches, the device's busy share of the fit's wall time, and the
host's launch count. The fit and ``ScreeningModel.train`` run with the trees
as a replayed CUDA graph (the default) and eagerly (``graph=False``), in
turns (eager, graph, graph, eager), each with its wall seconds, busy share,
host launch calls a tree and peak memory. Prints one JSON object and writes
it to ``--out``; the profiler's table of the first graph run goes beside it
as ``<out>_table.txt``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def profile(table_path: str):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from bbbp_tpu_torch.native.bindings import fingerprints
    from bbbp_tpu_torch.ops import forest_train as tr
    from bbbp_tpu_torch.ops.pca import PCA
    from bbbp_tpu_torch.ops.scaler import StandardScaler
    from bbbp_tpu_torch.pipelines.screen import ScreeningModel
    from bbbp_tpu_torch.testing import eager_tree_loop, labelled_training_set
    from bbbp_tpu_torch.timing import (host_launch_calls, profile_summary,
                                       profiler_table)

    smiles, labels = labelled_training_set()
    ScreeningModel.train(smiles[:512], labels[:512], device="cuda")  # warm-up
    torch.cuda.synchronize()

    stages = {}
    t0 = time.perf_counter()
    x, _ = fingerprints(smiles, "morgan", 2048)
    stages["fingerprints_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    xt = torch.from_numpy(x).to("cuda")
    scaler = StandardScaler().fit(xt)
    xs = scaler.transform(xt)
    z = PCA(30).fit(xs).transform(xs)
    torch.cuda.synchronize()
    stages["scaler_pca_s"] = time.perf_counter() - t0
    z_np = z.cpu().numpy()

    def fit():
        return tr.GBDTClassifier(n_estimators=300, learning_rate=0.1,
                                 max_depth=6, subsample=0.8, seed=42,
                                 device="cuda").fit(z_np, labels)

    counters = (tr.level_histogram, tr.best_splits, tr.leaf_values,
                tr.forest_draws)

    def classify(name):
        for kernel in ("hist_group_kernel", "level_hist_kernel",
                       "hist_finish_kernel", "oblivious_pick_kernel",
                       "best_splits", "leaf_values_kernel", "draws_kernel"):
            if kernel in name:
                return kernel
        return "Memset" if "Memset" in name else "torch ops"

    def measure(graph: bool, table: bool) -> dict:
        with contextlib.nullcontext() if graph else eager_tree_loop():
            out = {"graph": graph}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            live = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            fit()
            torch.cuda.synchronize()
            out["forest_fit_s"] = time.perf_counter() - t0
            out["fit_peak_mib_above_live"] = (torch.cuda.max_memory_allocated()
                                              - live) / 2 ** 20
            t0 = time.perf_counter()
            ScreeningModel.train(smiles, labels, device="cuda")
            torch.cuda.synchronize()
            out["train_total_s"] = time.perf_counter() - t0
            for counter in counters:
                counter.launches.reset()
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fit()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        out["trainer_launches"] = {c.__name__: c.launches.count for c in counters}
        summary = profile_summary(prof, classify)
        if table:
            profiler_table(prof, table_path)
        calls = host_launch_calls(prof)
        out.update(fit_wall_s_profiled=wall, **summary,
                   busy_share=summary["device_busy_ms"] / 1e3 / wall,
                   host_launch_calls=calls, host_launch_calls_a_tree=calls / 300)
        return out

    runs = {"eager": [], "graph": []}
    for i, graph in enumerate((False, True, True, False)):
        runs["graph" if graph else "eager"].append(measure(graph, table=i == 1))
    return {"molecules": len(smiles), "positive_share": float(np.mean(labels)),
            "stages": stages, "runs": runs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/train_profile.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from bbbp_tpu_torch.timing import nvidia_smi

    result = {"card": nvidia_smi(), "torch": torch.__version__,
              "cuda": torch.version.cuda}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    result["profile"] = profile(os.path.splitext(args.out)[0] + "_table.txt")
    result["card_after"] = nvidia_smi()
    text = json.dumps(result, indent=1)
    print(text)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
