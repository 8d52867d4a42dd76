#!/usr/bin/env python3
"""The PyTorch port's classification ensemble at its defaults on one CUDA
card, timed by stage.

    python3 torch_classification_profile.py [--forest-lanes] [--out FILE]

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
one after the other, since wall seconds differ between hosts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def xgb_search_both_ways(x, y, cfg) -> dict:
    """Wall seconds of xgb's tuned search over ``run_classification``'s own
    search rows (projection, SMOTE-Tomek and split as it takes them),
    sequentially and then as lanes, and the largest difference of their
    trials' CV accuracies."""
    import numpy as np
    import torch

    from bbbp_tpu_torch.ops import resample as rs
    from bbbp_tpu_torch.ops.similarity import f32_matmul
    from bbbp_tpu_torch.train import batched_search as bs
    from bbbp_tpu_torch.train import classification as cl

    cuda = torch.device("cuda")
    with f32_matmul():
        z = cl._project(cl._fit_basis(x, cfg.pca_dim, cuda), x, cuda)
    xs, ys = rs.smote_tomek(z, y, seed=cfg.seed, device=cuda)
    perm = np.random.default_rng(cfg.seed).permutation(len(ys))
    tr_rows = perm[int(len(ys) * cfg.test_size):]
    out, accs = {}, {}
    for mode, on in (("sequential", False), ("lanes", True)):
        bs.FOREST_VMAP = on
        torch.cuda.synchronize()
        t0 = time.time()
        _, trials, _ = cl.tune_zoo(xs[tr_rows], ys[tr_rows], ("xgb",), cfg,
                                   verbose=False, device=cuda)
        torch.cuda.synchronize()
        out[mode + "_s"] = time.time() - t0
        accs[mode] = np.array([t["mean_accuracy"] for t in trials["xgb"]])
    out["trials"] = len(accs["lanes"])
    out["max_accuracy_diff"] = float(np.abs(accs["lanes"] - accs["sequential"]).max())
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
                "forest_route_rows": tr.route_rows,
                "forest_level_histogram_lanes": tr.level_histogram_lanes,
                "forest_best_splits_lanes": tr.best_splits_lanes,
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
        result["xgb_search"] = xgb_search_both_ways(x, y, cfg)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--forest-lanes", action="store_true",
                    help="run the forest searches as lanes (BBBP_FOREST_VMAP=1) "
                         "and time xgb's search both ways")
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
    result["run"] = run(args.forest_lanes)
    result["card_after"] = nvidia_smi()
    text = json.dumps(result, indent=1)
    print(text)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
