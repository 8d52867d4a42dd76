#!/usr/bin/env python3
"""The PyTorch port's regression stack at its defaults on one CUDA card,
timed by stage.

    python3 torch_regression_profile.py [--out FILE]

``run_regression`` at ``RegressionTrainConfig()``'s defaults (MACCS, the
honest protocol, 10 folds; the NN leg 50 epochs x 3 seeds, the MPNN 192 x 5
layers x 100 epochs x 2 seeds at 128 atoms, rf 300 x depth 10, gbdt 400 x
depth 6, cat 400 x depth 6 oblivious, 3 tree seeds each; knn, ridge, tknn,
tkrr, ckrr; the linear meta-learner) over a B3DB-format TSV of
``testing.regression_molecules()`` (1,058 molecules): wall seconds by
stage, peak allocated memory, every kernel's launches and the report. Then,
under ``torch.profiler``, one epoch of each deep leg (the Transformer+CNN
and the MPNN, 10 folds) and one fold's fit of each forest leg at the tree
matrix's width: wall, device busy ms and share, the host's launch calls (a
step for the deep legs) and the device ms of the top kernels. Prints one
JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def _profiled(fn, steps: int = 1) -> dict:
    """Wall, device busy and the host's launch calls of one call of ``fn``
    under ``torch.profiler``, and its top kernels by device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bbbp_tpu_torch.timing import host_launch_calls, profile_summary

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = profile_summary(prof, lambda name: name)
    calls = host_launch_calls(prof)
    busy = summary["device_busy_ms"]
    top = sorted(summary["device"].items(), key=lambda kv: -kv[1]["ms"])[:8]
    return {"wall_s": wall, "device_busy_ms": busy,
            "busy_share": busy / 1e3 / wall, "host_launch_calls": calls,
            "host_launch_calls_a_step": calls / steps,
            "top_device_ms": {k[:80]: round(v["ms"], 3) for k, v in top}}


def run() -> dict:
    import numpy as np
    import torch

    from bbbp_tpu_torch.chem.graph_features import graph_features
    from bbbp_tpu_torch.models.gnn import MPNNRegressor
    from bbbp_tpu_torch.models.transformer_cnn import MultiModalRegressor
    from bbbp_tpu_torch.ops import forest as fo
    from bbbp_tpu_torch.ops import forest_train as tr
    from bbbp_tpu_torch.ops import similarity as sm
    from bbbp_tpu_torch.pipelines.preprocess import (PreprocessConfig,
                                                     ProcessedData, cache_path)
    from bbbp_tpu_torch.testing import (b3db_env, regression_molecules,
                                        write_regression_tsv)
    from bbbp_tpu_torch.train import regression as rg
    from bbbp_tpu_torch.train.loop import FoldTrainer, kfold_indices

    counters = {"dense_forest_predict": fo.raw_predict,
                "forest_level_histogram": tr.level_histogram,
                "forest_best_splits": tr.best_splits,
                "forest_leaf_values": tr.leaf_values,
                "tanimoto_topk": sm.tanimoto_topk_packed,
                "tanimoto_gram": sm.tanimoto_gram, "minmax_gram": sm.minmax_gram}
    cfg = rg.RegressionTrainConfig()
    smiles, y = regression_molecules()
    out = {"molecules": len(smiles)}
    with tempfile.TemporaryDirectory() as tmp, b3db_env(tmp) as env:
        write_regression_tsv(os.path.join(tmp, "B3DB_regression.tsv"), smiles, y)
        pre = env["BBBP_PREPROCESS_CACHE"]
        torch.zeros(1, device="cuda")     # the featurizer's pool spawns once CUDA is up
        for c in counters.values():
            c.launches.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = rg.run_regression(cfg, verbose=True, device="cuda")
        torch.cuda.synchronize()
        out["run"] = {"wall_s": time.time() - t0, "stage_s": res.stage_s,
                      "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "launches": {k: c.launches.count for k, c in counters.items()},
                      "report": res.report}
        data = ProcessedData.load(cache_path(PreprocessConfig(
            fp_kind=cfg.fp_kind, image_size=cfg.image_size, workers=cfg.workers,
            seed=cfg.seed), pre))

    n, k = len(data.y), cfg.n_folds
    steps = (n - n // k) // cfg.batch_size
    perms = np.stack([np.random.default_rng(i).permutation(n)[:steps * cfg.batch_size]
                      for i in range(k)]).reshape(k, steps, cfg.batch_size)
    nn_fp = data.nn_fp_features()
    img = data.img_norm.reshape(n, cfg.image_size, cfg.image_size, 3)
    nn = FoldTrainer(MultiModalRegressor(fp_dim=nn_fp.shape[1], n_layers=cfg.n_layers,
                                         image_size=cfg.image_size),
                     (nn_fp, img), data.y, k, torch.device("cuda"), cfg.seed, lr=cfg.lr)
    nn.train_epoch(perms)                               # warm: cuDNN's plans
    out["nn_epoch"] = _profiled(lambda: nn.train_epoch(perms), steps)
    del nn
    feats, _, adj_t, mask, _ = graph_features(data.smiles, max_atoms=cfg.max_atoms,
                                              edge_types=True)
    graph = FoldTrainer(MPNNRegressor(feats.shape[-1], hidden=cfg.graph_hidden,
                                      n_layers=cfg.graph_layers),
                        (feats, adj_t, mask), data.y, k, torch.device("cuda"),
                        cfg.seed, lr=cfg.graph_lr)
    graph.train_epoch(perms)
    out["graph_epoch"] = _profiled(lambda: graph.train_epoch(perms), steps)
    out["graph_predict_all"] = _profiled(graph.predict_all)
    del graph

    xt = rg._tree_features_global(data, device="cuda")
    folds = kfold_indices(n, k, cfg.seed)
    rows = np.concatenate(folds[1:])
    x, yt = xt[rows], data.y[rows]
    out["tree_features"] = int(xt.shape[1])
    fits = {
        "rf": lambda: tr.RandomForestRegressor(
            n_estimators=cfg.rf_trees, max_depth=cfg.rf_depth,
            colsample=cfg.rf_colsample, reg_lambda=cfg.rf_lambda, seed=cfg.seed,
            device="cuda").fit(x, yt),
        "gbdt": lambda: tr.GBDTRegressor(
            n_estimators=cfg.gbdt_trees, learning_rate=cfg.gbdt_lr,
            max_depth=cfg.gbdt_depth, subsample=cfg.gbdt_subsample,
            reg_lambda=cfg.gbdt_lambda, seed=cfg.seed, device="cuda").fit(x, yt),
        "cat": lambda: tr.GBDTRegressor(
            n_estimators=cfg.cat_trees, learning_rate=cfg.cat_lr,
            max_depth=cfg.cat_depth, oblivious=True, subsample=cfg.cat_subsample,
            reg_lambda=cfg.cat_lambda, seed=cfg.seed, device="cuda").fit(x, yt)}
    for name, fit in fits.items():
        out[f"fit_{name}"] = _profiled(fit)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/regression_profile.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_regression_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from bbbp_tpu_torch.timing import nvidia_smi

    result = {"card": nvidia_smi(), "torch": torch.__version__,
              "cuda": torch.version.cuda}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    result["profile"] = run()
    result["card_after"] = nvidia_smi()
    text = json.dumps(result, indent=1)
    print(text)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
