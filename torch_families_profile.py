#!/usr/bin/env python3
"""The PyTorch port's remaining model families on one CUDA card, timed by
stage with peak memory.

    python3 torch_families_profile.py [--out FILE]

Over B3DB-format TSVs of ``testing.labelled_training_set()`` (7,809
classification molecules) and ``testing.regression_molecules()`` (1,058
regression molecules) in a temporary ``$BBBP_B3DB_DIR``:

- ``pretrain`` at the flagship script's setting (``scripts/
  run_regression_full.py``: 120,000 ``synthetic_smiles`` + the B3DB sets, 2
  epochs, batch 256);
- ``pretrain_aux(kind="graph")`` at ``AuxPretrainConfig()``'s defaults;
- ``run_regression`` at that script's configuration (the graph and SMILES
  legs, the pretrained directory, nn_seeds 3, graph_seeds 2, bert_seeds 2,
  tree_seeds 3) over the regression molecules;
- ``run_weighted_ensemble``, ``run_bert`` and ``do_flow_train`` at their
  defaults;
- one epoch of the SMILES leg (10 folds of ``BertRegressor`` at the
  pretrained widths) under ``torch.profiler``: wall, device busy ms and
  share, the host's launch calls a step and the top kernels.

Each stage: wall seconds, peak allocated GiB, the forest kernels' launches
and its result. Prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def _stage(out: dict, name: str, fn, counters):
    """Run ``fn`` on the card: wall, peak memory, launches, result."""
    import torch

    for c in counters.values():
        c.launches.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    result = fn()
    torch.cuda.synchronize()
    out[name] = {"wall_s": time.time() - t0,
                 "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                 "launches": {k: c.launches.count for k, c in counters.items()}}
    print(f"[families] {name}: {out[name]}", flush=True)
    return result


def run() -> dict:
    import numpy as np
    import torch

    from bbbp_tpu_torch.models.bert import BertRegressor, read_pretrained
    from bbbp_tpu_torch.ops import forest as fo
    from bbbp_tpu_torch.ops import forest_train as tr
    from bbbp_tpu_torch.testing import (b3db_env, labelled_training_set,
                                        regression_molecules,
                                        write_classification_tsv,
                                        write_regression_tsv)
    from bbbp_tpu_torch.train import aux_pretrain as ap
    from bbbp_tpu_torch.train import bert_pretrain as bp
    from bbbp_tpu_torch.train import regression as rg
    from bbbp_tpu_torch.train.bert_pipeline import BertTrainConfig, run_bert
    from bbbp_tpu_torch.train.flow_pipeline import FlowTrainConfig, do_flow_train
    from bbbp_tpu_torch.train.loop import FoldTrainer
    from bbbp_tpu_torch.train.weighted_ensemble import (WeightedEnsembleConfig,
                                                        run_weighted_ensemble)
    from torch_regression_profile import _profiled

    counters = {"dense_forest_predict": fo.raw_predict,
                "forest_level_histogram": tr.level_histogram,
                "forest_best_splits": tr.best_splits,
                "forest_leaf_values": tr.leaf_values}
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp, b3db_env(tmp):
        write_regression_tsv(os.path.join(tmp, "B3DB_regression.tsv"),
                             *regression_molecules())
        write_classification_tsv(os.path.join(tmp, "B3DB_classification.tsv"),
                                 *labelled_training_set())
        torch.zeros(1, device="cuda")     # the featurizer's pool spawns once CUDA is up
        pre = os.path.join(tmp, "bert_pretrained")
        _stage(out, "mlm_pretrain", lambda: bp.pretrain(bp.MLMPretrainConfig(
            corpus_size=120_000, epochs=2, batch_size=256, out_dir=pre),
            device="cuda"), counters)
        with open(os.path.join(pre, "config.json")) as f:
            out["mlm_pretrain"]["config"] = json.load(f)
        path = _stage(out, "aux_graph", lambda: ap.pretrain_aux(
            ap.AuxPretrainConfig(kind="graph"), device="cuda"), counters)
        out["aux_graph"]["holdout_auc"] = ap.load_warm_start(path)[1]
        cfg = rg.RegressionTrainConfig(graph_leg=True, bert_leg=True,
                                       bert_pretrained_dir=pre, nn_seeds=3,
                                       graph_seeds=2, bert_seeds=2, tree_seeds=3)
        res = _stage(out, "run_regression", lambda: rg.run_regression(
            cfg, device="cuda"), counters)
        out["run_regression"].update(stage_s=res.stage_s, report=res.report)
        rep = _stage(out, "weighted_ensemble", lambda: run_weighted_ensemble(
            WeightedEnsembleConfig(), device="cuda"), counters)
        out["weighted_ensemble"]["report"] = rep
        _, rep, _ = _stage(out, "run_bert", lambda: run_bert(
            BertTrainConfig(), device="cuda"), counters)
        out["run_bert"]["report"] = rep
        _, rep, _ = _stage(out, "do_flow_train", lambda: do_flow_train(
            FlowTrainConfig(), device="cuda"), counters)
        out["do_flow_train"]["report"] = rep

        # one epoch of the SMILES leg, profiled
        tok, pcfg, params = read_pretrained(pre)
        smiles, y = regression_molecules()
        ids = tok.encode_batch(smiles)
        y = np.asarray(y, np.float32)
        n, k = len(y), cfg.n_folds
        steps = (n - n // k) // cfg.batch_size
        perms = np.stack([np.random.default_rng(i).permutation(n)[:steps * cfg.batch_size]
                          for i in range(k)]).reshape(k, steps, cfg.batch_size)
        bert = FoldTrainer(BertRegressor(tok.vocab_size, n_layers=pcfg["n_layers"],
                                         d_model=pcfg["d_model"],
                                         max_len=pcfg["max_len"]),
                           (ids,), y, k, torch.device("cuda"), cfg.seed,
                           lr=cfg.bert_lr, warm_start={"enc": params})
        bert.train_epoch(perms)                         # warm
        out["bert_epoch"] = _profiled(lambda: bert.train_epoch(perms), steps)
        out["bert_predict_all"] = _profiled(bert.predict_all)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/families_profile.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_families_profile: needs a CUDA device", file=sys.stderr)
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
