#!/usr/bin/env python3
"""The PyTorch port's classification ensemble at its defaults on one CUDA
card, timed by stage.

    python3 torch_classification_profile.py [--out FILE]

``run_classification`` at ``ClassificationTrainConfig()``'s defaults (MACCS
→ PCA 30 → SMOTE-Tomek → the 10-model zoo, each tuned by a 50-trial + default
randomized search over 5 folds, forests included → 5-fold stacking →
AUC-weighted voting) over ``testing.classification_inputs()`` (7,809
labelled molecules): wall seconds by stage (each model's search among them), peak
allocated memory, the forest kernels' launches and the 12-row report
(``chip_smoke.py`` phase 10 runs ``tune=False``). Prints one JSON object and
writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def run() -> dict:
    import torch

    from bbbp_tpu_torch.ops import forest as fo
    from bbbp_tpu_torch.ops import forest_train as tr
    from bbbp_tpu_torch.testing import classification_inputs
    from bbbp_tpu_torch.train import classification as cl

    counters = {"dense_forest_predict": fo.raw_predict,
                "forest_level_histogram": tr.level_histogram,
                "forest_best_splits": tr.best_splits,
                "forest_leaf_values": tr.leaf_values}
    x, y = classification_inputs()
    for c in counters.values():
        c.launches.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = cl.run_classification(cl.ClassificationTrainConfig(), x, y,
                                verbose=True, device="cuda")
    torch.cuda.synchronize()
    return {"molecules": len(y), "wall_s": time.time() - t0,
            "stage_s": res.stage_s,
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": {k: c.launches.count for k, c in counters.items()},
            "report": res.report}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
    result["run"] = run()
    result["card_after"] = nvidia_smi()
    text = json.dumps(result, indent=1)
    print(text)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
