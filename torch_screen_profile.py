#!/usr/bin/env python3
"""A ``torch.profiler`` run of the PyTorch port's screening path on one
CUDA card.

    python3 torch_screen_profile.py [--out FILE]

``screen()`` over 262,144 ``synthetic_smiles``, chunk 16,384, 2 dispatchers,
CSV written, the full-width fixture model of ``bbbp_tpu_torch/testing.py``,
after a warm-up: device ms by kernel and copy, launches, and the device's
busy share of the wall time; then 3 runs without the profiler for
molecules/s. Prints one JSON object and writes it to ``--out``; the
profiler's table goes beside it as ``<out>_table.txt``. The kernels alone
are timed against their plain versions by ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

CHUNK = 16384
PROFILE_N = 262144


def profile(table_path: str):
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from bbbp_tpu_torch.data.zinc import synthetic_smiles
    from bbbp_tpu_torch.ops.bitops import packed_project
    from bbbp_tpu_torch.ops.forest import raw_predict
    from bbbp_tpu_torch.pipelines.screen import ScreeningModel, screen
    from bbbp_tpu_torch.testing import full_width_screening_state
    from bbbp_tpu_torch.timing import profile_summary, profiler_table

    model = ScreeningModel.from_state(full_width_screening_state(0)).to("cuda")
    mols = [(s, f"M{i:07d}") for i, s in
            enumerate(synthetic_smiles(PROFILE_N, seed=1))]
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "out.csv")

        def run():
            return screen(model, iter(mols), out_csv=csv_path,
                          chunk_size=CHUNK, dispatch_workers=2, device="cuda")

        run()                                                  # warm-up
        packed_project.launches.reset()
        raw_predict.launches.reset()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            stats = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {"packed_project": packed_project.launches.count,
                    "dense_forest_predict": raw_predict.launches.count}
        rates = [run().mol_per_s for _ in range(3)]

    def classify(name):
        return ("dense_forest_predict" if "dense_forest" in name else
                "packed_project" if "packed_project" in name else
                "H2D" if "HtoD" in name else "D2H" if "DtoH" in name else name)

    summary = profile_summary(prof, classify)
    profiler_table(prof, table_path)
    return {"molecules": PROFILE_N, "chunk": CHUNK, "dispatchers": 2,
            "csv": True, "wall_s": wall, "featurize_s": stats.featurize_s,
            "mol_per_s_profiled": stats.mol_per_s, "launches": launches,
            **summary, "busy_share": summary["device_busy_ms"] / 1e3 / wall,
            "mol_per_s_3_runs_unprofiled": rates}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/screen_profile.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_screen_profile: needs a CUDA device", file=sys.stderr)
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
