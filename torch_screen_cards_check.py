#!/usr/bin/env python3
"""Screening over several CUDA cards: ``screen(devices=[...])`` of the
PyTorch port over 1, 2 and 4 cards (as many of them as torch sees; at least
two).

    python3 torch_screen_cards_check.py [--out FILE]     # needs >= 2 cards

Each card count screens 262,144 ``synthetic_smiles``, chunk 16,384, 2
dispatchers, CSV written, with the full-width fixture model of
``bbbp_tpu_torch/testing.py`` (as ``torch_screen_profile.py`` does): one
warm-up, one run under ``torch.profiler`` (device busy ms by card, the
host-to-device copies by card and by source memory, pinned or pageable),
then 3 runs without it (mol/s, wall s, featurize s). Held:

- each CSV byte-equal to the one-card CSV;
- each kernel launched once a shard of every chunk, counted by card;
- each shard's host-to-device copy from pinned memory on its card (the
  chunk's pinned buffer is allocated under one card, and its slices are
  copied to the others): a card's pinned copies are chunks x its shards,
  and its pageable ones only the model replica's few.

Prints the cards' ``nvidia-smi`` name and power limit and one JSON object,
which it also writes to ``--out``; exits non-zero with fewer than two cards
or when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

CHUNK = 16384
N = 262144
CARD_COUNTS = (1, 2, 4)


def copy_kind(name: str) -> str:
    """'H2D pinned', 'H2D pageable', 'D2H', a kernel, or the name as it is."""
    if "HtoD" in name:
        return "H2D pinned" if "Pinned" in name else "H2D pageable"
    return ("D2H" if "DtoH" in name else
            "dense_forest_predict" if "dense_forest" in name else
            "packed_project" if "packed_project" in name else name)


def h2d_by_card(prof) -> dict:
    """{card: {'H2D pinned' | 'H2D pageable': count}} of a profiler run."""
    import torch

    out: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and "HtoD" in ev.name:
            kinds = out.setdefault(ev.device_index, {})
            kinds[copy_kind(ev.name)] = kinds.get(copy_kind(ev.name), 0) + 1
    return out


def screen_cards(k: int, model, mols, tmp: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from bbbp_tpu_torch.ops.bitops import packed_project
    from bbbp_tpu_torch.ops.forest import raw_predict
    from bbbp_tpu_torch.pipelines.screen import screen
    from bbbp_tpu_torch.timing import profile_summary

    devices = [f"cuda:{i}" for i in range(k)]
    path = os.path.join(tmp, f"{k}.csv")

    def run():
        return screen(model, iter(mols), out_csv=path, chunk_size=CHUNK,
                      dispatch_workers=2, devices=devices)

    run()                                                      # warm-up
    for kernel in (packed_project, raw_predict):
        kernel.launches.reset()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"packed_project": dict(packed_project.launches.by_device),
                "dense_forest_predict": dict(raw_predict.launches.by_device)}
    summary = profile_summary(prof, copy_kind)
    runs = [run() for _ in range(3)]
    return {"cards": k, "csv": path, "launches_by_card": launches,
            "h2d_by_card": h2d_by_card(prof),
            "device_busy_ms_by_card": summary["device_busy_ms_by_card"],
            "busy_share_by_card": {i: ms / 1e3 / wall for i, ms in
                                   summary["device_busy_ms_by_card"].items()},
            "device": summary["device"], "wall_s_profiled": wall,
            "mol_per_s_profiled": stats.mol_per_s,
            "mol_per_s": [r.mol_per_s for r in runs],
            "wall_s": [r.wall_s for r in runs],
            "featurize_s": [r.featurize_s for r in runs]}


def problems_of(result: dict, chunks: int, one_csv: bytes) -> list:
    k = result["cards"]
    with open(result.pop("csv"), "rb") as f:
        same = f.read() == one_csv
    result["csv_equal_one_card"] = same
    problems = [] if same else [f"{k} cards: the CSV differs from one card's"]
    want = {i: chunks for i in range(k)}
    for name, by_card in result["launches_by_card"].items():
        if by_card != want:
            problems.append(f"{k} cards: {name} launches {by_card}, want {want}")
    pinned = {card: kinds.get("H2D pinned", 0)
              for card, kinds in result["h2d_by_card"].items()}
    if pinned != want:
        problems.append(f"{k} cards: H2D copies from pinned memory {pinned}, "
                        f"want {want} (chunks x shards)")
    return problems


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/screen_cards.json")
    args = ap.parse_args()
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"torch_screen_cards_check: needs at least two CUDA cards, torch "
              f"sees {n}", file=sys.stderr)
        return 1
    from bbbp_tpu_torch.data.zinc import synthetic_smiles
    from bbbp_tpu_torch.pipelines.screen import ScreeningModel
    from bbbp_tpu_torch.testing import full_width_screening_state
    from bbbp_tpu_torch.timing import nvidia_smi

    cards = nvidia_smi()
    print(f"cards: {cards}", flush=True)
    model = ScreeningModel.from_state(full_width_screening_state(0))
    mols = [(s, f"M{i:07d}") for i, s in enumerate(synthetic_smiles(N, seed=1))]
    chunks = -(-N // CHUNK)
    results, problems = [], []
    with tempfile.TemporaryDirectory() as tmp:
        one_csv = None
        for k in (c for c in CARD_COUNTS if c <= n):
            result = screen_cards(k, model, mols, tmp)
            if one_csv is None:
                with open(result["csv"], "rb") as f:
                    one_csv = f.read()
            problems += problems_of(result, chunks, one_csv)
            results.append(result)
            print(f"[{k} cards] mol/s {result['mol_per_s']}, wall s "
                  f"{result['wall_s']}, featurize s {result['featurize_s']} | "
                  f"profiled: busy ms by card {result['device_busy_ms_by_card']}"
                  f", H2D by card {result['h2d_by_card']} | launches by card "
                  f"{result['launches_by_card']} | CSV equal to one card's: "
                  f"{result['csv_equal_one_card']}", flush=True)
    out = {"cards": cards, "card_count": n, "torch": torch.__version__,
           "cuda": torch.version.cuda, "molecules": N, "chunk": CHUNK,
           "dispatchers": 2, "runs": results, "problems": problems,
           "cards_after": nvidia_smi()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({key: value for key, value in out.items() if key != "runs"}))
    if problems:
        print("torch_screen_cards_check: " + " | ".join(problems), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
