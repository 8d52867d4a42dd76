#!/usr/bin/env python3
"""The oblivious split search of one tree level over lanes, both ways, on
one CUDA card: the fused oblivious search (``level_splits_oblivious_lanes``)
against K3 with lanes then K4 with lanes (oblivious), level by level, for
several lane counts. These times set ``OBLIVIOUS_FUSED_LEVELS`` in
``bbbp_tpu_torch/ops/forest_train.py``: the levels from the root that
``fit_forest_lanes`` gives the fused search in each of its forms.

    python3 torch_oblivious_profile.py [--lanes 10,15,...] [--depth 12] [--out FILE]

The rows are the classification search's (``run_classification``'s
projection and resampling, binned: 8,162 rows, 30 features), each lane a
fold's row weights with gradients of the logistic loss at random margins
and lambda 0.1-10 across the lanes, min_child 1, no column mask. Each lane
grows one oblivious tree of ``--depth`` levels with the fused search, which
routes the level before, so that each level's rows lie in the nodes a real
tree gives them; at each level both searches are timed on those positions
(``timing.device_ms``: calls captured in a CUDA graph and replayed) and
their splits compared (bit-equal, or the level is reported). Prints one
JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

LANES = (10, 15, 33, 34, 80, 131, 132, 250, 255)


def profile(lanes_list, depth: int) -> dict:
    import torch

    from bbbp_tpu_torch.ops import forest_train as tr
    from bbbp_tpu_torch.testing import classification_inputs
    from bbbp_tpu_torch.timing import device_ms
    from bbbp_tpu_torch.train import batched_search as bs
    from bbbp_tpu_torch.train import classification as cl
    from torch_classification_profile import search_rows

    cuda = torch.device("cuda")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cfg = cl.ClassificationTrainConfig()
    x, y = classification_inputs()
    xs, ys = search_rows(x, y, cfg)
    folds = bs.stratified_kfold_indices(ys, cfg.search_folds, cfg.seed)
    prep = bs._forest_prep(xs, ys, folds, cuda)
    xb, yv = prep["xb"], prep["y"]
    n, n_feat = xb.shape
    out = {"n": n, "n_feat": n_feat, "sms": sms, "depth": depth, "lanes": {}}
    for lanes in lanes_list:
        gen = torch.Generator(device=cuda)
        gen.manual_seed(lanes)
        w = prep["w_kn"][[k % len(folds) for k in range(lanes)]]
        p = torch.sigmoid(0.5 * torch.randn(lanes, n, generator=gen, device=cuda))
        g = ((p - yv) * w).contiguous()
        h = (torch.clamp(p * (1 - p), min=1e-6) * w).contiguous()
        bounds = tr.gradient_bounds(g, h)
        lam = torch.logspace(-1, 1, lanes, device=cuda)
        every = torch.ones(lanes, n_feat, dtype=torch.bool, device=cuda)
        pos = torch.zeros(lanes, n, dtype=torch.int32, device=cuda)
        internal = (1 << depth) - 1
        tree_feats = torch.zeros((lanes, 1, internal), dtype=torch.int32, device=cuda)
        tree_bins = torch.zeros_like(tree_feats)
        parent = None
        levels = {}
        for level in range(depth):
            nodes = 1 << level
            f_l, b_l, s_l = tr.level_splits_oblivious_lanes(
                xb, pos, g, h, nodes, bounds, every, lam, 1.0, parent=parent)
            hist = tr.level_histogram_lanes(xb, pos, g, h, nodes, bounds, bins_checked=True)
            two = tr.best_splits_lanes(hist, every, lam, 1.0, True)
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip((f_l, b_l, s_l), two))
            few = dict(calls=2, replays=5) if level >= 8 else {}
            t = {"fused": device_ms(lambda: tr.level_splits_oblivious_lanes(
                     xb, pos, g, h, nodes, bounds, every, lam, 1.0), **few),
                 "k3": device_ms(lambda: tr.level_histogram_lanes(
                     xb, pos, g, h, nodes, bounds, bins_checked=True), **few),
                 "k4": device_ms(lambda: tr.best_splits_lanes(hist, every, lam, 1.0, True),
                                 **few)}
            t["two"] = t["k3"] + t["k4"]
            t["bit_equal"] = equal
            t["split_lanes"] = int(s_l[:, 0].sum())
            levels[level] = t
            parent = tr.ParentSplit(f_l, b_l, tree_feats, tree_bins, 0, level)
            del hist
            torch.cuda.empty_cache()
        slower = [lv for lv, t in levels.items() if t["fused"] > t["two"]]
        out["lanes"][lanes] = {
            "form": tr.oblivious_form(lanes, n_feat, sms),
            "fused_levels_of_the_rule": tr.oblivious_fused_levels(lanes, n_feat, sms),
            "first_level_the_fused_search_is_slower": slower[0] if slower else None,
            "levels": levels}
        print(lanes, "form", out["lanes"][lanes]["form"], "first slower level",
              out["lanes"][lanes]["first_level_the_fused_search_is_slower"],
              " ".join(f"{lv}:{t['fused']:.4f}/{t['two']:.4f}{'' if t['bit_equal'] else '!'}"
                       for lv, t in levels.items()), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", default=",".join(map(str, LANES)))
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--out", default="chiprun_out/oblivious_profile.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_oblivious_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from bbbp_tpu_torch.timing import nvidia_smi

    result = {"card": nvidia_smi(), "torch": torch.__version__,
              **profile([int(v) for v in args.lanes.split(",")], args.depth)}
    result["card_after"] = nvidia_smi()
    text = json.dumps(result, indent=1)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(json.dumps({k: v for k, v in result.items() if k != "lanes"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
