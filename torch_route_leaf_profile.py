#!/usr/bin/env python3
"""The routing inside the sort and K5, and K5 with lanes in each launch
shape, timed on one CUDA card (and against an earlier build of the
trainer's kernels, where one is given).

    python3 torch_route_leaf_profile.py [--earlier FILE.cu] [--out FILE]

At n = 8,162 rows and F = 30 features (7,809 rows for one fit), device ms
a call from CUDA graphs (``timing.device_ms``), positions restored from the
parents' before each routed call and that copy timed alone and taken off:

- the fused split search over L = 15 and 250 lanes at the level after
  levels 0, 5, 9 and 10, with the routing of that level's split and alone
  on the routed positions; one fit's K3 at the levels after 0-4 the same;
- K5 of one fit (64 leaves, the next tree) with routing and alone;
- K5 with lanes (64 and 1,024 leaves, the next tree, routing) at L = 15,
  50, 100, 250 and 255 in the chosen shape, the cluster form of
  ``leaf_plan(n)`` blocks and of 4 and 2, and a block a lane, each shape's
  bits held equal;
- the host's launch calls of one 30-tree boosted fit of depth 6.

``--earlier`` builds an earlier ``csrc/forest_train.cu`` beside the tree's,
one with the routing kernel ``bbbp_forest_route_rows`` (PR 15's: ``git show
24a6f45:bbbp_tpu_torch/csrc/forest_train.cu``), and times in turns (earlier,
tree, tree, earlier) its routing kernel, its sorts alone and its K5 in the
cluster form on the same inputs, holding its results equal to the tree's.
Writes JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

N, F, N_ONE = 8162, 30, 7809


def earlier_lib(source: str):
    """The earlier source built as a library of its own, its C entries
    bound with their signatures at that commit."""
    from bbbp_tpu_torch import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, "forest_train_earlier.so")
    subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS + [source, "-o", so], check=True)
    lib = ctypes.CDLL(so)
    P, I, Fl, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.bbbp_forest_route_rows.argtypes = [P, I, I, P, P, P, I, P, P, L, I, P]
    lib.bbbp_forest_level_splits_lanes.argtypes = [
        P, I, I, P, P, P, I, P, P, P, P, Fl, I, I, I, P, P, P, P, P, P, P, I, L, P]
    lib.bbbp_forest_level_histogram.argtypes = [
        P, I, I, P, P, P, I, P, P, I, I, I, I, P, P, P, P, P]
    lib.bbbp_forest_leaf_values.argtypes = [
        P, I, P, P, I, Fl, Fl, P, P, P, P, P, P, Fl, I, P, P, P, I, P]
    lib.bbbp_forest_leaf_values_lanes.argtypes = [
        P, I, P, P, I, P, P, P, P, P, P, P, P, P, I, P, P, P, I, I, P]
    return lib


class Earlier:
    """The earlier build's calls, with the tree's scratch plans."""

    def __init__(self, lib, tr, torch):
        self.lib, self.tr, self.torch = lib, tr, torch

    def stream(self):
        return self.torch.cuda.current_stream().cuda_stream

    def check(self, rc, name):
        if rc:
            raise RuntimeError(f"earlier {name}: cudaError {rc}")

    def route(self, xb, pos, split, lanes):
        level, feats, bins = split.level, split.feats, split.bins
        first = 4 * ((1 << level) - 1)
        self.check(self.lib.bbbp_forest_route_rows(
            xb.data_ptr(), xb.shape[0], xb.shape[1], pos.data_ptr(), split.f_l.data_ptr(),
            split.b_l.data_ptr(), 1 << level, feats.data_ptr() + first,
            bins.data_ptr() + first, feats.shape[-1], lanes, self.stream()), "route_rows")

    def fused(self, xb, pos, g, h, nodes, bounds, col, lam, n_bins):
        tr, torch = self.tr, self.torch
        lanes, n = pos.shape
        n_feat = xb.shape[1]
        plan = tr.histogram_plan(n, n_feat, nodes)
        stride = tr.lane_words(n, n_feat, nodes)
        scratch = torch.empty(lanes * stride, dtype=torch.int64, device=xb.device)
        base = scratch.data_ptr()
        groups = -(-n_feat // tr.SPLIT_GROUP)
        cand = torch.empty(2 * lanes * nodes * groups, dtype=torch.int32, device=xb.device)
        out = [torch.empty((lanes, nodes), dtype=d, device=xb.device)
               for d in (torch.int32, torch.int32, torch.bool)]
        run = tr.split_run(lanes, plan["max_items"] * groups,
                           torch.cuda.get_device_properties(xb.device).multi_processor_count)
        self.check(self.lib.bbbp_forest_level_splits_lanes(
            xb.data_ptr(), n, n_feat, pos.data_ptr(), g.data_ptr(), h.data_ptr(), nodes,
            bounds.data_ptr(), n_bins.data_ptr(), col.data_ptr(), lam.data_ptr(), 1.0,
            plan["rows_per_item"], plan["own_rows"], run, base + 8 * plan["rows"],
            base + 8 * plan["plan"], base, cand.data_ptr(), *(t.data_ptr() for t in out),
            lanes, stride, self.stream()), "level_splits_lanes")
        return out

    def k3(self, xb, pos, g, h, nodes, bounds, n_bins):
        tr, torch = self.tr, self.torch
        n, n_feat = xb.shape
        plan = tr.histogram_plan(n, n_feat, nodes)
        scratch = torch.empty(plan["words"], dtype=torch.int64, device=xb.device)
        base = scratch.data_ptr()
        out = torch.empty((nodes, n_feat, 64, 2), device=xb.device)
        self.check(self.lib.bbbp_forest_level_histogram(
            xb.data_ptr(), n, n_feat, pos.data_ptr(), g.data_ptr(), h.data_ptr(), nodes,
            bounds.data_ptr(), n_bins.data_ptr(), plan["tile_feats"], plan["threads"],
            plan["rows_per_item"], plan["own_rows"], base + 8 * plan["rows"],
            base + 8 * plan["plan"], base, out.data_ptr(), self.stream()),
            "level_histogram")
        return out

    def k5(self, pos, g, h, leaves, preds, bounds, nxt):
        torch = self.torch
        n = pos.shape[0]
        leaf = torch.empty(leaves, device=pos.device)
        out = [torch.empty(n, device=pos.device), torch.empty(n, device=pos.device),
               torch.empty(2, device=pos.device)]
        self.check(self.lib.bbbp_forest_leaf_values(
            pos.data_ptr(), n, g.data_ptr(), h.data_ptr(), leaves, 1.0, 0.1,
            bounds.data_ptr(), leaf.data_ptr(), preds.data_ptr(), nxt.y.data_ptr(),
            nxt.u.data_ptr(), nxt.w_rows.data_ptr(), float(nxt.subsample), 1,
            *(t.data_ptr() for t in out), self.tr.leaf_plan(n), self.stream()), "leaf_values")
        return (leaf, *out)

    def k5_lanes(self, pos, g, h, leaves, lam, scale, preds, bounds, nxt):
        torch = self.torch
        lanes, n = pos.shape
        leaf = torch.empty((lanes, leaves), device=pos.device)
        out = [torch.empty((lanes, n), device=pos.device),
               torch.empty((lanes, n), device=pos.device),
               torch.empty((lanes, 2), device=pos.device)]
        self.check(self.lib.bbbp_forest_leaf_values_lanes(
            pos.data_ptr(), n, g.data_ptr(), h.data_ptr(), leaves, lam.data_ptr(),
            scale.data_ptr(), bounds.data_ptr(), leaf.data_ptr(), preds.data_ptr(),
            nxt.y.data_ptr(), nxt.u.data_ptr(), nxt.w_rows.data_ptr(),
            nxt.subsample.data_ptr(), 1, *(t.data_ptr() for t in out),
            self.tr.leaf_plan(n), lanes, self.stream()), "leaf_values_lanes")
        return (leaf, *out)


def profile(earlier_source):
    import numpy as np
    import torch

    from bbbp_tpu_torch.ops import forest_train as tr
    from bbbp_tpu_torch.ops.forest_train import GBDTClassifier
    from bbbp_tpu_torch.timing import device_ms, host_launch_calls, leaf_values_bound

    cuda = torch.device("cuda")
    old = Earlier(earlier_lib(earlier_source), tr, torch) if earlier_source else None
    gen = torch.Generator(device=cuda)
    gen.manual_seed(16)
    xb = torch.randint(0, 64, (N, F), generator=gen, device=cuda).to(torch.uint8)
    n_bins = torch.full((F,), 64, dtype=torch.uint8, device=cuda)

    def ints(high, shape):
        return torch.randint(0, high, shape, generator=gen, dtype=torch.int32, device=cuda)

    def split_of(lead, level, n_internal):
        feats = torch.zeros(lead + (1, n_internal), dtype=torch.int32, device=cuda)
        return tr.ParentSplit(ints(F, lead + (1 << level,)), ints(64, lead + (1 << level,)),
                              feats, torch.zeros_like(feats), 0, level)

    def routed_of(xb_, parents, split):
        routed = parents.clone()
        tr.route_rows_reference(xb_, routed, split.f_l, split.b_l, split.feats.clone(),
                                split.bins.clone(), 0, split.level)
        return routed

    def turns(timings):
        """{name: fn} timed earlier, tree, tree, earlier (``old_*`` names are
        the earlier build's): each name's two times."""
        out = {}
        for order in ((True, False), (False, True)):
            for first_old in order:
                for name, fn in timings.items():
                    if name.startswith("old_") == first_old:
                        out.setdefault(name, []).append(device_ms(fn))
        return out

    sorts = {}
    for lanes in (15, 250):
        w = (torch.rand(lanes, N, generator=gen, device=cuda) > 0.2).float()
        g = torch.randn(lanes, N, generator=gen, device=cuda) * w
        h = (torch.rand(lanes, N, generator=gen, device=cuda) * 0.25 + 0.05) * w
        bounds = tr.gradient_bounds(g, h)
        lam = torch.logspace(-1, 1, lanes, device=cuda)
        every = torch.ones(lanes, F, dtype=torch.bool, device=cuda)
        for level in (0, 5, 9, 10):
            nodes = 2 << level
            parents = ints(nodes // 2, (lanes, N))
            split = split_of((lanes,), level, 4095)
            routed = routed_of(xb, parents, split)
            p_t = parents.clone()

            def fused(src, **kw):
                p_t.copy_(src)
                return tr.level_splits_lanes(xb, p_t, g, h, nodes, bounds, every, lam, 1.0,
                                             n_bins, bins_checked=True, **kw)

            got = [t.clone() for t in fused(parents, parent=split)]
            equal = torch.equal(p_t, routed) and all(
                torch.equal(a, b) for a, b in zip(got, fused(routed)))
            timings = {"copy": lambda: p_t.copy_(parents),
                       "routed": lambda: fused(parents, parent=split),
                       "alone": lambda: fused(routed)}
            if old:
                p_o = parents.clone()
                old.route(xb, p_o, split._replace(feats=split.feats.clone(),
                                                  bins=split.bins.clone()), lanes)
                equal = equal and torch.equal(p_o, routed) and all(
                    torch.equal(a, b) for a, b in zip(got, old.fused(
                        xb, routed.clone(), g, h, nodes, bounds, every, lam, n_bins)))
                f_t, b_t = split.feats.clone(), split.bins.clone()
                timings["old_route"] = lambda: (p_t.copy_(parents), old.route(
                    xb, p_t, split._replace(feats=f_t, bins=b_t), lanes))
                timings["old_alone"] = lambda: (p_t.copy_(routed), old.fused(
                    xb, p_t, g, h, nodes, bounds, every, lam, n_bins))
            key = f"fused L={lanes}, the split of level {level} -> level {level + 1}"
            sorts[key] = {"equal": equal, **turns(timings)}
            print(key, sorts[key], flush=True)
    xb1 = xb[:N_ONE].contiguous()
    g1 = torch.randn(N_ONE, generator=gen, device=cuda)
    h1 = torch.rand(N_ONE, generator=gen, device=cuda) * 0.25 + 0.05
    b1 = tr.gradient_bounds(g1, h1)
    nb1 = (xb1.amax(0) + 1).to(torch.uint8)
    for level in range(5):
        nodes = 2 << level
        parents = ints(nodes // 2, (N_ONE,))
        split = split_of((), level, 63)
        routed = routed_of(xb1, parents, split)
        p_t = parents.clone()

        def k3(src, **kw):
            p_t.copy_(src)
            return tr.level_histogram(xb1, p_t, g1, h1, nodes, b1, nb1, bins_checked=True,
                                      **kw)

        got = k3(parents, parent=split).clone()
        equal = torch.equal(p_t, routed) and torch.equal(got, k3(routed))
        timings = {"copy": lambda: p_t.copy_(parents),
                   "routed": lambda: k3(parents, parent=split), "alone": lambda: k3(routed)}
        if old:
            f_t, b_t = split.feats.clone(), split.bins.clone()
            equal = equal and torch.equal(k3(routed), old.k3(xb1, routed.clone(), g1, h1,
                                                             nodes, b1, nb1))
            timings["old_route"] = lambda: (p_t.copy_(parents), old.route(
                xb1, p_t, split._replace(feats=f_t, bins=b_t), 1))
            timings["old_alone"] = lambda: (p_t.copy_(routed), old.k3(
                xb1, p_t, g1, h1, nodes, b1, nb1))
        key = f"K3 one fit n={N_ONE}, the split of level {level} -> level {level + 1}"
        sorts[key] = {"equal": equal, **turns(timings)}
        print(key, sorts[key], flush=True)

    leaves_out = {}
    parents = ints(32, (N_ONE,))
    split = split_of((), 5, 63)
    routed = routed_of(xb1, parents, split)
    nxt1 = tr.NextTree((torch.rand(N_ONE, generator=gen, device=cuda) < 0.4).float(),
                       torch.rand(N_ONE, generator=gen, device=cuda), 0.8,
                       torch.ones(N_ONE, device=cuda), "cls")
    m1 = torch.zeros(N_ONE, device=cuda)
    timings = {"routed": lambda: tr.leaf_values(parents, g1, h1, 64, 1.0, 0.1, m1, b1, nxt1,
                                                parent=split, xb=xb1),
               "alone": lambda: tr.leaf_values(routed, g1, h1, 64, 1.0, 0.1, m1, b1, nxt1)}
    if old:
        timings["old_alone"] = lambda: old.k5(routed, g1, h1, 64, m1, b1, nxt1)
    leaves_out["K5 one fit n=7809, 64 leaves, the next tree"] = turns(timings)
    print("K5 one fit", leaves_out["K5 one fit n=7809, 64 leaves, the next tree"], flush=True)

    plan = tr.leaf_plan
    for lanes in (15, 50, 100, 250, 255):
        for leaves in (64, 1024):
            parents = ints(leaves // 2, (lanes, N))
            g = torch.randn(lanes, N, generator=gen, device=cuda)
            h = torch.rand(lanes, N, generator=gen, device=cuda) * 0.25 + 0.05
            bounds = tr.gradient_bounds(g, h)
            lam = torch.logspace(-1, 1, lanes, device=cuda)
            scale = torch.linspace(0.02, 0.3, lanes, device=cuda)
            nxt = tr.NextTree((torch.rand(N, generator=gen, device=cuda) < 0.4).float(),
                              torch.rand(lanes, N, generator=gen, device=cuda),
                              torch.linspace(0.6, 1.0, lanes, device=cuda),
                              (torch.rand(lanes, N, generator=gen, device=cuda) > 0.2).float(),
                              "cls")
            split = split_of((lanes,), leaves.bit_length() - 2, leaves - 1)
            routed = routed_of(xb, parents, split)
            start = torch.randn(lanes, N, generator=gen, device=cuda)

            def k5(shape, preds, blocks=None):
                if blocks:
                    tr.leaf_plan = lambda n_: blocks
                try:
                    return tr.leaf_values_lanes(parents, g, h, leaves, lam, scale, preds,
                                                bounds, nxt, parent=split, xb=xb, shape=shape)
                finally:
                    tr.leaf_plan = plan

            shapes = {"auto": ("auto", None), "cluster": ("cluster", None),
                      "cluster of 4": ("cluster", 4), "cluster of 2": ("cluster", 2),
                      "block": ("block", None)}
            results = []
            for shape, blocks in shapes.values():
                p = start.clone()
                results.append((p, *k5(shape, p, blocks)))
            if old:
                p = start.clone()
                results.append((p, *old.k5_lanes(routed, g, h, leaves, lam, scale, p,
                                                 bounds, nxt)))
            torch.cuda.synchronize()
            equal = all(all(torch.equal(a, b) for a, b in zip(r, results[0]))
                        for r in results)
            p_t = start.clone()
            timings = {name: (lambda s=shape, b=blocks: k5(s, p_t, b))
                       for name, (shape, blocks) in shapes.items()}
            if old:
                timings["old_cluster"] = lambda: old.k5_lanes(routed, g, h, leaves, lam,
                                                              scale, p_t, bounds, nxt)
            key = f"K5 L={lanes}, {leaves} leaves, the next tree"
            leaves_out[key] = {"equal": equal, **turns(timings),
                               "bound_ms": leaf_values_bound(N, leaves, True, lanes,
                                                             F)["bound_ms"]}
            print(key, leaves_out[key], flush=True)

    x = np.random.default_rng(0).normal(size=(N_ONE, F)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    GBDTClassifier(n_estimators=3, max_depth=6, subsample=0.8, device="cuda").fit(x, y)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        GBDTClassifier(n_estimators=30, max_depth=6, subsample=0.8, device="cuda").fit(x, y)
        torch.cuda.synchronize()
    calls = host_launch_calls(prof)
    print(f"host launch calls of a 30-tree boosted fit of depth 6: {calls}", flush=True)
    return {"sorts": sorts, "leaves": leaves_out, "boosted_fit_30_trees_launch_calls": calls}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--earlier", default=None,
                    help="an earlier csrc/forest_train.cu with the routing kernel")
    ap.add_argument("--out", default="chiprun_out/route_leaf_profile.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_route_leaf_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from bbbp_tpu_torch.timing import nvidia_smi

    result = {"card": nvidia_smi(), "torch": torch.__version__, "cuda": torch.version.cuda,
              "earlier": args.earlier, **profile(args.earlier)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(json.dumps(result, indent=1) + "\n")
    print(json.dumps({"card": result["card"], "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
