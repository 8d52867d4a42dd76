#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``bbbp_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (a failing check raises, so the script exits non-zero
before its last line):

1. environment: the card, torch and CUDA versions, TF32 off; builds both
   native libraries from the checkout's sources and prints the seconds;
2. kernel 1 (``packed_project``) against its plain version on the card;
3. kernel 2 (``dense_forest_predict``, via ``raw_predict``) against its
   plain version on the card;
4. the slice: ``screen()`` on ``cuda`` with the full-width fixture model over
   65,536 + a ragged tail of ``synthetic_smiles`` and 3 invalid SMILES; both
   kernels' launch counters must move, and the first 2,048 rows must match
   ``screen(device="cpu")``.

Then one JSON line per kernel set, the card's ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. There is no CPU fallback:
without a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import csv
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SLICE_N = 65536 + 1000            # 4 full chunks of 16,384 and a ragged tail
CHUNK = 16384
PREFIX = 2048
INVALID = ("NOT_A_SMILES((", "C1CC", "[Xx]")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def device_ms(fn, calls: int = 10, replays: int = 20) -> float:
    """Device milliseconds per call of ``fn``: ``calls`` calls captured in a
    CUDA graph and replayed, so host launch overhead is not in the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def read_csv(path: str):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if rows[0] != ["ID", "SMILES", "Prediction", "Probability"]:
        raise AssertionError(f"bad CSV header {rows[0]}")
    return rows[1:]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    from bbbp_tpu_torch import _build
    from bbbp_tpu_torch.data.zinc import synthetic_smiles
    from bbbp_tpu_torch.native.bindings import fingerprints_packed
    from bbbp_tpu_torch.ops.bitops import (pack_bits, packed_project,
                                           packed_project_reference)
    from bbbp_tpu_torch.ops.forest import (DenseTreeEnsemble,
                                           dense_predict_reference, raw_predict)
    from bbbp_tpu_torch.pipelines.screen import ScreeningModel, screen
    from bbbp_tpu_torch.testing import full_width_screening_state, near_tie_rows

    cuda = torch.device("cuda")
    card = nvidia_smi()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    t0 = time.time()
    _build.kernels_lib()
    t_kernels = time.time() - t0
    t0 = time.time()
    _build.chem_lib()
    t_chem = time.time() - t0
    print(f"[1 env] card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | allow_tf32={tf32} | build s: kernels "
          f"{t_kernels:.1f}, chem {t_chem:.1f}", flush=True)
    if tf32:
        raise AssertionError("torch.backends.cuda.matmul.allow_tf32 must be False")

    state = full_width_screening_state(0)
    model = ScreeningModel.from_state(state).to(cuda)
    rng = np.random.default_rng(0)

    # -- phase 2: kernel 1 against its plain version ----------------------
    w, c0 = model.proj_w, model.proj_c0
    k1_err = 0.0
    for n in (1, 255, 16384, 16385):
        dense = rng.random((n, 2048)) < 0.05
        dense[-1] = True                        # an all-ones row
        if n > 1:
            dense[0] = False                    # an all-zero row
        packed = torch.from_numpy(pack_bits(dense).view(np.int32)).to(cuda)
        got = packed_project(packed, w, c0)
        want = packed_project_reference(packed, w, c0)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        k1_err = max(k1_err, err)
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-4):
            raise AssertionError(f"packed_project N={n}: max |err| {err:.3g}")
    k1_ms = device_ms(lambda: packed_project(packed[:CHUNK], w, c0))
    k1_plain_ms = device_ms(lambda: packed_project_reference(packed[:CHUNK], w, c0))
    print(f"[2 packed_project] N in (1, 255, 16384, 16385), W=64, k=30: max "
          f"|err| {k1_err:.3g} (atol 1e-4, rtol 1e-5) | N=16384: kernel "
          f"{k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms", flush=True)

    # -- phase 3: kernel 2 against its plain version -----------------------
    k2_err = 0.0
    n, n_trees = 16384, 300
    for depth in (1, 6, 8):
        for n_feat in (30, 2048):
            x = torch.from_numpy(
                rng.standard_normal((n, n_feat)).astype(np.float32)).to(cuda)
            n_int = (1 << depth) - 1
            thr = rng.standard_normal((n_trees, n_int)).astype(np.float32)
            thr[rng.random(thr.shape) < 0.05] = np.inf
            ens = DenseTreeEnsemble.from_state({
                "feat": rng.integers(0, n_feat, (n_trees, n_int)), "thr": thr,
                "leaf": rng.normal(0, 0.1, (n_trees, n_int + 1)),
                "depth": depth, "base_score": 0.3, "tree_scale": 0.1}).to(cuda)
            want = dense_predict_reference(ens.feat, ens.thr, ens.leaf, x, depth,
                                           ens.base_score, ens.tree_scale)
            got = raw_predict(ens, x)
            got_p = raw_predict(ens, x, apply_sigmoid=True)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            err_p = (got_p - torch.sigmoid(want)).abs().max().item()
            k2_err = max(k2_err, err, err_p)
            if err > 2e-5 or err_p > 2e-5:
                raise AssertionError(f"dense_forest D={depth} F={n_feat}: max "
                                     f"|err| {err:.3g}, sigmoid {err_p:.3g}")
    z = packed_project(packed[:CHUNK], w, c0)
    ens = model.ensemble
    k2_ms = device_ms(lambda: raw_predict(ens, z, apply_sigmoid=True))
    k2_plain_ms = device_ms(lambda: torch.sigmoid(dense_predict_reference(
        ens.feat, ens.thr, ens.leaf, z, ens.depth, ens.base_score,
        ens.tree_scale)))
    print(f"[3 dense_forest_predict] N=16384, T=300, D in (1, 6, 8), F in "
          f"(30, 2048), +inf thresholds: max |err| {k2_err:.3g} (atol 2e-5) | "
          f"F=30, D=6: kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms",
          flush=True)

    # -- phase 4: the slice --------------------------------------------------
    smiles = synthetic_smiles(SLICE_N, seed=1)
    bad_at = (10, SLICE_N // 2, SLICE_N + 2)
    for pos, bad in zip(bad_at, INVALID):
        smiles.insert(pos, bad)
    mols = [(s, f"M{i:06d}") for i, s in enumerate(smiles)]
    with tempfile.TemporaryDirectory() as tmp:
        gpu_csv = os.path.join(tmp, "cuda.csv")
        cpu_csv = os.path.join(tmp, "cpu.csv")
        packed_project.launches.reset()
        raw_predict.launches.reset()
        stats = screen(model, iter(mols), out_csv=gpu_csv, chunk_size=CHUNK,
                       dispatch_workers=2, device="cuda")
        launches = {"packed_project": packed_project.launches.count,
                    "dense_forest_predict": raw_predict.launches.count}
        screen(model, iter(mols[:PREFIX]), out_csv=cpu_csv, chunk_size=PREFIX,
               device="cpu")
        gpu_rows, cpu_rows = read_csv(gpu_csv), read_csv(cpu_csv)
    if len(gpu_rows) != len(mols) or stats.n_molecules != len(mols):
        raise AssertionError(f"{len(gpu_rows)} rows for {len(mols)} molecules")
    invalid = [i for i, r in enumerate(gpu_rows) if r[2] == "invalid"]
    if invalid != list(bad_at) or stats.n_invalid != len(bad_at):
        raise AssertionError(f"invalid rows {invalid}, expected {list(bad_at)}")
    if [r[:2] for r in gpu_rows] != [[m[1], m[0]] for m in mols]:
        raise AssertionError("CSV rows are not in input order")
    proba = np.array([float(r[3]) for r in gpu_rows if r[2] != "invalid"])
    if not (np.isfinite(proba).all() and (proba >= 0).all() and (proba <= 1).all()):
        raise AssertionError("probabilities outside [0, 1]")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched by screen(): {launches}")
    # the prefix against the CPU run: rows may differ only where a path meets
    # a threshold within 1e-5 (the two sum z in different orders)
    prefix = [s for s, _ in mols[:PREFIX]]
    packed_np, _ = fingerprints_packed(prefix)
    z_cpu = packed_project_reference(torch.from_numpy(packed_np.view(np.int32)),
                                     model.proj_w.cpu(), model.proj_c0.cpu())
    near = near_tie_rows(state["ensemble"], z_cpu.numpy())
    mism, worst = [], 0.0
    for i, (g, c) in enumerate(zip(gpu_rows[:PREFIX], cpu_rows)):
        if g[2] == "invalid" or c[2] == "invalid":
            if g[2:] != c[2:]:
                mism.append(i)
            continue
        diff = abs(float(g[3]) - float(c[3]))
        if g[2] != c[2] or diff > 1e-4 + 1e-9:
            mism.append(i)
        else:
            worst = max(worst, diff)
    if any(not near[i] for i in mism) or near.mean() > 0.01:
        raise AssertionError(f"cuda vs cpu prefix: rows {mism} differ; near-tie "
                             f"rows {int(near.sum())}")
    print(f"[4 slice] screen(cuda) {stats.n_molecules} molecules "
          f"({stats.n_invalid} invalid), chunk {CHUNK}, 2 dispatchers: "
          f"{stats.mol_per_s:.1f} mol/s (wall {stats.wall_s:.3f} s, featurize "
          f"{stats.featurize_s:.3f} s) on {card} | launches {launches} | "
          f"first {PREFIX} vs screen(cpu): {len(mism)} rows differ, all "
          f"near ties ({int(near.sum())} near-tie rows), max |dProbability| "
          f"{worst:.3g} (limit 1e-4)", flush=True)

    kernels = [
        {"name": "packed_project", "route": "cuda",
         "source": "bbbp_tpu_torch/csrc/packed_project.cu",
         "replaces": "bbbp_tpu/ops/bitops.py:57",
         "launches": launches["packed_project"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "dense_forest_predict", "route": "cuda",
         "source": "bbbp_tpu_torch/csrc/dense_forest.cu",
         "replaces": "bbbp_tpu/ops/forest_tpu.py:85",
         "launches": launches["dense_forest_predict"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {nvidia_smi()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
