#!/usr/bin/env python3
"""Phase clocks of the trainer's leaf kernel (K5, ``forest_leaf_values``)
on one CUDA card.

    python3 torch_leaf_profile.py [--out FILE]

Builds ``bbbp_tpu_torch/csrc/forest_train.cu`` with ``BBBP_LEAF_CLOCKS`` defined
(into ``bbbp_tpu_torch/_build/``), so that thread 0 of every block of K5's
cluster reads ``clock64()`` at the end of each of the kernel's steps, and
runs it at the trainer's 7,809 rows (64, 256 and 1,024 leaves, with and
without the next tree's gradients, 8 blocks) and at 65,536 rows (16
blocks). Prints, for each case, the device ms of a call (CUDA-graph timing,
the stamps included), the cycles of each phase in block 0 and the largest
over the blocks, and the device ms of an empty launch of a cluster of the
same shape. Writes the same JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

# the steps LEAF_CLOCK(1..10) of leaf_values_kernel end, in order
PHASES = ("start: loads issued, table zeroed, scales",
          "own rows into the block's table", "cluster barrier",
          "tables copied into the stage", "block barrier", "leaf values",
          "second cluster barrier and the owners' values (many leaves)",
          "arrive, block barrier", "update, next gradients, bounds",
          "wait to exit")
CASES = ((7809, 64, False, 8), (7809, 64, True, 8), (7809, 256, True, 8),
         (7809, 1024, False, 8), (7809, 1024, True, 8), (65536, 64, True, 16))

# forest_train.cu with its clocks, and two C entry points more: leaf_clocks
# (copies the stamps out) and empty_cluster
WRAPPER = r'''#define BBBP_LEAF_CLOCKS
#include "{source}"
extern "C" int leaf_clocks(void* host) {{
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_leaf_clock,
                                               sizeof(g_leaf_clock)));
}}
__global__ void empty_kernel(int* p) {{ if (p != nullptr) p[threadIdx.x] = 0; }}
extern "C" int empty_cluster(int cluster, int threads, void* stream) {{
  cudaLaunchConfig_t cfg = {{}};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cluster > 8)
    cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, empty_kernel, (int*)nullptr));
}}
'''


def build():
    from bbbp_tpu_torch import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(_build.BUILD_DIR, "leaf_profile.cu")
    so = os.path.join(_build.BUILD_DIR, "leaf_profile.so")
    with open(cu, "w") as f:
        f.write(WRAPPER.format(source=os.path.abspath(
            os.path.join(_build.CSRC_DIR, "forest_train.cu"))))
    subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS + [cu, "-o", so], check=True)
    lib = ctypes.CDLL(so)
    lib.bbbp_forest_leaf_values.restype = ctypes.c_int
    lib.bbbp_forest_leaf_values.argtypes = \
        _build.kernels_lib().bbbp_forest_leaf_values.argtypes
    lib.leaf_clocks.restype = ctypes.c_int
    lib.leaf_clocks.argtypes = [ctypes.c_void_p]
    lib.empty_cluster.restype = ctypes.c_int
    lib.empty_cluster.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def profile():
    import torch

    from bbbp_tpu_torch.ops import forest_train as tr
    from bbbp_tpu_torch.timing import device_ms

    lib = build()
    cuda = torch.device("cuda")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    results = []
    for n, n_leaves, with_next, cluster in CASES:
        g = torch.randn(n, device=cuda, generator=gen)
        h = torch.rand(n, device=cuda, generator=gen)
        pos = torch.randint(0, n_leaves, (n,), dtype=torch.int32, device=cuda,
                            generator=gen)
        y = (torch.rand(n, device=cuda, generator=gen) < 0.4).float()
        u = torch.rand(n, device=cuda, generator=gen)
        w = torch.ones(n, device=cuda)
        preds = torch.zeros(n, device=cuda)
        bounds = tr.gradient_bounds(g, h)
        leaf = torch.empty(n_leaves, device=cuda)
        outs = [torch.empty(n, device=cuda), torch.empty(n, device=cuda),
                torch.empty(2, device=cuda)]
        nxt = ((y.data_ptr(), u.data_ptr(), w.data_ptr(), 0.8, 1) if with_next
               else (None, None, None, 1.0, 0))

        def call():
            rc = lib.bbbp_forest_leaf_values(
                pos.data_ptr(), n, g.data_ptr(), h.data_ptr(), n_leaves, 1.0, 0.1,
                bounds.data_ptr(), leaf.data_ptr(), preds.data_ptr(), *nxt,
                *((t.data_ptr() for t in outs) if with_next else (None, None, None)),
                cluster, None, 0, *tr.NO_PARENT, stream())
            if rc:
                raise RuntimeError(f"forest_leaf_values: cudaError {rc}")

        ms = device_ms(call)
        call()
        torch.cuda.synchronize()
        clocks = (ctypes.c_longlong * 256)()
        lib.leaf_clocks(clocks)
        phases = []
        for k, name in enumerate(PHASES, start=1):
            spans = [clocks[b * 16 + k] - clocks[b * 16 + k - 1] for b in range(cluster)]
            phases.append({"phase": name, "block0": spans[0], "max": max(spans)})
        results.append({
            "n": n, "leaves": n_leaves, "next_tree": with_next, "blocks": cluster,
            "ms": ms, "empty_cluster_ms": device_ms(
                lambda: lib.empty_cluster(cluster, tr.LEAF_THREADS, stream())),
            "cycles_block0": sum(p["block0"] for p in phases), "phases": phases})
        print(f"n={n} leaves={n_leaves} next={with_next} blocks={cluster}: "
              f"{ms:.5f} ms a call, an empty cluster launch "
              f"{results[-1]['empty_cluster_ms']:.5f} ms; cycles block 0 / "
              f"largest: " + "; ".join(f"{p['phase']} {p['block0']} / {p['max']}"
                                       for p in phases), flush=True)
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/leaf_profile.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_leaf_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from bbbp_tpu_torch.timing import nvidia_smi

    result = {"card": nvidia_smi(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "cases": profile()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(json.dumps(result, indent=1) + "\n")
    print(json.dumps({"card": result["card"], "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
