#!/usr/bin/env python3
"""Issue rates of the two units that can take a Tanimoto intersection on one
CUDA card: the 32-bit population count (POPC) and the binary tensor-core
product ``mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc``; and
of shared-memory atomic adds, which bound the forest kernels' histograms.

    python3 torch_rate_profile.py [--out FILE]

Builds a small probe library with ``nvcc`` for ``sm_90a`` (the source is in
this file) and runs, with one block of 1,024 threads on each SM (the dynamic
shared memory admits no second one):

- ``popc``: eight independent chains a thread of ``x = popc(x ^ s) + x``;
- ``lop3``: eight independent chains of a three-input logic operation;
- ``imad``: eight independent chains of a 32-bit integer multiply-add;
  ``lop3_imad``: four chains of each, interleaved (whether the ALU pipe's
  LOP3 and the FMA pipe's IMAD issue together: K9's bound);
- ``mma_b1`` / ``mma_s8``: four independent accumulators a warp of
  ``m16n8k256`` b1 AND-POPC / ``m16n8k32`` s8 products;
- ``mma_b1_chain``: one warp, one accumulator, each product waiting on the
  last (latency);
- ``atoms``, ``atoms_random``, ``atoms_pair``: eight 32-bit shared-memory
  atomic adds a thread an iteration, to conflict-free banks, to random
  words of 64 KB, and as four low-word adds whose old values carry into
  four high-word adds (the forest kernels' 64-bit add); ``atoms_64``: four
  64-bit shared atomic adds a thread an iteration, at random words.

Each block counts its own ``clock64`` cycles, so a rate a clock and an SM
does not depend on the clock the card runs at; the rate a second comes from
CUDA events. One b1 product is checked against POPC on random words. The
SASS of the probes (``cuobjdump -sass``) shows which instruction each
compiled to. Prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

PROBE_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ void mma_b1(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ void stamp(long long t0, long long* cycles) {
  __syncthreads();
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
}

__global__ void popc_probe(int iters, uint32_t s, long long* cycles, uint32_t* sink) {
  uint32_t x[8];
  for (int u = 0; u < 8; ++u) x[u] = threadIdx.x * 2654435761u + u * 40503u;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = __popc(x[u] ^ s) + x[u];
  }
  stamp(t0, cycles);
  uint32_t acc = 0;
  for (int u = 0; u < 8; ++u) acc ^= x[u];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm volatile("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__global__ void lop3_probe(int iters, uint32_t s, long long* cycles, uint32_t* sink) {
  uint32_t x[8];
  for (int u = 0; u < 8; ++u) x[u] = threadIdx.x * 2654435761u + u * 40503u;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = lop3(x[u], x[(u + 1) & 7], s);
  }
  stamp(t0, cycles);
  uint32_t acc = 0;
  for (int u = 0; u < 8; ++u) acc ^= x[u];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

// 32-bit integer multiply-adds (IMAD, the FMA pipe), eight independent
// chains a thread; kMixed: four chains of them beside four of LOP3 (the
// ALU pipe), so that the rate shows whether the two pipes issue together.
template <bool kMixed>
__global__ void imad_probe(int iters, uint32_t s, long long* cycles, uint32_t* sink) {
  uint32_t x[8];
  for (int u = 0; u < 8; ++u) x[u] = threadIdx.x * 2654435761u + u * 40503u;
  const uint32_t m = s | 1u;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (kMixed && (u & 1)) {
        x[u] = lop3(x[u], x[u ^ 1], s);
      } else {
        asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(x[u]) : "r"(m), "r"(x[(u + 2) & 7]));
      }
    }
  }
  stamp(t0, cycles);
  uint32_t acc = 0;
  for (int u = 0; u < 8; ++u) acc ^= x[u];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

template <bool kBinary, int kAcc>
__global__ void mma_probe(int iters, uint32_t s, long long* cycles, uint32_t* sink) {
  uint32_t a[4], b[2];
  for (int u = 0; u < 4; ++u) a[u] = (threadIdx.x + u) * 2654435761u ^ s;
  for (int u = 0; u < 2; ++u) b[u] = (threadIdx.x * 3 + u) * 40503u ^ s;
  int d[kAcc][4] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < kAcc; ++u) {
      if (kBinary) mma_b1(d[u], a, b); else mma_s8(d[u], a, b);
    }
  }
  stamp(t0, cycles);
  int acc = 0;
  for (int u = 0; u < kAcc; ++u) acc ^= d[u][0] ^ d[u][1] ^ d[u][2] ^ d[u][3];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = static_cast<uint32_t>(acc);
}

// Shared-memory 32-bit atomic adds, eight a thread an iteration, no result
// waited for: kForm 0 to addresses whose banks are the lanes' (conflict
// free), 1 to pseudo-random words of 64 KB (the banks a histogram meets), 2
// as pairs of a low word whose old value carries into a high word (the
// two-word 64-bit add of the forest kernels), at random words; 3 one 64-bit
// atomic add a pair instead, at random words.
template <int kForm>
__global__ void atoms_probe(int iters, uint32_t s, long long* cycles, uint32_t* sink) {
  extern __shared__ uint32_t words[];
  for (int i = threadIdx.x; i < 32768; i += blockDim.x) words[i] = 0;
  uint32_t x = threadIdx.x * 2654435761u ^ s;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    if (kForm == 3) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        x = x * 1664525u + 1013904223u;
        atomicAdd(reinterpret_cast<unsigned long long*>(words) + (x >> 19),
                  static_cast<unsigned long long>(x) << 20);
      }
    } else if (kForm == 2) {
      uint32_t at[4], lo[4], old[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        x = x * 1664525u + 1013904223u;
        at[u] = x >> 18;
        lo[u] = x;
        old[u] = atomicAdd(&words[at[u]], lo[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        atomicAdd(&words[16384 + at[u]], (x >> 24) + ((old[u] + lo[u]) < lo[u]));
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (kForm == 0) {
          atomicAdd(&words[(threadIdx.x + u * 1024) & 16383], x);
        } else {
          x = x * 1664525u + 1013904223u;
          atomicAdd(&words[x >> 18], 1u);
        }
      }
    }
  }
  stamp(t0, cycles);
  sink[blockIdx.x * blockDim.x + threadIdx.x] = x ^ words[threadIdx.x];
}

// One m16n8k256 b1 product of A [16, 8 words] and B [8, 8 words] (a
// reference row a column) against popc(a & b) summed over the words.
__global__ void mma_check(const uint32_t* A, const uint32_t* B, int* bad) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const uint32_t a[4] = {A[g * 8 + t], A[(g + 8) * 8 + t], A[g * 8 + t + 4],
                         A[(g + 8) * 8 + t + 4]};
  const uint32_t b[2] = {B[g * 8 + t], B[g * 8 + t + 4]};
  int d[4] = {0, 0, 0, 0};
  mma_b1(d, a, b);
  for (int e = 0; e < 4; ++e) {
    const int row = g + (e >> 1) * 8, col = 2 * t + (e & 1);
    int want = 0;
    for (int w = 0; w < 8; ++w) want += __popc(A[row * 8 + w] & B[col * 8 + w]);
    if (want != d[e]) atomicAdd(bad, 1);
  }
}

// kind: 0 popc, 1 lop3, 2 mma_b1, 3 mma_s8, 4 mma_b1_chain, 5 check, 6-9 the
// shared atomics (atoms_probe<kind - 6>), 10 imad, 11 lop3 beside imad.
extern "C" int probe(int kind, int iters, long long* cycles_out, float* ms_out,
                     int* blocks_out) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = kind == 4 ? 1 : sms, threads = kind == 4 ? 32 : 1024;
  const int smem = 150 * 1024;         // one block an SM
  long long* cycles = nullptr;
  uint32_t* sink = nullptr;
  cudaMalloc(&cycles, sizeof(long long) * blocks);
  cudaMalloc(&sink, sizeof(uint32_t) * blocks * threads);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  auto run = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kernel<<<blocks, threads, smem>>>(iters / 10, 0x9e3779b9u, cycles, sink);
    cudaEventRecord(e0);
    kernel<<<blocks, threads, smem>>>(iters, 0x9e3779b9u, cycles, sink);
    cudaEventRecord(e1);
  };
  if (kind == 5) {
    uint32_t hA[128], hB[64];
    uint32_t x = 12345u;
    for (auto& v : hA) v = (x = x * 1664525u + 1013904223u);
    for (auto& v : hB) v = (x = x * 1664525u + 1013904223u);
    uint32_t *A, *B;
    int* bad;
    cudaMalloc(&A, sizeof hA);
    cudaMalloc(&B, sizeof hB);
    cudaMalloc(&bad, sizeof(int));
    cudaMemcpy(A, hA, sizeof hA, cudaMemcpyHostToDevice);
    cudaMemcpy(B, hB, sizeof hB, cudaMemcpyHostToDevice);
    cudaMemset(bad, 0, sizeof(int));
    mma_check<<<1, 32>>>(A, B, bad);
    cudaMemcpy(blocks_out, bad, sizeof(int), cudaMemcpyDeviceToHost);
    cudaFree(A); cudaFree(B); cudaFree(bad);
    return static_cast<int>(cudaDeviceSynchronize());
  }
  if (kind == 0) run(popc_probe);
  if (kind == 1) run(lop3_probe);
  if (kind == 2) run(mma_probe<true, 4>);
  if (kind == 3) run(mma_probe<false, 4>);
  if (kind == 4) run(mma_probe<true, 1>);
  if (kind == 6) run(atoms_probe<0>);
  if (kind == 7) run(atoms_probe<1>);
  if (kind == 8) run(atoms_probe<2>);
  if (kind == 9) run(atoms_probe<3>);
  if (kind == 10) run(imad_probe<false>);
  if (kind == 11) run(imad_probe<true>);
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaGetLastError();
  cudaEventElapsedTime(ms_out, e0, e1);
  cudaMemcpy(cycles_out, cycles, sizeof(long long) * blocks, cudaMemcpyDeviceToHost);
  *blocks_out = blocks;
  cudaFree(cycles);
  cudaFree(sink);
  return static_cast<int>(err);
}
"""

# operations a thread (popc, lop3) or a warp (mma) per iteration, and what
# one such operation is worth in bit-level AND + popcount work
PROBES = {"popc": (0, 8, 1), "lop3": (1, 8, 1),
          "mma_b1": (2, 4, 16 * 8 * 256), "mma_s8": (3, 4, 16 * 8 * 32),
          "mma_b1_chain": (4, 1, 16 * 8 * 256),
          "atoms": (6, 8, 1), "atoms_random": (7, 8, 1), "atoms_pair": (8, 8, 1),
          "atoms_64": (9, 4, 1), "imad": (10, 8, 1), "lop3_imad": (11, 8, 1)}


def build(workdir: str) -> tuple:
    from bbbp_tpu_torch._build import COMPILE_FLAGS, _nvcc

    src = os.path.join(workdir, "rate_probe.cu")
    with open(src, "w") as f:
        f.write(PROBE_SRC)
    obj, lib = src[:-3] + ".o", src[:-3] + ".so"
    nvcc = _nvcc()
    for cmd in ([nvcc] + COMPILE_FLAGS + ["-c", src, "-o", obj],
                [nvcc] + COMPILE_FLAGS + ["-shared", obj, "-o", lib]):
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", obj], capture_output=True,
                          text=True).stdout
    return lib, sass


def sass_of(sass: str, kernel: str) -> dict:
    """Counts of the opcodes in the loop of one probe's SASS."""
    blocks = re.split(r"\n\s*Function : ", sass)
    body = next((b for b in blocks if kernel in b.split("\n", 1)[0]), "")
    ops: dict = {}
    for m in re.finditer(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body):
        ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return ops


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/rate_profile.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_rate_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from bbbp_tpu_torch.timing import nvidia_smi

    torch.zeros(1, device="cuda")
    result = {"card": nvidia_smi(), "torch": torch.__version__,
              "cuda": torch.version.cuda}
    with tempfile.TemporaryDirectory() as work:
        path, sass = build(work)
        lib = ctypes.CDLL(path)
        lib.probe.restype = ctypes.c_int
        lib.probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_void_p]
        bad = ctypes.c_int(-1)
        rc = lib.probe(5, 0, None, None, ctypes.byref(bad))
        result["mma_b1_check"] = {"rc": rc, "wrong_outputs_of_128": bad.value}
        for name, (kind, per_iter, bit_ops) in PROBES.items():
            iters = (200000 if name.startswith("mma") else
                     20000 if name.startswith("atoms") else 400000)
            cycles = (ctypes.c_longlong * 256)()
            ms = ctypes.c_float(0.0)
            blocks = ctypes.c_int(0)
            rc = lib.probe(kind, iters, cycles, ctypes.byref(ms), ctypes.byref(blocks))
            if rc != 0:
                result[name] = {"rc": rc}
                continue
            n_blocks = blocks.value
            threads = 32 if name == "mma_b1_chain" else 1024
            units = threads // 32 if name.startswith("mma") else threads
            ops_block = units * per_iter * iters
            cyc = sorted(cycles[i] for i in range(n_blocks))
            entry = {"blocks": n_blocks, "ms": ms.value,
                     "cycles_median": cyc[len(cyc) // 2],
                     "per_clock_per_sm": ops_block / cyc[len(cyc) // 2],
                     "per_s": ops_block * n_blocks / (ms.value / 1e3)}
            if bit_ops > 1:
                entry["bit_and_popc_per_s"] = entry["per_s"] * bit_ops
            if name == "mma_b1_chain":
                entry["cycles_per_dependent_mma"] = cyc[0] / iters
            result[name] = entry
        result["sass_opcodes"] = {k: sass_of(sass, k) for k in (
            "popc_probe", "lop3_probe", "mma_probeILb1ELi4E", "mma_probeILb0ELi4E",
            "atoms_probeILi0E", "atoms_probeILi1E", "atoms_probeILi2E",
            "atoms_probeILi3E", "imad_probeILb0E", "imad_probeILb1E")}
        full_sass = sass
    result["card_after"] = nvidia_smi()
    text = json.dumps(result, indent=1)
    print(text)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    with open(os.path.splitext(args.out)[0] + "_sass.txt", "w") as f:
        f.write(full_sass)
    return 0


if __name__ == "__main__":
    sys.exit(main())
