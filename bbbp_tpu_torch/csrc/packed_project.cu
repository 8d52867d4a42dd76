// packed_project.cu — the screening projection on Hopper (sm_90a).
//
// Replaces: bbbp_tpu/ops/bitops.py::_packed_project_pallas, reached through
// packed_project. It unpacks little-endian uint32 fingerprint words into
// {0,1} bits and computes z = bits · W' + c0, where W' [d, k] and c0 [k] are
// the scaler and PCA folded together (bitops.py::project_weights).
//
// What bounds it here: Morgan fingerprints are about 5% dense, so z is c0
// plus the sum of the ~100 rows of W' at the set bits. A dense product would
// spend 20 multiply-adds on zeros for each useful one. The useful work is a
// gather of W' rows: k*4 = 120 bytes per set bit, from a W' of 240 KB that
// stays in L2 and L1 after the first rows touch it. Input is 256 B and
// output 120 B per molecule, so HBM traffic is small; the latency of the
// dependent row loads is the bound.
//
// Design: one warp per molecule. Lane j owns output column j (columns past
// 32 take further passes). The warp reads the molecule's words once, one
// word per lane, coalesced. Each word is broadcast with __shfl_sync and its
// set bits are walked with __ffs, so the loop is the same for every lane (no
// divergence) and each set bit costs one coalesced 120-byte read of a W'
// row. W' is too large (240 KB) for shared memory and is not staged there.
// Everything is f32, as the JAX package's reference (_packed_project_jnp);
// only the order of the sum differs. Bits at positions >= d are ignored.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void packed_project_kernel(const uint32_t* __restrict__ packed,
                                      int n, int words,
                                      const float* __restrict__ w,
                                      const float* __restrict__ c0, int d,
                                      int k, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // row is the same for the whole warp
  const uint32_t* row_words = packed + row * words;
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int j = j0 + lane;
    const bool active = j < k;
    float acc = 0.0f;
    for (int base = 0; base < words; base += 32) {
      const int wi = base + lane;
      const uint32_t mine = wi < words ? __ldg(row_words + wi) : 0u;
      const int count = min(32, words - base);
      for (int s = 0; s < count; ++s) {
        uint32_t word = __shfl_sync(0xffffffffu, mine, s);
        const int bit0 = (base + s) * 32;
        while (word) {
          const int bit = bit0 + __ffs(word) - 1;
          word &= word - 1;
          if (bit >= d) break;  // bits ascend, so the rest are >= d too
          if (active) acc += __ldg(w + (size_t)bit * k + j);
        }
      }
    }
    if (active) out[row * k + j] = acc + __ldg(c0 + j);
  }
}

}  // namespace

// packed [n, words] uint32, w [d, k] f32, c0 [k] f32 -> out [n, k] f32, all
// contiguous on the current device; launched on `stream`, not synchronised.
extern "C" int bbbp_packed_project(const void* packed, int n, int words,
                                   const void* w, const void* c0, int d, int k,
                                   void* out, void* stream) {
  if (n > 0) {
    const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    packed_project_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(packed), n, words,
        static_cast<const float*>(w), static_cast<const float*>(c0), d, k,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
