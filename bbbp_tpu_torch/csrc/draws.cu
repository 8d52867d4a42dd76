// draws.cu — the random draws of forest training, on Hopper (sm_90a).
//
// K9 bbbp_forest_draws — replaces the per-tree draws of
//    bbbp_tpu/ops/forest_tpu.py::_fit_forest_device: the keys split per tree
//    (jax.random.split(key, n_trees), :356, then split(key, 3), :303) and the
//    draws from them, rf's Poisson(1) row weights (:305), the subsample's
//    uniforms (:317) and the columns' uniforms (:320). One launch draws one
//    stream of one tree for every lane of a fit (L = 1 for a single fit).
//
// Keyed draws. Every draw is a pure function of (seed, tree, stream,
// index): word = Threefry-2x32 with 20 rounds (the generator JAX uses,
// Salmon et al. 2011) of the key (seed >> 32, seed & 0xffffffff), as
// jax.random.PRNGKey lays a seed out, and the counter (tree * 4 + stream,
// index); the first of the two output words is the draw. So a lane draws
// what a single fit with its seed draws, whatever the lanes and their order,
// and the plain version (forest_draws_reference, torch int64 ops masked to
// 32 bits) gives the same bits on the CPU.
//   - a uniform in [0, 1) is (word >> 8) * 2^-24, exact in f32;
//   - a Poisson(1) count is the number of thresholds T_k = floor(CDF(k) *
//     2^32) that the word reaches (the inverse CDF of word / 2^32), with the
//     thresholds computed once on the host in float64 and passed by value.
//
// The tree index is read from device memory (tree[0] + tree_offset), so
// that a CUDA graph of one tree, replayed, draws each tree's numbers as the
// graph advances the index.
//
// What bounds it. Each draw writes 4 bytes and costs one Threefry block:
// 20 rounds of an add, a rotate and a xor, and 6 key injections, ~70
// integer operations. At a fit's sizes (n ~ 8k rows, 30-458 columns, up to
// 255 lanes) it is a few microseconds of launch latency; making it fast is
// left for later.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStreams = 4;           // counter words a tree: subsample, columns, Poisson
constexpr int kMaxThresholds = 24;    // Poisson(1) thresholds below 2^32 (13 of them)
constexpr int kDrawThreads = 256;
constexpr int kMaxDrawBlocks = 1024;  // blocks along a lane's draws

struct Thresholds {
  unsigned t[kMaxThresholds];
  int count;                          // 0: uniforms
};

__device__ __forceinline__ unsigned rotl(unsigned x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, as jax._src.prng.threefry_2x32 computes it; the
// first output word.
__device__ __forceinline__ unsigned threefry2x32(unsigned k0, unsigned k1, unsigned x0,
                                                 unsigned x1) {
  const unsigned k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const unsigned ks[3] = {k0, k1, k2};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int group = 0; group < 5; ++group) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rot[group & 1][r]);
      x1 ^= x0;
    }
    x0 += ks[(group + 1) % 3];
    x1 += ks[(group + 2) % 3] + static_cast<unsigned>(group + 1);
  }
  return x0;
}

// out[lane, i] for i < size, every lane in blockIdx.y.
__global__ void __launch_bounds__(kDrawThreads)
    draws_kernel(const long long* __restrict__ seeds, const long long* __restrict__ tree,
                 int tree_offset, int stream, int size, Thresholds table,
                 float* __restrict__ out) {
  const int lane = blockIdx.y;
  const unsigned long long seed = static_cast<unsigned long long>(seeds[lane]);
  const unsigned k0 = static_cast<unsigned>(seed >> 32);
  const unsigned k1 = static_cast<unsigned>(seed);
  const unsigned x0 =
      static_cast<unsigned>((tree[0] + tree_offset) * kStreams + stream);
  float* row = out + static_cast<size_t>(lane) * size;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < size;
       i += gridDim.x * blockDim.x) {
    const unsigned word = threefry2x32(k0, k1, x0, static_cast<unsigned>(i));
    float v;
    if (table.count) {
      int count = 0;
      for (int k = 0; k < table.count; ++k) count += word >= table.t[k];
      v = static_cast<float>(count);
    } else {
      v = static_cast<float>(word >> 8) * 0x1p-24f;
    }
    row[i] = v;
  }
}

}  // namespace

// K9. seeds int64 [lanes] and tree int64 [1] in device memory; stream in
// [0, 4); thresholds (host memory, n_thresholds of them, increasing) for
// Poisson counts, or null for uniforms; out f32 [lanes, size].
extern "C" int bbbp_forest_draws(const void* seeds, int lanes, const void* tree,
                                 int tree_offset, int stream, int size,
                                 const unsigned* thresholds, int n_thresholds, void* out,
                                 void* stream_ptr) {
  if (lanes < 0 || lanes > 65535 || size < 0 || stream < 0 || stream >= kStreams ||
      n_thresholds < 0 || n_thresholds > kMaxThresholds ||
      (n_thresholds > 0 && thresholds == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0 || size == 0) return static_cast<int>(cudaSuccess);
  Thresholds table = {};
  table.count = n_thresholds;
  for (int k = 0; k < n_thresholds; ++k) table.t[k] = thresholds[k];
  int blocks = (size + kDrawThreads - 1) / kDrawThreads;
  if (blocks > kMaxDrawBlocks) blocks = kMaxDrawBlocks;
  draws_kernel<<<dim3(blocks, lanes), kDrawThreads, 0,
                 static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const long long*>(seeds), static_cast<const long long*>(tree),
      tree_offset, stream, size, table, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
