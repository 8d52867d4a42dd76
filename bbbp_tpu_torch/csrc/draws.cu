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
// 20 rounds of an add, a rotate and a xor, and 5 key injections, ~70
// integer operations, so at a lane group's sizes (L = 255 lanes of 8,162
// rows) the integer rate bounds it (timing.forest_draws_bound: the adds on
// the ALU or the FMA pipe, the rotates and xors on the ALU pipe only, at
// the rates torch_rate_profile.py measured), a few microseconds; one fit's
// draw (L = 1) is a launch.
//
// Design. One wave of blocks (the card's SMs times the blocks an SM holds,
// asked once a device), a grid row a lane, blocks along a row only as many
// as the wave leaves to each lane. A thread makes 4 consecutive draws of its
// lane at a time, their four Threefry chains independent (instruction-level
// parallelism), and writes them with one 16-byte store: a row's draws from
// its first 16-byte boundary on; the at most 3 + 3 draws before it and
// after the last whole 4 are single stores. What is fixed for a lane and a
// tree (the key schedule, the counter's first word with its key added) is
// taken once a thread. Uniforms and Poisson counts are two instantiations;
// a count compares the word with the thresholds, padded to 16 with
// 0xffffffff, in an unrolled loop over kernel parameters (no table in
// local memory), and is clipped to the real count (a word of 0xffffffff
// reaches every threshold).
// Timed by torch_draws_profile.py on an H100 80GB HBM3 at 700 W against the
// form before it (a thread a draw, 256-thread blocks up to 1,024 along a
// row, the Poisson count a runtime loop over a by-value table) in one call:
// L = 255 x 8,162 rows 0.0092 ms for uniforms and 0.0127 ms for Poisson
// counts, against 0.0565 and 0.0575; L = 15 0.0020-0.0021 / 0.0023
// against 0.0048-0.0049 / 0.0052; one fit's draw (L = 1, 7,809 rows)
// 0.0017-0.0018 against 0.0019-0.0020, a launch. The bound at L = 255 is
// 0.0055 / 0.0061 ms (LOP3 alone 61.8 a clock an SM, LOP3 beside IMAD
// 103.0), so 60% / 49% of it. cuobjdump -sass: 32 registers, no local
// memory, the rounds IADD3, IMAD (its adds), SHF and LOP3: 261 / 342
// instructions of the ALU pipe beside 94 / 173 of the FMA pipe.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kStreams = 4;           // counter words a tree: subsample, columns, Poisson
constexpr int kMaxThresholds = 16;    // Poisson(1) thresholds below 2^32 (13 of them)
constexpr int kDrawThreads = 256;
constexpr int kDrawsAThread = 4;      // consecutive draws of one lane, one 16-byte store

struct Thresholds {
  unsigned t[kMaxThresholds];         // increasing, padded with 0xffffffff
  int count;                          // the real ones
};

// What a lane's draws of one tree and stream share: the key schedule (k0,
// k1, k0 ^ k1 ^ 0x1BD11BDA) and the counter's first word plus k0.
struct Key {
  unsigned ks[3];
  unsigned x0;
};

__device__ __forceinline__ Key lane_key(unsigned long long seed, unsigned counter0) {
  Key key;
  key.ks[0] = static_cast<unsigned>(seed >> 32);
  key.ks[1] = static_cast<unsigned>(seed);
  key.ks[2] = key.ks[0] ^ key.ks[1] ^ 0x1BD11BDAu;
  key.x0 = counter0 + key.ks[0];
  return key;
}

__device__ __forceinline__ unsigned rotl(unsigned x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, as jax._src.prng.threefry_2x32 computes it, at
// the counter (key's first word, x1); the first output word.
__device__ __forceinline__ unsigned threefry2x32(const Key& key, unsigned x1) {
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  unsigned x0 = key.x0;
  x1 += key.ks[1];
#pragma unroll
  for (int group = 0; group < 5; ++group) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rot[group & 1][r]);
      x1 ^= x0;
    }
    x0 += key.ks[(group + 1) % 3];
    x1 += key.ks[(group + 2) % 3] + static_cast<unsigned>(group + 1);
  }
  return x0;
}

template <bool kPoisson>
__device__ __forceinline__ float draw_value(unsigned word, const Thresholds& table) {
  if (!kPoisson) return static_cast<float>(word >> 8) * 0x1p-24f;
  int count = 0;
#pragma unroll
  for (int k = 0; k < kMaxThresholds; ++k) count += word >= table.t[k];
  return static_cast<float>(min(count, table.count));
}

// out[lane, i] for i < size, lane blockIdx.y; blocks along the row stride
// over its 4-draw groups.
template <bool kPoisson>
__global__ void __launch_bounds__(kDrawThreads)
    draws_kernel(const long long* __restrict__ seeds, const long long* __restrict__ tree,
                 int tree_offset, int stream, int size, Thresholds table,
                 float* __restrict__ out) {
  const int lane = blockIdx.y;
  const Key key = lane_key(static_cast<unsigned long long>(seeds[lane]),
                           static_cast<unsigned>((tree[0] + tree_offset) * kStreams + stream));
  float* row = out + static_cast<size_t>(lane) * size;
  // draws [head, body) in groups of 4 at 16-byte boundaries (row is 4-byte aligned)
  const int head = min(size, static_cast<int>((0u - (reinterpret_cast<uintptr_t>(row) >> 2)) & 3));
  const int groups = (size - head) / kDrawsAThread;
  const int body = head + groups * kDrawsAThread;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  for (int q = first; q < groups; q += gridDim.x * blockDim.x) {
    const unsigned i = static_cast<unsigned>(head + q * kDrawsAThread);
    const unsigned w0 = threefry2x32(key, i), w1 = threefry2x32(key, i + 1);
    const unsigned w2 = threefry2x32(key, i + 2), w3 = threefry2x32(key, i + 3);
    *reinterpret_cast<float4*>(row + i) =
        make_float4(draw_value<kPoisson>(w0, table), draw_value<kPoisson>(w1, table),
                    draw_value<kPoisson>(w2, table), draw_value<kPoisson>(w3, table));
  }
  if (first < head + size - body) {          // the ends, single stores
    const int i = first < head ? first : body + first - head;
    row[i] = draw_value<kPoisson>(threefry2x32(key, static_cast<unsigned>(i)), table);
  }
}

constexpr int kMaxDevices = 64;

// [device][kPoisson]: blocks one wave of the card holds, 0 until asked
std::atomic<int> wave_blocks[kMaxDevices][2] = {};

// Blocks one wave of the current device holds of a draws kernel, asked once
// a device (a device past kMaxDevices is asked at every launch).
cudaError_t wave_of(const void* kernel, bool poisson, int* blocks) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::atomic<int>* known = device < kMaxDevices ? &wave_blocks[device][poisson] : nullptr;
  *blocks = known ? known->load(std::memory_order_relaxed) : 0;
  if (*blocks > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kDrawThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  if (known) known->store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace

// K9. seeds int64 [lanes] and tree int64 [1] in device memory; stream in
// [0, 4); thresholds (host memory, n_thresholds of them, increasing, at
// most 16) for Poisson counts, or null for uniforms; out f32 [lanes, size],
// 4-byte aligned.
extern "C" int bbbp_forest_draws(const void* seeds, int lanes, const void* tree,
                                 int tree_offset, int stream, int size,
                                 const unsigned* thresholds, int n_thresholds, void* out,
                                 void* stream_ptr) {
  if (lanes < 0 || lanes > 65535 || size < 0 || stream < 0 || stream >= kStreams ||
      n_thresholds < 0 || n_thresholds > kMaxThresholds ||
      (n_thresholds > 0 && thresholds == nullptr) ||
      reinterpret_cast<uintptr_t>(out) % sizeof(float))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0 || size == 0) return static_cast<int>(cudaSuccess);
  Thresholds table;
  table.count = n_thresholds;
  for (int k = 0; k < kMaxThresholds; ++k)
    table.t[k] = k < n_thresholds ? thresholds[k] : 0xffffffffu;
  const bool poisson = n_thresholds > 0;
  const void* kernels[2] = {reinterpret_cast<const void*>(draws_kernel<false>),
                            reinterpret_cast<const void*>(draws_kernel<true>)};
  int wave = 0;
  const cudaError_t err = wave_of(kernels[poisson], poisson, &wave);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a lane's share of the wave, no more blocks than its groups of 4 need
  const int per_lane = (wave + lanes - 1) / lanes;
  const int needed = (size / kDrawsAThread + kDrawThreads - 1) / kDrawThreads;
  const int blocks = per_lane < needed ? per_lane : (needed > 0 ? needed : 1);
  const dim3 grid(blocks, lanes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  const long long* sp = static_cast<const long long*>(seeds);
  const long long* tp = static_cast<const long long*>(tree);
  float* op = static_cast<float*>(out);
  if (poisson)
    draws_kernel<true><<<grid, kDrawThreads, 0, s>>>(sp, tp, tree_offset, stream, size, table,
                                                     op);
  else
    draws_kernel<false><<<grid, kDrawThreads, 0, s>>>(sp, tp, tree_offset, stream, size,
                                                      table, op);
  return static_cast<int>(cudaGetLastError());
}
