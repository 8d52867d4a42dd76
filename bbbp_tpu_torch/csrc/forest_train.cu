// forest_train.cu — the level-wise histogram split search of forest
// training, on Hopper (sm_90a). Three kernels, each behind one C entry point:
//
// K3 bbbp_forest_level_histogram — replaces the histogram of
//    bbbp_tpu/ops/forest_tpu.py::_grow_level (the scatter engine's
//    segment_sum, :204-218, and the matmul engine, :188-203, which compute
//    the same function): hist[node, f, b, {g, h}] =
//    sum over rows of [pos == node && xb[:, f] == b] * (g, h).
// K4 bbbp_forest_best_splits — replaces _chunk_gains (:125-151) and the
//    cross-chunk argmax (:220-231): per node the cumulative sums over the
//    64 bins, the XGBoost gain, the min_child and column masks, the
//    first-index argmax over f * 64 + b, and oblivious mode.
// K5 bbbp_forest_leaf_values — replaces the leaf sums of _fit_forest_device
//    (:340-348) with leaf = -G / (H + lambda) and preds += scale * leaf[pos]
//    (:348-352), the update as one fused multiply-add, which is how the
//    reference's compiled tree step rounds it.
//
// Determinism. Two fits with one seed must grow the same trees, so K3 and
// K5 give the same sums on every run: each value is quantised to a 64-bit
// integer, q = rint(v * 2^e), and integer adds are associative, so the
// order in which atomics land does not change the sum. e is chosen from
// max|v| over the rows (an exact, order-free reduction), so that
// n * max|v| * 2^e < 2^62 and no sum can overflow. The caller passes
// (max|g|, max|h|) in device memory: g and h do not change within a tree, so
// a fit takes the maxima once a tree and hands them to every K3 and K5 call. The result is the exact
// sum of the quantised values rounded once to f32: its error against the
// exact sum is at most one f32 rounding plus n * 2^-e / 2, which is below
// 2^-62 * n * max|v| * n. The plain versions sum in f32 in row order, so the
// two differ by the plain version's own rounding error. (The alternative,
// warp-owned row ranges with a lane-ordered reduction of colliding keys, needs
// per-warp partial histograms added in a fixed order; fixed point needs
// neither and keeps one shared histogram tile per block.)
//
// What bounds them here. K3 reads xb once (n * F bytes) and writes the
// histogram once (nodes * F * 512 B); at the main path's shapes (n = 7,809,
// F = 30, levels 0-5) that is well under a microsecond at 3.35 TB/s, and
// the kernel is bound by its shared-memory atomics (two 64-bit adds per row
// and feature) and by the launch chain (memset, accumulate, finish).
// K4 and K5 are small: one pass over the histogram, one over the rows.
//
// K3 design: a block owns a tile of 64 (node, feature) pairs, min(F, 32)
// features by 64 / min(F, 32) nodes (at most 64 KB of int64 (g, h) bins in
// shared memory), and a range of rows; grid = (pair tiles, row splits). A warp loads 32 rows' pos,
// keeps those whose node is in its tile (ballot), and for each such row its
// lanes take one feature each and add the row's quantised (g, h) to the
// tile. At the end the block adds its non-zero bins to a global int64
// histogram with atomics, and a finish kernel converts it to f32.
//
// K4 design: a block per node (in oblivious mode one block for the level);
// a thread per feature walks the 64 bins twice, once for the chunk totals
// and once for the gains, in the order of the plain version (sequential
// inside 16-bin chunks, chunk offsets added last, as the reference's CPU
// cumsum sums). Every operation is an explicitly rounded f32 op, so the
// kernel's gains are bit-equal to the plain version's on the same
// histogram. (gain, index) pairs meet in a block reduction that keeps the
// first index on ties; NaN counts as the largest value, as torch.argmax
// and jnp.argmax treat it.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBins = 64;
constexpr int kChunk = 16;                  // bin-sum order, see K4 design
constexpr int kTilePairs = 64;              // (node, feature) pairs a block
constexpr int kTileFeats = 32;              // one feature a lane
constexpr int kHistThreads = 256;
constexpr int kSplitThreads = 256;
constexpr int kTargetBlocks = 528;          // 4 a multiprocessor

typedef unsigned long long u64;

// ---- fixed point ------------------------------------------------------------

// 2^e with n * max * 2^e < 2^62
__device__ __forceinline__ double fixed_scale(float m, int n) {
  if (!(m > 0.f) || !isfinite(m)) return 1.0;
  // bound < 2^(ilogb(bound) + 1); bound >= 2^-149, so 2^(62 - e) is finite
  const int e = ilogb(static_cast<double>(m) * static_cast<double>(n)) + 1;
  return ldexp(1.0, 62 - e);
}

__device__ __forceinline__ long long quantise(float v, double scale) {
  return llrint(static_cast<double>(v) * scale);
}

__device__ __forceinline__ float dequantise(long long q, double scale) {
  return static_cast<float>(static_cast<double>(q) / scale);
}

int blocks_for(int n, int threads) {
  const int b = (n + threads - 1) / threads;
  return b < 1 ? 1 : (b > 1024 ? 1024 : b);
}

// ---- K3 ---------------------------------------------------------------------

__global__ void __launch_bounds__(kHistThreads)
level_hist_kernel(const uint8_t* __restrict__ xb, int n, int F,
                  const int* __restrict__ pos, const float* __restrict__ g,
                  const float* __restrict__ h, int n_nodes, int tile_nodes,
                  int tile_feats, int rows_per_split,
                  const float* __restrict__ bounds,
                  u64* __restrict__ acc) {
  extern __shared__ u64 tile[];             // [pair][bin][g, h]
  const int f_tiles = (F + tile_feats - 1) / tile_feats;
  const int node0 = (blockIdx.x / f_tiles) * tile_nodes;
  const int f0 = (blockIdx.x % f_tiles) * tile_feats;
  const int n_count = min(tile_nodes, n_nodes - node0);
  const int f_count = min(tile_feats, F - f0);
  const int entries = n_count * f_count * kBins * 2;
  for (int i = threadIdx.x; i < entries; i += blockDim.x) tile[i] = 0;
  __syncthreads();

  const double sg = fixed_scale(bounds[0], n);
  const double sh = fixed_scale(bounds[1], n);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);
  for (int base = r_begin + warp * 32; base < r_end; base += warps * 32) {
    const int r = base + lane;
    int p = -1;
    long long qg = 0, qh = 0;
    if (r < r_end) {
      p = pos[r] - node0;
      if (p >= 0 && p < n_count) {
        qg = quantise(g[r], sg);
        qh = quantise(h[r], sh);
      }
    }
    unsigned todo = __ballot_sync(0xffffffffu, (qg | qh) != 0);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int row = base + src;
      const int node = __shfl_sync(0xffffffffu, p, src);
      const long long rg = __shfl_sync(0xffffffffu, qg, src);
      const long long rh = __shfl_sync(0xffffffffu, qh, src);
      for (int f = lane; f < f_count; f += 32) {
        const int b = xb[static_cast<size_t>(row) * F + f0 + f];
        if (b >= kBins) continue;
        u64* cell = tile + (static_cast<size_t>(node * f_count + f) * kBins + b) * 2;
        atomicAdd(cell, static_cast<u64>(rg));
        atomicAdd(cell + 1, static_cast<u64>(rh));
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < entries; i += blockDim.x) {
    const u64 v = tile[i];
    if (v == 0) continue;
    const int pair = i / (kBins * 2);
    const int node = node0 + pair / f_count;
    const int f = f0 + pair % f_count;
    atomicAdd(acc + (static_cast<size_t>(node) * F + f) * (kBins * 2) +
                  i % (kBins * 2),
              v);
  }
}

__global__ void hist_finish_kernel(const long long* __restrict__ acc,
                                   size_t total, int n,
                                   const float* __restrict__ bounds,
                                   float* __restrict__ out) {
  const double sg = fixed_scale(bounds[0], n);
  const double sh = fixed_scale(bounds[1], n);
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x)
    out[i] = dequantise(acc[i], (i & 1) ? sh : sg);
}

// ---- K4 ---------------------------------------------------------------------

struct Best {
  float gain;
  int idx;
};

// a is better than b: larger, NaN above everything, the smaller index on ties
__device__ __forceinline__ bool better(float ag, int ai, float bg, int bi) {
  const bool an = isnan(ag), bn = isnan(bg);
  if (an != bn) return an;
  if (!an && ag != bg) return ag > bg;
  return ai < bi;
}

__device__ Best block_best(Best mine) {
  __shared__ float s_gain[32];
  __shared__ int s_idx[32];
  for (int o = 16; o > 0; o >>= 1) {
    const float og = __shfl_xor_sync(0xffffffffu, mine.gain, o);
    const int oi = __shfl_xor_sync(0xffffffffu, mine.idx, o);
    if (better(og, oi, mine.gain, mine.idx)) mine = {og, oi};
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_gain[warp] = mine.gain;
    s_idx[warp] = mine.idx;
  }
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    mine = lane < warps ? Best{s_gain[lane], s_idx[lane]}
                        : Best{-INFINITY, 0x7fffffff};
    for (int o = 16; o > 0; o >>= 1) {
      const float og = __shfl_xor_sync(0xffffffffu, mine.gain, o);
      const int oi = __shfl_xor_sync(0xffffffffu, mine.idx, o);
      if (better(og, oi, mine.gain, mine.idx)) mine = {og, oi};
    }
  }
  return mine;                              // valid in thread 0
}

// The chunk offsets of one feature's (g, h) cumulative sums: off[k] is the
// total of chunks 0..k-1, summed in chunk order; tg, th the feature's totals.
struct Offsets {
  float g[kBins / kChunk], h[kBins / kChunk];
  float tg, th;
};

__device__ __forceinline__ Offsets chunk_offsets(const float2* __restrict__ hf) {
  Offsets o;
  float og = 0.f, oh = 0.f;
#pragma unroll
  for (int k = 0; k < kBins / kChunk; ++k) {
    float ag = hf[k * kChunk].x, ah = hf[k * kChunk].y;
#pragma unroll
    for (int i = 1; i < kChunk; ++i) {
      ag = __fadd_rn(ag, hf[k * kChunk + i].x);
      ah = __fadd_rn(ah, hf[k * kChunk + i].y);
    }
    o.g[k] = og;
    o.h[k] = oh;
    if (k == kBins / kChunk - 1) {
      o.tg = __fadd_rn(ag, og);
      o.th = __fadd_rn(ah, oh);
    }
    og = __fadd_rn(og, ag);
    oh = __fadd_rn(oh, ah);
  }
  return o;
}

// Calls visit(b, gain, valid) for the 64 bins of one feature, in bin order.
template <typename Visit>
__device__ __forceinline__ void feature_gains(const float2* __restrict__ hf,
                                              bool col_ok, float lam,
                                              float min_child, Visit visit) {
  const Offsets o = chunk_offsets(hf);
  const float parent = __fdiv_rn(__fmul_rn(o.tg, o.tg), __fadd_rn(o.th, lam));
#pragma unroll
  for (int k = 0; k < kBins / kChunk; ++k) {
    float ag = 0.f, ah = 0.f;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const float2 v = hf[k * kChunk + i];
      ag = i ? __fadd_rn(ag, v.x) : v.x;
      ah = i ? __fadd_rn(ah, v.y) : v.y;
      const float gl = __fadd_rn(ag, o.g[k]);
      const float hl = __fadd_rn(ah, o.h[k]);
      const float gr = __fsub_rn(o.tg, gl);
      const float hr = __fsub_rn(o.th, hl);
      const float left = __fdiv_rn(__fmul_rn(gl, gl), __fadd_rn(hl, lam));
      const float right = __fdiv_rn(__fmul_rn(gr, gr), __fadd_rn(hr, lam));
      const float gain = __fsub_rn(__fadd_rn(left, right), parent);
      const bool valid = hl >= min_child && hr >= min_child && col_ok;
      visit(k * kChunk + i, gain, valid);
    }
  }
}

__device__ __forceinline__ void write_split(const Best& best, int node,
                                            int* feat, int* bin,
                                            bool* has_split) {
  const bool has = isfinite(best.gain) && best.gain > 0.f;
  feat[node] = has ? best.idx / kBins : 0;
  bin[node] = has ? best.idx % kBins : kBins - 1;
  has_split[node] = has;
}

__global__ void __launch_bounds__(kSplitThreads)
best_splits_kernel(const float2* __restrict__ hist, int F,
                   const bool* __restrict__ col_mask, float lam,
                   float min_child, int* feat, int* bin, bool* has_split) {
  const int node = blockIdx.x;
  Best mine{-INFINITY, 0x7fffffff};
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const float2* hf = hist + (static_cast<size_t>(node) * F + f) * kBins;
    feature_gains(hf, col_mask[f], lam, min_child,
                  [&](int b, float gain, bool valid) {
                    const float c = valid ? gain : -INFINITY;
                    const int idx = f * kBins + b;
                    if (better(c, idx, mine.gain, mine.idx)) mine = {c, idx};
                  });
  }
  mine = block_best(mine);
  if (threadIdx.x == 0) write_split(mine, node, feat, bin, has_split);
}

__global__ void __launch_bounds__(kSplitThreads)
best_splits_oblivious_kernel(const float2* __restrict__ hist, int n_nodes,
                             int F, const bool* __restrict__ col_mask,
                             float lam, float min_child, int* feat, int* bin,
                             bool* has_split) {
  Best mine{-INFINITY, 0x7fffffff};
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float total[kBins];
    u64 any_valid = 0;
#pragma unroll
    for (int b = 0; b < kBins; ++b) total[b] = 0.f;
    for (int node = 0; node < n_nodes; ++node) {   // node order, as the plain
      const float2* hf = hist + (static_cast<size_t>(node) * F + f) * kBins;
      feature_gains(hf, col_mask[f], lam, min_child,
                    [&](int b, float gain, bool valid) {
                      total[b] = __fadd_rn(total[b],
                                           valid && gain > 0.f ? gain : 0.f);
                      any_valid |= static_cast<u64>(valid) << b;
                    });
    }
#pragma unroll
    for (int b = 0; b < kBins; ++b) {
      const float c = (any_valid >> b) & 1 ? total[b] : -INFINITY;
      if (better(c, f * kBins + b, mine.gain, mine.idx)) mine = {c, f * kBins + b};
    }
  }
  mine = block_best(mine);
  if (threadIdx.x == 0)
    for (int node = 0; node < n_nodes; ++node)
      write_split(mine, node, feat, bin, has_split);
}

// ---- K5 ---------------------------------------------------------------------

__global__ void leaf_sums_kernel(const int* __restrict__ pos, int n,
                                 const float* __restrict__ g,
                                 const float* __restrict__ h, int n_leaves,
                                 const float* __restrict__ bounds,
                                 u64* __restrict__ acc) {
  extern __shared__ u64 sums[];             // [leaf][g, h]
  for (int i = threadIdx.x; i < 2 * n_leaves; i += blockDim.x) sums[i] = 0;
  __syncthreads();
  const double sg = fixed_scale(bounds[0], n);
  const double sh = fixed_scale(bounds[1], n);
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += gridDim.x * blockDim.x) {
    const int p = pos[r];
    if (p < 0 || p >= n_leaves) continue;
    const long long qg = quantise(g[r], sg), qh = quantise(h[r], sh);
    if (qg) atomicAdd(sums + 2 * p, static_cast<u64>(qg));
    if (qh) atomicAdd(sums + 2 * p + 1, static_cast<u64>(qh));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * n_leaves; i += blockDim.x)
    if (sums[i]) atomicAdd(acc + i, sums[i]);
}

__global__ void leaf_apply_kernel(const int* __restrict__ pos, int n,
                                  int n_leaves, float lam, float scale,
                                  const long long* __restrict__ acc,
                                  const float* __restrict__ bounds,
                                  float* __restrict__ leaf,
                                  float* __restrict__ preds) {
  extern __shared__ float s_leaf[];
  const double sg = fixed_scale(bounds[0], n);
  const double sh = fixed_scale(bounds[1], n);
  for (int i = threadIdx.x; i < n_leaves; i += blockDim.x) {
    const float gs = dequantise(acc[2 * i], sg);
    const float hs = dequantise(acc[2 * i + 1], sh);
    const float v = __fdiv_rn(-gs, __fadd_rn(hs, lam));
    s_leaf[i] = v;
    if (blockIdx.x == 0) leaf[i] = v;
  }
  __syncthreads();
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += gridDim.x * blockDim.x) {
    const int p = pos[r];
    if (p >= 0 && p < n_leaves)   // one fused multiply-add, as the reference
      preds[r] = __fmaf_rn(scale, s_leaf[p], preds[r]);
  }
}

// Raises a kernel's dynamic shared-memory limit to the most it is launched
// with, once (so that launches inside a CUDA graph capture set nothing).
cudaError_t shared_limit(const void* kernel, int* raised_to, int bytes) {
  if (bytes <= 48 * 1024 || bytes <= *raised_to) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *raised_to = bytes;
  return err;
}

int hist_smem_raised = 0;
int leaf_smem_raised = 0;

}  // namespace

extern "C" int bbbp_forest_level_histogram(const void* xb, int n, int F,
                                           const void* pos, const void* g,
                                           const void* h, int n_nodes,
                                           const void* bounds, void* acc,
                                           void* out, void* stream) {
  if (n < 0 || F <= 0 || n_nodes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = static_cast<size_t>(n_nodes) * F * kBins * 2;
  cudaError_t err = cudaMemsetAsync(acc, 0, total * sizeof(u64), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* mb = static_cast<const float*>(bounds);
  if (n > 0) {
    const float* gp = static_cast<const float*>(g);
    const float* hp = static_cast<const float*>(h);
    const int tile_feats = F < kTileFeats ? F : kTileFeats;
    const int tile_nodes = kTilePairs / tile_feats;
    const int tiles = ((n_nodes + tile_nodes - 1) / tile_nodes) *
                      ((F + tile_feats - 1) / tile_feats);
    const int max_splits = (n + 255) / 256;
    int splits = (kTargetBlocks + tiles - 1) / tiles;
    splits = splits < max_splits ? splits : max_splits;
    const int rows = ((n + splits - 1) / splits + 31) / 32 * 32;
    splits = (n + rows - 1) / rows;
    const int smem = tile_nodes * tile_feats * kBins * 2 *
                     static_cast<int>(sizeof(u64));
    err = shared_limit(reinterpret_cast<const void*>(level_hist_kernel),
                       &hist_smem_raised, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    level_hist_kernel<<<dim3(tiles, splits), kHistThreads, smem, s>>>(
        static_cast<const uint8_t*>(xb), n, F, static_cast<const int*>(pos), gp,
        hp, n_nodes, tile_nodes, tile_feats, rows, mb,
        static_cast<u64*>(acc));
  }
  const int finish_blocks =
      total >= 1024u * 256u ? 1024 : blocks_for(static_cast<int>(total), 256);
  hist_finish_kernel<<<finish_blocks, 256, 0, s>>>(
      static_cast<const long long*>(acc), total, n, mb, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bbbp_forest_best_splits(const void* hist, int n_nodes, int F,
                                       const void* col_mask, float lam,
                                       float min_child, int oblivious,
                                       void* feat, void* bin, void* has_split,
                                       void* stream) {
  if (n_nodes <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = F >= kSplitThreads ? kSplitThreads : (F + 31) / 32 * 32;
  const float2* hp = static_cast<const float2*>(hist);
  const bool* mp = static_cast<const bool*>(col_mask);
  int* fp = static_cast<int*>(feat);
  int* bp = static_cast<int*>(bin);
  bool* sp = static_cast<bool*>(has_split);
  if (oblivious)
    best_splits_oblivious_kernel<<<1, threads, 0, s>>>(hp, n_nodes, F, mp, lam,
                                                       min_child, fp, bp, sp);
  else
    best_splits_kernel<<<n_nodes, threads, 0, s>>>(hp, F, mp, lam, min_child,
                                                   fp, bp, sp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bbbp_forest_leaf_values(const void* pos, int n, const void* g,
                                       const void* h, int n_leaves, float lam,
                                       float scale, const void* bounds,
                                       void* acc, void* leaf, void* preds,
                                       void* stream) {
  if (n < 0 || n_leaves <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(acc, 0, 2 * n_leaves * sizeof(u64), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* pp = static_cast<const int*>(pos);
  const float* mb = static_cast<const float*>(bounds);
  const int blocks = blocks_for(n, 256) < 264 ? blocks_for(n, 256) : 264;
  if (n > 0) {
    const float* gp = static_cast<const float*>(g);
    const float* hp = static_cast<const float*>(h);
    const int smem = 2 * n_leaves * static_cast<int>(sizeof(u64));
    err = shared_limit(reinterpret_cast<const void*>(leaf_sums_kernel),
                       &leaf_smem_raised, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    leaf_sums_kernel<<<blocks, 256, smem, s>>>(pp, n, gp, hp, n_leaves, mb,
                                               static_cast<u64*>(acc));
  }
  leaf_apply_kernel<<<blocks, 256, n_leaves * sizeof(float), s>>>(
      pp, n, n_leaves, lam, scale, static_cast<const long long*>(acc), mb,
      static_cast<float*>(leaf), static_cast<float*>(preds));
  return static_cast<int>(cudaGetLastError());
}
