// dense_forest.cu — forest inference over the implicit full-binary layout,
// on Hopper (sm_90a).
//
// Replaces: bbbp_tpu/ops/forest_tpu.py::DenseTreeEnsemble.raw_predict, the
// XLA code _dense_predict_route (the TPU's gather-free form, which exists
// only because gathers are slow on the TPU) and its gather form
// _dense_predict. Level l of tree t holds its internal nodes at flat
// [2^l - 1, 2^(l+1) - 1); a row goes right iff x[feat] > thr, in exact f32,
// so thr = +inf always goes left. The margin is
// base_score + tree_scale * sum_t leaf[t, pos].
//
// Tree records (built once by ops/forest.py::pack_tree_records): tree t is
// R = round_up(3 * 2^D, 4) 32-bit words; internal node i is the 8-byte pair
// (thr bits, feat) at words 2i, 2i + 1, one pair slot is padding, and leaf p
// is word 2 * 2^D + p. A record is a multiple of 16 bytes.
//
// What bounds it here: the bound by bytes is tiny (x once, the trees once:
// 2.3 MB at N=16,384, F=30, T=300, D=6, 0.67 µs at 3.35 TB/s). The work is
// N*T*D dependent steps, each a load of the node, then a load of x[feat]
// that needs it, then a compare: 29.5 M steps, 59 M shared-memory loads. On
// an H100 the kernel is bound by those loads and the instructions around
// them, not by memory traffic.
//
// Design:
// - A block takes 128 rows and 8 tree groups (1,024 threads). Thread (g, r)
//   walks row r through the trees g, g + 8, g + 16, ... of every tile: at
//   N=16,384 there are 128 blocks of 32 warps, one per SM. The 32 lanes of
//   a warp are 32 rows on the same tree.
// - The trees stream through shared memory in tiles of 24 KB (32 trees at
//   D=6; a depth-12 tree, 48 KB, is a tile alone), copied with cp.async
//   into two buffers: the next tile arrives while the current one is
//   walked. 128 rows a block keep the tiles' L2 traffic at 30 MB a chunk.
// - A level is one 8-byte shared load of (thr, feat) and one 4-byte load of
//   x[feat], both from 32-bit shared byte addresses, so a step is about
//   seven instructions. Each thread walks 4 trees at once, interleaved level
//   by level, so four independent load chains are in flight.
// - For F <= 64 the block's rows are staged in shared memory transposed,
//   xs[f * 128 + r]: lane r of a warp reads bank r whatever feature each
//   lane asks for, so the x reads never conflict. Wider rows (F = 2048 is
//   8 KB a row) are read from global memory.
// - Per-row partial sums (one per tree group) meet in shared memory and
//   tree group 0 adds them in group order, so the result is the same from
//   run to run. The sum order differs from the plain version's (and from
//   the earlier one-thread-per-row form of this kernel, which summed in
//   tree order); the margins agree within 2e-5. The epilogue is rounded as
//   the plain version rounds it (no fused multiply-add), and apply_sigmoid
//   adds 1/(1+expf(-m)).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;                 // rows per block
constexpr int kGroups = 8;                 // tree groups per block
constexpr int kThreads = kRows * kGroups;  // 1024
constexpr int kInterleave = 4;             // trees a thread walks at once
constexpr int kMaxSharedF = 64;
constexpr int kTileBytes = 24576;          // per buffer, unless one tree is more

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// loads from 32-bit shared-memory byte addresses
__device__ __forceinline__ uint2 lds_u2(unsigned addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float lds_f(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

template <bool kStageRows>
__global__ void __launch_bounds__(kThreads, 1)
    dense_forest_kernel(const float* __restrict__ x, int n, int F,
                        const uint32_t* __restrict__ trees, int T, int depth,
                        int rec_words, int tile_trees, float base_score,
                        float tree_scale, int apply_sigmoid,
                        float* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int tile_words = tile_trees * rec_words;
  float* partial = reinterpret_cast<float*>(smem + 2 * tile_words);
  float* xs = partial + kThreads;

  const int tid = threadIdx.x;
  const int r = tid % kRows;
  const int g = tid / kRows;
  const int row0 = blockIdx.x * kRows;
  const float* xg = x + (size_t)min(row0 + r, n - 1) * F;
  if (kStageRows) {
    const int rows = min(kRows, n - row0);
    const float* src = x + (size_t)row0 * F;
    for (int i = tid; i < kRows * F; i += kThreads) {
      const int rr = i / F;
      xs[(i - rr * F) * kRows + rr] = rr < rows ? src[i] : 0.0f;
    }
  }
  // byte addresses: x of this row is at x_row + 4 * kRows * feat
  const unsigned x_row =
      static_cast<unsigned>(__cvta_generic_to_shared(xs)) + 4 * r;

  const int ntiles = (T + tile_trees - 1) / tile_trees;
  auto load_tile = [&](int i) {
    const int t0 = i * tile_trees;
    const int chunks = min(tile_trees, T - t0) * rec_words / 4;
    const uint32_t* src = trees + (size_t)t0 * rec_words;
    uint32_t* dst = smem + (i & 1) * tile_words;
    for (int c = tid; c < chunks; c += kThreads) {
      cp_async16(dst + 4 * c, src + 4 * c);
    }
    cp_async_commit();
  };

  float acc = 0.0f;
  if (ntiles > 0) load_tile(0);
  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      load_tile(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* tile = smem + (i & 1) * tile_words;
    const unsigned tile_addr =
        static_cast<unsigned>(__cvta_generic_to_shared(tile));
    const int nt = min(tile_trees, T - i * tile_trees);
    for (int j0 = g; j0 < nt; j0 += kGroups * kInterleave) {
      // rec: byte address of a tree's record; node: byte offset of the
      // current node in it (8 * flat index)
      unsigned rec[kInterleave], node[kInterleave];
#pragma unroll
      for (int u = 0; u < kInterleave; ++u) {
        rec[u] = tile_addr + 4 * min(j0 + u * kGroups, nt - 1) * rec_words;
        node[u] = 0;
      }
      for (int l = 0; l < depth; ++l) {
#pragma unroll
        for (int u = 0; u < kInterleave; ++u) {
          const uint2 tf = lds_u2(rec[u] + node[u]);  // (thr bits, feat)
          const float xv = kStageRows ? lds_f(x_row + 4 * kRows * tf.y)
                                      : __ldg(xg + tf.y);
          node[u] = 2 * node[u] + (xv > __uint_as_float(tf.x) ? 16u : 8u);
        }
      }
      // leaf p = flat - (2^D - 1) is word 2 * 2^D + p = 2^D + 1 + flat
#pragma unroll
      for (int u = 0; u < kInterleave; ++u) {
        if (j0 + u * kGroups < nt) {
          acc += lds_f(rec[u] + 4 * ((1 << depth) + 1) + node[u] / 2);
        }
      }
    }
    __syncthreads();  // the buffer is refilled at the next iteration
  }

  partial[g * kRows + r] = acc;
  __syncthreads();
  if (g == 0 && row0 + r < n) {
    float sum = partial[r];
    for (int q = 1; q < kGroups; ++q) sum += partial[q * kRows + r];
    float m = __fadd_rn(base_score, __fmul_rn(tree_scale, sum));
    if (apply_sigmoid) m = 1.0f / (1.0f + expf(-m));
    out[row0 + r] = m;
  }
}

template <bool kStageRows>
cudaError_t launch(const float* x, int n, int F, const uint32_t* trees, int T,
                   int depth, float base_score, float tree_scale,
                   int apply_sigmoid, float* out, cudaStream_t s) {
  const int rec_words = ((3 << depth) + 3) / 4 * 4;
  const int rec_bytes = rec_words * 4;
  const int tile_trees = max(1, min(max(T, 1), kTileBytes / rec_bytes));
  const size_t smem = (size_t)2 * tile_trees * rec_bytes +
                      kThreads * sizeof(float) +
                      (kStageRows ? (size_t)kRows * F * sizeof(float) : 0);
  auto kernel = dense_forest_kernel<kStageRows>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kRows - 1) / kRows;
  kernel<<<blocks, kThreads, smem, s>>>(x, n, F, trees, T, depth, rec_words,
                                        tile_trees, base_score, tree_scale,
                                        apply_sigmoid, out);
  return cudaGetLastError();
}

}  // namespace

// x [n, F] f32, trees [T, R] int32 records (layout above; every feat in
// [0, F)) -> out [n] f32, all contiguous on the current device; launched on
// `stream`, not synchronised. depth <= 12.
extern "C" int bbbp_dense_forest_predict(const void* x, int n, int F,
                                         const void* trees, int T, int depth,
                                         float base_score, float tree_scale,
                                         int apply_sigmoid, void* out,
                                         void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (depth < 0 || depth > 12) return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  const uint32_t* tp = static_cast<const uint32_t*>(trees);
  float* op = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      F <= kMaxSharedF
          ? launch<true>(xp, n, F, tp, T, depth, base_score, tree_scale,
                         apply_sigmoid, op, s)
          : launch<false>(xp, n, F, tp, T, depth, base_score, tree_scale,
                          apply_sigmoid, op, s);
  return static_cast<int>(err);
}
