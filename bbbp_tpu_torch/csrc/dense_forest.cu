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
// What bounds it here: per row, T*D dependent steps, each two loads of the
// node (feat, thr) and one of x[feat], then one leaf load per tree. Every
// row reads the same tree arrays: T*(2^D-1)*8 + T*2^D*4 bytes (227 KB at
// T=300, D=6), which stay in L2 and L1; x is read once (F*4 bytes a row).
// The latency of the dependent chain bounds it, not HBM or arithmetic.
//
// Design: one thread per row, looping over the trees in order, so all the
// threads of a block walk the same tree at the same time and the node loads
// of a warp hit the same few cache lines. For F <= 64 the block's rows are
// staged in shared memory first (coalesced, at an odd row stride so that the
// per-row reads x[feat] do not conflict on banks); wider rows (F = 2048 is
// 8 KB a row) are read from global memory. The sum is f32 in tree order;
// the epilogue is rounded as the plain version rounds it (no fused
// multiply-add), and apply_sigmoid adds 1/(1+expf(-m)).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 128;
constexpr int kMaxSharedF = 64;

template <bool kStageRows>
__global__ void dense_forest_kernel(const float* __restrict__ x, int n, int F,
                                    const int32_t* __restrict__ feat,
                                    const float* __restrict__ thr,
                                    const float* __restrict__ leaf, int T,
                                    int depth, float base_score,
                                    float tree_scale, int apply_sigmoid,
                                    float* __restrict__ out) {
  extern __shared__ float xs[];
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int row = row0 + threadIdx.x;
  const float* xr;
  if (kStageRows) {
    const int stride = F | 1;
    const int rows = min(kRowsPerBlock, n - row0);
    const float* src = x + (size_t)row0 * F;
    for (int i = threadIdx.x; i < rows * F; i += blockDim.x) {
      xs[(i / F) * stride + i % F] = src[i];
    }
    __syncthreads();
    xr = xs + threadIdx.x * stride;
  } else {
    xr = x + (size_t)row * F;
  }
  if (row >= n) return;
  const int internal = (1 << depth) - 1;
  const int leaves = 1 << depth;
  float acc = 0.0f;
  for (int t = 0; t < T; ++t) {
    const int32_t* ft = feat + (size_t)t * internal;
    const float* tt = thr + (size_t)t * internal;
    int pos = 0;
    for (int l = 0; l < depth; ++l) {
      const int node = (1 << l) - 1 + pos;
      pos = 2 * pos + (xr[__ldg(ft + node)] > __ldg(tt + node) ? 1 : 0);
    }
    acc += __ldg(leaf + (size_t)t * leaves + pos);
  }
  float m = __fadd_rn(base_score, __fmul_rn(tree_scale, acc));
  if (apply_sigmoid) m = 1.0f / (1.0f + expf(-m));
  out[row] = m;
}

}  // namespace

// x [n, F] f32, feat [T, 2^depth - 1] int32 (each in [0, F)), thr same shape
// f32, leaf [T, 2^depth] f32 -> out [n] f32, all contiguous on the current
// device; launched on `stream`, not synchronised. depth <= 12.
extern "C" int bbbp_dense_forest_predict(const void* x, int n, int F,
                                         const void* feat, const void* thr,
                                         const void* leaf, int T, int depth,
                                         float base_score, float tree_scale,
                                         int apply_sigmoid, void* out,
                                         void* stream) {
  if (n > 0) {
    const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* xp = static_cast<const float*>(x);
    const int32_t* fp = static_cast<const int32_t*>(feat);
    const float* tp = static_cast<const float*>(thr);
    const float* lp = static_cast<const float*>(leaf);
    float* op = static_cast<float*>(out);
    if (F <= kMaxSharedF) {
      const size_t smem = (size_t)kRowsPerBlock * (F | 1) * sizeof(float);
      dense_forest_kernel<true><<<blocks, kRowsPerBlock, smem, s>>>(
          xp, n, F, fp, tp, lp, T, depth, base_score, tree_scale,
          apply_sigmoid, op);
    } else {
      dense_forest_kernel<false><<<blocks, kRowsPerBlock, 0, s>>>(
          xp, n, F, fp, tp, lp, T, depth, base_score, tree_scale,
          apply_sigmoid, op);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
