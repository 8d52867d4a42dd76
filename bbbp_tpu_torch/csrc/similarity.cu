// similarity.cu — chemistry similarity kernels on Hopper (sm_90a): Tanimoto
// top-k search (K6), the full Tanimoto gram (K7) and the min-max gram of
// count fingerprints (K8).
//
// Replaces: bbbp_tpu/ops/similarity.py::tanimoto_topk, tanimoto_matrix,
// tanimoto_matrix_w, minmax_matrix and minmax_matrix_w. There the TPU takes
// every intersection as a float matmul of 0/1 matrices (and the min of two
// counts as `levels` such matmuls), because the matrix unit is the one fast
// thing it has. That form is not carried over. Here the fingerprints come in
// packed, 32 bits a word, and an intersection is AND + popcount; counts come
// in clipped to one byte each, four a word, and Σ min(a, b) comes from the
// byte-wise Σ|a - b| and the row sums. No [Nq, Nr] intermediate leaves the
// chip but the result itself, and the top-k search writes only k columns.
//
// What bounds them here: at the shapes of the transfer path (1,058 queries
// against 7,809 rows of 6 words) and of the regression legs (about 1,000 x
// 1,000 pairs of 64 words or 2,048 counts) the inputs are a few hundred KB to
// 2 MB and stay in L2; the work is Nq·Nr·W word operations, so all three are
// bound by integer instructions, and K6 besides by its selection. For K8 the
// instruction that counts is the byte-wise minimum, and on sm_90a
// `__vminu4` is no single instruction: `cuobjdump -sass` shows about six
// (LOP3, SHF, PRMT, IMAD.IADD) before the IDP.4A, while `__vsadu4`,
// Σ|a - b| over four bytes, is one, VABSDIFF4.U8.ACC, and accumulates as
// well.
//
// Design:
// - Row sums (popcounts, count sums, or their weighted forms) are taken once
//   a call by row_sums_kernel, one warp a row: lane l adds the words l,
//   l + 32, ... in ascending order and the 32 partial sums meet in a fixed
//   shuffle tree, so a sum is the same from run to run.
// - K7 is gram_kernel: a block of 256 threads computes a 32 x 32 tile of
//   the result; the tile's query and reference rows pass through shared
//   memory 64 words at a time, padded to 65 so that the 32 lanes of a warp
//   (32 reference rows, the same word) hit 32 banks. Unweighted sums are
//   integers and exact; weighted sums add w in ascending index order in
//   f32, so a result is the same from run to run.
// - K8 is minmax_gram_kernel, tiled in registers: a block of 128 threads
//   computes a 64 x 64 tile and a thread 8 x 4 of it, so that 12 LDS.128
//   (four words of 12 rows) feed 128 word pairs. The slabs of 16 words of
//   the tile's 128 rows are staged with cp.async (16 bytes a copy where rows
//   are 16-byte aligned, else 4) in two buffers, the next slab's copy in
//   flight during this one's work, one barrier a slab. Unweighted,
//   Σ min(a, b) = (Σa + Σb - Σ|a - b|) / 2 with the row sums: integers,
//   exact, VABSDIFF4 one instruction a word pair. Weighted, the counts are
//   staged as f32 and Σ w·min(a, b) is one fminf and one fused multiply-add
//   a count in ascending count order (the byte-wise minimum and a bytes-to-
//   float conversion cost more on this card). A result tile's words are
//   shared by a cluster of up to 8 blocks (8 at the legs' 2,048 counts), so
//   that a 106 x 952 fold still fills the card: the blocks leave their sums
//   in shared memory, and after a cluster barrier block z adds them up in
//   block order for its share of the tile's rows.
// - The epilogue is rounded as the reference rounds it: (sq + sr) − inter,
//   max(·, 1e-9), and a round-to-nearest division. The file is compiled
//   without --use_fast_math.
// - K6: one block a query. Each thread scores the reference rows tid,
//   tid + 256, ... and turns (similarity, index) into one 64-bit key, the
//   similarity's f32 bits above the complemented index, so that a larger key
//   is a larger similarity or, among equal similarities, a lower index: the
//   order of the reference's top_k. Keys above the current threshold are
//   appended to a 2,048-entry buffer in shared memory; when the buffer may
//   overflow, a bitonic sort keeps the k largest and raises the threshold to
//   the k-th. Nr is not bounded by shared memory, and since keys are unique
//   the result does not depend on the order of the appends.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;            // result tile edge
constexpr int kGramThreads = 256;    // 32 x 8: four result rows a thread
constexpr int kChunk = 64;           // words staged a step
constexpr int kPad = kChunk + 1;
constexpr int kRowSumThreads = 256;  // eight rows a block
constexpr int kMmTile = 64;          // K8: result tile edge
constexpr int kMmTq = 8;             // q rows of a thread's sub-tile
constexpr int kMmTr = 4;             // r rows of a thread's sub-tile
constexpr int kMmTx = kMmTile / kMmTr;       // threads along r
constexpr int kMmTy = kMmTile / kMmTq;       // threads along q
constexpr int kMmThreads = kMmTx * kMmTy;
constexpr int kMmSlab = 16;          // 32-bit elements of a row a stage
constexpr int kMmStride = kMmSlab + 4;  // padded row: 80 bytes
constexpr int kMmMaxSplit = 8;       // blocks of a cluster along the words

constexpr int kTopkThreads = 256;
constexpr int kTopkCap = 2048;       // candidate buffer, a power of two
constexpr int kTopkMaxK = 1024;
static_assert(kTopkMaxK + kTopkThreads <= kTopkCap, "buffer too small");

// A word of 32 fingerprint bits.
struct BitOp {
  static constexpr int kPerWord = 32;
  __device__ static int count(uint32_t a) { return __popc(a); }
  __device__ static float weigh(uint32_t a, const float* w) {
    float s = 0.0f;
    while (a) {
      s = __fadd_rn(s, w[__ffs(a) - 1]);
      a &= a - 1;
    }
    return s;
  }
  __device__ static uint32_t meet(uint32_t a, uint32_t b) { return a & b; }
};

// A word of four counts, one byte each.
struct CountOp {
  static constexpr int kPerWord = 4;
  __device__ static int count(uint32_t a) {
    return static_cast<int>(__dp4a(a, 0x01010101u, 0u));
  }
  __device__ static float weigh(uint32_t a, const float* w) {
    float s = __fmul_rn(w[0], static_cast<float>(a & 0xffu));
    s = __fadd_rn(s, __fmul_rn(w[1], static_cast<float>((a >> 8) & 0xffu)));
    s = __fadd_rn(s, __fmul_rn(w[2], static_cast<float>((a >> 16) & 0xffu)));
    s = __fadd_rn(s, __fmul_rn(w[3], static_cast<float>(a >> 24)));
    return s;
  }
};

// out[i] = Σ count(x[i, :]) or Σ w·x[i, :], one warp a row.
template <typename Op, bool kWeighted>
__global__ void __launch_bounds__(kRowSumThreads)
    row_sums_kernel(const uint32_t* __restrict__ x, int n, int words,
                    const float* __restrict__ w, float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * (kRowSumThreads / 32) + threadIdx.x / 32;
  if (i >= n) return;                  // a whole warp leaves together
  const uint32_t* row = x + (size_t)i * words;
  if (kWeighted) {
    float s = 0.0f;
    for (int c = lane; c < words; c += 32) {
      s = __fadd_rn(s, Op::weigh(__ldg(row + c), w + c * Op::kPerWord));
    }
    for (int step = 16; step > 0; step >>= 1) {
      s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, step));
    }
    if (lane == 0) out[i] = s;
  } else {
    int s = 0;
    for (int c = lane; c < words; c += 32) s += Op::count(__ldg(row + c));
    for (int step = 16; step > 0; step >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, step);
    }
    if (lane == 0) out[i] = static_cast<float>(s);
  }
}

template <typename Op, bool kWeighted>
__global__ void __launch_bounds__(kGramThreads)
    gram_kernel(const uint32_t* __restrict__ q, int nq,
                const uint32_t* __restrict__ r, int nr, int words,
                const float* __restrict__ w, const float* __restrict__ sq,
                const float* __restrict__ sr, float* __restrict__ out) {
  __shared__ uint32_t qs[kTile * kPad];
  __shared__ uint32_t rs[kTile * kPad];
  __shared__ float ws[kWeighted ? kChunk * Op::kPerWord : 1];

  const int tid = threadIdx.x;
  const int tx = tid % kTile;          // reference row of the tile
  const int ty = tid / kTile;          // query rows ty, ty + 8, ty + 16, ty + 24
  const int q0 = blockIdx.y * kTile;
  const int r0 = blockIdx.x * kTile;

  int acc_i[4] = {0, 0, 0, 0};
  float acc_f[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int c0 = 0; c0 < words; c0 += kChunk) {
    const int len = min(kChunk, words - c0);
    for (int i = tid; i < kTile * len; i += kGramThreads) {
      const int row = i / len;
      const int c = i - row * len;
      qs[row * kPad + c] =
          q0 + row < nq ? __ldg(q + (size_t)(q0 + row) * words + c0 + c) : 0u;
      rs[row * kPad + c] =
          r0 + row < nr ? __ldg(r + (size_t)(r0 + row) * words + c0 + c) : 0u;
    }
    if (kWeighted) {
      for (int i = tid; i < len * Op::kPerWord; i += kGramThreads) {
        ws[i] = __ldg(w + (size_t)c0 * Op::kPerWord + i);
      }
    }
    __syncthreads();
    for (int c = 0; c < len; ++c) {
      const uint32_t rv = rs[tx * kPad + c];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t m = Op::meet(qs[(ty + 8 * u) * kPad + c], rv);
        if (kWeighted) {
          acc_f[u] = __fadd_rn(acc_f[u], Op::weigh(m, ws + c * Op::kPerWord));
        } else {
          acc_i[u] += Op::count(m);
        }
      }
    }
    __syncthreads();
  }

  const int j = r0 + tx;
  if (j >= nr) return;
  const float srj = sr[j];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = q0 + ty + 8 * u;
    if (i >= nq) continue;
    const float inter = kWeighted ? acc_f[u] : static_cast<float>(acc_i[u]);
    const float uni = __fsub_rn(__fadd_rn(sq[i], srj), inter);
    out[(size_t)i * nr + j] = __fdiv_rn(inter, fmaxf(uni, 1e-9f));
  }
}

// ---- K8 ---------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The block's q and r rows, elements [e0, e0 + kMmSlab) of each, into one
// stage: words with cp.async (16 bytes a copy where rows are 16-byte
// aligned, else 4), zeros past the matrix.
template <bool kVec>
__device__ __forceinline__ void stage_words(uint32_t* qs, uint32_t* rs,
                                            const uint32_t* q, int nq,
                                            const uint32_t* r, int nr, int words,
                                            int q0, int r0, int e0) {
  constexpr int kPer = kVec ? 4 : 1;        // words a copy
  constexpr int kCopies = 2 * kMmTile * kMmSlab / kPer;
  for (int c = threadIdx.x; c < kCopies; c += kMmThreads) {
    const bool is_q = c < kCopies / 2;
    const int local = is_q ? c : c - kCopies / 2;
    const int row = local / (kMmSlab / kPer);
    const int e = (local % (kMmSlab / kPer)) * kPer;
    const int base = is_q ? q0 : r0;
    const int limit = is_q ? nq : nr;
    const bool live = base + row < limit && e0 + e < words;
    const uint32_t* src = is_q ? q : r;
    if (live) src += static_cast<size_t>(base + row) * words + e0 + e;
    uint32_t* dst = (is_q ? qs : rs) + row * kMmStride + e;
    if (kVec)
      cp_async16(dst, src, live);
    else
      cp_async4(dst, src, live);
  }
  cp_async_commit();
}

// The same for the weighted form: the counts as f32, four a word, staged
// through registers (issued before the previous slab's compute, stored
// after it); count index e0 + e of a row is byte e & 3 of word (e0 + e) / 4.
struct CountRegs {
  uint32_t v[2 * kMmTile * (kMmSlab / 4) / kMmThreads];
};

__device__ __forceinline__ void load_counts(CountRegs& regs, const uint32_t* q,
                                            int nq, const uint32_t* r, int nr,
                                            int words, int q0, int r0, int e0) {
  constexpr int kWords = kMmSlab / 4;       // words of a row a slab
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(regs.v) / 4); ++k) {
    const int c = threadIdx.x + k * kMmThreads;
    const bool is_q = c < kMmTile * kWords;
    const int local = is_q ? c : c - kMmTile * kWords;
    const int row = local / kWords;
    const int word = e0 / 4 + local % kWords;
    const int base = is_q ? q0 : r0;
    const bool live = base + row < (is_q ? nq : nr) && word < words;
    regs.v[k] = live ? __ldg((is_q ? q : r) + static_cast<size_t>(base + row) * words + word)
                     : 0u;
  }
}

__device__ __forceinline__ void store_counts(const CountRegs& regs, float* qs,
                                             float* rs) {
  constexpr int kWords = kMmSlab / 4;
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(regs.v) / 4); ++k) {
    const int c = threadIdx.x + k * kMmThreads;
    const bool is_q = c < kMmTile * kWords;
    const int local = is_q ? c : c - kMmTile * kWords;
    const uint32_t v = regs.v[k];
    *reinterpret_cast<float4*>((is_q ? qs : rs) + (local / kWords) * kMmStride +
                               (local % kWords) * 4) =
        make_float4(static_cast<float>(v & 0xffu), static_cast<float>((v >> 8) & 0xffu),
                    static_cast<float>((v >> 16) & 0xffu), static_cast<float>(v >> 24));
  }
}

// The reference's epilogue, and Σ min(a, b) of a pair from Σ|a - b| and the
// row sums, which are integers below 2^24 (exact as f32 and as int).
__device__ __forceinline__ float minmax_ratio(float inter, float sqi, float srj) {
  const float uni = __fsub_rn(__fadd_rn(sqi, srj), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-9f));
}

__device__ __forceinline__ float inter_from_sad(unsigned sad, float sqi, float srj) {
  return static_cast<float>(
      (static_cast<int>(sqi) + static_cast<int>(srj) - static_cast<int>(sad)) >> 1);
}

// K8 (see Design above): q rows ty + 8i, r rows tx + 16j of the tile, so
// that the 8 lanes of a shared-memory phase read 8 rows 80 bytes apart, in
// 8 distinct 16-byte bank groups, and the lanes of one ty the same q words;
// the 32 accumulators of a thread are independent, and consecutive
// instructions go to different ones.
template <bool kWeighted>
__global__ void __launch_bounds__(kMmThreads)
    minmax_gram_kernel(const uint32_t* __restrict__ q, int nq,
                       const uint32_t* __restrict__ r, int nr, int words,
                       bool vec, const float* __restrict__ w,
                       const float* __restrict__ sq, const float* __restrict__ sr,
                       float* __restrict__ out) {
  __shared__ __align__(16) uint32_t stages[2][2][kMmTile * kMmStride];  // [stage][q, r]
  __shared__ __align__(16) float ws[2][kWeighted ? kMmSlab : 4];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tx = threadIdx.x % kMmTx, ty = threadIdx.x / kMmTx;
  const int q0 = blockIdx.y * kMmTile, r0 = blockIdx.x * kMmTile;
  const int elements = kWeighted ? 4 * words : words;
  const int slabs = (elements + kMmSlab - 1) / kMmSlab;
  const int per_block = (slabs + split - 1) / split;
  const int s_begin = min(slabs, rank * per_block);
  const int s_end = min(slabs, s_begin + per_block);

  unsigned sad[kMmTq][kMmTr];
  float acc[kMmTq][kMmTr];
#pragma unroll
  for (int i = 0; i < kMmTq; ++i)
#pragma unroll
    for (int j = 0; j < kMmTr; ++j) {
      sad[i][j] = 0u;
      acc[i][j] = 0.f;
    }

  CountRegs regs;
  auto stage = [&](int s) {                 // slab s into stage (s - s_begin) & 1
    const int e0 = s * kMmSlab;
    const int b = (s - s_begin) & 1;
    if (kWeighted) {
      store_counts(regs, reinterpret_cast<float*>(stages[b][0]),
                   reinterpret_cast<float*>(stages[b][1]));
      if (threadIdx.x < kMmSlab)
        ws[b][threadIdx.x] = e0 + threadIdx.x < elements ? w[e0 + threadIdx.x] : 0.f;
    } else if (vec) {
      stage_words<true>(stages[b][0], stages[b][1], q, nq, r, nr, words, q0, r0, e0);
    } else {
      stage_words<false>(stages[b][0], stages[b][1], q, nq, r, nr, words, q0, r0, e0);
    }
  };
  if (s_begin < s_end) {
    if (kWeighted) load_counts(regs, q, nq, r, nr, words, q0, r0, s_begin * kMmSlab);
    stage(s_begin);
  }
  for (int s = s_begin; s < s_end; ++s) {
    const int b = (s - s_begin) & 1;
    if (kWeighted) {
      __syncthreads();                      // stage s stored; stage s + 1 free
      if (s + 1 < s_end) load_counts(regs, q, nq, r, nr, words, q0, r0, (s + 1) * kMmSlab);
    } else {
      cp_async_wait_all();
      __syncthreads();                      // stage s landed; stage s + 1 free
      if (s + 1 < s_end) stage(s + 1);      // in flight during this slab
    }
    const uint32_t* qb = stages[b][0];
    const uint32_t* rb = stages[b][1];
#pragma unroll
    for (int e = 0; e < kMmSlab; e += 4) {
      uint4 qv[kMmTq], rv[kMmTr];
#pragma unroll
      for (int i = 0; i < kMmTq; ++i)
        qv[i] = *reinterpret_cast<const uint4*>(qb + (ty + kMmTy * i) * kMmStride + e);
#pragma unroll
      for (int j = 0; j < kMmTr; ++j)
        rv[j] = *reinterpret_cast<const uint4*>(rb + (tx + kMmTx * j) * kMmStride + e);
      const float4 wv = kWeighted ? *reinterpret_cast<const float4*>(&ws[b][e])
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < 4; ++c) {         // element e + c of every pair
        const auto part = [c](const uint4& v) {
          return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
        };
        const float wc = c == 0 ? wv.x : c == 1 ? wv.y : c == 2 ? wv.z : wv.w;
#pragma unroll
        for (int i = 0; i < kMmTq; ++i)
#pragma unroll
          for (int j = 0; j < kMmTr; ++j) {
            if (kWeighted)
              acc[i][j] = fmaf(wc, fminf(__uint_as_float(part(qv[i])),
                                         __uint_as_float(part(rv[j]))),
                               acc[i][j]);
            else
              sad[i][j] += __vsadu4(part(qv[i]), part(rv[j]));
          }
      }
    }
    if (kWeighted && s + 1 < s_end) stage(s + 1);
  }

  auto write = [&](int i, int j, unsigned sad_sum, float acc_sum) {
    const int qi = q0 + ty + kMmTy * i, rj = r0 + tx + kMmTx * j;
    if (qi >= nq || rj >= nr) return;
    const float sqi = sq[qi], srj = sr[rj];
    const float inter = kWeighted ? acc_sum : inter_from_sad(sad_sum, sqi, srj);
    out[static_cast<size_t>(qi) * nr + rj] = minmax_ratio(inter, sqi, srj);
  };
  if (split == 1) {
#pragma unroll
    for (int i = 0; i < kMmTq; ++i)
#pragma unroll
      for (int j = 0; j < kMmTr; ++j) write(i, j, sad[i][j], acc[i][j]);
    return;
  }
  // the cluster's sums meet: [k = i * kMmTr + j][thread] in each block
  __syncthreads();                          // the last stage is read
  uint32_t* sums = &stages[0][0][0];
#pragma unroll
  for (int i = 0; i < kMmTq; ++i)
#pragma unroll
    for (int j = 0; j < kMmTr; ++j)
      sums[(i * kMmTr + j) * kMmThreads + threadIdx.x] =
          kWeighted ? __float_as_uint(acc[i][j]) : sad[i][j];
  cluster.sync();
  const int rows = kMmTq / split;
  for (int i = rank * rows; i < (rank + 1) * rows; ++i) {
#pragma unroll
    for (int j = 0; j < kMmTr; ++j) {
      const int k = (i * kMmTr + j) * kMmThreads + threadIdx.x;
      uint32_t v[kMmMaxSplit];
#pragma unroll
      for (int z = 0; z < kMmMaxSplit; ++z)
        if (z < split) v[z] = *cluster.map_shared_rank(sums + k, z);
      unsigned total = v[0];
      float total_f = __uint_as_float(v[0]);
#pragma unroll
      for (int z = 1; z < kMmMaxSplit; ++z)
        if (z < split) {
          total += v[z];
          total_f = __fadd_rn(total_f, __uint_as_float(v[z]));
        }
      write(i, j, total, total_f);
    }
  }
  cluster.sync();                           // the others read this block's sums
}

// Sorts a[0, n) in descending order; n is a power of two, every thread of
// the block calls it.
__device__ void bitonic_sort_desc(unsigned long long* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const unsigned long long x = a[lo], y = a[hi];
        if ((x < y) == desc) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kTopkThreads)
    tanimoto_topk_kernel(const uint32_t* __restrict__ q,
                         const uint32_t* __restrict__ r, int nr, int words,
                         const float* __restrict__ sq,
                         const float* __restrict__ sr, int k,
                         float* __restrict__ out_sim,
                         long long* __restrict__ out_idx) {
  extern __shared__ uint32_t qs[];                 // the query's words
  __shared__ unsigned long long cand[kTopkCap];
  __shared__ int count;
  __shared__ unsigned long long thresh;

  const int tid = threadIdx.x;
  const int qi = blockIdx.x;
  for (int c = tid; c < words; c += kTopkThreads) {
    qs[c] = __ldg(q + (size_t)qi * words + c);
  }
  if (tid == 0) {
    count = 0;
    thresh = 0ull;      // below every key: a key's low half is never zero
  }
  __syncthreads();
  const float pq = sq[qi];

  // keeps the k largest of cand[0, have) at the front, in order
  auto compact = [&](int have) {
    int n = 2;
    while (n < have) n <<= 1;
    for (int i = have + tid; i < n; i += kTopkThreads) cand[i] = 0ull;
    __syncthreads();
    bitonic_sort_desc(cand, n);
    if (tid == 0 && have >= k) {
      count = k;
      thresh = cand[k - 1];
    }
    __syncthreads();
  };

  for (int base = 0; base < nr; base += kTopkThreads) {
    int have = count;            // the same for every thread: nobody appends
    __syncthreads();             // between the barrier above and this one
    if (have + kTopkThreads > kTopkCap) {
      compact(have);
      have = count;
      __syncthreads();
    }
    const unsigned long long floor_key = thresh;
    const int j = base + tid;
    if (j < nr) {
      const uint32_t* row = r + (size_t)j * words;
      int inter = 0;
      if ((words & 3) == 0) {
        const uint4* row4 = reinterpret_cast<const uint4*>(row);
        for (int c = 0; c < words / 4; ++c) {
          const uint4 v = __ldg(row4 + c);
          inter += __popc(qs[4 * c] & v.x) + __popc(qs[4 * c + 1] & v.y) +
                   __popc(qs[4 * c + 2] & v.z) + __popc(qs[4 * c + 3] & v.w);
        }
      } else {
        for (int c = 0; c < words; ++c) inter += __popc(qs[c] & __ldg(row + c));
      }
      const float fi = static_cast<float>(inter);
      const float uni = __fsub_rn(__fadd_rn(pq, sr[j]), fi);
      const float sim = __fdiv_rn(fi, fmaxf(uni, 1e-9f));
      const unsigned long long key =
          (static_cast<unsigned long long>(__float_as_uint(sim)) << 32) |
          (0xffffffffu - static_cast<uint32_t>(j));
      if (key > floor_key) cand[atomicAdd(&count, 1)] = key;
    }
    __syncthreads();
  }
  compact(count);
  for (int t = tid; t < k; t += kTopkThreads) {
    const unsigned long long key = cand[t];
    out_sim[(size_t)qi * k + t] = __uint_as_float(static_cast<uint32_t>(key >> 32));
    out_idx[(size_t)qi * k + t] =
        static_cast<long long>(0xffffffffu - static_cast<uint32_t>(key));
  }
}

template <typename Op>
cudaError_t row_sums(const uint32_t* x, int n, int words, const float* w,
                     float* out, cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  const int rows = kRowSumThreads / 32;
  const int blocks = (n + rows - 1) / rows;
  if (w != nullptr) {
    row_sums_kernel<Op, true><<<blocks, kRowSumThreads, 0, s>>>(x, n, words, w,
                                                                out);
  } else {
    row_sums_kernel<Op, false><<<blocks, kRowSumThreads, 0, s>>>(x, n, words, w,
                                                                 out);
  }
  return cudaGetLastError();
}

template <typename Op>
cudaError_t gram(const void* q, int nq, const void* r, int nr, int words,
                 const void* w, void* sq, void* sr, void* out, void* stream) {
  if (nq <= 0 || nr <= 0) return cudaGetLastError();
  const uint32_t* qp = static_cast<const uint32_t*>(q);
  const uint32_t* rp = static_cast<const uint32_t*>(r);
  const float* wp = static_cast<const float*>(w);
  float* sqp = static_cast<float*>(sq);
  float* srp = static_cast<float*>(sr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nr + kTile - 1) / kTile, (nq + kTile - 1) / kTile);
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  cudaError_t err = row_sums<Op>(qp, nq, words, wp, sqp, s);
  if (err != cudaSuccess) return err;
  err = row_sums<Op>(rp, nr, words, wp, srp, s);
  if (err != cudaSuccess) return err;
  if (wp != nullptr) {
    gram_kernel<Op, true><<<grid, kGramThreads, 0, s>>>(
        qp, nq, rp, nr, words, wp, sqp, srp, static_cast<float*>(out));
  } else {
    gram_kernel<Op, false><<<grid, kGramThreads, 0, s>>>(
        qp, nq, rp, nr, words, wp, sqp, srp, static_cast<float*>(out));
  }
  return cudaGetLastError();
}

}  // namespace

// K6. q [nq, words], r [nr, words] packed bits (pad bits zero) -> sim
// [nq, k] f32 and idx [nq, k] int64, the k largest similarities a query in
// descending order, the lower index first among equal ones. sq [nq] and sr
// [nr] f32 are scratch for the row popcounts. 1 <= k <= min(nr, 1024), words
// <= 2048. All contiguous on the current device; launched on `stream`, not
// synchronised.
extern "C" int bbbp_tanimoto_topk(const void* q, int nq, const void* r, int nr,
                                  int words, int k, void* sq, void* sr,
                                  void* out_sim, void* out_idx, void* stream) {
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  if (k < 1 || k > nr || k > kTopkMaxK || words < 1 || words > 2048) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t* qp = static_cast<const uint32_t*>(q);
  const uint32_t* rp = static_cast<const uint32_t*>(r);
  float* sqp = static_cast<float*>(sq);
  float* srp = static_cast<float*>(sr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = row_sums<BitOp>(qp, nq, words, nullptr, sqp, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = row_sums<BitOp>(rp, nr, words, nullptr, srp, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  tanimoto_topk_kernel<<<nq, kTopkThreads, words * sizeof(uint32_t), s>>>(
      qp, rp, nr, words, sqp, srp, k, static_cast<float*>(out_sim),
      static_cast<long long*>(out_idx));
  return static_cast<int>(cudaGetLastError());
}

// K7. q [nq, words], r [nr, words] packed bits -> out [nq, nr] f32 Tanimoto
// similarities. w is null, or [words * 32] f32 weights a bit (zero on pad
// bits). sq [nq], sr [nr] f32 are scratch for the row sums.
extern "C" int bbbp_tanimoto_gram(const void* q, int nq, const void* r, int nr,
                                  int words, const void* w, void* sq, void* sr,
                                  void* out, void* stream) {
  return static_cast<int>(
      gram<BitOp>(q, nq, r, nr, words, w, sq, sr, out, stream));
}

// K8. q [nq, words], r [nr, words] words of four uint8 counts, already
// clipped -> out [nq, nr] f32, Σ min / Σ max. w is null, or [words * 4] f32
// weights a count. sq [nq], sr [nr] f32 are scratch for the row sums.
extern "C" int bbbp_minmax_gram(const void* q, int nq, const void* r, int nr,
                                int words, const void* w, void* sq, void* sr,
                                void* out, int split, void* stream) {
  if (nq <= 0 || nr <= 0) return static_cast<int>(cudaGetLastError());
  if (split != 1 && split != 2 && split != 4 && split != kMmMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t* qp = static_cast<const uint32_t*>(q);
  const uint32_t* rp = static_cast<const uint32_t*>(r);
  const float* wp = static_cast<const float*>(w);
  float* sqp = static_cast<float*>(sq);
  float* srp = static_cast<float*>(sr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nr + kMmTile - 1) / kMmTile, (nq + kMmTile - 1) / kMmTile, split);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = row_sums<CountOp>(qp, nq, words, wp, sqp, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = row_sums<CountOp>(rp, nr, words, wp, srp, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = words % 4 == 0 && reinterpret_cast<uintptr_t>(qp) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rp) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kMmThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  float* op = static_cast<float*>(out);
  err = wp != nullptr
            ? cudaLaunchKernelEx(&cfg, minmax_gram_kernel<true>, qp, nq, rp, nr, words,
                                 vec, wp, static_cast<const float*>(sqp),
                                 static_cast<const float*>(srp), op)
            : cudaLaunchKernelEx(&cfg, minmax_gram_kernel<false>, qp, nq, rp, nr, words,
                                 vec, wp, static_cast<const float*>(sqp),
                                 static_cast<const float*>(srp), op);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
