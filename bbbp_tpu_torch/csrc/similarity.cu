// similarity.cu — chemistry similarity kernels on Hopper (sm_90a): Tanimoto
// top-k search (K6), the full Tanimoto gram (K7) and the min-max gram of
// count fingerprints (K8).
//
// Replaces: bbbp_tpu/ops/similarity.py::tanimoto_topk, tanimoto_matrix,
// tanimoto_matrix_w, minmax_matrix and minmax_matrix_w. There the TPU takes
// every intersection as a float matmul of 0/1 matrices (and the min of two
// counts as `levels` such matmuls), because the matrix unit is the one fast
// thing it has. That form is not carried over. Here the fingerprints come in
// packed, 32 bits a word, and an intersection is a bitwise AND and a
// population count; counts come in clipped to one byte each, four a word,
// and Σ min(a, b) comes from the byte-wise Σ|a - b| and the row sums. No
// [Nq, Nr] intermediate leaves the chip but the result itself, and the
// top-k search writes only k columns.
//
// What bounds them here. The inputs of the transfer path (1,058 queries
// against 7,809 rows of 6 words) and of the regression legs (about 1,000 x
// 1,000 pairs of 64 words or 2,048 counts) are a few hundred KB to 2 MB and
// stay in L2. Intersections were the work: Nq·Nr·32·W bit pairs. Measured
// on an H100 (torch_rate_profile.py), POPC issues 15.9 a clock an SM, a
// quarter of LOP3's 61.8, while the binary tensor-core product
// mma.m16n8k256.b1.and.popc is one native instruction (BMMA.168256.AND.POPC)
// at 0.67 a clock an SM: 21,800 bit pairs a clock, 43x what POPC gives. So
// K6 and K7 take their intersections from it, and what is left bounds them:
// for K7 the epilogue (a round-to-nearest division and a store a pair) and
// each block's chain of latencies (the first stage's copy, the cluster's
// exchange), for K6 the selection. For K8 the instruction that counts is
// the byte-wise minimum: `__vminu4` is about six instructions on sm_90a,
// `__vsadu4` (Σ|a - b| over four bytes, accumulating) one,
// VABSDIFF4.U8.ACC.
//
// Design:
// - intersect_tile, shared by K6 and K7: a block of 256 threads (8 warps,
//   2 along the queries x 4 along the references) computes the exact int32
//   intersections of 32 query rows with 128 reference rows. Slabs of 16
//   words (two 256-bit k-steps) of the 160 rows are staged with cp.async
//   (16 bytes a copy where rows are 16-byte aligned, else 4; zeros past a
//   row's words, so 6 or 8 words are one slab), in two buffers, the next
//   slab's copy in flight during this one's work, one barrier a slab; rows
//   padded to 80 bytes so that each phase of ldmatrix hits 32 distinct
//   banks. ldmatrix.x4 gives a warp its A fragment (16 query rows, the "row"
//   layout) and two B fragments (16 reference rows: the "col" layout of B is
//   exactly a packed reference row), and each warp issues 4 b1 products a
//   k-step (16 x 32 of the tile). While the slab is in shared memory every
//   thread also popcounts its 16-byte pieces of it, so a block has the row
//   sums of its own rows in the same pass. For K6 the tile loop runs on over
//   chunks of 128 references and calls the selection after each one.
//   (ops/similarity.py pads packed rows to 16 bytes, so the main path takes
//   the 16-byte copies: four times as many 4-byte copies are slow to issue.)
// - K7 (tanimoto_gram_kernel): one launch, one 32 x 128 tile a block, each
//   thread storing its 16 results from its fragments. Where the tile has
//   many slabs (tanimoto_split in ops/similarity.py: 2 blocks at the legs'
//   64 words, 8 from 256) a thread block cluster shares the tile's slabs,
//   and block z adds the cluster's intersections and row sums (in block
//   order: integers, so any order gives the same bits) for its share of the
//   tile. The epilogue is rounded as the reference rounds it: (sq + sr) −
//   inter, max(·, 1e-9), a round-to-nearest division (the file is compiled
//   without --use_fast_math).
// - K6 (tanimoto_topk_kernel): the same tile with a selection epilogue. A
//   block holds 8 queries, one a warp (the tile's other 24 query rows are
//   zeros), and streams its share of the references (a cluster of up to 8
//   blocks splits them: topk_plan). (similarity, index) is one 64-bit key,
//   the similarity's f32 bits above the complemented index, so a larger key
//   is a larger similarity or, among equal ones, a lower index: the order of
//   the reference's top_k. A warp keeps its query's best 32·rows keys sorted
//   in its registers (rows from k); keys above the k-th go in, one at a
//   time by a ballot for the place and a shuffle of the tail, or, when more
//   than kMergeAt come in one group of 32, as a batch: a bitonic sort of the
//   group in shuffles and a bitonic merge with the list. The division is
//   taken only for a pair that passes an exact test: fma(-lo, den, inter)
//   >= 0, i.e. inter/den >= lo, with lo the f32 just below the k-th key's
//   similarity. Round-to-nearest is monotone, so a fraction that rounds to
//   that similarity or above is larger than its predecessor, and the single
//   rounding of the FMA keeps the sign of inter - lo·den: the test never
//   drops a pair whose key is above the k-th, at any width (where distinct
//   fractions round to one f32, the pair passes and the index decides in
//   the key). At the end the cluster's blocks meet in distributed shared
//   memory: the warp that owns a query in block z (z = query mod split)
//   takes the others' k best keys 32 at a time into its list. Keys are
//   unique, so the result does not depend on the order.
// - Weighted K7 (weighted_gram_kernel, 6 of a leg run's 67 calls): the b1
//   product cannot weigh bits. Row sums by row_sums_kernel (one warp a row,
//   a fixed shuffle tree), and a 32 x 32 tile a block that walks the set
//   bits of a AND b in ascending order with f32 adds, so a result is the
//   same from run to run.
// - K8 (minmax_gram_kernel), tiled in registers: a block of 128 threads
//   computes a 64 x 64 tile and a thread 8 x 4 of it; slabs of 16 words of
//   the tile's 128 rows staged with cp.async in two buffers. Unweighted,
//   Σ min(a, b) = (Σa + Σb - Σ|a - b|) / 2 with the row sums: integers,
//   exact. Weighted, the counts are staged as f32 and Σ w·min(a, b) is one
//   fminf and one FMA a count in ascending count order. A cluster of up to
//   8 blocks shares a tile's words, as in K7.
//
// Forms measured and dropped (PERF.md section 6 has the numbers):
// - the POPC inner loop of K6 and K7 (one block a query for K6, 32 x 32
//   tiles of scalar shared loads for K7) and their two row_sums launches;
// - Harley-Seal carry-save adders before POPC: not built, since the b1
//   product's measured rate is 43x POPC's and the adders save at most 4/3;
// - K7's results staged through shared memory and stored a row at a time
//   (slower at every shape measured);
// - K6 with 32 queries a block and their candidates in shared-memory
//   buffers sorted down to k by bitonic steps in shared memory (each step a
//   dependent load, compare and store), and with every new key inserted one
//   at a time, or every group merged as a batch (each slower).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;            // weighted K7: result tile edge
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

constexpr int kTq = 32;              // K6, K7: query rows of a tile
constexpr int kTr = 128;             // reference rows of a tile
constexpr int kTileRows = kTq + kTr;
constexpr int kTileThreads = 256;    // 8 warps: 2 along q x 4 along r
constexpr int kSlabWords = 16;       // words of a row a stage: two k-steps
constexpr int kSlabStride = kSlabWords + 4;  // 80 bytes
constexpr int kPieces = kTileRows * kSlabWords / 4;  // 16-byte pieces a stage
constexpr int kPiecesPerThread = (kPieces + kTileThreads - 1) / kTileThreads;
constexpr int kTileValues = 16;      // intersections a thread holds
constexpr int kTopkMaxK = 1024;
constexpr int kTopkQ = kTileThreads / 32;   // K6: queries a block, one a warp
constexpr int kMergeAt = 8;          // K6: more new keys than this are merged, not inserted

// A word of 32 fingerprint bits, weighed: the weights of its set bits,
// added in ascending bit order.
struct BitOp {
  static constexpr int kPerWord = 32;
  __device__ static float weigh(uint32_t a, const float* w) {
    float s = 0.0f;
    while (a) {
      s = __fadd_rn(s, w[__ffs(a) - 1]);
      a &= a - 1;
    }
    return s;
  }
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
  if constexpr (kWeighted) {
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

// Weighted K7: Σ w over the set bits of q AND r, a 32 x 32 tile a block.
__global__ void __launch_bounds__(kGramThreads)
    weighted_gram_kernel(const uint32_t* __restrict__ q, int nq,
                         const uint32_t* __restrict__ r, int nr, int words,
                         const float* __restrict__ w, const float* __restrict__ sq,
                         const float* __restrict__ sr, float* __restrict__ out) {
  __shared__ uint32_t qs[kTile * kPad];
  __shared__ uint32_t rs[kTile * kPad];
  __shared__ float ws[kChunk * BitOp::kPerWord];

  const int tid = threadIdx.x;
  const int tx = tid % kTile;          // reference row of the tile
  const int ty = tid / kTile;          // query rows ty, ty + 8, ty + 16, ty + 24
  const int q0 = blockIdx.y * kTile;
  const int r0 = blockIdx.x * kTile;

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};

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
    for (int i = tid; i < len * BitOp::kPerWord; i += kGramThreads) {
      ws[i] = __ldg(w + (size_t)c0 * BitOp::kPerWord + i);
    }
    __syncthreads();
    for (int c = 0; c < len; ++c) {
      const uint32_t rv = rs[tx * kPad + c];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t m = qs[(ty + 8 * u) * kPad + c] & rv;
        acc[u] = __fadd_rn(acc[u], BitOp::weigh(m, ws + c * BitOp::kPerWord));
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
    const float uni = __fsub_rn(__fadd_rn(sq[i], srj), acc[u]);
    out[(size_t)i * nr + j] = __fdiv_rn(acc[u], fmaxf(uni, 1e-9f));
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

// ---- the intersection tile of K6 and K7 ------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], const uint32_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(a)
               : "memory");
}

// c += popc(A AND B) over 256 bits: A 16 rows, B 8 columns (rows of r).
__device__ __forceinline__ void mma_and_popc(int (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct TileStages {
  uint32_t w[2][kTileRows * kSlabStride];   // [stage][q rows, then r rows]
};

// A thread's part of a tile: c[n][e] is the intersection of query row
// 16·wm + g + 8·(e / 2) with reference row 32·wn + 8·n + 2·t + e % 2 (warp
// wm, wn; lane 4·g + t); pop[u] the popcount of its piece u of each slab.
struct TileAcc {
  int c[4][4];
  int pop[kPiecesPerThread];
};

__device__ __forceinline__ void tile_position(int v, int& row, int& col) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = v / 4, e = v % 4;
  row = (warp / 4) * 16 + lane / 4 + (e / 2) * 8;
  col = (warp % 4) * 32 + n * 8 + 2 * (lane % 4) + e % 2;
}

// Words [w0, w0 + kSlabWords) of the tile's q_live query rows (from q) and
// r_live reference rows (from r) into one stage, zeros elsewhere.
__device__ __forceinline__ void stage_tile(uint32_t* dst, const uint32_t* q, int q_live,
                                           const uint32_t* r, int r_live, int words,
                                           int w0, bool vec) {
  const int per = vec ? 4 : 1;                  // words a copy
  const int copies = kTileRows * kSlabWords / per;
  for (int c = threadIdx.x; c < copies; c += kTileThreads) {
    const int row = c / (kSlabWords / per);
    const int e = (c % (kSlabWords / per)) * per;
    const bool is_q = row < kTq;
    const int local = is_q ? row : row - kTq;
    const bool live = local < (is_q ? q_live : r_live) && w0 + e < words;
    const uint32_t* src = is_q ? q : r;
    if (live) src += static_cast<size_t>(local) * words + w0 + e;
    if (vec)
      cp_async16(dst + row * kSlabStride + e, src, live);
    else
      cp_async4(dst + row * kSlabStride + e, src, live);
  }
  cp_async_commit();
}

// One stage's work: the b1 products of its k-steps (one where the slab has
// at most 8 live words), then the popcounts of this thread's pieces.
__device__ __forceinline__ void tile_products(TileAcc& acc, const uint32_t* buf,
                                              int ksteps) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const uint32_t* a_row = buf + ((warp / 4) * 16 + lane % 16) * kSlabStride + (lane / 16) * 4;
  const uint32_t* b_row =
      buf + (kTq + (warp % 4) * 32 + lane % 8 + (lane / 16) * 8) * kSlabStride +
      ((lane / 8) % 2) * 4;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    if (ks < ksteps) {
      uint32_t a[4], b[2][4];
      ldsm_x4(a, a_row + ks * 8);
      ldsm_x4(b[0], b_row + ks * 8);
      ldsm_x4(b[1], b_row + 16 * kSlabStride + ks * 8);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        mma_and_popc(acc.c[2 * p], a, b[p][0], b[p][1]);
        mma_and_popc(acc.c[2 * p + 1], a, b[p][2], b[p][3]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kPiecesPerThread; ++u) {
    const int c = threadIdx.x + u * kTileThreads;
    if (c < kPieces) {
      const uint4 v = *reinterpret_cast<const uint4*>(buf + (c / 4) * kSlabStride + (c % 4) * 4);
      acc.pop[u] += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    }
  }
}

__device__ __forceinline__ void tile_clear(TileAcc& acc) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc.c[n][e] = 0;
#pragma unroll
  for (int u = 0; u < kPiecesPerThread; ++u) acc.pop[u] = 0;
}

// rs[row] = the popcount of tile row `row` over the slabs seen (q rows
// first); the four pieces of a row sit in four neighbouring lanes.
__device__ __forceinline__ void tile_row_sums(const TileAcc& acc, int* rs) {
#pragma unroll
  for (int u = 0; u < kPiecesPerThread; ++u) {
    const int c = threadIdx.x + u * kTileThreads;
    int s = acc.pop[u];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (c < kPieces && c % 4 == 0) rs[c / 4] = s;
  }
}

// The tile loop of K6 and K7: for each chunk of kTr reference rows in
// [r_begin, r_end), the intersections with the tile's q_live query rows
// (q points at the first) over the slabs [s_begin, s_end), into acc (cleared
// at each chunk's start), then done(chunk). Slabs of all chunks form one
// stream through the two stages, so the next chunk's first copy is in
// flight during this chunk's last slab and its done().
template <typename Done>
__device__ __forceinline__ void intersect_tile(TileStages& st, TileAcc& acc,
                                               const uint32_t* q, int q_live,
                                               const uint32_t* r, int r_begin,
                                               int r_end, int words, int s_begin,
                                               int s_end, bool vec, Done&& done) {
  const int per_chunk = s_end - s_begin;
  const int chunks = r_end > r_begin ? (r_end - r_begin + kTr - 1) / kTr : 0;
  const int total = per_chunk > 0 ? chunks * per_chunk : 0;
  auto issue = [&](int f) {
    const int r0 = r_begin + (f / per_chunk) * kTr;
    stage_tile(st.w[f & 1], q, q_live, r + static_cast<size_t>(r0) * words,
               min(kTr, r_end - r0), words, (s_begin + f % per_chunk) * kSlabWords, vec);
  };
  tile_clear(acc);
  if (total > 0) issue(0);
  for (int f = 0; f < total; ++f) {
    const int s = s_begin + f % per_chunk;
    if (f > 0 && s == s_begin) tile_clear(acc);
    cp_async_wait_all();
    __syncthreads();                        // stage f landed; stage f + 1 free
    if (f + 1 < total) issue(f + 1);
    tile_products(acc, st.w[f & 1], words - s * kSlabWords > 8 ? 2 : 1);
    if (s == s_end - 1) done(f / per_chunk);
  }
}

// ---- K7 ---------------------------------------------------------------------

__global__ void __launch_bounds__(kTileThreads)
    tanimoto_gram_kernel(const uint32_t* __restrict__ q, int nq,
                         const uint32_t* __restrict__ r, int nr, int words,
                         bool vec, float* __restrict__ out) {
  __shared__ __align__(16) TileStages st;
  __shared__ int rs[kTileRows];             // this block's row sums
  __shared__ int rs_all[kTileRows];         // the cluster's
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int q0 = blockIdx.y * kTq, r0 = blockIdx.x * kTr;
  const int slabs = (words + kSlabWords - 1) / kSlabWords;

  TileAcc acc;
  intersect_tile(st, acc, q + static_cast<size_t>(q0) * words, min(kTq, nq - q0), r, r0,
                 min(r0 + kTr, nr), words, rank * slabs / split,
                 (rank + 1) * slabs / split, vec, [](int) {});
  tile_row_sums(acc, rs);

  const int* sums = split == 1 ? rs : rs_all;
  auto write = [&](int v, int inter) {
    int row, col;
    tile_position(v, row, col);
    const int i = q0 + row, j = r0 + col;
    if (i >= nq || j >= nr) return;
    const float fi = static_cast<float>(inter);
    const float uni = __fsub_rn(__fadd_rn(static_cast<float>(sums[row]),
                                          static_cast<float>(sums[kTq + col])), fi);
    out[static_cast<size_t>(i) * nr + j] = __fdiv_rn(fi, fmaxf(uni, 1e-9f));
  };
  if (split == 1) {
    __syncthreads();
#pragma unroll
    for (int v = 0; v < kTileValues; ++v) write(v, acc.c[v / 4][v % 4]);
    return;
  }
  // the cluster's sums meet: [v][thread] in each block's stages
  __syncthreads();                          // the last stage is read
  int* part = reinterpret_cast<int*>(&st.w[0][0]);
#pragma unroll
  for (int v = 0; v < kTileValues; ++v) part[v * kTileThreads + threadIdx.x] = acc.c[v / 4][v % 4];
  cluster.sync();
  for (int row = threadIdx.x; row < kTileRows; row += kTileThreads) {
    int s = 0;
    for (int z = 0; z < split; ++z) s += *cluster.map_shared_rank(rs + row, z);
    rs_all[row] = s;
  }
  __syncthreads();
  const int per = kTileValues / split;
#pragma unroll
  for (int v = 0; v < kTileValues; ++v) {
    if (v / per != rank) continue;
    int s = 0;
    for (int z = 0; z < split; ++z)
      s += *cluster.map_shared_rank(part + v * kTileThreads + threadIdx.x, z);
    write(v, s);
  }
  cluster.sync();                           // the others read this block's sums
}

// ---- K6 ---------------------------------------------------------------------

struct TopkShared {
  TileStages st;
  int inter[kTopkQ][kTr + 4];               // a chunk's intersections
  int rs[kTileRows];                        // the tile's row sums
};                                          // with a cluster, the lists follow:
                                            // [kTopkQ][32 * rows] keys

// The similarity's f32 bits above the complemented index: a larger key is
// a larger similarity or, among equal ones, a lower index. Never 0.
__device__ __forceinline__ unsigned long long topk_key(float sim, int j) {
  return (static_cast<unsigned long long>(__float_as_uint(sim)) << 32) |
         (0xffffffffu - static_cast<uint32_t>(j));
}

// One compare-exchange of a descending bitonic step between this lane's x
// and lane ^ s's: the lower lane keeps the larger key when `desc`.
__device__ __forceinline__ unsigned long long warp_exchange(unsigned long long x, int s,
                                                            bool desc) {
  const unsigned long long o = __shfl_xor_sync(0xffffffffu, x, s);
  const bool lower = (threadIdx.x & s) == 0;
  return (lower == desc) == (x > o) ? x : o;
}

// A query's best 32·kRows keys, in the registers of the warp that owns it:
// element 32·r + lane is v[r] of that lane, in descending order; zeros
// (below every key) until that many have come.
template <int kRows>
struct TopList {
  unsigned long long v[kRows];
  unsigned long long thresh;                // its k-th element
  float lo;                                 // the f32 below thresh's similarity

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int r = 0; r < kRows; ++r) v[r] = 0ull;
    thresh = 0ull;
    lo = -1.0f;                             // every pair passes
  }

  // Offers one key a lane (0: none); the keys above thresh go in. A few
  // are inserted one at a time (each a ballot for its place and a shift of
  // the list's tail by one lane); more than kMergeAt are merged at once:
  // the warp sorts the 32 keys (a bitonic network in shuffles), the larger
  // of the list's last row and the reversed batch leaves the list bitonic,
  // and one bitonic clean (rows, then lanes) sorts it again. Either way
  // thresh is then the k-th element.
  __device__ __forceinline__ void offer(unsigned long long key, int k) {
    unsigned ballot = __ballot_sync(0xffffffffu, key > thresh);
    if (ballot == 0u) return;
    if (__popc(ballot) <= kMergeAt) {
      while (ballot) {
        const unsigned long long one = __shfl_sync(0xffffffffu, key, __ffs(ballot) - 1);
        ballot &= ballot - 1;
        if (one > thresh) insert(one, k);
      }
      return;
    }
    const int lane = threadIdx.x % 32;
    unsigned long long x = key > thresh ? key : 0ull;
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
      for (int s = size / 2; s > 0; s /= 2) x = warp_exchange(x, s, (lane & size) == 0);
    const unsigned long long rev = __shfl_sync(0xffffffffu, x, 31 - lane);
    v[kRows - 1] = v[kRows - 1] > rev ? v[kRows - 1] : rev;
#pragma unroll
    for (int rs = kRows / 2; rs > 0; rs /= 2)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if ((r & rs) == 0) {
          const unsigned long long a = v[r], b = v[r + rs];
          v[r] = a > b ? a : b;
          v[r + rs] = a > b ? b : a;
        }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int s = 16; s > 0; s /= 2) v[r] = warp_exchange(v[r], s, true);
    set_thresh(k);
  }

  // Inserts `key` (the same in every lane, above thresh), dropping the
  // last element.
  __device__ __forceinline__ void insert(unsigned long long key, int k) {
    const int lane = threadIdx.x % 32;
    int pos = 0;                            // elements above key (keys are unique)
#pragma unroll
    for (int r = 0; r < kRows; ++r) pos += __popc(__ballot_sync(0xffffffffu, v[r] > key));
    unsigned long long carry = 0ull;        // the last element of the row before
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const unsigned long long up = __shfl_up_sync(0xffffffffu, v[r], 1);
      const unsigned long long last = __shfl_sync(0xffffffffu, v[r], 31);
      const int e = 32 * r + lane;
      if (e == pos)
        v[r] = key;
      else if (e > pos)
        v[r] = lane == 0 ? carry : up;
      carry = last;
    }
    set_thresh(k);
  }

  __device__ __forceinline__ void set_thresh(int k) {
    unsigned long long kth = 0ull;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r == (k - 1) / 32) kth = v[r];
    thresh = __shfl_sync(0xffffffffu, kth, (k - 1) % 32);
    const float sim = __uint_as_float(static_cast<uint32_t>(thresh >> 32));
    lo = sim > 0.0f ? __uint_as_float(__float_as_uint(sim) - 1u) : -1.0f;
  }
};

// K6 (see Design above). A warp owns query q0 + warp of the block's tile.
template <int kRows>
__global__ void __launch_bounds__(kTileThreads)
    tanimoto_topk_kernel(const uint32_t* __restrict__ q, int nq,
                         const uint32_t* __restrict__ r, int nr, int words,
                         bool vec, int k, float* __restrict__ out_sim,
                         long long* __restrict__ out_idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  TopkShared& sh = *reinterpret_cast<TopkShared*>(smem);
  unsigned long long* lists = reinterpret_cast<unsigned long long*>(smem + sizeof(TopkShared));
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int q0 = blockIdx.x * kTopkQ;
  const int q_live = min(kTopkQ, nq - q0);
  const int chunks = (nr + kTr - 1) / kTr;  // block z takes its share of them
  const int r_begin = min(nr, rank * chunks / split * kTr);
  const int r_end = min(nr, (rank + 1) * chunks / split * kTr);

  TopList<kRows> list;
  list.clear();
  TileAcc acc;
  intersect_tile(
      sh.st, acc, q + static_cast<size_t>(q0) * words, q_live, r, r_begin, r_end, words, 0,
      (words + kSlabWords - 1) / kSlabWords, vec, [&](int chunk) {
        const int r0 = r_begin + chunk * kTr;
        const int r_live = min(kTr, r_end - r0);
#pragma unroll
        for (int v = 0; v < kTileValues; ++v) {
          int row, col;
          tile_position(v, row, col);
          if (row < kTopkQ) sh.inter[row][col] = acc.c[v / 4][v % 4];
        }
        tile_row_sums(acc, sh.rs);
        __syncthreads();
        if (warp >= q_live) return;
        const int sqi = sh.rs[warp];
        unsigned long long keys[kTr / 32];     // references lane, lane + 32, ...
#pragma unroll
        for (int u = 0; u < kTr / 32; ++u) {
          const int c = lane + 32 * u;
          keys[u] = 0ull;
          if (c < r_live) {
            const int inter = sh.inter[warp][c];
            const int uni = sqi + sh.rs[kTq + c] - inter;
            const float fi = static_cast<float>(inter);
            const float den = uni > 0 ? static_cast<float>(uni) : 1e-9f;
            if (fmaf(-list.lo, den, fi) >= 0.0f)   // inter / den >= lo, exactly
              keys[u] = topk_key(__fdiv_rn(fi, den), r0 + c);
          }
        }
#pragma unroll
        for (int u = 0; u < kTr / 32; ++u) list.offer(keys[u], k);
      });

  auto write = [&]() {
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int t = 32 * rr + lane;
      if (t < k) {
        const size_t at = static_cast<size_t>(q0 + warp) * k + t;
        out_sim[at] = __uint_as_float(static_cast<uint32_t>(list.v[rr] >> 32));
        out_idx[at] = static_cast<long long>(0xffffffffu - static_cast<uint32_t>(list.v[rr]));
      }
    }
  };
  if (split == 1) {
    if (warp < q_live) write();
    return;
  }
  // the cluster's lists meet: block z's warp i takes query i = z (mod split)
  // and offers it the other blocks' k best keys, 32 at a time
  unsigned long long* mine = lists + static_cast<size_t>(warp) * 32 * kRows;
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) mine[32 * rr + lane] = list.v[rr];
  cluster.sync();
  if (warp < q_live && warp % split == rank) {
    for (int z = 0; z < split; ++z) {
      if (z == rank) continue;
      const unsigned long long* far = cluster.map_shared_rank(mine, z);
      for (int t0 = 0; t0 < k; t0 += 32) {
        const int t = t0 + lane;
        list.offer(t < k ? far[t] : 0ull, k);
      }
    }
    write();
  }
  cluster.sync();                           // the others read this block's lists
}

template <typename Op, bool kWeighted>
cudaError_t row_sums(const uint32_t* x, int n, int words, const float* w,
                     float* out, cudaStream_t s) {
  if (n <= 0) return cudaSuccess;
  const int rows = kRowSumThreads / 32;
  const int blocks = (n + rows - 1) / rows;
  row_sums_kernel<Op, kWeighted><<<blocks, kRowSumThreads, 0, s>>>(x, n, words, w, out);
  return cudaGetLastError();
}

bool aligned_rows(const void* q, const void* r, int words) {
  return words % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(r) % 16 == 0;
}

}  // namespace

// K6. q [nq, words], r [nr, words] packed bits (pad bits zero) -> sim
// [nq, k] f32 and idx [nq, k] int64, the k largest similarities a query in
// descending order, the lower index first among equal ones. 1 <= k <=
// min(nr, 1024), words <= 2048. A cluster of `split` blocks along the
// references, 32·`rows` keys kept a query (topk_plan's). All contiguous on
// the current device; launched on `stream`, not synchronised.
extern "C" int bbbp_tanimoto_topk(const void* q, int nq, const void* r, int nr,
                                  int words, int k, int split, int rows,
                                  void* out_sim, void* out_idx, void* stream) {
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  const bool plan_ok = (split == 1 || split == 2 || split == 4 || split == kMmMaxSplit) &&
                       (rows & (rows - 1)) == 0 && 32 * rows >= k && (rows == 1 || 16 * rows < k);
  if (k < 1 || k > nr || k > kTopkMaxK || words < 1 || words > 2048 || !plan_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using Kernel = void (*)(const uint32_t*, int, const uint32_t*, int, int, bool, int, float*,
                          long long*);
  const Kernel kernels[] = {tanimoto_topk_kernel<1>, tanimoto_topk_kernel<2>,
                            tanimoto_topk_kernel<4>, tanimoto_topk_kernel<8>,
                            tanimoto_topk_kernel<16>, tanimoto_topk_kernel<32>};
  const Kernel kernel = kernels[__builtin_ctz(rows)];
  const size_t smem = sizeof(TopkShared) +
                      (split > 1 ? static_cast<size_t>(kTopkQ) * 32 * rows * 8 : 0);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((nq + kTopkQ - 1) / kTopkQ, 1, split);
  cfg.blockDim = dim3(kTileThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const uint32_t*>(q), nq,
                           static_cast<const uint32_t*>(r), nr, words,
                           aligned_rows(q, r, words), k, static_cast<float*>(out_sim),
                           static_cast<long long*>(out_idx));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K7. q [nq, words], r [nr, words] packed bits -> out [nq, nr] f32 Tanimoto
// similarities. w is null: one launch, a cluster of `split` blocks
// (tanimoto_split's) along the words; sq and sr are not used. Or w is
// [words * 32] f32 weights a bit (zero on pad bits): sq [nq], sr [nr] f32
// are scratch for the weighted row sums, and split must be 1.
extern "C" int bbbp_tanimoto_gram(const void* q, int nq, const void* r, int nr,
                                  int words, const void* w, void* sq, void* sr,
                                  void* out, int split, void* stream) {
  if (nq <= 0 || nr <= 0) return static_cast<int>(cudaGetLastError());
  const uint32_t* qp = static_cast<const uint32_t*>(q);
  const uint32_t* rp = static_cast<const uint32_t*>(r);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != nullptr) {
    if (split != 1) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((nr + kTile - 1) / kTile, (nq + kTile - 1) / kTile);
    if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
    const float* wp = static_cast<const float*>(w);
    float* sqp = static_cast<float*>(sq);
    float* srp = static_cast<float*>(sr);
    cudaError_t err = row_sums<BitOp, true>(qp, nq, words, wp, sqp, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = row_sums<BitOp, true>(rp, nr, words, wp, srp, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    weighted_gram_kernel<<<grid, kGramThreads, 0, s>>>(qp, nq, rp, nr, words, wp, sqp, srp,
                                                       static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  const int slabs = (words + kSlabWords - 1) / kSlabWords;
  if ((split != 1 && split != 2 && split != 4 && split != kMmMaxSplit) || split > slabs)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((nr + kTr - 1) / kTr, (nq + kTq - 1) / kTq, split);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kTileThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, tanimoto_gram_kernel, qp, nq, rp, nr, words,
                                       aligned_rows(q, r, words), static_cast<float*>(out));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
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
  cudaError_t (*sums)(const uint32_t*, int, int, const float*, float*, cudaStream_t) =
      wp != nullptr ? &row_sums<CountOp, true> : &row_sums<CountOp, false>;
  cudaError_t err = sums(qp, nq, words, wp, sqp, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sums(rp, nr, words, wp, srp, s);
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
