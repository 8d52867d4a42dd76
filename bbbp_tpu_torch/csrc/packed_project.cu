// packed_project.cu — the screening projection on Hopper (sm_90a).
//
// Replaces: bbbp_tpu/ops/bitops.py::_packed_project_pallas, reached through
// packed_project. It unpacks little-endian uint32 fingerprint words into
// {0,1} bits and computes z = bits · W' + c0, where W' [d, k] and c0 [k] are
// the scaler and PCA folded together (bitops.py::project_weights).
//
// What bounds it here: the bound by bytes is the words, W' and z once (6.4 MB
// at N=16,384, W=64, d=2048, k=30: 1.9 µs at 3.35 TB/s). The useful work is
// a gather: z is c0 plus the rows of W' at the set bits, and Morgan
// fingerprints of the screening stream carry ~34 set bits of 2048 (1.65%).
// A dense product would spend ~60 multiply-adds on zeros for each useful
// one, and a walk over every word spends most of its instructions on words
// that are zero. On an H100 the set-bit form is bound by the latency of each
// molecule's chain of dependent steps (load the words, count, prefix sum,
// list, walk) and by the load instructions of the walk, one per set bit per
// column pair.
//
// Design:
// - 16 lanes take one molecule, 2 molecules a warp, 64 a block; one block
//   of 1,024 threads per SM streams molecules (persistent over rows).
// - Set-bit list instead of a word walk: lane l loads the molecule's words
//   4l..4l+3 (a pass of 64 words, 2,048 bits), counts their bits with
//   __popc, a prefix sum over the 16 lanes (__shfl_up_sync) gives its
//   offset, and it writes its ascending bit indices (uint16) into the
//   molecule's list in shared memory. Bits >= d are dropped. The list holds
//   128 entries: a denser pass (an all-ones row has 2,048 bits) is written
//   and walked in pieces of 128.
// - The lanes then walk the list, 8 entries a step, lane l adding the
//   columns 2l and 2l + 1 of each W' row with one 8-byte load. W' (240 KB)
//   is read through L1 and L2; holding it in shared memory in two column
//   slices, which costs a load of each slice per block and a pass over the
//   words per slice, was slower on the card (PERF.md). Where k or a slice
//   width is odd, the pair is two 4-byte loads.
// - k > 32 gives a lane more pairs (up to 4, k <= 128); the launcher cuts a
//   wider W' into column slices of balanced width, one per blockIdx.y.
// - Each column sums its bits in ascending order from 0 and adds c0 last,
//   so the rounding is that of the earlier word-walk form of this kernel.
//   Everything is f32, as the JAX package's reference
//   (_packed_project_jnp); only the order of the sum differs from it.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kGS = 16;                  // lanes a molecule: 2 molecules a warp
constexpr int kGroups = kThreads / kGS;
constexpr int kR = 4;                    // words a lane holds: a pass is 64
constexpr int kPassWords = kGS * kR;
constexpr int kCap = 128;                // list entries walked at a time
constexpr int kMaxSlice = 128;           // columns a slice: 4 pairs a lane
constexpr int kListStride = kCap + 8;    // uint16; 272 B keeps 16-B alignment
constexpr unsigned kFull = 0xffffffffu;

// W'[bit, j], W'[bit, jn]: one 8-byte load where the pair is aligned (and
// then jn = j + 1)
template <bool kAligned>
__device__ __forceinline__ float2 w_pair(const float* wrow, int bit, int k,
                                         int j, int jn) {
  const float* p = wrow + (size_t)bit * k;
  if (kAligned) return __ldg(reinterpret_cast<const float2*>(p + j));
  return make_float2(__ldg(p + j), __ldg(p + jn));
}

// acc[c] += W'[bit, 2p[c] : 2p[c] + 2] for every bit of lst[0, cnt), in
// list order
template <int C, bool kAligned>
__device__ __forceinline__ void walk(const uint16_t* lst, int cnt,
                                     const float* wrow, int k,
                                     const int (&j)[C], const int (&jn)[C],
                                     float2 (&acc)[C]) {
  constexpr int kStep = C == 1 ? 8 : 4;
  int e = 0;
  for (; e + kStep <= cnt; e += kStep) {
    unsigned pairs[kStep / 2];  // two uint16 entries each
    if constexpr (kStep == 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(lst + e);
      pairs[0] = q.x;
      pairs[1] = q.y;
      pairs[2] = q.z;
      pairs[3] = q.w;
    } else {
      const uint2 q = *reinterpret_cast<const uint2*>(lst + e);
      pairs[0] = q.x;
      pairs[1] = q.y;
    }
    float2 v[kStep][C];
#pragma unroll
    for (int i = 0; i < kStep; ++i) {
      const int bit = (pairs[i / 2] >> (16 * (i % 2))) & 0xffffu;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[i][c] = w_pair<kAligned>(wrow, bit, k, j[c], jn[c]);
      }
    }
#pragma unroll
    for (int i = 0; i < kStep; ++i) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[c].x += v[i][c].x;
        acc[c].y += v[i][c].y;
      }
    }
  }
  for (; e < cnt; ++e) {
    const int bit = lst[e];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float2 v = w_pair<kAligned>(wrow, bit, k, j[c], jn[c]);
      acc[c].x += v.x;
      acc[c].y += v.y;
    }
  }
}

// A group of 16 lanes takes one molecule; lane l owns the column pairs
// 2p, 2p + 1 for p = l, l + 16, ... (C of them) of the slice blockIdx.y,
// and holds words [p0 + 4l, p0 + 4l + 4) of a 64-word pass.
template <int C, bool kAligned>
__global__ void __launch_bounds__(kThreads, 1)
    packed_project_kernel(const uint32_t* __restrict__ packed, int n,
                          int words, const float* __restrict__ w,
                          const float* __restrict__ c0, int d, int k, int kc,
                          float* __restrict__ out) {
  __shared__ __align__(16) uint16_t lists[kGroups * kListStride];
  const int lane = threadIdx.x % kGS;
  uint16_t* lst = lists + (threadIdx.x / kGS) * kListStride;
  const int col0 = blockIdx.y * kc;
  const int width = min(kc, k - col0);
  const float* wrow = w + col0;
  int j[C], jn[C];  // the columns of each pair, clamped into the slice
#pragma unroll      // (what a clamped column reads is not stored)
  for (int c = 0; c < C; ++c) {
    j[c] = min(2 * (lane + kGS * c), kAligned ? width - 2 : width - 1);
    jn[c] = min(j[c] + 1, width - 1);
  }
  const int used = min(words, (d + 31) / 32);
  const long long step = (long long)gridDim.x * kGroups;
  // the loop is uniform over the warp, so the shuffles see all 32 lanes
  for (long long m0 = (long long)blockIdx.x * kGroups + threadIdx.x / 32 * 2;
       m0 < n; m0 += step) {
    const long long mol = m0 + threadIdx.x % 32 / kGS;
    float2 acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = make_float2(0.0f, 0.0f);
    for (int p0 = 0; p0 < used; p0 += kPassWords) {
      uint32_t cur[kR];
      int cnt = 0;
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        const int wi = p0 + lane * kR + q;
        cur[q] = mol < n && wi < used ? __ldg(packed + mol * words + wi) : 0u;
        const int below_d = d - wi * 32;  // bits at or past d are dropped
        if (below_d < 32) cur[q] &= below_d > 0 ? (1u << below_d) - 1u : 0u;
        cnt += __popc(cur[q]);
      }
      int incl = cnt;  // prefix sum of the counts over the group
#pragma unroll
      for (int o = 1; o < kGS; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o, kGS);
        if (lane >= o) incl += v;
      }
      const int total = __shfl_sync(kFull, incl, kGS - 1, kGS);
      const int pieces = __reduce_max_sync(kFull, (total + kCap - 1) / kCap);
      for (int lo = 0; lo < pieces * kCap; lo += kCap) {
        int e = incl - cnt - lo;  // this lane's first entry in the piece
        if (e < kCap && e + cnt > 0) {
#pragma unroll
          for (int q = 0; q < kR; ++q) {
            uint32_t word = cur[q];
            const int b0 = (p0 + lane * kR + q) * 32;
            while (word) {
              if (e >= 0 && e < kCap) {
                lst[e] = static_cast<uint16_t>(b0 + __ffs(word) - 1);
              }
              ++e;
              word &= word - 1;
            }
          }
        }
        __syncwarp();
        walk<C, kAligned>(lst, max(0, min(kCap, total - lo)), wrow, k, j, jn,
                          acc);
        __syncwarp();  // the list is refilled by the next piece
      }
    }
    if (mol < n) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int jj = 2 * (lane + kGS * c);
        float* o = out + mol * k + col0 + jj;
        if (jj < width) o[0] = acc[c].x + __ldg(c0 + col0 + jj);
        if (jj + 1 < width) o[1] = acc[c].y + __ldg(c0 + col0 + jj + 1);
      }
    }
  }
}

template <int C, bool kAligned>
cudaError_t launch(const uint32_t* packed, int n, int words, const float* w,
                   const float* c0, int d, int k, int kc, float* out,
                   cudaStream_t s) {
  const int slices = (k + kc - 1) / kc;
  if (slices > 65535) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // one block of 32 warps per SM, shared among the slices
  const long long needed = ((long long)n + kGroups - 1) / kGroups;
  const int blocks = (int)std::max(
      1LL, std::min(needed, (long long)std::max(1, sms / slices)));
  packed_project_kernel<C, kAligned><<<dim3(blocks, slices), kThreads, 0, s>>>(
      packed, n, words, w, c0, d, k, kc, out);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_c(const uint32_t* packed, int n, int words, const float* w,
                     const float* c0, int d, int k, int kc, float* out,
                     cudaStream_t s) {
  // pairs are 8-byte aligned when every row and slice starts on an even column
  const bool aligned = k % 2 == 0 && kc % 2 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 8 == 0;
  return aligned ? launch<C, true>(packed, n, words, w, c0, d, k, kc, out, s)
                 : launch<C, false>(packed, n, words, w, c0, d, k, kc, out, s);
}

}  // namespace

// packed [n, words] uint32, w [d, k] f32, c0 [k] f32 -> out [n, k] f32, all
// contiguous on the current device; launched on `stream`, not synchronised.
// d <= 65536 (the list holds uint16 bit indices).
extern "C" int bbbp_packed_project(const void* packed, int n, int words,
                                   const void* w, const void* c0, int d, int k,
                                   void* out, void* stream) {
  if (n <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  if (d < 0 || d > 65536) return static_cast<int>(cudaErrorInvalidValue);
  // the fewest column slices of at most kMaxSlice columns, of balanced width,
  // even where k is even so that every slice starts on an even column:
  // k = 30 is one slice, k = 200 two of 100, k = 258 three of 86
  const int n_slices = (k + kMaxSlice - 1) / kMaxSlice;
  int kc = (k + n_slices - 1) / n_slices;
  if (k % 2 == 0 && kc % 2 == 1) ++kc;
  const uint32_t* pp = static_cast<const uint32_t*>(packed);
  const float* wp = static_cast<const float*>(w);
  const float* cp = static_cast<const float*>(c0);
  float* op = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((kc + 31) / 32) {
    case 1: err = launch_c<1>(pp, n, words, wp, cp, d, k, kc, op, s); break;
    case 2: err = launch_c<2>(pp, n, words, wp, cp, d, k, kc, op, s); break;
    case 3: err = launch_c<3>(pp, n, words, wp, cp, d, k, kc, op, s); break;
    default: err = launch_c<4>(pp, n, words, wp, cp, d, k, kc, op, s); break;
  }
  return static_cast<int>(err);
}
