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
//    reference's compiled tree step rounds it; in boosting also the next
//    tree's g, h (tree_step, :302-319) from the updated margins, and their
//    (max |g|, max |h|).
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
// two differ by the plain version's own rounding error;
// level_histogram_fixed_reference repeats the fixed-point arithmetic in
// torch and equals K3 bit for bit.
//
// What bounds them here. K3 reads xb once (n * F bytes) and writes the
// histogram once (nodes * F * 512 B): under a microsecond at the screening
// trainer's shape (n = 7,809, F = 30, levels 0-5), 26 us at the transfer
// path's deepest (F = 326, level 9, an 85 MB histogram). What a histogram
// kernel pays above that is (a) shared-memory atomics, two 64-bit adds per
// row and feature, which collide when a feature has two bins and most rows
// sit in one of them, (b) rows that a block reads and does not use, and (c)
// passes over the histogram besides the one write. The design below removes
// the three; measured on an H100 (700 W), what is left is the chain of its
// launches: the one-block sort takes 5-8 us of a 12-16 us call at F = 30 and
// of a 25-32 us call at F = 326, levels 0-5, and at level 9 (60-67 us)
// 10,752 blocks of ~15 rows each pay a block's start-up for 8 KB of output.
// K4 reads the histogram once; its work is a chain of dependent f32 adds
// and two IEEE divisions a bin, and it is bound by the instruction rate, not
// by bytes. K5 moves 156 KB at the trainer's 7,809 rows with the next
// tree's inputs and outputs (0.05 us at the memory rate); it is bound by
// latency: a launch (~1 us for an empty cluster launch in a CUDA graph), a
// global load's round trip, one cluster barrier (~1,200-1,700 cycles: the
// barrier's release is a GPU-wide MEMBAR, and its acquire invalidates L1)
// and the loads from other blocks' shared memory (torch_leaf_profile.py
// builds K5 with its phase clocks, below, and reads them).
//
// K3 design.
// 1. hist_group_kernel, one block: a counting sort of the rows by node
//    (count in shared memory, exclusive scan, scatter). It drops the rows
//    of weight 0 (g = h = 0), writes the kept rows' indices in node order
//    and lays out the work. It is one multiprocessor's serial section of
//    every call, so it does the least it can per row: the rows are
//    quantised by the blocks that use them, 8 rows' loads a thread are in
//    flight together, the first 8,192 rows' nodes stay in registers between
//    count and scatter, and the scatter goes through shared memory so that
//    global memory is written in order. An item is
//    (node, row range). A node of at most own_rows rows is one item, so
//    one block owns it; a larger node is cut into items of rows_per_item
//    rows and gets a slot in a small int64 accumulator. The other blocks of
//    the same launch zero that accumulator and take the two fixed-point
//    scales and their inverses, once a call.
// 2. level_hist_kernel, grid (items, feature tiles): a block reads only its
//    item's rows. A lane keeps one feature of the tile for all its rows.
//    A feature of at most 4 occupied bins (n_bins, from the bin mapper's
//    edges) is summed in the lane's registers, as the node total and bins
//    1-3, and reaches shared memory once a block; the others add to a
//    shared tile that holds only occupied bins. A 64-bit add on shared
//    memory is a compare-and-swap loop on this card, so the tile is added
//    to as two 32-bit words with the carry taken from the low word's
//    returned value: two native atomics, exact modulo 2^64 in any order.
//    The block that owns a node converts its tile to f32 and writes out
//    itself, zeros included; a block of a split node adds its non-zero
//    bins to the node's accumulator slot.
// 3. hist_finish_kernel converts the slots of split nodes only. It is not
//    launched when no node can be split (n <= own_rows).
// The wrapper's histogram_plan sets the sizes: 8 features a tile up to
// F = 64 and 16 above, 256 rows an item, nodes split above 512 rows, 256
// threads a block or 128 where a node holds under 128 rows on average (of
// the sizes tried on the card, these were the fastest at n = 7,809).
// Order never enters an integer sum, so the result equals the exact sum of
// the quantised values whatever the grouping.
//
// K4 design: four lanes a feature, one 16-bin chunk each. The plain version
// sums sequentially inside a 16-bin chunk and adds the chunk offsets last
// (as the reference's CPU cumsum sums), so the chunks are independent until
// the offsets: a lane keeps its 16 running (g, h) sums in registers, the
// four lanes exchange their chunk totals by shuffle and each forms the
// offsets in chunk order, then its 16 gains. One pass over the histogram.
// A warp copies 8 features (4 KB, contiguous) from the histogram into its
// shared-memory stage with cp.async, 16 coalesced bytes a lane. Each 16-bin
// chunk is padded by 16 bytes (cp.async needs 16-byte aligned rows), which
// spreads the lanes' chunks over 8 bank groups instead of one. Masked-out
// features are not read. Measured, the kernel is bound by the instruction
// rate, not by the copy (85 MB at level 9 took 94 us with the next copy
// in flight behind the arithmetic, and as long without): two IEEE
// divisions a bin. So the divisions of a bin are skipped where none of the
// warp's 32 bins is valid, which at deep levels is most of them. Every
// operation is an explicitly rounded f32 op in the plain version's order,
// so the gains are bit-equal to the plain version's on the same histogram. (gain, index) pairs meet in a reduction
// that keeps the first index on ties; NaN counts as the largest value, as
// torch.argmax and jnp.argmax treat it.
// Per-node mode: grid (nodes, blocks of 64 features), a warp per group of 8
// features, so a level of few nodes still fills the card; where a node has
// more than one block, each writes its best (gain, index) and a second
// small launch takes the first-index maximum per node.
// Oblivious mode: the grid runs over groups of 4 features. A block's warps
// compute the masked gains of (node, feature) pairs for a run of 32 nodes
// into shared memory (an invalid entry is stored as -0.0f, which adds
// nothing and marks itself), then one thread per (feature, bin) adds the
// run in node order, the plain version's order. Each block writes its best
// (gain, index); a second one-block launch takes the first-index maximum of
// those and writes the level's split to every node.
//
// K5 design: one launch, no memset, no global scratch. One thread block
// cluster of up to 16 blocks of 1,024 threads, a row a thread (8 blocks at
// the trainer's 7,809 rows), more rows in a loop.
// 1. All loads of a thread's first row (pos, g, h, the margin and, in
//    boosting, y, the subsample draw and the weight) and the bounds are
//    issued first and stay in registers through the barriers to the update.
// 2. A thread of each block takes both scales from the exponent field of
//    the float64 n * max (fixed_scale): a few integer operations.
// 3. A block adds its rows' quantised (g, h) to its own shared table, each
//    64-bit add as two 32-bit atomics with a carry, as K3 (a 64-bit shared
//    atomicAdd is a compare-and-swap loop, ATOMS.CAST.SPIN.64).
// 4. One cluster barrier. Warps copy 32 entries (512 contiguous bytes) of
//    one block's table at a time into a local stage through distributed
//    shared memory, and a thread adds a leaf's entries (integers: in any
//    order, so the sums, leaves and margins are those of the three-launch
//    form bit for bit). With leaves x blocks <= 2 x threads (64 leaves)
//    every block takes every leaf itself; with more (1,024 leaves) block b
//    takes a slice and a second barrier hands the values round.
// 5. Every row is updated from local shared memory. In boosting the next
//    (g, h) follow with the plain version's torch ops and roundings: the
//    sigmoid as 1 / (1 + expf(-x)) (torch's on the card; equal bit for bit
//    in every case held), the clamp that keeps a NaN, (g * m) * w. The
//    bounds meet by warp, block and cluster maximum on the float bits
//    (|v| >= 0, so the integer order is the float order), in an output
//    that block 0 zeroes before the barrier.
// 6. A block that has read the others' memory arrives at a second cluster
//    barrier without a release (a release would wait for its global
//    stores), and waits there only before it exits.
// Tried on the card and dropped: one block of 1,024 threads (its 31,000
// shared atomics at 7,809 rows take longer than the barrier saves), a
// block reading a leaf's entries with one remote load a lane and a shuffle
// tree, or each row its leaf from the owner's shared memory (slower than
// the staged copies), a cheaper barrier (raw PTX and fence.acq_rel
// .cluster give the same MEMBAR.ALL.GPU), and every block pushing its table
// into the others' shared memory with st.async, counted on each receiver's
// transaction barrier (under half a microsecond less at 64 leaves, for a
// second exchange path of raw PTX with its own ordering argument).

#include <cmath>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 64;
constexpr int kChunk = 16;                  // bin-sum order, see K4 design
constexpr int kChunks = kBins / kChunk;
constexpr int kFewBins = 4;                 // summed in registers up to here
constexpr int kHistThreads = 256;
constexpr int kHistUnroll = 8;              // rows a lane has in flight
constexpr int kSortThreads = 1024;
constexpr int kSortUnroll = 8;
constexpr int kFewNodes = 8;                // levels whose rows share counters
constexpr int kMaxSlots = 64;               // split nodes a level
constexpr int kMaxSortNodes = 8192;         // 32 KB of shared counters
constexpr int kSortStagedRows = 10240;      // ordered in shared memory up to here
constexpr int kSplitThreads = 256;
constexpr int kGroupFeats = 32 / kChunks;   // features a warp stages at once
constexpr int kChunkStride = 2 * kChunk + 4;        // floats: 16-byte rows, padded
constexpr int kStageFloats = 32 * kChunkStride;     // a warp's stage
constexpr int kSplitFeats = (kSplitThreads / 32) * kGroupFeats;    // a block
constexpr int kOblFeats = 4;                // features a block, oblivious
constexpr int kOblRun = 32;                 // nodes a run
constexpr int kOblThreads = kOblFeats * kBins;
constexpr int kLeafThreads = 1024;
constexpr int kLeafMaxCluster = 16;         // non-portable above 8

typedef unsigned long long u64;

}  // namespace

// K5's phase clocks, compiled in only with -DBBBP_LEAF_CLOCKS (see
// torch_leaf_profile.py): thread 0 of each block stamps clock64() at the
// end of each step, [block][step].
#ifdef BBBP_LEAF_CLOCKS
__device__ long long g_leaf_clock[16][16];
#define LEAF_CLOCK(k) \
  do { if (threadIdx.x == 0) g_leaf_clock[rank][k] = clock64(); } while (0)
#else
#define LEAF_CLOCK(k) do {} while (0)
#endif

namespace {

// ---- fixed point ------------------------------------------------------------

// 2^e with n * max * 2^e < 2^62, 1 for no rows or a max of 0, inf or nan.
// The float64 bound n * max is normal and finite (2^-149 to 2^159), so e is
// its exponent field + 1 (ilogb's value + 1) and 2^(62 - e) is built from
// the fields (ldexp's value): a few integer operations, where ilogb and
// ldexp are subroutines of ~1,300 cycles.
__device__ __forceinline__ double fixed_scale(float m, int n) {
  if (!(m > 0.f) || !isfinite(m) || n <= 0) return 1.0;
  const double bound = static_cast<double>(m) * static_cast<double>(n);
  const int e = static_cast<int>((__double_as_longlong(bound) >> 52) & 0x7ff) - 1022;
  return __longlong_as_double(static_cast<long long>(1023 + 62 - e) << 52);
}

__device__ __forceinline__ long long quantise(float v, double scale) {
  return llrint(static_cast<double>(v) * scale);
}

// A fixed-point sum q back in f32: q / scale as q * inverse, inverse =
// 1 / scale. The scale is a power of two, so is its inverse, and the two
// give the same float64 (both exact, and normal: |q| >= 1, scale <= 2^211);
// the division it saves is a subroutine of float64 operations.
__device__ __forceinline__ float bin_value(long long q, double inverse) {
  return static_cast<float>(static_cast<double>(q) * inverse);
}

// ---- K3 ---------------------------------------------------------------------

// Exclusive prefix of v over the block's threads; *total gets the sum.
__device__ long long block_exclusive_scan(long long v, long long* total) {
  __shared__ long long s_warp[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const long long up = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += up;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const long long w = lane < (blockDim.x >> 5) ? s_warp[lane] : 0;
    long long winc = w;
    for (int o = 1; o < 32; o <<= 1) {
      const long long up = __shfl_up_sync(0xffffffffu, winc, o);
      if (lane >= o) winc += up;
    }
    s_warp[lane] = winc - w;
    if (lane == 31) *total = winc;
  }
  __syncthreads();
  return s_warp[warp] + inc - v;
}

// The nodes of the block's rows first + u * blockDim.x + threadIdx.x, u <
// kSortUnroll: -1 for a row of weight 0 (g = h = 0, as subsampling leaves
// them), a row outside the level or a slot past n. The loads of all
// kSortUnroll rows are in flight together.
__device__ __forceinline__ void live_nodes(const int* __restrict__ pos, int n,
                                           const float* __restrict__ g,
                                           const float* __restrict__ h,
                                           int n_nodes, int first,
                                           int (&node)[kSortUnroll]) {
  float gv[kSortUnroll], hv[kSortUnroll];
#pragma unroll
  for (int u = 0; u < kSortUnroll; ++u) {
    const int r = first + u * blockDim.x + threadIdx.x;
    node[u] = r < n ? pos[r] : -1;
    gv[u] = r < n ? g[r] : 0.f;
    hv[u] = r < n ? h[r] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kSortUnroll; ++u)
    if (node[u] >= n_nodes || (gv[u] == 0.f && hv[u] == 0.f)) node[u] = -1;
}

// Where this lane's kSortUnroll rows go: every (warp, node) adds its rows
// to the node's counter, and with kScatter place[u] gets, for each row, the
// rows of its node that the counter held and that the warp puts ahead of it
// (any order inside a node will do). Levels of at most kFewNodes nodes count
// a warp's rows of all nodes at once, in 16-bit fields of two 64-bit words
// that a shuffle scan sums over the lanes, and add once a (warp, node): at
// level 0 every row holds node 0, and one add a row to one counter is
// 8,000 adds in a queue. Deeper levels, where the rows of a warp seldom
// meet, add row by row.
template <bool kScatter>
__device__ __forceinline__ void add_rows(int* s_cnt, int n_nodes,
                                         const int (&node)[kSortUnroll],
                                         int (&place)[kSortUnroll]) {
  const int lane = threadIdx.x & 31;
  if (n_nodes > kFewNodes) {
#pragma unroll
    for (int u = 0; u < kSortUnroll; ++u)
      if (node[u] >= 0) place[u] = atomicAdd(s_cnt + node[u], 1);
    return;
  }
  // field k & 3 of word k >> 2: rows of node k; a warp holds at most 256
  const auto field = [](u64 low, u64 high, int k) {
    return static_cast<int>((k < 4 ? low : high) >> (16 * (k & 3))) & 0xffff;
  };
  u64 mine0 = 0, mine1 = 0;
#pragma unroll
  for (int u = 0; u < kSortUnroll; ++u) {
    if (node[u] < 0) continue;
    if (kScatter) place[u] = field(mine0, mine1, node[u]);   // this lane's earlier rows
    const u64 one = 1ull << (16 * (node[u] & 3));
    mine0 += node[u] < 4 ? one : 0;
    mine1 += node[u] < 4 ? 0 : one;
  }
  u64 upto0 = mine0, upto1 = mine1;         // inclusive over the lanes
  for (int o = 1; o < 32; o <<= 1) {
    const u64 up0 = __shfl_up_sync(0xffffffffu, upto0, o);
    const u64 up1 = __shfl_up_sync(0xffffffffu, upto1, o);
    if (lane >= o) {
      upto0 += up0;
      upto1 += up1;
    }
  }
  const u64 all0 = __shfl_sync(0xffffffffu, upto0, 31);
  const u64 all1 = __shfl_sync(0xffffffffu, upto1, 31);
  int first = 0;                            // lane k: node k's rows before the warp's
  if (lane < n_nodes) {
    const int rows = field(all0, all1, lane);
    if (rows) first = atomicAdd(s_cnt + lane, rows);
  }
  if (!kScatter) return;
#pragma unroll
  for (int u = 0; u < kSortUnroll; ++u) {
    const int of_node = __shfl_sync(0xffffffffu, first, node[u] < 0 ? 0 : node[u]);
    if (node[u] >= 0)
      place[u] += of_node + field(upto0 - mine0, upto1 - mine1, node[u]);
  }
}

// scratch plan: scales f64 [4] (g, h, then their inverses), items
// [max_items] int4 (node, first row, end row, slot or -1), slot_node
// [acc_slots], info {items, slots in use}
__global__ void __launch_bounds__(kSortThreads)
hist_group_kernel(const int* __restrict__ pos, int n,
                  const float* __restrict__ g, const float* __restrict__ h,
                  int n_nodes, int rows_per_item, int own_rows,
                  const float* __restrict__ bounds, int* __restrict__ rows,
                  double* __restrict__ scales, int4* __restrict__ items,
                  int* __restrict__ slot_node, int* __restrict__ info,
                  ulonglong2* __restrict__ acc, size_t acc_pairs) {
  if (blockIdx.x > 0) {                     // the zeroing blocks
    if (blockIdx.x == 1 && threadIdx.x < 2) {
      // once a call, for the other kernels, off this kernel's one long block
      const double scale = fixed_scale(bounds[threadIdx.x], n);
      scales[threadIdx.x] = scale;
      scales[2 + threadIdx.x] = 1.0 / scale;
    }
    const size_t stride = static_cast<size_t>(gridDim.x - 1) * blockDim.x;
    for (size_t i = static_cast<size_t>(blockIdx.x - 1) * blockDim.x + threadIdx.x;
         i < acc_pairs; i += stride)
      acc[i] = make_ulonglong2(0, 0);
    return;
  }
  extern __shared__ int s_cnt[];            // [n_nodes] counts, then cursors
  __shared__ long long s_total;
  __shared__ int4 s_split[kMaxSlots];       // a split node: rows, first item
  for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) s_cnt[i] = 0;
  __syncthreads();
  // every thread walks the same number of row slots, so the warp-wide
  // primitives below see whole warps; the first kSortUnroll * blockDim.x
  // rows' nodes stay in registers for the scatter (all of them at the
  // trainer's 7,809 rows: one multiprocessor reads pos, g and h once)
  const int chunk = kSortUnroll * blockDim.x;
  int kept_node[kSortUnroll], node[kSortUnroll], place[kSortUnroll];
  live_nodes(pos, n, g, h, n_nodes, 0, kept_node);
  add_rows<false>(s_cnt, n_nodes, kept_node, place);
  for (int first = chunk; first < n; first += chunk) {
    live_nodes(pos, n, g, h, n_nodes, first, node);
    add_rows<false>(s_cnt, n_nodes, node, place);
  }
  __syncthreads();

  // a run of nodes a thread; rows, items and slots before it in one scan:
  // rows in the high word, items (< 2^24) and slots (< 2^8) in the low
  const int per = (n_nodes + blockDim.x - 1) / blockDim.x;
  const int node0 = min(n_nodes, static_cast<int>(threadIdx.x) * per);
  const int node1 = min(n_nodes, node0 + per);
  long long mine = 0;
  for (int node = node0; node < node1; ++node) {
    const int c = s_cnt[node];
    const int n_items = c > own_rows ? (c + rows_per_item - 1) / rows_per_item : 1;
    mine += (static_cast<long long>(c) << 32) + (n_items << 8) + (c > own_rows);
  }
  const long long before = block_exclusive_scan(mine, &s_total);
  int start = static_cast<int>(before >> 32);
  int item = static_cast<int>(before & 0xffffffff) >> 8;
  int slot = static_cast<int>(before & 0xff);
  for (int node = node0; node < node1; ++node) {
    const int c = s_cnt[node];
    if (c > own_rows) {                     // its items: by all threads, below
      s_split[slot] = make_int4(node, start, start + c, item);
      slot_node[slot++] = node;
      item += (c + rows_per_item - 1) / rows_per_item;
    } else {
      items[item++] = make_int4(node, start, start + c, -1);
    }
    s_cnt[node] = start;
    start += c;
  }
  if (threadIdx.x == 0) {
    info[0] = static_cast<int>(s_total & 0xffffffff) >> 8;
    info[1] = static_cast<int>(s_total & 0xff);
  }
  __syncthreads();
  for (int k = 0; k < static_cast<int>(s_total & 0xff); ++k) {
    const int4 split = s_split[k];
    for (int j = threadIdx.x; split.y + j * rows_per_item < split.z; j += blockDim.x)
      items[split.w + j] =
          make_int4(split.x, split.y + j * rows_per_item,
                    min(split.y + (j + 1) * rows_per_item, split.z), k);
  }
  // the scatter: through shared memory where the rows fit there, so that
  // global memory is written in order (32 scattered 4-byte stores a warp
  // keep one multiprocessor busy for microseconds)
  const bool staged = n <= kSortStagedRows;
  int* ordered = staged ? s_cnt + n_nodes : rows;
  auto scatter = [&](const int (&nodes)[kSortUnroll], int first_row) {
    add_rows<true>(s_cnt, n_nodes, nodes, place);
#pragma unroll
    for (int u = 0; u < kSortUnroll; ++u)
      if (nodes[u] >= 0)
        ordered[place[u]] = first_row + u * blockDim.x + threadIdx.x;
  };
  scatter(kept_node, 0);
  for (int first = chunk; first < n; first += chunk) {
    live_nodes(pos, n, g, h, n_nodes, first, node);
    scatter(node, first);
  }
  if (!staged) return;
  __syncthreads();
  const int kept = static_cast<int>(s_total >> 32);
  for (int i = threadIdx.x; i < kept; i += blockDim.x) rows[i] = ordered[i];
}

// cell += v modulo 2^64 with two 32-bit atomics: the low word's old value
// tells whether this add carried, and the carries of all adds together are
// what the low words' sum carries, in any order.
__device__ __forceinline__ void shared_add64(u64* cell, long long value) {
  if (value == 0) return;
  unsigned* w = reinterpret_cast<unsigned*>(cell);
  const unsigned lo = static_cast<unsigned>(static_cast<u64>(value));
  unsigned hi = static_cast<unsigned>(static_cast<u64>(value) >> 32);
  if (lo) {
    const unsigned old = atomicAdd(w, lo);
    hi += (old + lo) < lo;
  }
  if (hi) atomicAdd(w + 1, hi);
}

__global__ void __launch_bounds__(kHistThreads)
level_hist_kernel(const uint8_t* __restrict__ xb, int F,
                  const float* __restrict__ g, const float* __restrict__ h,
                  const uint8_t* __restrict__ n_bins, int tile_shift,
                  const int* __restrict__ rows, const double* __restrict__ scales,
                  const int4* __restrict__ items, const int* __restrict__ info,
                  u64* __restrict__ acc, float2* __restrict__ out) {
  extern __shared__ u64 tile[];             // [occupied bin of the tile][g, h]
  __shared__ int s_off[33];                 // first tile bin of a feature
  __shared__ int s_nb[32];
  const int tile_feats = 1 << tile_shift;
  const int f0 = blockIdx.y * tile_feats;
  const int f_count = min(tile_feats, F - f0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // these loads are in flight at once; an item past the count is allocated
  const int4 item = items[blockIdx.x];
  const double sg = scales[0], sh = scales[1];
  int lane_nb = 0;
  if (warp == 0 && lane < f_count)
    lane_nb = n_bins ? min(static_cast<int>(n_bins[f0 + lane]), kBins) : kBins;
  if (static_cast<int>(blockIdx.x) >= info[0]) return;
  if (warp == 0) {
    int inc = lane_nb;
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += up;
    }
    s_nb[lane] = lane_nb;
    s_off[lane] = inc - lane_nb;
    if (lane == 31) s_off[32] = inc;
  }
  __syncthreads();
  const int cells = s_off[f_count];
  for (int i = threadIdx.x; i < 2 * cells; i += blockDim.x) tile[i] = 0;
  __syncthreads();

  // a lane keeps feature f for rows sub, sub + step, ... of the item, the
  // loads of kHistUnroll of them in flight together
  const int f = lane & (tile_feats - 1);
  const int rows_a_warp = 32 >> tile_shift;
  const int step = (blockDim.x >> 5) * rows_a_warp;
  if (f < f_count) {
    const int nb = s_nb[f];
    const bool few = nb <= kFewBins;
    u64* cell0 = tile + 2 * s_off[f];
    const uint8_t* col = xb + f0 + f;
    long long tg = 0, th = 0, g1 = 0, h1 = 0, g2 = 0, h2 = 0, g3 = 0, h3 = 0;
    for (int i0 = item.y + warp * rows_a_warp + (lane >> tile_shift); i0 < item.z;
         i0 += kHistUnroll * step) {
      int r[kHistUnroll], b[kHistUnroll];
      float gv[kHistUnroll], hv[kHistUnroll];
#pragma unroll
      for (int u = 0; u < kHistUnroll; ++u)
        r[u] = i0 + u * step < item.z ? rows[i0 + u * step] : -1;
#pragma unroll
      for (int u = 0; u < kHistUnroll; ++u) {
        b[u] = r[u] >= 0 ? col[static_cast<size_t>(r[u]) * F] : kBins;
        gv[u] = r[u] >= 0 ? g[r[u]] : 0.f;
        hv[u] = r[u] >= 0 ? h[r[u]] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kHistUnroll; ++u) {
        if (b[u] >= nb) continue;
        const long long qg = quantise(gv[u], sg), qh = quantise(hv[u], sh);
        if (few) {
          tg += qg;
          th += qh;
          if (b[u] == 1) { g1 += qg; h1 += qh; }
          if (b[u] == 2) { g2 += qg; h2 += qh; }
          if (b[u] == 3) { g3 += qg; h3 += qh; }
        } else {
          shared_add64(cell0 + 2 * b[u], qg);
          shared_add64(cell0 + 2 * b[u] + 1, qh);
        }
      }
    }
    if (few) {                              // bins past nb hold 0 and are skipped
      shared_add64(cell0, tg - g1 - g2 - g3);
      shared_add64(cell0 + 1, th - h1 - h2 - h3);
      shared_add64(cell0 + 2, g1);
      shared_add64(cell0 + 3, h1);
      shared_add64(cell0 + 4, g2);
      shared_add64(cell0 + 5, h2);
      shared_add64(cell0 + 6, g3);
      shared_add64(cell0 + 7, h3);
    }
  }
  __syncthreads();

  const size_t pair0 = (static_cast<size_t>(item.w < 0 ? item.x : item.w) * F + f0) * kBins;
  if (item.w < 0) {                         // the node is this block's: write out
    for (int i = threadIdx.x; i < f_count * kBins; i += blockDim.x) {
      const int tf = i / kBins, b = i % kBins;
      float2 v = make_float2(0.f, 0.f);
      if (b < s_nb[tf]) {
        const u64* cell = tile + 2 * (s_off[tf] + b);
        v.x = bin_value(static_cast<long long>(cell[0]), scales[2]);
        v.y = bin_value(static_cast<long long>(cell[1]), scales[3]);
      }
      out[pair0 + i] = v;
    }
  } else {                                  // a part of a split node
    for (int i = threadIdx.x; i < f_count * kBins; i += blockDim.x) {
      const int tf = i / kBins, b = i % kBins;
      if (b >= s_nb[tf]) continue;
      const u64* cell = tile + 2 * (s_off[tf] + b);
      if (cell[0]) atomicAdd(acc + 2 * (pair0 + i), cell[0]);
      if (cell[1]) atomicAdd(acc + 2 * (pair0 + i) + 1, cell[1]);
    }
  }
}

// grid (acc_slots, parts): the slots in use become their nodes' histograms
__global__ void hist_finish_kernel(const long long* __restrict__ acc, int F,
                                   const int* __restrict__ slot_node,
                                   const int* __restrict__ info,
                                   const double* __restrict__ scales,
                                   float* __restrict__ out) {
  if (static_cast<int>(blockIdx.x) >= info[1]) return;
  const double inverse_g = scales[2], inverse_h = scales[3];
  const size_t len = static_cast<size_t>(F) * kBins * 2;
  const long long* src = acc + blockIdx.x * len;
  float* dst = out + slot_node[blockIdx.x] * len;
  for (size_t i = blockIdx.y * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < len; i += static_cast<size_t>(gridDim.y) * blockDim.x)
    dst[i] = bin_value(src[i], (i & 1) ? inverse_h : inverse_g);
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
  return mine;                              // valid in warp 0
}

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

// A warp copies up to 8 features' bins into its stage: slice(s) is the 512 B of the feature for
// slot s (the lane-th float4 holds bins 2 * lane and 2 * lane + 1), or null
// for a slot that is not read.
template <typename Slice>
__device__ __forceinline__ void stage_copy(float* stage, int lane, Slice slice) {
#pragma unroll
  for (int s = 0; s < kGroupFeats; ++s) {
    const float4* src = slice(s);
    if (src)
      cp_async16(stage + (s * kChunks + lane / (kChunk / 2)) * kChunkStride +
                     (lane % (kChunk / 2)) * 4,
                 src + lane);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
}

// Lane 4 * s + k of a warp holds chunk k (16 bins) of the feature staged in
// slot s. Calls visit(b, gain, valid) for its bins in order. All 32 lanes
// must call it: the four lanes of a feature exchange their chunk totals,
// and the two divisions of a bin are skipped where no lane's bin is valid
// (deep levels: most bins hold less than min_child on one side).
// The sums are those of the plain version: sequential inside a chunk, the
// offset of the chunks before it added last, in chunk order.
template <typename Visit>
__device__ __forceinline__ void chunk_gains(const float* __restrict__ stage,
                                            float lam, float min_child,
                                            Visit visit) {
  const int lane = threadIdx.x & 31, k = lane & (kChunks - 1);
  const float2* bins = reinterpret_cast<const float2*>(stage + lane * kChunkStride);
  float rg[kChunk], rh[kChunk];
  float ag = 0.f, ah = 0.f;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const float2 v = bins[i];
    ag = i ? __fadd_rn(ag, v.x) : v.x;
    ah = i ? __fadd_rn(ah, v.y) : v.y;
    rg[i] = ag;
    rh[i] = ah;
  }
  float og = 0.f, oh = 0.f, my_og = 0.f, my_oh = 0.f, tg = 0.f, th = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const float cg = __shfl_sync(0xffffffffu, ag, (lane & ~(kChunks - 1)) + j);
    const float ch = __shfl_sync(0xffffffffu, ah, (lane & ~(kChunks - 1)) + j);
    if (j == k) {
      my_og = og;
      my_oh = oh;
    }
    if (j == kChunks - 1) {
      tg = __fadd_rn(cg, og);
      th = __fadd_rn(ch, oh);
    }
    og = __fadd_rn(og, cg);
    oh = __fadd_rn(oh, ch);
  }
  const float parent = __fdiv_rn(__fmul_rn(tg, tg), __fadd_rn(th, lam));
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const float gl = __fadd_rn(rg[i], my_og);
    const float hl = __fadd_rn(rh[i], my_oh);
    const float gr = __fsub_rn(tg, gl);
    const float hr = __fsub_rn(th, hl);
    const bool valid = hl >= min_child && hr >= min_child;
    float gain = 0.f;                         // read only where valid
    if (__any_sync(0xffffffffu, valid)) {
      const float left = __fdiv_rn(__fmul_rn(gl, gl), __fadd_rn(hl, lam));
      const float right = __fdiv_rn(__fmul_rn(gr, gr), __fadd_rn(hr, lam));
      gain = __fsub_rn(__fadd_rn(left, right), parent);
    }
    visit(k * kChunk + i, gain, valid);
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

// grid (nodes, blocks of kSplitFeats features). With one block a node the
// split is written; with more, each writes its best (gain, index) to
// cand_gain, cand_idx [node][block] for splits_pick_kernel.
__global__ void __launch_bounds__(kSplitThreads)
best_splits_kernel(const float4* __restrict__ hist, int F,
                   const bool* __restrict__ col_mask, float lam,
                   float min_child, float* __restrict__ cand_gain,
                   int* __restrict__ cand_idx, int* feat, int* bin,
                   bool* has_split) {
  __shared__ __align__(16) float stages[(kSplitThreads / 32) * kStageFloats];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* stage = stages + warp * kStageFloats;
  const int node = blockIdx.x;
  const int f_base = blockIdx.y * kSplitFeats + warp * kGroupFeats;
  stage_copy(stage, lane, [&](int s) -> const float4* {
    const int f = f_base + s;
    return f < F && col_mask[f]
               ? hist + (static_cast<size_t>(node) * F + f) * (kBins / 2)
               : nullptr;
  });
  const int f = f_base + lane / kChunks;
  const bool live = f < F && col_mask[f];       // else a stale stage slot
  // bins come in index order, so a later one wins only if it is larger, or
  // NaN where none was
  float best = -INFINITY;
  int best_bin = kBins;
  chunk_gains(stage, lam, min_child, [&](int b, float gain, bool valid) {
    const float c = valid ? gain : -INFINITY;
    if ((!(c <= best) && best == best) || best_bin == kBins) {
      best = c;
      best_bin = b;
    }
  });
  Best mine = live ? Best{best, f * kBins + best_bin} : Best{-INFINITY, 0x7fffffff};
  mine = block_best(mine);
  if (threadIdx.x != 0) return;
  if (gridDim.y == 1) {
    write_split(mine, node, feat, bin, has_split);
  } else {
    cand_gain[node * gridDim.y + blockIdx.y] = mine.gain;
    cand_idx[node * gridDim.y + blockIdx.y] = mine.idx;
  }
}

// a thread a node: the first-index maximum of its per_node candidates
__global__ void splits_pick_kernel(const float* __restrict__ cand_gain,
                                   const int* __restrict__ cand_idx,
                                   int per_node, int n_nodes, int* feat,
                                   int* bin, bool* has_split) {
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n_nodes) return;
  Best best{-INFINITY, 0x7fffffff};
  for (int i = node * per_node; i < (node + 1) * per_node; ++i)
    if (better(cand_gain[i], cand_idx[i], best.gain, best.idx))
      best = {cand_gain[i], cand_idx[i]};
  write_split(best, node, feat, bin, has_split);
}

// grid: groups of kOblFeats features; cand_gain, cand_idx [grid]
__global__ void __launch_bounds__(kOblThreads)
best_splits_oblivious_kernel(const float4* __restrict__ hist, int n_nodes, int F,
                             const bool* __restrict__ col_mask, float lam,
                             float min_child, float* __restrict__ cand_gain,
                             int* __restrict__ cand_idx) {
  extern __shared__ __align__(16) float stages[];   // the warps' stages, then gains
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* stage = stages + warp * kStageFloats;
  float* gains = stages + warps * kStageFloats;     // [run node][feature][bin]
  const int f0 = blockIdx.x * kOblFeats;
  const int my_f = f0 + threadIdx.x / kBins, my_b = threadIdx.x % kBins;
  float total = 0.f;
  bool any_valid = false;
  for (int run0 = 0; run0 < n_nodes; run0 += kOblRun) {
    const int run = min(kOblRun, n_nodes - run0);
    const int pairs = run * kOblFeats;      // pair = run node * kOblFeats + feature
    for (int p0 = warp * kGroupFeats; p0 < pairs; p0 += warps * kGroupFeats) {
      stage_copy(stage, lane, [&](int s) -> const float4* {
        const int p = p0 + s, f = f0 + p % kOblFeats;
        return p < pairs && f < F && col_mask[f]
                   ? hist + (static_cast<size_t>(run0 + p / kOblFeats) * F + f) * (kBins / 2)
                   : nullptr;
      });
      const int p = p0 + lane / kChunks, f = f0 + p % kOblFeats;
      const bool live = p < pairs && f < F && col_mask[f];
      float* dst = gains + static_cast<size_t>(p) * kBins;
      chunk_gains(stage, lam, min_child, [&](int b, float gain, bool valid) {
        // -0.0f: not valid here; it adds nothing to a sum that starts at +0
        if (p < pairs) dst[b] = valid && live ? (gain > 0.f ? gain : 0.f) : -0.f;
      });
      __syncwarp();                         // before the stage is filled again
    }
    __syncthreads();
    for (int node = 0; node < run; ++node) {        // node order, as the plain
      const float v = gains[(node * kOblFeats + threadIdx.x / kBins) * kBins + my_b];
      any_valid |= __float_as_uint(v) != 0x80000000u;
      total = __fadd_rn(total, v);
    }
    __syncthreads();
  }
  Best mine = my_f < F ? Best{any_valid ? total : -INFINITY, my_f * kBins + my_b}
                       : Best{-INFINITY, 0x7fffffff};
  mine = block_best(mine);
  if (threadIdx.x == 0) {
    cand_gain[blockIdx.x] = mine.gain;
    cand_idx[blockIdx.x] = mine.idx;
  }
}

__global__ void oblivious_pick_kernel(const float* __restrict__ cand_gain,
                                      const int* __restrict__ cand_idx,
                                      int n_cand, int n_nodes, int* feat,
                                      int* bin, bool* has_split) {
  __shared__ Best s_best;
  Best mine{-INFINITY, 0x7fffffff};
  for (int i = threadIdx.x; i < n_cand; i += blockDim.x)
    if (better(cand_gain[i], cand_idx[i], mine.gain, mine.idx))
      mine = {cand_gain[i], cand_idx[i]};
  mine = block_best(mine);
  if (threadIdx.x == 0) s_best = mine;
  __syncthreads();
  const Best best = s_best;
  for (int node = threadIdx.x; node < n_nodes; node += blockDim.x)
    write_split(best, node, feat, bin, has_split);
}

// ---- K5 ---------------------------------------------------------------------

// The next boosted tree's inputs and outputs (y null: there is none).
struct NextTree {
  const float* y;
  const float* u;                           // the tree's subsample draw
  const float* w;                           // row weights
  float subsample;
  int cls;
  float* g;
  float* h;
  unsigned* bounds;                         // (max |g|, max |h|) as float bits
};

// The next tree's (g, h) of a row from its updated margin, with the torch
// ops of the plain version: sigmoid as 1 / (1 + exp(-x)), the clamp that
// keeps a NaN, the subsample mask and the weight multiplied in that order.
__device__ __forceinline__ void next_gradient(float pred, float y, float u, float w,
                                              const NextTree& next, float* go,
                                              float* ho) {
  float gv, hv;
  if (next.cls) {
    const float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-pred)));
    gv = __fsub_rn(p, y);
    const float v = __fmul_rn(p, __fsub_rn(1.0f, p));
    hv = isnan(v) ? v : fmaxf(v, 1e-6f);
  } else {
    gv = __fsub_rn(pred, y);
    hv = 1.0f;
  }
  const float m = u < next.subsample ? 1.0f : 0.0f;
  *go = __fmul_rn(__fmul_rn(gv, m), w);
  *ho = __fmul_rn(__fmul_rn(hv, m), w);
}

// Arrives at the cluster barrier without ordering memory: for a block that
// has only finished reading other blocks' shared memory (the reads are
// complete: their values are used), so that they may exit once all have
// arrived. A release here waits for this block's stores to global memory.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One row's inputs, loaded together.
struct LeafRow {
  int p;
  float g, h, pred, y, u, w;
};

template <bool kNext>
__device__ __forceinline__ LeafRow load_leaf_row(int r, int n, const int* pos,
                                                 const float* g, const float* h,
                                                 const float* preds,
                                                 const NextTree& next) {
  LeafRow row{-1, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (r >= n) return row;
  row.p = pos[r];
  row.g = g[r];
  row.h = h[r];
  row.pred = preds[r];
  if (kNext) {
    row.y = next.y[r];
    row.u = next.u[r];
    row.w = next.w[r];
  }
  return row;
}

// K5: one cluster of 1 to 16 blocks, a row a thread (see K5 design).
template <bool kNext>
__global__ void __launch_bounds__(kLeafThreads, 1)
leaf_values_kernel(const int* __restrict__ pos, int n, const float* __restrict__ g,
                   const float* __restrict__ h, int n_leaves, float lam,
                   float scale, const float* __restrict__ bounds,
                   float* __restrict__ leaf, float* __restrict__ preds,
                   NextTree next) {
  extern __shared__ __align__(16) unsigned char leaf_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  const bool every = n_leaves * blocks <= 2 * static_cast<int>(blockDim.x);
  const int per = every ? n_leaves : (n_leaves + blocks - 1) / blocks;
  ulonglong2* sums = reinterpret_cast<ulonglong2*>(leaf_smem);  // [leaf] (g, h)
  ulonglong2* stage = sums + n_leaves;                           // [block][per]
  float* values = reinterpret_cast<float*>(stage + blocks * per);   // [leaf]
  __shared__ double s_scale[4];             // g, h, then their inverses
  __shared__ unsigned s_max[2];
  const int stride = blocks * blockDim.x;
  const int r0 = rank * blockDim.x + threadIdx.x;
  LEAF_CLOCK(0);
  // every load of the first row (at the trainer's sizes, every row) and
  // the bounds are in flight together, through the start-up and barriers
  const float bound = threadIdx.x < 2 ? bounds[threadIdx.x] : 0.f;
  const LeafRow first = load_leaf_row<kNext>(r0, n, pos, g, h, preds, next);
  for (int i = threadIdx.x; i < n_leaves; i += blockDim.x)
    sums[i] = make_ulonglong2(0, 0);
  if (threadIdx.x < 2) {
    const double sc = fixed_scale(bound, n);
    s_scale[threadIdx.x] = sc;
    s_scale[2 + threadIdx.x] = 1.0 / sc;   // a power of two: exact
    s_max[threadIdx.x] = 0;
    if (kNext && rank == 0) atomicExch(next.bounds + threadIdx.x, 0u);
  }
  __syncthreads();
  LEAF_CLOCK(1);                            // loads issued, table zeroed, scales
  const double sg = s_scale[0], sh = s_scale[1];
  for (int r = r0; r < n; r += stride) {    // this block's rows, its own table
    const LeafRow row = r == r0 ? first
                                : load_leaf_row<false>(r, n, pos, g, h, preds, next);
    if (row.p < 0 || row.p >= n_leaves) continue;
    shared_add64(&sums[row.p].x, quantise(row.g, sg));
    shared_add64(&sums[row.p].y, quantise(row.h, sh));
  }
  LEAF_CLOCK(2);                            // own rows into the block's table
  cluster.sync();
  LEAF_CLOCK(3);                            // cluster barrier

  const int own0 = every ? 0 : rank * per;
  const int owned = min(n_leaves, own0 + per) - own0;
  for (int t = threadIdx.x; t < blocks * per; t += blockDim.x) {
    const int b = t / per, li = t - b * per;
    if (li < owned) stage[t] = *cluster.map_shared_rank(sums + own0 + li, b);
  }
  LEAF_CLOCK(4);                            // tables copied into the stage
  __syncthreads();
  LEAF_CLOCK(5);                            // block barrier
  for (int li = threadIdx.x; li < owned; li += blockDim.x) {
    u64 gs = 0, hs = 0;
    for (int b = 0; b < blocks; ++b) {
      gs += stage[b * per + li].x;
      hs += stage[b * per + li].y;
    }
    const float gl = bin_value(static_cast<long long>(gs), s_scale[2]);
    const float hl = bin_value(static_cast<long long>(hs), s_scale[3]);
    const float v = __fdiv_rn(-gl, __fadd_rn(hl, lam));
    values[own0 + li] = v;
    if (!every || rank == 0) leaf[own0 + li] = v;
  }
  LEAF_CLOCK(6);                            // leaf values
  if (!every) {
    cluster.sync();
    for (int i = threadIdx.x; i < n_leaves; i += blockDim.x) {
      const int owner = i / per;
      if (owner != rank) values[i] = *cluster.map_shared_rank(values + i, owner);
    }
  }
  LEAF_CLOCK(7);                            // second barrier, owners' values
  cluster_arrive_relaxed();                 // no more reads of other blocks
  __syncthreads();
  LEAF_CLOCK(8);                            // arrive, block barrier

  unsigned max_g = 0, max_h = 0;
  for (int r = r0; r < n; r += stride) {
    const LeafRow row = r == r0 ? first
                                : load_leaf_row<kNext>(r, n, pos, g, h, preds, next);
    float pred = row.pred;
    if (row.p >= 0 && row.p < n_leaves) {   // one fused multiply-add, as the reference
      pred = __fmaf_rn(scale, values[row.p], pred);
      preds[r] = pred;
    }
    if (kNext) {
      float gn, hn;
      next_gradient(pred, row.y, row.u, row.w, next, &gn, &hn);
      next.g[r] = gn;
      next.h[r] = hn;
      // |v| >= 0: the integer order of the bits is the float order
      max_g = max(max_g, __float_as_uint(fabsf(gn)));
      max_h = max(max_h, __float_as_uint(fabsf(hn)));
    }
  }
  if (kNext) {
    max_g = __reduce_max_sync(0xffffffffu, max_g);
    max_h = __reduce_max_sync(0xffffffffu, max_h);
    if ((threadIdx.x & 31) == 0) {
      atomicMax(s_max, max_g);
      atomicMax(s_max + 1, max_h);
    }
    __syncthreads();
    if (threadIdx.x < 2) atomicMax(next.bounds + threadIdx.x, s_max[threadIdx.x]);
  }
  LEAF_CLOCK(9);                            // update, next gradients, bounds
  cluster_wait();                           // others may still read this block
  LEAF_CLOCK(10);                           // wait to exit
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

int sort_smem_raised = 0;
int oblivious_smem_raised = 0;
int leaf_smem_raised[2] = {0, 0};
bool leaf_wide_clusters[2] = {false, false};

}  // namespace

// Scratch, all from the wrapper: rows int32 [n]; plan: f64 [4], then int32
// [4 max_items + acc_slots + 2]; acc int64 [acc_slots * F * 128]. The
// plan's sizes follow from rows_per_item and own_rows: max_items = n_nodes +
// n / rows_per_item, acc_slots = min(n_nodes, n / (own_rows + 1)).
// n_bins is uint8 [F], the occupied bins of each feature, or null for 64.
extern "C" int bbbp_forest_level_histogram(const void* xb, int n, int F,
                                           const void* pos, const void* g,
                                           const void* h, int n_nodes,
                                           const void* bounds,
                                           const void* n_bins, int tile_feats,
                                           int threads, int rows_per_item,
                                           int own_rows, void* rows, void* plan,
                                           void* acc, void* out, void* stream) {
  if (n < 0 || F <= 0 || n_nodes <= 0 || n_nodes > kMaxSortNodes ||
      n / (own_rows + 1) > kMaxSlots ||
      rows_per_item <= 0 || own_rows < rows_per_item || threads < 32 ||
      threads > kHistThreads || threads % 32 ||
      (tile_feats != 8 && tile_feats != 16 && tile_feats != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int max_items = n_nodes + n / rows_per_item;
  const int by_rows = n / (own_rows + 1);
  const int acc_slots = n_nodes < by_rows ? n_nodes : by_rows;
  const size_t acc_pairs = static_cast<size_t>(acc_slots) * F * kBins;
  double* scales = static_cast<double*>(plan);
  int4* items = reinterpret_cast<int4*>(scales + 4);
  int* slot_node = reinterpret_cast<int*>(items + max_items);
  int* info = slot_node + acc_slots;
  const float* gp = static_cast<const float*>(g);
  const float* hp = static_cast<const float*>(h);
  const size_t zero_blocks = (acc_pairs + 4 * kSortThreads - 1) / (4 * kSortThreads);
  const int sort_smem = (n_nodes + (n <= kSortStagedRows ? n : 0)) *
                        static_cast<int>(sizeof(int));
  const cudaError_t err = shared_limit(
      reinterpret_cast<const void*>(hist_group_kernel), &sort_smem_raised, sort_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  hist_group_kernel<<<1 + static_cast<int>(zero_blocks < 1 ? 1 : (zero_blocks < 128 ? zero_blocks : 128)),
                      kSortThreads, sort_smem, s>>>(
      static_cast<const int*>(pos), n, gp, hp, n_nodes, rows_per_item, own_rows,
      static_cast<const float*>(bounds), static_cast<int*>(rows), scales, items,
      slot_node, info, static_cast<ulonglong2*>(acc), acc_pairs);
  const int tile_shift = tile_feats == 8 ? 3 : (tile_feats == 16 ? 4 : 5);
  const dim3 grid(max_items, (F + tile_feats - 1) / tile_feats);
  level_hist_kernel<<<grid, threads, tile_feats * kBins * 2 * sizeof(u64), s>>>(
      static_cast<const uint8_t*>(xb), F, gp, hp,
      static_cast<const uint8_t*>(n_bins), tile_shift,
      static_cast<const int*>(rows), scales, items, info,
      static_cast<u64*>(acc), static_cast<float2*>(out));
  if (acc_slots > 0)
    hist_finish_kernel<<<dim3(acc_slots, (F * kBins * 2 + 1023) / 1024), 256, 0, s>>>(
        static_cast<const long long*>(acc), F, slot_node, info, scales,
        static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// scratch: int32 [2 * n_cand] candidates: n_cand = ceil(F / 4) in oblivious
// mode, n_nodes * ceil(F / 64) per node when F > 64, else unused
extern "C" int bbbp_forest_best_splits(const void* hist, int n_nodes, int F,
                                       const void* col_mask, float lam,
                                       float min_child, int oblivious,
                                       void* scratch, void* feat, void* bin,
                                       void* has_split, void* stream) {
  if (n_nodes <= 0 || F <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* hp = static_cast<const float4*>(hist);
  const bool* mp = static_cast<const bool*>(col_mask);
  int* fp = static_cast<int*>(feat);
  int* bp = static_cast<int*>(bin);
  bool* sp = static_cast<bool*>(has_split);
  if (oblivious) {
    const int blocks = (F + kOblFeats - 1) / kOblFeats;
    const int smem = ((kOblThreads / 32) * kStageFloats +
                      kOblRun * kOblFeats * kBins) * static_cast<int>(sizeof(float));
    const cudaError_t err = shared_limit(
        reinterpret_cast<const void*>(best_splits_oblivious_kernel),
        &oblivious_smem_raised, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    float* cand_gain = static_cast<float*>(scratch);
    int* cand_idx = static_cast<int*>(scratch) + blocks;
    best_splits_oblivious_kernel<<<blocks, kOblThreads, smem, s>>>(
        hp, n_nodes, F, mp, lam, min_child, cand_gain, cand_idx);
    oblivious_pick_kernel<<<1, 256, 0, s>>>(cand_gain, cand_idx, blocks, n_nodes,
                                            fp, bp, sp);
  } else {
    const int per_node = (F + kSplitFeats - 1) / kSplitFeats;
    const int groups = (F + kGroupFeats - 1) / kGroupFeats;
    const int threads = per_node > 1 ? kSplitThreads : groups * 32;
    float* cand_gain = static_cast<float*>(scratch);
    int* cand_idx = static_cast<int*>(scratch) + n_nodes * per_node;
    best_splits_kernel<<<dim3(n_nodes, per_node), threads, 0, s>>>(
        hp, F, mp, lam, min_child, cand_gain, cand_idx, fp, bp, sp);
    if (per_node > 1)
      splits_pick_kernel<<<(n_nodes + 255) / 256, 256, 0, s>>>(
          cand_gain, cand_idx, per_node, n_nodes, fp, bp, sp);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5. The leaves of one tree and the margin update; with y, also the next
// tree's (g, h) and bounds. One launch: `cluster` blocks of kLeafThreads in
// one thread block cluster (at most 16).
extern "C" int bbbp_forest_leaf_values(const void* pos, int n, const void* g,
                                       const void* h, int n_leaves, float lam,
                                       float scale, const void* bounds,
                                       void* leaf, void* preds, const void* y,
                                       const void* u, const void* w_rows,
                                       float subsample, int cls, void* g_next,
                                       void* h_next, void* bounds_next,
                                       int cluster, void* stream) {
  if (n < 0 || n_leaves <= 0 || cluster < 1 || cluster > kLeafMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool with_next = y != nullptr;
  const NextTree next{static_cast<const float*>(y), static_cast<const float*>(u),
                      static_cast<const float*>(w_rows), subsample, cls,
                      static_cast<float*>(g_next), static_cast<float*>(h_next),
                      static_cast<unsigned*>(bounds_next)};
  const void* kernel = with_next
                           ? reinterpret_cast<const void*>(leaf_values_kernel<true>)
                           : reinterpret_cast<const void*>(leaf_values_kernel<false>);
  const int per = n_leaves * cluster <= 2 * kLeafThreads
                      ? n_leaves
                      : (n_leaves + cluster - 1) / cluster;
  const int smem = (n_leaves + cluster * per) * static_cast<int>(sizeof(ulonglong2)) +
                   n_leaves * static_cast<int>(sizeof(float));
  cudaError_t err = shared_limit(kernel, &leaf_smem_raised[with_next], smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cluster > 8 && !leaf_wide_clusters[with_next]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    leaf_wide_clusters[with_next] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kLeafThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int* pp = static_cast<const int*>(pos);
  const float* gp = static_cast<const float*>(g);
  const float* hp = static_cast<const float*>(h);
  const float* bp = static_cast<const float*>(bounds);
  float* lp = static_cast<float*>(leaf);
  float* predp = static_cast<float*>(preds);
  err = with_next
            ? cudaLaunchKernelEx(&cfg, leaf_values_kernel<true>, pp, n, gp, hp,
                                 n_leaves, lam, scale, bp, lp, predp, next)
            : cudaLaunchKernelEx(&cfg, leaf_values_kernel<false>, pp, n, gp, hp,
                                 n_leaves, lam, scale, bp, lp, predp, next);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
