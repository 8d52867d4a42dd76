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
// bbbp_forest_level_splits_lanes — replaces _grow_level (:154-231) under
//    jax.vmap, as bbbp_tpu/train/batched_search.py:340-344 runs it: one
//    level's split search over lanes, K3's sums and K4's per-node pick in
//    one pass, with no histogram in device memory (see its design below).
// bbbp_forest_level_splits_oblivious_lanes — the same for oblivious mode
//    (_grow_level(..., oblivious=True), :135-146): K3's sums and K4's
//    level-wide pick in one pass over the level's nodes in order.
// The routing of _fit_forest_device (:335-338), pos <- 2 * pos + (xb[row,
//    f[pos]] > b[pos]) for every row and the level's (feature, bin) pairs
//    into the tree's flat arrays, has no entry point of its own: the kernel
//    that next reads the positions routes them (see Routing design).
//
// Lanes. K3, K4 and K5 also run `lanes` fits of one shape over
// one binned matrix (the *_lanes entry points), as
// bbbp_tpu/train/batched_search.py::_forest_cv_vmapped runs them under
// jax.vmap (:340-344). The lane is one more grid dimension of the same
// kernel bodies. K3's and K5's bodies take a template flag that compiles the
// lane offsets out of the single fit's launch: compiled in, they made the
// single-fit K3 and K5 3-5% slower on an H100. A lane has its own
// pos, g, h, margins, bounds, scratch and, in K4 and K5, its lambda, scale
// and subsample rate; xb and y are every lane's. A lane's sums are the
// single launch's (integers, in any order), so a lane grows the trees of
// the single fit with the same draws bit for bit.
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
// Fused split search design (lanes, per-node mode). K3 then K4 with lanes
// hand over a dense [L, nodes, F, 64, 2] f32 histogram, written and read
// back: at rf's level 9 a node holds ~16 of 8,162 rows, so at most 480 of
// its 1,920 (feature, bin) cells are not zero, and 250 lanes move 2 GB each
// way a level. The reference never exposes it: _grow_level returns (feat,
// bin, has_split) a node. So the gains are taken where the sums lie.
// 1. hist_group_kernel, as K3: each lane's rows sorted by node, items
//    (node, row range) of at most own_rows rows, a split node's items with
//    an int64 accumulator slot, the lane's fixed-point scales.
// 2. level_splits_kernel: a unit is (item, group of 8 live features), a
//    warp a unit, a block of kSplitWarps warps walking `run` units a warp
//    (split_run in ops/forest_train.py: one unit while the units fill four
//    rounds of the card's warps, up to 8 where many small nodes would each
//    pay a block's start-up, zeroing its tiles). Timed by chip_smoke.py
//    phase 14 on an H100 80GB HBM3 at 700 W, n = 8,162, F = 30, levels
//    9 / 11: at 250 lanes 1.297 / 3.279 ms against 1.568 / 4.084 with one
//    unit a warp, at 15 lanes 0.098 / 0.211 against 0.103 / 0.248; at
//    levels 0 and 5 the runs (2-4 units at 250 lanes) are within 2% of one
//    unit. A node's groups run on as
//    many warps, so a large node is not one warp's serial work. The warp
//    sums its rows into its own tile of 8
//    features x 64 bins of int64 (g, h) in shared memory, K3's quantisation
//    and two-word atomics. A unit of an owned node rounds each non-zero bin
//    once to f32 (K3's value), in place: these are the only int64 -> f64
//    -> f32 conversions, which run on the slow double-precision unit. Then
//    K4's sums in K4's order
//    (lane 4s + k: chunk k of slot s, sequential inside the chunk, chunk
//    offsets last) and K4's gain with K4's rounded operations
//    (group_best): every bin of the chunk is summed, and the gain is taken
//    only at fresh bins: a bin whose left sums have the bits of the bin
//    before it has the same gain and validity, and the first index wins
//    ties, so it is never the pick (an empty bin adds +0, so it is such a
//    bin unless a sum of -0 becomes +0, and then it is fresh). Fresh bins
//    are queued in the tile and the warp's 32 lanes take them in turn.
//    The unit writes its first-index maximum (gain, f * 64 + b) as the
//    (node, group) candidate. A unit of a split node adds its non-zero
//    bins to the node's slot instead.
// 3. splits_finish_kernel: a block a slot in use takes those nodes' group
//    candidates from their int64 sums, with group_best.
// 4. splits_pick_kernel (K4's): a thread a node, the first-index maximum of
//    its group candidates; dead-node rule (feature 0, bin 63) where the gain
//    is not finite or not > 0. The candidates are fixed values, so the
//    result does not depend on the order in which units run.
// The candidates are 8 bytes a (node, group), the only output of step 2.
// Every value the pick sees is the one K4 computes from K3's histogram, so
// (feat, bin, has_split) equal K3 then K4 with lanes bit for bit.
// Oblivious mode sums a (feature, bin)'s gain over the level's nodes before
// its argmax, so its units cannot finish node by node: it has a fused form
// of its own (below).
// Tried on the card and dropped: a warp a whole node (slower at 15 lanes'
// shallow levels, where a level has too few nodes to fill the card, and
// wherever nodes were skewed, a large node being one warp's serial work),
// converting every bin, touched or not (the double-precision unit bound
// it), and a sparse form for nodes of few rows, which marked the bins its
// rows touched and walked only those (faster only at a level of even
// 8-row nodes that no tree of the search reaches, slower at level 8).
//
// Fused oblivious search design (lanes, oblivious mode: cat's search). K3
// then K4 with lanes hand over the dense [L, nodes, F, 64, 2] histogram (125
// MB at cat's level 5, 255 lanes), and K3's summation (a global int64
// accumulator for nodes of over 512 rows, atomics into it from every item,
// its zeroing and finish) costs as much as that traffic: 0.37 ms at level 0,
// where the histogram is 3.8 MB. The reference returns one (feat, bin,
// has_split) a lane. K4's oblivious body adds each node's masked gain to an
// f32 total per (feature, bin) in node order; the per-node bin sums are K3's
// integers, whose order never matters. So a block owns a (lane, group of
// features) for the whole level and walks the nodes in order:
// 1. hist_group_kernel, as K3, but with rows_per_item = own_rows = n: an
//    item a node (no node is cut, no accumulator, nothing to zero), each
//    node's rows contiguous in the lane's order.
// 2. oblivious_splits_kernel, runs of 2 or 4 nodes: a warp takes 32 rows,
//    each lane quantises one (once a row), then the warp adds them a step
//    at a time, lane l a (row, feature) pair, into column l of the run's
//    int64 sums, [node][word][bin][32 columns]: a warp's atomics meet 32
//    banks whatever their bins. Then K4's chunk sums and gains from each
//    bin's columns (one f32 rounding, K3's value) and K4's masked gain,
//    added by a thread a (bin, feature) to its running total in node order;
//    the block's first-index maximum is the group's candidate. No histogram
//    leaves shared memory.
// 3. oblivious_pick_kernel (K4's): a lane's first-index maximum over its
//    groups, the dead-level rule, the split written to every node.
// Each total is K4's sum, in K4's order, of K4's values on K3's histogram,
// so the splits equal K3 then K4 with lanes bit for bit in every form. The
// forms: 32 features a block (a row a warp step), 512 threads, runs of 2,
// where lanes x groups fill the card's SMs; else 8 features a block (4 rows
// a step, a feature's sums in 4 columns), in blocks of 1,024 threads and
// runs of 4 where those blocks do not fill it either.
// What bounds it. The bytes (xb once, each lane's rows) are 7.4 us a level
// at L = 250; K4's operations at every (node, feature, bin) pass them from
// level 6. The summation is four 32-bit shared atomics a (row, feature):
// torch_rate_profile.py measured them on an H100 80GB HBM3 (700 W) at 32 a
// clock an SM to conflict-free banks (8.4e12 a second) and 9.1 at random
// ones (a 64-bit shared atomic add is a compare-and-swap loop, 1.2), so
// their floor is about 23 us a level at L = 250 (6,530 rows of weight not 0
// a lane, 30 features). Timed by chip_smoke.py phase 14 on that card, n =
// 8,162, F = 30, against K3 + K4 with lanes in the same call: L = 250,
// levels 0-5, 0.197 / 0.201 / 0.217 / 0.247 / 0.288 / 0.373 ms against
// 0.422 / 0.440 / 0.449 / 0.485 / 0.537 / 0.546; levels 9 / 11 4.33 / 11.5
// against 3.35 / 9.49. L = 15 (8 features a block): levels 0-2 0.045-0.048
// against 0.049-0.050, slower from level 3 (0.062 against 0.051, level 5
// 0.130 against 0.058, level 9 1.73 against 0.45). Past a few nodes a run
// the walk is a chain of dependent round trips (the run's rows, their bins,
// the atomics' low words) a run, and each node's bins are all rounded and
// gained. So fit_forest_lanes cuts over to K3 then K4 with lanes from the
// first level where they are faster (ops/forest_train.py's
// OBLIVIOUS_FUSED_LEVELS, by form and blocks an SM).
// torch_oblivious_profile.py on that card over real oblivious trees of the search's rows (n = 8,162,
// F = 30; ms, fused / two kernels): L = 10 (form 2) slower from level 0,
// 0.045 / 0.041; L = 15 levels 0-2 0.046 / 0.050, level 3 0.056 / 0.050;
// L = 33 level 3 0.057 / 0.079, level 4 0.087 / 0.082; L = 34 (form 1)
// level 1 0.070 / 0.074, level 2 0.081 / 0.076; L = 80 levels 2 / 3
// 0.124 / 0.146, 0.168 / 0.156; L = 131 levels 3 / 4 0.207 / 0.248, 0.306 /
// 0.278; L = 132 (form 0) levels 4 / 5 0.236 / 0.279, 0.341 / 0.322;
// L = 250 levels 5 / 6 0.415 / 0.585, 0.661 / 0.656; L = 255 levels 6 / 7
// 0.664 / 0.670, 1.145 / 1.000; level 11 at L = 250 10.0 / 9.2. Cat's
// tuned group (255 lanes, depth 6) keeps the fused search at every level;
// phase 14's 10-lane cat search takes the two kernels at every level.
// Tried on the card and dropped, each slower at L = 250, levels 0-5: a
// compact tile (a cell a bin, the atomics meeting banks at random) with 1
// to 32 features a block and runs of up to 48 (node, feature) pairs; the
// same with the columns of a dense tile summed into a stage of K4's layout
// (much slower at deep levels); staging a chunk's rows in shared memory
// before its pairs; 4 or 8 pairs' loads a thread in flight; the run's rows
// by shuffles rather than shared memory. No faster, so dropped too: the next
// batch's rows and their g, h loaded while a batch adds; 32-feature blocks
// of 1,024 threads and runs of 4 nodes from level 3.

// Routing design. The reference routes a level's rows in a step of its own
// (_fit_forest_device, :335-338). As a kernel of its own (PR 14) it moved 9
// bytes a row and took 1.5 us for one fit, 2.0 us at 15 lanes: a launch, a
// table load and two dependent round trips, far from its bound however it
// was written. So it has no launch: the kernel that next reads the
// positions routes them as it reads them.
// - Levels >= 1: hist_group_kernel<kLanes, kRoute = true> (K3's sort and the
//   fused search's, one fit and lanes) stages the parent level's table in
//   shared memory, one int a node (pack_split: a row takes its split in one
//   shared load), while its first rows' positions are in flight; then the
//   xb loads of kSortUnroll rows go out with their g and h, each row is
//   routed (weight 0 too: K5 moves their margins), pos is written back and
//   the child counted. Past kSortUnroll * blockDim.x rows the scatter pass
//   reads the routed pos (the thread's own writes) and does not route again.
//   Block 1, which takes the scales, writes the table into the tree. The
//   unrouted sort is its own instantiation: the block runs at its
//   64-register limit, and routing's registers in one body spilled both.
// - After the last level, K5 routes each row as it loads it (both forms)
//   and does not write pos back, as no one reads it; rank 0 (or the lane's
//   block) writes the table into the tree.
// - A level of one node, or the children of one, reads no positions: every
//   row is at 0, so a fit never resets pos between trees.
// Measured by torch_route_leaf_profile.py against PR 15's build in one call
// (H100 80GB HBM3, 700 W, n = 7,809 / 8,162, F = 30): the sort with routing
// against PR 15's sort alone plus its routing kernel (1.5 us one fit, 2.0-2.8
// at 15 lanes, 8.9-14.9 at 250), one fit, levels 1-5: +0.4 to +0.8 us a
// level; 15 lanes +0.4 to +0.9 us; 250 lanes 3.0 to 5.8 us less; K5 with
// routing +0.5 us over PR 15's K5, which saves the last level's launch. The
// device time is about what it was; a fit issues one launch call a level
// fewer and no zeroing of pos a tree. Past 8,192 rows each chunk of the sort
// adds a round trip (9-14 us a level at 65,536 rows, chip_smoke.py phase 5).

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
//
// K5 with lanes design. The cluster form above gives every lane the single
// fit's cluster of leaf_plan(n) blocks of 1,024 threads (8 at 8,162 rows)
// and its chain of cluster barriers. At 64 registers a thread one block
// fills an SM, so one wave of the card holds about 16 such clusters: 250
// lanes ran as ~15 waves of a latency chain, 0.0909 ms at 64 leaves with the next
// tree, while their work is bandwidth-sized (73.6 MB, 0.022 ms at the
// memory rate). So leaf_values asks the card how many clusters one wave
// holds (cudaOccupancyMaxActiveClusters) and takes the largest cluster of
// leaf_plan(n), leaf_plan(n) / 2, ... 2 blocks of which one wave holds every
// lane's; where none does, one block a lane (leaf_values_block_kernel): no
// cluster barrier and no distributed shared memory. The block walks its
// lane's rows kLeafUnroll rows a thread at a time (all their loads in
// flight), sums them into its own table with the two-word atomics, takes
// the leaves, and walks the rows again for the update and the next tree's
// gradients; 1,024 threads where one wave holds the lanes' blocks
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), else 512, two an SM.
// The sums are integers, so every shape gives the same bits.
// Timed by torch_route_leaf_profile.py against PR 15's build in one call
// (chip_smoke.py phase 14 times both shapes) on an H100 80GB HBM3 at 700 W,
// n = 8,162, 64 / 1,024 leaves, the next tree and routing: L = 250 the chosen
// block a lane 0.0424 / 0.0444 ms against PR 15's cluster form 0.0909 /
// 0.1207 (bound 0.0221 / 0.0229); L = 100 0.0182 / 0.0188 against 0.0347 /
// 0.0464; L = 50 a cluster of 2 blocks 0.0118 / 0.0131 against 0.0198 /
// 0.0266; L = 15 the cluster of 8, 0.0066 / 0.0083 against 0.0060 / 0.0076
// (the routing's round trip).
// Tried on the card and dropped: a warp's rows of one leaf summed before the
// atomics (__match_any_sync and a shuffle tree over the peers: slower at 64
// and 1,024 leaves, where a warp's 32 rows in row order seldom share a
// leaf), blocks of 256 threads, blocks at 32 registers (spilling the next
// tree's loads), and a cluster of one block in place of the block form
// (slower at 250 lanes). For the routing, reading the routed bins from a
// copy of xb's columns [F, n] made once a fit was no faster, in the sort or
// in K5.

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
constexpr int kLeafUnroll = 4;              // rows a thread has in flight, a block a lane
constexpr int kRouteMaxNodes = 2048;        // a level of a depth-12 tree
constexpr int kMaxLanes = 65535;            // a grid's y and z extent
constexpr int kSplitWarps = 8;              // warps a block, fused split search
constexpr int kSplitBlocks = 3;             // blocks an SM, for the registers
constexpr int kSplitUnroll = 4;             // (row, feature) pairs a lane has in flight
constexpr int kTileChunk = kChunk + 1;      // cells a chunk's row of a tile, padded
constexpr int kWarpTile = 32 * kTileChunk;  // cells of a warp's tile: 8 features
constexpr int kMaxSplitFeats = 8192;
constexpr int kObsFeats = 32;               // fused oblivious search: features
                                            // a block, a warp lane each
constexpr int kObsMaxRun = 4;               // nodes a run (32 KB of sums each)
constexpr int kObsUnroll = 4;               // rows a warp adds together
constexpr int kObsHalf = 16;                // rows whose bins a warp loads together
constexpr int kObsNodeWords = 4 * kBins * kObsFeats;   // a node's sums

typedef unsigned long long u64;

// p moved by `bytes`: a lane's part of a buffer laid out lane after lane.
template <typename T>
__device__ __forceinline__ T* shift(T* p, size_t bytes) {
  return reinterpret_cast<T*>(reinterpret_cast<uintptr_t>(p) + bytes);
}

// The parent level's splits, routed by the kernel that next reads the
// positions (see Routing design). nodes 0: no routing, pos holds the level's
// positions as they are.
struct Route {
  const uint8_t* xb;   // [n, F]
  int F;
  const int* f;        // [lanes][nodes]: the parent level's features
  const int* b;        // and bins
  int nodes;
  int* feats;          // the tree's flat arrays at the parent level's first
  int* bins;           // node, lane after lane at tree_lane
  size_t tree_lane;
};

// A node's split as the routing reads it from shared memory, one int:
// feature << 9 | (bin + 1), the bin clamped to [-1, 255] (the same compare
// for every uint8 bin), so that a row takes its node's split in one load.
constexpr int kSplitBinBits = 9;
constexpr int kRouteMaxFeats = 1 << (31 - kSplitBinBits);

__device__ __forceinline__ int pack_split(int f, int b) {
  return (f << kSplitBinBits) | (min(max(b, -1), 255) + 1);
}

// The child of parent p for a row whose bin of the split's feature is x.
__device__ __forceinline__ int child_of(int p, int split, int x) {
  return 2 * p + (x > (split & ((1 << kSplitBinBits) - 1)) - 1);
}

// Row r's bin of the split's feature.
__device__ __forceinline__ int split_bin(const Route& r, int row, int split) {
  return r.xb[static_cast<size_t>(row) * r.F + (split >> kSplitBinBits)];
}

// A lane's part of a Route.
__device__ __forceinline__ Route lane_route(Route r, size_t fit) {
  r.f += fit * r.nodes;
  r.b += fit * r.nodes;
  r.feats += fit * r.tree_lane;
  r.bins += fit * r.tree_lane;
  return r;
}

// The parent level's table into shared memory (pack_split a node), and, by
// the block that `writes`, into the tree's flat arrays.
__device__ __forceinline__ void stage_route(const Route& r, int* table, bool writes) {
  for (int i = threadIdx.x; i < r.nodes; i += blockDim.x) {
    const int f = r.f[i], b = r.b[i];
    table[i] = pack_split(f, b);
    if (writes) {
      r.feats[i] = f;
      r.bins[i] = b;
    }
  }
}

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

// The positions of the sort block's rows first + u * blockDim.x +
// threadIdx.x, u < kSortUnroll (the parent level's, with routing): read only
// where they can be other than 0 (`read`: more than one node); 0 past n.
__device__ __forceinline__ void load_positions(const int* pos, bool read, int n, int first,
                                               int (&p)[kSortUnroll]) {
#pragma unroll
  for (int u = 0; u < kSortUnroll; ++u) {
    const int r = first + u * blockDim.x + threadIdx.x;
    p[u] = r < n && read ? pos[r] : 0;
  }
}

// The nodes of those rows from their positions p: -1 for a row of weight 0
// (g = h = 0, as subsampling leaves them), a row outside the level or a
// slot past n. With kRoute, each row is first routed by the parent level's
// table (shared memory, pack_split a node), p <- 2 p + (xb[r, f[p]] > b[p]),
// and the routed position written back to pos, weight 0 or not (K5 moves
// every row's margin). The g, h and xb loads of all kSortUnroll rows are in
// flight together; a row's split is read from the table again for its
// child rather than held (the block runs at its 64-register limit).
template <bool kRoute>
__device__ __forceinline__ void live_nodes(int (&p)[kSortUnroll], int* pos, int n,
                                           const float* __restrict__ g,
                                           const float* __restrict__ h, int n_nodes,
                                           int first, const int* table, const Route& rt,
                                           int (&node)[kSortUnroll]) {
  int x[kSortUnroll];
  float gv[kSortUnroll], hv[kSortUnroll];
#pragma unroll
  for (int u = 0; u < kSortUnroll; ++u) {
    const int r = first + u * blockDim.x + threadIdx.x;
    if (kRoute) x[u] = r < n ? split_bin(rt, r, table[p[u]]) : 0;
    gv[u] = r < n ? g[r] : 0.f;
    hv[u] = r < n ? h[r] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kSortUnroll; ++u) {
    const int r = first + u * blockDim.x + threadIdx.x;
    if (kRoute && r < n) {
      p[u] = child_of(p[u], table[p[u]], x[u]);
      pos[r] = p[u];
    }
    node[u] = r >= n || p[u] >= n_nodes || (gv[u] == 0.f && hv[u] == 0.f) ? -1 : p[u];
  }
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
// [acc_slots], info {items, slots in use}. blockIdx.y is the lane: its rows
// lie at lane * n, its bounds at 2 * lane and its scratch at lane *
// lane_bytes from lane 0's. kLanes false is the single fit's launch, with
// no lane offsets compiled in (one body, as before the lane axis). With a
// parent table (kRoute, route.nodes > 0) pos holds the parent level's
// positions and the sort block routes them in place; block 1 writes the
// table into the tree.
template <bool kLanes, bool kRoute>
__global__ void __launch_bounds__(kSortThreads)
hist_group_kernel(int* __restrict__ pos, int n,
                  const float* __restrict__ g, const float* __restrict__ h,
                  int n_nodes, int rows_per_item, int own_rows,
                  const float* __restrict__ bounds, int* __restrict__ rows,
                  double* __restrict__ scales, int4* __restrict__ items,
                  int* __restrict__ slot_node, int* __restrict__ info,
                  ulonglong2* __restrict__ acc, size_t acc_pairs,
                  size_t lane_bytes, Route route) {
  if (kLanes) {
    const size_t fit = blockIdx.y, at = fit * lane_bytes;
    pos += fit * n;
    g += fit * n;
    h += fit * n;
    bounds += 2 * fit;
    rows = shift(rows, at);
    scales = shift(scales, at);
    items = shift(items, at);
    slot_node = shift(slot_node, at);
    info = shift(info, at);
    acc = shift(acc, at);
    route = lane_route(route, fit);
  }
  if (blockIdx.x > 0) {                     // the zeroing blocks
    if (blockIdx.x == 1) {
      // once a call, for the other kernels, off this kernel's one long block
      if (threadIdx.x < 2) {
        const double scale = fixed_scale(bounds[threadIdx.x], n);
        scales[threadIdx.x] = scale;
        scales[2 + threadIdx.x] = 1.0 / scale;
      }
      for (int i = threadIdx.x; i < route.nodes; i += blockDim.x) {
        route.feats[i] = route.f[i];
        route.bins[i] = route.b[i];
      }
    }
    const size_t stride = static_cast<size_t>(gridDim.x - 1) * blockDim.x;
    for (size_t i = static_cast<size_t>(blockIdx.x - 1) * blockDim.x + threadIdx.x;
         i < acc_pairs; i += stride)
      acc[i] = make_ulonglong2(0, 0);
    return;
  }
  extern __shared__ int s_route[];          // [route.nodes], then s_cnt
  int* s_cnt = s_route + (kRoute ? route.nodes : 0);   // [n_nodes] counts, then cursors
  __shared__ long long s_total;
  __shared__ int4 s_split[kMaxSlots];       // a split node: rows, first item
  // every thread walks the same number of row slots, so the warp-wide
  // primitives below see whole warps; the first kSortUnroll * blockDim.x
  // rows' nodes stay in registers for the scatter (all of them at the
  // trainer's 7,809 rows: one multiprocessor reads pos, g and h once). With
  // routing the first rows' positions are in flight while the table is
  // staged; a level of one node (or the children of one) reads none.
  const int chunk = kSortUnroll * blockDim.x;
  const bool read = (kRoute ? route.nodes : n_nodes) > 1;
  int kept_node[kSortUnroll], node[kSortUnroll], place[kSortUnroll], p[kSortUnroll];
  if (kRoute) {
    load_positions(pos, read, n, 0, p);
    stage_route(route, s_route, false);
  }
  for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) s_cnt[i] = 0;
  __syncthreads();
  if (!kRoute) load_positions(pos, read, n, 0, p);
  live_nodes<kRoute>(p, pos, n, g, h, n_nodes, 0, s_route, route, kept_node);
  add_rows<false>(s_cnt, n_nodes, kept_node, place);
  for (int first = chunk; first < n; first += chunk) {
    load_positions(pos, read, n, first, p);
    live_nodes<kRoute>(p, pos, n, g, h, n_nodes, first, s_route, route, node);
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
    // the rows past the first chunk again, at the positions routed above
    // (this thread's own writes)
    load_positions(pos, n_nodes > 1, n, first, p);
    live_nodes<false>(p, pos, n, g, h, n_nodes, first, s_route, route, node);
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

// grid (items, feature tiles, lanes); xb and n_bins are every lane's, the
// rest lane after lane as in hist_group_kernel, out [lane][node][f][b]
template <bool kLanes>
__global__ void __launch_bounds__(kHistThreads)
level_hist_kernel(const uint8_t* __restrict__ xb, int n, int F,
                  const float* __restrict__ g, const float* __restrict__ h,
                  const uint8_t* __restrict__ n_bins, int tile_shift,
                  const int* __restrict__ rows, const double* __restrict__ scales,
                  const int4* __restrict__ items, const int* __restrict__ info,
                  u64* __restrict__ acc, float2* __restrict__ out,
                  size_t lane_bytes, size_t out_lane) {
  if (kLanes) {
    const size_t fit = blockIdx.z, at = fit * lane_bytes;
    g += fit * n;
    h += fit * n;
    rows = shift(rows, at);
    scales = shift(scales, at);
    items = shift(items, at);
    info = shift(info, at);
    acc = shift(acc, at);
    out += fit * out_lane;
  }
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

// grid (acc_slots, parts, lanes): the slots in use become their nodes'
// histograms
template <bool kLanes>
__global__ void hist_finish_kernel(const long long* __restrict__ acc, int F,
                                   const int* __restrict__ slot_node,
                                   const int* __restrict__ info,
                                   const double* __restrict__ scales,
                                   float* __restrict__ out, size_t lane_bytes,
                                   size_t out_lane) {
  if (kLanes) {
    const size_t fit = blockIdx.z, at = fit * lane_bytes;
    acc = shift(acc, at);
    slot_node = shift(slot_node, at);
    info = shift(info, at);
    scales = shift(scales, at);
    out += fit * out_lane * 2;
  }
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

// the warp's best, in every lane
__device__ __forceinline__ Best warp_best(Best mine) {
  for (int o = 16; o > 0; o >>= 1) {
    const float og = __shfl_xor_sync(0xffffffffu, mine.gain, o);
    const int oi = __shfl_xor_sync(0xffffffffu, mine.idx, o);
    if (better(og, oi, mine.gain, mine.idx)) mine = {og, oi};
  }
  return mine;
}

__device__ Best block_best(Best mine) {
  __shared__ float s_gain[32];
  __shared__ int s_idx[32];
  mine = warp_best(mine);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_gain[warp] = mine.gain;
    s_idx[warp] = mine.idx;
  }
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    mine = warp_best(lane < warps ? Best{s_gain[lane], s_idx[lane]}
                                  : Best{-INFINITY, 0x7fffffff});
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

// The bin sums of one 16-bin chunk, K4's order: lane 4 * s + k holds chunk k
// of feature slot s; bin(i) gives its bin i as f32 (g, h). rg, rh: the
// running sums inside the chunk, sequential; og, oh: the chunks before it,
// added in chunk order; tg, th the feature's totals and parent its term.
// All 32 lanes must call it: the four lanes of a feature exchange their chunk
// totals by shuffle.
struct ChunkOffsets {
  float og, oh, tg, th, parent;
};

struct ChunkSums : ChunkOffsets {
  float rg[kChunk], rh[kChunk];
};

// K4's chunk offsets from each lane's chunk totals (ag, ah): og, oh the
// chunks before the lane's, in chunk order; tg, th the feature's totals and
// parent its term.
__device__ __forceinline__ void chunk_offsets(float ag, float ah, float lam,
                                              ChunkOffsets& c) {
  const int lane = threadIdx.x & 31, k = lane & (kChunks - 1);
  float og = 0.f, oh = 0.f;
  c.og = c.oh = c.tg = c.th = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const float cg = __shfl_sync(0xffffffffu, ag, (lane & ~(kChunks - 1)) + j);
    const float ch = __shfl_sync(0xffffffffu, ah, (lane & ~(kChunks - 1)) + j);
    if (j == k) {
      c.og = og;
      c.oh = oh;
    }
    if (j == kChunks - 1) {
      c.tg = __fadd_rn(cg, og);
      c.th = __fadd_rn(ch, oh);
    }
    og = __fadd_rn(og, cg);
    oh = __fadd_rn(oh, ch);
  }
  c.parent = __fdiv_rn(__fmul_rn(c.tg, c.tg), __fadd_rn(c.th, lam));
}

template <typename Bin>
__device__ __forceinline__ void chunk_sums(Bin bin, float lam, ChunkSums& c) {
  float ag = 0.f, ah = 0.f;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const float2 v = bin(i);
    ag = i ? __fadd_rn(ag, v.x) : v.x;
    ah = i ? __fadd_rn(ah, v.y) : v.y;
    c.rg[i] = ag;
    c.rh[i] = ah;
  }
  chunk_offsets(ag, ah, lam, c);
}

// The XGBoost gain of a split with left sums (gl, hl) and right (gr, hr).
__device__ __forceinline__ float split_gain(float gl, float hl, float gr, float hr,
                                            float parent, float lam) {
  const float left = __fdiv_rn(__fmul_rn(gl, gl), __fadd_rn(hl, lam));
  const float right = __fdiv_rn(__fmul_rn(gr, gr), __fadd_rn(hr, lam));
  return __fsub_rn(__fadd_rn(left, right), parent);
}

// Lane 4 * s + k of a warp holds chunk k (16 bins) of the feature staged in
// slot s. Calls visit(b, gain, valid) for its bins in order. All 32 lanes
// must call it, and the two divisions of a bin are skipped where no lane's
// bin is valid (deep levels: most bins hold less than min_child on one side).
// The sums are those of the plain version: sequential inside a chunk, the
// offset of the chunks before it added last, in chunk order.
template <typename Visit>
__device__ __forceinline__ void chunk_gains(const float* __restrict__ stage,
                                            float lam, float min_child,
                                            Visit visit) {
  const int k = threadIdx.x & (kChunks - 1);
  const float2* bins = reinterpret_cast<const float2*>(
      stage + (threadIdx.x & 31) * kChunkStride);
  ChunkSums c;
  chunk_sums([&](int i) { return bins[i]; }, lam, c);
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const float gl = __fadd_rn(c.rg[i], c.og);
    const float hl = __fadd_rn(c.rh[i], c.oh);
    const float gr = __fsub_rn(c.tg, gl);
    const float hr = __fsub_rn(c.th, hl);
    const bool valid = hl >= min_child && hr >= min_child;
    float gain = 0.f;                         // read only where valid
    if (__any_sync(0xffffffffu, valid)) gain = split_gain(gl, hl, gr, hr, c.parent, lam);
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

// grid (nodes, blocks of kSplitFeats features, lanes). With one block a
// node the split is written; with more, each writes its best (gain, index)
// to cand_gain, cand_idx [node][block] for splits_pick_kernel. Lane l
// reads hist, col_mask [l], lams[l] (when given, else lam) and writes its
// candidates at l * cand_lane and its splits at l * nodes.
__global__ void __launch_bounds__(kSplitThreads)
best_splits_kernel(const float4* __restrict__ hist, int F,
                   const bool* __restrict__ col_mask, float lam,
                   const float* __restrict__ lams, float min_child,
                   float* __restrict__ cand_gain, int* __restrict__ cand_idx,
                   size_t cand_lane, int* feat, int* bin, bool* has_split) {
  __shared__ __align__(16) float stages[(kSplitThreads / 32) * kStageFloats];
  const size_t fit = blockIdx.z, nodes = gridDim.x;
  hist += fit * nodes * F * (kBins / 2);
  col_mask += fit * F;
  if (lams) lam = lams[fit];
  cand_gain += fit * cand_lane;
  cand_idx += fit * cand_lane;
  feat += fit * nodes;
  bin += fit * nodes;
  has_split += fit * nodes;
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

// a thread a node: the first-index maximum of its per_node candidates;
// blockIdx.y is the lane
__global__ void splits_pick_kernel(const float* __restrict__ cand_gain,
                                   const int* __restrict__ cand_idx,
                                   size_t cand_lane, int per_node, int n_nodes,
                                   int* feat, int* bin, bool* has_split) {
  const size_t fit = blockIdx.y;
  cand_gain += fit * cand_lane;
  cand_idx += fit * cand_lane;
  feat += fit * n_nodes;
  bin += fit * n_nodes;
  has_split += fit * n_nodes;
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n_nodes) return;
  Best best{-INFINITY, 0x7fffffff};
  for (int i = node * per_node; i < (node + 1) * per_node; ++i)
    if (better(cand_gain[i], cand_idx[i], best.gain, best.idx))
      best = {cand_gain[i], cand_idx[i]};
  write_split(best, node, feat, bin, has_split);
}

// grid (groups of kOblFeats features, lanes); cand_gain, cand_idx [grid.x]
// of each lane at lane * cand_lane
__global__ void __launch_bounds__(kOblThreads)
best_splits_oblivious_kernel(const float4* __restrict__ hist, int n_nodes, int F,
                             const bool* __restrict__ col_mask, float lam,
                             const float* __restrict__ lams, float min_child,
                             float* __restrict__ cand_gain,
                             int* __restrict__ cand_idx, size_t cand_lane) {
  const size_t fit = blockIdx.y;
  hist += fit * n_nodes * F * (kBins / 2);
  col_mask += fit * F;
  if (lams) lam = lams[fit];
  cand_gain += fit * cand_lane;
  cand_idx += fit * cand_lane;
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

// a block a lane
__global__ void oblivious_pick_kernel(const float* __restrict__ cand_gain,
                                      const int* __restrict__ cand_idx,
                                      size_t cand_lane, int n_cand, int n_nodes,
                                      int* feat, int* bin, bool* has_split) {
  const size_t fit = blockIdx.x;
  cand_gain += fit * cand_lane;
  cand_idx += fit * cand_lane;
  feat += fit * n_nodes;
  bin += fit * n_nodes;
  has_split += fit * n_nodes;
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

// ---- the fused split search over lanes -------------------------------------

// A fresh bin waiting for its gain (see the fused search's design): its left
// sums, f * 64 + b, and its feature's slot in the warp's group.
struct Fresh {
  float gl, hl;
  int idx, slot;
};

// Cell of (feature slot s, bin b) in a warp's tile: chunk (s, b / 16) is a
// row of kTileChunk cells, one more than its bins, so that the lanes reading
// their chunks' bin i meet on distinct banks.
__device__ __forceinline__ int tile_cell(int s, int b) {
  return (s * kChunks + (b >> 4)) * kTileChunk + (b & (kChunk - 1));
}

// The lane's unmasked features, in order, into feats; returns their count.
// One warp works; every thread of the block must call it.
__device__ int live_features(const bool* __restrict__ col_mask, int F, int* feats,
                             int* s_count) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int count = 0;
    for (int f0 = 0; f0 < F; f0 += 32) {
      const int f = f0 + lane;
      const bool on = f < F && col_mask[f];
      const unsigned ball = __ballot_sync(0xffffffffu, on);
      if (on) feats[count + __popc(ball & ((1u << lane) - 1))] = f;
      count += __popc(ball);
    }
    if (lane == 0) *s_count = count;
  }
  __syncthreads();
  return *s_count;
}

// The best (gain, f * 64 + b) of one warp's group of `count` live features
// feats[0..count), merged into `best` (each lane its own). Lane 4 * s + k
// takes chunk k of feats[s]; bin(s, b) gives bin b of slot s as f32 (g, h),
// K3's value (one rounding of its fixed-point sums; bins past n_bins are
// K3's zeros). From them K4's sums and gains, op for op, so the pick is K4's
// on K3's histogram. Only fresh bins get a gain: a bin whose left sums (gl,
// hl) have the bits of the bin before it in its chunk has that bin's gr, hr,
// validity and gain bit for bit, and ties go to the first index, so it can
// never be the pick (an empty bin is such a bin, but where a sum of -0
// meets +0). The fresh bins are queued (`queue`, up to 512) and the warp's
// lanes take them in turn; *queued is their number. totals holds each
// slot's (tg, th, parent).
template <typename Bin>
__device__ __forceinline__ Best group_best(Bin bin, const int* __restrict__ feats,
                                           int count, const uint8_t* __restrict__ n_bins,
                                           float lam, float min_child, Fresh* queue,
                                           float (*totals)[3], int* queued, Best best) {
  const int lane = threadIdx.x & 31, s = lane / kChunks, k = lane & (kChunks - 1);
  const bool live = s < count;
  const int f = live ? feats[s] : 0;
  const int nb = !live ? 0 : (n_bins ? min(static_cast<int>(n_bins[f]), kBins) : kBins);
  ChunkSums c;
  chunk_sums([&](int i) {
    const int b = k * kChunk + i;
    return b < nb ? bin(s, b) : make_float2(0.f, 0.f);
  }, lam, c);
  unsigned fresh = 0;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const float gl = __fadd_rn(c.rg[i], c.og), hl = __fadd_rn(c.rh[i], c.oh);
    const int before = i > 0 ? i - 1 : 0;
    if (i == 0 || __float_as_uint(gl) != __float_as_uint(c.rg[before]) ||
        __float_as_uint(hl) != __float_as_uint(c.rh[before]))
      fresh |= 1u << i;
    c.rg[i] = gl;                           // now the left sums
    c.rh[i] = hl;
  }
  if (!live) fresh = 0;
  const int mine = __popc(fresh);
  int at = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, at, o);
    if (lane >= o) at += up;
  }
  const int total = __shfl_sync(0xffffffffu, at, 31);
  at -= mine;
  __syncwarp();                             // every bin is read: the queue may overwrite them
  if (k == 0 && live) {
    totals[s][0] = c.tg;
    totals[s][1] = c.th;
    totals[s][2] = c.parent;
  }
#pragma unroll
  for (int i = 0; i < kChunk; ++i)
    if (fresh >> i & 1) queue[at++] = Fresh{c.rg[i], c.rh[i], f * kBins + k * kChunk + i, s};
  __syncwarp();
  for (int e = lane; e < total; e += 32) {
    const Fresh q = queue[e];
    const float gr = __fsub_rn(totals[q.slot][0], q.gl);
    const float hr = __fsub_rn(totals[q.slot][1], q.hl);
    if (q.hl >= min_child && hr >= min_child) {
      const float gain = split_gain(q.gl, q.hl, gr, hr, totals[q.slot][2], lam);
      if (better(gain, q.idx, best.gain, best.idx)) best = {gain, q.idx};
    }
  }
  *queued = total;
  __syncwarp();                             // before the queue and totals are written again
  return best;
}

// grid (blocks of kSplitWarps warps, lanes). A unit is an item
// (hist_group_kernel's) and a group of 8 live features: unit u is item u /
// groups and group u % groups. Warp w of block x takes units (x *
// kSplitWarps + w) + j * gridDim.x * kSplitWarps, j < run, of its lane. The
// warp sums the item's rows into its tile (int64 fixed point, as K3). A
// unit of an item that is its node rounds its non-zero bins to f32 in
// place (the only conversions: the double-precision unit is the slow one),
// takes group_best from them and writes its first-index maximum to
// cand_gain, cand_idx [node][group] (-inf where the group holds no live
// feature); a unit of a part of a split node adds its non-zero bins to the
// node's slot in acc. A warp leaves its tile zero behind it. Lane offsets as level_hist_kernel's; col_mask [L][F],
// lams [L]; cand_* cand_lane apart.
__global__ void __launch_bounds__(kSplitWarps * 32, kSplitBlocks)
level_splits_kernel(const uint8_t* __restrict__ xb, int n, int F,
                    const float* __restrict__ g, const float* __restrict__ h,
                    const uint8_t* __restrict__ n_bins, const bool* __restrict__ col_mask,
                    const float* __restrict__ lams, float min_child,
                    const int* __restrict__ rows, const double* __restrict__ scales,
                    const int4* __restrict__ items, const int* __restrict__ info,
                    u64* __restrict__ acc, int groups, int run,
                    float* __restrict__ cand_gain, int* __restrict__ cand_idx,
                    size_t cand_lane, size_t lane_bytes) {
  const size_t fit = blockIdx.y, at = fit * lane_bytes;
  g += fit * n;
  h += fit * n;
  rows = shift(rows, at);
  scales = shift(scales, at);
  items = shift(items, at);
  info = shift(info, at);
  acc = shift(acc, at);
  col_mask += fit * F;
  cand_gain += fit * cand_lane;
  cand_idx += fit * cand_lane;
  const int n_units = info[0] * groups;
  const int stride = gridDim.x * kSplitWarps;
  if (static_cast<int>(blockIdx.x) * kSplitWarps >= n_units) return;
  extern __shared__ __align__(16) unsigned char split_smem[];
  ulonglong2* tiles = reinterpret_cast<ulonglong2*>(split_smem);   // [warp][kWarpTile]
  int* feats = reinterpret_cast<int*>(tiles + kSplitWarps * kWarpTile);   // [F]
  __shared__ float s_totals[kSplitWarps][kGroupFeats][3];
  __shared__ int s_live;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kSplitWarps * kWarpTile; i += blockDim.x)
    tiles[i] = make_ulonglong2(0, 0);
  const int live = live_features(col_mask, F, feats, &s_live);
  const double sg = scales[0], sh = scales[1], inv_g = scales[2], inv_h = scales[3];
  const float lam = lams[fit];
  ulonglong2* tile = tiles + warp * kWarpTile;
  const ulonglong2 zero = make_ulonglong2(0, 0);
  const int slot = lane / kChunks, chunk = lane & (kChunks - 1);
  for (int j = 0, u = blockIdx.x * kSplitWarps + warp; j < run && u < n_units;
       ++j, u += stride) {
    const int4 item = items[u / groups];
    const int group = u % groups;
    const int pairs = kGroupFeats * (item.z - item.y);
    Best best{-INFINITY, 0x7fffffff};
    if (group * kGroupFeats < live) {
      const int count = min(kGroupFeats, live - group * kGroupFeats);
      const int* gf = feats + group * kGroupFeats;
      // pair p: row item.y + p / 8 at slot p % 8, kSplitUnroll pairs' loads in flight
      for (int p0 = lane; p0 < pairs; p0 += 32 * kSplitUnroll) {
        int r[kSplitUnroll], b[kSplitUnroll];
        float gv[kSplitUnroll], hv[kSplitUnroll];
#pragma unroll
        for (int k = 0; k < kSplitUnroll; ++k) {
          const int p = p0 + 32 * k;
          r[k] = p < pairs && (p & (kGroupFeats - 1)) < count ? rows[item.y + p / kGroupFeats] : -1;
        }
#pragma unroll
        for (int k = 0; k < kSplitUnroll; ++k) {
          const int s = (p0 + 32 * k) & (kGroupFeats - 1);
          b[k] = r[k] >= 0 ? xb[static_cast<size_t>(r[k]) * F + gf[s]] : 0;
          gv[k] = r[k] >= 0 ? g[r[k]] : 0.f;
          hv[k] = r[k] >= 0 ? h[r[k]] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kSplitUnroll; ++k) {
          if (r[k] < 0) continue;
          const int s = (p0 + 32 * k) & (kGroupFeats - 1);
          ulonglong2* cell = tile + tile_cell(s, b[k]);
          shared_add64(&cell->x, quantise(gv[k], sg));
          shared_add64(&cell->y, quantise(hv[k], sh));
        }
      }
      __syncwarp();
      if (item.w < 0) {                     // the node is this item's
        // this lane's chunk: its non-zero bins to f32 in place, K3's rounding
        unsigned mine = 0xffffu;
        for (int i = 0; i < kChunk; ++i) {
          const ulonglong2 q = tile[tile_cell(slot, chunk * kChunk + i)];
          if (!(q.x | q.y)) mine &= ~(1u << i);
        }
        for (unsigned m = mine; m; m &= m - 1) {
          ulonglong2* cell = tile + tile_cell(slot, chunk * kChunk + __ffs(m) - 1);
          const ulonglong2 q = *cell;
          *reinterpret_cast<float2*>(cell) = make_float2(
              q.x ? bin_value(static_cast<long long>(q.x), inv_g) : 0.f,
              q.y ? bin_value(static_cast<long long>(q.y), inv_h) : 0.f);
        }
        int queued;
        best = group_best(
            [&](int s, int b) {
              if (!(mine >> (b & (kChunk - 1)) & 1)) return make_float2(0.f, 0.f);
              ulonglong2* cell = tile + tile_cell(s, b);
              const float2 v = *reinterpret_cast<const float2*>(cell);
              *cell = zero;
              return v;
            },
            gf, count, n_bins, lam, min_child, reinterpret_cast<Fresh*>(tile),
            s_totals[warp], &queued, best);
        for (int i = lane; i < queued; i += 32) tile[i] = zero;   // the queue
      } else {                              // a part of a split node: into its slot
        u64* dst0 = acc + 2 * static_cast<size_t>(item.w) * F * kBins;
        for (int i = lane; i < count * kBins; i += 32) {
          const int s = i / kBins, b = i % kBins;
          ulonglong2* cell = tile + tile_cell(s, b);
          u64* dst = dst0 + 2 * (static_cast<size_t>(gf[s]) * kBins + b);
          if (cell->x) atomicAdd(dst, cell->x);
          if (cell->y) atomicAdd(dst + 1, cell->y);
          *cell = zero;
        }
      }
      __syncwarp();
    }
    if (item.w >= 0) continue;
    best = warp_best(best);
    if (lane == 0) {
      const size_t cand = static_cast<size_t>(item.x) * groups + group;
      cand_gain[cand] = best.gain;
      cand_idx[cand] = best.idx;
    }
  }
}

// grid (acc_slots, lanes): the group candidates of each split node (the
// slots in use) from its fixed-point sums in acc, as level_splits_kernel
// takes an owned node's from its tile: warp w takes groups w, w +
// kSplitWarps, ...
__global__ void __launch_bounds__(kSplitWarps * 32)
splits_finish_kernel(const ulonglong2* __restrict__ acc, int F,
                     const int* __restrict__ slot_node, const int* __restrict__ info,
                     const double* __restrict__ scales, const uint8_t* __restrict__ n_bins,
                     const bool* __restrict__ col_mask, const float* __restrict__ lams,
                     float min_child, int groups, float* __restrict__ cand_gain,
                     int* __restrict__ cand_idx, size_t cand_lane, size_t lane_bytes) {
  const size_t fit = blockIdx.y, at = fit * lane_bytes;
  acc = shift(acc, at);
  slot_node = shift(slot_node, at);
  info = shift(info, at);
  scales = shift(scales, at);
  col_mask += fit * F;
  cand_gain += fit * cand_lane;
  cand_idx += fit * cand_lane;
  if (static_cast<int>(blockIdx.x) >= info[1]) return;
  extern __shared__ __align__(16) unsigned char split_smem[];
  Fresh* queues = reinterpret_cast<Fresh*>(split_smem);   // [warp][8 features x 64 bins]
  int* feats = reinterpret_cast<int*>(queues + kSplitWarps * kGroupFeats * kBins);
  __shared__ float s_totals[kSplitWarps][kGroupFeats][3];
  __shared__ int s_live;
  const int live = live_features(col_mask, F, feats, &s_live);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const ulonglong2* node_sums = acc + static_cast<size_t>(blockIdx.x) * F * kBins;
  const double inv_g = scales[2], inv_h = scales[3];
  const size_t cand0 = static_cast<size_t>(slot_node[blockIdx.x]) * groups;
  for (int group = warp; group < groups; group += kSplitWarps) {
    const int g0 = group * kGroupFeats;
    Best best{-INFINITY, 0x7fffffff};
    if (g0 < live) {
      const int* gf = feats + g0;
      int queued;
      best = warp_best(group_best(
          [&](int s, int b) {
            const ulonglong2 q = node_sums[static_cast<size_t>(gf[s]) * kBins + b];
            return make_float2(q.x ? bin_value(static_cast<long long>(q.x), inv_g) : 0.f,
                               q.y ? bin_value(static_cast<long long>(q.y), inv_h) : 0.f);
          },
          gf, min(kGroupFeats, live - g0), n_bins, lams[fit], min_child,
          queues + warp * kGroupFeats * kBins, s_totals[warp], &queued, best));
    }
    if (lane == 0) {
      cand_gain[cand0 + group] = best.gain;
      cand_idx[cand0 + group] = best.idx;
    }
  }
}

// ---- the fused oblivious split search over lanes ---------------------------

// The low word of value into *lo_word: the word's old value, for
// add_high (0 where value's low word is 0 and nothing is added).
__device__ __forceinline__ unsigned add_low(unsigned* lo_word, long long value) {
  const unsigned lo = static_cast<unsigned>(static_cast<u64>(value));
  return lo ? atomicAdd(lo_word, lo) : 0u;
}

// The high word of value, with the carry of its low word's add (old: what
// add_low returned), into *hi_word. add_low then add_high is shared_add64,
// split so that a thread's low-word atomics go out together and their round
// trips overlap (a shared atomic's result is waited for where it is used).
__device__ __forceinline__ void add_high(unsigned* hi_word, long long value, unsigned old) {
  const unsigned lo = static_cast<unsigned>(static_cast<u64>(value));
  const unsigned hi = static_cast<unsigned>(static_cast<u64>(value) >> 32) + ((old + lo) < lo);
  if (hi) atomicAdd(hi_word, hi);
}

// Word `part` (0, 1: the low and high words of g; 2, 3: of h) of the run's
// sums of node j, bin b, feature f: [node][part][bin][32 features], so that
// the 32 lanes of a warp, a feature each, meet 32 banks whatever their bins.
__device__ __forceinline__ int obs_word(int j, int part, int b, int f) {
  return ((j * 4 + part) * kBins + b) * kObsFeats + f;
}

// The masked gain of node j, bin b, feature f in the run's [node][bin][32]
// gains, the feature's column turned by the bin's chunk, so that a warp in
// K4's layout (8 features x 4 chunks) writes 32 banks and a warp of 32
// features reads them.
__device__ __forceinline__ int obs_gain(int j, int b, int f) {
  return (j * kBins + b) * kObsFeats + (f ^ ((b >> 4) << 3));
}

// grid (groups of 32 / kRows features, lanes), kThreads threads. The block
// owns features [x * kFeats, x * kFeats + fw) of lane y for the whole level
// and walks its nodes in node order, `run` (at most kObsMaxRun) at a time;
// the sort ran with own_rows = n, so items[k] = (k, first, end, -1). For
// each run:
// A. its sorted rows, contiguous, 32 a warp at a time: lane l stages row l's
//    K3-quantised (g, h) (once a row), then the warp adds kRows rows a step,
//    lane l the bin of feature l % kFeats of row l / kFeats of the step, to
//    column l of the run's int64 sums (obs_word) with two-word atomics, the
//    low words of kObsUnroll steps together, the bins of a batch's steps
//    loaded together: a warp's atomics never meet in a bank;
// B. a warp takes 8 (node, feature) pairs in K4's layout, lane 4 s + k chunk
//    k of pair s: each bin's sums (its kRows columns added) rounded once to
//    f32, K3's value, K4's chunk sums and gains, op for op, and the masked
//    gain (valid and > 0: the gain; valid: 0; else -0.0, which adds nothing
//    and marks itself) into gains (obs_gain);
// C. a thread a (bin, column) clears the sums and, for a feature's column,
//    adds the run's masked gains to its running total in node order (K4's
//    order), with any_valid beside it.
// Then the block's first-index maximum (gain, f * 64 + b) is its candidate
// at cand_gain, cand_idx [lane][group] for oblivious_pick_kernel. Lane
// offsets as level_hist_kernel's; col_mask [L][F], lams [L].
template <int kThreads, int kRows>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
oblivious_splits_kernel(const uint8_t* __restrict__ xb, int n, int F,
                        const float* __restrict__ g, const float* __restrict__ h,
                        const bool* __restrict__ col_mask, const float* __restrict__ lams,
                        float min_child, int n_nodes, int run,
                        const int* __restrict__ rows, const double* __restrict__ scales,
                        const int4* __restrict__ items, float* __restrict__ cand_gain,
                        int* __restrict__ cand_idx, size_t cand_lane, size_t lane_bytes) {
  constexpr int kFeats = kObsFeats / kRows;  // features a block
  constexpr int kSteps = 32 / kRows;         // steps a batch of 32 rows
  constexpr int kLoads = kSteps < 16 ? kSteps : 16;   // steps whose bins load together
  const size_t fit = blockIdx.y, at = fit * lane_bytes;
  g += fit * n;
  h += fit * n;
  rows = shift(rows, at);
  scales = shift(scales, at);
  items = shift(items, at);
  col_mask += fit * F;
  cand_gain += fit * cand_lane;
  cand_idx += fit * cand_lane;
  extern __shared__ __align__(16) unsigned obs_smem[];
  const int f0 = blockIdx.x * kFeats;
  const int fw = min(kFeats, F - f0);
  const int cells = kBins * kObsFeats;       // (bin, column) b * 32 + column
  unsigned* sums = obs_smem;                                        // [run][kObsNodeWords]
  float* gains = reinterpret_cast<float*>(sums + run * kObsNodeWords);   // [run][cells]
  float* s_total = gains + run * cells;                                  // [cells]
  unsigned char* s_any = reinterpret_cast<unsigned char*>(s_total + cells);  // [cells]
  __shared__ int s_first[kObsMaxRun + 1];   // the run's rows; end past its nodes
  __shared__ bool s_live[kObsFeats];
  __shared__ longlong2 s_q[kThreads];       // a warp's 32 rows' quantised (g, h)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < run * kObsNodeWords; i += blockDim.x) sums[i] = 0;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    s_total[c] = 0.f;
    s_any[c] = 0;
  }
  if (static_cast<int>(threadIdx.x) < fw) s_live[threadIdx.x] = col_mask[f0 + threadIdx.x];
  const double sg = scales[0], sh = scales[1], inv_g = scales[2], inv_h = scales[3];
  const float lam = lams[fit];
  const int lf = lane % kFeats, slot = lane / kFeats;   // this lane's feature and row
  const bool feature = lf < fw;              // feature f0 + lf exists
  // thread t <= kObsMaxRun: entry t of the run's s_first, loaded a run ahead
  const auto first_of = [&](int k0) {
    const int nodes = min(run, n_nodes - k0), t = threadIdx.x;
    return t < nodes ? items[k0 + t].y : items[k0 + nodes - 1].z;
  };
  int next_first = static_cast<int>(threadIdx.x) <= kObsMaxRun ? first_of(0) : 0;
  for (int k0 = 0; k0 < n_nodes; k0 += run) {
    const int nodes = min(run, n_nodes - k0);
    if (static_cast<int>(threadIdx.x) <= kObsMaxRun) s_first[threadIdx.x] = next_first;
    __syncthreads();                        // s_first; the last run's sums clear
    // A. 32 rows a warp at a time; sorted row i's node in the run is the
    // count of the run's later nodes' first rows at or before it
    const int end = s_first[nodes];
    int later[kObsMaxRun - 1];
#pragma unroll
    for (int k = 0; k < kObsMaxRun - 1; ++k) later[k] = s_first[k + 1];
    longlong2* my_q = s_q + warp * 32;
    for (int i0 = s_first[0] + warp * 32; i0 < end; i0 += warps * 32) {
      const int i = i0 + lane, batch = min(32, end - i0);
      int r = 0;
      if (i < end) {
        r = rows[i];
        my_q[lane] = make_longlong2(quantise(g[r], sg), quantise(h[r], sh));
      }
      __syncwarp();
      for (int t0 = 0; t0 < kSteps; t0 += kLoads) {
        int bin[kLoads];
#pragma unroll
        for (int t = 0; t < kLoads; ++t) {
          const int src = (t0 + t) * kRows + slot;
          const int rk = __shfl_sync(0xffffffffu, r, src);
          bin[t] = src < batch && feature ? xb[static_cast<size_t>(rk) * F + f0 + lf] : 0;
        }
#pragma unroll
        for (int t = 0; t < kLoads; t += kObsUnroll) {
          int word[kObsUnroll];
          longlong2 v[kObsUnroll];
#pragma unroll
          for (int u = 0; u < kObsUnroll; ++u) {
            const int src = (t0 + t + u) * kRows + slot;
            const bool in = src < batch && feature;
            v[u] = in ? my_q[src] : make_longlong2(0, 0);   // 0: nothing added
            int node = 0;
#pragma unroll
            for (int n1 = 0; n1 < kObsMaxRun - 1; ++n1) node += i0 + src >= later[n1];
            word[u] = obs_word(node, 0, bin[t + u], lane);
          }
          unsigned old_g[kObsUnroll], old_h[kObsUnroll];
#pragma unroll
          for (int u = 0; u < kObsUnroll; ++u) {
            old_g[u] = add_low(sums + word[u], v[u].x);
            old_h[u] = add_low(sums + word[u] + 2 * kBins * kObsFeats, v[u].y);
          }
#pragma unroll
          for (int u = 0; u < kObsUnroll; ++u) {
            add_high(sums + word[u] + kBins * kObsFeats, v[u].x, old_g[u]);
            add_high(sums + word[u] + 3 * kBins * kObsFeats, v[u].y, old_h[u]);
          }
        }
      }
      __syncwarp();                         // before the warp's rows are staged again
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) <= kObsMaxRun && k0 + run < n_nodes)
      next_first = first_of(k0 + run);      // in flight through B and C
    // B. K4's gains of each (node, feature) pair, masked
    const int run_pairs = nodes * fw;
    for (int p0 = warp * kGroupFeats; p0 < run_pairs; p0 += warps * kGroupFeats) {
      const int p = p0 + lane / kChunks, k = lane & (kChunks - 1);
      const bool in = p < run_pairs;
      const int jp = in ? p / fw : 0, f = in ? p % fw : 0;
      const bool live = in && s_live[f];
      ChunkSums c;
      chunk_sums([&](int i) {
        if (!in) return make_float2(0.f, 0.f);
        const int b = k * kChunk + i;
        u64 sum_g = 0, sum_h = 0;
#pragma unroll
        for (int s = 0; s < kRows; ++s) {
          const int col = s * kFeats + f;
          sum_g += (static_cast<u64>(sums[obs_word(jp, 1, b, col)]) << 32) |
                   sums[obs_word(jp, 0, b, col)];
          sum_h += (static_cast<u64>(sums[obs_word(jp, 3, b, col)]) << 32) |
                   sums[obs_word(jp, 2, b, col)];
        }
        return make_float2(
            sum_g ? bin_value(static_cast<long long>(sum_g), inv_g) : 0.f,
            sum_h ? bin_value(static_cast<long long>(sum_h), inv_h) : 0.f);
      }, lam, c);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float gl = __fadd_rn(c.rg[i], c.og);
        const float hl = __fadd_rn(c.rh[i], c.oh);
        const float gr = __fsub_rn(c.tg, gl);
        const float hr = __fsub_rn(c.th, hl);
        const bool valid = hl >= min_child && hr >= min_child;
        float gain = 0.f;                   // read only where valid
        if (__any_sync(0xffffffffu, valid)) gain = split_gain(gl, hl, gr, hr, c.parent, lam);
        if (in) gains[obs_gain(jp, k * kChunk + i, f)] =
                    valid && live ? (gain > 0.f ? gain : 0.f) : -0.f;
      }
    }
    __syncthreads();
    // C. the sums cleared and the run's masked gains into the totals in node
    // order; cell = b * 32 + column, so that a warp's accesses meet 32 banks
    for (int cell = threadIdx.x; cell < cells; cell += blockDim.x) {
      const int col = cell % kObsFeats, b = cell / kObsFeats;
      for (int jn = 0; jn < nodes; ++jn)
        for (int part = 0; part < 4; ++part) sums[obs_word(jn, part, b, col)] = 0;
      if (col >= fw) continue;              // columns past the features: sums only
      float total = s_total[cell];
      bool any = s_any[cell];
      for (int jn = 0; jn < nodes; ++jn) {
        const float v = gains[obs_gain(jn, b, col)];
        any |= __float_as_uint(v) != 0x80000000u;
        total = __fadd_rn(total, v);
      }
      s_total[cell] = total;
      s_any[cell] = any;
    }
  }
  // each thread reads back the totals it wrote
  Best mine{-INFINITY, 0x7fffffff};
  for (int cell = threadIdx.x; cell < cells; cell += blockDim.x) {
    const int f = cell % kObsFeats, b = cell / kObsFeats;
    if (f >= fw) continue;
    const float total = s_any[cell] ? s_total[cell] : -INFINITY;
    const int idx = (f0 + f) * kBins + b;
    if (better(total, idx, mine.gain, mine.idx)) mine = {total, idx};
  }
  mine = block_best(mine);
  if (threadIdx.x == 0) {
    cand_gain[blockIdx.x] = mine.gain;
    cand_idx[blockIdx.x] = mine.idx;
  }
}

// ---- K5 ---------------------------------------------------------------------

// The next boosted tree's inputs and outputs (y null: there is none).
struct NextTree {
  const float* y;                           // every lane's
  const float* u;                           // the tree's subsample draw
  const float* w;                           // row weights
  float subsample;
  const float* subsamples;                  // a lane's rate, or null: subsample
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

// pos is read only where it can hold other than 0 (`read`); a slot past n
// is position -1.
template <bool kNext>
__device__ __forceinline__ LeafRow load_leaf_row(int r, int n, const int* pos, bool read,
                                                 const float* g, const float* h,
                                                 const float* preds,
                                                 const NextTree& next) {
  LeafRow row{-1, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (r >= n) return row;
  row.p = read ? pos[r] : 0;
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

// Row r's leaf from its parent position p (-1 past n) and, with `routing`,
// the parent level's table in shared memory; p itself without.
__device__ __forceinline__ int routed_leaf(int p, int r, bool routing, const int* table,
                                           const Route& route) {
  if (!routing || p < 0) return p;
  const int split = table[p];
  return child_of(p, split, split_bin(route, r, split));
}

// K5: one cluster of 1 to 16 blocks a lane, a row a thread (see K5
// design). blockIdx.y is the lane: its rows (pos, g, h, preds and the next
// tree's u, w, g, h) at lane * n, its bounds at 2 * lane, its leaves at
// lane * n_leaves, its lam, scale and subsample from lams, scales and
// next.subsamples; y is every lane's. kLanes false: the single fit, with
// lam, scale and subsample as given and no lane offsets compiled in. With a
// parent table pos holds the last level's parents, and each row is routed
// as it is loaded (pos is not written back); rank 0 writes the table into
// the tree.
template <bool kNext, bool kLanes>
__global__ void __launch_bounds__(kLeafThreads, 1)
leaf_values_kernel(const int* __restrict__ pos, int n, const float* __restrict__ g,
                   const float* __restrict__ h, int n_leaves, float lam,
                   float scale, const float* __restrict__ lams,
                   const float* __restrict__ scales,
                   const float* __restrict__ bounds,
                   float* __restrict__ leaf, float* __restrict__ preds,
                   NextTree next, Route route) {
  if (kLanes) {
    const size_t fit = blockIdx.y, rows0 = fit * n;
    pos += rows0;
    g += rows0;
    h += rows0;
    preds += rows0;
    bounds += 2 * fit;
    leaf += fit * n_leaves;
    lam = lams[fit];
    scale = scales[fit];
    if (kNext) {
      next.u += rows0;
      next.w += rows0;
      next.g += rows0;
      next.h += rows0;
      next.bounds += 2 * fit;
      next.subsample = next.subsamples[fit];
    }
    route = lane_route(route, fit);
  }
  extern __shared__ __align__(16) unsigned char leaf_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blocks = static_cast<int>(cluster.num_blocks());
  const bool every = n_leaves * blocks <= 2 * static_cast<int>(blockDim.x);
  const int per = every ? n_leaves : (n_leaves + blocks - 1) / blocks;
  ulonglong2* sums = reinterpret_cast<ulonglong2*>(leaf_smem);  // [leaf] (g, h)
  ulonglong2* stage = sums + n_leaves;                           // [block][per]
  int* s_route = reinterpret_cast<int*>(stage + blocks * per);      // [parent]
  float* values = reinterpret_cast<float*>(s_route + route.nodes);  // [leaf]
  __shared__ double s_scale[4];             // g, h, then their inverses
  __shared__ unsigned s_max[2];
  const int stride = blocks * blockDim.x;
  const int r0 = rank * blockDim.x + threadIdx.x;
  const bool read = (route.nodes ? route.nodes : n_leaves) > 1;
  const bool routing = route.nodes > 0;
  LEAF_CLOCK(0);
  // every load of the first row (at the trainer's sizes, every row) and
  // the bounds are in flight together, through the start-up and barriers
  const float bound = threadIdx.x < 2 ? bounds[threadIdx.x] : 0.f;
  LeafRow first = load_leaf_row<kNext>(r0, n, pos, read, g, h, preds, next);
  stage_route(route, s_route, rank == 0);
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
  first.p = routed_leaf(first.p, r0, routing, s_route, route);
  LEAF_CLOCK(1);                            // loads issued, table zeroed, scales
  const double sg = s_scale[0], sh = s_scale[1];
  for (int r = r0; r < n; r += stride) {    // this block's rows, its own table
    LeafRow row = first;
    if (r != r0) {
      row = load_leaf_row<false>(r, n, pos, read, g, h, preds, next);
      row.p = routed_leaf(row.p, r, routing, s_route, route);
    }
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
    LeafRow row = first;
    if (r != r0) {
      row = load_leaf_row<kNext>(r, n, pos, read, g, h, preds, next);
      row.p = routed_leaf(row.p, r, routing, s_route, route);
    }
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

// K5 with lanes, one block a lane (see K5 with lanes design): the block
// walks its lane's rows kLeafUnroll a thread at a time, sums them into its
// own shared table, takes the leaves, and walks the rows again for the
// update and the next tree's gradients. No cluster, no barrier but the
// block's. blockIdx.x is the lane; the layout is leaf_values_kernel's.
template <bool kNext, int kThreads>
__global__ void __launch_bounds__(kThreads, kLeafThreads / kThreads)
leaf_values_block_kernel(const int* __restrict__ pos, int n,
                         const float* __restrict__ g, const float* __restrict__ h,
                         int n_leaves, const float* __restrict__ lams,
                         const float* __restrict__ scales,
                         const float* __restrict__ bounds, float* __restrict__ leaf,
                         float* __restrict__ preds, NextTree next, Route route) {
  const size_t fit = blockIdx.x, rows0 = fit * n;
  pos += rows0;
  g += rows0;
  h += rows0;
  preds += rows0;
  bounds += 2 * fit;
  leaf += fit * n_leaves;
  const float lam = lams[fit], scale = scales[fit];
  if (kNext) {
    next.u += rows0;
    next.w += rows0;
    next.g += rows0;
    next.h += rows0;
    next.bounds += 2 * fit;
    next.subsample = next.subsamples[fit];
  }
  route = lane_route(route, fit);
  extern __shared__ __align__(16) unsigned char leaf_smem[];
  ulonglong2* sums = reinterpret_cast<ulonglong2*>(leaf_smem);      // [leaf] (g, h)
  int* s_route = reinterpret_cast<int*>(sums + n_leaves);           // [parent]
  float* values = reinterpret_cast<float*>(s_route + route.nodes);  // [leaf]
  __shared__ double s_scale[4];
  __shared__ unsigned s_max[2];
  const bool read = (route.nodes ? route.nodes : n_leaves) > 1;
  const bool routing = route.nodes > 0;
  const float bound = threadIdx.x < 2 ? bounds[threadIdx.x] : 0.f;
  stage_route(route, s_route, true);
  for (int i = threadIdx.x; i < n_leaves; i += kThreads) sums[i] = make_ulonglong2(0, 0);
  if (threadIdx.x < 2) {
    const double sc = fixed_scale(bound, n);
    s_scale[threadIdx.x] = sc;
    s_scale[2 + threadIdx.x] = 1.0 / sc;
    s_max[threadIdx.x] = 0;
  }
  __syncthreads();
  const double sg = s_scale[0], sh = s_scale[1];
  // a thread's kLeafUnroll rows: their loads in flight together, then
  // their xb loads
  for (int base = 0; base < n; base += kLeafUnroll * kThreads) {
    int p[kLeafUnroll];
    float gv[kLeafUnroll], hv[kLeafUnroll];
#pragma unroll
    for (int u = 0; u < kLeafUnroll; ++u) {
      const int r = base + u * kThreads + threadIdx.x;
      p[u] = r < n ? (read ? pos[r] : 0) : -1;
      gv[u] = r < n ? g[r] : 0.f;
      hv[u] = r < n ? h[r] : 0.f;
    }
    if (routing) {
      int split[kLeafUnroll], x[kLeafUnroll];
#pragma unroll
      for (int u = 0; u < kLeafUnroll; ++u) split[u] = p[u] >= 0 ? s_route[p[u]] : 0;
#pragma unroll
      for (int u = 0; u < kLeafUnroll; ++u) {
        const int r = base + u * kThreads + threadIdx.x;
        x[u] = p[u] >= 0 ? split_bin(route, r, split[u]) : 0;
      }
#pragma unroll
      for (int u = 0; u < kLeafUnroll; ++u)
        if (p[u] >= 0) p[u] = child_of(p[u], split[u], x[u]);
    }
#pragma unroll
    for (int u = 0; u < kLeafUnroll; ++u) {
      if (p[u] < 0 || p[u] >= n_leaves) continue;
      shared_add64(&sums[p[u]].x, quantise(gv[u], sg));
      shared_add64(&sums[p[u]].y, quantise(hv[u], sh));
    }
  }
  __syncthreads();
  for (int li = threadIdx.x; li < n_leaves; li += kThreads) {
    const ulonglong2 s = sums[li];
    const float gl = bin_value(static_cast<long long>(s.x), s_scale[2]);
    const float hl = bin_value(static_cast<long long>(s.y), s_scale[3]);
    const float v = __fdiv_rn(-gl, __fadd_rn(hl, lam));
    values[li] = v;
    leaf[li] = v;
  }
  __syncthreads();
  unsigned max_g = 0, max_h = 0;
  for (int base = 0; base < n; base += kLeafUnroll * kThreads) {
    int p[kLeafUnroll];
    float pv[kLeafUnroll], yv[kLeafUnroll], uv[kLeafUnroll], wv[kLeafUnroll];
#pragma unroll
    for (int u = 0; u < kLeafUnroll; ++u) {
      const int r = base + u * kThreads + threadIdx.x;
      p[u] = r < n ? (read ? pos[r] : 0) : -1;
      pv[u] = r < n ? preds[r] : 0.f;
      if (kNext) {
        yv[u] = r < n ? next.y[r] : 0.f;
        uv[u] = r < n ? next.u[r] : 0.f;
        wv[u] = r < n ? next.w[r] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kLeafUnroll; ++u) {
      const int r = base + u * kThreads + threadIdx.x;
      p[u] = routed_leaf(p[u], r, routing, s_route, route);
    }
#pragma unroll
    for (int u = 0; u < kLeafUnroll; ++u) {
      const int r = base + u * kThreads + threadIdx.x;
      if (r >= n) continue;
      float pred = pv[u];
      if (p[u] >= 0 && p[u] < n_leaves) {  // one fused multiply-add, as the reference
        pred = __fmaf_rn(scale, values[p[u]], pred);
        preds[r] = pred;
      }
      if (kNext) {
        float gn, hn;
        next_gradient(pred, yv[u], uv[u], wv[u], next, &gn, &hn);
        next.g[r] = gn;
        next.h[r] = hn;
        max_g = max(max_g, __float_as_uint(fabsf(gn)));
        max_h = max(max_h, __float_as_uint(fabsf(hn)));
      }
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
    if (threadIdx.x < 2) next.bounds[threadIdx.x] = s_max[threadIdx.x];
  }
}

// Raises a kernel's dynamic shared-memory limit to the most it is launched
// with, once a size (so that launches inside a CUDA graph capture set
// nothing once the calls before it have). Every size is set, 48 KB or
// under too: the kernel's static shared memory counts toward 48 KB.
cudaError_t shared_limit(const void* kernel, int* raised_to, int bytes) {
  if (bytes <= *raised_to) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *raised_to = bytes;
  return err;
}

int sort_smem_raised[2][2] = {};             // [kLanes][kRoute]

typedef void (*SortKernel)(int*, int, const float*, const float*, int, int, int,
                           const float*, int*, double*, int4*, int*, int*, ulonglong2*,
                           size_t, size_t, Route);
const SortKernel sort_kernels[2][2] = {          // [kLanes][kRoute]
    {hist_group_kernel<false, false>, hist_group_kernel<false, true>},
    {hist_group_kernel<true, false>, hist_group_kernel<true, true>}};

// The sort's kernel for a launch, its dynamic shared memory (the parent's
// table, then the plan's counters and rows) raised to `smem` bytes.
cudaError_t sort_kernel(bool lanes, const Route& route, int smem, SortKernel* kernel) {
  const bool routing = route.nodes > 0;
  *kernel = sort_kernels[lanes][routing];
  return shared_limit(reinterpret_cast<const void*>(*kernel),
                      &sort_smem_raised[lanes][routing], smem);
}
int oblivious_smem_raised = 0;
int leaf_smem_raised[2][2] = {};              // [kNext][kLanes]
bool leaf_wide_clusters[2][2] = {};

// One lane's K3 scratch (the sort's plan) and the sort launch's sizes: the
// plan holds f64 [4] scales, int4 [max_items] items, int [acc_slots] slot
// nodes and int [2] counts; acc holds acc_pairs (g, h) int64 pairs.
struct SortPlan {
  int max_items, acc_slots, sort_blocks, sort_smem;
  size_t acc_pairs;
  double* scales;
  int4* items;
  int* slot_node;
  int* info;
};

SortPlan sort_plan(int n, int F, int n_nodes, int rows_per_item, int own_rows,
                   void* plan) {
  SortPlan p;
  p.max_items = n_nodes + n / rows_per_item;
  const int by_rows = n / (own_rows + 1);
  p.acc_slots = n_nodes < by_rows ? n_nodes : by_rows;
  p.acc_pairs = static_cast<size_t>(p.acc_slots) * F * kBins;
  p.scales = static_cast<double*>(plan);
  p.items = reinterpret_cast<int4*>(p.scales + 4);
  p.slot_node = reinterpret_cast<int*>(p.items + p.max_items);
  p.info = p.slot_node + p.acc_slots;
  const size_t zero_blocks = (p.acc_pairs + 4 * kSortThreads - 1) / (4 * kSortThreads);
  p.sort_blocks = 1 + static_cast<int>(zero_blocks < 1 ? 1 : (zero_blocks < 128 ? zero_blocks : 128));
  p.sort_smem = (n_nodes + (n <= kSortStagedRows ? n : 0)) * static_cast<int>(sizeof(int));
  return p;
}

// The parent split of a C entry point's arguments; false where they do not
// describe one that leads to `children` nodes (nodes 0: no routing).
bool parent_route(const void* xb, int F, const void* f, const void* b, int nodes,
                  void* feats, void* bins, long long tree_lane, int children,
                  Route* route) {
  *route = Route{static_cast<const uint8_t*>(xb), F, static_cast<const int*>(f),
                 static_cast<const int*>(b), nodes, static_cast<int*>(feats),
                 static_cast<int*>(bins), static_cast<size_t>(tree_lane)};
  if (nodes == 0) return true;
  return nodes > 0 && nodes <= kRouteMaxNodes && 2 * nodes == children && xb && F > 0 &&
         F <= kRouteMaxFeats && f && b && feats && bins && tree_lane >= 0;
}

template <bool kLanes>
void launch_histogram(int groups, int sort_smem, const dim3& grid, int threads,
                      int tile_smem, int acc_slots, int F, cudaStream_t s,
                      const int* pos, int n, const float* gp, const float* hp,
                      int n_nodes, int rows_per_item, int own_rows,
                      const float* bounds, int* rows, double* scales, int4* items,
                      int* slot_node, int* info, void* acc, size_t acc_pairs,
                      const uint8_t* xb, const uint8_t* n_bins, int tile_shift,
                      void* out, size_t lane_bytes, size_t out_lane,
                      SortKernel sort, const Route& route) {
  sort<<<dim3(groups, grid.z), kSortThreads, sort_smem, s>>>(
      const_cast<int*>(pos), n, gp, hp, n_nodes, rows_per_item, own_rows, bounds, rows,
      scales, items, slot_node, info, static_cast<ulonglong2*>(acc), acc_pairs,
      lane_bytes, route);
  level_hist_kernel<kLanes><<<grid, threads, tile_smem, s>>>(
      xb, n, F, gp, hp, n_bins, tile_shift, rows, scales, items, info,
      static_cast<u64*>(acc), static_cast<float2*>(out), lane_bytes, out_lane);
  if (acc_slots > 0)
    hist_finish_kernel<kLanes>
        <<<dim3(acc_slots, (F * kBins * 2 + 1023) / 1024, grid.z), 256, 0, s>>>(
            static_cast<const long long*>(acc), F, slot_node, info, scales,
            static_cast<float*>(out), lane_bytes, out_lane);
}

// K3 over `lanes` fits (1: the single fit's launch). pos, g, h [lanes][n],
// bounds [lanes][2]; each lane's scratch (rows, plan, acc) lies lane_words
// int64 words after the one before (even, so its int4 and 128-bit parts stay
// aligned); out [lanes][n_nodes][F][64][2]. With a parent split (route)
// pos holds the parent level's positions and is routed in place.
int level_histogram(const void* xb, int n, int F, const void* pos,
                    const void* g, const void* h, int n_nodes,
                    const void* bounds, const void* n_bins, int tile_feats,
                    int threads, int rows_per_item, int own_rows, void* rows,
                    void* plan, void* acc, void* out, int lanes,
                    long long lane_words, const Route& route, void* stream) {
  if (n < 0 || F <= 0 || n_nodes <= 0 || n_nodes > kMaxSortNodes ||
      n / (own_rows + 1) > kMaxSlots ||
      rows_per_item <= 0 || own_rows < rows_per_item || threads < 32 ||
      threads > kHistThreads || threads % 32 ||
      (tile_feats != 8 && tile_feats != 16 && tile_feats != 32) ||
      lanes < 1 || lanes > kMaxLanes || (lanes > 1 && (lane_words <= 0 || lane_words % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t lane_bytes = static_cast<size_t>(lane_words) * sizeof(long long);
  const size_t out_lane = static_cast<size_t>(n_nodes) * F * kBins;
  const SortPlan p = sort_plan(n, F, n_nodes, rows_per_item, own_rows, plan);
  const int sort_smem = p.sort_smem + route.nodes * static_cast<int>(sizeof(int));
  const float* gp = static_cast<const float*>(g);
  const float* hp = static_cast<const float*>(h);
  const bool with_lanes = lanes > 1;
  SortKernel sort;
  const cudaError_t err = sort_kernel(with_lanes, route, sort_smem, &sort);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile_shift = tile_feats == 8 ? 3 : (tile_feats == 16 ? 4 : 5);
  const dim3 grid(p.max_items, (F + tile_feats - 1) / tile_feats, lanes);
  const int tile_smem = tile_feats * kBins * 2 * static_cast<int>(sizeof(u64));
  (with_lanes ? launch_histogram<true> : launch_histogram<false>)(
      p.sort_blocks, sort_smem, grid, threads, tile_smem, p.acc_slots, F, s,
      static_cast<const int*>(pos), n, gp, hp, n_nodes, rows_per_item, own_rows,
      static_cast<const float*>(bounds), static_cast<int*>(rows), p.scales, p.items,
      p.slot_node, p.info, acc, p.acc_pairs, static_cast<const uint8_t*>(xb),
      static_cast<const uint8_t*>(n_bins), tile_shift, out, lane_bytes, out_lane, sort,
      route);
  return static_cast<int>(cudaGetLastError());
}

int splits_smem_raised = 0;
int finish_smem_raised = 0;

// The fused split search over `lanes` fits: the sort (hist_group_kernel),
// level_splits_kernel over the items, `run` a warp, and, where a node can be
// split (n > own_rows), splits_finish_kernel. pos, g, h [lanes][n], bounds
// [lanes][2], col_mask [lanes][F], lams [lanes]; the scratch (rows, plan,
// acc) as level_histogram's, lane_words apart; feat, bin, has_split
// [lanes][n_nodes].
int level_splits(const void* xb, int n, int F, const void* pos, const void* g,
                 const void* h, int n_nodes, const void* bounds, const void* n_bins,
                 const void* col_mask, const void* lams, float min_child,
                 int rows_per_item, int own_rows, int run,
                 void* rows, void* plan, void* acc, void* cand, void* feat, void* bin,
                 void* has_split, int lanes, long long lane_words, const Route& route,
                 void* stream) {
  if (n < 0 || F <= 0 || F > kMaxSplitFeats || n_nodes <= 0 ||
      n_nodes > kMaxSortNodes || n / (own_rows + 1) > kMaxSlots ||
      rows_per_item <= 0 || own_rows < rows_per_item || run < 1 || lanes < 1 ||
      lanes > kMaxLanes || lane_words <= 0 || lane_words % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t lane_bytes = static_cast<size_t>(lane_words) * sizeof(long long);
  const SortPlan p = sort_plan(n, F, n_nodes, rows_per_item, own_rows, plan);
  const float* gp = static_cast<const float*>(g);
  const float* hp = static_cast<const float*>(h);
  const uint8_t* nbp = static_cast<const uint8_t*>(n_bins);
  const bool* mp = static_cast<const bool*>(col_mask);
  const float* lp = static_cast<const float*>(lams);
  int* fp = static_cast<int*>(feat);
  int* bp = static_cast<int*>(bin);
  bool* sp = static_cast<bool*>(has_split);
  const int split_smem = kSplitWarps * kWarpTile * static_cast<int>(sizeof(ulonglong2)) +
                         F * static_cast<int>(sizeof(int));
  const int groups = (F + kGroupFeats - 1) / kGroupFeats;
  const int finish_smem = kSplitWarps * kGroupFeats * kBins * static_cast<int>(sizeof(Fresh)) +
                          F * static_cast<int>(sizeof(int));
  const int sort_smem = p.sort_smem + route.nodes * static_cast<int>(sizeof(int));
  SortKernel sort;
  cudaError_t err = sort_kernel(true, route, sort_smem, &sort);
  if (err == cudaSuccess)
    err = shared_limit(reinterpret_cast<const void*>(level_splits_kernel),
                       &splits_smem_raised, split_smem);
  if (err == cudaSuccess)
    err = shared_limit(reinterpret_cast<const void*>(splits_finish_kernel),
                       &finish_smem_raised, finish_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = kSplitWarps * run;
  const size_t cand_lane = static_cast<size_t>(n_nodes) * groups;
  float* cand_gain = static_cast<float*>(cand);
  int* cand_idx = static_cast<int*>(cand) + static_cast<size_t>(lanes) * cand_lane;
  sort<<<dim3(p.sort_blocks, lanes), kSortThreads, sort_smem, s>>>(
      static_cast<int*>(const_cast<void*>(pos)), n, gp, hp, n_nodes, rows_per_item,
      own_rows, static_cast<const float*>(bounds), static_cast<int*>(rows), p.scales,
      p.items, p.slot_node, p.info, static_cast<ulonglong2*>(acc), p.acc_pairs,
      lane_bytes, route);
  const int units = p.max_items * groups;
  level_splits_kernel<<<dim3((units + per_block - 1) / per_block, lanes),
                        kSplitWarps * 32, split_smem, s>>>(
      static_cast<const uint8_t*>(xb), n, F, gp, hp, nbp, mp, lp, min_child,
      static_cast<const int*>(rows), p.scales, p.items, p.info, static_cast<u64*>(acc),
      groups, run, cand_gain, cand_idx, cand_lane, lane_bytes);
  if (p.acc_slots > 0)
    splits_finish_kernel<<<dim3(p.acc_slots, lanes), kSplitWarps * 32, finish_smem, s>>>(
        static_cast<const ulonglong2*>(acc), F, p.slot_node, p.info, p.scales, nbp, mp, lp,
        min_child, groups, cand_gain, cand_idx, cand_lane, lane_bytes);
  splits_pick_kernel<<<dim3((n_nodes + 255) / 256, lanes), 256, 0, s>>>(
      cand_gain, cand_idx, cand_lane, groups, n_nodes, fp, bp, sp);
  return static_cast<int>(cudaGetLastError());
}

typedef void (*ObsKernel)(const uint8_t*, int, int, const float*, const float*, const bool*,
                          const float*, float, int, int, const int*, const double*,
                          const int4*, float*, int*, size_t, size_t);
// the forms of the fused oblivious search: 32 features a block, 8 features,
// 8 features in blocks of 1,024 threads
const ObsKernel obs_kernels[3] = {oblivious_splits_kernel<512, 1>,
                                  oblivious_splits_kernel<512, 4>,
                                  oblivious_splits_kernel<1024, 4>};
int oblivious_search_smem_raised[3] = {};

// The fused oblivious split search over `lanes` fits: the sort
// (hist_group_kernel with rows_per_item = own_rows = max(n, 1): an item a
// node, no accumulator to zero), oblivious_splits_kernel over (groups of
// features, lanes) and K4's oblivious_pick_kernel. pos, g, h [lanes][n],
// bounds [lanes][2], col_mask [lanes][F], lams [lanes]; the scratch (rows,
// plan) lane_words apart, the plan laid out by sort_plan at those sizes;
// cand int32 [2][lanes][ceil(F / 8)] at least (a candidate a group of 32
// features, or of 8); feat, bin, has_split [lanes][n_nodes].
int level_splits_oblivious(const void* xb, int n, int F, const void* pos, const void* g,
                           const void* h, int n_nodes, const void* bounds,
                           const void* col_mask, const void* lams, float min_child,
                           void* rows, void* plan, void* cand, void* feat, void* bin,
                           void* has_split, int lanes, long long lane_words,
                           const Route& route, void* stream) {
  if (n < 0 || F <= 0 || n_nodes <= 0 || n_nodes > kMaxSortNodes || lanes < 1 ||
      lanes > kMaxLanes || lane_words <= 0 || lane_words % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t lane_bytes = static_cast<size_t>(lane_words) * sizeof(long long);
  const int own = n > 0 ? n : 1;
  const SortPlan p = sort_plan(n, F, n_nodes, own, own, plan);   // no accumulator
  const float* gp = static_cast<const float*>(g);
  const float* hp = static_cast<const float*>(h);
  // a block 32 features, a row a warp step, 512 threads and runs of 2 nodes,
  // two blocks an SM, where the lanes' blocks fill the card's SMs; else 8
  // features and 4 rows a step, and 1,024 threads and runs of 4 nodes where
  // those blocks do not fill it either
  int device = 0, sms = 0;                  // the current device's, at every call
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool narrow = static_cast<long long>(lanes) * ((F + kObsFeats - 1) / kObsFeats) < sms;
  const int feats = narrow ? kObsFeats / 4 : kObsFeats;
  const int groups = (F + feats - 1) / feats;
  const bool wide = narrow && static_cast<long long>(lanes) * groups <= sms;
  const int run_most = wide ? kObsMaxRun : kObsMaxRun / 2;
  const int run = n_nodes < run_most ? n_nodes : run_most;
  // the run's sums, its masked gains, the totals and any_valid
  const int smem = run * kObsNodeWords * 4 + (run + 1) * kObsFeats * kBins * 4 +
                   kObsFeats * kBins;
  const int sort_smem = p.sort_smem + route.nodes * static_cast<int>(sizeof(int));
  const int form = wide ? 2 : narrow;
  const ObsKernel kernel = obs_kernels[form];
  SortKernel sort;
  err = sort_kernel(true, route, sort_smem, &sort);
  if (err == cudaSuccess)
    err = shared_limit(reinterpret_cast<const void*>(kernel),
                       &oblivious_search_smem_raised[form], smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* cand_gain = static_cast<float*>(cand);
  int* cand_idx = static_cast<int*>(cand) + static_cast<size_t>(lanes) * groups;
  sort<<<dim3(p.sort_blocks, lanes), kSortThreads, sort_smem, s>>>(
      static_cast<int*>(const_cast<void*>(pos)), n, gp, hp, n_nodes, own, own,
      static_cast<const float*>(bounds), static_cast<int*>(rows), p.scales, p.items,
      p.slot_node, p.info, nullptr, 0, lane_bytes, route);
  kernel<<<dim3(groups, lanes), wide ? 1024 : 512, smem, s>>>(
      static_cast<const uint8_t*>(xb), n, F, gp, hp, static_cast<const bool*>(col_mask),
      static_cast<const float*>(lams), min_child, n_nodes, run,
      static_cast<const int*>(rows), p.scales, p.items, cand_gain, cand_idx, groups,
      lane_bytes);
  oblivious_pick_kernel<<<lanes, 256, 0, s>>>(cand_gain, cand_idx, groups, groups, n_nodes,
                                              static_cast<int*>(feat), static_cast<int*>(bin),
                                              static_cast<bool*>(has_split));
  return static_cast<int>(cudaGetLastError());
}

// K4 over `lanes` fits: hist [lanes][n_nodes][F][64][2], col_mask
// [lanes][F], lams [lanes] or null for lam; scratch int32 [lanes][2 *
// n_cand]: n_cand = ceil(F / 4) in oblivious mode, n_nodes * ceil(F / 64)
// per node when F > 64, else unused; feat, bin, has_split [lanes][n_nodes].
int best_splits(const void* hist, int n_nodes, int F, const void* col_mask,
                float lam, const void* lams, float min_child, int oblivious,
                void* scratch, void* feat, void* bin, void* has_split, int lanes,
                void* stream) {
  if (n_nodes <= 0 || F <= 0 || lanes < 1 || lanes > kMaxLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* hp = static_cast<const float4*>(hist);
  const bool* mp = static_cast<const bool*>(col_mask);
  const float* lp = static_cast<const float*>(lams);
  int* fp = static_cast<int*>(feat);
  int* bp = static_cast<int*>(bin);
  bool* sp = static_cast<bool*>(has_split);
  if (oblivious) {
    const int blocks = (F + kOblFeats - 1) / kOblFeats;
    const size_t cand_lane = 2 * static_cast<size_t>(blocks);
    const int smem = ((kOblThreads / 32) * kStageFloats +
                      kOblRun * kOblFeats * kBins) * static_cast<int>(sizeof(float));
    const cudaError_t err = shared_limit(
        reinterpret_cast<const void*>(best_splits_oblivious_kernel),
        &oblivious_smem_raised, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    float* cand_gain = static_cast<float*>(scratch);
    int* cand_idx = static_cast<int*>(scratch) + blocks;
    best_splits_oblivious_kernel<<<dim3(blocks, lanes), kOblThreads, smem, s>>>(
        hp, n_nodes, F, mp, lam, lp, min_child, cand_gain, cand_idx, cand_lane);
    oblivious_pick_kernel<<<lanes, 256, 0, s>>>(cand_gain, cand_idx, cand_lane,
                                                blocks, n_nodes, fp, bp, sp);
  } else {
    const int per_node = (F + kSplitFeats - 1) / kSplitFeats;
    const int groups = (F + kGroupFeats - 1) / kGroupFeats;
    const int threads = per_node > 1 ? kSplitThreads : groups * 32;
    const size_t cand_lane = 2 * static_cast<size_t>(n_nodes) * per_node;
    float* cand_gain = static_cast<float*>(scratch);
    int* cand_idx = static_cast<int*>(scratch) + n_nodes * per_node;
    best_splits_kernel<<<dim3(n_nodes, per_node, lanes), threads, 0, s>>>(
        hp, F, mp, lam, lp, min_child, cand_gain, cand_idx, cand_lane, fp, bp, sp);
    if (per_node > 1)
      splits_pick_kernel<<<dim3((n_nodes + 255) / 256, lanes), 256, 0, s>>>(
          cand_gain, cand_idx, cand_lane, per_node, n_nodes, fp, bp, sp);
  }
  return static_cast<int>(cudaGetLastError());
}

// What one wave of the card holds of a launch: clusters of a cluster
// launch (cudaOccupancyMaxActiveClusters) or blocks of a plain one
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs). Asked once
// a kernel, size and shared-memory size; known = {shared bytes, count}.
int wave_size(const void* kernel, const cudaLaunchConfig_t* cfg, int threads, int smem,
              int2* known) {
  if (known->x == smem && known->y > 0) return known->y;
  int count = 0;
  cudaError_t err;
  if (cfg) {
    err = cudaOccupancyMaxActiveClusters(&count, kernel, cfg);
  } else {
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&count, kernel, threads, smem);
    count *= sms;
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  *known = make_int2(smem, count > 0 ? count : 1);
  return known->y;
}

int2 leaf_wave[2][kLeafMaxCluster + 1] = {};  // [kNext][cluster size]
int2 leaf_block_wave[2][2] = {};              // [kNext][512, 1,024 threads]
int leaf_block_smem_raised[2][2] = {};

typedef void (*LeafBlockKernel)(const int*, int, const float*, const float*, int,
                                const float*, const float*, const float*, float*, float*,
                                NextTree, Route);

// K5 over `lanes` fits. The single fit takes the cluster form: one cluster
// of `cluster` blocks of kLeafThreads (at most 16). Over lanes, shape 0
// chooses (see K5 with lanes design): the cluster form at the largest
// cluster of `cluster`, `cluster` / 2, ... 2 blocks of which one wave of the
// card holds every lane's cluster, else one block a lane, of 1,024 threads
// where one wave holds the lanes' blocks, else of 512. shape 1 is the
// cluster form at `cluster` blocks and shape 2 the block form, whatever the
// lanes (for tests and timing). The layout is leaf_values_kernel's.
int leaf_values(const void* pos, int n, const void* g, const void* h,
                int n_leaves, float lam, float scale, const void* lams,
                const void* scales, const void* bounds, void* leaf, void* preds,
                const void* y, const void* u, const void* w_rows,
                float subsample, const void* subsamples, int cls, void* g_next,
                void* h_next, void* bounds_next, int cluster, int shape, int lanes,
                const Route& route, void* stream) {
  const bool with_next = y != nullptr, with_lanes = lams != nullptr;
  if (n < 0 || n_leaves <= 0 || cluster < 1 || cluster > kLeafMaxCluster ||
      lanes < 1 || lanes > kMaxLanes || shape < 0 || shape > 2 ||
      (shape != 1 && !with_lanes))
    return static_cast<int>(cudaErrorInvalidValue);
  const NextTree next{static_cast<const float*>(y), static_cast<const float*>(u),
                      static_cast<const float*>(w_rows), subsample,
                      static_cast<const float*>(subsamples), cls,
                      static_cast<float*>(g_next), static_cast<float*>(h_next),
                      static_cast<unsigned*>(bounds_next)};
  const int* pp = static_cast<const int*>(pos);
  const float* gp = static_cast<const float*>(g);
  const float* hp = static_cast<const float*>(h);
  const float* lamp = static_cast<const float*>(lams);
  const float* scalep = static_cast<const float*>(scales);
  const float* bp = static_cast<const float*>(bounds);
  float* lp = static_cast<float*>(leaf);
  float* predp = static_cast<float*>(preds);
  Route rt = route;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int table = route.nodes * static_cast<int>(sizeof(int));
  const void* kernels[2][2] = {
      {reinterpret_cast<const void*>(leaf_values_kernel<false, false>),
       reinterpret_cast<const void*>(leaf_values_kernel<false, true>)},
      {reinterpret_cast<const void*>(leaf_values_kernel<true, false>),
       reinterpret_cast<const void*>(leaf_values_kernel<true, true>)}};
  const void* kernel = kernels[with_next][with_lanes];
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kLeafThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the cluster form's configuration at c blocks a lane
  const auto cluster_config = [&](int c) {
    const int per = n_leaves * c <= 2 * kLeafThreads ? n_leaves : (n_leaves + c - 1) / c;
    cfg.gridDim = dim3(c, lanes);
    cfg.dynamicSmemBytes = (n_leaves + c * per) * static_cast<int>(sizeof(ulonglong2)) +
                           table + n_leaves * static_cast<int>(sizeof(float));
    attr[0].val.clusterDim.x = c;
    cudaError_t err = shared_limit(kernel, &leaf_smem_raised[with_next][with_lanes],
                                   static_cast<int>(cfg.dynamicSmemBytes));
    if (err == cudaSuccess && c > 8 && !leaf_wide_clusters[with_next][with_lanes]) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err == cudaSuccess) leaf_wide_clusters[with_next][with_lanes] = true;
    }
    return err;
  };
  cudaError_t err;
  if (shape == 0) {                          // lanes: the shape from the card's wave
    shape = 2;
    for (int c = cluster; c >= 2; c /= 2) {
      if ((err = cluster_config(c)) != cudaSuccess) return static_cast<int>(err);
      const int wave = wave_size(kernel, &cfg, kLeafThreads,
                                 static_cast<int>(cfg.dynamicSmemBytes),
                                 &leaf_wave[with_next][c]);
      if (wave < 0) return -wave;
      if (lanes <= wave) {
        cluster = c;
        shape = 1;
        break;
      }
    }
  }
  if (shape == 2) {                          // one block a lane
    const LeafBlockKernel forms[2][2] = {
        {leaf_values_block_kernel<false, 512>, leaf_values_block_kernel<false, 1024>},
        {leaf_values_block_kernel<true, 512>, leaf_values_block_kernel<true, 1024>}};
    const int smem = n_leaves * static_cast<int>(sizeof(ulonglong2)) + table +
                     n_leaves * static_cast<int>(sizeof(float));
    int wide = 1;
    for (; wide >= 0; --wide) {              // 1,024 threads where a wave holds them
      const void* k = reinterpret_cast<const void*>(forms[with_next][wide]);
      err = shared_limit(k, &leaf_block_smem_raised[with_next][wide], smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      const int wave = wave_size(k, nullptr, 512 << wide, smem,
                                 &leaf_block_wave[with_next][wide]);
      if (wave < 0) return -wave;
      if (lanes <= wave || wide == 0) break;
    }
    forms[with_next][wide]<<<lanes, 512 << wide, smem, s>>>(
        pp, n, gp, hp, n_leaves, lamp, scalep, bp, lp, predp, next, rt);
    return static_cast<int>(cudaGetLastError());
  }
  if ((err = cluster_config(cluster)) != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&pp, &n, &gp, &hp, &n_leaves, &lam, &scale, &lamp, &scalep,
                  &bp, &lp, &predp, const_cast<NextTree*>(&next), &rt};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scratch, all from the wrapper: rows int32 [n]; plan: f64 [4], then int32
// [4 max_items + acc_slots + 2]; acc int64 [acc_slots * F * 128]. The
// plan's sizes follow from rows_per_item and own_rows: max_items = n_nodes +
// n / rows_per_item, acc_slots = min(n_nodes, n / (own_rows + 1)).
// n_bins is uint8 [F], the occupied bins of each feature, or null for 64.
// The parent split, in every entry point that reads positions: f_l, b_l
// int32 [lanes][route_nodes], the parent level's features and bins (route_nodes
// 0: none, pos holds the level's own positions); feats and bins int32 at the
// parent level's first node of the tree of lane 0, tree_lane words apart.
// With one, pos holds the parent level's positions; K3 and the fused search
// route them in place, K5 reads them and leaves them as they are.
extern "C" int bbbp_forest_level_histogram(const void* xb, int n, int F,
                                           const void* pos, const void* g,
                                           const void* h, int n_nodes,
                                           const void* bounds,
                                           const void* n_bins, int tile_feats,
                                           int threads, int rows_per_item,
                                           int own_rows, void* rows, void* plan,
                                           void* acc, void* out,
                                           const void* f_l, const void* b_l,
                                           int route_nodes, void* feats, void* bins,
                                           void* stream) {
  Route route;
  if (!parent_route(xb, F, f_l, b_l, route_nodes, feats, bins, 0, n_nodes, &route))
    return static_cast<int>(cudaErrorInvalidValue);
  return level_histogram(xb, n, F, pos, g, h, n_nodes, bounds, n_bins, tile_feats,
                         threads, rows_per_item, own_rows, rows, plan, acc, out, 1,
                         0, route, stream);
}

// K3 with a lane axis: `lanes` fits over one xb (see level_histogram).
extern "C" int bbbp_forest_level_histogram_lanes(
    const void* xb, int n, int F, const void* pos, const void* g, const void* h,
    int n_nodes, const void* bounds, const void* n_bins, int tile_feats,
    int threads, int rows_per_item, int own_rows, void* rows, void* plan,
    void* acc, void* out, const void* f_l, const void* b_l, int route_nodes,
    void* feats, void* bins, long long tree_lane, int lanes, long long lane_words,
    void* stream) {
  Route route;
  if (!parent_route(xb, F, f_l, b_l, route_nodes, feats, bins, tree_lane, n_nodes, &route))
    return static_cast<int>(cudaErrorInvalidValue);
  return level_histogram(xb, n, F, pos, g, h, n_nodes, bounds, n_bins, tile_feats,
                         threads, rows_per_item, own_rows, rows, plan, acc, out,
                         lanes, lane_words, route, stream);
}

// The split search of one level over `lanes` fits in one pass, K3's sums and
// K4's pick without the histogram in device memory (see level_splits):
// feat, bin, has_split [lanes][n_nodes] equal bbbp_forest_best_splits_lanes
// on bbbp_forest_level_histogram_lanes's histogram, per node mode.
extern "C" int bbbp_forest_level_splits_lanes(
    const void* xb, int n, int F, const void* pos, const void* g, const void* h,
    int n_nodes, const void* bounds, const void* n_bins, const void* col_mask,
    const void* lams, float min_child, int rows_per_item, int own_rows,
    int run, void* rows, void* plan, void* acc, void* cand,
    void* feat, void* bin, void* has_split, const void* f_l, const void* b_l,
    int route_nodes, void* feats, void* bins, long long tree_lane, int lanes,
    long long lane_words, void* stream) {
  Route route;
  if (!parent_route(xb, F, f_l, b_l, route_nodes, feats, bins, tree_lane, n_nodes, &route))
    return static_cast<int>(cudaErrorInvalidValue);
  return level_splits(xb, n, F, pos, g, h, n_nodes, bounds, n_bins, col_mask, lams,
                      min_child, rows_per_item, own_rows, run, rows, plan,
                      acc, cand, feat, bin, has_split, lanes, lane_words, route, stream);
}

// The oblivious split search of one level over `lanes` fits in one pass (see
// level_splits_oblivious): feat, bin, has_split [lanes][n_nodes] equal
// bbbp_forest_best_splits_lanes on bbbp_forest_level_histogram_lanes's
// histogram, oblivious mode, with no histogram in device memory.
extern "C" int bbbp_forest_level_splits_oblivious_lanes(
    const void* xb, int n, int F, const void* pos, const void* g, const void* h,
    int n_nodes, const void* bounds, const void* col_mask, const void* lams,
    float min_child, void* rows, void* plan, void* cand, void* feat, void* bin,
    void* has_split, const void* f_l, const void* b_l, int route_nodes, void* feats,
    void* bins, long long tree_lane, int lanes, long long lane_words, void* stream) {
  Route route;
  if (!parent_route(xb, F, f_l, b_l, route_nodes, feats, bins, tree_lane, n_nodes, &route))
    return static_cast<int>(cudaErrorInvalidValue);
  return level_splits_oblivious(xb, n, F, pos, g, h, n_nodes, bounds, col_mask, lams,
                                min_child, rows, plan, cand, feat, bin, has_split, lanes,
                                lane_words, route, stream);
}

// scratch: int32 [2 * n_cand] candidates: n_cand = ceil(F / 4) in oblivious
// mode, n_nodes * ceil(F / 64) per node when F > 64, else unused
extern "C" int bbbp_forest_best_splits(const void* hist, int n_nodes, int F,
                                       const void* col_mask, float lam,
                                       float min_child, int oblivious,
                                       void* scratch, void* feat, void* bin,
                                       void* has_split, void* stream) {
  return best_splits(hist, n_nodes, F, col_mask, lam, nullptr, min_child, oblivious,
                     scratch, feat, bin, has_split, 1, stream);
}

// K4 with a lane axis and a lambda a lane (see best_splits).
extern "C" int bbbp_forest_best_splits_lanes(const void* hist, int n_nodes, int F,
                                             const void* col_mask, const void* lams,
                                             float min_child, int oblivious,
                                             void* scratch, void* feat, void* bin,
                                             void* has_split, int lanes,
                                             void* stream) {
  return best_splits(hist, n_nodes, F, col_mask, 0.f, lams, min_child, oblivious,
                     scratch, feat, bin, has_split, lanes, stream);
}

// K5. The leaves of one tree and the margin update; with y, also the next
// tree's (g, h) and bounds. One launch: `cluster` blocks of kLeafThreads in
// one thread block cluster (at most 16). xb [n, F] for the parent split.
extern "C" int bbbp_forest_leaf_values(const void* pos, int n, const void* g,
                                       const void* h, int n_leaves, float lam,
                                       float scale, const void* bounds,
                                       void* leaf, void* preds, const void* y,
                                       const void* u, const void* w_rows,
                                       float subsample, int cls, void* g_next,
                                       void* h_next, void* bounds_next,
                                       int cluster, const void* xb, int F,
                                       const void* f_l, const void* b_l,
                                       int route_nodes, void* feats, void* bins,
                                       void* stream) {
  Route route;
  if (!parent_route(xb, F, f_l, b_l, route_nodes, feats, bins, 0, n_leaves, &route))
    return static_cast<int>(cudaErrorInvalidValue);
  return leaf_values(pos, n, g, h, n_leaves, lam, scale, nullptr, nullptr, bounds,
                     leaf, preds, y, u, w_rows, subsample, nullptr, cls, g_next,
                     h_next, bounds_next, cluster, 1, 1, route, stream);
}

// K5 with a lane axis: lam, scale and subsample a lane, the launch shape
// chosen from the lanes (shape 0) or given (see leaf_values).
extern "C" int bbbp_forest_leaf_values_lanes(
    const void* pos, int n, const void* g, const void* h, int n_leaves,
    const void* lams, const void* scales, const void* bounds, void* leaf,
    void* preds, const void* y, const void* u, const void* w_rows,
    const void* subsamples, int cls, void* g_next, void* h_next,
    void* bounds_next, int cluster, int shape, const void* xb, int F,
    const void* f_l, const void* b_l, int route_nodes, void* feats, void* bins,
    long long tree_lane, int lanes, void* stream) {
  Route route;
  if (!parent_route(xb, F, f_l, b_l, route_nodes, feats, bins, tree_lane, n_leaves,
                    &route))
    return static_cast<int>(cudaErrorInvalidValue);
  return leaf_values(pos, n, g, h, n_leaves, 0.f, 0.f, lams, scales, bounds, leaf,
                     preds, y, u, w_rows, 1.f, subsamples, cls, g_next, h_next,
                     bounds_next, cluster, shape, lanes, route, stream);
}
