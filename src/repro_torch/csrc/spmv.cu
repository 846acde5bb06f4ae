// B2 and B3 · CSR sparse matrix-vector product, y = A x, for the CUDA backend.
//
// B2 replaces the TPU kernel repro/exec/pallas.py:595 `_spmv_row_tile` (the
// row-tile body of the `spmv-stream` pass built at :427 `_StreamCall._build`).
// That kernel held the whole CSR triple in VMEM and, for every row tile, ran
// a masked segment-sum over all nnz entries, so each grid step cost O(nnz).
//
// B2 keeps the reference rule's add order (repro/exec/reference.py:67-75:
// products in entry order through a sequential segment sum): each row's
// products are rounded (__fmul_rn / __dmul_rn, so that nvcc cannot contract
// them into fused multiply-adds) and added with __fadd_rn / __dadd_rn from
// zero in ascending entry order, with no atomics.  The result repeats
// bitwise from run to run; B3 and the two lane forms keep the same order
// and equal it bitwise, as does B2's first kernel (scripts/b2_vs_parent.py).
// Two forms, picked by b2_shape from the entries a row, data.numel() / rows:
//
// * rows (`csr_spmv_kernel`, below kB2BlocksMinPerRow): one thread a row
//   walks indptr[i]..indptr[i+1].  At a few entries a row a warp's 32 rows
//   read neighbouring row segments, so its loads coalesce.
// * blocks (`csr_spmv_blocks_kernel`): the entries are cut into ranges of
//   E = kB2Entries.  CTA b owns the whole rows whose first entry lies in
//   [b E, (b + 1) E), and each of its kB2Warps warps the rows that start in
//   its share of E: a row never splits, so its adds stay in order.  Two
//   warps find the CTA's rows by a 32-ary search of indptr, then each warp
//   its own among them: no host sync, no scratch, so a CUDA graph captures
//   it.  The grid is data.numel() / E + 1 CTAs, so that every row start up
//   to data.numel() has one owner: empty rows, trailing empty rows, nnz ==
//   0, and a mesh shard's padded window (indptr[rows] < data.numel(), the
//   arrays at any alignment).  A warp takes its rows 32 at a time, a lane a
//   row, and walks their entries in steps of 64 (128 below kB2LongRow
//   entries a row): each lane reads 2 (4) entries of indices and data,
//   coalesced, a step ahead and streamed past L1 (ld.global.cs), gathers
//   x and rounds the products into the warp's buffer in shared memory;
//   then each lane adds its row's products of the step to its sum in entry
//   order.  Only the adds are serial, and no barrier spans warps.
//
// Bound on the H100: bytes, indptr (4(n+1) B), indices and data
// ((4 + sizeof(T)) B an entry) and x once, y written: the 5-point Laplacian
// at n = 2^20, fp32, 54.5 MB (0.0163 ms at 3.35 TB/s); bicgstab_sparse's
// random pattern (n 131072, 17.2 M entries), 139 MB (0.0415 ms).  Beneath
// it lie the gathers x[indices[e]], one random 4- or 8-byte read an entry,
// each a 32-byte sector from L1 or L2.  On an H100 80GB HBM3 (700 W;
// chip_smoke.py's gather floor, PERF.md §6) the random operand's 17.2 M
// gathers alone take 0.116 ms fp32 / 0.122 fp64, 0.124 / 0.129 with its
// indices read: 2.8x / 2.0x the bytes bound, and the floor of every design.
//
// What the card said (scripts/b2_shapes.py, ms fp32 / fp64): on the random
// operand the blocks form takes 0.153 / 0.164 (the rows form 0.199 / 0.263,
// cuSPARSE 0.152 / 0.159); on the banded one (33 a row) 0.0165 / 0.0233
// (rows 0.0205 / 0.0360); on a skewed one (rows of up to 16384) 0.167 /
// 0.244 (rows 1.115 / 2.104).  The Laplacian (5 a row) and a random pattern
// of 0-39 a row keep the rows form, the faster there in fp32.  Tried and
// slower on the random operand (scripts/b2_variants.cu): CTA-wide windows
// of 1024 entries staged by 16-byte cp.async in two buffers, the products
// formed in place by all 256 threads and folded by each row's owner (the
// design first proposed) 0.167 / 0.184, its staged windows taking shared
// memory from the L1 that holds x; the same windows read into registers a
// window ahead, only the products in shared memory, 0.156 / 0.171 (the
// fastest on the skewed operand, 0.098 / 0.134: a long row's gathers spread
// over the CTA); the blocks form with ld.global.nc.L1::no_allocate or
// ld.global.nc for the stream, a 16-byte-vector fold (0.151 / 0.194), the
// next step's gathers in flight during the fold (0.154 / 0.165), steps of
// 32-256 entries, E of 4096-16384, 4-16 warps a CTA (all within 5% on the
// random operand, steps of 64 the best there and of 128-256 on the banded
// one); x held in a cluster's distributed shared memory, 4 or 8 CTAs of
// 128 KB, 0.52-0.59 / 0.63-0.68.
//
// B3 (`spmv_tiled_kernel`) replaces repro/exec/pallas.py:616
// `_spmv_sliced_tile` together with its arrangement, :300
// `_StreamCall._arrange` (kernels/spmv.py::arrange here).  It runs an spmv op
// whose operand holds an overbooked pin: a row prefix [0, prefix_rows) that
// the plan keeps resident while the tail streams.  The TPU kernel streamed
// whole row tiles of a per-tile layout; rows never split across tiles, and
// each row's products were added in entry order.  B3 keeps that structure:
//
// * A tile is kTileRows rows, one thread a row.  A block walks tiles
//   blockIdx.x, blockIdx.x + gridDim.x, ... (one wave of blocks, as many as
//   fit on the card).  For each tile it stages the tile's entry range
//   [indptr[r0], indptr[r0 + kTileRows]) of `indices` and `data` in shared
//   memory with 16-byte `cp.async` copies, coalesced: the 16-byte-aligned
//   superset of the range (the wrapper requires 16-byte-aligned arrays; the
//   bytes past nnz are zero-filled, not read).  A tile with more than
//   kWindow entries is walked in windows of kWindow; a row that spans two
//   windows keeps its running sum in its thread's register.  Two window
//   buffers: the next window (of this tile or the block's next tile) is in
//   flight while the threads sum the current one.
// * Each thread sums its row from shared memory in ascending entry order,
//   from zero, with B2's rounded products and adds: B3 is bitwise equal to
//   B2 and to its plain version.  x[indices[e]] is gathered through L1/L2.
//   Shared-memory reads: lane t reads entry indptr[row_t] + k at step k, so
//   two lanes whose rows start L entries apart hit one bank when L is a
//   multiple of 32 words; a row length L makes a gcd(L, 32)-way conflict
//   for a warp of equal rows (the banded operand's 33-entry rows: none;
//   the 5-point Laplacian's 5: none; rows of 32 entries: 32-way).
// * The prefix: when prefix_rows > 0, the copies of a tile that lies
//   wholly in [0, prefix_rows) carry an L2 evict_last policy
//   (`createpolicy` operand of `cp.async ... .L2::cache_hint`), and the
//   tail tiles' copies evict_first, so that streaming the tail does not
//   push the prefix out of L2; with prefix_rows == 0 no copy carries a
//   hint.  The policy is part of the instruction, so a captured CUDA graph
//   replays it, and no device-wide state is set (the persisting-L2
//   set-aside stays as the port finds it).
//
// Bound of B3: bytes.  With the prefix held in L2 a call must read from device
// memory only the tail's entries ((4 + sizeof(T)) B each), indptr (4(n+1) B)
// and x, and write y.  At cg_sparse(n=131072, banded, bandwidth 16) with the
// 40 MiB plan's prefix of 104596 rows (3451532 of 4325104 entries): fp32
// 8.6 MB, 2.6 us at 3.35 TB/s (all operand bytes: 36.2 MB, 10.8 us); fp64
// 13.1 MB, 3.9 us (all operand bytes: 54.5 MB, 16.3 us).
//
// What the card said (H100 80GB HBM3, 700 W, chip_smoke.py; PERF.md §6 holds
// the numbers): the one-thread-a-row B3 of earlier (B2 with the prefix's
// loads marked evict_last through `ld.global.nc.L2::cache_hint`) ran 20-37%
// slower than B2 and 1.22x cuSPARSE at this operand: at 33 entries a row
// each load instruction of a warp touched 32 rows' segments.  This tiled B3,
// back to back as a CUDA graph replays it, runs at about the all-operand
// bound in fp32 (the operand fits the 50 MB L2), ~0.6x B2's time and ahead
// of cuSPARSE; in fp64 ~0.8x B2's, a little behind cuSPARSE.  The hint pays
// a few percent over the same kernel unhinted (prefix_rows = 0), so it
// stays; a raised persisting-L2 set-aside is not needed for it.
//
// B2's lane form (`csr_spmv_lanes_kernel`) serves L requests against one
// operand at once: Y = A [x_0 ... x_{L-1}], lane-major (x and y are (L, n)).
// On the TPU a vmap gave the row-tile kernel a batch axis.  Here a block is
// kLaneRows rows by a group of kLaneGroup (16) lanes: threadIdx.x is the row,
// threadIdx.y a run of kLanesPerThread (4) lanes of the group, and a second
// grid axis walks the groups.  A thread reads each entry (col, val) of its
// row once for its 4 lanes, and the 4 lane-threads of a row share the entry
// through L1; a warp's 32 rows gather neighbouring columns of one lane (as
// B2's do), four entries' gathers in flight before their adds.  Each lane's
// sum runs from zero in ascending entry order with B2's rounded products and
// adds, so every lane is bitwise equal to B2 on that lane alone.  Lanes past
// L: a lane-thread wholly past returns, a partial run skips by a branch.
// Bound: bytes, the operand once plus, per lane, x (gathered through L2) and
// y: at the 5-point Laplacian, n = 2^20, 16 lanes, 180 MB in fp32 (0.054 ms
// at 3.35 TB/s) and 336 MB in fp64 (0.100 ms).  What the card said (H100
// 80GB HBM3, 700 W; chip_smoke.py, PERF.md §6): one thread a row carrying
// all 16 lanes (the earlier form) ran at 0.185 ms fp32, 29% of the bound,
// its 16 gathers an entry from 16 vectors 4 MB apart; 4 lanes a thread runs
// at 0.089 ms fp32 (60% of the bound) and 0.148 ms fp64 (68%), and on the
// overbooked path's banded operand at 0.060 / 0.081 ms.  One lane a thread
// (the row's entries re-read 16 times through L1), 8 lanes a thread and
// the earlier form of B3's lane form at prefix 0 (16 lanes a thread) were
// each slower.
//
// B3's lane form (`spmv_tiled_lanes_kernel`) is the counterpart of the TPU
// kernel :616 under jax.vmap (CompiledPlan.batched() on an overbooked plan):
// L SpMVs, lane-major x (L, n) and y (L, rows), against one operand whose
// row prefix is pinned.  Each lane adds its row's products in ascending
// entry order from zero with B2's rounded products and adds, so every lane
// is bitwise equal to single-request B3 (and so to B2) on that lane alone.
// It is B3's staging under B2 lanes' thread layout:
// * A block is kLaneTileRows (32) rows by the kLaneRuns (4) runs of
//   kLaneRun (4) lanes of one 16-lane group, 128 threads: threadIdx.x the
//   row, threadIdx.y the run.  A second grid axis walks the groups, and one
//   wave of blocks covers them all (two groups at 17 lanes).  A block walks
//   tiles as B3 does and stages each tile's indices and data in windows of
//   kLaneWindow (1152) entries with B3's coalesced cp.async copies, in one
//   buffer (9.3 KB fp32, 13.9 KB fp64): while a block waits for its copy,
//   the SM's other blocks (10 in fp32, 8 in fp64) add.  A 32-row tile of
//   33-entry banded rows fits one window.
// * A thread reads each staged entry once for its 4 lanes, with four
//   entries' gathers in flight before their adds.  A warp whose lanes all
//   lie past L stages and syncs but adds nothing; a partial run skips by a
//   branch.
// * What bounds it on the card is the x gathers: 16 an entry, each warp's
//   32 rows gathering neighbouring columns of one lane.  They hit L1 when
//   L1 holds the tiles' x.  The earlier form of this kernel staged two
//   4608-entry windows a block (~224 KB of shared memory an SM, L1 left
//   ~28 KB) and carried 16 lanes a thread (8-12 warps an SM).  B2's lane
//   form keeps L1 for x, but each thread loads its own row's entries, so a
//   warp's loads touch 32 row segments, and each of a row's four runs loads
//   them again.  Small staged windows keep both the coalesced copies and
//   L1 for x (~93 KB fp32 / ~111 KB fp64 of shared memory an SM).
// * The prefix, as B3's: copies of tiles wholly in the prefix evict_last,
//   the tail's evict_first, no hint at prefix_rows == 0.
// Bound: bytes, as B3's: with the prefix in L2, the tail's entries, indptr,
// then x and y of every lane.  At the overbooked path's operand (banded,
// n = 131072, bandwidth 16, prefix 104596 rows) and 16 lanes: 24.3 MB fp32
// (0.0073 ms at 3.35 TB/s), 44.6 MB fp64 (0.0133 ms); all operand bytes
// 51.9 / 86.0 MB (0.0155 / 0.0257 ms).  On that operand at 16 lanes it
// takes ~0.037 ms fp32 and ~0.056 ms fp64 on an H100 80GB HBM3 (700 W),
// against 0.086 / 0.164 ms for the earlier form and ~0.060 / ~0.082 ms
// for B2's lane form (chip_smoke.py, PERF.md §6).  Tried and slower in
// fp32, fp64 or both: two buffers a block (double the shared memory, L1
// taken from x), windows of half a tile (the rows past a window idle),
// 8 lanes a thread (more registers in fp64), 64- and 128-row tiles with
// one or two buffers, and a shared-memory carveout of 50%.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// ---------------------------------------------------------------------------
// B2
// ---------------------------------------------------------------------------

constexpr int kB2RowThreads = 256;     // threads a CTA of the rows form
constexpr int kB2Warps = 8;            // warps a CTA of the blocks form (B2_WARPS)
constexpr int kB2Entries = 8192;       // E: entries whose row starts a CTA owns (B2_BLOCK_ENTRIES)
// the rule on entries a row, data.numel() / rows: the blocks form from
// kB2BlocksMinPerRow on, in steps of 64 entries from kB2LongRow on, else 128
constexpr int kB2BlocksMinPerRow = 24;
constexpr int kB2LongRow = 64;

// the rows form: one thread a row
template <typename T>
__global__ void csr_spmv_kernel(const int* __restrict__ indptr,
                                const int* __restrict__ indices,
                                const T* __restrict__ data,
                                const T* __restrict__ x,
                                T* __restrict__ y, int rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const int end = indptr[i + 1];
  T acc = T(0);
  for (int e = indptr[i]; e < end; ++e) {
    acc = add_rn(acc, mul_rn(data[e], x[indices[e]]));
  }
  y[i] = acc;
}

// the first row r in [lo, hi) with indptr[r] >= key, hi if none, given that
// no row before lo qualifies: a 32-ary search by one whole warp (lane l
// probes lo + l * step)
__device__ __forceinline__ int first_row_at(const int* __restrict__ indptr, int lo, int hi,
                                            long long key, int lane) {
  while (lo < hi) {                       // the answer lies in [lo, hi]
    const int step = (hi - lo + 31) / 32;
    const int q = lo + lane * step;
    const unsigned below = __ballot_sync(0xffffffffu, q < hi && indptr[q] < key);
    const int c = __popc(below);          // probes 0 .. c-1 lie below key
    if (c == 0) break;                    // indptr[lo] >= key
    hi = min(hi, lo + c * step);
    lo += (c - 1) * step + 1;
  }
  return lo;
}

// acc plus p[lo], p[lo + 1], ..., p[hi - 1], added in that order, the next
// 4 products loaded while the current 4 are added
template <typename T>
__device__ __forceinline__ T fold_in_order(T acc, const T* p, int lo, int hi) {
  constexpr int kAhead = 4;
  int k = lo;
  if (hi - k >= kAhead) {
    T a[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) a[q] = p[k + q];
    for (k += kAhead; k + kAhead <= hi; k += kAhead) {
      T nx[kAhead];
#pragma unroll
      for (int q = 0; q < kAhead; ++q) nx[q] = p[k + q];
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        acc = add_rn(acc, a[q]);
        a[q] = nx[q];
      }
    }
#pragma unroll
    for (int q = 0; q < kAhead; ++q) acc = add_rn(acc, a[q]);
  }
  for (; k < hi; ++k) acc = add_rn(acc, p[k]);
  return acc;
}

// the CTA's rows [bounds[0], bounds[1]): those whose first entry lies in
// [e0, e0 + ent), found by warps 0 and 1 (every thread of the CTA calls it)
__device__ __forceinline__ void b2_block_rows(const int* __restrict__ indptr, int rows,
                                              long long e0, int ent, int* bounds, int tid) {
  if (tid < 64) {
    const int r = first_row_at(indptr, 0, rows, e0 + (tid >> 5) * static_cast<long long>(ent),
                               tid & 31);
    if ((tid & 31) == 0) bounds[tid >> 5] = r;
  }
  __syncthreads();
}

// the blocks form: CTA b owns the rows whose first entry lies in [b kEnt,
// (b + 1) kEnt), and warp w of it those in its share of kEnt / kWarps.  A
// warp walks its rows 32 at a time, a lane a row, and their entries in steps
// of 32 kChunks: each lane reads kChunks entries (coalesced, a step ahead,
// streamed past L1), gathers x and forms the products, which go to the
// warp's buffer in shared memory; then each lane adds its row's products of
// the step to its sum in entry order.  No barrier across warps after the
// search.
template <typename T, int kWarps, int kChunks, int kEnt>
__global__ void __launch_bounds__(kWarps * 32)
    csr_spmv_blocks_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                          const T* __restrict__ data, const T* __restrict__ x,
                          T* __restrict__ y, int rows) {
  static_assert(kEnt % kWarps == 0 && kWarps >= 2, "");
  constexpr int kStep = 32 * kChunks;
  constexpr int kWarpEnt = kEnt / kWarps;
  __shared__ T prod[kWarps][kStep];
  __shared__ int bounds[2];
  const int tid = static_cast<int>(threadIdx.x), lane = tid & 31, warp = tid >> 5;
  const long long b0 = static_cast<long long>(blockIdx.x) * kEnt;
  b2_block_rows(indptr, rows, b0, kEnt, bounds, tid);
  if (bounds[0] == bounds[1]) return;
  const long long w0 = b0 + static_cast<long long>(warp) * kWarpEnt;
  const int ra = first_row_at(indptr, bounds[0], bounds[1], w0, lane);
  const int rb = first_row_at(indptr, ra, bounds[1], w0 + kWarpEnt, lane);
  T* buf = prod[warp];
  for (int ga = ra; ga < rb; ga += 32) {
    const int row = ga + lane;
    const bool mine = row < rb;
    const int rs = mine ? indptr[row] : 0;
    const int re = mine ? indptr[row + 1] : 0;
    const int start = __shfl_sync(0xffffffffu, rs, 0);
    const int end = __shfl_sync(0xffffffffu, re, min(rb - ga, 32) - 1);
    int c[kChunks];
    T v[kChunks];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int e = start + q * 32 + lane;
      c[q] = e < end ? __ldcs(indices + e) : 0;
      v[q] = e < end ? __ldcs(data + e) : T(0);
    }
    T acc = T(0);
    for (int base = start; base < end; base += kStep) {
      int cn[kChunks];
      T vn[kChunks];
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {     // the next step's entries
        const int e = base + kStep + q * 32 + lane;
        cn[q] = e < end ? __ldcs(indices + e) : 0;
        vn[q] = e < end ? __ldcs(data + e) : T(0);
      }
      T xs[kChunks];
#pragma unroll
      for (int q = 0; q < kChunks; ++q) xs[q] = base + q * 32 + lane < end ? x[c[q]] : T(0);
#pragma unroll
      for (int q = 0; q < kChunks; ++q) buf[q * 32 + lane] = mul_rn(v[q], xs[q]);
      __syncwarp();
      acc = fold_in_order(acc, buf, max(rs, base) - base, min(re, base + kStep) - base);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        c[q] = cn[q];
        v[q] = vn[q];
      }
    }
    if (mine) y[row] = acc;
  }
}

template <typename T>
int launch_b2_rows(const void* indptr, const void* indices, const void* data, const void* x,
                   void* y, int rows, void* stream) {
  const int blocks = (rows + kB2RowThreads - 1) / kB2RowThreads;
  csr_spmv_kernel<T><<<blocks, kB2RowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y), rows);
  return static_cast<int>(cudaGetLastError());
}

// `entries` is data.numel(): the grid covers every row start up to it
template <typename T, int kWarps, int kChunks, int kEnt>
int launch_b2_blocks(const void* indptr, const void* indices, const void* data, const void* x,
                    void* y, int rows, int entries, void* stream) {
  csr_spmv_blocks_kernel<T, kWarps, kChunks, kEnt>
      <<<entries / kEnt + 1, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(indptr), static_cast<const int*>(indices),
          static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y), rows);
  return static_cast<int>(cudaGetLastError());
}

// B2's launch for (rows, entries), the rule of kB2BlocksMinPerRow and
// kB2LongRow: form (1 blocks, 0 rows), threads a CTA, CTAs, entries a step
// and E (0 and 0 for the rows form)
inline void b2_shape(int rows, int entries, int* out) {
  const long long n = entries, r = rows > 0 ? rows : 1;
  const bool blocks = n >= kB2BlocksMinPerRow * r;
  const int step = n >= kB2LongRow * r ? 64 : 128;
  const int shape[5] = {blocks ? 1 : 0, blocks ? kB2Warps * 32 : kB2RowThreads,
                        blocks ? entries / kB2Entries + 1
                               : (rows + kB2RowThreads - 1) / kB2RowThreads,
                        blocks ? step : 0, blocks ? kB2Entries : 0};
  for (int i = 0; i < 5; ++i) out[i] = shape[i];
}

template <typename T>
int launch_b2(const void* indptr, const void* indices, const void* data, const void* x, void* y,
              int rows, int entries, void* stream) {
  if (rows <= 0 || entries < 0) return static_cast<int>(cudaGetLastError());
  int shape[5];
  b2_shape(rows, entries, shape);
  if (shape[0] == 0) return launch_b2_rows<T>(indptr, indices, data, x, y, rows, stream);
  if (shape[3] == 64)
    return launch_b2_blocks<T, kB2Warps, 2, kB2Entries>(indptr, indices, data, x, y, rows,
                                                        entries, stream);
  return launch_b2_blocks<T, kB2Warps, 4, kB2Entries>(indptr, indices, data, x, y, rows, entries,
                                                      stream);
}

// ---------------------------------------------------------------------------
// B2's lane form
// ---------------------------------------------------------------------------

constexpr int kLaneGroup = 16;    // lanes a block carries (LANE_GROUP)
// lanes one thread of B2's lane form carries (threadIdx.y picks the run in
// the block's group), and rows a block (threadIdx.x): 64 x 4 threads
constexpr int kLanesPerThread = 4;
constexpr int kLaneThreads = kLaneGroup / kLanesPerThread;
constexpr int kLaneRows = 64;

template <typename T>
__global__ void __launch_bounds__(kLaneRows * kLaneThreads)
    csr_spmv_lanes_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                          const T* __restrict__ data, const T* __restrict__ x,
                          T* __restrict__ y, int rows, int cols, int lanes) {
  const int i = blockIdx.x * kLaneRows + threadIdx.x;
  const int l0 = blockIdx.y * kLaneGroup + threadIdx.y * kLanesPerThread;
  if (i >= rows || l0 >= lanes) return;
  const int nl = min(kLanesPerThread, lanes - l0);
  const T* __restrict__ xl = x + static_cast<size_t>(l0) * cols;
  T acc[kLanesPerThread];
#pragma unroll
  for (int g = 0; g < kLanesPerThread; ++g) acc[g] = T(0);
  const int end = indptr[i + 1];
  int e = indptr[i];
  for (; e + 4 <= end; e += 4) {          // four entries' gathers in flight
    int c[4];
    T v[4], xs[4][kLanesPerThread];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      c[q] = indices[e + q];
      v[q] = data[e + q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int g = 0; g < kLanesPerThread; ++g)
        xs[q][g] = g < nl ? xl[static_cast<size_t>(g) * cols + c[q]] : T(0);
#pragma unroll
    for (int g = 0; g < kLanesPerThread; ++g)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[g] = add_rn(acc[g], mul_rn(v[q], xs[q][g]));
  }
  for (; e < end; ++e) {
    const int c = indices[e];
    const T v = data[e];
#pragma unroll
    for (int g = 0; g < kLanesPerThread; ++g)
      if (g < nl) acc[g] = add_rn(acc[g], mul_rn(v, xl[static_cast<size_t>(g) * cols + c]));
  }
#pragma unroll
  for (int g = 0; g < kLanesPerThread; ++g) {
    if (g < nl) y[static_cast<size_t>(l0 + g) * rows + i] = acc[g];
  }
}

template <typename T>
int launch_b2_lanes(const void* indptr, const void* indices, const void* data, const void* x,
                    void* y, int rows, int cols, int lanes, void* stream) {
  if (rows > 0 && lanes > 0) {
    const dim3 grid((rows + kLaneRows - 1) / kLaneRows, (lanes + kLaneGroup - 1) / kLaneGroup);
    csr_spmv_lanes_kernel<T><<<grid, dim3(kLaneRows, kLaneThreads), 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y), rows, cols,
        lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// B3
// ---------------------------------------------------------------------------

constexpr int kTileRows = 128;    // rows a tile = threads a block (B3_TILE_ROWS)
constexpr int kWindow = 4608;     // entries a window stages (B3_WINDOW)
constexpr int kSlack = 8;         // the aligned superset's extra entries

// One window buffer of kWin entries: entry e of the window [e0, e1) sits at
// [e - (e0 rounded down to 16 bytes)].  Both arrays start 16-byte aligned.
template <typename T, int kWin>
struct WindowOf {
  static_assert(kWin % 4 == 0, "16-byte aligned arrays");
  int idx[kWin + kSlack];
  T val[kWin + kSlack];
};
template <typename T>
using Window = WindowOf<T, kWindow>;
static_assert(sizeof(Window<float>) % 16 == 0 && sizeof(Window<double>) % 16 == 0, "");

enum Hint { kNoHint = 0, kEvictLast = 1, kEvictFirst = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes, int hint,
                                           uint64_t pol) {
  if (hint == kNoHint) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes), "l"(pol));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint64_t make_policy(int hint) {
  uint64_t pol = 0;
  if (hint == kEvictLast)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  else if (hint == kEvictFirst)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

// the 16-byte chunks covering entries [e0, e1) of src into dst (nnz entries
// in all: the bytes of a chunk past nnz are zero-filled), thread tid of the
// block's kThreads
template <int kThreads, typename E>
__device__ __forceinline__ void stage(E* dst, const E* __restrict__ src, int e0, int e1, int nnz,
                                      int hint, uint64_t pol, int tid) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(E));
  const int c0 = e0 & ~(kPer - 1);
  const int c1 = (e1 + kPer - 1) & ~(kPer - 1);
  for (int c = c0 + tid * kPer; c < c1; c += kThreads * kPer) {
    const int left = nnz - c;
    cp_async16(dst + (c - c0), src + c, left >= kPer ? 16 : left * static_cast<int>(sizeof(E)),
               hint, pol);
  }
}

struct Span {
  int tile, e0, e1, end;    // window [e0, e1) of the tile's entries [.., end)
};

// tiles of kRows rows, windows of at most kWin entries
template <int kRows, int kWin>
__device__ __forceinline__ Span first_window(const int* __restrict__ indptr, int tile, int rows) {
  const int r0 = tile * kRows;
  const int e0 = indptr[r0];
  const int end = indptr[min(r0 + kRows, rows)];
  return {tile, e0, end - e0 > kWin ? e0 + kWin : end, end};
}

template <int kRows, int kWin>
__device__ __forceinline__ Span next_window(const int* __restrict__ indptr, const Span& w,
                                            int rows) {
  if (w.e1 < w.end)
    return {w.tile, w.e1, w.end - w.e1 > kWin ? w.e1 + kWin : w.end, w.end};
  const int tiles = (rows + kRows - 1) / kRows;
  const int t = w.tile + static_cast<int>(gridDim.x);
  return t < tiles ? first_window<kRows, kWin>(indptr, t, rows) : Span{t, 0, 0, 0};
}

// stage window w of the tile's entries into `to`: a tile wholly inside the
// prefix with the evict_last policy, the tail's with evict_first, none when
// there is no prefix; one cp.async group
template <int kRows, int kThreads, typename T, int kWin>
__device__ __forceinline__ void fetch_window(const Span& w, WindowOf<T, kWin>& to,
                                             const int* __restrict__ indices,
                                             const T* __restrict__ data, int nnz, int rows,
                                             int prefix_rows, uint64_t pol_last,
                                             uint64_t pol_first, int tid) {
  const bool in_prefix = min((w.tile + 1) * kRows, rows) <= prefix_rows;
  const int hint = prefix_rows == 0 ? kNoHint : (in_prefix ? kEvictLast : kEvictFirst);
  const uint64_t pol = in_prefix ? pol_last : pol_first;
  stage<kThreads>(to.idx, indices, w.e0, w.e1, nnz, hint, pol, tid);
  stage<kThreads>(to.val, data, w.e0, w.e1, nnz, hint, pol, tid);
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(kTileRows)
    spmv_tiled_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                      const T* __restrict__ data, const T* __restrict__ x, T* __restrict__ y,
                      int rows, int prefix_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  Window<T>* buf = reinterpret_cast<Window<T>*>(smem);
  constexpr int kPerT = 16 / static_cast<int>(sizeof(T));
  const int tiles = (rows + kTileRows - 1) / kTileRows;
  if (static_cast<int>(blockIdx.x) >= tiles) return;
  const int nnz = indptr[rows];
  const uint64_t pol_last = make_policy(prefix_rows > 0 ? kEvictLast : kNoHint);
  const uint64_t pol_first = make_policy(prefix_rows > 0 ? kEvictFirst : kNoHint);

  auto fetch = [&](const Span& w, Window<T>& to) {
    fetch_window<kTileRows, kTileRows>(w, to, indices, data, nnz, rows, prefix_rows, pol_last,
                                       pol_first, static_cast<int>(threadIdx.x));
  };

  Span cur = first_window<kTileRows, kWindow>(indptr, blockIdx.x, rows);
  fetch(cur, buf[0]);
  int b = 0;
  int row = cur.tile * kTileRows + static_cast<int>(threadIdx.x);
  int rs = row < rows ? indptr[row] : 0;
  int re = row < rows ? indptr[row + 1] : 0;
  T acc = T(0);
  for (;;) {
    const Span nxt = next_window<kTileRows, kWindow>(indptr, cur, rows);
    const bool more = nxt.tile < tiles;
    if (more) {
      fetch(nxt, buf[b ^ 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                      // the current window has landed
    // this thread's entries of the window, as offsets into the buffer
    const int lo = max(rs, cur.e0), hi = min(re, cur.e1);
    const int* sidx = buf[b].idx + (lo - (cur.e0 & ~3));
    const T* sval = buf[b].val + (lo - (cur.e0 & ~(kPerT - 1)));
    const int n = max(hi - lo, 0);
    int k = 0;
    for (; k + 4 <= n; k += 4) {          // four gathers in flight, adds in order
      const T x0 = x[sidx[k]], x1 = x[sidx[k + 1]], x2 = x[sidx[k + 2]], x3 = x[sidx[k + 3]];
      acc = add_rn(acc, mul_rn(sval[k], x0));
      acc = add_rn(acc, mul_rn(sval[k + 1], x1));
      acc = add_rn(acc, mul_rn(sval[k + 2], x2));
      acc = add_rn(acc, mul_rn(sval[k + 3], x3));
    }
    for (; k < n; ++k) acc = add_rn(acc, mul_rn(sval[k], x[sidx[k]]));
    if (cur.e1 == cur.end && row < rows) y[row] = acc;
    __syncthreads();                      // the buffer is read: it may be refilled
    if (!more) break;
    if (nxt.tile != cur.tile) {
      row = nxt.tile * kTileRows + static_cast<int>(threadIdx.x);
      rs = row < rows ? indptr[row] : 0;
      re = row < rows ? indptr[row + 1] : 0;
      acc = T(0);
    }
    cur = nxt;
    b ^= 1;
  }
}

// ---------------------------------------------------------------------------
// B3's lane form
// ---------------------------------------------------------------------------

constexpr int kLaneTileRows = 32;                // rows a tile (B3_LANE_ROWS in kernels/spmv.py)
constexpr int kLaneWindow = 1152;                // entries a window (B3_LANE_WINDOW)
constexpr int kLaneRun = 4;                      // lanes a thread
constexpr int kLaneRuns = kLaneGroup / kLaneRun;  // threads a row
constexpr int kLaneBlock = kLaneTileRows * kLaneRuns;
static_assert(kLaneGroup % kLaneRun == 0 && kLaneTileRows % 32 == 0, "");

template <typename T>
using LaneWindow = WindowOf<T, kLaneWindow>;

// B3's lane form: a block is kLaneTileRows rows by the kLaneRuns runs of
// kLaneRun lanes of one lane group (threadIdx.x the row, threadIdx.y the
// run); it walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... staging each
// tile's windows as B3 does, and every thread adds its row's entries of a
// window for its run of lanes, four entries' gathers in flight
template <typename T>
__global__ void __launch_bounds__(kLaneBlock)
    spmv_tiled_lanes_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                            const T* __restrict__ data, const T* __restrict__ x,
                            T* __restrict__ y, int rows, int cols, int lanes, int prefix_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  LaneWindow<T>* buf = reinterpret_cast<LaneWindow<T>*>(smem);
  constexpr int kPerT = 16 / static_cast<int>(sizeof(T));
  const int tiles = (rows + kLaneTileRows - 1) / kLaneTileRows;
  if (static_cast<int>(blockIdx.x) >= tiles) return;
  const int tid = static_cast<int>(threadIdx.y) * kLaneTileRows + static_cast<int>(threadIdx.x);
  const int l0 = static_cast<int>(blockIdx.y) * kLaneGroup +
                 static_cast<int>(threadIdx.y) * kLaneRun;
  // this warp's lanes: none past L (the warp still stages and syncs), a
  // partial run skips the rest by a branch
  const int nl = min(kLaneRun, lanes - l0);
  const T* __restrict__ xl = x + static_cast<size_t>(nl > 0 ? l0 : 0) * cols;
  const int nnz = indptr[rows];
  const uint64_t pol_last = make_policy(prefix_rows > 0 ? kEvictLast : kNoHint);
  const uint64_t pol_first = make_policy(prefix_rows > 0 ? kEvictFirst : kNoHint);

  auto fetch = [&](const Span& w, LaneWindow<T>& to) {
    fetch_window<kLaneTileRows, kLaneBlock>(w, to, indices, data, nnz, rows, prefix_rows,
                                            pol_last, pol_first, tid);
  };

  Span cur = first_window<kLaneTileRows, kLaneWindow>(indptr, blockIdx.x, rows);
  fetch(cur, *buf);
  int row = cur.tile * kLaneTileRows + static_cast<int>(threadIdx.x);
  int rs = row < rows ? indptr[row] : 0;
  int re = row < rows ? indptr[row + 1] : 0;
  T acc[kLaneRun];
#pragma unroll
  for (int g = 0; g < kLaneRun; ++g) acc[g] = T(0);
  for (;;) {
    const Span nxt = next_window<kLaneTileRows, kLaneWindow>(indptr, cur, rows);
    const bool more = nxt.tile < tiles;
    cp_async_wait<0>();
    __syncthreads();                      // the current window has landed
    if (nl > 0) {
      const int lo = max(rs, cur.e0), hi = min(re, cur.e1);
      const int* sidx = buf->idx + (lo - (cur.e0 & ~3));
      const T* sval = buf->val + (lo - (cur.e0 & ~(kPerT - 1)));
      const int n = max(hi - lo, 0);
      int k = 0;
      for (; k + 4 <= n; k += 4) {        // four entries' gathers in flight
        int c[4];
        T v[4], xs[4][kLaneRun];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          c[q] = sidx[k + q];
          v[q] = sval[k + q];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int g = 0; g < kLaneRun; ++g)
            xs[q][g] = g < nl ? xl[static_cast<size_t>(g) * cols + c[q]] : T(0);
#pragma unroll
        for (int g = 0; g < kLaneRun; ++g)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[g] = add_rn(acc[g], mul_rn(v[q], xs[q][g]));
      }
      for (; k < n; ++k) {
        const int c = sidx[k];
        const T v = sval[k];
#pragma unroll
        for (int g = 0; g < kLaneRun; ++g)
          if (g < nl) acc[g] = add_rn(acc[g], mul_rn(v, xl[static_cast<size_t>(g) * cols + c]));
      }
      if (cur.e1 == cur.end && row < rows) {
#pragma unroll
        for (int g = 0; g < kLaneRun; ++g)
          if (g < nl) y[static_cast<size_t>(l0 + g) * rows + row] = acc[g];
      }
    }
    __syncthreads();                      // the buffer is read: it may be refilled
    if (!more) break;
    fetch(nxt, *buf);
    if (nxt.tile != cur.tile) {
      row = nxt.tile * kLaneTileRows + static_cast<int>(threadIdx.x);
      rs = row < rows ? indptr[row] : 0;
      re = row < rows ? indptr[row + 1] : 0;
#pragma unroll
      for (int g = 0; g < kLaneRun; ++g) acc[g] = T(0);
    }
    cur = nxt;
  }
}

struct TiledLaunch {
  cudaError_t err;
  int blocks_per_sm, sms;
};

// the shared-memory attribute and the blocks that fit on the card, for one
// of the tiled kernels (B3 or its lane form): `threads` a block, `smem`
// bytes of dynamic shared memory
template <typename Kernel>
TiledLaunch tiled_setup(Kernel kernel, int threads, int smem) {
  TiledLaunch s{cudaSuccess, 0, 0};
  int dev = 0;
  s.err = cudaGetDevice(&dev);
  if (s.err == cudaSuccess)
    s.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (s.err == cudaSuccess)
    s.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.blocks_per_sm, kernel, threads,
                                                          smem);
  if (s.err == cudaSuccess)
    s.err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
  if (s.err == cudaSuccess && s.blocks_per_sm < 1) s.err = cudaErrorInvalidConfiguration;
  return s;
}

template <typename T>
int launch_b3(const void* indptr, const void* indices, const void* data, const void* x, void* y,
              int rows, int prefix_rows, void* stream) {
  constexpr int kSmem = 2 * sizeof(Window<T>);
  // once per instantiation, at the first call: not during a CUDA-graph capture
  static const TiledLaunch setup = tiled_setup(spmv_tiled_kernel<T>, kTileRows, kSmem);
  if (setup.err != cudaSuccess) return static_cast<int>(setup.err);
  if ((reinterpret_cast<uintptr_t>(indices) | reinterpret_cast<uintptr_t>(data)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (rows > 0) {
    const int tiles = (rows + kTileRows - 1) / kTileRows;
    const int blocks = min(tiles, setup.blocks_per_sm * setup.sms);
    spmv_tiled_kernel<T><<<blocks, kTileRows, kSmem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y), rows,
        prefix_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
constexpr int lane_smem() {
  return static_cast<int>(sizeof(LaneWindow<T>));
}

// once per instantiation, at the first call: not during a CUDA-graph capture
template <typename T>
const TiledLaunch& lane_setup() {
  static const TiledLaunch setup =
      tiled_setup(spmv_tiled_lanes_kernel<T>, kLaneBlock, lane_smem<T>());
  return setup;
}

// the lane form's launch shape: rows a tile, threads a block, dynamic shared
// bytes a block, blocks an SM, SMs, entries a window, lanes a thread
template <typename T>
int b3_lanes_shape(int* out) {
  const TiledLaunch& setup = lane_setup<T>();
  const int shape[7] = {kLaneTileRows, kLaneBlock, lane_smem<T>(), setup.blocks_per_sm,
                        setup.sms, kLaneWindow, kLaneRun};
  for (int i = 0; i < 7; ++i) out[i] = shape[i];
  return static_cast<int>(setup.err);
}

template <typename T>
int launch_b3_lanes(const void* indptr, const void* indices, const void* data, const void* x,
                    void* y, int rows, int cols, int lanes, int prefix_rows, void* stream) {
  const TiledLaunch& setup = lane_setup<T>();
  if (setup.err != cudaSuccess) return static_cast<int>(setup.err);
  if ((reinterpret_cast<uintptr_t>(indices) | reinterpret_cast<uintptr_t>(data)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (rows > 0 && lanes > 0) {
    // one wave of blocks over all the lane groups (17 lanes: two groups)
    const int tiles = (rows + kLaneTileRows - 1) / kLaneTileRows;
    const int groups = (lanes + kLaneGroup - 1) / kLaneGroup;
    const dim3 grid(min(tiles, max(1, setup.blocks_per_sm * setup.sms / groups)), groups);
    spmv_tiled_lanes_kernel<T><<<grid, dim3(kLaneTileRows, kLaneRuns), lane_smem<T>(),
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y), rows, cols,
        lanes, prefix_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cello_spmv_f32(const void* indptr, const void* indices, const void* data,
                              const void* x, void* y, int rows, int entries, void* stream) {
  return launch_b2<float>(indptr, indices, data, x, y, rows, entries, stream);
}

extern "C" int cello_spmv_f64(const void* indptr, const void* indices, const void* data,
                              const void* x, void* y, int rows, int entries, void* stream) {
  return launch_b2<double>(indptr, indices, data, x, y, rows, entries, stream);
}

extern "C" int cello_spmv_shape(int rows, int entries, int* out) {
  b2_shape(rows, entries, out);
  return 0;
}

extern "C" int cello_spmv_sliced_f32(const void* indptr, const void* indices, const void* data,
                                     const void* x, void* y, int rows, int prefix_rows,
                                     void* stream) {
  return launch_b3<float>(indptr, indices, data, x, y, rows, prefix_rows, stream);
}

extern "C" int cello_spmv_sliced_f64(const void* indptr, const void* indices, const void* data,
                                     const void* x, void* y, int rows, int prefix_rows,
                                     void* stream) {
  return launch_b3<double>(indptr, indices, data, x, y, rows, prefix_rows, stream);
}

extern "C" int cello_spmv_lanes_f32(const void* indptr, const void* indices, const void* data,
                                    const void* x, void* y, int rows, int cols, int lanes,
                                    void* stream) {
  return launch_b2_lanes<float>(indptr, indices, data, x, y, rows, cols, lanes, stream);
}

extern "C" int cello_spmv_lanes_f64(const void* indptr, const void* indices, const void* data,
                                    const void* x, void* y, int rows, int cols, int lanes,
                                    void* stream) {
  return launch_b2_lanes<double>(indptr, indices, data, x, y, rows, cols, lanes, stream);
}

extern "C" int cello_spmv_sliced_lanes_f32(const void* indptr, const void* indices,
                                           const void* data, const void* x, void* y, int rows,
                                           int cols, int lanes, int prefix_rows, void* stream) {
  return launch_b3_lanes<float>(indptr, indices, data, x, y, rows, cols, lanes, prefix_rows,
                                stream);
}

extern "C" int cello_spmv_sliced_lanes_f64(const void* indptr, const void* indices,
                                           const void* data, const void* x, void* y, int rows,
                                           int cols, int lanes, int prefix_rows, void* stream) {
  return launch_b3_lanes<double>(indptr, indices, data, x, y, rows, cols, lanes, prefix_rows,
                                 stream);
}

extern "C" int cello_spmv_sliced_lanes_shape_f32(int* out) { return b3_lanes_shape<float>(out); }

extern "C" int cello_spmv_sliced_lanes_shape_f64(int* out) { return b3_lanes_shape<double>(out); }
