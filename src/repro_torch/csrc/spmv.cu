// B2 and B3 · CSR sparse matrix-vector product, y = A x, for the CUDA backend.
//
// B2 replaces the TPU kernel repro/exec/pallas.py:595 `_spmv_row_tile` (the
// row-tile body of the `spmv-stream` pass built at :427 `_StreamCall._build`).
// That kernel held the whole CSR triple in VMEM and, for every row tile, ran
// a masked segment-sum over all nnz entries, so each grid step cost O(nnz).
//
// Here one thread owns one row: it reads indptr[i], indptr[i+1] directly and
// adds that row's products in ascending entry order, starting from zero, with
// no atomics.  That is the add order of the reference rule
// (repro/exec/reference.py:67-75: products in entry order through a
// sequential segment sum), so the result repeats bitwise from run to run.
//
// Rounding: the products and sums use __fmul_rn/__fadd_rn (__dmul_rn/__dadd_rn
// for fp64) so that nvcc cannot contract them into fused multiply-adds; every
// product is rounded before it is added, as in the reference.
//
// Bound on the H100: bytes.  Per call it reads indptr (4(n+1) B), indices and
// data (4 + sizeof(T) B per entry) and x, and writes y; at the 5-point
// Laplacian with n = 2^20 in fp32 that is about 54 MB, about 16 us at
// 3.35 TB/s.  The gathers x[indices[e]] hit L2 (x is 4 MB), and a warp's 32
// rows read 32 neighbouring row segments of indices/data, so loads coalesce
// into a few cache lines per instruction at 5 entries a row.
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
// B3's staged lane form at prefix 0 (16 lanes a thread) were each slower.
//
// B3's lane form (`spmv_tiled_lanes_kernel`) is the counterpart of the TPU
// kernel :616 under jax.vmap (CompiledPlan.batched() on an overbooked plan):
// L SpMVs, lane-major x (L, n) and y (L, rows), against one operand whose
// row prefix is pinned.  It keeps B3's design (128-row tiles, windows of the
// tile's indices and data staged in shared memory by cp.async, double
// buffered, the prefix tiles' copies evict_last and the tail's evict_first)
// and adds B2's lane group: each thread carries kLaneGroup accumulators, so
// each staged window serves the 16 lanes of a group and the operand is read
// from memory once per group.  A second grid axis walks the groups (lanes
// past L skip by a uniform branch; no lane writes outside y).  Each lane
// adds its row's products in ascending entry order from zero with B2's
// rounded products and adds, so every lane is bitwise equal to single-
// request B3 (and so to B2) on that lane alone.
// Bound: bytes, as B3's: with the prefix in L2, the tail's entries, indptr,
// then x and y of every lane; x[l][col] is gathered through L1/L2.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

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

template <typename T>
int launch_b2(const void* indptr, const void* indices, const void* data,
              const void* x, void* y, int rows, void* stream) {
  constexpr int kThreads = 256;
  if (rows > 0) {
    const int blocks = (rows + kThreads - 1) / kThreads;
    csr_spmv_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y), rows);
  }
  return static_cast<int>(cudaGetLastError());
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

// One window buffer: entry e of the window [e0, e1) sits at [e - (e0 rounded
// down to 16 bytes)].  Both arrays start 16-byte aligned.
template <typename T>
struct Window {
  int idx[kWindow + kSlack];
  T val[kWindow + kSlack];
};
static_assert(sizeof(Window<float>) % 16 == 0 && sizeof(Window<double>) % 16 == 0, "");
static_assert((sizeof(int) * (kWindow + kSlack)) % 16 == 0, "");

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
// in all: the bytes of a chunk past nnz are zero-filled)
template <typename E>
__device__ __forceinline__ void stage(E* dst, const E* __restrict__ src, int e0, int e1, int nnz,
                                      int hint, uint64_t pol) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(E));
  const int c0 = e0 & ~(kPer - 1);
  const int c1 = (e1 + kPer - 1) & ~(kPer - 1);
  for (int c = c0 + static_cast<int>(threadIdx.x) * kPer; c < c1; c += kTileRows * kPer) {
    const int left = nnz - c;
    cp_async16(dst + (c - c0), src + c, left >= kPer ? 16 : left * static_cast<int>(sizeof(E)),
               hint, pol);
  }
}

struct Span {
  int tile, e0, e1, end;    // window [e0, e1) of the tile's entries [.., end)
};

__device__ __forceinline__ Span first_window(const int* __restrict__ indptr, int tile, int rows) {
  const int r0 = tile * kTileRows;
  const int e0 = indptr[r0];
  const int end = indptr[min(r0 + kTileRows, rows)];
  return {tile, e0, end - e0 > kWindow ? e0 + kWindow : end, end};
}

__device__ __forceinline__ Span next_window(const int* __restrict__ indptr, const Span& w,
                                            int rows) {
  if (w.e1 < w.end)
    return {w.tile, w.e1, w.end - w.e1 > kWindow ? w.e1 + kWindow : w.end, w.end};
  const int tiles = (rows + kTileRows - 1) / kTileRows;
  const int t = w.tile + static_cast<int>(gridDim.x);
  return t < tiles ? first_window(indptr, t, rows) : Span{t, 0, 0, 0};
}

// stage window w of the tile's entries into `to`: a tile wholly inside the
// prefix with the evict_last policy, the tail's with evict_first, none when
// there is no prefix; one cp.async group
template <typename T>
__device__ __forceinline__ void fetch_window(const Span& w, Window<T>& to,
                                             const int* __restrict__ indices,
                                             const T* __restrict__ data, int nnz, int rows,
                                             int prefix_rows, uint64_t pol_last,
                                             uint64_t pol_first) {
  const bool in_prefix = min((w.tile + 1) * kTileRows, rows) <= prefix_rows;
  const int hint = prefix_rows == 0 ? kNoHint : (in_prefix ? kEvictLast : kEvictFirst);
  const uint64_t pol = in_prefix ? pol_last : pol_first;
  stage(to.idx, indices, w.e0, w.e1, nnz, hint, pol);
  stage(to.val, data, w.e0, w.e1, nnz, hint, pol);
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
    fetch_window(w, to, indices, data, nnz, rows, prefix_rows, pol_last, pol_first);
  };

  Span cur = first_window(indptr, blockIdx.x, rows);
  fetch(cur, buf[0]);
  int b = 0;
  int row = cur.tile * kTileRows + static_cast<int>(threadIdx.x);
  int rs = row < rows ? indptr[row] : 0;
  int re = row < rows ? indptr[row + 1] : 0;
  T acc = T(0);
  for (;;) {
    const Span nxt = next_window(indptr, cur, rows);
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

// B3's lane form: spmv_tiled_kernel's walk over tiles and windows, with
// kLaneGroup accumulators a thread (lanes blockIdx.y * kLaneGroup + g)
template <typename T>
__global__ void __launch_bounds__(kTileRows)
    spmv_tiled_lanes_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                            const T* __restrict__ data, const T* __restrict__ x,
                            T* __restrict__ y, int rows, int cols, int lanes, int prefix_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  Window<T>* buf = reinterpret_cast<Window<T>*>(smem);
  constexpr int kPerT = 16 / static_cast<int>(sizeof(T));
  const int tiles = (rows + kTileRows - 1) / kTileRows;
  if (static_cast<int>(blockIdx.x) >= tiles) return;
  const int l0 = static_cast<int>(blockIdx.y) * kLaneGroup;
  const int nl = min(kLaneGroup, lanes - l0);
  const T* __restrict__ xl = x + static_cast<size_t>(l0) * cols;
  T* __restrict__ yl = y + static_cast<size_t>(l0) * rows;
  const int nnz = indptr[rows];
  const uint64_t pol_last = make_policy(prefix_rows > 0 ? kEvictLast : kNoHint);
  const uint64_t pol_first = make_policy(prefix_rows > 0 ? kEvictFirst : kNoHint);

  auto fetch = [&](const Span& w, Window<T>& to) {
    fetch_window(w, to, indices, data, nnz, rows, prefix_rows, pol_last, pol_first);
  };

  Span cur = first_window(indptr, blockIdx.x, rows);
  fetch(cur, buf[0]);
  int b = 0;
  int row = cur.tile * kTileRows + static_cast<int>(threadIdx.x);
  int rs = row < rows ? indptr[row] : 0;
  int re = row < rows ? indptr[row + 1] : 0;
  T acc[kLaneGroup];
#pragma unroll
  for (int g = 0; g < kLaneGroup; ++g) acc[g] = T(0);
  for (;;) {
    const Span nxt = next_window(indptr, cur, rows);
    const bool more = nxt.tile < tiles;
    if (more) {
      fetch(nxt, buf[b ^ 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                      // the current window has landed
    const int lo = max(rs, cur.e0), hi = min(re, cur.e1);
    const int* sidx = buf[b].idx + (lo - (cur.e0 & ~3));
    const T* sval = buf[b].val + (lo - (cur.e0 & ~(kPerT - 1)));
    const int n = max(hi - lo, 0);
    for (int k = 0; k < n; ++k) {         // each entry once for the group
      const int c = sidx[k];
      const T v = sval[k];
#pragma unroll
      for (int g = 0; g < kLaneGroup; ++g) {
        if (g < nl) acc[g] = add_rn(acc[g], mul_rn(v, xl[static_cast<size_t>(g) * cols + c]));
      }
    }
    if (cur.e1 == cur.end && row < rows) {
#pragma unroll
      for (int g = 0; g < kLaneGroup; ++g) {
        if (g < nl) yl[static_cast<size_t>(g) * rows + row] = acc[g];
      }
    }
    __syncthreads();                      // the buffer is read: it may be refilled
    if (!more) break;
    if (nxt.tile != cur.tile) {
      row = nxt.tile * kTileRows + static_cast<int>(threadIdx.x);
      rs = row < rows ? indptr[row] : 0;
      re = row < rows ? indptr[row + 1] : 0;
#pragma unroll
      for (int g = 0; g < kLaneGroup; ++g) acc[g] = T(0);
    }
    cur = nxt;
    b ^= 1;
  }
}

struct TiledLaunch {
  cudaError_t err;
  int blocks_per_sm, sms;
};

// the shared-memory attribute and the blocks that fit on the card, for one
// of the tiled kernels (B3 or its lane form)
template <typename T, typename Kernel>
TiledLaunch tiled_setup(Kernel kernel) {
  TiledLaunch s{cudaSuccess, 0, 0};
  const int smem = static_cast<int>(2 * sizeof(Window<T>));
  int dev = 0;
  s.err = cudaGetDevice(&dev);
  if (s.err == cudaSuccess)
    s.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (s.err == cudaSuccess)
    s.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.blocks_per_sm, kernel, kTileRows,
                                                          smem);
  if (s.err == cudaSuccess)
    s.err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
  if (s.err == cudaSuccess && s.blocks_per_sm < 1) s.err = cudaErrorInvalidConfiguration;
  return s;
}

template <typename T>
int launch_b3(const void* indptr, const void* indices, const void* data, const void* x, void* y,
              int rows, int prefix_rows, void* stream) {
  // once per instantiation, at the first call: not during a CUDA-graph capture
  static const TiledLaunch setup = tiled_setup<T>(spmv_tiled_kernel<T>);
  if (setup.err != cudaSuccess) return static_cast<int>(setup.err);
  if ((reinterpret_cast<uintptr_t>(indices) | reinterpret_cast<uintptr_t>(data)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (rows > 0) {
    const int tiles = (rows + kTileRows - 1) / kTileRows;
    const int blocks = min(tiles, setup.blocks_per_sm * setup.sms);
    spmv_tiled_kernel<T><<<blocks, kTileRows, 2 * sizeof(Window<T>),
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y), rows,
        prefix_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_b3_lanes(const void* indptr, const void* indices, const void* data, const void* x,
                    void* y, int rows, int cols, int lanes, int prefix_rows, void* stream) {
  // once per instantiation, at the first call: not during a CUDA-graph capture
  static const TiledLaunch setup = tiled_setup<T>(spmv_tiled_lanes_kernel<T>);
  if (setup.err != cudaSuccess) return static_cast<int>(setup.err);
  if ((reinterpret_cast<uintptr_t>(indices) | reinterpret_cast<uintptr_t>(data)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (rows > 0 && lanes > 0) {
    const int tiles = (rows + kTileRows - 1) / kTileRows;
    const dim3 grid(min(tiles, setup.blocks_per_sm * setup.sms),
                    (lanes + kLaneGroup - 1) / kLaneGroup);
    spmv_tiled_lanes_kernel<T><<<grid, kTileRows, 2 * sizeof(Window<T>),
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y), rows, cols,
        lanes, prefix_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cello_spmv_f32(const void* indptr, const void* indices, const void* data,
                              const void* x, void* y, int rows, void* stream) {
  return launch_b2<float>(indptr, indices, data, x, y, rows, stream);
}

extern "C" int cello_spmv_f64(const void* indptr, const void* indices, const void* data,
                              const void* x, void* y, int rows, void* stream) {
  return launch_b2<double>(indptr, indices, data, x, y, rows, stream);
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
