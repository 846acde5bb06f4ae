// B2's designs that were tried on the card and not kept, for
// scripts/b2_shapes.py to time beside the kept ones.  Not part of the
// library: the script compiles this file after src/repro_torch/csrc/spmv.cu
// in one translation unit (it uses that file's helpers) and calls the
// launchers through C entries of its own.  Each keeps B2's add order (a
// row's rounded products added in entry order from zero), so each is held
// bitwise against the ordered plain version.
//
// * staged: CTA-wide windows of entries staged in shared memory by 16-byte
//   cp.async copies (two buffers, unaligned arrays by a scalar head), all
//   threads forming a window's products over the staged values, each row's
//   owner folding them in order (the design first proposed for B2);
// * direct: the same CTA-wide windows, the entries read straight into
//   registers a window ahead, only the products in shared memory;
// * warps with cache hints or a vector fold (b2x_warps_kernel);
// * piped: the warps form with the next step's gathers in flight during
//   the fold;
// * cluster: x held in a cluster's distributed shared memory.
#include <cooperative_groups.h>

namespace {

// the entry at the start of the 16-byte chunk of src that holds entry e
// (src need not be 16-byte aligned; the result may be negative)
template <typename E>
__device__ __forceinline__ int chunk_start(const E* src, int e) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(E));
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(src) / sizeof(E)) % kPer);
  return ((e + mis) & ~(kPer - 1)) - mis;
}

// stage entries [e0, e1) of src (n entries in all) into dst as 16-byte
// chunks, thread tid of kThreads: entry e lands at dst[e - chunk_start(src,
// e0)].  A chunk that starts before src[0] is copied entry by entry, the
// bytes of a chunk past src[n - 1] are zero-filled.
template <int kThreads, typename E>
__device__ __forceinline__ void stage_unaligned(E* dst, const E* __restrict__ src, int e0, int e1,
                                                int n, int tid) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(E));
  const int c0 = chunk_start(src, e0);
  const int c1 = chunk_start(src, e1 + kPer - 1);
  for (int c = c0 + tid * kPer; c < c1; c += kThreads * kPer) {
    if (c < 0) {
      for (int q = -c; q < kPer && c + q < n; ++q) dst[q] = src[c + q];
    } else {
      const int left = n - c;
      cp_async16(dst + (c - c0), src + c, left >= kPer ? 16 : left * static_cast<int>(sizeof(E)),
                 kNoHint, 0);
    }
  }
}

// one window of a row group: the group is rows [ga, gb), its entries
// [indptr[ga], end), the window [e0, e1)
struct B2Span {
  int ga, gb, e0, e1, end;
};

template <int kThreads, int kWin>
__device__ __forceinline__ B2Span b2_group(const int* __restrict__ indptr, int ga, int r1) {
  const int gb = min(ga + kThreads, r1);
  const int e0 = indptr[ga], end = indptr[gb];
  return {ga, gb, e0, min(end, e0 + kWin), end};
}

// acc plus p[lo], p[lo + 1], ..., p[hi - 1], added in that order, the
// next kAhead products loaded while the current kAhead are added
template <int kAhead, typename T>
__device__ __forceinline__ T fold_ahead(T acc, const T* p, int lo, int hi) {
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

// as fold_ahead, reading p (16-byte aligned) by 16-byte vectors: the
// head to a vector boundary by scalars, then a vector ahead of the adds
template <typename V, typename T>
__device__ __forceinline__ T fold_vectors(T acc, const T* p, int lo, int hi) {
  constexpr int kV = static_cast<int>(sizeof(V) / sizeof(T));
  int k = lo;
  for (; k < hi && k % kV; ++k) acc = add_rn(acc, p[k]);
  if (k + kV <= hi) {
    V a = *reinterpret_cast<const V*>(p + k);
    for (k += kV; k + kV <= hi; k += kV) {
      const V nx = *reinterpret_cast<const V*>(p + k);
      const T* av = reinterpret_cast<const T*>(&a);
#pragma unroll
      for (int q = 0; q < kV; ++q) acc = add_rn(acc, av[q]);
      a = nx;
    }
    const T* av = reinterpret_cast<const T*>(&a);
#pragma unroll
    for (int q = 0; q < kV; ++q) acc = add_rn(acc, av[q]);
  }
  for (; k < hi; ++k) acc = add_rn(acc, p[k]);
  return acc;
}
__device__ __forceinline__ float fold_vec(float acc, const float* p, int lo, int hi) {
  return fold_vectors<float4>(acc, p, lo, hi);
}
__device__ __forceinline__ double fold_vec(double acc, const double* p, int lo, int hi) {
  return fold_vectors<double2>(acc, p, lo, hi);
}

// a streamed entry: read once, not kept in L1 (which holds x's gathers);
// kHint 1: ld.global.cs, 2: ld.global.nc
template <int kHint = 0>
__device__ __forceinline__ int ld_stream(const int* p) {
  int v;
  if (kHint == 1) return __ldcs(p);
  if (kHint == 2) return __ldg(p);
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
template <int kHint = 0>
__device__ __forceinline__ float ld_stream(const float* p) {
  float v;
  if (kHint == 1) return __ldcs(p);
  if (kHint == 2) return __ldg(p);
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
template <int kHint = 0>
__device__ __forceinline__ double ld_stream(const double* p) {
  double v;
  if (kHint == 1) return __ldcs(p);
  if (kHint == 2) return __ldg(p);
  asm("ld.global.nc.L1::no_allocate.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}
// staged: CTA blockIdx.x owns the rows whose first entry lies in
// [blockIdx.x * kEnt, (blockIdx.x + 1) * kEnt); `entries` is data.numel()
template <typename T, int kThreads, int kWin, int kEnt>
__global__ void __launch_bounds__(kThreads)
    b2x_staged_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                           const T* __restrict__ data, const T* __restrict__ x,
                           T* __restrict__ y, int rows, int entries) {
  static_assert(kWin % kThreads == 0 && kThreads >= 64, "");
  constexpr int kPer = kWin / kThreads;   // entries a thread in the products
  __shared__ __align__(16) WindowOf<T, kWin> buf[2];
  __shared__ int bounds[2];
  const int tid = static_cast<int>(threadIdx.x);
  if (tid < 64) {                         // warp 0: the first row, warp 1: one past the last
    const long long key = (static_cast<long long>(blockIdx.x) + (tid >> 5)) * kEnt;
    const int r = first_row_at(indptr, 0, rows, key, tid & 31);
    if ((tid & 31) == 0) bounds[tid >> 5] = r;
  }
  __syncthreads();
  const int r0 = bounds[0], r1 = bounds[1];
  if (r0 == r1) return;

  auto fetch = [&](const B2Span& w, int to) {
    stage_unaligned<kThreads>(buf[to].idx, indices, w.e0, w.e1, entries, tid);
    stage_unaligned<kThreads>(buf[to].val, data, w.e0, w.e1, entries, tid);
    cp_async_commit();
  };
  B2Span cur = b2_group<kThreads, kWin>(indptr, r0, r1);
  fetch(cur, 0);
  int b = 0;
  int row = r0 + tid;
  int rs = row < cur.gb ? indptr[row] : 0;
  int re = row < cur.gb ? indptr[row + 1] : 0;
  T acc = T(0);
  for (;;) {
    cp_async_wait<0>();
    __syncthreads();                      // the window has landed; the other buffer is free
    B2Span nxt = cur;
    bool more = true;
    if (cur.e1 < cur.end) {
      nxt.e0 = cur.e1;
      nxt.e1 = min(cur.end, cur.e1 + kWin);
    } else if (cur.gb < r1) {
      nxt = b2_group<kThreads, kWin>(indptr, cur.gb, r1);
    } else {
      more = false;
    }
    if (more) fetch(nxt, b ^ 1);
    // the products, every thread kPer entries, their gathers in flight together
    const int n = cur.e1 - cur.e0;
    const int* sidx = buf[b].idx + (cur.e0 - chunk_start(indices, cur.e0));
    T* sval = buf[b].val + (cur.e0 - chunk_start(data, cur.e0));
    int c[kPer];
    T xs[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = tid + k * kThreads;
      c[k] = j < n ? sidx[j] : 0;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) xs[k] = tid + k * kThreads < n ? x[c[k]] : T(0);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = tid + k * kThreads;
      if (j < n) sval[j] = mul_rn(sval[j], xs[k]);
    }
    __syncthreads();                      // the products are in place
    // the fold: this thread's row, its products of the window in entry order
    acc = fold_ahead<8>(acc, sval, max(rs, cur.e0) - cur.e0, min(re, cur.e1) - cur.e0);
    if (cur.e1 == cur.end && row < cur.gb) y[row] = acc;
    if (!more) break;
    if (nxt.ga != cur.ga) {
      row = nxt.ga + tid;
      rs = row < nxt.gb ? indptr[row] : 0;
      re = row < nxt.gb ? indptr[row + 1] : 0;
      acc = T(0);
    }
    cur = nxt;
    b ^= 1;
  }
}

template <typename T, int kThreads, int kWin, int kEnt>
int launch_b2x_staged(const void* indptr, const void* indices, const void* data, const void* x,
                     void* y, int rows, int entries, void* stream) {
  b2x_staged_kernel<T, kThreads, kWin, kEnt>
      <<<entries / kEnt + 1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(indptr), static_cast<const int*>(indices),
          static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y), rows,
          entries);
  return static_cast<int>(cudaGetLastError());
}

// direct: each window's indices and data read by all
// threads straight into registers (coalesced, a window ahead), the products
// alone in shared memory (two buffers, one barrier a window)
template <typename T, int kThreads, int kWin, int kEnt, int kMinCtas, int kAhead>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    b2x_direct_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                           const T* __restrict__ data, const T* __restrict__ x,
                           T* __restrict__ y, int rows, int entries) {
  static_assert(kWin % kThreads == 0 && kThreads >= 64, "");
  constexpr int kPer = kWin / kThreads;
  __shared__ __align__(16) T prod[2][kWin];
  __shared__ int bounds[2];
  const int tid = static_cast<int>(threadIdx.x);
  b2_block_rows(indptr, rows, static_cast<long long>(blockIdx.x) * kEnt, kEnt, bounds, tid);
  const int r0 = bounds[0], r1 = bounds[1];
  if (r0 == r1) return;
  int c[kPer];
  T v[kPer];
  auto load = [&](const B2Span& w, int* cc, T* vv) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = w.e0 + tid + k * kThreads;
      cc[k] = e < w.e1 ? ld_stream<>(indices + e) : 0;
      vv[k] = e < w.e1 ? ld_stream<>(data + e) : T(0);
    }
  };
  B2Span cur = b2_group<kThreads, kWin>(indptr, r0, r1);
  load(cur, c, v);
  int b = 0;
  int row = r0 + tid;
  int rs = row < cur.gb ? indptr[row] : 0;
  int re = row < cur.gb ? indptr[row + 1] : 0;
  T acc = T(0);
  for (;;) {
    B2Span nxt = cur;
    bool more = true;
    if (cur.e1 < cur.end) {
      nxt.e0 = cur.e1;
      nxt.e1 = min(cur.end, cur.e1 + kWin);
    } else if (cur.gb < r1) {
      nxt = b2_group<kThreads, kWin>(indptr, cur.gb, r1);
    } else {
      more = false;
    }
    int cn[kPer];
    T vn[kPer];
    if (more) load(nxt, cn, vn);
    const int n = cur.e1 - cur.e0;
    T xs[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) xs[k] = tid + k * kThreads < n ? x[c[k]] : T(0);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = tid + k * kThreads;
      if (j < n) prod[b][j] = mul_rn(v[k], xs[k]);
    }
    __syncthreads();                      // the products are in place
    acc = kAhead ? fold_ahead<kAhead ? kAhead : 1>(acc, prod[b], max(rs, cur.e0) - cur.e0,
                                                      min(re, cur.e1) - cur.e0)
                 : fold_vec(acc, prod[b], max(rs, cur.e0) - cur.e0, min(re, cur.e1) - cur.e0);
    if (cur.e1 == cur.end && row < cur.gb) y[row] = acc;
    if (!more) break;
    if (nxt.ga != cur.ga) {
      row = nxt.ga + tid;
      rs = row < nxt.gb ? indptr[row] : 0;
      re = row < nxt.gb ? indptr[row + 1] : 0;
      acc = T(0);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      c[k] = cn[k];
      v[k] = vn[k];
    }
    cur = nxt;
    b ^= 1;
  }
}

template <typename T, int kThreads, int kWin, int kEnt, int kMinCtas = 1, int kAhead = 8>
int launch_b2x_direct(const void* indptr, const void* indices, const void* data, const void* x,
                     void* y, int rows, int entries, void* stream) {
  b2x_direct_kernel<T, kThreads, kWin, kEnt, kMinCtas, kAhead>
      <<<entries / kEnt + 1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(indptr), static_cast<const int*>(indices),
          static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y), rows,
          entries);
  return static_cast<int>(cudaGetLastError());
}

// the blocks form (csr_spmv_blocks_kernel) with the streamed loads' cache hint
// (kSH 0: ld.global.nc.L1::no_allocate, 1: ld.global.cs, the kept one, 2:
// ld.global.nc) and the fold by scalars (kVec 0, 4 ahead, kept) or by
// 16-byte vectors (kVec 1).  CTA b owns the rows whose first entry lies in
// [b kEnt, (b + 1) kEnt), and warp w of it those in its kEnt / kWarps share.
// A warp walks its rows 32 at a time, a lane a row, and their entries in
// steps of 32 kChunks: each lane loads kChunks entries (coalesced, a step
// ahead), gathers and multiplies them, the products go to the warp's buffer
// in shared memory, and each lane adds its row's products of the step in
// entry order.  No barrier across warps.
template <typename T, int kWarps, int kChunks, int kEnt, int kSH = 0, int kVec = 0>
__global__ void __launch_bounds__(kWarps * 32)
    b2x_warps_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                          const T* __restrict__ data, const T* __restrict__ x,
                          T* __restrict__ y, int rows, int entries) {
  static_assert(kEnt % kWarps == 0, "");
  constexpr int kStep = 32 * kChunks;
  constexpr int kWarpEnt = kEnt / kWarps;
  __shared__ __align__(16) T prod[kWarps][kStep];
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
      c[q] = e < end ? ld_stream<kSH>(indices + e) : 0;
      v[q] = e < end ? ld_stream<kSH>(data + e) : T(0);
    }
    T acc = T(0);
    for (int base = start; base < end; base += kStep) {
      int cn[kChunks];
      T vn[kChunks];
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {     // the next step's entries
        const int e = base + kStep + q * 32 + lane;
        cn[q] = e < end ? ld_stream<kSH>(indices + e) : 0;
        vn[q] = e < end ? ld_stream<kSH>(data + e) : T(0);
      }
      T xs[kChunks];
#pragma unroll
      for (int q = 0; q < kChunks; ++q)
        xs[q] = base + q * 32 + lane < end ? x[c[q]] : T(0);
#pragma unroll
      for (int q = 0; q < kChunks; ++q) buf[q * 32 + lane] = mul_rn(v[q], xs[q]);
      __syncwarp();
      acc = kVec ? fold_vec(acc, buf, max(rs, base) - base, min(re, base + kStep) - base)
                 : fold_ahead<4>(acc, buf, max(rs, base) - base, min(re, base + kStep) - base);
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

template <typename T, int kWarps, int kChunks, int kEnt, int kSH = 0, int kVec = 0>
int launch_b2x_warps(const void* indptr, const void* indices, const void* data, const void* x,
                    void* y, int rows, int entries, void* stream) {
  b2x_warps_kernel<T, kWarps, kChunks, kEnt, kSH, kVec>
      <<<entries / kEnt + 1, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(indptr), static_cast<const int*>(indices),
          static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y), rows,
          entries);
  return static_cast<int>(cudaGetLastError());
}

// piped: the blocks form with step i's gathers in flight while step i - 1
// is folded, step i + 1's entries loaded
template <typename T, int kWarps, int kChunks, int kEnt>
__global__ void __launch_bounds__(kWarps * 32)
    b2x_piped_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                          const T* __restrict__ data, const T* __restrict__ x,
                          T* __restrict__ y, int rows, int entries) {
  static_assert(kEnt % kWarps == 0, "");
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
    // step s covers [start + s kStep, ...); held: xv/v of the current step
    // (gathers in flight), c1/v1 of the next
    int c1[kChunks];
    T v[kChunks], v1[kChunks], xv[kChunks];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int e = start + q * 32 + lane;
      const int c = e < end ? ld_stream<1>(indices + e) : 0;
      v[q] = e < end ? ld_stream<1>(data + e) : T(0);
      xv[q] = e < end ? x[c] : T(0);
      const int e1 = e + kStep;
      c1[q] = e1 < end ? ld_stream<1>(indices + e1) : 0;
      v1[q] = e1 < end ? ld_stream<1>(data + e1) : T(0);
    }
    T acc = T(0);
    for (int base = start; base < end; base += kStep) {
#pragma unroll
      for (int q = 0; q < kChunks; ++q) buf[q * 32 + lane] = mul_rn(v[q], xv[q]);
      // the next step's gathers and the one after's entries, then the fold
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        const int e1 = base + kStep + q * 32 + lane;
        xv[q] = e1 < end ? x[c1[q]] : T(0);
        v[q] = v1[q];
        const int e2 = e1 + kStep;
        c1[q] = e2 < end ? ld_stream<1>(indices + e2) : 0;
        v1[q] = e2 < end ? ld_stream<1>(data + e2) : T(0);
      }
      __syncwarp();
      acc = fold_ahead<4>(acc, buf, max(rs, base) - base, min(re, base + kStep) - base);
      __syncwarp();
    }
    if (mine) y[row] = acc;
  }
}

template <typename T, int kWarps, int kChunks, int kEnt>
int launch_b2x_piped(const void* indptr, const void* indices, const void* data, const void* x,
                    void* y, int rows, int entries, void* stream) {
  b2x_piped_kernel<T, kWarps, kChunks, kEnt>
      <<<entries / kEnt + 1, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(indptr), static_cast<const int*>(indices),
          static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y), rows,
          entries);
  return static_cast<int>(cudaGetLastError());
}

// x held in a thread-block cluster's distributed shared memory: kCluster
// CTAs a slice of `slice` entries each, persistent CTAs, the blocks form's
// walk; x must fit (a launch that does not fit returns the error)
template <typename T, int kCluster, int kWarps, int kChunks, int kEnt>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kWarps * 32, 1)
    b2x_cluster_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                       const T* __restrict__ data, const T* __restrict__ x,
                       T* __restrict__ y, int rows, int entries, int cols, int slice) {
  namespace cg = cooperative_groups;
  constexpr int kStep = 32 * kChunks;
  constexpr int kWarpEnt = kEnt / kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  __shared__ T prod[kWarps][kStep];
  __shared__ int bounds[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = static_cast<int>(threadIdx.x), lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < slice; i += kWarps * 32) {
    const int g = rank * slice + i;
    xs[i] = g < cols ? x[g] : T(0);
  }
  cluster.sync();
  T* buf = prod[warp];
  const int blocks = entries / kEnt + 1;
  for (int blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const long long b0 = static_cast<long long>(blk) * kEnt;
    b2_block_rows(indptr, rows, b0, kEnt, bounds, tid);
    const int R0 = bounds[0], R1 = bounds[1];
    __syncthreads();
    if (R0 == R1) continue;
    const long long w0 = b0 + static_cast<long long>(warp) * kWarpEnt;
    const int ra = first_row_at(indptr, R0, R1, w0, lane);
    const int rb = first_row_at(indptr, ra, R1, w0 + kWarpEnt, lane);
    for (int ga = ra; ga < rb; ga += 32) {
      const int row = ga + lane;
      const bool mine = row < rb;
      const int rs = mine ? indptr[row] : 0;
      const int re = mine ? indptr[row + 1] : 0;
      const int start = __shfl_sync(0xffffffffu, rs, 0);
      const int end = __shfl_sync(0xffffffffu, re, min(rb - ga, 32) - 1);
      T acc = T(0);
      for (int base = start; base < end; base += kStep) {
        T pv[kChunks];
#pragma unroll
        for (int q = 0; q < kChunks; ++q) {
          const int e = base + q * 32 + lane;
          const int c = e < end ? __ldcs(indices + e) : 0;
          const T v = e < end ? __ldcs(data + e) : T(0);
          const unsigned r = static_cast<unsigned>(c) / static_cast<unsigned>(slice);
          const T* remote = cluster.map_shared_rank(xs, r);
          pv[q] = mul_rn(v, e < end ? remote[c - static_cast<int>(r) * slice] : T(0));
        }
#pragma unroll
        for (int q = 0; q < kChunks; ++q) buf[q * 32 + lane] = pv[q];
        __syncwarp();
        acc = fold_ahead<4>(acc, buf, max(rs, base) - base, min(re, base + kStep) - base);
        __syncwarp();
      }
      if (mine) y[row] = acc;
    }
  }
  cluster.sync();                         // no CTA leaves while its slice is read
}

template <typename T, int kCluster, int kWarps, int kChunks, int kEnt>
int launch_b2x_cluster(const void* indptr, const void* indices, const void* data, const void* x,
                       void* y, int rows, int entries, void* stream) {
  const int cols = rows;
  const int slice = (cols + kCluster - 1) / kCluster;
  const int smem = slice * static_cast<int>(sizeof(T));
  auto kernel = b2x_cluster_kernel<T, kCluster, kWarps, kChunks, kEnt>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) {
    cudaGetLastError();                   // not sticky: clear it for the next launch
    return static_cast<int>(err);
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  kernel<<<sms / kCluster * kCluster, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y), rows, entries,
      cols, slice);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
