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
// into a few cache lines per instruction.
//
// B3 (the same kernel with kSliced) replaces repro/exec/pallas.py:616
// `_spmv_sliced_tile` together with its arrangement, :300
// `_StreamCall._arrange` (kernels/spmv.py::arrange here).  It runs an spmv op
// whose operand holds an overbooked pin: a row prefix [0, prefix_rows) that
// the plan keeps resident while the tail streams.  On the TPU the prefix
// blocks stayed in VMEM across every grid step (constant index maps) and each
// tail tile streamed once.  On Hopper the only on-chip store that outlives a
// launch, and so spans the 65 SpMV launches of one cg_sparse run(), is the
// 50 MB L2, so the residency control is a cache policy chosen per load, route
// (b): the prefix rows make a policy with
// `createpolicy.fractional.L2::evict_last` (fraction 1.0) and load their
// indices and values through `ld.global.nc.L2::cache_hint` (the read-only
// path of B2's `const __restrict__` loads); tail rows load as B2's do.
//
// Why route (b) and not an L2 access-policy window (route (a)): it sets no
// device-wide state (nothing to reset or restore when a run ends); the policy
// is part of the instructions, so a captured CUDA graph replays it; and the
// prefix is already one contiguous range of `indices` and of `data` (CSR rows
// are in order), so no packed layout is built.
//
// What the card said (H100 80GB HBM3, 700 W, chip_smoke.py; PERF.md holds the
// numbers): the hint does not make the prefix resident at this shape.
// evict_last lines are kept preferentially only within the persisting
// set-aside (cudaLimitPersistingL2CacheSize, 9.8 MB in force, at most
// 32.8 MB), smaller than the path's prefix (27.6 MB in fp32, 41.4 MB in
// fp64), and B3 runs 20-37% slower than B2 on the same operand.  A
// set-aside raised toward the prefix's bytes slowed B3 and B2 further (the
// L2 left for normal lines shrinks), so the port sets none.
//
// Bound of B3: bytes.  With the prefix held in L2 a call must read from device
// memory only the tail's entries ((4 + sizeof(T)) B each), indptr (4(n+1) B)
// and x, and write y.  At cg_sparse(n=131072, banded, bandwidth 16) with the
// 40 MiB plan's prefix of 104596 rows (3451532 of 4325104 entries): fp32
// 8.6 MB, 2.6 us at 3.35 TB/s (all operand bytes: 36.2 MB, 10.8 us); fp64
// 13.1 MB, 3.9 us (all operand bytes: 54.5 MB, 16.3 us).  One thread per row
// spreads a warp's loads over 32 rows' segments, so the kernel is bound by
// load issue before bytes; B2 reads at about 1.7x its all-bytes bound with
// much of the operand in L2.  (One warp per row with a shuffle chain in the
// same add order was 2x slower: the 33 dependent adds a row set its time.)
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ int load_hinted(const int* p, uint64_t pol) {
  int v;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ float load_hinted(const float* p, uint64_t pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" : "=f"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ double load_hinted(const double* p, uint64_t pol) {
  double v;
  asm("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;" : "=d"(v) : "l"(p), "l"(pol));
  return v;
}

// kSliced: B3, rows [0, prefix_rows) load evict_last; otherwise B2.
template <typename T, bool kSliced>
__global__ void csr_spmv_kernel(const int* __restrict__ indptr,
                                const int* __restrict__ indices,
                                const T* __restrict__ data,
                                const T* __restrict__ x,
                                T* __restrict__ y, int rows, int prefix_rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const int end = indptr[i + 1];
  T acc = T(0);
  if (kSliced && i < prefix_rows) {
    const uint64_t pol = policy_evict_last();
    for (int e = indptr[i]; e < end; ++e) {
      const int col = load_hinted(indices + e, pol);
      acc = add_rn(acc, mul_rn(load_hinted(data + e, pol), x[col]));
    }
  } else {
    for (int e = indptr[i]; e < end; ++e) {
      acc = add_rn(acc, mul_rn(data[e], x[indices[e]]));
    }
  }
  y[i] = acc;
}

template <typename T, bool kSliced>
int launch(const void* indptr, const void* indices, const void* data,
           const void* x, void* y, int rows, int prefix_rows, void* stream) {
  constexpr int kThreads = 256;
  if (rows > 0) {
    const int blocks = (rows + kThreads - 1) / kThreads;
    csr_spmv_kernel<T, kSliced><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(indptr), static_cast<const int*>(indices),
        static_cast<const T*>(data), static_cast<const T*>(x), static_cast<T*>(y), rows,
        prefix_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cello_spmv_f32(const void* indptr, const void* indices, const void* data,
                              const void* x, void* y, int rows, void* stream) {
  return launch<float, false>(indptr, indices, data, x, y, rows, 0, stream);
}

extern "C" int cello_spmv_f64(const void* indptr, const void* indices, const void* data,
                              const void* x, void* y, int rows, void* stream) {
  return launch<double, false>(indptr, indices, data, x, y, rows, 0, stream);
}

extern "C" int cello_spmv_sliced_f32(const void* indptr, const void* indices, const void* data,
                                     const void* x, void* y, int rows, int prefix_rows,
                                     void* stream) {
  return launch<float, true>(indptr, indices, data, x, y, rows, prefix_rows, stream);
}

extern "C" int cello_spmv_sliced_f64(const void* indptr, const void* indices, const void* data,
                                     const void* x, void* y, int rows, int prefix_rows,
                                     void* stream) {
  return launch<double, true>(indptr, indices, data, x, y, rows, prefix_rows, stream);
}
