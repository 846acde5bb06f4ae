// B7 · RMSNorm, y = x · rsqrt(mean x² + eps) · (1 + w), for the LLM path.
//
// Replaces the TPU kernel repro/kernels/rmsnorm/kernel.py:21 `_rmsnorm_kernel`
// (launched by `rmsnorm` at :28, `pallas_call` at :36).  That kernel took a
// (row_block × D) VMEM tile per grid step and fused the mean-of-squares with
// the normalise-and-scale, so x is read from HBM once and y written once.
//
// Here one block owns one row.  Each thread adds the squares of the row's
// elements i ≡ tid (mod 256) in ascending i, in fp32; the 256 partial sums
// are folded by a fixed butterfly inside each warp and then across the 8
// warps in warp order, so the sum (and the result) repeats bitwise from run
// to run with no atomics.  w stays fp32; the product is cast to the input
// type once, at the store.
//
// Bound on the H100: bytes.  A call reads x and w and writes y: at the LLM
// path's D = 4096 in bf16 that is 16 KB a row, so the prefill's 1024 rows
// move ~16.8 MB (~5 us at 3.35 TB/s) and a decode step's 4 rows ~82 KB,
// where the launch itself dominates.  The row is read twice (sum, then
// scale); the second read hits L1/L2 (8 KB a row in bf16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ y, int d, float eps) {
  __shared__ float warp_sums[kThreads / 32];
  __shared__ float inv_rms;
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* yr = y + static_cast<size_t>(blockIdx.x) * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
    inv_rms = rsqrtf(__fdiv_rn(total, static_cast<float>(d)) + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    yr[i] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(xr[i]), r), __fadd_rn(1.f, w[i])));
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int rows, int d, double eps,
           void* stream) {
  if (rows > 0) {
    rmsnorm_kernel<T><<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(y), d,
        static_cast<float>(eps));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cello_rmsnorm_bf16(const void* x, const void* w, void* y, int rows, int d,
                                  double eps, void* stream) {
  return launch<__nv_bfloat16>(x, w, y, rows, d, eps, stream);
}

extern "C" int cello_rmsnorm_f32(const void* x, const void* w, void* y, int rows, int d,
                                 double eps, void* stream) {
  return launch<float>(x, w, y, rows, d, eps, stream);
}
