// B8 · RG-LRU scan (recurrentgemma's recurrent block) for the LLM path.
//
// Replaces the TPU kernel repro/kernels/rglru/kernel.py:27 `_rglru_kernel`
// (launched by `rglru` at :48, `pallas_call` at :71).  That kernel ran a
// grid (batch, d_block) of parallel steps, each streaming a (1, S, d_block)
// VMEM tile and looping over time with the state h in VMEM scratch, so h
// reached HBM only as h0 and hT.  Per channel d and batch row b, over t:
//   r = σ(g_r), i = σ(g_i), a = exp(−8·softplus(Λ)·r),
//   h = a·h + sqrt(max(1 − a², 1e-12))·(i·x),   y_t = h,
// all in fp32; y is stored in x's type, hT in fp32.
//
// Here one thread owns one (b, d) channel and loops over t with h in a
// register, which takes the place of both the d_block tile and the
// sequential time loop.  Threads of a warp own neighbouring channels, so
// every load and store of a step is coalesced across d.  The loads of
// kChunk steps are issued before their arithmetic: they do not depend on
// h, so kChunk steps' worth of memory latency overlap and only the
// multiply-add chain through h stays serial.  The TPU kernel padded D to
// a multiple of d_block (:55-63); here a thread past D returns, which
// gives the same numbers for any D.  softplus is jax.nn.softplus's form,
// log1p(exp(−|Λ|)) + max(Λ, 0); products and sums round one at a time
// (__fmul_rn/__fadd_rn, no contraction into FMA), as the plain version's
// elementwise torch ops do.
//
// Bound on the H100: bytes.  At the path's shape (B 1, S 4096, D 2560, bf16
// x/g_r/g_i/y) a call moves 4 · 2 B · 4096 · 2560 = 83.9 MB, 0.025 ms at
// 3.35 TB/s; its ~15 fp32 operations an element are 0.002 ms at 67
// TFLOP/s.  It is latency-bound instead: batch 1 and D = 2560 give 20
// blocks of 128 threads, each walking 4096 dependent steps.  A later PR
// can split time into chunks (a two-pass scan over the linear recurrence)
// to fill the card.  No atomics: results repeat bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;           // steps whose loads are issued together
constexpr float kC = 8.0f;           // RGLRU_C

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float v) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v)));
}

// one step of the recurrence; returns the new h
__device__ __forceinline__ float step(float h, float coef, float x, float gr, float gi) {
  const float r = sigmoid(gr);
  const float i = sigmoid(gi);
  const float a = expf(__fmul_rn(coef, r));
  const float beta = sqrtf(fmaxf(__fsub_rn(1.f, __fmul_rn(a, a)), 1e-12f));
  return __fadd_rn(__fmul_rn(a, h), __fmul_rn(beta, __fmul_rn(i, x)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_kernel(const T* __restrict__ x, const T* __restrict__ gr, const T* __restrict__ gi,
             const float* __restrict__ a_param, const float* __restrict__ h0,
             T* __restrict__ y, float* __restrict__ h_out, int s, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= d) return;
  const float ap = a_param[c];
  const float softplus = __fadd_rn(log1pf(expf(-fabsf(ap))), fmaxf(ap, 0.f));
  const float coef = __fmul_rn(-kC, softplus);
  float h = h0 ? h0[static_cast<size_t>(b) * d + c] : 0.f;
  const size_t dd = static_cast<size_t>(d);
  size_t off = static_cast<size_t>(b) * s * dd + c;
  int t = 0;
  for (; t + kChunk <= s; t += kChunk, off += kChunk * dd) {
    float xv[kChunk], rv[kChunk], iv[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      xv[u] = to_f32(x[off + u * dd]);
      rv[u] = to_f32(gr[off + u * dd]);
      iv[u] = to_f32(gi[off + u * dd]);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      h = step(h, coef, xv[u], rv[u], iv[u]);
      y[off + u * dd] = from_f32<T>(h);
    }
  }
  for (; t < s; ++t, off += dd) {
    h = step(h, coef, to_f32(x[off]), to_f32(gr[off]), to_f32(gi[off]));
    y[off] = from_f32<T>(h);
  }
  h_out[static_cast<size_t>(b) * d + c] = h;
}

template <typename T>
int launch(const void* x, const void* gr, const void* gi, const void* a_param,
           const void* h0, void* y, void* h_out, int batch, int s, int d, void* stream) {
  if (batch > 0 && d > 0) {
    const dim3 grid((d + kThreads - 1) / kThreads, batch);
    rglru_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(gr), static_cast<const T*>(gi),
        static_cast<const float*>(a_param), static_cast<const float*>(h0),
        static_cast<T*>(y), static_cast<float*>(h_out), s, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, gr, gi, y: (batch, s, d) contiguous; a_param (d,), h0 (batch, d) or
// null, h_out (batch, d), all fp32
extern "C" int cello_rglru_bf16(const void* x, const void* gr, const void* gi,
                                const void* a_param, const void* h0, void* y, void* h_out,
                                int batch, int s, int d, void* stream) {
  return launch<__nv_bfloat16>(x, gr, gi, a_param, h0, y, h_out, batch, s, d, stream);
}

extern "C" int cello_rglru_f32(const void* x, const void* gr, const void* gi,
                               const void* a_param, const void* h0, void* y, void* h_out,
                               int batch, int s, int d, void* stream) {
  return launch<float>(x, gr, gi, a_param, h0, y, h_out, batch, s, d, stream);
}
