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
// Here the recurrence runs as a chunked scan over time (kernels/rglru.py::
// rglru_plain repeats this arithmetic in torch).  h_t = a_t·h_{t−1} + b_t is
// linear in h, so a chunk of kChunkLen steps maps its incoming state h_in
// to P·h_in + h_loc, where P is the product of the chunk's a and h_loc the
// chunk's scan from h = 0.  P is built as 1 − Q, Q = Q·a + (1 − a) from
// Q = 0 (1 − a is exact for a ≥ 1/2): a plain running product P·a of
// decays near 1 starts at 1 and stays on the grid just below it, where
// its roundings take one sign step after step, and at long memory (a ≈
// 0.9999) the fold adds that bias up over the chunks; Q is small, and
// its roundings are relative to itself.  (tests/
// test_torch_recurrent_kernels.py holds the plain version to 1e-5 of an
// fp64 scan over 4096 such steps, which the product form fails.)  Two
// launches:
//   1. rglru_chunk_kernel, grid (⌈D/128⌉, N − 1, B) for N = ⌈S/kChunkLen⌉
//      chunks: thread (channel, chunk) scans its chunk from 0 and writes
//      (P, h_loc) to an fp32 scratch of (B, N − 1, D, 2) (the last chunk's
//      pair is never read);
//   2. rglru_apply_kernel, grid (⌈D/128⌉, N, B): thread (channel, chunk n)
//      starts from h0 (or 0), folds in the pairs of chunks 0 … n−1 in that
//      order, h = P·h + h_loc, then scans its own chunk again from that
//      state, writing y; the last chunk writes hT.
// One call is one launch when S ≤ kChunkLen (pass 1 has nothing to do).
// Within a chunk both passes run the sequential step exactly; only a
// chunk's incoming state goes through the pairs.  Every product and sum
// rounds on its own (__fmul_rn/__fadd_rn, never contracted into an FMA),
// Q's one step at a time.  The fold's order is fixed, and no block waits
// on or reads another block's progress (no atomics, no look-back): affine
// maps in floating point do not compose associatively, so a varying
// order would give results that vary from run to run; this one repeats
// bitwise.  At a chunk boundary the carried state differs from the
// sequential one by the roundings of Q (kChunkLen of them, relative to
// Q), of P = 1 − Q and of the fold, a few ε relative, and no more is
// added per chunk than that: a ∈ (0, 1], so P never overflows, the fold
// never divides, and an old error is decayed, not grown.  The pair loads
// of the fold and the inputs' loads of kAhead steps are issued before
// their arithmetic: they do not depend on h, so only the multiply-add
// chain through h stays serial.  A thread past D returns, which gives the same
// numbers for any D (the TPU kernel padded D to a multiple of d_block,
// :55-63).  softplus is jax.nn.softplus's form, log1p(exp(−|Λ|)) +
// max(Λ, 0).
//
// Bound on the H100: bytes.  At the path's shape (B 1, S 4096, D 2560, bf16
// x/g_r/g_i/y) the function moves 4 · 2 B · 4096 · 2560 = 83.9 MB, 0.025 ms
// at 3.35 TB/s; its ~16 fp32 operations an element are 0.0025 ms at 67
// TFLOP/s.  The chunked form reads x, g_r and g_i twice (pass 1 and pass
// 2: 63 + 84 MB, 0.044 ms) and recomputes the gates' transcendentals in
// both passes; in exchange the path's shape gives 20 × 64 = 1,280 blocks
// of 128 threads instead of 20, so the card's memory latency is covered.
// The (P, h_loc) scratch (1.3 MB there) stays in L2.  What the card said
// (H100 80GB HBM3, 700 W; PERF.md §6): loads issued 4 steps ahead beat 16
// (fp32 most: pass 2 then needs 48 registers a thread, not 121, and the
// extra warps an SM hide more latency than the deeper prefetch did); the
// chunk length (32, 64, 128) and 256-thread blocks moved the time by 3%
// or less.  It runs at 0.092 ms there, 3.7× the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunkLen = 64;        // steps a chunk (CHUNK in kernels/rglru.py)
constexpr int kAhead = 4;            // steps (or pairs) whose loads are issued together
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

// one step of the recurrence; returns the new h and the step's decay a
__device__ __forceinline__ float step(float h, float coef, float x, float gr, float gi,
                                      float& a) {
  const float r = sigmoid(gr);
  const float i = sigmoid(gi);
  a = expf(__fmul_rn(coef, r));
  const float beta = sqrtf(fmaxf(__fsub_rn(1.f, __fmul_rn(a, a)), 1e-12f));
  return __fadd_rn(__fmul_rn(a, h), __fmul_rn(beta, __fmul_rn(i, x)));
}

__device__ __forceinline__ float coefficient(const float* a_param, int c) {
  const float ap = a_param[c];
  const float softplus = __fadd_rn(log1pf(expf(-fabsf(ap))), fmaxf(ap, 0.f));
  return __fmul_rn(-kC, softplus);
}

// `len` steps of channel c from h, starting at element `off` of (batch, s,
// d) with stride dd between steps.  kApply writes y; otherwise the steps'
// decays go into q ← q·a + (1 − a).  Returns the last h.
template <typename T, bool kApply>
__device__ __forceinline__ float scan(const T* __restrict__ x, const T* __restrict__ gr,
                                      const T* __restrict__ gi, T* __restrict__ y,
                                      size_t off, size_t dd, int len, float coef,
                                      float h, float& q) {
  int t = 0;
  for (; t + kAhead <= len; t += kAhead, off += kAhead * dd) {
    float xv[kAhead], rv[kAhead], iv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      xv[u] = to_f32(x[off + u * dd]);
      rv[u] = to_f32(gr[off + u * dd]);
      iv[u] = to_f32(gi[off + u * dd]);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      float a;
      h = step(h, coef, xv[u], rv[u], iv[u], a);
      if (kApply) y[off + u * dd] = from_f32<T>(h);
      else q = __fadd_rn(__fmul_rn(q, a), __fsub_rn(1.f, a));
    }
  }
  for (; t < len; ++t, off += dd) {
    float a;
    h = step(h, coef, to_f32(x[off]), to_f32(gr[off]), to_f32(gi[off]), a);
    if (kApply) y[off] = from_f32<T>(h);
    else q = __fadd_rn(__fmul_rn(q, a), __fsub_rn(1.f, a));
  }
  return h;
}

// pass 1: chunk n of channel c from h = 0 → carry[b, n, c] = (1 − Q, h_loc)
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_chunk_kernel(const T* __restrict__ x, const T* __restrict__ gr,
                   const T* __restrict__ gi, const float* __restrict__ a_param,
                   float2* __restrict__ carry, int s, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  if (c >= d) return;
  const float coef = coefficient(a_param, c);
  const int t0 = n * kChunkLen;
  const size_t dd = static_cast<size_t>(d);
  float q = 0.f;
  const float h = scan<T, false>(x, gr, gi, nullptr,
                                 (static_cast<size_t>(b) * s + t0) * dd + c, dd,
                                 min(kChunkLen, s - t0), coef, 0.f, q);
  carry[(static_cast<size_t>(b) * gridDim.y + n) * dd + c] =
      make_float2(__fsub_rn(1.f, q), h);
}

// pass 2: chunk n of channel c from its incoming state, folded from h0 and
// the pairs of chunks 0 … n−1 in order; writes y, and hT from the last chunk
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_apply_kernel(const T* __restrict__ x, const T* __restrict__ gr,
                   const T* __restrict__ gi, const float* __restrict__ a_param,
                   const float* __restrict__ h0, const float2* __restrict__ carry,
                   T* __restrict__ y, float* __restrict__ h_out, int s, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  if (c >= d) return;
  const size_t dd = static_cast<size_t>(d);
  float h = h0 ? h0[static_cast<size_t>(b) * d + c] : 0.f;
  const float2* pair = carry + static_cast<size_t>(b) * (gridDim.y - 1) * dd + c;
  int m = 0;
  for (; m + kAhead <= n; m += kAhead, pair += kAhead * dd) {
    float2 pv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) pv[u] = pair[u * dd];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) h = __fadd_rn(__fmul_rn(pv[u].x, h), pv[u].y);
  }
  for (; m < n; ++m, pair += dd) {
    const float2 pv = *pair;
    h = __fadd_rn(__fmul_rn(pv.x, h), pv.y);
  }
  const float coef = coefficient(a_param, c);
  const int t0 = n * kChunkLen;
  float unused = 0.f;
  h = scan<T, true>(x, gr, gi, y, (static_cast<size_t>(b) * s + t0) * dd + c, dd,
                    min(kChunkLen, s - t0), coef, h, unused);
  if (n == static_cast<int>(gridDim.y) - 1) h_out[static_cast<size_t>(b) * d + c] = h;
}

template <typename T>
int launch(const void* x, const void* gr, const void* gi, const void* a_param,
           const void* h0, void* carry, void* y, void* h_out, int batch, int s, int d,
           void* stream) {
  if (batch > 0 && d > 0) {
    const int chunks = s > 0 ? (s + kChunkLen - 1) / kChunkLen : 1;
    const unsigned col_blocks = (d + kThreads - 1) / kThreads;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (chunks > 1) {
      rglru_chunk_kernel<T><<<dim3(col_blocks, chunks - 1, batch), kThreads, 0, st>>>(
          static_cast<const T*>(x), static_cast<const T*>(gr), static_cast<const T*>(gi),
          static_cast<const float*>(a_param), static_cast<float2*>(carry), s, d);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    rglru_apply_kernel<T><<<dim3(col_blocks, chunks, batch), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(gr), static_cast<const T*>(gi),
        static_cast<const float*>(a_param), static_cast<const float*>(h0),
        static_cast<const float2*>(carry), static_cast<T*>(y), static_cast<float*>(h_out),
        s, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, gr, gi, y: (batch, s, d) contiguous; a_param (d,), h0 (batch, d) or
// null, h_out (batch, d), all fp32; carry: fp32 scratch of (batch,
// ⌈s/kChunkLen⌉ − 1, d, 2), 8-byte aligned (unused when s ≤ kChunkLen)

extern "C" int cello_rglru_bf16(const void* x, const void* gr, const void* gi,
                                const void* a_param, const void* h0, void* carry, void* y,
                                void* h_out, int batch, int s, int d, void* stream) {
  return launch<__nv_bfloat16>(x, gr, gi, a_param, h0, carry, y, h_out, batch, s, d,
                               stream);
}

extern "C" int cello_rglru_f32(const void* x, const void* gr, const void* gi,
                               const void* a_param, const void* h0, void* carry, void* y,
                               void* h_out, int batch, int s, int d, void* stream) {
  return launch<float>(x, gr, gi, a_param, h0, carry, y, h_out, batch, s, d, stream);
}
