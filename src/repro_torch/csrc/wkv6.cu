// B9 · WKV6 (the RWKV-6 time-mix recurrence) for the LLM path.
//
// Replaces the TPU kernel repro/kernels/rwkv6/kernel.py:26 `_wkv6_kernel`
// (launched by `wkv6` at :47, `pallas_call` at :59).  That kernel ran a grid
// (batch, heads) of parallel steps, each holding one head's E×E fp32 state
// in VMEM scratch across a fori_loop over time, so the state reached HBM
// only as s0 and sT.  Per (b, h), with the state S:
//   y_t[j] = Σ_i r_i·(S_ij + u_i·k_i·v_j),
//   S_ij  ← exp(−exp(w_i))·S_ij + k_i·v_j,
// in fp32; y is stored in r's type, sT in fp32.
//
// Here one block of 64 threads owns one (b, h), and thread j keeps column j
// of S (S_0j … S_63j) in registers for the whole sequence.  The block
// stages kSteps time steps of r, k, v and the decay exp(−exp(w)) (computed
// once, at staging) in shared memory, zero beyond E, with one barrier per
// chunk; then every thread walks the chunk's steps, reading r_i, k_i, u_i
// and the decay as broadcasts, four at a time (float4), and adding y's
// terms in four chains (i mod 4, each in ascending i) that end as
// (c0 + c1) + (c2 + c3): the chains shorten the dependent FMA sequence
// fourfold, the sum's order is fixed and results repeat bitwise.  Zero
// lanes beyond E add nothing and keep their state at 0, so E ≤ 64 needs
// no other case (the arch's E is 64; the reduced configs use 16).  The
// state's products and sums round one at a time (__fmul_rn/__fadd_rn), as
// the plain version's elementwise torch ops do; y's chains are FMAs, as a
// matrix-vector product's are.  Inputs may have any strides over (batch,
// head, position) and unit stride over E, so the model's head split (a
// transpose of (B, S, H, E)) goes in without a copy; y takes r's strides.
//
// Bound on the H100: operations.  At the path's shape (B 1, H 64, S 1024,
// E 64) the function needs 5 fp32 operations per state element and step
// (2 for y_j's Σ_i r_i·S_ij, 3 for S_ij ← d_i·S_ij + k_i·v_j; the bonus
// term is v_j·Σ_i r_i·u_i·k_i, O(E) a step, as is the decay),
// 5·S·H·E² + 7·S·H·E = 1.37 GFLOP, 0.020 ms at 67 TFLOP/s; the bytes
// (r/k/v/y in bf16, w in fp32, 12 B · 1024 · 4096 = 50.3 MB) take 0.015
// ms.  The grid is 64 blocks of 64 threads: half the SMs hold one block
// each and the rest idle, with two warps an SM to hide each step's
// latencies.  Splitting a head's columns over several blocks
// would fill the card; that is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kE = 64;               // largest head size, and threads per block
constexpr int kSteps = 32;           // time steps staged per barrier

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;                    // (heads, e)
  const float* s0;                   // (batch, heads, e, e) or null
  void* y;
  float* s_out;                      // (batch, heads, e, e)
  long long st[15];                  // (batch, head, position) strides of r, k, v, w, y
  int heads, s, e;
};

template <typename T>
__global__ void __launch_bounds__(kE) wkv6_kernel(Args a) {
  __shared__ __align__(16) float sR[kSteps][kE], sK[kSteps][kE], sV[kSteps][kE],
      sD[kSteps][kE];
  __shared__ __align__(16) float sU[kE];
  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const bool lane = j < a.e;
  const T* r = static_cast<const T*>(a.r) + b * a.st[0] + h * a.st[1];
  const T* k = static_cast<const T*>(a.k) + b * a.st[3] + h * a.st[4];
  const T* v = static_cast<const T*>(a.v) + b * a.st[6] + h * a.st[7];
  const float* w = a.w + b * a.st[9] + h * a.st[10];
  T* y = static_cast<T*>(a.y) + b * a.st[12] + h * a.st[13];
  const long long rs = a.st[2], ks = a.st[5], vs = a.st[8], ws = a.st[11], ys = a.st[14];
  const size_t sbase = (static_cast<size_t>(b) * a.heads + h) * a.e * a.e;

  sU[j] = lane ? a.u[h * a.e + j] : 0.f;
  float S[kE];
#pragma unroll
  for (int i = 0; i < kE; ++i)
    S[i] = (a.s0 && lane && i < a.e) ? a.s0[sbase + static_cast<size_t>(i) * a.e + j] : 0.f;

  for (int t0 = 0; t0 < a.s; t0 += kSteps) {
    const int n = min(kSteps, a.s - t0);
    __syncthreads();                 // the previous chunk has been read
#pragma unroll 4
    for (int tt = 0; tt < kSteps; ++tt) {
      const bool ok = lane && tt < n;
      const long long t = t0 + tt;
      sR[tt][j] = ok ? to_f32(r[t * rs + j]) : 0.f;
      sK[tt][j] = ok ? to_f32(k[t * ks + j]) : 0.f;
      sV[tt][j] = ok ? to_f32(v[t * vs + j]) : 0.f;
      sD[tt][j] = ok ? expf(-expf(w[t * ws + j])) : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sV[tt][j];
      const float4* r4 = reinterpret_cast<const float4*>(sR[tt]);
      const float4* k4 = reinterpret_cast<const float4*>(sK[tt]);
      const float4* d4 = reinterpret_cast<const float4*>(sD[tt]);
      const float4* u4 = reinterpret_cast<const float4*>(sU);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};     // one chain per i mod 4
#pragma unroll
      for (int q = 0; q < kE / 4; ++q) {
        const float4 rq = r4[q], kq = k4[q], dq = d4[q], uq = u4[q];
        const float rr[4] = {rq.x, rq.y, rq.z, rq.w}, kk[4] = {kq.x, kq.y, kq.z, kq.w};
        const float dd[4] = {dq.x, dq.y, dq.z, dq.w}, uu[4] = {uq.x, uq.y, uq.z, uq.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * q + c;
          const float kv = __fmul_rn(kk[c], vj);
          acc[c] = fmaf(rr[c], __fadd_rn(S[i], __fmul_rn(uu[c], kv)), acc[c]);
          S[i] = __fadd_rn(__fmul_rn(dd[c], S[i]), kv);
        }
      }
      if (lane) y[(t0 + tt) * ys + j] = from_f32<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }
  if (lane) {
#pragma unroll
    for (int i = 0; i < kE; ++i)
      if (i < a.e) a.s_out[sbase + static_cast<size_t>(i) * a.e + j] = S[i];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* s0, void* y, void* s_out, const long long* strides, int batch,
           int heads, int s, int e, void* stream) {
  if (e <= 0 || e > kE) return static_cast<int>(cudaErrorInvalidValue);
  Args a{r, k, v, static_cast<const float*>(w), static_cast<const float*>(u),
         static_cast<const float*>(s0), y, static_cast<float*>(s_out), {}, heads, s, e};
  for (int i = 0; i < 15; ++i) a.st[i] = strides[i];
  if (batch > 0 && heads > 0) {
    const dim3 grid(heads, batch);
    wkv6_kernel<T><<<grid, kE, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, y: bf16 or fp32 of one type; w fp32; strides: 15 element strides,
// (batch, head, position) of r, k, v, w, y in turn, unit stride over e
extern "C" int cello_wkv6_bf16(const void* r, const void* k, const void* v, const void* w,
                               const void* u, const void* s0, void* y, void* s_out,
                               const long long* strides, int batch, int heads, int s, int e,
                               void* stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, strides, batch, heads, s, e,
                               stream);
}

extern "C" int cello_wkv6_f32(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* s0, void* y, void* s_out,
                              const long long* strides, int batch, int heads, int s, int e,
                              void* stream) {
  return launch<float>(r, k, v, w, u, s0, y, s_out, strides, batch, heads, s, e, stream);
}
