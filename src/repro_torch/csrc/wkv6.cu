// B9 · WKV6 (the RWKV-6 time-mix recurrence) for the LLM path.
//
// Replaces the TPU kernel repro/kernels/rwkv6/kernel.py:26 `_wkv6_kernel`
// (launched by `wkv6` at :47, `pallas_call` at :59).  That kernel ran a grid
// (batch, heads) of parallel steps, each holding one head's E×E fp32 state
// in VMEM scratch across a fori_loop over time, so the state reached HBM
// only as s0 and sT.  Per (b, h), with the state S:
//   y_t[j] = Σ_i r_i·(S_ij + u_i·k_i·v_j),
//   S_ij  ← d_i·S_ij + k_i·v_j,   d = exp(−exp(w)),
// in fp32; y is stored in r's type, sT in fp32.
//
// Here the recurrence runs in its exact chunked form (kernels/rwkv6.py::
// wkv6_plain repeats this arithmetic in torch).  Per chunk of kChunk steps
// from the state S_0, with every decay a product of the d between two steps:
//   G_t  = Π_{τ<t} d_τ,  P_ts = Σ_i r_ti·k_si·Π_{s<τ<t} d_τi (s < t),
//   P_tt = Σ_i r_ti·u_i·k_ti,
//   y_t  = (r_t ⊙ G_t)·S_0 + Σ_{s≤t} P_ts·v_s,
//   S_C  = diag(Π_τ d_τ)·S_0 + Σ_s (k_s ⊙ Π_{τ>s} d_τ)·v_sᵀ.
// Only the chunk-to-chunk state pass is serial: S/kChunk steps, not S.
// Products, not quotients or differences of cumulative log sums: at w = 3
// a step decays by e^−20, so a cumulative sum reaches −320 within 16 steps
// (e^{+320} overflows fp32 in a factored form, and a difference of two
// sums that large keeps only ~|A|·2^−24 of relative accuracy).  A product
// of at most kChunk factors rounds kChunk times at most; one that
// underflows is below anything the output can show.  Against the JAX
// reference's sequential form the chunked plain version sits at ~3e-7 of
// the output's scale with w drawn over [−8, 3] (tests/
// test_torch_recurrent_kernels.py holds it to 1e-5).
//
// How it maps onto the card: one block per (value-column group of kCols,
// head, batch): every column of y and of S depends on its own column of S
// alone, so rwkv6-7b's shape (B 1, H 64, E 64) gives 2 × 64 = 128 blocks of
// 512 threads, one to an SM.  Per chunk:
//   1. stage r, k (fp32), d = exp(−exp(w)) and the block's v columns in
//      shared memory (zero r, k, v and d = 1 past the sequence or past E),
//      from registers loaded, in their stored types, during the previous
//      chunk's work;
//   2. eight warps: thread (s, p) walks t upward with k_s ⊙ Π d for its 4
//      channels, and 16-lane shuffle sums, issued for all t together, give
//      P_ts; beside them two warps take the prefix products (r ⊙ G) and
//      two the suffix products (k ⊙ Π_{τ>s} d), one channel a thread;
//   3. thread (t, j) forms y_t[j] from the state slice (shared memory) and
//      P, and thread (row quad, j) the next state slice, written back after
//      a barrier.
// All products are fp32 CUDA-core FMAs: the chunk's matrix products are
// 16 × 64 × 32 a block, too small for the tensor cores' tiles to pay at
// this width.  What the card said (H100 80GB HBM3, 700 W; PERF.md §6):
// the time is latency and issue, not the products: 32 columns a block
// (one block of 16 warps an SM) ran faster than 16 (two blocks of 8), which
// recompute each head's scores and decays four times over instead of twice.
//
// Bound on the H100: operations.  At the path's shape (B 1, H 64, S 1024,
// E 64) the function needs 5 fp32 operations per state element and step
// (2 for y_j's Σ_i r_i·S_ij, 3 for S_ij ← d_i·S_ij + k_i·v_j; the bonus
// term is v_j·Σ_i r_i·u_i·k_i, O(E) a step, as is the decay),
// 5·S·H·E² + 7·S·H·E = 1.37 GFLOP, 0.020 ms at 67 TFLOP/s; the bytes
// (r/k/v/y in bf16, w in fp32, 12 B · 1024 · 4096 = 50.3 MB) take 0.015
// ms.  The chunked form does about as many operations (the state's terms
// a chunk, plus 16 × 16 × 64 for P), two blocks recompute each head's P
// and decays, and each chunk costs three barriers and shared-memory loads.
// Inputs may have any strides over (batch, head, position) and unit stride
// over E, so the model's head split (a transpose of (B, S, H, E)) goes in
// without a copy; y takes r's strides.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kE = 64;               // largest head size
constexpr int kChunk = 16;           // steps a chunk (CHUNK in kernels/rwkv6.py)
constexpr int kCols = 32;            // value columns a block
constexpr int kThreads = kChunk * kCols;   // one (t, j) of y, one (row quad, j) of S
constexpr int kScorers = kChunk * 16;      // threads (s, channel quad) of the scores
constexpr int kPrefix0 = kScorers;         // then a warp pair each for the prefix
                                           // and the suffix products
constexpr int kStage = kChunk * kE / kThreads;   // r, k, w elements a thread stages
static_assert(kThreads == (kE / 4) * kCols && kThreads >= kScorers + 2 * kE, "");

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

__device__ __forceinline__ float sum16(float v) {   // over 16 aligned lanes
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wkv6_chunk_kernel(Args a) {
  __shared__ __align__(16) float sR[kChunk][kE], sK[kChunk][kE], sD[kChunk][kE];
  __shared__ __align__(16) float sRG[kChunk][kE];    // r_t ⊙ G_t
  __shared__ __align__(16) float sKD[kChunk][kE];    // k_s ⊙ Π_{τ>s} d_τ
  __shared__ __align__(16) float sV[kChunk][kCols];
  __shared__ __align__(16) float sP[kChunk][kChunk + 1];
  __shared__ __align__(16) float sS[kE][kCols];      // the state's column slice
  __shared__ __align__(16) float sU[kE], sTot[kE];
  const int j0 = blockIdx.x * kCols, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const T* r = static_cast<const T*>(a.r) + b * a.st[0] + h * a.st[1];
  const T* k = static_cast<const T*>(a.k) + b * a.st[3] + h * a.st[4];
  const T* v = static_cast<const T*>(a.v) + b * a.st[6] + h * a.st[7];
  const float* w = a.w + b * a.st[9] + h * a.st[10];
  T* y = static_cast<T*>(a.y) + b * a.st[12] + h * a.st[13];
  const long long rs = a.st[2], ks = a.st[5], vs = a.st[8], ws = a.st[11], ys = a.st[14];
  const size_t sbase = (static_cast<size_t>(b) * a.heads + h) * a.e * a.e;

  // staging: element (t = tid / kE + c · kThreads / kE, i = tid % kE) of
  // r, k, w; v's (t, jj)
  const int si = tid % kE, st0 = tid / kE;
  constexpr int kTStep = kThreads / kE;
  const int vt = tid / kCols, vj = tid % kCols;
  // y: thread (t, jj); the state update: thread (rows 4q..4q+3, jj)
  const int yt = tid / kCols, q = tid / kCols, jj = tid % kCols;
  const int jg = j0 + jj;
  // the scores: thread (s, p) over channels 4p..4p+3
  const int ps = tid / 16, pp = tid % 16;

  for (int idx = tid; idx < kE * kCols; idx += kThreads) {
    const int i = idx / kCols, c = idx % kCols;
    sS[i][c] = (a.s0 && i < a.e && j0 + c < a.e) ? a.s0[sbase + static_cast<size_t>(i) * a.e + j0 + c]
                                                 : 0.f;
  }
  if (tid < kE) sU[tid] = tid < a.e ? a.u[h * a.e + tid] : 0.f;

  // the next chunk's elements, in their stored types: converted when staged,
  // so that no instruction waits on these loads before then
  T pr[kStage], pk[kStage], pv;
  float pw[kStage];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int c = 0; c < kStage; ++c) {
      const long long t = t0 + st0 + kTStep * c;
      const bool ok = t < a.s && si < a.e;
      pr[c] = ok ? r[t * rs + si] : from_f32<T>(0.f);
      pk[c] = ok ? k[t * ks + si] : from_f32<T>(0.f);
      pw[c] = ok ? w[t * ws + si] : -CUDART_INF_F;      // d = exp(−exp(−∞)) = 1
    }
    const long long t = t0 + vt;
    pv = (t < a.s && j0 + vj < a.e) ? v[t * vs + j0 + vj] : from_f32<T>(0.f);
  };
  fetch(0);

  for (int t0 = 0; t0 < a.s; t0 += kChunk) {
    // 1. stage this chunk (the previous chunk's reads ended at a barrier)
#pragma unroll
    for (int c = 0; c < kStage; ++c) {
      sR[st0 + kTStep * c][si] = to_f32(pr[c]);
      sK[st0 + kTStep * c][si] = to_f32(pk[c]);
      sD[st0 + kTStep * c][si] = expf(-expf(pw[c]));
    }
    sV[vt][vj] = to_f32(pv);
    if (t0 + kChunk < a.s) fetch(t0 + kChunk);          // in flight during 2-3
    __syncthreads();

    // 2. the scores P_ts, and the prefix / suffix decay products
    if (tid < kScorers) {
      const float4 k4 = *reinterpret_cast<const float4*>(&sK[ps][4 * pp]);
      const float4 r4 = *reinterpret_cast<const float4*>(&sR[ps][4 * pp]);
      const float4 u4 = *reinterpret_cast<const float4*>(&sU[4 * pp]);
      const float bonus = sum16(fmaf(r4.x * u4.x, k4.x, fmaf(r4.y * u4.y, k4.y,
                                fmaf(r4.z * u4.z, k4.z, (r4.w * u4.w) * k4.w))));
      if (pp == 0) sP[ps][ps] = bonus;
      float kw[4] = {k4.x, k4.y, k4.z, k4.w};          // k_s ⊙ Π_{s<τ<t} d_τ
      float part[kChunk];                              // this lane's 4 channels of P_ts
      part[0] = 0.f;
#pragma unroll
      for (int t = 1; t < kChunk; ++t) {
        const float4 rt = *reinterpret_cast<const float4*>(&sR[t][4 * pp]);
        const float4 dp = *reinterpret_cast<const float4*>(&sD[t - 1][4 * pp]);
        if (t - 1 > ps) {
          kw[0] = kw[0] * dp.x;
          kw[1] = kw[1] * dp.y;
          kw[2] = kw[2] * dp.z;
          kw[3] = kw[3] * dp.w;
        }
        part[t] = fmaf(rt.x, kw[0], fmaf(rt.y, kw[1], fmaf(rt.z, kw[2], rt.w * kw[3])));
      }
      // the 16 lanes' sums, level by level over all t: independent shuffles
#pragma unroll
      for (int m = 8; m >= 1; m >>= 1) {
#pragma unroll
        for (int t = 1; t < kChunk; ++t) part[t] += __shfl_xor_sync(0xffffffffu, part[t], m);
      }
      if (pp == 0) {
#pragma unroll
        for (int t = 1; t < kChunk; ++t)
          if (t > ps) sP[t][ps] = part[t];
      }
    }
    if (tid >= kPrefix0 && tid < kPrefix0 + kE) {   // r ⊙ G, the chunk's decay
      const int i = tid - kPrefix0;
      float g = 1.f;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        sRG[t][i] = sR[t][i] * g;
        g = g * sD[t][i];
      }
      sTot[i] = g;
    } else if (tid >= kPrefix0 + kE && tid < kPrefix0 + 2 * kE) {   // k ⊙ Π_{τ>s} d
      const int i = tid - kPrefix0 - kE;
      float g = 1.f;
#pragma unroll
      for (int s = kChunk - 1; s >= 0; --s) {
        sKD[s][i] = sK[s][i] * g;
        g = g * sD[s][i];
      }
    }
    __syncthreads();

    // 3. y for this chunk, then the next state slice
    {
      float c4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i4 = 0; i4 < kE / 4; ++i4) {
        const float4 rg = *reinterpret_cast<const float4*>(&sRG[yt][4 * i4]);
        c4[0] = fmaf(rg.x, sS[4 * i4][jj], c4[0]);
        c4[1] = fmaf(rg.y, sS[4 * i4 + 1][jj], c4[1]);
        c4[2] = fmaf(rg.z, sS[4 * i4 + 2][jj], c4[2]);
        c4[3] = fmaf(rg.w, sS[4 * i4 + 3][jj], c4[3]);
      }
      float intra = 0.f;
      for (int s = 0; s <= yt; ++s) intra = fmaf(sP[yt][s], sV[s][jj], intra);
      const float yv = ((c4[0] + c4[1]) + (c4[2] + c4[3])) + intra;
      if (t0 + yt < a.s && jg < a.e) y[(t0 + yt) * ys + jg] = from_f32<T>(yv);
    }
    float ns[4];
    {
      const float4 tot = *reinterpret_cast<const float4*>(&sTot[4 * q]);
      ns[0] = tot.x * sS[4 * q][jj];
      ns[1] = tot.y * sS[4 * q + 1][jj];
      ns[2] = tot.z * sS[4 * q + 2][jj];
      ns[3] = tot.w * sS[4 * q + 3][jj];
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        const float4 kd = *reinterpret_cast<const float4*>(&sKD[s][4 * q]);
        const float vv = sV[s][jj];
        ns[0] = fmaf(kd.x, vv, ns[0]);
        ns[1] = fmaf(kd.y, vv, ns[1]);
        ns[2] = fmaf(kd.z, vv, ns[2]);
        ns[3] = fmaf(kd.w, vv, ns[3]);
      }
    }
    __syncthreads();                      // every read of this chunk's state is done
#pragma unroll
    for (int c = 0; c < 4; ++c) sS[4 * q + c][jj] = ns[c];
  }
  __syncthreads();
  for (int idx = tid; idx < kE * kCols; idx += kThreads) {
    const int i = idx / kCols, c = idx % kCols;
    if (i < a.e && j0 + c < a.e) a.s_out[sbase + static_cast<size_t>(i) * a.e + j0 + c] = sS[i][c];
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
    const dim3 grid((e + kCols - 1) / kCols, heads, batch);
    wkv6_chunk_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
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
