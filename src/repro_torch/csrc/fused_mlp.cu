// B6 · fused MLP, out = (act(x·Wg) ⊙ (x·Wu))·Wd or act(x·Wu)·Wd, for the LLM
// path (act: silu, tanh-gelu or relu²).
//
// Replaces the TPU kernels repro/kernels/fused_mlp/kernel.py:37
// `_mlp_kernel_gated` and :59 `_mlp_kernel_plain` (launched by `fused_mlp`
// at :78, `pallas_call` at :111 and :122).  Those ran a grid (m_blocks,
// f_blocks) whose f axis was sequential: each step computed one
// (m_block × f_block) hidden tile in VMEM and added its down-projection into
// an (m_block × D) fp32 accumulator in VMEM scratch (:104), so the hidden
// tensor (tokens × d_ff, the largest activation of a block) never reached HBM.
//
// The TPU's accumulator does not carry over: at D = 4096 it is 16 KB a row,
// and blocks run in parallel, not in order.  Of the two ways to keep the
// hidden tensor on chip, this kernel takes split-F partials folded in a
// fixed order by a second pass:
//   * pass 1 — one block per (BM-row tile, f-chunk of 128·n columns): the
//     block computes its hidden tile act(x·Wg)⊙(x·Wu) into shared memory
//     (never HBM), then multiplies it by the chunk's rows of Wd, 128 output
//     columns at a time, and stores an fp32 partial (BM × D) for its chunk;
//   * pass 2 — out = Σ partials over the chunks in ascending order, cast to
//     the output type once.
// The other way, a block owning a few rows × all of D and looping over F,
// needs no second pass but gives only ceil(M / rows) blocks — one block at
// a decode step's M = 4 — and every block would read all of the weights.
// Split-F gives M/BM × F/chunk blocks (400 at the prefill's M = 1024, 100 at
// M = 4), reads each weight once per row tile, and costs the partials'
// write and read (~0.8 GB at M = 1024, D = 4096, 50 chunks: well under the
// products' time; 26 MB at M = 4).
//
// Arithmetic: fp32 on the fp32 weights, x converted to fp32, as the TPU
// kernel's dots in preferred_element_type=f32 (:45-52); no TF32, no tensor
// cores.  Each output is a sum over k in ascending order inside a block and
// over chunks in ascending order in pass 2: no atomics, so results repeat
// bitwise from run to run.  Ragged M and F are masked (rows ≥ M and weight
// columns ≥ F load as zeros and are not stored), the TPU kernel's padding
// (:87-96) without the copies.
//
// Bound on the H100: operations at the prefill (M = 1024, D = 4096,
// F = 12800, gated: 6·M·D·F ≈ 322 GFLOP, ~4.8 ms at 67 TFLOP/s fp32, against
// 629 MB of weights, ~0.19 ms), bytes at a decode step (M = 4: 629 MB of
// fp32 weights, ~0.19 ms, against 1.3 GFLOP).  This first version runs the
// products on the fp32 CUDA cores from shared-memory tiles; tensor cores
// (which would need the weights in bf16/TF32, a different function) and TMA
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;     // depth of one shared-memory tile
constexpr int kBN = 128;    // columns of one hidden sub-chunk / output tile
constexpr int kMaxChunk = 256;  // hidden columns per block, at most

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// the activations of repro/kernels/fused_mlp/kernel.py:26 `_act`, in fp32
__device__ __forceinline__ float act_fn(float h, int kind) {
  if (kind == 0) return h * (1.f / (1.f + expf(-h)));                  // silu
  if (kind == 1) {                                                     // tanh-gelu
    const float c = 0.7978845608028654f;                               // sqrt(2/pi)
    return 0.5f * h * (1.f + tanhf(c * (h + 0.044715f * h * h * h)));
  }
  const float r = fmaxf(h, 0.f);                                       // relu²
  return r * r;
}

struct Args {
  const void* x;          // (M, D), T
  const float* wg;        // (D, F) or nullptr (plain MLP)
  const float* wu;        // (D, F)
  const float* wd;        // (F, D)
  float* partial;         // (n_chunks, M, D)
  int m, d, f, chunk, act;
};

// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty*RM .. ty*RM+RM-1 and
// columns tx + 16 j (j < 8) of every 128-column tile.
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
mlp_partial_kernel(Args a) {
  constexpr int RM = BM / 16;
  constexpr int RN = kBN / 16;
  constexpr int X_LD = BM + 4;
  extern __shared__ float smem[];
  const int h_ld = a.chunk + 4;
  float* sH = smem;                          // [BM][chunk + 4]: the hidden tile
  float* sX = sH + BM * h_ld;                // [kBK][BM + 4]: x tile, transposed
  float* sA = sX + kBK * X_LD;               // [kBK][128]: Wg (pass 1) / Wd tile
  float* sB = sA + kBK * kBN;                // [kBK][128]: Wu tile

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM;
  const int fc = blockIdx.y;
  const int f_base = fc * a.chunk;
  const bool gated = a.wg != nullptr;
  const T* x = static_cast<const T*>(a.x);

  // ---- hidden tile: sH = act(x·Wg) ⊙ (x·Wu), one 128-column sub-chunk at a time
  for (int n0 = 0; n0 < a.chunk; n0 += kBN) {
    float acc_g[RM][RN], acc_u[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc_g[i][j] = acc_u[i][j] = 0.f;
    for (int k0 = 0; k0 < a.d; k0 += kBK) {
      for (int l = tid; l < kBK * BM; l += kThreads) {
        const int kk = l % kBK, r = l / kBK;
        const int row = m0 + r, col = k0 + kk;
        sX[kk * X_LD + r] = (row < a.m && col < a.d)
                                ? to_f32(x[static_cast<size_t>(row) * a.d + col]) : 0.f;
      }
      for (int l = tid; l < kBK * kBN; l += kThreads) {
        const int n = l % kBN, kk = l / kBN;
        const int kr = k0 + kk, fcol = f_base + n0 + n;
        const bool ok = kr < a.d && fcol < a.f && n0 + n < a.chunk;
        const size_t off = static_cast<size_t>(kr) * a.f + fcol;
        sB[kk * kBN + n] = ok ? a.wu[off] : 0.f;
        if (gated) sA[kk * kBN + n] = ok ? a.wg[off] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float xv[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) xv[i] = sX[kk * X_LD + ty * RM + i];
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const float u = sB[kk * kBN + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RM; ++i) acc_u[i][j] = fmaf(xv[i], u, acc_u[i][j]);
          if (gated) {
            const float g = sA[kk * kBN + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < RM; ++i) acc_g[i][j] = fmaf(xv[i], g, acc_g[i][j]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < a.chunk) {
          sH[(ty * RM + i) * h_ld + n] =
              gated ? act_fn(acc_g[i][j], a.act) * acc_u[i][j] : act_fn(acc_u[i][j], a.act);
        }
      }
  }
  __syncthreads();

  // ---- partial = sH · Wd[f_base : f_base + chunk, :], 128 output columns at a time
  float* part = a.partial + static_cast<size_t>(fc) * a.m * a.d;
  for (int d0 = 0; d0 < a.d; d0 += kBN) {
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < a.chunk; k0 += kBK) {
      for (int l = tid; l < kBK * kBN; l += kThreads) {
        const int n = l % kBN, kk = l / kBN;
        const int frow = f_base + k0 + kk, dcol = d0 + n;
        sA[kk * kBN + n] = (frow < a.f && k0 + kk < a.chunk && dcol < a.d)
                               ? a.wd[static_cast<size_t>(frow) * a.d + dcol] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float hv[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) hv[i] = sH[(ty * RM + i) * h_ld + k0 + kk];
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const float w = sA[kk * kBN + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RM; ++i) acc[i][j] = fmaf(hv[i], w, acc[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = m0 + ty * RM + i;
      if (row >= a.m) continue;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = d0 + tx + 16 * j;
        if (col < a.d) part[static_cast<size_t>(row) * a.d + col] = acc[i][j];
      }
    }
  }
}

template <typename T>
__global__ void fold_kernel(const float* __restrict__ partial, T* __restrict__ out,
                            long long elems, int n_chunks) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= elems) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += partial[c * elems + i];
  out[i] = from_f32<T>(s);
}

template <typename T, int BM>
int launch_bm(const Args& a, T* out, void* stream) {
  const int n_chunks = (a.f + a.chunk - 1) / a.chunk;
  const size_t smem = sizeof(float) * (BM * (a.chunk + 4) + kBK * (BM + 4) + 2 * kBK * kBN);
  // once per instantiation, at the first call (not during a CUDA-graph
  // capture), for the largest chunk the wrapper uses (256 columns)
  static const cudaError_t attr = cudaFuncSetAttribute(
      mlp_partial_kernel<T, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(float) * (BM * (kMaxChunk + 4) + kBK * (BM + 4) + 2 * kBK * kBN)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (a.chunk > kMaxChunk) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((a.m + BM - 1) / BM, n_chunks);
  mlp_partial_kernel<T, BM><<<grid, kThreads, smem, s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long elems = static_cast<long long>(a.m) * a.d;
  const int threads = 256;
  fold_kernel<T><<<static_cast<unsigned>((elems + threads - 1) / threads), threads, 0, s>>>(
      a.partial, out, elems, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd, void* partial,
           void* out, int m, int d, int f, int chunk, int block_m, int act, void* stream) {
  Args a{x, static_cast<const float*>(wg), static_cast<const float*>(wu),
         static_cast<const float*>(wd), static_cast<float*>(partial), m, d, f, chunk, act};
  if (m <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  if (chunk <= 0 || chunk % kBN != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (block_m == 64) return launch_bm<T, 64>(a, static_cast<T*>(out), stream);
  if (block_m == 16) return launch_bm<T, 16>(a, static_cast<T*>(out), stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// wg == nullptr selects the plain (non-gated) MLP; act: 0 silu, 1 tanh-gelu,
// 2 relu²; partial holds ceil(f / chunk) · m · d floats of scratch
extern "C" int cello_fused_mlp_bf16(const void* x, const void* wg, const void* wu,
                                    const void* wd, void* partial, void* out, int m, int d,
                                    int f, int chunk, int block_m, int act, void* stream) {
  return launch<__nv_bfloat16>(x, wg, wu, wd, partial, out, m, d, f, chunk, block_m, act,
                               stream);
}

extern "C" int cello_fused_mlp_f32(const void* x, const void* wg, const void* wu,
                                   const void* wd, void* partial, void* out, int m, int d,
                                   int f, int chunk, int block_m, int act, void* stream) {
  return launch<float>(x, wg, wu, wd, partial, out, m, d, f, chunk, block_m, act, stream);
}
