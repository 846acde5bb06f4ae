// B5 · flash attention (online softmax over KV tiles) for the LLM path.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:30
// `_flash_kernel` (launched by `flash_attention` at :90, `pallas_call` at
// :116).  That kernel ran a grid (B, H, q_blocks, kv_blocks) whose innermost
// kv axis was sequential ("arbitrary", :136): the running max m, the
// denominator l and the output accumulator lived in VMEM scratch across kv
// steps, so the (S × T) score matrix never reached HBM.
//
// Here one block owns one (b, h, 64-query tile) and loops over the 64-key
// tiles itself, which takes the place of the sequential grid axis.  The
// block keeps its q tile (pre-scaled in fp32, as :60 scales q before the
// product), one K tile, one V tile and the 64×64 probability tile in shared
// memory, and m, l and a 64×E accumulator in registers, all fp32.  The kv
// head is h·KVH/H (GQA: the repeated K/V never exists).  What it carries
// over from the TPU kernel, so that the two compute the same function:
//   * the tile skip (:44-50): a kv tile runs only if some key in it can be
//     seen by some query of the q tile (kv padding, causal, window);
//   * the mask (:64-69) with NEG_INF = -1e30 (not -inf), so a row that has
//     seen only masked keys carries exp(0) terms that the first real key's
//     alpha = exp(-1e30 - m) = 0 erases exactly, as on the TPU;
//   * acc / max(l, 1e-30) at the end (:86-87), q_offset = T - S and
//     t_valid = T (:114).
// Tile sizes are this kernel's own (64 × 64): the plan's q_block/kv_block
// are sized for a 128 MiB VMEM.  The feature dim is padded with zeros to
// EMAX ∈ {64, 128, 256} inside the block (zeros add nothing to q·k; padded
// output columns are not stored).  Inputs and outputs are bf16 or fp32, with
// any strides over (batch, head, position) and unit stride over features,
// so the model's (B, S, H, E) tensors go in without a transpose.
//
// Bound on the H100: operations.  At the LLM path's prefill (B=1, H=32,
// KVH=8, S=T=1024, E=128, causal) the products need 4·H·E·(S(S+1)/2) ≈ 8.6
// GFLOP (~0.13 ms at 67 TFLOP/s in fp32) and move ~20 MB (~6 us).  This
// first version runs the products on the fp32 CUDA cores from shared memory
// (no tensor cores, no TMA); wgmma on bf16 tiles is later work.  No atomics:
// results repeat bitwise from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // queries per block and keys per kv tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss;        // element strides of q (batch, head, position)
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int heads, kv_heads, s, t, e;
  float scale;
  int causal, window;                // window <= 0: no window
};

// Thread (ty, tx) = (tid / 16, tid % 16) owns query rows ty*4 .. ty*4+3 and
// key/feature columns tx + 16 j: the 16 threads of a row group are one
// half-warp, so row reductions are 4 shuffles.
template <typename T, int EMAX>
__global__ void __launch_bounds__(kThreads)
flash_kernel(Args a) {
  constexpr int QK_LD = EMAX + 1;     // padded rows: column reads hit distinct banks
  constexpr int P_LD = kTile + 1;
  constexpr int EC = EMAX / 16;       // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                               // [64][EMAX+1]
  float* sK = sQ + kTile * QK_LD;                 // [64][EMAX+1]
  float* sV = sK + kTile * QK_LD;                 // [64][EMAX]
  float* sP = sV + kTile * EMAX;                  // [64][65]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h * a.kv_heads / a.heads;
  const int q0 = iq * kTile;
  const int q_offset = a.t - a.s;
  const int t_valid = a.t;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int l = tid; l < kTile * EMAX; l += kThreads) {
    const int r = l / EMAX, e = l % EMAX;
    float val = 0.f;
    if (q0 + r < a.s && e < a.e) val = to_f32(q[(q0 + r) * a.q_ss + e]) * a.scale;
    sQ[r * QK_LD + e] = val;
  }

  float m[4], lsum[4], acc[4][EC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    lsum[i] = 0.f;
#pragma unroll
    for (int c = 0; c < EC; ++c) acc[i][c] = 0.f;
  }

  const int kv_tiles = (a.t + kTile - 1) / kTile;
  for (int ik = 0; ik < kv_tiles; ++ik) {
    const int k0 = ik * kTile;
    // block-level skip of fully masked tiles (kernel.py:44-50)
    bool needed = k0 < t_valid;
    if (a.causal) needed = needed && (k0 <= q0 + q_offset + kTile - 1);
    if (a.window > 0) needed = needed && (k0 + kTile > q0 + q_offset - a.window + 1);
    if (!needed) continue;

    __syncthreads();                 // previous tile's sK/sV/sP reads are done
    for (int l = tid; l < kTile * EMAX; l += kThreads) {
      const int r = l / EMAX, e = l % EMAX;
      float kv = 0.f, vv = 0.f;
      if (k0 + r < a.t && e < a.e) {
        kv = to_f32(k[(k0 + r) * a.k_ss + e]);
        vv = to_f32(v[(k0 + r) * a.v_ss + e]);
      }
      sK[r * QK_LD + e] = kv;
      sV[r * EMAX + e] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int e = 0; e < a.e; ++e) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * QK_LD + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * QK_LD + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty * 4 + i + q_offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        bool keep = k_pos < t_valid;
        if (a.causal) keep = keep && (k_pos <= q_pos);
        if (a.window > 0) keep = keep && (k_pos > q_pos - a.window);
        if (!keep) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty * 4 + i) * P_LD + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      lsum[i] = alpha[i] * lsum[i] + rs;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < EC; ++c) acc[i][c] *= alpha[i];
    for (int j = 0; j < kTile; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * P_LD + j];
#pragma unroll
      for (int c = 0; c < EC; ++c) {
        const float vv = sV[j * EMAX + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= a.s) continue;
    const float den = fmaxf(lsum[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < EC; ++c) {
      const int e = tx + 16 * c;
      if (e < a.e) o[r * a.o_ss + e] = from_f32<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int EMAX>
int launch_e(const Args& a, int batch, void* stream) {
  const size_t smem = sizeof(float) * (2 * kTile * (EMAX + 1) + kTile * EMAX + kTile * (kTile + 1));
  // once per instantiation, at the first call: not during a CUDA-graph capture
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, EMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.s + kTile - 1) / kTile, a.heads, batch);
  flash_kernel<T, EMAX><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, const long long* strides,
           int batch, int heads, int kv_heads, int s, int t, int e, double scale,
           int causal, int window, void* stream) {
  Args a{q, k, v, o,
         strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
         strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
         heads, kv_heads, s, t, e, static_cast<float>(scale), causal, window};
  if (batch <= 0 || heads <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  if (e <= 64) return launch_e<T, 64>(a, batch, stream);
  if (e <= 128) return launch_e<T, 128>(a, batch, stream);
  if (e <= 256) return launch_e<T, 256>(a, batch, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// strides: 12 element strides, (batch, head, position) of q, k, v, o in turn
extern "C" int cello_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                          const long long* strides, int batch, int heads,
                                          int kv_heads, int s, int t, int e, double scale,
                                          int causal, int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, strides, batch, heads, kv_heads, s, t, e, scale,
                               causal, window, stream);
}

extern "C" int cello_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                         const long long* strides, int batch, int heads,
                                         int kv_heads, int s, int t, int e, double scale,
                                         int causal, int window, void* stream) {
  return launch<float>(q, k, v, o, strides, batch, heads, kv_heads, s, t, e, scale, causal,
                       window, stream);
}
