// B5 · flash attention (online softmax over KV tiles) for the LLM path.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py:30
// `_flash_kernel` (launched by `flash_attention` at :90, `pallas_call` at
// :116).  That kernel ran a grid (B, H, q_blocks, kv_blocks) whose innermost
// kv axis was sequential ("arbitrary", :136): the running max m, the
// denominator l and the output accumulator lived in VMEM scratch across kv
// steps, so the (S × T) score matrix never reached HBM.
//
// Here one block owns one (b, h, 64-query tile) and loops over the kv tiles
// itself, which takes the place of the sequential grid axis.  The kv head is
// h·KVH/H (GQA: the repeated K/V never exists).  What both kernels below
// carry over from the TPU kernel, so that they compute the same function:
//   * the tile skip (:44-50): a kv tile runs only if some key in it can be
//     seen by some query of the q tile (kv padding, causal, window);
//   * the mask (:64-69) with NEG_INF = -1e30 (not -inf), so a row that has
//     seen only masked keys carries exp(0) terms that the first real key's
//     alpha = exp(-1e30 - m) = 0 erases exactly, as on the TPU;
//   * acc / max(l, 1e-30) at the end (:86-87), q_offset = T - S and
//     t_valid = T (:114).
// Tile sizes are these kernels' own: the plan's q_block/kv_block are sized
// for a 128 MiB VMEM.  Inputs and outputs take any strides over (batch,
// head, position) and unit stride over features, so the model's (B, S, H, E)
// tensors go in without a transpose.  No atomics: results repeat bitwise.
//
// Bound on the H100: operations.  At granite's prefill (B 1, H 32 over KVH
// 8, S = T = 1024, E 128, causal) the function needs 4·H·E·(S(S+1)/2) ≈ 8.6
// GFLOP (8.7 us at 989 TFLOP/s in bf16) and moves ~20 MB (~6 us); at
// recurrentgemma's (H 10 over 1, E 256, S 4096, window 2048) 64.4 GFLOP.
//
// bf16 operands, the serving paths' type: `flash_bf16_kernel`, in the
// FlashAttention-2 shape on the tensor cores.  4 warps, each owning 16 query
// rows.  S = Q·Kᵀ runs on `mma.sync.m16n8k16` bf16 with fp32 accumulators
// (the products of bf16 values are exact in fp32); the scale multiplies the
// fp32 scores after the product, with log2 e folded in, so that the
// exponentials are `exp2f` (e^x to within 2 fp32 ulps).  The online softmax
// stays in registers (row max and sum over the quad by shuffles).  P is split into P_hi = bf16(P)
// and P_lo = bf16(P - P_hi), re-packed in registers as A fragments, and O +=
// P_lo·V + P_hi·V, so the P·V product keeps 16 bits of P: one bf16 rounding
// of P (standard FlashAttention) would carry a ~2^-9 relative error into the
// sum, which on outputs near zero breaks the one-bf16-rounding rule the
// kernel is held to; the split doubles the P·V MMAs (1.5× the function's
// operations).  Q, K and V tiles come by 16-byte `cp.async` copies into an
// XOR-swizzled layout (16-byte chunk c of row r at c ^ (r & 7)), so that
// `ldmatrix` (Q, K) and `ldmatrix.trans` (V) are free of bank conflicts; K/V
// tiles stream through a 2-stage ring, the next tile's copies in flight
// during this tile's products.  The feature dim is padded with zeros to
// EMAX ∈ {64, 128, 256}, and k16 steps or n8 tiles past E are skipped.  At
// E 256 a 16 × 256 fp32 accumulator is 128 registers a thread, so the kv
// tile is 32 keys there (64 below) and Q's fragments are re-read from
// shared memory at every kv tile; up to E 128 they stay in registers.  Q tiles run heaviest
// (last) first, so causal blocks of unequal length fill the card evenly.
// What the profile shows limiting it is in PERF.md (`chip_smoke.py
// --profile`); `wgmma` and TMA are the step after this one.
//
// fp32 operands (no serving path runs them): `flash_kernel`, unchanged, on
// the fp32 CUDA cores from shared memory: the q tile pre-scaled in fp32 (as
// :60 scales q before the product), one K, one V and the 64×64 probability
// tile in shared memory, m, l and a 64×E accumulator in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;            // fp32 kernel: queries per block and keys per kv tile
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

// ===========================================================================
// bf16: tensor cores
// ===========================================================================

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;      // 4 warps of 16 query rows
constexpr int kBQ = 64;              // queries per block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte global -> shared copy; the bytes past src_bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
// c += a·b on one 16×8×16 bf16 tile, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// (p0, p1) as a packed bf16 pair P_hi and the packed remainder P_lo
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
}

// element offset of 16-byte chunk c of row r in a swizzled [rows][EMAX] tile
template <int EMAX>
__device__ __forceinline__ int swz(int r, int c) {
  return r * EMAX + ((c ^ (r & 7)) << 3);
}

// rows row0 .. row0 + R of a (position, feature) matrix into a swizzled tile;
// rows ≥ n_rows and features ≥ e are zero-filled
template <int EMAX, int R>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ss, int row0,
                                          int n_rows, int e, int tid) {
  constexpr int C = EMAX / 8;
  static_assert(R * C % kTcThreads == 0, "tile copies");
#pragma unroll
  for (int i = 0; i < R * C / kTcThreads; ++i) {
    const int idx = tid + i * kTcThreads;
    const int r = idx / C, c = idx % C;
    const int row = row0 + r, col = c * 8;
    const bool ok = row < n_rows && col < e;
    cp_async16(dst + swz<EMAX>(r, c), ok ? src + row * ss + col : src,
               ok ? min(16, (e - col) * 2) : 0);
  }
}

template <int EMAX, int BK>
constexpr int bf16_smem_bytes() {
  return (kBQ + 4 * BK) * EMAX * 2;     // Q, and K and V in two stages each
}

// Warp w owns query rows 16w .. 16w + 15 of the tile.  Lane (g, t) = (lane /
// 4, lane % 4) holds, of every 16 × 8 accumulator, rows g and g + 8 at
// columns 2t and 2t + 1 (the m16n8 layout).
template <int EMAX, int BK>
__global__ void __launch_bounds__(kTcThreads)
flash_bf16_kernel(Args a) {
  constexpr int NS = BK / 8;            // score tiles of 8 keys
  constexpr int NO = EMAX / 8;          // output tiles of 8 features
  extern __shared__ float smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);           // [64][EMAX]
  bf16* sK = sQ + kBQ * EMAX;                          // [2][BK][EMAX]
  bf16* sV = sK + 2 * BK * EMAX;                       // [2][BK][EMAX]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, iq = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int hk = h * a.kv_heads / a.heads;
  const int q0 = iq * kBQ;
  const int q_offset = a.t - a.s;
  const int t_valid = a.t;

  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  bf16* o = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;

  // the kv tiles some query of this tile can see (kernel.py:44-50)
  int hi_key = a.t - 1;
  if (a.causal) hi_key = min(hi_key, q0 + q_offset + kBQ - 1);
  const int hi_tile = hi_key >= 0 ? hi_key / BK : -1;
  int lo_tile = 0;
  if (a.window > 0) {
    const int lo_key = q0 + q_offset - a.window + 1;
    if (lo_key > 0) lo_tile = lo_key / BK;
  }

  load_tile<EMAX, kBQ>(sQ, q, a.q_ss, q0, a.s, a.e, tid);
  if (lo_tile <= hi_tile) {
    load_tile<EMAX, BK>(sK, k, a.k_ss, lo_tile * BK, a.t, a.e, tid);
    load_tile<EMAX, BK>(sV, v, a.v_ss, lo_tile * BK, a.t, a.e, tid);
  }
  cp_async_commit();

  const int e_steps = (a.e + 15) / 16;  // k16 steps of Q·Kᵀ that carry features
  const int e_tiles = (a.e + 7) / 8;    // output tiles that carry features
  const int qr = warp * 16;
  const int qp0 = q0 + qr + g + q_offset;   // position of row g; row g + 8 is qp0 + 8
  // scores in log2 units: p = 2^(s·scale·log2 e - m) = e^(s·scale - m')
  const float scale2 = a.scale * 1.4426950408889634f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  // Q's A fragments: held in registers up to E 128, re-read from shared
  // memory at every kv tile at E 256 (whose accumulator takes 128 registers)
  constexpr int QH = EMAX <= 128 ? EMAX / 16 : 1;
  uint32_t qh[QH][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = lo_tile; it <= hi_tile; ++it) {
    const int st = (it - lo_tile) & 1;
    cp_async_wait_all();
    __syncthreads();                   // tile it landed; tile it - 1 is no longer read
    if (EMAX <= 128 && it == lo_tile) {
#pragma unroll
      for (int kk = 0; kk < QH; ++kk)
        if (kk < e_steps)
          ldmatrix_x4(qh[kk], sQ + swz<EMAX>(qr + (lane & 7) + ((lane >> 3) & 1) * 8,
                                             2 * kk + (lane >> 4)));
    }
    if (it < hi_tile) {
      load_tile<EMAX, BK>(sK + (st ^ 1) * BK * EMAX, k, a.k_ss, (it + 1) * BK, a.t, a.e, tid);
      load_tile<EMAX, BK>(sV + (st ^ 1) * BK * EMAX, v, a.v_ss, (it + 1) * BK, a.t, a.e, tid);
    }
    cp_async_commit();
    const bf16* cK = sK + st * BK * EMAX;
    const bf16* cV = sV + st * BK * EMAX;
    const int k0 = it * BK;

    // ---- S = Q·Kᵀ
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < EMAX / 16; ++kk) {
      if (kk < e_steps) {
        uint32_t qa[4];
        if (EMAX <= 128) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qh[kk < QH ? kk : 0][e];
        } else {
          ldmatrix_x4(qa, sQ + swz<EMAX>(qr + (lane & 7) + ((lane >> 3) & 1) * 8,
                                         2 * kk + (lane >> 4)));
        }
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
          uint32_t kb[4];
          ldmatrix_x4(kb, cK + swz<EMAX>(j * 8 + (lane & 7) + (lane >> 4) * 8,
                                         2 * kk + ((lane >> 3) & 1)));
          mma_bf16(s[j], qa, kb[0], kb[1]);
          mma_bf16(s[j + 1], qa, kb[2], kb[3]);
        }
      }
    }

    // ---- scale, mask, online softmax (rows g and g + 8)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = qp0 + (e >> 1) * 8;
        const int kp = k0 + j * 8 + 2 * t + (e & 1);
        bool keep = kp < t_valid;
        if (a.causal) keep = keep && kp <= qp;
        if (a.window > 0) keep = keep && kp > qp - a.window;
        s[j][e] = keep ? s[j][e] * scale2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_r[e >> 1]);
        ps[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = alpha[r] * l_r[r] + ps[r];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // ---- O += P_lo·V + P_hi·V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        if (n < e_tiles) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, cV + swz<EMAX>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                               n + (lane >> 4)));
          mma_bf16(acc[n], pl, vb[0], vb[1]);
          mma_bf16(acc[n], ph, vb[0], vb[1]);
          mma_bf16(acc[n + 1], pl, vb[2], vb[3]);
          mma_bf16(acc[n + 1], ph, vb[2], vb[3]);
        }
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + qr + g + 8 * r;
    if (row >= a.s) continue;
    const float den = fmaxf(l_r[r], 1e-30f);
    bf16* orow = o + row * a.o_ss;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = n * 8 + 2 * t;
      if (n >= e_tiles || col >= a.e) continue;
      const float v0 = acc[n][2 * r] / den, v1 = acc[n][2 * r + 1] / den;
      if (col + 1 < a.e)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(v0, v1);
      else
        orow[col] = __float2bfloat16(v0);
    }
  }
}

template <int EMAX, int BK>
int launch_bf16(const Args& a, int batch, void* stream) {
  constexpr int smem = bf16_smem_bytes<EMAX, BK>();
  // once per instantiation, at the first call: not during a CUDA-graph capture
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bf16_kernel<EMAX, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(a.heads, (a.s + kBQ - 1) / kBQ, batch);
  flash_bf16_kernel<EMAX, BK><<<grid, kTcThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* q, const void* k, const void* v, void* o, const long long* strides,
               int heads, int kv_heads, int s, int t, int e, double scale, int causal,
               int window) {
  return Args{q, k, v, o,
              strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
              strides[6], strides[7], strides[8], strides[9], strides[10], strides[11],
              heads, kv_heads, s, t, e, static_cast<float>(scale), causal, window};
}

}  // namespace

// strides: 12 element strides, (batch, head, position) of q, k, v, o in turn.
// bf16: every stride a multiple of 8 and every pointer 16-byte aligned (the
// wrapper checks).
extern "C" int cello_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                          const long long* strides, int batch, int heads,
                                          int kv_heads, int s, int t, int e, double scale,
                                          int causal, int window, void* stream) {
  const Args a = make_args(q, k, v, o, strides, heads, kv_heads, s, t, e, scale, causal, window);
  if (batch <= 0 || heads <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  if (e <= 64) return launch_bf16<64, 64>(a, batch, stream);
  if (e <= 128) return launch_bf16<128, 64>(a, batch, stream);
  if (e <= 256) return launch_bf16<256, 32>(a, batch, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int cello_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                         const long long* strides, int batch, int heads,
                                         int kv_heads, int s, int t, int e, double scale,
                                         int causal, int window, void* stream) {
  const Args a = make_args(q, k, v, o, strides, heads, kv_heads, s, t, e, scale, causal, window);
  if (batch <= 0 || heads <= 0 || s <= 0) return static_cast<int>(cudaGetLastError());
  if (e <= 64) return launch_e<float, 64>(a, batch, stream);
  if (e <= 128) return launch_e<float, 128>(a, batch, stream);
  if (e <= 256) return launch_e<float, 256>(a, batch, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
