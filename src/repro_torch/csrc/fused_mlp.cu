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
// Blocks run in parallel here, so the accumulator cannot carry over; the
// kernels split F into chunks instead, and sum the chunks' parts of the
// output in ascending chunk order: out = ((0 + p0) + p1) + …, p_c = h[:, c] ·
// Wd[c, :], cast once.  Each call is two launches.  The first computes the
// hidden tensor h = act(x·Wg)⊙(x·Wu), one block a (rows × F-chunk), and
// writes it to a scratch buffer of M × F fp32; the second gives each block
// an output tile and every chunk: it forms each chunk's part of its tile
// and adds it to a running sum in registers, chunk after chunk, so the
// order of the sum needs no synchronization between blocks.  No atomics:
// results repeat bitwise from run to run.  The scratch is the hidden tensor
// (210 MB at 4096 × 12800) where an earlier design kept every chunk's fp32
// part of the output, n_chunks × M × D (3.36 GB there), for a fold pass;
// the parts, their arithmetic and the fold's order are unchanged, so the
// outputs are bitwise that design's.  (A design that summed the parts
// into one M × D accumulator in place, each chunk waiting for its
// predecessor's turn per output tile, also kept those bits, but each turn
// is a round trip to L2 that stalls a block: 6.78 against 5.84 ms at
// granite's prefill on an H100 80GB HBM3 at 700 W, `scripts/
// b6_vs_parent.py`.)  The weights stay fp32 in the JAX layout (Wg, Wu:
// (D, F); Wd: (F, D)).  Ragged M and F are masked (rows ≥ M and columns ≥ F
// load as zeros and are not stored).  Two regimes, chosen by the wrapper
// (`launch_shape`):
//
// * Rows ≥ 17 (every prefill): bound by operations.  The products run on
//   the tensor cores, `mma.sync.m16n8k8` with TF32 operands and fp32
//   accumulators, in the 3×TF32 split (CUTLASS's "tfloat32x3"): each fp32
//   operand a is split in registers, as its fragment is loaded, into a_hi =
//   tf32(a) and a_lo = tf32(a - a_hi) (the rounding of `cvt.rna.tf32.f32`,
//   done in two integer operations: on the card that ran faster than the
//   instruction), and a·b is taken as a_lo·b_hi + a_hi·b_lo + a_hi·b_hi,
//   relative error ~2^-21, inside the 1e-5 limit that rejects a one-pass
//   TF32 product.  A bf16 x is exact in TF32, so x·W takes two terms; the
//   hidden tile (fp32) takes three against Wd.  The MMAs' own fp32
//   accumulation truncates: summed over the 1,536 MMAs of a 4096-deep
//   product that bias reached 5.6e-5 of the output's scale on the card, so
//   each 32-deep ring stage sums into fresh registers from zero and is added
//   to the running sum by an IEEE fp32 add (as fp8 GEMMs promote their
//   partial sums); that brought it to ~5e-6.
//   `mlp_tc_up_kernel`: a block is 64 rows × a 256-column chunk, 8 warps; a
//   warp owns 64 rows × 16 hidden columns, so each weight split serves four
//   row tiles.  An fp32 x, whose third term needs the registers, takes 64
//   hidden columns a pass.  x and the Wg/Wu tiles (32 deep) stream through a
//   3-stage shared-memory ring filled by 16-byte `cp.async.cg` copies, so
//   two tiles' loads are in flight during each tile's products; row pitches
//   are padded so that fragment loads are free of bank conflicts.  The
//   activation is applied in registers and the hidden tile stored from them.
//   `mlp_tc_down_kernel`: a block is 64 rows × 256 output columns, 8 warps,
//   warp (wm, wn) owning rows 32·wm .. +32 and columns 64·wn .. +64; the
//   hidden tile (64 × 32) and the Wd tile (32 × 256) of each step stream
//   through a 3-stage ring, each chunk's part is summed over its 8 steps as
//   the one-kernel design summed it, then added to the running sum.
//   At granite's prefill (M 1024, D 4096, F 12800, bf16 x) the function is
//   322 GFLOP, 0.65 ms at TF32's 495 TFLOP/s; the split issues 2.33× that
//   in MMAs (751 GFLOP, 1.52 ms at that rate).  What bound the one-kernel
//   design, from variants of it timed on an H100 (700 W) at that shape,
//   with its MMAs, its global copies or its splits left out in turn: none
//   of the three alone set its time.  With one block of 8 warps an SM it
//   was bound by latency and issue, not by the tensor cores.  `wgmma` and
//   TMA are the step after this one: TF32 `wgmma` needs K-major B in shared
//   memory, which the (D, F) layout of Wg/Wu is not.
// * Rows ≤ 16 (a decode step): bound by reading the weights (629 MB of fp32
//   at granite, 0.188 ms).  Exact fp32 FMAs on the CUDA cores, built for
//   bandwidth.  `mlp_rows_up_kernel` computes the hidden rows: the chunk is
//   64 (or 32) columns, so F/chunk ≥ 200 blocks run two to an SM; each
//   thread reads 16-byte vectors of a weight row and keeps four of them
//   (eight with the gate) in flight; rows are padded to 4 (or 16), not to a
//   16-row tile; the hidden sums over D are split over thread groups and
//   folded in a fixed order in shared memory.  `mlp_rows_down_kernel` gives
//   a block 32 output columns and every chunk: its 16 warps take a chunk
//   each, form the chunk's part with the FMAs in the order the one-kernel
//   design used, and the block adds the 16 parts to its running sums in
//   chunk order before the next 16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* out, float v) { *out = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store2(float* out, float x, float y) {
  *reinterpret_cast<float2*>(out) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* out, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(x, y);
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; the bytes past src_bytes (all 16 when it is
// 0) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// v rounded to TF32 (10-bit mantissa, to nearest, ties away from zero),
// low 13 bits zero: the bits of `cvt.rna.tf32.f32` for finite v, in two
// integer operations
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}
// an operand that is exact in TF32 (a bf16 value): its bits as they are
__device__ __forceinline__ uint32_t exact_tf32(float v) { return __float_as_uint(v); }

// c += a·b on one 16×8×8 TF32 tile, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Args {
  const void* x;          // (M, D), T
  const float* wg;        // (D, F) or nullptr (plain MLP)
  const float* wu;        // (D, F)
  const float* wd;        // (F, D)
  float* hidden;          // (M, F): the hidden tensor, written by the first launch
  void* out;              // (M, D), T
  int m, d, f, chunk, act;
};

// ===========================================================================
// rows ≥ 17: 3×TF32 on the tensor cores
// ===========================================================================

constexpr int kBM = 64;          // rows per block
constexpr int kBN = 128;         // hidden columns per first-product pass
constexpr int kBD = 256;         // output columns per down-product block
constexpr int kBK = 32;          // depth of one ring stage
constexpr int kStages = 3;
constexpr int kWLd = kBN + 8;    // W tile pitches (floats): B fragment loads hit 32 banks
constexpr int kMaxChunk = 256;   // hidden columns per block, at most

// the x tile's pitch (elements), so that A fragment loads hit distinct banks
template <typename T> struct XLd;
template <> struct XLd<float> { static constexpr int v = kBK + 4; };
template <> struct XLd<__nv_bfloat16> { static constexpr int v = kBK + 8; };
// hidden columns per first-product pass: 128 for a bf16 x; 64 for an fp32 x,
// whose third term needs registers that a 128-column pass would spill
template <typename T>
__host__ __device__ constexpr int pass_cols() { return sizeof(T) == 2 ? kBN : kBN / 2; }

// a ring stage of the first product holds an x tile, a Wu and a Wg tile
template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return kBM * XLd<T>::v * static_cast<int>(sizeof(T)) + 2 * kBK * kWLd * 4;
}
template <typename T>
constexpr size_t tc_up_smem_bytes() {
  return static_cast<size_t>(kStages) * stage_bytes<T>();
}
// a ring stage of the down product holds a hidden tile (64 × 32) and a Wd
// tile (32 × 256)
constexpr int kHLd = kBK + 4;    // hidden tile pitch (floats): A fragment loads hit 32 banks
constexpr int kDLd = kBD + 8;    // Wd tile pitch (floats)
constexpr int kDownStage = (kBM * kHLd + kBK * kDLd) * 4;
constexpr size_t tc_down_smem_bytes() { return static_cast<size_t>(kStages) * kDownStage; }

// The first product's work is one sequence of ring steps, kBK deep each:
// for every PC hidden columns of the block's chunk, x·Wg and x·Wu over all
// of D.  A cursor walks the steps without divisions.
struct Cursor {
  int kt, pass;    // step within the pass, pass
};
__device__ __forceinline__ void advance(Cursor& c, int kd) {
  if (++c.kt == kd) {
    c.kt = 0;
    ++c.pass;
  }
}

// One thread's share of a ring stage's 16-byte copies: its rows and
// columns within each tile follow from its index; a step moves the tile's
// origin.  Nothing is kept per copy, to spare registers.
template <typename T>
struct Copier {
  static constexpr int XP = 16 / sizeof(T);                 // x elements per copy
  static constexpr int XR = kBK / XP;                       // copies per x row
  static constexpr int XC = kBM * XR / kThreads;            // x copies per thread
  static constexpr int PC = pass_cols<T>();
  static constexpr int WC = kBK * PC / 4 / kThreads;        // Wg / Wu copies per thread
  int tid, m0;

  // x rows m0.., columns k0..; Wu (Wg) rows k0.., columns f0..
  __device__ __forceinline__ void first(const Args& a, char* stage, int k0, int f0) const {
    T* sX = reinterpret_cast<T*>(stage);
    float* sWu = reinterpret_cast<float*>(stage + kBM * XLd<T>::v * sizeof(T));
    const int x_col = (tid % XR) * XP, col_x = k0 + x_col;
#pragma unroll
    for (int i = 0; i < XC; ++i) {
      const int r = tid / XR + i * (kThreads / XR), row = m0 + r;
      const bool ok = row < a.m && col_x < a.d;
      const T* x = static_cast<const T*>(a.x);
      cp_async16(sX + r * XLd<T>::v + x_col, ok ? x + static_cast<size_t>(row) * a.d + col_x : x,
                 ok ? min(16, (a.d - col_x) * static_cast<int>(sizeof(T))) : 0);
    }
    const int w_row = tid / (PC / 4), w_col = (tid % (PC / 4)) * 4;
    const int col = f0 + w_col;
    const bool col_ok = col < a.f;
    const int bytes = col_ok ? min(16, (a.f - col) * 4) : 0;
#pragma unroll
    for (int i = 0; i < WC; ++i) {
      const int r = w_row + i * (kThreads / (PC / 4)), kr = k0 + r;
      const bool ok = col_ok && kr < a.d;
      const size_t off = ok ? static_cast<size_t>(kr) * a.f + col : 0;
      cp_async16(sWu + r * kWLd + w_col, a.wu + off, ok ? bytes : 0);
      if (a.wg != nullptr)
        cp_async16(sWu + kBK * kWLd + r * kWLd + w_col, a.wg + off, ok ? bytes : 0);
    }
  }
};

template <int A, int B>
__device__ __forceinline__ void zero(float (&v)[A][B][4]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[i][j][e] = 0.f;
}
// acc += tmp by IEEE fp32 adds: the MMAs' own fp32 accumulation truncates,
// so a stage's terms are summed from zero and promoted here
template <int A, int B>
__device__ __forceinline__ void promote(float (&acc)[A][B][4], const float (&tmp)[A][B][4]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += tmp[i][j][e];
}

// Lane (g, t) = (lane / 4, lane % 4).  First product: warp w owns all 64
// rows and hidden columns 16w .. 16w + 15 of each 128 (4 × 2 MMA tiles of
// 16 × 8, for Wg and for Wu; for an fp32 x, 8w .. 8w + 7 of each 64), so
// that each split of a weight serves four row tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
mlp_tc_up_kernel(Args a) {
  constexpr int XL = XLd<T>::v;
  constexpr int SB = stage_bytes<T>();
  constexpr bool kExactX = sizeof(T) == 2;               // a bf16 x is exact in TF32
  constexpr int PC = pass_cols<T>();                     // hidden columns per pass
  constexpr int NT = PC / 64;                            // 8-column tiles per warp
  extern __shared__ __align__(16) char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kBM;
  const int f_base = blockIdx.y * a.chunk;
  const bool gated = a.wg != nullptr;
  const int kd = (a.d + kBK - 1) / kBK, n_sub = a.chunk / PC;
  const int n = n_sub * kd;

  const Copier<T> cp{tid, m0};
  Cursor ld{0, 0};                     // the next step to load
  auto load = [&](int s) {             // step s (the cursor's) into its stage
    cp.first(a, smem + (s % kStages) * SB, ld.kt * kBK, f_base + ld.pass * PC);
    advance(ld, kd);
  };
  auto next = [&](int s) {             // wait for step s; start step s + kStages - 1
    cp_async_wait<kStages - 2>();
    __syncthreads();                   // step s landed; step s - 1's stage is free
    if (s + kStages - 1 < n) load(s + kStages - 1);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load(s);
    cp_async_commit();
  }

  int s = 0;
  // ---- hidden tile: h = act(x·Wg) ⊙ (x·Wu), PC columns at a time
  for (int sub = 0; sub < n_sub; ++sub) {
    float acc_u[4][NT][4], acc_g[4][NT][4];
    zero(acc_u);
    zero(acc_g);
    for (int kt = 0; kt < kd; ++kt, ++s) {
      next(s);
      const char* stage = smem + (s % kStages) * SB;
      const T* sX = reinterpret_cast<const T*>(stage);
      const float* sWu = reinterpret_cast<const float*>(stage + kBM * XL * sizeof(T));
      const float* sWg = sWu + kBK * kWLd;
      float tu[4][NT][4], tg[4][NT][4];
      zero(tu);
      zero(tg);
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 8) {
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int r = mt * 16 + g;
          const float v[4] = {to_f32(sX[r * XL + ks + t]), to_f32(sX[(r + 8) * XL + ks + t]),
                              to_f32(sX[r * XL + ks + t + 4]),
                              to_f32(sX[(r + 8) * XL + ks + t + 4])};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (kExactX) {
              ah[mt][e] = exact_tf32(v[e]);
              al[mt][e] = 0u;
            } else {
              split_tf32(v[e], ah[mt][e], al[mt][e]);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = warp * 8 * NT + nt * 8 + g;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(sWu[(ks + t) * kWLd + col], bh0, bl0);
          split_tf32(sWu[(ks + t + 4) * kWLd + col], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            if (!kExactX) mma_tf32(tu[mt][nt], al[mt], bh0, bh1);
            mma_tf32(tu[mt][nt], ah[mt], bl0, bl1);
            mma_tf32(tu[mt][nt], ah[mt], bh0, bh1);
          }
          if (gated) {
            split_tf32(sWg[(ks + t) * kWLd + col], bh0, bl0);
            split_tf32(sWg[(ks + t + 4) * kWLd + col], bh1, bl1);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
              if (!kExactX) mma_tf32(tg[mt][nt], al[mt], bh0, bh1);
              mma_tf32(tg[mt][nt], ah[mt], bl0, bl1);
              mma_tf32(tg[mt][nt], ah[mt], bh0, bh1);
            }
          }
        }
      }
      promote(acc_u, tu);
      if (gated) promote(acc_g, tg);
    }
    // PC hidden columns are complete: the activation, in registers, to
    // the hidden tensor (columns ≥ F and rows ≥ M are not stored)
    const int c0 = f_base + sub * PC + warp * 8 * NT + 2 * t;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float u0 = acc_u[mt][nt][2 * half], u1 = acc_u[mt][nt][2 * half + 1];
          const float g0 = acc_g[mt][nt][2 * half], g1 = acc_g[mt][nt][2 * half + 1];
          const int r = m0 + mt * 16 + g + 8 * half, c = c0 + nt * 8;
          if (r < a.m && c < a.f)      // f is a multiple of 4: c + 1 < f as well
            *reinterpret_cast<float2*>(a.hidden + static_cast<size_t>(r) * a.f + c) =
                gated ? make_float2(act_fn(g0, a.act) * u0, act_fn(g1, a.act) * u1)
                      : make_float2(act_fn(u0, a.act), act_fn(u1, a.act));
        }
  }
  cp_async_wait<0>();
}



// The down product and the fold: block (blockIdx.x, blockIdx.y) owns rows
// 64·x .. +64 and output columns 256·y .. +256.  For each chunk c it sums
// the chunk's part p_c = h[:, c] · Wd[c, :] over the chunk's 8 ring steps
// (each step's MMAs from zero, promoted), exactly as the one-kernel design
// formed its partial, then adds p_c to its running sum: sum = ((0 + p0) +
// p1) + …, the fold's order.  Hidden columns past F load as zeros, as the
// one-kernel design's hidden tile held them.
struct DownCopier {
  static constexpr int HC = kBM * kBK / 4 / kThreads;       // hidden copies per thread
  static constexpr int DC = kBK * kBD / 4 / kThreads;       // Wd copies per thread
  int tid, m0, d0;

  // hidden rows m0.., columns fr0.. (< f_end); Wd rows fr0.. (< f_end),
  // columns d0..
  __device__ __forceinline__ void load(const Args& a, char* stage, int fr0, int f_end) const {
    float* sA = reinterpret_cast<float*>(stage);
    float* sW = sA + kBM * kHLd;
    const int h_col = (tid % (kBK / 4)) * 4, fc = fr0 + h_col;
#pragma unroll
    for (int i = 0; i < HC; ++i) {
      const int r = tid / (kBK / 4) + i * (kThreads / (kBK / 4)), row = m0 + r;
      const bool ok = row < a.m && fc < f_end;          // f_end is a multiple of 4
      const size_t off = ok ? static_cast<size_t>(row) * a.f + fc : 0;
      cp_async16(sA + r * kHLd + h_col, a.hidden + off, ok ? 16 : 0);
    }
    const int d_row = tid / (kBD / 4), d_col = (tid % (kBD / 4)) * 4;
    const int col = d0 + d_col;
    const bool col_ok = col < a.d;
    const int bytes = col_ok ? min(16, (a.d - col) * 4) : 0;
#pragma unroll
    for (int i = 0; i < DC; ++i) {
      const int r = d_row + i * (kThreads / (kBD / 4)), fr = fr0 + r;
      const bool ok = col_ok && fr < f_end;
      const size_t off = ok ? static_cast<size_t>(fr) * a.d + col : 0;
      cp_async16(sW + r * kDLd + d_col, a.wd + off, ok ? bytes : 0);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
mlp_tc_down_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * kBM, d0 = blockIdx.y * kBD;
  const int kc = a.chunk / kBK, n_chunks = (a.f + a.chunk - 1) / a.chunk;
  const int n = n_chunks * kc;
  const DownCopier cp{tid, m0, d0};
  int ld_c = 0, ld_kt = 0;             // the next step to load: chunk, step in it
  auto load = [&](int s) {
    const int f0 = ld_c * a.chunk;
    cp.load(a, smem + (s % kStages) * kDownStage, f0 + ld_kt * kBK, min(a.f, f0 + a.chunk));
    if (++ld_kt == kc) {
      ld_kt = 0;
      ++ld_c;
    }
  };
  auto next = [&](int s) {             // wait for step s; start step s + kStages - 1
    cp_async_wait<kStages - 2>();
    __syncthreads();                   // step s landed; step s - 1's stage is free
    if (s + kStages - 1 < n) load(s + kStages - 1);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load(s);
    cp_async_commit();
  }

  float sum[2][8][4];
  zero(sum);
  int s = 0;
  for (int c = 0; c < n_chunks; ++c) {
    float acc[2][8][4];
    zero(acc);
    for (int kt = 0; kt < kc; ++kt, ++s) {
      next(s);
      const float* sA = reinterpret_cast<const float*>(smem + (s % kStages) * kDownStage);
      const float* sW = sA + kBM * kHLd;
      float tmp[2][8][4];
      zero(tmp);
#pragma unroll 1
      for (int ks = 0; ks < kBK; ks += 8) {
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = wm * 32 + mt * 16 + g, k = ks + t;
          split_tf32(sA[r * kHLd + k], ah[mt][0], al[mt][0]);
          split_tf32(sA[(r + 8) * kHLd + k], ah[mt][1], al[mt][1]);
          split_tf32(sA[r * kHLd + k + 4], ah[mt][2], al[mt][2]);
          split_tf32(sA[(r + 8) * kHLd + k + 4], ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = wn * 64 + nt * 8 + g;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(sW[(ks + t) * kDLd + col], bh0, bl0);
          split_tf32(sW[(ks + t + 4) * kDLd + col], bh1, bl1);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_tf32(tmp[mt][nt], al[mt], bh0, bh1);
            mma_tf32(tmp[mt][nt], ah[mt], bl0, bl1);
            mma_tf32(tmp[mt][nt], ah[mt], bh0, bh1);
          }
        }
      }
      promote(acc, tmp);
    }
    // the chunk's part is complete: add it to the running sum
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[mt][nt][e] = __fadd_rn(sum[mt][nt][e], acc[mt][nt][e]);
  }
  cp_async_wait<0>();
  const int c0 = d0 + wn * 64 + 2 * t;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm * 32 + mt * 16 + g + 8 * half, c = c0 + nt * 8;
        if (r < a.m && c < a.d)        // d is even: c + 1 < d as well
          store2(static_cast<T*>(a.out) + static_cast<size_t>(r) * a.d + c,
                 sum[mt][nt][2 * half], sum[mt][nt][2 * half + 1]);
      }
}

// ===========================================================================
// rows ≤ 16: exact fp32 on the CUDA cores, built for the weights' bytes
// ===========================================================================

constexpr int kLoadsAhead = 4;   // weight vectors in flight per thread and matrix
constexpr int kDownWarps = 16;   // warps of the rows regime's down product
constexpr int kDownThreads = 32 * kDownWarps;

// MR: rows padded to 4 or 16; CF: hidden columns per block (32 or 64).
// Thread (dg, cg) = (tid / (CF/4), tid % (CF/4)) sums d ≡ dg (mod DG) for
// the four hidden columns 4·cg .. 4·cg + 3; the DG partial sums are folded
// in ascending dg in shared memory.  Writes the hidden rows h (M, F) fp32
// to a.hidden.
template <typename T, int MR, int CF>
__global__ void __launch_bounds__(kThreads, (MR <= 4 ? 2 : 1))
mlp_rows_up_kernel(Args a) {
  constexpr int CG = CF / 4;
  constexpr int DG = kThreads / CG;
  constexpr int XS = 4096 / MR;                  // d values per x slice
  extern __shared__ __align__(16) char smem[];
  float* sX = reinterpret_cast<float*>(smem);    // [XS][MR]: x slice, transposed
  float* sRed = sX + XS * MR;                    // [DG][MR][CF]
  float* sG = sRed + DG * MR * CF;               // [MR][CF]
  float* sH = sG + MR * CF;                      // [MR][CF]

  const int tid = threadIdx.x;
  const int cg = tid % CG, dg = tid / CG;
  const int f0 = blockIdx.x * CF;
  const int col = f0 + cg * 4;
  const bool col_ok = col < a.f;                 // f is a multiple of 4
  const bool gated = a.wg != nullptr;
  const T* x = static_cast<const T*>(a.x);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float acc_g[MR][4], acc_u[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_g[m][j] = acc_u[m][j] = 0.f;

  for (int x0 = 0; x0 < a.d; x0 += XS) {
    const int dn = min(XS, a.d - x0);
    __syncthreads();
    for (int l = tid; l < XS * MR; l += kThreads) {
      const int m = l / XS, dd = l % XS;
      sX[dd * MR + m] = (m < a.m && dd < dn)
                            ? to_f32(x[static_cast<size_t>(m) * a.d + x0 + dd]) : 0.f;
    }
    __syncthreads();
    for (int base = dg; base < dn; base += DG * kLoadsAhead) {
      float4 wu[kLoadsAhead], wg[kLoadsAhead];
#pragma unroll
      for (int j = 0; j < kLoadsAhead; ++j) {
        const int dd = base + j * DG;
        const bool ok = col_ok && dd < dn;
        const size_t off = static_cast<size_t>(x0 + dd) * a.f + col;
        wu[j] = ok ? __ldg(reinterpret_cast<const float4*>(a.wu + off)) : zero;
        wg[j] = ok && gated ? __ldg(reinterpret_cast<const float4*>(a.wg + off)) : zero;
      }
#pragma unroll
      for (int j = 0; j < kLoadsAhead; ++j) {
        const int dd = base + j * DG;
        if (dd >= dn) break;
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const float xv = sX[dd * MR + m];
          acc_u[m][0] = fmaf(xv, wu[j].x, acc_u[m][0]);
          acc_u[m][1] = fmaf(xv, wu[j].y, acc_u[m][1]);
          acc_u[m][2] = fmaf(xv, wu[j].z, acc_u[m][2]);
          acc_u[m][3] = fmaf(xv, wu[j].w, acc_u[m][3]);
          if (gated) {
            acc_g[m][0] = fmaf(xv, wg[j].x, acc_g[m][0]);
            acc_g[m][1] = fmaf(xv, wg[j].y, acc_g[m][1]);
            acc_g[m][2] = fmaf(xv, wg[j].z, acc_g[m][2]);
            acc_g[m][3] = fmaf(xv, wg[j].w, acc_g[m][3]);
          }
        }
      }
    }
  }

  // fold the DG partial sums of x·Wu (into sH) and x·Wg (into sG) in order
  for (int pass = gated ? 0 : 1; pass < 2; ++pass) {
    float* dst = pass == 0 ? sG : sH;
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MR; ++m)
      *reinterpret_cast<float4*>(sRed + (dg * MR + m) * CF + cg * 4) =
          pass == 0 ? make_float4(acc_g[m][0], acc_g[m][1], acc_g[m][2], acc_g[m][3])
                    : make_float4(acc_u[m][0], acc_u[m][1], acc_u[m][2], acc_u[m][3]);
    __syncthreads();
    for (int l = tid; l < MR * CF; l += kThreads) {
      float s = 0.f;
      for (int q = 0; q < DG; ++q) s += sRed[q * MR * CF + l];
      dst[l] = s;
    }
  }
  __syncthreads();
  for (int l = tid; l < MR * CF; l += kThreads)
    sH[l] = gated ? act_fn(sG[l], a.act) * sH[l] : act_fn(sH[l], a.act);
  __syncthreads();

  for (int l = tid; l < MR * CF; l += kThreads) {
    const int m = l / CF, c = f0 + l % CF;
    if (m < a.m && c < a.f) a.hidden[static_cast<size_t>(m) * a.f + c] = sH[l];
  }
}

template <int MR, int CF>
constexpr size_t rows_smem_bytes() {
  return sizeof(float) * (4096 + (kThreads / (CF / 4)) * MR * CF + 2 * MR * CF);
}
template <int MR, int CF>
constexpr size_t down_smem_bytes() {
  return sizeof(float) * kDownWarps * MR * (CF + 32);
}

// The down product of the rows regime: block b owns output columns
// 32·b .. 32·b + 31 (one a lane) and every chunk of CF hidden rows.  Warp w
// of a round takes chunk round · kDownWarps + w: it stages the chunk's
// hidden rows in shared memory and forms the chunk's part of its columns,
// p = Σ_k h[k]·Wd[k, col] by fmaf from 0 in ascending k, kLoadsAhead · 4
// weight rows in flight; the block then adds the round's parts to the
// running sums in chunk order.  The last round's sums are cast once.
template <typename T, int MR, int CF>
__global__ void __launch_bounds__(kDownThreads, 1)
mlp_rows_down_kernel(Args a) {
  constexpr int kAhead = 4 * kLoadsAhead;
  extern __shared__ __align__(16) float smem_down[];
  float (*sH)[MR][CF] = reinterpret_cast<float (*)[MR][CF]>(smem_down);
  float (*sPart)[MR][32] =
      reinterpret_cast<float (*)[MR][32]>(smem_down + kDownWarps * MR * CF);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const bool col_ok = col < a.d;
  const int n_chunks = (a.f + CF - 1) / CF;
  // thread e < MR·32 keeps the running sum of (row e / 32, column e % 32)
  const int e = threadIdx.x;
  float sum = 0.f;
  for (int round = 0; round * kDownWarps < n_chunks; ++round) {
    const int chunk = round * kDownWarps + warp;
    float p[MR];
#pragma unroll
    for (int m = 0; m < MR; ++m) p[m] = 0.f;
    if (chunk < n_chunks) {
      const int f0 = chunk * CF, kn = min(CF, a.f - f0);
      for (int l = lane; l < MR * CF; l += 32) {
        const int m = l / CF, k = l % CF;
        sH[warp][m][k] = (m < a.m && k < kn)
                             ? a.hidden[static_cast<size_t>(m) * a.f + f0 + k] : 0.f;
      }
      __syncwarp();
      for (int k = 0; k < kn; k += kAhead) {
        float w[kAhead];
#pragma unroll
        for (int j = 0; j < kAhead; ++j)
          w[j] = col_ok && k + j < kn
                     ? __ldg(a.wd + static_cast<size_t>(f0 + k + j) * a.d + col) : 0.f;
#pragma unroll
        for (int j = 0; j < kAhead; ++j) {
          if (k + j >= kn) break;
#pragma unroll
          for (int m = 0; m < MR; ++m) p[m] = fmaf(sH[warp][m][k + j], w[j], p[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MR; ++m) sPart[warp][m][lane] = p[m];
    __syncthreads();
    if (e < MR * 32) {
      const int last = min(kDownWarps, n_chunks - round * kDownWarps);
      for (int q = 0; q < last; ++q) sum = __fadd_rn(sum, sPart[q][e / 32][e % 32]);
    }
    __syncthreads();
  }
  const int m = e / 32, c = blockIdx.x * 32 + e % 32;
  if (e < MR * 32 && m < a.m && c < a.d)
    store1(static_cast<T*>(a.out) + static_cast<size_t>(m) * a.d + c, sum);
}


template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t launch_tc(const Args& a, int n_chunks, cudaStream_t s) {
  // once per instantiation, at the first call (not during a CUDA-graph capture)
  static const cudaError_t attr = allow_smem(mlp_tc_up_kernel<T>, tc_up_smem_bytes<T>());
  if (attr != cudaSuccess) return attr;
  static const cudaError_t attr_down = allow_smem(mlp_tc_down_kernel<T>, tc_down_smem_bytes());
  if (attr_down != cudaSuccess) return attr_down;
  const int row_tiles = (a.m + kBM - 1) / kBM;
  mlp_tc_up_kernel<T><<<dim3(row_tiles, n_chunks), kThreads, tc_up_smem_bytes<T>(), s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlp_tc_down_kernel<T><<<dim3(row_tiles, (a.d + kBD - 1) / kBD), kThreads,
                          tc_down_smem_bytes(), s>>>(a);
  return cudaGetLastError();
}

template <typename T, int MR, int CF>
cudaError_t launch_rows(const Args& a, int n_chunks, cudaStream_t s) {
  static const cudaError_t attr = allow_smem(mlp_rows_up_kernel<T, MR, CF>,
                                             rows_smem_bytes<MR, CF>());
  if (attr != cudaSuccess) return attr;
  static const cudaError_t attr_down = allow_smem(mlp_rows_down_kernel<T, MR, CF>,
                                                  down_smem_bytes<MR, CF>());
  if (attr_down != cudaSuccess) return attr_down;
  mlp_rows_up_kernel<T, MR, CF><<<n_chunks, kThreads, rows_smem_bytes<MR, CF>(), s>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlp_rows_down_kernel<T, MR, CF>
      <<<(a.d + 31) / 32, kDownThreads, down_smem_bytes<MR, CF>(), s>>>(a);
  return cudaGetLastError();
}

template <typename T, int MR>
cudaError_t launch_rows_mr(const Args& a, int n_chunks, cudaStream_t s) {
  if (a.chunk == 64) return launch_rows<T, MR, 64>(a, n_chunks, s);
  if (a.chunk == 32) return launch_rows<T, MR, 32>(a, n_chunks, s);
  return cudaErrorInvalidValue;
}

// block_m 64: the tensor-core kernels (chunk a multiple of 128, at most 256);
// block_m 4 or 16 (≥ m): the rows kernels (chunk 32 or 64).  d must be a
// multiple of 8 and f of 4, the pointers 16-byte aligned (the wrapper checks).
template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd, void* hidden,
           void* out, int m, int d, int f, int chunk, int block_m, int act, void* stream) {
  Args a{x, static_cast<const float*>(wg), static_cast<const float*>(wu),
         static_cast<const float*>(wd), static_cast<float*>(hidden), out, m, d, f, chunk, act};
  if (m <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  if (chunk <= 0 || d % 8 != 0 || f % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (f + chunk - 1) / chunk;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (block_m == kBM) {
    if (chunk % kBN != 0 || chunk > kMaxChunk) return static_cast<int>(cudaErrorInvalidValue);
    err = launch_tc<T>(a, n_chunks, s);
  } else if (block_m == 4 && m <= 4) {
    err = launch_rows_mr<T, 4>(a, n_chunks, s);
  } else if (block_m == 16 && m <= 16) {
    err = launch_rows_mr<T, 16>(a, n_chunks, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // namespace

// wg == nullptr selects the plain (non-gated) MLP; act: 0 silu, 1 tanh-gelu,
// 2 relu²; hidden holds m · f floats of scratch
extern "C" int cello_fused_mlp_bf16(const void* x, const void* wg, const void* wu,
                                    const void* wd, void* hidden, void* out, int m, int d,
                                    int f, int chunk, int block_m, int act, void* stream) {
  return launch<__nv_bfloat16>(x, wg, wu, wd, hidden, out, m, d, f, chunk, block_m, act,
                               stream);
}

extern "C" int cello_fused_mlp_f32(const void* x, const void* wg, const void* wu,
                                   const void* wd, void* hidden, void* out, int m, int d,
                                   int f, int chunk, int block_m, int act, void* stream) {
  return launch<float>(x, wg, wu, wd, hidden, out, m, d, f, chunk, block_m, act, stream);
}
