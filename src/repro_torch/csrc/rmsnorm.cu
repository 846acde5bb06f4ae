// B7 · RMSNorm, y = x · rsqrt(mean x² + eps) · (1 + w), for the LLM path.
//
// Replaces the TPU kernel repro/kernels/rmsnorm/kernel.py:21 `_rmsnorm_kernel`
// (launched by `rmsnorm` at :28, `pallas_call` at :36).  That kernel took a
// (row_block × D) VMEM tile per grid step and fused the mean-of-squares with
// the normalise-and-scale, so x is read from HBM once and y written once.
//
// Bound on the H100: bytes.  A call reads x once, writes y once and reads the
// fp32 w once: at D = 4096 in bf16 a prefill's 1024 rows move 16.8 MB (5.0 us
// at 3.35 TB/s); a decode step's 4 rows move 82 KB, and the launch dominates.
// So what matters is bytes in flight, occupancy and no second read of x; the
// tensor cores and TMA have nothing to do here.
//
// Design (the launch shape comes from kernels/rmsnorm.py::launch_shape):
// - A row group of G threads (a multiple of 32) owns a row; each thread owns
//   V 16-byte vectors of it, vector v of thread t at (v·G + t)·E elements
//   (E = 16 / sizeof(T)), so G·V·E = D and a warp's loads of one v are 512
//   contiguous bytes.  R row groups share a CTA of G·R threads (128-256);
//   a call with fewer rows than SMs × R takes fewer a CTA, so that its rows
//   spread over the SMs (a decode step's 4 rows: 4 CTAs).  G is about 128
//   and V 2-6 where the width allows (launch_shape's rule).
// - Each thread issues its V 16-byte loads of x before it uses any, keeps the
//   raw vectors in registers, adds their squares, and after the fold scales
//   and stores from those registers with 16-byte stores: x is read once.
// - (1 + w) for the thread's V vectors is loaded once per CTA with 16-byte
//   __ldg, after the first row's loads are out, and kept in registers; CTAs
//   walk the row groups with a grid stride.  The grid is as many CTAs as the
//   SMs hold (both read at run time), cut so that every CTA walks the same
//   number of row groups.
// - The fold is fixed: a thread adds its squares in (v, element) order with
//   fmaf; a warp butterfly (xor 16, 8, 4, 2, 1) leaves every lane the warp's
//   sum; where G > 32 the row group's warps add their sums through shared
//   memory in warp order.  No atomics, and the order depends only on (D,
//   dtype): the result repeats bitwise from run to run, and a row gives the
//   same bits whatever the call's row count or the row's place in it.
// - The general path (rmsnorm_general_kernel) runs the same code with scalar
//   loads, masked past D: for a width that is no multiple of E, or an operand
//   that is not 16-byte aligned (a view).  It keeps the thread-to-element map
//   and the fold, so on an unaligned view it gives the vector path's bits.
// w stays fp32; the product is cast to the input type once, at the store.
//
// Tried on the card (H100 80GB HBM3, 700 W) as throwaway builds and not
// kept, for none was faster across the phase-3 shapes (a few percent at one,
// lost at others): (1 + w) staged in shared memory once a CTA, with or
// without the next row group's loads issued ahead.  Kept for what they
// saved: the first row's loads issued before w's, fewer rows a CTA when the
// call has few.  The launch shape was chosen from every (G, V, R) this file
// takes, timed at phase 3's widths (scripts/b7_shapes.py).  The kept
// design's times, warm and with the L2 emptied, beside a copy of the same
// bytes, are in PERF.md §6 (chip_smoke.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;            // a CTA's threads (G · R)
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Pack;          // 16 bytes of T as registers
template <> struct Pack<float> {
  static constexpr int kElems = 4;
  float4 raw;
  __device__ __forceinline__ float get(int e) const {
    return e == 0 ? raw.x : e == 1 ? raw.y : e == 2 ? raw.z : raw.w;
  }
  __device__ __forceinline__ void set(const float (&f)[4]) {
    raw = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Pack<__nv_bfloat16> {
  static constexpr int kElems = 8;
  uint4 raw;
  __device__ __forceinline__ float get(int e) const {
    const unsigned word = e < 2 ? raw.x : e < 4 ? raw.y : e < 6 ? raw.z : raw.w;
    const unsigned short half = (e & 1) ? static_cast<unsigned short>(word >> 16)
                                        : static_cast<unsigned short>(word & 0xffffu);
    return __bfloat162float(__ushort_as_bfloat16(half));
  }
  __device__ __forceinline__ void set(const float (&f)[8]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    raw = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// V vectors of the row at xr: 16-byte loads (kVec) or masked scalar ones
template <typename T, int V, bool kVec>
__device__ __forceinline__ void load_row(const T* __restrict__ xr, int t, int g, int d,
                                         Pack<T> (&p)[V], float (&xs)[V][Pack<T>::kElems]) {
  constexpr int E = Pack<T>::kElems;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int base = (v * g + t) * E;
    if constexpr (kVec) {
      p[v].raw = __ldg(reinterpret_cast<const decltype(p[v].raw)*>(xr + base));
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) xs[v][e] = base + e < d ? to_f32(xr[base + e]) : 0.f;
    }
  }
}

template <typename T, int V, bool kVec>
__device__ __forceinline__ void rmsnorm_rows(const T* __restrict__ x, const float* __restrict__ w,
                                             T* __restrict__ y, int rows, int d, int g, int r,
                                             float eps) {
  constexpr int E = Pack<T>::kElems;
  __shared__ float warp_sums[2][kMaxWarps];
  const int t = threadIdx.x % g;            // the thread's place in its row group
  const int ry = threadIdx.x / g;           // the row group's place in the CTA
  const int lane = threadIdx.x & 31;
  const int nw = g / 32;                    // warps a row group
  const int groups = (rows + r - 1) / r;
  const int stride = gridDim.x;

  // the first row group's loads go out before (1 + w) is loaded
  int grp = blockIdx.x;
  Pack<T> p[V];
  float xs[V][E];
  auto load = [&](int group) {
    const int row = group * r + ry;
    if (row < rows) load_row<T, V, kVec>(x + static_cast<size_t>(row) * d, t, g, d, p, xs);
  };
  if (grp < groups) load(grp);
  float wp[V][E];                           // (1 + w) in registers
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int base = (v * g + t) * E;
    if constexpr (kVec) {
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(w + base) + q);
        wp[v][4 * q] = __fadd_rn(1.f, f.x);
        wp[v][4 * q + 1] = __fadd_rn(1.f, f.y);
        wp[v][4 * q + 2] = __fadd_rn(1.f, f.z);
        wp[v][4 * q + 3] = __fadd_rn(1.f, f.w);
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e)
        wp[v][e] = base + e < d ? __fadd_rn(1.f, __ldg(w + base + e)) : 0.f;
    }
  }

  int parity = 0;
  // every CTA walks the same number of row groups (the grid divides them
  // evenly), and the trip count is the CTA's, so all reach the barriers
  for (; grp < groups; grp += stride) {
    const int row = grp * r + ry;
    const bool live = row < rows;
    float ss = 0.f;
    if (live) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float f;
          if constexpr (kVec) f = p[v].get(e); else f = xs[v][e];
          ss = __fmaf_rn(f, f, ss);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(kFull, ss, off));
    float total = ss;
    if (nw > 1) {                           // uniform across the CTA
      if (lane == 0) warp_sums[parity][threadIdx.x / 32] = ss;
      __syncthreads();                      // one barrier a row group: the
      total = warp_sums[parity][ry * nw];   // buffers alternate, so a slot is
      for (int i = 1; i < nw; ++i)          // rewritten only after the next
        total = __fadd_rn(total, warp_sums[parity][ry * nw + i]);  // barrier
      parity ^= 1;
    }
    if (live) {
      const float rs = rsqrtf(__fadd_rn(__fdiv_rn(total, static_cast<float>(d)), eps));
      T* yr = y + static_cast<size_t>(row) * d;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int base = (v * g + t) * E;
        float o[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float f;
          if constexpr (kVec) f = p[v].get(e); else f = xs[v][e];
          o[e] = __fmul_rn(__fmul_rn(f, rs), wp[v][e]);
        }
        if constexpr (kVec) {
          Pack<T> out;
          out.set(o);
          *reinterpret_cast<decltype(out.raw)*>(yr + base) = out.raw;
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e)
            if (base + e < d) yr[base + e] = from_f32<T>(o[e]);
        }
      }
    }
    if (grp + stride < groups) load(grp + stride);   // the registers are free again
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y, int rows,
               int d, int g, int r, float eps) {
  rmsnorm_rows<T, V, true>(x, w, y, rows, d, g, r, eps);
}

// the general path; its bound of one CTA an SM keeps ptxas from spilling
// (it spilled one register of the bf16, V = 2 instantiation without it)
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads, 1)
rmsnorm_general_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
                       int rows, int d, int g, int r, float eps) {
  rmsnorm_rows<T, V, false>(x, w, y, rows, d, g, r, eps);
}

// the SMs, read once; the CTAs an SM holds are read for each (G / 32, R) at
// the first launch of that shape (eagerly, before any CUDA-graph capture)
struct Sms {
  cudaError_t err;
  int count;
};

Sms read_sms() {
  Sms s{cudaSuccess, 0};
  int dev = 0;
  s.err = cudaGetDevice(&dev);
  if (s.err == cudaSuccess) s.err = cudaDeviceGetAttribute(&s.count, cudaDevAttrMultiProcessorCount, dev);
  return s;
}

template <typename T, int V, bool kVec>
int launch(const void* x, const void* w, void* y, int rows, int d, int g, int r, float eps,
           cudaStream_t stream) {
  auto* const kernel = kVec ? &rmsnorm_kernel<T, V> : &rmsnorm_general_kernel<T, V>;
  static const Sms sms = read_sms();
  static int ctas_per_sm[kMaxWarps + 1][kMaxWarps + 1];   // [G / 32][R]; 0: not read yet
  if (sms.err != cudaSuccess) return static_cast<int>(sms.err);
  if (g < 32 || g % 32 || r < 1 || g * r > kMaxThreads ||
      static_cast<long long>(g) * V * Pack<T>::kElems < d ||
      (kVec && static_cast<long long>(g) * V * Pack<T>::kElems != d))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows < sms.count * r) r = max(1, (rows + sms.count - 1) / sms.count);
  int& per_sm = ctas_per_sm[g / 32][r];
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, g * r, 0);
    if (err != cudaSuccess || per_sm < 1) {
      per_sm = 0;
      return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
    }
  }
  // as many CTAs as fit, then fewer so that each walks the same number of
  // row groups: no CTA runs a last round alone
  const int groups = (rows + r - 1) / r;
  const int rounds = (groups + sms.count * per_sm - 1) / (sms.count * per_sm);
  const int grid = (groups + rounds - 1) / rounds;
  kernel<<<grid, g * r, 0, stream>>>(static_cast<const T*>(x), static_cast<const float*>(w),
                                     static_cast<T*>(y), rows, d, g, r, eps);
  return static_cast<int>(cudaGetLastError());
}

// the V that kernels/rmsnorm.py::VECTORS may choose, one instantiation each
template <typename T, bool kVec>
int dispatch(const void* x, const void* w, void* y, int rows, int d, int g, int v, int r,
             float eps, cudaStream_t stream) {
  switch (v) {
    case 1: return launch<T, 1, kVec>(x, w, y, rows, d, g, r, eps, stream);
    case 2: return launch<T, 2, kVec>(x, w, y, rows, d, g, r, eps, stream);
    case 3: return launch<T, 3, kVec>(x, w, y, rows, d, g, r, eps, stream);
    case 4: return launch<T, 4, kVec>(x, w, y, rows, d, g, r, eps, stream);
    case 5: return launch<T, 5, kVec>(x, w, y, rows, d, g, r, eps, stream);
    case 6: return launch<T, 6, kVec>(x, w, y, rows, d, g, r, eps, stream);
    case 8: return launch<T, 8, kVec>(x, w, y, rows, d, g, r, eps, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int run(const void* x, const void* w, void* y, int rows, int d, int g, int v, int r, int vec,
        double eps, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float e = static_cast<float>(eps);
  // an operand that is not 16-byte aligned (a view) takes the general path
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  return vec && aligned ? dispatch<T, true>(x, w, y, rows, d, g, v, r, e, s)
                        : dispatch<T, false>(x, w, y, rows, d, g, v, r, e, s);
}

}  // namespace

// x (rows, d) and y in bf16 or fp32, w (d,) fp32; g threads a row, v vectors
// a thread, r rows a CTA, vec: the 16-byte path where the operands are
// aligned to it (else the general one)
extern "C" int cello_rmsnorm_bf16(const void* x, const void* w, void* y, int rows, int d, int g,
                                  int v, int r, int vec, double eps, void* stream) {
  return run<__nv_bfloat16>(x, w, y, rows, d, g, v, r, vec, eps, stream);
}

extern "C" int cello_rmsnorm_f32(const void* x, const void* w, void* y, int rows, int d, int g,
                                 int v, int r, int vec, double eps, void* stream) {
  return run<float>(x, w, y, rows, d, g, v, r, vec, eps, stream);
}
