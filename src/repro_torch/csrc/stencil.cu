// B4 · periodic 5-point Jacobi sweep on an (n0, n1) grid, for the CUDA backend:
//
//   out[i,j] = 0.25 * (((u[i-1,j] + u[i+1,j]) + u[i,j-1]) + u[i,j+1])
//              + cf * f[i,j]                  (cf = 0.25 * h2; f optional)
//
// with indices taken modulo the grid.  Replaces the TPU kernel
// repro/exec/pallas.py:687 `_BlockCall._build` (pallas_call at :700), which
// held the whole grid as one VMEM block and evaluated the reference rule
// repro/exec/reference.py:58-64 on it.
//
// Here each warp sweeps a strip of kRows rows down a tile of 32·V columns,
// V = 16 bytes / sizeof(T) (4 in fp32, 2 in fp64), with no shared memory and
// no barrier:
// - each lane owns V adjacent columns and loads u and f and stores out as
//   one 16-byte vector a row;
// - the north, centre and south rows stay in registers and rotate as the
//   warp walks down, so u's halo costs 2 extra rows per kRows, not 2 per 8;
// - west and east neighbours come from the next lanes by __shfl_up_sync /
//   __shfl_down_sync; only lane 0 and the lane holding the tile's last
//   column load one extra scalar each a row;
// - wrapped indices are computed once per strip (the rows above and below)
//   and once per warp (the columns left and right of its tile), by compare
//   and select: no `%` anywhere;
// - the next row's loads are issued before the current row's arithmetic,
//   so each warp keeps two rows in flight.
// Where n1 is not a multiple of V or an operand is not 16-byte aligned, the
// same kernel takes its scalar path, V = 1, with the same structure.  Grids
// of one or two rows or columns work unchanged: the neighbours coincide, as
// the reference's rolls make them.
//
// Rounding: the neighbours are added in the reference's order (the order of
// the four jnp.roll terms), and every operation uses __fadd_rn/__fmul_rn
// (__dadd_rn/__dmul_rn for fp64), which nvcc never contracts into fused
// multiply-adds.  The kernel therefore computes the reference's expression
// with the same roundings and agrees with it bitwise, on either path.
//
// Bound on the H100: bytes.  One sweep reads u and f once and writes out once:
// 3 * 4 * n^2 bytes, 201 MB at n = 4096 in fp32, 0.060 ms at 3.35 TB/s.  The
// strips re-read 2/kRows of u (the halo rows, mostly from L2).  What the card
// said (H100 80GB HBM3, 700 W; PERF.md §6): strips of 32 rows beat 16 and 64
// by 1.5-8% in fp32 and fp64 (at n = 4096, 4,096 warps of 32 rows each), and
// 8 warps a block did no better than 4.  It runs at 0.072 ms there (fp32,
// 4096²), 84% of the bound.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;   // warps a block, side by side over column tiles
constexpr int kRows = 32;   // rows a warp walks down its tile (a strip)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// V elements at p: one 16-byte access when V > 1 (p then 16-byte aligned)
__device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
__device__ __forceinline__ void load(const double* p, double (&v)[1]) { v[0] = __ldg(p); }
__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 w = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
}
__device__ __forceinline__ void load(const double* p, double (&v)[2]) {
  const double2 w = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = w.x; v[1] = w.y;
}
__device__ __forceinline__ void store(float* p, const float (&v)[1]) { p[0] = v[0]; }
__device__ __forceinline__ void store(double* p, const double (&v)[1]) { p[0] = v[0]; }
__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// what row i's arithmetic needs beyond the north and centre rows
template <typename T, int V>
struct RowIn {
  T south[V];
  T f[V];
  T west, east;   // the edge lanes' outside neighbours
};

template <typename T, int V>
__device__ __forceinline__ void load_row(RowIn<T, V>& r, const T* __restrict__ u,
                                         const T* __restrict__ f, size_t row,
                                         size_t south_row, int j, bool active, bool first,
                                         bool last, int jw, int je) {
  if (active) {
    load(u + south_row + j, r.south);
    if (f != nullptr) load(f + row + j, r.f);
  }
  if (first) r.west = __ldg(u + row + jw);
  if (last) r.east = __ldg(u + row + je);
}

template <typename T, int V>
__device__ __forceinline__ void sweep(const T* __restrict__ u, const T* __restrict__ f,
                                      T* __restrict__ out, int n0, int n1, T cf) {
  const int lane = threadIdx.x & 31;
  const int tile0 = (blockIdx.y * kWarps + (threadIdx.x >> 5)) * 32 * V;
  if (tile0 >= n1) return;                         // the whole warp
  const int j = tile0 + lane * V;                  // this lane's first column
  const bool active = j < n1;                      // all V columns (n1 % V == 0)
  const int last_lane = min(31, (n1 - 1 - tile0) / V);
  const int jw = tile0 == 0 ? n1 - 1 : tile0 - 1;  // left of the tile, wrapped
  const int je_raw = tile0 + (last_lane + 1) * V;  // right of the tile's last column
  const int je = je_raw == n1 ? 0 : je_raw;
  const bool first = lane == 0;
  const bool last = lane == last_lane;
  const int i0 = blockIdx.x * kRows;
  const int i1 = min(n0, i0 + kRows);
  const size_t nn1 = static_cast<size_t>(n1);

  T north[V], centre[V];
#pragma unroll
  for (int k = 0; k < V; ++k) north[k] = centre[k] = T(0);
  if (active) {
    load(u + static_cast<size_t>(i0 == 0 ? n0 - 1 : i0 - 1) * nn1 + j, north);
    load(u + static_cast<size_t>(i0) * nn1 + j, centre);
  }
  RowIn<T, V> next;
#pragma unroll
  for (int k = 0; k < V; ++k) next.south[k] = next.f[k] = T(0);
  next.west = next.east = T(0);
  load_row(next, u, f, static_cast<size_t>(i0) * nn1,
           static_cast<size_t>(i0 + 1 == n0 ? 0 : i0 + 1) * nn1, j, active, first, last,
           jw, je);
  for (int i = i0; i < i1; ++i) {
    const RowIn<T, V> cur = next;
    if (i + 1 < i1) {
      const int s = i + 2 >= n0 ? i + 2 - n0 : i + 2;
      load_row(next, u, f, static_cast<size_t>(i + 1) * nn1, static_cast<size_t>(s) * nn1,
               j, active, first, last, jw, je);
    }
    T west = __shfl_up_sync(kFull, centre[V - 1], 1);
    T east = __shfl_down_sync(kFull, centre[0], 1);
    if (first) west = cur.west;
    if (last) east = cur.east;
    if (active) {
      T o[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        T s = add_rn(north[k], cur.south[k]);
        s = add_rn(s, k == 0 ? west : centre[k > 0 ? k - 1 : 0]);
        s = add_rn(s, k == V - 1 ? east : centre[k < V - 1 ? k + 1 : 0]);
        o[k] = mul_rn(T(0.25), s);
        if (f != nullptr) o[k] = add_rn(o[k], mul_rn(cf, cur.f[k]));
      }
      store(out + static_cast<size_t>(i) * nn1 + j, o);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      north[k] = centre[k];
      centre[k] = cur.south[k];
    }
  }
}

template <typename T>
constexpr int kVec = 16 / sizeof(T);

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
stencil2d_kernel(const T* __restrict__ u, const T* __restrict__ f, T* __restrict__ out,
                 int n0, int n1, T cf, bool vec) {
  if (vec) sweep<T, kVec<T>>(u, f, out, n0, n1, cf);
  else sweep<T, 1>(u, f, out, n0, n1, cf);
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

template <typename T>
int launch(const void* u, const void* f, void* out, int n0, int n1, double cf,
           void* stream) {
  if (n0 > 0 && n1 > 0) {
    const bool vec = n1 % kVec<T> == 0 && aligned16(u) && aligned16(out) &&
                     (f == nullptr || aligned16(f));
    const int cols = 32 * (vec ? kVec<T> : 1);
    const int tiles = (n1 + cols - 1) / cols;
    const dim3 grid((n0 + kRows - 1) / kRows, (tiles + kWarps - 1) / kWarps);
    stencil2d_kernel<T><<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(u), static_cast<const T*>(f), static_cast<T*>(out), n0, n1,
        static_cast<T>(cf), vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f may be null (no source term); cf = 0.25 * h2 is rounded to T once, as the
// reference rounds its Python-float coefficient to the array dtype.
extern "C" int cello_stencil2d_f32(const void* u, const void* f, void* out, int n0, int n1,
                                   double cf, void* stream) {
  return launch<float>(u, f, out, n0, n1, cf, stream);
}

extern "C" int cello_stencil2d_f64(const void* u, const void* f, void* out, int n0, int n1,
                                   double cf, void* stream) {
  return launch<double>(u, f, out, n0, n1, cf, stream);
}
