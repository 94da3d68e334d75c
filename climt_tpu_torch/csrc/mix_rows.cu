// Band-fused table-row gather-sum for the RRTMG gas optics (kernel B).
//
// One launch computes one taumol output for every band of a group.  Band b
// owns output columns [goff, goff + ng) and terms [t0, t0 + nt); per cell s
//
//   out[s, goff + g] = sum_t  w[t, s] * table[base_t + clip(idx[t, s], 0,
//                                              rows_t - 1) * ngp + g]
//
// summed in the working type (float or double) in term order.  base_t and
// rows_t locate the part (key-species [absa; absb], continuum, minor-gas or
// one-row table) that term t reads in the packed table, whose rows are
// padded to ngp, a multiple of 4 elements, so that four elements of a row
// load as one float4 (float) or two double2 (double).
//
// Replaces climt_tpu/components/rrtmg/fused_mix.py:fused_mix_rows (the
// Pallas _mix_kernel) at the granularity BandAccum gives it there, one
// launch for every term of a band, and extends it to every band of one
// output.  The TPU kernel builds one-hot rows in VMEM and contracts them on
// the MXU because TPU gathers do not vectorise; on Hopper the gather is the
// natural form.  The float32 instantiation serves the fused moist GCM; the
// float64 one the climt components, which run at their state's float64.
//
// Bound: bytes.  Per cell each term streams one weight (4 or 8 bytes) and,
// for a table of more than one row, a 4-byte index; the output row is
// written once.  A band's tables are at most 116 KB in float32 (232 KB in
// float64) and stay in L1/L2.  So:
//   - one thread per cell, one block per (band, 128-cell tile), the band
//     fastest in the grid: the blocks of one tile run together, so every
//     32-byte sector of the tile's output rows, which several bands share,
//     is complete in L2 before it goes to memory;
//   - each term's index and weight are loaded once, coalesced along cells,
//     and the index is clipped and offset here (no index load at all for a
//     one-row table);
//   - table rows are read 16 bytes at a time, the ng sums stay in
//     registers;
//   - each thread parks its row in shared memory and the block writes the
//     band's (128 cells x ng) slice of the output row by row, so stores
//     are contiguous runs of ng elements instead of one scattered row per
//     thread.
// (Staging each band's tables in shared memory instead of reading them
// through L1 measured slower on every large group; see PERF.md.)
#include <cuda_runtime.h>

namespace {

constexpr int kCells = 128;        // cells (threads) per block
constexpr int kTileStride = 20;    // widest padded row (16) + 4

struct Band {
  int ng, ngp, t0, nt, goff, tab0, tablen;
};

__device__ __forceinline__ Band load_band(const int* __restrict__ bands,
                                          int b) {
  const int* p = bands + 7 * b;
  return Band{__ldg(p),     __ldg(p + 1), __ldg(p + 2), __ldg(p + 3),
              __ldg(p + 4), __ldg(p + 5), __ldg(p + 6)};
}

// Four consecutive sums of one cell, and the fused multiply-add of four
// consecutive table elements into them: one float4 load for float, two
// double2 loads for double.
struct Acc4d {
  double x, y, z, w;
};

template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  using Acc = float4;
  static __device__ __forceinline__ Acc zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void fma4(Acc& acc, float wt,
                                              const float* row) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(row));
    acc.x = fmaf(wt, x.x, acc.x);
    acc.y = fmaf(wt, x.y, acc.y);
    acc.z = fmaf(wt, x.z, acc.z);
    acc.w = fmaf(wt, x.w, acc.w);
  }
  static __device__ __forceinline__ void store(float* dst, const Acc& acc) {
    *reinterpret_cast<float4*>(dst) = acc;
  }
};

template <>
struct Vec4<double> {
  using Acc = Acc4d;
  static __device__ __forceinline__ Acc zero() {
    return Acc4d{0.0, 0.0, 0.0, 0.0};
  }
  static __device__ __forceinline__ void fma4(Acc& acc, double wt,
                                              const double* row) {
    const double2* r = reinterpret_cast<const double2*>(row);
    const double2 a = __ldg(r);
    const double2 b = __ldg(r + 1);
    acc.x = fma(wt, a.x, acc.x);
    acc.y = fma(wt, a.y, acc.y);
    acc.z = fma(wt, b.x, acc.z);
    acc.w = fma(wt, b.y, acc.w);
  }
  static __device__ __forceinline__ void store(double* dst, const Acc& acc) {
    double2* d = reinterpret_cast<double2*>(dst);
    d[0] = make_double2(acc.x, acc.y);
    d[1] = make_double2(acc.z, acc.w);
  }
};

// Shared-memory row stride of the output tile, in elements: an odd number
// of 16-byte units, so that a quarter-warp's 16-byte stores hit distinct
// banks (ngp or ngp + 4 floats; ngp + 2 doubles, ngp being a multiple
// of 4).
template <typename T>
__device__ __forceinline__ int tile_stride(int ngp) {
  constexpr int per16 = 16 / static_cast<int>(sizeof(T));
  return ((ngp / per16) & 1) ? ngp : ngp + per16;
}

// The ng (padded to 4*NV) sums of one cell, into its row of the tile.
template <typename T, int NV>
__device__ __forceinline__ void gather_sum(
    const T* __restrict__ table, const int2* __restrict__ terms,
    const Band& bd, const int* __restrict__ idx, const T* __restrict__ w,
    long long ncell, long long cell, T* trow) {
  using V = Vec4<T>;
  typename V::Acc acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = V::zero();
#pragma unroll 4
  for (int t = bd.t0; t < bd.t0 + bd.nt; ++t) {
    const int2 d = __ldg(&terms[t]);  // (flat offset of row 0, rows)
    const long long k = static_cast<long long>(t) * ncell + cell;
    int r = 0;
    if (d.y > 1) r = min(max(__ldg(&idx[k]), 0), d.y - 1);
    const T wt = __ldg(&w[k]);
    const T* row = table + d.x + static_cast<long long>(r) * (4 * NV);
#pragma unroll
    for (int v = 0; v < NV; ++v) V::fma4(acc[v], wt, row + 4 * v);
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) V::store(trow + 4 * v, acc[v]);
}

template <typename T>
__global__ void __launch_bounds__(kCells)
    mix_groups_kernel(const T* __restrict__ table,
                      const int* __restrict__ bands,
                      const int2* __restrict__ terms,
                      const int* __restrict__ idx,
                      const T* __restrict__ w, long long ncell, int width,
                      T* __restrict__ out) {
  __shared__ __align__(16) T tile[kCells * kTileStride];
  const Band bd = load_band(bands, blockIdx.x);
  const int stride = tile_stride<T>(bd.ngp);
  const long long ntiles = (ncell + kCells - 1) / kCells;
  for (long long it = blockIdx.y; it < ntiles; it += gridDim.y) {
    const long long cell0 = it * kCells;
    const long long cell = cell0 + threadIdx.x;
    if (cell < ncell) {
      T* trow = tile + threadIdx.x * stride;
      switch (bd.ngp) {
        case 4:
          gather_sum<T, 1>(table, terms, bd, idx, w, ncell, cell, trow);
          break;
        case 8:
          gather_sum<T, 2>(table, terms, bd, idx, w, ncell, cell, trow);
          break;
        case 12:
          gather_sum<T, 3>(table, terms, bd, idx, w, ncell, cell, trow);
          break;
        default:
          gather_sum<T, 4>(table, terms, bd, idx, w, ncell, cell, trow);
          break;
      }
    }
    __syncthreads();
    const long long left = ncell - cell0;
    const int n = static_cast<int>(left < kCells ? left : kCells);
    for (int i = threadIdx.x; i < n * bd.ng; i += kCells) {
      const int cl = i / bd.ng;
      const int g = i - cl * bd.ng;
      out[(cell0 + cl) * width + bd.goff + g] = tile[cl * stride + g];
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const T* table, const int* bands, int nband, const int* terms,
           const int* idx, const T* w, long long ncell, int width, T* out,
           void* stream) {
  const long long ntiles = (ncell + kCells - 1) / kCells;
  const dim3 grid(nband,
                  static_cast<unsigned>(ntiles < 65535 ? ntiles : 65535));
  mix_groups_kernel<T><<<grid, kCells, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      table, bands, reinterpret_cast<const int2*>(terms), idx, w, ncell,
      width, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bands: nband x 7 ints (ng, ngp, t0, nt, goff, tab0, tablen); terms:
// T x 2 ints (base, rows); idx, w: T x ncell; out: ncell x width.  The
// grid is (band, cell tile), the band fastest.  Returns the CUDA error.
extern "C" int climt_mix_groups_f32(const float* table, const int* bands,
                                    int nband, const int* terms,
                                    const int* idx, const float* w,
                                    long long ncell, int width, float* out,
                                    void* stream) {
  return launch<float>(table, bands, nband, terms, idx, w, ncell, width, out,
                       stream);
}

extern "C" int climt_mix_groups_f64(const double* table, const int* bands,
                                    int nband, const int* terms,
                                    const int* idx, const double* w,
                                    long long ncell, int width, double* out,
                                    void* stream) {
  return launch<double>(table, bands, nband, terms, idx, w, ncell, width,
                        out, stream);
}
