// Band-fused table-row gather-sum for the RRTMG gas optics (kernel B).
//
// One launch computes one taumol output for every band of a group.  Band b
// owns output columns [goff, goff + ng) and terms [t0, t0 + nt); per cell s
//
//   out[s, goff + g] = sum_t  w[t, s] * table[base_t + clip(idx[t, s], 0,
//                                              rows_t - 1) * ngp + g]
//
// summed in float32 in term order.  base_t and rows_t locate the part
// (key-species [absa; absb], continuum, minor-gas or one-row table) that
// term t reads in the packed table, whose rows are padded to ngp, a
// multiple of 4 floats, so that a row loads as float4.
//
// Replaces climt_tpu/components/rrtmg/fused_mix.py:fused_mix_rows (the
// Pallas _mix_kernel) at the granularity BandAccum gives it there, one
// launch for every term of a band, and extends it to every band of one
// output.  The TPU kernel builds one-hot rows in VMEM and contracts them on
// the MXU because TPU gathers do not vectorise; on Hopper the gather is the
// natural form.
//
// Bound: bytes.  Per cell each term streams a 4-byte weight and, for a
// table of more than one row, a 4-byte index; the output row is written
// once.  A band's tables are at most 116 KB and stay in L1/L2.  So:
//   - one thread per cell, one block per (band, 128-cell tile), the band
//     fastest in the grid: the blocks of one tile run together, so every
//     32-byte sector of the tile's output rows, which several bands share,
//     is complete in L2 before it goes to memory;
//   - each term's index and weight are loaded once, coalesced along cells,
//     and the index is clipped and offset here (no index load at all for a
//     one-row table);
//   - table rows are read as float4, the ng sums stay in registers;
//   - each thread parks its row in shared memory and the block writes the
//     band's (128 cells x ng) slice of the output row by row, so stores
//     are contiguous runs of ng floats instead of one scattered row per
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

// Shared-memory row stride of the output tile: an odd number of float4s,
// so that a quarter-warp's float4 stores hit distinct banks.
__device__ __forceinline__ int tile_stride(int ngp) {
  return ((ngp >> 2) & 1) ? ngp : ngp + 4;
}

// The ng (padded to 4*NV) sums of one cell, into its row of the tile.
template <int NV>
__device__ __forceinline__ void gather_sum(
    const float* __restrict__ table, const int2* __restrict__ terms,
    const Band& bd, const int* __restrict__ idx, const float* __restrict__ w,
    long long ncell, long long cell, float* trow) {
  float4 acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int t = bd.t0; t < bd.t0 + bd.nt; ++t) {
    const int2 d = __ldg(&terms[t]);  // (flat offset of row 0, rows)
    const long long k = static_cast<long long>(t) * ncell + cell;
    int r = 0;
    if (d.y > 1) r = min(max(__ldg(&idx[k]), 0), d.y - 1);
    const float wt = __ldg(&w[k]);
    const float4* row = reinterpret_cast<const float4*>(
        table + d.x + static_cast<long long>(r) * (4 * NV));
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float4 x = __ldg(row + v);
      acc[v].x = fmaf(wt, x.x, acc[v].x);
      acc[v].y = fmaf(wt, x.y, acc[v].y);
      acc[v].z = fmaf(wt, x.z, acc[v].z);
      acc[v].w = fmaf(wt, x.w, acc[v].w);
    }
  }
  float4* dst = reinterpret_cast<float4*>(trow);
#pragma unroll
  for (int v = 0; v < NV; ++v) dst[v] = acc[v];
}

__global__ void __launch_bounds__(kCells)
    mix_groups_kernel(const float* __restrict__ table,
                      const int* __restrict__ bands,
                      const int2* __restrict__ terms,
                      const int* __restrict__ idx,
                      const float* __restrict__ w, long long ncell, int width,
                      float* __restrict__ out) {
  __shared__ float4 tile4[kCells * kTileStride / 4];
  float* tile = reinterpret_cast<float*>(tile4);
  const Band bd = load_band(bands, blockIdx.x);
  const int stride = tile_stride(bd.ngp);
  const long long ntiles = (ncell + kCells - 1) / kCells;
  for (long long it = blockIdx.y; it < ntiles; it += gridDim.y) {
    const long long cell0 = it * kCells;
    const long long cell = cell0 + threadIdx.x;
    if (cell < ncell) {
      float* trow = tile + threadIdx.x * stride;
      switch (bd.ngp) {
        case 4:
          gather_sum<1>(table, terms, bd, idx, w, ncell, cell, trow);
          break;
        case 8:
          gather_sum<2>(table, terms, bd, idx, w, ncell, cell, trow);
          break;
        case 12:
          gather_sum<3>(table, terms, bd, idx, w, ncell, cell, trow);
          break;
        default:
          gather_sum<4>(table, terms, bd, idx, w, ncell, cell, trow);
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

}  // namespace

// bands: nband x 7 ints (ng, ngp, t0, nt, goff, tab0, tablen); terms:
// T x 2 ints (base, rows); idx, w: T x ncell; out: ncell x width.  The
// grid is (band, cell tile), the band fastest.  Returns the CUDA error.
extern "C" int climt_mix_groups_f32(const float* table, const int* bands,
                                    int nband, const int* terms,
                                    const int* idx, const float* w,
                                    long long ncell, int width, float* out,
                                    void* stream) {
  const long long ntiles = (ncell + kCells - 1) / kCells;
  const dim3 grid(nband,
                  static_cast<unsigned>(ntiles < 65535 ? ntiles : 65535));
  mix_groups_kernel<<<grid, kCells, 0, static_cast<cudaStream_t>(stream)>>>(
      table, bands, reinterpret_cast<const int2*>(terms), idx, w, ncell,
      width, out);
  return static_cast<int>(cudaGetLastError());
}
