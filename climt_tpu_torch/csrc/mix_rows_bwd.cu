// Backward of kernel B: the gradient of the packed table.
//
// Kernel B (mix_rows.cu) computes, per band b and cell s,
//
//   out[s, goff + g] = sum_t  w[t, s] * table[base_t + clip(idx[t, s], 0,
//                                             rows_t - 1) * ngp + g].
//
// Its gradient with respect to the table, for an upstream gradient gout
// (ncell x width), is the scatter
//
//   dtable[base_t + clip(idx[t, s]) * ngp + g] += w[t, s] * gout[s, goff + g]
//
// summed over every term t of the band and every cell s.  The LW k-table
// calibration (climt_tpu_torch/tools/calibrate_lw_ktables.py) needs it: its
// loss depends on the tables only through kernel B.  The JAX package takes
// this gradient with XLA's autodiff of the gather in
// climt_tpu/components/rrtmg/interp.py (its Pallas kernel has none).  One
// template serves float32 and float64; the calibration runs in float64.
//
// Bound: bytes, like the forward: per cell each term's weight and index,
// the upstream gradient once, the table gradient written once.  The work
// is a scatter with heavy contention: the cells of one level pick the same
// few pressure and temperature rows.  So:
//   - the grid is (band, chunk of cells, split of the band's rows); a block
//     of 256 threads, one cell each, walks its chunk's 256-cell tiles;
//   - the block accumulates its band's gradient rows (or one split of
//     them: a float64 band table may be larger than a block's shared
//     memory) in shared memory, and adds the nonzero entries to global
//     memory with atomicAdd once, at the end;
//   - before each shared-memory atomic, the lanes of a warp that picked the
//     same row are summed with shuffles (one warp reduction per distinct
//     row, the row found with a ballot), so a warp issues one atomic per
//     (row, g) instead of one per (cell, g).
// The atomics add in an order that changes from run to run: the result
// varies in its last bits (the tolerance in chip_smoke.py says how much).
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;          // cells per tile, one per thread
constexpr int kMaxNg = 16;             // widest band
constexpr unsigned kFull = 0xffffffffu;
// shared memory per block: two blocks fit on one SM
constexpr int kSmemBytes = 96 * 1024;

struct Band {
  int ng, ngp, t0, nt, goff, tab0, tablen;
};

__device__ __forceinline__ Band load_band(const int* __restrict__ bands,
                                          int b) {
  const int* p = bands + 7 * b;
  return Band{__ldg(p),     __ldg(p + 1), __ldg(p + 2), __ldg(p + 3),
              __ldg(p + 4), __ldg(p + 5), __ldg(p + 6)};
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mix_groups_bwd_kernel(const int* __restrict__ bands,
                          const int2* __restrict__ terms,
                          const int* __restrict__ idx,
                          const T* __restrict__ w, long long ncell,
                          int width, const T* __restrict__ gout, int cap,
                          T* __restrict__ dtable) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);
  const Band bd = load_band(bands, blockIdx.x);
  if (bd.nt == 0) return;
  // this block's split: whole rows of the band's table
  const int span = (cap / bd.ngp) * bd.ngp;
  const int lo = blockIdx.z * span;
  if (lo >= bd.tablen) return;
  const int len = min(span, bd.tablen - lo);
  for (int i = threadIdx.x; i < len; i += kThreads) acc[i] = T(0);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long ntiles = (ncell + kThreads - 1) / kThreads;
  for (long long it = blockIdx.y; it < ntiles; it += gridDim.y) {
    const long long cell = it * kThreads + threadIdx.x;
    const bool valid = cell < ncell;
    T g[kMaxNg];
#pragma unroll
    for (int j = 0; j < kMaxNg; ++j)
      g[j] = (valid && j < bd.ng) ? __ldg(&gout[cell * width + bd.goff + j])
                                  : T(0);
    for (int t = bd.t0; t < bd.t0 + bd.nt; ++t) {
      const int2 d = __ldg(&terms[t]);  // (flat offset of row 0, rows)
      int key = -1;                     // the row's offset in the split
      T wt = T(0);
      if (valid) {
        const long long k = static_cast<long long>(t) * ncell + cell;
        int r = 0;
        if (d.y > 1) r = min(max(__ldg(&idx[k]), 0), d.y - 1);
        const int off = d.x - bd.tab0 + r * bd.ngp - lo;
        if (off >= 0 && off < len) {
          key = off;
          wt = __ldg(&w[k]);
        }
      }
      // one pass per distinct row among the warp's lanes
      unsigned todo = __ballot_sync(kFull, key >= 0);
      while (todo) {
        const int lead = __ffs(todo) - 1;
        const int row = __shfl_sync(kFull, key, lead);
        const bool mine = key == row;
        const unsigned grp = __ballot_sync(kFull, mine);
        const T c = mine ? wt : T(0);
        if (grp == (1u << lead)) {      // one lane: no reduction
          if (lane == lead) {
#pragma unroll
            for (int j = 0; j < kMaxNg; ++j)
              if (j < bd.ng) atomicAdd(&acc[row + j], c * g[j]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < kMaxNg; ++j) {
            if (j < bd.ng) {
              const T s = warp_sum(c * g[j]);
              if (lane == lead) atomicAdd(&acc[row + j], s);
            }
          }
        }
        todo &= ~grp;
      }
    }
  }
  __syncthreads();
  T* dst = dtable + bd.tab0 + lo;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const T v = acc[i];
    if (v != T(0)) atomicAdd(&dst[i], v);
  }
}

template <typename T>
int launch_bwd(const int* bands, int nband, const int* terms, const int* idx,
               const T* w, long long ncell, int width, const T* gout,
               int max_tablen, T* dtable, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // shared-memory elements per block; a split spans whole rows of at
  // most 16 elements, so cap - 15 elements of every band fit in one
  const int cap_max = kSmemBytes / static_cast<int>(sizeof(T));
  const int cap = std::max(kMaxNg, std::min(max_tablen, cap_max));
  const int splits = max_tablen <= cap
                         ? 1
                         : (max_tablen + cap - kMaxNg) / (cap - kMaxNg + 1);
  // many small chunks: the bands' work differs by up to 16x, and the
  // blocks of the large bands must spread over every SM (64 chunks per SM
  // and band ran the LW groups 10-40% faster than 4 on an H100 80GB HBM3
  // at 700 W, PERF.md)
  const long long ntiles = (ncell + kThreads - 1) / kThreads;
  long long chunks = (64LL * sms) / nband;
  if (chunks < 1) chunks = 1;
  if (chunks > ntiles) chunks = ntiles;
  const size_t smem = static_cast<size_t>(cap) * sizeof(T);
  err = cudaFuncSetAttribute(mix_groups_bwd_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nband, static_cast<unsigned>(chunks), splits);
  mix_groups_bwd_kernel<T><<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      bands, reinterpret_cast<const int2*>(terms), idx, w, ncell, width, gout,
      cap, dtable);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bands: nband x 7 ints (ng, ngp, t0, nt, goff, tab0, tablen); terms:
// T x 2 ints (base, rows); idx, w: T x ncell; gout: ncell x width;
// max_tablen: the largest tablen; dtable: the packed table's gradient,
// zeroed by the caller, added into.  Returns the CUDA error.
extern "C" int climt_mix_groups_bwd_f32(const int* bands, int nband,
                                        const int* terms, const int* idx,
                                        const float* w, long long ncell,
                                        int width, const float* gout,
                                        int max_tablen, float* dtable,
                                        void* stream) {
  return launch_bwd<float>(bands, nband, terms, idx, w, ncell, width, gout,
                           max_tablen, dtable, stream);
}

extern "C" int climt_mix_groups_bwd_f64(const int* bands, int nband,
                                        const int* terms, const int* idx,
                                        const double* w, long long ncell,
                                        int width, const double* gout,
                                        int max_tablen, double* dtable,
                                        void* stream) {
  return launch_bwd<double>(bands, nband, terms, idx, w, ncell, width, gout,
                            max_tablen, dtable, stream);
}
