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
// this gradient with XLA's autodiff of the float64 gather of
// climt_tpu/components/rrtmg/interp.py:45 (its Pallas kernel has none).
// One template serves float32 and float64; the calibration runs in
// float64.
//
// Bound: bytes.  Each weight and each index of a table of more than one
// row is read once, the upstream gradient once, the table gradient
// written once.  The work is a scatter with heavy contention: the cells
// of one level pick the same few rows of each term's table (on the T85
// radiation chunk almost every two neighbouring cells share a row).
// The design, against what limited the previous kernel (commit 2ff23a1:
// one cell a thread, a ballot and ng five-step butterflies for every
// distinct row of a warp, then ng shared-memory atomics from one lane; a
// block zeroing and flushing a whole band table for a few hundred cells;
// float64 tables split over blocks that each re-read the cells; strided
// loads of gout):
//   - a lane owns 16 bytes of consecutive cells of one level (4 in
//     float32, 2 in float64) and reads their indices and weights as
//     vectors.  For each term it sums w * gout over its cells of a row in
//     registers, so a warp meets once per row of its 128 (float32) or 64
//     (float64) cells, not once per row of 32;
//   - a warp sweeps its tile's rows, one row a sweep, taken from the first
//     lane with cells left: every lane adds its cells of that row, and a
//     transposing reduce-scatter (recursive halving: 8+4+2+1 shuffles and
//     one butterfly step for 16 values, against 80 shuffles for 16
//     butterflies) leaves each g's sum on its own lane, so ng lanes add
//     them with one atomic instruction.  A tile whose lanes' rows all
//     differ (__match_any_sync), or after kMaxSweeps sweeps, has each lane
//     add its own cells;
//   - the sums go straight to the table gradient in global memory: after
//     the warp's reduction the atomics are few, and a global float or
//     double atomicAdd is one RED instruction performed at the L2, where a
//     shared-memory one (a block's copy of the band table, or a cluster's
//     in distributed shared memory) is a compare-and-swap loop on sm_90a.
//     No block zeroes or flushes a table, and no cell is read twice;
//   - the band's padded width (4, 8, 12 or 16) is a template parameter:
//     the upstream gradient of the lane's cells and the sums live in
//     registers (no spills in either type);
//   - a warp's slice of gout (its cells x the band's ng columns) is copied
//     with cp.async along each cell's row, four neighbouring g to a group
//     of lanes, into shared memory g-major, then read back by each lane
//     for its own cells with 16-byte loads; the first term's indices and
//     weights load meanwhile, and each term's sums overlap the next term's
//     loads;
//   - the grid is (band, run of kRunCells cells), one block of four warps
//     each, bands fastest: the blocks of one run go out together, so the
//     blocks running at one time work on every band of the same cells and
//     read their gout from L2, and the card's scheduler fills SMs freed by
//     the short blocks of small bands.  A band without terms returns.
// The atomics add in an order that changes from run to run: the result
// varies in its last bits (the tolerance in chip_smoke.py says how much).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// row sweeps of one term over a tile before each lane adds its own cells
constexpr int kMaxSweeps = 8;
constexpr int kMaxNgp = 16;  // the widest band's padded width
// a block's run of cells: whole warp tiles in either type, so every run
// but the last starts on a 16-byte vector of each term's indices and
// weights
constexpr int kRunCells = 512;

// The cells of a lane: kCells consecutive cells, 16 bytes of weights.
template <typename T>
struct Lanes {
  static constexpr int kCells = 16 / static_cast<int>(sizeof(T));
  static constexpr int kTile = 32 * kCells;  // cells of a warp tile
  // a staging row: one g of a tile, padded so that neither the transposing
  // stores nor the 16-byte loads meet a bank twice
  static constexpr int kStride = kTile + 32 / static_cast<int>(sizeof(T));
  static_assert(kRunCells % kTile == 0, "a run is whole warp tiles");
};

struct Band {
  int ng, ngp, t0, nt, goff, tab0, tablen;
};

__device__ __forceinline__ Band load_band(const int* __restrict__ bands,
                                          int b) {
  const int* p = bands + 7 * b;
  return Band{__ldg(p),     __ldg(p + 1), __ldg(p + 2), __ldg(p + 3),
              __ldg(p + 4), __ldg(p + 5), __ldg(p + 6)};
}

__device__ __forceinline__ void load16(const float* p, float (&o)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void load16(const double* p, double (&o)[2]) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  o[0] = v.x, o[1] = v.y;
}
__device__ __forceinline__ void load_idx(const int* p, int (&o)[4]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void load_idx(const int* p, int (&o)[2]) {
  const int2 v = __ldg(reinterpret_cast<const int2*>(p));
  o[0] = v.x, o[1] = v.y;
}
__device__ __forceinline__ void lds16(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void lds16(const double* p, double (&o)[2]) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  o[0] = v.x, o[1] = v.y;
}

// a ? x : y in registers (a plain conditional on two array elements may be
// compiled as a computed address into local memory)
__device__ __forceinline__ float pick(bool a, float x, float y) {
  float r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %3, 0;\n\t"
      "selp.f32 %0, %1, %2, p;\n\t}"
      : "=f"(r) : "f"(x), "f"(y), "r"(static_cast<int>(a)));
  return r;
}
__device__ __forceinline__ double pick(bool a, double x, double y) {
  double r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %3, 0;\n\t"
      "selp.f64 %0, %1, %2, p;\n\t}"
      : "=d"(r) : "d"(x), "d"(y), "r"(static_cast<int>(a)));
  return r;
}

// One halving step of reduce_scatter and the steps after it: lanes l and
// l ^ O trade halves of their first N values, each keeping the half that
// bit O of its lane picks and adding its partner's copy of it.
template <int N, int O, int NV, typename T>
__device__ __forceinline__ void halve(T (&v)[NV], int lane) {
  if constexpr (N > 1) {
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const T send = pick(upper, v[j], v[j + N / 2]);
      const T keep = pick(upper, v[j + N / 2], v[j]);
      v[j] = keep + __shfl_xor_sync(kFull, send, O);
    }
    halve<N / 2, O / 2>(v, lane);
  }
}

// Sum of v[j] over the warp for every j < NV, scattered: lane l ends with
// the sum of j = l >> (5 - log2 NV).  Recursive halving (NV - 1 shuffles)
// leaves each lane one value summed over NV lanes; a butterfly over the
// remaining lane bits completes it.
template <int NV, typename T>
__device__ __forceinline__ T reduce_scatter(T (&v)[NV], int lane) {
  halve<NV, 16>(v, lane);
  T r = v[0];
#pragma unroll
  for (int o = 16 / NV; o > 0; o >>= 1) r += __shfl_xor_sync(kFull, r, o);
  return r;
}

// 4 or 8 bytes from global to shared memory, without registers; zeros
// where !valid
template <int N>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(N), "r"(valid ? N : 0));
}

template <typename T>
__device__ __forceinline__ void load_term(
    const int* __restrict__ idx, const T* __restrict__ w, long long k0,
    long long tb, long long end, int lane, bool vec, bool need_idx,
    int (&iv)[Lanes<T>::kCells], T (&wv)[Lanes<T>::kCells]) {
  constexpr int N = Lanes<T>::kCells;
  const long long cell = tb + lane * N;
  if (vec && cell + N <= end) {
    load16(w + k0 + cell, wv);
    if (need_idx) {
      load_idx(idx + k0 + cell, iv);
    } else {
#pragma unroll
      for (int v = 0; v < N; ++v) iv[v] = 0;
    }
  } else {
#pragma unroll
    for (int v = 0; v < N; ++v) {
      const bool in = cell + v < end;
      wv[v] = in ? __ldg(w + k0 + cell + v) : T(0);
      iv[v] = (in && need_idx) ? __ldg(idx + k0 + cell + v) : 0;
    }
  }
}

// One term's sums over a warp tile: the warp sweeps the tile's rows; each
// lane's cells of the swept row are summed in registers and reduced over
// the warp, and the ng sums added to the table gradient with one atomic
// instruction.
template <typename T, int NGP>
__device__ __forceinline__ void add_term(
    const int (&key)[Lanes<T>::kCells], const T (&cw)[Lanes<T>::kCells],
    const T (&gr)[Lanes<T>::kCells][NGP], unsigned rem, int ng, int lane,
    T* __restrict__ dtable) {
  using L = Lanes<T>;
  constexpr int NV = NGP == 12 ? 16 : NGP;  // reduce-scatter width
  constexpr int kShift = NV == 16 ? 1 : NV == 8 ? 2 : 3;
  for (int sweep = 0;; ++sweep) {
    // each lane's first row left; a tile whose lanes all differ there (or
    // one swept kMaxSweeps times) has its rows scattered: each lane then
    // adds its own cells
    int mine = -1;
#pragma unroll
    for (int i = L::kCells - 1; i >= 0; --i)
      if (rem >> i & 1u) mine = key[i];
    const unsigned busy = __ballot_sync(kFull, rem != 0);
    if (busy == 0) break;
    const unsigned same = __match_any_sync(kFull, mine);
    if (sweep == kMaxSweeps ||
        __all_sync(kFull, rem == 0 || __popc(same) == 1)) {
#pragma unroll
      for (int i = 0; i < L::kCells; ++i) {
        if (rem >> i & 1u) {
#pragma unroll
          for (int j = 0; j < NGP; ++j)
            if (j < ng) atomicAdd(dtable + key[i] + j, cw[i] * gr[i][j]);
        }
      }
      break;
    }
    // this sweep's row: the first row left on the first busy lane; every
    // lane sums its cells of that row
    const int k = __shfl_sync(kFull, mine, __ffs(busy) - 1);
    T acc[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[j] = T(0);
#pragma unroll
    for (int i = 0; i < L::kCells; ++i) {
      const bool take = (rem >> i & 1u) && key[i] == k;
      if (take) rem &= ~(1u << i);
      const T wi = take ? cw[i] : T(0);
#pragma unroll
      for (int j = 0; j < NGP; ++j) acc[j] += wi * gr[i][j];
    }
    const T sum = reduce_scatter<NV>(acc, lane);
    const int g = lane >> kShift;
    if ((lane & ((1 << kShift) - 1)) == 0 && g < ng)
      atomicAdd(dtable + k + g, sum);
  }
}

// One block's cells [b0, b1) of one band, in warp tiles.
template <typename T, int NGP>
__device__ __forceinline__ void band_cells(
    const Band& bd, const int2* __restrict__ terms,
    const int* __restrict__ idx, const T* __restrict__ w, long long ncell,
    int width, const T* __restrict__ gout, long long b0, long long b1,
    bool vec, T* stage, T* __restrict__ dtable) {
  using L = Lanes<T>;
  const int lane = threadIdx.x & 31;
  T* buf = stage + (threadIdx.x >> 5) * kMaxNgp * L::kStride;
  const long long ntile = (b1 - b0 + L::kTile - 1) / L::kTile;
  for (long long tile = threadIdx.x >> 5; tile < ntile; tile += kWarps) {
    const long long tb = b0 + tile * L::kTile;
    // the first term's indices and weights load during the staging
    int2 dn = __ldg(&terms[bd.t0]);
    int iv[L::kCells];
    T wv[L::kCells];
    load_term<T>(idx, w, static_cast<long long>(bd.t0) * ncell, tb, b1, lane,
                 vec, dn.y > 1, iv, wv);
    // the tile's upstream gradient, copied along each cell's row (four
    // neighbouring g a lane group) into shared memory, g-major, without
    // registers, and read back by each lane for its own cells
    {
      const T* src = gout + (tb + (lane >> 2)) * width + bd.goff + (lane & 3);
      const long long step = 8LL * width, left = b1 - tb - (lane >> 2);
#pragma unroll 1
      for (int q = 0; q < NGP / 4; ++q) {
        const bool g_ok = 4 * q + (lane & 3) < bd.ng;
        T* row = buf + (4 * q + (lane & 3)) * L::kStride + (lane >> 2);
        const T* from = src + 4 * q;
#pragma unroll 4
        for (int it = 0; it < L::kCells * 4; ++it, from += step) {
          const bool ok = g_ok && it * 8 < left;
          copy_async<sizeof(T)>(row + it * 8, ok ? from : gout, ok);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    T gr[L::kCells][NGP];
#pragma unroll
    for (int g = 0; g < NGP; ++g) {
      T o[L::kCells];
      lds16(buf + g * L::kStride + lane * L::kCells, o);
#pragma unroll
      for (int v = 0; v < L::kCells; ++v) gr[v][g] = o[v];
    }
    __syncwarp();

    bool in[L::kCells];
#pragma unroll
    for (int i = 0; i < L::kCells; ++i) in[i] = tb + lane * L::kCells + i < b1;
    for (int t = bd.t0; t < bd.t0 + bd.nt; ++t) {
      const int2 d = dn;
      int key[L::kCells];
      T cw[L::kCells];
      unsigned rem = 0;
#pragma unroll
      for (int i = 0; i < L::kCells; ++i) {
        const int r = d.y > 1 ? min(max(iv[i], 0), d.y - 1) : 0;
        key[i] = d.x - bd.tab0 + r * bd.ngp;
        cw[i] = wv[i];
        if (in[i]) rem |= 1u << i;
      }
      // the next term's indices and weights load while this one is summed
      if (t + 1 < bd.t0 + bd.nt) {
        dn = __ldg(&terms[t + 1]);
        load_term<T>(idx, w, static_cast<long long>(t + 1) * ncell, tb, b1,
                     lane, vec, dn.y > 1, iv, wv);
      }
      add_term<T, NGP>(key, cw, gr, rem, bd.ng, lane, dtable);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
    mix_groups_bwd_kernel(const int* __restrict__ bands,
                          const int2* __restrict__ terms,
                          const int* __restrict__ idx,
                          const T* __restrict__ w, long long ncell,
                          int width, const T* __restrict__ gout, bool vec,
                          T* __restrict__ dtable) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const stage = reinterpret_cast<T*>(smem_raw);
  // the block's band and run of cells: (blockIdx.z, blockIdx.y) numbers
  // the runs, for more than 65535 of them
  const long long b0 =
      (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) *
      kRunCells;
  const Band bd = load_band(bands, blockIdx.x);
  if (bd.nt == 0 || b0 >= ncell) return;
  const long long b1 = b0 + kRunCells < ncell ? b0 + kRunCells : ncell;
  T* const dst = dtable + bd.tab0;
  switch (bd.ngp) {
    case 4:
      band_cells<T, 4>(bd, terms, idx, w, ncell, width, gout, b0, b1, vec,
                       stage, dst);
      break;
    case 8:
      band_cells<T, 8>(bd, terms, idx, w, ncell, width, gout, b0, b1, vec,
                       stage, dst);
      break;
    case 12:
      band_cells<T, 12>(bd, terms, idx, w, ncell, width, gout, b0, b1, vec,
                        stage, dst);
      break;
    default:
      band_cells<T, 16>(bd, terms, idx, w, ncell, width, gout, b0, b1, vec,
                        stage, dst);
  }
}

template <typename T>
int launch_bwd(const int* bands, int nband, const int* terms, const int* idx,
               const T* w, long long ncell, int width, const T* gout,
               T* dtable, void* stream) {
  using L = Lanes<T>;
  if (nband <= 0 || ncell <= 0) return 0;
  // each warp stages up to kMaxNgp g of its tile
  const int smem =
      kWarps * kMaxNgp * L::kStride * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      mix_groups_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = ncell % L::kCells == 0 &&
                   reinterpret_cast<std::uintptr_t>(idx) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(w) % 16 == 0;
  const long long runs = (ncell + kRunCells - 1) / kRunCells;
  const long long ry = runs < 65535 ? runs : 65535;
  const dim3 grid(nband, static_cast<unsigned>(ry),
                  static_cast<unsigned>((runs + ry - 1) / ry));
  mix_groups_bwd_kernel<T><<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      bands, reinterpret_cast<const int2*>(terms), idx, w, ncell, width, gout,
      vec, dtable);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bands: nband x 7 ints (ng, ngp, t0, nt, goff, tab0, tablen); terms:
// T x 2 ints (base, rows); idx, w: T x ncell; gout: ncell x width;
// dtable: the packed table's gradient, zeroed by the caller, added into.
// Returns the CUDA error.
extern "C" int climt_mix_groups_bwd_f32(const int* bands, int nband,
                                        const int* terms, const int* idx,
                                        const float* w, long long ncell,
                                        int width, const float* gout,
                                        float* dtable, void* stream) {
  return launch_bwd<float>(bands, nband, terms, idx, w, ncell, width, gout,
                           dtable, stream);
}

extern "C" int climt_mix_groups_bwd_f64(const int* bands, int nband,
                                        const int* terms, const int* idx,
                                        const double* w, long long ncell,
                                        int width, const double* gout,
                                        double* dtable, void* stream) {
  return launch_bwd<double>(bands, nband, terms, idx, w, ncell, width, gout,
                            dtable, stream);
}
