// Table-row gather-sum for the RRTMG gas optics (kernel B).
//
//   out[s, g] = sum_t  w[t, s] * table[clip(idx[t, s], 0, R-1), g]
//
// Replaces climt_tpu/components/rrtmg/fused_mix.py:fused_mix_rows (the
// Pallas _mix_kernel, which builds one-hot rows in VMEM and contracts them
// on the MXU because TPU gathers do not vectorise).  On Hopper the gather
// is the natural form: the tables are at most a few thousand rows of <= 16
// floats (tens of KB), so they stay resident in L1/L2 and the kernel is
// bound by the streaming bytes of idx, w and out (8 T + 4 ng bytes a cell).
// One thread per (cell, g) with g fastest keeps the out stores coalesced;
// the idx/w loads of one cell are shared by its ng threads through L1, and
// the table is read through the read-only (__ldg) path.  Terms accumulate
// in float32 in term order.
#include <cuda_runtime.h>

namespace {

__global__ void mix_rows_kernel(const float* __restrict__ table, int rows,
                                int ng, const int* __restrict__ idx,
                                const float* __restrict__ w, int nterms,
                                long long ncell, float* __restrict__ out) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= ncell * ng) return;
  const long long cell = tid / ng;
  const int g = static_cast<int>(tid - cell * ng);
  float acc = 0.0f;
  for (int t = 0; t < nterms; ++t) {
    const long long k = static_cast<long long>(t) * ncell + cell;
    int r = __ldg(&idx[k]);
    r = r < 0 ? 0 : (r > rows - 1 ? rows - 1 : r);
    acc += __ldg(&w[k]) * __ldg(&table[static_cast<long long>(r) * ng + g]);
  }
  out[tid] = acc;
}

}  // namespace

extern "C" int climt_mix_rows_f32(const float* table, int rows, int ng,
                                  const int* idx, const float* w, int nterms,
                                  long long ncell, float* out, void* stream) {
  const int threads = 256;
  const long long total = ncell * ng;
  const long long blocks = (total + threads - 1) / threads;
  mix_rows_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      table, rows, ng, idx, w, nterms, ncell, out);
  return static_cast<int>(cudaGetLastError());
}
