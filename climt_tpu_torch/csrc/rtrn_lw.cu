// Fused RRTMG-LW flux integration (kernel A).
//
// Replaces climt_tpu/components/rrtmg/pallas_rtrn.py:rtrn_lw_fused (the
// Pallas _rtrn_kernel) and computes what lw_spectral.rtrn_lw's XLA path
// computes for float32, analytic transmittance and band clouds: per
// (g, layer, column) the gas optical depth od = taug * secdiff, the
// absorptance with its Taylor branch at od <= 0.06, the linear-in-tau
// source factor, the cloudy combination with exp(-od_tot) factored as
// exp(-od) * exp(-od_cloud); a downward sweep, surface emission plus
// reflection, an upward sweep; and the quadrature-weighted g-sums into
// all-sky and clear-sky up/down fluxes on the nz+1 interfaces.
//
// Bound: bytes.  taug and fracs are 8 bytes per (g, layer, column), the
// band inputs (Planck, band cloud depth) 16/140 of that, the outputs
// 16 bytes per (interface, column).  The design reads each of them once:
//   - A block owns one column, one thread per g-point (140 of 160).  At
//     block start every thread issues cp.async copies of the column's
//     (nz, 140) taug and fracs rows and (nz, 16) band rows into dynamic
//     shared memory (about 42 KB at nz=28, 90 KB at nz=60).  Other
//     resident blocks compute while one block's copies land.  (Two
//     columns per block, 280 of 288 threads busy, measured slower: the
//     larger tile leaves fewer blocks per SM; see PERF.md.)
//   - The band-space cloud prologue (odcl = taucld * secdiff, exp(-odcl),
//     the cloudy (1 - exp(-odcl)) * cldfrac) is computed once per (layer,
//     band) into shared memory by the block.
//   - Both sweeps read only shared memory; the up sweep recomputes its
//     layer terms (one exp per (g, layer) in each sweep) instead of
//     storing them.  Exponentials and divisions use the hardware
//     intrinsics (__expf, __fdividef): no slow-path branches.
//   - The g-sums take no block barrier: every 8 interfaces each warp
//     reduce-scatters its 16 values (all-sky and clear-sky) with 16
//     shuffles and writes the warp's partials to shared memory; after the
//     up sweep one __syncthreads, then the partials of each (interface,
//     flux) are added in warp order, so the sums are the same from run to
//     run.
// The z recurrences stay in registers; nothing per-g goes back to device
// memory.  With the loads hidden this way, the sweeps' arithmetic (a
// thread per (g, column) issues every layer's terms twice) is what takes
// the time, not the bytes.
#include <cuda_runtime.h>

namespace {

constexpr int kNgpt = 140;
constexpr int kBands = 16;
constexpr int kThreads = 160;  // 140 g-points in five warps
constexpr int kWarps = kThreads / 32;

// band (0-based) of each of the 140 g-points: NG = 10, 12, 16, 14, 16, 8,
// 12, 8, 12, 6, 8, 8, 4, 2, 2, 2 (rrtmg_lw_init.f90 ngc)
__constant__ int NGB[kNgpt] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1,  1,  1,  1,
    1,  1,  1,  1,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,
    2,  2,  3,  3,  3,  3,  3,  3,  3,  3,  3,  3,  3,  3,  3,  3,  4,  4,
    4,  4,  4,  4,  4,  4,  4,  4,  4,  4,  4,  4,  4,  4,  5,  5,  5,  5,
    5,  5,  5,  5,  6,  6,  6,  6,  6,  6,  6,  6,  6,  6,  6,  6,  7,  7,
    7,  7,  7,  7,  7,  7,  8,  8,  8,  8,  8,  8,  8,  8,  8,  8,  8,  8,
    9,  9,  9,  9,  9,  9,  10, 10, 10, 10, 10, 10, 10, 10, 11, 11, 11, 11,
    11, 11, 11, 11, 12, 12, 12, 12, 13, 13, 14, 14, 15, 15};

struct Inputs {
  const float* taug;      // (nz, ncol, 140)
  const float* fracs;     // (nz, ncol, 140)
  const float* planklay;  // (nz, ncol, 16)
  const float* planklev;  // (nz+1, ncol, 16)
  const float* plankbnd;  // (ncol, 16)
  const float* semiss;    // (16, ncol)
  const float* secdiff;   // (16, ncol)
  const float* cldfrac;   // (nz, ncol)
  const float* taucld;    // (nz, ncol, 16) band cloud optical depth
  const float* dwave_g;   // (140,)
  int nz;
  int ncol;
  float rec_6;
};

// One column's tile in shared memory (float offsets, each a multiple of 4).
struct Tile {
  float* taug;   // nz x 140
  float* fracs;  // nz x 140
  float* blay;   // nz x 16
  float* blev;   // (nz+1) x 16
  float* odcl;   // nz x 16: taucld on arrival, then taucld * secdiff
  float* expcl;  // nz x 16: exp(-odcl)
  float* efcl;   // nz x 16: cloudy (1 - exp(-odcl)) * cldfrac
  float* cld;    // nz (rounded up to 4)
};

__host__ __device__ inline int tile_floats(int nz) {
  return 2 * nz * kNgpt + (5 * nz + 1) * kBands + ((nz + 3) & ~3);
}

__device__ __forceinline__ Tile tile_at(float* base, int nz) {
  Tile t;
  t.taug = base;
  t.fracs = t.taug + nz * kNgpt;
  t.blay = t.fracs + nz * kNgpt;
  t.blev = t.blay + nz * kBands;
  t.odcl = t.blev + (nz + 1) * kBands;
  t.expcl = t.odcl + nz * kBands;
  t.efcl = t.expcl + nz * kBands;
  t.cld = t.efcl + nz * kBands;
  return t;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

struct Layer {
  float atr;   // clear-sky absorptance
  float aeff;  // all-sky attenuation
  float gdn;   // clear-sky downward source
  float gup;   // clear-sky upward source
  float sdn;   // all-sky downward source
  float sup;   // all-sky upward source
};

// Linear-in-tau source factor, Taylor form where small.  __fdividef and
// __expf (below) are the hardware reciprocal and exponent: a few ulp, far
// inside the kernel's 2e-6-of-max tolerance, and no slow-path branches.
__device__ __forceinline__ float source_factor(float od, float od_safe,
                                               float e, bool small,
                                               float rec_6) {
  const float tfn =
      1.0f - 2.0f * (__fdividef(1.0f, od_safe) -
                     __fdividef(e, fmaxf(1.0f - e, 1e-30f)));
  return small ? rec_6 * od : tfn;
}

__device__ __forceinline__ Layer layer_terms(const Tile& s, int z, int g,
                                             int b, float sec, float rec_6) {
  const int zb = z * kBands + b;
  const float fr = s.fracs[z * kNgpt + g];
  const float blay = s.blay[zb];
  const float bdn = s.blev[zb] - blay;
  const float bup = s.blev[zb + kBands] - blay;

  const float od = fmaxf(s.taug[z * kNgpt + g] * sec, 0.0f);
  const float od_safe = fmaxf(od, 1e-12f);
  const float expo = __expf(-od_safe);
  const bool small = od <= 0.06f;  // gas test: non-strict
  Layer L;
  L.atr = small ? od - 0.5f * od * od : 1.0f - expo;
  const float tfacgas =
      source_factor(od, od_safe, expo, small, rec_6);
  L.gdn = fr * (blay + tfacgas * bdn) * L.atr;
  L.gup = fr * (blay + tfacgas * bup) * L.atr;

  const float cf = s.cld[z];
  if (cf >= 1e-6f) {
    const float odtot = od + s.odcl[zb];
    const float odtot_safe = fmaxf(odtot, 1e-12f);
    const float expot = expo * s.expcl[zb];
    const bool small_t = odtot < 0.06f;  // total test: strict
    const float atot = small_t ? odtot - 0.5f * odtot * odtot : 1.0f - expot;
    const float tfactot =
        source_factor(odtot, odtot_safe, expot, small_t, rec_6);
    const float bbdtot = fr * (blay + tfactot * bdn);
    const float bbutot = fr * (blay + tfactot * bup);
    L.aeff = L.atr + s.efcl[zb] * (1.0f - L.atr);
    L.sdn = L.gdn + cf * (bbdtot * atot - L.gdn);
    L.sup = L.gup + cf * (bbutot * atot - L.gup);
  } else {
    L.aeff = L.atr;
    L.sdn = L.gdn;
    L.sup = L.gup;
  }
  return L;
}

constexpr int kBatch = 8;  // interfaces reduced together

// Warp sums of v[j] (all-sky) and v[kBatch + j] (clear-sky) at interface
// iface0 + step * j, j < kBatch, over the warp's lanes, as one
// reduce-scatter: the 2 * kBatch values take 2 * kBatch shuffles, where
// one reduction each would take 5.  Lanes 2j and 2j+1 end with the sum of
// value j; the even lane stores it at part[warp][iface][q (+1 for clear
// sky)].
__device__ __forceinline__ void flush_partials(float (&v)[2 * kBatch],
                                               float* part, int nz1,
                                               int iface0, int step, int q) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = kBatch; n >= 1; n >>= 1) {
    const bool up = lane & (2 * n);
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = up ? v[i] : v[i + n];
      const float keep = up ? v[i + n] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * n);
    }
  }
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 1);
  const int j = lane >> 1;  // 0..kBatch-1 all-sky, kBatch.. clear
  const int iface = iface0 + step * (j % kBatch);
  if (!(lane & 1) && iface >= 0 && iface < nz1)
    part[((threadIdx.x >> 5) * nz1 + iface) * 4 + q + j / kBatch] = v[0];
}

__global__ void __launch_bounds__(kThreads)
    rtrn_lw_kernel(Inputs in, float* __restrict__ totu,
                   float* __restrict__ totd, float* __restrict__ totuc,
                   float* __restrict__ totdc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nz = in.nz, ncol = in.ncol, nz1 = nz + 1;
  const long long c = blockIdx.x;
  const Tile s = tile_at(smem, nz);
  float* part = smem + tile_floats(nz);  // [warp][nz+1][4]: dn, dnc, up, upc

  // 1. bring the column in: 16-byte async copies of the g rows and band
  //    rows; cldfrac by plain loads
  for (int i = threadIdx.x; i < nz * (kNgpt / 4); i += kThreads) {
    const int z = i / (kNgpt / 4);
    const int q = 4 * (i - z * (kNgpt / 4));
    const long long src = (z * static_cast<long long>(ncol) + c) * kNgpt + q;
    cp_async16(s.taug + z * kNgpt + q, in.taug + src);
    cp_async16(s.fracs + z * kNgpt + q, in.fracs + src);
  }
  for (int i = threadIdx.x; i < (3 * nz + 1) * 4; i += kThreads) {
    const int r = i >> 2;
    const int q = 4 * (i & 3);
    if (r < nz) {
      cp_async16(s.blay + r * kBands + q,
                 in.planklay + (r * static_cast<long long>(ncol) + c) *
                                   kBands + q);
    } else if (r < 2 * nz + 1) {
      const int z = r - nz;
      cp_async16(s.blev + z * kBands + q,
                 in.planklev + (z * static_cast<long long>(ncol) + c) *
                                   kBands + q);
    } else {
      const int z = r - 2 * nz - 1;
      cp_async16(s.odcl + z * kBands + q,
                 in.taucld + (z * static_cast<long long>(ncol) + c) *
                                 kBands + q);
    }
  }
  for (int z = threadIdx.x; z < nz; z += kThreads)
    s.cld[z] = __ldg(&in.cldfrac[z * static_cast<long long>(ncol) + c]);
  cp_async_wait_all();
  __syncthreads();

  // 2. band-space cloud optics, once per (layer, band)
  for (int i = threadIdx.x; i < nz * kBands; i += kThreads) {
    const float cf = s.cld[i / kBands];
    const bool cloudy = cf >= 1e-6f;
    const float sec_b =
        __ldg(&in.secdiff[(i % kBands) * static_cast<long long>(ncol) + c]);
    const float od = cloudy ? s.odcl[i] * sec_b : 0.0f;
    const float e = expf(-od);
    s.odcl[i] = od;
    s.expcl[i] = e;
    s.efcl[i] = cloudy ? (1.0f - e) * cf : 0.0f;
  }
  __syncthreads();

  // 3. one thread per g-point; padding threads shadow g-point 0 with a
  //    zero quadrature weight
  const bool live = threadIdx.x < kNgpt;
  const int g = live ? threadIdx.x : 0;
  const int b = NGB[g];
  const float dw = live ? __ldg(&in.dwave_g[g]) : 0.0f;
  const float sec = __ldg(&in.secdiff[b * static_cast<long long>(ncol) + c]);

  // downward sweep, top layer (nz-1) to the surface, kBatch layers at a
  // time: the recurrence in registers, the g-sums of the batch reduced
  // together
  float rad = 0.0f, radc = 0.0f;
  for (int z0 = nz - 1; z0 >= 0; z0 -= kBatch) {
    float v[2 * kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int z = z0 - j;
      if (z >= 0) {
        const Layer L = layer_terms(s, z, g, b, sec, in.rec_6);
        rad = rad * (1.0f - L.aeff) + L.sdn;
        radc = radc * (1.0f - L.atr) + L.gdn;
      }
      v[j] = dw * rad;
      v[kBatch + j] = dw * radc;
    }
    flush_partials(v, part, nz1, z0, -1, 0);
  }

  // surface emission + reflection (rrtmg_lw_rtrn.f90:460-476), then the
  // upward sweep: interface 0 is the surface, interface i tops layer i-1
  const float rad0 =
      s.fracs[g] * __ldg(&in.plankbnd[static_cast<long long>(c) * kBands + b]);
  const float reflect =
      1.0f - __ldg(&in.semiss[b * static_cast<long long>(ncol) + c]);
  float radu = rad0 + reflect * rad;
  float raduc = rad0 + reflect * radc;
  for (int i0 = 0; i0 <= nz; i0 += kBatch) {
    float v[2 * kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j;
      if (i >= 1 && i <= nz) {
        const Layer L = layer_terms(s, i - 1, g, b, sec, in.rec_6);
        radu = radu * (1.0f - L.aeff) + L.sup;
        raduc = raduc * (1.0f - L.atr) + L.gup;
      }
      v[j] = dw * radu;
      v[kBatch + j] = dw * raduc;
    }
    flush_partials(v, part, nz1, i0, 1, 2);
  }
  __syncthreads();

  // 4. add the warp partials in warp order; the TOA downward flux is 0
  for (int i = threadIdx.x; i < nz1 * 4; i += kThreads) {
    const int iface = i >> 2;
    const int q = i & 3;
    float sum = 0.0f;
    if (q >= 2 || iface < nz) {
      for (int w = 0; w < kWarps; ++w) sum += part[(w * nz1 + iface) * 4 + q];
    }
    float* dst = q == 0 ? totd : (q == 1 ? totdc : (q == 2 ? totu : totuc));
    dst[iface * static_cast<long long>(ncol) + c] = sum;
  }
}

}  // namespace

extern "C" int climt_rtrn_lw_f32(
    const float* taug, const float* fracs, const float* planklay,
    const float* planklev, const float* plankbnd, const float* semiss,
    const float* secdiff, const float* cldfrac, const float* taucld,
    const float* dwave_g, int nz, int ncol, float rec_6, float* totu,
    float* totd, float* totuc, float* totdc, void* stream) {
  const Inputs in{taug,    fracs,  planklay, planklev, plankbnd,
                  semiss,  secdiff, cldfrac, taucld,   dwave_g,
                  nz,      ncol,   rec_6};
  const size_t bytes = sizeof(float) * (tile_floats(nz) + kWarps * (nz + 1) * 4);
  const cudaError_t e = cudaFuncSetAttribute(
      rtrn_lw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  rtrn_lw_kernel<<<ncol, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      in, totu, totd, totuc, totdc);
  return static_cast<int>(cudaGetLastError());
}
