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
// Work split: one thread per (g, column).  A block holds one column's 140
// g-points padded to 160 threads (five warps); the z loop runs inside the
// thread with the all-sky and clear-sky radiances in registers.  taug and
// fracs are (nz, ncol, 140) with g fastest, so each layer's loads are
// coalesced across the block.  Band-indexed inputs (Planck, emissivity,
// diffusivity, band cloud optics) are read through the constant NGB[140]
// table.  The g-sum of each interface is a deterministic block reduction
// (warp shuffles, then one thread adds the five warp sums in order).
//
// Bound: the bytes of taug and fracs (8 bytes per (g, layer, column)),
// read twice because the upward sweep recomputes the layer terms instead
// of storing them: keeping four terms per (g, layer, column) in a scratch
// would write and read 16 bytes more than the recompute reads.  So the
// kernel evaluates two exp per (g, layer, column), one in each sweep.
// Nothing per-g is written to device memory.
#include <cuda_runtime.h>

namespace {

constexpr int kNgpt = 140;
constexpr int kBands = 16;
constexpr int kThreads = 160;
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
  const float* odclb;     // (nz, ncol, 16) band cloud optical depth * secdiff
  const float* expb;      // (nz, ncol, 16) exp(-odclb)
  const float* efclb;     // (nz, ncol, 16) cloudy (1 - expb) * cldfrac
  const float* dwave_g;   // (140,)
  int nz;
  int ncol;
  float rec_6;
};

struct Layer {
  float atr;   // clear-sky absorptance
  float aeff;  // all-sky attenuation
  float gdn;   // clear-sky downward source
  float gup;   // clear-sky upward source
  float sdn;   // all-sky downward source
  float sup;   // all-sky upward source
};

__device__ __forceinline__ float source_factor(float od, float od_safe,
                                               float e, bool small,
                                               float rec_6) {
  return small ? rec_6 * od
               : 1.0f - 2.0f * (1.0f / od_safe - e / fmaxf(1.0f - e, 1e-30f));
}

__device__ __forceinline__ Layer layer_terms(const Inputs& in, int z, int c,
                                             int g, int b, float sec) {
  const long long gi = (static_cast<long long>(z) * in.ncol + c) * kNgpt + g;
  const long long bi = (static_cast<long long>(z) * in.ncol + c) * kBands + b;
  const long long bi_up =
      (static_cast<long long>(z + 1) * in.ncol + c) * kBands + b;
  const float fr = in.fracs[gi];
  const float blay = __ldg(&in.planklay[bi]);
  const float bdn = __ldg(&in.planklev[bi]) - blay;
  const float bup = __ldg(&in.planklev[bi_up]) - blay;

  const float od = fmaxf(in.taug[gi] * sec, 0.0f);
  const float od_safe = fmaxf(od, 1e-12f);
  const float expo = expf(-od_safe);
  const bool small = od <= 0.06f;  // gas test: non-strict
  Layer L;
  L.atr = small ? od - 0.5f * od * od : 1.0f - expo;
  const float tfacgas = source_factor(od, od_safe, expo, small, in.rec_6);
  L.gdn = fr * (blay + tfacgas * bdn) * L.atr;
  L.gup = fr * (blay + tfacgas * bup) * L.atr;

  const float cf = __ldg(&in.cldfrac[static_cast<long long>(z) * in.ncol + c]);
  if (cf >= 1e-6f) {
    const float odtot = od + __ldg(&in.odclb[bi]);
    const float odtot_safe = fmaxf(odtot, 1e-12f);
    const float expot = expo * __ldg(&in.expb[bi]);
    const bool small_t = odtot < 0.06f;  // total test: strict
    const float atot = small_t ? odtot - 0.5f * odtot * odtot : 1.0f - expot;
    const float tfactot =
        source_factor(odtot, odtot_safe, expot, small_t, in.rec_6);
    const float bbdtot = fr * (blay + tfactot * bdn);
    const float bbutot = fr * (blay + tfactot * bup);
    L.aeff = L.atr + __ldg(&in.efclb[bi]) * (1.0f - L.atr);
    L.sdn = L.gdn + cf * (bbdtot * atot - L.gdn);
    L.sup = L.gup + cf * (bbutot * atot - L.gup);
  } else {
    L.aeff = L.atr;
    L.sdn = L.gdn;
    L.sup = L.gup;
  }
  return L;
}

// Sum a and b over the block's threads; thread 0 writes them to pa, pb.
__device__ __forceinline__ void block_sum2(float a, float b, float* pa,
                                           float* pb,
                                           float (*red)[kWarps]) {
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sa = 0.0f, sb = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      sa += red[0][w];
      sb += red[1][w];
    }
    *pa = sa;
    *pb = sb;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    rtrn_lw_kernel(Inputs in, float* __restrict__ totu,
                   float* __restrict__ totd, float* __restrict__ totuc,
                   float* __restrict__ totdc) {
  __shared__ float red[2][kWarps];
  const int c = blockIdx.x;
  const int ncol = in.ncol;
  const int nz = in.nz;
  // padding threads shadow g-point 0 with a zero quadrature weight
  const bool live = threadIdx.x < kNgpt;
  const int g = live ? threadIdx.x : 0;
  const int b = NGB[g];
  const float dw = live ? in.dwave_g[g] : 0.0f;
  const float sec = in.secdiff[static_cast<long long>(b) * ncol + c];

  if (threadIdx.x == 0) {
    totd[static_cast<long long>(nz) * ncol + c] = 0.0f;  // TOA: no inflow
    totdc[static_cast<long long>(nz) * ncol + c] = 0.0f;
  }

  // downward sweep: top layer (nz-1) to the surface
  float rad = 0.0f, radc = 0.0f;
  for (int z = nz - 1; z >= 0; --z) {
    const Layer L = layer_terms(in, z, c, g, b, sec);
    rad = rad * (1.0f - L.aeff) + L.sdn;
    radc = radc * (1.0f - L.atr) + L.gdn;
    block_sum2(dw * rad, dw * radc, &totd[static_cast<long long>(z) * ncol + c],
               &totdc[static_cast<long long>(z) * ncol + c], red);
  }

  // surface emission + reflection (rrtmg_lw_rtrn.f90:460-476)
  const float rad0 =
      in.fracs[static_cast<long long>(c) * kNgpt + g] *
      in.plankbnd[static_cast<long long>(c) * kBands + b];
  const float reflect = 1.0f - in.semiss[static_cast<long long>(b) * ncol + c];
  float radu = rad0 + reflect * rad;
  float raduc = rad0 + reflect * radc;
  block_sum2(dw * radu, dw * raduc, &totu[c], &totuc[c], red);

  // upward sweep: surface layer 0 to the top
  for (int z = 0; z < nz; ++z) {
    const Layer L = layer_terms(in, z, c, g, b, sec);
    radu = radu * (1.0f - L.aeff) + L.sup;
    raduc = raduc * (1.0f - L.atr) + L.gup;
    block_sum2(dw * radu, dw * raduc,
               &totu[static_cast<long long>(z + 1) * ncol + c],
               &totuc[static_cast<long long>(z + 1) * ncol + c], red);
  }
}

}  // namespace

extern "C" int climt_rtrn_lw_f32(
    const float* taug, const float* fracs, const float* planklay,
    const float* planklev, const float* plankbnd, const float* semiss,
    const float* secdiff, const float* cldfrac, const float* odclb,
    const float* expb, const float* efclb, const float* dwave_g, int nz,
    int ncol, float rec_6, float* totu, float* totd, float* totuc,
    float* totdc, void* stream) {
  Inputs in{taug,   fracs,  planklay, planklev, plankbnd, semiss, secdiff,
            cldfrac, odclb, expb,     efclb,    dwave_g,  nz,     ncol,
            rec_6};
  rtrn_lw_kernel<<<ncol, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, totu, totd, totuc, totdc);
  return static_cast<int>(cudaGetLastError());
}
