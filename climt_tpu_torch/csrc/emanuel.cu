// Emanuel-Zivkovic-Rothman convection (v4.3c), the whole scheme in one
// kernel: what components/emanuel_convection.py:emanuel_convect_plain
// computes, for every column, in the caller's precision.
//
// Replaces no TPU kernel: the JAX package runs the scheme inside one
// lax.scan that XLA fuses.  The eager port issued about 5,600 small
// launches a call (level loops over 32768 columns) and three pageable
// host-to-device copies, each of which synchronised the stream.
//
// Bound: operations, counted from this body (chip_smoke.py EMANUEL_OPS:
// each add, multiply, division, comparison, min, max, sqrt, exp, log and
// pow is one; a level recurrence counts once per level, a warp sum as one
// lane's adds; branches taken on some cells only are left out).  Every
// column: 151 per level and 70 more.  A convecting column besides: 86 per
// (origin level i, mixing level j) of the dense mixing matrix, 7 more above
// its diagonal, 250 per level and 91 more.  At nz=28 and 32768 columns all
// convecting that is 2.67e9, 40 us at 67 TFLOP/s (float32), against 41.7 MB
// of inputs ((7 nz + 2) values a column) and outputs ((4 nz + 6) values and
// an int64), 12 us at 3.35 TB/s.  A column that does not convect stops after
// the cloud-base closure: its other outputs are 0 in the plain version too
// (its last torch.where).
//
// Design: one warp per column, lane = level (nz <= 32).
//   - Level arrays live in registers, one level a lane; a value of another
//     level is a __shfl_sync.  The vertical recurrences (minimum-MSE search,
//     CAPE and inb, the precipitating downdraft) are run by every lane at
//     once on broadcast values, so no lane waits on another and the lane of
//     each level keeps its own results.
//   - The mixing matrix: lane i owns row i and walks j in order, so the
//     running SMIN over j is the plain version's sequential loop.  sij,
//     altem and the weights of row i go to shared memory (three nz x 33
//     tiles a warp, 11 KB at nz=28 in float32) between the passes.  Sums
//     over i (the entrained fluxes of level j, the downdraft's water source)
//     are warp reductions; amp1 and ad, the two triangular double sums, are
//     row prefix and suffix sums transposed through shared memory.
//   - The geopotential is torch.cumsum's scan on the card (ATen's
//     ScanUtils.cuh, Sklansky over 2^L >= 32 elements), so gz is the plain
//     version's bit for bit.  Every other expression keeps the plain
//     version's order of operations, Python scalars are rounded to the
//     working type as PyTorch rounds them, a division by a scalar is the
//     product with its rounded reciprocal and `c / x` is reciprocal(x) * c,
//     as PyTorch's CUDA kernels compute them; this file is built with
//     -fmad=false so that no product and sum fuse.  The level decisions
//     (nk, icb, inb, the entrainment pattern) therefore see the same numbers
//     as the plain version; only sums over levels, taken in another order,
//     differ in the last bits.
#include <cuda_runtime.h>

#include <cmath>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kMaxNz = 32;
constexpr int kWarps = 8;      // columns a block
constexpr int kStride = 33;    // row stride of the shared tiles
constexpr unsigned kAll = 0xffffffffu;

// the plain version's params dict, in the order of the C interface
struct Params {
  double cpd, cpv, cl, rv, rd, lv0, g, rowl, sigd, sigs, entp, elcrit,
      tlcrit, omtrain, omtsnow, coeffr, coeffs, cu, beta, dtmax, alpha, damp,
      delt0, dt;
};
static_assert(sizeof(Params) == 24 * sizeof(double), "Params: 24 doubles");

template <typename R>
struct Level {  // element (c, k) at p[c * sc + k * sk]
  const R* p;
  long long sc, sk;
  __device__ R at(long long c, int k) const { return p[c * sc + k * sk]; }
};

template <typename R>
struct Args {
  Level<R> T, q, qs, u, v, p, ph;
  const R* cbmf_in;
  long long cbmf_s;
  R *ft, *fq, *fu, *fv;      // (c, k) at c * osc + k * osk
  long long osc, osk;
  R *precip, *wd, *tprime, *qprime, *cbmf, *cape;
  long long* iflag;
  int ncol, nz, nl, minorig;
};

// torch.maximum / torch.clamp(min=) / torch.minimum: a NaN propagates
template <typename R>
__device__ __forceinline__ R mx(R a, R b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename R>
__device__ __forceinline__ R mn(R a, R b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
template <typename R>
__device__ __forceinline__ R sh(R x, int src) {
  return __shfl_sync(kAll, x, src);
}
// butterfly sum: every lane ends with the same value
template <typename R>
__device__ __forceinline__ R warp_sum(R x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}
template <typename R>
__device__ __forceinline__ R ex(R x) {
  if constexpr (std::is_same_v<R, float>) return expf(x); else return exp(x);
}
template <typename R>
__device__ __forceinline__ R lg(R x) {
  if constexpr (std::is_same_v<R, float>) return logf(x); else return log(x);
}
template <typename R>
__device__ __forceinline__ R pw(R x, R y) {
  if constexpr (std::is_same_v<R, float>) return powf(x, y);
  else return pow(x, y);
}
template <typename R>
__device__ __forceinline__ R sq(R x) {
  if constexpr (std::is_same_v<R, float>) return sqrtf(x);
  else return sqrt(x);
}
template <typename R>
__device__ __forceinline__ R ab(R x) {
  if constexpr (std::is_same_v<R, float>) return fabsf(x);
  else return fabs(x);
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Inclusive scan of the values at positions 0..n-1 held one a lane (lane
// of position r: r, or n-1-r when reversed), as torch.cumsum computes a
// row of at most 32 on the card: Sklansky's steps, the padding zeros never
// read by a position below n.
template <typename R>
__device__ R row_cumsum(R x, int lane, int n, bool reversed) {
  const int pos = lane < n ? (reversed ? n - 1 - lane : lane) : -1;
  if (pos == 0) x = x + R(0);     // the running total of earlier chunks
#pragma unroll
  for (int m = 0; m < 5; ++m) {
    const int s = 1 << m;
    const int si = pos < 0 ? 0 : ((pos >> (m + 1)) << (m + 1)) + s - 1;
    const int src = reversed ? n - 1 - si : si;
    const R y = sh(x, src < 0 ? 0 : (src > 31 ? 31 : src));
    if (pos >= 0 && (pos & s)) x = x + y;
  }
  return x;
}

template <typename R>
__global__ void __launch_bounds__(kWarps * 32)
    emanuel_kernel(const Args<R> a, const Params P) {
  extern __shared__ unsigned char smem_raw[];
  const int nz = a.nz;
  const int k = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (c >= a.ncol) return;             // the whole warp
  R* const tile = reinterpret_cast<R*>(smem_raw) + warp * 3 * nz * kStride;
  R* const S = tile;                   // sij[i][j] at S[j * kStride + i]
  R* const A = S + nz * kStride;       // altem
  R* const W = A + nz * kStride;       // weights, then the final ment
  const bool lev = k < nz;
  const int kc = lev ? k : nz - 1;     // lanes above the top read the top
  const R one = R(1), zero = R(0);

  const double cpd = P.cpd, cpv = P.cpv, cl = P.cl, rv = P.rv, rd = P.rd;
  const double lv0 = P.lv0, g = P.g, sigd = P.sigd;
  const double cpvmcl = cl - cpv;
  const double eps = rd / rv;
  const double epsi = 1.0 / eps;
  const double ginv = 1.0 / g;
  const int nl0 = a.nl - 1;
  const R inv_cpd = one / R(cpd);

  // ---- inputs, one level a lane --------------------------------------
  const R T = a.T.at(c, kc), q = a.q.at(c, kc), qs = a.qs.at(c, kc);
  const R u = a.u.at(c, kc), v = a.v.at(c, kc), p = a.p.at(c, kc);
  const R ph = a.ph.at(c, kc), ph1 = a.ph.at(c, kc + 1);
  const R cbmf_in = a.cbmf_in[c * a.cbmf_s];
  const R dph = ph - ph1;

  // ---- geopotential, heat capacity, static energies -------------------
  const R tv = T * ((q * R(epsi) + one) - q);
  const int kdn = k > 0 ? k - 1 : 0;
  const R tv_dn = sh(tv, kdn), p_dn = sh(p, kdn);
  R gz_incr = zero;
  if (lev && k >= 1) gz_incr = ((R(0.5 * rd) * (tv + tv_dn)) * (p_dn - p)) / ph;
  const R gz = row_cumsum(gz_incr, k, nz, false);
  const R cpn = R(cpd) * (one - q) + R(cpv) * q;
  const R h = T * cpn + gz;
  const R lv = R(lv0) - R(cpvmcl) * (T - R(273.15));
  const R T0 = sh(T, 0);
  R hm = (((R(cpd) * (one - q) + R(cl) * q) * (T - T0)) + lv * q) + gz;
  if (k == 0) hm = lv * q;
  const R lvcp = lv / cpn;

  // ---- level of minimum moist static energy ---------------------------
  R ahmin = R(1e12);
  int ihmin = nl0;
  const int kmin = a.minorig > 1 ? a.minorig : 1;
  for (int kk = 1; kk < nl0 + 2; ++kk) {
    const R hk = sh(hm, kk), hkm = sh(hm, kk - 1);
    if (hk < ahmin && hk < hkm && kk >= kmin) {
      ahmin = hk;
      ihmin = kk;
    }
  }
  ihmin = ihmin < nl0 - 1 ? ihmin : nl0 - 1;

  // ---- parcel origin nk: the first largest hm > 0 in [minorig, ihmin]
  const int in_range = lev && k >= a.minorig && k <= ihmin && hm > zero;
  int nk = 0;
  {
    bool any = false;
    R best = zero;
    for (int kk = 0; kk < nz; ++kk) {
      const R hk = sh(hm, kk);
      if (sh(in_range, kk) && (!any || hk > best)) {
        best = hk;
        nk = kk;
        any = true;
      }
    }
  }
  const R T_nk = sh(T, nk), q_nk = sh(q, nk), qs_nk = sh(qs, nk);
  const R p_nk = sh(p, nk);
  const bool no_conv0 = (T_nk < R(250.0)) || (q_nk <= zero) || (ihmin == nl0 - 1);

  // ---- lifted condensation level, cloud base icb ----------------------
  const R rh = q_nk / mx(qs_nk, R(1e-30));
  const R chi = T_nk / ((R(1669.0) - R(122.0) * rh) - T_nk);
  const R plcl = p_nk * pw(mx(rh, R(1e-30)), chi);
  const bool no_conv2 = (plcl < R(200.0)) || (plcl >= R(2000.0));
  const unsigned above = __ballot_sync(kAll, lev && (p < plcl) && k > nk && k <= nl0);
  int icb = above ? __ffs(above) - 1 : nl0 - 1;
  icb = icb < nl0 - 1 ? icb : nl0 - 1;
  const bool no_conv3 = icb >= nl0 - 1;
  const bool no_conv = no_conv0 || no_conv2 || no_conv3;
  const int icb_s = clampi(icb, 1, nz - 3);
  const int nk_s = clampi(nk, 0, nz - 4);

  // ---- lifted parcel (lifted_parcel: dry below icb_s, two Newton steps)
  const R gz_nk = sh(gz, nk);
  const R ah0 = (((R(cpd) * (one - q_nk) + R(cl) * q_nk) * T_nk)
                 + q_nk * (R(lv0) - R(cpvmcl) * (T_nk - R(273.15)))) + gz_nk;
  const R cpp = R(cpd) * (one - q_nk) + q_nk * R(cpv);
  const R tp_dry = T_nk - (gz - gz_nk) / cpp;
  const R tvp_dry = tp_dry * (q_nk * R(epsi) + one);
  R tg = T, qg = qs;
  const R alv = lv;
  for (int it = 0; it < 2; ++it) {
    const R s = one / ((((alv * alv) * qg) / ((R(rv) * T) * T)) + R(cpd));
    const R ahg = ((R(cpd) * tg + (R(cl - cpd) * q_nk) * T) + alv * qg) + gz;
    tg = mx(tg + s * (ah0 - ahg), R(35.0));
    const R tc = tg - R(273.15);
    const R es_warm = ex((tc * R(17.67)) / (tc + R(243.5))) * R(6.112);
    const R es_cold = ex((R(23.33086) - (one / tg) * R(6111.72784))
                         + lg(tg) * R(0.15215));
    const R es = tc >= zero ? es_warm : es_cold;
    qg = (es * R(eps)) / mx(p - es * R(1.0 - eps), R(1e-30));
  }
  const R tp_sat = ((((ah0 - (R(cl - cpd) * q_nk) * T) - gz) - alv * qg)) * inv_cpd;
  const R rg = qg / (one - q_nk);
  const R tvp_sat = tp_sat * (rg * R(epsi) + one);
  const bool below_cb = k < icb_s;
  const R tp = below_cb ? tp_dry : tp_sat;
  R tvp = below_cb ? tvp_dry : tvp_sat;
  const R clw = below_cb ? zero : mx(q_nk - qg, zero);
  tvp = tvp - tp * q_nk;
  {
    const R tvp_nl0 = sh(tvp, nl0), gz_nl0 = sh(gz, nl0);
    const R gz_nl1 = sh(gz, nl0 + 1);
    if (k == nl0 + 1) tvp = tvp_nl0 - (gz_nl1 - gz_nl0) * inv_cpd;
  }

  const R tv_icb = sh(tv, icb_s), tvp_icb = sh(tvp, icb_s);
  const bool stable_skip = (cbmf_in == zero) && (tvp_icb <= tv_icb - R(P.dtmax));

  // ---- precipitation efficiencies -------------------------------------
  const R tca = tp - R(273.15);
  R elacrit = tca >= zero ? R(P.elcrit)
                          : R(P.elcrit) * (one - tca * (one / R(P.tlcrit)));
  elacrit = mx(elacrit, zero);
  R ep = R(0.999) * (one - elacrit / mx(clw, R(1e-8)));
  ep = mn(mx(ep, zero), R(0.999));
  if (k <= nk_s) ep = zero;

  // ---- CAPE and the top of convection inb -----------------------------
  const R by = ((tvp - tv) * dph) / p;
  R cape = zero, capem = zero, byp = zero;
  int inb = icb_s + 1, inb1 = icb_s + 1;
  for (int kk = 0; kk < nz - 1; ++kk) {
    const R by_i = sh(by, kk), by_n = sh(by, kk + 1);
    const bool act = kk >= icb_s + 1 && kk <= nl0 - 1;
    if (act) cape = cape + by_i;
    if (act && by_i >= zero) inb1 = kk + 1;
    if (act && cape > zero) {
      inb = kk + 1;
      byp = by_n;
      capem = cape;
    }
  }
  inb = inb > inb1 ? inb : inb1;
  inb = inb > icb_s + 1 ? inb : icb_s + 1;
  inb = inb < nl0 ? inb : nl0;
  cape = capem + byp;
  const R defrac = mx(capem - cape, R(0.001));
  const R frac = mn(mx((-cape) / defrac, zero), one);

  // ---- liquid water static energy of the lifted parcel ----------------
  const R h_nks = sh(h, nk_s);
  const bool in_cloud = k >= icb_s && k <= inb;
  const R hp = in_cloud ? h_nks + (((lv + T * R(cpd - cpv)) * ep) * clw) : h;

  // ---- cloud base mass flux relaxation --------------------------------
  const int icbm1 = clampi(icb_s - 1, 0, nz - 1);
  const int icbp1 = clampi(icb_s + 1, 0, nz - 1);
  const R tvp_icbm1 = sh(tvp, icbm1), p_icbm1 = sh(p, icbm1);
  const R cpn_icbm1 = sh(cpn, icbm1);
  const R tvpplcl = tvp_icbm1 - ((R(rd) * tvp_icbm1) * (p_icbm1 - plcl))
                                    / (cpn_icbm1 * p_icbm1);
  const R tvp_icbp1 = sh(tvp, icbp1), p_icb = sh(p, icb_s);
  const R p_icbp1 = sh(p, icbp1);
  const R tvaplcl = tv_icb + ((tvp_icb - tvp_icbp1) * (plcl - p_icb))
                                 / (p_icb - p_icbp1);
  R dtpbl = warp_sum((lev && k >= nk_s && k <= icbm1) ? (tvp - tv) * dph : zero);
  dtpbl = dtpbl / mx(sh(ph, nk_s) - sh(ph, icb_s), R(1e-10));
  const R dtma = ((tvpplcl - tvaplcl) + R(P.dtmax)) + dtpbl;
  const double damps = P.damp * P.dt / P.delt0;
  const R cbmf = mx(R(1.0 - damps) * cbmf_in + R(0.1 * P.alpha) * dtma, zero);
  const bool zero_flux_skip = (cbmf == zero) && (cbmf_in == zero);
  const bool active = !no_conv && !stable_skip && !zero_flux_skip;

  if (k == 0) a.cbmf[c] = no_conv ? zero : (stable_skip ? cbmf_in : cbmf);
  if (!active) {
    // every other output of a column that does not convect is 0
    if (lev) {
      const long long o = c * a.osc + k * a.osk;
      a.ft[o] = zero;
      a.fq[o] = zero;
      a.fu[o] = zero;
      a.fv[o] = zero;
    }
    if (k == 0) {
      a.precip[c] = zero;
      a.wd[c] = zero;
      a.tprime[c] = zero;
      a.qprime[c] = zero;
      a.cape[c] = zero;
      a.iflag[c] = 0;
    }
    return;
  }

  // ---- mixing rates m(i) ----------------------------------------------
  const int k_eff = k < inb1 ? k : inb1;
  const R tv_eff = sh(tv, k_eff), tvp_eff = sh(tvp, k_eff);
  const R dph_eff = sh(dph, k_eff < nz - 1 ? k_eff : nz - 1);
  const R dbo = ab(tv_eff - tvp_eff) + R(P.entp * 0.02) * dph_eff;
  const bool m_mask = lev && k >= icb_s + 1 && k <= inb;
  const R dbosum = warp_sum(m_mask ? dbo : zero);
  const R m = m_mask ? (cbmf * dbo) / mx(dbosum, R(1e-30)) : zero;

  // ---- row i = k of the buoyancy-sorted mixing matrix -----------------
  const int i = k;
  const R qti = q_nk - ep * clw;
  const R u_nk = sh(u, nk_s), v_nk = sh(v, nk_s);
  const R bf2 = (((lv * lv) * qs) / (((R(rv) * T) * T) * R(cpd))) + one;
  const R cwat = clw * (one - ep);
  const bool row_ok = lev && i >= icb_s + 1 && i <= inb;
  const R d_hhp = h - hp;

  // pass 1: sij and altem; entrainment count
  int nent = 0;
  for (int j = 0; j < nz; ++j) {
    const R Tj = sh(T, j), qj = sh(q, j), qsj = sh(qs, j), lvj = sh(lv, j);
    const R hj = sh(h, j), bf2j = sh(bf2, j), cwatj = sh(cwat, j);
    const R anum = (hj - hp) + ((Tj * R(cpv - cpd)) * (qti - qj));
    const R denom = d_hhp + ((R(cpd - cpv) * (q - qti)) * Tj);
    const R dei = ab(denom) < R(0.01) ? R(0.01) : denom;
    R sij = anum / dei;
    if (i == j) sij = one;
    R altem = (((sij * q) + ((one - sij) * qti)) - qsj) / bf2j;
    if (j > i && ((sij < zero) || (sij > one) || (altem > cwatj))) {
      const R anum2 = anum - lvj * ((qti - qsj) - cwatj * bf2j);
      R denom2 = denom + lvj * (q - qti);
      denom2 = ab(denom2) < R(0.01) ? R(0.01) : denom2;
      const R sij2 = anum2 / denom2;
      altem = (((sij2 * q) + ((one - sij2) * qti)) - qsj) - ((bf2j - one) * cwatj);
      sij = sij2;
    }
    const bool valid = row_ok && j >= icb_s && j <= inb;
    if (valid && sij > zero && sij < R(0.9)) ++nent;
    if (lev) {
      S[j * kStride + i] = sij;
      A[j * kStride + i] = altem;
    }
  }
  __syncwarp();

  // scrit of row i
  R den_s = d_hhp + lv * (q - qti);
  den_s = ab(den_s) < R(0.01) ? R(0.01) : den_s;
  R scrit = (d_hhp - lv * (qti - qs)) / den_s;
  const R alt_s = (qti - qs) + scrit * (q - qti);
  scrit = alt_s < zero ? one : scrit;
  scrit = mx(scrit, zero);

  // the stored sij of (i, j): the diagonal is always 1, cells outside the
  // cloud 0, and j beyond the column 0 (the plain version's padding)
  auto stored = [&](int j) -> R {
    if (!lev || j < 0 || j >= nz) return zero;
    const bool valid = row_ok && j >= icb_s && j <= inb;
    if (!(valid || j == i)) return zero;
    return mn(mx(S[j * kStride + i], zero), one);
  };

  // pass 2: the running SMIN over j, the weights and their sum
  R smin = one, asij = zero;
  {
    R s_jm1 = zero, s_j = stored(0);
    for (int j = 0; j < nz; ++j) {
      const R s_jp1 = stored(j + 1);
      const R dphj = sh(dph, j);
      const bool valid = row_ok && j >= icb_s && j <= inb;
      const bool cond = s_j > zero && s_j < R(0.9) && valid;
      const bool above_i = j > i;
      const R smid_a = mn(s_j, scrit);
      const bool take = cond && above_i && (smid_a < smin) && (s_jp1 < smid_a);
      const R sjmax_a = take ? mn(mn(s_jp1, s_j), scrit) : smid_a;
      const R sjmin_a = take ? mn(mx(s_jm1, s_j), scrit) : smid_a;
      if (take) smin = smid_a;
      const R sjmax_b = mx(s_jp1, scrit);
      const R smid_b = mx(s_j, scrit);
      const R sjmin_b = mx(j > 0 ? s_jm1 : zero, scrit);
      const R smid = above_i ? smid_a : smid_b;
      const R sjmax = above_i ? sjmax_a : sjmax_b;
      const R sjmin = above_i ? sjmin_a : sjmin_b;
      const R w = cond ? ab(sjmax - smid) + ab(sjmin - smid) : zero;
      if (cond) asij = asij + (w * dphj);
      if (lev) W[j * kStride + i] = w;
      s_jm1 = s_j;
      s_j = s_jp1;
    }
  }
  asij = mx(asij, R(1e-21));
  const bool has_ent = nent > 0;
  const bool no_ent = nent == 0 && m_mask;

  // ment of (i, j) before the resort fallback
  auto ment_of = [&](int j, R sij, R w, R dphj, bool valid) -> R {
    const bool ent = valid && sij > zero && sij < R(0.9);
    R me = ent ? m / mx(one - sij, R(1e-10)) : zero;
    if (no_ent && j == i) me = m;
    if (ent && has_ent) me = ((me * w) * dphj) / asij;
    return me;
  };

  // pass 3: bsum of row i
  R bsum = zero;
  for (int j = 0; j < nz; ++j) {
    const R dphj = sh(dph, j);
    if (!lev) continue;
    const bool valid = row_ok && j >= icb_s && j <= inb;
    const R me = ment_of(j, S[j * kStride + i], W[j * kStride + i], dphj, valid);
    if (valid) bsum = bsum + me;
  }
  const bool resort = has_ent && (bsum < R(1e-18)) && m_mask;
  const bool diag_fix = no_ent || resort;

  // pass 4: the final row; its fluxes into level j summed over i
  R Sq = zero, Su = zero, Sv = zero, Saw = zero, Sawg = zero;
  R ment_d = zero, qent_d = q;
  for (int j = 0; j < nz; ++j) {
    const R qj = sh(q, j), uj = sh(u, j), vj = sh(v, j), dphj = sh(dph, j);
    const R epj = sh(ep, j), clwj = sh(clw, j);
    R cq = zero, cu = zero, cv = zero, caw = zero, cawg = zero;
    if (lev) {
      const bool valid = row_ok && j >= icb_s && j <= inb;
      const R sij = S[j * kStride + i];
      const bool ent = valid && sij > zero && sij < R(0.9);
      R me = ment_of(j, sij, W[j * kStride + i], dphj, valid);
      R qent = ent ? (sij * q) + ((one - sij) * qti) : qj;
      R uent = ent ? (sij * u) + ((one - sij) * u_nk) : uj;
      R vent = ent ? (sij * v) + ((one - sij) * v_nk) : vj;
      R elij = ent ? mx(A[j * kStride + i], zero) : zero;
      if (diag_fix && j == i) {
        if (resort) me = m;
        qent = qti;
        uent = u_nk;
        vent = v_nk;
        elij = clw;
      }
      if (j == i) {
        ment_d = me;
        qent_d = qent;
      }
      W[j * kStride + i] = me;
      cq = me * (qent - qj);
      cu = me * (uent - uj);
      cv = me * (vent - vj);
      if (i < j) {
        const R awat = mx(elij - ((one - epj) * clwj), zero);
        caw = me * awat;
        cawg = (R(g) * awat) * me;
      }
    }
    cq = warp_sum(cq);
    cu = warp_sum(cu);
    cv = warp_sum(cv);
    caw = warp_sum(caw);
    cawg = warp_sum(cawg);
    if (k == j) {
      Sq = cq;
      Su = cu;
      Sv = cv;
      Saw = caw;
      Sawg = cawg;
    }
  }
  __syncwarp();

  // amp1 and ad: the flux across the top of level k from below (i <= k <
  // j) and into it from above (j < k <= i), as row sums transposed
  const int inb_p1 = inb + 1 < nz - 1 ? inb + 1 : nz - 1;
  if (lev) {
    R run = zero;
    for (int j = 0; j < nz; ++j) {
      S[j * kStride + i] = run;
      if (i <= inb) run = run + W[j * kStride + i];
    }
    run = zero;
    for (int j = nz - 1; j >= 0; --j) {
      A[j * kStride + i] = run;
      if (j <= inb_p1) run = run + W[j * kStride + i];
    }
  }
  __syncwarp();
  R ad = zero, amp1_s = zero;
  if (lev) {
    for (int r = 0; r < nz; ++r) {
      if (r >= k) ad = ad + S[k * kStride + r];
      if (r <= k) amp1_s = amp1_s + A[k * kStride + r];
    }
  }
  const R m_rev = row_cumsum(lev ? m : zero, k, nz, true);
  const R m_above = sh(m_rev, k + 1 < nz ? k + 1 : 0);
  const R amp1_m = (k >= nk_s && k + 1 < nz) ? m_above : zero;
  const R amp1 = amp1_m + amp1_s;

  // ---- precipitating downdraft, descended by every lane ---------------
  const bool skip_dd = sh(ep, inb) < R(0.0001);
  const R wdtrain_all = (((R(g) * ep) * m) * clw) + Sawg;
  const bool warm = T > R(273.0);
  const R coeff_l = warm ? R(P.coeffr) : R(P.coeffs);
  const R wt_l = warm ? R(P.omtrain) : R(P.omtsnow);
  const R sigt = mn(mx(R(P.sigs), zero), one);
  const R p0 = sh(p, 0);
  R water_n = zero, mp_n = zero, wt_n = R(P.omtsnow);
  R qp_n = sh(q, nz - 1), up_n = sh(u, nz - 1), vp_n = sh(v, nz - 1);
  R jtt_p = (p0 * zero) + one, jtt_mp = zero;
  bool jtt_set = false;
  // this lane's level and the one above it
  R my_water = zero, my_evap = zero, my_mp = zero, my_qp = zero;
  R my_up = zero, my_vp = zero;
  R up_water = zero, up_wt = zero, up_mp = zero, up_qp = zero, up_up = zero;
  R up_vp = zero;
  const bool dd = !skip_dd;           // active here
  for (int ii = nz - 1; ii >= 0; --ii) {
    const bool in_dd = ii <= inb && dd;
    const R wt_i = sh(wt_l, ii), coeff_i = sh(coeff_l, ii);
    const R q_i = sh(q, ii), qs_i = sh(qs, ii), ph_i = sh(ph, ii);
    const R dph_i = sh(dph, ii), wda_i = sh(wdtrain_all, ii);
    const int im1 = ii > 0 ? ii - 1 : 0;
    const int ip1 = ii + 1 < nz - 1 ? ii + 1 : nz - 1;
    const R h_i = sh(h, ii), h_m = sh(h, im1), p_i = sh(p, ii);
    const R p_m = sh(p, im1), lv_i = sh(lv, ii), dph_m = sh(dph, im1);
    const R gz_i = sh(gz, ii), gz_p = sh(gz, ip1), lv_p = sh(lv, ip1);
    const R T_i = sh(T, ii), T_p = sh(T, ip1);
    const R u_i = sh(u, ii), v_i = sh(v, ii);
    const R q_m = sh(q, im1), u_m = sh(u, im1), v_m = sh(v, im1);
    const R qstm = sh(qs, im1);

    const R qsm = R(0.5) * (q_i + qp_n);
    const R afac = mx(((coeff_i * ph_i) * (qs_i - qsm))
                      / (((ph_i * R(2.0e3)) * qs_i) + R(1.0e4)), zero);
    const R b6 = (((R(100.0) * dph_i) * sigt) * afac) / wt_i;
    const R c6 = ((water_n * wt_n) + wda_i * (one / R(sigd))) / wt_i;
    const R revap = R(0.5) * ((-b6) + sq(mx((b6 * b6) + c6 * R(4.0), zero)));
    const R evap_i = in_dd ? (sigt * afac) * revap : zero;
    const R water_i = in_dd ? revap * revap : zero;
    R mp_i = zero;
    if (ii > 0) {
      const R dhdp = mx((h_i - h_m) / mx(p_m - p_i, R(1e-10)), R(10.0));
      mp_i = mx((((R(100.0 * ginv) * lv_i) * R(sigd)) * evap_i) / dhdp, zero);
      const R fac = (one / mx(dph_m, R(1e-10))) * R(20.0);
      mp_i = ((fac * mp_n) + mp_i) / (fac + one);
      const bool near_sfc = p_i > (p0 * R(0.949));
      const bool newly = near_sfc && !jtt_set && in_dd;
      if (newly) {
        jtt_p = p_i;
        jtt_mp = mp_i;
      }
      jtt_set = jtt_set || newly;
      if (near_sfc && jtt_set)
        mp_i = (jtt_mp * (p0 - p_i)) / mx(p0 - jtt_p, R(1e-10));
      if (!in_dd) mp_i = zero;
    }
    const bool grow = mp_i > mp_n;
    const R rat = mp_n / mx(mp_i, R(1e-30));
    const R qp_grow = ((qp_n * rat) + (q_i * (one - rat)))
                      + ((R(100.0 * ginv * sigd) * dph_i) * (evap_i / mx(mp_i, R(1e-30))));
    const R up_grow = (up_n * rat) + (u_i * (one - rat));
    const R vp_grow = (vp_n * rat) + (v_i * (one - rat));
    const R qp_desc = (((gz_p - gz_i) + (qp_n * (lv_p + (T_p * R(cl - cpd)))))
                       + (R(cpd) * (T_p - T_i))) / (lv_i + (T_i * R(cl - cpd)));
    const bool has_mp_up = mp_n > zero;
    R qp_i = grow ? qp_grow : (has_mp_up ? qp_desc : q_m);
    const R up_i = grow ? up_grow : (has_mp_up ? up_n : u_m);
    const R vp_i = grow ? vp_grow : (has_mp_up ? vp_n : v_m);
    qp_i = mn(mx(qp_i, zero), qstm);
    const bool upd = in_dd && inb != ii;
    const R qp_new = upd ? qp_i : q_m;
    const R up_new = upd ? up_i : u_m;
    const R vp_new = upd ? vp_i : v_m;
    if (k == ii) {
      my_water = water_i;
      my_evap = evap_i;
      my_mp = mp_i;
      my_qp = qp_new;
      my_up = up_new;
      my_vp = vp_new;
      up_water = water_n;
      up_wt = wt_n;
      up_mp = mp_n;
      up_qp = qp_n;
      up_up = up_n;
      up_vp = vp_n;
    }
    water_n = water_i;
    wt_n = wt_i;
    mp_n = mp_i;
    qp_n = qp_new;
    up_n = up_new;
    vp_n = vp_new;
  }

  // ---- column outputs -------------------------------------------------
  const R wt0 = sh(wt_l, 0), water0 = sh(my_water, 0);
  const R precip = dd ? ((((wt0 * R(sigd)) * water0) * R(3600.0)) * R(24000.0))
                            * (one / R(P.rowl * g))
                      : zero;
  const R mp_icb = sh(my_mp, icb_s), T_icb = sh(T, icb_s);
  const R wd = ((((R(P.beta) * ab(mp_icb)) * R(0.01)) * R(rd)) * T_icb)
               / (p_icb * R(sigd));
  const R qprime = R(0.5) * (sh(my_qp, 0) - sh(q, 0));
  const R tprime = (R(lv0) * qprime) * inv_cpd;

  // ---- tendencies -----------------------------------------------------
  const double delti = 1.0 / P.dt;
  const R dpinv0 = (one / sh(dph, 0)) * R(0.01);
  R am = warp_sum((lev && k >= 1 && k <= inb) ? m : zero);
  if (nk_s != 0) am = zero;
  const bool cfl1 = ((R(2.0 * g) * dpinv0) * am) >= R(delti);
  const R T1 = sh(T, 1), gz0 = sh(gz, 0), gz1 = sh(gz, 1);
  const R cpn0 = sh(cpn, 0), lvcp0 = sh(lvcp, 0), evap0 = sh(my_evap, 0);
  const R wt1 = sh(up_wt, 0), water1 = sh(up_water, 0), mp1 = sh(up_mp, 0);
  const R qp1 = sh(up_qp, 0), up1 = sh(up_up, 0), vp1 = sh(up_vp, 0);
  const R q0 = sh(q, 0), q1 = sh(q, 1), u0 = sh(u, 0), u1 = sh(u, 1);
  const R v0 = sh(v, 0), v1 = sh(v, 1);
  const R gd0 = R(g) * dpinv0;
  R ft0 = ((((gd0 * am) * ((T1 - T0) + ((gz1 - gz0) / cpn0)))
            - ((lvcp0 * R(sigd)) * evap0))
           + ((((((R(sigd) * wt1) * R(cl - cpd)) * water1) * (T1 - T0)) * dpinv0) / cpn0));
  R fq0 = ((((R(g) * mp1) * (qp1 - q0)) * dpinv0) + (R(sigd) * evap0))
          + (((R(g) * am) * (q1 - q0)) * dpinv0);
  R fu0 = gd0 * ((mp1 * (up1 - u0)) + (am * (u1 - u0)));
  R fv0 = gd0 * ((mp1 * (vp1 - v0)) + (am * (v1 - v0)));
  // level 0 is below every cloud base, so its entrained fluxes are sums of
  // zeros; kept for the plain version's arithmetic
  fq0 = fq0 + (gd0 * sh(Sq, 0));
  fu0 = fu0 + (gd0 * sh(Su, 0));
  fv0 = fv0 + (gd0 * sh(Sv, 0));

  const R dpinv = (one / dph) * R(0.01);
  const R cpinv = one / cpn;
  const int kup = k + 1 < nz - 1 ? k + 1 : nz - 1;
  const R T_up = sh(T, kup), T_dn = sh(T, kdn), q_up = sh(q, kup);
  const R q_dn = sh(q, kdn), u_up = sh(u, kup), u_dn = sh(u, kdn);
  const R v_up = sh(v, kup), v_dn = sh(v, kdn), gz_up = sh(gz, kup);
  const R gz_dn = sh(gz, kdn);
  const R gd = R(g) * dpinv;
  R ft = (((gd * ((amp1 * ((T_up - T) + ((gz_up - gz) * cpinv)))
                  - (ad * ((T - T_dn) + ((gz - gz_dn) * cpinv)))))
           - ((R(sigd) * lvcp) * my_evap))
          + (((gd * ment_d) * ((hp - h) + ((T * R(cpv - cpd)) * (q - qent_d)))) * cpinv))
         + ((((((R(sigd) * up_wt) * R(cl - cpd)) * up_water) * (T_up - T)) * dpinv) * cpinv);
  R fq = gd * ((amp1 * (q_up - q)) - (ad * (q - q_dn)));
  R fu = gd * ((amp1 * (u_up - u)) - (ad * (u - u_dn)));
  R fv = gd * ((amp1 * (v_up - v)) - (ad * (v - v_dn)));
  fq = fq + (gd * (Sq - Saw));
  fu = fu + (gd * Su);
  fv = fv + (gd * Sv);
  fq = (fq + (R(sigd) * my_evap)) + (gd * ((up_mp * (up_qp - q)) - (my_mp * (my_qp - q_dn))));
  fu = fu + (gd * ((up_mp * (up_up - u)) - (my_mp * (my_up - u_dn))));
  fv = fv + (gd * ((up_mp * (up_vp - v)) - (my_mp * (my_vp - v_dn))));
  const bool cfl = ((R(2.0 * g) * dpinv) * amp1) >= R(delti);
  if (k == 0) {
    ft = ft0;
    fq = fq0;
    fu = fu0;
    fv = fv0;
  }
  const bool lev_mask = k <= inb;
  if (!lev_mask) {
    ft = zero;
    fq = zero;
    fu = zero;
    fv = zero;
  }

  // ---- spread the tendencies at the top of convection by frac ---------
  const int inbm1 = inb - 1 > 0 ? inb - 1 : 0;
  const R ratio = sh(dph, inb) / mx(sh(dph, inbm1), R(1e-10));
  const R oh = k == inb ? one : zero;
  const R ohm1 = k == inb - 1 ? one : zero;
  const R keep = one - frac * oh;
  const R shq = ((frac * sh(fq, inb)) * ratio) * (sh(lv, inb) / sh(lv, inbm1));
  const R sht = ((frac * sh(ft, inb)) * ratio) * (sh(cpn, inb) / sh(cpn, inbm1));
  const R shu = ((frac * sh(fu, inb)) * ratio) * one;
  const R shv = ((frac * sh(fv, inb)) * ratio) * one;
  fq = fq * keep + shq * ohm1;
  ft = ft * keep + sht * ohm1;
  fu = fu * keep + shu * ohm1;
  fv = fv * keep + shv * ohm1;

  // ---- exact enthalpy and momentum conservation -----------------------
  const R cm = lev_mask ? one : zero;
  const R norm = one / mx(sh(ph, 0) - sh(ph, inb + 1), R(1e-10));
  const R ents = warp_sum(lev ? (((cpn * ft) + (lv * fq)) * dph) * cm : zero) * norm;
  const R uav = warp_sum(lev ? (fu * dph) * cm : zero) * norm;
  const R vav = warp_sum(lev ? (fv * dph) * cm : zero) * norm;
  ft = ft - ((cm * ents) / cpn);
  fu = ((R(1.0 - P.cu) * (fu - uav)) * cm) + (fu * (one - cm));
  fv = ((R(1.0 - P.cu) * (fv - vav)) * cm) + (fv * (one - cm));

  const bool any_cfl = __any_sync(kAll, lev && lev_mask && cfl) || cfl1;
  if (lev) {
    const long long o = c * a.osc + k * a.osk;
    a.ft[o] = ft;
    a.fq[o] = fq;
    a.fu[o] = fu;
    a.fv[o] = fv;
  }
  if (k == 0) {
    a.precip[c] = precip;
    a.wd[c] = dd ? wd : zero;
    a.tprime[c] = dd ? tprime : zero;
    a.qprime[c] = dd ? qprime : zero;
    a.cape[c] = cape;
    a.iflag[c] = any_cfl ? 4 : 1;
  }
}

template <typename R>
int launch(const long long* t, const double* prm, int ncol, int nz, int nl,
           int minorig, void* stream) {
  Args<R> a;
  Level<R>* lv[7] = {&a.T, &a.q, &a.qs, &a.u, &a.v, &a.p, &a.ph};
  for (int n = 0; n < 7; ++n) {
    lv[n]->p = reinterpret_cast<const R*>(t[3 * n]);
    lv[n]->sc = t[3 * n + 1];
    lv[n]->sk = t[3 * n + 2];
  }
  a.cbmf_in = reinterpret_cast<const R*>(t[21]);
  a.cbmf_s = t[22];
  a.ft = reinterpret_cast<R*>(t[23]);
  a.fq = reinterpret_cast<R*>(t[24]);
  a.fu = reinterpret_cast<R*>(t[25]);
  a.fv = reinterpret_cast<R*>(t[26]);
  a.osc = t[27];
  a.osk = t[28];
  a.precip = reinterpret_cast<R*>(t[29]);
  a.wd = reinterpret_cast<R*>(t[30]);
  a.tprime = reinterpret_cast<R*>(t[31]);
  a.qprime = reinterpret_cast<R*>(t[32]);
  a.cbmf = reinterpret_cast<R*>(t[33]);
  a.cape = reinterpret_cast<R*>(t[34]);
  a.iflag = reinterpret_cast<long long*>(t[35]);
  a.ncol = ncol;
  a.nz = nz;
  a.nl = nl;
  a.minorig = minorig;
  Params P;
  std::memcpy(&P, prm, sizeof(Params));
  if (nz < 4 || nz > kMaxNz || nl < 1 || nl > nz - 1) return -1;
  const size_t bytes = sizeof(R) * kWarps * 3 * nz * kStride;
  const cudaError_t e = cudaFuncSetAttribute(
      emanuel_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (ncol + kWarps - 1) / kWarps;
  emanuel_kernel<R><<<blocks, kWarps * 32, bytes,
                      static_cast<cudaStream_t>(stream)>>>(a, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// t: T, q, qs, u, v, p, ph as (pointer, column stride, level stride); cbmf
// (pointer, stride); ft, fq, fu, fv pointers and their shared (column,
// level) strides; precip, wd, tprime, qprime, cbmf, cape (contiguous) and
// iflag (int64) pointers.  prm: the 24 doubles of Params.
extern "C" int climt_emanuel_f32(const long long* t, const double* prm,
                                 int ncol, int nz, int nl, int minorig,
                                 void* stream) {
  return launch<float>(t, prm, ncol, nz, nl, minorig, stream);
}

extern "C" int climt_emanuel_f64(const long long* t, const double* prm,
                                 int ncol, int nz, int nl, int minorig,
                                 void* stream) {
  return launch<double>(t, prm, ncol, nz, nl, minorig, stream);
}
