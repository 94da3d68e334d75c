// The taumol term writer: one launch writes the int32 row index and the
// weight of every term of one taumol call's kernel-B groups (LW taug and
// Planck fractions, or SW taug, Rayleigh depth and solar source), which
// csrc/mix_rows.cu then sums.
//
// It replaces no TPU kernel: the JAX package writes these terms with XLA,
// which fuses their elementwise arithmetic (climt_tpu/components/rrtmg/
// lw_spectral.py:396, sw_spectral.py:247); in PyTorch's elementwise
// operations, each dispatched alone, they take about 1,900 launches an LW
// call and 1,500 an SW call.
//
// What to write comes from a term plan (components/rrtmg/term_writer.py):
// a list of entries, each one step of the walk over the band table, with
// the ids of the (nz, ncol) fields it reads, its int parameters and its
// constants.  Entries of the cell groups run in one
// thread per cell, those of the solar source (one cell per column) in one
// thread per column, whose blocks come first in the grid: their loops over
// the levels take longest.
//
// Bound: bytes.  Each term's weight (4 or 8 bytes) and, for a table of more
// than one row, its index (4 bytes) are stored once per cell, coalesced
// along cells; each field is read from device memory once (the entries
// read it again from L1/L2).  The arithmetic is the plain version's
// (term_writer.taumol_terms_plain), operation by operation and in its
// order; this file is built with -fmad=false (_build.SOURCE_FLAGS) so that
// no product and sum fuse, and divides where PyTorch on the CPU divides.  The float32 power of the
// adjusted minor-gas columns is the float64 pow of its arguments, rounded.
#include <cuda_runtime.h>
#include <math.h>

namespace {

// entry kinds: keep in step with term_writer.py's KIND
enum Kind : int {
  kLwBand = 1, kLwKey = 2, kLwSelf = 3, kLwFor = 4, kLwMinor = 5, kLwWx = 6,
  kFracRow = 7, kFracLin = 8, kSwKey = 9, kSwSelf = 10, kSwFor = 11,
  kRowCol = 12, kRowO2 = 13, kLinEta = 14, kSolLayer = 15, kSolRow = 16,
  kSolLin = 17,
};

// ints per entry: kind, group, first term, 12 parameters, first constant
constexpr int kRecord = 16;
constexpr int kMaxFloat = 48, kMaxInt = 12, kGroups = 3, kMaxFactor = 48;
constexpr int kThreads = 128;
// weight masks (term_writer.py NO_MASK, TROP, UPPER)
constexpr int kTrop = 1, kUpper = 2;

template <typename T>
struct Params {
  const T* f[kMaxFloat];        // float fields, (nz, ncol) with row strides
  long long fs[kMaxFloat];
  const int* i[kMaxInt];        // int32 fields
  long long is[kMaxInt];
  const unsigned char* trop;    // bool
  long long trop_s;
  const T* chi;                 // setcoef's chi_mls (rows, levels)
  long long chi_s;
  int* idx[kGroups];            // each group's (terms, cells) pair
  T* w[kGroups];
  double factor[kMaxFactor];    // the solar source's factors by slot
  const int* rec;               // cell entries, then column entries
  const T* consts;
  int ncell_rec, ncol_rec, nz, ncol;
};

template <typename T>
__device__ __forceinline__ T power(T x, T e);

template <>
__device__ __forceinline__ float power<float>(float x, float e) {
  return static_cast<float>(pow(static_cast<double>(x),
                                static_cast<double>(e)));
}

template <>
__device__ __forceinline__ double power<double>(double x, double e) {
  return pow(x, e);
}

// _eta: specmult = n * clamp(specparm, max=ONEMINUS); (trunc, remainder)
template <typename T>
__device__ __forceinline__ void eta(T parm, T n, int& js, T& fs) {
  const T one_minus = static_cast<T>(1.0 - 1.0e-6);
  const T m = n * (parm > one_minus ? one_minus : parm);
  js = static_cast<int>(m);
  fs = m - static_cast<T>(js);
}

template <typename T>
struct Out {
  const Params<T>& P;
  long long n, s;     // cells of the group, this cell
  __device__ __forceinline__ void put(int g, int t, int ix, T wt) const {
    P.idx[g][t * n + s] = ix;
    P.w[g][t * n + s] = wt;
  }
  __device__ __forceinline__ void put_w(int g, int t, T wt) const {
    P.w[g][t * n + s] = wt;
  }
  // Group.lin: weight * (1 - frac) on ix, weight * frac on ix + 1
  __device__ __forceinline__ void lin(int g, int t, int ix, T frac,
                                      T weight) const {
    put(g, t, ix, (T(1) - frac) * weight);
    put(g, t + 1, ix + 1, frac * weight);
  }
  __device__ __forceinline__ void lin(int g, int t, int ix, T frac) const {
    put(g, t, ix, T(1) - frac);
    put(g, t + 1, ix + 1, frac);
  }
};

template <typename T>
__device__ void cell_terms(const Params<T>& P, long long s) {
  const long long k = s / P.ncol, c = s - k * P.ncol;
  const Out<T> out{P, static_cast<long long>(P.nz) * P.ncol, s};
  auto F = [&](int id) { return __ldg(P.f[id] + k * P.fs[id] + c); };
  auto I = [&](int id) { return __ldg(P.i[id] + k * P.is[id] + c); };
  const bool trop = P.trop[k * P.trop_s + c] != 0;
  const T trop_f = trop ? T(1) : T(0);
  const T upper_f = T(1) - trop_f;
  const int jp = I(0), jp0 = I(1), jt0 = I(2), jt10 = I(3);
  // [side][nsp_off]: fac00, fac10; fac01, fac11
  const T fac[2][2] = {{F(0), F(1)}, {F(2), F(3)}};
  bool has_corr = false;
  T corr = T(1);
  auto scaled = [&](T x) { return has_corr ? x * corr : x; };
  auto masked = [&](T x, int mask) {
    return mask == kTrop ? (trop ? x : T(0))
                         : mask == kUpper ? (trop ? T(0) : x) : x;
  };
  auto times_mask = [&](T x, int mask) {
    return mask == kTrop ? x * trop_f : mask == kUpper ? x * upper_f : x;
  };

  for (int r = 0; r < P.ncell_rec; ++r) {
    const int* q = P.rec + r * kRecord;
    const int kind = __ldg(q), g = __ldg(q + 1), t = __ldg(q + 2);
    int p[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) p[j] = __ldg(q + 3 + j);
    const T* cst = P.consts + __ldg(q + 15);
    switch (kind) {
      case kLwBand: {
        // taugb1/taugb2's pressure correction, folded into the weights
        has_corr = p[0] != 0;
        if (p[0] == 1) {
          const T pavel = F(p[1]);
          const T lo = pavel < T(250.0)
                           ? T(1) - T(0.15) * (T(250.0) - pavel) / T(154.4)
                           : T(1);
          corr = trop ? lo : T(1) - T(0.15) * (pavel / T(95.6));
        } else if (p[0] == 2) {
          const T pavel = F(p[1]);
          corr = trop ? T(1) - T(0.05) * (pavel - T(100.0)) / T(900.0)
                      : T(1);
        }
        break;
      }
      case kLwKey:
      case kSwKey: {
        const bool lw = kind == kLwKey;
        const int nspa = p[0], nspb = p[1], rows_a = p[2];
        // per side (lower, upper): speccomb at jp and jp+1, its eta index
        // and fraction, and whether the side exists and has eta
        T sc[2][2] = {{0, 0}, {0, 0}}, fs[2][2] = {{0, 0}, {0, 0}};
        int js[2][2] = {{0, 0}, {0, 0}};
        bool have[2], has_eta[2];
        for (int side = 0; side < 2; ++side) {
          const int c1 = lw ? p[3 + 4 * side] : p[3 + 2 * side];
          const int c2 = lw ? p[4 + 4 * side] : p[4 + 2 * side];
          const T n_eta = side == 0 ? T(8) : T(4);
          have[side] = c1 >= 0;
          has_eta[side] = have[side] && c2 >= 0;
          if (!have[side]) continue;
          const T x1 = F(c1);
          if (!has_eta[side]) {
            sc[side][0] = sc[side][1] = x1;
          } else if (lw) {
            const T x2 = F(c2);
            sc[side][0] = x1 + F(p[5 + 4 * side]) * x2;
            sc[side][1] = x1 + F(p[6 + 4 * side]) * x2;
            eta(x1 / sc[side][0], n_eta, js[side][0], fs[side][0]);
            eta(x1 / sc[side][1], n_eta, js[side][1], fs[side][1]);
          } else {
            sc[side][0] = sc[side][1] = x1 + cst[side] * F(c2);
            eta(x1 / sc[side][0], n_eta, js[side][0], fs[side][0]);
            js[side][1] = js[side][0];
            fs[side][1] = fs[side][0];
          }
          if (!lw && side == 1 && p[7]) {
            sc[1][0] = sc[1][1] = sc[1][0] * cst[2];
          }
        }
        T scale[2];
        for (int i0 = 0; i0 < 2; ++i0) {
          T x;
          if (have[0] && have[1]) {
            x = trop ? sc[0][i0] : sc[1][i0];
          } else if (have[0]) {
            x = trop ? sc[0][i0] : T(0);
          } else {
            x = trop ? T(0) : sc[1][i0];
          }
          if (!lw && p[8]) x = trop ? x * cst[3] : x;
          scale[i0] = lw ? scaled(x) : x;
        }
        const int base[2][2] = {
            {(jp0 * 5 + jt0) * nspa + js[0][0],
             ((jp0 + 1) * 5 + jt10) * nspa + js[0][1]},
            {((jp - 13) * 5 + jt0) * nspb + js[1][0],
             ((jp - 12) * 5 + jt10) * nspb + js[1][1]}};
        const int nsp[2] = {nspa, nspb};
        int tt = t;
        for (int i0 = 0; i0 < 2; ++i0) {
          for (int off = 0; off < 2; ++off) {
            const T fc = fac[i0][off];
            for (int e = 0; e < 2; ++e) {
              if (e && nspa != 9 && nspb != 5) continue;
              int ix[2];
              T wt[2];
              for (int side = 0; side < 2; ++side) {
                const T fse = has_eta[side] ? fs[side][i0] : T(0);
                wt[side] = fc * (e ? fse : T(1) - fse);
                ix[side] = base[side][i0] +
                           (off * nsp[side] + (lw && !has_eta[side] ? 0 : e));
              }
              int i;
              T wgt;
              if (have[0] && have[1]) {
                i = trop ? ix[0] : rows_a + ix[1];
                wgt = trop ? wt[0] : wt[1];
              } else if (have[0]) {
                i = ix[0];
                wgt = trop ? wt[0] : T(0);
              } else {
                i = ix[1];
                wgt = trop ? T(0) : wt[1];
              }
              out.put(g, tt++, i, wgt * scale[i0]);
            }
          }
        }
        break;
      }
      case kLwSelf:
        out.lin(g, t, I(p[0]), F(p[1]), scaled(trop ? F(p[2]) : T(0)));
        break;
      case kLwFor:
        out.lin(g, t, I(p[0]), F(p[1]), scaled(times_mask(F(p[2]), p[3])));
        break;
      case kLwMinor: {
        const T col = F(p[3]);
        T amount;
        if (p[2] == 0) {
          amount = col * F(p[4]);
        } else {
          // _adjusted_column: adjn2o / adjco2 (thresh, base, expo)
          const T coldry = F(p[6]);
          const T chi_ref = P.chi[p[7] * P.chi_s + jp0 + 1];
          const T rat = col / (T(1.0e-20) * coldry) / chi_ref;
          const T d = rat - cst[1];
          const T adjfac = cst[1] + power(d < T(1e-30) ? T(1e-30) : d,
                                          cst[2]);
          const T adj = adjfac * chi_ref * coldry * T(1.0e-20);
          amount = rat > cst[0] ? adj : col;
        }
        out.lin(g, t, I(p[0]), F(p[1]), scaled(masked(amount, p[5])));
        break;
      }
      case kLwWx:
        out.put_w(g, t, scaled(masked(F(p[0]), p[1])));
        break;
      case kFracRow:
        out.put_w(g, t, p[0] == kTrop ? trop_f
                        : p[0] == kUpper ? upper_f : T(1));
        break;
      case kFracLin: {
        const T x1 = F(p[0]);
        const T comb = x1 + cst[0] * F(p[1]);
        int js;
        T fs;
        eta(x1 / comb, static_cast<T>(p[2]), js, fs);
        if (p[3] == kTrop || p[3] == kUpper) {
          out.lin(g, t, js, fs, p[3] == kTrop ? trop_f : upper_f);
        } else {
          out.lin(g, t, js, fs);
        }
        break;
      }
      case kSwSelf:
        out.lin(g, t, I(p[0]), F(p[1]), (trop ? F(p[2]) : T(0)) * F(p[3]));
        break;
      case kSwFor:
        out.lin(g, t, I(p[0]), F(p[1]), times_mask(F(p[2]) * F(p[3]), p[4]));
        break;
      case kRowCol:
        out.put_w(g, t, times_mask(F(p[0]), p[1]));
        break;
      case kRowO2:
        out.put_w(g, t, T(4.35e-4) * F(p[0]) / T(700.0));
        break;
      case kLinEta: {
        const T x1 = F(p[0]);
        int js;
        T fs;
        eta(x1 / (x1 + cst[0] * F(p[1])), static_cast<T>(p[4]), js, fs);
        out.lin(g, t, js, fs, times_mask(F(p[2]), p[3]));
        break;
      }
      default:
        break;
    }
  }
}

// The solar source of one column: each band's reference layer (the
// crossing of jp and layreffr below or above the tropopause), the eta
// index and fraction of its key species there, and its terms.
template <typename T>
__device__ void column_terms(const Params<T>& P, long long c) {
  const Out<T> out{P, static_cast<long long>(P.ncol), c};
  auto trop = [&](int k) { return P.trop[k * P.trop_s + c] != 0; };
  auto jp = [&](int k) { return __ldg(P.i[0] + k * P.is[0] + c); };
  int js = 0;
  T fs = T(0);
  const int* col_rec = P.rec + P.ncell_rec * kRecord;
  for (int r = 0; r < P.ncol_rec; ++r) {
    const int* q = col_rec + r * kRecord;
    const int kind = __ldg(q), g = __ldg(q + 1), t = __ldg(q + 2);
    const T* cst = P.consts + __ldg(q + 15);
    switch (kind) {
      case kSolLayer: {
        const int upper = __ldg(q + 3), layreffr = __ldg(q + 4);
        int last = -1, lay;
        if (!upper) {
          int ntrop = 0;
          for (int k = 0; k < P.nz; ++k) ntrop += trop(k) ? 1 : 0;
          const int ltrop = ntrop > 1 ? ntrop - 1 : 0;
          for (int k = 0; k + 1 < P.nz; ++k) {
            if (trop(k) && jp(k) < layreffr && jp(k + 1) >= layreffr) {
              last = k;
            }
          }
          lay = (last >= 0 ? last : ltrop) + 1;
          lay = lay < ltrop ? lay : ltrop;
        } else {
          for (int k = 1; k < P.nz; ++k) {
            if (!trop(k) && jp(k) >= layreffr && jp(k - 1) < layreffr) {
              last = k;
            }
          }
          lay = last >= 0 ? last : P.nz - 1;
        }
        if (__ldg(q + 5)) {
          const int c1 = __ldg(q + 6), c2 = __ldg(q + 7);
          const T x1 = __ldg(P.f[c1] + lay * P.fs[c1] + c);
          const T x2 = __ldg(P.f[c2] + lay * P.fs[c2] + c);
          eta(x1 / (x1 + cst[0] * x2), static_cast<T>(__ldg(q + 8)), js, fs);
        }
        break;
      }
      case kSolRow:
        out.put_w(g, t, static_cast<T>(P.factor[__ldg(q + 3)]));
        break;
      case kSolLin:
        out.lin(g, t, js, fs, static_cast<T>(P.factor[__ldg(q + 3)]));
        break;
      default:
        break;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    taumol_terms_kernel(const __grid_constant__ Params<T> P,
                        long long col_blocks) {
  if (blockIdx.x < col_blocks) {
    const long long c = blockIdx.x * static_cast<long long>(kThreads) +
                        threadIdx.x;
    if (c < P.ncol) column_terms(P, c);
  } else {
    const long long s = (blockIdx.x - col_blocks) *
                            static_cast<long long>(kThreads) + threadIdx.x;
    if (s < static_cast<long long>(P.nz) * P.ncol) cell_terms(P, s);
  }
}

template <typename T>
int launch(const long long* a, const double* factors, void* stream) {
  Params<T> P = {};
  P.nz = static_cast<int>(a[0]);
  P.ncol = static_cast<int>(a[1]);
  const int nf = static_cast<int>(a[2]), ni = static_cast<int>(a[3]);
  P.ncell_rec = static_cast<int>(a[4]);
  P.ncol_rec = static_cast<int>(a[5]);
  P.rec = reinterpret_cast<const int*>(a[6]);
  P.consts = reinterpret_cast<const T*>(a[7]);
  P.trop = reinterpret_cast<const unsigned char*>(a[8]);
  P.trop_s = a[9];
  P.chi = reinterpret_cast<const T*>(a[10]);
  P.chi_s = a[11];
  for (int g = 0; g < kGroups; ++g) {
    P.idx[g] = reinterpret_cast<int*>(a[12 + g]);
    P.w[g] = reinterpret_cast<T*>(a[15 + g]);
  }
  const int nfactor = static_cast<int>(a[18]);
  if (nf < 4 || nf > kMaxFloat || ni < 4 || ni > kMaxInt || nfactor < 0 ||
      nfactor > kMaxFactor) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long* fa = a + 19;
  for (int j = 0; j < nf; ++j) {
    P.f[j] = reinterpret_cast<const T*>(fa[2 * j]);
    P.fs[j] = fa[2 * j + 1];
  }
  const long long* ia = fa + 2 * nf;
  for (int j = 0; j < ni; ++j) {
    P.i[j] = reinterpret_cast<const int*>(ia[2 * j]);
    P.is[j] = ia[2 * j + 1];
  }
  for (int j = 0; j < nfactor; ++j) P.factor[j] = factors[j];
  const long long ncell = static_cast<long long>(P.nz) * P.ncol;
  const long long cell_blocks = (ncell + kThreads - 1) / kThreads;
  const long long col_blocks =
      P.ncol_rec > 0 ? (P.ncol + kThreads - 1) / kThreads : 0;
  if (cell_blocks + col_blocks == 0) return 0;
  taumol_terms_kernel<T>
      <<<static_cast<unsigned>(cell_blocks + col_blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(P, col_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// args: nz, ncol, float fields, int fields, cell entries, column entries,
// entries, constants, trop, its row stride, chi, its row stride, three
// index and three weight pointers, solar factors, then (pointer, row
// stride) of each float field and of each int field; factors: the solar
// factors.  Returns the CUDA error.
extern "C" int climt_taumol_terms_f32(const long long* args,
                                      const double* factors, void* stream) {
  return launch<float>(args, factors, stream);
}

extern "C" int climt_taumol_terms_f64(const long long* args,
                                      const double* factors, void* stream) {
  return launch<double>(args, factors, stream);
}
