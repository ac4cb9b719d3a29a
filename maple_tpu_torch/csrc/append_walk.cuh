// The appendProbNode merge walk and its per-pair factor, shared by the CUDA
// pair kernel (append_pairs.cu) and by a host loop (append_walk_host.cpp)
// that the CPU tests call.  Under nvcc every function is __host__
// __device__; under g++ it is a plain inline function.
//
// A genome list in the operand layout (maple_tpu_torch/ops/layout.py) is a
// row of B entries of 16 fields.  Its entries are sorted: ends never
// decrease and an entry starts where the one before it ends, so the entry
// pairs of a (candidate, query) that overlap are the steps of a two-pointer
// merge, at most nP + nC - 1 of them, and never the B1 x B2 grid.
//
// The compact form of a row, made once a call by pack_entry():
//   count     entries up to and including the last one that is no PAD;
//   walk word one uint32 an entry, (end << 3) | type: all the walk needs;
//   record    kRec values of the working type T an entry, read only for
//             the pairs that contribute (three 16-byte loads at float):
//             [0..3]  val, bl, bl1, rate     bl: the length the entry adds
//             [4..7]  has2, flag, eps, 0         to the pair's branch
//             [8..11] the four O-entry likelihoods
//
// Numerics mirror _kernel_common (maple_tpu/ops/pallas_append.py) term for
// term, in its case order: the literals 0.33333, 0.25 and 0.02 are cast to
// T, and fac <= 0 (or NaN) gives -inf.  log(max(fac, T(1e-300))) keeps the
// reference's clamp: T(1e-300) is 0 in float, where the fac > 0 test alone
// guards the log.

#pragma once

#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MAPLE_HD __host__ __device__ __forceinline__
#define MAPLE_UNROLL _Pragma("unroll")
#else
#define MAPLE_HD inline
#define MAPLE_UNROLL
#endif

// walk_score() is called by all 32 lanes of a warp together on the card:
// the lanes walk apart and meet again to evaluate their factors.
#ifdef __CUDA_ARCH__
#define MAPLE_WARP_ANY(p) __any_sync(0xffffffffu, (p))
#define MAPLE_WARP_SYNC() __syncwarp()
#else
#define MAPLE_WARP_ANY(p) (p)
#define MAPLE_WARP_SYNC()
#endif

namespace maple_walk {

constexpr int kF = 16;  // fields an entry in the operand layout
constexpr int F_TYPE = 0, F_VAL = 1, F_BL1 = 2, F_BL2 = 3, F_HAS1 = 4,
              F_HAS2 = 5, F_FLAG = 6, F_P0 = 7, F_END = 11, F_RATE = 13,
              F_EPS = 14;
constexpr int TYPE_R = 4, TYPE_N = 5, TYPE_O = 6, TYPE_PAD = 7;
constexpr int kRec = 12;                       // values a record
constexpr int R_VAL = 0, R_BL = 1, R_BL1 = 2, R_RATE = 3, R_HAS2 = 4,
              R_FLAG = 5, R_EPS = 6, R_P0 = 8;
constexpr int kTypeBits = 3;
constexpr int kMaxEnd = (1 << (32 - kTypeBits)) - 1;

// x rounded to an int in [lo, hi]; NaN gives lo.  Types and positions are
// exact small integers in the working float type; whatever else a row
// holds is brought into range so that the walk stays inside its row.
template <typename T>
MAPLE_HD int to_int_clamped(T x, int lo, int hi) {
  if (!(x > T(lo))) return lo;
  if (x >= T(hi)) return hi;
  return static_cast<int>(x + T(0.5));
}

template <typename T>
MAPLE_HD int entry_type(T type_field) {
  return to_int_clamped(type_field, 0, TYPE_PAD);
}

MAPLE_HD uint32_t make_word(int type, int end) {
  return (static_cast<uint32_t>(end) << kTypeBits) |
         static_cast<uint32_t>(type);
}
MAPLE_HD int word_end(uint32_t w) { return static_cast<int>(w >> kTypeBits); }
MAPLE_HD int word_type(uint32_t w) {
  return static_cast<int>(w & ((1u << kTypeBits) - 1u));
}

// One entry of a row into its walk word (returned) and its record.  Field
// q of the entry is e[q * fs]: fs = B1 for a candidate row [16, B1] and 1
// for a query row [B2, 16].  A candidate adds its second length where it
// has one (its root-side half is then evolved apart), an O entry and a
// query entry their first.
template <typename T>
MAPLE_HD uint32_t pack_entry(const T* e, size_t fs, bool is_query,
                             T (&rec)[kRec]) {
  const int type = entry_type(e[F_TYPE * fs]);
  const bool has1 = e[F_HAS1 * fs] > T(0.5);
  const bool has2 = e[F_HAS2 * fs] > T(0.5);
  const T bl1 = e[F_BL1 * fs];
  const T first = has1 ? bl1 : T(0);
  rec[R_VAL] = e[F_VAL * fs];
  rec[R_BL] = (is_query || type == TYPE_O || !has2) ? first : e[F_BL2 * fs];
  rec[R_BL1] = bl1;
  rec[R_RATE] = e[F_RATE * fs];
  rec[R_HAS2] = has2 ? T(1) : T(0);
  rec[R_FLAG] = e[F_FLAG * fs] > T(0.5) ? T(1) : T(0);
  rec[R_EPS] = e[F_EPS * fs];
  rec[7] = T(0);
  MAPLE_UNROLL
  for (int q = 0; q < 4; ++q) rec[R_P0 + q] = e[(F_P0 + q) * fs];
  return make_word(type, to_int_clamped(e[F_END * fs], 0, kMaxEnd));
}

// Four values of a record, 16-byte aligned: one or two vector loads through
// the read-only path on the card.
MAPLE_HD void load4(const float* p, float (&out)[4]) {
#ifdef __CUDA_ARCH__
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
#else
  for (int q = 0; q < 4; ++q) out[q] = p[q];
#endif
}
MAPLE_HD void load4(const double* p, double (&out)[4]) {
#ifdef __CUDA_ARCH__
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
#else
  for (int q = 0; q < 4; ++q) out[q] = p[q];
#endif
}

MAPLE_HD float log_t(float x) { return logf(x); }
MAPLE_HD double log_t(double x) { return log(x); }

template <typename T>
MAPLE_HD T dot4(const T (&a)[4], const T (&b)[4]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3];
}

template <typename T>
MAPLE_HD T dot4p(const T (&a)[4], const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3];
}

// m = M @ v
template <typename T>
MAPLE_HD void mv(const T* mm, const T (&v)[4], T (&m)[4]) {
  MAPLE_UNROLL
  for (int q = 0; q < 4; ++q)
    m[q] = mm[4 * q + 0] * v[0] + mm[4 * q + 1] * v[1] + mm[4 * q + 2] * v[2] +
           mm[4 * q + 3] * v[3];
}

// base + t * (M @ base), collapsed to uniform when any component goes
// negative (reference getPartialVec).
template <typename T>
MAPLE_HD void evolve_down(const T* mm, const T (&base)[4], T t, T (&out)[4]) {
  T m[4];
  mv(mm, base, m);
  bool bad = false;
  MAPLE_UNROLL
  for (int q = 0; q < 4; ++q) {
    out[q] = base[q] + t * m[q];
    bad = bad || out[q] < T(0);
  }
  if (bad) {
    MAPLE_UNROLL
    for (int q = 0; q < 4; ++q) out[q] = T(0.25);
  }
}

template <typename T>
MAPLE_HD void onehot4(T idx, T (&h)[4]) {
  MAPLE_UNROLL
  for (int q = 0; q < 4; ++q) h[q] = idx == T(q) ? T(1) : T(0);
}

// error-adjusted one-hot: f * (h * (1 - eps - e3) + e3) + (1 - f) * h
template <typename T>
MAPLE_HD void err_onehot(T f, const T (&h)[4], T eps, T e3, T (&out)[4]) {
  MAPLE_UNROLL
  for (int q = 0; q < 4; ++q)
    out[q] = f * (h[q] * (T(1) - eps - e3) + e3) + (T(1) - f) * h[q];
}

template <typename T>
MAPLE_HD T root_sum(const T (&a)[4], const T (&b)[4], const T* rf) {
  return a[0] * b[0] * rf[0] + a[1] * b[1] * rf[1] + a[2] * b[2] * rf[2] +
         a[3] * b[3] * rf[3];
}

// log(factor) of one contributing pair: candidate entry (word wp, record
// rp) against query entry (word wc, record rc).  mm is the row-major 4x4
// rate matrix, rf the root frequencies.
template <typename T, bool UER>
MAPLE_HD T pair_log_factor(uint32_t wp, uint32_t wc, const T* rp,
                           const T* rc, T blen, T tip, const T* mm,
                           const T* rf) {
  const int tP = word_type(wp), tC = word_type(wc);
  const bool is_nucP = tP < TYPE_R, is_R_P = tP == TYPE_R,
             is_O_P = tP == TYPE_O;
  const bool is_nucC = tC < TYPE_R, is_O_C = tC == TYPE_O;
  T a0[4], a1[4], c0[4], c1[4] = {T(0), T(0), T(0), T(0)};
  load4(rp, a0);
  load4(rp + 4, a1);
  load4(rc, c0);
  if (UER) load4(rc + 4, c1);
  T pP[4] = {T(0), T(0), T(0), T(0)}, pC[4] = {T(0), T(0), T(0), T(0)};
  if (is_O_P) load4(rp + R_P0, pP);
  if (is_O_C) load4(rc + R_P0, pC);
  const T valP = a0[R_VAL], blP = a0[R_BL], blP1 = a0[R_BL1];
  const bool hasP2 = a1[R_HAS2 - 4] > T(0.5);
  const bool flagP = a1[R_FLAG - 4] > T(0.5);
  const bool flagC = c1[R_FLAG - 4] > T(0.5);
  const T valC = c0[R_VAL];

  // per-position model state: position = min(ends) - 1.  This is the tie
  // rule of the model state, apart from the rule that advances the walk.
  const bool p_side = word_end(wp) <= word_end(wc);
  const T rate = p_side ? a0[R_RATE] : c0[R_RATE];
  const T eps = UER ? (p_side ? a1[R_EPS - 4] : c1[R_EPS - 4]) : T(0);
  const T contrib = blen + blP + c0[R_BL];
  const T refn = is_R_P ? valC : valP;
  T h1[4], h2[4];
  onehot4(is_nucP ? T(tP) : refn, h1);
  onehot4(is_nucC ? T(tC) : refn, h2);
  const T fPh = (UER && flagP) ? T(1) : T(0);
  const T fCh = (UER && (tip > T(0.5) || flagC)) ? T(1) : T(0);
  const T t_eff = contrib * rate;
  const bool pos_t = contrib > T(0);
  const T e3 = T(0.33333) * eps;

  T fac;
  if (is_O_P && is_O_C) {
    T evC_O[4];
    evolve_down(mm, pC, t_eff, evC_O);
    if (!pos_t)
      for (int q = 0; q < 4; ++q) evC_O[q] = pC[q];
    fac = dot4(pP, evC_O);
  } else if (is_O_P) {
    const T pps_i2 = dot4(h2, pP);
    if (pps_i2 > T(0.02)) {
      fac = pps_i2;
    } else {
      T baseC[4], evC_nuc[4];
      err_onehot(fCh, h2, eps, e3, baseC);
      evolve_down(mm, baseC, t_eff, evC_nuc);
      fac = dot4(pP, evC_nuc);
    }
  } else if (is_O_C) {
    const T pcs_i1 = dot4(h1, pC);
    if (pcs_i1 > T(0.02)) {
      fac = pcs_i1;
    } else {
      T evC_O[4];
      evolve_down(mm, pC, t_eff, evC_O);
      if (!pos_t)
        for (int q = 0; q < 4; ++q) evC_O[q] = pC[q];
      if (hasP2) {
        T baseP[4], evP_root[4];
        err_onehot(fPh, h1, eps, e3, baseP);
        evolve_down(mm, baseP, blP1 * rate, evP_root);
        fac = root_sum(evC_O, evP_root, rf) / dot4p(h1, rf);
      } else {
        fac = pos_t ? dot4(h1, evC_O) : pcs_i1;
      }
    }
  } else if (hasP2) {
    T baseC[4], evC_nuc[4], baseP[4], evP_root[4];
    err_onehot(fCh, h2, eps, e3, baseC);
    evolve_down(mm, baseC, t_eff, evC_nuc);
    err_onehot(fPh, h1, eps, e3, baseP);
    evolve_down(mm, baseP, blP1 * rate, evP_root);
    fac = root_sum(evC_nuc, evP_root, rf) / dot4p(h1, rf);
  } else {
    T m2[4];
    mv(mm, h2, m2);
    const T x = rate * dot4(h1, m2) * contrib;
    const T base_nn = T(0.25) <= x ? T(0.25) : x;
    fac = is_R_P ? base_nn + fCh * T(0.33333) * eps
                 : base_nn + (fPh + fCh) * T(0.33333) * eps;
  }
  const T lo_clamp = T(1e-300);
  return fac > T(0) ? log_t(fac > lo_clamp ? fac : lo_clamp) : T(-INFINITY);
}

// What the walk of one (query, candidate) did; only the host loop asks.
struct WalkCount {
  long long steps;  // entry pairs looked at
  long long pairs;  // of them, contributing
};

// Bit (tP * 8 + tC) is set when a candidate entry of type tP and a query
// entry of type tC contribute where they overlap: both live, not R/R, not
// one nucleotide twice.
constexpr uint64_t contributing_types() {
  uint64_t m = 0;
  for (int p = 0; p < 8; ++p)
    for (int c = 0; c < 8; ++c)
      if (p != TYPE_N && p != TYPE_PAD && c != TYPE_N && c != TYPE_PAD &&
          !(p == TYPE_R && c == TYPE_R) && !(p < TYPE_R && p == c))
        m |= uint64_t(1) << (p * 8 + c);
  return m;
}
constexpr uint64_t kContributing = contributing_types();

constexpr int kQueue = 16;  // contributing pairs a walk collects a round

// The score of one query against one candidate.  wP[i * strideP] is the
// candidate's i-th walk word (i < nP), recP its records [nP][kRec]; wC[j]
// and recC the query's.  A step looks at the pair (i, j) under the two
// cursors, then advances the list whose entry ends first (both on a tie),
// so the sum runs in position order and a walk takes at most nP + nC - 1
// steps whatever the rows hold.  A pair contributes when it overlaps, both
// entries are live, and it is neither R/R nor one nucleotide twice.
//
// A step is branch-free (the lanes of a warp are at different entries, and
// a branch on which cursor moves would run both sides for all of them).
// The walk only notes the contributing pairs, (i, j), in `queue` (room for
// 2 * kQueue values, the q-th at queue[q * qstride]); when a lane has
// kQueue of them or has reached the end, the lanes of the warp meet and
// evaluate their factors together, so that the case code runs on full
// warps and not under the walk's lane-by-lane masks.
template <typename T, bool UER>
MAPLE_HD T walk_score(const uint32_t* wP, int strideP, int nP, const T* recP,
                      const uint32_t* wC, int nC, const T* recC, T blen, T tip,
                      T gtr, T tot_error, const T* mm, const T* rf,
                      uint32_t* queue, int qstride, WalkCount* count) {
  int i = 0, j = 0, prevP = 0, prevC = 0;
  bool done = nP <= 0 || nC <= 0;
  uint32_t wp = 0, wc = 0;
  if (!done) {
    wp = wP[0];
    wc = wC[0];
  }
  T acc = T(0);
  while (MAPLE_WARP_ANY(!done)) {
    int nq = 0;
    while (!done && nq < kQueue) {
      const int endP = word_end(wp), endC = word_end(wc);
      const int lo = prevP > prevC ? prevP : prevC;
      const int hi = endP < endC ? endP : endC;
      const int types = word_type(wp) * 8 + word_type(wc);
      if (hi > lo && ((kContributing >> types) & 1u)) {
        queue[static_cast<size_t>(2 * nq) * qstride] = static_cast<uint32_t>(i);
        queue[static_cast<size_t>(2 * nq + 1) * qstride] =
            static_cast<uint32_t>(j);
        ++nq;
      }
      const bool advP = endP <= endC, advC = endC <= endP;
      prevP = advP ? endP : prevP;
      prevC = advC ? endC : prevC;
      i += advP;
      j += advC;
      done = i >= nP || j >= nC;
      wp = wP[static_cast<size_t>(i < nP ? i : nP - 1) * strideP];
      wc = wC[j < nC ? j : nC - 1];
      if (count) ++count->steps;
    }
    MAPLE_WARP_SYNC();
    for (int r = 0; MAPLE_WARP_ANY(r < nq); ++r) {
      if (r < nq) {
        const size_t fi = queue[static_cast<size_t>(2 * r) * qstride];
        const size_t fj = queue[static_cast<size_t>(2 * r + 1) * qstride];
        acc += pair_log_factor<T, UER>(wP[fi * strideP], wC[fj],
                                       recP + fi * kRec, recC + fj * kRec,
                                       blen, tip, mm, rf);
        if (count) ++count->pairs;
      }
    }
  }
  T s = acc + blen * gtr;
  if (UER) s += tip * tot_error;
  return s;
}

}  // namespace maple_walk
