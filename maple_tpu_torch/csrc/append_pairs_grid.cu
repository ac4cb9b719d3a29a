// appendProbNode pair kernel, the B1 x B2 grid form: the yardstick beside
// the merge-walk kernel of append_pairs.cu.  No placer, screen or mesh
// function reaches it; chip_smoke.py and tools/speed_of_light.py time it on
// the operands they time the walk kernel on, and compare the two.
//
// It carries the design of the Pallas TPU kernel `_append_kernel_lanes` +
// `_kernel_common` (maple_tpu/ops/pallas_append.py) over as it is: a masked
// sum of log(factor) over every (candidate entry, query entry) cell of the
// grid, of which about one in a thousand contributes.
//
// Layout (see maple_tpu_torch/ops/layout.py): candidates P[N, 16, B1],
// queries C[K, B2 * 16], per-query params prm[K, 4] = (blen, tip,
// globalTotRate, totError), mm[16] (row-major 4x4 rate matrix), rf[4].
//
// Design.  Grid (ceil(N / 128), K), 128 threads; each thread owns one
// (query k, candidate n) and accumulates in the working type T.  The query
// is the same for the whole block, so it is staged in shared memory in
// chunks of kChunk entries (16 KB at double; B2 doubles with long queries,
// so it is never staged whole).  For each chunk the thread walks its B1
// candidate entries once, holding that entry's fields in registers, and
// reads the chunk's query entries from shared memory (broadcast).
//
// What bounds it on this card: it visits B1 x (active B2) cells a thread,
// a handful of compares each and about 100 flops for a contributing one,
// and its candidate reads are strided (neighbouring candidates are 16 * B1
// words apart in the [cap, 16, B1] pool), so they do not coalesce and are
// repeated for every query.
//
// Numerics mirror _kernel_common term for term: the literals 0.33333, 0.25
// and 0.02 are cast to T, and fac <= 0 (or NaN) gives -inf.
// log(max(fac, T(1e-300))) keeps the reference's clamp: T(1e-300) is 0 in
// float, where the fac > 0 test alone guards the log.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kF = 16;
constexpr int F_TYPE = 0, F_VAL = 1, F_BL1 = 2, F_BL2 = 3, F_HAS1 = 4,
              F_HAS2 = 5, F_FLAG = 6, F_P0 = 7, F_END = 11, F_PREV = 12,
              F_RATE = 13, F_EPS = 14;
constexpr int TYPE_R = 4, TYPE_N = 5, TYPE_O = 6, TYPE_PAD = 7;
constexpr int kThreads = 128;
constexpr int kChunk = 128;  // query entries staged per pass

__device__ __forceinline__ float log_t(float x) { return logf(x); }
__device__ __forceinline__ double log_t(double x) { return log(x); }
__device__ __forceinline__ float neg_inf(float) { return -CUDART_INF_F; }
__device__ __forceinline__ double neg_inf(double) { return -CUDART_INF; }

template <typename T>
__device__ __forceinline__ T dot4(const T (&a)[4], const T (&b)[4]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3];
}

// m = M @ v
template <typename T>
__device__ __forceinline__ void mv(const T (&mm)[16], const T (&v)[4],
                                   T (&m)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    m[q] = mm[4 * q + 0] * v[0] + mm[4 * q + 1] * v[1] + mm[4 * q + 2] * v[2] +
           mm[4 * q + 3] * v[3];
}

// base + t * (M @ base), collapsed to uniform when any component goes
// negative (reference getPartialVec).
template <typename T>
__device__ __forceinline__ void evolve_down(const T (&mm)[16],
                                            const T (&base)[4], T t,
                                            T (&out)[4]) {
  T m[4];
  mv(mm, base, m);
  bool bad = false;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    out[q] = base[q] + t * m[q];
    bad = bad || out[q] < T(0);
  }
  if (bad) {
#pragma unroll
    for (int q = 0; q < 4; ++q) out[q] = T(0.25);
  }
}

template <typename T>
__device__ __forceinline__ void onehot4(T idx, T (&h)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = idx == T(q) ? T(1) : T(0);
}

// error-adjusted one-hot: f * (h * (1 - eps - e3) + e3) + (1 - f) * h
template <typename T>
__device__ __forceinline__ void err_onehot(T f, const T (&h)[4], T eps, T e3,
                                           T (&out)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    out[q] = f * (h[q] * (T(1) - eps - e3) + e3) + (T(1) - f) * h[q];
}

template <typename T>
__device__ __forceinline__ T root_sum(const T (&a)[4], const T (&b)[4],
                                      const T (&rf)[4]) {
  return a[0] * b[0] * rf[0] + a[1] * b[1] * rf[1] + a[2] * b[2] * rf[2] +
         a[3] * b[3] * rf[3];
}

template <typename T, bool UER>
__global__ void __launch_bounds__(kThreads)
    append_pairs_kernel(const T* __restrict__ P, const T* __restrict__ Cq,
                        const T* __restrict__ prm, const T* __restrict__ mm_g,
                        const T* __restrict__ rf_g, T* __restrict__ out, int N,
                        int B1, int B2) {
  __shared__ T sC[kChunk * kF];
  const int k = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;

  T mm[16], rf[4];
#pragma unroll
  for (int q = 0; q < 16; ++q) mm[q] = mm_g[q];
#pragma unroll
  for (int q = 0; q < 4; ++q) rf[q] = rf_g[q];
  const T blen = prm[4 * k + 0];
  const T tip = prm[4 * k + 1];
  const T gtr = prm[4 * k + 2];
  const T tot_error = prm[4 * k + 3];

  const T* Ck = Cq + static_cast<size_t>(k) * B2 * kF;
  const T* Pn = P + static_cast<size_t>(n < N ? n : 0) * kF * B1;
  T acc = T(0);

  for (int c0 = 0; c0 < B2; c0 += kChunk) {
    const int cn = min(kChunk, B2 - c0);
    __syncthreads();
    for (int t = threadIdx.x; t < cn * kF; t += kThreads)
      sC[t] = Ck[static_cast<size_t>(c0) * kF + t];
    __syncthreads();
    if (n >= N) continue;

    for (int i = 0; i < B1; ++i) {
      const T cP = Pn[F_TYPE * B1 + i];
      if (cP == T(TYPE_N) || cP == T(TYPE_PAD)) continue;  // dead: no pairs
      const T endP = Pn[F_END * B1 + i];
      const T prevP = Pn[F_PREV * B1 + i];
      const T valP = Pn[F_VAL * B1 + i];
      const T blP1 = Pn[F_BL1 * B1 + i];
      const T blP2 = Pn[F_BL2 * B1 + i];
      const bool hasP1 = Pn[F_HAS1 * B1 + i] > T(0.5);
      const bool hasP2 = Pn[F_HAS2 * B1 + i] > T(0.5);
      const bool flagP = Pn[F_FLAG * B1 + i] > T(0.5);
      const T rateP = Pn[F_RATE * B1 + i];
      const T epsP = UER ? Pn[F_EPS * B1 + i] : T(0);
      T pP[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) pP[q] = Pn[(F_P0 + q) * B1 + i];
      const bool is_nucP = cP < T(3.5);
      const bool is_R_P = cP == T(TYPE_R);
      const bool is_O_P = cP == T(TYPE_O);
      const T blP = is_O_P ? (hasP1 ? blP1 : T(0))
                           : (hasP2 ? blP2 : (hasP1 ? blP1 : T(0)));
      const T fPh = (UER && flagP) ? T(1) : T(0);

      for (int j = 0; j < cn; ++j) {
        const T* c = sC + j * kF;
        const T cC = c[F_TYPE];
        if (cC == T(TYPE_N) || cC == T(TYPE_PAD)) continue;  // inactive
        const T endC = c[F_END];
        const T prevC = c[F_PREV];
        const T lo = prevP > prevC ? prevP : prevC;
        const T hi = endP < endC ? endP : endC;
        if (!(hi - lo > T(0.5))) continue;           // no overlap
        if (is_R_P && cC == T(TYPE_R)) continue;     // R/R: factor 1
        if (is_nucP && cP == cC) continue;           // same nucleotide

        const T valC = c[F_VAL];
        const bool hasC1 = c[F_HAS1] > T(0.5);
        const bool flagC = c[F_FLAG] > T(0.5);
        const bool is_nucC = cC < T(3.5);
        const bool is_O_C = cC == T(TYPE_O);
        T pC[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) pC[q] = c[F_P0 + q];

        // per-position model state: position = min(ends) - 1
        const bool p_side = endP <= endC;
        const T rate = p_side ? rateP : c[F_RATE];
        const T eps = UER ? (p_side ? epsP : c[F_EPS]) : T(0);
        const T contrib = blen + blP + (hasC1 ? c[F_BL1] : T(0));
        const T refn = is_R_P ? valC : valP;
        T h1[4], h2[4];
        onehot4(is_nucP ? cP : refn, h1);
        onehot4(is_nucC ? cC : refn, h2);
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
              fac = root_sum(evC_O, evP_root, rf) / dot4(h1, rf);
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
          fac = root_sum(evC_nuc, evP_root, rf) / dot4(h1, rf);
        } else {
          T m2[4];
          mv(mm, h2, m2);
          const T x = rate * dot4(h1, m2) * contrib;
          const T base_nn = T(0.25) <= x ? T(0.25) : x;
          fac = is_R_P ? base_nn + fCh * T(0.33333) * eps
                       : base_nn + (fPh + fCh) * T(0.33333) * eps;
        }
        const T lo_clamp = T(1e-300);
        acc += fac > T(0) ? log_t(fac > lo_clamp ? fac : lo_clamp)
                          : neg_inf(T(0));
      }
    }
  }
  if (n < N) {
    T s = acc + blen * gtr;
    if (UER) s += tip * tot_error;
    out[static_cast<size_t>(k) * N + n] = s;
  }
}

template <typename T>
int launch(const void* P, const void* C, const void* prm, const void* mm,
           const void* rf, void* out, int N, int K, int B1, int B2, int uer,
           void* stream) {
  const dim3 grid((N + kThreads - 1) / kThreads, K);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* p = static_cast<const T*>(P);
  const T* c = static_cast<const T*>(C);
  const T* pr = static_cast<const T*>(prm);
  const T* m = static_cast<const T*>(mm);
  const T* r = static_cast<const T*>(rf);
  T* o = static_cast<T*>(out);
  if (uer)
    append_pairs_kernel<T, true><<<grid, kThreads, 0, s>>>(p, c, pr, m, r, o,
                                                           N, B1, B2);
  else
    append_pairs_kernel<T, false><<<grid, kThreads, 0, s>>>(p, c, pr, m, r, o,
                                                            N, B1, B2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 on success).
int append_pairs_grid_f32(const void* P, const void* C, const void* prm,
                          const void* mm, const void* rf, void* out, int N,
                          int K, int B1, int B2, int uer, void* stream) {
  return launch<float>(P, C, prm, mm, rf, out, N, K, B1, B2, uer, stream);
}

int append_pairs_grid_f64(const void* P, const void* C, const void* prm,
                          const void* mm, const void* rf, void* out, int N,
                          int K, int B1, int B2, int uer, void* stream) {
  return launch<double>(P, C, prm, mm, rf, out, N, K, B1, B2, uer, stream);
}

}  // extern "C"
