// Host loop around the merge walk in append_walk.cuh: the functions the CUDA
// pair kernel calls, on the same operand layout, in a plain loop over
// (query, candidate).  Built with g++ (-ffp-contract=off) by
// maple_tpu_torch/ops/_build.py.  The CPU tests call the dense loop; the
// gathered loop is also the gathered entry's work on CPU tensors
// (ops/append_pairs.py append_scores_gathered).
//
// P [N, 16, B1], C [K, B2 * 16], prm [K, 4] = (blen, tip, globalTotRate,
// totError), mm [16], rf [4], out [K, N].  steps and pairs ([K, N], or
// null) receive what each walk did; n_p [N] and n_c [K] (or null) the
// rows' entry counts.  The gathered loop scores query k against candidate
// rows[k * M + m] into out [K, M] (a row outside [0, N) scores -inf).

#include <vector>

#include "append_walk.cuh"

namespace {

using namespace maple_walk;

template <typename T>
struct Rows {
  std::vector<int> count;
  std::vector<uint32_t> words;  // [rows, B]
  std::vector<T> recs;          // [rows, B, kRec]
};

// The compact form of `rows` rows of B entries; entry b of row r starts at
// base[r * 16 * B + b * es] and its field q lies fs values further on.
template <typename T>
Rows<T> compact(const T* base, int rows, int B, size_t es, size_t fs,
                bool is_query) {
  Rows<T> out;
  out.count.assign(rows, 0);
  out.words.assign(static_cast<size_t>(rows) * B, 0u);
  out.recs.assign(static_cast<size_t>(rows) * B * kRec, T(0));
  for (int r = 0; r < rows; ++r) {
    const T* row = base + static_cast<size_t>(r) * kF * B;
    for (int b = 0; b < B; ++b)
      if (entry_type(row[b * es + F_TYPE * fs]) != TYPE_PAD)
        out.count[r] = b + 1;
    for (int b = 0; b < out.count[r]; ++b) {
      T rec[kRec];
      const size_t at = static_cast<size_t>(r) * B + b;
      out.words[at] = pack_entry(row + b * es, fs, is_query, rec);
      for (int q = 0; q < kRec; ++q) out.recs[at * kRec + q] = rec[q];
    }
  }
  return out;
}

template <typename T, bool UER>
void score_all(const Rows<T>& P, const Rows<T>& Q, const T* prm, const T* mm,
               const T* rf, T* out, long long* steps, long long* pairs, int N,
               int K, int B1, int B2) {
  for (int k = 0; k < K; ++k) {
    const T* pr = prm + 4 * k;
    for (int n = 0; n < N; ++n) {
      WalkCount count = {0, 0};
      uint32_t queue[2 * kQueue];
      const size_t p0 = static_cast<size_t>(n) * B1;
      const size_t q0 = static_cast<size_t>(k) * B2;
      out[static_cast<size_t>(k) * N + n] = walk_score<T, UER>(
          P.words.data() + p0, 1, P.count[n], P.recs.data() + p0 * kRec,
          Q.words.data() + q0, Q.count[k], Q.recs.data() + q0 * kRec, pr[0],
          pr[1], pr[2], pr[3], mm, rf, queue, 1, &count);
      if (steps) steps[static_cast<size_t>(k) * N + n] = count.steps;
      if (pairs) pairs[static_cast<size_t>(k) * N + n] = count.pairs;
    }
  }
}

template <typename T, bool UER>
void score_gathered(const Rows<T>& P, const Rows<T>& Q, const long long* rows,
                    const T* prm, const T* mm, const T* rf, T* out, int N,
                    int K, int M, int B1, int B2) {
  for (int k = 0; k < K; ++k) {
    const T* pr = prm + 4 * k;
    const size_t q0 = static_cast<size_t>(k) * B2;
    for (int m = 0; m < M; ++m) {
      const long long r = rows[static_cast<size_t>(k) * M + m];
      T* o = out + static_cast<size_t>(k) * M + m;
      if (r < 0 || r >= N) {
        *o = T(-INFINITY);
        continue;
      }
      uint32_t queue[2 * kQueue];
      const size_t p0 = static_cast<size_t>(r) * B1;
      *o = walk_score<T, UER>(
          P.words.data() + p0, 1, P.count[r], P.recs.data() + p0 * kRec,
          Q.words.data() + q0, Q.count[k], Q.recs.data() + q0 * kRec, pr[0],
          pr[1], pr[2], pr[3], mm, rf, queue, 1, nullptr);
    }
  }
}

template <typename T>
int run_gathered(const T* P, const T* C, const long long* rows, const T* prm,
                 const T* mm, const T* rf, T* out, int N, int K, int M,
                 int B1, int B2, int uer) {
  const Rows<T> cand = compact(P, N, B1, 1, static_cast<size_t>(B1), false);
  const Rows<T> query = compact(C, K, B2, kF, 1, true);
  if (uer)
    score_gathered<T, true>(cand, query, rows, prm, mm, rf, out, N, K, M, B1,
                            B2);
  else
    score_gathered<T, false>(cand, query, rows, prm, mm, rf, out, N, K, M, B1,
                             B2);
  return 0;
}

template <typename T>
int run(const T* P, const T* C, const T* prm, const T* mm, const T* rf, T* out,
        long long* steps, long long* pairs, int* n_p, int* n_c, int N, int K,
        int B1, int B2, int uer) {
  const Rows<T> cand = compact(P, N, B1, 1, static_cast<size_t>(B1), false);
  const Rows<T> query = compact(C, K, B2, kF, 1, true);
  if (n_p)
    for (int n = 0; n < N; ++n) n_p[n] = cand.count[n];
  if (n_c)
    for (int k = 0; k < K; ++k) n_c[k] = query.count[k];
  if (uer)
    score_all<T, true>(cand, query, prm, mm, rf, out, steps, pairs, N, K, B1,
                       B2);
  else
    score_all<T, false>(cand, query, prm, mm, rf, out, steps, pairs, N, K, B1,
                        B2);
  return 0;
}

}  // namespace

extern "C" {

int append_walk_host_f32(const float* P, const float* C, const float* prm,
                         const float* mm, const float* rf, float* out,
                         long long* steps, long long* pairs, int* n_p,
                         int* n_c, int N, int K, int B1, int B2, int uer) {
  return run<float>(P, C, prm, mm, rf, out, steps, pairs, n_p, n_c, N, K, B1,
                    B2, uer);
}

int append_walk_host_f64(const double* P, const double* C, const double* prm,
                         const double* mm, const double* rf, double* out,
                         long long* steps, long long* pairs, int* n_p,
                         int* n_c, int N, int K, int B1, int B2, int uer) {
  return run<double>(P, C, prm, mm, rf, out, steps, pairs, n_p, n_c, N, K, B1,
                     B2, uer);
}

int append_walk_host_gathered_f32(const float* P, const float* C,
                                  const long long* rows, const float* prm,
                                  const float* mm, const float* rf, float* out,
                                  int N, int K, int M, int B1, int B2,
                                  int uer) {
  return run_gathered<float>(P, C, rows, prm, mm, rf, out, N, K, M, B1, B2,
                             uer);
}

int append_walk_host_gathered_f64(const double* P, const double* C,
                                  const long long* rows, const double* prm,
                                  const double* mm, const double* rf,
                                  double* out, int N, int K, int M, int B1,
                                  int B2, int uer) {
  return run_gathered<double>(P, C, rows, prm, mm, rf, out, N, K, M, B1, B2,
                              uer);
}

}  // extern "C"
