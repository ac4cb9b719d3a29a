// appendProbNode pair kernel for Hopper (sm_90a): an O(B1 + B2) merge walk
// over compact entry lists.
//
// Replaces the Pallas TPU kernel `_append_kernel_lanes` + `_kernel_common`
// launched by `pallas_scores_prestacked` (maple_tpu/ops/pallas_append.py).
// It computes scores[K, N]: the relative appendProbNode log-likelihood of
// attaching each query genome list (K of them) below each candidate upper
// vector (N of them).  Both lists partition [0, lRef] into entries, so every
// union segment is the overlap of exactly one (candidate entry, query entry)
// pair; the score is the sum of log(factor) over the overlapping pairs that
// are not dead (N/PAD), not R/R and not the same nucleotide, plus
// blen * globalTotRate (and tip * totError with the error model on).
//
// Layout (see maple_tpu_torch/ops/layout.py): candidates P[N, 16, B1],
// queries C[K, B2 * 16], per-query params prm[K, 4] = (blen, tip,
// globalTotRate, totError), mm[16] (row-major 4x4 rate matrix), rf[4].
//
// What bounds the function on this card.  About one entry pair in a
// thousand of the B1 x B2 grid contributes; a kernel that visits the grid
// (the TPU kernel's design, where a masked sum over 128 candidate lanes
// costs no branch) spends its time on empty cells and on candidate reads
// that are 16 * B1 words apart from thread to thread and are repeated for
// every query.  The
// function itself needs the packed lists once (bytes) and about 100
// operations a contributing pair.
//
// Design.  Two launches a call, no atomics, every sum in position order, so
// a call gives the same bits every time.
//
// 1. compact_rows: one warp a row, candidates and queries alike.  It reads
//    the row along its entry axis (contiguous, so the loads coalesce), first
//    the type plane to find the row's entry count, then the other planes up
//    to that count only, and writes the compact form of append_walk.cuh: the
//    count, one walk word an entry and one 12-value record an entry.  The
//    candidates' walk words are written tile by tile, [tile][entry][32], the
//    layout the walk reads them in.
// 2. append_walk: a block is 4 warps on one tile of 32 candidates (lane =
//    candidate) and a group of KQ queries (warp w takes queries w, w + 4,
//    ...).  The tile's walk words are copied once into shared memory,
//    [entry][32], so the lanes of a warp read 32 different banks whatever
//    entry each has reached; the group's query words sit beside them.  The
//    pool is thus read once a call in its 16-plane form and once a query
//    group in its 4-byte form.  Each lane runs walk_score(): at most
//    nP + nC - 1 branch-free steps of integer compares that note the
//    contributing pairs in a queue of 16 in shared memory; then, for those
//    pairs only, three 16-byte loads of each record and the case code, which
//    the lanes of a warp enter together.
//
// KQ is chosen so that the grid has about a thousand blocks.  Rows too long
// for shared memory (B1 above 1152, B2 above 4096) are walked from device
// memory through the same pointers.
//
// A second entry, append_pairs_gathered_*, scores each query against its own
// list of candidate rows (scores [K, M], the device SPR pass's re-score of
// each query's screened rows): the same compaction, then
// append_walk_gathered, one query a block and one candidate a thread.

#include <cuda_runtime.h>

#include "append_walk.cuh"

namespace {

using namespace maple_walk;

constexpr int kTile = 32;       // candidates a block: one a lane
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kModel = 24;      // mm[16], rf[4], padded to 16 bytes
constexpr int kTargetBlocks = 1056;
constexpr size_t kSmemP = 144 * 1024;  // most a tile's words may take
constexpr size_t kSmemC = 64 * 1024;   // most a query group's may take

// Where the compact form lies in the wrapper's two scratch tensors.
struct Scratch {
  long long cnt_p, cnt_c, w_p, w_c, n_int;  // offsets in int32 words
  long long rec_p, rec_c, n_rec;            // offsets in values of T
};

Scratch scratch_layout(int N, int K, int B1, int B2) {
  const long long tiles = (N + kTile - 1) / kTile;
  Scratch s;
  s.cnt_p = 0;
  s.cnt_c = s.cnt_p + N;
  s.w_p = s.cnt_c + K;
  s.w_c = s.w_p + tiles * kTile * B1;
  s.n_int = s.w_c + static_cast<long long>(K) * B2;
  s.rec_p = 0;
  s.rec_c = static_cast<long long>(N) * B1 * kRec;
  s.n_rec = s.rec_c + static_cast<long long>(K) * B2 * kRec;
  return s;
}

// The walk's launch: a grid of (tiles, groups) blocks, KQ queries a group,
// which lists lie in shared memory, and the block's dynamic shared memory.
struct WalkLaunch {
  int tiles, groups, KQ, p_in_smem, c_in_smem, smem;
};

// Queries a block: enough blocks to fill the card, a warp's worth of
// queries at least, and no more than shared memory holds.
WalkLaunch walk_launch(int N, int K, int B1, int B2, size_t elem_size) {
  WalkLaunch w;
  w.tiles = N > 0 ? (N + kTile - 1) / kTile : 1;
  const int max_groups = K > kWarps ? (K + kWarps - 1) / kWarps : 1;
  int groups = (kTargetBlocks + w.tiles - 1) / w.tiles;
  groups = groups > max_groups ? max_groups : groups;
  w.KQ = (K + groups - 1) / groups;
  w.KQ = w.KQ > kWarps ? (w.KQ + kWarps - 1) / kWarps * kWarps : kWarps;
  w.p_in_smem = sizeof(uint32_t) * kTile * B1 <= kSmemP;
  w.c_in_smem = sizeof(uint32_t) * kWarps * B2 <= kSmemC;
  while (w.c_in_smem && sizeof(uint32_t) * w.KQ * B2 > kSmemC) w.KQ -= kWarps;
  w.groups = (K + w.KQ - 1) / w.KQ;
  w.smem = static_cast<int>(
      kModel * elem_size + (w.p_in_smem ? sizeof(uint32_t) * kTile * B1 : 0) +
      (w.c_in_smem ? sizeof(uint32_t) * w.KQ * B2 : 0) +
      sizeof(uint32_t) * 2 * kQueue * kThreads);
  return w;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double* v) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int o = __shfl_xor_sync(0xffffffffu, v, d);
    v = o > v ? o : v;
  }
  return v;
}

// Rows 0..N-1 are the candidates, rows N..N+K-1 the queries.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    compact_rows(const T* __restrict__ P, const T* __restrict__ C,
                 int* __restrict__ cnt_p, int* __restrict__ cnt_c,
                 uint32_t* __restrict__ w_p, uint32_t* __restrict__ w_c,
                 T* __restrict__ rec_p, T* __restrict__ rec_c, int N, int K,
                 int B1, int B2) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= N + K) return;  // the whole warp
  const bool is_query = row >= N;
  const int r = is_query ? row - N : row;
  const int B = is_query ? B2 : B1;
  const size_t es = is_query ? kF : 1;    // from entry to entry
  const size_t fs = is_query ? 1 : B1;    // from field to field
  const T* base = (is_query ? C : P) + static_cast<size_t>(r) * kF * B;

  int last = 0;
  for (int b = lane; b < B; b += 32)
    if (entry_type(base[b * es + F_TYPE * fs]) != TYPE_PAD) last = b + 1;
  const int count = warp_max(last);
  if (lane == 0) (is_query ? cnt_c : cnt_p)[r] = count;

  uint32_t* words =
      is_query ? w_c + static_cast<size_t>(r) * B2
               : w_p + static_cast<size_t>(r / kTile) * kTile * B1 + r % kTile;
  const size_t ws = is_query ? 1 : kTile;
  T* recs = (is_query ? rec_c : rec_p) + static_cast<size_t>(r) * B * kRec;
  for (int b = lane; b < count; b += 32) {
    T rec[kRec];
    words[b * ws] = pack_entry(base + b * es, fs, is_query, rec);
    T* out = recs + static_cast<size_t>(b) * kRec;
    store4(out, rec);
    store4(out + 4, rec + 4);
    store4(out + 8, rec + 8);
  }
}

template <typename T, bool UER>
__global__ void __launch_bounds__(kThreads)
    append_walk(const int* __restrict__ cnt_p, const int* __restrict__ cnt_c,
                const uint32_t* __restrict__ w_p,
                const uint32_t* __restrict__ w_c, const T* __restrict__ rec_p,
                const T* __restrict__ rec_c, const T* __restrict__ prm,
                const T* __restrict__ mm_g, const T* __restrict__ rf_g,
                T* __restrict__ out, int N, int K, int B1, int B2, int KQ,
                int p_in_smem, int c_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_model = reinterpret_cast<T*>(smem_raw);
  uint32_t* s_p = reinterpret_cast<uint32_t*>(s_model + kModel);
  uint32_t* s_c = s_p + (p_in_smem ? kTile * B1 : 0);
  uint32_t* s_queue = s_c + (c_in_smem ? KQ * B2 : 0) + threadIdx.x;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int k0 = blockIdx.y * KQ;
  const int kn = min(KQ, K - k0);
  const int n = tile * kTile + lane;
  const int nP = n < N ? cnt_p[n] : 0;
  const uint32_t* tile_words = w_p + static_cast<size_t>(tile) * kTile * B1;

  if (threadIdx.x < 16) s_model[threadIdx.x] = mm_g[threadIdx.x];
  if (threadIdx.x >= 16 && threadIdx.x < 20)
    s_model[threadIdx.x] = rf_g[threadIdx.x - 16];
  if (p_in_smem) {
    const int filled = warp_max(nP) * kTile;  // the same in every warp
    for (int t = threadIdx.x; t < filled; t += kThreads)
      s_p[t] = tile_words[t];
  }
  if (c_in_smem) {
    for (int q = 0; q < kn; ++q) {
      const int nC = cnt_c[k0 + q];
      const uint32_t* src = w_c + static_cast<size_t>(k0 + q) * B2;
      for (int j = threadIdx.x; j < nC; j += kThreads)
        s_c[q * B2 + j] = src[j];
    }
  }
  __syncthreads();

  const uint32_t* wP = (p_in_smem ? s_p : tile_words) + lane;
  const T* recP = rec_p + static_cast<size_t>(n < N ? n : 0) * B1 * kRec;
  for (int q = warp; q < kn; q += kWarps) {
    const int k = k0 + q;
    const uint32_t* wC =
        c_in_smem ? s_c + q * B2 : w_c + static_cast<size_t>(k) * B2;
    const T* pr = prm + 4 * k;
    const T s = walk_score<T, UER>(
        wP, kTile, nP, recP, wC, cnt_c[k],
        rec_c + static_cast<size_t>(k) * B2 * kRec, pr[0], pr[1], pr[2], pr[3],
        s_model, s_model + 16, s_queue, kThreads, nullptr);
    if (n < N) out[static_cast<size_t>(k) * N + n] = s;
  }
}

// The compact form of a call's rows in the two scratch tensors: the first
// launch of every call.
template <typename T>
struct Compact {
  int *cnt_p, *cnt_c;
  uint32_t *w_p, *w_c;
  T *rec_p, *rec_c;
};

template <typename T>
int compact(const void* P, const void* C, void* scratch_int, void* scratch_rec,
            int N, int K, int B1, int B2, cudaStream_t st, Compact<T>* c) {
  const Scratch s = scratch_layout(N, K, B1, B2);
  int* ints = static_cast<int*>(scratch_int);
  T* recs = static_cast<T*>(scratch_rec);
  c->cnt_p = ints + s.cnt_p;
  c->cnt_c = ints + s.cnt_c;
  c->w_p = reinterpret_cast<uint32_t*>(ints + s.w_p);
  c->w_c = reinterpret_cast<uint32_t*>(ints + s.w_c);
  c->rec_p = recs + s.rec_p;
  c->rec_c = recs + s.rec_c;
  const int rows = N + K;
  compact_rows<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<const T*>(P), static_cast<const T*>(C), c->cnt_p, c->cnt_c,
      c->w_p, c->w_c, c->rec_p, c->rec_c, N, K, B1, B2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* P, const void* C, const void* prm, const void* mm,
           const void* rf, void* out, void* scratch_int, void* scratch_rec,
           int N, int K, int B1, int B2, int uer, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Compact<T> c;
  cudaError_t err = static_cast<cudaError_t>(
      compact<T>(P, C, scratch_int, scratch_rec, N, K, B1, B2, st, &c));
  if (err != cudaSuccess) return static_cast<int>(err);

  const WalkLaunch w = walk_launch(N, K, B1, B2, sizeof(T));
  if (w.groups > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);

  decltype(&append_walk<T, true>) kernel =
      uer ? &append_walk<T, true> : &append_walk<T, false>;
  if (w.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, w.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(w.tiles, w.groups), kThreads, w.smem, st>>>(
      c.cnt_p, c.cnt_c, c.w_p, c.w_c, c.rec_p, c.rec_c,
      static_cast<const T*>(prm), static_cast<const T*>(mm),
      static_cast<const T*>(rf), static_cast<T*>(out), N, K, B1, B2, w.KQ,
      w.p_in_smem, w.c_in_smem);
  return static_cast<int>(cudaGetLastError());
}

// Gathered pairs: each query against its own list of candidate rows (the
// device SPR pass re-scores each query's screened top-M this way).  Block
// (k, y) takes query k and its candidates rows[k][y * 128 + t], one a
// thread; a row outside [0, N) scores -inf.  The query's walk words are
// copied into shared memory; the candidates' words are read from device
// memory in the tiled layout compact_rows wrote (L2 holds a pool of a few
// MB).  All threads call walk_score(), a dead one with no entries, so the
// warps meet as the walk needs.
template <typename T, bool UER>
__global__ void __launch_bounds__(kThreads)
    append_walk_gathered(const int* __restrict__ cnt_p,
                         const int* __restrict__ cnt_c,
                         const uint32_t* __restrict__ w_p,
                         const uint32_t* __restrict__ w_c,
                         const T* __restrict__ rec_p,
                         const T* __restrict__ rec_c,
                         const long long* __restrict__ rows,
                         const T* __restrict__ prm, const T* __restrict__ mm_g,
                         const T* __restrict__ rf_g, T* __restrict__ out, int N,
                         int M, int B1, int B2, int c_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_model = reinterpret_cast<T*>(smem_raw);
  uint32_t* s_c = reinterpret_cast<uint32_t*>(s_model + kModel);
  uint32_t* s_queue = s_c + (c_in_smem ? B2 : 0) + threadIdx.x;

  const int k = blockIdx.x;
  const int m = blockIdx.y * kThreads + threadIdx.x;
  const int nC = cnt_c[k];
  const uint32_t* wC = w_c + static_cast<size_t>(k) * B2;
  if (threadIdx.x < 16) s_model[threadIdx.x] = mm_g[threadIdx.x];
  if (threadIdx.x >= 16 && threadIdx.x < 20)
    s_model[threadIdx.x] = rf_g[threadIdx.x - 16];
  if (c_in_smem) {
    for (int j = threadIdx.x; j < nC; j += kThreads) s_c[j] = wC[j];
    wC = s_c;
  }
  __syncthreads();

  const long long r = m < M ? rows[static_cast<size_t>(k) * M + m] : -1;
  const bool live = r >= 0 && r < N;
  const int n = live ? static_cast<int>(r) : 0;
  const uint32_t* wP =
      w_p + static_cast<size_t>(n / kTile) * kTile * B1 + n % kTile;
  const T* pr = prm + 4 * k;
  const T s = walk_score<T, UER>(
      wP, kTile, live ? cnt_p[n] : 0, rec_p + static_cast<size_t>(n) * B1 * kRec,
      wC, nC, rec_c + static_cast<size_t>(k) * B2 * kRec, pr[0], pr[1], pr[2],
      pr[3], s_model, s_model + 16, s_queue, kThreads, nullptr);
  if (m < M) out[static_cast<size_t>(k) * M + m] = live ? s : T(-INFINITY);
}

template <typename T>
int launch_gathered(const void* P, const void* C, const void* rows,
                    const void* prm, const void* mm, const void* rf, void* out,
                    void* scratch_int, void* scratch_rec, int N, int K, int M,
                    int B1, int B2, int uer, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Compact<T> c;
  cudaError_t err = static_cast<cudaError_t>(
      compact<T>(P, C, scratch_int, scratch_rec, N, K, B1, B2, st, &c));
  if (err != cudaSuccess || K == 0 || M == 0) return static_cast<int>(err);
  const int ygroups = (M + kThreads - 1) / kThreads;
  if (ygroups > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int c_in_smem = sizeof(uint32_t) * B2 <= kSmemC;
  const int smem = static_cast<int>(kModel * sizeof(T) +
                                    (c_in_smem ? sizeof(uint32_t) * B2 : 0) +
                                    sizeof(uint32_t) * 2 * kQueue * kThreads);
  decltype(&append_walk_gathered<T, true>) kernel =
      uer ? &append_walk_gathered<T, true> : &append_walk_gathered<T, false>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(K, ygroups), kThreads, smem, st>>>(
      c.cnt_p, c.cnt_c, c.w_p, c.w_c, c.rec_p, c.rec_c,
      static_cast<const long long*>(rows), static_cast<const T*>(prm),
      static_cast<const T*>(mm), static_cast<const T*>(rf),
      static_cast<T*>(out), N, M, B1, B2, c_in_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The sizes of the two scratch tensors a call needs: n_int int32 words and
// n_rec values of the working type.
void append_pairs_scratch(int N, int K, int B1, int B2, long long* n_int,
                          long long* n_rec) {
  const Scratch s = scratch_layout(N, K, B1, B2);
  *n_int = s.n_int;
  *n_rec = s.n_rec;
}

// Each returns the first CUDA error of its launches (0 on success).
int append_pairs_f32(const void* P, const void* C, const void* prm,
                     const void* mm, const void* rf, void* out,
                     void* scratch_int, void* scratch_rec, int N, int K,
                     int B1, int B2, int uer, void* stream) {
  return launch<float>(P, C, prm, mm, rf, out, scratch_int, scratch_rec, N, K,
                       B1, B2, uer, stream);
}

int append_pairs_f64(const void* P, const void* C, const void* prm,
                     const void* mm, const void* rf, void* out,
                     void* scratch_int, void* scratch_rec, int N, int K,
                     int B1, int B2, int uer, void* stream) {
  return launch<double>(P, C, prm, mm, rf, out, scratch_int, scratch_rec, N,
                        K, B1, B2, uer, stream);
}

// Scores [K, M] of query k against candidate rows[k * M + m] (int64; a row
// outside [0, N) scores -inf), with the scratch of append_pairs_scratch(N,
// K, B1, B2).
int append_pairs_gathered_f32(const void* P, const void* C, const void* rows,
                              const void* prm, const void* mm, const void* rf,
                              void* out, void* scratch_int, void* scratch_rec,
                              int N, int K, int M, int B1, int B2, int uer,
                              void* stream) {
  return launch_gathered<float>(P, C, rows, prm, mm, rf, out, scratch_int,
                                scratch_rec, N, K, M, B1, B2, uer, stream);
}

int append_pairs_gathered_f64(const void* P, const void* C, const void* rows,
                              const void* prm, const void* mm, const void* rf,
                              void* out, void* scratch_int, void* scratch_rec,
                              int N, int K, int M, int B1, int B2, int uer,
                              void* stream) {
  return launch_gathered<double>(P, C, rows, prm, mm, rf, out, scratch_int,
                                 scratch_rec, N, K, M, B1, B2, uer, stream);
}

const char* maple_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
