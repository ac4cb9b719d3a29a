// Native genome-list kernel library.
//
// C++ twin of maple_tpu/core/kernels.py + genomelist.py: the exact sparse
// partial-likelihood kernels over run-length genome lists (two-pointer
// merges with the {R,N,O,nuc}^2 case matrix), written for bit-identical
// IEEE-double results with the Python host kernels (which are themselves
// bit-identical to the reference implementation).  See
// maple_tpu/native/bridge.py for the ctypes binding.
//
// Exactness notes:
//  - all arithmetic is plain double in the same order as the Python code;
//  - 4-vector normalization sums use Neumaier compensation to match
//    CPython 3.12's builtin sum() (see neumaier_sum4);
//  - entry tuple layouts are encoded in per-entry presence bits so that
//    exported tuples reproduce the reference's variable-length layouts.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <functional>
#include <vector>
#include <limits>
#include <algorithm>
#include <unordered_map>
#include <unordered_set>
#include <memory>
#include <atomic>
#include <thread>
#include <mutex>
#include <condition_variable>
#include <chrono>
#include <cstdio>

namespace {

constexpr int TYPE_R = 4;
constexpr int TYPE_N = 5;
constexpr int TYPE_O = 6;

constexpr uint8_t BIT_BL1 = 1;
constexpr uint8_t BIT_BL2 = 2;
constexpr uint8_t BIT_FLAG = 4;   // the error-model tip flag VALUE

// O-entry payload, stored out of line so the common R/N/nuc entries are
// 32 bytes (the round-4 counters blamed the 64-byte inline-probs layout
// for the memory-bound placement crawl and recompute: every two-pointer
// scan dragged 4 doubles of O-probs through the cache for every entry,
// O or not).  `tag` is the alias-tag id of the shared Python probability
// list these probs mirror, or -1.  The reference shares ONE mutable list
// per tip ambiguity (:3959) and passthrough merge branches keep
// referencing it, so error-model refreshes change cached vectors in
// place; tags let store_patch_tag reproduce that (see tag_registry).
// Blocks are owned (deep-copied with the entry): aliasing semantics are
// emulated via the registry exactly as with the old inline layout.
struct Prob {
    double p[4];
    std::atomic<int32_t> rc;
    int32_t tag;
};

// Prob-block allocator: chunks live in a process-global reservoir (so a
// block outlives the thread that allocated it — engine worker threads
// die at engine_free while their vectors transfer back to the session),
// freelists are thread-local with batched global spill/refill (the
// slot-cache pattern above).  Entry copies don't allocate at all — they
// share the block via refcount (see Entry) — so this path only serves
// freshly-computed O entries (make_O / store_write).
struct ProbGlobal {
    std::mutex mu;
    std::vector<std::unique_ptr<Prob[]>> chunks;
    std::vector<Prob *> free_items;
};
inline ProbGlobal &prob_global() {
    static ProbGlobal *g = new ProbGlobal;  // immortal: outlives TLS dtors
    return *g;
}
struct ProbFreeList {
    std::vector<Prob *> items;
    ~ProbFreeList() {
        ProbGlobal &g = prob_global();
        std::lock_guard<std::mutex> lk(g.mu);
        g.free_items.insert(g.free_items.end(), items.begin(),
                            items.end());
    }
};
inline std::vector<Prob *> &prob_tl() {
    static thread_local ProbFreeList f;
    return f.items;
}
inline Prob *prob_new() {
    std::vector<Prob *> &f = prob_tl();
    if (f.empty()) {
        ProbGlobal &g = prob_global();
        std::lock_guard<std::mutex> lk(g.mu);
        if (g.free_items.size() >= 512) {
            f.insert(f.end(), g.free_items.end() - 512,
                     g.free_items.end());
            g.free_items.resize(g.free_items.size() - 512);
        } else {
            constexpr size_t N = 4096;
            g.chunks.emplace_back(new Prob[N]);
            Prob *base = g.chunks.back().get();
            for (size_t i = 0; i < N; i++) f.push_back(base + i);
        }
    }
    Prob *p = f.back();
    f.pop_back();
    return p;
}
inline void prob_del(Prob *p) {
    std::vector<Prob *> &f = prob_tl();
    f.push_back(p);
    if (f.size() > 16384) {  // spill half back to the reservoir
        ProbGlobal &g = prob_global();
        std::lock_guard<std::mutex> lk(g.mu);
        g.free_items.insert(g.free_items.end(), f.begin() + 8192,
                            f.end());
        f.resize(8192);
    }
}

struct Entry {
    int8_t type;
    uint8_t bits;
    int16_t _pad;
    int32_t val;      // end position (R/N) or local-ref nucleotide (nuc/O)
    double bl1;
    double bl2;
    Prob *pp;         // O entries only (else null); refcount-shared

    Entry() : type(0), bits(0), _pad(0), val(0), bl1(0), bl2(0),
              pp(nullptr) {}
    Entry(const Entry &o)
        : type(o.type), bits(o.bits), _pad(0), val(o.val), bl1(o.bl1),
          bl2(o.bl2), pp(o.pp) {
        if (pp) pp->rc.fetch_add(1, std::memory_order_relaxed);
    }
    Entry(Entry &&o) noexcept
        : type(o.type), bits(o.bits), _pad(0), val(o.val), bl1(o.bl1),
          bl2(o.bl2), pp(o.pp) { o.pp = nullptr; }
    Entry &operator=(const Entry &o) {
        if (this == &o) return *this;
        type = o.type; bits = o.bits; val = o.val;
        bl1 = o.bl1; bl2 = o.bl2;
        Prob *np = o.pp;
        if (np) np->rc.fetch_add(1, std::memory_order_relaxed);
        release();
        pp = np;
        return *this;
    }
    Entry &operator=(Entry &&o) noexcept {
        if (this == &o) return *this;
        type = o.type; bits = o.bits; val = o.val;
        bl1 = o.bl1; bl2 = o.bl2;
        release();
        pp = o.pp;
        o.pp = nullptr;
        return *this;
    }
    ~Entry() { release(); }

    void release() {
        if (pp && pp->rc.fetch_sub(1, std::memory_order_acq_rel) == 1)
            prob_del(pp);
        pp = nullptr;
    }

    bool has_bl1() const { return bits & BIT_BL1; }
    bool has_bl2() const { return bits & BIT_BL2; }
    bool flag() const { return bits & BIT_FLAG; }
    int32_t etag() const { return pp ? pp->tag : -1; }
};
static_assert(sizeof(Entry) == 32, "hot-entry layout is two per line");

inline Prob *prob_new1() {  // fresh block with rc=1
    Prob *p = prob_new();
    p->rc.store(1, std::memory_order_relaxed);
    p->tag = -1;
    return p;
}

using Vec = std::vector<Entry>;

// Dev-only phase profiling (build with -DMAPLE_PROFILE): rdtsc cycle
// counters around the placement engine's phases, exported via
// engine_profile().  Zero overhead in normal builds.
#ifdef MAPLE_PROFILE
static inline uint64_t prof_now() {
    unsigned lo, hi;
    __asm__ __volatile__("rdtsc" : "=a"(lo), "=d"(hi));
    return ((uint64_t)hi << 32) | lo;
}
#define PROF_T(var) uint64_t var = prof_now()
#define PROF_ADD(acc, t0) (acc) += prof_now() - (t0)
#else
#define PROF_T(var)
#define PROF_ADD(acc, t0)
#endif

// EM accumulator state (reference expectationMaximizationCalculationRates
// :10077-10947; Python twin maple_tpu/models/em.py).  One per Store; the
// host drives the tree traversal and calls em_branch per branch, keeping
// Python-float-op order for byte parity.  Estimators stay host-side.
struct EMState {
    bool rate_var = false, uer = false, site_err = false;
    double counts[4][4] = {};
    double waiting_times[4] = {0, 0, 0, 0};
    double error_count = 0.0;
    double observed_tot = 0.0;   // leaf-N corrections; host adds lRef*nTips
    double tot_tree_length = 0.0;
    std::vector<double> wts;        // waiting_times_sites, lRef*4
    std::vector<double> cs;         // counts_sites, lRef
    std::vector<double> tns;        // tracking_ns, lRef+1
    std::vector<double> obs_sites;  // observed_sites, lRef+1
    std::vector<double> err_sites;  // error_count_sites, lRef
};

struct Store {
    int lRef = 0;
    // reference tables
    std::vector<int8_t> ref_indices;
    double root_freqs[4] = {0, 0, 0, 0};
    double root_freqs_log[4] = {0, 0, 0, 0};
    std::vector<int32_t> cumulative_bases;  // (lRef+1)*4
    // model state
    double mut[4][4] = {};
    std::vector<double> cumulative_rate;    // lRef+1
    bool use_rate_variation = false;
    std::vector<double> site_rates;         // lRef (scales mut per site)
    bool using_error_rate = false;
    bool site_err = false;
    double error_rate = 0.0;
    std::vector<double> error_rates;        // lRef
    std::vector<double> cumulative_error_rate;  // lRef+1
    double tot_error = 0.0;
    std::vector<double> rfle_cum;           // lRef+1
    // thresholds
    double threshold_prob = 1e-8;
    double threshold_prob4 = 1e-32;
    double min_carry = 0.0;
    double global_tot_rate = 0.0;
    double min_blen_sensitivity = 0.0;
    double threshold_diff_update = 1e-5;
    double threshold_fold_change = 1.01;
    // Vector slots (freelist + chunked stable storage).  Chunking keeps
    // Vec references valid while the placement scorer's worker threads
    // read vectors concurrently with main-thread allocations: chunks are
    // never moved, and the chunk table itself is reserved once in
    // store_create so push_back never reallocates it.
    static constexpr int VCHUNK_BITS = 12;
    static constexpr size_t VCHUNK = (size_t)1 << VCHUNK_BITS;
    std::vector<std::unique_ptr<Vec[]>> vec_chunks;
    size_t vec_count = 0;
    std::vector<int64_t> free_slots;

    // Alias-tag registry: tag -> (vid, idx) refs of tagged entries.
    // Patching by tag is self-correcting — writing the shared list's
    // current values into any entry carrying that tag is always right —
    // so refs may be stale (freed/recycled vids, shifted indices after
    // shorten); validation is just bounds + tag match, and failed refs
    // are dropped lazily during patching.
    std::unordered_map<int32_t,
                       std::vector<std::pair<int64_t, int32_t>>> tag_registry;
    bool tags_active = false;

    void finish(int64_t id) {
        if (!tags_active) return;
        const Vec &vv = v(id);
        for (int32_t i = 0; i < (int32_t)vv.size(); i++)
            if (vv[i].pp && vv[i].pp->tag >= 0)
                tag_registry[vv[i].pp->tag].emplace_back(id, i);
    }

    // Slot allocation/recycling is guarded so the parallel SPR proposal
    // workers can allocate temporaries concurrently (the chunk table is
    // reserved once at store creation, so v(id) reads of existing slots
    // never move; ~20 ns uncontended lock vs ~1 us per merge).
    std::mutex slot_mu;
    // MAPLE_DEBUG_SLOTS: duplicate-free / free-while-live detector
    std::unordered_set<int64_t> dbg_free_set;
    bool dbg_slots = getenv("MAPLE_DEBUG_SLOTS") != nullptr;
    int64_t dbg_guard = getenv("MAPLE_DEBUG_GUARD")
        ? atoll(getenv("MAPLE_DEBUG_GUARD")) : -1;

    // Thread-local slot cache (SlotCacheScope): worker threads in the
    // phase-parallel paths (full-tree recomputes, batched placement
    // phase A, parallel SPR proposals) allocate/free a store vector
    // every few microseconds, and the global slot_mu serialized them —
    // measured as the difference between 1.6x and near-linear scaling
    // of the 100k recompute.  With a scope installed, recycling runs
    // lock-free against a per-thread free list that refills/spills from
    // the global list in batches of 64.  Disabled under the
    // MAPLE_DEBUG_SLOTS tracker (its free-set bookkeeping is global).
    static thread_local std::vector<int64_t> *tl_slot_cache;

    int64_t alloc() {
        std::vector<int64_t> *c = tl_slot_cache;
        if (c) {
            if (c->empty()) {
                std::lock_guard<std::mutex> g(slot_mu);
                int take = (int)std::min<size_t>(64, free_slots.size());
                for (int i = 0; i < take; i++) {
                    c->push_back(free_slots.back());
                    free_slots.pop_back();
                }
                while (c->size() < 64) {
                    if (vec_count == vec_chunks.size() * VCHUNK) {
                        if (vec_chunks.size() == vec_chunks.capacity())
                            vec_chunks.reserve(
                                vec_chunks.capacity() * 2 + 1024);
                        vec_chunks.emplace_back(new Vec[VCHUNK]);
                    }
                    c->push_back((int64_t)vec_count++);
                }
            }
            int64_t id = c->back();
            c->pop_back();
            v(id).clear();
            return id;
        }
        std::lock_guard<std::mutex> g(slot_mu);
        if (!free_slots.empty()) {
            int64_t id = free_slots.back();
            free_slots.pop_back();
            if (dbg_slots) {
                dbg_free_set.erase(id);
                if (id == dbg_guard)
                    std::fprintf(stderr, "GUARD alloc %lld\n",
                                 (long long)id);
            }
            v(id).clear();
            return id;
        }
        if (vec_count == vec_chunks.size() * VCHUNK) {
            if (vec_chunks.size() == vec_chunks.capacity())
                vec_chunks.reserve(vec_chunks.capacity() * 2 + 1024);
            vec_chunks.emplace_back(new Vec[VCHUNK]);
        }
        return (int64_t)vec_count++;
    }

    // clear + recycle one slot (lock-guarded counterpart of alloc)
    void free_slot(int64_t id) {
        v(id).clear();
        std::vector<int64_t> *c = tl_slot_cache;
        if (c) {
            if (c->size() >= 1024) {  // spill half back to the pool
                std::lock_guard<std::mutex> g(slot_mu);
                free_slots.insert(free_slots.end(), c->begin() + 512,
                                  c->end());
                c->resize(512);
            }
            c->push_back(id);
            return;
        }
        std::lock_guard<std::mutex> g(slot_mu);
        dbg_check_free(id);
        free_slots.push_back(id);
    }
    void dbg_check_free(int64_t id) {
        if (!dbg_slots) return;
        if (id == dbg_guard)
            std::fprintf(stderr, "GUARD free %lld\n", (long long)id);
        if (!dbg_free_set.insert(id).second) {
            std::fprintf(stderr, "DOUBLE FREE slot %lld\n", (long long)id);
            std::abort();
        }
    }
    Vec &v(int64_t id) {
        return vec_chunks[id >> VCHUNK_BITS][id & (VCHUNK - 1)];
    }

    EMState em_state;

    // per-site matrix entry: mut[i][j] * site_rate
    inline double mm(int pos, int i, int j) const {
        if (use_rate_variation) return mut[i][j] * site_rates[pos];
        return mut[i][j];
    }
    inline double eps_at(int pos) const {
        return site_err ? error_rates[pos] : error_rate;
    }
};

thread_local std::vector<int64_t> *Store::tl_slot_cache = nullptr;

// RAII installer for the thread-local slot cache (Store::tl_slot_cache
// doc above): worker threads in phase-parallel paths wrap their work in
// one of these; leftover cached ids spill back to the global pool on
// scope exit.  No-op under the MAPLE_DEBUG_SLOTS tracker.
struct SlotCacheScope {
    Store *s;
    std::vector<int64_t> cache;
    bool on;
    explicit SlotCacheScope(Store *st) : s(st), on(!st->dbg_slots) {
        if (on) Store::tl_slot_cache = &cache;
    }
    ~SlotCacheScope() {
        if (!on) return;
        Store::tl_slot_cache = nullptr;
        if (!cache.empty()) {
            std::lock_guard<std::mutex> g(s->slot_mu);
            s->free_slots.insert(s->free_slots.end(), cache.begin(),
                                 cache.end());
        }
    }
};

const double DBL_MIN_POS = std::numeric_limits<double>::min();

static inline void prefetch_entries(const Vec &v) {
    // The two-pointer walk's loads are branch-dependent on loaded data,
    // so out-of-order execution cannot overlap their cache misses.
    // Issuing all line prefetches up front restores full memory-level
    // parallelism; the walk then runs on (nearly) resident lines.
    const char *p = (const char *)v.data();
    const char *end = p + v.size() * sizeof(Entry);
    if (end - p > 64 * 96) end = p + 64 * 96;
    for (; p < end; p += 64) __builtin_prefetch(p, 0, 3);
}


// CPython 3.12 builtin sum() float fast path (Neumaier compensation).
inline double neumaier_sum4(const double *x) {
    double total = 0.0, c = 0.0;
    for (int i = 0; i < 4; i++) {
        double t = total + x[i];
        if (std::fabs(total) >= std::fabs(x[i]))
            c += (total - t) + x[i];
        else
            c += (x[i] - t) + total;
        total = t;
    }
    return total + c;
}

// ---------------------------------------------------------------- helpers

// getPartialVec (reference :4073-4141): first-order evolution of a one-site
// likelihood 4-vector.  mm is indexed at `pos` through the store.
inline void partial_vec_O(const Store &S, int pos, double tot_len,
                          const double *vect, bool up_node, double *out) {
    if (tot_len == 0.0) {
        for (int i = 0; i < 4; i++) out[i] = vect[i];
        return;
    }
    if (up_node) {
        for (int i = 0; i < 4; i++) {
            double tot = (S.mm(pos, 0, i) * vect[0] + S.mm(pos, 1, i) * vect[1]
                          + S.mm(pos, 2, i) * vect[2]
                          + S.mm(pos, 3, i) * vect[3]) * tot_len + vect[i];
            if (tot < 0) {
                out[0] = out[1] = out[2] = out[3] = 0.25;
                return;
            }
            out[i] = tot;
        }
    } else {
        for (int i = 0; i < 4; i++) {
            double tot = (S.mm(pos, i, 0) * vect[0] + S.mm(pos, i, 1) * vect[1]
                          + S.mm(pos, i, 2) * vect[2]
                          + S.mm(pos, i, 3) * vect[3]) * tot_len + vect[i];
            if (tot < 0) {
                out[0] = out[1] = out[2] = out[3] = 0.25;
                return;
            }
            out[i] = tot;
        }
    }
}

inline void partial_vec_nuc(const Store &S, int pos, int i12, double tot_len,
                            double eps, bool flag, bool up_node,
                            double *out) {
    if (flag) {
        double base[4] = {eps * 0.33333, eps * 0.33333, eps * 0.33333,
                          eps * 0.33333};
        base[i12] = 1.0 - eps;
        if (tot_len == 0.0) {
            for (int i = 0; i < 4; i++) out[i] = base[i];
            return;
        }
        for (int j = 0; j < 4; j++) {
            double tot = (S.mm(pos, j, 0) * base[0] + S.mm(pos, j, 1) * base[1]
                          + S.mm(pos, j, 2) * base[2]
                          + S.mm(pos, j, 3) * base[3]) * tot_len + base[j];
            if (tot < 0) {
                out[0] = out[1] = out[2] = out[3] = 0.25;
                return;
            }
            out[j] = tot;
        }
        return;
    }
    if (tot_len == 0.0) {
        out[0] = out[1] = out[2] = out[3] = 0.0;
        out[i12] = 1.0;
        return;
    }
    if (up_node) {
        for (int i = 0; i < 4; i++) out[i] = S.mm(pos, i12, i) * tot_len;
    } else {
        for (int i = 0; i < 4; i++) out[i] = S.mm(pos, i, i12) * tot_len;
    }
    out[i12] += 1.0;
    if (out[i12] < 0) {
        out[0] = out[1] = out[2] = out[3] = 0.25;
    }
}

// simplify (reference :3697-3717)
inline int simplify4(const Store &S, const double *vec, int ref_nuc) {
    double max_p = 0.0;
    int max_i = 0, num_above = 0;
    for (int i = 0; i < 4; i++) {
        if (vec[i] > max_p) { max_p = vec[i]; max_i = i; }
        if (vec[i] > S.threshold_prob) num_above++;
    }
    if (max_p < S.threshold_prob4) return -1;  // degenerate - caller raises
    if (num_above == 1) return max_i == ref_nuc ? TYPE_R : max_i;
    return TYPE_O;
}

inline Entry make_nuc(int type, int32_t val, uint8_t bits, double bl1,
                      double bl2) {
    Entry e{};
    e.type = (int8_t)type;
    e.val = val;
    e.bits = bits;
    e.bl1 = bl1;
    e.bl2 = bl2;
    return e;
}

inline Entry make_O(int32_t val, bool has_bl, double bl, const double *probs,
                    int32_t tag = -1) {
    // `tag` is passed only where the Python kernels REUSE the input
    // entry's probability list (aliasing); computed outputs stay -1
    Entry e{};
    e.type = TYPE_O;
    e.val = val;
    e.bits = has_bl ? BIT_BL1 : 0;
    e.bl1 = bl;
    e.pp = prob_new1();
    for (int i = 0; i < 4; i++) e.pp->p[i] = probs[i];
    e.pp->tag = tag;
    return e;
}

// effective python tuple length of an entry (for layout-sensitive rules)
inline int tuple_len(const Store &S, const Entry &e) {
    if (e.type == TYPE_N) return 2;
    if (e.type == TYPE_O) return e.has_bl1() ? 4 : 3;
    int n = 2;
    if (e.has_bl1()) n += 1;
    if (e.has_bl2()) n += 1;
    if (S.using_error_rate && e.has_bl1()) n += 1;  // flag accompanies bl1
    return n;
}

// shorten (reference :3721-3745): merge adjacent compatible R runs.
void shorten_vec(const Store &S, Vec &v) {
    size_t i = 0;
    while (i + 1 < v.size()) {
        const Entry &prev = v[i];
        const Entry &cur = v[i + 1];
        if (cur.type == TYPE_R && prev.type == TYPE_R
                && tuple_len(S, cur) == tuple_len(S, prev)) {
            int n = tuple_len(S, cur);
            bool merge = false;
            if (n == 2) merge = true;
            else if (std::fabs(cur.bl1 - prev.bl1) > S.threshold_prob) {
                i++; continue;
            } else if (n == 3) merge = true;
            else if (!cur.has_bl2()) {
                // n==4 with uer: (c,v,bl1,flag) - compare flags
                if (cur.flag() == prev.flag()) merge = true;
            } else if (std::fabs(cur.bl2 - prev.bl2) > S.threshold_prob) {
                i++; continue;
            } else if (n == 4) merge = true;
            else if (cur.flag() == prev.flag()) merge = true;
            if (merge) {
                v.erase(v.begin() + i);
                continue;
            }
        }
        i++;
    }
}

// ------------------------------------------------------- emission helpers
// Survivor-entry emissions for one-side-N merge cases (see Python
// _emit_survivor_lower / _emit_survivor_upper, reference :4501-4643).

void emit_survivor_lower(const Store &S, Vec &out, const Entry &e,
                         int32_t new_el, double blen, bool from_tip,
                         bool is_up_down) {
    bool uer = S.using_error_rate;
    if (is_up_down) {
        if (uer) {
            if (!e.has_bl1()) {
                if (blen != 0.0 || from_tip)
                    out.push_back(make_nuc(e.type, new_el,
                                           BIT_BL1 | BIT_BL2
                                           | (from_tip ? BIT_FLAG : 0),
                                           blen, 0.0));
                else
                    out.push_back(make_nuc(e.type, new_el, 0, 0, 0));
            } else {
                out.push_back(make_nuc(e.type, new_el,
                                       BIT_BL1 | BIT_BL2
                                       | (e.flag() ? BIT_FLAG : 0),
                                       e.bl1 + blen, 0.0));
            }
        } else {
            if (e.has_bl1())
                out.push_back(make_nuc(e.type, new_el, BIT_BL1 | BIT_BL2,
                                       e.bl1 + blen, 0.0));
            else if (blen != 0.0)
                out.push_back(make_nuc(e.type, new_el, BIT_BL1 | BIT_BL2,
                                       blen, 0.0));
            else
                out.push_back(make_nuc(e.type, new_el, 0, 0, 0));
        }
    } else {
        if (uer) {
            if (!e.has_bl1()) {
                if (blen != 0.0 || from_tip)
                    out.push_back(make_nuc(e.type, new_el,
                                           BIT_BL1
                                           | (from_tip ? BIT_FLAG : 0),
                                           blen, 0.0));
                else
                    out.push_back(make_nuc(e.type, new_el, 0, 0, 0));
            } else {
                out.push_back(make_nuc(e.type, new_el,
                                       BIT_BL1 | (e.flag() ? BIT_FLAG : 0),
                                       e.bl1 + blen, 0.0));
            }
        } else {
            if (e.has_bl1())
                out.push_back(make_nuc(e.type, new_el, BIT_BL1,
                                       e.bl1 + blen, 0.0));
            else if (blen != 0.0)
                out.push_back(make_nuc(e.type, new_el, BIT_BL1, blen, 0.0));
            else
                out.push_back(make_nuc(e.type, new_el, 0, 0, 0));
        }
    }
}

void emit_survivor_upper(const Store &S, Vec &out, const Entry &e,
                         int32_t new_el, double blen, bool from_tip,
                         bool is_up_down) {
    bool uer = S.using_error_rate;
    if (is_up_down) {
        if (uer) {
            if (!e.has_bl1()) {
                if (blen != 0.0)
                    out.push_back(make_nuc(e.type, new_el, BIT_BL1, blen,
                                           0.0));
                else
                    out.push_back(make_nuc(e.type, new_el, 0, 0, 0));
            } else if (!e.has_bl2()) {
                out.push_back(make_nuc(e.type, new_el,
                                       BIT_BL1 | (e.flag() ? BIT_FLAG : 0),
                                       e.bl1 + blen, 0.0));
            } else {
                out.push_back(make_nuc(e.type, new_el,
                                       BIT_BL1 | BIT_BL2
                                       | (e.flag() ? BIT_FLAG : 0),
                                       e.bl1, e.bl2 + blen));
            }
        } else {
            if (!e.has_bl1()) {
                if (blen != 0.0)
                    out.push_back(make_nuc(e.type, new_el, BIT_BL1, blen,
                                           0.0));
                else
                    out.push_back(make_nuc(e.type, new_el, 0, 0, 0));
            } else if (!e.has_bl2()) {
                out.push_back(make_nuc(e.type, new_el, BIT_BL1,
                                       e.bl1 + blen, 0.0));
            } else {
                out.push_back(make_nuc(e.type, new_el, BIT_BL1 | BIT_BL2,
                                       e.bl1, e.bl2 + blen));
            }
        }
    } else {
        if (uer) {
            if (!e.has_bl1()) {
                if (blen != 0.0 || from_tip)
                    out.push_back(make_nuc(e.type, new_el,
                                           BIT_BL1
                                           | (from_tip ? BIT_FLAG : 0),
                                           blen, 0.0));
                else
                    out.push_back(make_nuc(e.type, new_el, 0, 0, 0));
            } else {
                out.push_back(make_nuc(e.type, new_el,
                                       BIT_BL1 | (e.flag() ? BIT_FLAG : 0),
                                       e.bl1 + blen, 0.0));
            }
        } else {
            if (e.has_bl1())
                out.push_back(make_nuc(e.type, new_el, BIT_BL1,
                                       e.bl1 + blen, 0.0));
            else if (blen != 0.0)
                out.push_back(make_nuc(e.type, new_el, BIT_BL1, blen, 0.0));
            else
                out.push_back(make_nuc(e.type, new_el, 0, 0, 0));
        }
    }
}

// ------------------------------------------------------------ mergeVectors
// (reference :4446-4859; Python merge_vectors).  Returns 0 on success,
// -1 for the impossible 0-length merge, -2 for LK underflow.
int merge_vectors(Store &S, const Vec &v1, double bl1, bool tip1,
                  const Vec &v2, double bl2, bool tip2, bool return_lk,
                  bool is_up_down, int n_minor1, int n_minor2, Vec &out,
                  double *lk_out) {
    prefetch_entries(v1);
    prefetch_entries(v2);
    const bool uer = S.using_error_rate;
    double lk = 0.0;
    if (return_lk) {
        lk = (bl1 + bl2) * S.global_tot_rate;
        if (uer) {
            if (tip1 || n_minor1) lk += S.tot_error * (1 + n_minor1);
            if (tip2 || n_minor2) lk += S.tot_error * (1 + n_minor2);
        }
    }
    size_t i1 = 0, i2 = 0;
    int pos = 0;
    double tot_factor = 1.0;
    out.clear();
    const Entry *e1 = &v1[0];
    const Entry *e2 = &v2[0];
    while (true) {
        int c1 = e1->type, c2 = e2->type;
        int new_pos;
        if (c1 == TYPE_N) {
            if (c2 == TYPE_N) {
                new_pos = std::min(e1->val, e2->val);
                Entry e{};
                e.type = TYPE_N;
                e.val = new_pos;
                out.push_back(e);
            } else if (c2 < TYPE_R) {
                new_pos = pos + 1;
                emit_survivor_lower(S, out, *e2, e2->val, bl2, tip2,
                                    is_up_down);
            } else if (c2 == TYPE_R) {
                new_pos = std::min(e1->val, e2->val);
                emit_survivor_lower(S, out, *e2, new_pos, bl2, tip2,
                                    is_up_down);
            } else {  // O survives vs N
                new_pos = pos + 1;
                if (is_up_down) {
                    double tot_b = bl2 + (e2->has_bl1() ? e2->bl1 : 0.0);
                    double nv[4];
                    partial_vec_O(S, pos, tot_b, e2->pp->p, false, nv);
                    for (int i = 0; i < 4; i++) nv[i] *= S.root_freqs[i];
                    double s = neumaier_sum4(nv);
                    for (int i = 0; i < 4; i++) nv[i] /= s;
                    out.push_back(make_O(e2->val, false, 0.0, nv));
                } else {
                    if (e2->has_bl1())
                        out.push_back(make_O(e2->val, true, e2->bl1 + bl2,
                                             e2->pp->p, e2->etag()));
                    else if (bl2 != 0.0)
                        out.push_back(make_O(e2->val, true, bl2, e2->pp->p,
                                             e2->etag()));
                    else
                        out.push_back(*e2);
                }
            }
            if (return_lk) {
                lk += (bl1 + bl2)
                      * (S.cumulative_rate[pos] - S.cumulative_rate[new_pos]);
                if (uer && (tip1 || tip2)) {
                    double ce = S.site_err
                        ? (S.cumulative_error_rate[new_pos]
                           - S.cumulative_error_rate[pos])
                        : S.error_rate * (new_pos - pos);
                    if (tip1) lk += ce;
                    if (tip2) lk += ce;
                }
            }
            pos = new_pos;
        } else if (c2 == TYPE_N) {
            if (c1 < TYPE_N) {
                int32_t new_el;
                if (c1 < TYPE_R) {
                    new_pos = pos + 1;
                    new_el = e1->val;
                } else {
                    new_pos = std::min(e1->val, e2->val);
                    new_el = new_pos;
                }
                emit_survivor_upper(S, out, *e1, new_el, bl1, tip1,
                                    is_up_down);
            } else {  // O survives vs N
                new_pos = pos + 1;
                bool evolve = is_up_down
                    && ((tuple_len(S, *e1) == 4 && e1->bl1 > 0)
                        || bl1 != 0.0);
                if (evolve) {
                    double tot_b = bl1 + (e1->has_bl1() ? e1->bl1 : 0.0);
                    double nv[4];
                    partial_vec_O(S, pos, tot_b, e1->pp->p, true, nv);
                    double s = neumaier_sum4(nv);
                    for (int i = 0; i < 4; i++) nv[i] /= s;
                    out.push_back(make_O(e1->val, false, 0.0, nv));
                } else {
                    if (e1->has_bl1())
                        out.push_back(make_O(e1->val, true, e1->bl1 + bl1,
                                             e1->pp->p, e1->etag()));
                    else if (bl1 != 0.0)
                        out.push_back(make_O(e1->val, true, bl1, e1->pp->p,
                                             e1->etag()));
                    else
                        out.push_back(*e1);
                }
            }
            if (return_lk) {
                lk += (bl1 + bl2)
                      * (S.cumulative_rate[pos] - S.cumulative_rate[new_pos]);
                if (uer && (tip1 || tip2)) {
                    double ce = S.site_err
                        ? (S.cumulative_error_rate[new_pos]
                           - S.cumulative_error_rate[pos])
                        : S.error_rate * (new_pos - pos);
                    if (tip1) lk += ce;
                    if (tip2) lk += ce;
                }
            }
            pos = new_pos;
        } else {
            // both sides informative
            double tot_len1 = bl1;
            int len1 = tuple_len(S, *e1);
            if (c1 == TYPE_O) {
                if (e1->has_bl1()) tot_len1 += e1->bl1;
            } else {
                if (len1 > 2 + (uer ? 1 : 0)) {
                    tot_len1 += e1->bl1;
                    if (len1 > 3 + (uer ? 1 : 0)) tot_len1 += e1->bl2;
                }
            }
            double tot_len2 = bl2;
            int len2 = tuple_len(S, *e2);
            if (len2 > 2 + ((uer || c2 == TYPE_O) ? 1 : 0))
                tot_len2 += e2->bl1;
            bool flag1 = uer && c1 != TYPE_O
                         && ((len1 > 2 && e1->flag()) || tip1);
            bool flag2 = uer && c2 != TYPE_O
                         && ((len2 > 2 && e2->flag()) || tip2);
            if (c1 == TYPE_R && c2 == TYPE_R)
                new_pos = std::min(e1->val, e2->val);
            else
                new_pos = pos + 1;

            if (return_lk) {
                if (c1 == TYPE_R && c2 == TYPE_R) {
                    if (tot_len2 > bl2 || tot_len1 > bl1) {
                        lk += (tot_len2 - bl2 + tot_len1 - bl1)
                              * (S.cumulative_rate[new_pos]
                                 - S.cumulative_rate[pos]);
                        if (uer && ((!tip1 && flag1) || (!tip2 && flag2))) {
                            double ce = S.site_err
                                ? (S.cumulative_error_rate[pos]
                                   - S.cumulative_error_rate[new_pos])
                                : S.error_rate * (pos - new_pos);
                            if (!tip1 && flag1) lk += ce;
                            if (!tip2 && flag2) lk += ce;
                        }
                    }
                } else {
                    int ref_nuc = (c1 != TYPE_R) ? e1->val : e2->val;
                    lk -= S.mm(pos, ref_nuc, ref_nuc) * (bl2 + bl1);
                    if (uer && ((c1 != c2) || c1 == TYPE_O)
                            && (tip1 || tip2)) {
                        double ce = S.eps_at(pos);
                        if (tip1) lk += ce;
                        if (tip2) lk += ce;
                    }
                }
            }

            if (c2 == c1 && c2 < TYPE_N) {
                if (c1 == TYPE_R) {
                    Entry e{};
                    e.type = TYPE_R;
                    e.val = new_pos;
                    out.push_back(e);
                } else {
                    out.push_back(make_nuc(c1, e1->val, 0, 0, 0));
                    if (return_lk) {
                        lk += S.mm(pos, c1, c1) * (tot_len1 + tot_len2);
                        if (uer && ((!tip1 && flag1) || (!tip2 && flag2))) {
                            double ce = S.eps_at(pos);
                            if (!tip1 && flag1) lk -= ce;
                            if (!tip2 && flag2) lk -= ce;
                        }
                    }
                }
            } else if (tot_len1 == 0.0 && tot_len2 == 0.0 && c1 < TYPE_N
                       && c2 < TYPE_N && !flag1 && !flag2) {
                return -1;  // impossible merge
            } else {
                double eps = uer ? S.eps_at(pos) : S.error_rate;
                int ref_nuc, i1n;
                if (c1 == TYPE_R) {
                    ref_nuc = e2->val;
                    i1n = ref_nuc;
                } else {
                    ref_nuc = e1->val;
                    i1n = c1;
                }
                double nv[4];
                if (i1n <= 4) {
                    if (tot_len1 != 0.0 || flag1) {
                        if (is_up_down && len1 > 3 + (uer ? 1 : 0)) {
                            partial_vec_nuc(S, pos, i1n, e1->bl1, eps, flag1,
                                            false, nv);
                            for (int i = 0; i < 4; i++)
                                nv[i] *= S.root_freqs[i];
                            if (e1->bl2 + bl1 != 0.0) {
                                double tmp[4];
                                partial_vec_O(S, pos, e1->bl2 + bl1, nv,
                                              true, tmp);
                                for (int i = 0; i < 4; i++) nv[i] = tmp[i];
                            }
                        } else {
                            partial_vec_nuc(S, pos, i1n, tot_len1, eps,
                                            flag1, is_up_down, nv);
                        }
                    } else {
                        nv[0] = nv[1] = nv[2] = nv[3] = 0.0;
                        nv[i1n] = 1.0;
                    }
                } else {  // c1 is O
                    if (tot_len1 != 0.0)
                        partial_vec_O(S, pos, tot_len1, e1->pp->p, is_up_down,
                                      nv);
                    else
                        for (int i = 0; i < 4; i++) nv[i] = e1->pp->p[i];
                }
                int i2n = (c2 == TYPE_R) ? ref_nuc : c2;
                double nv2[4];
                if (i2n == TYPE_O) {
                    if (tot_len2 != 0.0)
                        partial_vec_O(S, pos, tot_len2, e2->pp->p, false,
                                      nv2);
                    else
                        for (int i = 0; i < 4; i++) nv2[i] = e2->pp->p[i];
                } else {
                    if (tot_len2 != 0.0 || flag2) {
                        partial_vec_nuc(S, pos, i2n, tot_len2, eps, flag2,
                                        false, nv2);
                    } else {
                        nv2[0] = nv2[1] = nv2[2] = nv2[3] = 0.0;
                        nv2[i2n] = 1.0;
                    }
                }
                for (int i = 0; i < 4; i++) nv[i] *= nv2[i];
                double s = neumaier_sum4(nv);
                if (s == 0.0) {
                    return return_lk ? -2 : -1;
                }
                for (int i = 0; i < 4; i++) nv[i] /= s;
                int state = simplify4(S, nv, ref_nuc);
                if (state < 0) return -3;
                if (state == TYPE_O)
                    out.push_back(make_O(ref_nuc, false, 0.0, nv));
                else if (state == TYPE_R) {
                    Entry e{};
                    e.type = TYPE_R;
                    e.val = new_pos;
                    out.push_back(e);
                } else
                    out.push_back(make_nuc(state, ref_nuc, 0, 0, 0));
                if (return_lk) tot_factor *= s;
            }
            pos = new_pos;
        }

        if (return_lk && tot_factor <= S.min_carry) {
            if (tot_factor < DBL_MIN_POS) return -2;
            lk += std::log(tot_factor);
            tot_factor = 1.0;
        }
        if (pos == S.lRef) break;
        if (c1 < TYPE_R || c1 == TYPE_O) e1 = &v1[++i1];
        else if (pos == e1->val) e1 = &v1[++i1];
        if (c2 < TYPE_R || c2 == TYPE_O) e2 = &v2[++i2];
        else if (pos == e2->val) e2 = &v2[++i2];
    }
    if (return_lk) *lk_out = lk + std::log(tot_factor);
    return 0;
}

// --------------------------------------------------------- appendProbNode
// (reference :6505-6785; Python append_prob_node).  Templated on the
// error-rate flag so the placement-path instantiation (uer=false) strips
// every error-model branch at compile time.
template <bool UER>
static double append_prob_node_t(const Store &S, const Vec &vP,
                                 const Vec &vC, bool tip_c, double blen) {
    constexpr bool uer = UER;
    constexpr int uer1 = uer ? 1 : 0;
    prefetch_entries(vP);
    prefetch_entries(vC);
    size_t i1 = 0, i2 = 0;
    double tot_factor = 1.0;
    int pos = 0;
    const Entry *e1 = &vP[0];
    const Entry *e2 = &vC[0];
    double lk = blen * S.global_tot_rate;
    if (uer && tip_c) lk += S.tot_error;
    const double NEG_INF = -std::numeric_limits<double>::infinity();
    while (true) {
        // fast path: R/N runs on both sides contribute nothing to the
        // likelihood — advance the cursors without touching state.
        // (cases c2==N and c1==N in the general loop below are pure
        // cursor moves for run-typed partners.)
        while ((unsigned)(e1->type - TYPE_R) <= 1u
               && (unsigned)(e2->type - TYPE_R) <= 1u) {
            int end1 = e1->val, end2 = e2->val;
            pos = end1 < end2 ? end1 : end2;
            if (pos == S.lRef) return lk + std::log(tot_factor);
            if (end1 == pos) e1 = &vP[++i1];
            if (end2 == pos) e2 = &vC[++i2];
        }
        int c1 = e1->type, c2 = e2->type;
        if (c2 == TYPE_N) {
            if (c1 == TYPE_R || c1 == TYPE_N) {
                pos = std::min(e1->val, e2->val);
                if (pos == S.lRef) break;
                if (e1->val == pos) e1 = &vP[++i1];
            } else {
                pos += 1;
                if (pos == S.lRef) break;
                e1 = &vP[++i1];
            }
            if (e2->val == pos) e2 = &vC[++i2];
        } else if (c1 == TYPE_N) {
            if (c2 == TYPE_R) {
                pos = std::min(e1->val, e2->val);
                if (pos == S.lRef) break;
                if (e2->val == pos) e2 = &vC[++i2];
            } else {
                pos += 1;
                if (pos == S.lRef) break;
                e2 = &vC[++i2];
            }
            if (e1->val == pos) e1 = &vP[++i1];
        } else {
            double contrib = blen;
            int len1 = tuple_len(S, *e1);
            int len2 = tuple_len(S, *e2);
            if (c1 != c2 || c1 == TYPE_O) {
                if (c1 < TYPE_N) {
                    if (len1 == 3 + uer1) contrib += e1->bl1;
                    else if (len1 == 4 + uer1) contrib += e1->bl2;
                } else if (len1 == 4) {
                    contrib += e1->bl1;
                }
                if (c2 < TYPE_N) {
                    if (len2 == 3 + uer1) contrib += e2->bl1;
                } else if (len2 == 4) {
                    contrib += e2->bl1;
                }
            }

            if (c1 == TYPE_R) {
                if (c2 == TYPE_R) {
                    pos = std::min(e1->val, e2->val);
                    if (pos == S.lRef) break;
                    if (e2->val == pos) e2 = &vC[++i2];
                } else if (c2 == TYPE_O) {
                    int i1n = e2->val;
                    if (e2->pp->p[i1n] > 0.02) {
                        tot_factor *= e2->pp->p[i1n];
                    } else if (len1 == 4 + uer1) {
                        bool flag1 = uer && len1 > 2 && e1->flag();
                        double eps = uer ? S.eps_at(pos) : S.error_rate;
                        double t3[4], t2[4];
                        partial_vec_O(S, pos, contrib, e2->pp->p, false, t3);
                        partial_vec_nuc(S, pos, i1n, e1->bl1, eps, flag1,
                                        false, t2);
                        double tot = 0.0;
                        for (int i = 0; i < 4; i++)
                            tot += t3[i] * t2[i] * S.root_freqs[i];
                        tot /= S.root_freqs[i1n];
                        tot_factor *= tot;
                    } else {
                        if (contrib != 0.0) {
                            double t3[4];
                            partial_vec_O(S, pos, contrib, e2->pp->p, false,
                                          t3);
                            tot_factor *= t3[i1n];
                        } else {
                            tot_factor *= e2->pp->p[i1n];
                        }
                    }
                    pos += 1;
                    if (pos == S.lRef) break;
                    e2 = &vC[++i2];
                } else {
                    bool flag2 = uer && (tip_c || (len2 > 2 && e2->flag()));
                    if (len1 == 4 + uer1) {
                        bool flag1 = uer && len1 > 2 && e1->flag();
                        int i1n = e2->val;
                        int i2n = c2;
                        double eps = uer ? S.eps_at(pos) : S.error_rate;
                        double t3[4], t2[4];
                        partial_vec_nuc(S, pos, i2n, contrib, eps, flag2,
                                        false, t3);
                        partial_vec_nuc(S, pos, i1n, e1->bl1, eps, flag1,
                                        false, t2);
                        double tot = 0.0;
                        for (int i = 0; i < 4; i++)
                            tot += t3[i] * t2[i] * S.root_freqs[i];
                        tot_factor *= tot / S.root_freqs[i1n];
                    } else if (flag2) {
                        double eps = uer ? S.eps_at(pos) : S.error_rate;
                        tot_factor *= std::min(
                            0.25, S.mm(pos, e2->val, c2) * contrib)
                            + eps * 0.33333;
                    } else if (contrib != 0.0) {
                        tot_factor *= std::min(
                            0.25, S.mm(pos, e2->val, c2) * contrib);
                    } else {
                        return NEG_INF;
                    }
                    pos += 1;
                    if (pos == S.lRef) break;
                    e2 = &vC[++i2];
                }
                if (e1->val == pos) e1 = &vP[++i1];
            } else if (c1 == TYPE_O) {
                if (c2 == TYPE_O) {
                    double tot = 0.0;
                    if (contrib != 0.0) {
                        double t3[4];
                        partial_vec_O(S, pos, contrib, e2->pp->p, false, t3);
                        for (int j = 0; j < 4; j++)
                            tot += e1->pp->p[j] * t3[j];
                    } else {
                        for (int j = 0; j < 4; j++)
                            tot += e1->pp->p[j] * e2->pp->p[j];
                    }
                    tot_factor *= tot;
                } else {
                    int i2n = (c2 == TYPE_R) ? e1->val : c2;
                    if (e1->pp->p[i2n] > 0.02) {
                        tot_factor *= e1->pp->p[i2n];
                    } else {
                        double t3[4];
                        if (uer && (tip_c || (len2 > 2 && e2->flag()))) {
                            double eps = S.eps_at(pos);
                            partial_vec_nuc(S, pos, i2n, contrib, eps, true,
                                            false, t3);
                        } else {
                            partial_vec_nuc(S, pos, i2n, contrib, 0.0, false,
                                            false, t3);
                        }
                        double tot = 0.0;
                        for (int j = 0; j < 4; j++)
                            tot += e1->pp->p[j] * t3[j];
                        tot_factor *= tot;
                    }
                }
                pos += 1;
                if (pos == S.lRef) break;
                e1 = &vP[++i1];
                if (c2 != TYPE_R || e2->val == pos) e2 = &vC[++i2];
            } else {
                // parent is a concrete non-reference nucleotide
                if (c2 != c1) {
                    bool flag1 = uer && len1 > 2 && e1->flag();
                    int i1n = c1;
                    if (c2 < TYPE_N) {
                        int i2n = (c2 == TYPE_R) ? e1->val : c2;
                        bool flag2 = uer
                            && (tip_c || (len2 > 2 && e2->flag()));
                        if (len1 == 4 + uer1) {
                            double eps = uer ? S.eps_at(pos) : S.error_rate;
                            double t3[4], t2[4];
                            partial_vec_nuc(S, pos, i2n, contrib, eps, flag2,
                                            false, t3);
                            partial_vec_nuc(S, pos, i1n, e1->bl1, eps, flag1,
                                            false, t2);
                            double tot = 0.0;
                            for (int j = 0; j < 4; j++)
                                tot += S.root_freqs[j] * t3[j] * t2[j];
                            tot_factor *= tot / S.root_freqs[i1n];
                        } else if (flag1 || flag2) {
                            double eps = uer ? S.eps_at(pos) : S.error_rate;
                            tot_factor *= std::min(
                                0.25, S.mm(pos, i1n, i2n) * contrib)
                                + ((flag1 ? 1 : 0) + (flag2 ? 1 : 0))
                                  * 0.33333 * eps;
                        } else if (contrib != 0.0) {
                            tot_factor *= std::min(
                                0.25, S.mm(pos, i1n, i2n) * contrib);
                        } else {
                            return NEG_INF;
                        }
                    } else {
                        // child is O
                        double eps = uer ? S.eps_at(pos) : S.error_rate;
                        if (e2->pp->p[i1n] > 0.02) {
                            tot_factor *= e2->pp->p[i1n];
                        } else if (len1 == 4 + uer1) {
                            double t2[4], t3[4];
                            partial_vec_nuc(S, pos, i1n, e1->bl1, eps, flag1,
                                            false, t2);
                            partial_vec_O(S, pos, contrib, e2->pp->p, false,
                                          t3);
                            double tot = 0.0;
                            for (int i = 0; i < 4; i++)
                                tot += t2[i] * t3[i] * S.root_freqs[i];
                            tot_factor *= tot / S.root_freqs[i1n];
                        } else if (contrib != 0.0) {
                            double t3[4];
                            partial_vec_O(S, pos, contrib, e2->pp->p, false,
                                          t3);
                            tot_factor *= t3[i1n];
                        } else {
                            tot_factor *= e2->pp->p[i1n];
                        }
                    }
                }
                pos += 1;
                if (pos == S.lRef) break;
                e1 = &vP[++i1];
                if (c2 != TYPE_R || e2->val == pos) e2 = &vC[++i2];
            }
        }
        if (tot_factor <= S.min_carry) {
            if (tot_factor < DBL_MIN_POS) return NEG_INF;
            lk += std::log(tot_factor);
            tot_factor = 1.0;
        }
    }
    return lk + std::log(tot_factor);
}

double append_prob_node(const Store &S, const Vec &vP, const Vec &vC,
                        bool tip_c, double blen) {
    if (S.using_error_rate)
        return append_prob_node_t<true>(S, vP, vC, tip_c, blen);
    return append_prob_node_t<false>(S, vP, vC, tip_c, blen);
}


// ------------------------------------------- estimateBranchLengthWithDerivative
// (reference :5040-5358; Python estimate_branch_length).  Returns -1.0 for
// the Python-side `False` ("optimal length is 0").
double estimate_branch_length(const Store &S, const Vec &vP, const Vec &vC,
                              bool from_tip_c) {
    prefetch_entries(vP);
    prefetch_entries(vC);
    const bool uer = S.using_error_rate;
    const int uer1 = uer ? 1 : 0;
    double c1acc = S.global_tot_rate;
    std::vector<double> ais;
    ais.reserve(64);
    int n_zeros = 0;
    size_t i1 = 0, i2 = 0;
    int pos = 0;
    const Entry *e1 = &vP[0];
    const Entry *e2 = &vC[0];
    while (true) {
        int t1 = e1->type, t2 = e2->type;
        if (t2 == TYPE_N) {
            int end = (t1 == TYPE_R || t1 == TYPE_N)
                ? std::min(e1->val, e2->val) : pos + 1;
            c1acc += S.cumulative_rate[pos] - S.cumulative_rate[end];
            pos = end;
        } else if (t1 == TYPE_N) {
            int end = (t2 == TYPE_R) ? std::min(e1->val, e2->val) : pos + 1;
            c1acc += S.cumulative_rate[pos] - S.cumulative_rate[end];
            pos = end;
        } else {
            if (t1 == TYPE_R && t2 == TYPE_R) {
                pos = std::min(e1->val, e2->val);
            } else {
                int len1 = tuple_len(S, *e1), len2 = tuple_len(S, *e2);
                if (t1 == TYPE_R)
                    c1acc -= S.mm(pos, e2->val, e2->val);
                else
                    c1acc -= S.mm(pos, e1->val, e1->val);
                bool flag1 = uer && t1 != TYPE_O && len1 > 2 && e1->flag();
                bool flag2 = uer && t2 != TYPE_O
                             && (from_tip_c || (len2 > 2 && e2->flag()));
                double eps = uer ? S.eps_at(pos) : S.error_rate;
                // contrib starts as Python `False` == 0.0 (+ keeps += sem.)
                double contrib = 0.0;
                if (t1 < TYPE_N) {
                    if (len1 == 3 + uer1) contrib = e1->bl1;
                    else if (len1 == 4 + uer1) contrib = e1->bl2;
                } else if (len1 > 3) {
                    contrib = e1->bl1;
                }
                if (t2 < TYPE_N) {
                    if (len2 > 2 + uer1) contrib += e2->bl1;
                } else if (len2 > 3) {
                    contrib += e2->bl1;
                }

                if (t1 == TYPE_R) {
                    if (t2 == TYPE_O) {
                        int i1n = e2->val;
                        double coeff0, coeff1 = 0.0;
                        if (len1 == 4 + uer1) {
                            coeff0 = S.root_freqs[i1n] * e2->pp->p[i1n];
                            for (int i = 0; i < 4; i++) {
                                coeff0 += S.root_freqs[i] * S.mm(pos, i, i1n)
                                          * e1->bl1 * e2->pp->p[i];
                                coeff1 += S.mm(pos, i1n, i) * e2->pp->p[i];
                            }
                            coeff1 *= S.root_freqs[i1n];
                            if (contrib != 0.0) coeff0 += coeff1 * contrib;
                            if (flag1) {
                                coeff0 -= 1.33333 * eps * S.root_freqs[i1n]
                                          * e2->pp->p[i1n];
                                for (int i = 0; i < 4; i++)
                                    coeff0 += S.root_freqs[i] * e2->pp->p[i]
                                              * 0.33333 * eps;
                            }
                        } else {
                            coeff0 = e2->pp->p[i1n];
                            for (int j = 0; j < 4; j++)
                                coeff1 += S.mm(pos, i1n, j) * e2->pp->p[j];
                            if (contrib != 0.0) coeff0 += coeff1 * contrib;
                        }
                        if (coeff1 < 0.0) c1acc += coeff1 / coeff0;
                        else if (coeff1 != 0.0) ais.push_back(coeff0 / coeff1);
                        pos += 1;
                    } else {
                        // R parent vs different concrete child
                        bool have = true;
                        double coeff0;
                        if (len1 == 4 + uer1) {
                            int i1n = e2->val, i2n = t2;
                            coeff0 = S.root_freqs[i2n] * S.mm(pos, i2n, i1n)
                                     * e1->bl1;
                            if (contrib != 0.0)
                                coeff0 += S.root_freqs[i1n]
                                          * S.mm(pos, i1n, i2n) * contrib;
                            if (flag2)
                                coeff0 += S.root_freqs[i1n] * 0.33333 * eps;
                            if (flag1)
                                coeff0 += S.root_freqs[i2n] * 0.33333 * eps;
                            double coeff1 = S.root_freqs[i1n]
                                            * S.mm(pos, i1n, i2n);
                            if (coeff1 != 0.0) coeff0 = coeff0 / coeff1;
                            else have = false;
                        } else {
                            coeff0 = contrib;
                            if (flag2) {
                                double m = S.mm(pos, e2->val, t2);
                                if (m != 0.0) coeff0 += eps * 0.33333 / m;
                                else have = false;
                            }
                        }
                        if (have) {
                            if (coeff0 != 0.0) ais.push_back(coeff0);
                            else n_zeros += 1;
                        }
                        pos += 1;
                    }
                } else if (t1 == TYPE_O) {
                    double coeff0, coeff1 = 0.0;
                    if (t2 == TYPE_O) {
                        coeff0 = e1->pp->p[0] * e2->pp->p[0]
                                 + e1->pp->p[1] * e2->pp->p[1]
                                 + e1->pp->p[2] * e2->pp->p[2]
                                 + e1->pp->p[3] * e2->pp->p[3];
                        for (int i = 0; i < 4; i++)
                            for (int j = 0; j < 4; j++)
                                coeff1 += e1->pp->p[i] * e2->pp->p[j]
                                          * S.mm(pos, i, j);
                        if (contrib != 0.0) coeff0 += coeff1 * contrib;
                    } else {
                        int i2n = (t2 == TYPE_R) ? e1->val : t2;
                        coeff0 = e1->pp->p[i2n];
                        for (int i = 0; i < 4; i++)
                            coeff1 += e1->pp->p[i] * S.mm(pos, i, i2n);
                        if (contrib != 0.0) coeff0 += coeff1 * contrib;
                        if (flag2) coeff0 += eps * 0.33333;
                    }
                    if (coeff1 < 0.0) c1acc += coeff1 / coeff0;
                    else if (coeff1 != 0.0) ais.push_back(coeff0 / coeff1);
                    pos += 1;
                } else {
                    if (t2 == t1) {
                        c1acc += S.mm(pos, t1, t1);
                    } else {
                        int i1n = t1;
                        if (t2 < TYPE_N) {
                            int i2n = (t2 == TYPE_R) ? e1->val : t2;
                            bool have = true;
                            double coeff0;
                            if (len1 == 4 + uer1) {
                                coeff0 = S.root_freqs[i2n]
                                         * S.mm(pos, i2n, i1n) * e1->bl1;
                                if (contrib != 0.0)
                                    coeff0 += S.root_freqs[i1n]
                                              * S.mm(pos, i1n, i2n)
                                              * contrib;
                                if (flag2)
                                    coeff0 += S.root_freqs[i1n] * 0.33333
                                              * eps;
                                if (flag1)
                                    coeff0 += S.root_freqs[i2n] * 0.33333
                                              * eps;
                                double coeff1 = S.root_freqs[i1n]
                                                * S.mm(pos, i1n, i2n);
                                if (coeff1 != 0.0) coeff0 = coeff0 / coeff1;
                                else have = false;
                            } else {
                                coeff0 = contrib;
                                if (flag2)
                                    coeff0 += eps * 0.33333
                                              / S.mm(pos, i1n, i2n);
                            }
                            if (have) {
                                if (coeff0 != 0.0) ais.push_back(coeff0);
                                else n_zeros += 1;
                            }
                        } else {
                            // child is O
                            double coeff0, coeff1 = 0.0;
                            if (len1 == 4 + uer1) {
                                coeff0 = S.root_freqs[i1n] * e2->pp->p[i1n];
                                for (int i = 0; i < 4; i++) {
                                    coeff0 += S.root_freqs[i]
                                              * S.mm(pos, i, i1n) * e1->bl1
                                              * e2->pp->p[i];
                                    coeff1 += S.mm(pos, i1n, i)
                                              * e2->pp->p[i];
                                }
                                coeff1 *= S.root_freqs[i1n];
                                if (contrib != 0.0)
                                    coeff0 += coeff1 * contrib;
                                if (flag1) {
                                    coeff0 -= 1.33333 * eps
                                              * S.root_freqs[i1n]
                                              * e2->pp->p[i1n];
                                    for (int i = 0; i < 4; i++)
                                        coeff0 += S.root_freqs[i]
                                                  * e2->pp->p[i] * 0.33333
                                                  * eps;
                                }
                            } else {
                                coeff0 = e2->pp->p[i1n];
                                for (int j = 0; j < 4; j++)
                                    coeff1 += S.mm(pos, i1n, j)
                                              * e2->pp->p[j];
                                if (contrib != 0.0)
                                    coeff0 += coeff1 * contrib;
                            }
                            if (coeff1 < 0.0) c1acc += coeff1 / coeff0;
                            else if (coeff1 != 0.0)
                                ais.push_back(coeff0 / coeff1);
                        }
                    }
                    pos += 1;
                }
            }
        }
        if (pos == S.lRef) break;
        if (t1 < TYPE_R || t1 == TYPE_O) e1 = &vP[++i1];
        else if (pos == e1->val) e1 = &vP[++i1];
        if (t2 < TYPE_R || t2 == TYPE_O) e2 = &vC[++i2];
        else if (pos == e2->val) e2 = &vC[++i2];
    }
    // bisection on the derivative (reference :5297-5358)
    double c1 = -c1acc;
    size_t n = ais.size() + n_zeros;
    if (n == 0) return -1.0;
    double min_ais = ais.empty() ? 0.0
        : *std::min_element(ais.begin(), ais.end());
    if (n_zeros) min_ais = std::min(0.0, min_ais);
    if (min_ais < 0.0) return 0.1;
    double t_down = std::min(0.1, (double)n / c1 - min_ais);
    if (t_down <= 0.0) return -1.0;
    double v_down = n_zeros ? n_zeros / t_down : 0.0;
    for (double ai : ais) v_down += 1.0 / (ai + t_down);
    double max_ais = ais.empty() ? 0.0
        : *std::max_element(ais.begin(), ais.end());
    double t_up = std::min(0.1, (double)n / c1 - max_ais);
    if (t_up >= 0.1) return 0.1;
    double sens = S.min_blen_sensitivity;
    if (t_up <= sens) t_up = (min_ais != 0.0) ? 0.0 : sens;
    double v_up = n_zeros ? n_zeros / t_up : 0.0;
    for (double ai : ais) v_up += 1.0 / (ai + t_up);
    if (v_down > c1 + sens || v_up < c1 - sens) {
        if (v_up < c1 - sens && t_up == 0.0) return -1.0;
        if (v_down > c1 + sens && t_down >= 0.1) return 0.1;
    }
    while (t_down - t_up > sens) {
        double t_mid = (t_up + t_down) / 2;
        double v_mid = n_zeros ? n_zeros / t_mid : 0.0;
        for (double ai : ais) v_mid += 1.0 / (ai + t_mid);
        if (v_mid > c1) t_up = t_mid;
        else t_down = t_mid;
    }
    return t_up;
}

// ---------------------------------------------- passGenomeListThroughBranch
// (reference :3749-3877; Python pass_through_branch)
void pass_through_branch(const Store &S, const Vec &v,
                         const int32_t *muts, int n_mut, bool dir_is_up,
                         Vec &out) {
    int i_mut = 0;
    size_t i_ent = 0;
    int last_pos = 0;
    out.clear();
    const Entry *e = &v[0];
    while (true) {
        int c = e->type;
        if (c == TYPE_N) {
            out.push_back(*e);
            last_pos = e->val;
            if (last_pos == S.lRef) break;
            while (i_mut < n_mut && muts[i_mut * 3] <= last_pos) i_mut++;
            e = &v[++i_ent];
        } else if (c < TYPE_R) {
            last_pos += 1;
            if (i_mut < n_mut && muts[i_mut * 3] <= last_pos) {
                int other = dir_is_up ? muts[i_mut * 3 + 1]
                                      : muts[i_mut * 3 + 2];
                Entry ne = *e;
                if (c == other) {
                    ne.type = TYPE_R;
                    ne.val = last_pos;
                } else {
                    ne.val = other;
                }
                out.push_back(ne);
                i_mut++;
            } else {
                out.push_back(*e);
            }
            if (last_pos == S.lRef) break;
            e = &v[++i_ent];
        } else if (c == TYPE_R) {
            while (i_mut < n_mut && muts[i_mut * 3] <= e->val) {
                int mpos = muts[i_mut * 3];
                if (mpos > last_pos + 1) {
                    Entry ne = *e;
                    ne.val = mpos - 1;
                    out.push_back(ne);
                }
                last_pos = mpos;
                int nuc, other;
                if (dir_is_up) {
                    nuc = muts[i_mut * 3 + 2];
                    other = muts[i_mut * 3 + 1];
                } else {
                    nuc = muts[i_mut * 3 + 1];
                    other = muts[i_mut * 3 + 2];
                }
                Entry ne = *e;
                ne.type = (int8_t)nuc;
                ne.val = other;
                out.push_back(ne);
                i_mut++;
            }
            if (last_pos < e->val) {
                last_pos = e->val;
                out.push_back(*e);
            }
            if (last_pos == S.lRef) break;
            e = &v[++i_ent];
        } else {  // O
            last_pos += 1;
            if (i_mut < n_mut && muts[i_mut * 3] <= last_pos) {
                int other = dir_is_up ? muts[i_mut * 3 + 1]
                                      : muts[i_mut * 3 + 2];
                Entry ne = *e;
                ne.val = other;
                out.push_back(ne);
                i_mut++;
            } else {
                out.push_back(*e);
            }
            if (last_pos == S.lRef) break;
            e = &v[++i_ent];
        }
    }
}

// ------------------------------------------------------- rootVector (frame)
// (reference :4916-4996 minus the MAT walk; Python root_vector_frame)
void root_vector_frame(const Store &S, const Vec &v, double blen,
                       bool is_from_tip, Vec &out) {
    const bool uer = S.using_error_rate;
    out.clear();
    int new_pos = 0;
    for (const Entry &e : v) {
        int c = e.type;
        if (c == TYPE_N) {
            out.push_back(e);
            new_pos = e.val;
        } else if (c == TYPE_O) {
            double tot_b = blen + (e.has_bl1() ? e.bl1 : 0.0);
            double nv[4];
            if (tot_b != 0.0) {
                partial_vec_O(S, new_pos, tot_b, e.pp->p, false, nv);
                for (int i = 0; i < 4; i++) nv[i] *= S.root_freqs[i];
            } else {
                for (int i = 0; i < 4; i++)
                    nv[i] = e.pp->p[i] * S.root_freqs[i];
            }
            double sum = neumaier_sum4(nv);
            for (int i = 0; i < 4; i++) nv[i] /= sum;
            out.push_back(make_O(e.val, false, 0.0, nv));
            new_pos += 1;
        } else {
            if (uer) {
                bool fl = (tuple_len(S, e) > 2 && e.flag()) || is_from_tip;
                if (tuple_len(S, e) > 3)
                    out.push_back(make_nuc(c, e.val,
                                           BIT_BL1 | BIT_BL2
                                           | (fl ? BIT_FLAG : 0),
                                           e.bl1 + blen, 0.0));
                else if (blen != 0.0 || fl)
                    out.push_back(make_nuc(c, e.val,
                                           BIT_BL1 | BIT_BL2
                                           | (fl ? BIT_FLAG : 0),
                                           blen, 0.0));
                else
                    out.push_back(make_nuc(c, e.val, 0, 0, 0));
            } else {
                if (tuple_len(S, e) == 3)
                    out.push_back(make_nuc(c, e.val, BIT_BL1 | BIT_BL2,
                                           e.bl1 + blen, 0.0));
                else if (blen != 0.0)
                    out.push_back(make_nuc(c, e.val, BIT_BL1 | BIT_BL2,
                                           blen, 0.0));
                else
                    out.push_back(make_nuc(c, e.val, 0, 0, 0));
            }
            new_pos = (c == TYPE_R) ? e.val : new_pos + 1;
        }
    }
}

// ------------------------------------------------------ findProbRoot (frame)
// (reference :4865-4912; Python find_prob_root_frame)
double find_prob_root_frame(const Store &S, const Vec &v) {
    const bool uer = S.using_error_rate;
    double log_lk = 0.0, log_factor = 1.0;
    int pos = 0;
    for (const Entry &e : v) {
        int c = e.type;
        if (uer && c < TYPE_N && tuple_len(S, e) > 2 && e.flag()) {
            if (c == TYPE_R) {
                log_lk += S.rfle_cum[e.val] - S.rfle_cum[pos];
                pos = e.val;
            } else {
                double eps = S.eps_at(pos);
                log_factor *= S.root_freqs[c] * (1.0 - 1.33333 * eps)
                              + 0.33333 * eps;
                pos += 1;
            }
        } else {
            if (c == TYPE_R) {
                for (int i = 0; i < 4; i++)
                    log_lk += S.root_freqs_log[i]
                              * (S.cumulative_bases[e.val * 4 + i]
                                 - S.cumulative_bases[pos * 4 + i]);
                pos = e.val;
            } else if (c < TYPE_R) {
                log_lk += S.root_freqs_log[c];
                pos += 1;
            } else if (c == TYPE_O) {
                double tot = S.root_freqs[0] * e.pp->p[0]
                             + S.root_freqs[1] * e.pp->p[1]
                             + S.root_freqs[2] * e.pp->p[2]
                             + S.root_freqs[3] * e.pp->p[3];
                log_factor *= tot;
                pos += 1;
            } else {
                pos = e.val;
            }
        }
        if (log_factor <= S.min_carry) {
            if (log_factor < DBL_MIN_POS)
                return -std::numeric_limits<double>::infinity();
            log_lk += std::log(log_factor);
            log_factor = 1.0;
        }
    }
    return log_lk + std::log(log_factor);
}

// --------------------------------------------------- areVectorsDifferent
// (reference :5419-5472)
bool are_vectors_different(const Store &S, const Vec &v1, const Vec &v2) {
    prefetch_entries(v1);
    prefetch_entries(v2);
    size_t i1 = 0, i2 = 0;
    int pos = 0;
    const Entry *e1 = &v1[0];
    const Entry *e2 = &v2[0];
    const double tp = S.threshold_prob;
    while (true) {
        if (e1->type != e2->type) return true;
        if (tuple_len(S, *e1) != tuple_len(S, *e2)) return true;
        int c = e1->type;
        if (c < TYPE_N) {
            if (e1->has_bl1()) {
                if (std::fabs(e1->bl1 - e2->bl1) > tp) return true;
                if (e1->has_bl2()) {
                    if (std::fabs(e1->bl2 - e2->bl2) > tp) return true;
                    if (S.using_error_rate
                            && std::fabs((double)(e1->flag() ? 1 : 0)
                                         - (double)(e2->flag() ? 1 : 0))
                               > tp)
                        return true;
                } else if (S.using_error_rate
                           && std::fabs((double)(e1->flag() ? 1 : 0)
                                        - (double)(e2->flag() ? 1 : 0))
                              > tp) {
                    return true;
                }
            }
            pos = (c < TYPE_R) ? pos + 1 : std::min(e1->val, e2->val);
        } else if (c == TYPE_O) {
            if (tuple_len(S, *e1) == 4
                    && std::fabs(e1->bl1 - e2->bl1) > tp)
                return true;
            for (int i = 0; i < 4; i++) {
                double d = std::fabs(e1->pp->p[i] - e2->pp->p[i]);
                if (d != 0.0) {
                    if (e1->pp->p[i] == 0.0 || e2->pp->p[i] == 0.0)
                        return true;
                    if (d > S.threshold_diff_update
                            || (d > tp
                                && (d / e1->pp->p[i]
                                        > S.threshold_fold_change
                                    || d / e2->pp->p[i]
                                        > S.threshold_fold_change)))
                        return true;
                }
            }
            pos += 1;
        } else {
            pos = std::min(e1->val, e2->val);
        }
        if (pos == S.lRef) break;
        if (e1->type < TYPE_R || e1->type == TYPE_O) e1 = &v1[++i1];
        else if (pos == e1->val) e1 = &v1[++i1];
        if (e2->type < TYPE_R || e2->type == TYPE_O) e2 = &v2[++i2];
        else if (pos == e2->val) e2 = &v2[++i2];
    }
    return false;
}

// ------------------------------------------------------- isMinorSequence
// (reference :5919-6004)
int is_minor_sequence(const Store &S, const Vec &v1, const Vec &v2,
                      bool only_identical) {
    prefetch_entries(v1);
    prefetch_entries(v2);
    size_t i1 = 0, i2 = 0;
    int pos = 0;
    const Entry *e1 = &v1[0];
    const Entry *e2 = &v2[0];
    bool found1 = false, found2 = false;
    while (true) {
        int c1 = e1->type, c2 = e2->type;
        if (c1 != c2) {
            if (only_identical) return 0;
            if (c1 == TYPE_N) {
                pos = (c2 == TYPE_R) ? std::min(e1->val, e2->val) : pos + 1;
                found2 = true;
            } else if (c2 == TYPE_N) {
                pos = (c1 == TYPE_R) ? std::min(e1->val, e2->val) : pos + 1;
                found1 = true;
            } else if (c1 == TYPE_O) {
                int i2n = (c2 == TYPE_R) ? e1->val : c2;
                if (e1->pp->p[i2n] > 0.1) found2 = true;
                else return 0;
                pos += 1;
            } else if (c2 == TYPE_O) {
                int i1n = (c1 == TYPE_R) ? e2->val : c1;
                if (e2->pp->p[i1n] > 0.1) found1 = true;
                else return 0;
                pos += 1;
            } else {
                return 0;
            }
        } else if (c1 == TYPE_O) {
            for (int j = 0; j < 4; j++) {
                if (only_identical) {
                    if (e2->pp->p[j] != e1->pp->p[j]) return 0;
                } else if (e2->pp->p[j] > 0.1 && e1->pp->p[j] < 0.1) {
                    found1 = true;
                } else if (e1->pp->p[j] > 0.1 && e2->pp->p[j] < 0.1) {
                    found2 = true;
                }
            }
            pos += 1;
        } else {
            pos = (c1 < TYPE_R) ? pos + 1 : std::min(e1->val, e2->val);
        }
        if (found1 && found2) return 0;
        if (pos == S.lRef) break;
        if (e1->type < TYPE_R || e1->type == TYPE_O) e1 = &v1[++i1];
        else if (pos == e1->val) e1 = &v1[++i1];
        if (e2->type < TYPE_R || e2->type == TYPE_O) e2 = &v2[++i2];
        else if (pos == e2->val) e2 = &v2[++i2];
    }
    if (found1) return found2 ? 0 : 1;
    return found2 ? 2 : 1;
}

// ----------------------------------------------------- updatePesudoCounts
// (reference :5002-5035)
void update_pseudo_counts(const Store &S, const Vec &v1, const Vec &v2,
                          double *counts /*16*/) {
    size_t i1 = 0, i2 = 0;
    int pos = 0;
    const Entry *e1 = &v1[0];
    const Entry *e2 = &v2[0];
    while (true) {
        int c1 = e1->type, c2 = e2->type;
        if (c1 != c2 && c1 < TYPE_N && c2 < TYPE_N) {
            if (c1 == TYPE_R) counts[e2->val * 4 + c2] += 1;
            else if (c2 == TYPE_R) counts[c1 * 4 + e1->val] += 1;
            else counts[c1 * 4 + c2] += 1;
            pos += 1;
        } else {
            if ((c1 == TYPE_R || c1 == TYPE_N)
                    && (c2 == TYPE_R || c2 == TYPE_N))
                pos = std::min(e1->val, e2->val);
            else
                pos += 1;
        }
        if (pos == S.lRef) break;
        if (e1->type < TYPE_R || e1->type == TYPE_O) e1 = &v1[++i1];
        else if (pos == e1->val) e1 = &v1[++i1];
        if (e2->type < TYPE_R || e2->type == TYPE_O) e2 = &v2[++i2];
        else if (pos == e2->val) e2 = &v2[++i2];
    }
}

}  // namespace

// ================================================================ C API
// =============================================================== EM kernel
// Per-branch posterior accumulation (reference :10077-10947; Python twin
// models/em.py _em_* helpers).  Float-op order mirrors the Python code
// exactly so exported totals are byte-identical.  track_mutations mode
// (the MAT annotator) stays on the Python path.

// O upper vs O lower (em.py _em_O_O, reference :10247-10336)
static double em_O_O(const Store &S, EMState &E, const Entry &e1,
                     const Entry &e2, double tot_len1, int pos, bool leaf) {
    const double *p1 = e1.pp->p;
    const double *p2 = e2.pp->p;
    const bool rv = E.rate_var;
    double err_ret = 0.0;
    if (leaf && E.uer) {
        const double eps = S.eps_at(pos);
        double no_mut = 0.0, mut_prob = 0.0, err_prob = 0.0;
        for (int j = 0; j < 4; j++) {
            if (p2[j] > 0.1) {
                no_mut += p1[j];
                err_prob += (1.0 - p1[j]) * eps * 0.33333;
                for (int i = 0; i < 4; i++)
                    if (j != i)
                        mut_prob += p1[i] * S.mm(pos, i, j) * tot_len1;
            }
        }
        double norm = err_prob + no_mut + mut_prob;
        err_prob /= norm;
        err_ret = err_prob;
        if (E.uer && E.site_err) E.err_sites[pos] += err_prob;
        for (int j = 0; j < 4; j++) {
            if (p2[j] > 0.1) {
                E.waiting_times[j] += tot_len1 * p1[j] / norm;
                if (rv) E.wts[pos * 4 + j] += tot_len1 * p1[j] / norm;
                for (int i = 0; i < 4; i++) {
                    if (j != i) {
                        double mpij = p1[i] * S.mm(pos, i, j) * tot_len1
                                      / norm;
                        E.waiting_times[j] += tot_len1 * mpij / 2;
                        E.waiting_times[i] += tot_len1 * mpij / 2;
                        E.counts[i][j] += mpij;
                        if (rv) {
                            E.wts[pos * 4 + j] += tot_len1 * mpij / 2;
                            E.wts[pos * 4 + i] += tot_len1 * mpij / 2;
                            E.cs[pos] += mpij;
                        }
                    }
                }
            }
        }
    } else {
        double norm = 0.0;
        bool approx_failed[4];
        for (int i = 0; i < 4; i++) {
            double stay = 1.0 + S.mm(pos, i, i) * tot_len1;
            if (stay < 0) {
                for (int j = 0; j < 4; j++) norm += p1[i] * 0.25 * p2[j];
                approx_failed[i] = true;
            } else {
                approx_failed[i] = false;
                for (int j = 0; j < 4; j++) {
                    if (i == j) norm += p1[i] * stay * p2[j];
                    else norm += p1[i] * S.mm(pos, i, j) * tot_len1 * p2[j];
                }
            }
        }
        for (int i = 0; i < 4; i++) {
            for (int j = 0; j < 4; j++) {
                if (i == j) {
                    double prob;
                    if (approx_failed[i])
                        prob = p1[i] * 0.25 * p2[j] / norm;
                    else
                        prob = p1[i] * (1.0 + S.mm(pos, i, i) * tot_len1)
                               * p2[j] / norm;
                    E.waiting_times[i] += tot_len1 * prob;
                    if (rv) E.wts[pos * 4 + i] += tot_len1 * prob;
                } else {
                    double prob;
                    if (approx_failed[i])
                        prob = p1[i] * 0.25 * p2[j] / norm;
                    else
                        prob = p1[i] * S.mm(pos, i, j) * tot_len1 * p2[j]
                               / norm;
                    E.waiting_times[i] += (tot_len1 / 2) * prob;
                    E.waiting_times[j] += (tot_len1 / 2) * prob;
                    E.counts[i][j] += prob;
                    if (rv) {
                        E.wts[pos * 4 + i] += (tot_len1 / 2) * prob;
                        E.wts[pos * 4 + j] += (tot_len1 / 2) * prob;
                        E.cs[pos] += prob;
                    }
                }
            }
        }
    }
    return err_ret;
}

// O upper vs concrete lower (em.py _em_O_nuc, reference :10337-10432)
static double em_O_nuc(const Store &S, EMState &E, const Entry &e1,
                       const Entry &e2, double tot_len1, int pos, bool leaf,
                       bool has_minor) {
    const double *p1 = e1.pp->p;
    const bool rv = E.rate_var;
    double err_ret = 0.0;
    const int i2 = (e2.type == TYPE_R) ? e1.val : e2.type;
    if (leaf && E.uer && !has_minor) {
        const double eps = S.eps_at(pos);
        double err_prob = (1.0 - p1[i2]) * eps * 0.33333;
        double no_mut = p1[i2];
        double mut_prob = 0.0;
        for (int i = 0; i < 4; i++)
            if (i != i2) mut_prob += p1[i] * S.mm(pos, i, i2) * tot_len1;
        double norm = err_prob + no_mut + mut_prob;
        err_prob /= norm;
        no_mut /= norm;
        mut_prob /= norm;
        err_ret = err_prob;
        if (E.uer && E.site_err) E.err_sites[pos] += err_prob;
        E.waiting_times[i2] += tot_len1 * no_mut;
        E.waiting_times[i2] += (tot_len1 / 2) * mut_prob;
        if (rv) {
            E.wts[pos * 4 + i2] += tot_len1 * no_mut;
            E.wts[pos * 4 + i2] += tot_len1 * mut_prob / 2;
            E.cs[pos] += mut_prob;
        }
        for (int i = 0; i < 4; i++) {
            if (i != i2) {
                double prob = p1[i] * S.mm(pos, i, i2) * tot_len1 / norm;
                double prob_err = p1[i] * eps * 0.33333 / norm;
                E.waiting_times[i] += tot_len1 * (prob_err + prob / 2);
                E.counts[i][i2] += prob;
                if (rv)
                    E.wts[pos * 4 + i] += tot_len1 * (prob_err + prob / 2);
            }
        }
    } else {
        double stay = 1.0 + S.mm(pos, i2, i2) * tot_len1;
        double norm = 0.0;
        bool approx_failed;
        if (stay < 0) {
            norm = 0.25;
            approx_failed = true;
        } else {
            approx_failed = false;
            for (int i = 0; i < 4; i++) {
                if (i == i2) norm += p1[i] * stay;
                else norm += p1[i] * S.mm(pos, i, i2) * tot_len1;
            }
        }
        for (int i = 0; i < 4; i++) {
            if (i == i2) {
                double prob;
                if (approx_failed) prob = p1[i];
                else
                    prob = p1[i] * (1.0 + S.mm(pos, i, i) * tot_len1)
                           / norm;
                E.waiting_times[i] += tot_len1 * prob;
                if (rv) E.wts[pos * 4 + i] += tot_len1 * prob;
            } else {
                double prob;
                if (approx_failed) prob = p1[i];
                else prob = p1[i] * S.mm(pos, i, i2) * tot_len1 / norm;
                E.waiting_times[i] += (tot_len1 / 2) * prob;
                E.waiting_times[i2] += (tot_len1 / 2) * prob;
                E.counts[i][i2] += prob;
                if (rv) {
                    E.wts[pos * 4 + i] += (tot_len1 / 2) * prob;
                    E.wts[pos * 4 + i2] += (tot_len1 / 2) * prob;
                    E.cs[pos] += prob;
                }
            }
        }
    }
    return err_ret;
}

// concrete upper vs O lower (em.py _em_nuc_O, reference :10434-10660)
static double em_nuc_O(const Store &S, EMState &E, const Entry &e1,
                       const Entry &e2, int i1, double tot_len1,
                       double tot_len2, int pos, bool leaf, int uer1) {
    const double *p2 = e2.pp->p;
    const bool rv = E.rate_var;
    double err_inc = 0.0;
    if (p2[i1] > 0.1) {
        E.waiting_times[i1] += tot_len1;
        if (rv) {
            E.wts[pos * 4 + S.ref_indices[pos]] -= tot_len1;
            E.wts[pos * 4 + i1] += tot_len1;
        }
        return err_inc;
    }
    const bool uer_here = leaf && E.uer;
    if (uer_here) {
        const double eps = S.eps_at(pos);
        int num_alt = 0;
        for (int i = 0; i < 4; i++)
            if (p2[i] > 0.1) num_alt++;
        if (tuple_len(S, e1) == 4 + uer1) {
            double stay1 = 1.0 + S.mm(pos, i1, i1) * tot_len1;
            if (stay1 < 0) stay1 = 0.25;
            double stay2 = 1.0 + S.mm(pos, i1, i1) * e1.bl1;
            bool approx2 = stay2 < 0;
            if (approx2) stay2 = 0.25;
            double err_prob = S.root_freqs[i1] * stay1 * stay2 * eps
                              * 0.33333 * num_alt;
            double mut_prob = 0.0;
            double i1_root = S.root_freqs[i1] * stay2;
            for (int i = 0; i < 4; i++) {
                if (p2[i] > 0.1) {
                    double stay1i = 1.0 + S.mm(pos, i, i) * tot_len1;
                    bool approx1 = stay1i < 0;
                    if (approx1) stay1i = 0.25;
                    if (approx1) mut_prob += i1_root * 0.25;
                    else mut_prob += i1_root * S.mm(pos, i1, i) * tot_len1;
                    if (approx2)
                        mut_prob += S.root_freqs[i] * stay1i * 0.25;
                    else
                        mut_prob += S.root_freqs[i] * stay1i
                                    * S.mm(pos, i, i1) * e1.bl1;
                }
            }
            double norm = err_prob + mut_prob;
            err_prob /= norm;
            if (rv) {
                E.wts[pos * 4 + S.ref_indices[pos]] -= tot_len1;
                E.wts[pos * 4 + i1] += tot_len1 * err_prob;
            }
            E.waiting_times[i1] += tot_len1 * err_prob;
            err_inc += err_prob;
            if (E.uer && E.site_err) E.err_sites[pos] += err_prob;
            for (int i = 0; i < 4; i++) {
                if (p2[i] > 0.1) {
                    double stay1i = 1.0 + S.mm(pos, i, i) * tot_len1;
                    bool approx1 = stay1i < 0;
                    if (approx1) stay1i = 0.25;
                    double prob1, probi;
                    if (approx1) prob1 = i1_root * 0.25 / norm;
                    else
                        prob1 = i1_root * S.mm(pos, i1, i) * tot_len1
                                / norm;
                    if (approx2)
                        probi = S.root_freqs[i] * stay1i * 0.25 / norm;
                    else
                        probi = S.root_freqs[i] * stay1i * S.mm(pos, i, i1)
                                * e1.bl1 / norm;
                    E.waiting_times[i] += tot_len1 * (probi + prob1 / 2);
                    E.waiting_times[i1] += tot_len1 * prob1 / 2;
                    E.counts[i1][i] += prob1;
                    if (rv) {
                        E.wts[pos * 4 + i] += tot_len1 * (probi + prob1 / 2);
                        E.wts[pos * 4 + i1] += tot_len1 * prob1 / 2;
                        E.cs[pos] += prob1;
                    }
                }
            }
        } else {
            double stay = 1.0 + S.mm(pos, i1, i1) * tot_len1;
            bool approx = stay < 0;
            if (approx) stay = 0.25;
            double err_prob = stay * eps * 0.33333 * num_alt;
            double mut_prob = 0.0;
            for (int i = 0; i < 4; i++) {
                if (p2[i] > 0.1) {
                    if (approx) mut_prob += 0.25;
                    else mut_prob += S.mm(pos, i1, i) * tot_len1;
                }
            }
            double norm = err_prob + mut_prob;
            err_prob /= norm;
            if (rv) {
                E.wts[pos * 4 + S.ref_indices[pos]] -= tot_len1;
                E.wts[pos * 4 + i1] += tot_len1 * err_prob;
            }
            E.waiting_times[i1] += tot_len1 * err_prob;
            err_inc += err_prob;
            if (E.uer && E.site_err) E.err_sites[pos] += err_prob;
            for (int i = 0; i < 4; i++) {
                if (p2[i] > 0.1) {
                    double prob = S.mm(pos, i1, i) * tot_len1 / norm;
                    E.waiting_times[i1] += (tot_len1 / 2) * prob;
                    E.waiting_times[i] += (tot_len1 / 2) * prob;
                    E.counts[i1][i] += prob;
                    if (rv) {
                        E.wts[pos * 4 + i1] += (tot_len1 / 2) * prob;
                        E.wts[pos * 4 + i] += (tot_len1 / 2) * prob;
                        E.cs[pos] += prob;
                    }
                }
            }
        }
    } else if (tot_len2 == 0.0) {
        double norm = 0.0;
        if (tuple_len(S, e1) == 4 + uer1) {
            if (rv) E.wts[pos * 4 + S.ref_indices[pos]] -= tot_len1;
            double stay1 = 1.0 + S.mm(pos, i1, i1) * e1.bl1;
            bool approx1 = stay1 < 0;
            if (approx1) stay1 = 0.25;
            for (int i = 0; i < 4; i++) {
                double stay2 = 1.0 + S.mm(pos, i, i) * tot_len1;
                bool approx2 = stay2 < 0;
                if (approx2) stay2 = 0.25;
                if (i1 == i) {
                    double prob = S.root_freqs[i] * stay1;
                    double tot3;
                    if (approx2) tot3 = 0.25;
                    else {
                        tot3 = 0.0;
                        for (int j = 0; j < 4; j++)
                            tot3 += S.mm(pos, i, j) * p2[j];
                        tot3 *= tot_len1;
                        tot3 += p2[i];
                    }
                    norm += prob * tot3;
                } else {
                    double prob;
                    if (approx1)
                        prob = S.root_freqs[i] * 0.25 * stay2 * p2[i];
                    else
                        prob = S.root_freqs[i] * S.mm(pos, i, i1) * e1.bl1
                               * stay2 * p2[i];
                    norm += prob;
                }
            }
            for (int i = 0; i < 4; i++) {
                double stay2 = 1.0 + S.mm(pos, i, i) * tot_len1;
                bool approx2 = stay2 < 0;
                if (approx2) stay2 = 0.25;
                if (i1 == i) {
                    double prob = S.root_freqs[i] * stay1;
                    for (int j = 0; j < 4; j++) {
                        if (j == i) {
                            double tot3 = prob * stay2 * p2[j] / norm;
                            E.waiting_times[i] += tot_len1 * tot3;
                            if (rv) E.wts[pos * 4 + i] += tot_len1 * tot3;
                        } else {
                            double tot3;
                            if (approx2)
                                tot3 = prob * 0.25 * p2[j] / norm;
                            else
                                tot3 = prob * S.mm(pos, i, j) * tot_len1
                                       * p2[j] / norm;
                            E.waiting_times[i] += (tot_len1 / 2) * tot3;
                            E.waiting_times[j] += (tot_len1 / 2) * tot3;
                            E.counts[i][j] += tot3;
                            if (rv) {
                                E.wts[pos * 4 + i] += (tot_len1 / 2) * tot3;
                                E.wts[pos * 4 + j] += (tot_len1 / 2) * tot3;
                                E.cs[pos] += tot3;
                            }
                        }
                    }
                } else {
                    double prob;
                    if (approx1)
                        prob = S.root_freqs[i] * 0.25 * stay2 * p2[i]
                               / norm;
                    else
                        prob = S.root_freqs[i] * S.mm(pos, i, i1) * e1.bl1
                               * stay2 * p2[i] / norm;
                    E.waiting_times[i] += tot_len1 * prob;
                    if (rv) E.wts[pos * 4 + i] += tot_len1 * prob;
                }
            }
        } else {
            if (rv) E.wts[pos * 4 + S.ref_indices[pos]] -= tot_len1;
            double stay = 1.0 + S.mm(pos, i1, i1) * tot_len1;
            bool approx;
            if (stay < 0) {
                norm = 0.25;
                approx = true;
            } else {
                approx = false;
                for (int i = 0; i < 4; i++) {
                    if (i1 == i) norm += stay * p2[i];
                    else norm += S.mm(pos, i1, i) * tot_len1 * p2[i];
                }
            }
            for (int i = 0; i < 4; i++) {
                if (i1 == i) {
                    double prob;
                    if (approx) prob = p2[i];
                    else
                        prob = (1.0 + S.mm(pos, i, i) * tot_len1) * p2[i]
                               / norm;
                    E.waiting_times[i] += tot_len1 * prob;
                    if (rv) E.wts[pos * 4 + i] += tot_len1 * prob;
                } else {
                    double prob;
                    if (approx) prob = p2[i];
                    else
                        prob = S.mm(pos, i1, i) * tot_len1 * p2[i] / norm;
                    E.waiting_times[i1] += (tot_len1 / 2) * prob;
                    E.waiting_times[i] += (tot_len1 / 2) * prob;
                    E.counts[i1][i] += prob;
                    if (rv) {
                        E.wts[pos * 4 + i1] += (tot_len1 / 2) * prob;
                        E.wts[pos * 4 + i] += (tot_len1 / 2) * prob;
                        E.cs[pos] += prob;
                    }
                }
            }
        }
    }
    return err_inc;
}

// concrete upper vs concrete lower (em.py _em_nuc_nuc, reference
// :10680-10806)
static double em_nuc_nuc(const Store &S, EMState &E, const Entry &e1,
                         int i1, int i2, double tot_len1, double tot_len2,
                         int pos, bool leaf, bool has_minor, int uer1) {
    const bool rv = E.rate_var;
    double err_inc = 0.0;
    if (i2 == i1) {
        if (tot_len2 == 0.0) {
            E.waiting_times[i1] += tot_len1;
            if (rv) {
                E.wts[pos * 4 + i1] += tot_len1;
                E.wts[pos * 4 + S.ref_indices[pos]] -= tot_len1;
            }
        }
        return err_inc;
    }
    if (leaf && E.uer && !has_minor) {
        const double eps = S.eps_at(pos);
        if (tuple_len(S, e1) < 4 + uer1) {
            double error_prob = eps * 0.33333;
            double mut_prob = S.mm(pos, i1, i2) * tot_len1;
            double norm = error_prob + mut_prob;
            error_prob /= norm;
            mut_prob /= norm;
            if (rv) {
                E.wts[pos * 4 + S.ref_indices[pos]] -= tot_len1;
                E.wts[pos * 4 + i1] += tot_len1 * (mut_prob / 2);
                E.wts[pos * 4 + i2] += tot_len1 * (error_prob
                                                   + mut_prob / 2);
                E.cs[pos] += mut_prob;
            }
            E.waiting_times[i1] += tot_len1 * (error_prob + mut_prob / 2);
            E.waiting_times[i2] += tot_len1 * mut_prob / 2;
            E.counts[i1][i2] += mut_prob;
            err_inc += error_prob;
            if (E.uer && E.site_err) E.err_sites[pos] += error_prob;
        } else {
            double mutprob1 = S.root_freqs[i1] * S.mm(pos, i1, i2)
                              * tot_len1;
            double mutprob2 = S.root_freqs[i2] * S.mm(pos, i2, i1) * e1.bl1;
            double error_prob = S.root_freqs[i1] * eps * 0.33333;
            double norm = mutprob1 + mutprob2 + error_prob;
            mutprob1 /= norm;
            mutprob2 /= norm;
            error_prob /= norm;
            E.waiting_times[i1] += tot_len1 * (mutprob1 / 2 + error_prob);
            E.waiting_times[i2] += tot_len1 * (mutprob2 + mutprob1 / 2);
            E.counts[i1][i2] += mutprob1;
            err_inc += error_prob;
            if (E.uer && E.site_err) E.err_sites[pos] += error_prob;
            if (rv) {
                E.wts[pos * 4 + S.ref_indices[pos]] -= tot_len1;
                E.wts[pos * 4 + i1] += tot_len1 * (mutprob1 / 2
                                                   + error_prob);
                E.wts[pos * 4 + i2] += tot_len1 * (mutprob2 + mutprob1 / 2);
                E.cs[pos] += mutprob1;
            }
        }
    } else if (tot_len2 == 0.0) {
        if (tuple_len(S, e1) < 4 + uer1) {
            if (rv) {
                E.wts[pos * 4 + S.ref_indices[pos]] -= tot_len1;
                E.wts[pos * 4 + i1] += tot_len1 / 2;
                E.wts[pos * 4 + i2] += tot_len1 / 2;
                E.cs[pos] += 1;
            }
            E.waiting_times[i1] += tot_len1 / 2;
            E.waiting_times[i2] += tot_len1 / 2;
            E.counts[i1][i2] += 1;
        } else {
            double no_mut1 = 1.0 + S.mm(pos, i1, i1) * e1.bl1;
            if (no_mut1 < 0) no_mut1 = 0.25;
            double no_mut2 = 1.0 + S.mm(pos, i2, i2) * tot_len1;
            if (no_mut2 < 0) no_mut2 = 0.25;
            double prob1 = S.root_freqs[i1] * S.mm(pos, i1, i2) * tot_len1
                           * no_mut1;
            double prob2 = S.root_freqs[i2] * S.mm(pos, i2, i1) * e1.bl1
                           * no_mut2;
            double norm = prob1 + prob2;
            prob1 /= norm;
            prob2 /= norm;
            E.waiting_times[i1] += (tot_len1 / 2) * prob1;
            E.waiting_times[i2] += (tot_len1 / 2) * prob1;
            E.counts[i1][i2] += prob1;
            E.waiting_times[i2] += tot_len1 * prob2;
            if (rv) {
                E.wts[pos * 4 + S.ref_indices[pos]] -= tot_len1;
                E.wts[pos * 4 + i1] += (tot_len1 / 2) * prob1;
                E.wts[pos * 4 + i2] += (tot_len1 / 2) * prob1;
                E.wts[pos * 4 + i2] += tot_len1 * prob2;
                E.cs[pos] += prob1;
            }
        }
    }
    return err_inc;
}

extern "C" {

Store *store_create(int lRef) {
    Store *s = new Store();
    s->lRef = lRef;
    s->global_tot_rate = -(double)lRef;
    // Reserve the chunk table once: worker threads dereference it
    // concurrently with main-thread allocs, so it must never reallocate
    // (64k chunks = 256M vector slot capacity).
    s->vec_chunks.reserve((size_t)1 << 16);
    return s;
}

void store_free(Store *s) { delete s; }

void store_set_ref(Store *s, const int8_t *ref_indices,
                   const double *root_freqs, const int32_t *cum_bases) {
    s->ref_indices.assign(ref_indices, ref_indices + s->lRef);
    for (int i = 0; i < 4; i++) {
        s->root_freqs[i] = root_freqs[i];
        s->root_freqs_log[i] = std::log(root_freqs[i]);
    }
    s->cumulative_bases.assign(cum_bases, cum_bases + (s->lRef + 1) * 4);
}

void store_set_params(Store *s, double threshold_prob, double min_carry,
                      double min_blen_sensitivity,
                      double threshold_diff_update,
                      double threshold_fold_change) {
    s->threshold_prob = threshold_prob;
    s->threshold_prob4 = threshold_prob * threshold_prob * threshold_prob
                         * threshold_prob;
    s->min_carry = min_carry;
    s->min_blen_sensitivity = min_blen_sensitivity;
    s->threshold_diff_update = threshold_diff_update;
    s->threshold_fold_change = threshold_fold_change;
}

void store_set_model(Store *s, const double *mut, const double *cum_rate,
                     int use_rate_variation, const double *site_rates,
                     int using_error_rate, int site_err, double error_rate,
                     const double *error_rates,
                     const double *cumulative_error_rate, double tot_error,
                     const double *rfle_cum) {
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 4; j++) s->mut[i][j] = mut[i * 4 + j];
    s->cumulative_rate.assign(cum_rate, cum_rate + s->lRef + 1);
    s->use_rate_variation = use_rate_variation != 0;
    if (use_rate_variation && site_rates)
        s->site_rates.assign(site_rates, site_rates + s->lRef);
    s->using_error_rate = using_error_rate != 0;
    s->site_err = site_err != 0;
    s->error_rate = error_rate;
    if (error_rates)
        s->error_rates.assign(error_rates, error_rates + s->lRef);
    if (cumulative_error_rate)
        s->cumulative_error_rate.assign(cumulative_error_rate,
                                        cumulative_error_rate + s->lRef + 1);
    s->tot_error = tot_error;
    if (rfle_cum) s->rfle_cum.assign(rfle_cum, rfle_cum + s->lRef + 1);
}

// ------------------------------------------------------------ EM exports

void em_reset(Store *s) {
    EMState &E = s->em_state;
    E = EMState();
    E.rate_var = s->use_rate_variation;
    E.uer = s->using_error_rate;
    E.site_err = s->site_err;
    if (E.rate_var) {
        E.wts.assign((size_t)s->lRef * 4, 0.0);
        E.cs.assign(s->lRef, 0.0);
        E.tns.assign(s->lRef + 1, 0.0);
    }
    if (E.uer && E.site_err) {
        E.obs_sites.assign(s->lRef + 1, 0.0);
        E.err_sites.assign(s->lRef, 0.0);
    }
}

// One branch's accumulation (em.py main loop, reference :10141-10806).
// mut_pos/mut_alt = the node's current MAT frame-difference list
// (host-maintained via pass_mutation_list_through_branch).
void em_branch(Store *s, int64_t vP_id, int64_t vC_id, double dist,
               int node_is_leaf, int n_minor, const int32_t *mut_pos,
               const int8_t *mut_alt, int n_mut) {
    const Store &S = *s;
    EMState &E = s->em_state;
    const Vec &vP = s->v(vP_id);
    const Vec &vC = s->v(vC_id);
    prefetch_entries(vP);
    prefetch_entries(vC);
    const bool leaf = node_is_leaf != 0;
    const bool rv = E.rate_var;
    const int uer1 = E.uer ? 1 : 0;
    const int lRef = S.lRef;
    if (rv) E.tot_tree_length += dist;
    size_t i1x = 0, i2x = 0;
    int pos = 0;
    int iml = 0;
    const Entry *e1 = &vP[0];
    const Entry *e2 = &vC[0];
    while (true) {
        while (iml < n_mut && mut_pos[iml] < pos) iml++;
        const int c1 = e1->type;
        const int c2 = e2->type;
        if (c2 == TYPE_N) {
            int end = (c1 == TYPE_R || c1 == TYPE_N)
                      ? std::min(e1->val, e2->val) : pos + 1;
            if (E.uer && leaf) {
                if (E.site_err)
                    E.obs_sites[pos] -= 1 + n_minor;
                else
                    E.observed_tot -= (double)(end - pos) * (1 + n_minor);
            }
            if (rv) E.tns[pos] -= dist;
            pos = end;
            if (rv) E.tns[pos] += dist;
            if (E.uer && E.site_err && leaf) E.obs_sites[pos] += 1 + n_minor;
        } else if (c1 == TYPE_N) {
            int end = (c2 == TYPE_R) ? std::min(e1->val, e2->val) : pos + 1;
            if (rv) E.tns[pos] -= dist;
            pos = end;
            if (rv) E.tns[pos] += dist;
        } else {
            double tot_len1 = dist;
            if (c1 < TYPE_N) {
                int len1 = tuple_len(S, *e1);
                if (len1 == 3 + uer1) tot_len1 += e1->bl1;
                else if (len1 == 4 + uer1) tot_len1 += e1->bl2;
            } else {
                if (tuple_len(S, *e1) > 3) tot_len1 += e1->bl1;
            }
            double tot_len2 = 0.0;
            if (c2 < TYPE_N) {
                if (tuple_len(S, *e2) > 2 + uer1) tot_len2 += e2->bl1;
            } else {
                if (tuple_len(S, *e2) > 3) tot_len2 += e2->bl1;
            }

            if (c1 == TYPE_R && c2 == TYPE_R) {
                int end = std::min(e1->val, e2->val);
                if (tot_len2 == 0.0 && dist != 0.0) {
                    for (int i = 0; i < 4; i++)
                        E.waiting_times[i] += tot_len1
                            * (S.cumulative_bases[end * 4 + i]
                               - S.cumulative_bases[pos * 4 + i]);
                    while (iml < n_mut && mut_pos[iml] < end) {
                        int alt_pos = mut_pos[iml];
                        int alt_nuc = mut_alt[iml];
                        int ref_nuc = S.ref_indices[alt_pos];
                        E.waiting_times[ref_nuc] -= tot_len1;
                        E.waiting_times[alt_nuc] += tot_len1;
                        iml++;
                        if (rv) {
                            E.wts[(alt_pos - 1) * 4 + alt_nuc] += tot_len1;
                            E.wts[(alt_pos - 1) * 4 + ref_nuc] -= tot_len1;
                        }
                    }
                }
                pos = end;
            } else {
                if (c1 == TYPE_O) {
                    if (tot_len2 == 0.0) {
                        if (rv)
                            E.wts[pos * 4 + S.ref_indices[pos]] -= tot_len1;
                        if (c2 == TYPE_O)
                            E.error_count += em_O_O(S, E, *e1, *e2,
                                                    tot_len1, pos, leaf);
                        else
                            E.error_count += em_O_nuc(S, E, *e1, *e2,
                                                      tot_len1, pos, leaf,
                                                      n_minor > 0);
                    }
                } else {
                    int i1 = (c1 == TYPE_R) ? e2->val : c1;
                    if (c2 == TYPE_O) {
                        E.error_count += em_nuc_O(S, E, *e1, *e2, i1,
                                                  tot_len1, tot_len2, pos,
                                                  leaf, uer1);
                    } else {
                        int i2 = (e2->type < TYPE_R) ? e2->type : e1->val;
                        E.error_count += em_nuc_nuc(S, E, *e1, i1, i2,
                                                    tot_len1, tot_len2,
                                                    pos, leaf, n_minor > 0,
                                                    uer1);
                    }
                }
                pos += 1;
            }
        }

        if (pos == lRef) break;
        const int t1 = e1->type;
        if (t1 < TYPE_R || t1 == TYPE_O) e1 = &vP[++i1x];
        else if (pos == e1->val) e1 = &vP[++i1x];
        const int t2 = e2->type;
        if (t2 < TYPE_R || t2 == TYPE_O) e2 = &vC[++i2x];
        else if (pos == e2->val) e2 = &vC[++i2x];
    }
}

void em_totals(Store *s, double *counts16, double *wt4, double *scalars) {
    const EMState &E = s->em_state;
    for (int i = 0; i < 4; i++)
        for (int j = 0; j < 4; j++) counts16[i * 4 + j] = E.counts[i][j];
    for (int i = 0; i < 4; i++) wt4[i] = E.waiting_times[i];
    scalars[0] = E.error_count;
    scalars[1] = E.observed_tot;
    scalars[2] = E.tot_tree_length;
}

// rate-var site arrays: wts lRef*4, cs lRef, tns lRef+1
void em_site_arrays(Store *s, double *wts, double *cs, double *tns) {
    const EMState &E = s->em_state;
    std::copy(E.wts.begin(), E.wts.end(), wts);
    std::copy(E.cs.begin(), E.cs.end(), cs);
    std::copy(E.tns.begin(), E.tns.end(), tns);
}

// error-model site arrays: observed lRef+1, err lRef
void em_error_arrays(Store *s, double *obs_sites, double *err_sites) {
    const EMState &E = s->em_state;
    std::copy(E.obs_sites.begin(), E.obs_sites.end(), obs_sites);
    std::copy(E.err_sites.begin(), E.err_sites.end(), err_sites);
}

int64_t vec_create(Store *s, int n, const int8_t *types,
                   const int32_t *vals, const double *bl1,
                   const double *bl2, const uint8_t *bits,
                   const double *probs, const int32_t *tags) {
    int64_t id = s->alloc();
    Vec &v = s->v(id);
    v.resize(n);
    for (int k = 0; k < n; k++) {
        v[k].type = types[k];
        v[k].val = vals[k];
        v[k].bits = bits[k];
        v[k].bl1 = bl1[k];
        v[k].bl2 = bl2[k];
        int32_t tg = tags ? tags[k] : -1;
        if (v[k].type == TYPE_O || tg >= 0) {
            v[k].pp = prob_new1();
            for (int i = 0; i < 4; i++) v[k].pp->p[i] = probs[k * 4 + i];
            v[k].pp->tag = tg;
        }
        if (tg >= 0) s->tags_active = true;
    }
    s->finish(id);
    return id;
}

void vec_release(Store *s, int64_t id) {
    // keep capacity: released slots are recycled by alloc(), so steady
    // state runs with zero per-merge heap traffic
    s->v(id).clear();
    s->dbg_check_free(id);
    s->free_slots.push_back(id);
}

// core/genomelist.py terminal_node_genome_list (reference
// probVectTerminalNode :3882-3962) built directly in the store — the
// per-sample python tuple construction + upload loop costs ~300 us/sample
// at pandemic scale.  Gated by the host to runs WITHOUT an active error
// model: in that regime the shared ambiguity indicator lists are pristine
// (error refreshes are the only mutators, :3959), so the static table
// below is exact.  chars = raw lowercase diff characters; lens[k] = run
// length (1 for point entries).  Returns the new vector id, or -1 for an
// unrecognized character (host falls back to the python constructor).
static const double *amb_probs(char c) {
    static const struct { char c; double p[4]; } AMB[] = {
        {'y', {0.0, 1.0, 0.0, 1.0}}, {'r', {1.0, 0.0, 1.0, 0.0}},
        {'w', {1.0, 0.0, 0.0, 1.0}}, {'s', {0.0, 1.0, 1.0, 0.0}},
        {'k', {0.0, 0.0, 1.0, 1.0}}, {'m', {1.0, 1.0, 0.0, 0.0}},
        {'d', {1.0, 0.0, 1.0, 1.0}}, {'v', {1.0, 1.0, 1.0, 0.0}},
        {'h', {1.0, 1.0, 0.0, 1.0}}, {'b', {0.0, 1.0, 1.0, 1.0}},
    };
    for (const auto &a : AMB)
        if (a.c == c) return a.p;
    return nullptr;
}

int64_t vec_from_diffs(Store *s, int n, const int8_t *chars,
                       const int32_t *pos, const int32_t *lens,
                       int only_n_ambiguities) {
    int64_t id = s->alloc();
    Vec &v = s->v(id);
    v.reserve(2 * n + 1);
    int cur_pos = 1;
    const int lRef = s->lRef;
    Entry e;
    for (int k = 0; k < n; k++) {
        int cur = pos[k];
        if (cur > cur_pos) {
            e.type = TYPE_R;
            e.val = cur - 1;
            v.push_back(e);
            cur_pos = cur;
        }
        char c = (char)chars[k];
        if (c == 'n' || c == '-') {
            e.type = TYPE_N;
            e.val = cur + lens[k] - 1;
            v.push_back(e);
            cur_pos = cur + lens[k];
        } else if (c == 'a' || c == 'c' || c == 'g' || c == 't') {
            int nuc = c == 'a' ? 0 : c == 'c' ? 1 : c == 'g' ? 2 : 3;
            int refn = s->ref_indices[cur - 1];
            if (nuc == refn) {
                e.type = TYPE_R;
                e.val = cur;
            } else {
                e.type = (int8_t)nuc;
                e.val = refn;
            }
            v.push_back(e);
            cur_pos = cur + 1;
        } else {
            if (only_n_ambiguities) {
                e.type = TYPE_N;
                e.val = cur;
                v.push_back(e);
            } else {
                const double *p = amb_probs(c);
                if (!p) {
                    v.clear();
                    s->dbg_check_free(id);
                    s->free_slots.push_back(id);
                    return -1;
                }
                v.push_back(make_O(s->ref_indices[cur - 1], false, 0.0, p));
            }
            cur_pos = cur + 1;
        }
    }
    if (cur_pos <= lRef) {
        e.type = TYPE_R;
        e.val = lRef;
        v.push_back(e);
    }
    s->finish(id);
    return id;
}

// Batched vec_from_diffs: one call builds a whole placement batch's
// terminal vectors (counts[i] diff entries per sample, concatenated
// arrays).  out[i] = vec id, or -1 when sample i needs the python
// constructor (ambiguity code outside the fast table); successfully built
// ids for such a mixed batch stay valid.
void vec_from_diffs_batch(Store *s, int64_t n_samples,
                          const int64_t *counts, const int8_t *chars,
                          const int32_t *pos, const int32_t *lens,
                          int only_n_ambiguities, int64_t *out) {
    int64_t off = 0;
    for (int64_t i = 0; i < n_samples; i++) {
        out[i] = vec_from_diffs(s, (int)counts[i], chars + off,
                                pos + off, lens + off,
                                only_n_ambiguities);
        off += counts[i];
    }
}

int vec_size(Store *s, int64_t id) { return (int)s->v(id).size(); }

// Entry-category counts for the genome-list statistics print
// (partials.py _count_node; reference :6299-6345): out = [nucs, Rs, Ns,
// Os].  Avoids a full tuple export just to classify entries.
void vec_type_counts(Store *s, int64_t id, int64_t *out) {
    const Vec &v = s->v(id);
    int64_t nuc = 0, r = 0, n = 0, o = 0;
    for (size_t k = 0; k < v.size(); k++) {
        int t = v[k].type;
        if (t < 4) nuc++;
        else if (t == TYPE_R) r++;
        else if (t == TYPE_N) n++;
        else o++;
    }
    out[0] = nuc; out[1] = r; out[2] = n; out[3] = o;
}

void vec_export(Store *s, int64_t id, int8_t *types, int32_t *vals,
                double *bl1, double *bl2, uint8_t *bits, double *probs) {
    const Vec &v = s->v(id);
    for (size_t k = 0; k < v.size(); k++) {
        types[k] = v[k].type;
        vals[k] = v[k].val;
        bits[k] = v[k].bits;
        bl1[k] = v[k].bl1;
        bl2[k] = v[k].bl2;
        if (v[k].pp)
            for (int i = 0; i < 4; i++) probs[k * 4 + i] = v[k].pp->p[i];
        else
            for (int i = 0; i < 4; i++) probs[k * 4 + i] = 0.0;
    }
}

void vec_export_tags(Store *s, int64_t id, int32_t *tags) {
    const Vec &v = s->v(id);
    for (size_t k = 0; k < v.size(); k++) tags[k] = v[k].etag();
}

// Write a mutated shared tip probability list into every live entry that
// mirrors it (the native equivalent of the reference's in-place mutation
// of an aliased list, :3959).  Registry refs may be stale; writing the
// list's current values into any entry carrying the tag is always
// correct, so validation is bounds + tag match, dropping failures.
void store_patch_tag(Store *s, int32_t tag, const double *probs) {
    auto it = s->tag_registry.find(tag);
    if (it == s->tag_registry.end()) return;
    auto &refs = it->second;
    if (refs.size() > 4096) {
        std::sort(refs.begin(), refs.end());
        refs.erase(std::unique(refs.begin(), refs.end()), refs.end());
    }
    size_t w = 0;
    for (auto &r : refs) {
        Vec &v = s->v(r.first);
        if (r.second < (int32_t)v.size() && v[r.second].etag() == tag) {
            for (int i = 0; i < 4; i++) v[r.second].pp->p[i] = probs[i];
            refs[w++] = r;
        }
    }
    refs.resize(w);
}

int64_t k_merge(Store *s, int64_t v1, double bl1, int tip1, int64_t v2,
                double bl2, int tip2, int is_up_down, int do_shorten) {
    int64_t id = s->alloc();
    double lk;
    int rc = merge_vectors(*s, s->v(v1), bl1, tip1 != 0, s->v(v2), bl2,
                           tip2 != 0, false, is_up_down != 0, 0, 0,
                           s->v(id), &lk);
    if (rc != 0) {
        s->dbg_check_free(id);
        s->free_slots.push_back(id);
        return -1;
    }
    if (do_shorten) shorten_vec(*s, s->v(id));
    s->finish(id);
    return id;
}

int64_t k_merge_lk(Store *s, int64_t v1, double bl1, int tip1, int64_t v2,
                   double bl2, int tip2, int is_up_down, int n_minor1,
                   int n_minor2, int do_shorten, double *lk_out) {
    int64_t id = s->alloc();
    int rc = merge_vectors(*s, s->v(v1), bl1, tip1 != 0, s->v(v2), bl2,
                           tip2 != 0, true, is_up_down != 0, n_minor1,
                           n_minor2, s->v(id), lk_out);
    if (rc != 0) {
        s->dbg_check_free(id);
        s->free_slots.push_back(id);
        return -10 + rc;  // -11 impossible, -12 underflow
    }
    if (do_shorten) shorten_vec(*s, s->v(id));
    s->finish(id);
    return id;
}

double k_append(Store *s, int64_t vP, int64_t vC, int tip_c, double blen) {
    return append_prob_node(*s, s->v(vP), s->v(vC), tip_c != 0, blen);
}

void k_shorten(Store *s, int64_t id) {
    shorten_vec(*s, s->v(id));
    s->finish(id);  // re-register: shorten shifts entry indices
}

double k_blen(Store *s, int64_t vP, int64_t vC, int from_tip_c) {
    return estimate_branch_length(*s, s->v(vP), s->v(vC), from_tip_c != 0);
}

int64_t k_pass(Store *s, int64_t v, const int32_t *muts, int n_mut,
               int dir_is_up, int do_shorten) {
    int64_t id = s->alloc();
    Vec tmp;  // source may be reallocated if v's slot equals id
    pass_through_branch(*s, s->v(v), muts, n_mut, dir_is_up != 0, tmp);
    s->v(id) = std::move(tmp);
    if (do_shorten) shorten_vec(*s, s->v(id));
    s->finish(id);
    return id;
}

int64_t k_root_vector(Store *s, int64_t v, double blen, int from_tip,
                      int do_shorten) {
    int64_t id = s->alloc();
    Vec tmp;
    root_vector_frame(*s, s->v(v), blen, from_tip != 0, tmp);
    s->v(id) = std::move(tmp);
    if (do_shorten) shorten_vec(*s, s->v(id));
    s->finish(id);
    return id;
}

double k_find_prob_root(Store *s, int64_t v) {
    return find_prob_root_frame(*s, s->v(v));
}

int k_different(Store *s, int64_t v1, int64_t v2) {
    if (v2 < 0) return 1;
    return are_vectors_different(*s, s->v(v1), s->v(v2)) ? 1 : 0;
}

int k_minor(Store *s, int64_t v1, int64_t v2, int only_identical) {
    return is_minor_sequence(*s, s->v(v1), s->v(v2), only_identical != 0);
}

void k_pseudo_counts(Store *s, int64_t v1, int64_t v2, double *counts) {
    update_pseudo_counts(*s, s->v(v1), s->v(v2), counts);
}

int k_num_non4(Store *s, int64_t v) {
    int n = 0;
    for (const Entry &e : s->v(v))
        if (e.type < 4) n++;
    return n;
}



}  // extern "C"


// ======================================================================
// Native placement engine: stepwise-addition DFS + placement + dirty
// propagation run entirely in C++ over store-owned vectors.  A direct
// port of maple_tpu/search/placement.py (find_best_parent_for_new_sample
// :36-246, place_sample_on_tree :397-670) and
// maple_tpu/runtime/partials.py (update_partials :214-450,
// make_node_reference :547-595, root_vector :145-171) — reference
// findBestParentForNewSample :7912-8293, placeSampleOnTree :8370-8710,
// updatePartials :5479-5817, makeNodeReference :8296-8353.
// Covers the default de-novo path: no HnZ, no rate variation, no error
// rates, no deeper-long-branch search (the Python caller gates on this).
// ======================================================================

#include <unordered_set>
#include <cmath>
#include <string>

namespace {

// ---------------------------------------------------------------------
// Speculative placement-score pool.
//
// The stepwise-addition DFS (reference :7912-8293) pops stack items in a
// fixed serial order and *unconditionally* scores every popped item
// (appendProbNode for nodes with dist>eff0, isMinorSequence for leaves);
// only the *expansion* decision depends on evolving search state.  Score
// values are pure functions of (vector, vector, blen), so worker threads
// can compute them speculatively as soon as items are pushed while the
// main thread makes every decision in exact serial order — byte-identical
// results, parallel wall-clock.
//
// Exactness protocol: the one in-search mutation is shorten() on the
// current diffs list at a new-best event.  When a shorten would actually
// change the representation (rare), cancel_unconsumed() discards every
// not-yet-consumed speculative result first; the main thread then
// recomputes those scores inline at pop time, after the shorten — exactly
// what the serial loop does.  No result computed against a stale
// representation is ever used.
struct alignas(64) ScoreTask {
    std::atomic<uint8_t> state{0};  // 0=no result (main computes inline),
                                    // 1=pending, 2=running, 3=done,
                                    // 4=consumed
    uint8_t kind = 0;               // 0=append score, 1=minor-seq check
    int64_t va = -1, vb = -1;
    double blen = 0.0;
    double result = 0.0;
};

static inline void cpu_pause() {
#if defined(__x86_64__) || defined(__i386__)
    __builtin_ia32_pause();
#endif
}

struct ScorePool {
    static constexpr int TCHUNK_BITS = 12;
    static constexpr size_t TCHUNK = (size_t)1 << TCHUNK_BITS;
    size_t RESERVE = 2;   // newest tasks left for the main thread
    int spin_limit = 50000;
    Store *S = nullptr;
    bool only_identical = false;
    std::vector<std::unique_ptr<ScoreTask[]>> chunks;
    std::atomic<size_t> count{0};
    std::atomic<size_t> next_scan{0};
    std::atomic<int> sleeping{0};
    std::atomic<bool> stop{false};
    // consume-path telemetry (main thread only; plain counters)
    size_t n_hit = 0, n_inline = 0, n_wait = 0, n_cancel = 0;
    uint64_t worker_cy = 0;  // approx cycles workers spent computing
    std::mutex mu;
    std::condition_variable cv;
    std::vector<std::thread> threads;

    ScoreTask &task(size_t i) {
        return chunks[i >> TCHUNK_BITS][i & (TCHUNK - 1)];
    }

    void start(Store *store, bool only_ident, int n_threads) {
        S = store;
        only_identical = only_ident;
        if (const char *e = getenv("MAPLE_POOL_RESERVE"))
            RESERVE = (size_t)atoi(e);
        chunks.reserve((size_t)1 << 16);  // table never reallocates
        for (int i = 0; i < n_threads; i++)
            threads.emplace_back([this] { worker(); });
    }

    ~ScorePool() {
        stop.store(true);
        { std::lock_guard<std::mutex> g(mu); }
        cv.notify_all();
        for (auto &t : threads) t.join();
        if (getenv("MAPLE_POOL_STATS"))
            fprintf(stderr, "# pool: hit=%zu inline=%zu wait=%zu "
                    "cancel=%zu\n", n_hit, n_inline, n_wait, n_cancel);
    }

    bool active() const { return !threads.empty(); }

    // main thread: new search; all prior tasks are consumed or canceled.
    void reset() {
        count.store(0, std::memory_order_relaxed);
        next_scan.store(0, std::memory_order_relaxed);
    }

    // main thread: publish one speculative task, returns its index.
    size_t add(uint8_t kind, int64_t va, int64_t vb, double blen) {
        size_t i = count.load(std::memory_order_relaxed);
        if (i == chunks.size() * TCHUNK)
            chunks.emplace_back(new ScoreTask[TCHUNK]);
        ScoreTask &t = task(i);
        t.kind = kind;
        t.va = va;
        t.vb = vb;
        t.blen = blen;
        t.state.store(1, std::memory_order_release);
        count.store(i + 1, std::memory_order_release);
        if (sleeping.load(std::memory_order_relaxed) > 0)
            cv.notify_one();
        return i;
    }

    void compute(ScoreTask &t) {
        if (t.kind == 0)
            t.result = append_prob_node(*S, S->v(t.va), S->v(t.vb), true,
                                        t.blen);
        else
            t.result = (double)is_minor_sequence(*S, S->v(t.va), S->v(t.vb),
                                                 only_identical);
    }

    // main thread: fetch a task's result, computing inline when no worker
    // produced one (unclaimed or canceled).
    double consume(size_t i) {
        ScoreTask &t = task(i);
        bool waited = false;
        for (;;) {
            uint8_t st = t.state.load(std::memory_order_acquire);
            if (st == 1) {
                if (t.state.compare_exchange_strong(
                        st, 4, std::memory_order_acq_rel)) {
                    n_inline++;
                    compute(t);
                    return t.result;
                }
                continue;
            }
            if (st == 0) { n_inline++; compute(t); return t.result; }
            if (st == 2) { waited = true; cpu_pause(); continue; }
            // st == 3
            if (waited) n_wait++; else n_hit++;
            t.state.store(4, std::memory_order_relaxed);
            return t.result;
        }
    }

    // main thread: discard every not-yet-consumed speculative result
    // (before an in-place representation change, or when abandoning the
    // search on a minor-sequence absorption).  Waits out in-flight
    // computations; afterwards no worker touches any vector.
    void cancel_unconsumed() {
        size_t n = count.load(std::memory_order_relaxed);
        for (size_t i = 0; i < n; i++) {
            ScoreTask &t = task(i);
            for (;;) {
                uint8_t st = t.state.load(std::memory_order_acquire);
                if (st == 0 || st == 4) break;
                if (st == 2) { cpu_pause(); continue; }
                if (t.state.compare_exchange_strong(
                        st, 0, std::memory_order_acq_rel)) {
                    if (st == 3) n_cancel++;
                    break;
                }
            }
        }
        next_scan.store(n, std::memory_order_relaxed);
    }

    void worker() {
        int idle_spins = 0;
        for (;;) {
            if (stop.load(std::memory_order_relaxed)) return;
            size_t cnt = count.load(std::memory_order_acquire);
            size_t i = next_scan.load(std::memory_order_relaxed);
            // reserve window: leave the newest tasks for the main thread
            // (a DFS pops the just-pushed child immediately — a worker
            // claiming it would make main spin behind a cold cache)
            if (i + RESERVE >= cnt) {
                if (++idle_spins < spin_limit) { cpu_pause(); continue; }
                std::unique_lock<std::mutex> lk(mu);
                sleeping.fetch_add(1, std::memory_order_relaxed);
                cv.wait_for(lk, std::chrono::milliseconds(2));
                sleeping.fetch_sub(1, std::memory_order_relaxed);
                idle_spins = 0;
                continue;
            }
            i = next_scan.fetch_add(1, std::memory_order_relaxed);
            if (i + RESERVE >= cnt) {
                // overshoot: give the ticket back if nobody raced us
                size_t e = i + 1;
                next_scan.compare_exchange_strong(
                    e, i, std::memory_order_relaxed);
                continue;
            }
            idle_spins = 0;
            ScoreTask &t = task(i);
            uint8_t exp = 1;
            if (t.state.compare_exchange_strong(
                    exp, 2, std::memory_order_acq_rel)) {
                compute(t);
                t.state.store(3, std::memory_order_release);
            }
        }
    }
};

// read-only twin of shorten_vec's merge test: would it change anything?
static bool shorten_would_change(const Store &S, const Vec &v) {
    for (size_t i = 0; i + 1 < v.size(); i++) {
        const Entry &prev = v[i];
        const Entry &cur = v[i + 1];
        if (cur.type != TYPE_R || prev.type != TYPE_R) continue;
        int n = tuple_len(S, cur);
        if (n != tuple_len(S, prev)) continue;
        if (n == 2) return true;
        if (std::fabs(cur.bl1 - prev.bl1) > S.threshold_prob) continue;
        if (n == 3) return true;
        if (!cur.has_bl2()) {
            if (cur.flag() == prev.flag()) return true;
            continue;
        }
        if (std::fabs(cur.bl2 - prev.bl2) > S.threshold_prob) continue;
        if (n == 4) return true;
        if (cur.flag() == prev.flag()) return true;
    }
    return false;
}

// Persistent worker pool: the batched placement phases run in
// model-refresh-cadence chunks (25 samples), so per-call std::thread
// spawns cost ~4 threads x 4k calls x ~80 us = >1 s per 100k samples.
// Workers park on a condition variable between jobs; run() blocks the
// caller until all workers finish the current job (same semantics as
// the spawn-and-join it replaces).
struct ExecPool {
    std::vector<std::thread> threads;
    std::mutex mu;
    std::condition_variable cv, done_cv;
    const std::function<void(int)> *job = nullptr;
    uint64_t job_id = 0;
    int n_target = 0;      // workers participating in current job
    int n_done = 0;
    bool stop = false;

    void ensure(int T) {
        while ((int)threads.size() < T) {
            int idx = (int)threads.size();
            threads.emplace_back([this, idx]() {
                uint64_t seen = 0;
                std::unique_lock<std::mutex> lk(mu);
                for (;;) {
                    cv.wait(lk, [&] {
                        return stop || (job_id != seen && idx < n_target);
                    });
                    if (stop) return;
                    seen = job_id;
                    const std::function<void(int)> *j = job;
                    lk.unlock();
                    (*j)(idx);
                    lk.lock();
                    if (++n_done == n_target) done_cv.notify_all();
                }
            });
        }
    }

    // Serializes concurrent run() callers: the device placer's screen
    // thread exports query features (engine_export_query_feats, which
    // fans out here) WHILE the main thread runs the seeded place batch
    // — without this, two in-flight jobs clobber job/n_target/n_done
    // and both callers deadlock on done_cv.
    std::mutex run_mu;

    // Run fn(0..T-1) on pool workers; blocks until all return.
    void run(int T, const std::function<void(int)> &fn) {
        if (T <= 1) {
            fn(0);
            return;
        }
        std::lock_guard<std::mutex> rg(run_mu);
        ensure(T);
        std::unique_lock<std::mutex> lk(mu);
        job = &fn;
        n_target = T;
        n_done = 0;
        job_id++;
        cv.notify_all();
        done_cv.wait(lk, [&] { return n_done == n_target; });
        job = nullptr;
        n_target = 0;
    }

    ~ExecPool() {
        {
            std::lock_guard<std::mutex> g(mu);
            stop = true;
        }
        cv.notify_all();
        for (auto &t : threads) t.join();
    }
};

struct Engine {
    Store *S;
    ExecPool exec_pool;
    // tree arrays (index = node id, allocation order identical to the
    // Python PhyloTree.add_node sequence so downstream traversals match)
    std::vector<int32_t> up, c0, c1;          // -1 = none
    std::vector<double> dist;
    std::vector<int32_t> name;                // sample id, -1 = internal
    std::vector<int32_t> nDesc;
    std::vector<uint8_t> dirty;
    std::vector<std::vector<int32_t>> minorSeqs;
    std::vector<std::vector<int32_t>> muts;   // flat (pos,from,to) triples
    std::vector<int64_t> pv, upR, upL, totUp; // vec ids, -1 = None
    int32_t root = 0;
    // config
    bool strict_stop = true, only_identical = false, use_refs = true;
    int allowed_fails = 0;
    double threshold_log_lk = 0, threshold_opt = 0, threshold_consec = 0;
    double one_mut = 0, eff0 = 0;
    int max_ndesc_clade = 0, min_num_non4 = 0;
    // SPR-phase parameters (set by engine_import)
    double threshold_opt_topology = 0;
    double threshold_topology_placement = 0;
    double default_blen = 0;
    int max_replacements = 0;
    std::vector<int32_t> replacements;
    // HnZ lineage-abundance modifiers (reference :305-328); hnz_mode 0 =
    // off.  nDesc0 = effective-multifurcation sizes; hnz_vec memoizes the
    // per-mode score exactly like models/hnz.get_hnz (same float-op
    // order: mode 1 accumulates log(2n-3), mode 2 computes n*log(n)).
    int hnz_mode = 0;
    std::vector<int32_t> nDesc0;
    std::vector<double> hnz_vec;
    double hnz(int n) {
        if (n <= 0) { error = "HnZ score for non-positive nDesc0"; return 0.0; }
        if (hnz_vec.empty()) {
            hnz_vec = {0.0, 0.0, hnz_mode == 1 ? 0.0 : 2 * std::log(2.0)};
        }
        while ((int)hnz_vec.size() <= n) {
            int cur = (int)hnz_vec.size();
            if (hnz_mode == 1)
                hnz_vec.push_back(hnz_vec.back() + std::log(2.0 * cur - 3));
            else
                hnz_vec.push_back(cur * std::log((double)cur));
        }
        return hnz_vec[n];
    }
    // partials.update_ndesc0_changing_dist (reference :5361-5380)
    void nd0_changing_dist(int node, double new_dist) {
        int32_t addendum;
        if (dist[node] > eff0 && new_dist <= eff0)
            addendum = nDesc0[node] - 1;
        else if (dist[node] <= eff0 && new_dist > eff0)
            addendum = 1 - nDesc0[node];
        else
            return;
        int parent = up[node];
        nDesc0[parent] += addendum;
        while (up[parent] >= 0 && dist[parent] <= eff0) {
            parent = up[parent];
            nDesc0[parent] += addendum;
        }
    }
    // placement.py try_absorb_minor nDesc0 bump (:102-108)
    void nd0_absorb(int node) {
        nDesc0[node] += 1;
        if (dist[node] <= eff0 && up[node] >= 0) {
            int p0 = node;
            while (dist[p0] <= eff0 && up[p0] >= 0) {
                p0 = up[p0];
                nDesc0[p0] += 1;
            }
        }
    }
    // proxy-screen feature fingerprints (engine_export_feats): 0 =
    // never exported / unstable, 1 = exported-as-invalid, else FNV-1a
    // of the feature row last handed to the host
    std::vector<uint64_t> feat_fp;
    // accumulators / stats
    double counts[16] = {};
    int num_refs = 0;
    int num_minors_found = 0, total_missed_minors = 0, num_child_lks = 0;
    int64_t dfs_visits = 0, fine_evals = 0;  // placement-search telemetry
#ifdef MAPLE_PROFILE
    uint64_t p_append_cy = 0, p_pass_cy = 0, p_fine_cy = 0, p_place_cy = 0;
    uint64_t p_find_cy = 0;
    int64_t p_scored = 0, p_free = 0, p_entries = 0;
    int64_t p_tot_entries = 0, p_o_entries = 0;
    // cross-sample speculation viability probe: would a search running
    // concurrently with the previous k placements have read state those
    // placements wrote?  write_stamp[node] = seq of last placement that
    // touched the node; per search we record the min (cur_seq - stamp)
    // over visited nodes -> a speculation pipelined at depth d is valid
    // iff min_gap > d.  p_gap_hist[d] counts searches with min_gap == d
    // (d capped at 15).
    std::vector<int64_t> write_stamp;
    int64_t place_seq = 0;
    int64_t p_gap_hist[16] = {};
    void stamp(int node) {
        if ((size_t)node >= write_stamp.size())
            write_stamp.resize(node + 1024, -1000000);
        write_stamp[node] = place_seq;
    }
#endif
    double sum_child_lks = 0.0;
    int warned_blen = 0;
    double warned_blen_value = 0.0;
    std::string error;
    // per-call temporary ownership: every vec id allocated during a
    // place() call lands here; installing into a tree slot removes it
    // (and orphans the replaced id back in).  Released at call end.
    std::unordered_set<int64_t> owned;

    // speculative placement-score workers (see ScorePool above); started
    // lazily once the tree is big enough for threading to pay off.
    std::unique_ptr<ScorePool> pool;
    int place_threads = -1;  // -1 = decide from env/hw on first use
    // Best-first placement search (opt-in, engine_set_search_budget):
    // stop after this many consecutive non-improving scored nodes;
    // 0 = exact reference DFS.
    int64_t search_budget = 0;
    // Parallel SPR core assignment (parallel_spr.py assign_core_numbers,
    // reference :12164-12195): computed lazily on the first parallel
    // pass and kept for the run, like the host code's round-0 call.
    std::vector<int32_t> core_num;
    int cores_assigned = 0;
    // SPR-crawl budget (opt-in, engine_set_spr_budget): the per-node
    // re-attachment crawl stops after this many consecutive
    // non-improving scored candidates.  The crawl radiates outward from
    // the prune point, so the budget bounds it to the local
    // neighborhood where SPR moves actually land; 0 = exact reference
    // stop rules only.
    int64_t spr_budget = 0;
    // Root-search budget (opt-in, engine_set_root_budget): the
    // findBestRoot crawl runs best-first (on path score) and stops
    // after this many consecutive non-improving scored directions.  On
    // flat pandemic-scale trees the exact crawl's stop rules barely
    // prune (measured: ~all internal nodes visited at 20k samples), so
    // this is the root-search twin of search_budget / spr_budget;
    // 0 = exact reference DFS stop rules only.
    int64_t root_budget = 0;
    // Phase-parallel execution width for full-tree recomputes
    // (engine_set_threads; the host passes --numCores).  1 = serial.
    int exec_threads = 1;
    // Error-refresh patch schedule for engine_recalculate_err: the host
    // pre-computes every shared-ambiguity-list write the reference's
    // per-tip refresh would perform (updateProbVectTerminalNode
    // :3968-4006 — values depend only on error rates, not tree state)
    // and the engine replays each at its exact post-order position, so
    // mid-recompute merges read the same interleaved list states as the
    // python host loop.  node -> [begin, end) into err_tags/err_vals.
    std::unordered_map<int32_t, std::pair<int64_t, int64_t>> err_patches;
    const int32_t *err_tags = nullptr;
    const double *err_vals = nullptr;

    // Device proxy-screen support (engine_screen_*): while enabled,
    // every node whose mid-branch vector slot (totUp) is re-installed —
    // plus every new node — is logged so the host re-exports only those
    // rows to the device screen between batches.  The log is a recall
    // aid only: a missed entry can cost the screen a candidate, never
    // correctness (the batch apply re-validates every decision against
    // live vectors).
    bool screen_log_on = false;
    std::vector<int32_t> screen_log;
    // Batch-apply touch stamps (E_apply_batch scope): every node whose
    // ANY cached-vector slot (pv/upR/upL/totUp) is re-installed during
    // the serial apply is stamped, so a later proposal can prove its
    // speculative worker fine result read only untouched state.
    bool touch_on = false;
    std::vector<uint8_t> touch_stamp;
    // The device SPR pass of a live session (engine_spr_collect): the
    // global-frame translations of its queries and anchors, which the host
    // exports and packs, held until engine_spr_release.
    std::vector<int64_t> spr_held;

    int add_node() {
        up.push_back(-1); c0.push_back(-1); c1.push_back(-1);
        dist.push_back(0.0); name.push_back(-1); nDesc.push_back(0);
        dirty.push_back(1);
        replacements.push_back(0);
        nDesc0.push_back(1);
        minorSeqs.emplace_back(); muts.emplace_back();
        pv.push_back(-1); upR.push_back(-1); upL.push_back(-1);
        totUp.push_back(-1);
        if (screen_log_on) screen_log.push_back((int32_t)up.size() - 1);
#ifdef MAPLE_PROFILE
        stamp((int)up.size() - 1);
#endif
        return (int)up.size() - 1;
    }
    bool is_tip(int n) const {
        return c0[n] < 0 && minorSeqs[n].empty();
    }
    bool is_leaf(int n) const { return c0[n] < 0; }
    int child_index(int n) const { return c0[up[n]] == n ? 0 : 1; }
    int child(int n, int i) const { return i == 0 ? c0[n] : c1[n]; }
    int64_t vect_up_for(int n) const {
        return c0[up[n]] == n ? upR[up[n]] : upL[up[n]];
    }
    // Parallel SPR proposal workers (engine_spr_pass_parallel) run the
    // read-only search concurrently; each carries its own temp-ownership
    // set via this thread-local, so release()/end_call() stay wait-free.
    static thread_local std::unordered_set<int64_t> *tl_owned;
    std::unordered_set<int64_t> &own_set() {
        return tl_owned ? *tl_owned : owned;
    }
    void own(int64_t id) { if (id >= 0) own_set().insert(id); }
    // Eagerly reclaim an engine-owned temporary (no-op for tree-owned or
    // foreign ids).  Long crawls (root search) allocate a handful of
    // vectors per visited node; without eager release they all stay live
    // until end_call(), which at 10k+ nodes means gigabytes of
    // cache-hostile churn (measured 50x slower than the python crawl,
    // whose refcounting frees intermediates immediately).
    void release(int64_t id) {
        if (id < 0) return;
        auto &o = own_set();
        auto it = o.find(id);
        if (it == o.end()) return;
        o.erase(it);
        S->free_slot(id);
    }
    void install(int64_t *slot, int64_t id) {
        auto &o = own_set();
        if (*slot >= 0 && *slot != id) o.insert(*slot);
        if (id >= 0) o.erase(id);
        if (screen_log_on && !totUp.empty()) {
            // mid-branch slot write -> the node's screen row is stale
            size_t ix = (size_t)(slot - totUp.data());
            if (ix < totUp.size()) screen_log.push_back((int32_t)ix);
        }
        if (touch_on) {
            for (std::vector<int64_t> *arr : {&pv, &upR, &upL, &totUp}) {
                size_t ix = (size_t)(slot - arr->data());
                if (ix < arr->size()) {
                    if (ix < touch_stamp.size()) touch_stamp[ix] = 1;
                    break;
                }
            }
        }
        *slot = id;
    }
    void end_call() {
        auto &o = own_set();
        for (int64_t id : o) {
            S->v(id).clear();
        }
        {
            std::lock_guard<std::mutex> g(S->slot_mu);
            for (int64_t id : o) {
                S->dbg_check_free(id);
                S->free_slots.push_back(id);
            }
        }
        o.clear();
    }
};

thread_local std::unordered_set<int64_t> *Engine::tl_owned = nullptr;

// --- kernel wrappers with temp ownership ---
static int64_t E_merge(Engine *E, int64_t v1, double bl1, bool t1,
                       int64_t v2, double bl2, bool t2, bool updown) {
    Store *s = E->S;
    int64_t id = s->alloc();
    double lk;
    int rc = merge_vectors(*s, s->v(v1), bl1, t1, s->v(v2), bl2, t2,
                           false, updown, 0, 0, s->v(id), &lk);
    if (rc != 0) { s->free_slot(id); return -1; }  // locked: worker-reachable
    E->own(id);
    return id;
}

static int64_t E_merge_lk(Engine *E, int64_t v1, double bl1, bool t1,
                          int64_t v2, double bl2, bool t2, int nm1,
                          int nm2, double *lk_out) {
    Store *s = E->S;
    int64_t id = s->alloc();
    int rc = merge_vectors(*s, s->v(v1), bl1, t1, s->v(v2), bl2, t2,
                           true, false, nm1, nm2, s->v(id), lk_out);
    if (rc != 0) { s->free_slot(id); return -1; }  // locked: worker-reachable
    s->finish(id);
    E->own(id);
    return id;
}

static double E_append(Engine *E, int64_t vP, int64_t vC, bool tipc,
                       double blen) {
    return append_prob_node(*E->S, E->S->v(vP), E->S->v(vC), tipc, blen);
}

static double E_blen(Engine *E, int64_t vP, int64_t vC, bool from_tip) {
    double b = estimate_branch_length(*E->S, E->S->v(vP), E->S->v(vC),
                                      from_tip);
    return b < 0.0 ? 0.0 : b;  // Python returns False for "no branch"
}

static void E_shorten(Engine *E, int64_t id) {
    if (id >= 0) {
        shorten_vec(*E->S, E->S->v(id));
        // re-register tagged entries: shorten shifts entry indices, so
        // the alias-tag refs would go stale and store_patch_tag would
        // silently drop them (k_shorten does the same; no-op untagged)
        E->S->finish(id);
    }
}

static int64_t E_pass(Engine *E, int64_t v,
                      const std::vector<int32_t> &m, bool dir_up) {
    if (m.empty()) return v;
    Store *s = E->S;
    int64_t id = s->alloc();
    Vec tmp;
    pass_through_branch(*s, s->v(v), m.data(), (int)(m.size() / 3), dir_up,
                        tmp);
    s->v(id) = std::move(tmp);
    s->finish(id);
    E->own(id);
    return id;
}

static int64_t E_pass_down(Engine *E, int64_t v, int node) {
    return E_pass(E, v, E->muts[node], false);
}
static int64_t E_pass_up(Engine *E, int64_t v, int node) {
    return E_pass(E, v, E->muts[node], true);
}

// Frame-translate a terminal vector from the global reference frame to
// `node`'s local frame: pass down through every muts-bearing node on the
// root->node path (inclusive), mirroring what the search crawl does as
// it descends (placement.py find_best_parent_for_new_sample; reference
// passGenomeListThroughBranch :3749).  Returned id is engine-owned.
static int64_t E_diffs_at_node(Engine *E, int64_t vid, int node) {
    std::vector<int> path;
    for (int a = node; a >= 0; a = E->up[a]) path.push_back(a);
    int64_t d = vid;
    for (auto it = path.rbegin(); it != path.rend(); ++it)
        if (!E->muts[*it].empty()) d = E_pass_down(E, d, *it);
    return d;
}

// Memoized twin of E_diffs_at_node for one proposal's apply step: many
// candidate/region nodes share MAT frames (a frame is identified by the
// deepest muts-bearing node on the root->node path), and parent frames
// are shared prefixes — so each distinct frame costs exactly ONE
// incremental pass from its parent frame's cached translation instead
// of a full root-path walk per query node.  Valid only while the MAT
// mutation lists are unchanged (i.e. within one proposal, before
// E_place_sample / end_call).
struct FrameDiffCache {
    int64_t vid;                           // global-frame terminal
    std::unordered_map<int, int64_t> m;    // frame node -> translated id
};
static int64_t E_diffs_cached(Engine *E, FrameDiffCache &fc, int node) {
    int f = node;
    while (f >= 0 && E->muts[f].empty()) f = E->up[f];
    if (f < 0) return fc.vid;
    auto it = fc.m.find(f);
    if (it != fc.m.end()) return it->second;
    int64_t base = (E->up[f] >= 0) ? E_diffs_cached(E, fc, E->up[f])
                                   : fc.vid;
    int64_t d = E_pass_down(E, base, f);
    fc.m.emplace(f, d);
    return d;
}

// partials.py root_vector :145-161 — pass up to the global frame, apply
// root frequencies, pass back down into node's frame.
static int64_t E_root_vector(Engine *E, int64_t vec, double blen,
                             bool from_tip, int node) {
    std::vector<int> chain;
    int n = node;
    int64_t orig = vec;
    while (n >= 0) {
        chain.push_back(n);
        int64_t next = E_pass_up(E, vec, n);
        if (next != vec && vec != orig) E->release(vec);
        vec = next;
        n = E->up[n];
    }
    Store *s = E->S;
    int64_t id = s->alloc();
    Vec tmp;
    root_vector_frame(*s, s->v(vec), blen, from_tip, tmp);
    s->v(id) = std::move(tmp);
    s->finish(id);
    E->own(id);
    if (vec != orig) E->release(vec);
    vec = id;
    for (auto it = chain.rbegin(); it != chain.rend(); ++it) {
        int64_t next = E_pass_down(E, vec, *it);
        if (next != vec) E->release(vec);
        vec = next;
    }
    E_shorten(E, vec);
    return vec;
}

// partials.py find_prob_root :163-171
static double E_find_prob_root(Engine *E, int64_t vec, int node) {
    int n = node;
    int64_t orig = vec;
    while (n >= 0) {
        int64_t next = E_pass_up(E, vec, n);
        if (next != vec && vec != orig) E->release(vec);
        vec = next;
        n = E->up[n];
    }
    double out = find_prob_root_frame(*E->S, E->S->v(vec));
    if (vec != orig) E->release(vec);
    return out;
}

static bool E_different(Engine *E, int64_t v1, int64_t v2) {
    if (v1 < 0 || v2 < 0) return true;
    return are_vectors_different(*E->S, E->S->v(v1), E->S->v(v2));
}

struct WorkItem { int32_t node; int32_t dir; uint8_t lk_dirty; };

// partials.py update_blen :174-194
static void E_update_blen(Engine *E, int c_node, bool add_to_list,
                          std::vector<WorkItem> *wl) {
    int node = E->up[c_node];
    int c_num = E->child_index(c_node);
    int64_t vect_up = c_num == 0 ? E->upR[node] : E->upL[node];
    vect_up = E_pass_down(E, vect_up, c_node);
    double best = E_blen(E, vect_up, E->pv[c_node], E->is_tip(c_node));
    if (E->hnz_mode) E->nd0_changing_dist(c_node, best);
    E->dist[c_node] = best;
    E->dirty[node] = 1;
    E->dirty[c_node] = 1;
#ifdef MAPLE_PROFILE
    E->stamp(node);
    E->stamp(c_node);
#endif
    if (add_to_list) {
        wl->push_back({(int32_t)c_node, 2, 1});
        wl->push_back({(int32_t)node, (int32_t)c_num, 1});
    }
}

// partials.py update_partials :214-450 (no-HnZ path)
static bool E_update_partials(Engine *E, std::vector<WorkItem> wl) {
    while (!wl.empty()) {
        bool updated_blen = false, made_change = false;
        WorkItem it = wl.back(); wl.pop_back();
        int node = it.node, direction = it.dir;
        bool lk_dirty = it.lk_dirty != 0;
        E->dirty[node] = 1;
#ifdef MAPLE_PROFILE
        E->stamp(node);
#endif
        int64_t vect_up_up = -1;
        int child_num_up = -1;
        if (E->up[node] >= 0) {
            child_num_up = E->child_index(node);
            vect_up_up = child_num_up == 0 ? E->upR[E->up[node]]
                                           : E->upL[E->up[node]];
            if (!E->muts[node].empty() && lk_dirty)
                vect_up_up = E_pass_down(E, vect_up_up, node);
        }
        bool is_tip = E->is_tip(node);
        if (direction == 2) {
            if (E->dist[node] != 0.0) {
                if (lk_dirty) {
                    int64_t new_tot = E_merge(E, vect_up_up,
                        E->dist[node] / 2, false, E->pv[node],
                        E->dist[node] / 2, is_tip, true);
                    if (new_tot < 0) {
                        E_update_blen(E, node, false, nullptr);
                        wl.push_back({(int32_t)E->up[node],
                                      (int32_t)child_num_up, 1});
                        new_tot = E_merge(E, vect_up_up, E->dist[node] / 2,
                            false, E->pv[node], E->dist[node] / 2, is_tip,
                            true);
                        made_change = true;
                    }
                    E->install(&E->totUp[node], new_tot);
                    E_shorten(E, E->totUp[node]);
                }
            } else {
                E->install(&E->totUp[node], -1);
            }
            if (!E->is_leaf(node)) {
                int cc0 = E->c0[node], cc1 = E->c1[node];
                double dist0 = E->dist[cc0], dist1 = E->dist[cc1];
                int64_t new_up_right = -1, new_up_left = -1;
                if (lk_dirty) {
                    int64_t child0_vect = E_pass_up(E, E->pv[cc0], cc0);
                    int64_t child1_vect = E_pass_up(E, E->pv[cc1], cc1);
                    bool tip0 = E->is_tip(cc0), tip1 = E->is_tip(cc1);
                    new_up_right = E_merge(E, vect_up_up, E->dist[node],
                        false, child1_vect, dist1, tip1, true);
                    if (new_up_right < 0) {
                        if (E->dist[node] == 0.0 && dist1 == 0.0) {
                            E_update_blen(E, node, false, nullptr);
                            if (E->dist[node] == 0.0) {
                                E_update_blen(E, cc1, true, &wl);
                                updated_blen = true;
                            } else {
                                E->install(&E->totUp[node], E_merge(E,
                                    vect_up_up, E->dist[node] / 2, false,
                                    E->pv[node], E->dist[node] / 2, is_tip,
                                    true));
                                new_up_right = E_merge(E, vect_up_up,
                                    E->dist[node], false, child1_vect,
                                    dist1, tip1, true);
                                wl.push_back({(int32_t)E->up[node],
                                              (int32_t)child_num_up, 1});
                                made_change = true;
                            }
                        } else {
                            E->error = "impossible merge with non-zero "
                                "distances in update_partials (from parent)";
                            return false;
                        }
                    }
                    if (!updated_blen) {
                        new_up_left = E_merge(E, vect_up_up, E->dist[node],
                            false, child0_vect, dist0, tip0, true);
                        if (new_up_left < 0) {
                            if (E->dist[node] == 0.0 && dist0 == 0.0) {
                                E_update_blen(E, node, false, nullptr);
                                if (E->dist[node] == 0.0) {
                                    E_update_blen(E, cc0, true, &wl);
                                    updated_blen = true;
                                } else {
                                    E->install(&E->totUp[node], E_merge(E,
                                        vect_up_up, E->dist[node] / 2,
                                        false, E->pv[node],
                                        E->dist[node] / 2, is_tip, true));
                                    new_up_right = E_merge(E, vect_up_up,
                                        E->dist[node], false, child1_vect,
                                        dist1, tip1, true);
                                    new_up_left = E_merge(E, vect_up_up,
                                        E->dist[node], false, child0_vect,
                                        dist0, tip0, true);
                                    wl.push_back({(int32_t)E->up[node],
                                                  (int32_t)child_num_up,
                                                  1});
                                    made_change = true;
                                }
                            } else {
                                E->error = "impossible merge with non-zero "
                                    "distances in update_partials (from "
                                    "parent, child0)";
                                return false;
                            }
                        }
                    }
                }
                if (!updated_blen) {
                    bool up_right_changed = false, up_left_changed = false;
                    if (lk_dirty) {
                        if (made_change
                            || E_different(E, E->upR[node], new_up_right)) {
                            E->install(&E->upR[node], new_up_right);
                            E_shorten(E, E->upR[node]);
                            up_right_changed = true;
                        }
                        if (made_change
                            || E_different(E, E->upL[node], new_up_left)) {
                            E->install(&E->upL[node], new_up_left);
                            E_shorten(E, E->upL[node]);
                            up_left_changed = true;
                        }
                    }
                    if (up_right_changed) wl.push_back({(int32_t)cc0, 2, 1});
                    if (up_left_changed) wl.push_back({(int32_t)cc1, 2, 1});
                }
            }
        } else {
            int child_num = direction;
            int other_num = 1 - child_num;
            int child = E->child(node, child_num);
            int other = E->child(node, other_num);
            double child_dist = E->dist[child];
            double other_dist = E->dist[other];
            int64_t new_up_vect = -1, old_prob_vect = -1, other_vect_up = -1;
            bool have_old = false;
            if (lk_dirty) {
                int64_t other_child_vect = E_pass_up(E, E->pv[other], other);
                int64_t prob_vect_down = E_pass_up(E, E->pv[child], child);
                bool c_is_tip = E->is_tip(child);
                bool other_is_tip = E->is_tip(other);
                other_vect_up = child_num ? E->upR[node] : E->upL[node];
                int64_t new_vect = E_merge(E, other_child_vect, other_dist,
                    other_is_tip, prob_vect_down, child_dist, c_is_tip,
                    false);
                if (new_vect < 0) {
                    if (child_dist == 0.0 && other_dist == 0.0) {
                        E_update_blen(E, child, false, nullptr);
                        if (E->dist[child] == 0.0) {
                            E_update_blen(E, other, true, &wl);
                            updated_blen = true;
                        } else {
                            child_dist = E->dist[child];
                            E->install(&E->pv[node], E_merge(E,
                                other_child_vect, other_dist, other_is_tip,
                                prob_vect_down, child_dist, c_is_tip,
                                false));
                            wl.push_back({(int32_t)child, 2, 1});
                            made_change = true;
                        }
                    } else {
                        E->error = "impossible merge with non-zero "
                            "distances in update_partials (from child)";
                        return false;
                    }
                } else {
                    old_prob_vect = E->pv[node];
                    have_old = true;
                    // keep the old vector alive for the comparison below
                    if (old_prob_vect >= 0) E->owned.insert(old_prob_vect);
                    E->pv[node] = -1;
                    E->install(&E->pv[node], new_vect);
                    E_shorten(E, E->pv[node]);
                }
                if (!updated_blen && E->dist[node] != 0.0
                        && E->up[node] >= 0 && vect_up_up >= 0) {
                    int64_t new_tot = E_merge(E, vect_up_up,
                        E->dist[node] / 2, false, E->pv[node],
                        E->dist[node] / 2, false, true);
                    if (new_tot < 0) {
                        E_update_blen(E, node, false, nullptr);
                        E->install(&E->pv[node], E_merge(E,
                            other_child_vect, other_dist, other_is_tip,
                            prob_vect_down, child_dist, c_is_tip, false));
                        wl.push_back({(int32_t)child, 2, 1});
                        E->install(&E->totUp[node], E_merge(E, vect_up_up,
                            E->dist[node] / 2, false, E->pv[node],
                            E->dist[node] / 2, false, true));
                        made_change = true;
                    } else {
                        E->install(&E->totUp[node], new_tot);
                        E_shorten(E, E->totUp[node]);
                    }
                } else if (E->dist[node] == 0.0) {
                    E->install(&E->totUp[node], -1);
                }
                if (!updated_blen && other_vect_up >= 0) {
                    if (E->up[node] >= 0) {
                        new_up_vect = E_merge(E, vect_up_up, E->dist[node],
                            false, prob_vect_down, child_dist, c_is_tip,
                            true);
                    } else {
                        new_up_vect = E_root_vector(E, prob_vect_down,
                            child_dist, c_is_tip, node);
                    }
                    if (new_up_vect < 0) {
                        if (E->dist[node] == 0.0 && child_dist == 0.0) {
                            E_update_blen(E, node, false, nullptr);
                            if (E->dist[node] == 0.0) {
                                E_update_blen(E, child, true, &wl);
                                updated_blen = true;
                            } else {
                                E->install(&E->totUp[node], E_merge(E,
                                    vect_up_up, E->dist[node] / 2, false,
                                    E->pv[node], E->dist[node] / 2, false,
                                    true));
                                wl.push_back({(int32_t)child, 2, 1});
                                made_change = true;
                                new_up_vect = E_merge(E, vect_up_up,
                                    E->dist[node], false, prob_vect_down,
                                    child_dist, c_is_tip, true);
                            }
                        } else {
                            E->error = "impossible merge with non-zero "
                                "distances in update_partials (newUpVect)";
                            return false;
                        }
                    }
                }
            }
            if (!updated_blen) {
                bool up_changed = false, down_changed = false;
                if (lk_dirty) {
                    if (other_vect_up >= 0) {
                        if (made_change
                            || E_different(E, other_vect_up, new_up_vect)) {
                            up_changed = true;
                            if (child_num) {
                                E->install(&E->upR[node], new_up_vect);
                                E_shorten(E, E->upR[node]);
                            } else {
                                E->install(&E->upL[node], new_up_vect);
                                E_shorten(E, E->upL[node]);
                            }
                        }
                    }
                    if (made_change
                        || (have_old
                            && E_different(E, E->pv[node], old_prob_vect)))
                        down_changed = true;
                }
                if (E->up[node] >= 0 && down_changed)
                    wl.push_back({(int32_t)E->up[node],
                                  (int32_t)E->child_index(node), 1});
                if (up_changed) wl.push_back({(int32_t)other, 2, 1});
            }
        }
    }
    return true;
}

// partials.py merge_mutation_lists :454-500 (flat triples)
static std::vector<int32_t> E_merge_mutation_lists(
        const std::vector<int32_t> &m1, const std::vector<int32_t> &m2,
        bool downward) {
    std::vector<int32_t> out;
    size_t i1 = 0, i2 = 0, n1 = m1.size() / 3, n2 = m2.size() / 3;
    while (true) {
        if (i1 < n1) {
            int pos1 = m1[i1 * 3];
            if (i2 < n2) {
                int pos2 = m2[i2 * 3];
                if (pos1 < pos2) {
                    if (downward) {
                        out.push_back(pos1);
                        out.push_back(m1[i1 * 3 + 2]);
                        out.push_back(m1[i1 * 3 + 1]);
                    } else {
                        out.insert(out.end(), m1.begin() + i1 * 3,
                                   m1.begin() + i1 * 3 + 3);
                    }
                    i1++;
                } else if (pos2 < pos1) {
                    out.insert(out.end(), m2.begin() + i2 * 3,
                               m2.begin() + i2 * 3 + 3);
                    i2++;
                } else {
                    int source, end;
                    if (downward) {
                        source = m1[i1 * 3 + 2];
                        end = m1[i1 * 3 + 1];
                    } else {
                        source = m1[i1 * 3 + 1];
                        end = m1[i1 * 3 + 2];
                    }
                    if (end != m2[i2 * 3 + 1])
                        std::fprintf(stderr,
                                     "WARNING: inconsistent MAT mutations\n");
                    if (source != m2[i2 * 3 + 2]) {
                        out.push_back(pos2);
                        out.push_back(source);
                        out.push_back(m2[i2 * 3 + 2]);
                    }
                    i1++; i2++;
                }
            } else {
                if (downward) {
                    out.push_back(pos1);
                    out.push_back(m1[i1 * 3 + 2]);
                    out.push_back(m1[i1 * 3 + 1]);
                } else {
                    out.insert(out.end(), m1.begin() + i1 * 3,
                               m1.begin() + i1 * 3 + 3);
                }
                i1++;
            }
        } else if (i2 < n2) {
            out.insert(out.end(), m2.begin() + i2 * 3,
                       m2.begin() + i2 * 3 + 3);
            i2++;
        } else {
            break;
        }
    }
    return out;
}

// partials.py make_node_reference :547-595
static void E_make_node_reference(Engine *E, int node, int old_value) {
    E->num_refs++;
    if (old_value) {
        int p = E->up[node];
        while (p >= 0) {
            E->nDesc[p] -= old_value;
            if (!E->muts[p].empty()) break;
            p = E->up[p];
        }
    }
    int pos = 0;
    std::vector<int32_t> &m = E->muts[node];
    for (const Entry &e : E->S->v(E->pv[node])) {
        if (e.type < 4) {
            pos += 1;
            m.push_back(pos);
            m.push_back(e.val);
            m.push_back(e.type);
        } else if (e.type == TYPE_O) {
            pos += 1;
        } else {
            pos = e.val;
        }
    }
    auto repass = [&](int64_t *slot) {
        int64_t nv = E_pass(E, *slot, m, false);
        E->install(slot, nv);
        E_shorten(E, *slot);
    };
    repass(&E->pv[node]);
    if (E->dist[node] != 0.0 && E->up[node] >= 0) repass(&E->totUp[node]);
    repass(&E->upR[node]);
    repass(&E->upL[node]);
    std::vector<int> stack = {E->c0[node], E->c1[node]};
    while (!stack.empty()) {
        int n = stack.back(); stack.pop_back();
        if (!E->muts[n].empty()) {
            E->muts[n] = E_merge_mutation_lists(m, E->muts[n], true);
        } else {
            repass(&E->pv[n]);
            if (E->dist[n] != 0.0) repass(&E->totUp[n]);
            if (!E->is_leaf(n)) {
                repass(&E->upR[n]);
                repass(&E->upL[n]);
                stack.push_back(E->c0[n]);
                stack.push_back(E->c1[n]);
            }
        }
    }
}

// Batched placement (engine_place_batch): thread-local context for the
// read-only proposal phase.  When set, the budgeted search must not
// mutate engine state: minor absorption is recorded here instead of
// applied, stats accumulate locally (merged after join), and fine-phase
// errors land here instead of E->error (a shared std::string write
// would race across workers).
struct BatchCtx {
    int32_t absorb_leaf = -1;
    // fine-candidate set (node, crawl score), best first: the worker
    // skips its own fine phase — the serial apply re-runs it against
    // CURRENT vectors over these candidates, so near-tie choices are
    // made on live information
    std::vector<std::pair<int32_t, double>> cands;
    // every node the crawl discovered (scored, leaf-checked, or chased
    // through a zero-length chain): the apply phase uses it to decide
    // whether the serial crawl could have reached a batch-mate's fresh
    // branch (it only could if it visited a snapshot endpoint of the
    // split edge)
    std::vector<int32_t> visited;
    int64_t dfs_visits = 0, missed_minors = 0, fine_evals = 0;
    // speculative worker-side fine result (consumed by the apply only
    // when its freshness gate holds; see E_find_best_parent_budget)
    uint8_t fine_ok = 0;
    int32_t fine_node = -1;
    double fine_score = 0, fine_top = 0, fine_bottom = 0, fine_app = 0;
    // unowned copy of the winner's frame-translated diffs (the apply's
    // fresh path places it directly: re-deriving the root->winner frame
    // chain cost 77us/sample at 200k)
    int64_t fine_diffs = -1;
    std::string error;
};
static thread_local BatchCtx *tl_batch = nullptr;

static inline void E_fail(Engine *E, const char *msg) {
    if (tl_batch) tl_batch->error = msg;
    else E->error = msg;
}

// the mutating tail of try_absorb_minor, shared with the batch apply
static void E_absorb_commit(Engine *E, int node, int sample) {
    E->minorSeqs[node].push_back(sample);
    if (E->hnz_mode) E->nd0_absorb(node);
    E->num_minors_found++;
}

// placement.py try_absorb_minor :77-102 (no HnZ / error-rate path)
static int E_try_absorb_minor(Engine *E, int node, int64_t diffs_at,
                              int sample) {
    int cmp = is_minor_sequence(*E->S, E->S->v(E->pv[node]),
                                E->S->v(diffs_at), E->only_identical);
    if (cmp == 1) {
        if (tl_batch) tl_batch->absorb_leaf = node;
        else E_absorb_commit(E, node, sample);
        return 1;
    }
    if (cmp == 2) {
        if (tl_batch) tl_batch->missed_minors++;
        else E->total_missed_minors++;
    }
    return 0;
}

struct BestCand { int32_t node; double score; int64_t diffs; };

struct FindResult {
    int absorbed = 0;
    int32_t best_node = 0;
    double best_score = 0;
    double top = 0, bottom = 0, appending = 0;
    int64_t best_diffs = -1;
};

// Fine phase shared by the exact DFS and the beam crawl: 3-way
// branch-length optimization of every candidate within threshold_opt of
// the crawl best (placement.py :248-322 + _hnz_optimize_placement).
// Returns false on an impossible merge (E->error set).
static bool E_fine_phase(Engine *E, const std::vector<BestCand> &best_nodes,
                         double best_lk_diff, int &best_node,
                         double &best_score, double &best_top,
                         double &best_bottom, double &best_app,
                         int64_t &best_diffs) {
    PROF_T(pf0);
    best_score = best_lk_diff;
    for (const BestCand &bc : best_nodes) {
        if (!(bc.score >= best_lk_diff - E->threshold_opt)) continue;
        if (tl_batch) tl_batch->fine_evals++; else E->fine_evals++;
        int node = bc.node;
        int64_t diffs_at = bc.diffs;
        int64_t up_vect = E->vect_up_for(node);
        if (!E->muts[node].empty()) up_vect = E_pass_down(E, up_vect, node);
        bool is_tip = E->is_tip(node);
        double ba = E_blen(E, E->totUp[node], diffs_at, true);
        int64_t mid_lower = E_merge(E, E->pv[node], E->dist[node] / 2,
                                    is_tip, diffs_at, ba, true, false);
        if (mid_lower < 0) { E_fail(E, "impossible merge in fine phase"); return false; }
        double bt = E_blen(E, up_vect, mid_lower, false);
        int64_t mid_top = E_merge(E, up_vect, bt, false, diffs_at, ba, true,
                                  true);
        if (mid_top < 0) { E_fail(E, "impossible merge in fine phase"); return false; }
        double bb = E_blen(E, mid_top, E->pv[node], is_tip);
        int64_t new_mid = E_merge(E, up_vect, bt, false, E->pv[node], bb,
                                  is_tip, true);
        if (new_mid < 0) { E_fail(E, "impossible merge in fine phase"); return false; }
        double appending_cost = E_append(E, new_mid, diffs_at, true, ba);
        double initial_cost = E_append(E, up_vect, E->pv[node], is_tip,
                                       E->dist[node]);
        double new_partial_cost = E_append(E, up_vect, E->pv[node], is_tip,
                                           bb + bt);
        double optimized = appending_cost + new_partial_cost - initial_cost;
        if (E->hnz_mode) {
            // placement.py _hnz_optimize_placement (:324-362), incl. the
            // 0-length-bottom alternative
            double eff0 = E->eff0;
            if (bt > eff0 && bb > eff0) {
                optimized += E->hnz(2) - E->hnz(1);
            } else if (bt > eff0) {
                optimized += E->hnz(E->nDesc0[node] + 1)
                             - E->hnz(E->nDesc0[node]);
            } else {
                int p0 = E->up[node];
                while (E->dist[p0] <= eff0 && E->up[p0] >= 0)
                    p0 = E->up[p0];
                optimized += E->hnz(E->nDesc0[p0] + 1)
                             - E->hnz(E->nDesc0[p0]);
            }
            if (bb > eff0 && E->dist[node] > eff0) {
                int64_t alt_mid = E_merge(E, up_vect, bt + bb, false,
                                          E->pv[node], 0.0, is_tip, true);
                if (alt_mid >= 0) {
                    double alt_cost = E_append(E, alt_mid, diffs_at, true,
                                               ba);
                    double ic2 = E_append(E, up_vect, E->pv[node], is_tip,
                                          E->dist[node]);
                    double np2 = E_append(E, up_vect, E->pv[node], is_tip,
                                          bb + bt);
                    double alt_optimized = alt_cost + np2 - ic2;
                    alt_optimized += E->hnz(E->nDesc0[node] + 1)
                                     - E->hnz(E->nDesc0[node]);
                    if (alt_optimized > optimized) {
                        optimized = alt_optimized;
                        bt = bt + bb;
                        bb = 0.0;
                    }
                }
            }
        }
        if (optimized >= best_score) {
            best_node = node;
            best_score = optimized;
            best_top = bt;
            best_bottom = bb;
            best_app = ba;
            best_diffs = diffs_at;
        }
    }
    PROF_ADD(E->p_fine_cy, pf0);
    return true;
}

// placement.py find_best_parent_for_new_sample :36-246
static FindResult E_find_best_parent(Engine *E, int64_t diffs, int sample) {
    FindResult R;
    int root = E->root;
    std::vector<BestCand> best_nodes;
    int best_node = root;
    double best_top = 0.0, best_bottom = 0.0, best_app = E->one_mut;
    if (!E->muts[root].empty()) diffs = E_pass_down(E, diffs, root);
    int64_t best_diffs = diffs;
    if (E->is_leaf(root)) {
        if (E_try_absorb_minor(E, root, diffs, sample)) {
            R.absorbed = 1;
            return R;
        }
    }
    int64_t root_vect = E_root_vector(E, E->pv[root], 0.0, false, root);
    double best_lk_diff = E_append(E, root_vect, diffs, true, E->one_mut);
    if (E->hnz_mode)
        best_lk_diff += E->hnz(E->nDesc0[root] + 1)
                        - E->hnz(E->nDesc0[root]);
    double original_lk_diff = best_lk_diff;

    // speculative score workers: worth it once the tree is large
    if (E->place_threads < 0) {
        // Per-node speculative scoring is opt-in: on this class of host
        // the per-task handoff (~2.5k cycles of work per score) does not
        // beat its cache-line protocol cost.  The cross-sample pipeline
        // (engine_place_spec) is the production parallel path.
        const char *env = getenv("MAPLE_PLACE_THREADS");
        E->place_threads = env ? atoi(env) : 0;
    }
    bool pool_on = E->place_threads > 0 && E->up.size() > 4096;
    if (pool_on) {
        if (!E->pool) {
            E->pool = std::make_unique<ScorePool>();
            E->pool->start(E->S, E->only_identical, E->place_threads);
        }
        E->pool->reset();
    }

    struct StackItem { int32_t node; double parent_lk; int32_t failed;
                       int64_t diffs; int64_t ts; int64_t tm; };
    std::vector<StackItem> stack;
    // Prefetch a pushed child's vectors at push time: the pop (and its
    // append/minor-seq walk) happens after the sibling subtree, by which
    // time the lines are resident.  The walk itself cannot overlap its
    // misses (advance is branch-dependent on loaded data), so this is
    // where most of the placement DFS's memory stalls go away.
    auto prefetch_vec = [&](int64_t id) {
        if (id < 0) return;
        const Vec &vv = E->S->v(id);
        const char *p = (const char *)vv.data();
        const char *end = p + vv.size() * sizeof(Entry);
        if (end - p > 64 * 64) end = p + 64 * 64;
        for (; p < end; p += 64) __builtin_prefetch(p, 0, 2);
    };
    auto push_child = [&](int c, double plk, int failed, int64_t dcc) {
        int64_t ts = -1, tm = -1;
        bool leaf = E->is_leaf(c);
        bool scored = E->dist[c] > E->eff0 && E->up[c] >= 0;
        if (pool_on) {
            if (leaf)
                tm = (int64_t)E->pool->add(1, E->pv[c], dcc, 0.0);
            if (scored)
                ts = (int64_t)E->pool->add(0, E->totUp[c], dcc, E->one_mut);
        } else {
            if (leaf) prefetch_vec(E->pv[c]);
            if (scored) prefetch_vec(E->totUp[c]);
        }
        stack.push_back({(int32_t)c, plk, (int32_t)failed, dcc, ts, tm});
    };
    for (int i = 0; i < 2 && !E->is_leaf(root); i++) {
        int ch = E->child(root, i);
        int64_t dcc = diffs;
        if (!E->muts[ch].empty()) dcc = E_pass_down(E, diffs, ch);
        push_child(ch, best_lk_diff, 0, dcc);
    }
#ifdef MAPLE_PROFILE
    int64_t min_gap = 1000000;
#endif
    while (!stack.empty()) {
        E->dfs_visits++;
        StackItem it = stack.back(); stack.pop_back();
        int t1 = it.node;
#ifdef MAPLE_PROFILE
        if ((size_t)t1 < E->write_stamp.size()) {
            int64_t g = E->place_seq - E->write_stamp[t1];
            if (g < min_gap) min_gap = g;
        }
#endif
        double parent_lk = it.parent_lk;
        int failed_passes = it.failed;
        int64_t diffs_at = it.diffs;
        if (E->is_leaf(t1)) {
            int cmp = it.tm >= 0
                ? (int)E->pool->consume((size_t)it.tm)
                : is_minor_sequence(*E->S, E->S->v(E->pv[t1]),
                                    E->S->v(diffs_at), E->only_identical);
            if (cmp == 1) {
                E->minorSeqs[t1].push_back(sample);
                if (E->hnz_mode) E->nd0_absorb(t1);
                E->num_minors_found++;
                if (pool_on) E->pool->cancel_unconsumed();
                R.absorbed = 1;
                return R;
            }
            if (cmp == 2) E->total_missed_minors++;
        }
        double lk_diff;
        if (E->dist[t1] > E->eff0 && E->up[t1] >= 0) {
            PROF_T(pt0);
#ifdef MAPLE_PROFILE
            E->p_scored++;
            {
                const Vec &pv_ = E->S->v(E->totUp[t1]);
                const Vec &cv_ = E->S->v(diffs_at);
                E->p_entries += (int64_t)pv_.size() + (int64_t)cv_.size();
                E->p_tot_entries += (int64_t)pv_.size();
                for (const Entry &pe : pv_)
                    if (pe.type == TYPE_O) E->p_o_entries++;
            }
#endif
            lk_diff = it.ts >= 0
                ? E->pool->consume((size_t)it.ts)
                : E_append(E, E->totUp[t1], diffs_at, true, E->one_mut);
            PROF_ADD(E->p_append_cy, pt0);
            // HnZ mid-branch term (placement.py :199-207); dist[t1] >
            // eff0 holds on this branch, so only the generic term applies
            if (E->hnz_mode) lk_diff += E->hnz(2) - E->hnz(1);
            if (lk_diff >= best_lk_diff) {
                if (!pool_on) {
                    E_shorten(E, diffs_at);
                } else if (diffs_at >= 0
                           && shorten_would_change(*E->S,
                                                   E->S->v(diffs_at))) {
                    // exact protocol: drop speculative results, mutate,
                    // recompute inline at pop time (serial semantics)
                    E->pool->cancel_unconsumed();
                    E_shorten(E, diffs_at);
                }
                best_lk_diff = lk_diff;
                best_node = t1;
                failed_passes = 0;
                best_nodes.push_back({(int32_t)t1, lk_diff, diffs_at});
                best_diffs = diffs_at;
                best_top = E->dist[t1] / 2;
                best_bottom = E->dist[t1] / 4;  // (dist/2)/2 as in Python
                best_app = E->one_mut;
            } else if (lk_diff > best_lk_diff - E->threshold_opt) {
                best_nodes.push_back({(int32_t)t1, lk_diff, diffs_at});
            }
            if (lk_diff < parent_lk - E->threshold_consec) failed_passes++;
        } else {
#ifdef MAPLE_PROFILE
            E->p_free++;
#endif
            lk_diff = parent_lk;
        }
        bool keep_going;
        if (E->strict_stop)
            keep_going = failed_passes <= E->allowed_fails
                && lk_diff > best_lk_diff - E->threshold_log_lk;
        else
            keep_going = failed_passes <= E->allowed_fails
                || lk_diff > best_lk_diff - E->threshold_log_lk;
        if (keep_going && !E->is_leaf(t1)) {
            for (int i = 0; i < 2; i++) {
                int c = E->child(t1, i);
                int64_t dcc = diffs_at;
                if (!E->muts[c].empty()) {
                    PROF_T(pp0);
                    dcc = E_pass_down(E, diffs_at, c);
                    PROF_ADD(E->p_pass_cy, pp0);
                }
                push_child(c, lk_diff, failed_passes, dcc);
            }
        }
    }
    // fine phase: optimize branch lengths on the best candidates
    double best_score;
    if (!E_fine_phase(E, best_nodes, best_lk_diff, best_node, best_score,
                      best_top, best_bottom, best_app, best_diffs))
        return R;
#ifdef MAPLE_PROFILE
    E->p_gap_hist[min_gap < 0 ? 0 : (min_gap > 15 ? 15 : min_gap)]++;
#endif
    if (std::isinf(best_score) && best_score < 0)
        best_score = original_lk_diff;
    R.best_node = best_node;
    R.best_score = best_score;
    R.top = best_top;
    R.bottom = best_bottom;
    R.appending = best_app;
    R.best_diffs = best_diffs;
    return R;
}

// Best-first placement search with a non-improvement budget (opt-in via
// --placementBudget / engine_set_search_budget).
//
// Same scoring kernel, thresholds, and per-path stop rules as
// E_find_best_parent (reference :7912-8293), but the crawl order is
// best-first: children are scored when discovered and a max-heap always
// expands the highest-scoring frontier node next, so the search walks
// straight down the score gradient to the optimal region instead of
// sweeping the tree.  The budget is the adaptive cap the reference
// lacks: stop after `search_budget` consecutive scored nodes that fail
// to raise the best score.  On the flat low-divergence landscapes MAPLE
// targets, the reference's consecutive-failure rule barely prunes and
// the DFS visit count grows linearly with tree size (O(n^2) placement
// overall); best-first + budget bounds each sample's search at
// O(depth + budget) visits.  NOT byte-parity with the reference DFS:
// visit order differs and the budget prunes plateau tails; placement
// quality is pinned by LK-tolerance tests (tests/test_beam_placement.py).
// With `seeds`, the crawl is *seeded*: instead of starting at the root's
// children it starts best-first expansion at the given node set (the
// device proxy screen's top-M candidates, maple_tpu/parallel/
// proxy_placer.py), plus the first seeds' ancestor chains for upward
// coverage, deduplicating visits across overlapping seed subtrees.  Stop
// rule = `seed_budget` consecutive non-improving scored nodes.  Same
// LK-tolerance contract as the budget crawl (quality pinned by
// tests/test_device_placement.py; every proposal is re-validated by the
// batch apply).
static FindResult E_find_best_parent_budget(Engine *E, int64_t diffs,
                                            int sample,
                                            const int32_t *seeds = nullptr,
                                            int n_seeds = 0,
                                            int64_t seed_budget = 0) {
    FindResult R;
    int root = E->root;
    std::vector<BestCand> best_nodes;
    int best_node = root;
    double best_top = 0.0, best_bottom = 0.0, best_app = E->one_mut;
    const int64_t gdiffs = diffs;   // global-frame terminal (seed frames)
    const int64_t budget = seeds ? seed_budget : E->search_budget;
    if (!E->muts[root].empty()) diffs = E_pass_down(E, diffs, root);
    int64_t best_diffs = diffs;
    if (E->is_leaf(root)) {
        if (E_try_absorb_minor(E, root, diffs, sample)) {
            R.absorbed = 1;
            return R;
        }
    }
    int64_t root_vect = E_root_vector(E, E->pv[root], 0.0, false, root);
    double best_lk_diff = E_append(E, root_vect, diffs, true, E->one_mut);
    if (E->hnz_mode)
        best_lk_diff += E->hnz(E->nDesc0[root] + 1)
                        - E->hnz(E->nDesc0[root]);
    double original_lk_diff = best_lk_diff;

    struct HeapItem { double lk; int32_t node; int32_t failed;
                      int64_t diffs; };
    struct HeapLess {  // max-heap on lk for std::push_heap/pop_heap
        bool operator()(const HeapItem &a, const HeapItem &b) const {
            return a.lk < b.lk;
        }
    };
    std::vector<HeapItem> heap;
    int64_t since_improve = 0;
    bool absorbed = false;
    // seeded mode: visit-dedup across overlapping seed subtrees
    std::vector<uint8_t> seen;
    if (seeds) seen.assign(E->up.size(), 0);
    auto prefetch_vec = [&](int64_t id) {
        if (id < 0) return;
        const Vec &vv = E->S->v(id);
        const char *p = (const char *)vv.data();
        const char *end = p + vv.size() * sizeof(Entry);
        if (end - p > 64 * 64) end = p + 64 * 64;
        for (; p < end; p += 64) __builtin_prefetch(p, 0, 2);
    };
    // pull the vectors a node's discovery will read (score + minor check)
    auto prefetch_node = [&](int c) {
        if (E->is_leaf(c)) prefetch_vec(E->pv[c]);
        if (E->dist[c] > E->eff0 && E->up[c] >= 0)
            prefetch_vec(E->totUp[c]);
    };
    // Score-at-discovery: chase through zero-length internal nodes
    // (polytomy chains), minor-check leaves, score every node with
    // dist > eff0, and push scored/expandable nodes onto the heap.
    std::vector<std::pair<int, int64_t>> chase;
    auto discover = [&](int c_in, double plk, int failed_in,
                        int64_t d_in) {
        chase.clear();
        chase.push_back({c_in, d_in});
        while (!chase.empty()) {
            auto [c, dcur] = chase.back();
            chase.pop_back();
            if (seeds) {
                if (seen[c]) continue;
                seen[c] = 1;
            }
            int64_t dcc = dcur;
            if (!E->muts[c].empty()) dcc = E_pass_down(E, dcur, c);
            bool leaf = E->is_leaf(c);
            if (leaf) {
                if (tl_batch) {
                    tl_batch->dfs_visits++;
                    tl_batch->visited.push_back(c);
                } else E->dfs_visits++;
                if (E_try_absorb_minor(E, c, dcc, sample)) {
                    absorbed = true;
                    return;
                }
            }
            if (E->dist[c] > E->eff0 && E->up[c] >= 0) {
                if (!leaf) {
                    if (tl_batch) {
                        tl_batch->dfs_visits++;
                        tl_batch->visited.push_back(c);
                    } else E->dfs_visits++;
                }
                PROF_T(pt0);
                double lk = E_append(E, E->totUp[c], dcc, true, E->one_mut);
                PROF_ADD(E->p_append_cy, pt0);
                if (E->hnz_mode) lk += E->hnz(2) - E->hnz(1);
                int failed = failed_in;
                since_improve++;
                if (lk >= best_lk_diff) {
                    E_shorten(E, dcc);
                    best_lk_diff = lk;
                    best_node = c;
                    failed = 0;
                    since_improve = 0;
                    best_nodes.push_back({(int32_t)c, lk, dcc});
                    best_diffs = dcc;
                    best_top = E->dist[c] / 2;
                    best_bottom = E->dist[c] / 4;
                    best_app = E->one_mut;
                } else if (lk > best_lk_diff - E->threshold_opt) {
                    best_nodes.push_back({(int32_t)c, lk, dcc});
                }
                if (lk < plk - E->threshold_consec) failed++;
                if (!leaf) {
                    heap.push_back({lk, (int32_t)c, (int32_t)failed, dcc});
                    std::push_heap(heap.begin(), heap.end(), HeapLess());
                }
            } else if (!leaf) {
                // zero-length internal node: inherits the parent's score
                // and failure count; expand in place
                if (tl_batch) tl_batch->dfs_visits++;
                else E->dfs_visits++;
                chase.push_back({E->child(c, 0), dcc});
                chase.push_back({E->child(c, 1), dcc});
            }
        }
    };
    if (seeds) {
        // Seed frames: translate the global terminal into each seed's
        // parent frame (discover() handles the seed's own mutations);
        // frames memoize across seeds sharing MAT chains.
        FrameDiffCache fc{gdiffs, {}};
        auto seed_one = [&](int32_t s) {
            if (s < 0 || (size_t)s >= E->up.size() || E->up[s] < 0)
                return;  // spliced out / stale row / root (base covers)
            int64_t d_in = E->up[s] >= 0
                ? E_diffs_cached(E, fc, E->up[s]) : gdiffs;
            discover(s, best_lk_diff, 0, d_in);
        };
        for (int i = 0; i < n_seeds && !absorbed; i++) seed_one(seeds[i]);
        // upward coverage: the strongest seeds' ancestor chains (the
        // screen ranks by proxy score, so seed 0 is the hot region; its
        // ancestors cover attachments just above it), plus the parents
        // of the next few seeds
        if (!absorbed && n_seeds > 0) {
            int a = seeds[0];
            for (int hops = 0; a >= 0 && hops < 16 && !absorbed; hops++) {
                seed_one(a);
                a = (size_t)a < E->up.size() ? E->up[a] : -1;
            }
            for (int i = 1; i < n_seeds && i < 8 && !absorbed; i++)
                if (seeds[i] >= 0 && (size_t)seeds[i] < E->up.size())
                    seed_one(E->up[seeds[i]]);
        }
        if (absorbed) { R.absorbed = 1; return R; }
        // the budget is a CRAWL budget: scoring the seed set itself
        // (mostly non-improving by construction — only one seed is the
        // argmax) must not eat it, or expansion never starts
        since_improve = 0;
    } else {
        for (int i = 0; i < 2 && !E->is_leaf(root); i++) {
            discover(E->child(root, i), best_lk_diff, 0, diffs);
            if (absorbed) { R.absorbed = 1; return R; }
        }
    }
    while (!heap.empty() && since_improve < budget) {
        std::pop_heap(heap.begin(), heap.end(), HeapLess());
        HeapItem it = heap.back();
        heap.pop_back();
        // keep_going re-checked against the current best (reference
        // :8080-8088 semantics; best may have risen since discovery)
        bool keep_going;
        if (E->strict_stop)
            keep_going = it.failed <= E->allowed_fails
                && it.lk > best_lk_diff - E->threshold_log_lk;
        else
            keep_going = it.failed <= E->allowed_fails
                || it.lk > best_lk_diff - E->threshold_log_lk;
        if (!keep_going) continue;
        // sibling prefetch: child 1's lines load while child 0 scores
        prefetch_node(E->child(it.node, 0));
        prefetch_node(E->child(it.node, 1));
        for (int i = 0; i < 2; i++) {
            discover(E->child(it.node, i), it.lk, it.failed, it.diffs);
            if (absorbed) { R.absorbed = 1; return R; }
        }
        // peek-ahead: the heap front is the next expansion — start its
        // children's lines now
        if (!heap.empty()) {
            int nxt = heap.front().node;
            prefetch_node(E->child(nxt, 0));
            prefetch_node(E->child(nxt, 1));
        }
    }

    if (tl_batch) {
        // batch worker: export the candidate set, in crawl DISCOVERY
        // order (the fine phase's >= argmax makes later candidates win
        // exact ties, and the serial search evaluates in this order —
        // reordering changes tie-breaks)
        auto &out = tl_batch->cands;
        out.clear();
        for (const BestCand &bc : best_nodes)
            if (bc.score >= best_lk_diff - E->threshold_opt)
                out.push_back({bc.node, bc.score});
        R.best_node = best_node;  // crawl best: root-placement fallback
        R.best_score = best_lk_diff;
        R.top = best_top;
        R.bottom = best_bottom;
        R.appending = best_app;
        // Speculative worker-side fine phase (the dominant serial-apply
        // cost at scale was re-translating diffs + re-optimizing per
        // candidate: 27.5s of a 53s apply at 200k).  The apply uses
        // this result verbatim ONLY when its freshness gate proves no
        // candidate (or its parent) was touched by an earlier apply —
        // otherwise it re-runs the fine phase against live vectors
        // exactly as before.  HnZ runs skip it: the corrections read
        // nDesc0, which absorbs/inserts mutate without installing any
        // vector, so the gate could not see the change.
        if (!E->hnz_mode) {
            int f_node = best_node;
            double f_score, f_top = best_top, f_bottom = best_bottom,
                   f_app = best_app;
            int64_t f_diffs = best_diffs;
            if (E_fine_phase(E, best_nodes, best_lk_diff, f_node,
                             f_score, f_top, f_bottom, f_app, f_diffs)) {
                if (std::isinf(f_score) && f_score < 0)
                    f_score = original_lk_diff;
                tl_batch->fine_ok = 1;
                tl_batch->fine_node = f_node;
                tl_batch->fine_score = f_score;
                tl_batch->fine_top = f_top;
                tl_batch->fine_bottom = f_bottom;
                tl_batch->fine_app = f_app;
                // unowned copy (worker temps die at end_call; the
                // apply consumes or the batch guard frees it)
                Store *s2 = E->S;
                int64_t cp = s2->alloc();
                s2->v(cp) = s2->v(f_diffs);
                s2->finish(cp);
                tl_batch->fine_diffs = cp;
            } else {
                tl_batch->error.clear();  // apply re-runs the fine phase
            }
        }
        return R;
    }
    double best_score;
    if (!E_fine_phase(E, best_nodes, best_lk_diff, best_node, best_score,
                      best_top, best_bottom, best_app, best_diffs))
        return R;
    if (std::isinf(best_score) && best_score < 0)
        best_score = original_lk_diff;
    R.best_node = best_node;
    R.best_score = best_score;
    R.top = best_top;
    R.bottom = best_bottom;
    R.appending = best_app;
    R.best_diffs = best_diffs;
    return R;
}

// placement.py place_sample_on_tree :397-670 (no-HnZ path); returns the
// new root id or -1.
static int E_place_sample(Engine *E, int node, int64_t new_partials,
                          int sample, double new_child_lk,
                          double best_up_length, double best_down_length,
                          double best_appending_length) {
#ifdef MAPLE_PROFILE
    E->stamp(node);
    if (E->up[node] >= 0) E->stamp(E->up[node]);
#endif
    bool try_new_root = false;
    if (new_child_lk < -0.01) {
        E->sum_child_lks += new_child_lk;
        E->num_child_lks++;
    }
    int64_t vect_up = -1;
    int child = -1;
    int root = -1;
    int64_t root_new_partials = -1;
    if (E->up[node] < 0) {
        try_new_root = true;
        root_new_partials = new_partials;
        int64_t tot_root = E_root_vector(E, E->pv[node], 0.0, false, node);
        best_appending_length = E_blen(E, tot_root, new_partials, true);
        root = node;
        new_child_lk = E_append(E, tot_root, new_partials, true,
                                best_appending_length);
    } else {
        child = E->child_index(node);
        vect_up = child == 0 ? E->upR[E->up[node]] : E->upL[E->up[node]];
        if (!E->muts[node].empty())
            vect_up = E_pass_down(E, vect_up, node);
        if (best_up_length == 0.0) {
            int p_node = E->up[node];
            while (E->dist[p_node] == 0.0 && E->up[p_node] >= 0)
                p_node = E->up[p_node];
            if (E->up[p_node] < 0) {
                root = p_node;
                try_new_root = true;
                if (best_down_length == 0.0
                        || best_down_length > 1.01 * E->dist[node]
                        || best_down_length < 0.99 * E->dist[node]) {
                    if (E->hnz_mode)
                        E->nd0_changing_dist(node, best_down_length);
                    E->dist[node] = best_down_length;
                    std::vector<WorkItem> wl;
                    wl.push_back({(int32_t)node, 2, 1});
                    wl.push_back({(int32_t)E->up[node], (int32_t)child, 1});
                    if (!E_update_partials(E, std::move(wl))) return -2;
                }
            }
            if (try_new_root) {
                int p2 = E->up[node];
                root_new_partials = new_partials;
                if (!E->muts[node].empty())
                    root_new_partials = E_pass_up(E, new_partials, node);
                while (E->dist[p2] == 0.0 && E->up[p2] >= 0) {
                    if (!E->muts[p2].empty())
                        root_new_partials = E_pass_up(E, root_new_partials,
                                                      p2);
                    p2 = E->up[p2];
                }
            }
        }
    }
    bool is_tip = E->is_tip(node);

    if (try_new_root) {
        node = root;
        double prob_old_root = E_find_prob_root(E, E->pv[node], node);
        int64_t root_up_left = E_root_vector(E, E->pv[node],
            best_appending_length / 2, is_tip, node);
        double best_right = E_blen(E, root_up_left, root_new_partials,
                                   true);
        int64_t root_up_right = E_root_vector(E, root_new_partials,
                                              best_right, true, node);
        double best_left = E_blen(E, root_up_right, E->pv[node], is_tip);
        root_up_left = E_root_vector(E, E->pv[node], best_left, is_tip,
                                     node);
        best_right = E_blen(E, root_up_left, root_new_partials, true);
        root_up_right = E_root_vector(E, root_new_partials, best_right,
                                      true, node);
        best_left = E_blen(E, root_up_right, E->pv[node], is_tip);
        int64_t prob_vect_root = E_merge(E, E->pv[node], best_left, is_tip,
            root_new_partials, best_right, true, false);
        double prob_root = E_append(E, root_up_left, root_new_partials,
                                    true, best_right);
        prob_root += E_find_prob_root(E, prob_vect_root, node);
        if (E->hnz_mode) prob_root += E->hnz(2) - E->hnz(1);
        double parent_lk_diff = prob_root - prob_old_root;
        if (parent_lk_diff <= new_child_lk) {
            best_right = best_appending_length;
            best_left = 0.0;
            prob_vect_root = E_merge(E, E->pv[node], best_left, is_tip,
                root_new_partials, best_right, true, false);
            root_up_right = E_root_vector(E, root_new_partials, best_right,
                                          true, node);
        }
        int new_root = E->add_node();
        if (prob_vect_root < 0) {
            E->error = "new root probVect is None in placement";
            return -2;
        }
        E_shorten(E, prob_vect_root);
        E->install(&E->pv[new_root], prob_vect_root);
        E_shorten(E, root_up_right);
        E->install(&E->upR[new_root], root_up_right);
        E->install(&E->upL[new_root], E_root_vector(E, E->pv[node],
            best_left, is_tip, node));
        E_shorten(E, E->upL[new_root]);
        E->muts[new_root] = std::move(E->muts[node]);
        E->muts[node].clear();
        E->up[node] = new_root;
        E->dist[node] = best_left;
        if (E->hnz_mode)
            E->nDesc0[new_root] = best_left > E->eff0
                ? 2 : E->nDesc0[node] + 1;
        E->c0[new_root] = node;
        if (!E->is_leaf(node)) E->nDesc[new_root] += E->nDesc[node];
        if (best_left != 0.0) E->nDesc[new_root]++;
        if (best_right != 0.0) E->nDesc[new_root]++;
        int new_node = E->add_node();
        E->name[new_node] = sample;
        E->dist[new_node] = best_right;
        if (best_right != 0.0 && best_right > 0.01 && !E->warned_blen) {
            E->warned_blen = 1;
            E->warned_blen_value = best_right;
        }
        E->up[new_node] = new_root;
        E->c1[new_root] = new_node;
        E_shorten(E, root_new_partials);
        E->install(&E->pv[new_node], root_new_partials);
        if (best_right != 0.0) {
            E->install(&E->totUp[new_node], E_merge(E, E->upL[new_root],
                best_right / 2, false, root_new_partials, best_right / 2,
                true, true));
            E_shorten(E, E->totUp[new_node]);
        }
        std::vector<WorkItem> wl;
        wl.push_back({(int32_t)node, 2, 1});
        if (!E_update_partials(E, std::move(wl))) return -2;
        // the reference does not gate placement-time promotion on
        // --noLocalRef (:8543-8544); only setUpMAT is gated
        if (E->muts[new_root].empty()
                && E->nDesc[new_root] >= E->max_ndesc_clade) {
            int nn4 = 0;
            for (const Entry &e : E->S->v(E->pv[new_root]))
                if (e.type < 4) nn4++;
            if (nn4 > E->min_num_non4)
                E_make_node_reference(E, new_root, 0);
        }
        return new_root;
    }

    // ordinary case: insert a new internal node above `node`
    int new_internal = E->add_node();
    if (child == 0) E->c0[E->up[node]] = new_internal;
    else E->c1[E->up[node]] = new_internal;
    E->up[new_internal] = E->up[node];
    E->c0[new_internal] = node;
    E->up[node] = new_internal;
    double old_len = E->dist[node];
    E->dist[node] = best_down_length;
    if (E->hnz_mode)
        E->nDesc0[new_internal] = best_down_length > E->eff0
            ? 2 : E->nDesc0[node] + 1;
    bool pass_up_mutations = false;
    int descendants_to_pass = 0;
    if (!E->muts[node].empty() && best_down_length == 0.0) {
        E->muts[new_internal] = std::move(E->muts[node]);
        E->nDesc[new_internal] = E->nDesc[node];
        if (best_appending_length != 0.0) E->nDesc[new_internal]++;
        E->muts[node].clear();
        descendants_to_pass = 0;
    } else {
        if (!E->muts[node].empty()) {
            pass_up_mutations = true;
            E->nDesc[new_internal] = 1;
            descendants_to_pass = 1;
        } else {
            if (!E->is_leaf(node)) E->nDesc[new_internal] = E->nDesc[node];
            else E->nDesc[new_internal] = 0;
            descendants_to_pass = 0;
            if (best_down_length != 0.0) {
                descendants_to_pass++;
                E->nDesc[new_internal]++;
            }
        }
        E->muts[new_internal].clear();
        if (best_appending_length != 0.0) {
            E->nDesc[new_internal]++;
            descendants_to_pass++;
        }
        if (best_down_length != 0.0 && best_up_length == 0.0)
            descendants_to_pass--;
    }

    int new_node = E->add_node();
    E->name[new_node] = sample;
    E->dist[new_node] = best_appending_length;
    if (best_appending_length != 0.0 && best_appending_length > 0.01
            && !E->warned_blen) {
        E->warned_blen = 1;
        E->warned_blen_value = best_appending_length;
    }
    E->up[new_node] = new_internal;
    E->c1[new_internal] = new_node;
    E->dist[new_internal] = best_up_length;
    if (E->hnz_mode && best_up_length <= E->eff0) {
        // placement.py :717-724
        int p0 = new_internal;
        int32_t addendum = 1;
        if (best_down_length <= E->eff0 && old_len > E->eff0)
            addendum = E->nDesc0[node];
        while (E->up[p0] >= 0 && E->dist[p0] <= E->eff0) {
            p0 = E->up[p0];
            E->nDesc0[p0] += addendum;
        }
    }

    int64_t pv_new_node = new_partials;
    if (pass_up_mutations) pv_new_node = E_pass_up(E, new_partials, node);
    E->install(&E->pv[new_node], pv_new_node);
    E_shorten(E, E->pv[new_node]);
    int64_t pv_internal = E_merge(E, E->pv[node], best_down_length, is_tip,
        new_partials, best_appending_length, true, false);
    if (pass_up_mutations && pv_internal >= 0)
        pv_internal = E_pass_up(E, pv_internal, node);
    E->install(&E->pv[new_internal], pv_internal);
    E_shorten(E, E->pv[new_internal]);
    int64_t up_right = E_merge(E, vect_up, best_up_length, false,
        new_partials, best_appending_length, true, true);
    if (pass_up_mutations && up_right >= 0)
        up_right = E_pass_up(E, up_right, node);
    E->install(&E->upR[new_internal], up_right);
    E_shorten(E, E->upR[new_internal]);
    int64_t up_left = E_merge(E, vect_up, best_up_length, false,
        E->pv[node], best_down_length, is_tip, true);
    if (pass_up_mutations && up_left >= 0)
        up_left = E_pass_up(E, up_left, node);
    E->install(&E->upL[new_internal], up_left);
    E_shorten(E, E->upL[new_internal]);
    if (E->pv[new_internal] < 0 || E->upR[new_internal] < 0
            || E->upL[new_internal] < 0) {
        E->error = "None genome list created in placement";
        return -2;
    }
    if (best_up_length != 0.0) {
        int64_t tot = E_merge(E, vect_up, best_up_length / 2, false,
            E->pv[new_internal], best_up_length / 2, false, true);
        if (pass_up_mutations && tot >= 0) tot = E_pass_up(E, tot, node);
        E->install(&E->totUp[new_internal], tot);
        E_shorten(E, E->totUp[new_internal]);
    } else {
        E->install(&E->totUp[new_internal], -1);
    }
    if (best_appending_length != 0.0) {
        int64_t tot = E_merge(E, E->upL[new_internal],
            best_appending_length / 2, false, new_partials,
            best_appending_length / 2, true, true);
        if (pass_up_mutations && tot >= 0) tot = E_pass_up(E, tot, node);
        E->install(&E->totUp[new_node], tot);
        E_shorten(E, E->totUp[new_node]);
        update_pseudo_counts(*E->S, E->S->v(E->upL[new_internal]),
                             E->S->v(new_partials), E->counts);
    } else {
        E->install(&E->totUp[new_node], -1);
    }
    if (best_down_length == 0.0) E->install(&E->totUp[node], -1);

    if (descendants_to_pass) {
        int p_node = E->up[new_internal];
        E->nDesc[p_node] += descendants_to_pass;
        while (E->muts[p_node].empty()) {
            if (E->nDesc[p_node] >= E->max_ndesc_clade) {
                int nn4 = 0;
                for (const Entry &e : E->S->v(E->pv[p_node]))
                    if (e.type < 4) nn4++;
                if (nn4 > E->min_num_non4) {
                    E_make_node_reference(E, p_node,
                        E->nDesc[p_node] - descendants_to_pass);
                    break;
                }
            }
            p_node = E->up[p_node];
            if (p_node < 0) break;
            E->nDesc[p_node] += descendants_to_pass;
        }
    }
    std::vector<WorkItem> wl;
    wl.push_back({(int32_t)node, 2, 1});
    wl.push_back({(int32_t)E->up[new_internal], (int32_t)child, 1});
    if (!E_update_partials(E, std::move(wl))) return -2;
    return -1;
}


// ======================================================================
// Native SPR engine: the full sequential topology-improvement sweep
// (startTopologyUpdates -> traverseTreeForTopologyUpdate ->
// findBestParentTopology -> cutAndPasteNode -> placeSubtreeOnTree) over
// store-owned vectors.  Port of maple_tpu/search/spr.py (reference
// findBestParentTopology :6817-7724, placeSubtreeOnTree :8896-9187,
// cutAndPasteNode :9188-9277, traverseTreeForTopologyUpdate :9287-9464,
// startTopologyUpdates :9489-9573).  Default path only: no HnZ, no
// SPRTA, no time trees, no deeper-long-branch search (the Python caller
// gates on this).
// ======================================================================

// partials.py traverse_tree_to_update_mutation_list :502-545
static void E_update_mutation_list(Engine *E, int appended, int node) {
    auto &up = E->up;
    auto &muts = E->muts;
    int depth_app = 0;
    int p = up[appended];
    while (p >= 0) { p = up[p]; depth_app++; }
    int depth = 0;
    p = up[node];
    while (p >= 0) { p = up[p]; depth++; }
    std::vector<int> node_list = {node};
    int p_node = node;
    int p_app = appended;
    while (depth_app > depth) { p_app = up[p_app]; depth_app--; }
    while (depth_app < depth) {
        p_node = up[p_node];
        node_list.push_back(p_node);
        depth--;
    }
    while (p_app != p_node) {
        p_node = up[p_node];
        node_list.push_back(p_node);
        p_app = up[p_app];
    }
    node_list.pop_back();
    p_app = up[appended];
    while (p_app != p_node) {
        if (!muts[p_app].empty())
            muts[appended] = E_merge_mutation_lists(muts[p_app],
                                                    muts[appended], false);
        p_app = up[p_app];
    }
    while (!node_list.empty()) {
        int n = node_list.back();
        node_list.pop_back();
        if (!muts[n].empty())
            muts[appended] = E_merge_mutation_lists(muts[n],
                                                    muts[appended], true);
    }
}

// spr.py evaluate_placement :25-48
struct EvalResult { double cost, bottom, top, appending; bool ok; };

static EvalResult E_evaluate_placement(Engine *E, int64_t mid_tot,
                                       int64_t down_vect, int64_t up_vect,
                                       double distance, int64_t removed,
                                       bool is_removed_tip,
                                       bool from_tip1) {
    EvalResult R{0, 0, 0, 0, true};
    R.appending = E_blen(E, mid_tot, removed, is_removed_tip);
    int64_t mid_lower = E_merge(E, down_vect, distance / 2, from_tip1,
                                removed, R.appending, is_removed_tip,
                                false);
    if (mid_lower < 0) { R.ok = false; return R; }
    R.top = E_blen(E, up_vect, mid_lower, false);
    int64_t mid_top = E_merge(E, up_vect, R.top, false, removed,
                              R.appending, is_removed_tip, true);
    if (mid_top < 0) {
        R.top = E->default_blen * 0.1;
        mid_top = E_merge(E, up_vect, R.top, false, removed, R.appending,
                          is_removed_tip, true);
        if (mid_top < 0) { R.ok = false; return R; }
    }
    R.bottom = E_blen(E, mid_top, down_vect, from_tip1);
    int64_t new_mid = E_merge(E, up_vect, R.top, false, down_vect,
                              R.bottom, from_tip1, true);
    if (new_mid < 0) { R.ok = false; return R; }
    R.cost = E_append(E, new_mid, removed, is_removed_tip, R.appending);
    return R;
}

struct TopoCand {
    int32_t t1;
    double score;
    uint8_t fresh;          // carries its own vectors (needs_updating)
    int64_t up_vect;        // fresh: passed/up vector
    int64_t down_vect;      // fresh: lower/mid-bottom vector
    double distance;
    int64_t mid_tot;
    int64_t removed;
};

struct TopoResult {
    int32_t best_node;
    double best_score;
    double top, bottom, appending;
    int64_t removed;
};

// Parallel-proposal workers must not write the shared tree, so the lazy
// totUp cache fill inside the re-attachment crawl goes to a per-worker
// side map instead.  The map lives for the WHOLE worker sweep, exactly
// like the fork-based reference workers' copy-on-write pages: a fill
// made while searching one node must be visible while searching the
// worker's later nodes, because are_vectors_different(x, missing) is
// unconditionally true — fill persistence changes needs_updating
// decisions, not just speed (observed as proposal divergence on
// --HnZ 2 --numCores 3 before this cache spanned the sweep).
struct SprWorkerCache {
    std::unordered_map<int, int64_t> tot_up;
};
static thread_local SprWorkerCache *tl_spr_cache = nullptr;
// crawl-visit telemetry (MAPLE_DEBUG_SPR_TIMING progress lines)
static thread_local int64_t tl_crawl_visits = 0;

static inline int64_t E_tot_up_cached(Engine *E, int t1) {
    if (tl_spr_cache) {
        auto it = tl_spr_cache->tot_up.find(t1);
        if (it != tl_spr_cache->tot_up.end()) return it->second;
    }
    return E->totUp[t1];
}

// spr.py find_best_parent_topology :51-541 (no HnZ/abayes/deeper)
static bool E_find_best_parent_topology(Engine *E, int node, int child,
                                        double best_lk_diff,
                                        double removed_blen,
                                        bool strict_stop, int allowed_fails,
                                        double threshold_log_lk,
                                        TopoResult *out) {
    auto &up = E->up;
    auto &dist = E->dist;
    auto &muts = E->muts;
    double eff0 = E->eff0;
    double threshold_opt = E->threshold_opt_topology;
    double threshold_consec = E->threshold_consec;
    int pruned = E->child(node, child);
    int best_node = E->child(node, 1 - child);
    std::vector<TopoCand> best_nodes;
    int64_t removed_rel = E_pass_up(E, E->pv[pruned], pruned);
    int64_t best_removed = E_pass_down(E, removed_rel, best_node);
    bool is_removed_tip = E->is_tip(pruned);
    double original_lk = best_lk_diff;
    int original_placement = best_node;
    int64_t original_removed = best_removed;
    double orig_top, orig_bottom;

    // original_parent0 (spr.py :76-78) and the removed-subtree nDesc0
    // compensation helper (:89-94) for HnZ crawls
    int original_parent0 = node;
    while (dist[original_parent0] <= eff0 && up[original_parent0] >= 0)
        original_parent0 = up[original_parent0];
    auto ndesc0_to_add_for = [&](bool anchor_dist_small) -> int32_t {
        if (!(E->hnz_mode && anchor_dist_small)) return 0;
        if (dist[pruned] >= eff0) return -1;
        return -E->nDesc0[pruned];
    };
    // HnZ mid-correction during the crawl (spr.py hnz_mid_correction
    // :156-188); the engine has no deeper search, so best_top =
    // best_bottom = distance/2 and best_appending = removed_blen
    auto hnz_mid_correction = [&](int t1, double best_top,
                                  double best_bottom, double best_appending,
                                  int32_t nd_add, bool at_root_like,
                                  bool from_above) -> double {
        auto &nd = E->nDesc0;
        if (at_root_like) {
            int p0 = t1;
            while (dist[p0] <= eff0 && up[p0] >= 0) p0 = up[p0];
            if (best_appending > eff0)
                return E->hnz(nd[p0] + nd_add + 1) - E->hnz(nd[p0] + nd_add);
            return E->hnz(nd[pruned] + nd[p0] + nd_add)
                   - (E->hnz(nd[pruned]) + E->hnz(nd[p0] + nd_add));
        }
        if (best_bottom <= eff0) {
            int32_t a = from_above ? 0 : nd_add;
            if (best_appending > eff0)
                return E->hnz(nd[t1] + a + 1) - E->hnz(nd[t1] + a);
            return E->hnz(nd[pruned] + nd[t1] + a)
                   - (E->hnz(nd[pruned]) + E->hnz(nd[t1] + a));
        }
        if (best_top <= eff0) {
            int32_t a = from_above ? nd_add : 0;
            int p0 = up[t1];
            while (dist[p0] <= eff0 && up[p0] >= 0) p0 = up[p0];
            if (best_appending > eff0)
                return E->hnz(nd[p0] + a + 1) - E->hnz(nd[p0] + a);
            return E->hnz(nd[pruned] + nd[p0] + a)
                   - (E->hnz(nd[pruned]) + E->hnz(nd[p0] + a));
        }
        if (best_appending > eff0) return E->hnz(2) - E->hnz(1);
        return E->hnz(nd[pruned] + 1) - E->hnz(nd[pruned]);
    };

    struct CrawlItem {
        int32_t t1; int32_t direction;
        uint8_t fresh;
        int64_t passed; double distance;
        double last_lk; int32_t failed;
        int64_t removed_rel;
        int32_t nd_add;
    };
    std::vector<CrawlItem> stack;

    if (up[node] >= 0) {
        int child_up = (E->c0[up[node]] == node) ? 1 : 2;
        int64_t vect_up_up = child_up == 1 ? E->upR[up[node]]
                                           : E->upL[up[node]];
        int64_t prob_vect1 = E_pass_up(E, E->pv[best_node], best_node);
        int64_t removed_rel1 = removed_rel;
        if (!muts[node].empty()) {
            prob_vect1 = E_pass_up(E, prob_vect1, node);
            removed_rel1 = E_pass_up(E, removed_rel, node);
        }
        stack.push_back({(int32_t)up[node], (int32_t)child_up, 1,
                         prob_vect1, dist[best_node] + dist[node],
                         best_lk_diff, 0, removed_rel1,
                         ndesc0_to_add_for(dist[node] < eff0)});
        int64_t vect_down = vect_up_up;
        if (!muts[node].empty())
            vect_down = E_pass_down(E, vect_down, node);
        removed_rel1 = removed_rel;
        if (!muts[best_node].empty()) {
            vect_down = E_pass_down(E, vect_down, best_node);
            removed_rel1 = E_pass_down(E, removed_rel, best_node);
        }
        stack.push_back({(int32_t)best_node, 0, 1, vect_down,
                         dist[best_node] + dist[node], best_lk_diff, 0,
                         removed_rel1,
                         ndesc0_to_add_for(dist[best_node] < eff0)});
        orig_top = dist[node];
        orig_bottom = dist[best_node];
    } else {
        if (!E->is_leaf(best_node)) {
            int child1 = E->c0[best_node], child2 = E->c1[best_node];
            int64_t vect_up1 = E_pass_up(E, E->pv[child2], child2);
            vect_up1 = E_root_vector(E, vect_up1, dist[child2],
                                     E->is_tip(child2), node);
            int64_t removed_rel1 = best_removed;
            if (!muts[child1].empty()) {
                removed_rel1 = E_pass_down(E, best_removed, child1);
                vect_up1 = E_pass_down(E, vect_up1, child1);
            }
            stack.push_back({(int32_t)child1, 0, 1, vect_up1, dist[child1],
                             best_lk_diff, 0, removed_rel1,
                             ndesc0_to_add_for(dist[child1] < eff0
                                               && dist[best_node] < eff0)});
            int64_t vect_up2 = E_pass_up(E, E->pv[child1], child1);
            vect_up2 = E_root_vector(E, vect_up2, dist[child1],
                                     E->is_tip(child1), node);
            int64_t removed_rel2 = best_removed;
            if (!muts[child2].empty()) {
                removed_rel2 = E_pass_down(E, best_removed, child2);
                vect_up2 = E_pass_down(E, vect_up2, child2);
            }
            stack.push_back({(int32_t)child2, 0, 1, vect_up2, dist[child2],
                             best_lk_diff, 0, removed_rel2,
                             ndesc0_to_add_for(dist[child2] < eff0
                                               && dist[best_node] < eff0)});
        }
        orig_top = 0.0;
        orig_bottom = dist[best_node];
    }
    double best_top = orig_top;
    double best_bottom = orig_bottom;
    double best_appending = removed_blen;

    int64_t since_improve = 0;
    while (!stack.empty()) {
        tl_crawl_visits++;
        if (E->spr_budget > 0 && since_improve > E->spr_budget) break;
        CrawlItem it = stack.back();
        stack.pop_back();
        int t1 = it.t1;
        int direction = it.direction;
        bool needs_updating = it.fresh != 0;
        int64_t passed = it.passed;
        double distance = it.distance;
        double last_lk = it.last_lk;
        int failed = it.failed;
        int64_t removed_here = it.removed_rel;
        int32_t nd_add = it.nd_add;
        double mid_prob;

        if (direction == 0) {
            if (!(up[t1] == node || up[t1] < 0)
                    && (dist[t1] > eff0 || up[up[t1]] < 0)) {
                int64_t mid_tot;
                if (needs_updating) {
                    bool is_tip = E->is_tip(t1);
                    mid_tot = E_merge(E, passed, distance / 2, false,
                                      E->pv[t1], distance / 2, is_tip,
                                      true);
                    if (mid_tot < 0) continue;
                    if (!E_different(E, mid_tot, E_tot_up_cached(E, t1)))
                        needs_updating = false;
                } else {
                    mid_tot = E_tot_up_cached(E, t1);
                    distance = dist[t1];
                }
                if (mid_tot < 0) continue;
                mid_prob = E_append(E, mid_tot, removed_here,
                                    is_removed_tip, removed_blen);
                if (E->hnz_mode)
                    mid_prob += hnz_mid_correction(
                        t1, distance / 2, distance / 2, removed_blen,
                        nd_add,
                        up[up[t1]] < 0 && distance <= eff0, true);
                if (mid_prob > best_lk_diff - threshold_opt) {
                    if (needs_updating)
                        best_nodes.push_back({(int32_t)t1, mid_prob, 1,
                                              passed, E->pv[t1], distance,
                                              mid_tot, removed_here});
                    else
                        best_nodes.push_back({(int32_t)t1, mid_prob, 0, -1,
                                              -1, 0.0, -1, removed_here});
                }
                if (mid_prob > best_lk_diff) {
                    best_lk_diff = mid_prob;
                    failed = 0;
                    since_improve = 0;
                    E_shorten(E, removed_here);
                } else if (mid_prob < last_lk - threshold_consec) {
                    failed++;
                    since_improve++;
                } else {
                    since_improve++;
                }
            } else {
                mid_prob = last_lk;
            }
            bool traverse;
            if (strict_stop)
                traverse = failed <= allowed_fails
                    && mid_prob > best_lk_diff - threshold_log_lk
                    && !E->is_leaf(t1);
            else
                traverse = (failed <= allowed_fails
                            || mid_prob > best_lk_diff - threshold_log_lk)
                    && !E->is_leaf(t1);
            if (traverse) {
                for (int ci = 0; ci < 2; ci++) {
                    int child1 = E->child(t1, ci);
                    int other = E->child(t1, 1 - ci);
                    int64_t vect_next;
                    if (needs_updating) {
                        int64_t other_vect = E_pass_up(E, E->pv[other],
                                                       other);
                        vect_next = E_merge(E, passed, distance, false,
                                            other_vect, dist[other],
                                            E->is_tip(other), true);
                    } else {
                        vect_next = ci == 0 ? E->upR[t1] : E->upL[t1];
                    }
                    if (vect_next < 0) continue;
                    int64_t removed_rel1 = removed_here;
                    if (!muts[child1].empty())
                        removed_rel1 = E_pass_down(E, removed_here,
                                                   child1);
                    int32_t nd_pass = (nd_add && dist[child1] < eff0)
                                          ? nd_add : 0;
                    if (needs_updating) {
                        if (!muts[child1].empty())
                            vect_next = E_pass_down(E, vect_next, child1);
                        stack.push_back({(int32_t)child1, 0, 1, vect_next,
                                         dist[child1], mid_prob,
                                         (int32_t)failed, removed_rel1,
                                         nd_pass});
                    } else {
                        stack.push_back({(int32_t)child1, 0, 0, -1, 0.0,
                                         mid_prob, (int32_t)failed,
                                         removed_rel1, nd_pass});
                    }
                }
            }
        } else {
            int other_child = E->child(t1, 2 - direction);
            int64_t mid_bottom = -1;
            int64_t vect_up = -1;
            if (up[t1] >= 0 && (dist[t1] > eff0 || up[up[t1]] < 0)) {
                int64_t mid_tot;
                if (needs_updating) {
                    int64_t other_vect = E_pass_up(E, E->pv[other_child],
                                                   other_child);
                    mid_bottom = E_merge(E, passed, distance, false,
                                         other_vect, dist[other_child],
                                         E->is_tip(other_child), false);
                    if (mid_bottom < 0) continue;
                    vect_up = E->vect_up_for(t1);
                    if (!muts[t1].empty())
                        vect_up = E_pass_down(E, vect_up, t1);
                    mid_tot = E_merge(E, vect_up, dist[t1] / 2, false,
                                      mid_bottom, dist[t1] / 2, false,
                                      true);
                    if (E_tot_up_cached(E, t1) < 0) {
                        int64_t filled = E_merge(E, vect_up,
                            dist[t1] / 2, false, E->pv[t1], dist[t1] / 2,
                            false, true);
                        if (tl_spr_cache) {
                            // survives end_call(): owned by the sweep-long
                            // side cache, freed when the worker finishes
                            tl_spr_cache->tot_up[t1] = filled;
                            if (filled >= 0) E->own_set().erase(filled);
                        } else {
                            E->install(&E->totUp[t1], filled);
                        }
                    }
                    if (mid_tot < 0) continue;
                    if (!E_different(E, mid_tot, E_tot_up_cached(E, t1)))
                        needs_updating = false;
                } else {
                    mid_tot = E_tot_up_cached(E, t1);
                }
                if (mid_tot < 0) continue;
                mid_prob = E_append(E, mid_tot, removed_here,
                                    is_removed_tip, removed_blen);
                if (E->hnz_mode)
                    mid_prob += hnz_mid_correction(
                        t1, dist[t1] / 2, dist[t1] / 2, removed_blen,
                        nd_add,
                        up[up[t1]] < 0 && dist[t1] <= eff0, false);
                if (mid_prob >= best_lk_diff - threshold_opt) {
                    if (needs_updating)
                        best_nodes.push_back({(int32_t)t1, mid_prob, 1,
                                              vect_up, mid_bottom,
                                              dist[t1], mid_tot,
                                              removed_here});
                    else
                        best_nodes.push_back({(int32_t)t1, mid_prob, 0, -1,
                                              -1, 0.0, -1, removed_here});
                }
                if (mid_prob > best_lk_diff) {
                    best_lk_diff = mid_prob;
                    failed = 0;
                    since_improve = 0;
                } else if (mid_prob < last_lk - threshold_consec) {
                    failed++;
                    since_improve++;
                } else {
                    since_improve++;
                }
            } else {
                mid_prob = last_lk;
            }
            bool keep;
            if (strict_stop)
                keep = failed <= allowed_fails
                    && mid_prob > best_lk_diff - threshold_log_lk;
            else
                keep = failed <= allowed_fails
                    || mid_prob > best_lk_diff - threshold_log_lk;
            if (keep) {
                if (up[t1] >= 0) {
                    int up_child = (t1 == E->c0[up[t1]]) ? 0 : 1;
                    int64_t vect_up2;
                    if (needs_updating) {
                        int64_t vect_up_up = up_child == 0
                            ? E->upR[up[t1]] : E->upL[up[t1]];
                        if (!muts[t1].empty())
                            vect_up_up = E_pass_down(E, vect_up_up, t1);
                        vect_up2 = E_merge(E, vect_up_up, dist[t1], false,
                                           passed, distance, false, true);
                    } else {
                        vect_up2 = direction == 1 ? E->upL[t1]
                                                  : E->upR[t1];
                    }
                    if (vect_up2 >= 0) {
                        int64_t removed_rel1 = removed_here;
                        if (!muts[other_child].empty())
                            removed_rel1 = E_pass_down(E, removed_here,
                                                       other_child);
                        int32_t nd_pass =
                            (nd_add && dist[other_child] < eff0) ? nd_add
                                                                 : 0;
                        if (needs_updating) {
                            if (!muts[other_child].empty())
                                vect_up2 = E_pass_down(E, vect_up2,
                                                       other_child);
                            stack.push_back({(int32_t)other_child, 0, 1,
                                             vect_up2, dist[other_child],
                                             mid_prob, (int32_t)failed,
                                             removed_rel1, nd_pass});
                        } else {
                            stack.push_back({(int32_t)other_child, 0, 0,
                                             -1, 0.0, mid_prob,
                                             (int32_t)failed,
                                             removed_rel1, nd_pass});
                        }
                    }
                    // continue crawling up
                    bool dropped = false;
                    if (needs_updating && mid_bottom < 0) {
                        int64_t other_vect = E_pass_up(
                            E, E->pv[other_child], other_child);
                        mid_bottom = E_merge(E, passed, distance, false,
                                             other_vect,
                                             dist[other_child],
                                             E->is_tip(other_child),
                                             false);
                        if (mid_bottom < 0) dropped = true;
                    }
                    if (!dropped) {
                        int64_t removed_rel1 = removed_here;
                        if (!muts[t1].empty())
                            removed_rel1 = E_pass_up(E, removed_here, t1);
                        int32_t nd_pass = (nd_add && dist[t1] < eff0)
                                              ? nd_add : 0;
                        if (needs_updating) {
                            if (!muts[t1].empty())
                                mid_bottom = E_pass_up(E, mid_bottom, t1);
                            stack.push_back({(int32_t)up[t1],
                                             (int32_t)(up_child + 1), 1,
                                             mid_bottom, dist[t1],
                                             mid_prob, (int32_t)failed,
                                             removed_rel1, nd_pass});
                        } else {
                            stack.push_back({(int32_t)up[t1],
                                             (int32_t)(up_child + 1), 0,
                                             -1, 0.0, mid_prob,
                                             (int32_t)failed,
                                             removed_rel1, nd_pass});
                        }
                    }
                } else {
                    int64_t vect_up2 = -1;
                    if (needs_updating) {
                        vect_up2 = E_root_vector(E, passed, distance,
                                                 false, t1);
                        if (!muts[other_child].empty())
                            vect_up2 = E_pass_down(E, vect_up2,
                                                   other_child);
                    }
                    int64_t removed_rel1 = removed_here;
                    if (!muts[other_child].empty())
                        removed_rel1 = E_pass_down(E, removed_here,
                                                   other_child);
                    int32_t nd_pass = (nd_add && dist[other_child] < eff0)
                                          ? nd_add : 0;
                    if (needs_updating) {
                        stack.push_back({(int32_t)other_child, 0, 1,
                                         vect_up2, dist[other_child],
                                         mid_prob, (int32_t)failed,
                                         removed_rel1, nd_pass});
                    } else {
                        stack.push_back({(int32_t)other_child, 0, 0, -1,
                                         0.0, mid_prob, (int32_t)failed,
                                         removed_rel1, nd_pass});
                    }
                }
            }
        }
    }

    // fine optimization of candidates
    double best_score = original_lk;
    if (best_nodes.empty()) {
        out->best_node = original_placement;
        out->best_score = original_lk;
        out->top = orig_top;
        out->bottom = orig_bottom;
        out->appending = removed_blen;
        out->removed = original_removed;
        return true;
    }
    int best_node_fine = best_node;
    for (const TopoCand &bc : best_nodes) {
        if (bc.score < original_lk - threshold_opt) continue;
        int t1 = bc.t1;
        int64_t up_vect, down_vect, mid_tot;
        double distance;
        if (!bc.fresh) {
            up_vect = E->vect_up_for(t1);
            if (!muts[t1].empty())
                up_vect = E_pass_down(E, up_vect, t1);
            down_vect = E->pv[t1];
            distance = dist[t1];
            mid_tot = E_tot_up_cached(E, t1);
        } else {
            up_vect = bc.up_vect;
            down_vect = bc.down_vect;
            distance = bc.distance;
            mid_tot = bc.mid_tot;
        }
        bool from_tip1 = E->is_tip(t1);
        EvalResult ev = E_evaluate_placement(E, mid_tot, down_vect,
                                             up_vect, distance,
                                             bc.removed, is_removed_tip,
                                             from_tip1);
        if (!ev.ok) {
            if (!Engine::tl_owned)
                E->error = "impossible merge in SPR fine phase";
            return false;
        }
        double initial_cost = E_append(E, up_vect, down_vect, from_tip1,
                                       distance);
        double new_partial_cost = E_append(E, up_vect, down_vect,
                                           from_tip1, ev.bottom + ev.top);
        double optimized = ev.cost + new_partial_cost - initial_cost;
        if (E->hnz_mode) {
            // spr.py _hnz_spr_correction (:544-678) — HnZ corrections
            // for the optimized SPR placement + the 0-bottom alternative
            auto &nd = E->nDesc0;
            auto H = [&](int n) { return E->hnz(n); };
            const double NEG_INF =
                -std::numeric_limits<double>::infinity();
            double b_top = ev.top, b_bottom = ev.bottom;
            double b_app = ev.appending;
            bool below_t1 = false;
            int opn0 = node;
            if (opn0 == t1) below_t1 = true;
            while (dist[opn0] <= eff0 && up[opn0] >= 0) {
                opn0 = up[opn0];
                if (opn0 == t1) below_t1 = true;
            }
            int pn0 = up[t1];
            while (dist[pn0] <= eff0 && up[pn0] >= 0) pn0 = up[pn0];
            int32_t comp = 0;
            if (pn0 == opn0)
                comp = dist[pruned] != 0.0 ? -1 : -nd[pruned];
            int32_t comp_t1 = 0;
            if (below_t1)
                comp_t1 = dist[pruned] != 0.0 ? -1 : -nd[pruned];
            double addendum;
            if (b_top > eff0 && b_bottom > eff0) {
                if (b_app > eff0) addendum = H(2) - H(1);
                else addendum = H(nd[pruned] + 1) - H(nd[pruned]);
                if (dist[t1] <= eff0)
                    addendum += H(nd[pn0] + 1 - comp_t1 + comp - nd[t1])
                                + H(nd[t1] + comp_t1)
                                - H(nd[pn0] + comp);
            } else if (b_bottom > eff0) {
                if (pn0 == original_parent0) {
                    addendum = NEG_INF;
                } else if (b_app > eff0) {
                    if (dist[t1] <= eff0)
                        addendum = H(nd[pn0] + comp + 2 - comp_t1
                                     - nd[t1]) + H(nd[t1] + comp_t1)
                                   - H(nd[pn0] + comp);
                    else
                        addendum = H(nd[pn0] + comp + 1)
                                   - H(nd[pn0] + comp);
                } else {
                    if (dist[t1] <= eff0)
                        addendum = H(nd[pn0] + comp + 1 - comp_t1
                                     + nd[pruned] - nd[t1])
                                   + H(nd[t1] + comp_t1)
                                   - (H(nd[pruned]) + H(nd[pn0] + comp));
                    else
                        addendum = H(nd[pn0] + comp + nd[pruned])
                                   - (H(nd[pruned]) + H(nd[pn0] + comp));
                }
            } else if (b_top > eff0) {
                if (t1 == original_parent0) {
                    addendum = NEG_INF;
                } else if (dist[t1] <= eff0) {
                    if (b_app > eff0)
                        addendum = H(nd[t1] + comp_t1 + 1)
                                   + H(nd[pn0] + 1 + comp - comp_t1
                                       - nd[t1])
                                   - H(nd[pn0] + comp);
                    else
                        addendum = H(nd[t1] + comp_t1 + nd[pruned])
                                   + H(nd[pn0] + 1 + comp - comp_t1
                                       - nd[t1])
                                   - (H(nd[pruned]) + H(nd[pn0] + comp));
                } else {
                    if (b_app > eff0)
                        addendum = H(nd[t1] + comp_t1 + 1)
                                   - H(nd[t1] + comp_t1);
                    else
                        addendum = H(nd[t1] + comp_t1 + nd[pruned])
                                   - (H(nd[pruned])
                                      + H(nd[t1] + comp_t1));
                }
            } else {
                if (pn0 == original_parent0 || t1 == original_parent0) {
                    addendum = NEG_INF;
                } else if (dist[t1] <= eff0) {
                    if (b_app > eff0)
                        addendum = H(nd[pn0] + comp + 1)
                                   - H(nd[pn0] + comp);
                    else
                        addendum = H(nd[pn0] + comp + nd[pruned])
                                   - (H(nd[pruned]) + H(nd[pn0] + comp));
                } else {
                    if (b_app > eff0)
                        addendum = H(nd[pn0] + comp + nd[t1] + comp_t1
                                     + 1)
                                   - (H(nd[pn0] + comp)
                                      + H(nd[t1] + comp_t1));
                    else
                        addendum = H(nd[pn0] + comp + nd[t1] + comp_t1
                                     + nd[pruned])
                                   - (H(nd[pruned]) + H(nd[pn0] + comp)
                                      + H(nd[t1] + comp_t1));
                }
            }
            optimized += addendum;

            if (b_bottom > eff0 && dist[t1] > eff0) {
                int64_t alt_mid = E_merge(E, up_vect, b_top + b_bottom,
                                          false, down_vect, 0.0,
                                          from_tip1, true);
                if (alt_mid >= 0) {
                    double alt_cost = E_append(E, alt_mid, bc.removed,
                                               is_removed_tip, b_app);
                    double ic2 = E_append(E, up_vect, down_vect,
                                          from_tip1, distance);
                    double np2 = E_append(E, up_vect, down_vect,
                                          from_tip1, b_bottom + b_top);
                    double alt_optimized = alt_cost + np2 - ic2;
                    if ((b_top + b_bottom) > eff0) {
                        if (t1 == original_parent0)
                            addendum = NEG_INF;
                        else if (b_app > eff0)
                            addendum = H(nd[t1] + comp_t1 + 1)
                                       - H(nd[t1] + comp_t1);
                        else
                            addendum = H(nd[t1] + comp_t1 + nd[pruned])
                                       - (H(nd[pruned])
                                          + H(nd[t1] + comp_t1));
                    } else {
                        if (pn0 == original_parent0
                                || t1 == original_parent0)
                            addendum = NEG_INF;
                        else if (b_app > eff0)
                            addendum = H(nd[pn0] + comp + nd[t1]
                                         + comp_t1 + 1)
                                       - (H(nd[pn0] + comp)
                                          + H(nd[t1] + comp_t1));
                        else
                            addendum = H(nd[pn0] + comp + nd[t1]
                                         + comp_t1 + nd[pruned])
                                       - (H(nd[pruned])
                                          + H(nd[pn0] + comp)
                                          + H(nd[t1] + comp_t1));
                    }
                    alt_optimized += addendum;
                    if (alt_optimized > optimized) {
                        optimized = alt_optimized;
                        b_top = b_top + b_bottom;
                        b_bottom = 0.0;
                    }
                }
            }
            ev.top = b_top;
            ev.bottom = b_bottom;
        }
        if (optimized >= best_score) {
            best_node_fine = t1;
            best_score = optimized;
            best_top = ev.top;
            best_bottom = ev.bottom;
            best_appending = ev.appending;
            best_removed = bc.removed;
        }
    }
    out->best_node = best_node_fine;
    out->best_score = best_score;
    out->top = best_top;
    out->bottom = best_bottom;
    out->appending = best_appending;
    out->removed = best_removed;
    return true;
}

// spr.py place_subtree_on_tree :682-916 (no HnZ)
static int E_place_subtree(Engine *E, int node, int64_t new_partials,
                           int appended, double new_child_lk,
                           double best_up, double best_down,
                           double best_appending) {
    auto &up = E->up;
    auto &dist = E->dist;
    auto &muts = E->muts;
    bool try_new_root = false;
    int child = E->child_index(node);
    int64_t vect_up = child == 0 ? E->upR[up[node]] : E->upL[up[node]];
    int root = -1;
    int64_t root_new_partials = -1;
    if (best_up == 0.0) {
        int p_node = up[node];
        while (dist[p_node] == 0.0 && up[p_node] >= 0)
            p_node = up[p_node];
        if (up[p_node] < 0) {
            root = p_node;
            try_new_root = true;
            if (best_down == 0.0 || best_down > 1.01 * dist[node]
                    || best_down < 0.99 * dist[node]) {
                if (E->hnz_mode) E->nd0_changing_dist(node, best_down);
                dist[node] = best_down;
                std::vector<WorkItem> wl;
                wl.push_back({(int32_t)node, 2, 1});
                wl.push_back({(int32_t)up[node], (int32_t)child, 1});
                if (!E_update_partials(E, std::move(wl))) return -2;
            }
        }
        if (try_new_root) {
            int p2 = up[node];
            root_new_partials = new_partials;
            if (!muts[node].empty())
                root_new_partials = E_pass_up(E, new_partials, node);
            while (dist[p2] == 0.0 && up[p2] >= 0) {
                if (!muts[p2].empty())
                    root_new_partials = E_pass_up(E, root_new_partials,
                                                  p2);
                p2 = up[p2];
            }
        }
    }
    bool appended_is_tip = E->is_tip(appended);

    if (try_new_root) {
        node = root;
        bool is_tip = E->is_tip(node);
        double prob_old_root = E_find_prob_root(E, E->pv[node], node);
        int64_t root_up_left = E_root_vector(E, E->pv[node],
            best_appending / 2, is_tip, node);
        double best_right = E_blen(E, root_up_left, root_new_partials,
                                   appended_is_tip);
        int64_t root_up_right = E_root_vector(E, root_new_partials,
                                              best_right, appended_is_tip,
                                              node);
        double best_left = E_blen(E, root_up_right, E->pv[node], is_tip);
        root_up_left = E_root_vector(E, E->pv[node], best_left, is_tip,
                                     node);
        best_right = E_blen(E, root_up_left, root_new_partials,
                            appended_is_tip);
        root_up_right = E_root_vector(E, root_new_partials, best_right,
                                      appended_is_tip, node);
        best_left = E_blen(E, root_up_right, E->pv[node], is_tip);
        int64_t prob_vect_root = E_merge(E, E->pv[node], best_left, is_tip,
            root_new_partials, best_right, appended_is_tip, false);
        double prob_root = E_append(E, root_up_left, root_new_partials,
                                    appended_is_tip, best_right);
        prob_root += E_find_prob_root(E, prob_vect_root, node);
        double parent_lk_diff = prob_root - prob_old_root;
        if (parent_lk_diff <= new_child_lk) {
            best_right = best_appending;
            best_left = 0.0;
            prob_vect_root = E_merge(E, E->pv[node], best_left, is_tip,
                root_new_partials, best_right, appended_is_tip, false);
            root_up_right = E_root_vector(E, root_new_partials, best_right,
                                          appended_is_tip, node);
        }
        if (!muts[appended].empty()) E->num_refs--;
        E_update_mutation_list(E, appended, node);
        if (!muts[appended].empty()) E->num_refs++;
        int new_root = up[appended];
        up[new_root] = -1;
        E->dirty[new_root] = 1;
        dist[new_root] = E->default_blen;
        E->replacements[new_root]++;
        if (prob_vect_root < 0) {
            E->error = "new root probVect None in place_subtree";
            return -2;
        }
        E_shorten(E, prob_vect_root);
        E->install(&E->pv[new_root], prob_vect_root);
        E_shorten(E, root_up_right);
        E->install(&E->upR[new_root], root_up_right);
        E->install(&E->upL[new_root], E_root_vector(E, E->pv[node],
            best_left, is_tip, node));
        E_shorten(E, E->upL[new_root]);
        E->muts[new_root] = std::move(E->muts[node]);
        E->muts[node].clear();
        up[node] = new_root;
        dist[node] = best_left;
        E->c0[new_root] = node;
        E->c1[new_root] = appended;
        dist[appended] = best_right;
        E->replacements[appended]++;
        if (E->hnz_mode) {
            // spr.py :789-793
            E->nDesc0[new_root] = dist[node] > E->eff0
                ? 1 : E->nDesc0[node];
            E->nDesc0[new_root] += dist[appended] > E->eff0
                ? 1 : E->nDesc0[appended];
        }
        std::vector<WorkItem> wl;
        wl.push_back({(int32_t)node, 2, 1});
        wl.push_back({(int32_t)appended, 2, 1});
        if (!E_update_partials(E, std::move(wl))) return -2;
        return new_root;
    }

    // ordinary re-attachment below `node`
    if (!muts[node].empty())
        vect_up = E_pass_down(E, vect_up, node);
    bool is_tip = E->is_tip(node);
    if (!muts[appended].empty()) E->num_refs--;
    E_update_mutation_list(E, appended, node);
    if (!muts[appended].empty()) E->num_refs++;
    int new_internal = up[appended];
    E->muts[new_internal] = std::move(E->muts[node]);
    E->muts[node].clear();
    E->dirty[new_internal] = 1;
    E->replacements[new_internal]++;
    if (child == 0) E->c0[up[node]] = new_internal;
    else E->c1[up[node]] = new_internal;
    up[new_internal] = up[node];
    E->c0[new_internal] = node;
    up[node] = new_internal;
    E->replacements[appended]++;
    E->c1[new_internal] = appended;

    auto merge_lower = [&]() {
        return E_merge(E, E->pv[node], best_down, is_tip, new_partials,
                       best_appending, appended_is_tip, false);
    };
    auto merge_up_right = [&]() {
        return E_merge(E, vect_up, best_up, false, new_partials,
                       best_appending, appended_is_tip, true);
    };
    auto merge_up_left = [&]() {
        return E_merge(E, vect_up, best_up, false, E->pv[node], best_down,
                       is_tip, true);
    };

    int64_t lower = merge_lower();
    if (lower < 0) {
        int64_t ul = merge_up_left();
        if (ul < 0) {
            int64_t ur = merge_up_right();
            E->install(&E->upR[new_internal], ur);
            best_down = E_blen(E, E->upR[new_internal], E->pv[node],
                               is_tip);
            ul = merge_up_left();
            E->install(&E->upL[new_internal], ul);
            best_appending = E_blen(E, E->upL[new_internal], new_partials,
                                    appended_is_tip);
        } else {
            E->install(&E->upL[new_internal], ul);
            best_appending = E_blen(E, E->upL[new_internal], new_partials,
                                    appended_is_tip);
            int64_t ur = merge_up_right();
            E->install(&E->upR[new_internal], ur);
            best_down = E_blen(E, E->upR[new_internal], E->pv[node],
                               is_tip);
        }
        lower = merge_lower();
        if (lower < 0) {
            best_appending = E->one_mut / 5;
            best_down = E->one_mut / 5;
            lower = merge_lower();
            if (lower < 0) {
                E->error = "unresolvable lower merge in place_subtree";
                return -2;
            }
        }
    }
    E->install(&E->pv[new_internal], lower);
    E_shorten(E, E->pv[new_internal]);
    int64_t ur = merge_up_right();
    if (ur < 0) {
        best_up = E_blen(E, vect_up, E->pv[new_internal], false);
        E->install(&E->upL[new_internal], merge_up_left());
        best_appending = E_blen(E, E->upL[new_internal], new_partials,
                                appended_is_tip);
        ur = merge_up_right();
        if (ur < 0) {
            best_up = E->one_mut / 5;
            best_appending = E->one_mut / 5;
            ur = merge_up_right();
            if (ur < 0) {
                E->error = "unresolvable upRight merge in place_subtree";
                return -2;
            }
        }
        E->install(&E->pv[new_internal], merge_lower());
    }
    E->install(&E->upR[new_internal], ur);
    E_shorten(E, E->upR[new_internal]);
    int64_t ul = merge_up_left();
    if (ul < 0) {
        best_up = E_blen(E, vect_up, E->pv[new_internal], false);
        best_down = E_blen(E, E->upR[new_internal], E->pv[node], is_tip);
        ul = merge_up_left();
        if (ul < 0) {
            best_up = E->one_mut / 5;
            best_down = E->one_mut / 5;
            ul = merge_up_left();
            if (ul < 0) {
                E->error = "unresolvable upLeft merge in place_subtree";
                return -2;
            }
        }
        E->install(&E->pv[new_internal], merge_lower());
        E->install(&E->upR[new_internal], merge_up_right());
    }
    E->install(&E->upL[new_internal], ul);
    E_shorten(E, E->upL[new_internal]);
    double old_dist = dist[node];
    dist[appended] = best_appending;
    dist[new_internal] = best_up;
    dist[node] = best_down;
    if (E->hnz_mode) {
        // spr.py :884-904
        auto &nd = E->nDesc0;
        nd[new_internal] = dist[node] <= E->eff0 ? nd[node] : 1;
        nd[new_internal] += dist[appended] > E->eff0 ? 1 : nd[appended];
        int32_t to_add = 0;
        if (old_dist > E->eff0 && dist[new_internal] <= E->eff0)
            to_add = nd[new_internal] - 1;
        else if (old_dist <= E->eff0 && dist[new_internal] > E->eff0)
            to_add = 1 - nd[node];
        else if (old_dist <= E->eff0 && dist[new_internal] <= E->eff0)
            to_add = nd[new_internal] - nd[node];
        if (to_add) {
            int p0 = up[new_internal];
            while (true) {
                nd[p0] += to_add;
                if (dist[p0] > E->eff0) break;
                p0 = up[p0];
                if (p0 < 0) break;
            }
        }
    }
    if (best_appending == 0.0)
        E->install(&E->totUp[appended], -1);
    if (best_up != 0.0) {
        E->install(&E->totUp[new_internal], E_merge(E, vect_up,
            best_up / 2, false, E->pv[new_internal], best_up / 2, false,
            true));
        E_shorten(E, E->totUp[new_internal]);
    }
    if (best_down == 0.0)
        E->install(&E->totUp[node], -1);
    std::vector<WorkItem> wl;
    wl.push_back({(int32_t)node, 2, 1});
    wl.push_back({(int32_t)up[new_internal], (int32_t)child, 1});
    wl.push_back({(int32_t)appended, 2, 1});
    if (!E_update_partials(E, std::move(wl))) return -2;
    return -1;
}

// spr.py cut_and_paste_node :919-975 (no HnZ/trace)
static int E_cut_and_paste(Engine *E, int node, int best_node,
                           double top, double bottom, double appending,
                           double best_lk, int64_t passed_vect) {
    auto &up = E->up;
    auto &dist = E->dist;
    int parent = up[node];
    int sibling = (node == E->c0[parent]) ? E->c1[parent] : E->c0[parent];
    int child_p = -1;
    if (up[parent] >= 0) {
        child_p = (parent == E->c0[up[parent]]) ? 0 : 1;
        if (child_p == 0) E->c0[up[parent]] = sibling;
        else E->c1[up[parent]] = sibling;
        if (E->hnz_mode && dist[parent] <= E->eff0) {
            // spr.py :936-946
            int32_t to_remove = dist[node] > E->eff0
                ? -1 : -E->nDesc0[node];
            if (dist[sibling] <= E->eff0
                    && (dist[sibling] + dist[parent]) > E->eff0)
                to_remove += 1 - E->nDesc0[sibling];
            int p0 = parent;
            while (dist[p0] <= E->eff0 && up[p0] >= 0) {
                p0 = up[p0];
                E->nDesc0[p0] += to_remove;
                if (E->nDesc0[p0] <= 0) {
                    E->error = "negative nDesc0 removing subtree";
                    return -2;
                }
            }
        }
    }
    up[sibling] = up[parent];
    dist[sibling] = dist[sibling] + dist[parent];
    if (!E->muts[parent].empty())
        E->muts[sibling] = E_merge_mutation_lists(E->muts[parent],
                                                  E->muts[sibling], false);
    if (up[sibling] < 0) {
        dist[sibling] = 1.0;
        if (!E->is_leaf(sibling)) {
            int sc0 = E->c0[sibling], sc1 = E->c1[sibling];
            E->install(&E->upR[sibling], E_root_vector(E,
                E_pass_up(E, E->pv[sc1], sc1), dist[sc1],
                E->is_tip(sc1), sibling));
            E->install(&E->upL[sibling], E_root_vector(E,
                E_pass_up(E, E->pv[sc0], sc0), dist[sc0],
                E->is_tip(sc0), sibling));
            std::vector<WorkItem> wl;
            wl.push_back({(int32_t)sc0, 2, 1});
            wl.push_back({(int32_t)sc1, 2, 1});
            if (!E_update_partials(E, std::move(wl))) return -2;
        }
    } else {
        std::vector<WorkItem> wl;
        wl.push_back({(int32_t)sibling, 2, 1});
        wl.push_back({(int32_t)up[sibling], (int32_t)child_p, 1});
        if (!E_update_partials(E, std::move(wl))) return -2;
    }
    int new_root = E_place_subtree(E, best_node, passed_vect, node,
                                   best_lk, top, bottom, appending);
    if (new_root == -2) return -2;
    if (up[sibling] < 0) {
        if (new_root >= 0) return new_root;
        return sibling;
    }
    return new_root;
}

// spr.py traverse_tree_for_topology_update :984-1127 (no HnZ/abayes)
// returns 0 ok / -1 error; outputs via pointers
static int E_traverse_topology(Engine *E, int node, bool strict_stop,
                               int allowed_fails, double threshold_log_lk,
                               int *new_root_out, double *improvement_out,
                               long *topo_updates, long *blen_updates) {
    auto &up = E->up;
    auto &dist = E->dist;
    double eff0 = E->eff0;
    double threshold_topology_placement = E->threshold_topology_placement;
    *new_root_out = -1;
    *improvement_out = 0.0;
    if (up[node] < 0) return 0;
    int parent = up[node];
    int child = E->child_index(node);
    int64_t vect_up = child == 0 ? E->upR[parent] : E->upL[parent];
    if (!E->muts[node].empty())
        vect_up = E_pass_down(E, vect_up, node);
    double best_curren_blen = dist[node];
    bool is_tip = E->is_tip(node);
    double original_lk = E_append(E, vect_up, E->pv[node], is_tip,
                                  best_curren_blen);
    double genetic_lk = original_lk;
    int pn0 = -1;
    if (E->hnz_mode) {
        // spr.py :1016-1026 — HnZ correction of the current placement
        auto &nd = E->nDesc0;
        pn0 = up[node];
        while (dist[pn0] <= eff0 && up[pn0] >= 0) pn0 = up[pn0];
        if (dist[node] > eff0)
            original_lk += E->hnz(nd[pn0]) - E->hnz(nd[pn0] - 1);
        else
            original_lk += E->hnz(nd[pn0])
                           - (E->hnz(nd[pn0] - nd[node])
                              + E->hnz(nd[node]));
    }
    double best_current_lk = original_lk;
    bool blen_changed = false;
    if (genetic_lk < threshold_topology_placement
            && up[up[node]] >= 0) {
        best_curren_blen = E_blen(E, vect_up, E->pv[node], is_tip);
        if (best_curren_blen != 0.0 || dist[node] != 0.0) {
            if (best_curren_blen == 0.0 || dist[node] == 0.0
                    || dist[node] / best_curren_blen > 1.01
                    || dist[node] / best_curren_blen < 0.99)
                blen_changed = true;
            best_current_lk = E_append(E, vect_up, E->pv[node], is_tip,
                                       best_curren_blen);
            if (E->hnz_mode) {
                // spr.py :1038-1059
                auto &nd = E->nDesc0;
                double hz;
                if (best_curren_blen > eff0) {
                    if (dist[node] > eff0)
                        hz = E->hnz(nd[pn0]) - E->hnz(nd[pn0] - 1);
                    else
                        hz = E->hnz(nd[pn0] + 1 - nd[node])
                             - E->hnz(nd[pn0] - nd[node]);
                } else {
                    if (dist[node] > eff0)
                        hz = E->hnz(nd[pn0] + nd[node] - 1)
                             - (E->hnz(nd[pn0]) + E->hnz(nd[node]));
                    else
                        hz = E->hnz(nd[pn0])
                             - (E->hnz(nd[pn0] - nd[node])
                                + E->hnz(nd[node]));
                }
                best_current_lk += hz;
            }
            if (best_current_lk < original_lk) {
                best_curren_blen = dist[node];
                best_current_lk = original_lk;
                blen_changed = false;
            }
            if (best_current_lk
                    == -std::numeric_limits<double>::infinity()) {
                E->error = "infinite cost in SPR current placement";
                return -1;
            }
        }
    }
    bool topology_updated = false;
    if (best_current_lk < threshold_topology_placement
            || dist[node] != 0.0 || E->hnz_mode) {
        TopoResult R;
        if (!E_find_best_parent_topology(E, parent, child,
                                         best_current_lk,
                                         best_curren_blen, strict_stop,
                                         allowed_fails, threshold_log_lk,
                                         &R))
            return -1;
        if (R.best_score == std::numeric_limits<double>::infinity()) {
            E->error = "infinite improvement in SPR search";
            return -1;
        }
        if (R.best_score < -1e50) {
            E->error = "likelihood cost extremely heavy; wrong reference?";
            return -1;
        }
        if (R.best_score + threshold_topology_placement
                > best_current_lk) {
            topology_updated = true;
            int top_node = up[node];
            if (R.best_node == top_node) topology_updated = false;
            while (dist[top_node] == 0.0 && up[top_node] >= 0)
                top_node = up[top_node];
            if (R.best_node == top_node && R.bottom == 0.0)
                topology_updated = false;
            parent = up[node];
            int sibling = (node == E->c0[parent]) ? E->c1[parent]
                                                  : E->c0[parent];
            if (R.best_node == sibling) topology_updated = false;
            if (up[R.best_node] == sibling && R.top == 0.0)
                topology_updated = false;
            if (topology_updated) {
                (*topo_updates)++;
                double improvement = R.best_score - original_lk;
                if (original_lk
                        == -std::numeric_limits<double>::infinity())
                    improvement = R.best_score - best_current_lk;
                if (improvement
                        == std::numeric_limits<double>::infinity()) {
                    E->error = "infinite topology improvement";
                    return -1;
                }
                *improvement_out = improvement;
                int nr = E_cut_and_paste(E, node, R.best_node, R.top,
                                         R.bottom, R.appending,
                                         R.best_score, R.removed);
                if (nr == -2) return -1;
                *new_root_out = nr;
                blen_changed = false;
            }
        }
    }
    if (!topology_updated && blen_changed) {
        (*blen_updates)++;
        if (E->hnz_mode) E->nd0_changing_dist(node, best_curren_blen);
        dist[node] = best_curren_blen;
        std::vector<WorkItem> wl;
        wl.push_back({(int32_t)node, 2, 1});
        wl.push_back({(int32_t)up[node], (int32_t)child, 1});
        if (!E_update_partials(E, std::move(wl))) return -1;
        double improvement = best_current_lk - original_lk;
        if (original_lk == -std::numeric_limits<double>::infinity())
            improvement = 0;
        if (improvement == std::numeric_limits<double>::infinity()) {
            E->error = "infinite branch length improvement";
            return -1;
        }
        *improvement_out = improvement;
    }
    return 0;
}


// ---------------------------------------------------------------- phases
// Steady-state full recompute of all cached genome lists: the
// non-first-setup / non-error-refresh path of partials.recalculate_all
// (reference reCalculateAllGenomeLists :6013-6347).  Tips keep their
// lower vectors; all internal lowers and every upper/total vector are
// rebuilt with the same repair semantics as the Python host code.
static int E_recalculate(Engine *E) {
    int root = E->root;
    std::vector<double> &dist = E->dist;
    // pass 1: lower vectors (post-order)
    int node = root, last = -1, dir = 0;
    while (node >= 0) {
        if (dir == 0) {
            if (E->c0[node] >= 0) { node = E->c0[node]; continue; }
            if (!E->err_patches.empty()) {
                // error-model refresh of this tip's shared lists, replayed
                // at the reference's exact post-order position (see
                // Engine::err_patches)
                auto itp = E->err_patches.find(node);
                if (itp != E->err_patches.end())
                    for (int64_t i = itp->second.first;
                         i < itp->second.second; i++)
                        store_patch_tag(E->S, E->err_tags[i],
                                        E->err_vals + 4 * i);
            }
            last = node;
            node = E->up[node];
            dir = 1;
        } else if (last == E->c0[node]) {
            node = E->c1[node];
            dir = 0;
        } else {
            int cc0 = E->c0[node], cc1 = E->c1[node];
            bool t0 = E->is_tip(cc0), t1 = E->is_tip(cc1);
            int64_t v0 = E_pass_up(E, E->pv[cc0], cc0);
            int64_t v1 = E_pass_up(E, E->pv[cc1], cc1);
            int64_t nl = E_merge(E, v0, dist[cc0], t0, v1, dist[cc1], t1,
                                 false);
            if (nl < 0) {
                if (dist[cc0] == 0.0 && dist[cc1] == 0.0) {
                    E_update_blen(E, cc0, false, nullptr);
                    if (dist[cc0] == 0.0)
                        E_update_blen(E, cc1, false, nullptr);
                    nl = E_merge(E, v0, dist[cc0], t0, v1, dist[cc1], t1,
                                 false);
                    if (nl < 0) {
                        dist[cc0] = E->one_mut / 2;
                        dist[cc1] = E->one_mut / 2;
                        nl = E_merge(E, v0, dist[cc0], t0, v1, dist[cc1],
                                     t1, false);
                        if (nl < 0) {
                            E->error = "unresolvable merge in recalculate";
                            return -1;
                        }
                    }
                } else {
                    E->error = "inconsistent lower list with non-zero "
                               "distances in recalculate";
                    return -1;
                }
            }
            E->install(&E->pv[node], nl);
            E_shorten(E, E->pv[node]);
            last = node;
            node = E->up[node];
            dir = 1;
        }
    }
    // pass 2: upper/total vectors (pre-order)
    if (E->c0[root] < 0) return 0;
    int rc0 = E->c0[root], rc1 = E->c1[root];
    E->install(&E->upR[root],
               E_root_vector(E, E_pass_up(E, E->pv[rc1], rc1), dist[rc1],
                             E->is_tip(rc1), root));
    E->install(&E->upL[root],
               E_root_vector(E, E_pass_up(E, E->pv[rc0], rc0), dist[rc0],
                             E->is_tip(rc0), root));
    std::vector<WorkItem> tot_list;
    node = E->c0[root];
    last = -1;
    dir = 0;
    while (node >= 0) {
        if (dir == 0) {
            int cn = E->child_index(node);
            int64_t vect_up = cn == 0 ? E->upR[E->up[node]]
                                      : E->upL[E->up[node]];
            vect_up = E_pass_down(E, vect_up, node);
            if (dist[node] != 0.0) {
                int64_t nt = E_merge(E, vect_up, dist[node] / 2, false,
                                     E->pv[node], dist[node] / 2,
                                     E->is_tip(node), true);
                if (nt >= 0) E_shorten(E, nt);
                E->install(&E->totUp[node], nt);
            } else {
                E->install(&E->totUp[node], -1);
            }
            if (E->c0[node] >= 0) {
                int cc0 = E->c0[node], cc1 = E->c1[node];
                bool t0 = E->is_tip(cc0), t1 = E->is_tip(cc1);
                int64_t v0 = E_pass_up(E, E->pv[cc0], cc0);
                int64_t v1 = E_pass_up(E, E->pv[cc1], cc1);
                int64_t nur = E_merge(E, vect_up, dist[node], false, v1,
                                      dist[cc1], t1, true);
                if (nur < 0) {
                    if (dist[cc1] == 0.0 && dist[node] == 0.0) {
                        E_update_blen(E, node, false, nullptr);
                        if (dist[node] == 0.0) {
                            E_update_blen(E, cc1, false, nullptr);
                            tot_list.push_back({(int32_t)node, 1, 1});
                        } else {
                            E->install(&E->totUp[node],
                                E_merge(E, vect_up, dist[node] / 2, false,
                                        E->pv[node], dist[node] / 2, false,
                                        true));
                            tot_list.push_back({(int32_t)E->up[node],
                                                (int32_t)cn, 1});
                        }
                        E->install(&E->upR[node],
                                   E_merge(E, vect_up, dist[node], false,
                                           v1, dist[cc1], t1, true));
                    } else {
                        E->error = "inconsistent upRight list in "
                                   "recalculate";
                        return -1;
                    }
                } else {
                    E_shorten(E, nur);
                    E->install(&E->upR[node], nur);
                }
                int64_t nul = E_merge(E, vect_up, dist[node], false, v0,
                                      dist[cc0], t0, true);
                if (nul < 0) {
                    if (dist[cc0] == 0.0 && dist[node] == 0.0) {
                        E_update_blen(E, cc0, false, nullptr);
                        if (dist[cc0] == 0.0) {
                            E_update_blen(E, node, false, nullptr);
                            tot_list.push_back({(int32_t)E->up[node],
                                                (int32_t)cn, 1});
                            E->install(&E->totUp[node],
                                E_merge(E, vect_up, dist[node] / 2, false,
                                        E->pv[node], dist[node] / 2,
                                        E->is_tip(node), true));
                            E->install(&E->upR[node],
                                       E_merge(E, vect_up, dist[node],
                                               false, v1, dist[cc1], t1,
                                               true));
                        } else {
                            tot_list.push_back({(int32_t)node, 0, 1});
                        }
                        E->install(&E->upL[node],
                                   E_merge(E, vect_up, dist[node], false,
                                           v0, dist[cc0], t0, true));
                    } else {
                        E->error = "inconsistent upLeft list in "
                                   "recalculate";
                        return -1;
                    }
                } else {
                    E_shorten(E, nul);
                    E->install(&E->upL[node], nul);
                }
                node = E->c0[node];
            } else {
                last = node;
                node = E->up[node];
                dir = 1;
            }
        } else if (last == E->c0[node]) {
            node = E->c1[node];
            dir = 0;
        } else {
            last = node;
            node = E->up[node];
            dir = 1;
        }
    }
    if (!E_update_partials(E, std::move(tot_list))) return -1;
    return 0;
}

// ---- phase-parallel full recompute ---------------------------------
// Partition the tree into disjoint frontier subtrees of roughly equal
// size; worker threads recompute within subtrees while the main thread
// handles the interior.  Every recomputed vector is a pure function of
// finalized inputs (tip vectors, dist, muts, and — for the upper pass —
// uppers of already-processed ancestors), so the result is
// byte-identical to the serial pass.  The serial pass's rare repair
// conditions (inconsistent merges needing branch-length surgery) are
// order-dependent and mutate shared state (dist, nDesc0), so any such
// condition bails the whole call out to the serial path, which reruns
// from scratch — safe because the happy path mutates none of its own
// inputs (the recompute is idempotent).

// post-order lower recompute below `top`; masked nodes (and tips) are
// treated as leaves (their lower vectors are already final).  Returns
// false when a repair condition was hit (bail set).
static bool E_recalc_lowers_nr(Engine *E, int top,
                               const std::vector<char> *mask,
                               std::atomic<bool> *bail) {
    auto blocked = [&](int n) {
        return E->c0[n] < 0 || (mask && (*mask)[n]);
    };
    if (blocked(top)) return true;
    int node = top, last = -1, dir = 0;
    while (true) {
        if (bail->load(std::memory_order_relaxed)) return false;
        if (dir == 0) {
            if (!blocked(node)) { node = E->c0[node]; continue; }
            last = node;
            node = E->up[node];
            dir = 1;
        } else if (last == E->c0[node]) {
            node = E->c1[node];
            dir = 0;
        } else {
            int cc0 = E->c0[node], cc1 = E->c1[node];
            bool t0 = E->is_tip(cc0), t1 = E->is_tip(cc1);
            int64_t v0 = E_pass_up(E, E->pv[cc0], cc0);
            int64_t v1 = E_pass_up(E, E->pv[cc1], cc1);
            int64_t nl = E_merge(E, v0, E->dist[cc0], t0, v1, E->dist[cc1],
                                 t1, false);
            if (nl < 0) {  // zero-dist inconsistency: serial repair path
                bail->store(true);
                return false;
            }
            E->install(&E->pv[node], nl);
            E_shorten(E, E->pv[node]);
            if (node == top) return true;
            last = node;
            node = E->up[node];
            dir = 1;
        }
    }
}

// pre-order upper/total recompute from `top` (inclusive); masked nodes
// are neither processed nor descended into (their subtree's worker
// handles them).  Requires upR/upL of up[top] to be final.
static bool E_recalc_uppers_nr(Engine *E, int top,
                               const std::vector<char> *mask,
                               std::atomic<bool> *bail) {
    int node = top, last = -1, dir = 0;
    while (true) {
        if (bail->load(std::memory_order_relaxed)) return false;
        if (dir == 0) {
            if (mask && (*mask)[node]) {
                if (node == top) return true;
                last = node;
                node = E->up[node];
                dir = 1;
                continue;
            }
            int cn = E->child_index(node);
            int64_t vect_up = cn == 0 ? E->upR[E->up[node]]
                                      : E->upL[E->up[node]];
            vect_up = E_pass_down(E, vect_up, node);
            double dn = E->dist[node];
            if (dn != 0.0) {
                int64_t nt = E_merge(E, vect_up, dn / 2, false,
                                     E->pv[node], dn / 2, E->is_tip(node),
                                     true);
                if (nt >= 0) E_shorten(E, nt);
                E->install(&E->totUp[node], nt);
            } else {
                E->install(&E->totUp[node], -1);
            }
            if (E->c0[node] >= 0) {
                int cc0 = E->c0[node], cc1 = E->c1[node];
                bool t0 = E->is_tip(cc0), t1 = E->is_tip(cc1);
                int64_t v0 = E_pass_up(E, E->pv[cc0], cc0);
                int64_t v1 = E_pass_up(E, E->pv[cc1], cc1);
                int64_t nur = E_merge(E, vect_up, dn, false, v1,
                                      E->dist[cc1], t1, true);
                if (nur < 0) { bail->store(true); return false; }
                E_shorten(E, nur);
                E->install(&E->upR[node], nur);
                int64_t nul = E_merge(E, vect_up, dn, false, v0,
                                      E->dist[cc0], t0, true);
                if (nul < 0) { bail->store(true); return false; }
                E_shorten(E, nul);
                E->install(&E->upL[node], nul);
                node = E->c0[node];
                continue;
            }
            if (node == top) return true;
            last = node;
            node = E->up[node];
            dir = 1;
        } else if (last == E->c0[node]) {
            node = E->c1[node];
            dir = 0;
        } else {
            if (node == top) return true;
            last = node;
            node = E->up[node];
            dir = 1;
        }
    }
}

static int E_recalculate_parallel(Engine *E) {
    int T = E->exec_threads;
    size_t n = E->up.size();
    const char *env = getenv("MAPLE_PAR_RECALC_MIN");
    size_t min_n = env ? (size_t)atoll(env) : 20000;
    int root = E->root;
    if (T < 2 || n < min_n || E->S->tags_active || E->c0[root] < 0)
        return E_recalculate(E);
    // subtree sizes (post-order over live nodes only)
    std::vector<int32_t> sz(n, 1);
    {
        int node = root, last = -1, dir = 0;
        while (node >= 0) {
            if (dir == 0) {
                if (E->c0[node] >= 0) { node = E->c0[node]; continue; }
                last = node;
                node = E->up[node];
                dir = 1;
            } else if (last == E->c0[node]) {
                node = E->c1[node];
                dir = 0;
            } else {
                sz[node] = 1 + sz[E->c0[node]] + sz[E->c1[node]];
                last = node;
                node = E->up[node];
                dir = 1;
            }
        }
    }
    int64_t target = std::max<int64_t>(256, (int64_t)sz[root] / (T * 8));
    std::vector<char> mask(n, 0);
    std::vector<int32_t> frontier;
    {
        std::vector<int32_t> stack = {root};
        while (!stack.empty()) {
            int v = stack.back();
            stack.pop_back();
            if (v != root && (E->c0[v] < 0 || sz[v] <= target)) {
                mask[v] = 1;
                frontier.push_back(v);
            } else if (E->c0[v] >= 0) {
                stack.push_back(E->c0[v]);
                stack.push_back(E->c1[v]);
            }
        }
        // largest subtrees first: better load balance
        std::sort(frontier.begin(), frontier.end(),
                  [&](int32_t a, int32_t b) { return sz[a] > sz[b]; });
    }
    if (getenv("MAPLE_DEBUG_RECALC"))
        fprintf(stderr, "PAR_RECALC n=%zu frontier=%zu threads=%d\n",
                n, frontier.size(), T);
    std::atomic<bool> bail(false);
    std::atomic<size_t> next(0);
    auto run_workers = [&](void (*fn)(Engine *, int,
                                      const std::vector<char> *,
                                      std::atomic<bool> *)) {
        next.store(0);
        std::vector<std::thread> ws;
        ws.reserve(T);
        for (int t = 0; t < T; t++)
            ws.emplace_back([&, fn] {
                std::unordered_set<int64_t> my_owned;
                Engine::tl_owned = &my_owned;
                SlotCacheScope slot_cache(E->S);
                size_t i;
                while ((i = next.fetch_add(1)) < frontier.size()
                       && !bail.load(std::memory_order_relaxed))
                    fn(E, (int)frontier[i], nullptr, &bail);
                // replaced tree vectors land in the worker's owned set
                // via install(); reclaim them here
                for (int64_t id : my_owned) E->S->v(id).clear();
                {
                    std::lock_guard<std::mutex> g(E->S->slot_mu);
                    for (int64_t id : my_owned) {
                        E->S->dbg_check_free(id);
                        E->S->free_slots.push_back(id);
                    }
                }
                Engine::tl_owned = nullptr;
            });
        for (auto &w : ws) w.join();
    };
    // pass 1: frontier lowers in parallel, then the interior serially
    run_workers([](Engine *e, int f, const std::vector<char> *m,
                   std::atomic<bool> *b) { E_recalc_lowers_nr(e, f, m, b); });
    if (!bail.load()) E_recalc_lowers_nr(E, root, &mask, &bail);
    // pass 2: root vectors + interior uppers serially (top-down deps),
    // then frontier subtrees in parallel
    if (!bail.load()) {
        int rc0 = E->c0[root], rc1 = E->c1[root];
        E->install(&E->upR[root],
                   E_root_vector(E, E_pass_up(E, E->pv[rc1], rc1),
                                 E->dist[rc1], E->is_tip(rc1), root));
        E->install(&E->upL[root],
                   E_root_vector(E, E_pass_up(E, E->pv[rc0], rc0),
                                 E->dist[rc0], E->is_tip(rc0), root));
        if (!mask[rc0]) E_recalc_uppers_nr(E, rc0, &mask, &bail);
        if (!bail.load() && !mask[rc1])
            E_recalc_uppers_nr(E, rc1, &mask, &bail);
    }
    if (!bail.load())
        run_workers([](Engine *e, int f, const std::vector<char> *m,
                       std::atomic<bool> *b) {
            E_recalc_uppers_nr(e, f, m, b);
        });
    if (bail.load()) {
        // a repair condition was hit somewhere: rerun the exact serial
        // pass (which applies repairs in serial order) from scratch
        return E_recalculate(E);
    }
    return 0;
}

// Full-tree log-likelihood: post-order merge LKs + root contribution
// (partials.calculate_tree_likelihood; reference :9721-9779, no-HnZ).
static int E_tree_lk(Engine *E, double *out) {
    int root = E->root;
    double total = 0.0;
    double total_hnz = 0.0;  // accumulated separately (partials.py :893)
    int node = root, last = -1, dir = 0;
    while (node >= 0) {
        if (dir == 0) {
            if (E->c0[node] >= 0) { node = E->c0[node]; continue; }
            last = node;
            node = E->up[node];
            dir = 1;
        } else if (last == E->c0[node]) {
            node = E->c1[node];
            dir = 0;
        } else {
            int cc0 = E->c0[node], cc1 = E->c1[node];
            int64_t v0 = E_pass_up(E, E->pv[cc0], cc0);
            int64_t v1 = E_pass_up(E, E->pv[cc1], cc1);
            Store *s = E->S;
            int64_t id = s->alloc();
            double lk;
            int rc = merge_vectors(*s, s->v(v0), E->dist[cc0],
                                   E->is_tip(cc0), s->v(v1), E->dist[cc1],
                                   E->is_tip(cc1), true, false,
                                   (int)E->minorSeqs[cc0].size(),
                                   (int)E->minorSeqs[cc1].size(),
                                   s->v(id), &lk);
            if (rc != 0) {
                s->free_slot(id);
                E->error = "impossible merge in tree likelihood";
                return -1;
            }
            s->finish(id);
            E->own(id);
            total += lk;
            if (E->hnz_mode && (E->dist[node] > E->eff0
                                || E->up[node] < 0))
                total_hnz += E->hnz(E->nDesc0[node]);
            last = node;
            node = E->up[node];
            dir = 1;
        }
    }
    total += E_find_prob_root(E, E->pv[root], root);
    *out = total + total_hnz;
    return 0;
}

// Parallel twin of E_tree_lk: each internal node's contribution
// merge_lk(pass_up(pv[c0]), pass_up(pv[c1])) is independent, so workers
// pull fixed-size chunks of the post-order internal-node list and the
// per-chunk partial sums reduce in chunk order (deterministic at any
// core count; differs from the serial sum only by fp association, so
// parity-pinned small trees stay on the serial path via the size gate).
static int E_tree_lk_parallel(Engine *E, double *out) {
    int T = E->exec_threads;
    size_t n = E->up.size();
    const char *env = getenv("MAPLE_PAR_TREELK_MIN");
    size_t min_n = env ? (size_t)atoll(env) : 20000;
    int root = E->root;
    if (T < 2 || n < min_n || E->S->tags_active || E->c0[root] < 0)
        return E_tree_lk(E, out);
    std::vector<int32_t> internals;
    internals.reserve(n / 2 + 1);
    {
        int node = root, last = -1, dir = 0;
        while (node >= 0) {
            if (dir == 0) {
                if (E->c0[node] >= 0) { node = E->c0[node]; continue; }
                last = node;
                node = E->up[node];
                dir = 1;
            } else if (last == E->c0[node]) {
                node = E->c1[node];
                dir = 0;
            } else {
                internals.push_back(node);
                if (node == root) break;
                last = node;
                node = E->up[node];
                dir = 1;
            }
        }
    }
    const size_t CHUNK = 256;
    size_t n_chunks = (internals.size() + CHUNK - 1) / CHUNK;
    std::vector<double> chunk_lk(n_chunks, 0.0), chunk_hnz(n_chunks, 0.0);
    std::atomic<size_t> next(0);
    std::atomic<bool> fail(false);
    std::vector<std::thread> ws;
    ws.reserve(T);
    for (int t = 0; t < T; t++)
        ws.emplace_back([&] {
            std::unordered_set<int64_t> my_owned;
            Engine::tl_owned = &my_owned;
            SlotCacheScope slot_cache(E->S);
            Store *s = E->S;
            size_t c;
            while ((c = next.fetch_add(1)) < n_chunks
                   && !fail.load(std::memory_order_relaxed)) {
                double lk_sum = 0.0, hnz_sum = 0.0;
                size_t end = std::min(internals.size(), (c + 1) * CHUNK);
                for (size_t i = c * CHUNK; i < end; i++) {
                    int nd = internals[i];
                    int cc0 = E->c0[nd], cc1 = E->c1[nd];
                    int64_t v0 = E_pass_up(E, E->pv[cc0], cc0);
                    int64_t v1 = E_pass_up(E, E->pv[cc1], cc1);
                    int64_t id = s->alloc();
                    double lk;
                    int rc = merge_vectors(
                        *s, s->v(v0), E->dist[cc0], E->is_tip(cc0),
                        s->v(v1), E->dist[cc1], E->is_tip(cc1), true,
                        false, (int)E->minorSeqs[cc0].size(),
                        (int)E->minorSeqs[cc1].size(), s->v(id), &lk);
                    s->free_slot(id);
                    if (v0 != E->pv[cc0]) E->release(v0);
                    if (v1 != E->pv[cc1]) E->release(v1);
                    if (rc != 0) {
                        fail.store(true);
                        break;
                    }
                    lk_sum += lk;
                    if (E->hnz_mode && (E->dist[nd] > E->eff0
                                        || E->up[nd] < 0))
                        hnz_sum += E->hnz(E->nDesc0[nd]);
                }
                chunk_lk[c] = lk_sum;
                chunk_hnz[c] = hnz_sum;
            }
            for (int64_t id : my_owned) s->v(id).clear();
            {
                std::lock_guard<std::mutex> g(s->slot_mu);
                for (int64_t id : my_owned) {
                    s->dbg_check_free(id);
                    s->free_slots.push_back(id);
                }
            }
            Engine::tl_owned = nullptr;
        });
    for (auto &w : ws) w.join();
    if (fail.load()) {
        E->error = "impossible merge in tree likelihood";
        return -1;
    }
    double total = 0.0, total_hnz = 0.0;
    for (size_t c = 0; c < n_chunks; c++) {
        total += chunk_lk[c];
        total_hnz += chunk_hnz[c];
    }
    total += E_find_prob_root(E, E->pv[root], root);
    *out = total + total_hnz;
    return 0;
}

// findBestRoot crawl (reference :7730-7902; search/rootsearch.py
// find_best_root) — read-only search: walks down from the root scoring a
// re-rooting at every branch with full merge-LK bookkeeping.  Outputs the
// best node, its LK gain, and the candidate list (insertion-ordered, the
// Python best_nodes dict) for the host's remap/abayes/re-root phase.
// Returns 0 ok, 2 = unsupported state (host falls back to Python).
static int E_root_search(Engine *E, bool strict_stop, int allowed_fails,
                         double threshold_log_lk,
                         double threshold_consecutive, double threshold_opt,
                         int32_t *best_node_out, double *best_lk_out,
                         int32_t *cand_nodes, double *cand_scores,
                         int64_t *cand_count) {
    int root = E->root;
    int32_t best_node = root;
    double best_lk_diff = 0.0;
    int64_t n_cand = 0;
    cand_nodes[n_cand] = root;
    cand_scores[n_cand++] = 0.0;
    // crawl telemetry (MAPLE_DEBUG_ROOT_TIMING): visits + entry volume
    bool debug_timing = getenv("MAPLE_DEBUG_ROOT_TIMING") != nullptr;
    int64_t dbg_visits = 0, dbg_entries = 0;
    auto dbg_t0 = std::chrono::steady_clock::now();
    struct Item {
        int t1; int64_t passed; double distance; bool is_tip;
        int num_minor; double lk_to_remove; double last_lk; int failed;
    };
    std::vector<Item> stack;
    // Budgeted mode (engine_set_root_budget): best-first on path score,
    // stop after `budget` consecutive non-improving scored directions —
    // the root-search twin of E_find_best_parent_budget's rule.
    const int64_t budget = E->root_budget;
    auto item_less = [](const Item &a, const Item &b) {
        return a.last_lk < b.last_lk;
    };
    int64_t since_improve = 0;
    if (E->c0[root] >= 0) {
        int child1 = E->c0[root], child2 = E->c1[root];
        int64_t vect_up1 = E_pass_up(E, E->pv[child2], child2);
        int64_t vect_up2 = E_pass_up(E, E->pv[child1], child1);
        double original_lk_cost = E_find_prob_root(E, E->pv[root], root);
        bool is_tip2 = E->is_tip(child2);
        bool is_tip1 = E->is_tip(child1);
        double lk;
        int64_t m = E_merge_lk(E, vect_up1, E->dist[child2], is_tip2,
                               vect_up2, E->dist[child1], is_tip1,
                               (int)E->minorSeqs[child2].size(),
                               (int)E->minorSeqs[child1].size(), &lk);
        if (m < 0) return 2;  // python would raise; fall back
        original_lk_cost += lk;
        if (!E->muts[child1].empty())
            vect_up1 = E_pass_down(E, vect_up1, child1);
        if (E->c0[child1] >= 0)
            stack.push_back({child1, vect_up1,
                             E->dist[child1] + E->dist[child2], is_tip2,
                             (int)E->minorSeqs[child2].size(),
                             original_lk_cost, 0.0, 0});
        if (!E->muts[child2].empty())
            vect_up2 = E_pass_down(E, vect_up2, child2);
        if (E->c0[child2] >= 0)
            stack.push_back({child2, vect_up2,
                             E->dist[child2] + E->dist[child1], is_tip1,
                             (int)E->minorSeqs[child1].size(),
                             original_lk_cost, 0.0, 0});
    }
    if (budget > 0)
        std::make_heap(stack.begin(), stack.end(), item_less);
    while (!stack.empty()) {
        if (budget > 0 && since_improve > budget) break;
        if (budget > 0)
            std::pop_heap(stack.begin(), stack.end(), item_less);
        Item it = stack.back();
        stack.pop_back();
        if (debug_timing) {
            dbg_visits++;
            dbg_entries += (int64_t)E->S->v(it.passed).size();
        }
        int childs[2] = {E->c0[it.t1], E->c1[it.t1]};
        int64_t prob_vects[2];
        double dists[2];
        int num_minors[2];
        bool is_tips[2];
        for (int i = 0; i < 2; i++) {
            prob_vects[i] = E_pass_up(E, E->pv[childs[i]], childs[i]);
            dists[i] = E->dist[childs[i]];
            num_minors[i] = (int)E->minorSeqs[childs[i]].size();
            is_tips[i] = E->is_tip(childs[i]);
        }
        double new_lk_to_remove = it.lk_to_remove;
        double lk;
        int64_t m = E_merge_lk(E, prob_vects[0], dists[0], is_tips[0],
                               prob_vects[1], dists[1], is_tips[1],
                               num_minors[0], num_minors[1], &lk);
        if (m < 0) return 2;  // raises out of find_best_root in python
        E->release(m);
        new_lk_to_remove += lk;
        for (int i = 0; i < 2; i++) {
            bool traverse = false;
            bool ok = true;
            int64_t up_vect = -1;
            double new_lk_to_remove_pass = 0.0, score = 0.0;
            int failed_new = it.failed;
            double lk_pass = 0.0;
            up_vect = E_merge_lk(E, prob_vects[1 - i], dists[1 - i],
                                 is_tips[1 - i], it.passed, it.distance,
                                 it.is_tip, num_minors[1 - i],
                                 it.num_minor, &lk_pass);
            if (up_vect < 0) ok = false;
            if (ok) {
                new_lk_to_remove_pass = new_lk_to_remove - lk_pass;
                double lk_root = 0.0;
                int64_t new_root_vect = E_merge_lk(
                    E, up_vect, dists[i] / 2, false, prob_vects[i],
                    dists[i] / 2, is_tips[i], 0, num_minors[i], &lk_root);
                if (new_root_vect < 0) {
                    ok = false;
                } else {
                    double root_prob_lk =
                        E_find_prob_root(E, new_root_vect, it.t1);
                    E->release(new_root_vect);
                    score = root_prob_lk + lk_root + lk_pass
                            - new_lk_to_remove;
                    since_improve++;
                    if (score > best_lk_diff) {
                        E_shorten(E, up_vect);
                        best_lk_diff = score;
                        best_node = childs[i];
                        failed_new = 0;
                        since_improve = 0;
                    } else if (score
                               < (it.last_lk - threshold_consecutive)) {
                        failed_new++;
                    }
                    if (score >= best_lk_diff - threshold_opt) {
                        cand_nodes[n_cand] = childs[i];
                        cand_scores[n_cand++] = score;
                    }
                    if (E->c0[childs[i]] >= 0) {
                        if (strict_stop)
                            traverse = failed_new <= allowed_fails
                                       && score > best_lk_diff
                                                  - threshold_log_lk;
                        else
                            traverse = failed_new <= allowed_fails
                                       || score > best_lk_diff
                                                  - threshold_log_lk;
                    }
                }
            }
            if (!ok) {
                std::printf("Stopping root search at node %d due to "
                            "error\n", it.t1);
                traverse = false;
            }
            if (traverse) {
                int64_t vect_to_pass;
                if (!E->muts[childs[i]].empty()) {
                    vect_to_pass = E_pass_down(E, up_vect, childs[i]);
                    E_shorten(E, vect_to_pass);
                    E->release(up_vect);
                } else {
                    vect_to_pass = up_vect;
                }
                stack.push_back({childs[i], vect_to_pass, dists[i], false,
                                 0, new_lk_to_remove_pass, score,
                                 failed_new});
                if (budget > 0)
                    std::push_heap(stack.begin(), stack.end(), item_less);
            } else {
                E->release(up_vect);
            }
        }
        E->release(prob_vects[0]);
        E->release(prob_vects[1]);
        E->release(it.passed);
    }
    // budget stop: release the undrained frontier's carried vectors
    for (const Item &rem : stack) E->release(rem.passed);
    if (debug_timing) {
        double ms = std::chrono::duration<double, std::milli>(
            std::chrono::steady_clock::now() - dbg_t0).count();
        std::printf("[root timing] visits=%lld entries/visit=%.1f "
                    "wall=%.1fms us/visit=%.2f\n", (long long)dbg_visits,
                    dbg_visits ? (double)dbg_entries / dbg_visits : 0.0,
                    ms, dbg_visits ? ms * 1e3 / dbg_visits : 0.0);
        std::fflush(stdout);
    }
    *best_node_out = best_node;
    *best_lk_out = best_lk_diff;
    *cand_count = n_cand;
    return 0;
}

// Branch-length sweep (search/blen.optimize_branch_lengths; reference
// traverseTreeToOptimizeBranchLengths :8727-8889, no-HnZ/no-time path):
// grid search over half-mutation steps for the root's two branches,
// then a dirty-gated pre-order sweep with the derivative kernel.
static int E_blen_sweep(Engine *E, bool fast_pass, int64_t *updates_out) {
    int root = E->root;
    std::vector<double> &dist = E->dist;
    int64_t updates = 0;
    if (E->c0[root] < 0) { *updates_out = 0; return 0; }
    int child1 = E->c0[root], child2 = E->c1[root];
    int lRef = E->S->lRef;
    if (dist[child1] > E->eff0 || dist[child2] > E->eff0) {
        double tot_dist = (dist[child1] + dist[child2]) * lRef;
        bool tip1 = E->is_tip(child1), tip2 = E->is_tip(child2);
        int64_t v1 = E_pass_up(E, E->pv[child1], child1);
        int64_t v2 = E_pass_up(E, E->pv[child2], child2);
        double best_cost = -std::numeric_limits<double>::infinity();
        double best_bl1 = 0.0;
        long n_steps = (long)std::nearbyint(tot_dist);  // python round()
        if (n_steps < 1) n_steps = 1;
        for (long i = 0; i < n_steps * 2 + 1; i++) {
            double bl1 = std::min(tot_dist, (double)i / 2);
            double bl2 = std::max(tot_dist - bl1, 0.0);
            bl1 /= lRef;
            bl2 /= lRef;
            Store *s = E->S;
            int64_t id = s->alloc();
            double cost;
            int rc = merge_vectors(*s, s->v(v1), bl1, tip1, s->v(v2), bl2,
                                   tip2, true, false, 0, 0, s->v(id),
                                   &cost);
            if (rc != 0) {
                s->free_slot(id);
                E->error = "impossible merge in root grid search";
                return -1;
            }
            s->finish(id);
            E->own(id);
            cost += E_find_prob_root(E, id, root);
            E->release(id);
            if (E->hnz_mode) {
                // blen.py :66-72
                if (bl1 < E->eff0)
                    cost += E->hnz(E->nDesc0[child1] + 1)
                            - E->hnz(E->nDesc0[child1]);
                if (bl2 < E->eff0)
                    cost += E->hnz(E->nDesc0[child2] + 1)
                            - E->hnz(E->nDesc0[child2]);
            }
            if (cost > best_cost) {
                best_cost = cost;
                best_bl1 = bl1;
            }
        }
        E->release(v1);
        E->release(v2);
        double best_bl2 = std::max(dist[child1] + dist[child2] - best_bl1,
                                   0.0);
        if (E->hnz_mode) E->nd0_changing_dist(child1, best_bl1);
        dist[child1] = best_bl1;
        if (!fast_pass) {
            std::vector<WorkItem> wl;
            wl.push_back({(int32_t)child1, 2, 1});
            wl.push_back({(int32_t)root, 0, 1});
            if (!E_update_partials(E, std::move(wl))) return -1;
        }
        if (E->hnz_mode) E->nd0_changing_dist(child2, best_bl2);
        dist[child2] = best_bl2;
        if (!fast_pass) {
            std::vector<WorkItem> wl;
            wl.push_back({(int32_t)child2, 2, 1});
            wl.push_back({(int32_t)root, 0, 1});
            if (!E_update_partials(E, std::move(wl))) return -1;
        }
    }
    std::vector<int32_t> nodes;
    if (E->c0[E->c0[root]] >= 0) {
        nodes.push_back(E->c0[E->c0[root]]);
        nodes.push_back(E->c1[E->c0[root]]);
    }
    if (E->c0[E->c1[root]] >= 0) {
        nodes.push_back(E->c0[E->c1[root]]);
        nodes.push_back(E->c1[E->c1[root]]);
    }
    while (!nodes.empty()) {
        int node = nodes.back();
        nodes.pop_back();
        if (E->dirty[node]) {
            int child = E->child_index(node);
            int64_t up_vect = child == 0 ? E->upR[E->up[node]]
                                         : E->upL[E->up[node]];
            up_vect = E_pass_down(E, up_vect, node);
            bool is_tip = E->is_tip(node);
            double best = E_blen(E, up_vect, E->pv[node], is_tip);
            if (best != 0.0 || dist[node] != 0.0) {
                if (E->hnz_mode) {
                    // blen.py :106-146 — HnZ cost comparison incl. the
                    // 0-length alternative and the keep-current guard
                    auto &nd = E->nDesc0;
                    double current_cost = E_append(E, up_vect,
                                                   E->pv[node], is_tip,
                                                   dist[node]);
                    double new_cost = E_append(E, up_vect, E->pv[node],
                                               is_tip, best);
                    int p0 = E->up[node];
                    while (dist[p0] <= E->eff0 && E->up[p0] >= 0)
                        p0 = E->up[p0];
                    if (dist[node] > E->eff0) {
                        current_cost += E->hnz(nd[p0]) + E->hnz(nd[node]);
                        if (best > E->eff0)
                            new_cost += E->hnz(nd[p0])
                                        + E->hnz(nd[node]);
                        else
                            new_cost += E->hnz(nd[p0] + nd[node] - 1);
                    } else {
                        current_cost += E->hnz(nd[p0]);
                        if (best > E->eff0)
                            new_cost += E->hnz(nd[p0] + 1 - nd[node])
                                        + E->hnz(nd[node]);
                        else
                            new_cost += E->hnz(nd[p0]);
                    }
                    if (dist[node] > E->eff0 && best > E->eff0) {
                        double cost0 = E_append(E, up_vect, E->pv[node],
                                                is_tip, 0.0);
                        if (cost0 > -1000000) {
                            cost0 += E->hnz(nd[p0] + nd[node] - 1);
                            if (cost0 > new_cost) {
                                best = 0.0;
                                new_cost = cost0;
                            }
                        }
                    }
                    if (current_cost > new_cost)
                        best = dist[node];
                }
                if (best != 0.0 || dist[node] != 0.0) {
                    if (best == 0.0 || dist[node] == 0.0
                            || dist[node] / best > 1.01
                            || dist[node] / best < 0.99) {
                        if (E->hnz_mode) E->nd0_changing_dist(node, best);
                        dist[node] = best;
                        updates++;
                        if (!fast_pass) {
                            std::vector<WorkItem> wl;
                            wl.push_back({(int32_t)node, 2, 1});
                            wl.push_back({(int32_t)E->up[node],
                                          (int32_t)child, 1});
                            if (!E_update_partials(E, std::move(wl)))
                                return -1;
                        }
                    } else {
                        E->dirty[node] = 0;
                    }
                } else {
                    E->dirty[node] = 0;
                }
            } else {
                E->dirty[node] = 0;
            }
            E->release(up_vect);
        }
        if (E->c0[node] >= 0) {
            nodes.push_back(E->c0[node]);
            nodes.push_back(E->c1[node]);
        }
    }
    *updates_out = updates;
    return 0;
}

// ----------------------------------------------------------------------
// Proxy-screen feature extraction (device MXU screen,
// maple_tpu/parallel/proxy_placer.py).
//
// One genome list -> sparse features over a D = d_hash + g_buckets
// dimensional space:
//   bucket 0                  bias (anchor: -|muts|; query: 1)
//   [1, d_hash)               hashed (position, nucleotide) of non-
//                             reference entries
//   [d_hash, d_hash+g_b)      genome-interval channel: anchor -> mut
//                             count per interval; query -> fraction of
//                             the interval under its N runs
// Anchor (af) and query (qf) weights are complementary so that
//   qf . af  =  2*|shared muts| - |anchor muts|
//               + sum_g frac_N(q, g) * muts(a, g)
//            ~  |shared| - |anchor-only muts the query observes|,
// a monotone proxy (up to hash collisions) for the exact relative
// appendProbNode placement score (reference :6505-6785): every anchor
// mutation the query lacks (and observes) costs ~log(t*rate*m) exactly
// once, shared mutations cost ~nothing, and query-only mutations are a
// per-query constant that cancels in the argmax.  Recall-only: the
// seeded crawl + batch apply re-validate with exact kernels.
static long feat_extract(const Store &S, const Vec &v, bool query_side,
                         int32_t d_hash, int32_t g_buckets, int32_t fmax,
                         int32_t *idx, float *w) {
    const int lref = S.lRef;
    long nf = 0;
    auto emit = [&](int32_t i, float ww) {
        if (nf < fmax) { idx[nf] = i; w[nf] = ww; nf++; }
    };
    // bias first so the fmax cap can never drop it (anchor weight is
    // patched once the miss-penalty mass is known)
    emit(0, query_side ? 1.0f : 0.0f);
    float miss_mass = 0.0f;
    std::vector<float> cover;
    if (query_side) cover.assign(g_buckets, 0.0f);
    // One supported non-reference nucleotide.  `match` scales the hash
    // feature (how strongly matching this mutation helps); `miss`
    // scales the anchor-side bias/coverage penalty (what a query that
    // observes the position but lacks the mutation pays).  Mid-branch
    // anchor vectors carry clade mutations as O entries with mass split
    // between the mutation and the reference (subtree vs rest-of-tree)
    // — measured ~50/50 and almost never as concrete nucleotides — and
    // against such an entry the exact appendProbNode penalty for a
    // non-matching query is ~log(0.5), an order of magnitude milder
    // than against a concrete mutation (~log(t*rate*m)), hence the
    // smaller miss weight for partial support.
    auto mut_feat = [&](int p, int nuc, float match, float miss) {
        uint32_t hsh = (uint32_t)(p * 4 + nuc) * 2654435761u;
        emit(1 + (int32_t)(hsh % (uint32_t)(d_hash - 1)),
             (query_side ? 2.0f : 1.0f) * match);
        if (!query_side && miss > 0.0f) {
            emit(d_hash + (int32_t)((int64_t)(p - 1) * g_buckets / lref),
                 miss);
            miss_mass += miss;
        }
    };
    int pos = 0;
    for (const Entry &e : v) {
        if (e.type < 4) {
            // concrete entry: the TYPE is the nucleotide (e.val is the
            // frame's reference nucleotide, == global ref here)
            int p = ++pos;
            if (e.type != S.ref_indices[p - 1])
                mut_feat(p, e.type, 1.0f, 1.0f);
        } else if (e.type == TYPE_R) {
            pos = e.val;
        } else if (e.type == TYPE_N) {
            if (query_side) {
                // fractional coverage of the interval buckets under
                // this N run: positions [pos+1, e.val]
                int p0 = pos + 1, p1 = e.val;
                int g0 = (int)((int64_t)(p0 - 1) * g_buckets / lref);
                int g1 = (int)((int64_t)(p1 - 1) * g_buckets / lref);
                for (int g = g0; g <= g1 && g < g_buckets; g++) {
                    long bs = (long)g * lref / g_buckets + 1;
                    long be = (long)(g + 1) * lref / g_buckets;
                    long ov = std::min<long>(p1, be)
                              - std::max<long>(p0, bs) + 1;
                    if (ov > 0 && be > bs)
                        cover[g] += (float)ov / (float)(be - bs + 1);
                }
            }
            pos = e.val;
        } else {  // TYPE_O: every supported non-reference nucleotide is
                  // a (partial) mutation feature
            int p = ++pos;
            int ref = S.ref_indices[p - 1];
            for (int k2 = 0; k2 < 4; k2++) {
                float pk = (float)e.pp->p[k2];
                if (k2 == ref || pk <= 0.03f) continue;
                float match = std::min(1.0f, 2.0f * pk);
                mut_feat(p, k2, match, 0.15f * match);
            }
        }
    }
    if (query_side) {
        for (int g = 0; g < g_buckets; g++)
            if (cover[g] > 0.0f) emit(d_hash + g, cover[g]);
    } else {
        w[0] = -miss_mass;
    }
    // zero-pad so the host can upload rows without masking (bucket 0
    // with weight 0 is a no-op)
    for (long k2 = nf; k2 < fmax; k2++) { idx[k2] = 0; w[k2] = 0.0f; }
    return nf;
}

}  // namespace

extern "C" {

Engine *engine_create(Store *s, int64_t root_vec, int32_t root_name,
                      int strict_stop, int allowed_fails,
                      double threshold_log_lk, double threshold_opt,
                      double threshold_consec, double one_mut, double eff0,
                      int only_identical, int use_refs,
                      int max_ndesc_clade, int min_num_non4) {
    Engine *E = new Engine();
    E->S = s;
    E->strict_stop = strict_stop != 0;
    E->allowed_fails = allowed_fails;
    E->threshold_log_lk = threshold_log_lk;
    E->threshold_opt = threshold_opt;
    E->threshold_consec = threshold_consec;
    E->one_mut = one_mut;
    E->eff0 = eff0;
    E->only_identical = only_identical != 0;
    E->use_refs = use_refs != 0;
    E->max_ndesc_clade = max_ndesc_clade;
    E->min_num_non4 = min_num_non4;
    E->add_node();
    E->name[0] = root_name;
    E->pv[0] = root_vec;
    E->root = 0;
    return E;
}

void engine_free(Engine *E) { delete E; }

// Enable the HnZ topology modifiers (reference --HnZ 1|2, :305-328).
// Call right after engine_create / engine_import; nDesc0 starts at 1 per
// node (the add_node default) for de-novo runs, or is loaded via
// engine_import_ndesc0 for imported trees.
void engine_set_hnz(Engine *E, int mode) {
    E->hnz_mode = mode;
    E->hnz_vec.clear();
}

// Enable the best-first placement search (see E_find_best_parent_budget):
// budget = consecutive non-improving scored nodes before the search
// stops (0 restores the exact reference DFS).
void engine_set_search_budget(Engine *E, int64_t budget) {
    E->search_budget = budget;
}

// Bound the root-position crawl (see Engine::root_budget).
void engine_set_root_budget(Engine *E, int64_t budget) {
    E->root_budget = budget;
}

// Phase-parallel width for full-tree recomputes (E_recalculate_parallel);
// the host passes --numCores.  Byte-identical results at any width.
void engine_set_threads(Engine *E, int n) {
    E->exec_threads = n > 0 ? n : 1;
}

// Bound the per-node SPR re-attachment crawl (see Engine::spr_budget).
void engine_set_spr_budget(Engine *E, int64_t budget) {
    E->spr_budget = budget;
}

void engine_import_ndesc0(Engine *E, const int32_t *nd) {
    for (size_t i = 0; i < E->nDesc0.size(); i++) E->nDesc0[i] = nd[i];
}

void engine_export_ndesc0(Engine *E, int32_t *nd) {
    for (size_t i = 0; i < E->nDesc0.size(); i++) nd[i] = E->nDesc0[i];
}

// Place one sample (diffs = global-frame terminal vector id; the engine
// takes ownership).  Returns 1 if absorbed as a minor sequence, 0 if
// placed, -1 on error (see engine_error).
int engine_place(Engine *E, int64_t diffs, int32_t sample) {
    E->own(diffs);
    bool dbg_pl = getenv("MAPLE_DEBUG_PLACE") != nullptr;
    PROF_T(pt0);
    FindResult R = E->search_budget > 0
        ? E_find_best_parent_budget(E, diffs, sample)
        : E_find_best_parent(E, diffs, sample);
    PROF_ADD(E->p_find_cy, pt0);
    if (!E->error.empty()) { E->end_call(); return -1; }
    if (dbg_pl)
        std::fprintf(stderr, "PLACE %d node=%d abs=%d sc=%.6f t=%.3g "
                     "b=%.3g a=%.3g\n", sample, R.best_node, R.absorbed,
                     R.best_score, R.top, R.bottom, R.appending);
    if (R.absorbed) { E->end_call(); return 1; }
    PROF_T(pt1);
    int new_root = E_place_sample(E, R.best_node, R.best_diffs, sample,
                                  R.best_score, R.top, R.bottom,
                                  R.appending);
    PROF_ADD(E->p_place_cy, pt1);
    if (new_root == -2 || !E->error.empty()) { E->end_call(); return -1; }
    if (new_root >= 0) E->root = new_root;
    E->end_call();
#ifdef MAPLE_PROFILE
    E->place_seq++;
#endif
    return 0;
}

// Owned deep copy of a store vector (engine_place_batch: batch
// terminals are placed as copies so the originals stay alive — and
// frame-stable — for within-batch minor checks; an installed original
// could be replaced and freed by a MAT re-reference mid-batch, leaving
// later checks reading a recycled slot).
static int64_t E_copy_vec(Engine *E, int64_t id) {
    Store *s = E->S;
    int64_t nid = s->alloc();
    s->v(nid) = s->v(id);
    s->finish(nid);
    E->own(nid);
    return nid;
}

// Batched stepwise addition: search-parallel / apply-serial placement —
// the placement twin of engine_spr_pass_parallel.  The host hands a
// batch of terminal vectors (global reference frame, store ids it does
// NOT free) plus sample numbers; worker threads run the best-first
// budgeted search (engine_set_search_budget must be > 0) read-only
// against the batch-start tree, then placements apply serially in host
// order with apply-time re-derivation of everything frame- or
// vector-dependent (the local-frame diffs, the merge products, blen
// re-optimization inputs) so only the *choice* of node and the proposal
// blens can be stale.  NOT byte-parity with the serial loop: near-tied
// choices can differ; quality is contract-tested (LK tolerance) like
// --placementBudget itself.  Within-batch identical samples still
// absorb: each applied proposal records its new leaf, and later
// proposals anchored at the same node minor-check against those leaves
// first (frame-invariant: both sides compared in the global frame).
// Returns 0 ok, 2 unsupported (host falls back to the serial loop),
// -1 error (engine_error has the message).
// Proposal record shared by the batched placement entry points
// (engine_place_batch / engine_place_batch_seeded): phase A fills one
// per sample from a read-only search, E_apply_batch re-validates and
// applies them serially in host order.
struct PlaceProp {
    int32_t absorb_leaf = -1;
    int32_t best_node = -1;
    double score = 0, top = 0, bottom = 0, appending = 0;
    // fine-candidate set from the worker crawl (node, crawl score),
    // best first; the serial apply re-runs the fine phase over it
    // unless the speculative worker fine result below survives the
    // freshness gate
    std::vector<std::pair<int32_t, double>> cands;
    std::vector<int32_t> visited;  // crawl-discovered nodes
    uint8_t searched = 0;  // 0 = worker failed; re-search serially
    uint8_t fine_ok = 0;
    int32_t fine_node = -1;
    double fine_score = 0, fine_top = 0, fine_bottom = 0, fine_app = 0;
    int64_t fine_diffs = -1;  // unowned store copy, batch-guard freed
};
static int E_apply_batch(Engine *E, std::vector<PlaceProp> &props,
                         const int64_t *vids, const int32_t *samples,
                         int64_t n, size_t batch_start,
                         std::chrono::steady_clock::time_point t_a0);

int engine_place_batch(Engine *E, int num_cores, int64_t n,
                       const int64_t *vids, const int32_t *samples) {
    if (E->search_budget <= 0 || num_cores < 1 || E->S->tags_active)
        return 2;  // exact-DFS parity and alias-tag registration are
                   // order-dependent; the serial loop handles those
    if (E->hnz_mode) {
        // pre-grow the HnZ memo (lazy grow is not thread-safe)
        int max_nd = 2;
        for (int32_t v : E->nDesc0) max_nd = std::max(max_nd, (int)v);
        E->hnz(2 * max_nd + 4);
    }
    std::vector<PlaceProp> props(n);
    const size_t batch_start = E->up.size();  // snapshot/new boundary
    if (getenv("MAPLE_DEBUG_TREEHASH")) {
        uint64_t h = 1469598103934665603ull;
        auto mix = [&](uint64_t x) { h ^= x; h *= 1099511628211ull; };
        for (size_t x = 0; x < E->up.size(); x++) {
            mix((uint64_t)E->up[x]);
            mix((uint64_t)E->c0[x]);
            uint64_t db;
            std::memcpy(&db, &E->dist[x], 8);
            mix(db);
            for (int64_t *arr : {&E->pv[x], &E->upR[x], &E->upL[x],
                                 &E->totUp[x]}) {
                if (*arr < 0) { mix(0xdead); continue; }
                const Vec &vv = E->S->v(*arr);
                mix((uint64_t)vv.size());
                for (const Entry &e : vv) {
                    mix((uint64_t)e.type);
                    mix((uint64_t)e.val);
                    uint64_t pb = 0;
                    if (e.pp) std::memcpy(&pb, &e.pp->p[0], 8);
                    mix(pb);
                    std::memcpy(&pb, &e.bl1, 8);
                    mix(pb);
                }
            }
        }
        std::fprintf(stderr, "TREEHASH n=%zu first=%d hash=%016llx\n",
                     E->up.size(), samples[0], (unsigned long long)h);
    }
    auto t_a0 = std::chrono::steady_clock::now();
    // phase A: read-only proposal search
    std::atomic<int64_t> next{0};
    int64_t dfs = 0, missed = 0, fine = 0;
    std::mutex agg_mu;
    auto worker = [&]() {
        std::unordered_set<int64_t> my_owned;
        Engine::tl_owned = &my_owned;
        SlotCacheScope slot_cache(E->S);
        BatchCtx ctx;
        tl_batch = &ctx;
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n) break;
            ctx.absorb_leaf = -1;
            ctx.error.clear();
            ctx.visited.clear();
            ctx.fine_ok = 0;
            ctx.fine_diffs = -1;
            FindResult R = E_find_best_parent_budget(E, vids[i],
                                                     samples[i]);
            PlaceProp &p = props[i];
            if (ctx.error.empty()) {
                if (R.absorbed) {
                    p.absorb_leaf = ctx.absorb_leaf;
                } else {
                    p.best_node = R.best_node;
                    p.score = R.best_score;
                    p.top = R.top;
                    p.bottom = R.bottom;
                    p.appending = R.appending;
                    p.fine_ok = ctx.fine_ok;
                    p.fine_node = ctx.fine_node;
                    p.fine_score = ctx.fine_score;
                    p.fine_top = ctx.fine_top;
                    p.fine_bottom = ctx.fine_bottom;
                    p.fine_app = ctx.fine_app;
                    p.fine_diffs = ctx.fine_diffs;
                    ctx.fine_diffs = -1;
                    p.cands = std::move(ctx.cands);
                    std::sort(ctx.visited.begin(), ctx.visited.end());
                    ctx.visited.erase(std::unique(ctx.visited.begin(),
                                                  ctx.visited.end()),
                                      ctx.visited.end());
                    p.visited = std::move(ctx.visited);
                }
                p.searched = 1;
            }
            E->end_call();
        }
        {
            std::lock_guard<std::mutex> g(agg_mu);
            dfs += ctx.dfs_visits;
            missed += ctx.missed_minors;
            fine += ctx.fine_evals;
        }
        tl_batch = nullptr;
        Engine::tl_owned = nullptr;
    };
    {
        int T = std::min<int64_t>(num_cores, n);
        if (const char *fc = getenv("MAPLE_BATCH_FORCE_CORES"))
            T = std::max(1, atoi(fc));  // debug: isolate thread effects
        E->exec_pool.run(T, [&](int) { worker(); });
    }
    E->dfs_visits += dfs;
    E->total_missed_minors += missed;
    E->fine_evals += fine;
    if (getenv("MAPLE_DEBUG_PROPS2"))
        for (int64_t i = 0; i < n; i++) {
            std::fprintf(stderr, "PROP2 %d abs=%d bn=%d sc=%.9f nc=%zu [",
                         samples[i], props[i].absorb_leaf,
                         props[i].best_node, props[i].score,
                         props[i].cands.size());
            for (auto &pc : props[i].cands)
                std::fprintf(stderr, "%d:%.6f ", pc.first, pc.second);
            std::fprintf(stderr, "]\n");
        }
    return E_apply_batch(E, props, vids, samples, n, batch_start, t_a0);
}

// Phase B of the batched placement entry points: serial re-validated
// apply in host order, with re-search fallbacks for every staleness
// class (within-batch minors, structurally invalidated candidates,
// fresh-branch regions the snapshot search could have reached).
static int E_apply_batch(Engine *E, std::vector<PlaceProp> &props,
                         const int64_t *vids, const int32_t *samples,
                         int64_t n, size_t batch_start,
                         std::chrono::steady_clock::time_point t_a0) {
    static int64_t dbg_n = 0, dbg_coll = 0, dbg_absorb = 0, dbg_inval = 0;
    static double dbg_a_ms = 0, dbg_b_ms = 0;
    // phase-B section breakdown (MAPLE_DEBUG_BATCH): minor checks,
    // candidate frame translations, fine phase, region checks, place +
    // propagate, serial re-searches
    static double dbg_minor_ms = 0, dbg_diffs_ms = 0, dbg_fine_ms = 0,
                  dbg_region_ms = 0, dbg_place_ms = 0, dbg_res_ms = 0;
    bool dbg = getenv("MAPLE_DEBUG_BATCH") != nullptr;
    struct SecT {
        double *acc; bool on;
        std::chrono::steady_clock::time_point t0;
        SecT(double *a, bool dbg_on) : acc(a), on(dbg_on) {
            if (on) t0 = std::chrono::steady_clock::now();
        }
        ~SecT() {
            if (on) *acc += std::chrono::duration<double, std::milli>(
                std::chrono::steady_clock::now() - t0).count();
        }
    };
    auto t_b0 = std::chrono::steady_clock::now();
    // arm the touch stamps for the speculative-fine freshness gate
    // (RAII: early error returns must not leave stamping enabled)
    E->touch_stamp.assign(E->up.size(), 0);
    struct TouchGuard {
        Engine *e;
        ~TouchGuard() { e->touch_on = false; }
    } touch_guard{E};
    E->touch_on = true;
    // every unconsumed speculative winner-diffs copy is reclaimed on
    // ANY exit (error returns included)
    struct FineDiffsGuard {
        Engine *e;
        std::vector<PlaceProp> *props;
        ~FineDiffsGuard() {
            for (PlaceProp &p : *props)
                if (p.fine_diffs >= 0) e->S->free_slot(p.fine_diffs);
        }
    } fine_diffs_guard{E, &props};
    struct Applied { int32_t anchor; int32_t leaf; int64_t vid; };
    std::vector<Applied> leaves;        // for within-batch minor checks
    // Nodes where an earlier apply actually INSERTED a sample this
    // batch.  Proposals choosing one of these re-search serially: the
    // serial loop would have considered attaching inside the fresh
    // branch (nodes that do not exist in the snapshot candidate set),
    // and blindly stacking at the old anchor builds a star instead of a
    // chain (measured ~500 LK worse on b1429 without this rule).
    // Plain vector-refresh dirtiness does NOT disqualify a candidate:
    // the apply-side fine phase re-evaluates against current vectors,
    // so only its filter score is stale.
    std::unordered_set<int32_t> insert_anchors;
    // nodes created by this batch's applies: the one part of the tree no
    // snapshot search could see.  Before committing a proposal, its
    // fresh score is compared against a mid-branch append at each of
    // these; any win means the serial loop would have placed into a
    // batch-mate's new branch, so the sample re-searches serially.
    std::vector<int32_t> new_regions;
    auto harvest_new = [&](size_t nb) {
        for (size_t x = nb; x < E->up.size(); x++) {
            new_regions.push_back((int32_t)x);
            if (E->c0[x] >= 0) insert_anchors.insert(E->c0[x]);
        }
    };
    // serial re-search fallback: places against the current tree AND
    // records what it created
    auto serial_place = [&](int64_t vid2, int32_t sample2) -> int {
        SecT st(&dbg_res_ms, dbg);
        size_t nb = E->up.size();
        int rc = engine_place(E, E_copy_vec(E, vid2), sample2);
        harvest_new(nb);
        return rc;
    };
    for (int64_t i = 0; i < n; i++) {
        PlaceProp &p = props[i];
        int64_t vid = vids[i];
        if (!p.searched) {
            // rare (worker fine-phase error): exact serial semantics
            if (serial_place(vid, samples[i]) < 0) return -1;
            continue;
        }
        if (p.absorb_leaf >= 0) {
            E_absorb_commit(E, p.absorb_leaf, samples[i]);
            continue;
        }
        // Within-batch identicals: if any batch-mate leaf at one of this
        // proposal's candidate anchors is minor-compatible (global-frame
        // check — frame translation preserves entry containment), the
        // serial loop MIGHT have absorbed this sample when its crawl
        // reached that leaf.  Whether it actually would depends on the
        // crawl's stop rules (N-heavy samples are minor-compatible with
        // many leaves they would never crawl to), so don't absorb
        // directly — re-search serially against the current tree, which
        // reproduces the exact crawl-absorption semantics.
        bool maybe_minor = false;
        SecT *sec_minor = dbg ? new SecT(&dbg_minor_ms, true) : nullptr;
        auto proposal_covers = [&](int32_t a) {
            if (a == p.best_node) return true;
            for (const auto &pc : p.cands) if (pc.first == a) return true;
            return false;
        };
        for (const Applied &bl : leaves) {
            if (!proposal_covers(bl.anchor)) continue;
            if (is_minor_sequence(*E->S, E->S->v(bl.vid), E->S->v(vid),
                                  E->only_identical) == 1) {
                maybe_minor = true;
                break;
            }
        }
        delete sec_minor;
        if (maybe_minor) {
            dbg_absorb++;
            if (serial_place(vid, samples[i]) < 0) return -1;
            continue;
        }
        // Fresh fine phase over the worker's candidate set (the worker
        // deferred it), dropping candidates an earlier apply's partials
        // refresh touched — their crawl scores were computed on dead
        // information.  If the TOP candidate is stale, the whole ranking
        // is suspect (serial stepwise addition would have chained into
        // the just-created branch there): full serial re-search against
        // the current tree (which also sees batch-mate leaves, so
        // identicals still absorb).
        std::vector<BestCand> cands;
        // Root-anchored or candidate-less proposals re-search serially:
        // the new-root path derives blens from the proposal score, and a
        // snapshot score against the CURRENT root vector can force a
        // zero-length merge of contradictory vectors.  These are rare
        // (a handful per batch at most).
        if (p.cands.empty() || E->up[p.best_node] < 0) {
            dbg_inval++;
            if (serial_place(vid, samples[i]) < 0) return -1;
            continue;
        }
        bool stale_top =
            insert_anchors.count(p.best_node)
            || E->dist[p.best_node] <= E->eff0
            || E->totUp[p.best_node] < 0;
        for (size_t c = 0; c < p.cands.size() && !stale_top; c++) {
            int32_t cn = p.cands[c].first;
            if (insert_anchors.count(cn)) { stale_top = true; break; }
            if (E->up[cn] < 0 || E->dist[cn] <= E->eff0
                    || E->totUp[cn] < 0) {
                // structurally invalidated (branch zeroed/removed by an
                // earlier apply): cannot be evaluated
                if (cn == p.best_node) { stale_top = true; break; }
                continue;
            }
            cands.push_back({cn, p.cands[c].second, -1});
        }
        if (stale_top || cands.empty()) {
            dbg_coll++;
            if (serial_place(vid, samples[i]) < 0) return -1;
            continue;
        }
        int best_node = p.best_node;
        double score = p.score, top = p.top, bottom = p.bottom,
               app = p.appending;
        FrameDiffCache fc{vid, {}};
        // Freshness gate for the speculative worker fine result: every
        // surviving candidate AND its parent (the fine phase reads the
        // parent's upper vector) must be untouched since the batch
        // started, the fine winner must still be structurally valid,
        // and no candidate may have been dropped INTO the winner slot.
        // Dropped non-winning candidates cannot change the argmax, so
        // the worker result equals what a live re-run would produce.
        auto stamped = [&](int32_t x) {
            return (size_t)x < E->touch_stamp.size()
                   && E->touch_stamp[x];
        };
        bool fresh = p.fine_ok && !E->hnz_mode
                     && cands.size() == p.cands.size();
        if (fresh) {
            int32_t fn = p.fine_node;
            fresh = fn >= 0 && E->up[fn] >= 0 && !stamped(fn)
                    && !stamped(E->up[fn])
                    && !insert_anchors.count(fn);
            for (size_t c = 0; fresh && c < cands.size(); c++) {
                int32_t cn = cands[c].node;
                fresh = !stamped(cn) && E->up[cn] >= 0
                        && !stamped(E->up[cn]);
            }
        }
        bool fine_ok;
        int64_t d = -1;
        if (fresh) {
            best_node = p.fine_node;
            score = p.fine_score;
            top = p.fine_top;
            bottom = p.fine_bottom;
            app = p.fine_app;
            SecT st(&dbg_diffs_ms, dbg);
            if (p.fine_diffs >= 0) {
                d = p.fine_diffs;   // worker-translated, frames fresh
                p.fine_diffs = -1;  // consumed (placed into the tree)
            } else {
                d = E_diffs_cached(E, fc, best_node);
            }
            fine_ok = true;
        } else {
            {
                SecT st(&dbg_diffs_ms, dbg);
                for (BestCand &bc : cands)
                    bc.diffs = E_diffs_cached(E, fc, bc.node);
            }
            // reference decision rule (placement.py :248-322): a fine
            // candidate wins only if its 3-way-optimized score beats
            // the crawl best; otherwise the crawl-best node places with
            // its mid-branch defaults.  p.score (the snapshot crawl
            // best) is the threshold, exactly as in the serial search.
            for (const BestCand &bc : cands)
                if (bc.node == p.best_node) { d = bc.diffs; break; }
            if (d < 0) d = E_diffs_cached(E, fc, p.best_node);
            SecT *sec_fine = dbg ? new SecT(&dbg_fine_ms, true) : nullptr;
            fine_ok = E_fine_phase(E, cands, p.score, best_node, score,
                                   top, bottom, app, d);
            delete sec_fine;
        }
        if (!fine_ok
                || (std::isinf(score) && score < 0)) {
            E->error.clear();
            dbg_inval++;
            E->end_call();
            if (serial_place(vid, samples[i]) < 0) return -1;
            continue;
        }
        // Batch terminals must NOT enter the tree: vids stay alive (and
        // frame-stable) for the whole batch as within-batch minor-check
        // operands, and an installed original could be replaced + freed
        // by a MAT re-reference mid-batch, leaving later checks reading
        // a recycled slot.  Place an owned copy instead.
        if (d == vid) d = E_copy_vec(E, vid);
        // did a batch-mate's insertion open a better region?  (the
        // crawl's mid-branch score there vs this proposal's optimized
        // score — the same comparison the serial crawl's stop/argmax
        // logic would make when it reached the fresh branch)
        bool region_better = false;
        {
            SecT st(&dbg_region_ms, dbg);
            // crawl-admissibility filter: the snapshot crawl could only
            // have reached a node inserted this batch if it visited a
            // snapshot endpoint of the split edge (descending, a new
            // mid-branch node is pushed exactly when the old child
            // would have been; ascending, the new node lies on the
            // traversed edge).  Regions whose whole new-node component
            // borders no crawl-visited snapshot node are unreachable
            // for this proposal's serial crawl and are skipped.
            auto vis_has = [&](int32_t x) {
                return std::binary_search(p.visited.begin(),
                                          p.visited.end(), x);
            };
            std::vector<int32_t> comp_stack;
            std::unordered_set<int32_t> comp;
            auto region_seen = [&](int32_t r0) {
                comp_stack.assign(1, r0);
                comp.clear();
                while (!comp_stack.empty()) {
                    int32_t x = comp_stack.back();
                    comp_stack.pop_back();
                    if ((size_t)x < batch_start) {
                        if (vis_has(x)) return true;
                        continue;  // snapshot node: boundary, don't cross
                    }
                    if (!comp.insert(x).second) continue;
                    if (E->up[x] >= 0) comp_stack.push_back(E->up[x]);
                    if (E->c0[x] >= 0) {
                        comp_stack.push_back(E->child(x, 0));
                        comp_stack.push_back(E->child(x, 1));
                    }
                }
                return false;
            };
            for (int32_t r : new_regions) {
                if (E->dist[r] <= E->eff0 || E->totUp[r] < 0
                        || E->up[r] < 0)
                    continue;
                if (!region_seen(r)) continue;
                int64_t dr = E_diffs_cached(E, fc, r);
                double s = E_append(E, E->totUp[r], dr, true, E->one_mut);
                if (E->hnz_mode) s += E->hnz(2) - E->hnz(1);
                if (s > score) { region_better = true; break; }
            }
        }
        if (region_better) {
            dbg_inval++;
            E->end_call();
            if (serial_place(vid, samples[i]) < 0) return -1;
            continue;
        }
        if (getenv("MAPLE_DEBUG_PLACE"))
            std::fprintf(stderr, "BPLACE %d node=%d sc=%.6f t=%.3g "
                         "b=%.3g a=%.3g ncand=%zu\n", samples[i],
                         best_node, score, top, bottom, app,
                         cands.size());
        size_t n_before = E->up.size();
        SecT *sec_place = dbg ? new SecT(&dbg_place_ms, true) : nullptr;
        int new_root = E_place_sample(E, best_node, d, samples[i],
                                      score, top, bottom, app);
        delete sec_place;
        if (new_root == -2 || !E->error.empty()) {
            E->end_call();
            return -1;
        }
        if (new_root >= 0) E->root = new_root;
        E->end_call();
        int32_t leaf = -1;
        for (size_t x = n_before; x < E->up.size(); x++)
            if (E->name[x] == samples[i]) { leaf = (int32_t)x; break; }
        if (getenv("MAPLE_DEBUG_PLACE"))
            std::fprintf(stderr, "BIDS sample=%d vid=%lld d=%lld leaf=%d "
                         "pvleaf=%lld\n", samples[i], (long long)vid,
                         (long long)d, leaf,
                         leaf >= 0 ? (long long)E->pv[leaf] : -1);
        if (leaf >= 0) leaves.push_back({best_node, leaf, vid});
        harvest_new(n_before);
        insert_anchors.insert(best_node);
#ifdef MAPLE_PROFILE
        E->place_seq++;
#endif
    }
    if (dbg) {
        auto t_end = std::chrono::steady_clock::now();
        dbg_n += n;
        dbg_a_ms += std::chrono::duration<double, std::milli>(
            t_b0 - t_a0).count();
        dbg_b_ms += std::chrono::duration<double, std::milli>(
            t_end - t_b0).count();
        if (dbg_n % 2000 < n)
            std::fprintf(stderr, "[batch] n=%lld coll=%lld absorb=%lld "
                         "inval=%lld searchA=%.0fms apply=%.0fms "
                         "(minor=%.0f diffs=%.0f fine=%.0f region=%.0f "
                         "place=%.0f research=%.0f)\n",
                         (long long)dbg_n, (long long)dbg_coll,
                         (long long)dbg_absorb, (long long)dbg_inval,
                         dbg_a_ms, dbg_b_ms, dbg_minor_ms, dbg_diffs_ms,
                         dbg_fine_ms, dbg_region_ms, dbg_place_ms,
                         dbg_res_ms);
    }
    // batch terminals never enter the tree (copies are placed), so all
    // of them reclaim here
    for (int64_t i = 0; i < n; i++) E->S->free_slot(vids[i]);
    return 0;
}

// ----------------------------------------------------------------------
// Device proxy-screen integration (maple_tpu/parallel/proxy_placer.py).
//
// The TPU-native placement path replaces the reference's serial from-
// root DFS (MAPLEv0.7.5.4.py:11692-11752, :7912-8293) with a device MXU
// proxy screen over every anchor followed by an engine-side *seeded*
// best-first crawl: the screen supplies top-M candidate anchors per
// query, phase A crawls from those seeds read-only against the live
// tree (exact appendProbNode scores, minor-sequence checks, stop rules),
// and phase B re-validates/applies serially with the same staleness
// machinery as engine_place_batch.  The engine side here provides
// (1) a changed-node log so the host re-exports only stale screen rows,
// (2) feature extraction for the proxy (hashed mutation buckets +
// missing-data coverage buckets, see feat_extract), and (3) the
// seeded batched placement entry point.

// Batched placement seeded by device screen candidates.  seeds is
// [n, seeds_per] row-major (entries < 0 = padding); seed_budget is the
// crawl's consecutive-non-improvement stop (the from-root budget
// crawl's E->search_budget analogue, smaller because the crawl starts
// at the screened optimum).  Returns 0 ok, 2 unsupported (error-model
// alias-tag registration is placement-order-dependent), -1 error.
int engine_place_batch_seeded(Engine *E, int num_cores, int64_t n,
                              const int64_t *vids, const int32_t *samples,
                              const int32_t *seeds, int32_t seeds_per,
                              int64_t seed_budget) {
    if (num_cores < 1 || seeds_per <= 0 || seed_budget <= 0
            || E->S->tags_active)
        return 2;
    if (E->hnz_mode) {
        // pre-grow the HnZ memo (lazy grow is not thread-safe)
        int max_nd = 2;
        for (int32_t v : E->nDesc0) max_nd = std::max(max_nd, (int)v);
        E->hnz(2 * max_nd + 4);
    }
    std::vector<PlaceProp> props(n);
    const size_t batch_start = E->up.size();
    auto t_a0 = std::chrono::steady_clock::now();
    std::atomic<int64_t> next{0};
    int64_t dfs = 0, missed = 0, fine = 0;
    std::mutex agg_mu;
    auto worker = [&]() {
        std::unordered_set<int64_t> my_owned;
        Engine::tl_owned = &my_owned;
        SlotCacheScope slot_cache(E->S);
        BatchCtx ctx;
        tl_batch = &ctx;
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n) break;
            ctx.absorb_leaf = -1;
            ctx.error.clear();
            ctx.visited.clear();
            ctx.fine_ok = 0;
            ctx.fine_diffs = -1;
            FindResult R = E_find_best_parent_budget(
                E, vids[i], samples[i], seeds + i * seeds_per, seeds_per,
                seed_budget);
            PlaceProp &p = props[i];
            if (ctx.error.empty()) {
                if (R.absorbed) {
                    p.absorb_leaf = ctx.absorb_leaf;
                } else {
                    p.best_node = R.best_node;
                    p.score = R.best_score;
                    p.top = R.top;
                    p.bottom = R.bottom;
                    p.appending = R.appending;
                    p.fine_ok = ctx.fine_ok;
                    p.fine_node = ctx.fine_node;
                    p.fine_score = ctx.fine_score;
                    p.fine_top = ctx.fine_top;
                    p.fine_bottom = ctx.fine_bottom;
                    p.fine_app = ctx.fine_app;
                    p.fine_diffs = ctx.fine_diffs;
                    ctx.fine_diffs = -1;
                    p.cands = std::move(ctx.cands);
                    std::sort(ctx.visited.begin(), ctx.visited.end());
                    ctx.visited.erase(std::unique(ctx.visited.begin(),
                                                  ctx.visited.end()),
                                      ctx.visited.end());
                    p.visited = std::move(ctx.visited);
                }
                p.searched = 1;
            }
            E->end_call();
        }
        {
            std::lock_guard<std::mutex> g(agg_mu);
            dfs += ctx.dfs_visits;
            missed += ctx.missed_minors;
            fine += ctx.fine_evals;
        }
        tl_batch = nullptr;
        Engine::tl_owned = nullptr;
    };
    {
        int T = std::min<int64_t>(num_cores, n);
        E->exec_pool.run(T, [&](int) { worker(); });
    }
    E->dfs_visits += dfs;
    E->total_missed_minors += missed;
    E->fine_evals += fine;
    return E_apply_batch(E, props, vids, samples, n, batch_start, t_a0);
}

void engine_screen_log(Engine *E, int on) {
    E->screen_log_on = on != 0;
    if (!on) E->screen_log.clear();
}

// Drain the changed-node log (sorted, unique).  Returns the count
// written; the host passes cap >= engine_node_count so truncation never
// happens in practice (a truncated drain would only cost screen recall).
long engine_screen_drain(Engine *E, int32_t *out, long cap) {
    auto &log = E->screen_log;
    std::sort(log.begin(), log.end());
    log.erase(std::unique(log.begin(), log.end()), log.end());
    long m = std::min<long>(cap, (long)log.size());
    std::copy(log.begin(), log.begin() + m, out);
    log.clear();
    return m;
}

// Anchor-row features for the device proxy screen: for each node,
// valid[j] says whether the node is screen-eligible (attached, non-zero
// branch, cached mid-branch vector — the same criteria as the round-3
// device pool), and idx/w [n, fmax] carry the global-frame features of
// its probVectTotUp (MAT frames composed out via pass-up, reference
// :3749).  counts[j] = features written.  Returns the max count seen
// (host grows fmax when it approaches the cap).
// Composed root->frame mutation list for the deepest muts-bearing
// ancestor ``f`` (memoized; parent frames are shared prefixes).  One
// upward pass through the composite replaces chain-depth passes per
// exported row — chains average 10-13 branches at 10k-50k, so this is
// the difference between O(depth) and O(1) list transforms per row.
static const std::vector<int32_t> &E_frame_comp(
        Engine *E,
        std::unordered_map<int32_t, std::vector<int32_t>> &memo, int f) {
    auto it = memo.find(f);
    if (it != memo.end()) return it->second;
    int pf = E->up[f];
    while (pf >= 0 && E->muts[pf].empty()) pf = E->up[pf];
    std::vector<int32_t> comp;
    if (pf >= 0)
        // plain downward path composition: parent comp applied first,
        // then f's branch list (downward=false; true would REVERSE the
        // first operand — that mode composes an upward-then-downward
        // path, reference mergeMutationLists :2187-2233)
        comp = E_merge_mutation_lists(E_frame_comp(E, memo, pf),
                                      E->muts[f], false);
    else
        comp = E->muts[f];
    return memo.emplace(f, std::move(comp)).first->second;
}

long engine_export_feats(Engine *E, const int32_t *nodes, long n,
                         int32_t d_hash, int32_t g_buckets, int32_t fmax,
                         int32_t *idx, float *w, int32_t *counts,
                         uint8_t *valid, int use_fp) {
    // read-only over the tree (pass-up temporaries are thread-owned),
    // so the export threads across the engine's exec width
    int T = (int)std::max<long>(1, std::min<long>(E->exec_threads, n / 256));
    std::atomic<long> max_nf{0};
    const bool chain_mode = getenv("MAPLE_EXPORT_CHAIN") != nullptr;
    // Fingerprint skip: a changed-node log entry means the node's
    // vectors were touched, not that its hashed feature set changed
    // (partials refreshes adjust probabilities/branch lengths, which
    // the (position, nucleotide) features don't see).  Rows whose
    // feature fingerprint matches the last upload are marked
    // counts = -1 and dropped host-side before the device scatter.
    if (E->feat_fp.size() < E->up.size()) E->feat_fp.resize(E->up.size(), 0);
    auto work = [&](long lo, long hi) {
        std::unordered_set<int64_t> my_owned;
        Engine::tl_owned = &my_owned;
        SlotCacheScope slot_cache(E->S);
        std::unordered_map<int32_t, std::vector<int32_t>> frame_memo;
        long local_max = 0;
        for (long j = lo; j < hi; j++) {
            int node = nodes[j];
            int32_t *ji = idx + j * fmax;
            float *jw = w + j * fmax;
            bool ok = node >= 0 && (size_t)node < E->up.size()
                      && E->up[node] >= 0 && E->dist[node] > E->eff0
                      && E->totUp[node] >= 0;
            valid[j] = ok ? 1 : 0;
            if (!ok) {
                if (use_fp && node >= 0
                        && (size_t)node < E->feat_fp.size()) {
                    if (E->feat_fp[node] == 1) {  // already invalidated
                        counts[j] = -1;
                        continue;
                    }
                    E->feat_fp[node] = 1;
                }
                counts[j] = 0;
                for (int k2 = 0; k2 < fmax; k2++) {
                    ji[k2] = 0;
                    jw[k2] = 0;
                }
                continue;
            }
            int64_t v = E->totUp[node];
            if (chain_mode) {  // validation twin: per-ancestor passes
                for (int a = node; a >= 0; a = E->up[a])
                    if (!E->muts[a].empty()) v = E_pass_up(E, v, a);
            } else {
                int f = node;
                while (f >= 0 && E->muts[f].empty()) f = E->up[f];
                if (f >= 0)
                    v = E_pass(E, v, E_frame_comp(E, frame_memo, f),
                               true);
            }
            long nf = feat_extract(*E->S, E->S->v(v), false, d_hash,
                                   g_buckets, fmax, ji, jw);
            if (use_fp && nf < fmax) {  // untruncated rows are stable
                uint64_t fp = 1469598103934665603ull;
                auto mix = [&fp](uint64_t x) {
                    fp ^= x;
                    fp *= 1099511628211ull;
                };
                mix((uint64_t)nf);
                for (long k2 = 0; k2 < nf; k2++) {
                    mix((uint64_t)(uint32_t)ji[k2]);
                    uint32_t wb;
                    std::memcpy(&wb, &jw[k2], 4);
                    mix((uint64_t)wb);
                }
                if (fp <= 1) fp = 2;  // reserve 0 = unset, 1 = invalid
                if (E->feat_fp[node] == fp) {
                    counts[j] = -1;
                    continue;
                }
                E->feat_fp[node] = fp;
            } else if (use_fp) {
                E->feat_fp[node] = 0;
            }
            counts[j] = (int32_t)nf;
            local_max = std::max(local_max, nf);
            if ((j & 255) == 255) E->end_call();  // bound temp growth
        }
        E->end_call();  // reclaim pass-up temporaries
        Engine::tl_owned = nullptr;
        long cur = max_nf.load();
        while (local_max > cur
               && !max_nf.compare_exchange_weak(cur, local_max)) {}
    };
    if (T <= 1) {
        work(0, n);
    } else {
        E->exec_pool.run(T, [&](int c) {
            work(n * c / T, n * (c + 1) / T);
        });
    }
    return max_nf.load();
}

// Query features: same space, query-side weights, straight from the
// global-frame terminal vectors (vids stay host-owned).
long engine_export_query_feats(Engine *E, const int64_t *vids, long n,
                               int32_t d_hash, int32_t g_buckets,
                               int32_t fmax, int32_t *idx, float *w,
                               int32_t *counts) {
    int T = (int)std::max<long>(1, std::min<long>(E->exec_threads,
                                                  n / 256));
    std::atomic<long> max_nf{0};
    auto work = [&](long lo, long hi) {
        long local_max = 0;
        for (long j = lo; j < hi; j++) {
            long nf = feat_extract(*E->S, E->S->v(vids[j]), true, d_hash,
                                   g_buckets, fmax, idx + j * fmax,
                                   w + j * fmax);
            counts[j] = (int32_t)nf;
            local_max = std::max(local_max, nf);
        }
        long cur = max_nf.load();
        while (local_max > cur
               && !max_nf.compare_exchange_weak(cur, local_max)) {}
    };
    if (T <= 1) {
        work(0, n);
    } else {
        E->exec_pool.run(T, [&](int c) {
            work(n * c / T, n * (c + 1) / T);
        });
    }
    return max_nf.load();
}

// Store-level feature export for the rt-side device screens (the SPR
// proxy screen, maple_tpu/parallel/batch_spr.py): same feature space as
// engine_export_feats, over raw store vector handles the caller has
// already translated to the global frame.
long store_export_feats(Store *S, const int64_t *vids, long n,
                        int query_side, int32_t d_hash,
                        int32_t g_buckets, int32_t fmax, int32_t *idx,
                        float *w, int32_t *counts) {
    long max_nf = 0;
    for (long j = 0; j < n; j++) {
        if (vids[j] < 0) {
            counts[j] = 0;
            for (int k2 = 0; k2 < fmax; k2++) {
                idx[j * fmax + k2] = 0;
                w[j * fmax + k2] = 0.0f;
            }
            continue;
        }
        long nf = feat_extract(*S, S->v(vids[j]), query_side != 0,
                               d_hash, g_buckets, fmax, idx + j * fmax,
                               w + j * fmax);
        counts[j] = (int32_t)nf;
        max_nf = std::max(max_nf, nf);
    }
    return max_nf;
}

// Batched exact placement scoring over handle pairs (one crossing per
// screen re-score instead of one Python ctypes call per pair):
// out[i*m + k] = appendProbNode(vP[i*m + k], vC[i], blen[i], tip[i]).
// vP entries < 0 score -inf (masked candidates).  Threaded: scores are
// pure functions of immutable store vectors.
void k_append_grid(Store *S, const int64_t *vP, const int64_t *vC,
                   const double *blen, const uint8_t *tip_c, long n,
                   long m, int n_threads, double *out) {
    auto work = [&](long lo, long hi) {
        for (long i = lo; i < hi; i++)
            for (long k2 = 0; k2 < m; k2++) {
                int64_t p = vP[i * m + k2];
                out[i * m + k2] = p < 0
                    ? -std::numeric_limits<double>::infinity()
                    : append_prob_node(*S, S->v(p), S->v(vC[i]),
                                       tip_c[i] != 0, blen[i]);
            }
    };
    int T = std::max<long>(1, std::min<long>(n_threads, n));
    if (T == 1) { work(0, n); return; }
    std::vector<std::thread> ts;
    ts.reserve(T);
    for (int c = 0; c < T; c++)
        ts.emplace_back(work, n * c / T, n * (c + 1) / T);
    for (auto &t : ts) t.join();
}

// Dev microbenchmark: cycles/append over a set of (vP, vC) pairs.
// mode 0: sweep all pairs per rep (realistic cache footprint);
// mode 1: hammer one pair (cache-hot) — the difference separates
// memory-bound from compute-bound cost.
double engine_bench_append(Engine *E, const int64_t *va, const int64_t *vb,
                           int n_pairs, int reps, int mode) {
    volatile double sink = 0.0;
#ifdef MAPLE_PROFILE
    uint64_t t0 = prof_now();
    int64_t calls = 0;
    for (int r = 0; r < reps; r++) {
        if (mode == 1) {
            for (int i = 0; i < n_pairs; i++) {
                sink = append_prob_node(*E->S, E->S->v(va[0]),
                                        E->S->v(vb[0]), true, E->one_mut);
                calls++;
            }
        } else {
            for (int i = 0; i < n_pairs; i++) {
                sink = append_prob_node(*E->S, E->S->v(va[i]),
                                        E->S->v(vb[i]), true, E->one_mut);
                calls++;
            }
        }
    }
    (void)sink;
    return (double)(prof_now() - t0) / (double)calls;
#else
    (void)va; (void)vb; (void)n_pairs; (void)reps; (void)mode;
    return -1.0;
#endif
}

int32_t engine_root(Engine *E) { return E->root; }
int32_t engine_node_count(Engine *E) { return (int32_t)E->up.size(); }

const char *engine_error(Engine *E) { return E->error.c_str(); }

void engine_counts(Engine *E, double *out, int reset) {
    for (int i = 0; i < 16; i++) out[i] = E->counts[i];
    if (reset) for (int i = 0; i < 16; i++) E->counts[i] = 0.0;
}

void engine_stats(Engine *E, double *out) {
    out[0] = E->num_minors_found;
    out[1] = E->total_missed_minors;
    out[2] = E->sum_child_lks;
    out[3] = E->num_child_lks;
    out[4] = E->warned_blen;
    out[5] = E->warned_blen_value;
    out[6] = E->num_refs;
    out[7] = (double)E->dfs_visits;
    out[8] = (double)E->fine_evals;
}

// Dev-only (see MAPLE_PROFILE above); zeros when profiling is compiled out.
void engine_profile(Engine *E, double *out) {
    for (int i = 0; i < 26; i++) out[i] = 0.0;
#ifdef MAPLE_PROFILE
    out[0] = (double)E->p_find_cy;
    out[1] = (double)E->p_append_cy;
    out[2] = (double)E->p_pass_cy;
    out[3] = (double)E->p_fine_cy;
    out[4] = (double)E->p_place_cy;
    out[5] = (double)E->p_scored;
    out[6] = (double)E->p_free;
    out[7] = (double)E->p_entries;
    out[8] = (double)E->p_tot_entries;
    out[9] = (double)E->p_o_entries;
    for (int i = 0; i < 16; i++) out[10 + i] = (double)E->p_gap_hist[i];
#endif
}

void engine_export_nodes(Engine *E, int32_t *up, int32_t *cc0, int32_t *cc1,
                         double *dist, int32_t *name, int32_t *ndesc,
                         uint8_t *dirty, int64_t *pv, int64_t *upr,
                         int64_t *upl, int64_t *totup, int32_t *n_minor,
                         int32_t *n_muts) {
    int n = (int)E->up.size();
    for (int i = 0; i < n; i++) {
        up[i] = E->up[i];
        cc0[i] = E->c0[i];
        cc1[i] = E->c1[i];
        dist[i] = E->dist[i];
        name[i] = E->name[i];
        ndesc[i] = E->nDesc[i];
        dirty[i] = E->dirty[i];
        pv[i] = E->pv[i];
        upr[i] = E->upR[i];
        upl[i] = E->upL[i];
        totup[i] = E->totUp[i];
        n_minor[i] = (int32_t)E->minorSeqs[i].size();
        n_muts[i] = (int32_t)(E->muts[i].size() / 3);
    }
}

void engine_export_minor(Engine *E, int32_t node, int32_t *out) {
    for (size_t i = 0; i < E->minorSeqs[node].size(); i++)
        out[i] = E->minorSeqs[node][i];
}

void engine_export_muts(Engine *E, int32_t node, int32_t *out) {
    for (size_t i = 0; i < E->muts[node].size(); i++)
        out[i] = E->muts[node][i];
}


// ---- SPR-phase entry points ----

// (Re)build the engine tree from the session tree; vector ids transfer
// ownership to the engine.
void engine_import(Engine *E, int32_t n, const int32_t *up,
                   const int32_t *c0, const int32_t *c1,
                   const double *dist, const int32_t *ndesc,
                   const uint8_t *dirty, const int32_t *repl,
                   const int64_t *pv, const int64_t *upr,
                   const int64_t *upl, const int64_t *totup,
                   const int32_t *minor_counts, const int32_t *n_muts,
                   const int32_t *muts_flat, int32_t root) {
    E->up.assign(up, up + n);
    E->c0.assign(c0, c0 + n);
    E->c1.assign(c1, c1 + n);
    E->dist.assign(dist, dist + n);
    E->nDesc.assign(ndesc, ndesc + n);
    E->dirty.assign(dirty, dirty + n);
    E->replacements.assign(repl, repl + n);
    E->pv.assign(pv, pv + n);
    E->upR.assign(upr, upr + n);
    E->upL.assign(upl, upl + n);
    E->totUp.assign(totup, totup + n);
    E->name.assign(n, -1);
    E->nDesc0.assign(n, 1);
    E->minorSeqs.assign(n, {});
    E->muts.assign(n, {});
    const int32_t *m = muts_flat;
    for (int i = 0; i < n; i++) {
        if (minor_counts[i])
            E->minorSeqs[i].assign((size_t)minor_counts[i], -1);
        if (n_muts[i]) {
            E->muts[i].assign(m, m + 3 * n_muts[i]);
            m += 3 * n_muts[i];
        }
    }
    E->root = root;
}

int engine_recalculate(Engine *E) {
    int rc = E->exec_threads > 1 ? E_recalculate_parallel(E)
                                 : E_recalculate(E);
    E->end_call();
    return rc;
}

// Full recompute with the error model active: replay the host's
// pre-computed shared-ambiguity-list refresh schedule (n patches of
// (node, tag, 4 probs), in pass-1 post-order) at each tip's visit.
// Serial only — patch timing is ordering-sensitive by design.
int engine_recalculate_err(Engine *E, const int32_t *p_nodes,
                           const int32_t *p_tags, const double *p_vals,
                           int64_t n) {
    E->err_patches.clear();
    for (int64_t i = 0; i < n; i++) {
        auto &r = E->err_patches.emplace(
            p_nodes[i], std::make_pair(i, i)).first->second;
        r.second = i + 1;  // patches arrive contiguous per node
    }
    E->err_tags = p_tags;
    E->err_vals = p_vals;
    int rc = E_recalculate(E);
    E->err_patches.clear();
    E->err_tags = nullptr;
    E->err_vals = nullptr;
    E->end_call();
    return rc;
}

int engine_tree_lk(Engine *E, double *out) {
    int rc = E->exec_threads > 1 ? E_tree_lk_parallel(E, out)
                                 : E_tree_lk(E, out);
    E->end_call();
    return rc;
}

// Root-position search (findBestRoot :7730-7902) — read-only borrow of
// the session vectors; caller supplies cand arrays of node-count
// capacity.  Returns 0 ok / 2 fall-back-to-python.
int engine_root_search(Engine *E, int strict_stop, int allowed_fails,
                       double threshold_log_lk,
                       double threshold_consecutive, double threshold_opt,
                       int32_t *best_node_out, double *best_lk_out,
                       int32_t *cand_nodes, double *cand_scores,
                       int64_t *cand_count) {
    int rc = E_root_search(E, strict_stop != 0, allowed_fails,
                           threshold_log_lk, threshold_consecutive,
                           threshold_opt, best_node_out, best_lk_out,
                           cand_nodes, cand_scores, cand_count);
    E->end_call();
    return rc;
}

int engine_blen_sweep(Engine *E, int fast_pass, int64_t *updates) {
    int rc = E_blen_sweep(E, fast_pass != 0, updates);
    E->end_call();
    return rc;
}

// The host loop's branch-length finalization (spr.py run_spr_rounds):
// sweep once, then repeat while the previous sweep changed something,
// up to max_extra further sweeps.  Returns the number of extra sweeps
// run (the python loop's sub_round counter) via *sub_rounds.
int engine_blen_loop(Engine *E, int max_extra, int64_t *sub_rounds) {
    int64_t updates = 0;
    int rc = E_blen_sweep(E, false, &updates);
    E->end_call();
    if (rc != 0) return rc;
    int64_t sr = 0;
    while (sr < max_extra && updates) {
        sr++;
        rc = E_blen_sweep(E, false, &updates);
        E->end_call();
        if (rc != 0) return rc;
    }
    *sub_rounds = sr;
    return 0;
}

void engine_set_spr_params(Engine *E, double threshold_opt_topology,
                           double threshold_topology_placement,
                           double default_blen, int max_replacements) {
    E->threshold_opt_topology = threshold_opt_topology;
    E->threshold_topology_placement = threshold_topology_placement;
    E->default_blen = default_blen;
    E->max_replacements = max_replacements;
}

// startTopologyUpdates (:9489-9573): preorder sweep over dirty nodes.
// Returns 0 ok / -1 error; outputs new root (or -1), total improvement,
// and counters.
int engine_spr_pass(Engine *E, int strict_stop, int allowed_fails,
                    double threshold_log_lk, int32_t *new_root_out,
                    double *improvement_out, long *topo_updates_out,
                    long *blen_updates_out) {
    long topo = 0, blen = 0;
    double total = 0.0;
    int32_t new_root = -1;
    bool debug_progress = getenv("MAPLE_DEBUG_SPR_TIMING") != nullptr;
    int64_t searched = 0;
    tl_crawl_visits = 0;
    auto t_start = std::chrono::steady_clock::now();
    std::vector<int32_t> stack = {E->root};
    while (!stack.empty()) {
        int n = stack.back();
        stack.pop_back();
        if (!E->is_leaf(n)) {
            stack.push_back(E->c0[n]);
            stack.push_back(E->c1[n]);
        }
        if (E->dirty[n] && E->replacements[n] <= E->max_replacements) {
            E->dirty[n] = 0;
            int nr;
            double improvement;
            int rc = E_traverse_topology(E, n, strict_stop != 0,
                                         allowed_fails, threshold_log_lk,
                                         &nr, &improvement, &topo, &blen);
            E->end_call();
            if (rc != 0) return -1;
            total += improvement;
            if (nr >= 0) {
                new_root = nr;
                E->root = nr;
            }
            if (debug_progress && (++searched & 8191) == 0) {
                auto el =
                    std::chrono::duration_cast<std::chrono::milliseconds>(
                        std::chrono::steady_clock::now() - t_start).count();
                fprintf(stderr, "SPR_SERIAL searched=%lld visits=%lld "
                        "el=%lldms\n", (long long)searched,
                        (long long)tl_crawl_visits, (long long)el);
            }
        }
    }
    *new_root_out = new_root;
    *improvement_out = total;
    *topo_updates_out = topo;
    *blen_updates_out = blen;
    return 0;
}

void engine_export_replacements(Engine *E, int32_t *out) {
    for (size_t i = 0; i < E->replacements.size(); i++)
        out[i] = E->replacements[i];
}

// runtime/tree.py count_dirty_nodes: dirty and total counts over the
// reachable tree (the numCores>1 subround heuristic, reference :12450)
void engine_count_dirty(Engine *E, int64_t *out) {
    int64_t dirty = 0, total = 0;
    std::vector<int32_t> stack = {E->root};
    while (!stack.empty()) {
        int n = stack.back();
        stack.pop_back();
        total++;
        if (E->dirty[n]) dirty++;
        if (E->c0[n] >= 0) {
            stack.push_back(E->c0[n]);
            stack.push_back(E->c1[n]);
        }
    }
    out[0] = dirty;
    out[1] = total;
}

// runtime/tree.py set_all_dirty (reference setAllDirty :8715-8724): mark
// the whole tree dirty and reset the SPR replacement counters, engine-side
// so a live session needs no host round-trip.
void engine_set_all_dirty(Engine *E, int dirtiness) {
    std::vector<int32_t> stack = {E->root};
    while (!stack.empty()) {
        int n = stack.back();
        stack.pop_back();
        E->dirty[n] = dirtiness ? 1 : 0;
        E->replacements[n] = 0;
        if (E->c0[n] >= 0) {
            stack.push_back(E->c0[n]);
            stack.push_back(E->c1[n]);
        }
    }
}

// models/em.py pass_mutation_list_through_branch (reference
// :10027-10076), over the engine-session EM crawl's (pos, nuc) pair list
// with a branch's flat (pos, from, to) triples.
static void em_pass_list(const Store &S, std::vector<int32_t> &pos_l,
                         std::vector<int8_t> &alt_l,
                         const std::vector<int32_t> &branch, bool dir_is_up) {
    static thread_local std::vector<int32_t> out_pos;
    static thread_local std::vector<int8_t> out_alt;
    out_pos.clear();
    out_alt.clear();
    size_t i1 = 0, i2 = 0, n1 = pos_l.size(), n2 = branch.size() / 3;
    while (true) {
        if (i1 < n1) {
            int pos1 = pos_l[i1];
            if (i2 < n2) {
                int pos2 = branch[i2 * 3];
                if (pos1 < pos2) {
                    out_pos.push_back(pos1);
                    out_alt.push_back(alt_l[i1]);
                    i1++;
                } else {
                    int end_nuc = dir_is_up ? branch[i2 * 3 + 1]
                                            : branch[i2 * 3 + 2];
                    if (end_nuc != S.ref_indices[pos2 - 1]) {
                        out_pos.push_back(pos2);
                        out_alt.push_back((int8_t)end_nuc);
                    }
                    i2++;
                    if (pos1 == pos2) i1++;
                }
            } else {
                out_pos.push_back(pos1);
                out_alt.push_back(alt_l[i1]);
                i1++;
            }
        } else if (i2 < n2) {
            int pos2 = branch[i2 * 3];
            int end_nuc = dir_is_up ? branch[i2 * 3 + 1]
                                    : branch[i2 * 3 + 2];
            if (end_nuc != S.ref_indices[pos2 - 1]) {
                out_pos.push_back(pos2);
                out_alt.push_back((int8_t)end_nuc);
            }
            i2++;
        } else {
            break;
        }
    }
    pos_l = out_pos;
    alt_l = out_alt;
}

// models/em.py _em_native traversal fully engine-side: the same pre-order
// branch crawl (em_branch accumulation at first entry of every node with
// a contributing branch; MAT frame-difference list maintained across
// branches), reading the engine-resident tree so a live session never
// touches stale host state.  The host must em_reset the store first and
// reads the accumulated totals afterwards (em_totals & co) — float-op
// order is identical to the host-driven crawl, so results stay
// byte-identical.  Returns num_tips (leaves + minor sequences), or -1 on
// error.
int64_t engine_em(Engine *E) {
    const Store &S = *E->S;
    const bool uer = S.em_state.uer;
    std::vector<int32_t> ml_pos;
    std::vector<int8_t> ml_alt;
    for (size_t k = 0; k * 3 < E->muts[E->root].size(); k++) {
        ml_pos.push_back(E->muts[E->root][k * 3]);
        ml_alt.push_back((int8_t)E->muts[E->root][k * 3 + 2]);
    }
    int64_t num_tips = 0;
    int node = E->root, last = -1, dir = 0;
    while (node >= 0) {
        if (dir == 0) {
            bool leafq = E->c0[node] < 0;
            if (leafq) num_tips += 1 + (int64_t)E->minorSeqs[node].size();
            if ((E->dist[node] != 0.0 || (uer && leafq))
                    && E->up[node] >= 0) {
                int64_t vP = E->vect_up_for(node);
                int64_t tmp = -1;
                if (!E->muts[node].empty()) {
                    tmp = E_pass_down(E, vP, node);
                    vP = tmp;
                }
                em_branch(E->S, vP, E->pv[node], E->dist[node],
                          leafq ? 1 : 0, (int)E->minorSeqs[node].size(),
                          ml_pos.empty() ? nullptr : ml_pos.data(),
                          ml_alt.empty() ? nullptr : ml_alt.data(),
                          (int)ml_pos.size());
                if (tmp >= 0) E->release(tmp);
            }
            if (!leafq) {
                node = E->c0[node];
                if (!E->muts[node].empty())
                    em_pass_list(S, ml_pos, ml_alt, E->muts[node], false);
            } else {
                last = node;
                if (!E->muts[node].empty())
                    em_pass_list(S, ml_pos, ml_alt, E->muts[node], true);
                node = E->up[node];
                dir = 1;
            }
        } else {
            if (last == E->c0[node]) {
                node = E->c1[node];
                if (!E->muts[node].empty())
                    em_pass_list(S, ml_pos, ml_alt, E->muts[node], false);
                dir = 0;
            } else {
                last = node;
                if (!E->muts[node].empty())
                    em_pass_list(S, ml_pos, ml_alt, E->muts[node], true);
                node = E->up[node];
            }
        }
    }
    E->end_call();
    return num_tips;
}

// ---------------------------------------------------------------------
// Parallel SPR: search-parallel / apply-serial inside the engine.
//
// The reference's only parallel phase forks worker PROCESSES that
// re-run the python search over copy-on-write state
// (startTopologyUpdatesParallel :9580-9716, applySPRMovesParallel
// :9470-9484; host twin maple_tpu/search/parallel_spr.py).  Here the
// same contract runs as engine threads over the shared resident tree:
// the proposal phase is read-only (worker temporaries live in
// thread-local ownership sets, lazy totUp fills in a per-worker side
// cache), proposals merge in core order and stable-sort ascending by
// improvement, and the apply phase re-validates each move through the
// serial per-node loop — byte-identical outputs to the fork path,
// without pickling or pool spin-up.

struct SprProposal {
    int32_t node;
    int32_t placement;
    double improvement;
};

// parallel_spr.py _propose_moves :63-161 (no abayes/network — the host
// gates those to the python fork path)
static void E_spr_propose_core(Engine *E, int core, bool strict_stop,
                               int allowed_fails, double threshold_log_lk,
                               std::vector<SprProposal> *out,
                               int64_t *searched) {
    std::unordered_set<int64_t> my_owned;
    SprWorkerCache my_cache;
    Engine::tl_owned = &my_owned;
    SlotCacheScope slot_cache(E->S);
    tl_spr_cache = &my_cache;
    tl_crawl_visits = 0;
    bool debug_progress = getenv("MAPLE_DEBUG_SPR_TIMING") != nullptr;
    auto t_start = std::chrono::steady_clock::now();
    auto &up = E->up;
    auto &dist = E->dist;
    double eff0 = E->eff0;
    double placement_thresh = E->threshold_topology_placement;
    std::vector<int32_t> stack = {E->root};
    while (!stack.empty()) {
        int node = stack.back();
        stack.pop_back();
        if (E->c0[node] >= 0) {
            stack.push_back(E->c0[node]);
            stack.push_back(E->c1[node]);
        }
        if (!(E->dirty[node]
              && E->replacements[node] <= E->max_replacements
              && E->core_num[node] == core))
            continue;
        if (up[node] < 0) continue;
        (*searched)++;
        if (debug_progress && (*searched & 8191) == 0) {
            auto el = std::chrono::duration_cast<std::chrono::milliseconds>(
                std::chrono::steady_clock::now() - t_start).count();
            fprintf(stderr, "SPR_PROGRESS core=%d searched=%lld "
                    "visits=%lld fills=%zu el=%lldms\n", core,
                    (long long)*searched, (long long)tl_crawl_visits,
                    my_cache.tot_up.size(), (long long)el);
        }
        int parent = up[node];
        int child = E->child_index(node);
        int64_t vect_up = child == 0 ? E->upR[parent] : E->upL[parent];
        if (!E->muts[node].empty())
            vect_up = E_pass_down(E, vect_up, node);
        double best_curren_blen = dist[node];
        bool is_tip = E->is_tip(node);
        double best_current_lk = E_append(E, vect_up, E->pv[node], is_tip,
                                          best_curren_blen);
        if (E->hnz_mode) {
            // parallel_spr.py :106-119 — identical to the serial initial
            // HnZ correction
            auto &nd = E->nDesc0;
            int pn0 = up[node];
            while (dist[pn0] <= eff0 && up[pn0] >= 0) pn0 = up[pn0];
            if (dist[node] > eff0)
                best_current_lk += E->hnz(nd[pn0]) - E->hnz(nd[pn0] - 1);
            else
                best_current_lk += E->hnz(nd[pn0])
                                   - (E->hnz(nd[pn0] - nd[node])
                                      + E->hnz(nd[node]));
        }
        // the worker skips the serial path's branch-length re-optimization
        // (it cannot write blens); crawl gate :120-122
        if (best_current_lk < placement_thresh || dist[node] != 0.0
                || E->hnz_mode) {
            TopoResult R;
            // worker exceptions swallow the node (reference :9703-9704)
            if (E_find_best_parent_topology(E, parent, child,
                                            best_current_lk,
                                            best_curren_blen, strict_stop,
                                            allowed_fails,
                                            threshold_log_lk, &R)
                    && R.best_score + placement_thresh > best_current_lk) {
                bool topology_updated = true;
                int top_node = up[node];
                if (R.best_node == top_node) topology_updated = false;
                while (dist[top_node] == 0.0 && up[top_node] >= 0)
                    top_node = up[top_node];
                if (R.best_node == top_node && R.bottom == 0.0)
                    topology_updated = false;
                int sibling = node == E->c0[parent] ? E->c1[parent]
                                                    : E->c0[parent];
                if (R.best_node == sibling) topology_updated = false;
                if (up[R.best_node] == sibling && R.top == 0.0)
                    topology_updated = false;
                if (topology_updated)
                    out->push_back({node, R.best_node,
                                    R.best_score - best_current_lk});
            }
        }
        E->end_call();
    }
    for (auto &kv : my_cache.tot_up)
        if (kv.second >= 0) E->S->free_slot(kv.second);
    Engine::tl_owned = nullptr;
    tl_spr_cache = nullptr;
}

// The serial re-validated apply of a sorted proposal list
// (parallel_spr.py apply_spr_moves; reference applySPRMovesParallel
// :9470-9484): every node clean first, then each proposal's node, from the
// end of the list (best improvement first), re-searched and moved by
// E_traverse_topology against the live tree.  The serial phase of
// engine_spr_pass_parallel, and the apply of a list the host sorted (the
// device SPR pass, batch_spr.py _apply; set engine_set_spr_params first).
// Returns 0 ok, -1 error.
int engine_spr_apply(Engine *E, const int32_t *nodes, long n,
                     int strict_stop, int allowed_fails,
                     double threshold_log_lk, int32_t *new_root_out,
                     double *improvement_out, long *topo_out,
                     long *blen_out) {
    engine_set_all_dirty(E, 0);
    long topo = 0, blen = 0;
    double total = 0.0;
    int32_t new_root = -1;
    for (long k = n - 1; k >= 0; k--) {
        int nr;
        double improvement;
        int rc = E_traverse_topology(E, nodes[k], strict_stop != 0,
                                     allowed_fails, threshold_log_lk, &nr,
                                     &improvement, &topo, &blen);
        E->end_call();
        if (rc != 0) return -1;
        total += improvement;
        if (nr >= 0) {
            new_root = nr;
            E->root = nr;
        }
    }
    *new_root_out = new_root;
    *improvement_out = total;
    *topo_out = topo;
    *blen_out = blen;
    return 0;
}

// One search-parallel / apply-serial pass (parallel_spr.py
// parallel_topology_update; reference :12283-12312).  searched_out /
// proposed_out are per-core counters for the host's progress prints;
// *assigned_out > 0 only when this call computed the core assignment.
// Returns 0 ok, 2 = unsupported state (host falls back to the fork
// path), -1 = error during apply.
int engine_spr_pass_parallel(Engine *E, int num_cores, int strict_stop,
                             int allowed_fails, double threshold_log_lk,
                             int32_t *new_root_out, double *improvement_out,
                             long *topo_updates_out, long *blen_updates_out,
                             int64_t *searched_out, int64_t *proposed_out,
                             int64_t *assigned_out) {
    *assigned_out = 0;
    if (E->S->tags_active || num_cores < 1) return 2;
    // core assignment: round-robin in pre-order traversal order
    // (assign_core_numbers; reference :12164-12195), computed once
    if ((int)E->core_num.size() != (int)E->up.size()
            || E->cores_assigned != num_cores) {
        E->core_num.assign(E->up.size(), -1);
        E->cores_assigned = num_cores;
        int node = E->root, last = -1, dir = 0, current = 0;
        int64_t num_nodes = 0;
        while (node >= 0) {
            if (dir == 0) {
                num_nodes++;
                E->core_num[node] = current;
                current = (current + 1) % num_cores;
                if (E->c0[node] >= 0) {
                    node = E->c0[node];
                } else {
                    last = node;
                    node = E->up[node];
                    dir = 1;
                }
            } else if (last == E->c0[node]) {
                node = E->c1[node];
                dir = 0;
            } else {
                last = node;
                node = E->up[node];
            }
        }
        *assigned_out = num_nodes;
    }
    if (E->hnz_mode) {
        // pre-grow the HnZ memo: workers may query up to the sum of two
        // clade sizes (bounded by 2x the largest nDesc0), and the lazy
        // grow is not thread-safe
        int max_nd = 2;
        for (int32_t v : E->nDesc0) max_nd = std::max(max_nd, (int)v);
        E->hnz(2 * max_nd + 4);
    }
    // phase A: read-only proposal search, one thread per core
    auto t_a = std::chrono::steady_clock::now();
    std::vector<std::vector<SprProposal>> props(num_cores);
    std::vector<int64_t> searched(num_cores, 0);
    {
        std::vector<std::thread> workers;
        workers.reserve(num_cores);
        for (int c = 0; c < num_cores; c++)
            workers.emplace_back(E_spr_propose_core, E, c,
                                 strict_stop != 0, allowed_fails,
                                 threshold_log_lk, &props[c],
                                 &searched[c]);
        for (auto &t : workers) t.join();
    }
    auto t_b = std::chrono::steady_clock::now();
    std::vector<SprProposal> all;
    for (int c = 0; c < num_cores; c++) {
        searched_out[c] = searched[c];
        proposed_out[c] = (int64_t)props[c].size();
        all.insert(all.end(), props[c].begin(), props[c].end());
    }
    // ascending stable sort = the host's list.sort(key=improvement);
    // apply pops from the end (best first)
    std::stable_sort(all.begin(), all.end(),
                     [](const SprProposal &a, const SprProposal &b) {
                         return a.improvement < b.improvement;
                     });
    if (getenv("MAPLE_DEBUG_PROPS"))
        for (auto &p : all)
            fprintf(stderr, "PROP %d %d %.17g\n", p.node, p.placement,
                    p.improvement);
    // phase B: serial re-validated apply (applySPRMovesParallel)
    std::vector<int32_t> nodes;
    nodes.reserve(all.size());
    for (auto &p : all) nodes.push_back(p.node);
    if (engine_spr_apply(E, nodes.data(), (long)nodes.size(), strict_stop,
                         allowed_fails, threshold_log_lk, new_root_out,
                         improvement_out, topo_updates_out,
                         blen_updates_out) != 0)
        return -1;
    if (getenv("MAPLE_DEBUG_SPR_TIMING")) {
        auto t_c = std::chrono::steady_clock::now();
        auto ms = [](auto a, auto b) {
            return std::chrono::duration_cast<std::chrono::milliseconds>(
                       b - a).count();
        };
        fprintf(stderr, "SPR_TIMING search=%lldms apply=%lldms "
                "proposals=%zu vec_count=%zu free=%zu\n",
                (long long)ms(t_a, t_b), (long long)ms(t_b, t_c),
                all.size(), E->S->vec_count, E->S->free_slots.size());
    }
    return 0;
}


// --- the device SPR pass inside a live engine session
// (maple_tpu_torch/parallel/batch_spr.py _screen_session): collect here,
// screen and re-score on the device, apply here ---

// Free the translations engine_spr_collect held.
void engine_spr_release(Engine *E) {
    for (int64_t id : E->spr_held) E->S->free_slot(id);
    E->spr_held.clear();
}

// The queries and anchors of one device SPR pass, from the resident tree,
// with the gates of the host collection (batch_spr.py _collect_queries and
// _collect_anchors; the parallel crawl's E_spr_propose_core): a query is a
// dirty node under maxReplacements whose current attachment score `base`
// (with the HnZ correction) passes the crawl's gate; an anchor is an
// attached node with a non-zero branch and a mid-branch vector.  Queries
// come in the host's pre-order (second child first), anchors in node
// order.  Set engine_set_spr_params first (the placement threshold and
// maxReplacements gate the queries).
//
// Per query: node, the global-frame handle of its lower vector, branch
// length, tip flag, base, its Euler interval [lo, hi) (an anchor whose
// entry lies inside it is in the query's own subtree), the anchor rows of
// its parent and sibling (-1 where none) and its list's length.  Per
// anchor: node, the global-frame handle of its mid-branch vector, its
// Euler entry and list length.  Every array holds one value a node of the
// tree (q_excl two); counts_out gets (queries, anchors).  Handles made
// here (MAT frame translations) stay valid until engine_spr_release.
int engine_spr_collect(Engine *E, int32_t root, int32_t *q_node,
                       int64_t *q_vid, double *q_blen, uint8_t *q_tip,
                       double *q_base, int32_t *q_lo, int32_t *q_hi,
                       int32_t *q_excl, int32_t *q_len, int32_t *a_node,
                       int64_t *a_vid, int32_t *a_tin, int32_t *a_len,
                       int64_t *counts_out) {
    engine_spr_release(E);
    const int n_nodes = (int)E->up.size();
    auto &up = E->up;
    auto &dist = E->dist;
    const double eff0 = E->eff0;
    // batch_spr.py _euler_intervals: a is inside subtree(q) iff
    // tin[q] <= tin[a] < tout[q]
    std::vector<int32_t> tin(n_nodes, 0), tout(n_nodes, 0);
    {
        int32_t t = 0;
        std::vector<std::pair<int32_t, bool>> stack = {{root, false}};
        while (!stack.empty()) {
            auto [node, done] = stack.back();
            stack.pop_back();
            if (done) {
                tout[node] = t;
                continue;
            }
            tin[node] = t++;
            stack.push_back({node, true});
            if (E->c0[node] >= 0) {
                stack.push_back({E->c0[node], false});
                stack.push_back({E->c1[node], false});
            }
        }
    }
    std::unordered_set<int64_t> scratch;
    Engine::tl_owned = &scratch;
    std::unordered_map<int32_t, std::vector<int32_t>> frame_memo;
    // the vector in the global frame: one pass through the composed
    // root->frame mutation list (runtime/partials.py global_frame_up)
    auto global = [&](int64_t v, int node) {
        int f = node;
        while (f >= 0 && E->muts[f].empty()) f = up[f];
        if (f < 0) return v;
        int64_t g = E_pass(E, v, E_frame_comp(E, frame_memo, f), true);
        if (g != v) {
            scratch.erase(g);
            E->spr_held.push_back(g);
        }
        return g;
    };
    std::vector<int32_t> row_of(n_nodes, -1);
    long N = 0;
    for (int node = 0; node < n_nodes; node++) {
        if (up[node] < 0 || !(dist[node] > eff0) || E->totUp[node] < 0)
            continue;
        row_of[node] = (int32_t)N;
        a_node[N] = node;
        a_vid[N] = global(E->totUp[node], node);
        a_tin[N] = tin[node];
        a_len[N] = (int32_t)E->S->v(a_vid[N]).size();
        N++;
    }
    const double placement_thresh = E->threshold_topology_placement;
    long K = 0;
    std::vector<int32_t> stack = {root};
    while (!stack.empty()) {
        int node = stack.back();
        stack.pop_back();
        if (E->c0[node] >= 0) {
            stack.push_back(E->c0[node]);
            stack.push_back(E->c1[node]);
        }
        if (up[node] < 0 || !E->dirty[node]
                || E->replacements[node] > E->max_replacements)
            continue;
        // batch_spr.py _current_attachment_lk
        int parent = up[node];
        int child = E->child_index(node);
        int64_t vect_up = child == 0 ? E->upR[parent] : E->upL[parent];
        if (!E->muts[node].empty()) vect_up = E_pass_down(E, vect_up, node);
        bool is_tip = E->is_tip(node);
        double base = E_append(E, vect_up, E->pv[node], is_tip, dist[node]);
        E->release(vect_up);
        if (E->hnz_mode) {
            auto &nd = E->nDesc0;
            int pn0 = up[node];
            while (dist[pn0] <= eff0 && up[pn0] >= 0) pn0 = up[pn0];
            if (dist[node] > eff0)
                base += E->hnz(nd[pn0]) - E->hnz(nd[pn0] - 1);
            else
                base += E->hnz(nd[pn0])
                        - (E->hnz(nd[pn0] - nd[node]) + E->hnz(nd[node]));
        }
        if (!(base < placement_thresh || dist[node] != 0.0 || E->hnz_mode))
            continue;
        int sibling = child == 0 ? E->c1[parent] : E->c0[parent];
        q_node[K] = node;
        q_vid[K] = global(E->pv[node], node);
        q_blen[K] = dist[node];
        q_tip[K] = is_tip ? 1 : 0;
        q_base[K] = base;
        q_lo[K] = tin[node];
        q_hi[K] = tout[node];
        q_excl[2 * K] = row_of[parent];
        q_excl[2 * K + 1] = row_of[sibling];
        q_len[K] = (int32_t)E->S->v(q_vid[K]).size();
        K++;
    }
    E->end_call();
    Engine::tl_owned = nullptr;
    counts_out[0] = K;
    counts_out[1] = N;
    return E->error.empty() ? 0 : -1;
}

// Genome lists in the pair kernel's stacked operand layout, float64: what
// ops/pack.py pack_genome_list and ops/layout.py stack_fields_host make of
// the lists' tuples (NativeStore.to_tuples), written straight from the
// store.  Candidates (query_side 0) as [n, 16, B], queries as [n, B, 16];
// entries past a list's end are PAD (type 7, ending at lRef).  Site rates
// come from the store's model; a store with an error model is refused
// (returns -1), as is a list longer than B (-2).
int store_pack_stacked(Store *S, const int64_t *vids, long n, int32_t B,
                       int query_side, double *out) {
    if (S->using_error_rate) return -1;
    constexpr int F = 16, kPad = 7;  // ops/pack.py TYPE_PAD
    const size_t row = (size_t)F * B;
    const size_t es = query_side ? F : 1;   // from entry to entry
    const size_t fs = query_side ? 1 : B;   // from field to field
    const int lRef = S->lRef;
    auto rate_at = [&](int end) {
        int pos = end - 1 > 0 ? end - 1 : 0;
        return S->use_rate_variation ? S->site_rates[pos] : 1.0;
    };
    for (long r = 0; r < n; r++) {
        const Vec &v = S->v(vids[r]);
        if ((long)v.size() > B) return -2;
        double *base = out + row * r;
        int pos = 0, prev = 0;
        for (int b = 0; b < B; b++) {
            double f[F] = {};  // every field written once
            int type = kPad, end = lRef;
            if (b < (int)v.size()) {
                const Entry &x = v[b];
                type = x.type;
                if (type == TYPE_R || type == TYPE_N) {
                    pos = x.val;
                } else {
                    pos += 1;
                    f[1] = x.val;
                }
                end = pos;
                if (type == TYPE_O) {
                    for (int q = 0; q < 4; q++) f[7 + q] = x.pp->p[q];
                    if (x.has_bl1()) {
                        f[2] = x.bl1;
                        f[4] = 1.0;
                    }
                } else if (type != TYPE_N) {
                    // the tuple's lengths in order: (c, v[, bl1][, bl2])
                    double bls[2];
                    int nb = 0;
                    if (x.has_bl1()) bls[nb++] = x.bl1;
                    if (x.has_bl2()) bls[nb++] = x.bl2;
                    if (nb >= 1) {
                        f[2] = bls[0];
                        f[4] = 1.0;
                    }
                    if (nb >= 2) {
                        f[3] = bls[1];
                        f[5] = 1.0;
                    }
                }
            }
            f[0] = type;
            f[11] = end;
            f[12] = prev;
            f[13] = rate_at(end);
            prev = end;
            double *e = base + b * es;
            for (int q = 0; q < F; q++) e[q * fs] = f[q];
        }
    }
    return 0;
}

}  // extern "C"
