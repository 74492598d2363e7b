// Multi-advertiser (anycast ECMP) election, for Hopper (sm_90a).
//
// Replaces the jitted XLA function of the JAX package
// openr_tpu/ops/election.py:32 _elect_seg (called by elect_multi_device):
// segmented reductions over the CSR-sorted slots of the prefix->advertiser
// matrix, one segment per multi-advertiser prefix.
//
// For prefix m, owning slots s in [indptr[m], indptr[m+1]):
//
//   is_me[s]   = known[s] && adv[s] == my_id
//   elig[s]    = (known[s] && reach[adv[s]]) || is_me[s]
//   r_eff[s]   = elig[s] ? rank[s] : -1
//   best_r[m]  = max over s of r_eff[s]           (INT32_MIN if empty)
//   is_best[s] = elig[s] && r_eff[s] == best_r[m]
//   local[m]   = any s of is_best[s] && is_me[s]
//   d_adv[s]   = is_best[s] ? d_vec[adv[s]] : INF
//   min_igp[m] = min over s of d_adv[s]           (INT32_MAX if empty)
//   chosen[s]  = is_best[s] && d_adv[s] == min_igp[m]
//
// Design: a thread per segment, with a warp per segment for long ones. A
// prefix's slots are contiguous and few (two for a plain anycast pair),
// so thread m reads indptr[m], indptr[m+1], then issues the loads of all
// its slots' adv, rank and known at once (up to kShort slots, predicated),
// then the gathers of reach and d_vec, and reduces in registers: three
// dependent round trips to L2, then the writes. Every lane of a warp holds
// a segment of its own. A segment longer than kShort slots (a prefix with
// hundreds of advertisers) is left by its thread to the whole warp, which
// takes the warp's long segments one after another: lanes over slots, four
// slots a lane in flight, folded with __shfl_xor_sync, then a second pass
// over the same (cache-hot) slots for the per-slot writes, so any segment
// length stays exact. The reduction is one pass: (best rank, least
// distance among the slots at that rank, local) combines associatively and
// commutatively (`Best`), so no re-gather per step and no atomics; the
// result is the same on every run.
//
// Bound on this card: bytes. Per slot it reads adv, rank (4 B each),
// known (1 B), gathers reach (1 B) and d_vec (4 B) and writes is_best and
// chosen (1 B each); per segment it reads indptr and writes best_r,
// min_igp (4 B each) and local (1 B). A few integer compares per slot are
// far below the card's integer rate. At the port's sizes (10 000 to 25 000
// prefixes) the grid is under one wave, so the time is the latency of the
// three round trips and the launch, not the bytes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kShort = 8;  // longest segment a single thread elects
constexpr int kUnroll = 4;  // slots a lane loads at once on the warp path

struct ElectArgs {
  const int* indptr;
  const int* adv;
  const uint8_t* known;
  const int* rank;
  const int* d_vec;
  const uint8_t* reach;
  int* best_r;
  int* min_igp;
  uint8_t* is_best;
  uint8_t* chosen;
  uint8_t* local;
  int M, my_id;
};

// The election of a set of slots: the best rank r, the least d_adv over
// them (d_vec[adv] of an eligible slot at rank r, INF for every other
// slot), whether this node's own slot is among the best, and whether the
// set is non-empty.
struct Best {
  int r, d, l, n;
};

__device__ __forceinline__ Best empty_best() { return {INT_MIN, INT_MAX, 0, 0}; }

// The election of x and y together: the higher rank wins, and every slot
// of the losing side then counts INF in the min.
__device__ __forceinline__ Best combine(const Best& x, const Best& y) {
  if (!y.n) return x;
  if (!x.n) return y;
  if (x.r != y.r) {
    const Best& w = x.r > y.r ? x : y;
    return {w.r, min(w.d, kInf), w.l, 1};
  }
  return {x.r, min(x.d, y.d), x.l | y.l, 1};
}

// One slot's fields, read once: r_eff, d_vec[adv], eligible, own.
struct Slot {
  int r, dv;
  bool elig, me;
};

__device__ __forceinline__ Best slot_best(const Slot& q) {
  return {q.r, q.elig ? q.dv : kInf, q.elig && q.me, 1};
}

// The slot fields of [s0, s0 + count) (count <= N): the per-slot loads
// first, then the gathers through adv.
template <int N>
__device__ __forceinline__ void load_slots(const ElectArgs& a, int s0,
                                           int step, int count, Slot (&q)[N]) {
  int v[N], rk[N];
  bool kn[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int s = s0 + k * step;
    v[k] = 0;
    rk[k] = -1;
    kn[k] = false;
    if (k < count) {
      v[k] = a.adv[s];
      rk[k] = a.rank[s];
      kn[k] = a.known[s] != 0;
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    bool rc = false;
    int dv = kInf;
    if (k < count) {
      rc = a.reach[v[k]] != 0;
      dv = a.d_vec[v[k]];
    }
    q[k].me = kn[k] && v[k] == a.my_id;
    q[k].elig = (kn[k] && rc) || q[k].me;
    q[k].r = q[k].elig ? rk[k] : -1;
    q[k].dv = dv;
  }
}

template <int N>
__device__ __forceinline__ void write_slots(const ElectArgs& a, int s0,
                                            int step, int count,
                                            const Slot (&q)[N],
                                            const Best& b) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k >= count) continue;
    const bool best = q[k].elig && q[k].r == b.r;
    a.is_best[s0 + k * step] = best;
    a.chosen[s0 + k * step] = best && q[k].dv == b.d;
  }
}

__device__ __forceinline__ void write_segment(const ElectArgs& a, int m,
                                              const Best& b) {
  a.best_r[m] = b.n ? b.r : INT_MIN;
  a.min_igp[m] = b.n ? b.d : INT_MAX;
  a.local[m] = b.n ? b.l : 0;
}

__global__ void __launch_bounds__(kThreads) elect_seg_kernel(const ElectArgs a) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kThreads + threadIdx.x;
  int lo = 0, len = 0;
  if (m < a.M) {
    lo = a.indptr[m];
    len = a.indptr[m + 1] - lo;
  }
  if (m < a.M && len <= kShort) {  // a thread per segment
    Slot q[kShort];
    load_slots<kShort>(a, lo, 1, len, q);
    Best b = empty_best();
#pragma unroll
    for (int k = 0; k < kShort; ++k)
      if (k < len) b = combine(b, slot_best(q[k]));
    write_slots<kShort>(a, lo, 1, len, q, b);
    write_segment(a, m, b);
  }
  // the warp's long segments, one after another, by the whole warp
  unsigned longs = __ballot_sync(kFull, m < a.M && len > kShort);
  while (longs) {
    const int src = __ffs(longs) - 1;
    longs &= longs - 1;
    const int mm = __shfl_sync(kFull, m, src);
    const int s0 = __shfl_sync(kFull, lo, src);
    const int n = __shfl_sync(kFull, len, src);
    Best b = empty_best();
    for (int j = lane; j < n; j += 32 * kUnroll) {
      Slot q[kUnroll];
      load_slots<kUnroll>(a, s0 + j, 32, (n - j + 31) / 32, q);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (j + 32 * k < n) b = combine(b, slot_best(q[k]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const Best o = {__shfl_xor_sync(kFull, b.r, off),
                      __shfl_xor_sync(kFull, b.d, off),
                      __shfl_xor_sync(kFull, b.l, off),
                      __shfl_xor_sync(kFull, b.n, off)};
      b = combine(b, o);
    }
    for (int j = lane; j < n; j += 32 * kUnroll) {
      Slot q[kUnroll];
      load_slots<kUnroll>(a, s0 + j, 32, (n - j + 31) / 32, q);
      write_slots<kUnroll>(a, s0 + j, 32, (n - j + 31) / 32, q, b);
    }
    if (lane == 0) write_segment(a, mm, b);
  }
}

}  // namespace

extern "C" int openr_elect_seg(const void* indptr, int M, const void* adv,
                               const void* known, const void* rank,
                               const void* d_vec, const void* reach,
                               int my_id, void* best_r, void* min_igp,
                               void* is_best, void* chosen, void* local,
                               void* stream) {
  if (M <= 0) return 0;
  ElectArgs a;
  a.indptr = (const int*)indptr;
  a.adv = (const int*)adv;
  a.known = (const uint8_t*)known;
  a.rank = (const int*)rank;
  a.d_vec = (const int*)d_vec;
  a.reach = (const uint8_t*)reach;
  a.best_r = (int*)best_r;
  a.min_igp = (int*)min_igp;
  a.is_best = (uint8_t*)is_best;
  a.chosen = (uint8_t*)chosen;
  a.local = (uint8_t*)local;
  a.M = M;
  a.my_id = my_id;
  const long long blocks = ((long long)M + kThreads - 1) / kThreads;
  elect_seg_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* openr_election_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
