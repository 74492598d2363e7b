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
// Design: one warp per segment. A prefix's slots are contiguous and few
// (two for a plain anycast pair), so the warp strides over them and
// reduces with warp intrinsics in three passes over the same slots: the
// max rank (__reduce_max_sync), then the local flag (__any_sync) and the
// min distance over the best (__reduce_min_sync), then the writes of the
// per-slot masks. No atomics, so the result is the same on every run.
//
// Bound on this card: bytes. Per slot it reads adv, rank (4 B each),
// known (1 B), gathers reach (1 B) and d_vec (4 B) and writes is_best and
// chosen (1 B each); per segment it reads indptr and writes best_r,
// min_igp (4 B each) and local (1 B). A few integer compares per slot are
// far below the card's integer rate. Most lanes of a warp idle on a
// two-slot segment; the kernel is small beside the host assembly around
// it, and a later design could give a warp several segments.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;

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

// r_eff of slot s; whether the slot is eligible and this node's own.
__device__ __forceinline__ int slot_rank(const ElectArgs& a, int s,
                                         bool* elig, bool* is_me) {
  const int v = a.adv[s];
  const bool kn = a.known[s] != 0;
  *is_me = kn && v == a.my_id;
  *elig = (kn && a.reach[v] != 0) || *is_me;
  return *elig ? a.rank[s] : -1;
}

__global__ void __launch_bounds__(kThreads) elect_seg_kernel(const ElectArgs a) {
  const int lane = threadIdx.x & 31;
  const long long m =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (m >= a.M) return;  // uniform across the warp
  const int lo = a.indptr[m], hi = a.indptr[m + 1];
  bool elig, is_me;

  int best = INT_MIN;
  for (int s = lo + lane; s < hi; s += 32)
    best = max(best, slot_rank(a, s, &elig, &is_me));
  best = __reduce_max_sync(kFull, best);

  int loc = 0, mn = INT_MAX;
  for (int s = lo + lane; s < hi; s += 32) {
    const bool b = slot_rank(a, s, &elig, &is_me) == best && elig;
    if (b && is_me) loc = 1;
    mn = min(mn, b ? a.d_vec[a.adv[s]] : kInf);
  }
  loc = __any_sync(kFull, loc);
  mn = __reduce_min_sync(kFull, mn);

  for (int s = lo + lane; s < hi; s += 32) {
    const bool b = slot_rank(a, s, &elig, &is_me) == best && elig;
    a.is_best[s] = b;
    a.chosen[s] = b && a.d_vec[a.adv[s]] == mn;
  }
  if (lane == 0) {
    a.best_r[m] = best;
    a.min_igp[m] = mn;
    a.local[m] = loc;
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
  const long long blocks = ((long long)M + kWarpsPerBlock - 1) / kWarpsPerBlock;
  elect_seg_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* openr_election_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
