// k edge-disjoint shortest paths (KSP) for a batch of jobs, for Hopper
// (sm_90a): the two device steps of one KSP round.
//
// Replaces the jitted XLA function of the JAX package
// openr_tpu/ops/ksp.py:57 _ksp_edge_disjoint_dense_jit (k rounds of a
// masked batched SSSP to fixpoint, then a back-walk per job that bans the
// walked links). The round loop stays on the host (ops/ksp.py): per round,
// ksp_relax_kernel is launched until its changed flag stays clear, then
// ksp_walk_kernel walks every job once, and one read of its "any job ok"
// flag decides the early exit.
//
// Tables: the dense in-neighbor tables nbr/wgt [V, D] (padding slots have
// wgt == INF), blocked [V, D] (the in-neighbor may not carry transit), and
// the per-job ban mask packed as bits: bans [V, D, NW] uint32 words,
// NW = ceil(B / 32), bit b % 32 of word b / 32 for job b. The JAX kernel
// keeps [V, D, B] bools; the bits cut the mask eightfold, and several jobs
// share a word.
//
// ksp_relax_kernel: one Jacobi sweep, one thread per (row v, job b). A
// warp holds one row and 32 jobs (one ban word), its lanes over the jobs,
// so its gathers of dist_in[nbr[v, d], b] read consecutive ints of one
// dist row. The warp loads 32 slots of the row at once (nbr, wgt,
// blocked, and the ban word of its jobs), then walks only the usable
// ones, each broadcast with shuffles: padding and blocked slots cost no
// gather and no loop trip (a row of the 100k graph's dense table holds
// ~17 valid slots of 64). Each lane tests its own job's bit before its
// gather:
//
//   acc = min over d of  min(dist_in[nbr[v,d], b] + wgt[v,d], INF)
//         skipping slots with wgt >= INF, blocked, banned for b, or an
//         INF gather
//   dist_out[v, b] = min(acc, dist_in[v, b]);  *changed = 1 if lower
//
// Jacobi (read dist_in, write dist_out) rather than in-place, so one sweep
// equals the plain version exactly; the fixpoint, and so every path the
// walk reads from it, is the same either way. The flag is written once
// per warp that lowered a value.
//
// ksp_walk_kernel: one thread per job. From dest toward root, at each hop
// the smallest in-neighbor id p with a usable slot (not blocked, not
// banned for the job, wgt < INF, dist[p] < INF) and dist[p] + wgt ==
// dist[cur]; it bans every parallel slot of the link in both directions
// (row cur where nbr == p, row p where nbr == cur) with atomicOr, since
// jobs share ban words and each touches only its own bit. Distances fall
// strictly along a walk (metrics >= 1), so a serial walk per job gives
// the reference's lock-step walk, reordered across jobs only, and the
// same paths, costs, hops and bans. A walk that fails (no predecessor, or
// max_hops reached) keeps the bans it set, clears its path, and reports
// cost INF and 0 hops, as the reference does.
//
// Bound on this card: bytes. A sweep must read nbr, wgt (4 B per slot),
// blocked (1 B per slot), the ban words (4 B per slot and word) and each
// dist row once, and write dist_out; a few integer ops per slot and job
// are far below the integer rate. The walk moves little (a few rows per
// hop per job) and is bound by its dependent loads, one hop after
// another.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRelaxWarps = 8;
constexpr int kRelaxThreads = 32 * kRelaxWarps;
constexpr int kWalkThreads = 64;

struct RelaxArgs {
  const int* dist_in;
  int* dist_out;
  const int* nbr;
  const int* wgt;
  const uint8_t* blocked;
  const unsigned* bans;
  int* changed;
  int V, D, B, NW;
};

__global__ void __launch_bounds__(kRelaxThreads)
    ksp_relax_kernel(const RelaxArgs a) {
  const int lane = threadIdx.x & 31;
  const long long w_id =
      (long long)blockIdx.x * kRelaxWarps + (threadIdx.x >> 5);
  if (w_id >= (long long)a.V * a.NW) return;  // uniform across the warp
  const int v = (int)(w_id / a.NW);
  const int b0 = (int)(w_id - (long long)v * a.NW) * 32;
  const size_t row = (size_t)v * a.D;
  const int b = b0 + lane;  // this lane's job: bit `lane` of word b0/32
  const bool job = b < a.B;
  int acc = kInf;
  for (int d0 = 0; d0 < a.D; d0 += 32) {
    // lane l loads slot d0 + l; the usable slots are then walked one by
    // one, their fields broadcast with shuffles
    const int d = d0 + lane;
    int w = kInf, p = 0;
    unsigned ban = 0;
    bool slot_ok = false;
    if (d < a.D) {
      w = __ldg(a.wgt + row + d);
      p = __ldg(a.nbr + row + d);
      slot_ok = w < kInf && !__ldg(a.blocked + row + d);
      if (slot_ok) ban = __ldg(a.bans + (row + d) * a.NW + (b0 >> 5));
    }
    unsigned todo = __ballot_sync(kFull, slot_ok);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int pj = __shfl_sync(kFull, p, j);
      const int wj = __shfl_sync(kFull, w, j);
      const unsigned banj = __shfl_sync(kFull, ban, j);
      if (job && !((banj >> lane) & 1u)) {
        const int g = __ldg(a.dist_in + (size_t)pj * a.B + b);
        if (g < kInf) acc = min(acc, min(g + wj, kInf));
      }
    }
  }
  bool lowered = false;
  if (job) {
    const size_t i = (size_t)v * a.B + b;
    const int old = a.dist_in[i];
    const int nw = min(acc, old);
    a.dist_out[i] = nw;
    lowered = nw < old;
  }
  if (__ballot_sync(kFull, lowered) && lane == 0) *a.changed = 1;
}

struct WalkArgs {
  const int* dist;
  const int* nbr;
  const int* wgt;
  const uint8_t* blocked;
  unsigned* bans;
  const int* dests;
  int* cost;
  int* path;
  int* hops;
  int* any_ok;
  int root, V, D, B, NW, max_hops;
};

// Ban job b's bit on every slot of row `row` whose in-neighbor is `other`.
__device__ __forceinline__ void ban_link(const WalkArgs& a, int row, int other,
                                         int word, unsigned bit) {
  const size_t base = (size_t)row * a.D;
  for (int d = 0; d < a.D; ++d)
    if (a.nbr[base + d] == other)
      atomicOr(a.bans + (base + d) * a.NW + word, bit);
}

__global__ void __launch_bounds__(kWalkThreads) ksp_walk_kernel(const WalkArgs a) {
  const int b = blockIdx.x * kWalkThreads + threadIdx.x;
  if (b >= a.B) return;
  const int L = a.max_hops + 1;
  int* prow = a.path + (size_t)b * L;  // filled with -1 by the caller
  const int dest = a.dests[b];
  const int c0 = a.dist[(size_t)dest * a.B + b];
  if (c0 >= kInf || dest == a.root) {
    a.cost[b] = kInf;
    a.hops[b] = 0;
    return;
  }
  const int word = b >> 5;
  const unsigned bit = 1u << (b & 31);
  prow[0] = dest;
  int cur = dest, h = 0;
  bool alive = true, failed = false;
  while (alive && h < a.max_hops) {
    const size_t row = (size_t)cur * a.D;
    const int d_cur = a.dist[(size_t)cur * a.B + b];
    int pred = a.V;  // sentinel: no predecessor
#pragma unroll 4
    for (int d = 0; d < a.D; ++d) {
      const int w = a.wgt[row + d];
      const int p = a.nbr[row + d];
      // the ban words change under this kernel's atomics: read them past L1
      const bool usable = w < kInf && !a.blocked[row + d] &&
                          !(__ldcg(a.bans + (row + d) * a.NW + word) & bit);
      const int dp = usable ? a.dist[(size_t)p * a.B + b] : kInf;
      if (dp < kInf && dp + w == d_cur) pred = min(pred, p);
    }
    if (pred == a.V) {
      failed = true;
      break;
    }
    ban_link(a, cur, pred, word, bit);
    ban_link(a, pred, cur, word, bit);
    prow[++h] = pred;
    cur = pred;
    alive = pred != a.root;
  }
  if (failed || alive) {  // no predecessor, or max_hops reached mid-walk
    for (int j = 0; j <= h; ++j) prow[j] = -1;
    a.cost[b] = kInf;
    a.hops[b] = 0;
    return;
  }
  a.cost[b] = c0;
  a.hops[b] = h;
  *a.any_ok = 1;
}

}  // namespace

// One Jacobi sweep of the masked relax over all rows; clears *changed
// first, on the same stream.
extern "C" int openr_ksp_relax(const void* dist_in, void* dist_out,
                               const void* nbr, const void* wgt,
                               const void* blocked, const void* bans,
                               void* changed, int V, int D, int B,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (V <= 0 || B <= 0) return 0;
  RelaxArgs a;
  a.dist_in = (const int*)dist_in;
  a.dist_out = (int*)dist_out;
  a.nbr = (const int*)nbr;
  a.wgt = (const int*)wgt;
  a.blocked = (const uint8_t*)blocked;
  a.bans = (const unsigned*)bans;
  a.changed = (int*)changed;
  a.V = V;
  a.D = D;
  a.B = B;
  a.NW = (B + 31) / 32;
  const long long warps = (long long)V * a.NW;  // one per (row, 32 jobs)
  const long long blocks = (warps + kRelaxWarps - 1) / kRelaxWarps;
  ksp_relax_kernel<<<(unsigned)blocks, kRelaxThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// One walk per job into this round's cost [B], path [B, max_hops+1] and
// hops [B]; sets *any_ok (cleared first) when some job found its path.
extern "C" int openr_ksp_walk(const void* dist, const void* nbr,
                              const void* wgt, const void* blocked,
                              void* bans, const void* dests, int root,
                              void* cost, void* path, void* hops,
                              void* any_ok, int V, int D, int B,
                              int max_hops, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(any_ok, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0) return 0;
  WalkArgs a;
  a.dist = (const int*)dist;
  a.nbr = (const int*)nbr;
  a.wgt = (const int*)wgt;
  a.blocked = (const uint8_t*)blocked;
  a.bans = (unsigned*)bans;
  a.dests = (const int*)dests;
  a.cost = (int*)cost;
  a.path = (int*)path;
  a.hops = (int*)hops;
  a.any_ok = (int*)any_ok;
  a.root = root;
  a.V = V;
  a.D = D;
  a.B = B;
  a.NW = (B + 31) / 32;
  a.max_hops = max_hops;
  const int blocks = (B + kWalkThreads - 1) / kWalkThreads;
  ksp_walk_kernel<<<blocks, kWalkThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* openr_ksp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
