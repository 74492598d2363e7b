// k edge-disjoint shortest paths (KSP) for a batch of jobs, for Hopper
// (sm_90a): the two device steps of one KSP round.
//
// Replaces the jitted XLA function of the JAX package
// openr_tpu/ops/ksp.py:57 _ksp_edge_disjoint_dense_jit (k rounds of a
// masked batched SSSP to fixpoint, capped at V sweeps, then a back-walk per
// job that bans the walked links, with an early exit when a round finds
// nothing). The host enqueues every round without reading anything back
// (ops/ksp.py): per round, one ksp_sssp_kernel launch runs the SSSP to its
// fixpoint, then one ksp_walk_kernel launch walks every job. A device word
// per round carries the early exit: the walk of round i sets round i+1's
// word when some job found its path, and both kernels of a round whose word
// is clear return at once.
//
// Tables: the dense in-neighbor tables nbr/wgt [V, D] (padding slots have
// wgt == INF), blocked [V, D] (the in-neighbor may not carry transit), and
// the per-job ban mask packed as bits: bans [V, D, NW] uint32 words,
// NW = ceil(B / 32), bit b % 32 of word b / 32 for job b. The JAX kernel
// keeps [V, D, B] bools; the bits cut the mask eightfold, and 32 jobs share
// a word.
//
// ksp_sssp_kernel: the masked SSSP to fixpoint in one cooperative launch,
// updating dist in place (Gauss-Seidel):
//
//   acc = min over d of  min(dist[nbr[v,d], b] + wgt[v,d], INF)
//         skipping slots with wgt >= INF, blocked, banned for b, or an
//         INF gather
//   dist[v, b] = min(acc, dist[v, b])
//
// Every value dist holds is an upper bound of the masked distance and
// values only fall, so any order of these updates, and any read that races
// a write, reaches the same fixpoint; the distances there are unique, so
// the walk's paths, costs and bans are the plain version's. The kernel runs
// grid passes separated by a grid-wide barrier (this_grid().sync()) until a
// pass in which no block lowered anything, or max_sweeps passes (V, as the
// reference caps it, a cap that never binds: metrics are >= 1). Where a cap
// binds, each entry lies between the fixpoint and the plain loop's value
// after as many Jacobi sweeps: pass p is at least the Jacobi sweep p over
// values at least as low. The kernel adds its passes to a device counter
// (counters[1]); the plain version counts Jacobi sweeps, as the JAX package
// does, and a pass does at least one sweep's work, so passes <= sweeps.
// One Jacobi sweep from one buffer into another (ksp_relax: dist_in !=
// dist_out) is a single pass with every word active.
//
// The changed flag lives on the device, in three words used in rotation:
// pass s sets flags[s % 3], every thread reads it after the barrier that
// ends pass s, and block 0 clears flags[(s + 1) % 3] during pass s. That
// word was last read after the barrier ending pass s - 2, and every thread
// has passed the barrier ending pass s - 1 before block 0 starts pass s,
// so every read of it is done; the clear lands before the barrier ending
// pass s, so before any write of pass s + 1. With two words and one
// barrier, the word cleared during pass s would be the one a slower block
// may still be reading after the barrier ending pass s - 1: it could see
// the clear, leave the loop, and strand the rest of the grid at the next
// barrier.
//
// Bound on this card: the barriers, not the bytes. The least any fixpoint
// could cost is small: the tables read once, the result written once, and
// one relaxation of each usable slot out of each reachable entry
// (chip_smoke.py ksp_sssp_work, 5.4 us at config 4's 10 016 nodes). A
// change moves about one hop a pass, and config 4's backbone (a ring of
// 626 site rings) needs ~330 of them from bb1, each behind a grid
// barrier; the design before this one (Jacobi sweeps between two buffers)
// spent ~15 us a sweep on the barrier, a scan of every row's change bytes
// and a write of every row. So a pass now does only what a fall makes
// necessary:
//
// * in place: no second buffer, no copy, and a row word that did not
//   fall is not written;
// * the change-word skip by stamps: a (row, job word) is relaxed again
//   only when one of its in-neighbours' words fell since the row last
//   read it. A stamp per row and word holds the pass that last wrote a
//   fall (stamp[V, NW]; pass 0 writes every stamp, -1 where nothing
//   fell). Pass s relaxes a word whose in-neighbours hold a stamp >= s - 1:
//   a fall written during pass s - 1 may have landed after the row's read
//   in that pass, and one written in pass s - 2 or before was visible at
//   the start of pass s - 1, whose stamp rule relaxed the row then. The
//   row's own fall needs no new relax: its in-neighbours are as they
//   were. (ops/ksp.py ksp_sssp_passes_ref models the passes on the CPU
//   under the schedule that leans hardest on the rule, every read taken
//   at the pass's start; ">= s" fails there.)
//
// A local fixpoint per block between barriers cut config 4's passes from
// 329 to 42 but ran slower than Jacobi sweeps (PERF.md section 6, K3), so
// a pass is one relaxation of each row. A warp relaxes a row, its lanes
// over 32 jobs of a ban word, so each gather reads 128 consecutive bytes
// of one dist row past L1 (ld.global.cg: other SMs rewrite dist during a
// pass, and L1 is not coherent); 8 gathers per lane are issued before the
// first min (4 job words x 2 slots, 2 x 4 at two words, 1 x 8 at one),
// which keeps the kernel in 64 registers, two blocks of 512 threads per
// SM. Two table residencies, chosen by shape in sssp_plan
// (openr_ksp_sssp_plan reports the choice):
//
// * resident, where one SM's share of the rows (all D slots with their ban
//   words) fits in 96 KiB of shared memory and the card holds a warp per
//   row (config 4 at 1k nodes; see sssp_plan): each block copies its fixed
//   tile of rows into shared memory
//   once per launch, compacted to the usable slots (finite weight, not
//   blocked) with their ban words, so every pass reads only stamps and
//   dist, which sit in L2.
// * streamed, elsewhere (config 4 at 10k nodes; the 100k graph's tables
//   at D = 64): a warp stages a row's usable slots with their ban words in its
//   shared memory once per pass, for all of the row's job words, then
//   gathers as above. A warp's staging holds up to `stage` slots: the
//   whole row where (2 + NW) * D * 4 bytes a warp leave two blocks an SM,
//   else the most 32-slot chunks that do. Tables wider than that (a hub
//   with hundreds of in-neighbors) take the wide twin (kWide), which
//   stages and relaxes every row chunk by chunk, the running min carried
//   across its chunks in registers, so any D launches.

// ksp_walk_kernel: one warp per job. From dest toward root, at each hop the
// smallest in-neighbor id p with a usable slot (not blocked, not banned for
// the job, wgt < INF, dist[p] < INF) and dist[p] + wgt == dist[cur]; it bans
// every parallel slot of the link in both directions (row cur where nbr ==
// p, row p where nbr == cur) with atomicOr, since jobs share ban words and
// each touches only its own bit. Each lane takes one slot of the row (a
// loop over 32-slot chunks where D > 32): it loads the slot and the job's
// ban word (past L1, ld.global.cg: other warps' atomics change the words),
// gathers dist[p, b], tests the slot, and the warp takes the smallest id
// with __reduce_min_sync. The reverse ban's scan of row p loads the row
// that the next hop relaxes, so its first 32 slots stay in registers for
// that hop: about two dependent L2 round trips per hop (the slot's gather
// and ban word together; then the next row), where the thread-per-job
// design spent two per slot. Bound: those round trips, hop after hop; the
// bytes are a few rows per hop. Distances fall strictly along a walk
// (metrics >= 1), so a serial walk per job gives the reference's lock-step
// walk, reordered across jobs only: a job's bans touch only rows whose
// dist is at or above the current one, which its walk has left, so no job
// reads a bit it sets later. Paths, costs, hops and bans are the same. A
// walk that fails (no predecessor, or max_hops reached) keeps the bans it
// set, clears its path, and reports cost INF and 0 hops, as the reference
// does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kInf = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSsspThreads = 512;
constexpr int kSsspWarps = kSsspThreads / 32;
constexpr int kResidentSmBytes = 96 * 1024;
constexpr int kStageBytes = 96 * 1024;  // a block's staging: two an SM
constexpr int kMaxBlocksPerSm = 2;  // 64 registers a thread
constexpr int kMaxSmem = 227 * 1024;  // a block's dynamic shared memory
constexpr int kWalkThreads = 64;
constexpr int kMaxDevices = 16;

struct SsspArgs {
  const int* din;  // read: == dout in place (the fixpoint); else one pass
  int* dout;       // holds the result at exit
  const int* nbr;
  const int* wgt;
  const uint8_t* blocked;
  const unsigned* bans;
  const int* live;  // null, or the round's word: clear = return at once
  int* counters;    // null, or [rounds, passes]; passes += this launch's
  int* changed;     // null, or set to the last pass's flag
  int* flags;       // [3], zero at launch
  int* stamp;       // [V, NW]: the pass of each word's last fall (scratch)
  int root;         // >= 0: dout starts INF with row `root` 0
  int V, D, B, NW, max_passes;
  int tile_rows;  // resident: rows per block; 0: streamed
  int stage;      // streamed: slots a warp stages at a time
};

__host__ __device__ inline long long tile_bytes(long long rows, int D,
                                                int NW) {
  return 4 * (rows + 1) + rows * D * (8LL + 4LL * NW);
}

// A row's usable slots in shared memory, compacted, with their ban words.
struct RowSlots {
  const int* nbr;
  const int* wgt;
  const unsigned* ban;  // [n, NW]
};

__device__ __forceinline__ int stage_row(const SsspArgs& a, int row,
                                         int d_begin, int d_end, int lane,
                                         int* nbr, int* wgt, unsigned* ban);

// A row's usable slots, all in shared memory: the block's tile (resident),
// or the warp's staging where it holds the whole row (streamed).
struct TileRow {
  RowSlots sl;
  int n;
  __device__ int chunks() const { return 1; }
  __device__ int get(int, RowSlots& out) const {
    out = sl;
    return n;
  }
};

// kWide, a row wider than the staging: its slots in chunks of a.stage,
// staged into the warp's buffer on demand (the chunk staged last is not
// staged again).
struct StagedRow {
  const SsspArgs& a;
  int row, lane;
  int* nbr;
  int* wgt;
  unsigned* ban;
  int staged, n;
  __device__ int chunks() const { return (a.D + a.stage - 1) / a.stage; }
  __device__ int get(int c, RowSlots& out) {
    if (c != staged) {
      __syncwarp();  // every lane is done with the chunk staged before
      n = stage_row(a, row, c * a.stage, min(a.D, (c + 1) * a.stage), lane,
                    nbr, wgt, ban);
      __syncwarp();
      staged = c;
    }
    out = RowSlots{nbr, wgt, ban};
    return n;
  }
};

// The job words of global row `g` that fell in pass s - 1 or later (bit
// w % 32 for word w; every word in pass 0).
__device__ __forceinline__ unsigned stamped(const SsspArgs& a, int g, int s,
                                            int w) {
  return s == 0 || __ldcg(a.stamp + (size_t)g * a.NW + w) >= s - 1;
}

// Which of `row`'s job words pass s relaxes (bit w % 32 for word w): those
// with an in-neighbour word stamped in pass s - 1 or later. The warp's
// lanes load a chunk's n x NW stamps together.
template <class Row>
__device__ __forceinline__ unsigned active_words(const SsspArgs& a, Row& src,
                                                 int lane, int s) {
  if (s == 0 || a.din != a.dout) return kFull;  // every word
  unsigned m = 0;
  for (int c = 0; c < src.chunks(); ++c) {
    RowSlots sl;
    const int n = src.get(c, sl);
    for (int i = lane; i < n * a.NW; i += 32) {
      const int j = i / a.NW, w = i - j * a.NW;
      if (stamped(a, sl.nbr[j], s, w)) m |= 1u << (w & 31);
    }
  }
  return __reduce_or_sync(kFull, m);
}

// One update of `row`'s active job words from a.din into a.dout: the
// warp's lanes take the 32 jobs of a ban word, WU words at a time, and the
// gathers of SU slots for all WU words go out before the first min;
// weights and ban words are read from shared memory at the min. A slot
// index past the chunk's end is clamped to its last slot: min is
// idempotent. Stamps each word that fell with s (and, in pass 0, the
// others with -1).
template <int WU, int SU, class Row>
__device__ __forceinline__ bool relax_row(const SsspArgs& a, Row& src,
                                          int row, int lane, int s) {
  const unsigned act = active_words(a, src, lane, s);
  bool lowered = false;
  const size_t base = (size_t)row * a.B;
  for (int w0 = 0; w0 < a.NW; w0 += WU) {
    bool any = false;
#pragma unroll
    for (int u = 0; u < WU; ++u)
      any |= w0 + u < a.NW && ((act >> ((w0 + u) & 31)) & 1u);
    if (!any) continue;
    int acc[WU], old[WU];
    bool job[WU];
#pragma unroll
    for (int u = 0; u < WU; ++u) {
      const int b = (w0 + u) * 32 + lane;
      job[u] = w0 + u < a.NW && b < a.B;
      acc[u] = kInf;
      old[u] = job[u] ? __ldcg(a.din + base + b) : kInf;
    }
    for (int c = 0; c < src.chunks(); ++c) {
      RowSlots sl;
      const int n = src.get(c, sl);
      for (int j0 = 0; j0 < n; j0 += SU) {
        int g[WU][SU];
#pragma unroll
        for (int t = 0; t < SU; ++t) {
          const size_t p = (size_t)sl.nbr[min(j0 + t, n - 1)] * a.B;
#pragma unroll
          for (int u = 0; u < WU; ++u)
            g[u][t] = job[u] ? __ldcg(a.din + p + (w0 + u) * 32 + lane) : kInf;
        }
#pragma unroll
        for (int t = 0; t < SU; ++t) {
          const int j = min(j0 + t, n - 1);
          const int w = sl.wgt[j];
#pragma unroll
          for (int u = 0; u < WU; ++u) {
            const bool banned =
                w0 + u < a.NW && ((sl.ban[j * a.NW + w0 + u] >> lane) & 1u);
            if (!banned && g[u][t] < kInf)
              acc[u] = min(acc[u], min(g[u][t] + w, kInf));
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < WU; ++u) {
      const int nv = min(acc[u], old[u]);
      if (job[u] && (nv < old[u] || a.din != a.dout))
        __stcg(a.dout + base + (w0 + u) * 32 + lane, nv);
      const bool fell = __any_sync(kFull, job[u] && nv < old[u]);
      if (lane == 0 && w0 + u < a.NW && (fell || s == 0))
        a.stamp[(size_t)row * a.NW + w0 + u] = fell ? s : -1;
      lowered |= fell;
    }
  }
  return lowered;
}

// Eight gathers in flight per lane, spread over the job words a row has
// (sixteen spill at 64 registers, two blocks of 512 threads per SM).
template <class Row>
__device__ __forceinline__ bool relax_row_any(const SsspArgs& a, Row& src,
                                              int row, int lane, int s) {
  if (a.NW == 1) return relax_row<1, 8>(a, src, row, lane, s);
  if (a.NW == 2) return relax_row<2, 4>(a, src, row, lane, s);
  return relax_row<4, 2>(a, src, row, lane, s);
}

// Lane `lane`'s slot d0 + lane of `row`: usable (finite weight, not
// blocked), its in-neighbor and weight.
__device__ __forceinline__ bool load_slot(const SsspArgs& a, int row, int d,
                                          int& p, int& w) {
  if (d >= a.D) return false;
  const size_t i = (size_t)row * a.D + d;
  w = __ldg(a.wgt + i);
  p = __ldg(a.nbr + i);
  return w < kInf && !__ldg(a.blocked + i);
}

// Copy the usable slots among `row`'s slots [d_begin, d_end), compacted,
// with their ban words to nbr / wgt / ban [n, NW]; returns n. The warp's
// lanes take 32 slots at a time.
__device__ __forceinline__ int stage_row(const SsspArgs& a, int row,
                                         int d_begin, int d_end, int lane,
                                         int* nbr, int* wgt, unsigned* ban) {
  int n = 0;
  for (int d0 = d_begin; d0 < d_end; d0 += 32) {
    int p = 0, w = 0;
    const bool ok = d0 + lane < d_end && load_slot(a, row, d0 + lane, p, w);
    const unsigned m = __ballot_sync(kFull, ok);
    if (ok) {
      const int j = n + __popc(m & ((1u << lane) - 1u));
      nbr[j] = p;
      wgt[j] = w;
      const unsigned* src = a.bans + ((size_t)row * a.D + d0 + lane) * a.NW;
      for (int x = 0; x < a.NW; ++x) ban[(size_t)j * a.NW + x] = __ldg(src + x);
    }
    n += __popc(m);
  }
  return n;
}

// Resident mode: copy the block's rows [r0, r0 + nrows) into shared
// memory, compacted to the usable slots. Layout: start [tile_rows + 1],
// nbr [cap], wgt [cap], ban [cap, NW], cap = tile_rows * D.
__device__ void build_tile(const SsspArgs& a, int* smem, int r0, int nrows,
                           int lane, int warp) {
  const int cap = a.tile_rows * a.D;
  int* start = smem;
  int* s_nbr = start + a.tile_rows + 1;
  int* s_wgt = s_nbr + cap;
  unsigned* s_ban = (unsigned*)(s_wgt + cap);
  for (int r = warp; r < nrows; r += kSsspWarps) {  // usable slots per row
    int cnt = 0;
    for (int d0 = 0; d0 < a.D; d0 += 32) {
      int p, w;
      cnt += __popc(__ballot_sync(kFull, load_slot(a, r0 + r, d0 + lane,
                                                   p, w)));
    }
    if (lane == 0) start[r + 1] = cnt;
  }
  if (threadIdx.x == 0) start[0] = 0;
  __syncthreads();
  if (warp == 0) {  // inclusive scan of the counts, 32 rows at a time
    int carry = 0;
    for (int c = 0; c < nrows; c += 32) {
      const int i = c + lane;
      int v = i < nrows ? start[i + 1] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v += t;
      }
      if (i < nrows) start[i + 1] = carry + v;
      carry += __shfl_sync(kFull, v, 31);
    }
  }
  __syncthreads();
  for (int r = warp; r < nrows; r += kSsspWarps)
    stage_row(a, r0 + r, 0, a.D, lane, s_nbr + start[r], s_wgt + start[r],
              s_ban + (size_t)start[r] * a.NW);
  __syncthreads();
}

// kWide: the streamed kernel for tables wider than the staging, every row
// staged in chunks. A kernel of its own, so that the chunk loops leave the
// registers of the common kernel as they are (inlined into it, they made it
// spill in every row's loop: a streamed sweep 5-20% slower on an H100).
template <bool kWide>
__global__ void __launch_bounds__(kSsspThreads, kMaxBlocksPerSm)
    ksp_sssp_kernel(const SsspArgs a) {
  if (a.live != nullptr && __ldcg(a.live) == 0) return;  // the whole grid
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool resident = a.tile_rows > 0;
  const int r0 = blockIdx.x * a.tile_rows;
  const int nrows = resident ? max(0, min(a.V - r0, a.tile_rows)) : 0;
  if (resident) build_tile(a, smem, r0, nrows, lane, warp);
  const size_t n_dist = (size_t)a.V * a.B;
  const size_t tid = (size_t)blockIdx.x * kSsspThreads + threadIdx.x;
  const size_t n_threads = (size_t)gridDim.x * kSsspThreads;
  if (a.root >= 0) {
    for (size_t i = tid; i < n_dist; i += n_threads)
      __stcg(a.dout + i, (int)(i / a.B) == a.root ? 0 : kInf);
    grid.sync();
  }
  const int cap = a.tile_rows * a.D;
  const int* start = smem;
  const int* s_nbr = start + a.tile_rows + 1;
  const int* s_wgt = s_nbr + cap;
  const unsigned* s_ban = (const unsigned*)(s_wgt + cap);
  int* st_nbr = smem + warp * (2 + a.NW) * a.stage;  // streamed: this
  int* st_wgt = st_nbr + a.stage;                    // warp's staging
  unsigned* st_ban = (unsigned*)(st_wgt + a.stage);
  int s = 0;
  bool changed = false;
  while (s < a.max_passes) {
    if (blockIdx.x == 0 && threadIdx.x == 0) a.flags[(s + 1) % 3] = 0;
    bool lowered = false;
    if (resident) {
      for (int r = warp; r < nrows; r += kSsspWarps) {
        const int j = start[r];
        TileRow src{RowSlots{s_nbr + j, s_wgt + j, s_ban + (size_t)j * a.NW},
                    start[r + 1] - j};
        lowered |= relax_row_any(a, src, r0 + r, lane, s);
      }
    } else {
      for (int row = blockIdx.x * kSsspWarps + warp; row < a.V;
           row += gridDim.x * kSsspWarps) {
        if (kWide) {
          StagedRow src{a, row, lane, st_nbr, st_wgt, st_ban, -1, 0};
          lowered |= relax_row_any(a, src, row, lane, s);
        } else {  // the whole row staged at once
          __syncwarp();  // every lane is done with the last row's staging
          const int n = stage_row(a, row, 0, a.D, lane, st_nbr, st_wgt,
                                  st_ban);
          __syncwarp();
          TileRow src{RowSlots{st_nbr, st_wgt, st_ban}, n};
          lowered |= relax_row_any(a, src, row, lane, s);
        }
      }
    }
    if (lowered && lane == 0) a.flags[s % 3] = 1;  // warp-uniform
    grid.sync();
    changed = __ldcg(a.flags + s % 3) != 0;
    ++s;
    if (!changed) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (a.counters != nullptr) a.counters[1] += s;
    if (a.changed != nullptr) *a.changed = changed ? 1 : 0;
  }
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
  const int* live;  // null, or the round's word: clear = return at once
  int* counters;    // null, or [rounds, sweeps]; rounds += 1 if it runs
  int root, V, D, B, NW, max_hops;
};

__global__ void __launch_bounds__(kWalkThreads) ksp_walk_kernel(const WalkArgs a) {
  if (a.live != nullptr && __ldcg(a.live) == 0) return;
  if (a.counters != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    a.counters[0] += 1;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (kWalkThreads / 32) + (threadIdx.x >> 5);
  if (b >= a.B) return;  // uniform across the warp
  const int L = a.max_hops + 1;
  int* prow = a.path + (size_t)b * L;  // filled with -1 by the caller
  const int dest = a.dests[b];
  const int c0 = __ldg(a.dist + (size_t)dest * a.B + b);
  if (c0 >= kInf || dest == a.root) {
    if (lane == 0) {
      a.cost[b] = kInf;
      a.hops[b] = 0;
    }
    return;
  }
  const int word = b >> 5;
  const unsigned bit = 1u << (b & 31);
  if (lane == 0) prow[0] = dest;
  // the first 32 slots of row cur, carried from the previous hop's scan
  int p0 = -1, w0 = kInf;
  bool u0 = false;
  if (lane < a.D) {
    const size_t i = (size_t)dest * a.D + lane;
    p0 = __ldg(a.nbr + i);
    w0 = __ldg(a.wgt + i);
    u0 = w0 < kInf && !__ldg(a.blocked + i);
  }
  int cur = dest, d_cur = c0, h = 0;
  bool alive = true, failed = false;
  while (alive && h < a.max_hops) {
    const size_t row = (size_t)cur * a.D;
    int pred = a.V;  // sentinel: no predecessor
    for (int d0 = 0; d0 < a.D; d0 += 32) {
      const int d = d0 + lane;
      int p = p0, w = w0;
      bool usable = u0;
      if (d0 > 0) {
        usable = false;
        if (d < a.D) {
          p = __ldg(a.nbr + row + d);
          w = __ldg(a.wgt + row + d);
          usable = w < kInf && !__ldg(a.blocked + row + d);
        }
      }
      int cand = a.V;
      if (usable) {
        const unsigned bw = __ldcg(a.bans + (row + d) * a.NW + word);
        const int dp = __ldg(a.dist + (size_t)p * a.B + b);
        if (!(bw & bit) && dp < kInf && dp + w == d_cur) cand = p;
      }
      pred = min(pred, __reduce_min_sync(kFull, cand));
    }
    if (pred == a.V) {
      failed = true;
      break;
    }
    // ban pred->cur (row cur, slots nbr == pred) and cur->pred (row pred,
    // slots nbr == cur); row pred's first chunk is the next hop's
    const size_t prow_nbr = (size_t)pred * a.D;
    for (int d0 = 0; d0 < a.D; d0 += 32) {
      const int d = d0 + lane;
      if (d >= a.D) continue;
      const int pc = d0 == 0 ? p0 : __ldg(a.nbr + row + d);
      if (pc == pred) atomicOr(a.bans + (row + d) * a.NW + word, bit);
      const int pn = __ldg(a.nbr + prow_nbr + d);
      if (pn == cur) atomicOr(a.bans + (prow_nbr + d) * a.NW + word, bit);
      if (d0 == 0) {
        p0 = pn;
        w0 = __ldg(a.wgt + prow_nbr + d);
        u0 = w0 < kInf && !__ldg(a.blocked + prow_nbr + d);
      }
    }
    ++h;
    if (lane == 0) prow[h] = pred;
    d_cur = __ldg(a.dist + (size_t)pred * a.B + b);  // gathered above: L1
    cur = pred;
    alive = pred != a.root;
  }
  if (failed || alive) {  // no predecessor, or max_hops reached mid-walk
    __syncwarp();  // lane 0's path writes land before the clear
    for (int j = lane; j <= h; j += 32) prow[j] = -1;
    if (lane == 0) {
      a.cost[b] = kInf;
      a.hops[b] = 0;
    }
    return;
  }
  if (lane == 0) {
    a.cost[b] = c0;
    a.hops[b] = h;
    *a.any_ok = 1;
  }
}

struct Plan {
  int tile_rows;  // 0: streamed
  int grid;
  int smem;
  int stage;  // streamed: slots a warp stages at a time
  bool wide;  // streamed in chunks: ksp_sssp_kernel<true>
};

int sm_count() {
  static int sms[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  int n = dev < kMaxDevices ? sms[dev] : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
    if (dev < kMaxDevices) sms[dev] = n;
  }
  return n;
}

const void* sssp_fn(bool wide) {
  return wide ? (const void*)ksp_sssp_kernel<true>
              : (const void*)ksp_sssp_kernel<false>;
}

// The residency and grid of one launch. Resident iff one SM's share of the
// rows fits in kResidentSmBytes and the card holds a warp per row
// (measured: config 4's 2 048 padded rows run 4.56 us a pass resident, a
// warp a row; its 16 384, four rows a warp, 14.2 us resident and ~11.4
// streamed, where the staging of one row overlaps the next row's work);
// the grid is then as many blocks as can be
// resident together (at most kMaxBlocksPerSm per SM, and no more than one
// warp per row unless that tile would not fit: then fewer rows a block,
// some warps idle), each with its tile of rows. Streamed: a warp stages
// the whole row where a block's staging fits in kStageBytes, else the most
// 32-slot chunks that do (then ksp_sssp_kernel<true>); only B past ~3 500
// jobs (107 ban words a slot) leaves no room for one chunk, and the plan
// refuses it.
cudaError_t sssp_plan(int V, int D, int B, Plan* out) {
  static bool attr_set[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices || !attr_set[dev]) {
    for (bool wide : {false, true}) {
      cudaError_t err = cudaFuncSetAttribute(
          sssp_fn(wide), cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSmem);
      if (err != cudaSuccess) return err;
    }
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  const int sms = sm_count();
  const int NW = (B + 31) / 32;
  const long long want = ((long long)V + kSsspWarps - 1) / kSsspWarps;
  const long long share = ((long long)V + sms - 1) / sms;
  if (tile_bytes(share, D, NW) <= kResidentSmBytes &&
      V <= (long long)kMaxBlocksPerSm * sms * kSsspWarps) {
    for (int k = kMaxBlocksPerSm; k >= 1; --k) {
      long long grid = want < (long long)k * sms ? want : k * sms;
      long long rows = (V + grid - 1) / grid;
      if (tile_bytes(rows, D, NW) > kMaxSmem) {
        grid = V < (long long)k * sms ? V : k * sms;
        rows = (V + grid - 1) / grid;
      }
      const int smem = (int)tile_bytes(rows, D, NW);
      int per_sm = 0;
      cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ksp_sssp_kernel<false>, kSsspThreads, smem);
      if (err != cudaSuccess) return err;
      if ((long long)per_sm * sms >= grid) {
        *out = Plan{(int)rows, (int)grid, smem, 0, false};
        return cudaSuccess;
      }
    }
    return cudaErrorInvalidConfiguration;
  }
  const long long slot_bytes = (2LL + NW) * 4 * kSsspWarps;  // all warps
  const long long whole = (D + 31LL) / 32 * 32;
  long long stage = kStageBytes / slot_bytes / 32 * 32;
  if (stage > whole) stage = whole;
  if (stage < 32) stage = 32;
  const long long smem = stage * slot_bytes;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;  // B too wide to stage
  const bool wide = stage < D;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sssp_fn(wide), kSsspThreads, (int)smem);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const long long cap = (long long)per_sm * sms;
  *out = Plan{0, (int)(want < cap ? want : cap), (int)smem, (int)stage,
              wide};
  return cudaSuccess;
}

}  // namespace

// The plan of a launch at this shape: out[0] = rows per block (0:
// streamed), out[1] = blocks, out[2] = dynamic shared memory bytes, out[3]
// = slots a warp stages at a time (streamed; 0 resident).
extern "C" int openr_ksp_sssp_plan(int V, int D, int B, void* out) {
  Plan p{};
  cudaError_t err = sssp_plan(V, D, B, &p);
  if (err != cudaSuccess) return (int)err;
  int* o = (int*)out;
  o[0] = p.tile_rows;
  o[1] = p.grid;
  o[2] = p.smem;
  o[3] = p.stage;
  return 0;
}

// The masked SSSP: with dist_in == dist_out, to its fixpoint in place
// (at most max_sweeps grid passes; with root >= 0 from INF with row root
// at 0, else from the buffer's values); with two buffers, one Jacobi sweep
// from dist_in into dist_out (max_sweeps must be 1). `flags` is scratch of
// 16 + 4 * V * ceil(B / 32) bytes: 3 ints cleared here on the same stream,
// then from byte 16 the stamps, which need no set-up.
extern "C" int openr_ksp_sssp(void* dist_in, void* dist_out, const void* nbr,
                              const void* wgt, const void* blocked,
                              const void* bans, const void* live,
                              void* counters, void* changed, void* flags,
                              int root, int V, int D, int B, int max_sweeps,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(flags, 0, 3 * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (dist_in != dist_out && (max_sweeps != 1 || root >= 0))
    return (int)cudaErrorInvalidValue;
  if (V <= 0 || B <= 0 || max_sweeps <= 0) return 0;
  Plan p{};
  err = sssp_plan(V, D, B, &p);
  if (err != cudaSuccess) return (int)err;
  SsspArgs a;
  a.din = (const int*)dist_in;
  a.dout = (int*)dist_out;
  a.nbr = (const int*)nbr;
  a.wgt = (const int*)wgt;
  a.blocked = (const uint8_t*)blocked;
  a.bans = (const unsigned*)bans;
  a.live = (const int*)live;
  a.counters = (int*)counters;
  a.changed = (int*)changed;
  a.flags = (int*)flags;
  a.stamp = (int*)flags + 4;
  a.root = root;
  a.V = V;
  a.D = D;
  a.B = B;
  a.NW = (B + 31) / 32;
  a.max_passes = max_sweeps;
  a.tile_rows = p.tile_rows;
  a.stage = p.stage;
  void* args[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel(sssp_fn(p.wide), dim3(p.grid),
                                    dim3(kSsspThreads), args, (size_t)p.smem,
                                    s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One walk per job into this round's cost [B], path [B, max_hops+1] and
// hops [B]; sets *any_ok (cleared first) when some job found its path.
extern "C" int openr_ksp_walk(const void* dist, const void* nbr,
                              const void* wgt, const void* blocked,
                              void* bans, const void* dests, int root,
                              void* cost, void* path, void* hops,
                              void* any_ok, const void* live, void* counters,
                              int V, int D, int B, int max_hops,
                              void* stream) {
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
  a.live = (const int*)live;
  a.counters = (int*)counters;
  a.root = root;
  a.V = V;
  a.D = D;
  a.B = B;
  a.NW = (B + 31) / 32;
  a.max_hops = max_hops;
  constexpr int kJobsPerBlock = kWalkThreads / 32;
  const int blocks = (B + kJobsPerBlock - 1) / kJobsPerBlock;
  ksp_walk_kernel<<<blocks, kWalkThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* openr_ksp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
