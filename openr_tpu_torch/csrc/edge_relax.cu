// Edge-list Bellman-Ford (the batched multi-root SSSP over the padded CSR
// edge list), for Hopper (sm_90a).
//
// Replaces the jitted XLA function of the JAX package
// openr_tpu/ops/spf.py:52 batched_sssp: an init, then Jacobi rounds of a
// gather of dist[edge_src], an add and a segment_min by edge_dst, to the
// fixpoint, at most V rounds. Two kernels, both cooperative launches:
//
// edge_init_kernel, the round-free start (the per-root exemption of an
// overloaded root): for each column b,
//
//   dist[v, b] = min(INF, min over edges e with src(e) == roots[b] and
//                          dst(e) == v of metric(e))   (blocked edges too)
//   dist[roots[b], b] = 0
//
// It writes INF over the whole [V, Bp] matrix with 16-byte stores, then,
// behind a grid barrier, a warp per column walks only its root's own
// out-edges: out_slot[out_start[r] .. out_start[r + 1]) lists the slots
// whose src is r (the walked slots sorted by src, built on the host once per
// table set, ops/edge_relax.py edge_out_index). It stores slot ids, not
// metrics, so metric patches written into the edge arrays stay visible.
// atomicMin merges parallel edges and repeated roots (each column its own
// cell). It marks, per column tile, the rows it set finite: the rows the
// first round has to gather from.
//
// edge_relax_kernel, every round to the fixpoint in one launch. Columns are
// independent SSSPs, so the B columns are cut into tiles of Bt (a power of
// two, 4 to 128: ops/edge_relax.py tile_cols), and the tiles run one after
// another, each with the whole grid. A round of a tile is
//
//   dist_out[v, b] = min(dist_in[v, b],
//                        min over edges e into v, not blocked, with
//                            d = dist_in[src(e), b] < INF
//                        of min(d + metric(e), INF))
//
// from one buffer into the other (Jacobi, so the round count is the
// reference's: a column in round r depends only on that column in round
// r - 1), and a tile stops at its first round that lowers nothing, or at
// max_rounds. The solve's count is the maximum over the tiles. A grid
// barrier ends each round; the host reads nothing until the launch ends.
// Every tile walks every edge slot once a round, so the tiles are as wide
// as a warp's row takes (128 columns): tiles of 32, whose slabs (V x 32 x 4
// bytes) stay in L2, made the solve slower at BASELINE config 3 on an H100,
// since the walk costs as much as the gathers it saves from DRAM
// (chip_smoke.py [10c] times each width).
//
// Skipping sources that did not change: a bit per row of the tile says
// "some column of this row fell in the last round" (for the first round:
// the init set it finite). A round gathers dist_in[u] only for the edges
// whose source u has its bit set. If u's row did not change in round r - 1,
// every candidate dist[u] + w was already taken in round r - 1, so the skip
// changes neither the fixpoint nor the round count. Rows with no changed
// in-neighbor and no change of their own keep their value, which both
// buffers already hold (each round leaves the whole state in its output
// buffer: a row is written when it changed in the last round, so that its
// output copy is current, or when it falls now; the first round of a tile
// writes every row). The bitmaps rotate through three arrays: round g reads
// bm[g % 3], sets bits in bm[(g + 1) % 3] and clears bm[(g + 2) % 3], which
// was last read in round g - 1 (before the barrier that ended it) and is
// next written in round g + 1 (after the barrier that ends this one). The
// changed flag rotates through three words the same way (csrc/ksp.cu).
//
// Threads: q = the tile's width / 4 lanes a row, a lane four columns (one
// 16-byte load), so a warp takes R = 32 / q rows at a time. The warp loads
// its rows' edge slots 32 at a time, lane l the l-th slot of their
// concatenation (consecutive rows' runs are consecutive in the dst-sorted
// arrays, so a load is one or two lines), tests each source's bit in the
// block's copy of the last round's bitmap (shared memory), and ballots;
// then each row's lanes walk the set bits that fall in their row, reading
// src and metric from the lane that loaded the slot. dist and the global
// bitmaps are rewritten by other SMs during the launch, so they are read
// with ld.cg (L2), never through L1 or the read-only path. A row's changed
// bit is set in the block's shared copy and merged into the global bitmap
// once a round, one atomic a nonzero word. The grid barrier is written out
// inline (an arrival count and a spin with backoff): the call into
// cooperative_groups' grid sync made ptxas spill around it.
//
// Runs longer than seg_edges (a hub's thousands of in-edges) are split on
// the host into segments, walked as items of their own (ops/edge_relax.py
// edge_segments): with a barrier every round, the longest run would
// otherwise set the pace of every round. A segment merges its minimum into
// dist_out with atomicMin; the first segment of the row also merges dist_in
// when the row changed in the last round. Those rows are INF in dist_out
// before the first round (the launch's prologue), and every merged value is
// at most dist_in, so the merge needs no order. The gathered edges are
// counted on the device, one atomic a block a launch.
//
// When the last round lowered nothing, both buffers hold the result; when a
// tile stopped at max_rounds with an even count, its result is in buf0 and
// the kernel copies the tile into buf1, so buf1 always holds it.
//
// The sharded edge solve (parallel/sharded_spf.py, the port of
// openr_tpu/parallel/sharded_spf.py:95's while_loop) runs one round a
// launch on each edge slice, its exchange and exit between launches:
// edge_relax_kernel<true> through openr_edge_round_guarded, capped at one
// round with every row changed, behind a guard on the loop's control block
// (ops/split_loop.py's layout: ctl[0] the phase). A launch after the row's
// exit reads that word once a thread and returns before the first grid
// barrier, so a block of K launches replays its done rounds as no-ops. It
// stays a cooperative launch: a live round's segments merge into rows that
// the prologue set to INF behind a grid barrier.
//
// INF-guarded adds: d < INF is tested before d + metric, and METRIC_MAX =
// 2^30 - 1, so the sum stays below 2^31.
//
// Bound on this card: a full round must read each walked edge's src,
// metric and blocked once (9 B) and each dist row and write it (2 x V x B x
// 4 B). What it takes is the gathers, a Bt x 4-byte row segment per usable
// edge and tile (2.25 GB a full round at BASELINE config 3), which the skip
// cuts to the edges whose source changed; in tiles of 128 they come from
// DRAM.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kInf = 1 << 30;
constexpr int kThreads = 1024;
constexpr int kUnroll = 2;  // gathers a lane issues at once
// the row bitmaps (the last round's, read, and this round's, set) live in
// shared memory up to this many words each (2 x 24 560 B: V up to
// 196 480), so that with the kernel's 8 static bytes they stay within the
// 48 KB a block gets without an opt-in; else in global memory
constexpr int kMaxBitWords = 6140;
constexpr unsigned kFull = 0xffffffffu;

struct InitArgs {
  int* dist;              // [V, Bp]
  const int* roots;       // [B]
  const int* out_start;   // [V + 1]
  const int* out_slot;    // [walked slots], sorted by src
  const int* dst;         // [E]
  const int* metric;      // [E]
  unsigned* marks;        // [ntiles, W]: rows set finite, per tile
  int V, B, Bp, Bt, W, ntiles;
};

// A grid-wide barrier for a cooperative launch (every block resident): a
// monotonic arrival count, zeroed before the launch; the k-th barrier waits
// for k x gridDim.x arrivals. Written out inline: the call into
// cooperative_groups' grid sync made ptxas spill the round's registers.
// The fences make every write before the barrier visible after it (the
// readers use ld.cg, so no stale L1 line serves them).
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned& k) {
  ++k;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    const unsigned target = k * gridDim.x;
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen) : "l"(count) : "memory");
      if ((int)(seen - target) < 0) __nanosleep(64);
    } while ((int)(seen - target) < 0);
    __threadfence();
  }
  __syncthreads();
}

struct FixArgs {
  int* buf0;               // [V, Bp]: the start on entry
  int* buf1;               // [V, Bp]: the result on exit
  const int* row_start;    // [V + 1]
  const int* src;          // [E]
  const int* metric;       // [E]
  const uint8_t* blocked;  // [E]
  const int* seg_node;     // [n_seg]
  const int* seg_lo;       // [n_seg]
  const unsigned* marks;   // [ntiles, W] (null: every row changed)
  unsigned* bm;            // [3, W], rotating
  int* flags;              // [3], rotating
  unsigned* arrivals;      // [1]: the grid barrier's count
  unsigned long long* stats;  // [3]: rounds, last round lowered, gathered
  const int* ctl;          // the guard's control block (GUARD only)
  int* changed;            // [1]: the last round lowered (null: not kept)
  int V, Bp, Bt, W, n_seg, seg_edges, max_rounds, phase_mask;
};

__device__ __forceinline__ int4 inf4() {
  return make_int4(kInf, kInf, kInf, kInf);
}

__device__ __forceinline__ int4 min4(int4 a, int4 b) {
  return make_int4(min(a.x, b.x), min(a.y, b.y), min(a.z, b.z),
                   min(a.w, b.w));
}

__device__ __forceinline__ bool less4(int4 a, int4 b) {
  return a.x < b.x || a.y < b.y || a.z < b.z || a.w < b.w;
}

__device__ __forceinline__ int relax1(int best, int d, int w) {
  return d < kInf ? min(best, min(d + w, kInf)) : best;
}

// Bit v of a row bitmap: in shared memory (staged), or in global memory,
// which other SMs rewrite during the launch (read through L2); null: set.
__device__ __forceinline__ bool bit_set(const unsigned* bm, bool staged,
                                        int v) {
  if (bm == nullptr) return true;
  const unsigned w = staged ? bm[v >> 5] : __ldcg(bm + (v >> 5));
  return (w >> (v & 31)) & 1u;
}

__global__ void __launch_bounds__(kThreads)
    edge_init_kernel(const InitArgs a) {
  cg::grid_group grid = cg::this_grid();
  const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t n_threads = (size_t)gridDim.x * kThreads;
  const size_t n4 = (size_t)a.V * a.Bp / 4;
  int4* d4 = reinterpret_cast<int4*>(a.dist);
  for (size_t i = tid; i < n4; i += n_threads) d4[i] = inf4();
  const size_t n_marks = (size_t)a.ntiles * a.W;
  for (size_t i = tid; i < n_marks; i += n_threads) a.marks[i] = 0;
  grid.sync();
  const int lane = threadIdx.x & 31;
  const size_t warp = tid >> 5, n_warps = n_threads >> 5;
  for (size_t b = warp; b < (size_t)a.B; b += n_warps) {
    const int r = __ldg(a.roots + b);
    unsigned* mk = a.marks + (b / a.Bt) * a.W;
    if (lane == 0) {
      atomicMin(a.dist + (size_t)r * a.Bp + b, 0);
      atomicOr(mk + (r >> 5), 1u << (r & 31));
    }
    const int hi = __ldg(a.out_start + r + 1);
    for (int k = __ldg(a.out_start + r) + lane; k < hi; k += 32) {
      const int e = __ldg(a.out_slot + k);
      const int w = __ldg(a.metric + e);
      if (w < kInf) {
        const int v = __ldg(a.dst + e);
        atomicMin(a.dist + (size_t)v * a.Bp + b, w);
        atomicOr(mk + (v >> 5), 1u << (v & 31));
      }
    }
  }
}

// A warp's share of one round: R = 32 / q consecutive work items, q lanes
// each (lane = k * q + c: item k, columns col .. col + 3 with col = c0 +
// 4c; lanes past R * q idle). An item is row v's edge slots [lo, hi): all
// of its run (split false; empty for a run walked as segments), or one
// segment of a long run. The warp loads its items' slots 32 at a time,
// lane l the l-th slot of their concatenation (consecutive rows' runs are
// consecutive, so each load is one or two lines), tests each source's bit,
// ballots, and then every lane walks the set bits of its own item, reading
// each slot's src and metric from the lane that loaded it. `bits` holds the
// rows that changed in the last round (null: all), in shared memory where
// `staged`. Returns whether the lane lowered a column; lane 0 adds the
// warp's gathered edges to `gathered`. The edge arrays come by value: a
// reference to the kernel's parameter would copy it to local memory.
__device__ __forceinline__ bool relax_items(
    const int* __restrict__ src, const int* __restrict__ metric,
    const uint8_t* __restrict__ blocked, int Bp, const int* din, int* dout,
    const unsigned* bits, bool staged, unsigned* bout, int q, int R,
    int lane, bool have, int v, int col, int lo, int hi, bool split,
    bool first, bool round0, unsigned& gathered) {
  const int k = lane / q;
  const bool own = have && (round0 || bit_set(bits, staged, v));
  const size_t off = (size_t)v * Bp + col;
  int4 cur = inf4();
  if (own) cur = __ldcg(reinterpret_cast<const int4*>(din + off));
  // the items' slot counts and where each starts in their concatenation
  const int len = have ? hi - lo : 0;
  int x = (lane == k * q) ? len : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  const int total = __shfl_sync(kFull, x, 31);
  const int start = __shfl_sync(kFull, x, min(k * q, 31)) - len;
  int4 best = inf4();
  bool had = false;
  for (int base = 0; base < total; base += 32) {
    const int L = base + lane;  // the slot this lane loads
    int kl = 0, pl = 0;
    for (int i = 1; i < R; ++i) {
      const int p = __shfl_sync(kFull, start, i * q);
      if (p <= L) {
        kl = i;
        pl = p;
      }
    }
    const int e = __shfl_sync(kFull, lo, kl * q) + (L - pl);
    int u = 0, w = 0;
    bool ok = false;
    if (L < total) {
      u = __ldg(src + e);
      w = __ldg(metric + e);
      ok = __ldg(blocked + e) == 0 && bit_set(bits, staged, u);
    }
    const unsigned m = __ballot_sync(kFull, ok);
    if (lane == 0) gathered += __popc(m);
    const int a0 = max(start - base, 0), a1 = min(start + len - base, 32);
    unsigned mine =
        a1 > a0 ? m & ((a1 - a0 == 32 ? kFull : (1u << (a1 - a0)) - 1u)
                       << a0)
                : 0u;
    had |= mine != 0;
    while (__any_sync(kFull, mine != 0)) {
      int us[kUnroll], ws[kUnroll];
#pragma unroll
      for (int g = 0; g < kUnroll; ++g) {
        const int j = mine ? __ffs(mine) - 1 : 0;
        const bool valid = mine != 0;
        mine &= mine - 1;
        us[g] = __shfl_sync(kFull, u, j);
        ws[g] = __shfl_sync(kFull, w, j);
        if (!valid) us[g] = -1;
      }
      int4 d[kUnroll];
#pragma unroll
      for (int g = 0; g < kUnroll; ++g)
        d[g] = us[g] >= 0 ? __ldcg(reinterpret_cast<const int4*>(
                                din + (size_t)us[g] * Bp + col))
                          : inf4();
#pragma unroll
      for (int g = 0; g < kUnroll; ++g) {
        best.x = relax1(best.x, d[g].x, ws[g]);
        best.y = relax1(best.y, d[g].y, ws[g]);
        best.z = relax1(best.z, d[g].z, ws[g]);
        best.w = relax1(best.w, d[g].w, ws[g]);
      }
    }
  }
  if (!(own || had)) return false;  // the row keeps its value
  if (!own) cur = __ldcg(reinterpret_cast<const int4*>(din + off));
  const int4 nv = min4(cur, best);
  const bool low = less4(nv, cur);
  if (!split) {
    // an unchanged row's output copy is current in the columns that did
    // not fall (csrc header)
    if (own || low) __stcg(reinterpret_cast<int4*>(dout + off), nv);
  } else if (low || (first && own)) {
    atomicMin(dout + off, nv.x);
    atomicMin(dout + off + 1, nv.y);
    atomicMin(dout + off + 2, nv.z);
    atomicMin(dout + off + 3, nv.w);
  }
  if (low) atomicOr(bout + (v >> 5), 1u << (v & 31));
  return low;
}

// GUARD: the sharded loop's guard (parallel/sharded_spf.py): the launch
// does nothing unless bit ctl[0] of phase_mask is set. The control block
// is written only by launches before this one (the loop's exit kernel),
// never by this kernel, so one read through the read-only path serves;
// every block reads the same word, so a done launch returns from every
// block before the first grid barrier and writes nothing.
template <bool GUARD>
__global__ void __launch_bounds__(kThreads)
    edge_relax_kernel(const FixArgs a) {
  if (GUARD && !((a.phase_mask >> __ldg(a.ctl)) & 1)) return;
  unsigned barriers = 0;
  // the block's copies of the row bitmaps, when W fits: the last round's
  // (read) and this round's (set here, merged into the global one once a
  // round: one atomic a nonzero word and block)
  extern __shared__ uint4 s_mem4[];
  unsigned* s_in = reinterpret_cast<unsigned*>(s_mem4);
  unsigned* s_out = s_in + a.W;
  __shared__ unsigned long long s_gathered;
  if (threadIdx.x == 0) s_gathered = 0;
  __syncthreads();  // before any warp adds to it
  const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t n_threads = (size_t)gridDim.x * kThreads;
  const int lane = threadIdx.x & 31;
  const unsigned warp = (unsigned)(tid >> 5);
  const unsigned n_warps = (unsigned)(n_threads >> 5);
  const bool staged = a.W <= kMaxBitWords;
  // the long runs' rows start at INF in buf1, so their segments' merges
  // need no order in the first round
  if (a.n_seg > 0) {
    for (size_t j = tid; j < (size_t)a.n_seg; j += n_threads) {
      const int v = __ldg(a.seg_node + j);
      if (__ldg(a.seg_lo + j) != __ldg(a.row_start + v)) continue;
      int4* row = reinterpret_cast<int4*>(a.buf1 + (size_t)v * a.Bp);
      for (int c = 0; c < a.Bp / 4; ++c) row[c] = inf4();
    }
    grid_barrier(a.arrivals, barriers);
  }
  const int ntiles = (a.Bp + a.Bt - 1) / a.Bt;
  const unsigned n_items = (unsigned)(a.V + a.n_seg);
  unsigned gathered = 0;  // this round's, added to the block's total
  unsigned long long rounds_max = 0, last_changed = 0;
  int g_round = 0;  // rounds of this launch so far: the rotation index
  for (int t = 0; t < ntiles; ++t) {
    const int c0 = t * a.Bt;
    const int q = min(a.Bt, a.Bp - c0) / 4;  // lanes an item
    const int R = 32 / q;                    // items a warp
    const int k = lane / q;
    const int col = c0 + 4 * (lane - k * q);
    const unsigned n_groups = (n_items + R - 1) / R;
    int r = 0;
    bool changed = false;
    while (r < a.max_rounds) {
      const int* din = (r & 1) ? a.buf1 : a.buf0;
      int* dout = (r & 1) ? a.buf0 : a.buf1;
      const unsigned* bin =
          r > 0 ? a.bm + (size_t)(g_round % 3) * a.W
                : (a.marks != nullptr ? a.marks + (size_t)t * a.W : nullptr);
      unsigned* bout = a.bm + (size_t)((g_round + 1) % 3) * a.W;
      unsigned* bclr = a.bm + (size_t)((g_round + 2) % 3) * a.W;
      for (size_t i = tid; i < (size_t)a.W; i += n_threads) bclr[i] = 0;
      if (tid == 0) a.flags[(g_round + 1) % 3] = 0;
      const unsigned* bits = bin;
      if (staged) {  // W is a multiple of 4 words
        const uint4* b4 = reinterpret_cast<const uint4*>(bin);
        uint4* o4 = reinterpret_cast<uint4*>(s_out);
        for (int i = threadIdx.x; i < a.W / 4; i += kThreads) {
          if (bin != nullptr) s_mem4[i] = __ldcg(b4 + i);
          o4[i] = make_uint4(0, 0, 0, 0);
        }
        __syncthreads();
        if (bin != nullptr) bits = s_in;
      }
      bool lowered = false;
      for (unsigned gi = warp; gi < n_groups; gi += n_warps) {
        const unsigned it = gi * R + k;
        const bool have = k < R && it < n_items;
        int v = 0, lo = 0, hi = 0;
        bool split = false, first = false, walked = have;
        if (have && it < (unsigned)a.V) {
          v = (int)it;
          lo = __ldg(a.row_start + v);
          hi = __ldg(a.row_start + v + 1);
          walked = hi - lo <= a.seg_edges;  // else walked as segments
        } else if (have) {
          const unsigned j = it - a.V;
          v = __ldg(a.seg_node + j);
          lo = __ldg(a.seg_lo + j);
          const int end = __ldg(a.row_start + v + 1);
          hi = min(lo + a.seg_edges, end);
          split = true;
          first = lo == __ldg(a.row_start + v);
        }
        lowered |= relax_items(a.src, a.metric, a.blocked, a.Bp, din, dout,
                               bits, bits == s_in, staged ? s_out : bout, q,
                               R, lane, walked, v, col, lo, hi, split, first,
                               r == 0, gathered);
      }
      if (gathered) {
        atomicAdd(&s_gathered, (unsigned long long)gathered);
        gathered = 0;
      }
      lowered = __syncthreads_or(lowered);
      if (lowered && staged) {
        for (int i = threadIdx.x; i < a.W; i += kThreads)
          if (s_out[i]) atomicOr(bout + i, s_out[i]);
      }
      if (lowered && threadIdx.x == 0) a.flags[g_round % 3] = 1;
      grid_barrier(a.arrivals, barriers);
      changed = __ldcg(a.flags + g_round % 3) != 0;
      ++r;
      ++g_round;
      if (!changed) break;
    }
    if (changed && (r & 1) == 0) {  // capped on an even count: into buf1
      const size_t n = (size_t)a.V * q;
      for (size_t i = tid; i < n; i += n_threads) {
        const size_t off = (i / q) * a.Bp + c0 + (i % q) * 4;
        __stcg(reinterpret_cast<int4*>(a.buf1 + off),
               __ldcg(reinterpret_cast<const int4*>(a.buf0 + off)));
      }
    }
    if ((unsigned long long)r > rounds_max) rounds_max = r;
    last_changed |= changed;
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_gathered) atomicAdd(a.stats + 2, s_gathered);
  if (tid == 0) {
    a.stats[0] = rounds_max;
    a.stats[1] = last_changed;
    if (a.changed != nullptr) *a.changed = (int)last_changed;
  }
}

// Words of a row bitmap: a bit a row, rounded up to 16 bytes.
int bitmap_words(int V) { return (V + 127) / 128 * 4; }

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// The cooperative grid of `fn` with `smem` dynamic shared bytes a block:
// every block resident at once.
cudaError_t coop_grid(const void* fn, size_t smem, int* blocks) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sm_count();
  return cudaSuccess;
}

}  // namespace

// The init into dist [V, Bp] (Bp a multiple of 4; columns past B stay INF)
// and the per-tile row marks [ceil(Bp / Bt), bitmap_words(V)] words.
extern "C" int openr_edge_init(void* dist, const void* roots,
                               const void* out_start, const void* out_slot,
                               const void* dst, const void* metric,
                               void* marks, int V, int B, int Bp, int Bt,
                               void* stream) {
  if (V <= 0 || Bp <= 0) return 0;
  if (Bp % 4 || Bt <= 0 || Bt % 4 || B > Bp) return (int)cudaErrorInvalidValue;
  InitArgs a;
  a.dist = (int*)dist;
  a.roots = (const int*)roots;
  a.out_start = (const int*)out_start;
  a.out_slot = (const int*)out_slot;
  a.dst = (const int*)dst;
  a.metric = (const int*)metric;
  a.marks = (unsigned*)marks;
  a.V = V;
  a.B = B;
  a.Bp = Bp;
  a.Bt = Bt;
  a.W = bitmap_words(V);
  a.ntiles = (Bp + Bt - 1) / Bt;
  int blocks = 0;
  cudaError_t err = coop_grid((const void*)edge_init_kernel, 0, &blocks);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel((const void*)edge_init_kernel,
                                    dim3(blocks), dim3(kThreads), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

namespace {

// The shared body of the two fixpoint entries: clears the scratch and the
// stats on the stream, then launches edge_relax_kernel<GUARD>.
template <bool GUARD>
int launch_fix(void* buf0, void* buf1, const void* row_start,
               const void* src, const void* metric, const void* blocked,
               const void* seg_node, const void* seg_lo, int n_seg,
               int seg_edges, const void* marks, void* scratch, void* stats,
               int V, int Bp, int Bt, int max_rounds, const void* ctl,
               int phase_mask, void* changed, cudaStream_t s) {
  const int W = bitmap_words(V);
  cudaError_t err = cudaMemsetAsync(stats, 0, 3 * sizeof(unsigned long long),
                                    s);
  if (err != cudaSuccess) return (int)err;
  if (V <= 0 || Bp <= 0) return 0;
  if (Bp % 4 || Bt <= 0 || Bt % 4 || Bt > 128 || max_rounds <= 0 ||
      seg_edges <= 0 || ((long long)V + n_seg) * (Bt / 4) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  err = cudaMemsetAsync(scratch, 0, (3 * (size_t)W + 4) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  FixArgs a;
  a.buf0 = (int*)buf0;
  a.buf1 = (int*)buf1;
  a.row_start = (const int*)row_start;
  a.src = (const int*)src;
  a.metric = (const int*)metric;
  a.blocked = (const uint8_t*)blocked;
  a.seg_node = (const int*)seg_node;
  a.seg_lo = (const int*)seg_lo;
  a.marks = (const unsigned*)marks;
  a.bm = (unsigned*)scratch;
  a.flags = (int*)scratch + 3 * (size_t)W;
  a.arrivals = (unsigned*)scratch + 3 * (size_t)W + 3;
  a.stats = (unsigned long long*)stats;
  a.ctl = (const int*)ctl;
  a.changed = (int*)changed;
  a.V = V;
  a.Bp = Bp;
  a.Bt = Bt;
  a.W = W;
  a.n_seg = n_seg;
  a.seg_edges = seg_edges;
  a.max_rounds = max_rounds;
  a.phase_mask = phase_mask;
  const size_t smem =
      W <= kMaxBitWords ? 2 * (size_t)W * sizeof(unsigned) : 0;
  const void* fn = (const void*)edge_relax_kernel<GUARD>;
  int blocks = 0;
  err = coop_grid(fn, smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args,
                                    smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Rounds from buf0 to the fixpoint (at most max_rounds a tile), the result
// in buf1; both [V, Bp]. marks: the init's row marks, or null for "every
// row changed" (a round from any state). scratch: 3 * bitmap_words(V) + 4
// ints; stats: 3 unsigned 64-bit words (rounds, last round lowered,
// gathered edges); both cleared here on the same stream.
extern "C" int openr_edge_fix(void* buf0, void* buf1, const void* row_start,
                              const void* src, const void* metric,
                              const void* blocked, const void* seg_node,
                              const void* seg_lo, int n_seg, int seg_edges,
                              const void* marks, void* scratch, void* stats,
                              int V, int Bp, int Bt, int max_rounds,
                              void* stream) {
  return launch_fix<false>(buf0, buf1, row_start, src, metric, blocked,
                           seg_node, seg_lo, n_seg, seg_edges, marks,
                           scratch, stats, V, Bp, Bt, max_rounds, nullptr, 0,
                           nullptr, (cudaStream_t)stream);
}

// One full round from buf0 into buf1 (every row changed) under the loop's
// guard: nothing unless bit ctl[0] of phase_mask is set. changed (null: not
// kept) receives whether the round lowered an entry; a done launch leaves
// buf1 and changed as they were (the scratch and stats clears still run).
extern "C" int openr_edge_round_guarded(
    void* buf0, void* buf1, const void* row_start, const void* src,
    const void* metric, const void* blocked, const void* seg_node,
    const void* seg_lo, int n_seg, int seg_edges, void* scratch, void* stats,
    int V, int Bp, int Bt, const void* ctl, int phase_mask, void* changed,
    void* stream) {
  return launch_fix<true>(buf0, buf1, row_start, src, metric, blocked,
                          seg_node, seg_lo, n_seg, seg_edges, nullptr,
                          scratch, stats, V, Bp, Bt, 1, ctl, phase_mask,
                          changed, (cudaStream_t)stream);
}

extern "C" const char* openr_edge_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
