// The split solve's loop on the card, for Hopper (sm_90a).
//
// Replaces the control flow of openr_tpu/ops/spf_split.py:340
// batched_sssp_split (its three jax.lax.while_loops, :393, :450, :464, and
// the sort-compaction _compact_ids, :250), which the JAX package keeps on
// the device inside one jitted dispatch. The relax itself stays kernel A
// (csrc/relax.cu); these kernels carry the loop around it:
//
// * split_snap_mark_kernel: the step's snapshot of dist (the Jacobi
//   source of the overflow and tail relaxes) and the clears of the row
//   flags and of the changed-row count; in a tail step the same launch
//   also marks the out-neighbours of the listed frontier (and, on the
//   warm path, the frontier itself) in a [vp] flag array, skipping the
//   dead slot vp-1 (the reference's sort of out_nbr[frontier], :414 and
//   :614).
// * flag_compact_kernel: the stream compaction of a [vp] flag array into
//   the ids it holds, in index order, dead-padded to `cap`, with their
//   count and the spill bit (count > cap). Row ids are positions in
//   [0, vp), so this is the reference's sorted, deduplicated list without
//   a sort. With `decide`, its last block also makes the tail's decision
//   (cond2, and the net's entry) after a frontier's compaction.
// * split_ctl_kernel: the reference's cond1/cond3 decisions after a
//   step's relaxes, as writes to the control block.
//
// The loop's state is one int32 control block `ctl` (layout in
// ops/split_loop.py). ctl[0] is the phase: 1 dense sweeps, 2 compacted
// tail, 3 the exactness net, 0 done. Every kernel here (and kernel A on
// the solve's path) reads it at entry and returns at once unless bit
// `phase` of its `phase_mask` is set, so a fixed sequence of launches (a
// CUDA graph of K steps) runs the loop, and a step after the exit touches
// nothing. The host reads ctl once per K steps.
//
// Bound on this card: bytes, and for the compaction the latency of the
// chain from the first tile's count to the last tile's prefix. The
// snapshot moves 2 x vp x B x 4 bytes; the mark reads the frontier's
// out-neighbour rows, a few hundred of 256 bytes at er100k, and is
// latency-bound: a frontier id, then its row, then the stores. So it
// rides in the snapshot's launch, which every step makes anyway: a
// group of lanes a frontier row (16-byte loads of its wout slots, at
// most a warp), the row id read once and broadcast, shifts for wout (a
// power of two), one plain store a live slot. A dense step skips the
// mark, and a step after the loop's exit returns at the guard, a launch
// fewer than with a mark kernel of its own. The compaction reads vp
// flags (426 KB at vp 106 496), written by the step's kernels just
// before and L2-resident, in one pass: a block a tile of 4 096 flags (one
// wave of 26 blocks at that vp), the tiles' offsets by decoupled
// look-back, so each tile waits on its predecessors' status words and
// not on their loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// control block words (ops/split_loop.py holds the same names)
enum Ctl {
  kPhase = 0,
  kIt = 1,
  kSweeps = 2,
  kTailRounds = 3,
  kSteps = 4,
  kRowsChanged = 5,
  kNRows = 6,
  kNFront = 7,
  kRawFront = 8,
  kSpill = 9,
  kThreshold = 10,
  kRoundsCap = 11,
  kItCap = 12,
  kRawRows = 13,
};
enum Phase { kDone = 0, kDense = 1, kTail = 2, kNet = 3 };

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool runs(const int* ctl, int phase_mask) {
  return (phase_mask >> __ldcg(ctl + kPhase)) & 1;
}

// ------------------------------------------------- snapshot and mark

// The mark's lanes: a group of `lanes` = min(32, wout / 4) lanes a
// frontier row (the row's slots as 16-byte loads), `per_warp` rows a
// warp at once, lane `j` of its group, `leader` the group's first lane.
struct MarkLanes {
  int lg_lanes, lanes, lg_wout, j, leader, per_warp;
  __device__ MarkLanes(int wout, int lane) {
    lg_lanes = min(5, __ffs(wout) - 3);  // log2(min(32, wout / 4))
    lanes = 1 << lg_lanes;
    lg_wout = __ffs(wout) - 1;
    j = lane & (lanes - 1);
    leader = lane & ~(lanes - 1);
    per_warp = 32 >> lg_lanes;
  }
};

// one plain store of 1 a live slot: two slots naming one row write the
// same word, so no atomics
__device__ __forceinline__ void mark_slots(int4 v, int* __restrict__ mark,
                                           int dead) {
  if (v.x != dead) mark[v.x] = 1;
  if (v.y != dead) mark[v.y] = 1;
  if (v.z != dead) mark[v.z] = 1;
  if (v.w != dead) mark[v.w] = 1;
}

// Marks the out-neighbours of frontier rows [0, nf) in `mark` (and, with
// `with_frontier`, the rows themselves), the dead slot never, from the
// grid's second pass on (split_snap_mark_kernel marks the first): a
// warp's groups take consecutive rows, the grid's warps stride over
// them. The group's first lane reads the row id, a shuffle hands it to
// the group; every lane of the warp runs the shuffle, so the loop is
// warp-uniform.
__device__ __forceinline__ void mark_rows_past_first(
    const int* __restrict__ frontier, int nf,
    const int* __restrict__ out_nbr, int wout, int* __restrict__ mark,
    int dead, int with_frontier, long long warp, long long warps) {
  const int lane = threadIdx.x & 31;
  const MarkLanes m(wout, lane);
  for (long long r0 = (warp + warps) * m.per_warp; r0 < nf;
       r0 += warps * m.per_warp) {
    const long long r = r0 + (lane >> m.lg_lanes);
    const bool live = r < nf;
    int f = dead;
    if (live && m.j == 0) f = __ldcg(frontier + r);
    f = __shfl_sync(kFull, f, m.leader);
    if (!live) continue;
    const int4* row =
        reinterpret_cast<const int4*>(out_nbr + ((size_t)f << m.lg_wout));
    for (int q = m.j; q < (wout >> 2); q += m.lanes)
      mark_slots(__ldg(row + q), mark, dead);
    if (with_frontier && m.j == 0 && f != dead) mark[f] = 1;
  }
}

// The step's first launch. Every step: snap = dist, the row flags and
// the changed-row count cleared. A tail step also marks the frontier's
// out-neighbours. The mark is latency-bound (a row id, then its row,
// then the stores), so its first pass (a row a group: at er100k the
// grid's warps, two rows each at wout 64, cover the cap of 8 192) is
// interleaved with the copy: the row id's load goes out with the
// copy's first loads, the row's with their stores, and the marks are
// stored after the copy, so both loads wait under the copy's traffic.
// Rows past the first pass (mark_rows_past_first) follow. The two halves touch
// disjoint memory (the snapshot reads dist and writes snap, row_flag
// and ctl[kRowsChanged]; the mark reads frontier, out_nbr and
// ctl[kNFront] and writes mark), and the frontier was written by the
// previous step's last compaction, a launch earlier. The grid is one
// wave of the kernel on this device whatever its register count
// (snap_blocks); capping the registers at 32 instead spilled.
__global__ void __launch_bounds__(256)
    split_snap_mark_kernel(const int* __restrict__ dist,
                           int* __restrict__ snap, long long n,
                           int* __restrict__ row_flag, int vp,
                           const int* __restrict__ frontier,
                           const int* __restrict__ out_nbr, int wout,
                           int* __restrict__ mark, int dead,
                           int with_frontier, int* ctl, int phase_mask) {
  // The phase and the frontier's length through the read-only path:
  // this launch writes no word it reads (thread 0 writes only
  // ctl[kRowsChanged]), and a launch sees what earlier launches wrote.
  // Read with ld.global.cg, every warp's request for this one sector
  // queues at one L2 slice: a dense step took 7.69 us read so and 5.51
  // us by __ldg (chip_smoke.py [14], NVIDIA H100 80GB HBM3, 700.00 W).
  const int phase = __ldg(ctl + kPhase);
  const int n_front = __ldg(ctl + kNFront);
  if (!((phase_mask >> phase) & 1)) return;
  // 32-bit indices (the launcher holds n / 4 below 2^31): fewer
  // registers
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int nf = phase == kTail ? n_front : 0;
  const MarkLanes m(wout, lane);
  const int row = (tid >> 5) * m.per_warp + (lane >> m.lg_lanes);
  const bool marking = row < nf;  // this lane's group has a first-pass row
  int f = dead;
  if (marking && m.j == 0) f = __ldcg(frontier + row);
  const int n4 = (int)(n / 4);  // dist and snap are 16-byte aligned
  const int4* s4 = reinterpret_cast<const int4*>(dist);
  int4* d4 = reinterpret_cast<int4*>(snap);
  int i = tid;
  const bool has_a = i < n4, has_b = i + stride < n4;
  int4 a, b;
  if (has_a) a = __ldcg(s4 + i);
  if (has_b) b = __ldcg(s4 + i + stride);
  f = __shfl_sync(kFull, f, m.leader);
  const int4* nbr_row =
      reinterpret_cast<const int4*>(out_nbr + ((size_t)f << m.lg_wout));
  int4 slots = make_int4(dead, dead, dead, dead);
  if (marking) slots = __ldg(nbr_row + m.j);
  if (has_a) __stcg(d4 + i, a);
  if (has_b) __stcg(d4 + i + stride, b);
  for (i += 2 * stride; i < n4 - stride; i += 2 * stride) {
    const int4 a2 = __ldcg(s4 + i);  // two loads in flight
    const int4 b2 = __ldcg(s4 + i + stride);
    __stcg(d4 + i, a2);
    __stcg(d4 + i + stride, b2);
  }
  if (i < n4) __stcg(d4 + i, __ldcg(s4 + i));
  if (tid < n - 4LL * n4) snap[4LL * n4 + tid] = dist[4LL * n4 + tid];
  for (int j = tid; j < vp; j += stride) row_flag[j] = 0;
  if (tid == 0) ctl[kRowsChanged] = 0;
  if (marking) {
    mark_slots(slots, mark, dead);
    for (int q = m.j + m.lanes; q < (wout >> 2); q += m.lanes)
      mark_slots(__ldg(nbr_row + q), mark, dead);
    if (with_frontier && m.j == 0 && f != dead) mark[f] = 1;
  }
  if (nf > 0)
    mark_rows_past_first(frontier, nf, out_nbr, wout, mark, dead,
                         with_frontier, tid >> 5, stride >> 5);
}

// ------------------------------------------------------------- compact

constexpr int kCompactThreads = 256;
constexpr int kCompactWarps = kCompactThreads / 32;
// flags a block scans (ops/split_loop.py COMPACT_TILE): 16 a thread. Of
// 1 024, 2 048 and 4 096, the quickest at the 100k benchmark's vp of
// 106 496 (PERF.md has the timings)
constexpr int kTile = 4096;
// the compaction's workspace (int64 words, ops/split_loop.py compact_ws):
// the tile ticket, the count of blocks done, then a status word a tile
enum CompactWs { kTicket = 0, kDoneBlocks = 1, kStatus0 = 2 };
// a tile's status word: a tag in the high half (0: nothing yet), a count
// in the low half; the tile's own flags, or all flags up to its end
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// the reference's cond2 and the net's entry, after a tail round's (or the
// tail entry's) frontier compaction
__device__ void tail_decide(int* ctl) {
  if (ctl[kSpill]) {
    ctl[kPhase] = kNet;
    ctl[kIt] = 0;
  } else if (ctl[kRawFront] == 0) {
    ctl[kPhase] = kDone;
  } else if (ctl[kIt] >= ctl[kRoundsCap]) {
    ctl[kPhase] = kNet;
    ctl[kIt] = 0;
  }
}

// One pass over the flags, a block a tile of kTile flags (16 a thread,
// as 16-byte loads where whole). A block reads the phase guard,
// then takes its tile from a ticket, so the tiles go out in the order the
// blocks start and a block waits only on blocks already running. In the
// tile: a bit a flag, __popc a thread, a block scan (warp shuffles, then
// the warp sums). Across tiles: the single-pass scan with decoupled
// look-back (Merrill & Garland, 2016): a tile publishes its count, then
// its inclusive prefix, as one 64-bit status word; warp 0 sums its
// predecessors' words, 32 at a time, back to the nearest inclusive
// prefix. The ids go to prefix + local offset (those below cap). The
// block of the last tile, whose inclusive prefix is the count, writes the
// counts (ctl[count_slot] capped at cap, ctl[raw_slot], ctl[kSpill] past
// cap), pads out[kept:cap) with `dead` and with `decide` runs
// tail_decide: every block has read the guard by then, since the last
// ticket is out. The last block done zeroes the workspace (not the last
// tile's: other blocks may still read status words), so every launch
// leaves it as it found it and a graph replay needs no memset. Each block
// fences before it counts itself done and the last one fences again
// before the reset (the threadFenceReduction pattern): the status words,
// ticket and count of every block are then ordered before the zeroes. A
// guarded launch touches nothing, the workspace included.
__global__ void __launch_bounds__(kCompactThreads)
    flag_compact_kernel(int* flags, int n, int* __restrict__ out, int cap,
                        int dead, int* ctl, int phase_mask, int count_slot,
                        int raw_slot, int clear, int decide,
                        unsigned long long* ws) {
  constexpr int kPer = kTile / kCompactThreads;
  static_assert(kPer % 4 == 0 && kPer <= 32, "a thread's flags in a word");
  __shared__ int s_tile, s_prefix, s_raw, s_last;
  __shared__ int s_warp[kCompactWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0)
    s_tile = runs(ctl, phase_mask) ? (int)atomicAdd(ws + kTicket, 1ull) : -1;
  __syncthreads();
  const int tile = s_tile;
  if (tile < 0) return;
  const int tiles = gridDim.x;
  const int base = tile * kTile + t * kPer;
  const bool whole = ((uintptr_t)flags & 15) == 0 && base + kPer <= n;
  unsigned bits = 0;
  if (whole) {
    const int4* f4 = reinterpret_cast<const int4*>(flags + base);
    int4 v[kPer / 4];
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) v[q] = __ldcg(f4 + q);
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      bits |= (unsigned)(v[q].x != 0) << (4 * q);
      bits |= (unsigned)(v[q].y != 0) << (4 * q + 1);
      bits |= (unsigned)(v[q].z != 0) << (4 * q + 2);
      bits |= (unsigned)(v[q].w != 0) << (4 * q + 3);
    }
  } else {
    for (int e = 0; e < kPer; ++e)
      if (base + e < n && __ldcg(flags + base + e) != 0) bits |= 1u << e;
  }
  const int c = __popc(bits);
  int incl = c;  // inclusive scan over the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kCompactWarps ? s_warp[lane] : 0;
    int wi = w;
#pragma unroll
    for (int off = 1; off < kCompactWarps; off <<= 1) {
      const int y = __shfl_up_sync(kFull, wi, off);
      if (lane >= off) wi += y;
    }
    const int agg = __shfl_sync(kFull, wi, kCompactWarps - 1);
    if (lane < kCompactWarps) s_warp[lane] = wi - w;  // exclusive offsets
    unsigned long long* status = ws + kStatus0;
    int prefix = 0;
    if (tile > 0) {
      if (lane == 0) st_release(status + tile, kAggregate | (unsigned)agg);
      // lane l reads tile - 1 - l; a lane before tile 0 reads a zero
      // inclusive prefix
      for (int pred = tile - 1 - lane;; pred -= 32) {
        unsigned long long s;
        do {
          s = pred >= 0 ? ld_acquire(status + pred) : kInclusive;
        } while (__any_sync(kFull, (s >> 32) == 0));
        const unsigned inclusive = __ballot_sync(kFull, (s >> 32) == 2);
        const int nearest = inclusive ? __ffs(inclusive) - 1 : 32;
        prefix += (int)__reduce_add_sync(
            kFull, lane <= nearest ? (unsigned)(s & 0xffffffffu) : 0u);
        if (inclusive) break;
      }
    }
    if (lane == 0) {
      st_release(status + tile, kInclusive | (unsigned)(prefix + agg));
      s_prefix = prefix;
      s_raw = prefix + agg;
    }
  }
  __syncthreads();
  if (tile == tiles - 1) {  // the last tile's prefix is the count
    const int raw = s_raw, kept = raw < cap ? raw : cap;
    for (int i = kept + t; i < cap; i += kCompactThreads) out[i] = dead;
    if (t == 0) {
      ctl[count_slot] = kept;
      ctl[raw_slot] = raw;
      if (raw > cap) ctl[kSpill] = 1;
      if (decide) tail_decide(ctl);
    }
  }
  int pos = s_prefix + s_warp[warp] + incl - c;
  for (unsigned m = bits; m; m &= m - 1) {
    if (pos < cap) out[pos] = base + __ffs(m) - 1;
    ++pos;
  }
  if (clear && bits) {
    if (whole) {
      int4* f4 = reinterpret_cast<int4*>(flags + base);
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q)
        if ((bits >> (4 * q)) & 0xFu) f4[q] = make_int4(0, 0, 0, 0);
    } else {
      for (unsigned m = bits; m; m &= m - 1) flags[base + __ffs(m) - 1] = 0;
    }
  }
  // done: the last block to get here zeroes the workspace. Thread 0
  // counts the block after warp 0's look-back (the barrier above), so
  // every block's reads of the status words are over by then; the fences
  // order its ticket and status word before its count, and every block's
  // count before the last one's zeroes.
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(ws + kDoneBlocks, 1ull) ==
             (unsigned long long)(tiles - 1);
    if (s_last) __threadfence();
  }
  __syncthreads();
  if (!s_last) return;
  for (int i = t; i < tiles; i += kCompactThreads) ws[kStatus0 + i] = 0;
  if (t == 0) {
    ws[kTicket] = 0;
    ws[kDoneBlocks] = 0;
  }
}

// ----------------------------------------------------------------- ctl

// After a step's relaxes: count the step, and end phase 1 (to the tail's
// entry compaction) or phase 3 (done) as the reference's cond1 and cond3
// say. The tail's own decision (cond2) is the frontier compaction's
// (tail_decide).
__global__ void split_ctl_kernel(int* ctl, int phase_mask) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  if (!runs(ctl, phase_mask)) return;
  const int phase = ctl[kPhase];
  ctl[kSteps] += 1;
  const int it = ctl[kIt] + 1;
  ctl[kIt] = it;
  if (phase == kTail) {
    ctl[kTailRounds] += 1;
    return;
  }
  ctl[kSweeps] += 1;
  const int changed = ctl[kRowsChanged];
  if (phase == kDense) {
    if (!(changed > ctl[kThreshold] && it < ctl[kItCap])) {
      ctl[kPhase] = kTail;  // the entry compaction runs next
      ctl[kIt] = 0;
    }
  } else if (changed == 0 || it >= ctl[kItCap]) {
    ctl[kPhase] = kDone;
  }
}

// The snapshot's grid: a block per 2 048 elements of dist, at most one
// wave of split_snap_mark_kernel on this device (its resident blocks an
// SM at its register count, times the SMs), read once a process.
int snap_blocks(long long n) {
  static int wave = 0;
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, split_snap_mark_kernel, 256, 0);
    wave = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const long long b = (n / 8 + 255) / 256;
  return (int)(b < 1 ? 1 : b < wave ? b : wave);
}

}  // namespace

// `wout` a power of two, at least 4; out_nbr [vp, wout] 16-byte aligned;
// n / 4 below 2^31 (the kernel's indices are 32-bit).
extern "C" int openr_split_snap_mark(const void* dist, void* snap,
                                     long long n, void* row_flag, int vp,
                                     const void* frontier,
                                     const void* out_nbr, int wout,
                                     void* mark, int dead, int with_frontier,
                                     void* ctl, int phase_mask,
                                     void* stream) {
  // int4 indices stay 32-bit, with room for i + 2 x the grid's threads
  if (n / 4 > (1LL << 31) - (1LL << 28)) return (int)cudaErrorInvalidValue;
  split_snap_mark_kernel<<<snap_blocks(n), 256, 0, (cudaStream_t)stream>>>(
      (const int*)dist, (int*)snap, n, (int*)row_flag, vp,
      (const int*)frontier, (const int*)out_nbr, wout, (int*)mark, dead,
      with_frontier, (int*)ctl, phase_mask);
  return (int)cudaGetLastError();
}

// `ws`: compact_ws words, all zero (every launch leaves them so).
extern "C" int openr_flag_compact(void* flags, int n, void* out, int cap,
                                  int dead, void* ctl, int phase_mask,
                                  int count_slot, int raw_slot, int clear,
                                  int decide, void* ws, void* stream) {
  const int tiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  flag_compact_kernel<<<tiles, kCompactThreads, 0, (cudaStream_t)stream>>>(
      (int*)flags, n, (int*)out, cap, dead, (int*)ctl, phase_mask,
      count_slot, raw_slot, clear, decide, (unsigned long long*)ws);
  return (int)cudaGetLastError();
}

extern "C" int openr_split_ctl(void* ctl, int phase_mask, void* stream) {
  split_ctl_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((int*)ctl,
                                                      phase_mask);
  return (int)cudaGetLastError();
}

extern "C" const char* openr_split_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
