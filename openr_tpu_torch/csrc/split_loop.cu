// The split solve's loop on the card, for Hopper (sm_90a).
//
// Replaces the control flow of openr_tpu/ops/spf_split.py:340
// batched_sssp_split (its three jax.lax.while_loops, :393, :450, :464, and
// the sort-compaction _compact_ids, :250), which the JAX package keeps on
// the device inside one jitted dispatch. The relax itself stays kernel A
// (csrc/relax.cu); these kernels carry the loop around it:
//
// * split_snap_kernel: the step's snapshot of dist (the Jacobi source of
//   the overflow and tail relaxes) and the clears of the row flags and of
//   the changed-row count.
// * frontier_mark_kernel: marks the out-neighbours of the listed frontier
//   (and, on the warm path, the frontier itself) in a [vp] flag array,
//   skipping the dead slot vp-1.
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
// out-neighbour rows; the compaction reads vp flags (426 KB at vp
// 106 496), written by the step's kernels just before and L2-resident,
// in one pass: a block a tile of 4 096 flags (one wave of 26 blocks at
// that vp), the tiles' offsets by decoupled look-back, so each tile waits
// on its predecessors' status words and not on their loads.

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

// ------------------------------------------------------------ snapshot

__global__ void __launch_bounds__(256)
    split_snap_kernel(const int* __restrict__ dist, int* __restrict__ snap,
                      long long n, int* row_flag, int vp, int* ctl,
                      int phase_mask) {
  if (!runs(ctl, phase_mask)) return;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n4 = n / 4;  // dist and snap are 16-byte aligned
  const int4* s4 = reinterpret_cast<const int4*>(dist);
  int4* d4 = reinterpret_cast<int4*>(snap);
  long long i = tid;
  for (; i + stride < n4; i += 2 * stride) {  // two loads in flight
    const int4 a = __ldcg(s4 + i);
    const int4 b = __ldcg(s4 + i + stride);
    __stcg(d4 + i, a);
    __stcg(d4 + i + stride, b);
  }
  if (i < n4) __stcg(d4 + i, __ldcg(s4 + i));
  for (long long j = 4 * n4 + tid; j < n; j += stride) snap[j] = dist[j];
  for (long long j = tid; j < vp; j += stride) row_flag[j] = 0;
  if (tid == 0) ctl[kRowsChanged] = 0;
}

// ---------------------------------------------------------------- mark

__global__ void __launch_bounds__(256)
    frontier_mark_kernel(const int* __restrict__ frontier,
                         const int* __restrict__ out_nbr, int wout,
                         int* mark, int dead, int with_frontier, int* ctl,
                         int phase_mask) {
  if (!runs(ctl, phase_mask)) return;
  const long long n = __ldcg(ctl + kNFront);
  const long long total = n * wout;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // consecutive threads walk consecutive slots of one out-neighbour row
  for (long long i = tid; i < total; i += stride) {
    const int f = __ldcg(frontier + i / wout);
    const int v = __ldg(out_nbr + (size_t)f * wout + i % wout);
    if (v != dead) mark[v] = 1;
  }
  if (with_frontier)
    for (long long i = tid; i < n; i += stride) {
      const int f = __ldcg(frontier + i);
      if (f != dead) mark[f] = 1;
    }
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

constexpr int kMaxBlocks = 1024;

int blocks_for(long long work, int threads) {
  long long b = (work + threads - 1) / threads;
  if (b < 1) b = 1;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" int openr_split_snap(const void* dist, void* snap, long long n,
                                void* row_flag, int vp, void* ctl,
                                int phase_mask, void* stream) {
  split_snap_kernel<<<blocks_for(n / 8, 256), 256, 0, (cudaStream_t)stream>>>(
      (const int*)dist, (int*)snap, n, (int*)row_flag, vp, (int*)ctl,
      phase_mask);
  return (int)cudaGetLastError();
}

// `cap` bounds the frontier's length (the grid is sized for cap x wout).
extern "C" int openr_frontier_mark(const void* frontier, const void* out_nbr,
                                   int wout, int cap, void* mark, int dead,
                                   int with_frontier, void* ctl,
                                   int phase_mask, void* stream) {
  frontier_mark_kernel<<<blocks_for((long long)cap * wout, 256), 256, 0,
                         (cudaStream_t)stream>>>(
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
