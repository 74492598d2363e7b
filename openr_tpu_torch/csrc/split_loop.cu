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
//   a sort.
// * split_ctl_kernel: the reference's cond1/cond2/cond3 decisions, as
//   writes to the control block.
//
// The loop's state is one int32 control block `ctl` (layout in
// ops/split_loop.py). ctl[0] is the phase: 1 dense sweeps, 2 compacted
// tail, 3 the exactness net, 0 done. Every kernel here (and kernel A on
// the solve's path) reads it at entry and returns at once unless bit
// `phase` of its `phase_mask` is set, so a fixed sequence of launches (a
// CUDA graph of K steps) runs the loop, and a step after the exit touches
// nothing. The host reads ctl once per K steps.
//
// Bound on this card: bytes, and for the compaction the latency of one
// block's passes. The snapshot moves 2 x vp x B x 4 bytes; the mark reads
// the frontier's out-neighbour rows; the compaction reads vp flags (426 KB
// at vp 106 496) in one block of 1024 threads, 16 flags a thread a pass,
// with a block-wide scan per pass (7 passes at that vp). One block keeps
// the ids in order without a second pass or a cross-block scan; the
// flags it reads were written by the step's kernels just before and sit
// in L2.

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

constexpr int kCompactThreads = 1024;
constexpr int kPerThread = 16;  // flags a thread reads a pass
constexpr int kPass = kCompactThreads * kPerThread;

// One block. Each pass reads kPass flags (16 contiguous a thread, as four
// 16-byte loads where the pass is whole), scans the per-thread counts
// across the block (warp shuffles, then the 32 warp sums), and writes the
// set positions in order. The count goes to ctl[count_slot] (capped at
// cap) and ctl[raw_slot]; ctl[kSpill] is set when it exceeds cap.
__global__ void __launch_bounds__(kCompactThreads)
    flag_compact_kernel(int* flags, int n, int* __restrict__ out, int cap,
                        int dead, int* ctl, int phase_mask, int count_slot,
                        int raw_slot, int clear) {
  if (!runs(ctl, phase_mask)) return;
  __shared__ int s_warp[32];
  __shared__ int s_total;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool aligned = ((uintptr_t)flags & 15) == 0;
  int running = 0;  // ids written by earlier passes (uniform)
  for (int p0 = 0; p0 < n; p0 += kPass) {
    const int base = p0 + t * kPerThread;
    unsigned bits = 0;
    if (aligned && base + kPerThread <= n) {
      const int4* f4 = reinterpret_cast<const int4*>(flags + base);
      int4 v[kPerThread / 4];
#pragma unroll
      for (int q = 0; q < kPerThread / 4; ++q) v[q] = __ldcg(f4 + q);
#pragma unroll
      for (int q = 0; q < kPerThread / 4; ++q) {
        bits |= (unsigned)(v[q].x != 0) << (4 * q);
        bits |= (unsigned)(v[q].y != 0) << (4 * q + 1);
        bits |= (unsigned)(v[q].z != 0) << (4 * q + 2);
        bits |= (unsigned)(v[q].w != 0) << (4 * q + 3);
      }
    } else {
      for (int e = 0; e < kPerThread; ++e)
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
      const int w = s_warp[lane];
      int wi = w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, wi, off);
        if (lane >= off) wi += y;
      }
      s_warp[lane] = wi - w;  // exclusive warp offsets
      if (lane == 31) s_total = wi;
    }
    __syncthreads();
    int pos = running + s_warp[warp] + incl - c;
    for (unsigned m = bits; m; m &= m - 1) {
      const int e = __ffs(m) - 1;
      if (pos < cap) out[pos] = base + e;
      ++pos;
    }
    if (clear && bits) {
      if (aligned && base + kPerThread <= n) {
        int4* f4 = reinterpret_cast<int4*>(flags + base);
#pragma unroll
        for (int q = 0; q < kPerThread / 4; ++q)
          if ((bits >> (4 * q)) & 0xFu) f4[q] = make_int4(0, 0, 0, 0);
      } else {
        for (unsigned m = bits; m; m &= m - 1) flags[base + __ffs(m) - 1] = 0;
      }
    }
    running += s_total;
    __syncthreads();  // s_warp and s_total are rewritten by the next pass
  }
  const int kept = running < cap ? running : cap;
  for (int i = kept + t; i < cap; i += kCompactThreads) out[i] = dead;
  if (t == 0) {
    ctl[count_slot] = kept;
    ctl[raw_slot] = running;
    if (running > cap) ctl[kSpill] = 1;
  }
}

// ----------------------------------------------------------------- ctl

// stage 0, after a step's relaxes: count the step, and end phase 1 (to the
// tail's entry compaction) or phase 3 (done) as the reference's cond1 and
// cond3 say. stage 1, after a tail round's (or the tail entry's) frontier
// compaction: the reference's cond2 and the net's entry condition.
__global__ void split_ctl_kernel(int* ctl, int stage, int phase_mask) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  if (!runs(ctl, phase_mask)) return;
  const int phase = ctl[kPhase];
  if (stage == 0) {
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
    return;
  }
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

extern "C" int openr_flag_compact(void* flags, int n, void* out, int cap,
                                  int dead, void* ctl, int phase_mask,
                                  int count_slot, int raw_slot, int clear,
                                  void* stream) {
  flag_compact_kernel<<<1, kCompactThreads, 0, (cudaStream_t)stream>>>(
      (int*)flags, n, (int*)out, cap, dead, (int*)ctl, phase_mask,
      count_slot, raw_slot, clear);
  return (int)cudaGetLastError();
}

extern "C" int openr_split_ctl(void* ctl, int stage, int phase_mask,
                               void* stream) {
  split_ctl_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((int*)ctl, stage,
                                                      phase_mask);
  return (int)cudaGetLastError();
}

extern "C" const char* openr_split_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
