// Pull-relax of a set of rows of an in-neighbor table, for Hopper (sm_90a).
//
// Replaces the one Pallas TPU kernel of the JAX package,
// openr_tpu/ops/spf_pallas.py:90 _relax_kernel (via _relax_once), and serves
// every _relax_rows site of openr_tpu/ops/spf_split.py through row
// indirection: the dense base table (row0), the overflow table (dst_rows),
// and the compacted tail rows (src_rows == dst_rows).
//
// For each listed row i and distance column b:
//
//   r   = src_rows ? src_rows[i] : row0 + i        (table row)
//   t   = dst_rows ? dst_rows[i] : r               (target dist row)
//   acc = min over d of  dist_in[nbr[r,d], b] < INF
//                          ? min(dist_in[nbr[r,d], b] + wgt[r,d], INF) : INF
//         (INF where over[r,d] && nbr[r,d] != roots[b])
//   cur = out[t, b] (read before the write)
//   if acc < cur: atomicMin(&out[t, b], acc)
//   *changed += #{b : acc < dist_in[t, b]}          (if changed != nullptr)
//   row_flag[t] = 1 if some acc < cur; the write that sets it first adds 1
//   to *rows_changed                                (if row_flag != nullptr)
//
// Under the split solve's loop on the card (csrc/split_loop.cu), a launch
// through openr_relax_rows_guarded first reads the loop's phase, ctl[0],
// and returns at once unless bit ctl[0] of its phase mask is set; a tail
// round's launch, sized for the list's capacity, relaxes only the first
// *n_live rows. So one captured sequence of launches serves every phase.
//
// Targets may repeat (the dead slot vp-1 pads ov_ids and the tail lists),
// hence the atomicMin into an `out` the caller prepared. `out` may alias
// `dist_in` (the Gauss-Seidel chunks update dist in place): every value
// either buffer holds is a valid upper bound of the true distance, so a
// read that races a write changes only how fast the fixpoint is reached,
// never which fixpoint. Values only fall, so over all launches that share
// one cleared row_flag buffer, the flagged rows are exactly the rows whose
// value ended below where it started, the split solve's change detection:
// a flag's acc < cur <= start gives end <= acc < start; and a row that
// fell was lowered by some atomicMin with old > acc, whose writer had read
// cur >= old > acc. So the flag needs no atomic's return value, and the
// min is a fire-and-forget red.global.min.
//
// Bound on this card: bytes. Each candidate is one gathered distance and
// four integer ops; a dense chunk of the 100k benchmark does 56.6 M such
// ops, under 1 us at 67 Tops/s, while it must move ~26 MB (table rows,
// distinct gathered dist rows, target rows). No tensor core helps: wgmma
// multiplies and adds, and this is a min-plus over int32. Where the whole
// dist matrix fits in the 50 MB L2 (a 10k-node fabric at B = 128: 5.2 MB),
// a row is gathered once per in-edge from L2, so the L2 gather traffic
// (rows x slots x B x 4 bytes) is what the wide shapes wait on.
//
// Two designs, chosen by shape alone in openr_relax_rows:
//
// * relax_vec_kernel<W, B, OVER, GUARD> for W, B in {8, 16, 32, 64} (the
//   widths the split solve's builders produce). B/4 lanes cover one
//   gathered dist row
//   with 16-byte ld.global.cg loads (L2, no L1 allocation: the in-place
//   writes are L2 atomics and L1 would give little reuse), so one load
//   instruction of the warp serves 32/(B/4) table slots. The slot loop is
//   unrolled at compile time and a row's gathers are all issued, predicated
//   on w < INF and the overload test, before the first min, together with
//   the target row's own reads (out, the row flag), so one L2 round trip
//   covers them all; the slot groups are then combined with
//   __shfl_xor_sync. The counts are summed per block and added once per
//   block: thousands of rows counted into one word would serialise on its
//   atomics. A persistent grid of warps
//   strides over row groups; each warp double-buffers the next group's
//   nbr/wgt/over slab in shared memory with cp.async (and loads the row
//   indices two groups ahead into registers), so the table's latency hides
//   behind the current group's gathers.
// * relax_generic_kernel<NP, OVER, GUARD> for every other shape, above all
//   the wide ones that fabrics produce (a core or aggregation switch of a
//   90-ary Clos: W 64 with an overflow of 32, B 128; hubs: W and B of 256
//   and more). The same ingredients with the shape read at run time: a
//   warp per row, a strip of up to 32 lanes over the row's column quads
//   with 16-byte loads (NP strips per lane: B 128 is one warp instruction
//   per gathered 512-byte row, B 256 two strips, B 512 four), the other
//   lanes over slots; kBatch = 8 / NP slots' gathers issued before the
//   first min; the table staged in shared memory in slabs of 128 slots by
//   cp.async, double-buffered across slabs, column windows and rows, so a
//   hub's overflow row of 512 slots streams through four slabs; the row
//   indices read two rows ahead; a persistent grid; the min written with
//   red.global.min; the counts summed per block. Where B or W is not a
//   multiple of 4 (no aligned 16-byte piece), NP = 0 runs the scalar edge
//   path: a warp per row, lanes over the columns, 32 slots loaded at once
//   and broadcast with __shfl_sync, 4-byte gathers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kMaxDevices = 16;

struct RelaxArgs {
  const int* dist_in;
  int* out;
  const int* nbr;
  const int* wgt;
  const uint8_t* over;
  const int* roots;
  const int* src_rows;
  const int* dst_rows;
  int* changed;
  int* row_flag;
  int* rows_changed;
  // the split solve's loop guard (csrc/split_loop.cu): with ctl, the
  // launch returns at once unless bit ctl[0] of phase_mask is set; with
  // n_live, only the first *n_live listed rows are relaxed
  const int* ctl;
  const int* n_live;
  int phase_mask;
  int B, W, row0, n;
};

// The rows this launch relaxes under the loop guard: 0 when the loop's
// phase is not in its mask, else n capped at *n_live. (The arguments stay
// in parameter space; only this count is a register.)
__device__ __forceinline__ int live_rows(const RelaxArgs& a) {
  if (a.ctl && !((a.phase_mask >> __ldcg(a.ctl)) & 1)) return 0;
  return a.n_live ? min(a.n, __ldcg(a.n_live)) : a.n;
}

// Adds each block's sums of `v` into *dst: one atomic per block, not one
// per row. Every thread of the block calls it (s_sum: one shared int).
__device__ __forceinline__ void block_add(int* dst, int v, int* s_sum) {
  v = __reduce_add_sync(kFull, v);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(s_sum, v);
  __syncthreads();
  if (threadIdx.x == 0 && *s_sum) atomicAdd(dst, *s_sum);
}

// One candidate: INF guard before the add, INF where the slot is blocked.
__device__ __forceinline__ int cand(int g, int w, unsigned blocked) {
  return blocked ? kInf : (g < kInf ? min(g + w, kInf) : kInf);
}

// -------------------------------------------------------- vectorised

template <int W, int B>
struct VecShape {
  static constexpr int kL = B / 4;               // lanes per dist row (int4)
  static constexpr int kS = 32 / kL;             // slot lanes in the warp
  static constexpr int kSR = kS < W ? kS : W;    // slot lanes per table row
  static constexpr int kG = kS / kSR;            // table rows per warp step
  static constexpr int kK = W / kSR;             // slots per lane
  static constexpr int kSlots = kG * W;          // table slots per step
  static constexpr int kNW = kSR < 4 ? kSR : 4;  // writer lanes per quad
  static constexpr int kCPL = 4 / kNW;           // columns per writer lane
  static constexpr int kChunk = kK < 8 ? kK : 8;  // gathers per batch
  static_assert(kG >= 1 && kG <= 2, "a warp step holds one or two rows");
  static_assert(kK % kChunk == 0, "slot batches divide the slots");
};

template <int G>
struct Rows {
  int r[G];  // table rows
  int t[G];  // target dist rows
};

template <int G>
__device__ __forceinline__ int pick(const int (&x)[G], int g) {
  return (G == 1 || g == 0) ? x[0] : x[G - 1];
}

template <int G>
__device__ __forceinline__ Rows<G> load_rows(const RelaxArgs& a, int n,
                                             long long grp) {
  Rows<G> x;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const long long i = grp * G + g;
    int r = 0, t = 0;
    if (i < n) {
      r = a.src_rows ? __ldg(a.src_rows + i) : a.row0 + (int)i;
      t = a.dst_rows ? __ldg(a.dst_rows + i) : r;
    }
    x.r[g] = r;
    x.t[g] = t;
  }
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of row group `grp`'s table slab into shared memory.
template <int W, int B>
__device__ __forceinline__ void issue_slab(const RelaxArgs& a, int n,
                                           const Rows<VecShape<W, B>::kG>& x,
                                           long long grp, int* sn, int* sw,
                                           uint8_t* so, int lane) {
  using S = VecShape<W, B>;
  constexpr int kCh = W / 4;           // 16-byte chunks per table row
  constexpr int kChunks = S::kG * kCh;  // per table, <= 16
  if (lane < 2 * kChunks) {
    const int q = lane % kChunks;
    const int g = q / kCh, c = q % kCh;
    if (grp * S::kG + g < n) {
      const size_t off = (size_t)pick(x.r, g) * W + c * 4;
      if (lane < kChunks)
        cp_async16(sn + g * W + c * 4, a.nbr + off);
      else
        cp_async16(sw + g * W + c * 4, a.wgt + off);
    }
  }
  if (a.over) {
    constexpr int kCo = W / 8;  // 8-byte chunks per over row
    if (lane < S::kG * kCo) {
      const int g = lane / kCo, c = lane % kCo;
      if (grp * S::kG + g < n)
        cp_async8(so + g * W + c * 8,
                  a.over + (size_t)pick(x.r, g) * W + c * 8);
    }
  }
}

// Relaxes one row group whose table slab has landed in shared memory;
// adds to this lane's counts of better entries and newly flagged rows.
template <int W, int B, bool OVER>
__device__ __forceinline__ void relax_group(
    const RelaxArgs& a, int n, const Rows<VecShape<W, B>::kG>& x,
    long long grp, const int* sn, const int* sw, const uint8_t* so, int lane,
    int& n_better, int& n_rows) {
  using S = VecShape<W, B>;
  const int c = lane % S::kL;  // column quad: columns 4c .. 4c+3
  const int s = lane / S::kL;
  const int g = s / S::kSR;    // row of the group
  const int ds = s % S::kSR;   // first slot of this lane
  const bool valid = grp * S::kG + g < n;
  const int t = pick(x.t, g);
  // the target row's reads go out first, with the gathers below
  const bool writer = valid && ds < S::kNW;  // writes columns 4c + j
  const bool leader = valid && ds == 0 && c == 0;  // flags the row
  const size_t t_idx = (size_t)t * B + 4 * c + ds * S::kCPL;
  int cur[S::kCPL], din[S::kCPL];
#pragma unroll
  for (int e = 0; e < S::kCPL; ++e) {
    cur[e] = writer ? __ldcg(a.out + t_idx + e) : kInf;
    din[e] = writer && a.changed ? __ldcg(a.dist_in + t_idx + e) : kInf;
  }
  const int flag0 = leader && a.row_flag ? __ldcg(a.row_flag + t) : 1;

  const int* sn_g = sn + g * W;
  const int* sw_g = sw + g * W;
  const uint8_t* so_g = so + g * W;
  int r0 = -1, r1 = -1, r2 = -1, r3 = -1;
  if (OVER) {
    r0 = __ldg(a.roots + 4 * c);
    r1 = __ldg(a.roots + 4 * c + 1);
    r2 = __ldg(a.roots + 4 * c + 2);
    r3 = __ldg(a.roots + 4 * c + 3);
  }
  const int4* dist4 = reinterpret_cast<const int4*>(a.dist_in) + c;

  int4 acc = make_int4(kInf, kInf, kInf, kInf);
#pragma unroll
  for (int k0 = 0; k0 < S::kK; k0 += S::kChunk) {
    int4 v[S::kChunk];
    int wv[S::kChunk];
    unsigned blk[S::kChunk];
#pragma unroll
    for (int k = 0; k < S::kChunk; ++k) {  // issue every gather first
      const int d = ds + (k0 + k) * S::kSR;
      const int u = sn_g[d];
      const int w = sw_g[d];
      unsigned m = 0;
      if (OVER && so_g[d])
        m = (unsigned)(u != r0) | (unsigned)(u != r1) << 1 |
            (unsigned)(u != r2) << 2 | (unsigned)(u != r3) << 3;
      v[k] = make_int4(kInf, kInf, kInf, kInf);
      if (valid && w < kInf && m != 0xFu)
        v[k] = __ldcg(dist4 + (size_t)u * (B / 4));
      wv[k] = w;
      if (OVER) blk[k] = m;
    }
#pragma unroll
    for (int k = 0; k < S::kChunk; ++k) {  // then take the mins
      const unsigned m = OVER ? blk[k] : 0u;
      acc.x = min(acc.x, cand(v[k].x, wv[k], m & 1u));
      acc.y = min(acc.y, cand(v[k].y, wv[k], m & 2u));
      acc.z = min(acc.z, cand(v[k].z, wv[k], m & 4u));
      acc.w = min(acc.w, cand(v[k].w, wv[k], m & 8u));
    }
  }
  // combine the slot lanes of each row (lane = s * kL + c)
#pragma unroll
  for (int off = S::kL; off < S::kL * S::kSR; off <<= 1) {
    acc.x = min(acc.x, __shfl_xor_sync(kFull, acc.x, off));
    acc.y = min(acc.y, __shfl_xor_sync(kFull, acc.y, off));
    acc.z = min(acc.z, __shfl_xor_sync(kFull, acc.z, off));
    acc.w = min(acc.w, __shfl_xor_sync(kFull, acc.w, off));
  }
  // every slot lane now holds its row's quad; kNW of them write it
  bool lowered = false;
  if (writer) {
#pragma unroll
    for (int e = 0; e < S::kCPL; ++e) {
      const int j = ds * S::kCPL + e;
      const int val = j == 0 ? acc.x : j == 1 ? acc.y : j == 2 ? acc.z : acc.w;
      if (val < din[e]) ++n_better;
      if (val < cur[e]) {
        atomicMin(a.out + t_idx + e, val);
        lowered = true;
      }
    }
  }
  if (a.row_flag) {
    constexpr int kRowLanes = S::kSR * S::kL;  // 32 / kG
    const unsigned lb = __ballot_sync(kFull, lowered);
    const unsigned gm = kRowLanes == 32
                            ? kFull
                            : ((1u << (kRowLanes & 31)) - 1u) << (g * kRowLanes);
    if (leader && (lb & gm) && flag0 == 0 &&
        atomicExch(a.row_flag + t, 1) == 0)
      ++n_rows;
  }
}

template <int W, int B, bool OVER, bool GUARD>
__global__ void __launch_bounds__(kThreads)
    relax_vec_kernel(const RelaxArgs a) {
  using S = VecShape<W, B>;
  const int n = GUARD ? live_rows(a) : a.n;
  if (GUARD && n == 0) return;
  __shared__ __align__(16) int s_nbr[kWarpsPerBlock][2][S::kSlots];
  __shared__ __align__(16) int s_wgt[kWarpsPerBlock][2][S::kSlots];
  __shared__ __align__(16) uint8_t s_over[kWarpsPerBlock][2][S::kSlots];
  __shared__ int s_sum[2];
  if (threadIdx.x < 2) s_sum[threadIdx.x] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n_groups = ((long long)n + S::kG - 1) / S::kG;
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  long long grp = (long long)blockIdx.x * kWarpsPerBlock + warp;
  int n_better = 0, n_rows = 0;
  if (grp < n_groups) {  // uniform across the warp
    Rows<S::kG> cur = load_rows<S::kG>(a, n, grp);
    Rows<S::kG> nxt = load_rows<S::kG>(a, n, grp + stride);
    issue_slab<W, B>(a, n, cur, grp, s_nbr[warp][0], s_wgt[warp][0],
                     s_over[warp][0], lane);
    cp_async_commit();
    int st = 0;
    for (; grp < n_groups; grp += stride) {
      const Rows<S::kG> after = load_rows<S::kG>(a, n, grp + 2 * stride);
      if (grp + stride < n_groups)
        issue_slab<W, B>(a, n, nxt, grp + stride, s_nbr[warp][st ^ 1],
                         s_wgt[warp][st ^ 1], s_over[warp][st ^ 1], lane);
      cp_async_commit();
      cp_async_wait<1>();  // this lane's copies of the current slab landed
      __syncwarp();        // ... and every other lane's
      relax_group<W, B, OVER>(a, n, cur, grp, s_nbr[warp][st], s_wgt[warp][st],
                        s_over[warp][st], lane, n_better, n_rows);
      __syncwarp();  // the slab is read before it is refilled
      cur = nxt;
      nxt = after;
      st ^= 1;
    }
    cp_async_wait<0>();
  }
  if (a.changed) block_add(a.changed, n_better, s_sum);
  if (a.rows_changed) block_add(a.rows_changed, n_rows, s_sum + 1);
}

// ------------------------------------------------------------- generic

constexpr int kSlab = 128;  // table slots a warp stages per unit

// The generic kernel's shape, worked out on the host from (W, B).
struct GenShape {
  int Q;        // column quads, B / 4
  int L;        // lanes over one strip of quads (a power of two <= 32)
  int S;        // slot lanes, 32 / L
  int windows;  // column windows per row (each NP strips of L quads)
  int chunks;   // table slabs of kSlab slots per row
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ int row_of(const RelaxArgs& a, long long i) {
  return a.src_rows ? __ldg(a.src_rows + i) : a.row0 + (int)i;
}

__device__ __forceinline__ int target_of(const RelaxArgs& a, long long i,
                                         int r) {
  return a.dst_rows ? __ldg(a.dst_rows + i) : r;
}

// Starts the copy of slots [c * kSlab, c * kSlab + len) of table row r
// into shared memory: nbr and wgt in 16-byte pieces, over in 4-byte ones
// (W is a multiple of 4 on this path, so every piece is aligned).
template <bool OVER>
__device__ __forceinline__ void issue_chunk(const RelaxArgs& a, int r, int c,
                                            int* sn, int* sw, uint8_t* so,
                                            int lane) {
  const int d0 = c * kSlab;
  const int q = min(kSlab, a.W - d0) / 4;  // pieces per table
  const size_t off = (size_t)r * a.W + d0;
  for (int j = lane; j < (OVER ? 3 : 2) * q; j += 32) {
    if (j < q)
      cp_async16(sn + 4 * j, a.nbr + off + 4 * j);
    else if (j < 2 * q)
      cp_async16(sw + 4 * (j - q), a.wgt + off + 4 * (j - q));
    else
      cp_async4(so + 4 * (j - 2 * q), a.over + off + 4 * (j - 2 * q));
  }
}

// Wide path: one warp per table row, its lanes over a strip of L column
// quads (16-byte loads of the gathered dist rows) and S = 32 / L slot
// lanes; NP strips per window, so a lane carries NP quads (B 128: one
// strip of 32 quads, a warp instruction gathers a whole 512-byte row; B
// 256: two). A row is walked in units (column window, slab of kSlab
// slots); each unit's slab is staged in shared memory with cp.async while
// the one before it is relaxed (double buffer), and the row indices are
// read two rows ahead. A unit issues kBatch slots x NP gathers before the
// first min. The last unit of a window reads the target row (out, and
// dist_in for `changed`) and its flag ahead of its gathers, folds the slot
// lanes with __shfl_xor_sync and writes with a fire-and-forget min.
template <int NP, bool OVER>
__device__ __forceinline__ void relax_generic_wide(const RelaxArgs& a,
                                                   int n, const GenShape& g) {
  constexpr int kBatch = 8 / NP;  // slots a lane gathers at once
  __shared__ __align__(16) int s_nbr[kWarpsPerBlock][2][kSlab];
  __shared__ __align__(16) int s_wgt[kWarpsPerBlock][2][kSlab];
  __shared__ __align__(16) uint8_t s_over[kWarpsPerBlock][2][kSlab];
  __shared__ int s_sum[2];
  if (threadIdx.x < 2) s_sum[threadIdx.x] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cl = lane % g.L;  // quad of the strip
  const int s = lane / g.L;   // slot lane
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  long long i = (long long)blockIdx.x * kWarpsPerBlock + warp;
  const int4* dist4 = reinterpret_cast<const int4*>(a.dist_in);
  const int4* out4 = reinterpret_cast<const int4*>(a.out);
  int n_better = 0, n_rows = 0;
  if (i < n) {  // uniform across the warp
    int r = row_of(a, i), t = target_of(a, i, r);
    int nr = 0, nt = 0, ar = 0, at = 0;  // rows i + stride, i + 2 stride
    if (i + stride < n) {
      nr = row_of(a, i + stride);
      nt = target_of(a, i + stride, nr);
    }
    int w = 0, c = 0, st = 0, roots_w = -1;
    int rt[NP][4];
    int4 acc[NP];
    issue_chunk<OVER>(a, r, 0, s_nbr[warp][0], s_wgt[warp][0],
                      s_over[warp][0], lane);
    cp_async_commit();
    while (true) {
      if (w == 0 && c == 0 && i + 2 * stride < n) {
        ar = row_of(a, i + 2 * stride);
        at = target_of(a, i + 2 * stride, ar);
      }
      // the next unit: the next slab, window or row
      int nw = w, nc = c + 1;
      bool same_row = true;
      if (nc == g.chunks) {
        nc = 0;
        if (++nw == g.windows) {
          nw = 0;
          same_row = false;
        }
      }
      const bool has_next = same_row || i + stride < n;
      if (has_next)
        issue_chunk<OVER>(a, same_row ? r : nr, nc, s_nbr[warp][st ^ 1],
                          s_wgt[warp][st ^ 1], s_over[warp][st ^ 1], lane);
      cp_async_commit();

      const bool last = c == g.chunks - 1;
      const int qb = w * NP * g.L + cl;  // this lane's first quad
      if (c == 0) {
#pragma unroll
        for (int p = 0; p < NP; ++p) acc[p] = make_int4(kInf, kInf, kInf, kInf);
      }
      if (OVER && roots_w != w) {
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = qb + p * g.L;
            rt[p][e] = q < g.Q ? __ldg(a.roots + 4 * q + e) : -1;
          }
        roots_w = w;
      }
      // the target row's reads go out with the last unit's gathers
      const bool writer = last && s == 0;
      int4 cur[NP], din[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int q = qb + p * g.L;
        cur[p] = din[p] = make_int4(kInf, kInf, kInf, kInf);
        if (writer && q < g.Q) {
          cur[p] = __ldcg(out4 + (size_t)t * g.Q + q);
          if (a.changed) din[p] = __ldcg(dist4 + (size_t)t * g.Q + q);
        }
      }
      const int flag0 =
          last && lane == 0 && a.row_flag ? __ldcg(a.row_flag + t) : 1;

      cp_async_wait<1>();  // this lane's copies of the current slab landed
      __syncwarp();        // ... and every other lane's
      const int* sn = s_nbr[warp][st];
      const int* sw = s_wgt[warp][st];
      const uint8_t* so = s_over[warp][st];
      const int len = min(kSlab, a.W - c * kSlab);
      for (int d0 = 0; d0 < len; d0 += kBatch * g.S) {
        int4 v[kBatch][NP];
        int wv[kBatch];
        unsigned blk[kBatch][NP];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {  // issue every gather first
          const int d = d0 + k * g.S + s;
          const bool in = d < len;
          const int u = in ? sn[d] : 0;
          const int wt = in ? sw[d] : kInf;
          const bool o = OVER && in && so[d];
          wv[k] = wt;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const int q = qb + p * g.L;
            unsigned m = 0;
            if (o)
              m = (unsigned)(u != rt[p][0]) | (unsigned)(u != rt[p][1]) << 1 |
                  (unsigned)(u != rt[p][2]) << 2 |
                  (unsigned)(u != rt[p][3]) << 3;
            blk[k][p] = m;
            v[k][p] = make_int4(kInf, kInf, kInf, kInf);
            if (wt < kInf && q < g.Q && m != 0xFu)
              v[k][p] = __ldcg(dist4 + (size_t)u * g.Q + q);
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k)  // then take the mins
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const unsigned m = blk[k][p];
            acc[p].x = min(acc[p].x, cand(v[k][p].x, wv[k], m & 1u));
            acc[p].y = min(acc[p].y, cand(v[k][p].y, wv[k], m & 2u));
            acc[p].z = min(acc[p].z, cand(v[k][p].z, wv[k], m & 4u));
            acc[p].w = min(acc[p].w, cand(v[k][p].w, wv[k], m & 8u));
          }
      }
      __syncwarp();  // the slab is read before it is refilled

      if (last) {
        // fold the slot lanes (lane = s * L + cl)
        for (int off = g.L; off < 32; off <<= 1)
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            acc[p].x = min(acc[p].x, __shfl_xor_sync(kFull, acc[p].x, off));
            acc[p].y = min(acc[p].y, __shfl_xor_sync(kFull, acc[p].y, off));
            acc[p].z = min(acc[p].z, __shfl_xor_sync(kFull, acc[p].z, off));
            acc[p].w = min(acc[p].w, __shfl_xor_sync(kFull, acc[p].w, off));
          }
        bool lowered = false;
        if (writer) {
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const int q = qb + p * g.L;
            if (q >= g.Q) continue;
            const int val[4] = {acc[p].x, acc[p].y, acc[p].z, acc[p].w};
            const int cv[4] = {cur[p].x, cur[p].y, cur[p].z, cur[p].w};
            const int dv[4] = {din[p].x, din[p].y, din[p].z, din[p].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (a.changed && val[e] < dv[e]) ++n_better;
              if (val[e] < cv[e]) {
                atomicMin(a.out + (size_t)t * (4 * g.Q) + 4 * q + e, val[e]);
                lowered = true;
              }
            }
          }
        }
        if (a.row_flag && __any_sync(kFull, lowered) && lane == 0 &&
            flag0 == 0 && atomicExch(a.row_flag + t, 1) == 0)
          ++n_rows;
      }
      if (!has_next) break;
      if (!same_row) {
        i += stride;
        r = nr;
        t = nt;
        nr = ar;
        nt = at;
      }
      w = nw;
      c = nc;
      st ^= 1;
    }
    cp_async_wait<0>();
  }
  if (a.changed) block_add(a.changed, n_better, s_sum);
  if (a.rows_changed) block_add(a.rows_changed, n_rows, s_sum + 1);
}

// Scalar edge path, for B or W not a multiple of 4: one warp per row,
// lanes over the B columns, 32 table slots loaded at once and broadcast
// with __shfl_sync, 4-byte gathers.
template <bool OVER>
__device__ __forceinline__ void relax_generic_scalar(const RelaxArgs& a,
                                                     int n) {
  const int lane = threadIdx.x & 31;
  const long long i =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  int n_rows = 0;
  if (i < n) {  // uniform across the warp
    int n_better = 0;
    const int B = a.B, W = a.W;
    const int r = row_of(a, i);
    const int t = target_of(a, i, r);
    const int* nrow = a.nbr + (size_t)r * W;
    const int* wrow = a.wgt + (size_t)r * W;
    const uint8_t* orow = OVER ? a.over + (size_t)r * W : nullptr;
    bool lowered = false;
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int b = b0 + lane;
      const bool active = b < B;
      const int root_b = (OVER && active) ? a.roots[b] : -1;
      int acc = kInf;
      for (int d0 = 0; d0 < W; d0 += 32) {
        const int dl = d0 + lane;
        int my_u = 0, my_w = kInf, my_o = 0;
        if (dl < W) {
          my_u = nrow[dl];
          my_w = wrow[dl];
          my_o = OVER ? (int)orow[dl] : 0;
        }
        const int cnt = min(32, W - d0);
        for (int k = 0; k < cnt; ++k) {
          const int w = __shfl_sync(kFull, my_w, k);
          const int u = __shfl_sync(kFull, my_u, k);
          const int o = __shfl_sync(kFull, my_o, k);
          // padding slot: d + INF >= INF, so the candidate is INF
          if (w >= kInf || !active) continue;
          if (o && u != root_b) continue;  // overloaded transit, not root
          const int g = a.dist_in[(size_t)u * B + b];
          if (g < kInf) acc = min(acc, min(g + w, kInf));  // guard, then add
        }
      }
      bool better = false;
      if (active) {
        const size_t o_idx = (size_t)t * B + b;
        if (a.changed) better = acc < a.dist_in[o_idx];
        if (acc < a.out[o_idx]) {
          atomicMin(a.out + o_idx, acc);
          lowered = true;
        }
      }
      if (a.changed) n_better += __popc(__ballot_sync(kFull, better));
    }
    if (a.changed && lane == 0 && n_better) atomicAdd(a.changed, n_better);
    if (a.row_flag && __any_sync(kFull, lowered) && lane == 0 &&
        __ldcg(a.row_flag + t) == 0 && atomicExch(a.row_flag + t, 1) == 0)
      n_rows = 1;
  }
  if (a.rows_changed) {  // one atomic per block of 8 rows
    const int nr = __syncthreads_count(n_rows);
    if (threadIdx.x == 0 && nr) atomicAdd(a.rows_changed, nr);
  }
}

// The generic kernel family: NP int4 strips per lane (1, 2, 4) on the
// wide path, 0 for the scalar edge path.
template <int NP, bool OVER, bool GUARD>
__global__ void __launch_bounds__(kThreads)
    relax_generic_kernel(const RelaxArgs a, const GenShape g) {
  const int n = GUARD ? live_rows(a) : a.n;
  if (GUARD && n == 0) return;
  if constexpr (NP == 0)
    relax_generic_scalar<OVER>(a, n);
  else
    relax_generic_wide<NP, OVER>(a, n, g);
}

using Launcher = int (*)(const RelaxArgs&, cudaStream_t);

// The blocks of `kernel` the card holds at once (a persistent grid's
// size), cached per device in `cache`.
template <class Kernel>
int resident_blocks(Kernel kernel, int (&cache)[kMaxDevices]) {
  int dev = 0;
  cudaGetDevice(&dev);
  int mb = dev < kMaxDevices ? cache[dev] : 0;
  if (mb == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    mb = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
    if (dev < kMaxDevices) cache[dev] = mb;
  }
  return mb;
}

template <int W, int B, bool OVER, bool GUARD>
int launch_vec_over(const RelaxArgs& a, cudaStream_t stream) {
  using S = VecShape<W, B>;
  static int max_blocks[kMaxDevices];
  const int mb =
      resident_blocks(relax_vec_kernel<W, B, OVER, GUARD>, max_blocks);
  const long long groups = ((long long)a.n + S::kG - 1) / S::kG;
  const long long want = (groups + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = (int)(want < mb ? want : mb);
  relax_vec_kernel<W, B, OVER, GUARD><<<blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The overload mask and the loop guard are template arguments: without
// them (the common case, and every launch outside the split loop) the
// kernel keeps no roots, per-slot mask or live count in registers; a
// row count held in a register costs the generic kernel a block per SM.
template <int W, int B>
int launch_vec(const RelaxArgs& a, cudaStream_t stream) {
  const bool guard = a.ctl || a.n_live;
  if (a.over)
    return guard ? launch_vec_over<W, B, true, true>(a, stream)
                 : launch_vec_over<W, B, true, false>(a, stream);
  return guard ? launch_vec_over<W, B, false, true>(a, stream)
               : launch_vec_over<W, B, false, false>(a, stream);
}

// The generic family's strips per lane for (W, B): 0 (the scalar edge
// path) where B or W is not a multiple of 4, else 1 up to 32 column quads
// (B 128), 2 up to 64 (B 256), 4 beyond (B 512, and windows of 512
// columns past it). ops/relax.py `generic_np` mirrors this.
int generic_np(int W, int B) {
  if (B % 4 || W % 4) return 0;
  const int q = B / 4;
  return q <= 32 ? 1 : q <= 64 ? 2 : 4;
}

GenShape gen_shape(int W, int B, int np) {
  GenShape g;
  g.Q = B / 4;
  g.L = 32;
  if (np == 1)
    while (g.L / 2 >= g.Q) g.L /= 2;  // the least power of two >= Q
  g.S = 32 / g.L;
  const int per_window = (np > 0 ? np : 1) * g.L;  // np 0: not read
  g.windows = (g.Q + per_window - 1) / per_window;
  g.chunks = (W + kSlab - 1) / kSlab;
  return g;
}

template <int NP, bool OVER, bool GUARD>
int launch_generic_np(const RelaxArgs& a, cudaStream_t stream) {
  long long want = ((long long)a.n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (NP > 0) {  // the wide path strides a persistent grid over the rows
    static int max_blocks[kMaxDevices];
    const int mb = resident_blocks(relax_generic_kernel<NP, OVER, GUARD>,
                                   max_blocks);
    if (want > mb) want = mb;
  }
  relax_generic_kernel<NP, OVER, GUARD>
      <<<(unsigned)want, kThreads, 0, stream>>>(a, gen_shape(a.W, a.B, NP));
  return (int)cudaGetLastError();
}

template <bool OVER, bool GUARD>
int launch_generic_over(const RelaxArgs& a, cudaStream_t stream) {
  switch (generic_np(a.W, a.B)) {
    case 1: return launch_generic_np<1, OVER, GUARD>(a, stream);
    case 2: return launch_generic_np<2, OVER, GUARD>(a, stream);
    case 4: return launch_generic_np<4, OVER, GUARD>(a, stream);
    default: return launch_generic_np<0, OVER, GUARD>(a, stream);
  }
}

int launch_generic(const RelaxArgs& a, cudaStream_t stream) {
  const bool guard = a.ctl || a.n_live;
  if (a.over)
    return guard ? launch_generic_over<true, true>(a, stream)
                 : launch_generic_over<true, false>(a, stream);
  return guard ? launch_generic_over<false, true>(a, stream)
               : launch_generic_over<false, false>(a, stream);
}

int width_index(int x) {
  switch (x) {
    case 8: return 0;
    case 16: return 1;
    case 32: return 2;
    case 64: return 3;
    default: return -1;
  }
}

template <int W>
Launcher vec_for_b(int B) {
  switch (width_index(B)) {
    case 0: return launch_vec<W, 8>;
    case 1: return launch_vec<W, 16>;
    case 2: return launch_vec<W, 32>;
    case 3: return launch_vec<W, 64>;
    default: return nullptr;
  }
}

// The vectorised specialisation for (W, B), or nullptr: the generic one.
Launcher vec_launcher(int W, int B) {
  switch (width_index(W)) {
    case 0: return vec_for_b<8>(B);
    case 1: return vec_for_b<16>(B);
    case 2: return vec_for_b<32>(B);
    case 3: return vec_for_b<64>(B);
    default: return nullptr;
  }
}

RelaxArgs make_args(const void* dist_in, void* out, int B, const void* nbr,
                    const void* wgt, const void* over, int W,
                    const void* roots, const void* src_rows,
                    const void* dst_rows, int row0, int n, void* changed,
                    void* row_flag, void* rows_changed,
                    const void* ctl = nullptr, int phase_mask = 0,
                    const void* n_live = nullptr) {
  RelaxArgs a;
  a.dist_in = (const int*)dist_in;
  a.out = (int*)out;
  a.nbr = (const int*)nbr;
  a.wgt = (const int*)wgt;
  a.over = (const uint8_t*)over;
  a.roots = (const int*)roots;
  a.src_rows = (const int*)src_rows;
  a.dst_rows = (const int*)dst_rows;
  a.changed = (int*)changed;
  a.row_flag = (int*)row_flag;
  a.rows_changed = (int*)rows_changed;
  a.ctl = (const int*)ctl;
  a.n_live = (const int*)n_live;
  a.phase_mask = phase_mask;
  a.B = B;
  a.W = W;
  a.row0 = row0;
  a.n = n;
  return a;
}

}  // namespace

// 1 if (W, B) takes the vectorised specialisation, 0 if the generic kernel.
extern "C" int openr_relax_vec_shape(int W, int B) {
  return vec_launcher(W, B) != nullptr;
}

// The generic kernel's strips per lane at (W, B): 0 for its scalar edge
// path, else 1, 2 or 4 (`generic_np`).
extern "C" int openr_relax_generic_np(int W, int B) {
  return generic_np(W, B);
}

// The kernel for this shape: the vectorised specialisation where one
// exists, else the generic kernel.
extern "C" int openr_relax_rows(
    const void* dist_in, void* out, int B,
    const void* nbr, const void* wgt, const void* over, int W,
    const void* roots, const void* src_rows, const void* dst_rows,
    int row0, int n, void* changed, void* row_flag, void* rows_changed,
    void* stream) {
  if (n <= 0 || W <= 0 || B <= 0) return 0;  // nothing to relax
  const RelaxArgs a = make_args(dist_in, out, B, nbr, wgt, over, W, roots,
                                src_rows, dst_rows, row0, n, changed,
                                row_flag, rows_changed);
  const Launcher vec = vec_launcher(W, B);
  return vec ? vec(a, (cudaStream_t)stream)
             : launch_generic(a, (cudaStream_t)stream);
}

// openr_relax_rows under the split loop's guard: the launch does nothing
// unless bit ctl[0] of phase_mask is set, and relaxes only the first
// *n_live listed rows where n_live is given (n sizes the grid).
extern "C" int openr_relax_rows_guarded(
    const void* dist_in, void* out, int B,
    const void* nbr, const void* wgt, const void* over, int W,
    const void* roots, const void* src_rows, const void* dst_rows,
    int row0, int n, void* changed, void* row_flag, void* rows_changed,
    const void* ctl, int phase_mask, const void* n_live, void* stream) {
  if (n <= 0 || W <= 0 || B <= 0) return 0;  // nothing to relax
  const RelaxArgs a = make_args(dist_in, out, B, nbr, wgt, over, W, roots,
                                src_rows, dst_rows, row0, n, changed,
                                row_flag, rows_changed, ctl, phase_mask,
                                n_live);
  const Launcher vec = vec_launcher(W, B);
  return vec ? vec(a, (cudaStream_t)stream)
             : launch_generic(a, (cudaStream_t)stream);
}

// The generic kernel at any shape (to time both designs side by side).
extern "C" int openr_relax_rows_generic(
    const void* dist_in, void* out, int B,
    const void* nbr, const void* wgt, const void* over, int W,
    const void* roots, const void* src_rows, const void* dst_rows,
    int row0, int n, void* changed, void* row_flag, void* rows_changed,
    void* stream) {
  if (n <= 0 || W <= 0 || B <= 0) return 0;  // nothing to relax
  return launch_generic(
      make_args(dist_in, out, B, nbr, wgt, over, W, roots, src_rows,
                dst_rows, row0, n, changed, row_flag, rows_changed),
      (cudaStream_t)stream);
}

extern "C" const char* openr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
