// Pull-relax of a set of rows of an in-neighbor table, for Hopper (sm_90a).
//
// Replaces the one Pallas TPU kernel of the JAX package,
// openr_tpu/ops/spf_pallas.py _relax_kernel (via _relax_once), and serves
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
//   out[t, b] = atomicMin(out[t, b], acc)
//   *changed += #{b : acc < dist_in[t, b]}          (if changed != nullptr)
//
// Targets may repeat (the dead slot vp-1 pads ov_ids and the tail lists),
// hence the atomicMin into an `out` the caller prepared. `out` may alias
// `dist_in` (the Gauss-Seidel chunks update dist in place): every value
// either buffer holds is a valid upper bound of the true distance, so a
// read that races a write changes only how fast the fixpoint is reached,
// never which fixpoint.
//
// Bound on this card: bytes. Each candidate is one 4-byte gather and three
// integer ops; the table rows and the gathered dist rows have to come from
// memory (dist [vp,B] is 13.6 MB at the 100k benchmark and stays in the
// 50 MB L2). Design: one warp per row with lanes over the B columns, so a
// gathered dist row at B=32 is one 128-byte line; the warp loads 32 table
// slots at once, coalesced, and broadcasts them with __shfl_sync.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__global__ void relax_rows_kernel(
    const int* dist_in, int* out, int B,
    const int* __restrict__ nbr, const int* __restrict__ wgt,
    const uint8_t* __restrict__ over, int W,
    const int* __restrict__ roots,
    const int* __restrict__ src_rows, const int* __restrict__ dst_rows,
    int row0, int n, int* changed) {
  const int lane = threadIdx.x & 31;
  const long long i =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n) return;  // uniform across the warp
  const int r = src_rows ? src_rows[i] : row0 + (int)i;
  const int t = dst_rows ? dst_rows[i] : r;
  const int* nrow = nbr + (size_t)r * W;
  const int* wrow = wgt + (size_t)r * W;
  const uint8_t* orow = over ? over + (size_t)r * W : nullptr;

  int n_better = 0;
  for (int b0 = 0; b0 < B; b0 += 32) {
    const int b = b0 + lane;
    const bool active = b < B;
    const int root_b = (active && orow) ? roots[b] : -1;
    int acc = kInf;
    for (int d0 = 0; d0 < W; d0 += 32) {
      const int dl = d0 + lane;
      int my_u = 0, my_w = kInf, my_o = 0;
      if (dl < W) {
        my_u = nrow[dl];
        my_w = wrow[dl];
        my_o = orow ? (int)orow[dl] : 0;
      }
      const int cnt = min(32, W - d0);
      for (int k = 0; k < cnt; ++k) {
        const int w = __shfl_sync(kFull, my_w, k);
        const int u = __shfl_sync(kFull, my_u, k);
        const int o = __shfl_sync(kFull, my_o, k);
        // padding slot: d + INF >= INF, so the candidate is INF
        if (w >= kInf || !active) continue;
        if (o && u != root_b) continue;  // overloaded transit, not root
        const int g = dist_in[(size_t)u * B + b];
        if (g < kInf) acc = min(acc, min(g + w, kInf));  // guard, then add
      }
    }
    bool better = false;
    if (active) {
      const size_t o_idx = (size_t)t * B + b;
      if (changed) better = acc < dist_in[o_idx];
      if (acc < out[o_idx]) atomicMin(out + o_idx, acc);
    }
    if (changed) n_better += __popc(__ballot_sync(kFull, better));
  }
  if (changed && lane == 0 && n_better) atomicAdd(changed, n_better);
}

}  // namespace

extern "C" int openr_relax_rows(
    const void* dist_in, void* out, int B,
    const void* nbr, const void* wgt, const void* over, int W,
    const void* roots, const void* src_rows, const void* dst_rows,
    int row0, int n, void* changed, void* stream) {
  if (n <= 0) return 0;
  const int threads = 32 * kWarpsPerBlock;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  relax_rows_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)dist_in, (int*)out, B, (const int*)nbr, (const int*)wgt,
      (const uint8_t*)over, W, (const int*)roots, (const int*)src_rows,
      (const int*)dst_rows, row0, n, (int*)changed);
  return (int)cudaGetLastError();
}

extern "C" const char* openr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
