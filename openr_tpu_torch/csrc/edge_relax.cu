// Edge-list Bellman-Ford (the batched multi-root SSSP over the padded CSR
// edge list), for Hopper (sm_90a).
//
// Replaces the jitted XLA function of the JAX package
// openr_tpu/ops/spf.py:52 batched_sssp: a gather of dist[edge_src], an add
// and a segment_min by edge_dst per round, to the fixpoint. Two kernels:
//
// edge_init_kernel, the round-free start (the per-root exemption of an
// overloaded root): for each node v and column b,
//
//   dist[v, b] = min(INF, min over edges e into v with src(e) == roots[b]
//                          of metric(e))             (blocked edges too)
//   dist[roots[b], b] = 0
//
// edge_relax_kernel, one Jacobi round from dist_in into dist_out:
//
//   dist_out[v, b] = min(dist_in[v, b],
//                        min over edges e into v, not blocked, with
//                            d = dist_in[src(e), b] < INF
//                        of min(d + metric(e), INF))
//
// and sets *changed to 1 if any entry dropped. The host zeroes the word
// before each round and reads it after (one read per round); it stops at
// the first round that changes nothing, after at most V rounds, as the
// reference's while_loop does. dist_in and dist_out are distinct buffers,
// so every candidate of a round is taken from the previous round's values
// and the round count equals the reference's.
//
// Layout: the edge slots are sorted by dst (the CsrGraph layout, padding
// edges last, into the dead slot V-1 with metric INF and blocked), and
// row_start[v] .. row_start[v+1] is v's run of them, built on the host once
// per table set. The reference builds an [E, B] candidate tensor and
// scatter-mins it; here each node pulls over its own run, so nothing of size
// E x B exists (2.25 GB at BASELINE config 3: 2.2 M edges, B = 256).
//
// Design: a thread per (node, strip of NV columns): NV = 4 (one 16-byte
// load of four int32 columns) where B is a multiple of 4, else NV = 1. The
// threads of a node are consecutive, so the strips of one gathered row are
// one coalesced read (512 bytes for a warp at B >= 128), and the node's
// src, metric and blocked words are the same address across them (one
// broadcast load). Each thread walks its node's run kUnroll edges at a
// time: it loads their src, metric and blocked together (one round trip),
// then issues the kUnroll gathers before the first min, so kUnroll 16-byte
// loads are in flight a thread. The runs leave out the CsrGraph's trailing
// INF padding (edge_row_start with the metrics): every padding slot goes to
// the dead slot, whose run would otherwise hold ~2 M slots at 100k nodes,
// walked by that node's threads alone while the rest of the grid idles.
// A block's threads that lowered anything set a shared flag; one thread a
// block writes the device word, so a round costs at most one atomic a
// block. INF-guarded adds: d < INF is tested before d + metric, and
// METRIC_MAX = 2^30 - 1, so the sum stays below 2^31.
//
// Bound on this card: the gathers. A round reads dist_in once and writes
// dist_out once (2 x V x B x 4 bytes), and reads the edge arrays once (9 B
// an edge), but gathers a B-wide row for every usable edge: E x B x 4 bytes
// (2.25 GB at config 3), more than the 50 MB L2 holds, so mostly from HBM.
// A node with a long run (a hub of thousands of in-edges) is walked by its
// own threads alone while the rest of the grid has finished: right, but
// slow; a warp per long run is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // edges whose gathers a thread issues at once

struct EdgeArgs {
  const int* dist_in;     // [V, B] (round)
  int* dist_out;          // [V, B]
  const int* row_start;   // [V + 1]
  const int* src;         // [E]
  const int* metric;      // [E]
  const uint8_t* blocked; // [E] (round)
  const int* roots;       // [B] (init)
  int* changed;           // [1] (round)
  int V;
  int B;
};

template <int NV>
__device__ __forceinline__ void load_cols(const int* p, int (&x)[NV]) {
  if constexpr (NV == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int NV>
__device__ __forceinline__ void store_cols(int* p, const int (&x)[NV]) {
  if constexpr (NV == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(x[0], x[1], x[2], x[3]);
  } else {
    p[0] = x[0];
  }
}

// One thread per (node, strip); a grid-stride loop over V x (B / NV).
template <int NV>
__global__ void __launch_bounds__(kThreads)
edge_init_kernel(const EdgeArgs a) {
  const int tpr = a.B / NV;  // threads a node
  const long long total = (long long)a.V * tpr;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int v = (int)(t / tpr);
    const int c0 = (int)(t % tpr) * NV;
    int r[NV], best[NV];
    load_cols<NV>(a.roots + c0, r);
#pragma unroll
    for (int k = 0; k < NV; ++k) best[k] = kInf;
    const int lo = __ldg(a.row_start + v), hi = __ldg(a.row_start + v + 1);
    for (int e = lo; e < hi; ++e) {
      const int u = __ldg(a.src + e);
      const int w = __ldg(a.metric + e);
#pragma unroll
      for (int k = 0; k < NV; ++k)
        if (u == r[k]) best[k] = min(best[k], w);
    }
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (r[k] == v) best[k] = 0;
    store_cols<NV>(a.dist_out + (size_t)v * a.B + c0, best);
  }
}

template <int NV>
__global__ void __launch_bounds__(kThreads)
edge_relax_kernel(const EdgeArgs a) {
  __shared__ int block_changed;
  if (threadIdx.x == 0) block_changed = 0;
  __syncthreads();
  const int tpr = a.B / NV;
  const long long total = (long long)a.V * tpr;
  bool lowered = false;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int v = (int)(t / tpr);
    const int c0 = (int)(t % tpr) * NV;
    int cur[NV], best[NV];
    load_cols<NV>(a.dist_in + (size_t)v * a.B + c0, cur);
#pragma unroll
    for (int k = 0; k < NV; ++k) best[k] = cur[k];
    const int lo = __ldg(a.row_start + v), hi = __ldg(a.row_start + v + 1);
    for (int e0 = lo; e0 < hi; e0 += kUnroll) {
      int us[kUnroll], ws[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {  // one round trip for all three
        const int e = e0 + j;
        const bool in = e < hi;
        const uint8_t bl = in ? __ldg(a.blocked + e) : 1;
        us[j] = in ? __ldg(a.src + e) : 0;
        ws[j] = in ? __ldg(a.metric + e) : 0;
        ok[j] = bl == 0;
      }
      int d[kUnroll][NV];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (ok[j]) {
          load_cols<NV>(a.dist_in + (size_t)us[j] * a.B + c0, d[j]);
        } else {
#pragma unroll
          for (int k = 0; k < NV; ++k) d[j][k] = kInf;
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
#pragma unroll
        for (int k = 0; k < NV; ++k)
          if (d[j][k] < kInf)
            best[k] = min(best[k], min(d[j][k] + ws[j], kInf));
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) lowered |= best[k] < cur[k];
    store_cols<NV>(a.dist_out + (size_t)v * a.B + c0, best);
  }
  if (lowered) block_changed = 1;  // every writer stores the same value
  __syncthreads();
  if (threadIdx.x == 0 && block_changed) atomicOr(a.changed, 1);
}

// Columns a thread carries at B: 4 where B is a multiple of 4, else 1.
int cols_per_thread(int B) { return B % 4 == 0 ? 4 : 1; }

unsigned grid_for(int V, int B) {
  const long long total = (long long)V * (B / cols_per_thread(B));
  long long blocks = (total + kThreads - 1) / kThreads;
  // past 2^30 blocks the grid-stride loop takes the rest
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

}  // namespace

extern "C" int openr_edge_init(void* dist_out, const void* row_start,
                               const void* src, const void* metric,
                               const void* roots, int V, int B,
                               void* stream) {
  if (V <= 0 || B <= 0) return 0;
  EdgeArgs a = {};
  a.dist_out = (int*)dist_out;
  a.row_start = (const int*)row_start;
  a.src = (const int*)src;
  a.metric = (const int*)metric;
  a.roots = (const int*)roots;
  a.V = V;
  a.B = B;
  cudaStream_t s = (cudaStream_t)stream;
  if (cols_per_thread(B) == 4)
    edge_init_kernel<4><<<grid_for(V, B), kThreads, 0, s>>>(a);
  else
    edge_init_kernel<1><<<grid_for(V, B), kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int openr_edge_relax(const void* dist_in, void* dist_out,
                                const void* row_start, const void* src,
                                const void* metric, const void* blocked,
                                int V, int B, void* changed, void* stream) {
  if (V <= 0 || B <= 0) return 0;
  EdgeArgs a = {};
  a.dist_in = (const int*)dist_in;
  a.dist_out = (int*)dist_out;
  a.row_start = (const int*)row_start;
  a.src = (const int*)src;
  a.metric = (const int*)metric;
  a.blocked = (const uint8_t*)blocked;
  a.changed = (int*)changed;
  a.V = V;
  a.B = B;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (cols_per_thread(B) == 4)
    edge_relax_kernel<4><<<grid_for(V, B), kThreads, 0, s>>>(a);
  else
    edge_relax_kernel<1><<<grid_for(V, B), kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* openr_edge_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
