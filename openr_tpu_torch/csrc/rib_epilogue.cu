// The RIB epilogue of the split solve in one launch, for Hopper (sm_90a).
//
// Replaces the epilogue the JAX package fuses into the solve's dispatch,
// openr_tpu/ops/spf_split.py:524-532 (batched_sssp_split_rib): the ECMP
// first-hop matrix (openr_tpu/ops/spf.py:112 first_hop_matrix), the LFA
// matrix (:141 lfa_matrix) and the MSB-first jnp.packbits of each, behind
// the root's distance column as bytes. It writes the buffer
// ops/spf_split.py unpack_rib_buffer decodes:
//
//   [ d_root: vp int32 as 4·vp bytes
//   | fh:     N rows × vp/8 bytes (bit 7 of byte k = destination 8k)
//   | lfa:    N rows × vp/8 bytes, iff with_lfa ]
//
// with N = the neighbour count (dist columns 1..N) and, per neighbour n
// and destination d (INF = 2^30):
//
//   reach  = d_root(d) < INF && d_n(d) < INF            (guard before add)
//   fh     = reach && metric[n] + d_n(d) == d_root(d)
//   lfa    = reach && n_to_root[n] < INF && d_n(d) < n_to_root[n] + d_root(d)
//   allowed= !over[n] || d == ids[n]     (an overloaded neighbour still
//                                         reaches itself)
//   bit    = fh && allowed ;  lfa bit = lfa && allowed
//
// where n_to_root[n] = dist[my_id, 1 + n] (the neighbour's own column at
// the root's row: direction-correct under asymmetric metrics).
//
// Bound on this card: bytes. It must read dist [vp, B] once (13.6 MB at
// the 100k benchmark, B 32) and write 4·vp + N·vp/8 bytes (twice the bits
// with LFA; 838 656 bytes at the same shape), ~4.3 us at 3.35 TB/s; the
// compare work is a few integer operations a bit. Design: a block owns
// 256 destination rows
// (32 output bytes per neighbour row). It stages the rows' root column and
// then 32 neighbour columns at a time in shared memory with coalesced
// loads (a warp reads 32 consecutive columns of one row), stored so that
// the 8 rows behind one output byte sit 32 words apart: lane k of a warp
// then reads row 8k + j of its column with no bank conflict, builds its
// byte from 8 compares, and the warp writes 32 consecutive bytes. The
// root column goes out as int32 from the same stage.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr int kRows = 256;  // destination rows a block owns
constexpr int kCols = 32;   // neighbour columns staged at once
constexpr int kThreads = 256;
constexpr int kPitch = kRows + 1;  // words a staged column takes

// staged position of tile row r: the 8 rows of output byte k at 32 apart
__device__ __forceinline__ int swz(int r) { return (r & 7) * 32 + (r >> 3); }

__global__ void __launch_bounds__(kThreads)
    rib_epilogue_kernel(const int* __restrict__ dist, int vp, int B, int N,
                        const int* __restrict__ nbr_metric,
                        const int* __restrict__ nbr_ids,
                        const uint8_t* __restrict__ nbr_over, int my_id,
                        int with_lfa, uint8_t* __restrict__ out) {
  __shared__ int s_root[kRows];
  __shared__ int s_d[kCols * kPitch];
  __shared__ int s_met[kCols], s_id[kCols], s_ntr[kCols];
  __shared__ uint8_t s_ov[kCols];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int r0 = blockIdx.x * kRows;
  const size_t row_bytes = (size_t)vp / 8;
  uint8_t* fh_out = out + 4 * (size_t)vp;
  uint8_t* lfa_out = fh_out + (size_t)N * row_bytes;

  {  // the root column, staged and written out as int32
    const int r = r0 + t;
    const int v = r < vp ? __ldg(dist + (size_t)r * B) : kInf;
    s_root[swz(t)] = v;
    if (r < vp) reinterpret_cast<int*>(out)[r] = v;
  }
  for (int c0 = 0; c0 < N; c0 += kCols) {
    const int nc = min(kCols, N - c0);
    __syncthreads();  // the previous chunk's reads are done
    if (t < nc) {
      s_met[t] = nbr_metric[c0 + t];
      s_id[t] = nbr_ids[c0 + t];
      s_ov[t] = nbr_over[c0 + t];
      s_ntr[t] = with_lfa ? __ldg(dist + (size_t)my_id * B + 1 + c0 + t)
                          : kInf;
    }
    // warp w stages rows w, w + 8, ...: lane = column
    if (lane < nc)
      for (int r = warp; r < kRows; r += kThreads / 32) {
        const int row = r0 + r;
        s_d[lane * kPitch + swz(r)] =
            row < vp ? __ldg(dist + (size_t)row * B + 1 + c0 + lane) : kInf;
      }
    __syncthreads();
    // thread (k = lane, column warp + 8i) builds output byte k of it
    const int k = lane;
    const int byte = (r0 >> 3) + k;
    for (int c = warp; c < nc; c += kThreads / 32) {
      const int met = s_met[c], id = s_id[c], ntr = s_ntr[c];
      const bool over = s_ov[c] != 0;
      const int* col = s_d + c * kPitch;
      unsigned fb = 0, lb = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = r0 + 8 * k + j;
        const int dr = s_root[j * 32 + k];
        const int dn = col[j * 32 + k];
        const bool reach = dr < kInf && dn < kInf;
        const bool allowed = !over || d == id;
        const unsigned bit = 7 - j;  // MSB first
        if (reach && allowed && met + dn == dr) fb |= 1u << bit;
        if (with_lfa && reach && allowed && ntr < kInf && dn < ntr + dr)
          lb |= 1u << bit;
      }
      if ((size_t)byte < row_bytes) {
        fh_out[(size_t)(c0 + c) * row_bytes + byte] = (uint8_t)fb;
        if (with_lfa) lfa_out[(size_t)(c0 + c) * row_bytes + byte] = (uint8_t)lb;
      }
    }
  }
}

}  // namespace

// vp a multiple of 8; out holds 4·vp + N·vp/8·(1 + with_lfa) bytes.
extern "C" int openr_rib_epilogue(const void* dist, int vp, int B, int N,
                                  const void* nbr_metric, const void* nbr_ids,
                                  const void* nbr_over, int my_id,
                                  int with_lfa, void* out, void* stream) {
  if (vp <= 0) return 0;
  const int blocks = (vp + kRows - 1) / kRows;
  rib_epilogue_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)dist, vp, B, N, (const int*)nbr_metric,
      (const int*)nbr_ids, (const uint8_t*)nbr_over, my_id, with_lfa,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* openr_rib_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
