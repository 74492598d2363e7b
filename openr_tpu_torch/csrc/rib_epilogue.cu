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
// Bound on this card: bytes. It must read, of every row of dist [vp, B],
// the 32-byte sectors that hold columns 0..N (13.6 MB at the 100k
// benchmark, B 32, N 31: all of it) and write 4·vp + N·vp/8 bytes (twice
// the bits with LFA; 838 656 bytes at the same shape), ~4.3 us at
// 3.35 TB/s; the compare work is a few integer operations a bit.
//
// Design: a warp owns 32 destination rows and walks their columns 0..N
// in chunks of 32. Lane l = 8h + g holds, for q = 0..7, columns
// 4g .. 4g+3 of the chunk in row 4q + h: load q of the warp reads four
// whole 128-byte pieces of rows (16 bytes a lane), so every row is read
// once, in full lines, and all 8 loads of a chunk go out before its
// first compare (4 KB in flight a warp). Column 0 is the root's
// distance: the lanes of g = 0 write it out as int32, and a shuffle
// from them gives every lane its 8 rows' d_root. Each lane evaluates the
// 32 bits of its 4 columns x 8 rows into 4 words, each bit selected
// straight into its place in the packed bytes (MSB first: bit 7 of byte
// k is destination 8k), with bitwise tests and no branch; two
// xor-shuffles OR the 4 lanes h of a column group together, and lane h
// stores column 4g + h's word: one 32-bit store a column, bytes where a
// packed row's word is unaligned (vp / 8 odd) or partial (the last
// tile). The overload rule is a mask on that word (an overloaded
// neighbour keeps at most its own row's bit), not a test a bit. A lane
// reads its 4 columns' metric and, with LFA, n_to_root (row my_id) once
// a chunk. Past 32 columns (B > 32) the next chunk's loads go out before
// the current chunk's compares. No shared memory, no barrier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr int kThreads = 128;  // 4 warps: 128 destination rows a block
constexpr unsigned kFull = 0xffffffffu;

// where row 4q + h's bit sits in the packed word of rows r0 .. r0+31:
// byte q / 2, bit 7 - (4 (q & 1) + h); this is the place for h = 0
__device__ __forceinline__ int bit_at(int q) {
  return 8 * (q >> 1) + 7 - 4 * (q & 1);
}

// Lane (h, g)'s part of a chunk: columns c .. c+3 (c = c0 + 4g) of rows
// r0 + 4q + h, INF past vp and past `cols`. `vec`: 16-byte loads (B % 4
// == 0 and an aligned base; a load may run past `cols`, not past the
// row), else 4-byte ones.
__device__ __forceinline__ void load_chunk(int4 (&v)[8],
                                           const int* __restrict__ dist,
                                           int B, int vp, int r0, int h,
                                           int c, int cols, bool vec) {
  const int4 inf = make_int4(kInf, kInf, kInf, kInf);
  if (vec) {  // one uniform branch; the loads are predicated
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = r0 + 4 * q + h;
      v[q] = r < vp && c < cols
                 ? __ldg(reinterpret_cast<const int4*>(dist + (size_t)r * B +
                                                       c))
                 : inf;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int* p = dist + (size_t)(r0 + 4 * q + h) * B + c;
      const bool live = r0 + 4 * q + h < vp;
      v[q].x = live && c < cols ? __ldg(p) : kInf;
      v[q].y = live && c + 1 < cols ? __ldg(p + 1) : kInf;
      v[q].z = live && c + 2 < cols ? __ldg(p + 2) : kInf;
      v[q].w = live && c + 3 < cols ? __ldg(p + 3) : kInf;
    }
  }
}

__device__ __forceinline__ int elem(const int4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

__device__ __forceinline__ void store_bits(uint8_t* dst, unsigned w,
                                           int nbytes) {
  if (nbytes == 4 && ((uintptr_t)dst & 3) == 0) {
    *reinterpret_cast<unsigned*>(dst) = w;
  } else {
    for (int k = 0; k < nbytes; ++k) dst[k] = (uint8_t)(w >> (8 * k));
  }
}

// MULTI: more than one chunk of columns (N + 1 > 32), the next chunk's
// loads in flight during the current one's compares, and the lane's
// d_root kept across chunks; without it a lane holds one chunk and
// shuffles each row's d_root where it is used. LFA: the LFA bits too.
// The one-chunk kernels are held to 64 and 72 registers: 8 and 7 blocks
// an SM, one wave at the 100k benchmark's 832 blocks.
template <bool MULTI, bool LFA>
__global__ void __launch_bounds__(kThreads, MULTI ? 1 : LFA ? 7 : 8)
    rib_epilogue_kernel(const int* __restrict__ dist, int vp, int B, int N,
                        const int* __restrict__ nbr_metric,
                        const int* __restrict__ nbr_ids,
                        const uint8_t* __restrict__ nbr_over, int my_id,
                        int vec, uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31, h = lane >> 3, g = lane & 7;
  const int r0 = (blockIdx.x * kThreads + threadIdx.x) & ~31;
  const int cols = N + 1;
  const size_t row_bytes = (size_t)vp / 8;
  uint8_t* fh_out = out + 4 * (size_t)vp;
  uint8_t* lfa_out = fh_out + (size_t)N * row_bytes;
  // bytes of the warp's rows in a packed row (vp is a multiple of 8)
  const int nbytes = r0 < vp ? min(4, (vp - r0) >> 3) : 0;
  int4 v[8];
  load_chunk(v, dist, B, vp, r0, h, 4 * g, cols, vec);
  int dr[MULTI ? 8 : 1];  // d_root of the lane's rows, across chunks
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if constexpr (MULTI) dr[q] = __shfl_sync(kFull, v[q].x, lane & ~7);
    if (g == 0 && r0 + 4 * q + h < vp)
      reinterpret_cast<int*>(out)[r0 + 4 * q + h] = v[q].x;
  }
  for (int c0 = 0; c0 < cols; c0 += 32) {
    int4 nx[8];
    if constexpr (MULTI) {
      if (c0 + 32 < cols)
        load_chunk(nx, dist, B, vp, r0, h, c0 + 32 + 4 * g, cols, vec);
    }
    // the lane's columns c0 + 4g + e, neighbours k = c - 1
    int met[4], ntr[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = c0 + 4 * g + e - 1;
      met[e] = 0;
      ntr[e] = kInf;
      if (k >= 0 && k < N) {
        met[e] = __ldg(nbr_metric + k);
        if (LFA) ntr[e] = __ldg(dist + (size_t)my_id * B + 1 + k);
      }
    }
    unsigned fw[4] = {0, 0, 0, 0}, lw[4] = {0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const unsigned bit = 1u << (bit_at(q) - h);
      int d_r;
      if constexpr (MULTI) {
        d_r = dr[q];
      } else {
        d_r = __shfl_sync(kFull, v[q].x, lane & ~7);
      }
      const bool dr_ok = d_r < kInf;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int dn = elem(v[q], e);
        // d < INF before the add; the sums wrap as int32 does in torch.
        // Bitwise & on the tests, so no branch
        const bool reach = dr_ok & (dn < kInf);
        const bool hop =
            reach & ((int)((unsigned)met[e] + (unsigned)dn) == d_r);
        fw[e] |= hop ? bit : 0u;
        if constexpr (LFA) {
          const bool alt = reach & (ntr[e] < kInf) &
                           (dn < (int)((unsigned)ntr[e] + (unsigned)d_r));
          lw[e] |= alt ? bit : 0u;
        }
      }
    }
    // OR the four lanes h of each column group: every lane of the group
    // then holds the group's 4 words, and lane h stores column 4g + h's
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      fw[e] |= __shfl_xor_sync(kFull, fw[e], 8);
      fw[e] |= __shfl_xor_sync(kFull, fw[e], 16);
      if (LFA) {
        lw[e] |= __shfl_xor_sync(kFull, lw[e], 8);
        lw[e] |= __shfl_xor_sync(kFull, lw[e], 16);
      }
    }
    const int c = c0 + 4 * g + h;
    if (c >= 1 && c < cols && nbytes > 0) {
      // an overloaded neighbour is a first hop (or an LFA) only toward
      // itself: its word keeps at most the bit of row ids[k]
      unsigned keep = ~0u;
      if (__ldg(nbr_over + c - 1)) {
        const int rho = __ldg(nbr_ids + c - 1) - r0;
        keep = rho >= 0 && rho < 32 ? 1u << (8 * (rho >> 3) + 7 - (rho & 7))
                                    : 0u;
      }
      const size_t at = (size_t)(c - 1) * row_bytes + (r0 >> 3);
      const unsigned f = h == 0 ? fw[0] : h == 1 ? fw[1] : h == 2 ? fw[2]
                                                                  : fw[3];
      store_bits(fh_out + at, f & keep, nbytes);
      if (LFA) {
        const unsigned l = h == 0 ? lw[0] : h == 1 ? lw[1] : h == 2 ? lw[2]
                                                                    : lw[3];
        store_bits(lfa_out + at, l & keep, nbytes);
      }
    }
    if constexpr (MULTI) {
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = nx[q];
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
  const int blocks = (vp + kThreads - 1) / kThreads;
  const int vec = B % 4 == 0 && ((uintptr_t)dist & 15) == 0;
  const bool multi = N + 1 > 32;
  auto kernel = multi ? (with_lfa ? rib_epilogue_kernel<true, true>
                                  : rib_epilogue_kernel<true, false>)
                      : (with_lfa ? rib_epilogue_kernel<false, true>
                                  : rib_epilogue_kernel<false, false>);
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)dist, vp, B, N, (const int*)nbr_metric,
      (const int*)nbr_ids, (const uint8_t*)nbr_over, my_id, vec,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* openr_rib_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
