// Per-row neighbour lists of a block adjacency, for the kernels that
// aggregate from block_adj on the CUDA cores (mp_layer.cu, and
// mp_block.cu in its int8 mode).
//
// A block-packed batch ships A [T, 128, 128] with A[t, i, j] the number of
// edges (t*128 + j) -> (t*128 + i), small integers exact in f32.  A QM9
// block is ~97 % zeros, so a CTA compacts the adjacency rows it needs
// once, in shared memory, into lists of (count << 8) | j in column order,
// and every aggregation walks those lists: a hub over the ELL width costs
// its edges, not a dense row.

#pragma once

#include <cuda_runtime.h>

#include "quant.cuh"

namespace gnnb {

constexpr int LIST_COLS = 128;   // columns of an adjacency row

// Compacts rows [0, nrows) of A (row-major, 128 columns, rows 16-byte
// aligned, device memory) into ent[ptr[r] .. ptr[r + 1]); cnt holds nrows
// ints, ptr nrows + 1, ent up to nrows * 128.  Every thread of the CTA
// (NT threads) calls it; it ends with a barrier.
template <int NT>
__device__ __forceinline__ void compact_rows(const float* A, int nrows,
                                             int* cnt, int* ptr, int* ent) {
  constexpr int NWARPS = NT / 32;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int r = warp; r < nrows; r += NWARPS) {
    const float4 q =
        reinterpret_cast<const float4*>(A + (size_t)r * LIST_COLS)[lane];
    int n = (q.x != 0.f) + (q.y != 0.f) + (q.z != 0.f) + (q.w != 0.f);
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
    if (lane == 0) cnt[r] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    ptr[0] = 0;
    for (int r = 0; r < nrows; ++r) ptr[r + 1] = ptr[r] + cnt[r];
  }
  __syncthreads();
  for (int r = warp; r < nrows; r += NWARPS) {
    const float4 q =
        reinterpret_cast<const float4*>(A + (size_t)r * LIST_COLS)[lane];
    const float qv[4] = {q.x, q.y, q.z, q.w};
    const int n = (q.x != 0.f) + (q.y != 0.f) + (q.z != 0.f) + (q.w != 0.f);
    int incl = n;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    int e = ptr[r] + incl - n;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (qv[k] != 0.f) ent[e++] = ((int)qv[k] << 8) | (lane * 4 + k);
  }
  __syncthreads();
}

// sum_j A[r, j] S[j, c] over one row's list ent[e0 .. e1), S row-major with
// leading dimension ld and rows local to the block, in column order; with
// BF16, each S value rounded to bf16 first (the bf16 mode's gather).
template <bool BF16 = false>
__device__ __forceinline__ float agg_row(const int* ent, int e0, int e1,
                                         const float* S, int ld, int c) {
  float s = 0.f;
  for (int e = e0; e < e1; ++e) {
    const int p = ent[e];
    float x = S[(size_t)(p & 0xFF) * ld + c];
    if (BF16) x = gnnb_quant::bf16r(x);
    s = fmaf((float)(p >> 8), x, s);
  }
  return s;
}

}  // namespace gnnb
