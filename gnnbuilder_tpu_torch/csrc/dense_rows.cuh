// Device code shared by the GINE and EdgeConv layer kernels
// (gine_layer.cu, edge_block.cu): rows of a product X W with X in shared
// memory and W streaming from device memory, and the epilogue
// activations.
//
// A CTA of THREADS threads owns R rows; each thread owns one output column
// of a CB-column pass and R / GROUPS rows, so every weight read (L2
// resident, coalesced along the column) feeds R / GROUPS FMAs.  X rows sit
// in shared memory at a row stride rounded up to 4 floats with zeroed pad
// columns, so any width works (the first layer has 11).  Plain f32 FMAs,
// no tensor cores.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gnnb_dense {

constexpr int THREADS = 256;
constexpr int CB = 128;               // output columns per pass
constexpr int GROUPS = THREADS / CB;  // row groups (2)
constexpr int MIN_R = 8;              // fewest rows per CTA

// act: 0 none, 1 relu, 2 gelu (erf), 3 sigmoid, 4 tanh.
__device__ __forceinline__ float act_fn(float x, int act) {
  switch (act) {
    case 1: return fmaxf(x, 0.f);
    case 2: return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
    case 3: return 1.f / (1.f + expf(-x));
    case 4: return tanhf(x);
    default: return x;
  }
}

__host__ __device__ __forceinline__ int rup4(int n) { return (n + 3) & ~3; }

// acc[i] += X[r0 + i, 0:K] . W[0:K, col]; X rows in shared memory at
// stride ldx (a multiple of 4, pad columns zero), W row-major with row
// stride ldw in device memory (rows past K read as 0).
template <int RG>
__device__ __forceinline__ void dot_rows(float (&acc)[RG], const float* X,
                                         int ldx, int r0,
                                         const float* __restrict__ W,
                                         int ldw, int col, int K) {
  for (int k = 0; k < K; k += 4) {
    float w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = k + q < K ? __ldg(W + (size_t)(k + q) * ldw + col) : 0.f;
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(X + (size_t)(r0 + i) * ldx + k);
      acc[i] = fmaf(x.x, w[0], acc[i]);
      acc[i] = fmaf(x.y, w[1], acc[i]);
      acc[i] = fmaf(x.z, w[2], acc[i]);
      acc[i] = fmaf(x.w, w[3], acc[i]);
    }
  }
}

}  // namespace gnnb_dense
