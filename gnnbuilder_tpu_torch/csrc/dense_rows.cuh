// Device code of the GINE layer kernel (gine_layer.cu) and of the mp
// layer kernel's elementwise convs (mp_layer.cu: act_fn, THREADS): rows of
// a product X W with X in shared memory and W streaming from device
// memory, and the epilogue activations.  The mp layer's gin / sage and the
// EdgeConv kernel run on tc_rows.cuh's tensor-core product.
//
// A CTA of THREADS threads owns R rows; each thread owns one output column
// of a CB-column pass and R / GROUPS rows, so every weight read (L2
// resident, coalesced along the column) feeds R / GROUPS FMAs.  X rows sit
// in shared memory at a row stride rounded up to 4 floats with zeroed pad
// columns, so any width works (the first layer has 11).  Plain f32 FMAs,
// no tensor cores.  W is float32, or bfloat16 in the kernels' bf16 mode
// (X then holds bf16-rounded values, so each product is exact and the sum
// float32); the int8 mode's products are quant.cuh's qdot_rows.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "quant.cuh"

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
// stride ldw in device memory (rows past K read as 0), float32 or bf16.
template <int RG, typename TW>
__device__ __forceinline__ void dot_rows(float (&acc)[RG], const float* X,
                                         int ldx, int r0,
                                         const TW* __restrict__ W,
                                         int ldw, int col, int K) {
  for (int k = 0; k < K; k += 4) {
    float w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = k + q < K ? gnnb_quant::ldw(W + (size_t)(k + q) * ldw + col)
                       : 0.f;
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

// acc = X[r0 .. r0 + RG) W[:, col] in the kernels' mode (quant.cuh Mode):
// float32 or bf16 weights on the float rows X, or the int8 product of
// their levels Q (row stride ldx bytes, scales sq) with int8 weights
// (column scales sw).
template <int MODE, int RG>
__device__ __forceinline__ void prod_rows(float (&acc)[RG], const float* X,
                                          const int8_t* Q, const float* sq,
                                          int ldx, int r0, const void* W,
                                          const float* sw, int ldw, int col,
                                          int K) {
  using TW = typename gnnb_quant::WeightOf<MODE>::T;
  if constexpr (MODE == gnnb_quant::INT8) {
    gnnb_quant::qdot_scaled<RG>(acc, Q, ldx, sq, r0,
                                static_cast<const int8_t*>(W), sw, ldw, col,
                                K);
  } else {
#pragma unroll
    for (int i = 0; i < RG; ++i) acc[i] = 0.f;
    dot_rows<RG>(acc, X, ldx, r0, static_cast<const TW*>(W), ldw, col, K);
  }
}

}  // namespace gnnb_dense
