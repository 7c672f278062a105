// The CUDA-core kernels' block size and epilogue activations, shared by
// the mp layer kernel's elementwise convs (mp_layer.cu) and the GAT
// kernels' attention and backward launches (gat_common.cuh; pna_layer.cu
// takes act_fn through it).  The products of the mp layer's gin / sage,
// GINE and EdgeConv run on tc_rows.cuh's tensor-core rows product.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gnnb_dense {

constexpr int THREADS = 256;

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

}  // namespace gnnb_dense
