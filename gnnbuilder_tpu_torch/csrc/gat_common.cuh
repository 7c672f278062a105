// Device code shared by the GAT kernels (gat_layer.cu, gat_block.cu,
// gat_bwd.cu): the projection launch, the warp reductions and the
// epilogue activations.
//
// The projection computes, for every row r of x [N, Fin] and every head
// hd of H heads of C channels (HC = H * C):
//
//   h[r]          = x[r] W                        (W [Fin, HC], row-major)
//   a_src[r, hd]  = h[r, hd*C : (hd+1)*C] . att_src[hd]
//   a_dst[r, hd]  = h[r, hd*C : (hd+1)*C] . att_dst[hd]
//
// It is the part of the TPU kernels' bodies that computes h = x W in VMEM
// (gat_layer.py's proj, gat_block.py's h_scr): here it is a first launch
// of each kernel's source, because every receiver row needs its
// neighbours' h before it can aggregate, and h goes to device memory
// (38 MB at the canonical b1024 batch, mostly L2 resident).  A CTA owns R
// rows: x's rows sit in shared memory at a row stride rounded up to 4
// floats with zeroed pad columns (any Fin works, the first layer has 11),
// each thread owns one output column of a 128-column pass and R / 2
// rows, and every weight read from L2 feeds R / 2 products
// (dense_rows.cuh prod_rows).  The attention terms then take one (row,
// head) pair per thread, reading the CTA's own h rows back (visible to
// the CTA after the barrier).  Plain f32 FMAs and __dp4a, no tensor
// cores: the f32 rate is the roof.
//
// Modes (quant.cuh Mode, a template argument; inference only):
// * BF16: x's rows are rounded to bf16 as they are staged and W is
//   bfloat16, so each product is exact and the sum float32 (the JAX
//   kernels' _dot_mm("bf16")).  The attention terms stay float32 dots of
//   h with att (gat_layer.py), unless the logit weights wa_src / wa_dst
//   [Fin, H] are given: then a_src = x . wa_src with bf16 operands, the
//   order in which gat_block.py forms them (x @ (W @ A_src), both
//   products in bf16; wa = bf16(bf16(W) A) comes from the wrapper).  In
//   float32 the two orders agree to an ulp; in bf16 they do not, and the
//   difference goes through exp.
// * INT8: each staged row is quantized with its own scale (quant.cuh
//   quantize_rows) and W is int8 with per-column scales: h = the exact
//   __dp4a sum times s_row * s_col (the JAX kernels' _qdot).  A row gets
//   the same scale as a receiver and as a neighbour, since h is formed
//   once per row.  The attention terms are float32 dots of h with att.
//
// The kernels and launchers here are static, so each source that includes
// this header gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "dense_rows.cuh"

namespace gnnb_gat {

using gnnb_dense::act_fn;    // act: 0 none, 1 relu, 2 gelu, 3 sigmoid, 4 tanh
using gnnb_dense::CB;        // output columns per pass
using gnnb_dense::GROUPS;    // row groups (2)
using gnnb_dense::MIN_R;     // fewest rows per projection CTA
using gnnb_dense::rup4;
using gnnb_dense::THREADS;
using gnnb_quant::BF16;
using gnnb_quant::F32;
using gnnb_quant::INT8;

constexpr int WARPS = THREADS / 32;
constexpr float BIG = 3e38f;          // the TPU kernels' finite -inf

__device__ __forceinline__ float lrelu(float z, float ns) {
  return z >= 0.f ? z : ns * z;
}

// Butterfly reductions over a full warp: every lane ends with the same
// bits (each step adds the same two values in either order).
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct ProjArgs {
  const float* x;        // [N, Fin]
  const void* w;         // [Fin, HC]: float32, bfloat16 (BF16), int8 (INT8)
  const float* sw;       // [HC] column scales of an int8 w, else null
  const float* att_src;  // [HC] (att_src[0, hd, c] at hd * C + c)
  const float* att_dst;  // [HC]
  const __nv_bfloat16* wa_src;  // [Fin, H] logit weights (BF16) or null
  const __nv_bfloat16* wa_dst;  // [Fin, H]
  float* h;              // [N, HC]
  float* a_src;          // [N, H]
  float* a_dst;          // [N, H]
  int n_rows, Fin, H, C;
};

template <int R, int MODE>
static __global__ void __launch_bounds__(THREADS)
gat_proj_kernel(ProjArgs a) {
  constexpr int RG = R / GROUPS;
  extern __shared__ float4 smem4[];
  const int Fin = a.Fin, HC = a.H * a.C, ldF = rup4(Fin);
  float* X = reinterpret_cast<float*>(smem4);              // [R, ldF]
  int8_t* Q = reinterpret_cast<int8_t*>(X + (size_t)R * ldF);  // INT8
  float* sq = reinterpret_cast<float*>(Q + (size_t)R * ldF);   // [R]
  const int row0 = blockIdx.x * R;
  for (int e = threadIdx.x; e < R * ldF; e += THREADS) {
    const int i = e / ldF, c = e % ldF, r = row0 + i;
    const float v = (c < Fin && r < a.n_rows) ? a.x[(size_t)r * Fin + c]
                                              : 0.f;
    X[e] = MODE == BF16 ? gnnb_quant::bf16r(v) : v;
  }
  __syncthreads();
  if constexpr (MODE == INT8) {
    gnnb_quant::quantize_rows<THREADS>(X, ldF, R, Q, sq);
    __syncthreads();
  }
  const int col = threadIdx.x % CB;
  const int i0 = (threadIdx.x / CB) * RG;
  for (int c = col; c < HC; c += CB) {
    float acc[RG];
    gnnb_dense::prod_rows<MODE, RG>(acc, X, Q, sq, ldF, i0, a.w, a.sw, HC,
                                    c, Fin);
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int r = row0 + i0 + i;
      if (r < a.n_rows) a.h[(size_t)r * HC + c] = acc[i];
    }
  }
  __syncthreads();   // the CTA's h rows are visible to the whole CTA
  for (int p = threadIdx.x; p < R * a.H; p += THREADS) {
    const int i = p / a.H, hd = p % a.H, r = row0 + i;
    if (r >= a.n_rows) continue;
    float s = 0.f, d = 0.f;
    if (MODE == BF16 && a.wa_src != nullptr) {
      const float* xr = X + (size_t)i * ldF;   // bf16-rounded
      for (int k = 0; k < Fin; ++k) {
        s = fmaf(xr[k], gnnb_quant::ldw(a.wa_src + (size_t)k * a.H + hd), s);
        d = fmaf(xr[k], gnnb_quant::ldw(a.wa_dst + (size_t)k * a.H + hd), d);
      }
    } else {
      const float* hr = a.h + (size_t)r * HC + hd * a.C;
      const float* as = a.att_src + hd * a.C;
      const float* ad = a.att_dst + hd * a.C;
      for (int c = 0; c < a.C; ++c) {
        s = fmaf(hr[c], as[c], s);
        d = fmaf(hr[c], ad[c], d);
      }
    }
    a.a_src[(size_t)r * a.H + hd] = s;
    a.a_dst[(size_t)r * a.H + hd] = d;
  }
}

// Shared memory of a projection CTA of R rows in `mode`: the staged rows,
// and under INT8 their levels and scales.
static __host__ size_t proj_smem_bytes(int R, int Fin, int mode) {
  const size_t rows = (size_t)R * rup4(Fin);
  return rows * sizeof(float) +
         (mode == INT8 ? rows + (size_t)R * sizeof(float) : 0);
}

template <int R, int MODE>
static cudaError_t launch_proj_r(const ProjArgs& a, cudaStream_t s) {
  const size_t smem = proj_smem_bytes(R, a.Fin, MODE);
  cudaError_t err = cudaFuncSetAttribute(
      gat_proj_kernel<R, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  gat_proj_kernel<R, MODE><<<(a.n_rows + R - 1) / R, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <int MODE>
static __host__ cudaError_t launch_proj_mode(const ProjArgs& a, size_t optin,
                                             cudaStream_t s) {
  if (proj_smem_bytes(32, a.Fin, MODE) <= optin)
    return launch_proj_r<32, MODE>(a, s);
  if (proj_smem_bytes(16, a.Fin, MODE) <= optin)
    return launch_proj_r<16, MODE>(a, s);
  if (proj_smem_bytes(MIN_R, a.Fin, MODE) <= optin)
    return launch_proj_r<MIN_R, MODE>(a, s);
  return cudaErrorInvalidValue;
}

// The projection launch in `mode` at 32, 16 or 8 rows per CTA, the most
// that fit the card's shared memory per block (`optin` bytes).
static __host__ cudaError_t launch_proj(const ProjArgs& a, int mode,
                                        size_t optin, cudaStream_t s) {
  if (mode == BF16) return launch_proj_mode<BF16>(a, optin, s);
  if (mode == INT8) return launch_proj_mode<INT8>(a, optin, s);
  return launch_proj_mode<F32>(a, optin, s);
}

static __host__ cudaError_t optin_bytes(int device, size_t* out) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *out = (size_t)optin;
  return err;
}

}  // namespace gnnb_gat
