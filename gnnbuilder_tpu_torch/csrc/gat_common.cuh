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
// rows, and every weight read from L2 feeds R / 2 FMAs.  The attention
// terms then take one (row, head) pair per thread, reading the CTA's own
// h rows back (visible to the CTA after the barrier).  Plain f32 FMAs, no
// tensor cores: the f32 rate is the roof.
//
// The kernels and launchers here are static, so each source that includes
// this header gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gnnb_gat {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CB = 128;               // output columns per pass
constexpr int GROUPS = THREADS / CB;  // row groups (2)
constexpr int MIN_R = 8;              // fewest rows per projection CTA
constexpr float BIG = 3e38f;          // the TPU kernels' finite -inf

__device__ __forceinline__ float act_fn(float x, int act) {
  switch (act) {
    case 1: return fmaxf(x, 0.f);
    case 2: return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
    case 3: return 1.f / (1.f + expf(-x));
    case 4: return tanhf(x);
    default: return x;
  }
}

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

__host__ __device__ __forceinline__ int rup4(int n) { return (n + 3) & ~3; }

struct ProjArgs {
  const float* x;        // [N, Fin]
  const float* w;        // [Fin, HC]
  const float* att_src;  // [HC] (att_src[0, hd, c] at hd * C + c)
  const float* att_dst;  // [HC]
  float* h;              // [N, HC]
  float* a_src;          // [N, H]
  float* a_dst;          // [N, H]
  int n_rows, Fin, H, C;
};

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
      const float4 a =
          *reinterpret_cast<const float4*>(X + (size_t)(r0 + i) * ldx + k);
      acc[i] = fmaf(a.x, w[0], acc[i]);
      acc[i] = fmaf(a.y, w[1], acc[i]);
      acc[i] = fmaf(a.z, w[2], acc[i]);
      acc[i] = fmaf(a.w, w[3], acc[i]);
    }
  }
}

template <int R>
static __global__ void __launch_bounds__(THREADS)
gat_proj_kernel(ProjArgs a) {
  constexpr int RG = R / GROUPS;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);   // [R, ldF]
  const int Fin = a.Fin, HC = a.H * a.C, ldF = rup4(Fin);
  const int row0 = blockIdx.x * R;
  for (int e = threadIdx.x; e < R * ldF; e += THREADS) {
    const int i = e / ldF, c = e % ldF, r = row0 + i;
    X[e] = (c < Fin && r < a.n_rows) ? a.x[(size_t)r * Fin + c] : 0.f;
  }
  __syncthreads();
  const int col = threadIdx.x % CB;
  const int i0 = (threadIdx.x / CB) * RG;
  for (int c = col; c < HC; c += CB) {
    float acc[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) acc[i] = 0.f;
    dot_rows<RG>(acc, X, ldF, i0, a.w, HC, c, Fin);
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
    const float* hr = a.h + (size_t)r * HC + hd * a.C;
    const float* as = a.att_src + hd * a.C;
    const float* ad = a.att_dst + hd * a.C;
    float s = 0.f, d = 0.f;
    for (int c = 0; c < a.C; ++c) {
      s = fmaf(hr[c], as[c], s);
      d = fmaf(hr[c], ad[c], d);
    }
    a.a_src[(size_t)r * a.H + hd] = s;
    a.a_dst[(size_t)r * a.H + hd] = d;
  }
}

static __host__ size_t proj_smem_bytes(int R, int Fin) {
  return (size_t)R * rup4(Fin) * sizeof(float);
}

template <int R>
static cudaError_t launch_proj_r(const ProjArgs& a, cudaStream_t s) {
  const size_t smem = proj_smem_bytes(R, a.Fin);
  cudaError_t err = cudaFuncSetAttribute(
      gat_proj_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  gat_proj_kernel<R><<<(a.n_rows + R - 1) / R, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

// The projection launch at 32, 16 or 8 rows per CTA, the most that fit
// the card's shared memory per block (`optin` bytes).
static __host__ cudaError_t launch_proj(const ProjArgs& a, size_t optin,
                                        cudaStream_t s) {
  if (proj_smem_bytes(32, a.Fin) <= optin) return launch_proj_r<32>(a, s);
  if (proj_smem_bytes(16, a.Fin) <= optin) return launch_proj_r<16>(a, s);
  if (proj_smem_bytes(MIN_R, a.Fin) <= optin)
    return launch_proj_r<MIN_R>(a, s);
  return cudaErrorInvalidValue;
}

static __host__ cudaError_t optin_bytes(int device, size_t* out) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *out = (size_t)optin;
  return err;
}

}  // namespace gnnb_gat
