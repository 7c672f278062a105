// One GINE layer: the per-slot messages relu(x_j + pe_e) summed over each
// receiver's valid ELL slots, then GIN's MLP, in one kernel.
//
// Replaces: gnnbuilder_tpu/ops/pallas/gine_layer.py fused_gine_layer
// (kernel body _kernel).  For every row r, over its slots w < deg[r] in
// slot order, with j = nbr[r, w] and e = nbr_e[r, w] (pe = lin_edge of the
// edge features, in the batch's packed edge order, formed by the caller):
//
//   s[r] = sum_w relu(x[j] + pe[e])
//   o    = relu(((1 + eps) x[r] + s) W0 + b0) W1 + b1
//   out  = act(o [+ skip])           (skip added before the activation)
//
// Pad slots (w >= deg[r]) are never read: they point at pad edges, whose
// pe is lin_edge's bias and not 0, so the TPU kernel's reliance on a zero
// gathered row would not hold for them.
//
// What bounds it on the H100: operations at width 128 (2 F H + 2 H Fout
// flops per row against ~1 KB of row data and ~2 F gathered floats per
// edge), run as plain f32 FMAs.
//
// Design: a CTA owns R consecutive rows.  Each thread takes elements (row,
// column) of the CTA's rows, consecutive threads on consecutive columns,
// so the gathered x and pe rows are read coalesced; it forms T = (1 + eps)
// x + s into shared memory.  The MLP then runs as mp_layer.cu's GIN
// epilogue (dense_rows.cuh): Z = relu(T W0 + b0) in shared memory, then
// out.  The TPU kernel's one-hot gathers over a node window and an edge
// window (hi/lo bf16 passes, window DMAs) existed because Mosaic has no
// dynamic row gather; here an indexed load is exact.  R is 32, or 16 or 8
// where 32 rows do not fit the card's shared memory.
//
// Modes (a template argument; inference only), the JAX kernel's
// gather_mode="bf16" with mm="bf16", and quant:
//   BF16 (1): both gathered rows, x_j and pe_e, are rounded to bf16
//        before relu(x_j + pe_e), the sum float32; the MLP's products take
//        bf16-rounded operands (T and Z stored rounded) and bf16 weights.
//   INT8 (2): both MLP products quantize their operand rows (quant.cuh:
//        per-row scales, levels beside T in shared memory) against int8
//        weights with per-column scales, an exact int32 sum; the
//        aggregation stays exact.  lin_edge stays outside the kernel.
// T = (1 + eps) x + s is formed with two roundings (no fused
// multiply-add), as the plain version forms it: an ulp before a bf16
// rounding or an int8 quantization moves a value, and the whole row's
// output with it.

#include "dense_rows.cuh"

namespace {

using namespace gnnb_dense;
using gnnb_quant::bf16r;
using gnnb_quant::BF16;
using gnnb_quant::F32;
using gnnb_quant::INT8;

struct GineArgs {
  const float* x;      // [N, F]
  const float* pe;     // [E, F]
  const int* nbr;      // [N, W]
  const int* nbr_e;    // [N, W]
  const int* deg;      // [N]
  const void* w0;      // [F, H] (the mode's type)
  const float* b0;     // [H]
  const void* w1;      // [H, Fout]
  const float* b1;     // [Fout]
  const float* sw0;    // [H] column scales of w0 (INT8)
  const float* sw1;    // [Fout] column scales of w1 (INT8)
  const float* skip;   // [N, Fout] or null
  float* out;          // [N, Fout]
  int n_rows, W, F, H, Fout, act;
  float eps;
};

template <int R, int MODE>
__global__ void __launch_bounds__(THREADS) gine_layer_kernel(GineArgs a) {
  constexpr int RG = R / GROUPS;
  constexpr bool RND = MODE == BF16;
  extern __shared__ float4 smem4[];
  __shared__ int s_deg[R];
  __shared__ float s_q[MODE == INT8 ? R : 1];   // row scales of Q
  const int F = a.F, H = a.H, Fout = a.Fout;
  const int ldF = rup4(F), ldH = rup4(H);
  float* T = reinterpret_cast<float*>(smem4);   // [R, ldF]
  float* Z = T + R * ldF;                       // [R, ldH]
  int8_t* Q = reinterpret_cast<int8_t*>(Z + R * ldH);   // [R, max] INT8
  const int row0 = blockIdx.x * R;
  for (int i = threadIdx.x; i < R; i += THREADS)
    s_deg[i] = row0 + i < a.n_rows ? a.deg[row0 + i] : 0;
  __syncthreads();

  const float ope = 1.f + a.eps;
  for (int e = threadIdx.x; e < R * ldF; e += THREADS) {
    const int i = e / ldF, c = e % ldF, r = row0 + i;
    float t = 0.f;
    if (c < F && r < a.n_rows) {
      const int* nb = a.nbr + (size_t)r * a.W;
      const int* ne = a.nbr_e + (size_t)r * a.W;
      float s = 0.f;
      for (int w = 0; w < s_deg[i]; ++w) {
        float xj = a.x[(size_t)nb[w] * F + c];
        float pe = a.pe[(size_t)ne[w] * F + c];
        if (RND) {
          xj = bf16r(xj);
          pe = bf16r(pe);
        }
        s += fmaxf(xj + pe, 0.f);
      }
      // rounded twice, as the plain version forms it (module comment)
      t = __fadd_rn(__fmul_rn(ope, a.x[(size_t)r * F + c]), s);
    }
    T[e] = RND ? bf16r(t) : t;   // T feeds the W0 product only
  }
  __syncthreads();
  if constexpr (MODE == INT8) {
    gnnb_quant::quantize_rows<THREADS>(T, ldF, R, Q, s_q);
    __syncthreads();
  }

  const int col = threadIdx.x % CB;
  const int i0 = (threadIdx.x / CB) * RG;
  for (int c = col; c < ldH; c += CB) {   // Z = relu(T W0 + b0)
    float acc[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) acc[i] = 0.f;
    if (c < H) prod_rows<MODE, RG>(acc, T, Q, s_q, ldF, i0, a.w0, a.sw0, H, c,
                                   F);
    const float b = c < H ? a.b0[c] : 0.f;
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const float z = c < H ? fmaxf(acc[i] + b, 0.f) : 0.f;
      Z[(size_t)(i0 + i) * ldH + c] = RND ? bf16r(z) : z;
    }
  }
  __syncthreads();
  if constexpr (MODE == INT8) {   // Q is free again: Z's levels
    gnnb_quant::quantize_rows<THREADS>(Z, ldH, R, Q, s_q);
    __syncthreads();
  }

  for (int c = col; c < Fout; c += CB) {   // o, skip, act
    float acc[RG];
    prod_rows<MODE, RG>(acc, Z, Q, s_q, ldH, i0, a.w1, a.sw1, Fout, c, H);
    const float b = a.b1[c];
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int r = row0 + i0 + i;
      if (r >= a.n_rows) continue;
      const size_t o_idx = (size_t)r * Fout + c;
      float o = acc[i] + b;
      if (a.skip != nullptr) o += a.skip[o_idx];
      a.out[o_idx] = act_fn(o, a.act);
    }
  }
}

// Dynamic shared memory of a launch with R rows in `mode`.
size_t smem_bytes(int R, int F, int H, int mode) {
  const int ldF = rup4(F), ldH = rup4(H);
  return (size_t)R * (ldF + ldH) * sizeof(float) +
         (mode == INT8 ? (size_t)R * (ldF > ldH ? ldF : ldH) : 0);
}

// The kernel's static shared memory with R rows in `mode`.
size_t static_bytes(int R, int mode) {
  return (size_t)R * sizeof(int) + (mode == INT8 ? R : 1) * sizeof(float);
}

template <int R, int MODE>
cudaError_t launch_r(const GineArgs& a, cudaStream_t s) {
  const size_t smem = smem_bytes(R, a.F, a.H, MODE);
  cudaError_t err = cudaFuncSetAttribute(
      gine_layer_kernel<R, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gine_layer_kernel<R, MODE><<<(a.n_rows + R - 1) / R, THREADS, smem, s>>>(
      a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_fit(const GineArgs& a, size_t fits, cudaStream_t st) {
  auto need = [&](int R) {
    return smem_bytes(R, a.F, a.H, MODE) + static_bytes(R, MODE);
  };
  if (need(32) <= fits) return launch_r<32, MODE>(a, st);
  if (need(16) <= fits) return launch_r<16, MODE>(a, st);
  if (need(MIN_R) <= fits) return launch_r<MIN_R, MODE>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory of a launch in `mode` at the fewest rows per CTA, in
// bytes (the launcher takes more rows where they fit).
int gnnb_gine_layer_smem_bytes(int F, int H, int mode) {
  return (int)(smem_bytes(MIN_R, F, H, mode) + static_bytes(MIN_R, mode));
}

// Launches the layer on `stream` of `device`.  act: 0 none, 1 relu,
// 2 gelu, 3 sigmoid, 4 tanh; mode: 0 f32, 1 bf16 (w0, w1 bfloat16), 2 int8
// (w0, w1 int8 with column scales sw0, sw1); skip may be null.  All other
// arrays contiguous f32 / i32 as documented in ops/cuda/gine_layer.py.
// Returns the cudaError_t of the launch (0 = success).
int gnnb_gine_layer(const void* x, const void* pe, const void* nbr,
                    const void* nbr_e, const void* deg, int n_rows, int W,
                    int F, int H, int Fout, const void* w0, const void* b0,
                    const void* w1, const void* b1, const void* skip,
                    float eps, int act, int mode, const void* sw0,
                    const void* sw1, void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows < 0 || W < 1 || F < 1 || H < 1 || Fout < 1 || act < 0 ||
      act > 4 || !x || !pe || !nbr || !nbr_e || !deg || !w0 || !b0 ||
      !w1 || !b1 || !out || mode < F32 || mode > INT8 ||
      (mode == INT8 && (!sw0 || !sw1)))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  GineArgs a;
  a.x = (const float*)x;
  a.pe = (const float*)pe;
  a.nbr = (const int*)nbr;
  a.nbr_e = (const int*)nbr_e;
  a.deg = (const int*)deg;
  a.w0 = w0;
  a.b0 = (const float*)b0;
  a.w1 = w1;
  a.b1 = (const float*)b1;
  a.sw0 = (const float*)sw0;
  a.sw1 = (const float*)sw1;
  a.skip = (const float*)skip;
  a.out = (float*)out;
  a.n_rows = n_rows;
  a.W = W;
  a.F = F;
  a.H = H;
  a.Fout = Fout;
  a.act = act;
  a.eps = eps;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t fits = (size_t)optin;
  if (mode == BF16) return (int)launch_fit<BF16>(a, fits, st);
  if (mode == INT8) return (int)launch_fit<INT8>(a, fits, st);
  return (int)launch_fit<F32>(a, fits, st);
}

}  // extern "C"
