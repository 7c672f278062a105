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

#include "dense_rows.cuh"

namespace {

using namespace gnnb_dense;

struct GineArgs {
  const float* x;      // [N, F]
  const float* pe;     // [E, F]
  const int* nbr;      // [N, W]
  const int* nbr_e;    // [N, W]
  const int* deg;      // [N]
  const float* w0;     // [F, H]
  const float* b0;     // [H]
  const float* w1;     // [H, Fout]
  const float* b1;     // [Fout]
  const float* skip;   // [N, Fout] or null
  float* out;          // [N, Fout]
  int n_rows, W, F, H, Fout, act;
  float eps;
};

template <int R>
__global__ void __launch_bounds__(THREADS) gine_layer_kernel(GineArgs a) {
  constexpr int RG = R / GROUPS;
  extern __shared__ float4 smem4[];
  __shared__ int s_deg[R];
  const int F = a.F, H = a.H, Fout = a.Fout;
  const int ldF = rup4(F), ldH = rup4(H);
  float* T = reinterpret_cast<float*>(smem4);   // [R, ldF]
  float* Z = T + R * ldF;                       // [R, ldH]
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
      for (int w = 0; w < s_deg[i]; ++w)
        s += fmaxf(a.x[(size_t)nb[w] * F + c] + a.pe[(size_t)ne[w] * F + c],
                   0.f);
      t = ope * a.x[(size_t)r * F + c] + s;
    }
    T[e] = t;
  }
  __syncthreads();

  const int col = threadIdx.x % CB;
  const int i0 = (threadIdx.x / CB) * RG;
  for (int c = col; c < ldH; c += CB) {   // Z = relu(T W0 + b0)
    float acc[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) acc[i] = 0.f;
    if (c < H) dot_rows<RG>(acc, T, ldF, i0, a.w0, H, c, F);
    const float b = c < H ? a.b0[c] : 0.f;
#pragma unroll
    for (int i = 0; i < RG; ++i)
      Z[(size_t)(i0 + i) * ldH + c] = c < H ? fmaxf(acc[i] + b, 0.f) : 0.f;
  }
  __syncthreads();

  for (int c = col; c < Fout; c += CB) {   // o, skip, act
    float acc[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) acc[i] = 0.f;
    dot_rows<RG>(acc, Z, ldH, i0, a.w1, Fout, c, H);
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

size_t smem_bytes(int R, int F, int H) {
  return (size_t)R * (rup4(F) + rup4(H)) * sizeof(float);
}

template <int R>
cudaError_t launch_r(const GineArgs& a, cudaStream_t s) {
  const size_t smem = smem_bytes(R, a.F, a.H);
  cudaError_t err = cudaFuncSetAttribute(
      gine_layer_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  gine_layer_kernel<R><<<(a.n_rows + R - 1) / R, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of a launch at the fewest rows per CTA, in bytes (the
// launcher takes more rows where they fit).
int gnnb_gine_layer_smem_bytes(int F, int H) {
  return (int)(smem_bytes(MIN_R, F, H) + MIN_R * sizeof(int));
}

// Launches the layer on `stream` of `device`.  act: 0 none, 1 relu,
// 2 gelu, 3 sigmoid, 4 tanh; skip may be null.  All arrays contiguous
// f32 / i32 as documented in ops/cuda/gine_layer.py.  Returns the
// cudaError_t of the launch (0 = success).
int gnnb_gine_layer(const void* x, const void* pe, const void* nbr,
                    const void* nbr_e, const void* deg, int n_rows, int W,
                    int F, int H, int Fout, const void* w0, const void* b0,
                    const void* w1, const void* b1, const void* skip,
                    float eps, int act, void* out, void* stream,
                    int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows < 0 || W < 1 || F < 1 || H < 1 || Fout < 1 || act < 0 ||
      act > 4 || !x || !pe || !nbr || !nbr_e || !deg || !w0 || !b0 ||
      !w1 || !b1 || !out)
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
  a.w0 = (const float*)w0;
  a.b0 = (const float*)b0;
  a.w1 = (const float*)w1;
  a.b1 = (const float*)b1;
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
  if (smem_bytes(32, F, H) + 32 * sizeof(int) <= fits)
    return (int)launch_r<32>(a, st);
  if (smem_bytes(16, F, H) + 16 * sizeof(int) <= fits)
    return (int)launch_r<16>(a, st);
  if (smem_bytes(MIN_R, F, H) + MIN_R * sizeof(int) <= fits)
    return (int)launch_r<MIN_R>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
