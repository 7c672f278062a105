// PNA aggregation backward: from the cotangent of mid and the forward's
// residuals, each receiver's coefficient row (cstk), which the gather of
// ell_bwd.cu turns into dv over the reverse table or, on a batch without
// one, over the reverse CSR built from the forward table.
//
// Replaces: gnnbuilder_tpu/ops/pallas/scatter_bwd.py
// fused_pna_scatter_backward (its raw PNA mode; kernel body _kernel,
// launched through _launch), and the coefficient preparation of the JAX
// PNA VJP's reverse-table branch (pna_layer.py _make_vjp_fn).  For every
// receiver row r with degree d:
//
//   dy    = [d_mid | (log_deg/delta) d_mid | (delta/log_deg) d_mid]
//   d_agg = dy ks_t                              ([3Fout] x [3Fout, 4F])
//   ct_mx, ct_mn, ct_mean = the first three F blocks of d_agg (0 if d = 0)
//   c_lin = ct_mean / denom        c_a  = ct_std / (denom * std)
//   c_mx  = ct_mx / max(ties_mx, 1) c_mn = ct_mn / max(ties_mn, 1)
//
// with denom = max(d, 1) and log_deg = log(denom + 1).  The kernel
// writes row r of cstk [N, 7F]:
//
//   [c_lin | c_a | c_a * mean | mx | c_mx | mn | c_mn]
//
// (the JAX VJP's layout: one lin, one dev and two cmp terms), and
// ell_bwd.cu sums, for each sender j, over its out-neighbours i:
// c_lin + (v_j c_a - c_a mean) + [v_j == mx] c_mx + [v_j == mn] c_mn.  Each
// output element has one owner there, so dv is the same bits every run;
// no kernel adds floats atomically.
//
// mx, mn, mean, ties and std are the forward's saved values (aux and the
// std block of agg_cat) and the gather compares the forward's saved v, so
// v_j == mx repeats the forward's own comparisons.  For a degree-1 row
// mean == v_j bitwise, so the std term is exactly zero.
//
// What bounds it on the H100: operations.  d_agg costs 2 * 3Fout * 4F =
// 393,216 flops per row at 128 wide against ~2.8 KB of row inputs (and
// 3.5 KB of cstk written).  The product runs as plain f32 FMAs, as in the
// forward kernel.
//
// Design: each CTA takes R receiver rows (32, or 16 or 8 where dy of 32
// rows, R * 3Fout floats, does not fit the card's shared memory per
// block); dy of those rows sits in shared memory and each thread owns one
// feature column c of a 128-column block and R/2 rows, forming d_agg in
// columns c, F+c, 2F+c and 3F+c at once, so the four coefficients of
// (row, c) come out in its registers and d_agg never leaves them.  The
// TPU kernel accumulated a sender window in VMEM and overlap-added its
// margins because it could not scatter; this kernel writes each
// receiver's row once instead and leaves the sum over senders to a
// gather.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int CB = 128;               // columns per column block
constexpr int GROUPS = THREADS / CB;  // row groups (2)
constexpr int MIN_R = 8;              // fewest receiver rows per CTA

struct ScatterArgs {
  const float* d_mid;    // [N, Fout]
  const float* aux;      // [N, 5F]  mx | mn | mean | ties_mx | ties_mn
  const float* agg_cat;  // [N, 4F]  (std = block 3)
  const int* deg;        // [N]
  const float* ks_t;     // [3Fout, 4F]
  float* cstk;           // [N, 7F]
  int n_rows, F, Fout;
  float delta;
};

template <int R>
__global__ void __launch_bounds__(THREADS)
pna_scatter_bwd_kernel(ScatterArgs a) {
  constexpr int RG = R / GROUPS;                 // rows per thread
  extern __shared__ float4 smem4[];
  const int F = a.F, Fout = a.Fout;
  float* dy = reinterpret_cast<float*>(smem4);   // [R, 3Fout]
  int* s_deg = reinterpret_cast<int*>(dy + R * 3 * Fout);   // [R]

  const int row0 = blockIdx.x * R;
  const int col = threadIdx.x % CB;
  const int i0 = (threadIdx.x / CB) * RG;
  for (int i = threadIdx.x; i < R; i += THREADS)
    s_deg[i] = row0 + i < a.n_rows ? a.deg[row0 + i] : 0;
  for (int q = threadIdx.x; q < R * Fout; q += THREADS) {
    const int i = q / Fout, c = q % Fout;
    const int r = row0 + i;
    float dm = 0.f, ld = 1.f;
    if (r < a.n_rows) {
      dm = a.d_mid[(size_t)r * Fout + c];
      ld = logf(fmaxf((float)a.deg[r], 1.f) + 1.f);
    }
    float* row = dy + i * 3 * Fout;
    row[c] = dm;
    row[Fout + c] = (ld / a.delta) * dm;
    row[2 * Fout + c] = (a.delta / ld) * dm;
  }
  __syncthreads();

  const int K = 3 * Fout;
  const int ld4 = 4 * F;
  for (int c0 = 0; c0 < F; c0 += CB) {
    const int c = c0 + col;
    // d_agg of this thread's rows in the four aggregator blocks
    float da[4][RG];
#pragma unroll
    for (int i = 0; i < RG; ++i)
      da[0][i] = da[1][i] = da[2][i] = da[3][i] = 0.f;
    for (int k = 0; k < K; k += 4) {
      float w[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* kr = a.ks_t + (size_t)(k + q) * ld4 + c;
#pragma unroll
        for (int b = 0; b < 4; ++b) w[b][q] = __ldg(kr + b * F);
      }
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        const float4 d4 =
            *reinterpret_cast<const float4*>(dy + (i0 + i) * K + k);
        const float dv4[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            da[b][i] = fmaf(dv4[q], w[b][q], da[b][i]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RG; ++i) {   // unrolled: da stays in registers
      const int r = row0 + i0 + i;
      const int d = s_deg[i0 + i];
      if (r >= a.n_rows) continue;
      const bool nonempty = d > 0;
      const float denom = fmaxf((float)d, 1.f);
      const float* ax = a.aux + (size_t)r * 5 * F;
      const float mx = ax[c], mn = ax[F + c], mean = ax[2 * F + c];
      const float sd = a.agg_cat[(size_t)r * 4 * F + 3 * F + c];
      const float c_lin = nonempty ? da[2][i] / denom : 0.f;
      const float c_a = da[3][i] / (denom * sd);
      const float c_mx = nonempty ? da[0][i] / fmaxf(ax[3 * F + c], 1.f)
                                  : 0.f;
      const float c_mn = nonempty ? da[1][i] / fmaxf(ax[4 * F + c], 1.f)
                                  : 0.f;
      float* o = a.cstk + (size_t)r * 7 * F + c;
      o[0] = c_lin;
      o[F] = c_a;
      o[2 * F] = __fmul_rn(c_a, mean);
      o[3 * F] = mx;
      o[4 * F] = c_mx;
      o[5 * F] = mn;
      o[6 * F] = c_mn;
    }
  }
}

// Dynamic shared memory of the launch with R rows per CTA.
size_t smem_bytes(int R, int Fout) {
  return (size_t)R * (3 * Fout + 1) * sizeof(float);
}

template <int R>
cudaError_t launch(const ScatterArgs& a, cudaStream_t s) {
  const size_t smem = smem_bytes(R, a.Fout);
  cudaError_t err = cudaFuncSetAttribute(
      pna_scatter_bwd_kernel<R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.n_rows + R - 1) / R;
  pna_scatter_bwd_kernel<R><<<blocks, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every width must be a multiple of this (one column block).
int gnnb_scatter_bwd_width_multiple() { return CB; }

// Dynamic shared memory the backward needs for this d_mid width, in
// bytes: that of the fewest rows per CTA (the launcher takes more rows
// where they fit).
int gnnb_scatter_bwd_smem_bytes(int Fout) {
  return (int)smem_bytes(MIN_R, Fout);
}

// Launches the backward on `stream` of `device`: it writes the [N, 7F]
// coefficient rows into `cstk`.  All arrays contiguous f32 / i32 as
// documented in ops/cuda/scatter_bwd.py.  Returns the cudaError_t of the
// launch (0 = success).
int gnnb_pna_scatter_bwd(const void* d_mid, const void* aux,
                         const void* agg_cat, const void* deg,
                         const void* ks_t, int n_rows, int F, int Fout,
                         float delta, void* cstk, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (F % CB || Fout % CB || F < CB || Fout < CB || n_rows < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  ScatterArgs a;
  a.d_mid = (const float*)d_mid;
  a.aux = (const float*)aux;
  a.agg_cat = (const float*)agg_cat;
  a.deg = (const int*)deg;
  a.ks_t = (const float*)ks_t;
  a.cstk = (float*)cstk;
  if (cstk == nullptr) return (int)cudaErrorInvalidValue;
  a.n_rows = n_rows;
  a.F = F;
  a.Fout = Fout;
  a.delta = delta;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t limit = (size_t)optin;
  if (smem_bytes(32, Fout) <= limit) return (int)launch<32>(a, s);
  if (smem_bytes(16, Fout) <= limit) return (int)launch<16>(a, s);
  if (smem_bytes(MIN_R, Fout) <= limit) return (int)launch<MIN_R>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
