// Reverse-table gather backward: dv of an ELL aggregation, as a gather
// over each sender's out-neighbours, with no scatter and no atomics.
//
// Replaces: gnnbuilder_tpu/ops/pallas/ell_bwd.py fused_gather_backward
// (kernel body _kernel).  cstk [N, K*F] holds per-receiver coefficients
// in F-wide blocks [c_lin? | d1, d2? | (ref_1, coef_1) .. (ref_C, coef_C)]
// with K = has_lin + 2*has_dev + 2*n_cmp.  For every sender row j and
// column c, over j's reverse-table slots r < out_degree[j] in slot order,
// with i = rev_nbr[j, r]:
//
//   dv[j, c] = sum_r  c_lin[i, c]
//                   + (v[j, c] * d1[i, c] - d2[i, c])
//                   + sum_k [v[j, c] == ref_k[i, c]] * coef_k[i, c]
//
// The dev term is formed exactly as written, each operation rounded on
// its own (__fmul_rn, __fsub_rn: no fused multiply-add), so a degree-1
// receiver, whose mean is v[j] bitwise and whose d2 is the rounded
// product d1 * mean, contributes an exact zero, as XLA's gradient through
// relu'(0) at var == 0 does (the TPU kernel's "exactness argument").
// The compares test v against the forward's saved extrema, so they repeat
// the forward's own decisions; the caller divides each extremum
// coefficient by its tie count (XLA's reduce-max VJP splits the gradient
// evenly among ties).
//
// What bounds it on the H100: bytes.  It does ~(1 + 2 + 2C) operations
// per gathered coefficient and reads cstk once per edge, v once and the
// table once, and writes dv once: for PNA's 7F-wide cstk, ~0.1 flop per
// byte, far below the f32 ridge of 20.
//
// Design: one thread owns one output element (j, c); consecutive threads
// take consecutive columns, so each gathered cstk row is read coalesced.
// The sum of each element runs in slot order in one thread, so the result
// is the same bits on every run.  The TPU kernel's count-matrix one-hot
// products and hi/lo bf16 passes existed because Mosaic has no dynamic
// row gather; here an indexed load is exact.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct GatherArgs {
  const float* cstk;   // [N, K*F]
  const int* rev;      // [N, Wr]
  const int* odeg;     // [N]
  const float* v;      // [N, F] (dev / cmp terms; may be null otherwise)
  float* dv;           // [N, F]
  int n_rows, Wr, F, has_lin, has_dev, n_cmp;
};

__global__ void __launch_bounds__(THREADS)
ell_gather_bwd_kernel(GatherArgs a) {
  const size_t total = (size_t)a.n_rows * a.F;
  const int K = a.has_lin + 2 * a.has_dev + 2 * a.n_cmp;
  const size_t ld = (size_t)K * a.F;
  for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (size_t)gridDim.x * THREADS) {
    const int j = (int)(e / a.F);
    const int c = (int)(e % a.F);
    const float vj = a.v != nullptr ? a.v[e] : 0.f;
    const int d = a.odeg[j];
    const int* slots = a.rev + (size_t)j * a.Wr;
    float acc = 0.f;
    for (int r = 0; r < d; ++r) {
      const float* ci = a.cstk + (size_t)slots[r] * ld + c;
      int o = 0;
      if (a.has_lin) {
        acc += ci[0];
        o = a.F;
      }
      if (a.has_dev) {
        acc += __fsub_rn(__fmul_rn(vj, ci[o]), ci[o + a.F]);
        o += 2 * a.F;
      }
      for (int k = 0; k < a.n_cmp; ++k, o += 2 * a.F)
        if (vj == ci[o]) acc += ci[o + a.F];
    }
    a.dv[e] = acc;
  }
}

}  // namespace

extern "C" {

// Launches the gather on `stream` of `device`.  All arrays contiguous
// f32 / i32 as documented in ops/cuda/ell_bwd.py.  Returns the
// cudaError_t of the launch (0 = success).
int gnnb_ell_gather_bwd(const void* cstk, const void* rev, const void* odeg,
                        const void* v, int n_rows, int rev_width, int F,
                        int has_lin, int has_dev, int n_cmp, void* dv,
                        void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows < 0 || F < 1 || n_cmp < 0 ||
      has_lin + 2 * has_dev + 2 * n_cmp == 0 ||
      ((has_dev || n_cmp) && v == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  GatherArgs a;
  a.cstk = (const float*)cstk;
  a.rev = (const int*)rev;
  a.odeg = (const int*)odeg;
  a.v = (const float*)v;
  a.dv = (float*)dv;
  a.n_rows = n_rows;
  a.Wr = rev_width;
  a.F = F;
  a.has_lin = has_lin != 0;
  a.has_dev = has_dev != 0;
  a.n_cmp = n_cmp;
  const size_t total = (size_t)n_rows * F;
  const size_t want = (total + THREADS - 1) / THREADS;
  const int blocks = (int)(want < (size_t)1 << 20 ? want : (size_t)1 << 20);
  ell_gather_bwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
