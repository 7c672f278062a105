// The multi-aggregate of an ELL table: every requested aggregator of the
// messages t = (u_i +) v_j over each receiver's valid slots, concatenated
// in the caller's order into one [N, A*F] output.
//
// Replaces: gnnbuilder_tpu/ops/pallas/ell_agg.py fused_ell_aggregate
// (kernel body _kernel).  For every row r and column c, over the slots
// w < deg[r] in slot order, with t_w = v[nbr[r, w], c] (plus u[r, c]
// when u is given, added per slot before any reduction, as the file's
// _reference and the plain ELL path do):
//
//   sum   s = sum_w t_w
//   mean  s / max(deg, 1)
//   max   max_w t_w, 0 on an empty row
//   min   min_w t_w, 0 on an empty row
//   std   sqrt(relu(q / max(deg, 1) - mean^2) + 1e-5), q = sum_w t_w^2
//
// Each product and sum is rounded on its own (__fmul_rn, __fadd_rn: no
// fused multiply-add), as the plain version forms them, so the
// cancellation in std's E[t^2] - E[t]^2 is the plain version's.
//
// The bf16 mode (a template argument; the JAX kernel's gather_mode
// "bf16", inference only) rounds each gathered v to bf16, reduces the
// rounded g = v_j alone in float32, and applies u after the reduction, as
// the TPU kernel does (it commutes with sum, mean, max and min; std is
// shift-free): sum + deg u, u + mean, u + max, u + min (0 on an empty
// row), std of g.
//
// What bounds it on the H100: bytes.  It reads v once per slot (L2
// resident), u, the table and the degrees once, and writes A*F floats per
// row: a few operations per byte moved, far below the f32 ridge.
//
// Design: one thread owns one output element (r, c) and all A of its
// aggregates; consecutive threads take consecutive columns, so each
// gathered v row is read coalesced and the row's table entries are one
// broadcast.  The TPU kernel's one-hot gather products, hi/lo bf16
// passes and window DMAs existed because Mosaic has no dynamic row
// gather; here an indexed load is exact.

#include <cuda_runtime.h>
#include <math.h>

#include "quant.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_AGGS = 5;
constexpr float STD_EPS = 1e-5f;

enum Agg { SUM = 0, MEAN = 1, MAX = 2, MIN = 3, STD = 4 };

struct AggArgs {
  const float* v;     // [N, F]
  const float* u;     // [N, F] or null
  const int* nbr;     // [N, W]
  const int* deg;     // [N]
  float* out;         // [N, A*F]
  int n_rows, W, F, A;
  int codes;          // aggregator k's code in bits 3k .. 3k + 2
};

// Index arithmetic is 32-bit: the launcher takes N * A * F < 2^31, and the
// element counter is unsigned, so its last stride cannot overflow.
template <bool BF16>
__global__ void __launch_bounds__(THREADS) ell_agg_kernel(AggArgs a) {
  const unsigned total = (unsigned)a.n_rows * a.F;
  const int ld = a.A * a.F;
  for (unsigned e = blockIdx.x * THREADS + threadIdx.x; e < total;
       e += gridDim.x * THREADS) {
    const int r = (int)(e / a.F);
    const int c = (int)(e - (unsigned)r * a.F);
    const int d = a.deg[r];
    const int* nb = a.nbr + r * a.W;
    const bool has_u = a.u != nullptr;
    const float ur = has_u ? a.u[e] : 0.f;
    float s = 0.f, q = 0.f, mx = -INFINITY, mn = INFINITY;
    for (int w = 0; w < d; ++w) {
      float t = a.v[nb[w] * a.F + c];
      if (BF16)
        t = gnnb_quant::bf16r(t);   // u comes after the reduction
      else if (has_u)
        t = __fadd_rn(ur, t);
      s = __fadd_rn(s, t);
      q = __fadd_rn(q, __fmul_rn(t, t));
      mx = fmaxf(mx, t);
      mn = fminf(mn, t);
    }
    const float denom = fmaxf((float)d, 1.f);
    const float mean = s / denom;
    const bool shift = BF16 && has_u;   // u after the reduction
    float* o = a.out + r * ld + c;
    for (int k = 0; k < a.A; ++k) {
      float val;
      switch ((a.codes >> (3 * k)) & 7) {
        case SUM:
          val = shift ? __fadd_rn(s, __fmul_rn((float)d, ur)) : s;
          break;
        case MEAN:
          val = shift ? (d > 0 ? __fadd_rn(ur, mean) : 0.f) : mean;
          break;
        case MAX:
          val = d > 0 ? (shift ? __fadd_rn(ur, mx) : mx) : 0.f;
          break;
        case MIN:
          val = d > 0 ? (shift ? __fadd_rn(ur, mn) : mn) : 0.f;
          break;
        default: {
          const float var =
              fmaxf(__fsub_rn(q / denom, __fmul_rn(mean, mean)), 0.f);
          val = sqrtf(__fadd_rn(var, STD_EPS));
        }
      }
      o[k * a.F] = val;
    }
  }
}

}  // namespace

extern "C" {

// Launches the multi-aggregate on `stream` of `device`.  aggs holds A
// codes (0 sum, 1 mean, 2 max, 3 min, 4 std), in output order; u may be
// null; mode 0 f32, 1 bf16.  All arrays contiguous f32 / i32 as
// documented in ops/cuda/ell_agg.py.  Returns the cudaError_t of the
// launch (0 = success).
int gnnb_ell_agg(const void* v, const void* u, const void* nbr,
                 const void* deg, int n_rows, int W, int F, const int* aggs,
                 int A, int mode, void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows < 0 || W < 1 || F < 1 || A < 1 || A > MAX_AGGS ||
      (long long)n_rows * A * F >= (1ll << 31) || v == nullptr ||
      nbr == nullptr || deg == nullptr || out == nullptr ||
      (mode != gnnb_quant::F32 && mode != gnnb_quant::BF16))
    return (int)cudaErrorInvalidValue;
  AggArgs a;
  a.codes = 0;
  for (int k = 0; k < A; ++k) {
    if (aggs[k] < SUM || aggs[k] > STD) return (int)cudaErrorInvalidValue;
    a.codes |= aggs[k] << (3 * k);
  }
  if (n_rows == 0) return (int)cudaSuccess;
  a.v = (const float*)v;
  a.u = (const float*)u;
  a.nbr = (const int*)nbr;
  a.deg = (const int*)deg;
  a.out = (float*)out;
  a.n_rows = n_rows;
  a.W = W;
  a.F = F;
  a.A = A;
  const int want = (n_rows * F + THREADS - 1) / THREADS;
  const int blocks = want < (1 << 20) ? want : (1 << 20);
  if (mode == gnnb_quant::BF16)
    ell_agg_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
  else
    ell_agg_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
