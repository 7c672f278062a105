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
// Design (bytes in flight, as the gather backward, ell_bwd.cu).  A group
// of GS lanes owns a row r (GS = F / V rounded up to a power of two, at
// least U and at most 32: a warp a row at F = 128, two rows at 64 or 11,
// eight where four lanes cover F, the surplus lanes loading ids only),
// each lane V columns: a float4 where F % 4 == 0 and the arrays are
// 16-byte aligned, else one.  Lane 0 of the group loads r's degree and lane l slot l's
// sender id, beside it (the table is W wide whatever the degree), and the
// group reads the ids by __shfl_sync.  U slots' v rows are loaded, on the
// read-only path without L1 allocation, before their terms are added,
// which run in slot order, each element in one lane: per element the
// parent kernel's operations in the parent kernel's order, so the outputs
// are its bits (ell_aggregate_ordered in ops/cuda/ell_agg.py forms the
// same sums in torch).  The aggregator set is a template argument for the
// sets the convs launch (max, min, mean, sum, PNA's block min / max and
// its five), so the statistics it does not read are not formed and the
// output loop unrolls; one instance takes the codes at run time, its
// switch once per lane and aggregator, outside the per-element work.
// Index math is 32-bit (N * A * F < 2^31 is checked at the entry).  The
// grid is the instance's occupancy on every SM, each CTA's warps striding
// over the row groups.  The TPU kernel's one-hot gather products, hi/lo
// bf16 passes and window DMAs existed because Mosaic has no dynamic row
// gather; here an indexed load is exact.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "quant.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_AGGS = 5;
constexpr int U = 4;   // slots' loads in flight per lane
constexpr float STD_EPS = 1e-5f;
constexpr unsigned FULL = 0xffffffffu;

enum Agg { SUM = 0, MEAN = 1, MAX = 2, MIN = 3, STD = 4 };

// aggregator k's code in bits 3k .. 3k + 2
__host__ __device__ constexpr int code_at(int codes, int k) {
  return (codes >> (3 * k)) & 7;
}

// the template sets, in the convs' output order; ANY = codes at run time
enum Set { ANY = 0, S_MAX, S_MIN, S_MEAN, S_SUM, S_MIN_MAX, S_PNA5, N_SETS };
__host__ __device__ constexpr int set_aggs(int set) {
  return set == ANY ? 0 : set == S_MIN_MAX ? 2 : set == S_PNA5 ? 5 : 1;
}
__host__ __device__ constexpr int set_codes(int set) {
  switch (set) {
    case S_MAX: return MAX;
    case S_MIN: return MIN;
    case S_MEAN: return MEAN;
    case S_SUM: return SUM;
    case S_MIN_MAX: return MIN | MAX << 3;
    case S_PNA5: return SUM | MEAN << 3 | MIN << 6 | MAX << 9 | STD << 12;
    default: return 0;
  }
}

// the statistics a set reads: the sum, the sum of squares, the max, the
// min
enum Need { N_S = 1, N_Q = 2, N_MX = 4, N_MN = 8 };
__host__ __device__ constexpr int needs(int A, int codes) {
  int n = 0;
  for (int k = 0; k < A; ++k) {
    const int c = code_at(codes, k);
    n |= c == SUM || c == MEAN ? N_S
         : c == MAX            ? N_MX
         : c == MIN            ? N_MN
                               : N_S | N_Q;
  }
  return n;
}

struct AggArgs {
  const float* v;     // [N, F]
  const float* u;     // [N, F] or null
  const int* nbr;     // [N, W]
  const int* deg;     // [N]
  float* out;         // [N, A*F]
  int n_rows, W, F, A, codes, gs;
};

template <int V> struct Cols { float c[V]; };

// V floats at p, read-only and not allocated in L1 (a sender's row is
// read by its few receivers, rarely from one SM)
__device__ __forceinline__ Cols<4> ld_nc(const float* p, Cols<4>*) {
  Cols<4> r;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(r.c[0]), "=f"(r.c[1]), "=f"(r.c[2]), "=f"(r.c[3])
      : "l"(p));
  return r;
}
__device__ __forceinline__ Cols<1> ld_nc(const float* p, Cols<1>*) {
  Cols<1> r;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(r.c[0]) : "l"(p));
  return r;
}
template <int V>
__device__ __forceinline__ Cols<V> ld_cols(const float* p) {
  return ld_nc(p, static_cast<Cols<V>*>(nullptr));
}

template <bool BF16, int SET, int V>
__global__ void __launch_bounds__(THREADS) ell_agg_kernel(AggArgs a) {
  constexpr int AT = set_aggs(SET), CT = set_codes(SET);
  constexpr int NEED_T = needs(AT, CT);
  const int A = SET == ANY ? a.A : AT;
  const int codes = SET == ANY ? a.codes : CT;
  const int need = SET == ANY ? needs(a.A, a.codes) : NEED_T;
  const int F = a.F, W = a.W, GS = a.gs, RPW = 32 / GS;
  const int lane = threadIdx.x & 31, gl = lane % GS, sub = lane / GS;
  const int ld = A * F;
  const bool has_u = a.u != nullptr;
  const bool shift = BF16 && has_u;   // u after the reduction
  const int stride = gridDim.x * WARPS * RPW;
  for (int r0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * RPW;
       r0 < a.n_rows; r0 += stride) {
    const int r = r0 + sub;
    const bool rok = r < a.n_rows;
    // the degree, and each lane's first slot id loaded beside it
    int d = 0, first = 0;
    if (rok) {
      if (gl == 0) d = __ldg(a.deg + r);
      if (gl < W) first = __ldg(a.nbr + r * W + gl);
    }
    d = __shfl_sync(FULL, d, 0, GS);
    int most = d;   // the warp's longest row: its groups loop together
    for (int o = 16; o > 0; o >>= 1)
      most = max(most, __shfl_xor_sync(FULL, most, o));
    const int* nb = a.nbr + (rok ? r : 0) * W;
    for (int c0 = 0; c0 < F; c0 += GS * V) {
      const int c = c0 + V * gl;
      const bool cok = rok && c < F;
      float ur[V], s[V], q[V], mx[V], mn[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        ur[k] = s[k] = q[k] = 0.f;
        mx[k] = -INFINITY;
        mn[k] = INFINITY;
      }
      if (has_u && cok) {
        const Cols<V> t = ld_cols<V>(a.u + r * F + c);
#pragma unroll
        for (int k = 0; k < V; ++k) ur[k] = t.c[k];
      }
      for (int wb = 0; wb < most; wb += GS) {
        const int mine = wb == 0 ? first
                         : wb + gl < d ? __ldg(nb + wb + gl) : 0;
        const int m = min(GS, most - wb);
        for (int w = 0; w < m; w += U) {
          Cols<V> g[U];
#pragma unroll
          for (int uu = 0; uu < U; ++uu) {
            const int i = __shfl_sync(FULL, mine, w + uu, GS);
            if (cok && wb + w + uu < d) g[uu] = ld_cols<V>(a.v + i * F + c);
          }
#pragma unroll
          for (int uu = 0; uu < U; ++uu) {
            if (!cok || wb + w + uu >= d) continue;
#pragma unroll
            for (int k = 0; k < V; ++k) {
              float t = g[uu].c[k];
              if (BF16)
                t = gnnb_quant::bf16r(t);   // u comes after the reduction
              else if (has_u)
                t = __fadd_rn(ur[k], t);
              if (need & N_S) s[k] = __fadd_rn(s[k], t);
              if (need & N_Q) q[k] = __fadd_rn(q[k], __fmul_rn(t, t));
              if (need & N_MX) mx[k] = fmaxf(mx[k], t);
              if (need & N_MN) mn[k] = fminf(mn[k], t);
            }
          }
        }
      }
      if (!cok) continue;
      const float denom = fmaxf((float)d, 1.f);
      float* o = a.out + r * ld + c;
#pragma unroll
      for (int k = 0; k < (SET == ANY ? MAX_AGGS : AT); ++k) {
        if (k >= A) break;
        float val[V];
        switch (code_at(codes, k)) {   // once per lane and aggregator
          case SUM:
#pragma unroll
            for (int e = 0; e < V; ++e)
              val[e] = shift ? __fadd_rn(s[e], __fmul_rn((float)d, ur[e]))
                             : s[e];
            break;
          case MEAN:
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const float mean = s[e] / denom;
              val[e] = shift ? (d > 0 ? __fadd_rn(ur[e], mean) : 0.f) : mean;
            }
            break;
          case MAX:
#pragma unroll
            for (int e = 0; e < V; ++e)
              val[e] = d > 0 ? (shift ? __fadd_rn(ur[e], mx[e]) : mx[e]) : 0.f;
            break;
          case MIN:
#pragma unroll
            for (int e = 0; e < V; ++e)
              val[e] = d > 0 ? (shift ? __fadd_rn(ur[e], mn[e]) : mn[e]) : 0.f;
            break;
          default:
#pragma unroll
            for (int e = 0; e < V; ++e) {
              const float mean = s[e] / denom;
              const float var = fmaxf(
                  __fsub_rn(q[e] / denom, __fmul_rn(mean, mean)), 0.f);
              val[e] = sqrtf(__fadd_rn(var, STD_EPS));
            }
        }
        // streaming stores: the output is read by the next kernel, not
        // by this one, and should not push the gathered v out of L2
        if constexpr (V == 4)
          __stcs(reinterpret_cast<float4*>(o + k * F),
                 make_float4(val[0], val[1], val[2], val[3]));
        else
          __stcs(o + k * F, val[0]);
      }
    }
  }
}

template <bool BF16, int SET, int V>
cudaError_t launch_v(const AggArgs& a, cudaStream_t s, int device) {
  // CTAs an SM of this instance, worked out at its first launch
  static int per_sm = 0, sms = 0;
  if (per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ell_agg_kernel<BF16, SET, V>, THREADS, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) {
      per_sm = 0;
      return err;
    }
  }
  const int groups = WARPS * (32 / a.gs);   // rows a CTA a pass
  const long long want = ((long long)a.n_rows + groups - 1) / groups;
  const long long most = (long long)per_sm * sms;
  const int blocks = (int)(want < most ? want : most);
  ell_agg_kernel<BF16, SET, V><<<blocks, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

template <bool BF16, int SET>
cudaError_t launch_set(const AggArgs& a, bool vec, cudaStream_t s,
                       int device) {
  return vec ? launch_v<BF16, SET, 4>(a, s, device)
             : launch_v<BF16, SET, 1>(a, s, device);
}

template <bool BF16>
cudaError_t launch_mode(const AggArgs& a, int set, bool vec, cudaStream_t s,
                        int device) {
  switch (set) {
    case S_MAX: return launch_set<BF16, S_MAX>(a, vec, s, device);
    case S_MIN: return launch_set<BF16, S_MIN>(a, vec, s, device);
    case S_MEAN: return launch_set<BF16, S_MEAN>(a, vec, s, device);
    case S_SUM: return launch_set<BF16, S_SUM>(a, vec, s, device);
    case S_MIN_MAX: return launch_set<BF16, S_MIN_MAX>(a, vec, s, device);
    case S_PNA5: return launch_set<BF16, S_PNA5>(a, vec, s, device);
    default: return launch_set<BF16, ANY>(a, vec, s, device);
  }
}

// the template set of (A, codes), else ANY
int set_of(int A, int codes) {
  for (int k = 1; k < N_SETS; ++k)
    if (set_aggs(k) == A && set_codes(k) == codes) return k;
  return ANY;
}

// lanes rounded up to a power of two, at least U (a pass takes U slots
// from U lanes' ids, so GS is a multiple of U) and at most 32
int group_size(int lanes) {
  int gs = U;
  while (gs < 32 && gs < lanes) gs *= 2;
  return gs;
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
      (long long)n_rows * A * F >= (1ll << 31) ||
      (long long)n_rows * W >= (1ll << 31) || v == nullptr ||
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
  const bool vec =
      F % 4 == 0 &&
      ((uintptr_t)v | (uintptr_t)u | (uintptr_t)out) % 16 == 0;
  a.gs = group_size(vec ? F / 4 : F);
  const int set = set_of(A, a.codes);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == gnnb_quant::BF16)
    return (int)launch_mode<true>(a, set, vec, s, device);
  return (int)launch_mode<false>(a, set, vec, s, device);
}

// Registers per thread and resident CTAs per SM of the instance of the
// aggregator set `set` (0 codes at run time, 1 max, 2 min, 3 mean, 4 sum,
// 5 min and max, 6 sum, mean, min, max and std), mode (bf16) and float4
// columns (vec), on the current device.
int gnnb_ell_agg_info(int set, int bf16, int vec, int* regs,
                      int* ctas_per_sm) {
  const void* k = nullptr;
#define GNNB_PICK(S)                                                      \
  if (set == S)                                                           \
    k = bf16 ? (vec ? (const void*)ell_agg_kernel<true, S, 4>             \
                    : (const void*)ell_agg_kernel<true, S, 1>)            \
             : (vec ? (const void*)ell_agg_kernel<false, S, 4>            \
                    : (const void*)ell_agg_kernel<false, S, 1>);
  GNNB_PICK(ANY) GNNB_PICK(S_MAX) GNNB_PICK(S_MIN) GNNB_PICK(S_MEAN)
  GNNB_PICK(S_SUM) GNNB_PICK(S_MIN_MAX) GNNB_PICK(S_PNA5)
#undef GNNB_PICK
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, k,
                                                            THREADS, 0);
}

}  // extern "C"
