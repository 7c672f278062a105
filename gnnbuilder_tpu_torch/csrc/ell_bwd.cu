// Reverse-table gather backward: dv of an ELL aggregation, as a gather
// over each sender's out-neighbours, with no scatter and no atomics.
// Two modes, a template argument each so that neither moves the other's
// registers: the table mode walks the batch's reverse ELL table
// rev_nbr[j, :out_degree[j]]; the CSR mode walks
// rev_idx[rev_ptr[j] : rev_ptr[j + 1]] (ops/ell.py reverse_csr, built on
// the card from the forward table for batches that carry no reverse
// table).
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
// Design (bytes in flight, not arithmetic).  A group of GS lanes owns a
// sender row j (GS = F / V rounded up to a power of two, at most 32: a
// warp a row at F = 128, two at 64 or 11), each lane V columns: a float4
// where F % 4 == 0, else one.  Lane 0 of the group loads j's out-degree,
// and lane l slot l's receiver (GS slots at a time); the group reads them
// by __shfl_sync (in table mode the first GS ids are loaded beside the
// degree).  The term set is a template argument (lin-only, PNA's
// lin + dev + 2 cmp, cmp-only; one instance takes the terms at run time),
// so the slot and term loops unroll: U slots' coefficient rows (U = 4,
// PNA's 2) are loaded, on the read-only path without L1 allocation,
// before their adds, which run in slot order and, within a slot, in the
// term order above, each element in one lane: the parent kernel's sum,
// the same bits on every run.  Index math is 32-bit (N * K * F is checked
// at the entry) but for one 64-bit row base per gathered row.  The grid
// is a whole number of CTAs an SM (the instance's occupancy) on every
// SM, each CTA's warps striding over the row groups.  The TPU kernel's
// count-matrix one-hot products and hi/lo bf16 passes existed because
// Mosaic has no dynamic row gather; here an indexed load is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct GatherArgs {
  const float* cstk;   // [N, K*F]
  const int* rev;      // [N, Wr] (table mode) or rev_idx [E] (CSR mode)
  const int* odeg;     // [N] (table mode) or rev_ptr [N + 1] (CSR mode)
  const float* v;      // [N, F] (dev / cmp terms; may be null otherwise)
  float* dv;           // [N, F]
  int n_rows, Wr, F, has_lin, has_dev, n_cmp, gs;
};

// term sets: a template argument each; ANY takes GatherArgs' at run time
enum TermSet { ANY = 0, LIN = 1, PNA = 2, CMP = 3 };
template <int TS> struct Terms;
template <int L, int D, int C> struct TermsOf {
  static constexpr int lin = L, dev = D, cmp = C;
};
template <> struct Terms<LIN> : TermsOf<1, 0, 0> {};
template <> struct Terms<PNA> : TermsOf<1, 1, 2> {};
template <> struct Terms<CMP> : TermsOf<0, 0, 1> {};

template <int V> struct Cols { float c[V]; };

// V floats at p, read-only and not allocated in L1 (each receiver's
// coefficient row is read by its few senders, rarely from one SM)
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

// acc += one slot's terms of coefficient row g (K blocks of this lane's
// columns) in the kernel's order: c_lin, v d1 - d2, then each compare
template <int V>
__device__ __forceinline__ void add_terms(float (&acc)[V], const Cols<V>* g,
                                          const float (&vj)[V], int lin,
                                          int dev, int cmp) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    int b = 0;
    if (lin) acc[k] += g[b++].c[k];
    if (dev) {
      acc[k] += __fsub_rn(__fmul_rn(vj[k], g[b].c[k]), g[b + 1].c[k]);
      b += 2;
    }
    for (int q = 0; q < cmp; ++q, b += 2)
      if (vj[k] == g[b].c[k]) acc[k] += g[b + 1].c[k];
  }
}

template <bool CSR, int TS, int V>
__global__ void __launch_bounds__(THREADS)
ell_gather_bwd_kernel(GatherArgs a) {
  const int F = a.F, GS = a.gs, RPW = 32 / GS;
  const int lane = threadIdx.x & 31, gl = lane % GS, sub = lane / GS;
  int lin, dev, cmp;
  if constexpr (TS == ANY) {
    lin = a.has_lin;
    dev = a.has_dev;
    cmp = a.n_cmp;
  } else {
    lin = Terms<TS>::lin;
    dev = Terms<TS>::dev;
    cmp = Terms<TS>::cmp;
  }
  const int K = lin + 2 * dev + 2 * cmp;
  const int ld = K * F;
  const int warps = gridDim.x * WARPS;
  for (int j0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * RPW;
       j0 < a.n_rows; j0 += warps * RPW) {
    const int j = j0 + sub;
    const bool rok = j < a.n_rows;
    // out-degree; the first slot (CSR); in table mode each lane's first
    // slot id, loaded beside the degree (the table is Wr wide whatever
    // the degree), so a row waits on one dependent load less
    int d = 0, base = 0, first = 0;
    if (rok) {
      if (CSR) {
        if (gl == 0) {
          base = __ldg(a.odeg + j);
          d = __ldg(a.odeg + j + 1) - base;
        }
      } else {
        if (gl == 0) d = __ldg(a.odeg + j);
        if (gl < a.Wr) first = __ldg(a.rev + (size_t)j * a.Wr + gl);
      }
    }
    d = __shfl_sync(0xffffffffu, d, 0, GS);
    base = __shfl_sync(0xffffffffu, base, 0, GS);
    int most = d;   // the warp's longest row: its groups loop together
    for (int o = 16; o > 0; o >>= 1)
      most = max(most, __shfl_xor_sync(0xffffffffu, most, o));
    const int* slots =
        CSR ? a.rev + base : a.rev + (size_t)(rok ? j : 0) * a.Wr;
    for (int c0 = 0; c0 < F; c0 += GS * V) {
      const int c = c0 + V * gl;
      const bool cok = rok && c < F;
      float vj[V], acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = vj[k] = 0.f;
      if ((dev || cmp) && cok) {
        const Cols<V> t = ld_cols<V>(a.v + (size_t)j * F + c);
#pragma unroll
        for (int k = 0; k < V; ++k) vj[k] = t.c[k];
      }
      for (int wb = 0; wb < most; wb += GS) {
        const int mine = !CSR && wb == 0 ? first
                         : wb + gl < d ? __ldg(slots + wb + gl) : 0;
        const int m = min(GS, most - wb);
        if constexpr (TS == ANY) {   // one slot at a time, K at run time
          for (int w = 0; w < m; ++w) {
            const int i = __shfl_sync(0xffffffffu, mine, w, GS);
            if (!cok || wb + w >= d) continue;
            const float* ci = a.cstk + (size_t)i * ld + c;
            Cols<V> g[2 + 2 * 2 * 4];   // lin, dev, and up to 4 compares
            for (int b = 0; b < K; ++b) g[b] = ld_cols<V>(ci + b * F);
            add_terms<V>(acc, g, vj, lin, dev, cmp);
          }
        } else {
          constexpr int KC = Terms<TS>::lin + 2 * Terms<TS>::dev +
                             2 * Terms<TS>::cmp;
          constexpr int U = KC >= 5 ? 2 : 4;   // slots in flight
          for (int w = 0; w < m; w += U) {
            Cols<V> g[U][KC];
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int i = __shfl_sync(0xffffffffu, mine, (w + u) % GS, GS);
              if (cok && w + u < m && wb + w + u < d) {
                const float* ci = a.cstk + (size_t)i * ld + c;
#pragma unroll
                for (int b = 0; b < KC; ++b) g[u][b] = ld_cols<V>(ci + b * F);
              }
            }
#pragma unroll
            for (int u = 0; u < U; ++u)
              if (cok && w + u < m && wb + w + u < d)
                add_terms<V>(acc, g[u], vj, Terms<TS>::lin, Terms<TS>::dev,
                             Terms<TS>::cmp);
          }
        }
      }
      if (cok) {
        float* o = a.dv + (size_t)j * F + c;
        if constexpr (V == 4)
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
        else
          *o = acc[0];
      }
    }
  }
}

template <bool CSR, int TS, int V>
cudaError_t launch_v(const GatherArgs& a, cudaStream_t s, int device) {
  // CTAs an SM of this instance, worked out at its first launch
  static int per_sm = 0, sms = 0;
  if (per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ell_gather_bwd_kernel<CSR, TS, V>, THREADS, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) {
      per_sm = 0;
      return err;
    }
  }
  const int groups = THREADS / 32 * (32 / a.gs);   // rows a CTA a pass
  const long long want = ((long long)a.n_rows + groups - 1) / groups;
  const long long most = (long long)per_sm * sms;
  const int blocks = (int)(want < most ? want : most);
  ell_gather_bwd_kernel<CSR, TS, V><<<blocks, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

template <bool CSR, int TS>
cudaError_t launch_ts(const GatherArgs& a, cudaStream_t s, int device) {
  return a.F % 4 == 0 ? launch_v<CSR, TS, 4>(a, s, device)
                      : launch_v<CSR, TS, 1>(a, s, device);
}

int launch(const void* cstk, const void* rev, const void* odeg,
           const void* v, int n_rows, int rev_width, int F, int has_lin,
           int has_dev, int n_cmp, void* dv, void* stream, int device,
           bool csr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long K = (has_lin != 0) + 2 * (has_dev != 0) + 2LL * n_cmp;
  if (n_rows < 0 || F < 1 || n_cmp < 0 || n_cmp > 4 || K == 0 ||
      ((has_dev || n_cmp) && v == nullptr) ||
      (long long)n_rows * K * F >= (1LL << 31) ||
      (F % 4 == 0 && ((uintptr_t)cstk | (uintptr_t)v | (uintptr_t)dv) % 16))
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
  const int lanes = F % 4 == 0 ? F / 4 : F;
  a.gs = 1;
  while (a.gs < 32 && a.gs < lanes) a.gs *= 2;
  cudaStream_t s = (cudaStream_t)stream;
  const int ts = a.has_lin && !a.has_dev && n_cmp == 0   ? LIN
                 : a.has_lin && a.has_dev && n_cmp == 2  ? PNA
                 : !a.has_lin && !a.has_dev && n_cmp == 1 ? CMP
                                                          : ANY;
  if (csr) {
    if (ts == LIN) return (int)launch_ts<true, LIN>(a, s, device);
    if (ts == PNA) return (int)launch_ts<true, PNA>(a, s, device);
    if (ts == CMP) return (int)launch_ts<true, CMP>(a, s, device);
    return (int)launch_ts<true, ANY>(a, s, device);
  }
  if (ts == LIN) return (int)launch_ts<false, LIN>(a, s, device);
  if (ts == PNA) return (int)launch_ts<false, PNA>(a, s, device);
  if (ts == CMP) return (int)launch_ts<false, CMP>(a, s, device);
  return (int)launch_ts<false, ANY>(a, s, device);
}

}  // namespace

extern "C" {

// Launches the gather over the reverse table on `stream` of `device`.
// All arrays contiguous f32 / i32 as documented in ops/cuda/ell_bwd.py;
// N * K * F below 2^31 and at most 4 compares.  Returns the cudaError_t
// of the launch (0 = success).
int gnnb_ell_gather_bwd(const void* cstk, const void* rev, const void* odeg,
                        const void* v, int n_rows, int rev_width, int F,
                        int has_lin, int has_dev, int n_cmp, void* dv,
                        void* stream, int device) {
  return launch(cstk, rev, odeg, v, n_rows, rev_width, F, has_lin, has_dev,
                n_cmp, dv, stream, device, false);
}

// The same over the reverse CSR (rev_ptr [N + 1], rev_idx [E] int32).
int gnnb_ell_gather_bwd_csr(const void* cstk, const void* rev_ptr,
                            const void* rev_idx, const void* v, int n_rows,
                            int F, int has_lin, int has_dev, int n_cmp,
                            void* dv, void* stream, int device) {
  return launch(cstk, rev_idx, rev_ptr, v, n_rows, 0, F, has_lin, has_dev,
                n_cmp, dv, stream, device, true);
}

// Registers per thread and resident CTAs per SM of the instance of the
// term set ts (0 run-time terms, 1 lin-only, 2 PNA's, 3 cmp-only), CSR
// mode (csr) and float4 columns (vec), on the current device.
int gnnb_ell_gather_bwd_info(int csr, int ts, int vec, int* regs,
                             int* ctas_per_sm) {
  const void* k = nullptr;
#define GNNB_PICK(C, T)                                                  \
  if (csr == C && ts == T)                                               \
    k = vec ? (const void*)ell_gather_bwd_kernel<C, T, 4>                \
            : (const void*)ell_gather_bwd_kernel<C, T, 1>;
  GNNB_PICK(false, ANY) GNNB_PICK(false, LIN) GNNB_PICK(false, PNA)
  GNNB_PICK(false, CMP) GNNB_PICK(true, ANY) GNNB_PICK(true, LIN)
  GNNB_PICK(true, PNA) GNNB_PICK(true, CMP)
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
