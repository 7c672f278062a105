// Fused readout: per-graph add/mean pooling, the [add|mean|max] concat,
// the whole MLP head and the output activation, one CTA per TG graphs.
//
// Replaces: gnnbuilder_tpu/ops/pallas/readout.py fused_readout (kernel
// body _kernel).  For graph g with rows [start_g, start_g + n_g):
//
//   s      = sum of x over the rows       mean = s / max(n_g, 1)
//   pooled = concat of s / mean / mx[g] in the order of `aggrs`
//   out    = out_act(MLP(pooled)),  relu-like `act` between the Linears
//
// Max pooling comes in as mx (computed outside, as in the JAX model).
// Row ranges are clipped to the batch, so the ghost graph (its range runs
// past the last row under block packing) gives finite garbage, masked
// downstream.
//
// What bounds it on the H100: bytes, and at this size latency.  Pooling
// reads each node row once (N*F*4 bytes); the MLP is ~25 k MACs per
// graph, ~50 MFLOP for 1,025 graphs, under a microsecond of f32 FMA.
//
// The head arrives packed (ops/cuda/readout.py pack_head): one float32
// buffer holding each Linear's weight in nn.Linear's [out, in] layout, one
// Linear after another, then every bias, then (int8) every column-scale
// vector, each piece 16-byte aligned.  GNNModel packs its head once per
// weights and mode for inference, with each row padded to its
// shared-memory stride (w_ld_smem); the wrapper packs (w, b) pairs on
// every call without the padding, which for a train step's live weights
// (views of the parameters) is one concatenation.
//
// Design (the parent ran staging, pooling and five serial Linears one
// after another in one wave of 129 CTAs: its time was one CTA's latency;
// bench/readout_variants.py times each choice below against its
// alternative, with %globaltimer phase marks):
// * Staging.  A padded head is one cp.async.bulk into shared memory that
//   thread 0 issues at kernel start, signalled on an mbarrier, waited for
//   only before the first Linear: the copy overlaps the pooling.  An
//   unpadded head every thread copies with ordinary loads, row by row to
//   the padded stride.  A head too large for shared memory is read from
//   device memory instead (L2 resident across CTAs), the same loop.
// * Pooling.  A lane group of THREADS / TG lanes per graph, float4
//   columns where F % 4 == 0 (F = 64: 16 lanes); each lane loads the max
//   row beside the graph's row range, then up to ROUND rows (QM9's
//   largest graph: 29) before it adds them, in row order from +0, as the
//   parent did: two rounds of loads, and the pooled values keep the
//   parent's bits.  x and mx are streamed (read once).
// * The head.  A thread owns HEAD_GT graphs x HEAD_RC columns (o = o0 +
//   cq + 16 j); a quarter-warp reads one graph's h (broadcast) and eight
//   consecutive weight rows, whose padded stride puts them in distinct
//   bank groups; two register sets of four k's operands ping-pong, the
//   next set's loads issued before this set's chains.  Each output's chain is the parent's: acc = b[o], then
//   fmaf over k = 0 .. din - 1 in order (INT8: the exact integer sum, as
//   float while partial sums stay below 2^24, then the parent's (float)q
//   * s_row * s_col + b), so every mode's outputs are the parent's bits.
//   One barrier a Linear (two in the modes, whose operand rows are
//   rounded or quantized in place first).
// * Output activation: a warp per graph (max by butterfly, exact; each
//   exp formed by its lane, the sum z in the parent's order).
// The head's Linears are bound by instruction issue and shared-memory
// latency at these few warps: 2 x 2 tiles with ping-ponged operand loads
// ran fastest (1 x 2 and 2 x 4 slower), TG = 16 graphs a CTA (65 CTAs)
// slower than 8 (129).
//
// Modes (the JAX kernel's mm and quant; the pooling stays exact in all):
//   F32  (0): as above.
//   BF16 (1): each Linear's input rows are rounded to bf16 in place before
//        the product, the weights arrive rounded to bf16 (held as f32 in
//        the packed buffer), and the sums stay f32 (mm="bf16").
//   INT8 (2): each Linear's input rows are quantized in place with one
//        symmetric scale each (s = max(max|h| / 127, 1e-12), q =
//        clip(rint(h / s), -127, 127)); the weights arrive as int8
//        values (held as f32 integers in the packed buffer, exact) with
//        one scale per column at s_off; the sum is int32 and y =
//        float(sum) * s_row * s_col + b: the JAX package's _qdot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dense_rows.cuh"
#include "mma_ring.cuh"
#include "quant.cuh"

namespace {

using gnnb_dense::act_fn;
using gnnb_quant::BF16;
using gnnb_quant::F32;
using gnnb_quant::INT8;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LIN = 8;
constexpr int MAX_AGGR = 3;
constexpr int ROUND = 32;       // rows a pooling lane loads before adding
constexpr int EXACT_K = 1024;   // int8: k's whose float sum is exact
constexpr int HEAD_GT = 2;      // graphs a thread owns in a Linear
constexpr int HEAD_RC = 2;      // columns a thread owns in a Linear
constexpr int TG = 8;           // graphs a CTA
constexpr int MAX_DEV = 64;
constexpr int STATIC_SMEM = 128;   // bytes: s_row[TG] and the barrier
constexpr unsigned FULL = 0xffffffffu;

struct Head {
  int n_lin, n_aggr;
  int dims[MAX_LIN + 1];  // dims[0] = pooled width, dims[n_lin] = out
  int aggr[MAX_AGGR];     // 0 add, 1 mean, 2 max
  // where the kernel reads each Linear (floats into P, the head in shared
  // or in device memory): its weight rows (stride w_ld), bias and (int8)
  // column scales
  int w_at[MAX_LIN], w_ld[MAX_LIN], b_at[MAX_LIN], s_at[MAX_LIN];
  // staging: a padded buffer (rows at their shared-memory stride) is one
  // bulk copy of stage_bytes; an unpadded one (rows at stride din rounded
  // up to 4, w_g) is copied row by row with ordinary loads, its tail (the
  // biases and scales) whole
  int padded;
  int w_g[MAX_LIN];
  int tail_g, tail_sm, tail_len, stage_bytes;
};

struct Args {
  const float* x;
  const int* starts;
  const int* n_node;
  const float* mx;
  const float* params;
  float* out;
  Head hd;
  int N, F, G, head_floats, ld, act, out_act;
};

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// A weight's row stride in shared memory: its rows rounded up to 4 words,
// and 4 more where that leaves (stride / 4) even, so that eight
// consecutive rows' float4 reads fall in distinct bank groups.
__host__ __device__ inline int w_ld_smem(int din) {
  const int d4 = round4(din);
  return (d4 / 4) % 2 ? d4 : d4 + 4;
}

// The row stride (words) of the activation buffers: the widest Linear
// input or output, rounded to 4 mod 32 (LD / 4 odd: eight rows' float4
// reads fall in distinct bank groups).
__host__ __device__ inline int ld_of(int width) {
  return (width + 27) / 32 * 32 + 4;
}

// Rows [0, TG) of the [TG, din] tile A (row stride ld) as the next
// product's operand, in place: rounded to bf16, or quantized to int8
// levels (f32 integers) with the row's scale in s[t]; one warp per row.
// The divisions are IEEE (no fast math), rintf rounds half to even.
template <int MODE>
__device__ void operand_rows(float* A, int ld, int din, float* s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < TG; t += WARPS) {
    float* a = A + t * ld;
    if (MODE == BF16) {
      for (int k = lane; k < din; k += 32) a[k] = gnnb_quant::bf16r(a[k]);
      continue;
    }
    float m = 0.f;
    for (int k = lane; k < din; k += 32) m = fmaxf(m, fabsf(a[k]));
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
    const float sc = fmaxf(m / 127.f, 1e-12f);
    for (int k = lane; k < din; k += 32)
      a[k] = fminf(fmaxf(rintf(a[k] / sc), -127.f), 127.f);
    if (lane == 0) s[t] = sc;
  }
}

template <int V> struct Cols { float c[V]; };

__device__ __forceinline__ Cols<4> ld_stream(const float* p, Cols<4>*) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  return {{q.x, q.y, q.z, q.w}};
}
__device__ __forceinline__ Cols<1> ld_stream(const float* p, Cols<1>*) {
  return {{__ldcs(p)}};
}
template <int V>
__device__ __forceinline__ Cols<V> ld_cols(const float* p) {
  return ld_stream(p, static_cast<Cols<V>*>(nullptr));
}

// The CTA's pooled rows into B (row t at B + t * ld): lane group t of
// THREADS / TG lanes, V columns a lane; each lane's sums in row order.
template <int V>
__device__ __forceinline__ void pool(const Args& a, int g0, float* B) {
  constexpr int L = THREADS / TG;
  const int t = threadIdx.x / L, gl = threadIdx.x % L, g = g0 + t;
  const int F = a.F;
  bool has_max = false;
  for (int q = 0; q < a.hd.n_aggr; ++q) has_max |= a.hd.aggr[q] == 2;
  // the first chunk's max row loaded beside the row range (it needs g
  // alone), so the rows' loads are the second and last round
  Cols<V> m0;
#pragma unroll
  for (int k = 0; k < V; ++k) m0.c[k] = 0.f;
  if (has_max && g < a.G && V * gl < F)
    m0 = ld_cols<V>(a.mx + g * F + V * gl);
  int st = 0, end = 0;
  float n = 0.f;
  if (g < a.G) {
    st = __ldg(a.starts + g);
    const int ng = __ldg(a.n_node + g);
    end = min(st + ng, a.N);
    n = (float)ng;
  }
  for (int c = V * gl; c < F; c += V * L) {
    float s[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] = 0.f;
    Cols<V> m = m0;
    if (c != V * gl && has_max && g < a.G) m = ld_cols<V>(a.mx + g * F + c);
    for (int r0 = st; r0 < end; r0 += ROUND) {
      Cols<V> row[ROUND];
#pragma unroll
      for (int i = 0; i < ROUND; ++i)
        if (r0 + i < end) row[i] = ld_cols<V>(a.x + (r0 + i) * F + c);
#pragma unroll
      for (int i = 0; i < ROUND; ++i)
        if (r0 + i < end)
#pragma unroll
          for (int k = 0; k < V; ++k) s[k] += row[i].c[k];
    }
    float* b = B + t * a.ld + c;
    for (int q = 0; q < a.hd.n_aggr; ++q) {
      const int code = a.hd.aggr[q];
#pragma unroll
      for (int k = 0; k < V; ++k)
        b[q * F + k] = code == 0   ? s[k]
                       : code == 1 ? s[k] / fmaxf(n, 1.f)
                                   : m.c[k];
    }
  }
}

// The operands of k .. k + 3: each graph's h and each column's weights.
template <int GT, int RC>
__device__ __forceinline__ void load4(const float* const (&h)[GT],
                                      const float* const (&w)[RC], int k,
                                      float4 (&hv)[GT], float4 (&wv)[RC]) {
#pragma unroll
  for (int i = 0; i < GT; ++i)
    hv[i] = *reinterpret_cast<const float4*>(h[i] + k);
#pragma unroll
  for (int j = 0; j < RC; ++j)
    wv[j] = *reinterpret_cast<const float4*>(w[j] + k);
}

// Four k's of every chain, in k order (the parent's fmaf chain).
template <int GT, int RC>
__device__ __forceinline__ void fma4(float (&acc)[GT][RC],
                                     const float4 (&hv)[GT],
                                     const float4 (&wv)[RC]) {
#pragma unroll
  for (int i = 0; i < GT; ++i)
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      float r = acc[i][j];
      r = fmaf(hv[i].x, wv[j].x, r);
      r = fmaf(hv[i].y, wv[j].y, r);
      r = fmaf(hv[i].z, wv[j].z, r);
      acc[i][j] = fmaf(hv[i].w, wv[j].w, r);
    }
}

// One Linear: nxt[t, o] = act(y) of the CTA's TG rows, y the parent's
// chain of each output; with `direct` (the last Linear without an output
// activation) written to out instead.  P: the head (shared or device
// memory).  A thread owns GT graphs x RC columns (o = o0 + cq + 16 j), a
// pass 16 RC columns: TG / GT x 16 threads, the CTA's other warps the
// next passes.  A quarter-warp reads one graph's h (broadcast) and eight
// consecutive weight rows (distinct bank groups: w_ld_smem).
template <int MODE>
__device__ __forceinline__ void linear(const Args& a, const float* P, int l,
                                       const float* in, float* nxt,
                                       const float* s_row, bool last,
                                       bool direct, int g0) {
  constexpr int GT = HEAD_GT, RC = HEAD_RC, QUADS = 16, PASS = QUADS * RC;
  constexpr int WPP = TG / GT * QUADS / 32;      // warps a pass
  constexpr int GROUPS = WARPS / WPP;            // passes side by side
  const int din = a.hd.dims[l], dout = a.hd.dims[l + 1];
  const float* W = P + a.hd.w_at[l];
  const int ldw = a.hd.w_ld[l];
  const float* bias = P + a.hd.b_at[l];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wi = warp % WPP, wg = warp / WPP;
  const int cq = lane % 8 + 8 * (wi % 2);
  const int t0 = GT * (lane / 8 + 4 * (wi / 2));
  const int d4 = din / 4 * 4;
  for (int o0 = wg * PASS; o0 < dout; o0 += GROUPS * PASS) {
    int o[RC];
    bool on[RC];
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      o[j] = o0 + cq + QUADS * j;
      on[j] = o[j] < dout;
    }
    if (!on[0]) continue;
    const float* h[GT];
#pragma unroll
    for (int i = 0; i < GT; ++i) h[i] = in + (t0 + i) * a.ld;
    const float* w[RC];
    float acc[GT][RC];
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      const int oj = on[j] ? o[j] : o[0];
      w[j] = W + oj * ldw;
      const float b0 = MODE == INT8 ? 0.f : bias[oj];
#pragma unroll
      for (int i = 0; i < GT; ++i) acc[i][j] = b0;
    }
    int q[GT][RC];   // int8: the exact sum of the k blocks done
#pragma unroll
    for (int i = 0; i < GT; ++i)
#pragma unroll
      for (int j = 0; j < RC; ++j) q[i][j] = 0;
    for (int kb = 0; kb < din; kb += EXACT_K) {
      const int ke = min(din, kb + EXACT_K), k4 = min(d4, ke);
      int k = kb;
      // two sets of four k's operands, ping-ponged: the next set's loads
      // issue before this set's chains (the load past k4 stays inside
      // the buffers: activation rows are padded, weight rows followed by
      // more of the head)
      float4 ha[GT], wa[RC], hb[GT], wb[RC];
      if (k < k4) load4<GT, RC>(h, w, k, ha, wa);
      for (; k + 8 <= k4; k += 8) {
        load4<GT, RC>(h, w, k + 4, hb, wb);
        fma4<GT, RC>(acc, ha, wa);
        load4<GT, RC>(h, w, k + 8, ha, wa);
        fma4<GT, RC>(acc, hb, wb);
      }
      if (k < k4) {
        fma4<GT, RC>(acc, ha, wa);
        k += 4;
      }
      for (; k < ke; ++k) {
#pragma unroll
        for (int i = 0; i < GT; ++i)
#pragma unroll
          for (int j = 0; j < RC; ++j)
            acc[i][j] = fmaf(h[i][k], w[j][k], acc[i][j]);
      }
      if (MODE == INT8) {
#pragma unroll
        for (int i = 0; i < GT; ++i)
#pragma unroll
          for (int j = 0; j < RC; ++j) {
            q[i][j] += (int)acc[i][j];
            acc[i][j] = 0.f;
          }
      }
    }
#pragma unroll
    for (int j = 0; j < RC; ++j) {
      if (!on[j]) continue;
#pragma unroll
      for (int i = 0; i < GT; ++i) {
        const int t = t0 + i;
        float y = acc[i][j];
        if (MODE == INT8)
          y = fmaf(__fmul_rn((float)q[i][j], s_row[t]),
                   P[a.hd.s_at[l] + o[j]], bias[o[j]]);
        if (!last) y = act_fn(y, a.act);
        if (direct) {
          if (g0 + t < a.G) a.out[(g0 + t) * dout + o[j]] = y;
        } else {
          nxt[t * a.ld + o[j]] = y;
        }
      }
    }
  }
}

// Stages the head into Ps: a padded buffer by one bulk copy that thread 0
// issues, completion on `bar`; an unpadded one (the live weights of a
// train step, views of the parameters) by every thread with ordinary
// loads, row by row to the padded stride (visible after the next
// barrier).
__device__ __forceinline__ void stage_head(const Args& a, float* Ps,
                                           uint32_t bar) {
  const Head& hd = a.hd;
  if (hd.padded) {
    if (threadIdx.x == 0) {
      gnnb_mma::mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      gnnb_mma::mbar_expect_tx(bar, hd.stage_bytes);
      gnnb_mma::bulk_copy(gnnb_mma::smem_addr(Ps), a.params, hd.stage_bytes,
                          bar);
    }
    return;
  }
  for (int l = 0; l < hd.n_lin; ++l) {
    const int q4 = round4(hd.dims[l]) / 4, dout = hd.dims[l + 1];
    const float4* src =
        reinterpret_cast<const float4*>(a.params + hd.w_g[l]);
    float* dst = Ps + hd.w_at[l];
    for (int i = threadIdx.x; i < dout * q4; i += THREADS) {
      const int r = i / q4, c = i - r * q4;
      *reinterpret_cast<float4*>(dst + r * hd.w_ld[l] + 4 * c) =
          __ldg(src + i);
    }
  }
  const float4* src = reinterpret_cast<const float4*>(a.params + hd.tail_g);
  float4* dst = reinterpret_cast<float4*>(Ps + hd.tail_sm);
  for (int i = threadIdx.x; i < hd.tail_len / 4; i += THREADS)
    dst[i] = __ldg(src + i);
}

template <int MODE, bool SMEM, int V>
__global__ void __launch_bounds__(THREADS, 1) readout_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);          // the staged head
  float* B0 = Ps + (SMEM ? a.head_floats : 0);         // [TG, ld]
  float* B1 = B0 + TG * a.ld;                          // [TG, ld]
  __shared__ float s_row[TG];                          // int8 row scales
  __shared__ __align__(8) uint64_t bar;
  const float* P = SMEM ? Ps : a.params;
  const int g0 = blockIdx.x * TG;
  const uint32_t b = gnnb_mma::smem_addr(&bar);
  if (SMEM) stage_head(a, Ps, b);
  pool<V>(a, g0, B0);
  __syncthreads();
  if (SMEM && a.hd.padded) gnnb_mma::mbar_wait(b, 0);

  const int L = a.hd.n_lin;
  float* in = B0;
  float* nxt = B1;
  for (int l = 0; l < L; ++l) {
    if (MODE != F32) {
      operand_rows<MODE>(in, a.ld, a.hd.dims[l], s_row);
      __syncthreads();
    }
    const bool last = l + 1 == L;
    linear<MODE>(a, P, l, in, nxt, s_row, last, last && !a.out_act, g0);
    __syncthreads();
    float* tmp = in;
    in = nxt;
    nxt = tmp;
  }
  if (!a.out_act) return;

  // softmax / log_softmax of each graph's outputs, a warp a graph; nxt is
  // free and holds each output's exp
  const int dout = a.hd.dims[L];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < TG; t += WARPS) {
    const int g = g0 + t;
    if (g >= a.G) break;
    const float* h = in + t * a.ld;
    float* e = nxt + t * a.ld;
    float m = -INFINITY;
    for (int j = lane; j < dout; j += 32) m = fmaxf(m, h[j]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
    for (int j = lane; j < dout; j += 32) e[j] = expf(h[j] - m);
    __syncwarp();
    float z = 0.f;
    for (int j = 0; j < dout; ++j) z += e[j];
    float* o = a.out + g * dout;
    for (int j = lane; j < dout; j += 32)
      o[j] = a.out_act == 1 ? e[j] / z : h[j] - m - logf(z);
  }
}

constexpr int N_INST = 12;   // instances: (MODE, SMEM, V)
// per device: the shared memory a block may opt in to (queried once), and
// the dynamic shared memory each instance's attribute allows so far (set
// again only for a larger launch)
struct DevInfo {
  int optin = -1;
  int attr[N_INST] = {};
};
DevInfo dev_info[MAX_DEV];

cudaError_t optin_of(int device, int* out) {
  if (device < 0 || device >= MAX_DEV) return cudaErrorInvalidDevice;
  DevInfo& d = dev_info[device];
  if (d.optin < 0) {
    int v = 0;
    const cudaError_t err = cudaDeviceGetAttribute(
        &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    d.optin = v;
  }
  *out = d.optin;
  return cudaSuccess;
}

// The instance's dynamic shared-memory attribute raised to `smem` where
// it allows less (per device; never lowered)
template <int MODE, bool SMEM, int V>
cudaError_t allow_smem(int smem, int device) {
  constexpr int inst = MODE * 4 + SMEM * 2 + (V == 4);
  static_assert(inst < N_INST, "instance index");
  DevInfo& d = dev_info[device];
  if (smem <= d.attr[inst]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      readout_kernel<MODE, SMEM, V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) d.attr[inst] = smem;
  return err;
}

template <int MODE, bool SMEM, int V>
cudaError_t launch_inst(const Args& a, int smem, cudaStream_t st,
                        int device) {
  const cudaError_t err = allow_smem<MODE, SMEM, V>(smem, device);
  if (err != cudaSuccess) return err;
  readout_kernel<MODE, SMEM, V><<<(a.G + TG - 1) / TG, THREADS, smem, st>>>(
      a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(const Args& a, bool in_smem, bool vec, int smem,
                        cudaStream_t st, int device) {
  if (in_smem)
    return vec ? launch_inst<MODE, true, 4>(a, smem, st, device)
               : launch_inst<MODE, true, 1>(a, smem, st, device);
  return vec ? launch_inst<MODE, false, 4>(a, smem, st, device)
             : launch_inst<MODE, false, 1>(a, smem, st, device);
}

int buffers_bytes(int width) {
  return 2 * TG * ld_of(width) * (int)sizeof(float);
}

// The head of `desc` (pack_head's layout) read from shared memory
// (in_smem) or from the packed buffer: fills hd and returns the floats
// the staged head takes in shared memory (-1 where desc is not a head the
// kernel takes).  The buffer holds each Linear's rows one Linear after
// another, at their shared-memory stride (padded) or at din rounded up
// to 4, then the biases and scales (the tail).
int head_layout(const int* desc, int n_params, Head& hd, bool in_smem,
                int* width) {
  hd.n_lin = desc[0];
  hd.n_aggr = desc[1];
  if (hd.n_lin < 1 || hd.n_lin > MAX_LIN || hd.n_aggr < 1 ||
      hd.n_aggr > MAX_AGGR || n_params % 4)
    return -1;
  const int* p = desc + 2;
  const int *w_off = p + MAX_LIN + 1, *b_off = w_off + MAX_LIN,
            *s_off = b_off + MAX_LIN, *aggr = s_off + MAX_LIN;
  hd.padded = aggr[MAX_AGGR] != 0;
  *width = 0;
  for (int i = 0; i <= MAX_LIN; ++i) {
    hd.dims[i] = i <= hd.n_lin ? p[i] : 0;
    if (i <= hd.n_lin && hd.dims[i] < 1) return -1;
    *width = hd.dims[i] > *width ? hd.dims[i] : *width;
  }
  for (int i = 0; i < MAX_AGGR; ++i) hd.aggr[i] = aggr[i];
  const int tail = b_off[0];
  int off = 0, bytes = 0;
  for (int l = 0; l < hd.n_lin; ++l) {
    const int din = hd.dims[l], dout = hd.dims[l + 1];
    const int g = hd.padded ? w_ld_smem(din) : round4(din);
    if (w_off[l] % 4 || w_off[l] + dout * g > tail || b_off[l] < tail ||
        b_off[l] + dout > n_params || s_off[l] % 4 || b_off[l] % 4)
      return -1;
    hd.w_g[l] = w_off[l];
    hd.w_at[l] = in_smem && !hd.padded ? off : w_off[l];
    hd.w_ld[l] = in_smem ? w_ld_smem(din) : g;
    off += dout * w_ld_smem(din);
    bytes += dout * g * 4;
  }
  hd.tail_g = tail;
  hd.tail_sm = hd.padded ? tail : off;
  hd.tail_len = n_params - tail;
  hd.stage_bytes = hd.padded ? n_params * 4 : bytes + hd.tail_len * 4;
  for (int l = 0; l < hd.n_lin; ++l) {
    const bool moved = in_smem && !hd.padded;
    hd.b_at[l] = moved ? off + b_off[l] - tail : b_off[l];
    hd.s_at[l] = moved ? off + s_off[l] - tail : s_off[l];
  }
  return hd.padded ? n_params : off + hd.tail_len;
}

}  // namespace

extern "C" {

int gnnb_readout_max_linears() { return MAX_LIN; }
int gnnb_readout_max_aggregators() { return MAX_AGGR; }

// Shared memory the launch needs at least, in bytes: the two activation
// buffers and the static bytes (the wrapper checks it against
// gnnb_smem_per_block_optin before launching); the launcher adds the
// staged head where it fits.
int gnnb_readout_smem_bytes(int width) {
  return buffers_bytes(width) + STATIC_SMEM;
}

// Shared memory one block of `device` may use, in bytes (0 on error);
// queried once per device.
int gnnb_smem_per_block_optin(int device) {
  int v = 0;
  return optin_of(device, &v) == cudaSuccess ? v : 0;
}

// desc: the head as pack_head lays it out, host ints: n_lin, n_aggr,
// dims[0 .. MAX_LIN], w_off, b_off, s_off [MAX_LIN] each (float offsets,
// multiples of 4; s_off read in mode 2 only), aggr [MAX_AGGR], padded (1:
// the rows at their shared-memory stride).  params:
// n_params floats (a multiple of 4) on `device`, 16-byte aligned; mx may
// be null when no aggregator is max.  Returns the cudaError_t of the
// launch (0 = success).
int gnnb_readout(const void* x, int n_rows, int feat, const void* starts,
                 const void* n_node, int n_graphs, const void* mx,
                 const void* params, int n_params, const int* desc, int act,
                 int out_act, int mode, void* out, void* stream,
                 int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (mode < F32 || mode > INT8 || (uintptr_t)params % 16 ||
      (long long)n_rows * feat >= (1ll << 31) ||
      (long long)n_graphs * feat >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  int optin = 0;
  err = optin_of(device, &optin);
  if (err != cudaSuccess) return (int)err;
  Args a;
  int width = 0;
  // the dynamic bytes a launch may take beside the kernel's static ones
  // (the row scales and the barrier)
  const int cap = optin - STATIC_SMEM;
  const int staged = head_layout(desc, n_params, a.hd, true, &width);
  if (staged < 0 || a.hd.dims[0] != a.hd.n_aggr * feat)
    return (int)cudaErrorInvalidValue;
  if (n_graphs == 0) return (int)cudaSuccess;
  const int buffers = buffers_bytes(width);
  const bool in_smem = buffers + staged * 4 <= cap;
  if (!in_smem) head_layout(desc, n_params, a.hd, false, &width);
  const int smem = buffers + (in_smem ? staged * 4 : 0);
  if (smem > cap) return (int)cudaErrorInvalidValue;
  a.x = (const float*)x;
  a.starts = (const int*)starts;
  a.n_node = (const int*)n_node;
  a.mx = (const float*)mx;
  a.params = (const float*)params;
  a.out = (float*)out;
  a.N = n_rows;
  a.F = feat;
  a.G = n_graphs;
  a.head_floats = in_smem ? staged : 0;
  a.ld = ld_of(width);
  a.act = act;
  a.out_act = out_act;
  const bool vec = feat % 4 == 0 &&
                   ((uintptr_t)x | (uintptr_t)mx) % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == BF16)
    return (int)launch_mode<BF16>(a, in_smem, vec, smem, st, device);
  if (mode == INT8)
    return (int)launch_mode<INT8>(a, in_smem, vec, smem, st, device);
  return (int)launch_mode<F32>(a, in_smem, vec, smem, st, device);
}

// Registers per thread, shared memory per CTA (static plus the dynamic
// bytes of the head `desc` staged) and resident CTAs per SM of the
// instance for (mode, float4 pooling), the head in shared memory, on
// `device`.
int gnnb_readout_info(int mode, int vec, const int* desc, int n_params,
                      int device, int* regs, int* smem_bytes,
                      int* ctas_per_sm) {
  Head hd;
  int width = 0;
  const int staged = head_layout(desc, n_params, hd, true, &width);
  if (staged < 0 || mode < F32 || mode > INT8)
    return (int)cudaErrorInvalidValue;
  int optin = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = optin_of(device, &optin);
  if (err != cudaSuccess) return (int)err;
  const int dyn = buffers_bytes(width) + 4 * staged;
  if (dyn > optin - STATIC_SMEM) return (int)cudaErrorInvalidValue;
  const void* k = nullptr;
#define GNNB_PICK(M)                                                      \
  if (mode == M) {                                                        \
    err = vec ? allow_smem<M, true, 4>(dyn, device)                       \
              : allow_smem<M, true, 1>(dyn, device);                      \
    k = vec ? (const void*)readout_kernel<M, true, 4>                     \
            : (const void*)readout_kernel<M, true, 1>;                    \
  }
  GNNB_PICK(F32) GNNB_PICK(BF16) GNNB_PICK(INT8)
#undef GNNB_PICK
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  *smem_bytes = (int)fa.sharedSizeBytes + dyn;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, k,
                                                            THREADS, dyn);
}

}  // extern "C"
