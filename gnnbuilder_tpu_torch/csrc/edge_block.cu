// One EdgeConv layer (Dynamic Graph CNN): x'_i = aggr_j lin1(relu(
// lin0([x_i || x_j - x_i]))) over each receiver's valid ELL slots, for
// aggr max, sum or mean, in two launches.
//
// Replaces: gnnbuilder_tpu/ops/pallas/edge_block.py fused_edge_block_layer
// (kernel body _kernel).  lin0 is PairLinear-split (w_pair [2 Fin, F],
// self rows first): [x_i || x_j - x_i] W0 + b0 = w_i + v_j with
//
//   v = x W_diff,  w = (x W_self + b0) - v
//
// and then, per valid slot s < deg[i] with j = nbr[i, s],
// t_s = relu(w_i + v_j):
//
//   max   o = max_s (t_s W1) + b1          (0 on an empty row)
//   sum   o = (sum_s t_s) W1 + deg b1
//   mean  o = ((sum_s t_s) / deg) W1 + b1  (0 on an empty row)
//   out   = act(o [+ skip])                (skip added before the act)
//
// What bounds it on the H100: operations (2 Fin F per row for each half
// of lin0, and for max 2 F Fout per valid slot), run on the tensor cores
// (tc_rows.cuh: 3 x TF32, or bf16).
//
// Design.  Both launches run tc_rows.cuh's product of rows in shared
// memory by the caller's row-major weights, streamed by k-chunks.  The
// first launch (128 rows a CTA) forms v and w for every row: x W_self +
// b0 into w, then x W_diff into v and w - v into w, each element by the
// thread that wrote it (one pass of both matrices would hold 128
// accumulators a thread).  They go to device memory (L2 resident at the
// canonical batch), because every receiver reads its neighbours' v, which
// another CTA forms.  The second launch gives a CTA 64 receiver rows.  For
// sum and mean it sums t over the valid slots first, as the TPU kernel
// does, and runs lin1 once (the 64-row product).  For max it runs lin1 on
// the valid (row, slot) pairs only: their slots are numbered row by row
// (a prefix sum of the degrees), 128 at a time a chunk (a QM9 row has ~2
// in-neighbours: one chunk a CTA); a chunk's t rows are built in shared
// memory with indexed loads of v (four pairs' loads in flight a thread),
// the product runs over the chunk's m-tiles that hold pairs, its rows go
// to shared memory, and each thread folds the pairs of its (row, column)
// elements into a running maximum, in slot order (a CTA of more pairs
// keeps its maxima in `out` between chunks).  The FMA kernel before built
// t for every row at every slot up to the CTA's largest in-degree and
// multiplied all of them, about half thrown away on QM9; a variant that
// runs per slot over all rows with the empty trailing m-tiles skipped
// measured no faster (PERF.md §6).  The TPU kernel's block-local
// one-hot gathers (hi/lo bf16 passes) existed because Mosaic has no
// dynamic row gather; an indexed load is exact and needs no block
// locality, so the kernel takes any ELL table, though EdgeConv sends it
// block-packed batches only, as the JAX package does.
//
// The bf16 mode (a template argument; the JAX kernel's gather_mode
// "bf16" with mm="bf16", inference only): w_pair and w1 are bf16, x's
// rows are rounded as they are loaded (they feed only products), each
// gathered v_j is rounded to bf16, and t (or its sum, or mean) is stored
// rounded for the lin1 product; sums stay float32.  There is no int8 mode,
// as in the JAX package (its gate declines under int8).
//
// No float is added atomically: every launch gives the same bits.

#include <cuda_runtime.h>
#include <math.h>

#include "tc_rows.cuh"

namespace {

namespace tc = gnnb_tc;
using gnnb_quant::bf16r;

constexpr int PR = 128;   // rows of a projection CTA; pairs of a max chunk
constexpr int RR = 64;    // receiver rows of a slot CTA
constexpr int NC = tc::NC;

enum Aggr { MAX = 0, SUM = 1, MEAN = 2 };

struct EdgeArgs {
  const float* x;        // [N, Fin]
  const int* nbr;        // [N, W]
  const int* deg;        // [N]
  const void* w_self;    // [Fin, F] (float32, or bf16 in the bf16 mode)
  const void* w_diff;    // [Fin, F]
  const float* b0;       // [F]
  const void* w1;        // [F, Fout]
  const float* b1;       // [Fout]
  const float* skip;     // [N, Fout] or null
  float* v;              // [N, F] scratch
  float* w;              // [N, F] scratch
  float* out;            // [N, Fout]
  int n_rows, W, Fin, F, Fout, aggr, act;
  int stages;            // weight stages in shared memory
  bool xvec;             // Fin % 4 == 0 and x 16-byte aligned
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// shared memory (bytes) of the projection launch: the stages, then x's
// rows
__host__ __device__ inline int proj_x_offset(int mode, int stages) {
  return stages * tc::chunk_bytes(mode);
}
__host__ __device__ inline int proj_bytes(int Fin, int mode, int stages) {
  return proj_x_offset(mode, stages) + PR * tc::lda_of(Fin, mode) * 4;
}

// the slot launch: the stages, the t rows (PR pairs of a max chunk, whose
// product rows go over them; RR receiver rows' sums), the degrees, the
// row offsets of the pairs and a chunk's pair rows
struct SlotLayout {
  int ldT, T, DEG, OFF, CROW, bytes;
};
__host__ __device__ inline SlotLayout slot_layout(int F, int mode,
                                                  int stages) {
  SlotLayout L;
  L.ldT = tc::lda_of(F, mode);
  L.T = stages * tc::chunk_bytes(mode);
  L.DEG = tc::align16(L.T + PR * imax(L.ldT, tc::LDY) * 4);
  L.OFF = L.DEG + RR * 4;
  L.CROW = L.OFF + (RR + 1) * 4;
  L.bytes = L.CROW + PR * 4;
  return L;
}

// v and w of 128 rows: x W_self + b0 into w, then x W_diff into v and
// w - v into w (each element by the thread that wrote it).
template <bool BF16>
__global__ void __launch_bounds__(tc::THREADS, 2)
edge_proj_tc_kernel(EdgeArgs a) {
  constexpr int MODE = BF16 ? gnnb_quant::BF16 : gnnb_quant::F32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Fin = a.Fin, F = a.F;
  const int ldX = tc::lda_of(Fin, MODE), kX = tc::kpad(Fin, MODE);
  float* X = reinterpret_cast<float*>(smem + proj_x_offset(MODE, a.stages));
  const int row0 = blockIdx.x * PR;
  const int rows = min(PR, a.n_rows - row0);
  // pass 2 n + m: matrix m (0 self, 1 diff), column tile n
  auto pass = [&](int i) {
    tc::Pass p;
    p.w = i % 2 ? a.w_diff : a.w_self;
    p.ldw = p.N = F;
    p.K = Fin;
    p.n0 = i / 2 * NC;
    return p;
  };
  const int npass = 2 * ((F + NC - 1) / NC);
  tc::Stream<MODE, PR> ws{smem, a.stages, 0};
  ws.prefetch(pass(0));
  if (a.xvec) {   // four columns a thread (one at a time it waited)
    const float4* x4 = reinterpret_cast<const float4*>(a.x);
    const int F4 = Fin / 4, K4 = kX / 4;
    for (int e = threadIdx.x; e < PR * K4; e += tc::THREADS) {
      const int i = e / K4, c4 = e % K4;
      float4 x = i < rows && c4 < F4 ? __ldg(x4 + (size_t)(row0 + i) * F4 + c4)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
      if (BF16) x = make_float4(bf16r(x.x), bf16r(x.y), bf16r(x.z), bf16r(x.w));
      *reinterpret_cast<float4*>(X + (size_t)i * ldX + 4 * c4) = x;
    }
  } else {
    for (int e = threadIdx.x; e < PR * kX; e += tc::THREADS) {
      const int i = e / kX, c = e % kX;
      const float x =
          i < rows && c < Fin ? a.x[(size_t)(row0 + i) * Fin + c] : 0.f;
      X[(size_t)i * ldX + c] = BF16 ? bf16r(x) : x;
    }
  }
  ws.stage_prefetched();
  __syncthreads();
  for (int i = 0; i < npass; ++i) {
    const int n0 = i / 2 * NC;
    tc::Acc<MODE, PR> acc;
    tc::zero<MODE, PR>(acc);
    ws.run(acc, X, ldX, pass(i), rows, pass(i + 1), i + 1 < npass);
    // four n-tiles' loads (w's u + b0 in the second pass) issued together
    using G = tc::Geo<PR>;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int cb = n0 + 8 * G::NT * (warp / G::WR) + 2 * (lane & 3);
#pragma unroll
    for (int mt = 0; mt < tc::MT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 32 * (warp % G::WR) + 16 * mt + (lane >> 2) + 8 * hh;
        if (r >= rows) continue;
        const size_t orow = (size_t)(row0 + r) * F;
#pragma unroll
        for (int j0 = 0; j0 < G::NT; j0 += 4) {
          float pre[4][2];   // b0, or u + b0
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const int c = cb + 8 * (j0 + j) + k;
              pre[j][k] = c >= F         ? 0.f
                          : i % 2 == 0 ? __ldg(a.b0 + c)
                                       : a.w[orow + c];
            }
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const int c = cb + 8 * (j0 + j) + k;
              if (c >= F) continue;
              const float y = acc[mt][j0 + j][2 * hh + k];
              if (i % 2 == 0) {   // u = x W_self + b0
                a.w[orow + c] = __fadd_rn(y, pre[j][k]);
              } else {            // v, and w = u - v
                a.v[orow + c] = y;
                a.w[orow + c] = __fsub_rn(pre[j][k], y);
              }
            }
        }
      }
  }
}

// n consecutive floats of row-major src at offset o (n = 4: one 16-byte
// load), and their store into T, rounded to bf16 with BF16
template <int n>
__device__ __forceinline__ void load_cols(float (&x)[n], const float* src,
                                          size_t o) {
  if constexpr (n == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(src + o));
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < n; ++k) x[k] = src[o + k];
  }
}
template <int n, bool BF16>
__device__ __forceinline__ void store_cols(float* dst, const float (&t)[n]) {
  float y[n];
#pragma unroll
  for (int k = 0; k < n; ++k) y[k] = BF16 ? bf16r(t[k]) : t[k];
  if constexpr (n == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
  else
#pragma unroll
    for (int k = 0; k < n; ++k) dst[k] = y[k];
}

// VW: columns a thread builds t for (4 where F % 4 == 0, else 1)
template <bool BF16, int VW>
__global__ void __launch_bounds__(tc::THREADS, 2)
edge_slot_tc_kernel(EdgeArgs a) {
  constexpr int MODE = BF16 ? gnnb_quant::BF16 : gnnb_quant::F32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = a.F, Fout = a.Fout;
  const SlotLayout L = slot_layout(F, MODE, a.stages);
  float* T = reinterpret_cast<float*>(smem + L.T);
  float* Y = T;   // a max chunk's product rows, once T is read
  int* s_deg = reinterpret_cast<int*>(smem + L.DEG);
  int* s_off = reinterpret_cast<int*>(smem + L.OFF);
  int* s_crow = reinterpret_cast<int*>(smem + L.CROW);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * RR;
  const int rows = min(RR, a.n_rows - row0);
  const int kF = tc::kpad(F, MODE);
  auto pass = [&](int n0) {
    tc::Pass p;
    p.w = a.w1;
    p.ldw = p.N = Fout;
    p.K = F;
    p.n0 = n0;
    return p;
  };
  // max: products over PR pairs a chunk; sum, mean: over the RR rows
  const bool is_max = a.aggr == MAX;
  tc::Stream<MODE, PR> wm{smem, a.stages, 0};
  tc::Stream<MODE, RR> ws{smem, a.stages, 0};
  if (is_max)
    wm.prefetch(pass(0));
  else
    ws.prefetch(pass(0));
  for (int i = tid; i < RR; i += tc::THREADS)
    s_deg[i] = i < rows ? a.deg[row0 + i] : 0;
  __syncthreads();
  if (tid < 32) {   // the pairs' row offsets: a warp's prefix sum, RR / 32
                    // consecutive rows a lane
    constexpr int PER = RR / 32;
    int part = 0;
#pragma unroll
    for (int q = 0; q < PER; ++q) part += s_deg[PER * tid + q];
    int incl = part;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += t;
    }
    int off = incl - part;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      s_off[PER * tid + q] = off;
      off += s_deg[PER * tid + q];
    }
    if (tid == 31) s_off[RR] = incl;
  }

  if (!is_max) {
    // T = sum_s relu(w_i + v_j) over the valid slots (mean: / deg), in
    // slot order; four columns a thread where F % 4 == 0
    for (int e = tid; e < RR * (kF / VW); e += tc::THREADS) {
      const int i = e / (kF / VW), c = VW * (e % (kF / VW)), r = row0 + i;
      float t[VW] = {};
      if (i < rows && c < F) {
        float wi[VW];
        load_cols<VW>(wi, a.w, (size_t)r * F + c);
        const int* nb = a.nbr + (size_t)r * a.W;
        const int d = s_deg[i];
        for (int q = 0; q < d; ++q) {
          float x[VW];
          load_cols<VW>(x, a.v, (size_t)nb[q] * F + c);
#pragma unroll
          for (int k = 0; k < VW; ++k)
            t[k] += fmaxf(wi[k] + (BF16 ? bf16r(x[k]) : x[k]), 0.f);
        }
        if (a.aggr == MEAN)
#pragma unroll
          for (int k = 0; k < VW; ++k) t[k] /= fmaxf((float)d, 1.f);
      }
      store_cols<VW, BF16>(T + (size_t)i * L.ldT + c, t);
    }
    ws.stage_prefetched();
    __syncthreads();
    for (int n0 = 0; n0 < Fout; n0 += NC) {
      tc::Acc<MODE, RR> acc;
      tc::zero<MODE, RR>(acc);
      ws.run(acc, T, L.ldT, pass(n0), rows, pass(n0 + NC), n0 + NC < Fout);
      tc::each_pair<RR>([&](int mt, int j, int hh, int r, int cc) {
        if (r >= rows) return;
        const float d = (float)s_deg[r];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = n0 + cc + i;
          if (c >= Fout) break;
          const float y = acc[mt][j][2 * hh + i], b = __ldg(a.b1 + c);
          float o = a.aggr == SUM ? __fadd_rn(y, __fmul_rn(d, b))
                    : d > 0.f     ? __fadd_rn(y, b)
                                  : 0.f;
          const size_t oi = (size_t)(row0 + r) * Fout + c;
          if (a.skip != nullptr) o = __fadd_rn(o, a.skip[oi]);
          a.out[oi] = tc::act(o, a.act);
        }
      });
    }
    return;
  }

  // max: lin1 on the valid (row, slot) pairs, PR a chunk, folded per
  // (row, column) in slot order; this thread's elements are column tid %
  // 128 of rows tid / 128 + 2 q.  The running maximum lives in registers
  // only while a chunk is folded, so it is not live beside the product's
  // accumulators (it spilled there); a CTA of more than PR pairs keeps it
  // in `out` between its chunks.
  __syncthreads();   // s_off
  const int E = s_off[RR];
  const int col = tid % NC, rq = tid / NC;
  constexpr int IQ = 4;   // pairs' loads issued together a thread
  const int items = PR * (kF / VW);
  bool first = true;
  for (int n0 = 0; n0 < Fout; n0 += NC) {
    const bool cok = n0 + col < Fout;
    const float b = cok ? __ldg(a.b1 + n0 + col) : 0.f;
    for (int e0 = 0; e0 < E; e0 += PR) {
      const int ne = min(PR, E - e0);
      if (!first) wm.prefetch(pass(n0));
      for (int i = tid; i < RR; i += tc::THREADS) {   // the pairs' rows
        const int lo = max(s_off[i], e0), hi = min(s_off[i + 1], e0 + PR);
        for (int e = lo; e < hi; ++e) s_crow[e - e0] = i;
      }
      __syncthreads();
      // t of each pair, VW columns an item, IQ items a thread at a time
      for (int f0 = tid; f0 < items; f0 += IQ * tc::THREADS) {
        float wi[IQ][VW], x[IQ][VW];
        bool ok[IQ];
#pragma unroll
        for (int q = 0; q < IQ; ++q) {
          const int f = f0 + q * tc::THREADS;
          const int p = f / (kF / VW), c = VW * (f % (kF / VW));
          ok[q] = f < items && p < ne && c < F;
          if (ok[q]) {
            const int i = s_crow[p], r = row0 + i;
            const int j = a.nbr[(size_t)r * a.W + e0 + p - s_off[i]];
            load_cols<VW>(wi[q], a.w, (size_t)r * F + c);
            load_cols<VW>(x[q], a.v, (size_t)j * F + c);
          }
        }
#pragma unroll
        for (int q = 0; q < IQ; ++q) {
          const int f = f0 + q * tc::THREADS;
          if (f >= items) break;
          const int p = f / (kF / VW), c = VW * (f % (kF / VW));
          float t[VW] = {};
          if (ok[q])
#pragma unroll
            for (int k = 0; k < VW; ++k)
              t[k] = fmaxf(wi[q][k] + (BF16 ? bf16r(x[q][k]) : x[q][k]), 0.f);
          store_cols<VW, BF16>(T + (size_t)p * L.ldT + c, t);
        }
      }
      wm.stage_prefetched();
      first = false;
      __syncthreads();
      {
        tc::Acc<MODE, PR> acc;
        tc::zero<MODE, PR>(acc);
        wm.run(acc, T, L.ldT, pass(n0), ne, pass(n0), false);
        tc::each_pair<PR>([&](int mt, int j, int hh, int r, int cc) {
          *reinterpret_cast<float2*>(Y + (size_t)r * tc::LDY + cc) =
              make_float2(acc[mt][j][2 * hh], acc[mt][j][2 * hh + 1]);
        });
      }
      __syncthreads();
      const bool last = e0 + PR >= E;
      if (cok) {
        // four rows at a time: their earlier maxima or skips loaded together
        constexpr int QG = 4;
        for (int q0 = 0; q0 < RR / 2; q0 += QG) {
          float prev[QG];
#pragma unroll
          for (int g = 0; g < QG; ++g) {
            const int i = rq + 2 * (q0 + g);
            const size_t oi = (size_t)(row0 + i) * Fout + n0 + col;
            prev[g] = i >= rows           ? 0.f
                      : e0 != 0           ? a.out[oi]
                      : last && a.skip    ? a.skip[oi]
                                          : 0.f;
          }
#pragma unroll
          for (int g = 0; g < QG; ++g) {
            const int i = rq + 2 * (q0 + g);
            if (i >= rows) continue;
            const size_t oi = (size_t)(row0 + i) * Fout + n0 + col;
            float mx = e0 == 0 ? -INFINITY : prev[g];
            const int lo = max(s_off[i], e0), hi = min(s_off[i + 1], e0 + PR);
            for (int e = lo; e < hi; ++e)
              mx = fmaxf(mx, Y[(size_t)(e - e0) * tc::LDY + col]);
            if (!last) {
              a.out[oi] = mx;   // this CTA's pairs go on in the next chunk
              continue;
            }
            float o = s_deg[i] > 0 ? __fadd_rn(mx, b) : 0.f;
            if (a.skip != nullptr)
              o = __fadd_rn(o, e0 == 0 ? prev[g] : a.skip[oi]);
            a.out[oi] = tc::act(o, a.act);
          }
        }
      }
      __syncthreads();   // Y is read: the next chunk's t goes over it
    }
    if (E == 0 && cok) {   // no pair: every row's o is 0
      for (int q = 0; q < RR / 2; ++q) {
        const int i = rq + 2 * q;
        if (i >= rows) continue;
        const size_t oi = (size_t)(row0 + i) * Fout + n0 + col;
        a.out[oi] = tc::act(a.skip != nullptr ? a.skip[oi] : 0.f, a.act);
      }
    }
  }
}

int stages_for(int bytes2, int bytes1, size_t optin) {
  return (size_t)bytes2 <= optin ? 2 : (size_t)bytes1 <= optin ? 1 : 0;
}

template <bool BF16>
cudaError_t launch_layer(EdgeArgs a, size_t optin, cudaStream_t st) {
  constexpr int MODE = BF16 ? gnnb_quant::BF16 : gnnb_quant::F32;
  const int pgrid = (a.n_rows + PR - 1) / PR;
  const int sgrid = (a.n_rows + RR - 1) / RR;
  a.stages = stages_for(proj_bytes(a.Fin, MODE, 2),
                        proj_bytes(a.Fin, MODE, 1), optin);
  if (a.stages == 0) return cudaErrorInvalidValue;
  int smem = proj_bytes(a.Fin, MODE, a.stages);
  cudaError_t err = cudaFuncSetAttribute(
      edge_proj_tc_kernel<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  edge_proj_tc_kernel<BF16><<<pgrid, tc::THREADS, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  a.stages = stages_for(slot_layout(a.F, MODE, 2).bytes,
                        slot_layout(a.F, MODE, 1).bytes, optin);
  if (a.stages == 0) return cudaErrorInvalidValue;
  smem = slot_layout(a.F, MODE, a.stages).bytes;
  // 16-byte rows of v and w (the wrapper allocates them) where F % 4 == 0
  auto slot = a.F % 4 == 0 ? edge_slot_tc_kernel<BF16, 4>
                           : edge_slot_tc_kernel<BF16, 1>;
  err = cudaFuncSetAttribute(slot, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  slot<<<sgrid, tc::THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename K>
cudaError_t kernel_info(K kernel, int smem, int* regs, int* smem_bytes,
                        int* ctas) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  *regs = fa.numRegs;
  *smem_bytes = (int)fa.sharedSizeBytes + smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel,
                                                       tc::THREADS, smem);
}

}  // namespace

extern "C" {

// Shared memory of the larger launch with one weight stage (the launcher
// takes two where they fit), in bytes.
int gnnb_edge_block_smem_bytes(int Fin, int F, int mode) {
  const int p = proj_bytes(Fin, mode, 1);
  const int s = slot_layout(F, mode, 1).bytes;
  return p > s ? p : s;
}

// Registers per thread, shared memory per CTA (bytes) and resident CTAs
// per SM of the projection (kernel 0) or slot (kernel 1) launch's
// instance for `mode` (0 f32, 1 bf16) at Fin = F = Fout = 128, on the
// current device.
int gnnb_edge_block_info(int kernel, int mode, int* regs, int* smem_bytes,
                         int* ctas_per_sm) {
  if (mode != gnnb_quant::F32 && mode != gnnb_quant::BF16)
    return (int)cudaErrorInvalidValue;
  const int st = 2;
  if (kernel == 0)
    return (int)(mode ? kernel_info(edge_proj_tc_kernel<true>,
                                    proj_bytes(128, mode, st), regs,
                                    smem_bytes, ctas_per_sm)
                      : kernel_info(edge_proj_tc_kernel<false>,
                                    proj_bytes(128, mode, st), regs,
                                    smem_bytes, ctas_per_sm));
  if (kernel == 1)
    return (int)(mode ? kernel_info(edge_slot_tc_kernel<true, 4>,
                                    slot_layout(128, mode, st).bytes, regs,
                                    smem_bytes, ctas_per_sm)
                      : kernel_info(edge_slot_tc_kernel<false, 4>,
                                    slot_layout(128, mode, st).bytes, regs,
                                    smem_bytes, ctas_per_sm));
  return (int)cudaErrorInvalidValue;
}

// Launches the layer on `stream` of `device`: the projection into the
// scratch v and w [N, F], then the slots.  aggr: 0 max, 1 sum, 2 mean;
// act: 0 none, 1 relu, 2 gelu, 3 sigmoid, 4 tanh; mode: 0 f32, 1 bf16
// (w_pair and w1 bfloat16); skip may be null.  All other arrays
// contiguous f32 / i32 as documented in ops/cuda/edge_block.py.  Returns
// the cudaError_t of the launches (0 = success).
int gnnb_edge_block(const void* x, const void* nbr, const void* deg,
                    int n_rows, int W, int Fin, int F, int Fout,
                    const void* w_pair, const void* b0, const void* w1,
                    const void* b1, const void* skip, int aggr, int act,
                    int mode, void* v, void* w, void* out, void* stream,
                    int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows < 0 || W < 1 || Fin < 1 || F < 1 || Fout < 1 || aggr < MAX ||
      aggr > MEAN || act < 0 || act > 4 || !x || !nbr || !deg || !w_pair ||
      !b0 || !w1 || !b1 || !v || !w || !out ||
      (mode != gnnb_quant::F32 && mode != gnnb_quant::BF16))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  const size_t wsize = mode == gnnb_quant::BF16 ? 2 : 4;
  EdgeArgs a;
  a.x = (const float*)x;
  a.nbr = (const int*)nbr;
  a.deg = (const int*)deg;
  a.w_self = w_pair;
  a.w_diff = (const char*)w_pair + (size_t)Fin * F * wsize;
  a.b0 = (const float*)b0;
  a.w1 = w1;
  a.b1 = (const float*)b1;
  a.skip = (const float*)skip;
  a.v = (float*)v;
  a.w = (float*)w;
  a.out = (float*)out;
  a.n_rows = n_rows;
  a.W = W;
  a.Fin = Fin;
  a.F = F;
  a.Fout = Fout;
  a.aggr = aggr;
  a.act = act;
  a.stages = 0;
  a.xvec = Fin % 4 == 0 && (uintptr_t)x % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == gnnb_quant::BF16)
    return (int)launch_layer<true>(a, (size_t)optin, st);
  return (int)launch_layer<false>(a, (size_t)optin, st);
}

}  // extern "C"
