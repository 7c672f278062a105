// One GIN, SAGE, GCN, LG or Simple conv layer: the neighbour sum s of v
// and the conv's epilogue in one kernel, aggregating over the ELL table
// or over the block adjacency.
//
// Replaces: gnnbuilder_tpu/ops/pallas/mp_layer.py fused_mp_layer (kernel
// bodies _kernel, the ELL mode, and _block_kernel, the block mode, which
// share the epilogue _mp_epilogue).  For every row r:
//
//   s[r] = sum_{w < deg[r]} v[nbr[r, w]]     (ELL mode, in slot order)
//   s[r] = sum_j A[t][r, j] v[t*128 + j]      (block mode, r in block t)
//
//   gin          o = relu(((1 + eps) v + s) W0 + b0) W1 + b1
//   sage         o = (s / max(deg, 1)) W0 + b0 + v W1
//   gcn          o = rsqrt(deg + 1) (s + v) + b0      (the caller passes
//                    v = lin(x) rsqrt(deg + 1))
//   lg           o = (deg > 0 ? rsqrt(max(deg, 1)) : 0) s   (the caller
//                    pre-scales v by the same factor)
//   simple_sum   o = s
//   simple_mean  o = s / max(deg, 1)
//
//   out = act(o [+ skip])            (skip added before the activation)
//
// and, with save_s, s itself as a second output: the backward's residual.
// The aggregation mode (ELL or block) is a template argument; both run the
// same epilogue code.
//
// Modes (a template argument, as pna_layer.cu's MODE), the JAX kernel's
// gather_mode / mm / quant; each writes s with save_s (the sum as the mode
// forms it, the JAX kernel's residual in that mode), a store that leaves
// out's bits as they are without it:
//   BF16 (1): each gathered v is rounded to bf16 before the sum, which
//        stays float32; gin's and sage's products take bf16-rounded
//        operands ((1 + eps) v + s, the mean, v, Z) and bf16 weights.
//   INT8 (2), gin and sage only: every epilogue product quantizes its
//        operand rows (one scale per row, quant.cuh's formulas) against
//        int8 weights with per-column scales, an exact int32 sum times
//        s_row * s_col: _qdot; the aggregation stays exact.  sage's
//        order is (qdot(mean, W0) + b0) + qdot(v, W1), as in JAX.
//
// What bounds it on the H100: bytes for gcn, lg and simple (a few
// operations per element against v, the table, skip, out and s moved
// once); for gin and sage at width 128 the products' 2 F H + 2 H Fout (or
// 4 F Fout) flops a row take ~7 us at the TF32 tensor-core rate on the
// train batch (three passes), under the ~10 us its v, s, skip and out
// take at the memory rate: bytes, once the products run on the tensor
// cores.
//
// Design.  The TPU kernel's count-matrix one-hot products, hi/lo bf16
// passes and window DMAs existed because Mosaic has no dynamic row
// gather; here an indexed load is exact.  In block mode a CTA first
// compacts its adjacency rows into per-row (neighbour, count) lists in
// shared memory (block_lists.cuh, shared with mp_block.cu); in ELL mode
// it reads the table's slots with indexed loads.
// * gcn, lg, simple (mp_layer_ew_kernel or _ew3_kernel, _ew_block_kernel),
//   for bytes in flight as the gather backward and the multi-aggregate: a
//   lane group a row with float4 columns (F % 4 == 0), the row's slot ids
//   loaded once beside its own operands and shared by __shfl_sync, four
//   slots' v rows loaded before their adds (block mode: four list
//   entries' rows), the conv and the activation template arguments,
//   streaming stores of out and s.  The sums run in slot (list) order
//   from +0 and the epilogue is the parent's, so out and s keep the
//   parent kernel's bits (mp_layer_ew_ordered in ops/cuda/mp_layer.py
//   forms the same sums in torch).
// * gin, sage (mp_layer_tc_kernel): a CTA owns 128 rows (64 where 128 do
//   not fit shared memory: hidden 384; and BF16 gin, below): the train
//   batch's 18,688 rows are 146 CTAs, one round at two CTAs an SM.  Their
//   T ((1 + eps) v + s, or the mean) is formed in shared memory (four
//   columns an item and four items a thread at a time where F % 4 == 0,
//   the adds in slot order), then the products run on the tensor cores
//   through tc_rows.cuh: the caller's row-major weights streamed by
//   k-chunks into shared memory (TF32 halves split once per CTA), the
//   first chunk's loads in flight during the gather.  gin's Z = relu(T W0
//   + b0) goes over T where one column tile of W0 makes T dead by then (H
//   <= 128, and always in INT8, whose products read T's levels), else to
//   U; sage's v rows go over T once T W0 has read T (one column tile),
//   else to U, and its two products chain into one accumulator (f32,
//   bf16).  INT8 quantizes T, v's rows and Z once each.  In BF16, gin's
//   T W0 runs on the float64 tensor cores instead (gin_z_f64): Z is
//   rounded to bf16 next, and only a correctly rounded product rounds as
//   the plain version's does.  The epilogues issue their skip and bias
//   loads in groups.
//
// No float is added atomically and no sum depends on the schedule: every
// launch gives the same bits.

#include <cuda_runtime.h>
#include <math.h>

#include "block_lists.cuh"
#include "dense_rows.cuh"
#include "tc_rows.cuh"

namespace {

namespace tc = gnnb_tc;
using namespace gnnb_dense;
static_assert(THREADS == tc::THREADS, "both kernels' CTAs");
using gnnb_quant::bf16r;
using gnnb_quant::BF16;
using gnnb_quant::F32;
using gnnb_quant::INT8;

constexpr int BB = gnnb::LIST_COLS;   // rows of an adjacency block
constexpr int EW_R = 32;              // rows per CTA, elementwise block mode

enum Conv { GIN = 0, SAGE = 1, GCN = 2, LG = 3, SIMPLE_SUM = 4,
            SIMPLE_MEAN = 5 };

struct LayerArgs {
  const float* v;      // [N, F]
  const int* nbr;      // [N, W] (ELL mode)
  const float* adj;    // [N / 128, 128, 128] counts (block mode)
  const int* deg;      // [N]
  const void* w0;      // [F, H] gin, [F, Fout] sage (the mode's type)
  const float* b0;     // [H] gin, [Fout] sage, [F] gcn
  const void* w1;      // [H, Fout] gin, [F, Fout] sage
  const float* b1;     // [Fout] gin
  const float* sw0;    // [H] / [Fout] column scales of w0 (INT8)
  const float* sw1;    // [Fout] column scales of w1 (INT8)
  const float* skip;   // [N, Fout] or null
  float* out;          // [N, Fout]
  float* s;            // [N, F] or null (save_s)
  int n_rows, W, F, H, Fout, conv, act;
  float eps;
  int stages;          // weight stages in shared memory (gin, sage)
  bool vec;            // F % 4 == 0 and v, s 16-byte aligned
  int gs;              // lanes a row (gcn, lg, simple)
};

// s of global row r (row i of the CTA, in-degree d) at column c: over the
// ELL slots in slot order, or over the row's block list, vb being v at
// the block's first row; each v rounded to bf16 in the BF16 mode.
template <bool BLOCK, int MODE>
__device__ __forceinline__ float neighbour_sum(const LayerArgs& a, int r,
                                               int i, int d, const int* ent,
                                               const int* ptr,
                                               const float* vb, int c) {
  if (BLOCK)
    return gnnb::agg_row<MODE == BF16>(ent, ptr[i], ptr[i + 1], vb, a.F, c);
  const int* nb = a.nbr + (size_t)r * a.W;
  float s = 0.f;
  for (int w = 0; w < d; ++w) {
    const float x = a.v[(size_t)nb[w] * a.F + c];
    s += MODE == BF16 ? bf16r(x) : x;
  }
  return s;
}

// In-degrees of the CTA's R rows into s_deg and, in block mode, their
// adjacency lists; ends with a barrier.
template <int R, bool BLOCK>
__device__ __forceinline__ void load_rows(const LayerArgs& a, int row0,
                                          int* s_deg, int* s_cnt,
                                          int* s_ptr, int* s_ent) {
  for (int i = threadIdx.x; i < R; i += THREADS)
    s_deg[i] = row0 + i < a.n_rows ? a.deg[row0 + i] : 0;
  if (BLOCK)
    gnnb::compact_rows<THREADS>(a.adj + (size_t)row0 * BB, R, s_cnt, s_ptr,
                                s_ent);
  else
    __syncthreads();
}

// ---------------------------------------------------------------------------
// gcn, lg, simple_sum, simple_mean (F32 or BF16: these convs run no
// product to quantize).  A group of GS lanes owns a row (GS = the row's
// float4 chunks, or columns, rounded up to a power of two, at least
// EW_U and at most 32: a warp a row at F = 128, two at 64, eight where
// four lanes cover F), each lane V columns; the conv and the activation
// are template arguments, index math 32-bit (N * F and N * W < 2^31,
// checked at the entry), out and s streaming stores.

constexpr int EW_U = 4;               // slots' loads in flight a lane
// The ELL instances built for three CTAs an SM (mp_layer_ew3_kernel): f32
// lg and simple spilled at the compiler's own 64-register choice (~25 %
// slower); the rest run fastest at their own choice (gcn f32 80
// registers, the bf16 ones 64), slower when held to three CTAs an SM
__host__ __device__ constexpr bool ew_three(int mode, int conv) {
  return mode == F32 && conv != GCN;
}
constexpr unsigned FULL = 0xffffffffu;
enum EwAct { EW_RELU = 0, EW_ANY = 1 };   // EW_ANY: act at run time

template <int V> struct Cols { float c[V]; };

// V floats at p: gathered rows read-only without L1 allocation (a
// sender's row is read by its few receivers, rarely from one SM),
// streamed (read once) for skip, cached for b0
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
__device__ __forceinline__ Cols<4> ld_cs(const float* p, Cols<4>*) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  return {{q.x, q.y, q.z, q.w}};
}
__device__ __forceinline__ Cols<1> ld_cs(const float* p, Cols<1>*) {
  return {{__ldcs(p)}};
}
__device__ __forceinline__ Cols<4> ld_b(const float* p, Cols<4>*) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  return {{q.x, q.y, q.z, q.w}};
}
__device__ __forceinline__ Cols<1> ld_b(const float* p, Cols<1>*) {
  return {{__ldg(p)}};
}
template <int V> __device__ __forceinline__ Cols<V>* tag() { return nullptr; }
__device__ __forceinline__ void st_cs(float* p, Cols<4> v) {
  __stcs(reinterpret_cast<float4*>(p),
         make_float4(v.c[0], v.c[1], v.c[2], v.c[3]));
}
__device__ __forceinline__ void st_cs(float* p, Cols<1> v) {
  __stcs(p, v.c[0]);
}

// a row's own operands at column c: v[r] (gcn), skip[r], b0 (gcn)
template <int CONV, int V> struct Own {
  Cols<V> v, skip, b;
  __device__ __forceinline__ void load(const LayerArgs& a, int r, int c) {
#pragma unroll
    for (int k = 0; k < V; ++k) v.c[k] = skip.c[k] = b.c[k] = 0.f;
    if (CONV == GCN) {
      v = ld_nc(a.v + r * a.F + c, tag<V>());
      b = ld_b(a.b0 + c, tag<V>());
    }
    if (a.skip != nullptr) skip = ld_cs(a.skip + r * a.F + c, tag<V>());
  }
};

// the row's scale: gcn 1 / sqrt(d + 1), lg 1 / sqrt(max(d, 1)) (0 at
// d = 0), IEEE square root and division as the parent formed them
template <int CONV>
__device__ __forceinline__ float row_scale(int d) {
  const float df = (float)d;
  if (CONV == GCN) return 1.f / sqrtf(df + 1.f);
  if (CONV == LG) return d > 0 ? 1.f / sqrtf(fmaxf(df, 1.f)) : 0.f;
  return 0.f;
}

// The epilogue of one lane's V elements of row r and its stores: the
// parent's operations in the parent's order (gcn's scale times (s + v)
// plus b0 a fused multiply-add, as the parent compiled it; the skip
// added before the activation).
template <int CONV, int ACT, int V>
__device__ __forceinline__ void ew_store(const LayerArgs& a, int r, int c,
                                         int d, float rs, Cols<V> s,
                                         Own<CONV, V> own) {
  Cols<V> o;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float x;
    if (CONV == GCN)
      x = fmaf(rs, __fadd_rn(s.c[k], own.v.c[k]), own.b.c[k]);
    else if (CONV == LG)
      x = __fmul_rn(rs, s.c[k]);
    else if (CONV == SIMPLE_MEAN)
      x = s.c[k] / fmaxf((float)d, 1.f);
    else
      x = s.c[k];
    if (a.skip != nullptr) x = __fadd_rn(x, own.skip.c[k]);
    o.c[k] = ACT == EW_RELU ? fmaxf(x, 0.f) : act_fn(x, a.act);
  }
  const int idx = r * a.F + c;
  if (a.s != nullptr) st_cs(a.s + idx, s);
  st_cs(a.out + idx, o);
}

// ELL mode: lane 0 of the group loads r's degree and lane l slot l's
// sender id, beside the row's own operands (one round), the group reads
// the ids by __shfl_sync, and EW_U slots' v rows are loaded before
// their adds, which run in slot order from +0 (each v rounded to bf16
// first in BF16): the parent's sums, bit for bit.  The grid is the
// instance's occupancy on every SM, each warp striding over row groups.
template <int MODE, int CONV, int ACT, int V>
__device__ __forceinline__ void ew_rows(const LayerArgs& a) {
  const int F = a.F, W = a.W, GS = a.gs, RPW = 32 / GS;
  const int lane = threadIdx.x & 31, gl = lane % GS, sub = lane / GS;
  const int stride = gridDim.x * (THREADS / 32) * RPW;
  for (int r0 = (blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5)) * RPW;
       r0 < a.n_rows; r0 += stride) {
    const int r = r0 + sub;
    const bool rok = r < a.n_rows;
    int d = 0, first = 0;
    Own<CONV, V> own0;
    if (rok) {
      if (gl == 0) d = __ldg(a.deg + r);
      if (gl < W) first = __ldg(a.nbr + r * W + gl);
      if (V * gl < F) own0.load(a, r, V * gl);
    }
    d = __shfl_sync(FULL, d, 0, GS);
    int most = d;   // the warp's longest row: its groups loop together
    for (int o = 16; o > 0; o >>= 1)
      most = max(most, __shfl_xor_sync(FULL, most, o));
    const float rs = row_scale<CONV>(d);
    const int* nb = a.nbr + (rok ? r : 0) * W;
    for (int c0 = 0; c0 < F; c0 += GS * V) {
      const int c = c0 + V * gl;
      const bool cok = rok && c < F;
      Own<CONV, V> own = own0;
      if (c0 > 0 && cok) own.load(a, r, c);
      Cols<V> s;
#pragma unroll
      for (int k = 0; k < V; ++k) s.c[k] = 0.f;
      for (int wb = 0; wb < most; wb += GS) {
        const int mine = wb == 0 ? first
                         : rok && wb + gl < d ? __ldg(nb + wb + gl) : 0;
        const int m = min(GS, most - wb);
        for (int w = 0; w < m; w += EW_U) {
          Cols<V> g[EW_U];
#pragma unroll
          for (int uu = 0; uu < EW_U; ++uu) {
            const int i = __shfl_sync(FULL, mine, w + uu, GS);
            if (cok && wb + w + uu < d)
              g[uu] = ld_nc(a.v + i * F + c, tag<V>());
          }
#pragma unroll
          for (int uu = 0; uu < EW_U; ++uu) {
            if (!cok || wb + w + uu >= d) continue;
#pragma unroll
            for (int k = 0; k < V; ++k)
              s.c[k] += MODE == BF16 ? bf16r(g[uu].c[k]) : g[uu].c[k];
          }
        }
      }
      if (cok) ew_store<CONV, ACT, V>(a, r, c, d, rs, s, own);
    }
  }
}

template <int MODE, int CONV, int ACT, int V>
__global__ void __launch_bounds__(THREADS) mp_layer_ew_kernel(LayerArgs a) {
  ew_rows<MODE, CONV, ACT, V>(a);
}
template <int MODE, int CONV, int ACT, int V>
__global__ void __launch_bounds__(THREADS, 3)
mp_layer_ew3_kernel(LayerArgs a) {
  ew_rows<MODE, CONV, ACT, V>(a);
}

// the ELL kernel of an instance (only that one is instantiated)
using EwKernel = void (*)(LayerArgs);
template <int MODE, int CONV, int ACT, int V>
EwKernel ew_kernel() {
  if constexpr (ew_three(MODE, CONV))
    return mp_layer_ew3_kernel<MODE, CONV, ACT, V>;
  else
    return mp_layer_ew_kernel<MODE, CONV, ACT, V>;
}

// Block mode: the CTA's EW_R rows' adjacency lists compacted in shared
// memory (block_lists.cuh, as the parent), then the same lane groups, each
// loading EW_U entries' v rows before their multiply-adds, in list order
// from +0 (agg_row's fmaf(count, v, s)).
template <int MODE, int CONV, int ACT, int V>
__global__ void __launch_bounds__(THREADS)
mp_layer_ew_block_kernel(LayerArgs a) {
  __shared__ int s_deg[EW_R], s_cnt[EW_R], s_ptr[EW_R + 1];
  __shared__ int s_ent[EW_R * BB];
  const int F = a.F, GS = a.gs, RPW = 32 / GS;
  const int lane = threadIdx.x & 31, gl = lane % GS;
  const int row0 = blockIdx.x * EW_R;
  // the group's first row's own operands, beside the adjacency reads
  const int i0 = (threadIdx.x >> 5) * RPW + lane / GS;
  Own<CONV, V> own0;
  if (i0 < EW_R && row0 + i0 < a.n_rows && V * gl < F)
    own0.load(a, row0 + i0, V * gl);
  load_rows<EW_R, true>(a, row0, s_deg, s_cnt, s_ptr, s_ent);
  const float* vb = a.v + (row0 / BB) * BB * F;
  for (int i = i0; i < EW_R; i += (THREADS / 32) * RPW) {
    const int r = row0 + i;
    if (r >= a.n_rows) break;
    const int d = s_deg[i], e0 = s_ptr[i], e1 = s_ptr[i + 1];
    const float rs = row_scale<CONV>(d);
    for (int c = V * gl; c < F; c += GS * V) {
      Own<CONV, V> own = own0;
      if (i != i0 || c != V * gl) own.load(a, r, c);
      Cols<V> s;
#pragma unroll
      for (int k = 0; k < V; ++k) s.c[k] = 0.f;
      for (int e = e0; e < e1; e += EW_U) {
        Cols<V> g[EW_U];
        float cnt[EW_U];
#pragma unroll
        for (int uu = 0; uu < EW_U; ++uu) {
          if (e + uu >= e1) continue;
          const int p = s_ent[e + uu];
          cnt[uu] = (float)(p >> 8);
          g[uu] = ld_nc(vb + (p & 0xFF) * F + c, tag<V>());
        }
#pragma unroll
        for (int uu = 0; uu < EW_U; ++uu) {
          if (e + uu >= e1) continue;
#pragma unroll
          for (int k = 0; k < V; ++k)
            s.c[k] = fmaf(cnt[uu],
                          MODE == BF16 ? bf16r(g[uu].c[k]) : g[uu].c[k],
                          s.c[k]);
        }
      }
      ew_store<CONV, ACT, V>(a, r, c, d, rs, s, own);
    }
  }
}

__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

// Byte offsets of a gin (H > 0) or sage (H = 0) launch's shared memory:
// the weight stages at 0, T (gin's Z over it where z_over_t, sage's v rows
// where u_over_t), U (sage's v rows, gin's Z otherwise) with the block
// mode's adjacency lists over it (they are read only while T is formed),
// the int8 levels QT (T's, then Z's) and QU (sage's v), INT8 sage's first
// product YS (over T where T is as wide), the row scales and the degrees.
struct MMLayout {
  int ldT, ldZ, ldqT, ldqZ, T, U, QT, QU, YS, SQ, DEG, CNT, PTR, ENT, bytes;
  bool z_over_t, u_over_t, qu_sep;
};

// Fout <= 128 (one column tile): sage's v rows go over T once the T W0
// product has read T (in INT8 their levels over T's), and gin's Z likewise
// where H <= 128; R rows a CTA
__host__ __device__ inline MMLayout mm_layout(int F, int H, int Fout,
                                              bool block, int mode,
                                              int stages, int R) {
  MMLayout L;
  const bool gin = H > 0;
  L.ldT = tc::lda_of(F, mode);
  L.ldZ = gin ? tc::lda_of(H, mode) : 0;
  L.ldqT = tc::ldq_of(F);
  L.ldqZ = gin ? tc::ldq_of(H) : 0;
  L.z_over_t = gin && (mode == INT8 || H <= tc::NC);
  L.u_over_t = !gin && (mode == INT8 || Fout <= tc::NC);
  L.qu_sep = mode == INT8 && !gin && Fout > tc::NC;
  L.T = stages * tc::chunk_bytes(mode);
  const int t_floats = L.z_over_t ? imax(L.ldT, L.ldZ) : L.ldT;
  L.U = tc::align16(L.T + R * t_floats * 4);
  const int u_floats = gin ? (L.z_over_t ? 0 : L.ldZ)
                           : (L.u_over_t ? 0 : L.ldT);
  L.ENT = L.U;
  L.QT = tc::align16(L.U + imax(R * u_floats * 4, block ? R * BB * 4 : 0));
  const bool q = mode == INT8;
  L.QU = tc::align16(L.QT + (q ? R * imax(L.ldqT, L.ldqZ) : 0));
  // INT8 sage's qdot(T, W0) + b0 (a [R, 128] tile) while qdot(v, W1)
  // runs: over T's floats, dead once v's levels are made, where they are
  // as wide
  const bool ys = q && !gin;
  const bool ys_sep = ys && L.ldT < tc::LDY;
  L.YS = ys_sep ? tc::align16(L.QU + (L.qu_sep ? R * L.ldqT : 0)) : L.T;
  L.SQ = tc::align16(ys_sep ? L.YS + R * tc::LDY * 4
                            : L.QU + (L.qu_sep ? R * L.ldqT : 0));
  L.DEG = L.SQ + (q ? 2 * R * 4 : 0);
  L.CNT = L.DEG + R * 4;
  L.PTR = L.CNT + (block ? R * 4 : 0);
  L.bytes = L.PTR + (block ? (R + 1) * 4 : 0);
  return L;
}

// T[i, :] (and U[i, :] = v[r] with `with_u`) of the CTA's rows, zero past
// `rows` and in the pad columns up to kp; s to a.s with save_s.  gin's T is
// (1 + eps) x + s rounded twice, as the plain version forms it (a fused
// multiply-add moves an ulp, and an ulp before a bf16 rounding or an int8
// quantization moves a value); sage's the IEEE quotient s / max(d, 1).
// ELL rows with a.vec take four columns an item and four items a thread
// at a time; the adds stay in slot order.
template <bool BLOCK, int MODE, int R>
__device__ __forceinline__ void form_rows(const LayerArgs& a, int row0,
                                          int rows, const int* s_deg,
                                          const int* s_ptr, const int* s_ent,
                                          float* T, float* U, int ldT,
                                          int kp, bool with_u) {
  constexpr bool RND = MODE == BF16;
  const int F = a.F;
  const bool gin = a.conv == GIN;
  const float ope = 1.f + a.eps;
  auto fin = [&](float x, float s, int d) {
    const float t =
        gin ? __fadd_rn(__fmul_rn(ope, x), s) : s / fmaxf((float)d, 1.f);
    return RND ? bf16r(t) : t;
  };
  if (!BLOCK && a.vec) {
    // four items (row, 4 columns) a thread at a time: their slots' loads
    // issued together (one item's chain of dependent loads at a time left
    // the gather latency-bound at 16 warps an SM); each item's adds stay
    // in slot order
    const float4* v4 = reinterpret_cast<const float4*>(a.v);
    const int F4 = F / 4, K4 = kp / 4;
    constexpr int IQ = 4;
    for (int e0 = threadIdx.x; e0 < R * K4; e0 += IQ * tc::THREADS) {
      int d[IQ], i_[IQ], c4[IQ], most = 0;
      const int* nb[IQ];
      float4 s[IQ];
#pragma unroll
      for (int q = 0; q < IQ; ++q) {
        const int e = e0 + q * tc::THREADS;
        i_[q] = e / K4;
        c4[q] = e % K4;
        const bool ok = e < R * K4 && i_[q] < rows && c4[q] < F4;
        d[q] = ok ? s_deg[i_[q]] : 0;
        nb[q] = a.nbr + (size_t)(row0 + (ok ? i_[q] : 0)) * a.W;
        s[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        most = max(most, d[q]);
      }
      for (int w = 0; w < most; ++w) {
        int j[IQ];
#pragma unroll
        for (int q = 0; q < IQ; ++q) j[q] = w < d[q] ? nb[q][w] : -1;
        float4 y[IQ];
#pragma unroll
        for (int q = 0; q < IQ; ++q)
          if (j[q] >= 0) y[q] = __ldg(v4 + (size_t)j[q] * F4 + c4[q]);
#pragma unroll
        for (int q = 0; q < IQ; ++q) {
          if (j[q] < 0) continue;
          float4 x = y[q];
          if (RND) {
            x.x = bf16r(x.x);
            x.y = bf16r(x.y);
            x.z = bf16r(x.z);
            x.w = bf16r(x.w);
          }
          s[q].x += x.x;
          s[q].y += x.y;
          s[q].z += x.z;
          s[q].w += x.w;
        }
      }
#pragma unroll
      for (int q = 0; q < IQ; ++q) {
        const int e = e0 + q * tc::THREADS;
        if (e >= R * K4) break;
        const int i = i_[q], r = row0 + i;
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f), x = t;
        if (i < rows && c4[q] < F4) {
          if (a.s != nullptr)
            reinterpret_cast<float4*>(a.s)[(size_t)r * F4 + c4[q]] = s[q];
          x = __ldg(v4 + (size_t)r * F4 + c4[q]);
          const int dq = d[q];
          t = make_float4(fin(x.x, s[q].x, dq), fin(x.y, s[q].y, dq),
                          fin(x.z, s[q].z, dq), fin(x.w, s[q].w, dq));
          if (RND) {
            x.x = bf16r(x.x);
            x.y = bf16r(x.y);
            x.z = bf16r(x.z);
            x.w = bf16r(x.w);
          }
        }
        *reinterpret_cast<float4*>(T + (size_t)i * ldT + 4 * c4[q]) = t;
        if (with_u)
          *reinterpret_cast<float4*>(U + (size_t)i * ldT + 4 * c4[q]) = x;
      }
    }
    return;
  }
  const float* vb = a.v + (size_t)(row0 / BB) * BB * F;
  for (int e = threadIdx.x; e < R * kp; e += tc::THREADS) {
    const int i = e / kp, c = e % kp, r = row0 + i;
    float t = 0.f, x = 0.f;
    if (i < rows && c < F) {
      const int d = s_deg[i];
      const float s =
          neighbour_sum<BLOCK, MODE>(a, r, i, d, s_ent, s_ptr, vb, c);
      if (a.s != nullptr) a.s[(size_t)r * F + c] = s;
      x = a.v[(size_t)r * F + c];
      t = fin(x, s, d);
    }
    T[(size_t)i * ldT + c] = t;
    if (with_u) U[(size_t)i * ldT + c] = RND ? bf16r(x) : x;
  }
}

// gin and sage on the tensor cores (header, tc_rows.cuh), R rows a CTA.
template <int MODE, bool BLOCK, int R>
__global__ void __launch_bounds__(tc::THREADS, 2)
mp_layer_tc_kernel(LayerArgs a) {
  constexpr bool RND = MODE == BF16;
  constexpr int NC = tc::NC;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool gin = a.conv == GIN;
  const int F = a.F, H = a.H, Fout = a.Fout;
  const MMLayout L = mm_layout(F, gin ? H : 0, Fout, BLOCK, MODE, a.stages, R);
  float* T = reinterpret_cast<float*>(smem + L.T);
  float* U = reinterpret_cast<float*>(smem + L.U);
  int8_t* QT = reinterpret_cast<int8_t*>(smem + L.QT);
  int8_t* QU = reinterpret_cast<int8_t*>(smem + L.QU);
  float* sT = reinterpret_cast<float*>(smem + L.SQ);
  float* sU = sT + R;
  int* s_deg = reinterpret_cast<int*>(smem + L.DEG);
  int* s_cnt = reinterpret_cast<int*>(smem + L.CNT);
  int* s_ptr = reinterpret_cast<int*>(smem + L.PTR);
  int* s_ent = reinterpret_cast<int*>(smem + L.ENT);
  const int row0 = blockIdx.x * R;
  const int rows = min(R, a.n_rows - row0);
  const int kF = tc::kpad(F, MODE);

  auto pass0 = [&](int n0) {   // W0: [F, H] gin, [F, Fout] sage
    tc::Pass p;
    p.w = a.w0;
    p.ldw = p.N = gin ? H : Fout;
    p.K = F;
    p.n0 = n0;
    return p;
  };
  auto pass1 = [&](int n0) {   // W1: [H, Fout] gin, [F, Fout] sage
    tc::Pass p;
    p.w = a.w1;
    p.ldw = p.N = Fout;
    p.K = gin ? H : F;
    p.n0 = n0;
    return p;
  };
  // v's rows (rounded to bf16 in BF16) into dst, zero past rows and F;
  // four columns a thread where a.vec (one at a time it took 12 us a CTA)
  auto load_v = [&](float* dst) {
    if (a.vec) {
      const int F4 = F / 4, K4 = kF / 4;
      const float4* v4 = reinterpret_cast<const float4*>(a.v);
      for (int e = threadIdx.x; e < R * K4; e += tc::THREADS) {
        const int i = e / K4, c4 = e % K4;
        float4 x = i < rows && c4 < F4
                       ? __ldg(v4 + (size_t)(row0 + i) * F4 + c4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        if (RND) x = make_float4(bf16r(x.x), bf16r(x.y), bf16r(x.z),
                                 bf16r(x.w));
        *reinterpret_cast<float4*>(dst + (size_t)i * L.ldT + 4 * c4) = x;
      }
      return;
    }
    for (int e = threadIdx.x; e < R * kF; e += tc::THREADS) {
      const int i = e / kF, c = e % kF;
      const float x =
          i < rows && c < F ? a.v[(size_t)(row0 + i) * F + c] : 0.f;
      dst[(size_t)i * L.ldT + c] = RND ? bf16r(x) : x;
    }
  };
  // BF16 gin forms Z on the float64 tensor cores (tc::gin_z_f64)
  constexpr bool Z64 = MODE == BF16;
  tc::Stream<MODE, R> ws{smem, a.stages, 0};
  ws.prefetch(pass0(0));
  load_rows<R, BLOCK>(a, row0, s_deg, s_cnt, s_ptr, s_ent);
  const bool sep_u = !gin && !L.u_over_t;   // sage's v rows in U
  form_rows<BLOCK, MODE, R>(a, row0, rows, s_deg, s_ptr, s_ent, T, U, L.ldT,
                         kF, !BLOCK && sep_u);
  ws.stage_prefetched();
  __syncthreads();
  if (BLOCK && sep_u) {   // U over the lists, now unread
    load_v(U);
    __syncthreads();
  }
  if constexpr (MODE == INT8) {
    tc::quantize_rows<R>(T, L.ldT, kF, QT, L.ldqT, sT);
    if (L.qu_sep) {   // v's rows over T, once T's levels are made
      __syncthreads();
      load_v(T);
      __syncthreads();
      tc::quantize_rows<R>(T, L.ldT, kF, QU, L.ldqT, sU);
    }
    __syncthreads();
  }

  if (gin) {
    // Z = relu(T W0 + b0), zero in Z's pad columns
    const void* A = MODE == INT8 ? static_cast<const void*>(QT) : T;
    const int lda = MODE == INT8 ? L.ldqT : L.ldT;
    float* Z = L.z_over_t ? T : U;
    const int kH = tc::kpad(H, MODE);
    if constexpr (Z64 && R == 64) {
      for (int n0 = 0; n0 < H; n0 += NC) {
        float z[4][4][2];
        tc::gin_z_f64(ws, T, L.ldT, pass0(n0), n0 + NC < H ? pass0(n0 + NC)
                                                       : pass1(0), z);
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        const int wr = warp % 2, wc = warp / 2;
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int r = 32 * wr + 8 * m + (lane >> 2);
              const int c = n0 + 32 * wc + 8 * j + 2 * (lane & 3) + i;
              if (c >= kH) continue;
              const float zz =
                  c < H ? fmaxf(__fadd_rn(z[m][j][i], __ldg(a.b0 + c)), 0.f)
                        : 0.f;
              Z[(size_t)r * L.ldZ + c] = bf16r(zz);
            }
      }
    } else if constexpr (Z64) {
      __trap();   // the launcher runs BF16 gin at 64 rows a CTA
    }
    for (int n0 = 0; n0 < H && !Z64; n0 += NC) {
      tc::Acc<MODE, R> acc;
      tc::zero<MODE, R>(acc);
      ws.run(acc, A, lda, pass0(n0), rows,
             n0 + NC < H ? pass0(n0 + NC) : pass1(0), true);
      // this thread's columns' biases (and INT8 column scales) first
      constexpr int NT = tc::Geo<R>::NT;
      const int cb = n0 + 8 * NT * ((threadIdx.x >> 5) / tc::Geo<R>::WR) +
                     2 * (threadIdx.x & 3);
      float bz[NT][2], sz[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = cb + 8 * j + i;
          bz[j][i] = c < H ? __ldg(a.b0 + c) : 0.f;
          sz[j][i] = MODE == INT8 && c < H ? __ldg(a.sw0 + c) : 0.f;
        }
      tc::each_pair<R>([&](int mt, int j, int hh, int r, int cc) {
        const float sr = MODE == INT8 ? sT[r] : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = n0 + cc + i;
          if (c >= kH) continue;
          const float y =
              MODE == INT8
                  ? __fmul_rn(__fmul_rn((float)acc[mt][j][2 * hh + i], sr),
                              sz[j][i])
                  : (float)acc[mt][j][2 * hh + i];
          const float z = c < H ? fmaxf(__fadd_rn(y, bz[j][i]), 0.f) : 0.f;
          Z[(size_t)r * L.ldZ + c] = RND ? bf16r(z) : z;
        }
      });
    }
    __syncthreads();
    if constexpr (MODE == INT8) {   // QT is free: Z's levels
      tc::quantize_rows<R>(Z, L.ldZ, kH, QT, L.ldqZ, sT);
      __syncthreads();
    }
    const void* A2 = MODE == INT8 ? static_cast<const void*>(QT) : Z;
    const int lda2 = MODE == INT8 ? L.ldqZ : L.ldZ;
    for (int n0 = 0; n0 < Fout; n0 += NC) {   // o = Z W1 + b1
      tc::Acc<MODE, R> acc;
      tc::zero<MODE, R>(acc);
      ws.run(acc, A2, lda2, pass1(n0), rows, pass1(n0 + NC),
             n0 + NC < Fout);
      tc::store_out<R>(a, row0, rows, n0, [&](int mt, int j, int k, int r, int c) {
        const float sr = MODE == INT8 ? sT[r] : 0.f;
        return __fadd_rn(tc::value<MODE>(acc[mt][j][k], sr, a.sw1, c),
                         __ldg(a.b1 + c));
      });
    }
    return;
  }

  // sage: o = T W0 + U W1 + b0, or in INT8 (qdot(T, W0) + b0) + qdot(U, W1)
  for (int n0 = 0; n0 < Fout; n0 += NC) {
    const bool more = n0 + NC < Fout;
    tc::Acc<MODE, R> acc;
    tc::zero<MODE, R>(acc);
    if constexpr (MODE != INT8) {
      ws.run(acc, T, L.ldT, pass0(n0), rows, pass1(n0), true);
      if (L.u_over_t) {   // one column tile: T is read, v's rows over it
        load_v(T);
        __syncthreads();
      }
      ws.run(acc, L.u_over_t ? T : U, L.ldT, pass1(n0), rows,
             pass0(n0 + NC), more);
      tc::store_out<R>(a, row0, rows, n0, [&](int mt, int j, int k, int, int c) {
        return __fadd_rn(acc[mt][j][k], __ldg(a.b0 + c));
      });
    } else {
      ws.run(acc, QT, L.ldqT, pass0(n0), rows, pass1(n0), true);
      // y = qdot(T, W0) + b0, kept in shared memory (YS) while qdot(v,
      // W1) runs: in registers beside its accumulators it spilled
      float* Y = reinterpret_cast<float*>(smem + L.YS);
      float y[tc::MT][tc::Geo<R>::NT][4];
      tc::each_pair<R>([&](int mt, int j, int hh, int r, int cc) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = n0 + cc + i, k = 2 * hh + i;
          y[mt][j][k] = c < Fout ? __fadd_rn(tc::value<MODE>(acc[mt][j][k],
                                                             sT[r], a.sw0, c),
                                             __ldg(a.b0 + c))
                                 : 0.f;
        }
      });
      if (!L.qu_sep) {   // one column tile: v's levels over T's
        load_v(T);
        __syncthreads();
        tc::quantize_rows<R>(T, L.ldT, kF, QT, L.ldqT, sU);
        __syncthreads();
      }
      tc::each_pair<R>([&](int mt, int j, int hh, int r, int cc) {
        *reinterpret_cast<float2*>(Y + (size_t)r * tc::LDY + cc) =
            make_float2(y[mt][j][2 * hh], y[mt][j][2 * hh + 1]);
      });
      tc::zero<MODE, R>(acc);
      ws.run(acc, L.qu_sep ? QU : QT, L.ldqT, pass1(n0), rows,
             pass0(n0 + NC), more);
      tc::store_out<R>(a, row0, rows, n0, [&](int mt, int j, int k, int r, int c) {
        return __fadd_rn(Y[(size_t)r * tc::LDY + c - n0],
                         tc::value<MODE>(acc[mt][j][k], sU[r], a.sw1, c));
      });
    }
  }
}

// Dynamic shared memory of a gin (H > 0) or sage (H = 0) launch in `mode`
// with `stages` weight stages and R rows a CTA.
size_t mm_smem_bytes(int F, int H, int Fout, bool block, int mode,
                     int stages, int R) {
  return (size_t)mm_layout(F, H, Fout, block, mode, stages, R).bytes;
}

// The CTA's rows and weight stages of a launch: 128 rows where they fit
// the card's shared memory, else 64 (hidden 384; BF16 gin and the block
// mode always); two stages where they fit beside them, else one.  {0, 0}
// where nothing fits.
struct Shape {
  int R, stages;
};
Shape mm_shape(int F, int H, int Fout, bool block, int mode, size_t optin) {
  // BF16 gin's float64 Z (gin_z_f64) holds a 32 x 32 warp tile: 64 rows;
  // the block mode's lists of 128 rows (64 KB) leave one CTA an SM, and a
  // block batch's 160 CTAs two rounds: 64 rows (PERF.md §6, row 4)
  const bool z64 = mode == BF16 && H > 0;
  for (int R : {128, 64}) {
    if ((z64 || block) && R == 128) continue;
    for (int st : {2, 1})
      if (mm_smem_bytes(F, H, Fout, block, mode, st, R) <= optin)
        return {R, st};
  }
  return {0, 0};
}

template <int MODE, bool BLOCK, int R>
cudaError_t launch_rows(const LayerArgs& a, size_t smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      mp_layer_tc_kernel<MODE, BLOCK, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mp_layer_tc_kernel<MODE, BLOCK, R>
      <<<(a.n_rows + R - 1) / R, tc::THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

template <int MODE, bool BLOCK>
cudaError_t launch_mm(LayerArgs a, size_t optin, cudaStream_t s) {
  const int H = a.conv == GIN ? a.H : 0;
  const Shape sh = mm_shape(a.F, H, a.Fout, BLOCK, MODE, optin);
  if (sh.R == 0) return cudaErrorInvalidValue;
  a.stages = sh.stages;
  const size_t smem =
      mm_smem_bytes(a.F, H, a.Fout, BLOCK, MODE, sh.stages, sh.R);
  return sh.R == 128 ? launch_rows<MODE, BLOCK, 128>(a, smem, s)
                     : launch_rows<MODE, BLOCK, 64>(a, smem, s);
}

// an elementwise instance's launch: the block mode a CTA per EW_R rows;
// the ELL mode the instance's occupancy on every SM (worked out at its
// first launch on a device), each warp striding over row groups
template <bool BLOCK, int MODE, int CONV, int ACT, int V>
cudaError_t launch_ew(const LayerArgs& a, cudaStream_t s, int device) {
  if (BLOCK) {
    mp_layer_ew_block_kernel<MODE, CONV, ACT, V>
        <<<(a.n_rows + EW_R - 1) / EW_R, THREADS, 0, s>>>(a);
    return cudaGetLastError();
  }
  constexpr int MAX_DEV = 64;
  static int per_sm[MAX_DEV], sms[MAX_DEV];
  if (device < 0 || device >= MAX_DEV) return cudaErrorInvalidDevice;
  if (per_sm[device] == 0) {
    int p = 0, n = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &p, ew_kernel<MODE, CONV, ACT, V>(), THREADS, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return err;
    sms[device] = n;
    per_sm[device] = p;
  }
  const int groups = (THREADS / 32) * (32 / a.gs);   // rows a CTA a pass
  const long long want = ((long long)a.n_rows + groups - 1) / groups;
  const long long most = (long long)per_sm[device] * sms[device];
  ew_kernel<MODE, CONV, ACT, V>()
      <<<(int)(want < most ? want : most), THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

template <bool BLOCK, int MODE, int CONV>
cudaError_t launch_conv(const LayerArgs& a, cudaStream_t s, int device) {
  const bool relu = a.act == 1;
  if (a.vec)
    return relu ? launch_ew<BLOCK, MODE, CONV, EW_RELU, 4>(a, s, device)
                : launch_ew<BLOCK, MODE, CONV, EW_ANY, 4>(a, s, device);
  return relu ? launch_ew<BLOCK, MODE, CONV, EW_RELU, 1>(a, s, device)
              : launch_ew<BLOCK, MODE, CONV, EW_ANY, 1>(a, s, device);
}

template <bool BLOCK, int MODE>
cudaError_t launch(const LayerArgs& a, size_t optin, cudaStream_t s,
                   int device) {
  if (a.conv != GIN && a.conv != SAGE) {
    if constexpr (MODE == INT8) {
      return cudaErrorInvalidValue;   // no product to quantize
    } else {
      switch (a.conv) {
        case GCN: return launch_conv<BLOCK, MODE, GCN>(a, s, device);
        case LG: return launch_conv<BLOCK, MODE, LG>(a, s, device);
        case SIMPLE_SUM:
          return launch_conv<BLOCK, MODE, SIMPLE_SUM>(a, s, device);
        default: return launch_conv<BLOCK, MODE, SIMPLE_MEAN>(a, s, device);
      }
    }
  }
  return launch_mm<MODE, BLOCK>(a, optin, s);
}

template <int MODE>
cudaError_t launch_mode(const LayerArgs& a, bool block, size_t optin,
                        cudaStream_t s, int device) {
  return block ? launch<true, MODE>(a, optin, s, device)
               : launch<false, MODE>(a, optin, s, device);
}

template <int MODE, bool BLOCK, int R>
cudaError_t info_rows(size_t smem, int* regs, int* smem_bytes, int* ctas) {
  cudaError_t err = cudaFuncSetAttribute(
      mp_layer_tc_kernel<MODE, BLOCK, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, mp_layer_tc_kernel<MODE, BLOCK, R>);
  if (err != cudaSuccess) return err;
  *regs = fa.numRegs;
  *smem_bytes = (int)(fa.sharedSizeBytes + smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, mp_layer_tc_kernel<MODE, BLOCK, R>, tc::THREADS, smem);
}

// The resources of the instance a launch at F = H = Fout = w takes (H = 0:
// sage) with R rows a CTA (0: the launcher's choice).
template <int MODE, bool BLOCK>
cudaError_t info(int w, int H, int R, int* regs, int* smem_bytes, int* ctas,
                 size_t optin) {
  Shape sh = mm_shape(w, H, w, BLOCK, MODE, optin);
  if (R != 0 && R != sh.R) {
    sh.R = R;
    sh.stages = mm_smem_bytes(w, H, w, BLOCK, MODE, 2, R) <= optin ? 2 : 1;
  }
  if (sh.R == 0) return cudaErrorInvalidValue;
  const size_t smem = mm_smem_bytes(w, H, w, BLOCK, MODE, sh.stages, sh.R);
  return sh.R == 128 ? info_rows<MODE, BLOCK, 128>(smem, regs, smem_bytes, ctas)
                     : info_rows<MODE, BLOCK, 64>(smem, regs, smem_bytes, ctas);
}

template <int MODE>
cudaError_t info_mode(bool block, int w, int H, int R, int* regs,
                      int* smem_bytes, int* ctas, size_t optin) {
  return block ? info<MODE, true>(w, H, R, regs, smem_bytes, ctas, optin)
               : info<MODE, false>(w, H, R, regs, smem_bytes, ctas, optin);
}

// lanes a row of the elementwise kernels: its chunks rounded up to a
// power of two, at least EW_U (a pass takes EW_U slots from EW_U lanes'
// ids) and at most 32
int group_size(int lanes) {
  int gs = EW_U;
  while (gs < 32 && gs < lanes) gs *= 2;
  return gs;
}

}  // namespace

extern "C" {

int gnnb_smem_per_block_optin(int device);   // readout.cu: read once

// Rows of an adjacency block the block mode takes.
int gnnb_mp_layer_block_rows() { return BB; }

// Shared memory a gin (H > 0) or sage (H = 0) launch in `mode` needs at
// the fewest rows and weight stages, in bytes (the launcher takes more
// where they fit), at the widest Fout of the kernel's layouts (Fout > 128).
int gnnb_mp_layer_smem_bytes(int F, int H, int block, int mode) {
  return (int)mm_smem_bytes(F, H, 1 << 20, block != 0, mode, 1, 64);
}

// Registers per thread, shared memory per CTA (bytes) and resident CTAs
// per SM of the gin / sage kernel's instance for `mode`, `block` and R
// rows a CTA (128 or 64), at F = H = Fout = w (conv 0 gin, 1 sage; w =
// 128 takes 128 rows, 384 takes 64), on the current device.
int gnnb_mp_layer_info(int mode, int block, int conv, int rows, int w,
                       int* regs, int* smem_bytes, int* ctas_per_sm) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (rows != 128 && rows != 64) return (int)cudaErrorInvalidValue;
  const int H = conv == GIN ? w : 0;
  const bool b = block != 0;
  const size_t o = (size_t)optin;
  int* c = ctas_per_sm;
  if (mode == BF16)
    return (int)info_mode<BF16>(b, w, H, rows, regs, smem_bytes, c, o);
  if (mode == INT8)
    return (int)info_mode<INT8>(b, w, H, rows, regs, smem_bytes, c, o);
  if (mode == F32)
    return (int)info_mode<F32>(b, w, H, rows, regs, smem_bytes, c, o);
  return (int)cudaErrorInvalidValue;
}

// Registers per thread and resident CTAs per SM of the elementwise
// instance for (block, mode 0 f32 / 1 bf16, conv 2 gcn .. 5 simple_mean,
// relu or the run-time activation, float4 columns), on the current
// device.
int gnnb_mp_layer_ew_info(int block, int mode, int conv, int relu, int vec,
                          int* regs, int* ctas_per_sm) {
  const void* k = nullptr;
#define GNNB_EW(B, M, C, A, V)                                              \
  if (block == B && mode == M && conv == C && relu == (A == EW_RELU) &&    \
      vec == (V == 4))                                                     \
    k = B ? (const void*)mp_layer_ew_block_kernel<M, C, A, V>              \
          : (const void*)ew_kernel<M, C, A, V>();
#define GNNB_EW_V(B, M, C, A) GNNB_EW(B, M, C, A, 4) GNNB_EW(B, M, C, A, 1)
#define GNNB_EW_A(B, M, C) \
  GNNB_EW_V(B, M, C, EW_RELU) GNNB_EW_V(B, M, C, EW_ANY)
#define GNNB_EW_C(B, M)                                                     \
  GNNB_EW_A(B, M, GCN) GNNB_EW_A(B, M, LG) GNNB_EW_A(B, M, SIMPLE_SUM)     \
      GNNB_EW_A(B, M, SIMPLE_MEAN)
  GNNB_EW_C(1, F32) GNNB_EW_C(1, BF16) GNNB_EW_C(0, F32) GNNB_EW_C(0, BF16)
#undef GNNB_EW_C
#undef GNNB_EW_A
#undef GNNB_EW_V
#undef GNNB_EW
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, k,
                                                            THREADS, 0);
}

// Launches the layer on `stream` of `device`.  `adj` non-null selects the
// block mode (n_rows % 128 == 0), else the ELL mode reads nbr [N, W].
// conv: 0 gin, 1 sage, 2 gcn, 3 lg, 4 simple_sum, 5 simple_mean; act: 0
// none, 1 relu, 2 gelu, 3 sigmoid, 4 tanh; mode: 0 f32, 1 bf16 (w0, w1
// bfloat16), 2 int8 (gin and sage: w0, w1 int8 with column scales sw0,
// sw1).  skip and s may be null.  All other arrays
// contiguous f32 / i32 as documented in ops/cuda/mp_layer.py.  Returns the
// cudaError_t of the launch (0 = success).
int gnnb_mp_layer(const void* v, const void* nbr, const void* adj,
                  const void* deg, int n_rows, int W, int F, int H, int Fout,
                  const void* w0, const void* b0, const void* w1,
                  const void* b1, const void* skip, int conv, float eps,
                  int act, int mode, const void* sw0, const void* sw1,
                  void* out, void* s, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool block = adj != nullptr;
  const bool mm = conv == GIN || conv == SAGE;
  bool ok = n_rows >= 0 && F >= 1 && Fout >= 1 && conv >= GIN &&
            conv <= SIMPLE_MEAN && act >= 0 && act <= 4 && out != nullptr &&
            mode >= F32 && mode <= INT8;
  ok = ok && (block ? n_rows % BB == 0 : (nbr != nullptr && W >= 1));
  if (conv == GIN)
    ok = ok && H >= 1 && w0 && b0 && w1 && b1;
  else if (conv == SAGE)
    ok = ok && H == 0 && w0 && b0 && w1;
  else
    ok = ok && Fout == F && (conv != GCN || b0 != nullptr);
  if (mode == INT8) ok = ok && mm && sw0 && sw1;
  // the elementwise kernels' 32-bit index math
  if (!mm)
    ok = ok && (long long)n_rows * F < (1ll << 31) &&
         (long long)n_rows * W < (1ll << 31);
  if (!ok) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const int optin = mm ? gnnb_smem_per_block_optin(device) : 0;
  if (mm && optin == 0) return (int)cudaErrorInvalidValue;
  LayerArgs a;
  a.v = (const float*)v;
  a.nbr = (const int*)nbr;
  a.adj = (const float*)adj;
  a.deg = (const int*)deg;
  a.w0 = w0;
  a.b0 = (const float*)b0;
  a.w1 = w1;
  a.b1 = (const float*)b1;
  a.sw0 = (const float*)sw0;
  a.sw1 = (const float*)sw1;
  a.skip = (const float*)skip;
  a.out = (float*)out;
  a.s = (float*)s;
  a.n_rows = n_rows;
  a.W = W;
  a.F = F;
  a.H = H;
  a.Fout = Fout;
  a.conv = conv;
  a.act = act;
  a.eps = eps;
  a.stages = 0;
  a.vec = F % 4 == 0 &&
         ((uintptr_t)v | (uintptr_t)s |
          (mm ? 0 : (uintptr_t)skip | (uintptr_t)out | (uintptr_t)b0)) %
                 16 ==
             0;
  a.gs = group_size(a.vec ? F / 4 : F);
  cudaStream_t st = (cudaStream_t)stream;
  const size_t fits = (size_t)optin;
  if (mode == BF16) return (int)launch_mode<BF16>(a, block, fits, st, device);
  if (mode == INT8) return (int)launch_mode<INT8>(a, block, fits, st, device);
  return (int)launch_mode<F32>(a, block, fits, st, device);
}

}  // extern "C"
