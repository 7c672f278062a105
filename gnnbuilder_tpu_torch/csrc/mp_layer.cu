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
// Modes (a template argument, as pna_layer.cu's MODE; inference only, no
// s output), the JAX kernel's gather_mode / mm / quant:
//   BF16 (1): each gathered v is rounded to bf16 before the sum, which
//        stays float32; gin's and sage's products take bf16-rounded
//        operands ((1 + eps) v + s, the mean, v, Z) and bf16 weights.
//   INT8 (2), gin and sage only: every epilogue product quantizes its
//        operand rows (one scale per row, quant.cuh quantize_rows) against
//        int8 weights with per-column scales, an exact int32 sum
//        (__dp4a) times s_row * s_col: _qdot; the aggregation stays exact.
//
// What bounds it on the H100: bytes for gcn, lg and simple (a few
// operations per element against v, the table, skip, out and s moved
// once); operations for gin and sage at width 128 (2 F H + 2 H Fout, or
// 4 F Fout, flops per row against ~1 KB of row data), run as plain f32
// FMAs (bf16 operands unpacked to f32, int8 through __dp4a).
//
// Design: a CTA owns R consecutive rows (R divides 128, so in block mode
// they lie in one block).  In block mode it first compacts its R
// adjacency rows into per-row (neighbour, count) lists in shared memory
// (block_lists.cuh, shared with mp_block.cu); in ELL mode it reads the
// table's slots with indexed loads.  The TPU kernel's count-matrix
// one-hot products, hi/lo bf16 passes and window DMAs existed because
// Mosaic has no dynamic row gather; here an indexed load is exact.
// * gcn, lg, simple: each thread takes elements (row, column) of the
//   CTA's rows, consecutive threads on consecutive columns, forms s and
//   the epilogue in registers and writes out (and s) once.
// * gin, sage: the aggregate-derived rows T ((1 + eps) v + s, or the
//   mean) and, for sage, the v rows sit in shared memory at a row stride
//   rounded up to 4 floats with zeroed pad columns, so any width works
//   (the first layer has F = 11).  The products then run with one thread
//   per output column and R / 2 rows (dense_rows.cuh), weights streaming
//   from device memory (L2 resident, coalesced along the column), each
//   read feeding R / 2 FMAs; GIN's hidden layer Z goes through shared
//   memory too.  In the bf16 mode those rows are stored rounded (they feed
//   only products); in the int8 mode their levels and scales sit beside
//   them.  R is 32, or 16 or 8 where 32 rows do not fit the card's shared
//   memory.

#include <cuda_runtime.h>
#include <math.h>

#include "block_lists.cuh"
#include "dense_rows.cuh"

namespace {

using namespace gnnb_dense;
using gnnb_quant::bf16r;
using gnnb_quant::BF16;
using gnnb_quant::F32;
using gnnb_quant::INT8;

constexpr int BB = gnnb::LIST_COLS;   // rows of an adjacency block
constexpr int EW_R = 32;              // rows per CTA, elementwise convs

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

// gcn, lg, simple_sum, simple_mean: one element per thread and pass (F32
// or BF16: these convs run no product to quantize).
template <bool BLOCK, int MODE>
__global__ void __launch_bounds__(THREADS)
mp_layer_ew_kernel(LayerArgs a) {
  __shared__ int s_deg[EW_R], s_cnt[EW_R], s_ptr[EW_R + 1];
  __shared__ int s_ent[BLOCK ? EW_R * BB : 1];
  const int F = a.F;
  const int row0 = blockIdx.x * EW_R;
  load_rows<EW_R, BLOCK>(a, row0, s_deg, s_cnt, s_ptr, s_ent);
  const float* vb = a.v + (size_t)(row0 / BB) * BB * F;
  for (int e = threadIdx.x; e < EW_R * F; e += THREADS) {
    const int i = e / F, c = e % F, r = row0 + i;
    if (r >= a.n_rows) break;          // rows only grow with e
    const int d = s_deg[i];
    const float s =
        neighbour_sum<BLOCK, MODE>(a, r, i, d, s_ent, s_ptr, vb, c);
    const size_t o_idx = (size_t)r * F + c;
    if (a.s != nullptr) a.s[o_idx] = s;
    const float df = (float)d;
    float o;
    switch (a.conv) {
      case GCN:
        o = (1.f / sqrtf(df + 1.f)) * (s + a.v[o_idx]) + a.b0[c];
        break;
      case LG:
        o = (d > 0 ? 1.f / sqrtf(fmaxf(df, 1.f)) : 0.f) * s;
        break;
      case SIMPLE_MEAN:
        o = s / fmaxf(df, 1.f);
        break;
      default:
        o = s;
    }
    if (a.skip != nullptr) o += a.skip[o_idx];
    a.out[o_idx] = act_fn(o, a.act);
  }
}

__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

// gin and sage: T (and sage's v rows, or gin's Z) in shared memory, then
// the products; in the INT8 mode the levels of T and U (two buffers of R
// rows at the wider row stride) and their row scales follow them.
template <int R, bool BLOCK, int MODE>
__global__ void __launch_bounds__(THREADS)
mp_layer_mm_kernel(LayerArgs a) {
  constexpr int RG = R / GROUPS;       // rows per thread
  constexpr bool RND = MODE == BF16;   // rows stored bf16-rounded
  extern __shared__ float4 smem4[];
  __shared__ int s_deg[R], s_cnt[R], s_ptr[R + 1];
  __shared__ int s_ent[BLOCK ? R * BB : 1];
  __shared__ float s_q[MODE == INT8 ? 2 * R : 1];   // row scales of QT, QU
  const int F = a.F, H = a.H, Fout = a.Fout;
  const int ldF = rup4(F), ldH = rup4(H), ldU = imax(ldF, ldH);
  const bool gin = a.conv == GIN;
  float* T = reinterpret_cast<float*>(smem4);   // [R, ldF]
  float* U = T + R * ldF;   // sage v [R, ldF]; gin Z [R, ldH]
  int8_t* QT = reinterpret_cast<int8_t*>(U + R * ldU);   // [R, ldU]
  int8_t* QU = QT + R * ldU;                             // [R, ldF]
  float* sT = s_q;
  float* sU = s_q + R;
  const int row0 = blockIdx.x * R;
  const int col = threadIdx.x % CB;
  const int i0 = (threadIdx.x / CB) * RG;
  load_rows<R, BLOCK>(a, row0, s_deg, s_cnt, s_ptr, s_ent);
  const float* vb = a.v + (size_t)(row0 / BB) * BB * F;

  const float ope = 1.f + a.eps;
  for (int e = threadIdx.x; e < R * ldF; e += THREADS) {
    const int i = e / ldF, c = e % ldF, r = row0 + i;
    float t = 0.f, x = 0.f;
    if (c < F && r < a.n_rows) {
      const int d = s_deg[i];
      const float s =
          neighbour_sum<BLOCK, MODE>(a, r, i, d, s_ent, s_ptr, vb, c);
      if (a.s != nullptr) a.s[(size_t)r * F + c] = s;
      x = a.v[(size_t)r * F + c];
      // (1 + eps) x + s rounded twice, as the plain version forms it (a
      // fused multiply-add moves an ulp, and an ulp before a bf16 rounding
      // or an int8 quantization moves a value)
      t = gin ? __fadd_rn(__fmul_rn(ope, x), s) : s / fmaxf((float)d, 1.f);
    }
    T[e] = RND ? bf16r(t) : t;
    if (!gin) U[e] = RND ? bf16r(x) : x;
  }
  __syncthreads();
  if constexpr (MODE == INT8) {
    gnnb_quant::quantize_rows<THREADS>(T, ldF, R, QT, sT);
    if (!gin) gnnb_quant::quantize_rows<THREADS>(U, ldF, R, QU, sU);
    __syncthreads();
  }

  if (gin) {   // Z = relu(T W0 + b0)
    for (int c = col; c < ldH; c += CB) {
      float acc[RG];
#pragma unroll
      for (int i = 0; i < RG; ++i) acc[i] = 0.f;
      if (c < H)
        prod_rows<MODE, RG>(acc, T, QT, sT, ldF, i0, a.w0, a.sw0, H, c, F);
      const float b = c < H ? a.b0[c] : 0.f;
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        const float z = c < H ? fmaxf(acc[i] + b, 0.f) : 0.f;
        U[(size_t)(i0 + i) * ldH + c] = RND ? bf16r(z) : z;
      }
    }
    __syncthreads();
    if constexpr (MODE == INT8) {   // QT is free again: Z's levels
      gnnb_quant::quantize_rows<THREADS>(U, ldH, R, QT, sT);
      __syncthreads();
    }
  }

  for (int c = col; c < Fout; c += CB) {   // o, skip, act
    float acc[RG];
    float b;
    if (gin) {
      prod_rows<MODE, RG>(acc, U, QT, sT, ldH, i0, a.w1, a.sw1, Fout, c, H);
      b = a.b1[c];
#pragma unroll
      for (int i = 0; i < RG; ++i) acc[i] += b;
    } else if constexpr (MODE == INT8) {
      // qdot(mean, W0) + b0 + qdot(v, W1), in the JAX order
      float acc1[RG];
      prod_rows<MODE, RG>(acc, T, QT, sT, ldF, i0, a.w0, a.sw0, Fout, c, F);
      prod_rows<MODE, RG>(acc1, U, QU, sU, ldF, i0, a.w1, a.sw1, Fout, c,
                          F);
      b = a.b0[c];
#pragma unroll
      for (int i = 0; i < RG; ++i) acc[i] = (acc[i] + b) + acc1[i];
    } else {
      using TW = typename gnnb_quant::WeightOf<MODE>::T;
#pragma unroll
      for (int i = 0; i < RG; ++i) acc[i] = 0.f;
      dot_rows<RG>(acc, T, ldF, i0, static_cast<const TW*>(a.w0), Fout, c,
                   F);
      dot_rows<RG>(acc, U, ldF, i0, static_cast<const TW*>(a.w1), Fout, c,
                   F);
      b = a.b0[c];
#pragma unroll
      for (int i = 0; i < RG; ++i) acc[i] += b;
    }
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int r = row0 + i0 + i;
      if (r >= a.n_rows) continue;
      const size_t o_idx = (size_t)r * Fout + c;
      float o = acc[i];
      if (a.skip != nullptr) o += a.skip[o_idx];
      a.out[o_idx] = act_fn(o, a.act);
    }
  }
}

// Dynamic shared memory of a gin / sage launch with R rows (sage: H = 0)
// in `mode`.
size_t mm_smem_bytes(int R, int F, int H, int mode) {
  const int ldF = rup4(F), ldU = imax(ldF, rup4(H));
  size_t b = (size_t)R * (ldF + ldU) * sizeof(float);
  if (mode == INT8) b += (size_t)R * (ldU + ldF);
  return b;
}

// The kernel's static shared memory with R rows.
size_t static_bytes(int R, bool block, int mode) {
  return (size_t)(3 * R + 1 + (block ? R * BB : 1)) * sizeof(int) +
         (mode == INT8 ? 2 * R : 1) * sizeof(float);
}

template <int R, bool BLOCK, int MODE>
cudaError_t launch_mm(const LayerArgs& a, cudaStream_t s) {
  const size_t smem = mm_smem_bytes(R, a.F, a.H, MODE);
  cudaError_t err = cudaFuncSetAttribute(
      mp_layer_mm_kernel<R, BLOCK, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mp_layer_mm_kernel<R, BLOCK, MODE><<<(a.n_rows + R - 1) / R, THREADS,
                                       smem, s>>>(a);
  return cudaGetLastError();
}

template <bool BLOCK, int MODE>
cudaError_t launch(const LayerArgs& a, size_t optin, cudaStream_t s) {
  if (a.conv != GIN && a.conv != SAGE) {
    if constexpr (MODE == INT8) {
      return cudaErrorInvalidValue;   // no product to quantize
    } else {
      mp_layer_ew_kernel<BLOCK, MODE>
          <<<(a.n_rows + EW_R - 1) / EW_R, THREADS, 0, s>>>(a);
      return cudaGetLastError();
    }
  }
  if (mm_smem_bytes(32, a.F, a.H, MODE) + static_bytes(32, BLOCK, MODE) <=
      optin)
    return launch_mm<32, BLOCK, MODE>(a, s);
  if (mm_smem_bytes(16, a.F, a.H, MODE) + static_bytes(16, BLOCK, MODE) <=
      optin)
    return launch_mm<16, BLOCK, MODE>(a, s);
  if (mm_smem_bytes(MIN_R, a.F, a.H, MODE) +
          static_bytes(MIN_R, BLOCK, MODE) <= optin)
    return launch_mm<MIN_R, BLOCK, MODE>(a, s);
  return cudaErrorInvalidValue;
}

template <int MODE>
cudaError_t launch_mode(const LayerArgs& a, bool block, size_t optin,
                        cudaStream_t s) {
  return block ? launch<true, MODE>(a, optin, s)
               : launch<false, MODE>(a, optin, s);
}

}  // namespace

extern "C" {

// Rows of an adjacency block the block mode takes.
int gnnb_mp_layer_block_rows() { return BB; }

// Shared memory a gin (H > 0) or sage (H = 0) launch in `mode` needs at
// the fewest rows per CTA, in bytes (the launcher takes more rows where
// they fit).
int gnnb_mp_layer_smem_bytes(int F, int H, int block, int mode) {
  return (int)(mm_smem_bytes(MIN_R, F, H, mode) +
               static_bytes(MIN_R, block != 0, mode));
}

// Launches the layer on `stream` of `device`.  `adj` non-null selects the
// block mode (n_rows % 128 == 0), else the ELL mode reads nbr [N, W].
// conv: 0 gin, 1 sage, 2 gcn, 3 lg, 4 simple_sum, 5 simple_mean; act: 0
// none, 1 relu, 2 gelu, 3 sigmoid, 4 tanh; mode: 0 f32, 1 bf16 (w0, w1
// bfloat16), 2 int8 (gin and sage: w0, w1 int8 with column scales sw0,
// sw1).  skip and s may be null; s only in mode 0.  All other arrays
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
            mode >= F32 && mode <= INT8 && (mode == F32 || s == nullptr);
  ok = ok && (block ? n_rows % BB == 0 : (nbr != nullptr && W >= 1));
  if (conv == GIN)
    ok = ok && H >= 1 && w0 && b0 && w1 && b1;
  else if (conv == SAGE)
    ok = ok && H == 0 && w0 && b0 && w1;
  else
    ok = ok && Fout == F && (conv != GCN || b0 != nullptr);
  if (mode == INT8) ok = ok && mm && sw0 && sw1;
  if (!ok) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
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
  cudaStream_t st = (cudaStream_t)stream;
  const size_t fits = (size_t)optin;
  if (mode == BF16) return (int)launch_mode<BF16>(a, block, fits, st);
  if (mode == INT8) return (int)launch_mode<INT8>(a, block, fits, st);
  return (int)launch_mode<F32>(a, block, fits, st);
}

}  // extern "C"
