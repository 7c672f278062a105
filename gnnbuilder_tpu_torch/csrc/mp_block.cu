// Whole GCN, GIN or SAGE conv stack on a block-packed batch, one CTA per
// 128-row block.
//
// Replaces: gnnbuilder_tpu/ops/pallas/mp_block.py mp_block_stack (kernel
// body _kernel).  Per layer l, for every node row r of the block, with A
// the block's [128, 128] adjacency counts (A[i, j] = edges j -> i):
//
//   gcn   p = (h W0) * dis;           o = dis * (A p + p) + b0
//   gin   o = relu(((1 + eps) h + A h) W0 + b0) W1 + b1
//   sage  o = (A h / max(deg, 1)) W0 + b0 + h W1
//
//   h = act(o [+ h])                   (skip added before the activation)
//
// with dis = 1 / sqrt(deg + 1) (the self loop added analytically).  Every
// width is one F, a multiple of 128 (the caller zero-pads, as the TPU
// kernel's caller does).
//
// What bounds it on the H100: operations at F = 128 (2 F^2 flops per row
// and dot, 1 or 2 dots per layer, against ~1 KB of row data in and out
// once for the whole stack), run as plain f32 FMAs.
//
// Design: no graph crosses a 128-row block, so a CTA owns its block's
// whole problem for all L layers and device memory sees x once and the
// final h once.  The adjacency is read once per CTA and compacted in
// shared memory into per-row lists of (neighbour, count) pairs in
// neighbour order (a QM9 block is ~97 % zeros); every layer's aggregation
// walks those lists, so a block with a hub over the ELL width runs like
// any other.  The TPU kernel's dense [128, 128] MXU products, split into
// bf16 hi/lo passes, do not apply here.  Where they fit the card's shared
// memory (F = 128), the hidden state H and the per-layer buffer T (gcn's
// p, or the aggregate of gin and sage) stay there; at wider F they live
// in device memory (H in the output itself, T in a scratch array), where
// the CTA's rows are its own and L2 holds them.  The Linear epilogues of
// gin and sage run over R-row chunks (32, or 16 or 8 at widths where 32
// rows of a chunk buffer Z do not fit) with one thread per output column
// and R / 2 rows; weights stream from device memory (L2 resident,
// coalesced along the column), each read feeding R / 2 FMAs.
//
// Modes (a template argument, as pna_block.cu's MODE; the JAX kernel's
// gather_mode="bf16" with mm="bf16", and quant):
//   BF16 (1): bf16 weights; each layer's aggregation source (h, or gcn's
//        p) is rounded to bf16 as it is gathered, the sum float32; every
//        product takes bf16-rounded operands (h rounded as it is read,
//        since the skip and gin's (1 + eps) h need it unrounded; T and Z
//        stored rounded, they feed only products).
//   INT8 (2): every product (gcn's h W0, gin's two, sage's two) quantizes
//        its operand rows per row (quant.cuh) against int8 weights with
//        per-column scales, an exact int32 sum (__dp4a) times s_row *
//        s_col; the adjacency sum stays exact.  The levels of the R rows
//        of a chunk (two operands for sage) sit in shared memory beside
//        Z: 8 KB at F = 128, so H and T still fit there.  Zero pad
//        columns quantize to level 0 and leave the row's scale alone.

#include <cuda_runtime.h>
#include <math.h>

#include "block_lists.cuh"
#include "quant.cuh"

namespace {

using gnnb::agg_row;
using gnnb_quant::bf16r;
using gnnb_quant::BF16;
using gnnb_quant::F32;
using gnnb_quant::INT8;

constexpr int BB = 128;               // rows per block = rows per CTA
static_assert(BB == gnnb::LIST_COLS, "lists cover one block row");
constexpr int CB = 128;               // columns per column block
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / CB;  // row groups (2)
constexpr int VT = 32;                // rows per register tile, whole block
constexpr int MAX_L = 16;
constexpr int MAX_NNZ = BB * BB;      // a dense block fits the list
constexpr int MIN_R = 8;
// the kernel's static shared arrays (row pointers, counts, dis, denom)
constexpr size_t STATIC_SMEM = (BB + 1 + 3 * BB) * 4;

enum Conv { GCN = 0, GIN = 1, SAGE = 2 };

struct StackArgs {
  const float* x;     // [N, F]
  const float* adj;   // [N / 128, 128, 128] counts
  const int* deg;     // [N]
  const void* w0;     // [L, F, F] (the mode's type)
  const float* b0;    // [L, F]
  const void* w1;     // [L, F, F]
  const float* b1;    // [L, F]
  const float* sw0;   // [L, F] column scales of w0 (INT8)
  const float* sw1;   // [L, F] column scales of w1 (INT8)
  float* out;         // [N, F]
  float* scratch;     // [N, F] T in device memory, or null
  int n_rows, F, L, conv, act;
  float eps[MAX_L];
  int skip[MAX_L];
};

__device__ __forceinline__ float act_fn(float x, int act) {
  switch (act) {
    case 1: return fmaxf(x, 0.f);
    case 2: return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
    case 3: return 1.f / (1.f + expf(-x));
    case 4: return tanhf(x);
    default: return x;
  }
}

// acc[i] += A[r0 + i, 0:K] . W[0:K, col]; A rows 16-byte aligned (shared
// or device memory), each value rounded to bf16 first with RA, W
// row-major (float32 or bf16) in device memory.
template <int NR, bool RA = false, typename TW>
__device__ __forceinline__ void dot_rows(float (&acc)[NR], const float* A,
                                         int lda, int r0,
                                         const TW* __restrict__ W,
                                         int ldw_, int col, int K) {
  using gnnb_quant::ldw;
  for (int k = 0; k < K; k += 4) {
    const float w0 = ldw(W + (size_t)(k + 0) * ldw_ + col);
    const float w1 = ldw(W + (size_t)(k + 1) * ldw_ + col);
    const float w2 = ldw(W + (size_t)(k + 2) * ldw_ + col);
    const float w3 = ldw(W + (size_t)(k + 3) * ldw_ + col);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      float4 a =
          *reinterpret_cast<const float4*>(A + (size_t)(r0 + i) * lda + k);
      if (RA) a = make_float4(bf16r(a.x), bf16r(a.y), bf16r(a.z), bf16r(a.w));
      acc[i] = fmaf(a.x, w0, acc[i]);
      acc[i] = fmaf(a.y, w1, acc[i]);
      acc[i] = fmaf(a.z, w2, acc[i]);
      acc[i] = fmaf(a.w, w3, acc[i]);
    }
  }
}

template <int R, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
mp_block_stack_kernel(StackArgs a, int ht_smem) {
  using TW = typename gnnb_quant::WeightOf<MODE>::T;
  constexpr int RG = R / GROUPS;      // rows per thread in a chunk
  constexpr bool RND = MODE == BF16;
  const int F = a.F;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const size_t row0 = (size_t)blockIdx.x * BB;
  float *H, *T;
  if (ht_smem) {
    H = sm;
    T = H + BB * F;
    sm = T + BB * F;
  } else {
    H = a.out + row0 * F;
    T = a.scratch + row0 * F;
  }
  float* Z = sm;                                  // [R, F] chunk buffer
  int* ent = reinterpret_cast<int*>(Z + R * F);   // [MAX_NNZ] lists
  int8_t* Q0 = reinterpret_cast<int8_t*>(ent + MAX_NNZ);   // [R, F] INT8
  int8_t* Q1 = Q0 + R * F;                                 // [R, F] INT8
  __shared__ int s_ptr[BB + 1];
  __shared__ int s_cnt[BB];
  __shared__ float s_dis[BB];
  __shared__ float s_den[BB];                     // max(deg, 1)
  __shared__ float s_q[MODE == INT8 ? 2 * R : 1];  // row scales of Q0, Q1
  float* sq0 = s_q;
  float* sq1 = s_q + R;

  const int tid = threadIdx.x;
  const int col = tid % CB;
  const int grp = tid / CB;

  {  // h = x
    const float4* xs = reinterpret_cast<const float4*>(a.x + row0 * F);
    float4* hs = reinterpret_cast<float4*>(H);
    for (int i = tid; i < BB * F / 4; i += THREADS) hs[i] = xs[i];
  }
  for (int r = tid; r < BB; r += THREADS) {
    const float d = (float)a.deg[row0 + r];
    s_dis[r] = 1.f / sqrtf(d + 1.f);
    s_den[r] = fmaxf(d, 1.f);
  }
  // adjacency rows -> per-row lists (block_lists.cuh)
  gnnb::compact_rows<THREADS>(a.adj + row0 * BB, BB, s_cnt, s_ptr, ent);

  const int rA0 = grp * (BB / GROUPS);            // whole-block rows
  const int i0 = grp * RG;                        // a chunk's rows
  for (int l = 0; l < a.L; ++l) {
    const TW* W0 = static_cast<const TW*>(a.w0) + (size_t)l * F * F;
    const TW* W1 = static_cast<const TW*>(a.w1) + (size_t)l * F * F;
    const float* B0 = a.b0 + (size_t)l * F;
    const float* B1 = a.b1 + (size_t)l * F;
    const float* S0 = MODE == INT8 ? a.sw0 + (size_t)l * F : nullptr;
    const float* S1 = MODE == INT8 ? a.sw1 + (size_t)l * F : nullptr;
    const bool skip = a.skip[l] != 0;

    // T over the whole block: gcn p = (h W0) dis; gin (1+eps) h + A h;
    // sage A h / max(deg, 1)
    if (a.conv == GCN && MODE == INT8) {
      for (int c0 = 0; c0 < BB; c0 += R) {   // p = qdot(h, W0) dis
        gnnb_quant::quantize_rows<THREADS>(H + (size_t)c0 * F, F, R, Q0,
                                           sq0);
        __syncthreads();
        for (int c = col; c < F; c += CB) {
          float acc[RG];
          gnnb_quant::qdot_scaled<RG>(acc, Q0, F, sq0, i0,
                                      static_cast<const int8_t*>(a.w0) +
                                          (size_t)l * F * F,
                                      S0, F, c, F);
#pragma unroll
          for (int i = 0; i < RG; ++i)
            T[(size_t)(c0 + i0 + i) * F + c] = acc[i] * s_dis[c0 + i0 + i];
        }
        __syncthreads();
      }
    } else {
      for (int c = col; c < F; c += CB) {
        if (a.conv == GCN) {
          if constexpr (MODE != INT8) {
            for (int r0 = rA0; r0 < rA0 + BB / GROUPS; r0 += VT) {
              float acc[VT];
#pragma unroll
              for (int i = 0; i < VT; ++i) acc[i] = 0.f;
              dot_rows<VT, RND>(acc, H, F, r0, W0, F, c, F);
#pragma unroll
              for (int i = 0; i < VT; ++i)
                T[(size_t)(r0 + i) * F + c] = acc[i] * s_dis[r0 + i];
            }
          }
        } else {
          const float ope = 1.f + a.eps[l];
          for (int r = rA0; r < rA0 + BB / GROUPS; ++r) {
            const float s =
                agg_row<RND>(ent, s_ptr[r], s_ptr[r + 1], H, F, c);
            // two roundings, as the plain version (no fused multiply-add:
            // an ulp before a bf16 rounding or a quantization moves it)
            const float t = a.conv == GIN
                ? __fadd_rn(__fmul_rn(ope, H[(size_t)r * F + c]), s)
                : s / s_den[r];
            T[(size_t)r * F + c] = RND ? bf16r(t) : t;   // feeds W0 only
          }
        }
      }
      __syncthreads();
    }

    if (a.conv == GCN) {   // o = dis (A p + p) + b0, in place per element
      for (int c = col; c < F; c += CB) {
        const float b = B0[c];
        for (int r = rA0; r < rA0 + BB / GROUPS; ++r) {
          const float s = agg_row<RND>(ent, s_ptr[r], s_ptr[r + 1], T, F, c);
          float o = s_dis[r] * (s + T[(size_t)r * F + c]) + b;
          if (skip) o += H[(size_t)r * F + c];
          H[(size_t)r * F + c] = act_fn(o, a.act);
        }
      }
      __syncthreads();
      continue;
    }

    for (int c0 = 0; c0 < BB; c0 += R) {
      if constexpr (MODE == INT8) {   // levels of the chunk's T (and h)
        gnnb_quant::quantize_rows<THREADS>(T + (size_t)c0 * F, F, R, Q0,
                                           sq0);
        if (a.conv == SAGE)
          gnnb_quant::quantize_rows<THREADS>(H + (size_t)c0 * F, F, R, Q1,
                                             sq1);
        __syncthreads();
      }
      // Z = gin relu(T W0 + b0) | sage T W0 + b0 + h W1, for the chunk
      for (int c = col; c < F; c += CB) {
        float acc[RG];
        const float b = B0[c];
        if constexpr (MODE == INT8) {
          const int8_t* Q0w = static_cast<const int8_t*>(a.w0) +
                              (size_t)l * F * F;
          gnnb_quant::qdot_scaled<RG>(acc, Q0, F, sq0, i0, Q0w, S0, F, c, F);
#pragma unroll
          for (int i = 0; i < RG; ++i) acc[i] += b;
          if (a.conv == SAGE) {
            float acc1[RG];
            gnnb_quant::qdot_scaled<RG>(
                acc1, Q1, F, sq1, i0,
                static_cast<const int8_t*>(a.w1) + (size_t)l * F * F, S1, F,
                c, F);
#pragma unroll
            for (int i = 0; i < RG; ++i) acc[i] += acc1[i];
          }
        } else {
#pragma unroll
          for (int i = 0; i < RG; ++i) acc[i] = 0.f;
          dot_rows<RG>(acc, T, F, c0 + i0, W0, F, c, F);
          if (a.conv == SAGE)
            dot_rows<RG, RND>(acc, H, F, c0 + i0, W1, F, c, F);
#pragma unroll
          for (int i = 0; i < RG; ++i) acc[i] += b;
        }
#pragma unroll
        for (int i = 0; i < RG; ++i) {
          const float z = a.conv == GIN ? fmaxf(acc[i], 0.f) : acc[i];
          // gin's Z feeds W1 only: stored rounded in BF16
          Z[(i0 + i) * F + c] = RND && a.conv == GIN ? bf16r(z) : z;
        }
      }
      __syncthreads();
      if (MODE == INT8 && a.conv == GIN) {   // Z's levels
        gnnb_quant::quantize_rows<THREADS>(Z, F, R, Q0, sq0);
        __syncthreads();
      }
      // h = act(o [+ h]); gin o = Z W1 + b1, sage o = Z
      for (int c = col; c < F; c += CB) {
        float acc[RG];
        if (a.conv == GIN) {
          if constexpr (MODE == INT8) {
            gnnb_quant::qdot_scaled<RG>(
                acc, Q0, F, sq0, i0,
                static_cast<const int8_t*>(a.w1) + (size_t)l * F * F, S1, F,
                c, F);
          } else {
#pragma unroll
            for (int i = 0; i < RG; ++i) acc[i] = 0.f;
            dot_rows<RG>(acc, Z, F, i0, W1, F, c, F);
          }
          const float b = B1[c];
#pragma unroll
          for (int i = 0; i < RG; ++i) acc[i] += b;
        } else {
#pragma unroll
          for (int i = 0; i < RG; ++i) acc[i] = Z[(i0 + i) * F + c];
        }
#pragma unroll
        for (int i = 0; i < RG; ++i) {
          const size_t e = (size_t)(c0 + i0 + i) * F + c;
          float o = acc[i];
          if (skip) o += H[e];
          H[e] = act_fn(o, a.act);
        }
      }
      __syncthreads();
    }
  }

  if (ht_smem) {
    float4* os = reinterpret_cast<float4*>(a.out + row0 * F);
    const float4* hs = reinterpret_cast<const float4*>(H);
    for (int i = tid; i < BB * F / 4; i += THREADS) os[i] = hs[i];
  }
}

// Dynamic shared memory of a launch with R chunk rows, H and T in shared
// memory or not, in `mode`.
size_t smem_bytes(int R, int F, bool ht_smem, int mode) {
  return ((ht_smem ? 2 * (size_t)BB * F : 0) + (size_t)R * F) *
             sizeof(float) +
         (size_t)MAX_NNZ * sizeof(int) +
         (mode == INT8 ? 2 * (size_t)R * F : 0);
}

// The kernel's static shared memory in `mode`.
size_t static_smem(int R, int mode) {
  return STATIC_SMEM + (mode == INT8 ? 2 * R : 1) * sizeof(float);
}

template <int R, int MODE>
cudaError_t launch(const StackArgs& a, bool ht_smem, cudaStream_t s) {
  const size_t smem = smem_bytes(R, a.F, ht_smem, MODE);
  cudaError_t err = cudaFuncSetAttribute(
      mp_block_stack_kernel<R, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mp_block_stack_kernel<R, MODE><<<a.n_rows / BB, THREADS, smem, s>>>(
      a, ht_smem ? 1 : 0);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_fit(const StackArgs& a, size_t optin, bool has_scratch,
                       cudaStream_t s) {
  const int F = a.F;
  auto fits = [&](int R, bool ht) {
    return smem_bytes(R, F, ht, MODE) + static_smem(R, MODE) <= optin;
  };
  if (fits(32, true)) return launch<32, MODE>(a, true, s);
  if (!has_scratch) return cudaErrorInvalidValue;
  if (fits(32, false)) return launch<32, MODE>(a, false, s);
  if (fits(16, false)) return launch<16, MODE>(a, false, s);
  if (fits(MIN_R, false)) return launch<MIN_R, MODE>(a, false, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int gnnb_mp_block_rows() { return BB; }
int gnnb_mp_block_width_multiple() { return CB; }
int gnnb_mp_block_max_layers() { return MAX_L; }

// Dynamic and static shared memory the stack needs at width F in `mode`
// with the fewest chunk rows and H, T in device memory, in bytes (the
// launcher keeps them in shared memory, with more rows, where that fits).
int gnnb_mp_block_smem_bytes(int F, int mode) {
  return (int)(smem_bytes(MIN_R, F, false, mode) + static_smem(MIN_R, mode));
}

// Whether a launch at width F in `mode` keeps H and T in shared memory
// (1) or in device memory (0) on `device`; -1 on a CUDA error.
int gnnb_mp_block_ht_in_smem(int F, int mode, int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return smem_bytes(32, F, true, mode) + static_smem(32, mode) <=
                 (size_t)optin
             ? 1
             : 0;
}

// Launches the stack on `stream` of `device`; n_rows % 128 == 0 and
// F % 128 == 0, all arrays contiguous as documented in
// ops/cuda/mp_block.py; `scratch` ([N, F] f32) is read only when H and T
// do not fit shared memory.  conv: 0 gcn, 1 gin, 2 sage; mode: 0 f32,
// 1 bf16 (w0, w1 bfloat16), 2 int8 (w0, w1 int8 with column scales sw0,
// sw1 [L, F]).  Returns the cudaError_t of the launch (0 = success).
int gnnb_mp_block_stack(const void* x, const void* adj, const void* deg,
                        int n_rows, int F, const void* w0, const void* b0,
                        const void* w1, const void* b1, int n_layers,
                        int conv, const float* epss, const int* skips,
                        int act, int mode, const void* sw0, const void* sw1,
                        void* out, void* scratch, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_layers < 1 || n_layers > MAX_L || n_rows % BB != 0 || F % CB ||
      F < CB || conv < GCN || conv > SAGE || mode < F32 || mode > INT8 ||
      (mode == INT8 && (sw0 == nullptr || sw1 == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  StackArgs a;
  a.x = (const float*)x;
  a.adj = (const float*)adj;
  a.deg = (const int*)deg;
  a.w0 = w0;
  a.b0 = (const float*)b0;
  a.w1 = w1;
  a.b1 = (const float*)b1;
  a.sw0 = (const float*)sw0;
  a.sw1 = (const float*)sw1;
  a.out = (float*)out;
  a.scratch = (float*)scratch;
  a.n_rows = n_rows;
  a.F = F;
  a.L = n_layers;
  a.conv = conv;
  a.act = act;
  for (int l = 0; l < MAX_L; ++l) {
    a.eps[l] = l < n_layers ? epss[l] : 0.f;
    a.skip[l] = l < n_layers ? skips[l] : 0;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const bool has_scratch = scratch != nullptr;
  if (mode == BF16)
    return (int)launch_fit<BF16>(a, (size_t)optin, has_scratch, s);
  if (mode == INT8)
    return (int)launch_fit<INT8>(a, (size_t)optin, has_scratch, s);
  return (int)launch_fit<F32>(a, (size_t)optin, has_scratch, s);
}

}  // extern "C"
