// Device code shared by the GAT kernels (gat_layer.cu, gat_block.cu,
// gat_bwd.cu): the tensor-core projection, the warp reductions and the
// epilogue activations.
//
// The projection computes, for every row r of x [N, Fin] and every head
// hd of H heads of C channels (HC = H * C):
//
//   h[r]          = x[r] W                        (W [Fin, HC], row-major)
//   a_src[r, hd]  = h[r, hd*C : (hd+1)*C] . att_src[hd]
//   a_dst[r, hd]  = h[r, hd*C : (hd+1)*C] . att_dst[hd]
//
// It is the part of the TPU kernels' bodies that computes h = x W in VMEM
// (gat_layer.py's proj, gat_block.py's h_scr).  2 Fin HC flops a row
// against ~4 (Fin + HC) bytes: the products bound both kernels, so they
// run on the tensor cores with mma.sync (mma_ring.cuh).
//
// Geometry.  A CTA takes 128 rows and one head, in column chunks of CW =
// 64 (C <= 64) or 128 columns; a head wider than 128 takes
// ceil(C / 128) chunks in turn, each chunk's pad columns zero.  256
// threads: 8 warps in a 4 x 2 grid, each owning 32 rows x CW / 2 columns
// of the chunk (two m16 tiles by CW / 16 n8 tiles).  The weights of
// every (head, chunk) region are laid out once on the host
// (ops/cuda/gat_layer.py stage_projection) in the order the warps read
// them: per k-step, pairs of n8 tiles in mma B fragment order (16 bytes
// per lane per pair; in f32 a pair's TF32 hi half, then its lo half), k
// padded to a multiple of 32 with zero rows.  Thread 0 streams a
// region's tiles (32 k each) with cp.async.bulk through a ring of S
// stages, each guarded by a full mbarrier, S - 1 tiles ahead: a stage is
// refilled once every warp has passed the barrier that follows its last
// read of it (having fenced the async proxy), so there are no empty
// barriers and no producer warp (a ninth warp had capped ptxas at 168
// registers a thread, and it spilled).  Each CTA reads its head's weights
// once, and every weight feeds 128 rows.  x
// is staged by all threads 32 k at a time into two alternating buffers
// with cp.async (the next chunk's copies are in flight during the current
// chunk's products, and hold no registers); rows past N and k past Fin
// are zero-filled, so any Fin works (the first layer has 11).
//
// Modes (quant.cuh Mode, a template argument):
// * F32: split TF32 in three passes, hi*hi + hi*lo + lo*hi, summed in
//   f32 (hi = tf32(v), lo = tf32(v - hi)); the weights come split from
//   the host (split_tf32), x is split where its fragments are loaded.
//   The tensor cores truncate a chain's running sum, so each k-step
//   (F32) or tile (BF16) is a chain of its own from zero, added into the
//   f32 accumulator with an IEEE add (chunk_product).
// * BF16 (inference): x rounded to bf16 where its fragments are loaded,
//   bfloat16 W, f32 sums (the JAX kernels' _dot_mm("bf16")).  The logit
//   halves stay f32 dots of h with att (gat_layer.py), unless the region
//   carries the logit tile: then a_src = x . wa_src and a_dst = x .
//   wa_dst are two more MMA columns of the same pass (an n8 tile after
//   each k-step's pairs: wa_src[:, hd], wa_dst[:, hd], six zero
//   columns; wa = bf16(bf16(W) A) from the wrapper), the order in which
//   gat_block.py forms them (x @ (W @ A_src), both products in bf16).  In
//   float32 the two orders agree to an ulp; in bf16 they do not, and the
//   difference goes through exp.
// * INT8 (inference): each row is quantized once with its own scale
//   (gat_layer.cu's quantize_rows_kernel: quant.cuh quant_scale and
//   quant_level over the whole row, into levels padded to the tiles' k),
//   W is int8 with per-column scales: h = (float)(exact s32 sum of s8 x
//   s8 MMAs) * s_row * s_col (the JAX kernels' _qdot).  A row gets the
//   same scale as a receiver and as a neighbour, since h is formed once
//   per row.  The logit halves are f32 dots of h with att.
// The logit dots are summed per lane over its columns, then across the
// four lanes of a row and the two column warps, then across chunks, in a
// fixed order: two runs give the same bits.
//
// The kernels and launchers here are static, so each source that includes
// this header gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dense_rows.cuh"
#include "mma_ring.cuh"

namespace gnnb_gat {

using gnnb_dense::act_fn;    // act: 0 none, 1 relu, 2 gelu, 3 sigmoid, 4 tanh
using gnnb_dense::THREADS;   // threads of the attention and backward CTAs
using gnnb_quant::BF16;
using gnnb_quant::F32;
using gnnb_quant::INT8;

constexpr int WARPS = THREADS / 32;
constexpr float BIG = 3e38f;          // the TPU kernels' finite -inf

__device__ __forceinline__ float lrelu(float z, float ns) {
  return z >= 0.f ? z : ns * z;
}

// Butterfly reductions over a full warp: every lane ends with the same
// bits (each step adds the same two values in either order).
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

static __host__ cudaError_t optin_bytes(int device, size_t* out) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *out = (size_t)optin;
  return err;
}

// ------------------------------------------------ the tensor-core projection

constexpr int BM = 128;                // rows of x per CTA
constexpr int KC = 32;                 // k per staged x chunk = per tile
constexpr int ROW_WARPS = 4;           // warps: 4 row groups
constexpr int COL_WARPS = 2;           //   x 2 column groups
constexpr int CWARPS = ROW_WARPS * COL_WARPS;
constexpr int TC_THREADS = CWARPS * 32;
constexpr int LOGIT_BYTES = 256;       // the bf16 logit tile of a k-step

// k depth of one mma; k-steps per tile
template <int MODE> __host__ __device__ constexpr int kdepth() {
  return MODE == F32 ? 8 : MODE == BF16 ? 16 : 32;
}
template <int MODE> __host__ __device__ constexpr int ksteps() {
  return KC / kdepth<MODE>();
}
// B fragments of one pair of n8 tiles for one k-step (f32: hi, then lo)
template <int MODE> __host__ __device__ constexpr int pair_bytes() {
  return MODE == F32 ? 1024 : 512;
}
// one k-step of a region of 64 NP columns, with the logit tile (LOGIT)
template <int MODE, int NP, bool LOGIT>
__host__ __device__ constexpr int kstep_bytes() {
  return 4 * NP * pair_bytes<MODE>() + (LOGIT ? LOGIT_BYTES : 0);
}
template <int MODE, int NP, bool LOGIT>
__host__ __device__ constexpr int tile_bytes() {
  return ksteps<MODE>() * kstep_bytes<MODE, NP, LOGIT>();
}
template <int MODE> __host__ __device__ constexpr int stages() {
  return MODE == F32 ? 3 : 4;
}
// one staged x chunk: f32 values (F32, BF16) or int8 levels (INT8)
template <int MODE> __host__ __device__ constexpr int xchunk_bytes() {
  return BM * KC * (MODE == INT8 ? 1 : 4);
}
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Shared-memory carve-up (byte offsets) of a projection CTA: the ring and
// the two x chunks, which a kernel may overlay with OVL_MIN bytes of its
// own once the products are done, then the row scales (INT8), the logit
// partials of the column warps, the logit halves and the barriers.
template <int MODE, int NP, bool LOGIT, int OVL_MIN> struct ProjSmem {
  static constexpr int TB = tile_bytes<MODE, NP, LOGIT>();
  static constexpr int S = stages<MODE>();
  static constexpr int RING = 0;
  static constexpr int X = RING + S * TB;
  static constexpr int OVL = cmax(X + 2 * xchunk_bytes<MODE>(), OVL_MIN);
  static constexpr int SQ = (OVL + 127) / 128 * 128;    // [BM] f32
  static constexpr int PART = SQ + BM * 4;   // [2][COL_WARPS][BM] f32
  static constexpr int AS = PART + 2 * COL_WARPS * BM * 4;   // [BM] f32
  static constexpr int AD = AS + BM * 4;                 // [BM] f32
  static constexpr int BAR = AD + BM * 4;   // full[S]
  static constexpr int END = BAR + S * 8;
};

// this thread's ordinary accesses of shared memory come before the async
// proxy's next writes there (a bulk copy into a ring stage)
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int MODE> struct AccOf { using T = float; };
template <> struct AccOf<INT8> { using T = int; };

// A warp's share of a chunk as mma C fragments: v[mt][n][2 hh +
// i] is chunk row 32 wr + 16 mt + g + 8 hh, column 32 NP wc + 8 n + 2 t +
// i (g = lane / 4, t = lane % 4); l[mt] the logit tile's (columns 0, 1:
// a_src, a_dst), kept by the warps of column group 0.
template <int MODE, int NP> struct Acc {
  using T = typename AccOf<MODE>::T;
  T v[2][4 * NP][4];
  T l[2][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int n = 0; n < 4 * NP; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) v[mt][n][i] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) l[mt][i] = 0;
    }
  }
};

// Calls f(mt, n, hh, r, c) for each pair of accumulators v[mt][n][2 hh],
// v[mt][n][2 hh + 1] at chunk row r and columns c, c + 1.
template <int NP, typename Fn>
__device__ __forceinline__ void each_pair(int wr, int wc, int lane, Fn f) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < 4 * NP; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        f(mt, n, hh, 32 * wr + 16 * mt + g + 8 * hh,
          32 * NP * wc + 8 * n + 2 * t);
}

// ------------------------------------------------------ the x chunks

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// The A operand's source: f32 x [N, Fin] (F32, BF16), or under INT8 the
// levels q [rows padded to 128, Kp] of quantize_rows_kernel (k past Fin
// zero).
struct XSrc {
  const float* x;
  const int8_t* q;
  int n_rows, Fin, Kp;
  bool vec4;   // Fin % 4 == 0 and x 16-byte aligned: 16-byte copies
};

// Issues the copies of chunk kc (k in [32 kc, 32 kc + 32)) of the CTA's
// 128 rows into X, by this thread, with cp.async (no registers
// held over the products): f32 rows swizzled (mma_ring.cuh at), rows past
// N and k past Fin zero-filled; int8 levels at a 32-byte row stride (a
// half-warp's fragment loads cover 128 contiguous bytes).  Then commits.
template <int MODE>
__device__ __forceinline__ void stage_chunk(const XSrc& src, int row0,
                                            int kc, unsigned char* X,
                                            int tid) {
  const uint32_t xs = gnnb_mma::smem_addr(X);
  if constexpr (MODE == INT8) {
    const int r = tid >> 1, half = tid & 1;   // 256 copies of 16 bytes
    cp_async16(xs + r * KC + 16 * half,
               src.q + (size_t)(row0 + r) * src.Kp + kc * KC + 16 * half,
               true);
  } else if (src.vec4) {
#pragma unroll
    for (int i = 0; i < BM * KC / 4 / TC_THREADS; ++i) {
      const int e = tid + TC_THREADS * i, r = e / (KC / 4);
      const int k = 4 * (e % (KC / 4)), row = row0 + r, kk = kc * KC + k;
      const bool ok = row < src.n_rows && kk < src.Fin;
      cp_async16(xs + 4 * gnnb_mma::at(r, k, KC),
                 ok ? src.x + (size_t)row * src.Fin + kk : src.x, ok);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BM * KC / TC_THREADS; ++i) {
      const int e = tid + TC_THREADS * i, r = e / KC, k = e % KC;
      const int row = row0 + r, kk = kc * KC + k;
      const bool ok = row < src.n_rows && kk < src.Fin;
      cp_async4(xs + 4 * gnnb_mma::at(r, k, KC),
                ok ? src.x + (size_t)row * src.Fin + kk : src.x, ok);
    }
  }
  cp_async_commit();
}

// BF16: acc += the chunk's product as a sum of its own: each n8 tile's
// two k-steps are one chain of two MMAs from zero, added into acc with an
// IEEE f32 add.  The tensor cores normalise a chain's running sum by
// truncation, so a chain over all of Fin drifts below the f32 sum (the
// plain version's), and in bf16 every such difference can move a weight
// or a gathered h across a bf16 rounding boundary.
template <int NP, bool LOGIT>
__device__ __forceinline__ void chunk_product_bf16(Acc<BF16, NP>& acc,
                                                   const unsigned char* X,
                                                   const unsigned char* tile,
                                                   int wr, int wc, int lane) {
  constexpr int KSB = kstep_bytes<BF16, NP, LOGIT>();
  constexpr int PB = pair_bytes<BF16>();
  static_assert(ksteps<BF16>() == 2, "two k-steps a tile");
  const int g = lane >> 2, t = lane & 3;
  const float* Af = reinterpret_cast<const float*>(X);
  uint32_t a[2][2][4];   // [k-step][mt]
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r0 = 32 * wr + 16 * mt + g, r1 = r0 + 8, k0 = 16 * ks;
      const float4 y0 = *reinterpret_cast<const float4*>(
          Af + gnnb_mma::at(r0, k0 + 4 * t, KC));
      const float4 y1 = *reinterpret_cast<const float4*>(
          Af + gnnb_mma::at(r1, k0 + 4 * t, KC));
      a[ks][mt][0] = gnnb_mma::pack_bf16(y0.x, y0.y);
      a[ks][mt][1] = gnnb_mma::pack_bf16(y1.x, y1.y);
      a[ks][mt][2] = gnnb_mma::pack_bf16(y0.z, y0.w);
      a[ks][mt][3] = gnnb_mma::pack_bf16(y1.z, y1.w);
    }
  const uint4* b0p =
      reinterpret_cast<const uint4*>(tile + wc * 2 * NP * PB) + lane;
  const uint4* b1p =
      reinterpret_cast<const uint4*>(tile + KSB + wc * 2 * NP * PB) + lane;
#pragma unroll
  for (int np = 0; np < 2 * NP; ++np) {
    const uint4 b0 = b0p[np * (PB / 16)], b1 = b1p[np * (PB / 16)];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
      gnnb_mma::mma_bf16(p0, a[0][mt], b0.x, b0.y);
      gnnb_mma::mma_bf16(p0, a[1][mt], b1.x, b1.y);
      gnnb_mma::mma_bf16(p1, a[0][mt], b0.z, b0.w);
      gnnb_mma::mma_bf16(p1, a[1][mt], b1.z, b1.w);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc.v[mt][2 * np][i] = __fadd_rn(acc.v[mt][2 * np][i], p0[i]);
        acc.v[mt][2 * np + 1][i] = __fadd_rn(acc.v[mt][2 * np + 1][i], p1[i]);
      }
    }
  }
  if constexpr (LOGIT) {
    if (wc == 0) {
      const uint2 q0 = reinterpret_cast<const uint2*>(tile + 4 * NP * PB)[lane];
      const uint2 q1 =
          reinterpret_cast<const uint2*>(tile + KSB + 4 * NP * PB)[lane];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        gnnb_mma::mma_bf16(p, a[0][mt], q0.x, q0.y);
        gnnb_mma::mma_bf16(p, a[1][mt], q1.x, q1.y);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc.l[mt][i] = __fadd_rn(acc.l[mt][i], p[i]);
      }
    }
  }
}

// F32, INT8: acc += the staged chunk X (32 k) times the ring tile's
// weights (BF16: chunk_product_bf16).  In F32 each k-step's three TF32
// passes are a chain from zero added into acc with an IEEE add, for the
// reason chunk_product_bf16 gives (a chain over all of Fin sat ~5e-6 of
// max off the f32 sums, which moved leaky-ReLU and ReLU decisions near 0
// against the float64 reference of the train step's gradient gate).  The A fragments follow the staged
// weights' k order (gat_layer.py stage_projection,
// pna_block._fragment_index): a lane reads 2E consecutive k of its rows
// (E = 1, 2, 4 values a register).
template <int MODE, int NP, bool LOGIT>
__device__ __forceinline__ void chunk_product(Acc<MODE, NP>& acc,
                                              const unsigned char* X,
                                              const unsigned char* tile,
                                              int wr, int wc, int lane) {
  if constexpr (MODE == BF16) {
    chunk_product_bf16<NP, LOGIT>(acc, X, tile, wr, wc, lane);
  } else {
    static_assert(!LOGIT, "the logit tile is a bf16 tile");
    constexpr int KS = kdepth<MODE>();
    constexpr int KSB = kstep_bytes<MODE, NP, LOGIT>();
    constexpr int PB = pair_bytes<MODE>();
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < ksteps<MODE>(); ++ks) {
      const int k0 = ks * KS;
      uint32_t a[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r0 = 32 * wr + 16 * mt + g, r1 = r0 + 8;
        if constexpr (MODE == F32) {
          const float* Af = reinterpret_cast<const float*>(X);
          const float2 x0 = *reinterpret_cast<const float2*>(
              Af + gnnb_mma::at(r0, k0 + 2 * t, KC));
          const float2 x1 = *reinterpret_cast<const float2*>(
              Af + gnnb_mma::at(r1, k0 + 2 * t, KC));
          const float v[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[mt][i] = gnnb_mma::tf32(v[i]);
            al[mt][i] =
                gnnb_mma::tf32(__fsub_rn(v[i], __uint_as_float(a[mt][i])));
          }
        } else {
          const uint2 z0 =
              *reinterpret_cast<const uint2*>(X + r0 * KC + 8 * t);
          const uint2 z1 =
              *reinterpret_cast<const uint2*>(X + r1 * KC + 8 * t);
          a[mt][0] = z0.x;
          a[mt][1] = z1.x;
          a[mt][2] = z0.y;
          a[mt][3] = z1.y;
        }
      }
      // this warp's 2 NP pairs of n8 tiles
      const uint4* bp = reinterpret_cast<const uint4*>(
                            tile + ks * KSB + wc * 2 * NP * PB) + lane;
#pragma unroll
      for (int np = 0; np < 2 * NP; ++np) {
        const uint4 b = bp[np * (PB / 16)];
        uint4 bl;
        if constexpr (MODE == F32) bl = bp[np * (PB / 16) + 32];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if constexpr (MODE == F32) {   // a k-step's chain from zero
            float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
            gnnb_mma::mma_3xtf32(p0, a[mt], al[mt], b.x, b.y, bl.x, bl.y);
            gnnb_mma::mma_3xtf32(p1, a[mt], al[mt], b.z, b.w, bl.z, bl.w);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc.v[mt][2 * np][i] = __fadd_rn(acc.v[mt][2 * np][i], p0[i]);
              acc.v[mt][2 * np + 1][i] =
                  __fadd_rn(acc.v[mt][2 * np + 1][i], p1[i]);
            }
          } else {
            gnnb_mma::mma_s8(acc.v[mt][2 * np], a[mt], b.x, b.y);
            gnnb_mma::mma_s8(acc.v[mt][2 * np + 1], a[mt], b.z, b.w);
          }
        }
      }
    }
  }
}

// The weight ring: S stages of TB bytes at `base`, stage s guarded by
// the full mbarrier at full + 8 s (one arrival, thread 0's expect_tx).
// Tile i of the CTA's stream (counted over its regions) is the (i /
// S)-th fill of stage i % S.
template <int S, int TB> struct TileRing {
  unsigned char* base;
  uint32_t full;
  __device__ __forceinline__ void issue(const unsigned char* src,
                                        int i) const {
    const int s = i % S;
    gnnb_mma::mbar_expect_tx(full + 8 * s, TB);
    gnnb_mma::bulk_copy(gnnb_mma::smem_addr(base + s * TB), src, TB,
                        full + 8 * s);
  }
  __device__ __forceinline__ const unsigned char* wait(int i) const {
    gnnb_mma::mbar_wait(full + 8 * (i % S), (i / S) & 1);
    return base + (i % S) * TB;
  }
};

template <int S>
__device__ __forceinline__ void init_ring(uint32_t full) {
  for (int s = 0; s < S; ++s) gnnb_mma::mbar_init(full + 8 * s, 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One region (a head's chunk of CW columns): acc = x[row0 .. row0 + 128)
// . W over the region's nk tiles of 32 k at `wreg`; `it` counts the
// CTA's tiles and advances by nk.  Xb holds the two x chunks: chunk kc +
// 1 is copied in while chunk kc feeds the products.  Called by every
// thread after a barrier (the ring's and Xb's bytes free, fenced); ends
// with a fence and a barrier, after which they may be reused.
template <int MODE, int NP, bool LOGIT, int S, int TB>
__device__ __forceinline__ void project(Acc<MODE, NP>& acc, const XSrc& src,
                                        int row0, int nk, unsigned char* Xb,
                                        const TileRing<S, TB>& ring,
                                        const unsigned char* wreg, int& it,
                                        int tid) {
  constexpr int XB = xchunk_bytes<MODE>();
  const int warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 3, wc = warp >> 2;
  acc.zero();
  if (tid == 0)
    for (int i = 0; i < S && i < nk; ++i)
      ring.issue(wreg + (size_t)i * TB, it + i);
  stage_chunk<MODE>(src, row0, 0, Xb, tid);
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait_all();
    fence_async();   // this thread's reads of tile kc - 1's stage
    __syncthreads();   // x chunk kc in; tile kc - 1, x chunk kc - 1 free
    if (tid == 0 && kc >= 1 && kc - 1 + S < nk)
      ring.issue(wreg + (size_t)(kc - 1 + S) * TB, it + kc - 1 + S);
    if (kc + 1 < nk)
      stage_chunk<MODE>(src, row0, kc + 1, Xb + ((kc + 1) & 1) * XB, tid);
    chunk_product<MODE, NP, LOGIT>(acc, Xb + (kc & 1) * XB,
                                   ring.wait(it + kc), wr, wc, lane);
  }
  fence_async();
  __syncthreads();
  it += nk;
}

// The logit partials of this warp's columns of the chunk: for each of its
// rows, sum_c h[r, c] att_src[c] over the valid columns (c < cw), reduced
// over the row's four lanes, into part[0][wc][r] (src) and part[1][wc][r]
// (dst).  hv(mt, n, i) gives the accumulator as f32.
template <int NP, typename HV>
__device__ __forceinline__ void logit_partials(HV hv, const float* as,
                                               const float* ad, int cw,
                                               float* part, int wr, int wc,
                                               int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float s = 0.f, d = 0.f;
#pragma unroll
      for (int n = 0; n < 4 * NP; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = 32 * NP * wc + 8 * n + 2 * t + i;
          if (c < cw) {
            const float v = hv(mt, n, 2 * hh + i);
            s += v * __ldg(as + c);
            d += v * __ldg(ad + c);
          }
        }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      if (t == 0) {
        const int r = 32 * wr + 16 * mt + g + 8 * hh;
        part[wc * BM + r] = s;
        part[(COL_WARPS + wc) * BM + r] = d;
      }
    }
}

// After a barrier: the logit halves of row i (< BM) summed over the
// column warps, added to what earlier chunks of the head gave (first:
// the head's first chunk).
__device__ __forceinline__ void sum_partials(const float* part, float* AS,
                                             float* AD, int i, bool first) {
  float s = first ? 0.f : AS[i], d = first ? 0.f : AD[i];
#pragma unroll
  for (int w = 0; w < COL_WARPS; ++w) {
    s += part[w * BM + i];
    d += part[(COL_WARPS + w) * BM + i];
  }
  AS[i] = s;
  AD[i] = d;
}

// The chunk width, chunks per head and 32-k tiles of a projection.
__host__ __forceinline__ int chunk_cols(int C) { return C <= 64 ? 64 : 128; }
__host__ __forceinline__ int n_chunks(int C) {
  return (C + chunk_cols(C) - 1) / chunk_cols(C);
}
__host__ __forceinline__ int n_ktiles(int Fin) { return (Fin + KC - 1) / KC; }

// Bytes of the staged weights of H heads (stage_projection's layout).
static __host__ size_t staged_bytes(int mode, int Fin, int H, int C,
                                    bool logit) {
  const int np = chunk_cols(C) / 64;
  int tb;
  if (mode == F32)
    tb = np == 1 ? tile_bytes<F32, 1, false>() : tile_bytes<F32, 2, false>();
  else if (mode == BF16)
    tb = np == 1 ? (logit ? tile_bytes<BF16, 1, true>()
                          : tile_bytes<BF16, 1, false>())
                 : (logit ? tile_bytes<BF16, 2, true>()
                          : tile_bytes<BF16, 2, false>());
  else
    tb = np == 1 ? tile_bytes<INT8, 1, false>() : tile_bytes<INT8, 2, false>();
  return (size_t)H * n_chunks(C) * n_ktiles(Fin) * tb;
}

// Registers, shared memory and resident CTAs per SM of a kernel instance.
template <typename K>
static __host__ cudaError_t kernel_info(K kernel, int smem, int* regs,
                                        int* smem_bytes, int* ctas_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *smem_bytes = (int)a.sharedSizeBytes + smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel,
                                                       TC_THREADS, smem);
}

}  // namespace gnnb_gat
