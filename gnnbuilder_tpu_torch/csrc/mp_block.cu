// Whole GCN, GIN or SAGE conv stack on a block-packed batch, one CTA per
// 128-row block, its products on the tensor cores.
//
// Replaces: gnnbuilder_tpu/ops/pallas/mp_block.py mp_block_stack (kernel
// body _kernel).  Per layer l, for every node row r of the block, with A
// the block's [128, 128] adjacency counts (A[i, j] = edges j -> i):
//
//   gcn   p = (h W0) * dis;           o = dis * (A p + p) + b0
//   gin   o = relu(((1 + eps) h + A h) W0 + b0) W1 + b1
//   sage  o = (A h / max(deg, 1)) W0 + h W1 + b0
//
//   h = act(o [+ h])                   (skip added before the activation)
//
// with dis = 1 / sqrt(deg + 1) (the self loop added analytically).  Every
// width is one F, a multiple of 128 (the caller zero-pads, as the TPU
// kernel's caller does).
//
// What bounds it on the H100: operations.  At F = 128 the products cost
// 2 F^2 flops per row and product (gcn 1, gin and sage 2 a layer) against
// ~1 KB of row data in and out once for the whole stack.  They run on the
// tensor cores with mma.sync (m16n8k8 tf32 split in three passes, m16n8k16
// bf16, m16n8k32 s8), and so does the aggregation (tf32, below).
//
// Design.  No graph crosses a 128-row block, so a CTA owns its block's
// whole problem for all L layers.  288 threads: 8 consumer warps in a
// 4 x 2 grid, each owning 32 rows x 64 columns of every [128, 128]
// product tile (64 accumulators a thread), and one producer warp.  The
// wrapper lays the weights out once (ops/cuda/mp_block.py stage_mp_stack:
// per layer W0 then W1, each cut into 128-column tiles and k-steps in the
// order of the mma B fragments; f32 pre-split into TF32 halves); the
// producer streams the tiles a layer multiplies, in the order the
// consumers take them, with cp.async.bulk into a 2-stage ring guarded by
// full and empty mbarriers (mma_ring.cuh), so the weights reach shared
// memory once per block and layer.  The block's adjacency counts are
// read once per CTA into shared memory and every layer's aggregation (A p,
// A h) is a tensor-core product too, A as the m16n8k8 A operand (counts
// exact in tf32 up to 2048; above that a third pass takes A's remainder)
// and the aggregated rows as B, split into TF32 halves where their
// fragments are loaded (bf16: rounded to bf16, one pass); the k-steps
// whose 32 x 8 tile of A is zero are skipped (a QM9 block is ~97 %
// zeros).  Walked on the CUDA cores over compacted neighbour lists, one
// column of 64 rows a thread, the aggregation took two thirds of a GCN
// layer's time (PERF.md).  Its sums are then f32 chains per k-step, as
// the products', not sums in neighbour order.  INT8 keeps that walk
// (block_lists.cuh's lists, in neighbour order, in the adjacency's
// place): its aggregate is quantized next, and a sum an ulp off the
// plain version's moved a level (5.2e-3 of max in a GIN layer, over the
// mode's 5e-3).
//
// Buffers.  At F = 128 (template SM) the hidden state H and the per-layer
// buffer T (gcn's p, gin's aggregate then its Z, sage's mean) sit in shared
// memory, swizzled (mma_ring.cuh at / atb): no Z buffer, since gin's Z
// overwrites T once every warp has read T (its accumulators hold the tile),
// and sage's new h overwrites H the same way.  Shared memory (bytes): ring 2
// x 16,384 (f32), 2 x 8,192 (bf16), 2 x 4,096 (int8); H and T 65,536 each;
// int8 levels 16,384; the adjacency (int8: the lists) 65,536; row tables and
// masks 2,576: f32 230,992 of the card's 232,448.  That holds one CTA per SM,
// so the b1024 batch's 160 blocks run as 132 then 28 (PERF.md has the tail's
// measured cost).  Wider F keeps H in `out` and T, Z and the int8 levels in
// the scratch `work`, rows of the CTA's own (L2 resident), with the same
// products reading their A fragments from there, one 128-column tile of the
// output after another; sage's new h goes to Z and is copied back.
//
// Accuracy and reproducibility.  Each f32 tensor-core chain starts from
// zero per k-step of 8 (bf16: per 32 k) and is added into its f32
// accumulator with __fadd_rn (the tensor cores truncate a chain's running
// sum).  The epilogues use __fmul_rn / __fadd_rn: no fused multiply-add
// before a rounding or a quantization.  No float is added atomically.
//
// Modes (template argument MODE, the JAX kernel's gather_mode="bf16" with
// mm="bf16", and quant):
//   F32  (0): every product split TF32 in three passes, hi*hi + hi*lo +
//        lo*hi (hi = tf32(a), lo = tf32(a - hi)), summed in f32; weights
//        split on the host, activations where their fragments are loaded.
//   BF16 (1): bf16 weights; each layer's aggregation source (h, or gcn's
//        p) is rounded to bf16 as it is gathered, the sum float32; every
//        product rounds its activations to bf16 where their fragments are
//        loaded (h, the skip and gin's (1 + eps) h stay f32).
//   INT8 (2): every product (gcn's h W0, gin's two, sage's two) quantizes
//        its operand's rows once (quant.cuh's formulas, rintf half to
//        even) into int8 levels with one scale per row, an exact int32 sum
//        (s8 mma) times s_row * s_col; the adjacency sum stays exact.
//        sage's two products have their own row scales, so T W0 + b0 goes
//        to T (free once quantized) and h W1 adds to it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_lists.cuh"
#include "mma_ring.cuh"
#include "quant.cuh"

namespace {

using gnnb_mma::Acc;
using gnnb_mma::at;
using gnnb_mma::atb;
using gnnb_mma::bulk_copy;
using gnnb_mma::each_pair;
using gnnb_mma::mbar_expect_tx;
using gnnb_mma::mbar_init;
using gnnb_mma::mbar_wait;
using gnnb_mma::mma_3xtf32;
using gnnb_mma::mma_bf16;
using gnnb_mma::mma_s8;
using gnnb_mma::mma_tf32;
using gnnb_mma::pack_bf16;
using gnnb_mma::smem_addr;
using gnnb_mma::tf32;
using gnnb_mma::zero;

using gnnb_quant::BF16;
using gnnb_quant::bf16r;
using gnnb_quant::div_rcp;
using gnnb_quant::fast_ok;
using gnnb_quant::Recip;
using gnnb_quant::recip;
using gnnb_quant::F32;
using gnnb_quant::INT8;
using gnnb_quant::quant_scale;
using gnnb_quant::RowScale;

constexpr int BB = 128;               // rows per block = rows per CTA
static_assert(BB == gnnb::LIST_COLS, "lists cover one block row");
constexpr int NT = 128;               // columns per output tile
constexpr int CWARPS = 8;             // consumer warps
constexpr int CONSUMERS = CWARPS * 32;
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr int MAX_L = 16;
constexpr int STAGES = 2;
constexpr int SMEM_LIMIT = 232448;

enum Conv { GCN = 0, GIN = 1, SAGE = 2 };

// k depth of one mma, k-steps per ring tile, bytes of a k-step's B
// fragments over 128 columns (f32: both TF32 halves), of a tile, and of
// one staged weight
template <int MODE> __host__ __device__ constexpr int kdepth() {
  return MODE == F32 ? 8 : MODE == BF16 ? 16 : 32;
}
template <int MODE> __host__ __device__ constexpr int ksteps_per_tile() {
  return MODE == INT8 ? 1 : 2;
}
template <int MODE> __host__ __device__ constexpr int kstep_bytes() {
  return MODE == F32 ? 8192 : 4096;
}
template <int MODE> __host__ __device__ constexpr int tile_bytes() {
  return kstep_bytes<MODE>() * ksteps_per_tile<MODE>();
}
template <int MODE> __host__ __device__ constexpr int tile_k() {
  return kdepth<MODE>() * ksteps_per_tile<MODE>();
}
__host__ __device__ constexpr int weight_bytes(int mode) {
  return mode == F32 ? 8 : mode == BF16 ? 2 : 1;
}

// shared-memory carve-up, byte offsets; SM: H, T (and the int8 levels)
// in shared memory (F = 128)
template <int MODE, bool SM> struct Smem {
  static constexpr int RING = 0;
  static constexpr int H = RING + STAGES * tile_bytes<MODE>();
  static constexpr int T = H + (SM ? BB * NT * 4 : 0);
  static constexpr int Q = T + (SM ? BB * NT * 4 : 0);
  // the adjacency counts; INT8: the lists (a dense block fills them)
  static constexpr int ADJ = Q + (SM && MODE == INT8 ? BB * NT : 0);
  // k-step masks and big count; INT8: the lists' row pointers and counts
  static constexpr int PTR = ADJ + BB * BB * 4;
  static constexpr int CNT = PTR + (BB + 4) * 4;
  static constexpr int DIS = CNT + BB * 4;
  static constexpr int DEN = DIS + BB * 4;
  static constexpr int SQ = DEN + BB * 4;       // int8 row scales
  static constexpr int BAR = SQ + BB * 4;       // full, empty
  static constexpr int BYTES = BAR + 2 * STAGES * 8;
  static_assert(BYTES <= SMEM_LIMIT, "shared memory over the card's limit");
};

struct StackArgs {
  const float* x;              // [N, F]
  const float* adj;            // [N / 128, 128, 128] counts
  const int* deg;              // [N]
  const unsigned char* wst;    // stage_mp_stack's stream
  const float* b0;             // [L, F]
  const float* b1;             // [L, F]
  const float* sw0;            // [L, F] column scales of w0 (INT8)
  const float* sw1;            // [L, F] column scales of w1 (INT8)
  float* out;                  // [N, F]
  unsigned char* work;         // wide F: T, Z [N, F] f32, levels [N, F]
  int n_rows, F, L, conv, act;
  float eps[MAX_L];
  int skip[MAX_L];
};

// gelu, sigmoid, tanh: out of line, so the epilogues inline only relu
// and the identity (inlined, the three cost ~20 % of the launch at relu)
__device__ __noinline__ float act_call(float x, int act) {
  switch (act) {
    case 2: return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
    case 3: return 1.f / (1.f + expf(-x));
    default: return tanhf(x);
  }
}

__device__ __forceinline__ float act_fn(float x, int act) {
  return act == 1 ? fmaxf(x, 0.f) : act == 0 ? x : act_call(x, act);
}

// offset of (r, c) in a [128, ld] f32 (fidx) or int8 (bidx) operand:
// swizzled in shared memory, row-major in device memory
template <bool SM>
__device__ __forceinline__ int fidx(int r, int c, int ld) {
  return SM ? at(r, c, ld) : r * ld + c;
}
template <bool SM>
__device__ __forceinline__ int bidx(int r, int c, int ld) {
  return SM ? atb(r, c, ld) : r * ld + c;
}

// all consumer warps (the producer warp never joins)
__device__ __forceinline__ void cbar() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

template <int MODE>
using Ring = gnnb_mma::Ring<STAGES, tile_bytes<MODE>()>;

template <int MODE> struct AccOf { using T = float; };
template <> struct AccOf<INT8> { using T = int; };

// acc += A[rows of this warp, 0:K] . W[0:K, one 128-column tile], W
// streamed through the ring.  A's logical k of fragment slot (t, reg)
// matches the staged weights' (pna_block._fragment_index): a lane reads
// 2E consecutive k per row (E = 1, 2, 4 values per register).  F32 chains
// each k-step from zero, BF16 each tile of 32 k; both add the chain into
// acc with __fadd_rn.  INT8 sums exactly.
template <int MODE, bool SM, typename TAcc>
__device__ __forceinline__ void product(Acc<TAcc>& acc, const void* A,
                                        int lda, int K, Ring<MODE>& ring,
                                        int wr, int wc, int lane) {
  constexpr int KS = kdepth<MODE>();
  constexpr int KPT = ksteps_per_tile<MODE>();
  constexpr int KB = kstep_bytes<MODE>();
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = K / tile_k<MODE>();
  for (int kt = 0; kt < ntiles; ++kt) {
    const unsigned char* tile = ring.acquire();
    if constexpr (MODE == F32) {
      const float* Af = static_cast<const float*>(A);
#pragma unroll
      for (int ks = 0; ks < KPT; ++ks) {
        const int k0 = (kt * KPT + ks) * KS;
        uint32_t a[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r0 = 32 * wr + 16 * mt + g, r1 = r0 + 8;
          const float2 x0 = *reinterpret_cast<const float2*>(
              Af + fidx<SM>(r0, k0 + 2 * t, lda));
          const float2 x1 = *reinterpret_cast<const float2*>(
              Af + fidx<SM>(r1, k0 + 2 * t, lda));
          const float v[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[mt][i] = tf32(v[i]);
            al[mt][i] = tf32(__fsub_rn(v[i], __uint_as_float(a[mt][i])));
          }
        }
        const uint4* bp = reinterpret_cast<const uint4*>(
                              tile + ks * KB + wc * (KB / 2)) + lane;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const uint4 b = bp[np * (KB / 128)], bl = bp[np * (KB / 128) + 32];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {   // a k-step's chain from zero
            float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
            mma_3xtf32(p0, a[mt], al[mt], b.x, b.y, bl.x, bl.y);
            mma_3xtf32(p1, a[mt], al[mt], b.z, b.w, bl.z, bl.w);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[mt][2 * np][i] = __fadd_rn(acc[mt][2 * np][i], p0[i]);
              acc[mt][2 * np + 1][i] = __fadd_rn(acc[mt][2 * np + 1][i], p1[i]);
            }
          }
        }
      }
    } else if constexpr (MODE == BF16) {
      const float* Af = static_cast<const float*>(A);
      uint32_t a[2][2][4];   // [k-step][mt]
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r0 = 32 * wr + 16 * mt + g, k0 = (2 * kt + ks) * KS;
          const float4 y0 = *reinterpret_cast<const float4*>(
              Af + fidx<SM>(r0, k0 + 4 * t, lda));
          const float4 y1 = *reinterpret_cast<const float4*>(
              Af + fidx<SM>(r0 + 8, k0 + 4 * t, lda));
          a[ks][mt][0] = pack_bf16(y0.x, y0.y);
          a[ks][mt][1] = pack_bf16(y1.x, y1.y);
          a[ks][mt][2] = pack_bf16(y0.z, y0.w);
          a[ks][mt][3] = pack_bf16(y1.z, y1.w);
        }
      const uint4* b0p =
          reinterpret_cast<const uint4*>(tile + wc * (KB / 2)) + lane;
      const uint4* b1p =
          reinterpret_cast<const uint4*>(tile + KB + wc * (KB / 2)) + lane;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const uint4 b0 = b0p[np * (KB / 128)], b1 = b1p[np * (KB / 128)];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {   // a tile's chain from zero
          float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(p0, a[0][mt], b0.x, b0.y);
          mma_bf16(p0, a[1][mt], b1.x, b1.y);
          mma_bf16(p1, a[0][mt], b0.z, b0.w);
          mma_bf16(p1, a[1][mt], b1.z, b1.w);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[mt][2 * np][i] = __fadd_rn(acc[mt][2 * np][i], p0[i]);
            acc[mt][2 * np + 1][i] = __fadd_rn(acc[mt][2 * np + 1][i], p1[i]);
          }
        }
      }
    } else {
      const unsigned char* Aq = static_cast<const unsigned char*>(A);
      const int k0 = kt * KS;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r0 = 32 * wr + 16 * mt + g, r1 = r0 + 8;
        const uint2 z0 =
            *reinterpret_cast<const uint2*>(Aq + bidx<SM>(r0, k0 + 8 * t, lda));
        const uint2 z1 =
            *reinterpret_cast<const uint2*>(Aq + bidx<SM>(r1, k0 + 8 * t, lda));
        a[mt][0] = z0.x;
        a[mt][1] = z1.x;
        a[mt][2] = z0.y;
        a[mt][3] = z1.y;
      }
      const uint4* bp =
          reinterpret_cast<const uint4*>(tile + wc * (KB / 2)) + lane;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const uint4 b = bp[np * (KB / 128)];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_s8(acc[mt][2 * np], a[mt], b.x, b.y);
          mma_s8(acc[mt][2 * np + 1], a[mt], b.z, b.w);
        }
      }
    }
    ring.release(lane);
  }
}

// A product's value at (r, c): INT8 float(sum) * s_row * s_col (the JAX
// package's _qdot; sr the row's scale, sw the column scales), else the
// f32 sum.
template <int MODE, typename TAcc>
__device__ __forceinline__ float value(TAcc acc, float sr, const float* sw,
                                       int c) {
  if constexpr (MODE == INT8)
    return __fmul_rn(__fmul_rn((float)acc, sr), __ldg(sw + c));
  else
    return acc;
}

// v[mt][hh] = rowv[row] for the four rows of this lane's accumulators,
// loaded before an epilogue's stores (after them, each would wait)
__device__ __forceinline__ void own_rows(float (&v)[2][2], const float* rowv,
                                         int wr, int lane) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      v[mt][hh] = rowv[32 * wr + 16 * mt + (lane >> 2) + 8 * hh];
}

// The rows of a [128, F] f32 operand S quantized once each into Q (int8
// levels, the layout of fidx / bidx) and their scales sq, one warp a row
// (quant.cuh's formulas).  Zero pad columns neither move the scale nor
// get a level other than 0.
template <bool SM>
__device__ __forceinline__ void quantize(const float* S, int F,
                                         unsigned char* Q, float* sq,
                                         int warp, int lane) {
  for (int r = warp; r < BB; r += CWARPS) {
    float m = 0.f;
    for (int c = 4 * lane; c < F; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(S + fidx<SM>(r, c, F));
      m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                         fmaxf(fabsf(v.z), fabsf(v.w))));
    }
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const RowScale rs(quant_scale(m));
    for (int c = 4 * lane; c < F; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(S + fidx<SM>(r, c, F));
      *reinterpret_cast<uint32_t*>(Q + bidx<SM>(r, c, F)) =
          rs.level(v.x) | (rs.level(v.y) << 8) | (rs.level(v.z) << 16) |
          (rs.level(v.w) << 24);
    }
    if (lane == 0) sq[r] = rs.s;
  }
}

// acc += A[rows of this warp, 0:128] S[0:128, n0 + this warp's 64
// columns] on the tensor cores (m16n8k8 tf32): A the block's adjacency
// counts in shared memory (swizzled), S a [128, ld] operand (fidx).  The
// k-steps whose 32 x 8 tile of A is all zero are skipped (bit s of occ
// marks k-step s nonzero for this warp's rows; a QM9 block is ~97 %
// zeros).  A count is exact in tf32 up to 2048; with `big` (a count above
// that in the block) A's remainder runs a third pass.  S is split into
// TF32 halves where its fragments are loaded, or with RND rounded to bf16
// (exact in tf32: one pass).  Each k-step's chain starts from zero and is
// added with __fadd_rn, as the products' are.
template <bool RND, bool SM>
__device__ __forceinline__ void aggregate(Acc<float>& acc, const float* A,
                                          const float* S, int ld, int n0,
                                          uint32_t occ, bool big, int wr,
                                          int wc, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int st = 0; st < BB / 8; ++st) {
    if (!((occ >> st) & 1)) continue;
    const int k0 = 8 * st;
    uint32_t a[2][4], al[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r0 = 32 * wr + 16 * mt + g;
      const float2 x0 =
          *reinterpret_cast<const float2*>(A + at(r0, k0 + 2 * t, BB));
      const float2 x1 =
          *reinterpret_cast<const float2*>(A + at(r0 + 8, k0 + 2 * t, BB));
      const float v[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[mt][i] = tf32(v[i]);
        al[mt][i] =
            big ? tf32(__fsub_rn(v[i], __uint_as_float(a[mt][i]))) : 0u;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int n = n0 + 64 * wc + 8 * nt + g;
      float b[2] = {S[fidx<SM>(k0 + 2 * t, n, ld)],
                    S[fidx<SM>(k0 + 2 * t + 1, n, ld)]};
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (RND) b[i] = bf16r(b[i]);
        bh[i] = tf32(b[i]);
        bl[i] = tf32(__fsub_rn(b[i], __uint_as_float(bh[i])));
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float p[4] = {0.f, 0.f, 0.f, 0.f};
        if (!RND) mma_tf32(p, a[mt], bl[0], bl[1]);
        if (big) mma_tf32(p, al[mt], bh[0], bh[1]);
        mma_tf32(p, a[mt], bh[0], bh[1]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[mt][nt][i] = __fadd_rn(acc[mt][nt][i], p[i]);
      }
    }
  }
}

// INT8's aggregation on the CUDA cores, over the compacted lists
// (block_lists.cuh): dst[r, c] = f(r, c, s) with s = sum_j A[r, j] S[j, c]
// for this consumer thread's elements of a [128, F] array: column tid %
// 128 of each 128-column tile, rows 64 (tid / 128) .. 64 (tid / 128) + 63.
// Eight rows at a time: their list walks interleaved, then their f (which
// may read dst's own elements), then their stores (a walk, or a load
// after a store, alone waits on each shared-memory access).  Each row's
// sum stays in neighbour order, with RND each S value rounded to bf16
// first (the bf16 gather).
template <bool RND, bool SM, typename Fn>
__device__ __forceinline__ void each_agg(const int* ent, const int* ptr,
                                         const float* S, float* dst, int F,
                                         int tid, Fn f) {
  constexpr int RQ = 8;
  const int r0 = (tid / NT) * (BB / 2);
  for (int c = tid % NT; c < F; c += NT)
    for (int rb = r0; rb < r0 + BB / 2; rb += RQ) {
      int e[RQ], len[RQ], most = 0;
      float s[RQ];
#pragma unroll
      for (int q = 0; q < RQ; ++q) {
        e[q] = ptr[rb + q];
        len[q] = ptr[rb + q + 1] - e[q];
        most = max(most, len[q]);
        s[q] = 0.f;
      }
      for (int k = 0; k < most; ++k)
#pragma unroll
        for (int q = 0; q < RQ; ++q)
          if (k < len[q]) {
            const int p = ent[e[q] + k];
            float x = S[fidx<SM>(p & 0xFF, c, F)];
            if (RND) x = bf16r(x);
            s[q] = fmaf((float)(p >> 8), x, s[q]);
          }
      float v[RQ];
#pragma unroll
      for (int q = 0; q < RQ; ++q) v[q] = f(rb + q, c, s[q]);
#pragma unroll
      for (int q = 0; q < RQ; ++q) dst[fidx<SM>(rb + q, c, F)] = v[q];
    }
}

// The (matrix, column tile) of block j of a layer's stream in the order
// the consumers multiply them: gcn W0; gin W0 then W1; sage W0 and W1 per
// column tile (one accumulator set), or under INT8 W0 then W1 (two row
// scales).  Every block is F / tile_k tiles, contiguous in the stream.
__host__ __device__ inline int blocks_per_layer(int conv, int nct) {
  return conv == GCN ? nct : 2 * nct;
}
template <int MODE>
__device__ __forceinline__ void block_of(int conv, int j, int nct, int& m,
                                         int& n) {
  if (conv == SAGE && MODE != INT8) {
    m = j & 1;
    n = j >> 1;
  } else {
    m = j / nct;
    n = j % nct;
  }
}

// ------------------------------------------------------------------ kernel

template <int MODE, bool SM>
__global__ void __launch_bounds__(THREADS, 1)
mp_block_stack_kernel(StackArgs a) {
  using L = Smem<MODE, SM>;
  using TAcc = typename AccOf<MODE>::T;
  constexpr int S = STAGES;
  constexpr int TB = tile_bytes<MODE>();
  constexpr bool RND = MODE == BF16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int F = SM ? NT : a.F;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row0 = (size_t)blockIdx.x * BB;
  float* ADJ = reinterpret_cast<float*>(smem + L::ADJ);
  int* ent = reinterpret_cast<int*>(smem + L::ADJ);        // INT8
  int* s_ptr = reinterpret_cast<int*>(smem + L::PTR);      // INT8
  int* s_cnt = reinterpret_cast<int*>(smem + L::CNT);      // INT8
  int* s_occ = s_ptr;   // [4] k-step masks, big count (not INT8)
  float* s_dis = reinterpret_cast<float*>(smem + L::DIS);
  float* s_den = reinterpret_cast<float*>(smem + L::DEN);
  float* s_sq = reinterpret_cast<float*>(smem + L::SQ);
  float *H, *T, *Z;
  unsigned char* Q;
  if constexpr (SM) {
    H = reinterpret_cast<float*>(smem + L::H);
    T = reinterpret_cast<float*>(smem + L::T);
    Z = T;
    Q = smem + L::Q;
  } else {
    const size_t nf = (size_t)a.n_rows * F;
    H = a.out + row0 * F;
    T = reinterpret_cast<float*>(a.work) + row0 * F;
    Z = reinterpret_cast<float*>(a.work) + nf + row0 * F;
    Q = a.work + 8 * nf + row0 * F;
  }
  const uint32_t full = smem_addr(smem + L::BAR);
  const uint32_t empty = full + 8 * S;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (MODE != INT8) {
    if (tid < 5) s_occ[tid] = 0;
    __syncthreads();
    // the adjacency, its nonzero k-steps per 32 rows, and whether a count
    // exceeds tf32's exact integers
    for (int i = tid; i < BB * BB / 4; i += THREADS) {
      const int r = i / (BB / 4), c = 4 * (i % (BB / 4));
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          a.adj + (row0 + r) * BB + c));
      *reinterpret_cast<float4*>(ADJ + at(r, c, BB)) = v;
      if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
        atomicOr(s_occ + r / 32, 1 << (c / 8));
      if (fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)) > 2048.f)
        atomicOr(s_occ + 4, 1);
    }
  }
  for (int i = tid; i < BB * F / 4; i += THREADS) {   // h = x
    const int r = i / (F / 4), c = 4 * (i % (F / 4));
    *reinterpret_cast<float4*>(H + fidx<SM>(r, c, F)) =
        *reinterpret_cast<const float4*>(a.x + (row0 + r) * F + c);
  }
  for (int r = tid; r < BB; r += THREADS) {
    const float d = (float)a.deg[row0 + r];
    s_dis[r] = 1.f / sqrtf(d + 1.f);
    s_den[r] = fmaxf(d, 1.f);
  }
  if constexpr (MODE == INT8)   // the lists (block_lists.cuh); a barrier
    gnnb::compact_rows<THREADS>(a.adj + row0 * BB, BB, s_cnt, s_ptr, ent);
  else
    __syncthreads();

  const int nct = F / NT;
  if (warp == CWARPS) {   // the producer: every layer's tiles, in order
    if (lane == 0) {
      const int tpb = F / tile_k<MODE>();
      const size_t blk = (size_t)F * NT * weight_bytes(MODE);
      const uint32_t ring = smem_addr(smem + L::RING);
      int i = 0;
      for (int l = 0; l < a.L; ++l)
        for (int j = 0; j < blocks_per_layer(a.conv, nct); ++j) {
          int m, n;
          block_of<MODE>(a.conv, j, nct, m, n);
          const unsigned char* src =
              a.wst + ((size_t)(2 * l + m) * nct + n) * blk;
          for (int q = 0; q < tpb; ++q, ++i) {
            const int s = i % S;
            if (i >= S) mbar_wait(empty + 8 * s, ((i / S) - 1) & 1);
            mbar_expect_tx(full + 8 * s, TB);
            bulk_copy(ring + s * TB, src + (size_t)q * TB, TB, full + 8 * s);
          }
        }
    }
    return;
  }

  const int wr = warp & 3, wc = warp >> 2;
  Ring<MODE> ring{smem + L::RING, full, empty, 0};
  const uint32_t occ = s_occ[wr];
  const bool big = s_occ[4] != 0;
  for (int l = 0; l < a.L; ++l) {
    const float* B0 = a.b0 + (size_t)l * F;
    const float* B1 = a.b1 + (size_t)l * F;
    const float* S0 = MODE == INT8 ? a.sw0 + (size_t)l * F : nullptr;
    const float* S1 = MODE == INT8 ? a.sw1 + (size_t)l * F : nullptr;
    const bool skip = a.skip[l] != 0;
    const int act = a.act;

    if (a.conv == GCN) {
      const void* A = H;
      if constexpr (MODE == INT8) {
        quantize<SM>(H, F, Q, s_sq, warp, lane);
        cbar();
        A = Q;
      }
      for (int n0 = 0; n0 < F; n0 += NT) {   // T = p = (h W0) dis
        Acc<TAcc> acc;
        zero(acc);
        product<MODE, SM>(acc, A, F, F, ring, wr, wc, lane);
        float dis[2][2], sr[2][2];
        own_rows(dis, s_dis, wr, lane);
        own_rows(sr, s_sq, wr, lane);
        each_pair(wr, wc, lane, [&](int mt, int nt, int hh, int r, int cc) {
          const int c = n0 + cc;
          const float d = dis[mt][hh], q = sr[mt][hh];
          *reinterpret_cast<float2*>(T + fidx<SM>(r, c, F)) = make_float2(
              __fmul_rn(value<MODE>(acc[mt][nt][2 * hh], q, S0, c), d),
              __fmul_rn(value<MODE>(acc[mt][nt][2 * hh + 1], q, S0, c + 1),
                        d));
        });
      }
      cbar();
      // h = act(dis (A p + p) + b0 [+ h]), in place per element
      if constexpr (MODE == INT8) {
        each_agg<false, SM>(ent, s_ptr, T, H, F, tid,
                            [&](int r, int c, float s) {
          const int e = fidx<SM>(r, c, F);
          float o = __fadd_rn(__fmul_rn(s_dis[r], __fadd_rn(s, T[e])),
                              __ldg(B0 + c));
          if (skip) o = __fadd_rn(o, H[e]);
          return act_fn(o, act);
        });
      } else {
        for (int n0 = 0; n0 < F; n0 += NT) {
          Acc<float> ap;
          zero(ap);
          aggregate<RND, SM>(ap, ADJ, T, F, n0, occ, big, wr, wc, lane);
          float dis[2][2];
          own_rows(dis, s_dis, wr, lane);
          each_pair(wr, wc, lane, [&](int mt, int nt, int hh, int r, int cc) {
            const int c = n0 + cc;
            const int e = fidx<SM>(r, c, F);
            const float2 t2 = *reinterpret_cast<const float2*>(T + e);
            const float2 h2 = *reinterpret_cast<const float2*>(H + e);
            const float tv[2] = {t2.x, t2.y}, hv[2] = {h2.x, h2.y};
            float o[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float s = __fadd_rn(ap[mt][nt][2 * hh + i], tv[i]);
              o[i] = __fadd_rn(__fmul_rn(dis[mt][hh], s), __ldg(B0 + c + i));
              if (skip) o[i] = __fadd_rn(o[i], hv[i]);
              o[i] = act_fn(o[i], act);
            }
            *reinterpret_cast<float2*>(H + e) = make_float2(o[0], o[1]);
          });
        }
      }
      cbar();
      continue;
    }

    // T = gin (1 + eps) h + A h (two roundings, as the plain version: an
    // ulp before a bf16 rounding or a quantization moves it); sage A h /
    // max(deg, 1)
    const float ope = 1.f + a.eps[l];
    if constexpr (MODE == INT8) {
      each_agg<false, SM>(ent, s_ptr, H, T, F, tid,
                          [&](int r, int c, float s) {
        return a.conv == GIN
                   ? __fadd_rn(__fmul_rn(ope, H[fidx<SM>(r, c, F)]), s)
                   : s / s_den[r];
      });
    } else {
      for (int n0 = 0; n0 < F; n0 += NT) {
        Acc<float> ah;
        zero(ah);
        aggregate<RND, SM>(ah, ADJ, H, F, n0, occ, big, wr, wc, lane);
        // sage's division by max(deg, 1) as the IEEE quotient, from the
        // row's reciprocal where div_rcp gives it
        float den[2][2];
        own_rows(den, s_den, wr, lane);
        Recip rd[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) rd[mt][hh] = recip(den[mt][hh]);
        each_pair(wr, wc, lane, [&](int mt, int nt, int hh, int r, int cc) {
          const int e = fidx<SM>(r, n0 + cc, F);
          const float2 h2 = *reinterpret_cast<const float2*>(H + e);
          const float hv[2] = {h2.x, h2.y};
          float t[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float s = ah[mt][nt][2 * hh + i];
            t[i] = a.conv == GIN ? __fadd_rn(__fmul_rn(ope, hv[i]), s)
                   : fast_ok(s)  ? div_rcp(s, rd[mt][hh])
                                 : s / den[mt][hh];
          }
          *reinterpret_cast<float2*>(T + e) = make_float2(t[0], t[1]);
        });
      }
    }
    cbar();

    if (a.conv == GIN) {
      const void* A = T;
      if constexpr (MODE == INT8) {
        quantize<SM>(T, F, Q, s_sq, warp, lane);
        cbar();
        A = Q;
      }
      // Z = relu(T W0 + b0): over T where T is no operand any more (its
      // levels are, or every warp has read it: SM's single tile)
      float* Zd = SM || MODE == INT8 ? T : Z;
      for (int n0 = 0; n0 < F; n0 += NT) {
        Acc<TAcc> acc;
        zero(acc);
        product<MODE, SM>(acc, A, F, F, ring, wr, wc, lane);
        float sr[2][2];
        own_rows(sr, s_sq, wr, lane);
        if (SM && MODE != INT8) cbar();
        each_pair(wr, wc, lane, [&](int mt, int nt, int hh, int r, int cc) {
          const int c = n0 + cc;
          float z[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            z[i] = fmaxf(__fadd_rn(value<MODE>(acc[mt][nt][2 * hh + i],
                                               sr[mt][hh], S0, c + i),
                                   __ldg(B0 + c + i)),
                         0.f);
          *reinterpret_cast<float2*>(Zd + fidx<SM>(r, c, F)) =
              make_float2(z[0], z[1]);
        });
      }
      cbar();
      const void* A2 = Zd;
      if constexpr (MODE == INT8) {
        quantize<SM>(Zd, F, Q, s_sq, warp, lane);
        cbar();
        A2 = Q;
      }
      // h = act(Z W1 + b1 [+ h]): h is no operand here
      for (int n0 = 0; n0 < F; n0 += NT) {
        Acc<TAcc> acc;
        zero(acc);
        product<MODE, SM>(acc, A2, F, F, ring, wr, wc, lane);
        float sr[2][2];
        own_rows(sr, s_sq, wr, lane);
        each_pair(wr, wc, lane, [&](int mt, int nt, int hh, int r, int cc) {
          const int c = n0 + cc;
          float2* hp = reinterpret_cast<float2*>(H + fidx<SM>(r, c, F));
          const float2 h2 = *hp;
          const float hv[2] = {h2.x, h2.y};
          float o[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            o[i] = __fadd_rn(value<MODE>(acc[mt][nt][2 * hh + i], sr[mt][hh],
                                         S1, c + i),
                             __ldg(B1 + c + i));
            if (skip) o[i] = __fadd_rn(o[i], hv[i]);
            o[i] = act_fn(o[i], act);
          }
          *hp = make_float2(o[0], o[1]);
        });
      }
      cbar();
      continue;
    }

    // sage
    if constexpr (MODE == INT8) {
      quantize<SM>(T, F, Q, s_sq, warp, lane);
      cbar();
      for (int n0 = 0; n0 < F; n0 += NT) {   // T = T W0 + b0 (T is free)
        Acc<int> acc;
        zero(acc);
        product<MODE, SM>(acc, Q, F, F, ring, wr, wc, lane);
        float sr[2][2];
        own_rows(sr, s_sq, wr, lane);
        each_pair(wr, wc, lane, [&](int mt, int nt, int hh, int r, int cc) {
          const int c = n0 + cc;
          float y[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            y[i] = __fadd_rn(value<MODE>(acc[mt][nt][2 * hh + i], sr[mt][hh],
                                         S0, c + i),
                             __ldg(B0 + c + i));
          *reinterpret_cast<float2*>(T + fidx<SM>(r, c, F)) =
              make_float2(y[0], y[1]);
        });
      }
      cbar();
      quantize<SM>(H, F, Q, s_sq, warp, lane);
      cbar();
      for (int n0 = 0; n0 < F; n0 += NT) {   // h = act(T + h W1 [+ h])
        Acc<int> acc;
        zero(acc);
        product<MODE, SM>(acc, Q, F, F, ring, wr, wc, lane);
        float sr[2][2];
        own_rows(sr, s_sq, wr, lane);
        each_pair(wr, wc, lane, [&](int mt, int nt, int hh, int r, int cc) {
          const int c = n0 + cc;
          const int e = fidx<SM>(r, c, F);
          const float2 t2 = *reinterpret_cast<const float2*>(T + e);
          const float2 h2 = *reinterpret_cast<const float2*>(H + e);
          const float tv[2] = {t2.x, t2.y}, hv[2] = {h2.x, h2.y};
          float o[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            o[i] = __fadd_rn(tv[i], value<MODE>(acc[mt][nt][2 * hh + i],
                                                sr[mt][hh], S1, c + i));
            if (skip) o[i] = __fadd_rn(o[i], hv[i]);
            o[i] = act_fn(o[i], act);
          }
          *reinterpret_cast<float2*>(H + e) = make_float2(o[0], o[1]);
        });
      }
      cbar();
    } else {
      // o = T W0 + h W1 + b0 in one accumulator set per column tile; the
      // new h goes over H once every warp has read H (SM), else to Z
      for (int n0 = 0; n0 < F; n0 += NT) {
        Acc<float> acc;
        zero(acc);
        product<MODE, SM>(acc, T, F, F, ring, wr, wc, lane);
        product<MODE, SM>(acc, H, F, F, ring, wr, wc, lane);
        each_pair(wr, wc, lane, [&](int mt, int nt, int hh, int r, int cc) {
          const int c = n0 + cc;
          const float2 h2 =
              *reinterpret_cast<const float2*>(H + fidx<SM>(r, c, F));
          const float hv[2] = {h2.x, h2.y};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float o = __fadd_rn(acc[mt][nt][2 * hh + i], __ldg(B0 + c + i));
            if (skip) o = __fadd_rn(o, hv[i]);
            acc[mt][nt][2 * hh + i] = act_fn(o, act);
          }
        });
        float* dst = SM ? H : Z;
        if (SM) cbar();
        each_pair(wr, wc, lane, [&](int mt, int nt, int hh, int r, int cc) {
          *reinterpret_cast<float2*>(dst + fidx<SM>(r, n0 + cc, F)) =
              make_float2(acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]);
        });
      }
      cbar();
      if constexpr (!SM) {
        for (int i = tid; i < BB * F / 4; i += CONSUMERS)
          reinterpret_cast<float4*>(H)[i] =
              reinterpret_cast<const float4*>(Z)[i];
        cbar();
      }
    }
  }

  if constexpr (SM) {
    for (int i = tid; i < BB * F / 4; i += CONSUMERS) {
      const int r = i / (F / 4), c = 4 * (i % (F / 4));
      *reinterpret_cast<float4*>(a.out + (row0 + r) * F + c) =
          *reinterpret_cast<const float4*>(H + at(r, c, F));
    }
  }
}

template <int MODE, bool SM>
cudaError_t launch(const StackArgs& a, cudaStream_t s) {
  constexpr int smem = Smem<MODE, SM>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      mp_block_stack_kernel<MODE, SM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  mp_block_stack_kernel<MODE, SM><<<a.n_rows / BB, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

// whether a launch at width F in `mode` keeps H and T in shared memory
bool ht_in_smem(int F, int mode, int optin) {
  const int need = mode == BF16   ? Smem<BF16, true>::BYTES
                   : mode == INT8 ? Smem<INT8, true>::BYTES
                                  : Smem<F32, true>::BYTES;
  return F == NT && need <= optin;
}

template <int MODE>
cudaError_t launch_mode(const StackArgs& a, bool sm, cudaStream_t s) {
  return sm ? launch<MODE, true>(a, s) : launch<MODE, false>(a, s);
}

template <int MODE, bool SM>
cudaError_t info(int* regs, int* smem_bytes, int* ctas_per_sm) {
  constexpr int smem = Smem<MODE, SM>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      mp_block_stack_kernel<MODE, SM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, mp_block_stack_kernel<MODE, SM>);
  if (err != cudaSuccess) return err;
  *regs = fa.numRegs;
  *smem_bytes = (int)fa.sharedSizeBytes + smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, mp_block_stack_kernel<MODE, SM>, THREADS, smem);
}

template <int MODE>
cudaError_t info_mode(bool sm, int* regs, int* smem_bytes, int* ctas) {
  return sm ? info<MODE, true>(regs, smem_bytes, ctas)
            : info<MODE, false>(regs, smem_bytes, ctas);
}

int optin_smem(int device, cudaError_t* err) {
  int optin = 0;
  *err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return optin;
}

}  // namespace

extern "C" {

int gnnb_mp_block_rows() { return BB; }
int gnnb_mp_block_width_multiple() { return NT; }
int gnnb_mp_block_max_layers() { return MAX_L; }

// Dynamic shared memory of a launch at width F in `mode` with H and T in
// device memory, in bytes (the same at every width; at F = 128 the
// launcher keeps them in shared memory where that fits).
int gnnb_mp_block_smem_bytes(int F, int mode) {
  (void)F;
  return mode == BF16   ? Smem<BF16, false>::BYTES
         : mode == INT8 ? Smem<INT8, false>::BYTES
                        : Smem<F32, false>::BYTES;
}

// Whether a launch at width F in `mode` keeps H and T in shared memory
// (1) or in device memory (0) on `device`; -1 on a CUDA error.
int gnnb_mp_block_ht_in_smem(int F, int mode, int device) {
  cudaError_t err;
  const int optin = optin_smem(device, &err);
  if (err != cudaSuccess) return -1;
  return ht_in_smem(F, mode, optin) ? 1 : 0;
}

// Bytes of the scratch `work` a launch of n_rows rows at width F in
// `mode` needs on `device` (0 where H and T stay in shared memory); -1 on
// a CUDA error.
long long gnnb_mp_block_work_bytes(int n_rows, int F, int mode, int device) {
  const int sm = gnnb_mp_block_ht_in_smem(F, mode, device);
  if (sm < 0) return -1;
  return sm ? 0 : (long long)n_rows * F * 9;
}

// Bytes of stage_mp_stack's stream of L layers at width F in `mode`.
long long gnnb_mp_block_staged_bytes(int L, int F, int mode) {
  return (long long)L * 2 * F * F * weight_bytes(mode);
}

// Registers per thread, shared memory per CTA (bytes) and resident CTAs
// per SM of the kernel's instance for `mode` with H and T in shared
// memory (ht = 1) or not, on the current device.
int gnnb_mp_block_info(int mode, int ht, int* regs, int* smem_bytes,
                       int* ctas_per_sm) {
  const bool sm = ht != 0;
  int* c = ctas_per_sm;
  if (mode == BF16) return (int)info_mode<BF16>(sm, regs, smem_bytes, c);
  if (mode == INT8) return (int)info_mode<INT8>(sm, regs, smem_bytes, c);
  if (mode == F32) return (int)info_mode<F32>(sm, regs, smem_bytes, c);
  return (int)cudaErrorInvalidValue;
}

// Launches the stack on `stream` of `device`; n_rows % 128 == 0 and
// F % 128 == 0, all arrays contiguous as documented in
// ops/cuda/mp_block.py.  conv: 0 gcn, 1 gin, 2 sage; mode: 0 f32, 1 bf16,
// 2 int8 (with the column scales sw0, sw1 [L, F]).  The kernel reads the
// weights from `staged` (stage_mp_stack's stream of w0 and w1 in the mode,
// staged_bytes bytes, 16-byte aligned), not from w0 and w1; `scratch` is
// the work of gnnb_mp_block_work_bytes bytes (null where that is 0).
// Returns the cudaError_t of the launch (0 = success).
int gnnb_mp_block_stack(const void* x, const void* adj, const void* deg,
                        int n_rows, int F, const void* w0, const void* b0,
                        const void* w1, const void* b1, int n_layers,
                        int conv, const float* epss, const int* skips,
                        int act, int mode, const void* sw0, const void* sw1,
                        void* out, void* scratch, void* stream, int device,
                        const void* staged, long long staged_bytes) {
  (void)w0, (void)w1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_layers < 1 || n_layers > MAX_L || n_rows % BB != 0 || F % NT ||
      F < NT || conv < GCN || conv > SAGE || mode < F32 || mode > INT8 ||
      (mode == INT8 && (sw0 == nullptr || sw1 == nullptr)) ||
      staged == nullptr || ((uintptr_t)staged & 15) ||
      staged_bytes != gnnb_mp_block_staged_bytes(n_layers, F, mode))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const int optin = optin_smem(device, &err);
  if (err != cudaSuccess) return (int)err;
  const bool sm = ht_in_smem(F, mode, optin);
  if (!sm && scratch == nullptr) return (int)cudaErrorInvalidValue;
  StackArgs a;
  a.x = (const float*)x;
  a.adj = (const float*)adj;
  a.deg = (const int*)deg;
  a.wst = (const unsigned char*)staged;
  a.b0 = (const float*)b0;
  a.b1 = (const float*)b1;
  a.sw0 = (const float*)sw0;
  a.sw1 = (const float*)sw1;
  a.out = (float*)out;
  a.work = (unsigned char*)scratch;
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
  if (mode == BF16) return (int)launch_mode<BF16>(a, sm, s);
  if (mode == INT8) return (int)launch_mode<INT8>(a, sm, s);
  return (int)launch_mode<F32>(a, sm, s);
}

}  // extern "C"
