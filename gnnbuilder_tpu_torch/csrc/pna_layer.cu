// One PNA layer on any batch with an ELL neighbour table: the training
// forward, with the residuals its backward reads, its products on the
// tensor cores.
//
// Replaces: gnnbuilder_tpu/ops/pallas/pna_layer.py fused_pna_layer (kernel
// body _kernel).  For every node row r, with its ELL slots w < deg[r]:
//
//   u    = x Wi + b_pre                      v = x Wj   (all rows)
//   agg  = [u+max_w v_nbr | u+min_w v_nbr | u+mean_w v_nbr | std_w v_nbr]
//          (the first three 0 on empty rows; std = sqrt(relu(E[v^2] -
//          E[v]^2) + 1e-5) with E over max(deg, 1))
//   mid  = x K0 + b_post + y_id + amp*y_amp + att*y_att,  y = agg Ks
//   out  = act(mid Wlin + b_lin [+ skip])
//
// with amp = log(max(deg,1)+1)/delta and att = delta/log(max(deg,1)+1).
// With save_res it also writes v, agg (agg_cat), aux = [mx | mn | mean |
// ties_mx | ties_mn] over the raw v values (mx = -3e38, mn = +3e38 on
// empty rows, as the TPU kernel's finite -inf stand-in leaves them) and
// mid.  The tie counts compare the same f32 values that set mx and mn, and
// v is the exact tensor the backward re-reads, so the backward's g == mx
// test reproduces these decisions bit for bit.
//
// Weights: the kernels read them in the layout of ops/cuda/pna_layer.py
// stage_layer (one byte stream of sections, below), laid out from
// the JAX package's [in, out] matrices w_pre [2Fin, F] (receiver rows
// first), k_post [Fin + 12F, Fout] (self rows, then the three scaler
// groups of [max|min|mean|std] blocks) and w_lin [Fout, Fout].
//
// What bounds it on the H100: operations.  The products cost
// 2*(2 Fin F + 12 F Fout + Fin Fout + Fout^2) = 524,288 flops per row at
// 128 wide against ~4.6 KB of row traffic with residuals, far above every
// ridge of the card.  They run on the tensor cores with mma.sync (split
// TF32 in three passes in f32, bf16, s8; v = x Wj in f32 in float64).
//
// Design: four launches (BF16: three; INT8: five), none of whose shared
// memory grows with the widths, so any width the wrapper admits runs.
//  0. v = x Wj (pna_v_kernel) on the float64 tensor cores: the products
//     of two floats are exact in double and the sums float64, rounded to
//     float32 once, so v is the correctly rounded product but where the
//     double sum lands within ~1e-16 of a rounding boundary, whatever the
//     order (BF16: of bf16-rounded x and the bf16 Wj, rounded to bf16
//     after float32, as the plain version rounds it).  The tie counts and the max / min routing of the backward
//     compare v's values, so any two implementations that round v
//     correctly (the plain version does, by a float64 product) decide
//     them alike; split TF32 in three passes (some 22 bits of each
//     operand) or a float32 chain flip near ties between implementations.
//  1. The x products (pna_proj_kernel, the projection of gat_common.cuh):
//     [u | m0] = x [Wi | K0] over 128-column regions (BF16's stream also
//     holds Wj's regions in front, which this launch skips), a CTA per
//     128 rows and region, x staged 32 k at a time by cp.async, each
//     region's weights streamed once per CTA through the ring.  u + b_pre
//     goes to the scratch `work`, m0 = x K0 + b_post to mid's buffer
//     (mid_out, or `work`).
//  2. The aggregate and its product (pna_agg_kernel): a CTA per AM rows
//     and 128 columns of Ks's output, 8 consumer warps (2 x 4, each 32
//     rows x 32 columns) and a producer warp.  The aggregate is formed
//     once, in chunks of 64 k (16 features x the 4 aggregates; Ks's rows
//     are staged in that order) from u and exact indexed loads of v over
//     each row's slots (w < deg), into one of two buffers while the other
//     feeds the products (the next chunk's loads are issued before the
//     product and consumed after it); each chunk feeds all three scalers'
//     Ks, into three accumulator sets, so no scaler pass forms it again.
//     The producer streams the chunk's Ks tiles (all three scalers' 128
//     columns of a k-step, 24 KB) with cp.async.bulk through a ring of 4
//     stages guarded by full and empty mbarriers (fed by thread 0 instead,
//     behind the consumers, it ran 7 % slower, and 40 % when it issued only
//     what it could without waiting; a 9th warp caps ptxas at 168
//     registers a thread).  Then mid = ((m0 + y_id) + amp y_amp) + att
//     y_att (the plain version's order) over m0, to mid's buffer.  With
//     save_res the CTAs of the first column block write agg_out
//     and aux_out as each chunk is formed.  AM (a multiple of 16, at
//     most 64) is chosen per launch so that the batch fills whole waves
//     of the card: the train batch's 18,688 rows take AM = 48, 390 CTAs
//     on 132 SMs x 1 CTA, three full waves (at 128 rows they would be
//     146, 1.1 waves).
//  3. The final Linear out = act(mid Wlin + b_lin [+ skip])
//     (pna_proj_kernel again, of mid; under int8 after
//     quantize_rows_kernel has quantized mid's rows once each with
//     quant.cuh's formulas: s8 MMAs).  Fused into launch 2 at Fout = 128
//     (mid in shared memory, w_lin's tiles behind Ks's) it saved ~2 % of
//     the six layers' time, for a second copy of the product and its
//     epilogue, and registers under the producer warp's cap.
//
// Accuracy and reproducibility.  Each tensor-core chain starts from zero
// per k-step (f32) or per 32 k (bf16) and is added into its f32
// accumulator with __fadd_rn (the tensor cores truncate a chain's running
// sum; k_post's K is 12F).  No fused multiply-add stands before a
// rounding or a quantization, the aggregate's divisions and square roots
// are the IEEE results (div_rcp, sqrt_fast, or the IEEE operations where
// those do not give them), the variance is not contracted, and no float
// is added atomically: two runs give the same bits.
//
// Modes (template argument MODE, the JAX kernel's mm / gather_mode /
// quant; each writes the residuals with save_res, stores that leave out's
// bits as they are without them: v as the mode forms it, bf16-rounded in
// BF16, so the backward's tie tests compare what the forward compared):
//   F32  (0): every product but v (launch 0) split TF32 in three
//        passes, hi*hi + hi*lo + lo*hi (hi = tf32(a), lo = tf32(a -
//        hi)), summed in f32; the weights come split (stage_layer; Wj
//        whole, for launch 0), the activations are split where their
//        fragments are loaded.
//   BF16 (1): weights bf16; every product rounds its activations to bf16
//        where their fragments are loaded (x, the aggregate, mid) and
//        sums in f32 (mm="bf16"); v, compared by max / min and rounded
//        to bf16 next (gather_mode="bf16"), is launch 0's float64 product
//        of bf16 x and Wj (read from w_pre), rounded once to float32 and
//        then to bf16, so its ties and bf16 roundings are the plain
//        version's.  u, m0, mid and the skip stay f32.
//   INT8 (2): only the final Linear is quantized, as in the JAX kernel
//        (PairLinear and BlockScaledLinear stay f32: launches 0 to 2 run
//        as in F32, unfused): mid's rows quantized with one
//        symmetric scale
//        each, w_lin int8 with one scale per column, an exact int32 sum,
//        out = act(float(sum) * s_row * s_col + b_lin [+ skip]): _qdot.

#include "gat_common.cuh"

namespace {

using gnnb_dense::act_fn;
using gnnb_mma::at;
using gnnb_mma::bulk_copy;
using gnnb_mma::mbar_expect_tx;
using gnnb_mma::mbar_init;
using gnnb_mma::mbar_wait;
using gnnb_mma::mma_3xtf32;
using gnnb_mma::mma_bf16;
using gnnb_mma::mma_f64;
using gnnb_mma::pack_bf16;
using gnnb_mma::smem_addr;
using gnnb_mma::tf32;
using gnnb_quant::BF16;
using gnnb_quant::F32;
using gnnb_quant::INT8;
using gnnb_quant::bf16r;
using gnnb_quant::div_rcp;
using gnnb_quant::fast_ok;
using gnnb_quant::Recip;
using gnnb_quant::recip;
using gnnb_quant::sqrt_fast;

constexpr int CB = 128;               // width multiple; columns per region
constexpr float STD_EPS = 1e-5f;
constexpr float BIG = 3e38f;          // the TPU kernel's finite -inf

// ------------------------------------------------- launches 1 and 3

struct ProjArgs {
  const float* x;          // A operand rows [N, K] (x, or mid for lin)
  const int8_t* xq;        // INT8: mid's levels [N rounded up to 128, K]
  const float* xs;         // INT8: their row scales
  const unsigned char* wst;   // the section's regions, K / 32 tiles each
  int n_rows, K;
  int lin;                 // 0: the x products, 1: the final Linear
  // lin 0: region columns [0, F) -> v, [F, 2F) -> u, [2F, 2F + Fout) -> m0
  // of [v | u | m0]; the launch's first region is region `first` of it
  // (F / 128 where v is launch 0's)
  int first;
  float* v;
  float* u;
  float* m0;
  const float* bpre;
  const float* bpost;
  int F, Fout;
  // lin 1
  const float* sw;         // INT8: w_lin's column scales
  const float* blin;
  const float* skip;       // [N, Fout] or null
  float* out;
  int act;
};

// the epilogue's [128, 128] f32 tile overlays the ring and the x chunks
constexpr int TILE_BYTES = gnnb_gat::BM * CB * 4;
template <int MODE>
using ProjLayout = gnnb_gat::ProjSmem<MODE, 2, false, TILE_BYTES>;

// A CTA per 128 rows (blockIdx.x) and region of 128 columns (blockIdx.y):
// the region's product (gnnb_gat::project); the accumulators (INT8:
// scaled) go to a [128, 128] tile in shared memory, and the epilogue runs
// over its rows with 16-byte loads and stores.
template <int MODE>
__global__ void __launch_bounds__(gnnb_gat::TC_THREADS, 1)
pna_proj_kernel(ProjArgs a) {
  using SM = ProjLayout<MODE>;
  extern __shared__ __align__(128) unsigned char proj_smem[];
  unsigned char* smem = proj_smem;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * gnnb_gat::BM, region = blockIdx.y;
  const int nk = a.K / gnnb_gat::KC;
  const gnnb_gat::TileRing<SM::S, SM::TB> ring{smem + SM::RING,
                                               smem_addr(smem + SM::BAR)};
  if (tid == 0) gnnb_gat::init_ring<SM::S>(ring.full);
  float* sq = reinterpret_cast<float*>(smem + SM::SQ);
  if constexpr (MODE == INT8) {
    if (tid < gnnb_gat::BM) sq[tid] = a.xs[row0 + tid];
  }
  const gnnb_gat::XSrc src{a.x, a.xq, a.n_rows, a.K, a.K, true};
  __syncthreads();
  int it = 0;
  gnnb_gat::Acc<MODE, 2> acc;
  gnnb_gat::project<MODE, 2, false>(acc, src, row0, nk, smem + SM::X, ring,
                                    a.wst + (size_t)region * nk * SM::TB, it,
                                    tid);
  const int wr = warp & 3, wc = warp >> 2;
  float* T = reinterpret_cast<float*>(smem);   // free after project()
  gnnb_gat::each_pair<2>(wr, wc, lane, [&](int mt, int n, int hh, int r,
                                           int c) {
    float o[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if constexpr (MODE == INT8)
        o[i] = __fmul_rn(__fmul_rn((float)acc.v[mt][n][2 * hh + i], sq[r]),
                         __ldg(a.sw + region * CB + c + i));
      else
        o[i] = acc.v[mt][n][2 * hh + i];
    }
    *reinterpret_cast<float2*>(T + at(r, c, CB)) = make_float2(o[0], o[1]);
  });
  __syncthreads();
  const float* __restrict__ skip = a.skip;
  float* __restrict__ dst;
  const float* __restrict__ bias;
  int ld, c0;   // the destination's row stride and first column
  const int lr = region + a.first;
  if (a.lin) {
    dst = a.out, bias = a.blin, ld = a.Fout, c0 = region * CB;
  } else if (lr * CB < a.F) {
    dst = a.v, bias = nullptr, ld = a.F, c0 = lr * CB;
  } else if (lr * CB < 2 * a.F) {
    dst = a.u, bias = a.bpre, ld = a.F, c0 = lr * CB - a.F;
  } else {
    dst = a.m0, bias = a.bpost, ld = a.Fout, c0 = lr * CB - 2 * a.F;
  }
#pragma unroll 4
  for (int e = tid; e < gnnb_gat::BM * CB / 4; e += gnnb_gat::TC_THREADS) {
    const int r = e / (CB / 4), c = 4 * (e % (CB / 4)), row = row0 + r;
    if (row >= a.n_rows) break;
    const float4 t4 = *reinterpret_cast<const float4*>(T + at(r, c, CB));
    float o[4] = {t4.x, t4.y, t4.z, t4.w};
    float4 b4 = make_float4(0.f, 0.f, 0.f, 0.f), s4 = b4;
    if (bias != nullptr)
      b4 = __ldg(reinterpret_cast<const float4*>(bias + c0 + c));
    if (a.lin && skip != nullptr)
      s4 = *reinterpret_cast<const float4*>(skip + (size_t)row * ld + c0 + c);
    const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
    const float ss[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (bias != nullptr) o[i] = __fadd_rn(o[i], bb[i]);
      if (a.lin) {
        if (skip != nullptr) o[i] = __fadd_rn(o[i], ss[i]);
        o[i] = act_fn(o[i], a.act);
      } else if (MODE == BF16 && bias == nullptr) {
        o[i] = bf16r(o[i]);   // v: the gather of the BF16 mode reads bf16
      }
    }
    *reinterpret_cast<float4*>(dst + (size_t)row * ld + c0 + c) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

// ---------------------------------------------------------------- launch 0

// v = x Wj on the float64 tensor cores (mma.sync m8n8k4: the products of
// two floats are exact in double, the sums float64 FMAs), rounded to
// float32 once (BF16, `wjb` given: x rounded to bf16 where it is loaded,
// Wj bf16, and v rounded to bf16 after): a CTA per 64 rows and 128
// columns, 8 warps of 32 rows x 32 columns (4 x 4 tiles), x and Wj
// staged 16 k at a time in two buffers (the next k's loads issued before
// this one's products; rows padded by 8 floats, so a fragment's four k
// fall in four bank groups).
constexpr int VM = 64, VN = 128, VK = 16, VTHREADS = 256;
constexpr int VXLD = VM + 8, VWLD = VN + 8;

__global__ void __launch_bounds__(VTHREADS, 2)
pna_v_kernel(const float* __restrict__ x, const float* __restrict__ wj,
             const uint16_t* __restrict__ wjb, int n_rows, int Fin, int F,
             float* __restrict__ v) {
  __shared__ __align__(16) float xs[2][VK][VXLD];   // x transposed
  __shared__ __align__(16) float ws[2][VK][VWLD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 1, wc = warp >> 1, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * VM, col0 = blockIdx.y * VN;
  // thread tid loads x's row tid / 4, k 4 (tid % 4) .. + 3 and Wj's rows
  // tid / 32 and tid / 32 + 8, columns 4 (tid % 32) .. + 3
  const int xr = tid >> 2, xk = 4 * (tid & 3), wk = tid >> 5;
  const int wcol = 4 * (tid & 31);
  const bool x_ok = row0 + xr < n_rows;
  const float* xp = x + (size_t)(x_ok ? row0 + xr : 0) * Fin + xk;
  const bool rnd = wjb != nullptr;
  const size_t woff = (size_t)wk * F + col0 + wcol;
  float4 xa, wa[2];
  auto bf = [](unsigned short h) { return __uint_as_float((unsigned)h << 16); };
  auto load = [&](int k0) {
    xa = x_ok ? __ldg(reinterpret_cast<const float4*>(xp + k0))
              : make_float4(0.f, 0.f, 0.f, 0.f);
    if (rnd) {
      xa.x = bf16r(xa.x);
      xa.y = bf16r(xa.y);
      xa.z = bf16r(xa.z);
      xa.w = bf16r(xa.w);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t o = woff + (size_t)(k0 + 8 * i) * F;
      if (rnd) {
        const uint2 h = __ldg(reinterpret_cast<const uint2*>(wjb + o));
        wa[i] = make_float4(bf(h.x & 0xFFFF), bf(h.x >> 16),
                            bf(h.y & 0xFFFF), bf(h.y >> 16));
      } else {
        wa[i] = __ldg(reinterpret_cast<const float4*>(wj + o));
      }
    }
  };
  auto store = [&](int b) {
    xs[b][xk + 0][xr] = xa.x;
    xs[b][xk + 1][xr] = xa.y;
    xs[b][xk + 2][xr] = xa.z;
    xs[b][xk + 3][xr] = xa.w;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float4*>(&ws[b][wk + 8 * i][wcol]) = wa[i];
  };
  double acc[4][4][2];   // [m tile][n tile][column pair]
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = 0.0;
  load(0);
  store(0);
  __syncthreads();
  const int nk = Fin / VK;
  for (int it = 0; it < nk; ++it) {
    const int b = it & 1;
    if (it + 1 < nk) load((it + 1) * VK);
#pragma unroll
    for (int k0 = 0; k0 < VK; k0 += 4) {
      double a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = xs[b][k0 + t][32 * wr + 8 * i + g];
        w[i] = ws[b][k0 + t][32 * wc + 8 * i + g];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_f64(acc[mt][nt], a[mt], w[nt]);
    }
    if (it + 1 < nk) store(b ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int row = row0 + 32 * wr + 8 * mt + g;
    if (row >= n_rows) continue;
    float* dst = v + (size_t)row * F + col0 + 32 * wc + 2 * t;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float o0 = __double2float_rn(acc[mt][nt][0]);
      float o1 = __double2float_rn(acc[mt][nt][1]);
      if (rnd) {
        o0 = bf16r(o0);
        o1 = bf16r(o1);
      }
      *reinterpret_cast<float2*>(dst + 8 * nt) = make_float2(o0, o1);
    }
  }
}

// ---------------------------------------------------------------- launch 2

constexpr int AM_MAX = 64;             // rows per CTA, at most
constexpr int CHK = 64;                // k of one aggregate chunk
constexpr int AWARPS = 8;              // consumer warps, 2 x 4
constexpr int ACONS = AWARPS * 32;
constexpr int ATHREADS = ACONS + 32;   // + the producer warp

// k depth of one mma; k-steps per ring tile (a tile: all three scalers'
// k-steps, 24 KB: one k-step in F32, two in BF16; two in F32 measured
// slower, in 3 stages of 48 KB) and ring stages (6 measured no faster
// than 4); bytes of one scaler's
// k-step (128 columns in B-fragment order, F32: each pair's hi, then its
// lo)
template <int MODE> __host__ __device__ constexpr int akd() {
  return MODE == BF16 ? 16 : 8;
}
template <int MODE> __host__ __device__ constexpr int aksteps() {
  return MODE == BF16 ? 2 : 1;
}
template <int MODE> __host__ __device__ constexpr int astages() {
  return 4;
}
template <int MODE> __host__ __device__ constexpr int apair_bytes() {
  return MODE == BF16 ? 512 : 1024;
}
template <int MODE> __host__ __device__ constexpr int skb() {
  return 8 * apair_bytes<MODE>();
}
template <int MODE> __host__ __device__ constexpr int atile_bytes() {
  return aksteps<MODE>() * 3 * skb<MODE>();
}
template <int MODE> __host__ __device__ constexpr int tiles_per_chunk() {
  return CHK / (akd<MODE>() * aksteps<MODE>());
}
template <int MODE> struct AggSmem {
  static constexpr int S = astages<MODE>();
  static constexpr int TB = atile_bytes<MODE>();
  static constexpr int RING = 0;
  static constexpr int CH = RING + S * TB;   // two [64, 64] f32 chunks
  static constexpr int DEG = CH + 2 * AM_MAX * CHK * 4;
  static constexpr int AMP = DEG + AM_MAX * 4;
  static constexpr int ATT = AMP + AM_MAX * 4;
  static constexpr int BAR = ATT + AM_MAX * 4;           // full, empty
  static constexpr int END = BAR + 2 * S * 8;
};

struct AggArgs {
  const int* nbr;          // [N, W]
  const int* deg;          // [N]
  const float* v;          // [N, F] from launch 1
  const float* u;          // [N, F] from launch 1
  const unsigned char* wks;   // the Ks section
  float* mid;              // [N, Fout]: m0 in, mid out
  float* agg_out;          // [N, 4F] or null (save_res)
  float* aux_out;          // [N, 5F] or null
  int n_rows, W, F, Fout, am;
  float delta;
};

// all consumer warps (the producer warp never joins)
__device__ __forceinline__ void cbar() {
  asm volatile("bar.sync 1, %0;" ::"n"(ACONS) : "memory");
}

template <int MODE>
using ARing = gnnb_mma::Ring<astages<MODE>(), atile_bytes<MODE>()>;

// The first PF slots' v values and the u row of thread tid's part of
// chunk j, loaded ahead of the product of chunk j - 1 (their latency then
// hides behind it); slots past PF are loaded when the chunk is finished.
constexpr int PF = 4;
struct Pending {
  float4 g[PF];
  float4 u;
};

// Thread tid forms row tid / 4, features 16 j + 4 (tid % 4) + 0..3 of
// chunk j; rows past AM or N are zero.
__device__ __forceinline__ Pending gather_chunk(int j, const AggArgs& a,
                                                int row0, const int* s_deg,
                                                int tid) {
  const int r = tid >> 2, c = 16 * j + 4 * (tid & 3), row = row0 + r;
  Pending p;
  const int d = s_deg[r];     // 0 past AM and N
  const int* nb = a.nbr + (size_t)row * a.W;
#pragma unroll
  for (int w = 0; w < PF; ++w)
    if (w < d)
      p.g[w] = __ldg(reinterpret_cast<const float4*>(
          a.v + (size_t)__ldg(nb + w) * a.F + c));
  p.u = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r < a.am && row < a.n_rows)
    p.u = __ldg(reinterpret_cast<const float4*>(a.u + (size_t)row * a.F + c));
  return p;
}

// Chunk j of the aggregate, [AM_MAX, 64] f32, from gather_chunk's loads:
// column p * 16 + cc holds aggregate p (max, min, mean, std) of feature
// 16 j + cc.  With `save` (save_res, first column block) it also writes
// the row's agg_out and aux_out columns.
__device__ __forceinline__ void finish_chunk(int j, const Pending& pend,
                                             float* dst, const AggArgs& a,
                                             int row0, const int* s_deg,
                                             bool save, int tid) {
  const int r = tid >> 2, c = 16 * j + 4 * (tid & 3);
  const int row = row0 + r;
  float o[4][4];
  if (r < a.am && row < a.n_rows) {
    const int d = s_deg[r], F = a.F;
    const int* nb = a.nbr + (size_t)row * a.W;
    float s[4], sq[4], mx[4], mn[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = 0.f;
      sq[i] = 0.f;
      mx[i] = -BIG;
      mn[i] = BIG;
    }
    auto add = [&](const float4 g4) {
      const float g[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i] = __fadd_rn(s[i], g[i]);
        sq[i] = __fadd_rn(sq[i], __fmul_rn(g[i], g[i]));
        mx[i] = fmaxf(mx[i], g[i]);
        mn[i] = fminf(mn[i], g[i]);
      }
    };
#pragma unroll
    for (int w = 0; w < PF; ++w)
      if (w < d) add(pend.g[w]);
    for (int w = PF; w < d; ++w)
      add(__ldg(reinterpret_cast<const float4*>(
          a.v + (size_t)__ldg(nb + w) * F + c)));
    const float u[4] = {pend.u.x, pend.u.y, pend.u.z, pend.u.w};
    const float denom = fmaxf((float)d, 1.f);
    const Recip rd = recip(denom);
    bool fast = true;
#pragma unroll
    for (int i = 0; i < 4; ++i) fast = fast && fast_ok(s[i]) && fast_ok(sq[i]);
    const bool nonempty = d > 0;
    float mean[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // no contraction into FMAs: a row whose slots hold one value gets
      // var == 0 exactly, as in the plain version
      mean[i] = fast ? div_rcp(s[i], rd) : s[i] / denom;
      const float ms = fast ? div_rcp(sq[i], rd) : sq[i] / denom;
      const float var = fmaxf(__fsub_rn(ms, __fmul_rn(mean[i], mean[i])), 0.f);
      const float xv = __fadd_rn(var, STD_EPS);
      o[0][i] = nonempty ? __fadd_rn(u[i], mx[i]) : 0.f;
      o[1][i] = nonempty ? __fadd_rn(u[i], mn[i]) : 0.f;
      o[2][i] = nonempty ? __fadd_rn(u[i], mean[i]) : 0.f;
      o[3][i] = fast ? sqrt_fast(xv) : sqrtf(xv);
    }
    if (save) {
      float* go = a.agg_out + (size_t)row * 4 * F + c;
#pragma unroll
      for (int p = 0; p < 4; ++p)
        *reinterpret_cast<float4*>(go + p * F) =
            make_float4(o[p][0], o[p][1], o[p][2], o[p][3]);
      float tmx[4] = {0.f, 0.f, 0.f, 0.f}, tmn[4] = {0.f, 0.f, 0.f, 0.f};
      for (int w = 0; w < d; ++w) {
        const float4 g4 = __ldg(reinterpret_cast<const float4*>(
            a.v + (size_t)__ldg(nb + w) * F + c));
        const float g[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tmx[i] += (g[i] == mx[i]) ? 1.f : 0.f;
          tmn[i] += (g[i] == mn[i]) ? 1.f : 0.f;
        }
      }
      float4* xo =
          reinterpret_cast<float4*>(a.aux_out + (size_t)row * 5 * F + c);
      const int f4 = F / 4;
      xo[0] = make_float4(mx[0], mx[1], mx[2], mx[3]);
      xo[f4] = make_float4(mn[0], mn[1], mn[2], mn[3]);
      xo[2 * f4] = make_float4(mean[0], mean[1], mean[2], mean[3]);
      xo[3 * f4] = make_float4(tmx[0], tmx[1], tmx[2], tmx[3]);
      xo[4 * f4] = make_float4(tmn[0], tmn[1], tmn[2], tmn[3]);
    }
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[p][i] = 0.f;
  }
#pragma unroll
  for (int p = 0; p < 4; ++p)
    *reinterpret_cast<float4*>(dst + at(r, 16 * p + 4 * (tid & 3), CHK)) =
        make_float4(o[p][0], o[p][1], o[p][2], o[p][3]);
}

// Y[s] += chunk . Ks_s over the chunk's tiles.  The warp owns rows 32 wr
// .. 32 wr + 31 (m16 tile mt where live[mt]) and columns 32 wc .. 32 wc +
// 31 (two pairs of n8 tiles).  A's logical k of fragment slot (t, reg)
// matches the staged weights' (pna_block._fragment_index).
template <int MODE>
__device__ __forceinline__ void chunk_product(float (&Y)[3][2][4][4],
                                              const float* A,
                                              ARing<MODE>& ring, int wr,
                                              int wc, int lane,
                                              const bool (&live)[2]) {
  constexpr int PB = apair_bytes<MODE>(), SKB = skb<MODE>();
  const int g = lane >> 2, t = lane & 3;
  for (int kt = 0; kt < tiles_per_chunk<MODE>(); ++kt) {
    const unsigned char* tile = ring.acquire();
    if constexpr (MODE == BF16) {
      uint32_t a[2][2][4];   // [k-step][mt]
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r0 = 32 * wr + 16 * mt + g, k0 = 32 * kt + 16 * ks;
          const float4 y0 =
              *reinterpret_cast<const float4*>(A + at(r0, k0 + 4 * t, CHK));
          const float4 y1 = *reinterpret_cast<const float4*>(
              A + at(r0 + 8, k0 + 4 * t, CHK));
          a[ks][mt][0] = pack_bf16(y0.x, y0.y);
          a[ks][mt][1] = pack_bf16(y1.x, y1.y);
          a[ks][mt][2] = pack_bf16(y0.z, y0.w);
          a[ks][mt][3] = pack_bf16(y1.z, y1.w);
        }
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const uint4* b0p = reinterpret_cast<const uint4*>(
                               tile + s * SKB + wc * 2 * PB) + lane;
        const uint4* b1p = reinterpret_cast<const uint4*>(
                               tile + 3 * SKB + s * SKB + wc * 2 * PB) + lane;
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const uint4 b0 = b0p[np * (PB / 16)], b1 = b1p[np * (PB / 16)];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (!live[mt]) continue;
            float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(p0, a[0][mt], b0.x, b0.y);
            mma_bf16(p0, a[1][mt], b1.x, b1.y);
            mma_bf16(p1, a[0][mt], b0.z, b0.w);
            mma_bf16(p1, a[1][mt], b1.z, b1.w);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              Y[s][mt][2 * np][i] = __fadd_rn(Y[s][mt][2 * np][i], p0[i]);
              Y[s][mt][2 * np + 1][i] =
                  __fadd_rn(Y[s][mt][2 * np + 1][i], p1[i]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < aksteps<MODE>(); ++ks) {
        uint32_t a[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r0 = 32 * wr + 16 * mt + g;
          const int k0 = 8 * (kt * aksteps<MODE>() + ks);
          const float2 x0 =
              *reinterpret_cast<const float2*>(A + at(r0, k0 + 2 * t, CHK));
          const float2 x1 = *reinterpret_cast<const float2*>(
              A + at(r0 + 8, k0 + 2 * t, CHK));
          const float vv[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[mt][i] = tf32(vv[i]);
            al[mt][i] = tf32(__fsub_rn(vv[i], __uint_as_float(a[mt][i])));
          }
        }
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          const uint4* bp =
              reinterpret_cast<const uint4*>(tile + (3 * ks + s) * SKB +
                                             wc * 2 * PB) + lane;
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            const uint4 b = bp[np * (PB / 16)], bl = bp[np * (PB / 16) + 32];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {   // a k-step's chain from zero
              if (!live[mt]) continue;
              float p0[4] = {0.f, 0.f, 0.f, 0.f};
              float p1[4] = {0.f, 0.f, 0.f, 0.f};
              mma_3xtf32(p0, a[mt], al[mt], b.x, b.y, bl.x, bl.y);
              mma_3xtf32(p1, a[mt], al[mt], b.z, b.w, bl.z, bl.w);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                Y[s][mt][2 * np][i] = __fadd_rn(Y[s][mt][2 * np][i], p0[i]);
                Y[s][mt][2 * np + 1][i] =
                    __fadd_rn(Y[s][mt][2 * np + 1][i], p1[i]);
              }
            }
          }
        }
      }
    }
    ring.release(lane);
  }
}

// A CTA per AM rows (blockIdx.x) and 128 columns of mid (blockIdx.y).
template <int MODE>
__global__ void __launch_bounds__(ATHREADS, 1)
pna_agg_kernel(AggArgs a) {
  using SM = AggSmem<MODE>;
  constexpr int TB = SM::TB;
  extern __shared__ __align__(128) unsigned char agg_smem[];
  unsigned char* smem = agg_smem;
  int* s_deg = reinterpret_cast<int*>(smem + SM::DEG);
  float* s_amp = reinterpret_cast<float*>(smem + SM::AMP);
  float* s_att = reinterpret_cast<float*>(smem + SM::ATT);
  const uint32_t full = smem_addr(smem + SM::BAR);
  constexpr int S = SM::S;
  const uint32_t empty = full + 8 * S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * a.am, cb = blockIdx.y;
  const int nch = 4 * a.F / CHK;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, AWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < AM_MAX) {
    const int row = row0 + tid;
    const int d = tid < a.am && row < a.n_rows ? a.deg[row] : 0;
    const float logd = logf(fmaxf((float)d, 1.f) + 1.f);
    s_deg[tid] = d;
    s_amp[tid] = logd / a.delta;
    s_att[tid] = a.delta / logd;
  }
  __syncthreads();

  if (warp == AWARPS) {   // the producer: the CTA's Ks tiles
    if (lane == 0) {
      const int n = nch * tiles_per_chunk<MODE>();
      const unsigned char* ks = a.wks + (size_t)cb * n * TB;
      const uint32_t ring = smem_addr(smem + SM::RING);
      for (int i = 0; i < n; ++i) {
        const int s = i % S;
        if (i >= S) mbar_wait(empty + 8 * s, ((i / S) - 1) & 1);
        mbar_expect_tx(full + 8 * s, TB);
        bulk_copy(ring + s * TB, ks + (size_t)i * TB, TB, full + 8 * s);
      }
    }
    return;
  }

  const int wr = warp & 1, wc = warp >> 1;
  const bool live[2] = {32 * wr < a.am, 32 * wr + 16 < a.am};
  const bool save = a.agg_out != nullptr && cb == 0;
  ARing<MODE> ring{smem + SM::RING, full, empty, 0};
  float* CHB = reinterpret_cast<float*>(smem + SM::CH);
  float Y[3][2][4][4];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) Y[s][mt][nt][i] = 0.f;

  finish_chunk(0, gather_chunk(0, a, row0, s_deg, tid), CHB, a, row0, s_deg,
               save, tid);
  cbar();
  for (int j = 0; j < nch; ++j) {
    Pending next;
    if (j + 1 < nch) next = gather_chunk(j + 1, a, row0, s_deg, tid);
    chunk_product<MODE>(Y, CHB + (j & 1) * AM_MAX * CHK, ring, wr, wc, lane,
                        live);
    if (j + 1 < nch)
      finish_chunk(j + 1, next, CHB + ((j + 1) & 1) * AM_MAX * CHK, a, row0,
                   s_deg, save, tid);
    cbar();
  }

  // mid = ((m0 + y_id) + amp y_amp) + att y_att; every m0 is loaded
  // before any mid is stored (they share the buffer)
  const int g = lane >> 2, t = lane & 3;
  auto valid = [&](int mt, int hh) {
    const int r = 32 * wr + 16 * mt + g + 8 * hh;
    return live[mt] && r < a.am && row0 + r < a.n_rows;
  };
  auto mid_at = [&](int mt, int hh, int nt) {
    const int r = 32 * wr + 16 * mt + g + 8 * hh;
    return reinterpret_cast<float2*>(a.mid + (size_t)(row0 + r) * a.Fout +
                                     cb * CB + 32 * wc + 8 * nt + 2 * t);
  };
  float2 m0[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        m0[mt][hh][nt] = valid(mt, hh) ? *mid_at(mt, hh, nt)
                                       : make_float2(0.f, 0.f);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (!valid(mt, hh)) continue;
      const int r = 32 * wr + 16 * mt + g + 8 * hh;
      const float amp = s_amp[r], att = s_att[r];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float mm[2] = {m0[mt][hh][nt].x, m0[mt][hh][nt].y};
        float o[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[i] = __fadd_rn(mm[i], Y[0][mt][nt][2 * hh + i]);
          o[i] = __fadd_rn(o[i], __fmul_rn(amp, Y[1][mt][nt][2 * hh + i]));
          o[i] = __fadd_rn(o[i], __fmul_rn(att, Y[2][mt][nt][2 * hh + i]));
        }
        *mid_at(mt, hh, nt) = make_float2(o[0], o[1]);
      }
    }
}

// ------------------------------------------------------------- launchers

// the rows per CTA of launch 2 for n_rows on a card with `slots` CTAs in
// one wave: the fewest waves whose rows per CTA (a multiple of 16) stay
// within AM_MAX
int agg_rows(int n_rows, int slots) {
  for (int w = 1;; ++w) {
    const long long per = (long long)slots * w * 16;
    const int am = (int)(16 * ((n_rows + per - 1) / per));
    if (am <= AM_MAX) return am < 16 ? 16 : am;
  }
}

// bytes of one weight of the x products' and the Ks section in `mode`
// (F32 and INT8: both TF32 halves), and of one w_lin weight
size_t float_section_bpw(int mode) { return mode == BF16 ? 2 : 8; }
size_t lin_bpw(int mode) { return mode == BF16 ? 2 : mode == INT8 ? 1 : 8; }

// The stream's sections: F32 and INT8 [Wj (f32, row-major, launch 0's) |
// x [Wi | K0] | Ks | w_lin], BF16 [x [Wj | Wi | K0] | Ks | w_lin].
struct Sections {
  size_t wj, proj, ks, lin;
};
Sections section_bytes(int Fin, int F, int Fout, int mode) {
  const size_t b = float_section_bpw(mode);
  const bool v_fma = mode != BF16;
  return {v_fma ? (size_t)Fin * F * 4 : 0,
          (size_t)Fin * ((v_fma ? F : 2 * F) + Fout) * b,
          (size_t)12 * F * Fout * b, (size_t)Fout * Fout * lin_bpw(mode)};
}

// the scratch `work` holds u [N, F], mid [N, Fout] when mid_out is null,
// and under INT8 mid's row scales [n128] and levels [n128, Fout]
struct Work {
  size_t u, mid, xs, xq, end;
};
Work work_layout(int n_rows, int F, int Fout, int mode, bool has_mid) {
  const size_t n128 = (size_t)(n_rows + 127) / 128 * 128;
  const bool q = mode == INT8;
  Work w;
  w.u = 0;
  w.mid = w.u + (size_t)n_rows * F * 4;
  w.xs = w.mid + (has_mid ? 0 : (size_t)n_rows * Fout * 4);
  w.xq = w.xs + (q ? n128 * 4 : 0);
  w.end = w.xq + (q ? n128 * Fout : 0);
  return w;
}

template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int MODE>
cudaError_t launch_proj(const ProjArgs& p, int regions, cudaStream_t st) {
  constexpr int smem = ProjLayout<MODE>::END;
  cudaError_t err = set_smem(pna_proj_kernel<MODE>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n_rows + gnnb_gat::BM - 1) / gnnb_gat::BM, regions);
  pna_proj_kernel<MODE><<<grid, gnnb_gat::TC_THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t agg_slots(int device, int* slots) {
  int sms = 0, per = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = set_smem(pna_agg_kernel<MODE>, AggSmem<MODE>::END);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per, pna_agg_kernel<MODE>, ATHREADS, AggSmem<MODE>::END);
  *slots = sms * (per > 0 ? per : 1);
  return err;
}

template <int MODE>
cudaError_t launch_agg(AggArgs g, int device, cudaStream_t st) {
  int slots = 0;
  cudaError_t err = agg_slots<MODE>(device, &slots);
  if (err != cudaSuccess) return err;
  g.am = agg_rows(g.n_rows, slots);
  const dim3 grid((g.n_rows + g.am - 1) / g.am, g.Fout / CB);
  pna_agg_kernel<MODE><<<grid, ATHREADS, AggSmem<MODE>::END, st>>>(g);
  return cudaGetLastError();
}

template <typename K>
cudaError_t info(K kernel, int threads, int smem, int* regs, int* smem_bytes,
                 int* ctas_per_sm) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  *regs = fa.numRegs;
  *smem_bytes = (int)fa.sharedSizeBytes + smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel,
                                                       threads, smem);
}

int max_smem() {
  int m = AggSmem<F32>::END;
  m = m > AggSmem<BF16>::END ? m : AggSmem<BF16>::END;
  m = m > ProjLayout<F32>::END ? m : ProjLayout<F32>::END;
  m = m > ProjLayout<BF16>::END ? m : ProjLayout<BF16>::END;
  return m > ProjLayout<INT8>::END ? m : ProjLayout<INT8>::END;
}

}  // namespace

extern "C" {

// Every width must be a multiple of this (one region of columns).
int gnnb_pna_layer_width_multiple() { return CB; }

// Dynamic shared memory of the largest of the layer's launches, in bytes
// (the same at every width); the wrapper checks it against the device's
// per-block limit.
int gnnb_pna_layer_smem_bytes(int Fin, int F, int Fout, int mode) {
  (void)Fin, (void)F, (void)Fout, (void)mode;
  return max_smem();
}

// Bytes of stage_layer's stream at these widths in `mode`.
long long gnnb_pna_layer_staged_bytes(int Fin, int F, int Fout, int mode) {
  const Sections s = section_bytes(Fin, F, Fout, mode);
  return (long long)(s.wj + s.proj + s.ks + s.lin);
}

// Bytes of the scratch `work` for n_rows rows (save_res: mid_out holds mid).
long long gnnb_pna_layer_work_bytes(int n_rows, int F, int Fout, int mode,
                                    int save_res) {
  return (long long)work_layout(n_rows, F, Fout, mode, save_res != 0).end;
}

// Rows per CTA of the aggregate launch for n_rows rows on `device`.
int gnnb_pna_layer_agg_rows(int n_rows, int mode, int device) {
  int slots = 0;
  const cudaError_t err = mode == BF16 ? agg_slots<BF16>(device, &slots)
                                       : agg_slots<F32>(device, &slots);
  return err != cudaSuccess ? -(int)err : agg_rows(n_rows, slots);
}

// Registers per thread, shared memory per CTA (bytes) and resident CTAs
// per SM of `kernel` (0: the projection of launches 1 and 3, 1: the
// aggregate, 2: the v launch of F32 and INT8) in `mode` on the current
// device
// (INT8: the projection's INT8 instance is launch 3's; its x products and
// aggregate run the F32 instances).
int gnnb_pna_layer_info(int kernel, int mode, int* regs, int* smem_bytes,
                        int* ctas_per_sm) {
  if (mode < F32 || mode > INT8) return (int)cudaErrorInvalidValue;
  if (kernel == 0) {
    if (mode == BF16)
      return (int)info(pna_proj_kernel<BF16>, gnnb_gat::TC_THREADS,
                       ProjLayout<BF16>::END, regs, smem_bytes, ctas_per_sm);
    if (mode == INT8)
      return (int)info(pna_proj_kernel<INT8>, gnnb_gat::TC_THREADS,
                       ProjLayout<INT8>::END, regs, smem_bytes, ctas_per_sm);
    return (int)info(pna_proj_kernel<F32>, gnnb_gat::TC_THREADS,
                     ProjLayout<F32>::END, regs, smem_bytes, ctas_per_sm);
  }
  if (kernel == 1) {
    if (mode == BF16)
      return (int)info(pna_agg_kernel<BF16>, ATHREADS, AggSmem<BF16>::END,
                       regs, smem_bytes, ctas_per_sm);
    return (int)info(pna_agg_kernel<F32>, ATHREADS, AggSmem<F32>::END, regs,
                     smem_bytes, ctas_per_sm);
  }
  if (kernel == 2)
    return (int)info(pna_v_kernel, VTHREADS, 0, regs, smem_bytes,
                     ctas_per_sm);
  return (int)cudaErrorInvalidValue;
}

// Launches the layer on `stream` of `device`.  All arrays contiguous as
// documented in ops/cuda/pna_layer.py: x, biases, skip and outputs f32;
// s_wlin (mode 2) f32; skip, agg_out, aux_out and mid_out may be null (the
// last three together, in every mode).  The kernels read
// the weights from `staged`, stage_layer's stream of w_pre, k_post and
// w_lin (of staged_bytes bytes, 16-byte aligned), not from those three
// pointers, but for BF16's v launch, which reads w_pre's Wj rows (bf16,
// row-major, contiguous, 8-byte aligned); `work` is the scratch of
// gnnb_pna_layer_work_bytes bytes.
// Returns the cudaError_t of the launches (0 = success).
int gnnb_pna_layer(const void* x, const void* nbr, const void* deg,
                   int n_rows, int ell_width, int Fin, int F, int Fout,
                   const void* w_pre, const void* b_pre, const void* k_post,
                   const void* b_post, const void* w_lin, const void* b_lin,
                   const void* skip, float delta, int act, int mode,
                   const void* s_wlin, void* out, void* v, void* agg_out,
                   void* aux_out, void* mid_out, void* stream, int device,
                   const void* staged, long long staged_bytes, void* work) {
  (void)k_post, (void)w_lin;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Fin % CB || F % CB || Fout % CB || Fin < CB || F < CB || Fout < CB ||
      n_rows < 0 || mode < F32 || mode > INT8 || staged == nullptr ||
      (mode == BF16 && (w_pre == nullptr || ((uintptr_t)w_pre & 7))) ||
      work == nullptr || ((uintptr_t)staged & 15) || ((uintptr_t)work & 15) ||
      staged_bytes != gnnb_pna_layer_staged_bytes(Fin, F, Fout, mode))
    return (int)cudaErrorInvalidValue;
  const bool save = agg_out != nullptr;
  if (save != (aux_out != nullptr) || save != (mid_out != nullptr))
    return (int)cudaErrorInvalidValue;
  if (mode == INT8 && s_wlin == nullptr) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  if (max_smem() > optin) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Sections sec = section_bytes(Fin, F, Fout, mode);
  const unsigned char* wst = (const unsigned char*)staged;
  const Work wl = work_layout(n_rows, F, Fout, mode, save);
  unsigned char* wk = (unsigned char*)work;
  float* u = (float*)(wk + wl.u);
  float* mid = save ? (float*)mid_out : (float*)(wk + wl.mid);

  // 0. v = x Wj (BF16: from w_pre's bf16 Wj rows, row-major)
  {
    const bool b = mode == BF16;
    const dim3 grid((n_rows + VM - 1) / VM, F / VN);
    pna_v_kernel<<<grid, VTHREADS, 0, st>>>(
        (const float*)x, b ? nullptr : (const float*)wst,
        b ? (const uint16_t*)w_pre + (size_t)Fin * F : nullptr, n_rows, Fin,
        F, (float*)v);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  // 1. [u | m0] = x [Wi | K0] (BF16: past the stream's Wj regions)
  ProjArgs p{};
  p.x = (const float*)x;
  p.wst = wst + sec.wj +
          (mode == BF16 ? (size_t)(F / CB) * (Fin / gnnb_gat::KC) *
                              ProjLayout<BF16>::TB
                        : 0);
  p.n_rows = n_rows;
  p.K = Fin;
  p.lin = 0;
  p.first = F / CB;
  p.v = (float*)v;
  p.u = u;
  p.m0 = mid;
  p.bpre = (const float*)b_pre;
  p.bpost = (const float*)b_post;
  p.F = F;
  p.Fout = Fout;
  const int regions = (2 * F + Fout) / CB - p.first;
  err = mode == BF16 ? launch_proj<BF16>(p, regions, st)
                     : launch_proj<F32>(p, regions, st);
  if (err != cudaSuccess) return (int)err;

  // 2. the aggregate, y = agg Ks and mid
  AggArgs g{};
  g.nbr = (const int*)nbr;
  g.deg = (const int*)deg;
  g.v = (const float*)v;
  g.u = u;
  g.wks = wst + sec.wj + sec.proj;
  g.mid = mid;
  g.agg_out = (float*)agg_out;
  g.aux_out = (float*)aux_out;
  g.n_rows = n_rows;
  g.W = ell_width;
  g.F = F;
  g.Fout = Fout;
  g.delta = delta;
  err = mode == BF16 ? launch_agg<BF16>(g, device, st)
                     : launch_agg<F32>(g, device, st);
  if (err != cudaSuccess) return (int)err;

  // 3. out = act(mid Wlin + b_lin [+ skip])
  ProjArgs q{};
  q.x = mid;
  q.wst = wst + sec.wj + sec.proj + sec.ks;
  q.n_rows = n_rows;
  q.K = Fout;
  q.lin = 1;
  q.F = F;
  q.Fout = Fout;
  q.sw = (const float*)s_wlin;
  q.blin = (const float*)b_lin;
  q.skip = (const float*)skip;
  q.out = (float*)out;
  q.act = act;
  const int out_regions = Fout / CB;
  if (mode == INT8) {
    const int n_pad = (n_rows + 127) / 128 * 128;
    q.xq = (const int8_t*)(wk + wl.xq);
    q.xs = (const float*)(wk + wl.xs);
    gnnb_gat::quantize_rows_kernel<<<(n_pad + gnnb_gat::WARPS - 1) /
                                         gnnb_gat::WARPS,
                                     gnnb_gat::THREADS, 0, st>>>(
        mid, n_rows, Fout, Fout, n_pad, (int8_t*)(wk + wl.xq),
        (float*)(wk + wl.xs));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)launch_proj<INT8>(q, out_regions, st);
  }
  return (int)(mode == BF16 ? launch_proj<BF16>(q, out_regions, st)
                            : launch_proj<F32>(q, out_regions, st));
}

}  // extern "C"
