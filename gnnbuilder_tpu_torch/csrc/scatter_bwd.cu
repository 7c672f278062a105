// PNA aggregation backward: from the cotangent of mid and the forward's
// residuals, each receiver's coefficient row (cstk), which the gather of
// ell_bwd.cu turns into dv over the reverse table or, on a batch without
// one, over the reverse CSR built from the forward table.
//
// Replaces: gnnbuilder_tpu/ops/pallas/scatter_bwd.py
// fused_pna_scatter_backward (its raw PNA mode; kernel body _kernel,
// launched through _launch), and the coefficient preparation of the JAX
// PNA VJP's reverse-table branch (pna_layer.py _make_vjp_fn).  For every
// receiver row r with degree d:
//
//   dy    = [d_mid | (log_deg/delta) d_mid | (delta/log_deg) d_mid]
//   d_agg = dy ks_t                              ([3Fout] x [3Fout, 4F])
//   ct_mx, ct_mn, ct_mean = the first three F blocks of d_agg (0 if d = 0)
//   c_lin = ct_mean / denom        c_a  = ct_std / (denom * std)
//   c_mx  = ct_mx / max(ties_mx, 1) c_mn = ct_mn / max(ties_mn, 1)
//
// with denom = max(d, 1) and log_deg = log(denom + 1).  The kernel
// writes row r of cstk [N, 7F]:
//
//   [c_lin | c_a | c_a * mean | mx | c_mx | mn | c_mn]
//
// (the JAX VJP's layout: one lin, one dev and two cmp terms), and
// ell_bwd.cu sums, for each sender j, over its out-neighbours i:
// c_lin + (v_j c_a - c_a mean) + [v_j == mx] c_mx + [v_j == mn] c_mn.  Each
// output element has one owner there, so dv is the same bits every run;
// no kernel adds floats atomically.
//
// mx, mn, mean, ties and std are the forward's saved values (aux and the
// std block of agg_cat) and the gather compares the forward's saved v, so
// v_j == mx repeats the forward's own comparisons.  For a degree-1 row
// mean == v_j bitwise, so the std term is exactly zero.
//
// What bounds it on the H100: operations.  d_agg costs 2 * 3Fout * 4F =
// 393,216 flops per row at 128 wide against ~7 KB of row inputs and cstk
// written; it runs on the tensor cores (mma.sync m16n8k8 tf32, split in
// three passes).
//
// Design: a CTA per R receiver rows (blockIdx.x; 128, fewer only where
// d_mid's rows do not fit shared memory) and 32 features (blockIdx.y):
// the 128 columns of d_agg that are those features' four blocks (mx, mn,
// mean, std).  8 consumer warps in a 4 x 2 grid each own 32 rows x 64 of
// those columns, and one producer warp streams the feature group's
// columns of ks_t (scatter_bwd.py stage_ks_t: k-steps of 8 in mma
// B-fragment order, pre-split into TF32 halves, laid out on the card on
// every call) with cp.async.bulk through a ring of 3 stages guarded by
// full and empty mbarriers (mma_ring.cuh).  The staged columns are
// ordered so that a thread's accumulators hold the same two features of
// all four blocks: the coefficients come out of its registers and d_agg
// never leaves them.  The A operand is dy, formed where its fragments
// are loaded from the CTA's d_mid rows in shared memory (the k-steps of
// dy's second and third blocks multiply by the row's scaler, rounded once
// as the plain version's dy is).  The train batch's 18,688 rows
// take 146 x 4 CTAs, 4.4 waves of 132; 96 rows a CTA would fill 5.9
// waves but leave one of the SM's four sub-partitions idle, and measured
// slower (PERF.md).  The TPU kernel accumulated a sender window in VMEM
// and overlap-added its margins because it could not scatter; this
// kernel writes each receiver's row once instead and leaves the sum over
// senders to a gather.
//
// Accuracy.  Each k-step's four chains start from zero, their three
// passes (lo*hi, hi*lo, hi*hi) issued in turn across the chains, and each
// chain is added into its f32 accumulator with __fadd_rn (the tensor
// cores truncate a chain's running sum); the split keeps ~22 bits of each
// operand (~1e-6 of d_agg's size, the float32 FMA version ~1e-7).  The
// divisions are IEEE.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_ring.cuh"

namespace {

using gnnb_mma::Acc;
using gnnb_mma::at;
using gnnb_mma::bulk_copy;
using gnnb_mma::mbar_expect_tx;
using gnnb_mma::mbar_init;
using gnnb_mma::mbar_wait;
using gnnb_mma::mma_tf32;
using gnnb_mma::smem_addr;
using gnnb_mma::tf32;
using gnnb_mma::zero;

constexpr int CB = 128;               // width multiple
constexpr int FG = 32;                // features per CTA column group
constexpr int RMAX = 128;             // most receiver rows per CTA
constexpr int RSTEP = 16;             // rows per CTA are a multiple of this
constexpr int CWARPS = 8;             // consumer warps
constexpr int CONSUMERS = CWARPS * 32;
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr int STAGES = 3;
constexpr int KB = 8192;              // a k-step of 8 x 128 columns, hi + lo
constexpr int TB = 2 * KB;            // a ring tile: two k-steps

constexpr int SMEM_LIMIT = 232448;

// shared-memory carve-up, byte offsets; d_mid's R rows after the tables
constexpr int RING = 0;
constexpr int DEG = RING + STAGES * TB;
constexpr int SC1 = DEG + RMAX * 4;
constexpr int SC2 = SC1 + RMAX * 4;
constexpr int BAR = SC2 + RMAX * 4;   // full, empty
constexpr int DM = (BAR + 2 * STAGES * 8 + 127) / 128 * 128;

// dynamic shared memory of a launch with R rows per CTA
size_t smem_bytes(int R, int Fout) { return DM + (size_t)R * Fout * 4; }

// Rows per CTA at d_mid width Fout: the most (a multiple of 16, at most
// 128) whose shared memory fits; 0 when none does.  With fewer than 128
// the warps of the idle rows leave some of the SM's four sub-partitions
// without work (4 x 2 warps, rows by warp % 4), so no R below 128 is
// taken to round the waves (PERF.md has R = 96 measured).
int rows_for(int Fout) {
  for (int R = RMAX; R >= RSTEP; R -= RSTEP)
    if (smem_bytes(R, Fout) <= (size_t)SMEM_LIMIT) return R;
  return 0;
}

struct ScatterArgs {
  const float* d_mid;          // [N, Fout]
  const float* aux;            // [N, 5F]  mx | mn | mean | ties_mx | ties_mn
  const float* agg_cat;        // [N, 4F]  (std = block 3)
  const int* deg;              // [N]
  const unsigned char* wst;    // stage_ks_t's stream
  float* cstk;                 // [N, 7F]
  int n_rows, F, Fout, rows;
  float delta;
};

using Ring = gnnb_mma::Ring<STAGES, TB>;

__global__ void __launch_bounds__(THREADS, 1)
pna_scatter_bwd_kernel(ScatterArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = a.rows, F = a.F, Fout = a.Fout, K = 3 * Fout;
  const int row0 = blockIdx.x * R, cg = blockIdx.y;
  int* s_deg = reinterpret_cast<int*>(smem + DEG);
  float* s_sc1 = reinterpret_cast<float*>(smem + SC1);
  float* s_sc2 = reinterpret_cast<float*>(smem + SC2);
  float* dm = reinterpret_cast<float*>(smem + DM);
  const uint32_t full = smem_addr(smem + BAR);
  const uint32_t empty = full + 8 * STAGES;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < RMAX; i += THREADS) {
    const int r = row0 + i;
    const int d = i < R && r < a.n_rows ? a.deg[r] : 0;
    const float ld = logf(fmaxf((float)d, 1.f) + 1.f);
    s_deg[i] = d;
    s_sc1[i] = ld / a.delta;
    s_sc2[i] = a.delta / ld;
  }
  for (int q = tid; q < R * Fout / 4; q += THREADS) {   // d_mid rows
    const int i = q / (Fout / 4), c = 4 * (q % (Fout / 4));
    const int r = row0 + i;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < a.n_rows)
      v = __ldg(reinterpret_cast<const float4*>(a.d_mid + (size_t)r * Fout +
                                                c));
    *reinterpret_cast<float4*>(dm + at(i, c, Fout)) = v;
  }
  __syncthreads();

  if (warp == CWARPS) {   // the producer: the column group's ks_t tiles
    if (lane == 0) {
      const int n = K / 16;
      const unsigned char* src = a.wst + (size_t)cg * n * TB;
      const uint32_t ring = smem_addr(smem + RING);
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
        mbar_expect_tx(full + 8 * s, TB);
        bulk_copy(ring + s * TB, src + (size_t)i * TB, TB, full + 8 * s);
      }
    }
    return;
  }

  const int wr = warp & 3, wc = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const bool live[2] = {32 * wr < R, 32 * wr + 16 < R};
  Ring ring{smem + RING, full, empty, 0};
  // acc[mt][nt][2 hh + i]: row 32 wr + 16 mt + g + 8 hh, block nt % 4 of
  // feature 32 cg + 16 wc + 8 (nt / 4) + 2 t + i
  Acc<float> acc;
  zero(acc);

  for (int blk = 0; blk < 3; ++blk) {   // dy's three blocks of Fout k
    // this thread's four rows' scaler (1 for d_mid itself: exact)
    float m[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rl = 32 * wr + 16 * mt + g + 8 * hh;
        m[mt][hh] = blk == 0 ? 1.f : blk == 1 ? s_sc1[rl] : s_sc2[rl];
      }
    for (int kk0 = 0; kk0 < Fout; kk0 += 16) {
      const unsigned char* tile = ring.acquire();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int kk = kk0 + 8 * ks;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float v[4] = {0.f, 0.f, 0.f, 0.f};
          if (live[mt]) {   // the rows past R are not in shared memory
            const int r0 = 32 * wr + 16 * mt + g;
            const float2 x0 = *reinterpret_cast<const float2*>(
                dm + at(r0, kk + 2 * t, Fout));
            const float2 x1 = *reinterpret_cast<const float2*>(
                dm + at(r0 + 8, kk + 2 * t, Fout));
            // dy's values, each rounded once as the plain version's are
            v[0] = __fmul_rn(m[mt][0], x0.x);
            v[1] = __fmul_rn(m[mt][1], x1.x);
            v[2] = __fmul_rn(m[mt][0], x0.y);
            v[3] = __fmul_rn(m[mt][1], x1.y);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah[mt][i] = tf32(v[i]);
            al[mt][i] = tf32(__fsub_rn(v[i], __uint_as_float(ah[mt][i])));
          }
        }
        const uint4* bp = reinterpret_cast<const uint4*>(
                              tile + ks * KB + wc * (KB / 2)) + lane;
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          const uint4 b = bp[np * (KB / 128)], bl = bp[np * (KB / 128) + 32];
          // a k-step's four chains from zero, their three passes in
          // turn (lo*hi, hi*lo, hi*hi: a pass waits on the one before it
          // in the same chain, not on the other chains)
          float p[2][2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int q = 0; q < 2; ++q)
#pragma unroll
              for (int i = 0; i < 4; ++i) p[mt][q][i] = 0.f;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            if (live[mt]) {
              mma_tf32(p[mt][0], al[mt], b.x, b.y);
              mma_tf32(p[mt][1], al[mt], b.z, b.w);
            }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            if (live[mt]) {
              mma_tf32(p[mt][0], ah[mt], bl.x, bl.y);
              mma_tf32(p[mt][1], ah[mt], bl.z, bl.w);
            }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            if (live[mt]) {
              mma_tf32(p[mt][0], ah[mt], b.x, b.y);
              mma_tf32(p[mt][1], ah[mt], b.z, b.w);
            }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            if (live[mt]) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                acc[mt][2 * np][i] = __fadd_rn(acc[mt][2 * np][i], p[mt][0][i]);
                acc[mt][2 * np + 1][i] =
                    __fadd_rn(acc[mt][2 * np + 1][i], p[mt][1][i]);
              }
            }
        }
      }
      ring.release(lane);
    }
  }

  // the coefficients, each (row, feature) from this thread's registers
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = 32 * wr + 16 * mt + g + 8 * hh, r = row0 + rl;
      if (rl >= R || r >= a.n_rows) continue;
      const int d = s_deg[rl];
      const bool nonempty = d > 0;
      const float denom = fmaxf((float)d, 1.f);
      const float* ax = a.aux + (size_t)r * 5 * F;
      const float* sdp = a.agg_cat + (size_t)r * 4 * F + 3 * F;
      float* o = a.cstk + (size_t)r * 7 * F;
#pragma unroll
      for (int fg = 0; fg < 2; ++fg) {
        const int f = FG * cg + 16 * wc + 8 * fg + 2 * t;
        auto ld2 = [&](const float* p) {
          return __ldg(reinterpret_cast<const float2*>(p + f));
        };
        const float2 mx = ld2(ax), mn = ld2(ax + F), mean = ld2(ax + 2 * F);
        const float2 tmx = ld2(ax + 3 * F), tmn = ld2(ax + 4 * F);
        const float2 sd = ld2(sdp);
        const float vmean[2] = {mean.x, mean.y}, vtmx[2] = {tmx.x, tmx.y};
        const float vtmn[2] = {tmn.x, tmn.y}, vsd[2] = {sd.x, sd.y};
        float c_lin[2], c_a[2], c_am[2], c_mx[2], c_mn[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float d_mx = acc[mt][4 * fg + 0][2 * hh + i];
          const float d_mn = acc[mt][4 * fg + 1][2 * hh + i];
          const float d_mean = acc[mt][4 * fg + 2][2 * hh + i];
          const float d_std = acc[mt][4 * fg + 3][2 * hh + i];
          c_lin[i] = nonempty ? d_mean / denom : 0.f;
          c_a[i] = d_std / (denom * vsd[i]);
          c_am[i] = __fmul_rn(c_a[i], vmean[i]);
          c_mx[i] = nonempty ? d_mx / fmaxf(vtmx[i], 1.f) : 0.f;
          c_mn[i] = nonempty ? d_mn / fmaxf(vtmn[i], 1.f) : 0.f;
        }
        auto st2 = [&](int blk, float x, float y) {
          *reinterpret_cast<float2*>(o + blk * F + f) = make_float2(x, y);
        };
        st2(0, c_lin[0], c_lin[1]);
        st2(1, c_a[0], c_a[1]);
        st2(2, c_am[0], c_am[1]);
        st2(3, mx.x, mx.y);
        st2(4, c_mx[0], c_mx[1]);
        st2(5, mn.x, mn.y);
        st2(6, c_mn[0], c_mn[1]);
      }
    }
}

}  // namespace

extern "C" {

// Every width must be a multiple of this.
int gnnb_scatter_bwd_width_multiple() { return CB; }

// Dynamic shared memory the backward needs for this d_mid width, in
// bytes: that of the fewest rows per CTA (the launcher takes more rows
// where they fit).
int gnnb_scatter_bwd_smem_bytes(int Fout) {
  return (int)smem_bytes(RSTEP, Fout);
}

// Rows per CTA of a launch at d_mid width Fout (0: none fits).
int gnnb_scatter_bwd_rows(int Fout) { return rows_for(Fout); }

// Registers per thread, shared memory per CTA (bytes) and resident CTAs
// per SM of the kernel at R rows per CTA and d_mid width Fout on the
// current device.
int gnnb_scatter_bwd_info(int rows, int Fout, int* regs, int* smem,
                          int* ctas_per_sm) {
  const int bytes = (int)smem_bytes(rows, Fout);
  cudaError_t err = cudaFuncSetAttribute(
      pna_scatter_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, pna_scatter_bwd_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  *smem = (int)fa.sharedSizeBytes + bytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, pna_scatter_bwd_kernel, THREADS, bytes);
}

// Launches the backward on `stream` of `device`: it writes the [N, 7F]
// coefficient rows into `cstk`.  All arrays contiguous f32 / i32 as
// documented in ops/cuda/scatter_bwd.py; the kernel reads ks_t from
// `staged` (stage_ks_t's stream, staged_bytes bytes, 16-byte aligned),
// not from `ks_t`.  Returns the cudaError_t of the launch (0 = success).
int gnnb_pna_scatter_bwd(const void* d_mid, const void* aux,
                         const void* agg_cat, const void* deg,
                         const void* ks_t, int n_rows, int F, int Fout,
                         float delta, void* cstk, void* stream, int device,
                         const void* staged, long long staged_bytes) {
  (void)ks_t;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (F % CB || Fout % CB || F < CB || Fout < CB || n_rows < 0 ||
      cstk == nullptr || staged == nullptr || ((uintptr_t)staged & 15) ||
      staged_bytes != (long long)3 * Fout * 4 * F * 8)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const int R = rows_for(Fout);
  if (R == 0) return (int)cudaErrorInvalidValue;
  ScatterArgs a;
  a.d_mid = (const float*)d_mid;
  a.aux = (const float*)aux;
  a.agg_cat = (const float*)agg_cat;
  a.deg = (const int*)deg;
  a.wst = (const unsigned char*)staged;
  a.cstk = (float*)cstk;
  a.n_rows = n_rows;
  a.F = F;
  a.Fout = Fout;
  a.rows = R;
  a.delta = delta;
  const size_t smem = smem_bytes(R, Fout);
  err = cudaFuncSetAttribute(pna_scatter_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_rows + R - 1) / R, F / FG);
  pna_scatter_bwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
