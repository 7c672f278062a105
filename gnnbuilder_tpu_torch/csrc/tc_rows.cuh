// The tensor-core rows product shared by the mp layer kernel (mp_layer.cu,
// gin and sage), the EdgeConv kernel (edge_block.cu) and the GINE kernel
// (gine_layer.cu): a CTA's R = 128 rows, held in shared memory, times a
// weight matrix that the kernel reads row-major from device memory as the
// caller passes it (Stream), or as the caller has laid it out on the card
// (Ring, below), one 128-column tile of the output at a time, on
// mma.sync; with the epilogue's store (store_out) and gin's bf16 Z on the
// float64 tensor cores (gin_z_f64).
//
// Geometry.  256 threads, 8 warps in a 4 x 2 grid (mp_block.cu's): warp
// (wr, wc) owns rows 32 wr .. 32 wr + 31 (two m16 tiles) and columns 64 wc
// .. 64 wc + 63 (eight n8 tiles) of every [128, 128] output tile, 64
// accumulators a thread; a k-step's A fragments feed eight n-tiles.  Where
// 128 rows do not fit the card's shared memory (the mp layer at hidden
// 384), a CTA takes 64 rows in a 2 x 4 grid of 32 x 32 warp tiles.  The
// m-tiles past the rows a caller marks valid and the n-tiles past the
// matrix's columns are skipped (warp-uniform; a full tile takes a path
// with no test), so a short tile (an EdgeConv chunk of few valid slots,
// the last layer's 64 columns) costs only its own tiles.  A first version
// with 64 rows and 32 x 32 warp tiles spent most of its issue slots on
// fragment traffic and chain latency at 16 warps an SM, and its 292 CTAs
// on the train batch took two rounds on 132 SMs at two CTAs an SM (PERF.md
// §6).
//
// Weights, with no host work.  A pass streams its k-chunks (2 mma k-steps:
// 16 k in f32, 32 in bf16, 64 in int8) from the caller's row-major [K, N]
// matrix (float32, bf16 or int8: the kernels' mode) through registers
// into one of two shared-memory stages, already in the order of the mma
// B fragments: each thread loads 4 fragment units (a lane's two registers
// of one n8 tile and k-step) with coalesced 32-byte sectors, and in f32
// splits them into TF32 halves once per CTA (tf32r: two integer
// instructions, where cvt.rna.tf32.f32 compiles to five); a warp then
// reads a fragment as one 16-byte (f32) or 8-byte load, conflict-free.
// The next chunk's loads are issued before the current chunk's products,
// so their latency hides behind them; one barrier a chunk.  A pass may
// name the pass after it, whose first chunk then goes to the other stage
// during its last chunk (a kernel's first pass is staged by the kernel,
// overlapped with its gather).  Where two stages do not fit beside the
// rows, one stage is refilled between two barriers.  What bounds a chunk
// on the H100 is latency, not the tensor cores: copies without the MMAs,
// or without the weight loads, ran at most 15 % faster (PERF.md §6;
// bench/mp_edge_variants.py).
//
// Products (quant.cuh's modes):
//   F32  m16n8k8 TF32 in three passes, hi*hi + hi*lo + lo*hi (hi =
//        tf32r(a), lo = tf32r(a - hi)); each k-step's chain starts from zero
//        and is added into the float32 accumulator with __fadd_rn (the
//        tensor cores truncate a chain's running sum).
//   BF16 m16n8k16 bf16; each chunk's chain of 32 k from zero, added with
//        __fadd_rn; A rows hold bf16-rounded values, so packing is exact.
//   INT8 m16n8k32 s8 on rows quantized once (quantize_rows, quant.cuh's
//        formulas), an exact int32 sum; the caller scales it by s_row *
//        s_col (value()).
// The k order inside a k-step is permuted (a lane reads 2E consecutive k
// of a row, E = 1, 2, 4 values a register), and the B fragments are laid
// out to match, as mp_block.cu's are.
//
// A rows: float32 (F32, BF16; INT8 before quantization) at a row stride of
// lda_of(K) floats, int8 levels at ldq_of(K) bytes, columns past K zero up
// to kpad(K): the strides make every fragment load conflict-free.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_ring.cuh"
#include "quant.cuh"

namespace gnnb_tc {

using gnnb_quant::BF16;
using gnnb_quant::F32;
using gnnb_quant::INT8;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NC = 128;    // output columns of a pass
constexpr int MT = 2;      // m16 tiles a warp
constexpr int LDY = NC + 8;   // row stride (floats) of an f32 output tile

// A CTA of R rows (128, or 64 where 128 do not fit the card's shared
// memory): WR x WC warps, each 32 rows and 8 NT columns.
template <int R> struct Geo {
  static_assert(R == 128 || R == 64, "128 or 64 rows");
  static constexpr int WR = R / 32, WC = WARPS / WR, NT = NC / (8 * WC);
};

// k of one mma, of a chunk (two k-steps), bytes of a chunk in shared
// memory (2 k-steps x 16 n-tiles x 32 lanes x a lane's registers)
__host__ __device__ constexpr int kstep(int mode) {
  return mode == F32 ? 8 : mode == BF16 ? 16 : 32;
}
__host__ __device__ constexpr int kchunk(int mode) { return 2 * kstep(mode); }
__host__ __device__ constexpr int chunk_bytes(int mode) {
  return 2 * 16 * 32 * (mode == F32 ? 16 : 8);
}
// K rounded up to whole chunks
__host__ __device__ inline int kpad(int K, int mode) {
  const int kc = kchunk(mode);
  return (K + kc - 1) / kc * kc;
}
// row stride (floats) of a float32 A operand: == 8 or 24 mod 32 for the
// F32 float2 loads, 16 mod 32 for the BF16 float4 loads
__host__ __device__ inline int lda_of(int K, int mode) {
  return kpad(K, mode) + (mode == BF16 ? 16 : 8);
}
// row stride (bytes) of int8 levels: 32 or 96 mod 128 for the uint2 loads
__host__ __device__ inline int ldq_of(int K) { return kpad(K, INT8) + 32; }
__host__ __device__ inline int align16(int b) { return (b + 15) & ~15; }

template <int MODE> struct AccOf { using T = float; };
template <> struct AccOf<INT8> { using T = int; };
template <int MODE, int R>
using Acc = typename AccOf<MODE>::T[MT][Geo<R>::NT][4];

template <int MODE, int R>
__device__ __forceinline__ void zero(Acc<MODE, R>& acc) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < Geo<R>::NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0;
}

// x rounded to tf32 (nearest, ties away: cvt.rna's result for every finite
// x and infinity) in two integer instructions
__device__ __forceinline__ uint32_t tf32r(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// One pass: columns n0 .. n0 + 127 of a matrix [K, N] (row stride ldw,
// the mode's type) against A's K columns.
struct Pass {
  const void* w;
  int ldw, K, N, n0;
};

// A thread's share of one chunk of a pass: for each of its 4 fragment
// units, the lane's two B registers (F32: two floats, split at store()).
template <int MODE> struct Chunk {
  uint32_t raw[4][2];

  __device__ __forceinline__ void load(const Pass& p, int kc) {
    constexpr int KS = kstep(MODE);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int u = threadIdx.x + THREADS * q;
      const int lane = u & 31, nt = (u >> 5) & 15, ks = u >> 9;
      const int n = p.n0 + 8 * nt + (lane >> 2), t = lane & 3;
      const int k0 = kc * 2 * KS + ks * KS;
      const bool nok = n < p.N;
      if constexpr (MODE == F32) {
        const float* W = static_cast<const float*>(p.w);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int k = k0 + 2 * t + i;
          raw[q][i] = nok && k < p.K
                          ? __float_as_uint(__ldg(W + (size_t)k * p.ldw + n))
                          : 0u;
        }
      } else if constexpr (MODE == BF16) {
        const unsigned short* W = static_cast<const unsigned short*>(p.w);
        uint32_t h[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + 4 * t + i;
          h[i] = nok && k < p.K ? (uint32_t)__ldg(W + (size_t)k * p.ldw + n)
                                : 0u;
        }
        raw[q][0] = h[0] | (h[1] << 16);
        raw[q][1] = h[2] | (h[3] << 16);
      } else {
        const unsigned char* W = static_cast<const unsigned char*>(p.w);
        uint32_t b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int k = k0 + 8 * t + i;
          b[i] = nok && k < p.K ? (uint32_t)__ldg(W + (size_t)k * p.ldw + n)
                                : 0u;
        }
        raw[q][0] = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
        raw[q][1] = b[4] | (b[5] << 8) | (b[6] << 16) | (b[7] << 24);
      }
    }
  }

  // into a stage: unit u at its fragment slot ((ks 16 + nt) 32 + lane)
  __device__ __forceinline__ void store(unsigned char* stage) const {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int u = threadIdx.x + THREADS * q;
      if constexpr (MODE == F32) {
        const float f0 = __uint_as_float(raw[q][0]);
        const float f1 = __uint_as_float(raw[q][1]);
        const uint32_t h0 = tf32r(f0), h1 = tf32r(f1);
        reinterpret_cast<uint4*>(stage)[u] = make_uint4(
            h0, h1, tf32r(__fsub_rn(f0, __uint_as_float(h0))),
            tf32r(__fsub_rn(f1, __uint_as_float(h1))));
      } else {
        reinterpret_cast<uint2*>(stage)[u] = make_uint2(raw[q][0], raw[q][1]);
      }
    }
  }
};

// acc += A[this warp's rows, chunk kc] W[chunk kc, this warp's columns].
// FULL: all MT x NT tiles and no test in the loop, so the compiler
// interleaves the independent chains; else the m-tiles below mts and the
// n-tiles below nts.
template <int MODE, int R, bool FULL>
__device__ __forceinline__ void mma_step(Acc<MODE, R>& acc, const void* A,
                                         int lda, int kc,
                                         const unsigned char* stage, int wr,
                                         int wc, int lane, int mts, int nts) {
  constexpr int NT = Geo<R>::NT;
  const int g = lane >> 2, t = lane & 3;
  auto live = [&](int mt, int j) { return FULL || (mt < mts && j < nts); };
  if constexpr (MODE == F32) {
    const float* Af = static_cast<const float*>(A);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int k = kc * 16 + ks * 8 + 2 * t;
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = 32 * wr + 16 * mt + g;
        const float2 x0 = *reinterpret_cast<const float2*>(Af + r0 * lda + k);
        const float2 x1 =
            *reinterpret_cast<const float2*>(Af + (r0 + 8) * lda + k);
        const float v[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[mt][i] = tf32r(v[i]);
          al[mt][i] = tf32r(__fsub_rn(v[i], __uint_as_float(ah[mt][i])));
        }
      }
      const uint4* bp =
          reinterpret_cast<const uint4*>(stage) + (ks * 16 + NT * wc) * 32 + lane;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (!live(0, j)) continue;
        const uint4 b = bp[32 * j];
        float p[MT][4];   // a k-step's chains from zero
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) p[mt][i] = 0.f;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          if (live(mt, j)) gnnb_mma::mma_tf32(p[mt], al[mt], b.x, b.y);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          if (live(mt, j)) gnnb_mma::mma_tf32(p[mt], ah[mt], b.z, b.w);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          if (live(mt, j)) gnnb_mma::mma_tf32(p[mt], ah[mt], b.x, b.y);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[mt][j][i] = __fadd_rn(acc[mt][j][i], p[mt][i]);
      }
    }
  } else if constexpr (MODE == BF16) {
    const float* Af = static_cast<const float*>(A);
    uint32_t a[2][MT][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = 32 * wr + 16 * mt + g;
        const int k = kc * 32 + ks * 16 + 4 * t;
        const float4 y0 = *reinterpret_cast<const float4*>(Af + r0 * lda + k);
        const float4 y1 =
            *reinterpret_cast<const float4*>(Af + (r0 + 8) * lda + k);
        a[ks][mt][0] = gnnb_mma::pack_bf16(y0.x, y0.y);
        a[ks][mt][1] = gnnb_mma::pack_bf16(y1.x, y1.y);
        a[ks][mt][2] = gnnb_mma::pack_bf16(y0.z, y0.w);
        a[ks][mt][3] = gnnb_mma::pack_bf16(y1.z, y1.w);
      }
    const uint2* bp = reinterpret_cast<const uint2*>(stage) + NT * wc * 32 + lane;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (!live(0, j)) continue;
      const uint2 b0 = bp[32 * j], b1 = bp[32 * (16 + j)];
      float p[MT][4];   // the chunk's chain of 32 k from zero
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) p[mt][i] = 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        if (live(mt, j)) gnnb_mma::mma_bf16(p[mt], a[0][mt], b0.x, b0.y);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        if (live(mt, j)) gnnb_mma::mma_bf16(p[mt], a[1][mt], b1.x, b1.y);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[mt][j][i] = __fadd_rn(acc[mt][j][i], p[mt][i]);
    }
  } else {
    const unsigned char* Aq = static_cast<const unsigned char*>(A);
    uint32_t a[2][MT][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = 32 * wr + 16 * mt + g;
        const int k = kc * 64 + ks * 32 + 8 * t;
        const uint2 z0 = *reinterpret_cast<const uint2*>(Aq + r0 * lda + k);
        const uint2 z1 =
            *reinterpret_cast<const uint2*>(Aq + (r0 + 8) * lda + k);
        a[ks][mt][0] = z0.x;
        a[ks][mt][1] = z1.x;
        a[ks][mt][2] = z0.y;
        a[ks][mt][3] = z1.y;
      }
    const uint2* bp = reinterpret_cast<const uint2*>(stage) + NT * wc * 32 + lane;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (!live(0, j)) continue;
      const uint2 b0 = bp[32 * j], b1 = bp[32 * (16 + j)];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        if (live(mt, j)) {
          gnnb_mma::mma_s8(acc[mt][j], a[0][mt], b0.x, b0.y);
          gnnb_mma::mma_s8(acc[mt][j], a[1][mt], b1.x, b1.y);
        }
    }
  }
}

// acc += A[0:R, 0:K] W[0:K, p.n0 + 0:128] through the weight stream ws
// (Stream or Ring: ws.walk(p, next, has_next, step) calls step(kc, stage)
// on each chunk of p and ends with a barrier).  rows: the valid rows of A
// (m-tiles past them skipped).  Every thread calls it.  Inlined: acc
// passed by reference to a call would live in local memory.
template <int MODE, int R, class WS>
__device__ __forceinline__ void product(WS& ws, Acc<MODE, R>& acc,
                                        const void* A, int lda, const Pass p,
                                        int rows, const Pass next,
                                        bool has_next) {
  using G = Geo<R>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp % G::WR, wc = warp / G::WR;
  const int mts = min(max((rows - 32 * wr + 15) / 16, 0), MT);
  const int nts = min(max((p.N - p.n0 - 8 * G::NT * wc + 7) / 8, 0), G::NT);
  const bool full = mts == MT && nts == G::NT;
  ws.walk(p, next, has_next, [&](int kc, const unsigned char* st) {
    if (full)
      mma_step<MODE, R, true>(acc, A, lda, kc, st, wr, wc, lane, mts, nts);
    else
      mma_step<MODE, R, false>(acc, A, lda, kc, st, wr, wc, lane, mts, nts);
  });
}

// The weight stream of a kernel: `wbuf` holds `stages` (1 or 2) chunk
// stages; `cur` is the stage that holds the next pass's first chunk.
template <int MODE, int R> struct Stream {
  unsigned char* wbuf;
  int stages, cur;
  Chunk<MODE> ch;

  __device__ __forceinline__ unsigned char* stage(int s) {
    return wbuf + s * chunk_bytes(MODE);
  }
  // first chunk of pass p: issue its loads (prefetch), then later store it
  // into the current stage; the caller puts a barrier between the store and
  // the pass
  __device__ __forceinline__ void prefetch(const Pass& p) { ch.load(p, 0); }
  __device__ __forceinline__ void stage_prefetched() { ch.store(stage(cur)); }

  // acc += A[0:R, 0:K] W[0:K, p.n0 + 0:128], the first chunk already
  // staged at `cur`; with has_next, next's first chunk is staged during
  // the last chunk (product()).
  __device__ __forceinline__ void run(Acc<MODE, R>& acc, const void* A,
                                      int lda, const Pass p, int rows,
                                      const Pass next, bool has_next) {
    product<MODE, R>(*this, acc, A, lda, p, rows, next, has_next);
  }

  // The chunk loop of run(): step(kc, stage) on each staged chunk of p,
  // the next chunk (or next's first) loaded meanwhile; ends with a barrier.
  template <typename Step>
  __device__ __forceinline__ void walk(const Pass p, const Pass next,
                                       bool has_next, Step step) {
    const int nk = kpad(p.K, MODE) / kchunk(MODE);
    for (int kc = 0; kc < nk; ++kc) {
      const bool more = kc + 1 < nk, load = more || has_next;
      if (more)
        ch.load(p, kc + 1);
      else if (has_next)
        ch.load(next, 0);
      step(kc, stage(cur));
      if (load) {
        if (stages == 1) {
          __syncthreads();
        } else {
          cur ^= 1;
        }
        ch.store(stage(cur));
      }
      __syncthreads();
    }
  }
};

// The weight stream of a kernel whose weights the caller has laid out on
// the card in the order the kernel walks its chunks: each pass's column
// tiles in turn, each tile's k-chunks in turn, each chunk as Chunk::store
// lays a stage out (fragment order, f32 split into TF32 halves;
// ops/cuda/gine_layer.py stage_weights), chunk i at src + i
// chunk_bytes(MODE).  `stages` (>= 2) stages in shared memory are filled
// by cp.async.bulk, each counted on an mbarrier (full); every warp marks a
// stage read on a second one (empty), and thread 0, one of the consumers
// (no producer warp: 256 threads keep their registers), refills a stage
// once every warp has read it: with three stages or more the stage of the
// chunk before the one its warp has just read (stages - 2 chunks in
// flight during a chunk's products, warps up to a chunk apart), with two
// that of the chunk just read (one in flight; the refill waits for the
// slowest warp).  No CTA-wide barrier runs per chunk: one ends each pass,
// where a caller may overwrite the pass's A.
template <int MODE, int R> struct Ring {
  unsigned char* wbuf;          // stages x chunk_bytes(MODE)
  uint32_t bar;                 // full[s] at bar + 8 s, empty[s] after them
  const unsigned char* src;     // the laid-out chunks
  int stages, n, it;            // stages; chunks in all; chunks read

  __device__ __forceinline__ uint32_t full(int s) const { return bar + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bar + 8 * (stages + s);
  }
  __device__ __forceinline__ void issue(int i) const {
    constexpr int CB = chunk_bytes(MODE);
    const int s = i % stages;
    gnnb_mma::mbar_expect_tx(full(s), CB);
    gnnb_mma::bulk_copy(gnnb_mma::smem_addr(wbuf + s * CB),
                        src + (size_t)i * CB, CB, full(s));
  }
  // thread 0 sets the barriers up and issues the first chunks; a barrier
  // of the caller's (after its gather) comes before the first wait
  __device__ __forceinline__ void start() const {
    if (threadIdx.x != 0) return;
    for (int s = 0; s < stages; ++s) {
      gnnb_mma::mbar_init(full(s), 1);
      gnnb_mma::mbar_init(empty(s), WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < min(stages, n); ++i) issue(i);
  }

  // step(kc, stage) on each chunk of p, in the sequence's order; ends
  // with a barrier.  (next, has_next: Stream's; the sequence holds them.)
  template <typename Step>
  __device__ __forceinline__ void walk(const Pass p, const Pass, bool,
                                       Step step) {
    const int nk = kpad(p.K, MODE) / kchunk(MODE);
    const int lane = threadIdx.x & 31;
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % stages;
      gnnb_mma::mbar_wait(full(s), (it / stages) & 1);
      step(kc, wbuf + s * chunk_bytes(MODE));
      // the stage's next fill is an async-proxy write over these reads
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) gnnb_mma::mbar_arrive(empty(s));
      const int q = stages >= 3 ? it - 1 : it;   // the stage to refill
      if (threadIdx.x == 0 && q >= 0 && q + stages < n) {
        gnnb_mma::mbar_wait(empty(q % stages), (q / stages) & 1);
        issue(q + stages);
      }
      __syncwarp();
    }
    __syncthreads();
  }

  __device__ __forceinline__ void run(Acc<MODE, R>& acc, const void* A,
                                      int lda, const Pass p, int rows,
                                      const Pass next, bool has_next) {
    product<MODE, R>(*this, acc, A, lda, p, rows, next, has_next);
  }
};

// Calls f(mt, j, hh, r, c) for each pair of accumulators acc[mt][j][2 hh],
// [2 hh + 1] of this thread: tile row r, columns c, c + 1.
template <int R, typename Fn>
__device__ __forceinline__ void each_pair(Fn f) {
  using G = Geo<R>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp % G::WR, wc = warp / G::WR, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        f(mt, j, hh, 32 * wr + 16 * mt + g + 8 * hh,
          8 * G::NT * wc + 8 * j + 2 * t);
}

// A product's value: INT8 float(sum) * s_row * s_col (the JAX package's
// _qdot), else the float32 sum.
template <int MODE, typename TAcc>
__device__ __forceinline__ float value(TAcc acc, float sr, const float* sw,
                                       int c) {
  if constexpr (MODE == INT8)
    return __fmul_rn(__fmul_rn((float)acc, sr), __ldg(sw + c));
  else
    return acc;
}

// Q[r, 0:K) = the int8 levels of A[r, 0:K) (row stride lda floats, into
// ldq bytes) with row scales sq[r], rows [0, R), one warp a row (quant.cuh's
// formulas, the level by RowScale: the IEEE quotient's), four columns a
// lane (K, lda and ldq are multiples of 4).  Zero pad columns neither move
// the scale nor get a level other than 0.
template <int R>
__device__ __forceinline__ void quantize_rows(const float* A, int lda, int K,
                                              int8_t* Q, int ldq, float* sq) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += WARPS) {
    const float* a = A + (size_t)r * lda;
    float m = 0.f;
    for (int k = 4 * lane; k < K; k += 128) {
      const float4 v = *reinterpret_cast<const float4*>(a + k);
      m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                         fmaxf(fabsf(v.z), fabsf(v.w))));
    }
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const gnnb_quant::RowScale rs(gnnb_quant::quant_scale(m));
    for (int k = 4 * lane; k < K; k += 128) {
      const float4 v = *reinterpret_cast<const float4*>(a + k);
      *reinterpret_cast<uint32_t*>(Q + (size_t)r * ldq + k) =
          rs.level(v.x) | (rs.level(v.y) << 8) | (rs.level(v.z) << 16) |
          (rs.level(v.w) << 24);
    }
    if (lane == 0) sq[r] = rs.s;
  }
}

// gelu, sigmoid, tanh: out of line, so the epilogues inline only relu and
// the identity (as mp_block.cu: inlined, the three slowed its epilogues)
static __device__ __noinline__ float act_call(float x, int act) {
  switch (act) {
    case 2: return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
    case 3: return 1.f / (1.f + expf(-x));
    default: return tanhf(x);
  }
}

// act: 0 none, 1 relu, 2 gelu (erf), 3 sigmoid, 4 tanh
__device__ __forceinline__ float act(float x, int a) {
  return a == 1 ? fmaxf(x, 0.f) : a == 0 ? x : act_call(x, a);
}

// out[row0 + r, n0 + c] = act(o [+ skip]) for this thread's accumulator
// pairs, o = o_of(mt, j, 2 hh + i, r, column) for the valid rows and
// columns; four n-tiles' skip loads issued together (one at a time, the
// epilogue waited on each).  a: a kernel's arguments (out, skip, Fout,
// act).
template <int R, class Args, typename Fn>
__device__ __forceinline__ void store_out(const Args& a, int row0, int rows,
                                          int n0, Fn o_of) {
  using G = Geo<R>;
  const int Fout = a.Fout;
  const bool pair = (Fout & 1) == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp % G::WR, wc = warp / G::WR;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 32 * wr + 16 * mt + (lane >> 2) + 8 * hh;
      if (r >= rows) continue;
      const size_t orow = (size_t)(row0 + r) * Fout;
#pragma unroll
      for (int j0 = 0; j0 < G::NT; j0 += 4) {
        float2 sk[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + 8 * G::NT * wc + 8 * (j0 + j) + 2 * (lane & 3);
          sk[j] = make_float2(0.f, 0.f);
          if (a.skip == nullptr || c >= Fout) continue;
          if (pair)
            sk[j] = *reinterpret_cast<const float2*>(a.skip + orow + c);
          else
            sk[j] = make_float2(a.skip[orow + c],
                                c + 1 < Fout ? a.skip[orow + c + 1] : 0.f);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + 8 * G::NT * wc + 8 * (j0 + j) + 2 * (lane & 3);
          if (c >= Fout) continue;
          float o[2] = {o_of(mt, j0 + j, 2 * hh, r, c),
                        c + 1 < Fout ? o_of(mt, j0 + j, 2 * hh + 1, r, c + 1)
                                     : 0.f};
          if (a.skip != nullptr) {
            o[0] = __fadd_rn(o[0], sk[j].x);
            o[1] = __fadd_rn(o[1], sk[j].y);
          }
          o[0] = act(o[0], a.act);
          o[1] = act(o[1], a.act);
          if (pair) {
            *reinterpret_cast<float2*>(a.out + orow + c) =
                make_float2(o[0], o[1]);
          } else {
            a.out[orow + c] = o[0];
            if (c + 1 < Fout) a.out[orow + c + 1] = o[1];
          }
        }
      }
    }
}

// GIN's Z pre-activation columns n0 .. n0 + 127 in the BF16 mode, 64 rows
// a CTA: T W0 on the float64 tensor cores (m8n8k4: the products of bf16
// values are exact in double and their sums float64, exact for any K a
// layer has), rounded to float32 once, as the plain versions form it (a
// float64 product).  Z is rounded to bf16 next, so its pre-rounding value
// must be the plain version's: a float32 chain in another order than the
// plain version's flips a bf16 rounding now and then (2^-8 of a value;
// 3.4e-3 of max off plain at F = 128 on the bf16 tensor cores' chains,
// over the mode's 2e-3).  W0 comes through the stream's bf16 chunks (32 k
// each, fragment order: unit (ks 16 + nt) 32 + 4 g + t holds k 16 ks + 4
// t .. + 3 of column 8 nt + g).  Each warp takes its 32 rows and 32
// columns; z[m][j][i] is row 32 wr + 8 m + lane / 4, column 32 wc + 8 j +
// 2 (lane % 4) + i of the tile.  ws: a Stream or a Ring of 64 rows.
template <class WS>
__device__ __forceinline__ void gin_z_f64(WS& ws, const float* T, int ldT,
                                          const Pass p, const Pass next,
                                          float (&z)[4][4][2]) {
  using G = Geo<64>;
  static_assert(G::NT == 4, "32 columns a warp");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp % G::WR, wc = warp / G::WR;
  const int l4 = lane >> 2, lm = lane & 3;
  double d[4][4][2];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) d[m][j][0] = d[m][j][1] = 0.0;
  ws.walk(p, next, true, [&](int kc, const unsigned char* st) {
    const uint2* w2 = reinterpret_cast<const uint2*>(st);
#pragma unroll
    for (int q = 0; q < 8; ++q) {   // 4 k at a time
      const int k = kc * 32 + 4 * q + lm;   // T's columns past K are zero
      double av[4], bv[4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        av[m] = (double)T[(32 * wr + 8 * m + l4) * ldT + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint2 u =
            w2[((q >> 2) * 16 + G::NT * wc + j) * 32 + 4 * l4 + (q & 3)];
        const uint32_t h = ((lm < 2 ? u.x : u.y) >> (16 * (lm & 1))) & 0xffffu;
        bv[j] = (double)__uint_as_float(h << 16);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) gnnb_mma::mma_f64(d[m][j], av[m], bv[j]);
    }
  });
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) z[m][j][i] = (float)d[m][j][i];
}

}  // namespace gnnb_tc
