// The tensor-core building blocks shared by the kernels whose products run
// on mma.sync with their weights streamed through shared memory
// (pna_block.cu, mp_block.cu, scatter_bwd.cu, the GAT projection in
// gat_common.cuh, and tc_rows.cuh for mp_layer.cu and edge_block.cu): the swizzled row layouts of the A operands, the
// mbarrier and cp.async.bulk primitives, the consumers' side of a ring of
// weight tiles, a warp's accumulator tile of a 4 x 2 warp grid and its
// epilogue walk, and the mma.sync wrappers (m16n8k8 tf32, split TF32 in
// three passes, m16n8k16 bf16, m16n8k32 s8).  Device functions only:
// every kernel that includes this header keeps its own launch geometry
// and shared-memory carve-up.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gnnb_mma {

// ---------------------------------------------------------------- layout

// The XOR on the 4-byte word index of a row: rows r..r+3 of a fragment
// load land in distinct 8-word bank groups.
__device__ __forceinline__ int swz(int r) {
  return ((r & 1) << 4) | ((r & 2) << 2);
}
// word (float) offset of (r, c) in a row-major array of ld words
__device__ __forceinline__ int at(int r, int c, int ld) {
  return r * ld + (c ^ swz(r));
}
// byte offset of (r, c) in a row-major int8 array of ld bytes
__device__ __forceinline__ int atb(int r, int c, int ld) {
  return r * ld + (c ^ (swz(r) << 2));
}

// ---------------------------------------------- barriers and bulk copies

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Waits for the phase of `bar` with this parity to complete.  A wait that
// outlasts 2^28 polls (seconds; a tile takes microseconds) traps, so a
// broken pipeline fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::
          "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// bytes from global to shared memory, completion counted on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The consumers' side of a ring of S stages of TB bytes each: tile `it`
// sits in stage it % S and is the (it / S)-th fill of that stage.
template <int S, int TB> struct Ring {
  const unsigned char* base;
  uint32_t full, empty;
  int it;
  __device__ __forceinline__ const unsigned char* acquire() {
    const int s = it % S;
    mbar_wait(full + 8 * s, (it / S) & 1);
    return base + s * TB;
  }
  // The stage's next fill is a bulk copy (the async proxy) over what this
  // warp read with ordinary loads: without the proxy fence the copy could
  // land before those reads (bf16 outputs then varied from run to run).
  __device__ __forceinline__ void release(int lane) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (it % S));
    ++it;
  }
};

// ---------------------------------------------- a warp's accumulator tile

// acc[2][8][4]: a warp's 32 x 64 share of a [128, 128] product tile in a
// 4 x 2 grid of warps, as mma C fragments: acc[mt][nt][2 hh + i] is row
// 16 mt + g + 8 hh, column 8 nt + 2 t + i of the share (g = lane / 4,
// t = lane % 4).
template <typename T> using Acc = T[2][8][4];

template <typename T>
__device__ __forceinline__ void zero(Acc<T>& acc) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
}

// Calls f(mt, nt, hh, r, c) for each pair of accumulators acc[mt][nt][2hh],
// acc[mt][nt][2hh + 1] at tile row r and columns c, c + 1 of warp (wr,
// wc).  The positions are worked out anew at each call: hoisted out of a
// layer loop, the 32 addresses of each epilogue would stay live and spill.
template <typename Fn>
__device__ __forceinline__ void each_pair(int wr, int wc, int lane, Fn f) {
  asm volatile("" : "+r"(lane));
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        f(mt, nt, hh, 32 * wr + 16 * mt + g + 8 * hh, 64 * wc + 8 * nt + 2 * t);
}

// ------------------------------------------------------------ tensor cores

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b on the float64 tensor cores, m8n8k4: lane l holds A's (row
// l / 4, k l % 4), B's (k l % 4, column l / 4) and D's row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1
__device__ __forceinline__ void mma_f64(double (&d)[2], double a,
                                        double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1}, {%2}, {%3}, {%0,%1};"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// one product with both tf32 halves of a and b: lo*hi + hi*lo + hi*hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

}  // namespace gnnb_mma
