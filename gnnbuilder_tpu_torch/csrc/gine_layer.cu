// One GINE layer: the per-slot messages relu(x_j + pe_e) summed over each
// receiver's valid ELL slots, then GIN's MLP, in one kernel.
//
// Replaces: gnnbuilder_tpu/ops/pallas/gine_layer.py fused_gine_layer
// (kernel body _kernel).  For every row r, over its slots w < deg[r] in
// slot order, with j = nbr[r, w] and e = nbr_e[r, w] (pe = lin_edge of the
// edge features, in the batch's packed edge order, formed by the caller):
//
//   s[r] = sum_w relu(x[j] + pe[e])
//   o    = relu(((1 + eps) x[r] + s) W0 + b0) W1 + b1
//   out  = act(o [+ skip])           (skip added before the activation)
//
// Pad slots (w >= deg[r]) are never read: they point at pad edges, whose
// pe is lin_edge's bias and not 0, so the TPU kernel's reliance on a zero
// gathered row would not hold for them.
//
// What bounds it on the H100: bytes at width 128.  The products' 2 F H +
// 2 H Fout flops a row take ~6 us of the train batch at min(67 TFLOP/s,
// 3 x TF32 at 495) against ~15 us for its x, pe, skip and out at the
// memory rate.
//
// Design.  The TPU kernel's one-hot gathers over a node window and an
// edge window (hi/lo bf16 passes, window DMAs) existed because Mosaic has
// no dynamic row gather; here an indexed load is exact.  A CTA owns R
// rows.  Its T = (1 + eps) x + s is formed in shared memory in
// tc_rows.cuh's A layout (gine_rows: a warp two rows at a time, each
// row's slot and edge ids loaded once and shared by __shfl_sync, four
// columns a lane as float4 where F % 4 == 0, two slots' loads of both
// rows issued before their adds, the adds in slot order), then GIN's MLP
// runs on the tensor cores (gine_mlp: mp_layer.cu's gin MLP, on
// tc_rows.cuh): Z = relu(T W0 + b0) in shared memory, then out.  Two
// weight paths, a template argument:
//   * the Ring (tc_rows.cuh): the layer's W0 and W1 laid out on the card
//     in the order the CTA reads them (ops/cuda/gine_layer.py
//     stage_weights: fragment order, f32 split into TF32 halves) and
//     streamed by cp.async.bulk into 2..6 stages, counted on mbarriers,
//     refilled by thread 0 (one of the consumers, so the CTA keeps 256
//     threads); no barrier per chunk.  The first chunks are in flight
//     during the gather.  64 rows a CTA, three CTAs an SM in f32 and int8
//     (gine_shape says why);
//   * the Stream (tc_rows.cuh): the caller's row-major weights through
//     registers into two stages, one barrier a chunk (mp_layer.cu's path);
//     128 rows where they fit, else 64; what the launcher takes when no
//     layout is given or the Ring's stages do not fit (hidden 384).
// Products (quant.cuh's modes): F32 3 x TF32 chains from zero per k-step,
// BF16 bf16 chains of 32 k, INT8 s8 on rows quantized once (T, then Z).
//
// Modes (a template argument; inference only), the JAX kernel's
// gather_mode="bf16" with mm="bf16", and quant:
//   BF16 (1): both gathered rows, x_j and pe_e, are rounded to bf16
//        before relu(x_j + pe_e), the sum float32; T and Z are stored
//        rounded, W0 and W1 are bf16; Z's pre-activation T W0 is the
//        float64 product rounded once (gin_z_f64, 64 rows a CTA): Z is
//        rounded to bf16 next, and only a correctly rounded product
//        rounds as the plain version's does.
//   INT8 (2): both MLP products quantize their operand rows (per-row
//        scales, quant.cuh's formulas) against int8 weights with
//        per-column scales, an exact int32 sum; the aggregation stays
//        exact.  lin_edge stays outside the kernel.
// T = (1 + eps) x + s is formed with two roundings (no fused
// multiply-add), as the plain version forms it: an ulp before a bf16
// rounding or an int8 quantization moves a value, and the whole row's
// output with it.  No float is added atomically: every launch gives the
// same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_rows.cuh"

namespace {

namespace tc = gnnb_tc;
using gnnb_quant::bf16r;
using gnnb_quant::BF16;
using gnnb_quant::F32;
using gnnb_quant::INT8;

// the Ring's stages: at three CTAs an SM 3, or 2 where 3 do not fit (f32,
// whose chunks hold both TF32 halves: 16 KB); at two up to 6
constexpr int RING_MIN = 2, RING_THREE = 3, RING_MAX = 6;

struct GineArgs {
  const float* x;      // [N, F]
  const float* pe;     // [E, F]
  const int* nbr;      // [N, W]
  const int* nbr_e;    // [N, W]
  const int* deg;      // [N]
  const void* w0;      // [F, H] (the mode's type)
  const float* b0;     // [H]
  const void* w1;      // [H, Fout]
  const float* b1;     // [Fout]
  const float* sw0;    // [H] column scales of w0 (INT8)
  const float* sw1;    // [Fout] column scales of w1 (INT8)
  const float* skip;   // [N, Fout] or null
  float* out;          // [N, Fout]
  const unsigned char* staged;   // the Ring's chunks (or null)
  int n_rows, W, F, H, Fout, act;
  float eps;
  int stages, n_chunks;
  bool vec;            // F % 4 == 0 and x, pe 16-byte aligned
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Byte offsets in dynamic shared memory: the weight stages at 0, T (Z
// over it where one column tile of W0 makes T dead by then, H <= 128, and
// always in INT8, whose products read T's levels), Z otherwise, the int8
// levels QT (T's, then Z's), the row scales, the Ring's barriers.
struct GineLayout {
  int ldT, ldZ, ldqT, ldqZ, T, Z, QT, SQ, BAR, bytes;
};

__host__ __device__ inline GineLayout gine_layout(int F, int H, int mode,
                                                  bool ring, int stages,
                                                  int R) {
  GineLayout L;
  L.ldT = tc::lda_of(F, mode);
  L.ldZ = tc::lda_of(H, mode);
  L.ldqT = tc::ldq_of(F);
  L.ldqZ = tc::ldq_of(H);
  const bool z_over_t = mode == INT8 || H <= tc::NC;
  L.T = stages * tc::chunk_bytes(mode);
  const int t_end = L.T + R * (z_over_t ? imax(L.ldT, L.ldZ) : L.ldT) * 4;
  L.Z = z_over_t ? L.T : tc::align16(t_end);
  L.QT = tc::align16(z_over_t ? t_end : L.Z + R * L.ldZ * 4);
  const bool q = mode == INT8;
  L.SQ = tc::align16(L.QT + (q ? R * imax(L.ldqT, L.ldqZ) : 0));
  L.BAR = (L.SQ + (q ? R * 4 : 0) + 7) & ~7;
  L.bytes = L.BAR + (ring ? 16 * stages : 0);
  return L;
}

__device__ __forceinline__ void ldv(float (&v)[4], const float* p) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void ldv(float (&v)[1], const float* p) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void stv(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void stv(float* p, const float (&v)[1]) {
  *p = v[0];
}

// T[i, 0:kp) of the CTA's rows: (1 + eps) x[r] + s[r] rounded twice (s:
// the messages over the row's valid slots in slot order; BF16: x_j and
// pe_e rounded to bf16 before the relu, T stored rounded), zero past
// `rows` and in the pad columns.  A warp takes RB rows at a time; lane w
// loads slot w's node and edge ids (32 slots at a time), which the row's
// lanes read by __shfl_sync; each lane takes V columns (float4 where F %
// 4 == 0); G slots' loads of the RB rows are issued before their adds
// (four slots spilled the registers the weight stream holds meanwhile).
template <int MODE, int R, int V>
__device__ __forceinline__ void gine_rows(const GineArgs& a, int row0,
                                          int rows, float* T, int ldT,
                                          int kp) {
  constexpr bool RND = MODE == BF16;
  constexpr int RB = 2, G = 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int F = a.F, W = a.W;
  const float ope = 1.f + a.eps;
  for (int i0 = RB * warp; i0 < R; i0 += RB * tc::WARPS) {
    int d[RB];
#pragma unroll
    for (int q = 0; q < RB; ++q)
      d[q] = i0 + q < rows ? __ldg(a.deg + row0 + i0 + q) : 0;
    const int most = max(d[0], d[1]);
    for (int c0 = 0; c0 < kp; c0 += 32 * V) {
      const int c = c0 + V * lane;
      const bool cok = c < F;   // V = 4: F % 4 == 0, the whole group
      float s[RB][V];
#pragma unroll
      for (int q = 0; q < RB; ++q)
#pragma unroll
        for (int k = 0; k < V; ++k) s[q][k] = 0.f;
      for (int wb = 0; wb < most; wb += 32) {
        int jn[RB], je[RB];
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          const bool ok = wb + lane < d[q];
          const size_t at = (size_t)(row0 + i0 + q) * W + wb + lane;
          jn[q] = ok ? __ldg(a.nbr + at) : 0;
          je[q] = ok ? __ldg(a.nbr_e + at) : 0;
        }
        const int m = min(32, most - wb);
        for (int w = 0; w < m; w += G) {
          float xv[RB][G][V], pv[RB][G][V];
#pragma unroll
          for (int q = 0; q < RB; ++q)
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const int sl = (w + g) & 31;
              const int j = __shfl_sync(0xffffffffu, jn[q], sl);
              const int e = __shfl_sync(0xffffffffu, je[q], sl);
              if (cok && wb + w + g < d[q]) {
                ldv(xv[q][g], a.x + (size_t)j * F + c);
                ldv(pv[q][g], a.pe + (size_t)e * F + c);
              }
            }
#pragma unroll
          for (int q = 0; q < RB; ++q)
#pragma unroll
            for (int g = 0; g < G; ++g) {
              if (!cok || wb + w + g >= d[q]) continue;
#pragma unroll
              for (int k = 0; k < V; ++k) {
                float xj = xv[q][g][k], pk = pv[q][g][k];
                if (RND) {
                  xj = bf16r(xj);
                  pk = bf16r(pk);
                }
                s[q][k] += fmaxf(xj + pk, 0.f);
              }
            }
        }
      }
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int i = i0 + q;
        float t[V];
#pragma unroll
        for (int k = 0; k < V; ++k) t[k] = 0.f;
        if (cok && i < rows) {
          float x[V];
          ldv(x, a.x + (size_t)(row0 + i) * F + c);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            // rounded twice, as the plain version forms it (module comment)
            const float tk = __fadd_rn(__fmul_rn(ope, x[k]), s[q][k]);
            t[k] = RND ? bf16r(tk) : tk;
          }
        }
        if (c < kp) stv(T + (size_t)i * ldT + c, t);
      }
    }
  }
}

// GIN's MLP on the CTA's rows T (formed, and in INT8 quantized into QT
// with row scales sT): Z = relu(T W0 + b0) into Z (zero in its pad
// columns; BF16: rounded to bf16, T W0 by tc::gin_z_f64 at 64 rows a
// CTA), then out = act(Z W1 + b1 [+ skip]) (INT8: Z's levels over QT's).
// Z may lie over T where one column tile of W0 makes T dead by then (H <=
// 128), and in INT8 always.  The W0 pass's first chunk is staged (Stream)
// or in flight (Ring).  The same MLP as mp_layer.cu's gin, kept apart:
// one function shared by both kernels moved mp_layer's register
// allocation and cost its int8 gin ~10 % (PERF.md §6, row 12).
template <int MODE, int R, class WS>
__device__ __forceinline__ void gine_mlp(WS& ws, const GineArgs a, int row0,
                                        int rows, const float* T, int ldT,
                                        float* Z, int ldZ, int8_t* QT,
                                        int ldqT, int ldqZ, float* sT) {
  constexpr bool RND = MODE == BF16;
  constexpr bool Z64 = MODE == BF16;   // Z on the float64 tensor cores
  constexpr int NC = tc::NC;
  const int F = a.F, H = a.H, Fout = a.Fout;
  auto pass0 = [&](int n0) { return tc::Pass{a.w0, H, F, H, n0}; };
  auto pass1 = [&](int n0) { return tc::Pass{a.w1, Fout, H, Fout, n0}; };
  const void* A = MODE == INT8 ? static_cast<const void*>(QT) : T;
  const int lda = MODE == INT8 ? ldqT : ldT;
  const int kH = tc::kpad(H, MODE);
  if constexpr (Z64 && R == 64) {
    for (int n0 = 0; n0 < H; n0 += NC) {
      float z[4][4][2];
      tc::gin_z_f64(ws, T, ldT, pass0(n0),
                    n0 + NC < H ? pass0(n0 + NC) : pass1(0), z);
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
            Z[(size_t)r * ldZ + c] = bf16r(zz);
          }
    }
  } else if constexpr (Z64) {
    __trap();   // the launchers run BF16 gin at 64 rows a CTA
  }
  for (int n0 = 0; n0 < H && !Z64; n0 += NC) {
    tc::Acc<MODE, R> acc;
    tc::zero<MODE, R>(acc);
    ws.run(acc, A, lda, pass0(n0), rows,
           n0 + NC < H ? pass0(n0 + NC) : pass1(0), true);
    // this thread's columns' biases (and INT8 column scales) first
    constexpr int NT = tc::Geo<R>::NT;
    const int cb =
        n0 + 8 * NT * ((threadIdx.x >> 5) / tc::Geo<R>::WR) +
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
        Z[(size_t)r * ldZ + c] = RND ? bf16r(z) : z;
      }
    });
  }
  __syncthreads();
  if constexpr (MODE == INT8) {   // QT is free: Z's levels
    tc::quantize_rows<R>(Z, ldZ, kH, QT, ldqZ, sT);
    __syncthreads();
  }
  const void* A2 = MODE == INT8 ? static_cast<const void*>(QT) : Z;
  const int lda2 = MODE == INT8 ? ldqZ : ldZ;
  for (int n0 = 0; n0 < Fout; n0 += NC) {   // o = Z W1 + b1
    tc::Acc<MODE, R> acc;
    tc::zero<MODE, R>(acc);
    ws.run(acc, A2, lda2, pass1(n0), rows, pass1(n0 + NC), n0 + NC < Fout);
    tc::store_out<R>(a, row0, rows, n0, [&](int mt, int j, int k, int r,
                                            int c) {
      const float sr = MODE == INT8 ? sT[r] : 0.f;
      return __fadd_rn(tc::value<MODE>(acc[mt][j][k], sr, a.sw1, c),
                       __ldg(a.b1 + c));
    });
  }
}

template <int MODE, int R, bool RING> struct StreamOf {
  using T = tc::Stream<MODE, R>;
};
template <int MODE, int R> struct StreamOf<MODE, R, true> {
  using T = tc::Ring<MODE, R>;
};

template <int MODE, int R, bool RING, int CTAS>
__global__ void __launch_bounds__(tc::THREADS, CTAS)
gine_layer_kernel(GineArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const GineLayout L = gine_layout(a.F, a.H, MODE, RING, a.stages, R);
  float* T = reinterpret_cast<float*>(smem + L.T);
  float* Z = reinterpret_cast<float*>(smem + L.Z);
  int8_t* QT = reinterpret_cast<int8_t*>(smem + L.QT);
  float* sT = reinterpret_cast<float*>(smem + L.SQ);
  const int row0 = blockIdx.x * R;
  const int rows = min(R, a.n_rows - row0);
  const int kF = tc::kpad(a.F, MODE);
  typename StreamOf<MODE, R, RING>::T ws;
  ws.wbuf = smem;
  ws.stages = a.stages;
  if constexpr (RING) {
    ws.bar = gnnb_mma::smem_addr(smem + L.BAR);
    ws.src = a.staged;
    ws.n = a.n_chunks;
    ws.it = 0;
    ws.start();
  } else {
    ws.cur = 0;
    ws.prefetch(tc::Pass{a.w0, a.H, a.F, a.H, 0});
  }
  if (a.vec)
    gine_rows<MODE, R, 4>(a, row0, rows, T, L.ldT, kF);
  else
    gine_rows<MODE, R, 1>(a, row0, rows, T, L.ldT, kF);
  if constexpr (!RING) ws.stage_prefetched();
  __syncthreads();
  if constexpr (MODE == INT8) {
    tc::quantize_rows<R>(T, L.ldT, kF, QT, L.ldqT, sT);
    __syncthreads();
  }
  gine_mlp<MODE, R>(ws, a, row0, rows, T, L.ldT, Z, L.ldZ, QT, L.ldqT,
                    L.ldqZ, sT);
}

// The Ring's chunks of a layer: W0's column tiles, then W1's, each
// kpad(K) / kchunk chunks.
int ring_chunks(int F, int H, int Fout, int mode) {
  const int kc = tc::kchunk(mode);
  return (H + tc::NC - 1) / tc::NC * (tc::kpad(F, mode) / kc) +
         (Fout + tc::NC - 1) / tc::NC * (tc::kpad(H, mode) / kc);
}

// A launch's rows a CTA, CTAs an SM (the launch bounds), stages and
// weight path.  The Ring takes 64 rows a CTA: a CTA's chunk loop is
// latency-bound at 8 warps an SM (copies without the MMAs ran as fast),
// and the train batch's 292 CTAs of 64 rows fit the 132 SMs at once, two
// or three an SM, where its 146 CTAs of 128 rows left 118 SMs one CTA
// (PERF.md §6, row 12); three CTAs an SM (85 registers a thread) in f32
// and int8 where they fit, BF16 (its float64 Z) two.  The caller's
// weights take 128 rows where they fit, else 64, at two CTAs an SM.
// {0, ...} where nothing fits.
struct Shape {
  int R, ctas, stages;
  bool ring;
};
Shape gine_shape(int F, int H, int mode, bool staged, size_t optin,
                 size_t per_sm, size_t reserved) {
  auto fit = [&](int ctas) {
    const size_t share = per_sm / ctas - reserved;
    return share < optin ? share : optin;
  };
  if (staged) {
    for (int ctas : {3, 2}) {
      if (mode == BF16 && ctas == 3) continue;
      for (int st = ctas == 3 ? RING_THREE : RING_MAX; st >= RING_MIN; --st)
        if ((size_t)gine_layout(F, H, mode, true, st, 64).bytes <= fit(ctas))
          return {64, ctas, st, true};
    }
  }
  for (int R : {128, 64}) {   // BF16's float64 Z holds 64 rows
    if (mode == BF16 && R == 128) continue;
    for (int st : {2, 1})
      if ((size_t)gine_layout(F, H, mode, false, st, R).bytes <= optin)
        return {R, 2, st, false};
  }
  return {0, 0, 0, false};
}

cudaError_t smem_limits(int device, size_t* optin, size_t* per_sm,
                        size_t* reserved) {
  int o = 0, sm = 0, res = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &o, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &res, cudaDevAttrReservedSharedMemoryPerBlock, device);
  *optin = (size_t)o;
  *per_sm = (size_t)sm;
  *reserved = (size_t)res;
  return err;
}

// The kernel instance of a shape (the launcher's four of each mode,
// BF16's two).
template <int MODE>
const void* instance(const Shape& sh) {
  if (sh.ring) {
    if constexpr (MODE != BF16)
      if (sh.ctas == 3)
        return (const void*)gine_layer_kernel<MODE, 64, true, 3>;
    return (const void*)gine_layer_kernel<MODE, 64, true, 2>;
  }
  if constexpr (MODE != BF16)
    if (sh.R == 128) return (const void*)gine_layer_kernel<MODE, 128, false, 2>;
  return (const void*)gine_layer_kernel<MODE, 64, false, 2>;
}

template <int MODE>
cudaError_t launch(GineArgs a, size_t optin, size_t per_sm, size_t reserved,
                   cudaStream_t s) {
  const Shape sh = gine_shape(a.F, a.H, MODE, a.staged != nullptr, optin,
                              per_sm, reserved);
  if (sh.R == 0) return cudaErrorInvalidValue;
  a.stages = sh.stages;
  if (!sh.ring) a.staged = nullptr;
  const size_t smem =
      gine_layout(a.F, a.H, MODE, sh.ring, sh.stages, sh.R).bytes;
  const void* k = instance<MODE>(sh);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  return cudaLaunchKernel(k, dim3((a.n_rows + sh.R - 1) / sh.R),
                          dim3(tc::THREADS), args, smem, s);
}

// Registers, shared memory and CTAs an SM of instance (MODE, sh.R,
// sh.ring, sh.ctas) at F = H = Fout = w, with the stages its launcher
// gives it there.
template <int MODE>
cudaError_t info(Shape sh, int w, int* regs, int* smem_bytes, int* ctas,
                 size_t optin, size_t per_sm, size_t reserved) {
  if ((MODE == BF16 && (sh.R != 64 || sh.ctas != 2)) ||
      (sh.ring ? sh.R != 64 : sh.ctas != 2))
    return cudaErrorInvalidValue;
  size_t fit = sh.ring ? per_sm / sh.ctas - reserved : optin;
  fit = fit < optin ? fit : optin;
  const int most = sh.ring ? (sh.ctas == 3 ? RING_THREE : RING_MAX) : 2;
  sh.stages = 0;
  for (int st = most; st >= (sh.ring ? RING_MIN : 1) && !sh.stages; --st)
    if ((size_t)gine_layout(w, w, MODE, sh.ring, st, sh.R).bytes <= fit)
      sh.stages = st;
  if (sh.stages == 0) return cudaErrorInvalidValue;
  const size_t smem = gine_layout(w, w, MODE, sh.ring, sh.stages, sh.R).bytes;
  const void* k = instance<MODE>(sh);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return err;
  *regs = fa.numRegs;
  *smem_bytes = (int)(fa.sharedSizeBytes + smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, k, tc::THREADS,
                                                       smem);
}

}  // namespace

extern "C" {

// Shared memory of a launch in `mode` at the fewest rows and stages of the
// caller's-weights path, in bytes (the launcher takes more where they
// fit).
int gnnb_gine_layer_smem_bytes(int F, int H, int mode) {
  return gine_layout(F, H, mode, false, 1, 64).bytes;
}

// Chunks of the Ring's layout of a layer (F, H, Fout) in `mode`
// (ops/cuda/gine_layer.py stage_weights), or 0 where the Ring's stages do
// not fit the current card's shared memory at two CTAs an SM (the
// launcher then reads the caller's weights).
int gnnb_gine_layer_ring_chunks(int F, int H, int Fout, int mode) {
  int dev = 0;
  size_t optin = 0, per_sm = 0, res = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      smem_limits(dev, &optin, &per_sm, &res) != cudaSuccess || mode < F32 ||
      mode > INT8 || F < 1 || H < 1 || Fout < 1)
    return 0;
  return gine_shape(F, H, mode, true, optin, per_sm, res).ring
             ? ring_chunks(F, H, Fout, mode)
             : 0;
}

// Registers per thread, shared memory per CTA (bytes) and resident CTAs
// per SM of the instance `mode` x `rows` a CTA (128, 64) x weight path
// (ring 1: the Ring, 0: the caller's weights) x `ctas` an SM (its launch
// bounds: 3 or 2), with the stages its launcher gives it at F = H = Fout
// = w, on the current device.
int gnnb_gine_layer_info(int mode, int rows, int ring, int ctas, int w,
                         int* regs, int* smem_bytes, int* ctas_per_sm) {
  int dev = 0;
  size_t o = 0, sm = 0, res = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = smem_limits(dev, &o, &sm, &res);
  if (err != cudaSuccess) return (int)err;
  if ((rows != 128 && rows != 64) || (ctas != 2 && ctas != 3))
    return (int)cudaErrorInvalidValue;
  const Shape sh{rows, ctas, 0, ring != 0};
  int* c = ctas_per_sm;
  if (mode == BF16)
    return (int)info<BF16>(sh, w, regs, smem_bytes, c, o, sm, res);
  if (mode == INT8)
    return (int)info<INT8>(sh, w, regs, smem_bytes, c, o, sm, res);
  if (mode == F32)
    return (int)info<F32>(sh, w, regs, smem_bytes, c, o, sm, res);
  return (int)cudaErrorInvalidValue;
}

// Launches the layer on `stream` of `device`.  act: 0 none, 1 relu,
// 2 gelu, 3 sigmoid, 4 tanh; mode: 0 f32, 1 bf16 (w0, w1 bfloat16), 2 int8
// (w0, w1 int8 with column scales sw0, sw1); skip may be null.  staged
// (or null): the layer's weights in the Ring's layout, staged_bytes long
// (gnnb_gine_layer_ring_chunks x 8192); the kernel then reads them and
// not w0 / w1.  All other arrays contiguous f32 / i32 as documented in
// ops/cuda/gine_layer.py.  Returns the cudaError_t of the launch (0 =
// success).
int gnnb_gine_layer(const void* x, const void* pe, const void* nbr,
                    const void* nbr_e, const void* deg, int n_rows, int W,
                    int F, int H, int Fout, const void* w0, const void* b0,
                    const void* w1, const void* b1, const void* skip,
                    float eps, int act, int mode, const void* sw0,
                    const void* sw1, void* out, void* stream, int device,
                    const void* staged, long long staged_bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows < 0 || W < 1 || F < 1 || H < 1 || Fout < 1 || act < 0 ||
      act > 4 || !x || !pe || !nbr || !nbr_e || !deg || !w0 || !b0 ||
      !w1 || !b1 || !out || mode < F32 || mode > INT8 ||
      (mode == INT8 && (!sw0 || !sw1)) ||
      (staged && (staged_bytes != (long long)ring_chunks(F, H, Fout, mode) *
                                      tc::chunk_bytes(mode) ||
                  (uintptr_t)staged % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  size_t optin = 0, per_sm = 0, res = 0;
  err = smem_limits(device, &optin, &per_sm, &res);
  if (err != cudaSuccess) return (int)err;
  GineArgs a;
  a.x = (const float*)x;
  a.pe = (const float*)pe;
  a.nbr = (const int*)nbr;
  a.nbr_e = (const int*)nbr_e;
  a.deg = (const int*)deg;
  a.w0 = w0;
  a.b0 = (const float*)b0;
  a.w1 = w1;
  a.b1 = (const float*)b1;
  a.sw0 = (const float*)sw0;
  a.sw1 = (const float*)sw1;
  a.skip = (const float*)skip;
  a.out = (float*)out;
  a.staged = (const unsigned char*)staged;
  a.n_rows = n_rows;
  a.W = W;
  a.F = F;
  a.H = H;
  a.Fout = Fout;
  a.act = act;
  a.eps = eps;
  a.stages = 0;
  a.n_chunks = ring_chunks(F, H, Fout, mode);
  a.vec = F % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)pe % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == BF16) return (int)launch<BF16>(a, optin, per_sm, res, st);
  if (mode == INT8) return (int)launch<INT8>(a, optin, per_sm, res, st);
  return (int)launch<F32>(a, optin, per_sm, res, st);
}

}  // extern "C"
