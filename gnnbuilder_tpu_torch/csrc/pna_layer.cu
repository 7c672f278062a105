// One PNA layer on any batch with an ELL neighbour table: the training
// forward, with the residuals its backward reads.
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
// Weights keep the JAX package's [in, out] layout: w_pre [2Fin, F]
// (receiver rows first), k_post [Fin + 12F, Fout] (self rows, then the
// three scaler groups of [max|min|mean|std] blocks), w_lin [Fout, Fout].
// The kernel reads Ks straight out of k_post, so no operand is repacked.
//
// What bounds it on the H100: operations.  The products cost
// 2*(2 Fin F + 12 F Fout + Fin Fout + Fout^2) = 524,288 flops per row at
// 128 wide against ~4.6 KB of row traffic with residuals, above the f32
// ridge of 67 TFLOP/s / 3.35 TB/s = 20 flops per byte.  The dots run as
// plain f32 FMAs (no tensor cores), so the f32 FMA rate is its roof.
//
// Design: two launches.  The first computes v = x Wj for every row (the
// gather needs the neighbours' v before any receiver can aggregate; the
// TPU kernel recomputed it per window, here it goes to device memory,
// where save_res wants it anyway, and stays L2 resident: 9.5 MB at the
// canonical b1024 batch).  The second gives each CTA R receiver rows:
// x tile, u, the [R, 4F] aggregate concat and mid live in shared memory
// (96 KB at 128 wide and R = 32, two CTAs per SM); a neighbour id is an
// exact indexed load of v, so the one-hot MXU gather, its hi/lo split and
// the window DMAs of the Pallas kernel do not apply.  Each thread owns one
// column of a 128-column block and R/2 rows; weights stream from L2
// (coalesced along the column) and each weight read feeds R/2 FMAs.  R is
// 32 where that tile fits the card's shared memory per block, else 16 or
// 8 (R * (Fin + 4F + Fout) floats: hidden 384 takes R = 16, and R = 8
// reaches widths of about 1,150).
//
// Inference modes (template argument MODE, the JAX kernel's mm /
// gather_mode / quant; no residuals):
//   F32  (0): as above.
//   BF16 (1): w_pre, k_post and w_lin are bf16 in device memory; every
//        product takes bf16-rounded operands and sums in f32 (mm="bf16"),
//        and v is stored rounded to bf16 (gather_mode="bf16").  The x
//        tile, the aggregate concat and mid feed only products, so they
//        are stored already rounded; u and the skip stay f32.
//   INT8 (2): only the final Linear is quantized, as in the JAX kernel
//        (PairLinear and BlockScaledLinear stay f32): mid's rows are
//        quantized with one symmetric scale each (s = max(max|mid| /
//        127, 1e-12), q = clip(rint(mid / s), -127, 127)), w_lin is int8
//        with one scale per column, the sum is int32 (__dp4a) and out =
//        act(float(sum) * s_row * s_col + b_lin [+ skip]): _qdot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Mode { F32 = 0, BF16 = 1, INT8 = 2 };

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CB = 128;               // columns per column block
constexpr int GROUPS = THREADS / CB;  // row groups (2)
constexpr int MIN_R = 8;              // fewest rows per CTA
constexpr float STD_EPS = 1e-5f;
constexpr float BIG = 3e38f;          // the TPU kernel's finite -inf

__device__ __forceinline__ float act_fn(float x, int act) {
  switch (act) {
    case 1: return fmaxf(x, 0.f);
    case 2: return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
    case 3: return 1.f / (1.f + expf(-x));
    case 4: return tanhf(x);
    default: return x;
  }
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float ldw(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldw(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// the products' weight type of each mode (w_lin of INT8 aside)
template <int MODE> struct WeightOf { using T = float; };
template <> struct WeightOf<BF16> { using T = __nv_bfloat16; };

// acc[i] += A[r0 + i, 0:K] . W[0:K, col]; A in shared memory (row stride
// lda floats, 16-byte aligned rows), W row-major (row stride ldw) in
// device memory.  K % 4 == 0.
template <int RG, typename TW>
__device__ __forceinline__ void dot_rows(float (&acc)[RG], const float* A,
                                         int lda, int r0,
                                         const TW* __restrict__ W,
                                         int ldw_, int col, int K) {
  for (int k = 0; k < K; k += 4) {
    const float w0 = ldw(W + (size_t)(k + 0) * ldw_ + col);
    const float w1 = ldw(W + (size_t)(k + 1) * ldw_ + col);
    const float w2 = ldw(W + (size_t)(k + 2) * ldw_ + col);
    const float w3 = ldw(W + (size_t)(k + 3) * ldw_ + col);
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(A + (r0 + i) * lda + k);
      acc[i] = fmaf(a.x, w0, acc[i]);
      acc[i] = fmaf(a.y, w1, acc[i]);
      acc[i] = fmaf(a.z, w2, acc[i]);
      acc[i] = fmaf(a.w, w3, acc[i]);
    }
  }
}

// W[k..k+3, col] of an int8 [K, ld] matrix packed into one word, k first
__device__ __forceinline__ int ldw4(const int8_t* __restrict__ W, int ld,
                                    int col, int k) {
  const unsigned b0 = (unsigned char)__ldg(W + (size_t)(k + 0) * ld + col);
  const unsigned b1 = (unsigned char)__ldg(W + (size_t)(k + 1) * ld + col);
  const unsigned b2 = (unsigned char)__ldg(W + (size_t)(k + 2) * ld + col);
  const unsigned b3 = (unsigned char)__ldg(W + (size_t)(k + 3) * ld + col);
  return (int)(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
}

// The int8 product: acc[i] += Q[r0 + i, 0:K] . W[0:K, col] in int32
// (row stride lda bytes, 4-byte aligned rows).
template <int RG>
__device__ __forceinline__ void qdot_rows(int (&acc)[RG], const int8_t* Q,
                                          int lda, int r0,
                                          const int8_t* __restrict__ W,
                                          int ldw_, int col, int K) {
  for (int k = 0; k < K; k += 4) {
    const int w = ldw4(W, ldw_, col, k);
#pragma unroll
    for (int i = 0; i < RG; ++i)
      acc[i] = __dp4a(*reinterpret_cast<const int*>(Q + (r0 + i) * lda + k),
                      w, acc[i]);
  }
}

// Q[r, :] = clip(rint(A[r, :] / s[r]), -127, 127) with s[r] = max(max_k
// |A[r, k]| / 127, 1e-12), rows [0, rows) of a [rows, K] f32 tile; one
// warp per row.  IEEE divisions (no fast math) and rintf (half to even):
// the JAX package's quantize_rows.
__device__ void quantize_rows(const float* A, int rows, int K, int8_t* Q,
                              float* s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += WARPS) {
    const float* a = A + r * K;
    float m = 0.f;
    for (int k = lane; k < K; k += 32) m = fmaxf(m, fabsf(a[k]));
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float sc = fmaxf(m / 127.f, 1e-12f);
    for (int k = lane; k < K; k += 32)
      Q[r * K + k] =
          (int8_t)(int)fminf(fmaxf(rintf(a[k] / sc), -127.f), 127.f);
    if (lane == 0) s[r] = sc;
  }
}

// x rows [row0, row0 + R) into shared memory, zero past the last row;
// rounded to bf16 in the BF16 mode (the tile feeds only products there).
template <int R, int MODE>
__device__ __forceinline__ void load_tile(float* xs,
                                          const float* __restrict__ x,
                                          int n_rows, int row0, int Fin) {
  const int n4 = R * Fin / 4;
  for (int q = threadIdx.x; q < n4; q += THREADS) {
    const int r = (q * 4) / Fin;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      val = reinterpret_cast<const float4*>(x + (size_t)row0 * Fin)[q];
    if constexpr (MODE == BF16)
      val = make_float4(bf16r(val.x), bf16r(val.y), bf16r(val.z),
                        bf16r(val.w));
    reinterpret_cast<float4*>(xs)[q] = val;
  }
}

// v = x Wj for R rows per CTA (stored rounded to bf16 in the BF16 mode,
// whose gather reads bf16 rows).
template <int R, int MODE>
__global__ void __launch_bounds__(THREADS)
pna_layer_v_kernel(const float* __restrict__ x, int n_rows, int Fin, int F,
                   const void* wj_, float* __restrict__ v) {
  using TW = typename WeightOf<MODE>::T;
  const TW* wj = static_cast<const TW*>(wj_);
  constexpr int RG = R / GROUPS;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);   // [R, Fin]
  const int row0 = blockIdx.x * R;
  const int col = threadIdx.x % CB;
  const int i0 = (threadIdx.x / CB) * RG;
  load_tile<R, MODE>(xs, x, n_rows, row0, Fin);
  __syncthreads();
  for (int c0 = 0; c0 < F; c0 += CB) {
    float acc[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) acc[i] = 0.f;
    dot_rows(acc, xs, Fin, i0, wj, F, c0 + col, Fin);
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int r = row0 + i0 + i;
      if (r < n_rows)
        v[(size_t)r * F + c0 + col] = MODE == BF16 ? bf16r(acc[i]) : acc[i];
    }
  }
}

struct LayerArgs {
  const float* x;       // [N, Fin]
  const int* nbr;       // [N, W]
  const int* deg;       // [N]
  const float* v;       // [N, F] from pna_layer_v_kernel
  const void* wi;       // [Fin, F] (the first Fin rows of w_pre)
  const float* bpre;    // [F]
  const void* kpost;    // [Fin + 12F, Fout]
  const float* bpost;   // [Fout]
  const void* wlin;     // [Fout, Fout]
  const float* swlin;   // [Fout] column scales of an int8 w_lin
  const float* blin;    // [Fout]
  const float* skip;    // [N, Fout] or null
  float* out;           // [N, Fout]
  float* agg_out;       // [N, 4F] or null (save_res)
  float* aux_out;       // [N, 5F] or null
  float* mid_out;       // [N, Fout] or null
  int n_rows, W, Fin, F, Fout, act;
  float delta;
};

template <int R, int MODE>
__global__ void __launch_bounds__(THREADS)
pna_layer_kernel(LayerArgs a) {
  using TW = typename WeightOf<MODE>::T;
  constexpr int RG = R / GROUPS;
  extern __shared__ float4 smem4[];
  const int Fin = a.Fin, F = a.F, Fout = a.Fout;
  const TW* wi = static_cast<const TW*>(a.wi);
  float* xs = reinterpret_cast<float*>(smem4);   // [R, Fin]
  float* agg = xs + R * Fin;                     // [R, 4F], u first
  float* mids = agg + R * 4 * F;                 // [R, Fout]
  int* s_deg = reinterpret_cast<int*>(mids + R * Fout);   // [R]
  float* s_logd = reinterpret_cast<float*>(s_deg + R);    // [R]
  float* s_mid = s_logd + R;                     // int8: [R] scales of mid
  int8_t* mq = reinterpret_cast<int8_t*>(s_mid + R);      // [R, Fout]

  const int row0 = blockIdx.x * R;
  const int col = threadIdx.x % CB;
  const int i0 = (threadIdx.x / CB) * RG;
  load_tile<R, MODE>(xs, a.x, a.n_rows, row0, Fin);
  for (int i = threadIdx.x; i < R; i += THREADS) {
    const int d = row0 + i < a.n_rows ? a.deg[row0 + i] : 0;
    s_deg[i] = d;
    s_logd[i] = logf(fmaxf((float)d, 1.f) + 1.f);
  }
  __syncthreads();

  // u = x Wi + b_pre into the first F columns of agg; the same thread
  // reads its (row, column) of u back below, so no barrier is needed
  for (int c0 = 0; c0 < F; c0 += CB) {
    float acc[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) acc[i] = 0.f;
    dot_rows(acc, xs, Fin, i0, wi, F, c0 + col, Fin);
    const float b = a.bpre[c0 + col];
#pragma unroll
    for (int i = 0; i < RG; ++i) agg[(i0 + i) * 4 * F + c0 + col] = acc[i] + b;
  }

  // aggregates over each row's valid slots, gathered from v
  for (int c0 = 0; c0 < F; c0 += CB) {
    const int c = c0 + col;
    for (int i = i0; i < i0 + RG; ++i) {
      const int r = row0 + i;
      if (r >= a.n_rows) break;
      const int d = s_deg[i];
      const int* nb = a.nbr + (size_t)r * a.W;
      float s = 0.f, sq = 0.f, mx = -BIG, mn = BIG;
      for (int w = 0; w < d; ++w) {
        const float g = a.v[(size_t)nb[w] * F + c];
        s += g;
        sq += __fmul_rn(g, g);
        mx = fmaxf(mx, g);
        mn = fminf(mn, g);
      }
      // no contraction into FMAs: a row whose slots hold one value then
      // gets var == 0 exactly, as in the plain version (the std of a
      // near-constant row magnifies rounding by 1 / (2 std) ~ 158)
      const float denom = fmaxf((float)d, 1.f);
      const float mean = s / denom;
      const float var =
          fmaxf(__fsub_rn(sq / denom, __fmul_rn(mean, mean)), 0.f);
      const float sd = sqrtf(var + STD_EPS);
      float* ar = agg + i * 4 * F;
      const float u = ar[c];
      const bool nonempty = d > 0;
      const float amx = nonempty ? u + mx : 0.f;
      const float amn = nonempty ? u + mn : 0.f;
      const float amean = nonempty ? u + mean : 0.f;
      // bf16: the concat feeds only the Ks product
      ar[c] = MODE == BF16 ? bf16r(amx) : amx;
      ar[F + c] = MODE == BF16 ? bf16r(amn) : amn;
      ar[2 * F + c] = MODE == BF16 ? bf16r(amean) : amean;
      ar[3 * F + c] = MODE == BF16 ? bf16r(sd) : sd;
      if (a.agg_out != nullptr) {
        float* go = a.agg_out + (size_t)r * 4 * F;
        go[c] = amx;
        go[F + c] = amn;
        go[2 * F + c] = amean;
        go[3 * F + c] = sd;
        float tmx = 0.f, tmn = 0.f;
        for (int w = 0; w < d; ++w) {
          const float g = a.v[(size_t)nb[w] * F + c];
          tmx += (g == mx) ? 1.f : 0.f;
          tmn += (g == mn) ? 1.f : 0.f;
        }
        float* xo = a.aux_out + (size_t)r * 5 * F;
        xo[c] = mx;
        xo[F + c] = mn;
        xo[2 * F + c] = mean;
        xo[3 * F + c] = tmx;
        xo[4 * F + c] = tmn;
      }
    }
  }
  __syncthreads();

  // mid = x K0 + b_post + y_id + amp*y_amp + att*y_att, y_s = agg Ks_s
  const TW* K0 = static_cast<const TW*>(a.kpost);
  const TW* Ks = K0 + (size_t)Fin * Fout;         // [3][4F, Fout]
  for (int c0 = 0; c0 < Fout; c0 += CB) {
    const int c = c0 + col;
    float y[3][RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) y[0][i] = y[1][i] = y[2][i] = 0.f;
    dot_rows(y[0], xs, Fin, i0, K0, Fout, c, Fin);
#pragma unroll
    for (int s = 0; s < 3; ++s)
      dot_rows(y[s], agg, 4 * F, i0, Ks + (size_t)s * 4 * F * Fout, Fout, c,
               4 * F);
    const float bp = a.bpost[c];
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const float ld = s_logd[i0 + i];
      const float m = y[0][i] + bp + (ld / a.delta) * y[1][i] +
                      (a.delta / ld) * y[2][i];
      // bf16: mid feeds only the Wlin product
      mids[(i0 + i) * Fout + c] = MODE == BF16 ? bf16r(m) : m;
      const int r = row0 + i0 + i;
      if (a.mid_out != nullptr && r < a.n_rows)
        a.mid_out[(size_t)r * Fout + c] = m;
    }
  }
  __syncthreads();

  if constexpr (MODE == INT8) {
    quantize_rows(mids, R, Fout, mq, s_mid);
    __syncthreads();
  }

  // out = act(mid Wlin + b_lin [+ skip])
  for (int c0 = 0; c0 < Fout; c0 += CB) {
    const int c = c0 + col;
    float acc[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) acc[i] = 0.f;
    if constexpr (MODE == INT8) {
      int q[RG];
#pragma unroll
      for (int i = 0; i < RG; ++i) q[i] = 0;
      qdot_rows(q, mq, Fout, i0, static_cast<const int8_t*>(a.wlin), Fout, c,
                Fout);
      const float sw = a.swlin[c];
#pragma unroll
      for (int i = 0; i < RG; ++i) acc[i] = (float)q[i] * s_mid[i0 + i] * sw;
    } else {
      dot_rows(acc, mids, Fout, i0, static_cast<const TW*>(a.wlin), Fout, c,
               Fout);
    }
    const float bl = a.blin[c];
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int r = row0 + i0 + i;
      if (r >= a.n_rows) break;
      float o = acc[i] + bl;
      if (a.skip != nullptr) o += a.skip[(size_t)r * Fout + c];
      a.out[(size_t)r * Fout + c] = act_fn(o, a.act);
    }
  }
}

// Dynamic shared memory of the layer launch with R rows per CTA; the
// int8 mode adds mid's row scales and its int8 copy.
size_t layer_smem_bytes(int R, int Fin, int F, int Fout, int mode) {
  size_t b = (size_t)R * (Fin + 4 * F + Fout + 2) * sizeof(float);
  if (mode == INT8) b += (size_t)R * (sizeof(float) + Fout);
  return b;
}

// v = x Wj, then the layer, with R rows per CTA.
template <int R, int MODE>
cudaError_t launch(const LayerArgs& a, const void* wj, float* v,
                   cudaStream_t s) {
  const size_t smem_v = (size_t)R * a.Fin * sizeof(float);
  const size_t smem = layer_smem_bytes(R, a.Fin, a.F, a.Fout, MODE);
  cudaError_t err = cudaFuncSetAttribute(
      pna_layer_v_kernel<R, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_v);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(pna_layer_kernel<R, MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.n_rows + R - 1) / R;
  pna_layer_v_kernel<R, MODE><<<blocks, THREADS, smem_v, s>>>(
      a.x, a.n_rows, a.Fin, a.F, wj, v);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pna_layer_kernel<R, MODE><<<blocks, THREADS, smem, s>>>(a);
  return cudaGetLastError();
}

// the launch at the most rows per CTA that fit `limit` bytes
template <int MODE>
cudaError_t launch_fit(const LayerArgs& a, const void* wj, float* v,
                       cudaStream_t s, size_t limit) {
  if (layer_smem_bytes(32, a.Fin, a.F, a.Fout, MODE) <= limit)
    return launch<32, MODE>(a, wj, v, s);
  if (layer_smem_bytes(16, a.Fin, a.F, a.Fout, MODE) <= limit)
    return launch<16, MODE>(a, wj, v, s);
  if (layer_smem_bytes(MIN_R, a.Fin, a.F, a.Fout, MODE) <= limit)
    return launch<MIN_R, MODE>(a, wj, v, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Every width must be a multiple of this (one column block).
int gnnb_pna_layer_width_multiple() { return CB; }

// Dynamic shared memory the layer needs at these widths in `mode`, in
// bytes: that of the fewest rows per CTA.  The wrapper checks it against
// the device's per-block limit; the launcher takes more rows where they
// fit.
int gnnb_pna_layer_smem_bytes(int Fin, int F, int Fout, int mode) {
  return (int)layer_smem_bytes(MIN_R, Fin, F, Fout, mode);
}

// Launches v = x Wj and then the layer on `stream` of `device`.  All
// arrays contiguous as documented in ops/cuda/pna_layer.py: x, biases,
// skip and outputs f32, w_pre / k_post / w_lin f32 (mode 0), bf16 (mode
// 1), or f32 / f32 / int8 with its f32 column scales s_wlin (mode 2);
// skip, agg_out, aux_out and mid_out may be null (the last three
// together, and always in modes 1 and 2).  Returns the cudaError_t of
// the launches (0 = success).
int gnnb_pna_layer(const void* x, const void* nbr, const void* deg,
                   int n_rows, int ell_width, int Fin, int F, int Fout,
                   const void* w_pre, const void* b_pre, const void* k_post,
                   const void* b_post, const void* w_lin, const void* b_lin,
                   const void* skip, float delta, int act, int mode,
                   const void* s_wlin, void* out, void* v, void* agg_out,
                   void* aux_out, void* mid_out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Fin % CB || F % CB || Fout % CB || Fin < CB || F < CB || Fout < CB ||
      n_rows < 0 || mode < F32 || mode > INT8)
    return (int)cudaErrorInvalidValue;
  if (mode != F32 && agg_out != nullptr) return (int)cudaErrorInvalidValue;
  if (mode == INT8 && s_wlin == nullptr) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  LayerArgs a;
  a.x = (const float*)x;
  a.nbr = (const int*)nbr;
  a.deg = (const int*)deg;
  a.v = (const float*)v;
  a.wi = w_pre;
  a.bpre = (const float*)b_pre;
  a.kpost = k_post;
  a.bpost = (const float*)b_post;
  a.wlin = w_lin;
  a.swlin = (const float*)s_wlin;
  a.blin = (const float*)b_lin;
  a.skip = (const float*)skip;
  a.out = (float*)out;
  a.agg_out = (float*)agg_out;
  a.aux_out = (float*)aux_out;
  a.mid_out = (float*)mid_out;
  a.n_rows = n_rows;
  a.W = ell_width;
  a.Fin = Fin;
  a.F = F;
  a.Fout = Fout;
  a.act = act;
  a.delta = delta;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t limit = (size_t)optin;
  if (mode == BF16) {
    const void* wj = (const __nv_bfloat16*)w_pre + (size_t)Fin * F;
    return (int)launch_fit<BF16>(a, wj, (float*)v, s, limit);
  }
  const void* wj = (const float*)w_pre + (size_t)Fin * F;
  if (mode == INT8) return (int)launch_fit<INT8>(a, wj, (float*)v, s, limit);
  return (int)launch_fit<F32>(a, wj, (float*)v, s, limit);
}

}  // extern "C"
