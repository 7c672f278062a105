// One GAT layer over the ELL neighbour table, concatenated heads: the
// windowed GAT layer of the JAX package.
//
// Replaces: gnnbuilder_tpu/ops/pallas/gat_layer.py fused_gat_layer (kernel
// body _kernel).  For every row r with its slots w < deg[r] (neighbour
// j_w = nbr[r, w]) and every head hd (HC = H * C):
//
//   h, a_src, a_dst  = the projection of x (gat_common.cuh)
//   z_w   = leaky_relu(a_src[j_w, hd] + a_dst[r, hd])
//   z_s   = leaky_relu(a_src[r, hd] + a_dst[r, hd])        (self loop)
//   m     = max(-BIG, max_w z_w, z_s), then at least -BIG / 2
//   den   = sum_w exp(z_w - m) + exp(z_s - m)
//   num   = sum_w exp(z_w - m) h[j_w] + exp(z_s - m) h[r]  (head hd's C
//           columns, in slot order, the self slot last)
//   out   = act(num / max(den, 1e-16) + bias [+ skip])
//
// The self slot's terms drop out with self_loops = 0; an empty row then
// gives bias (+ skip) through act, as the TPU kernel's -BIG mask and
// clamp give.
//
// Edge-logit mode (EDGE, a template argument; GATConv edge_dim, in every
// mode): le [N, W, H] holds a float32 term per slot and ae_self [N, H]
// one per self slot, added before the leaky ReLU (the TPU kernel's
// edge_logits / self_edge_logit):
//
//   z_w   = leaky_relu((a_src[j_w, hd] + a_dst[r, hd]) + le[r, w, hd])
//   z_s   = leaky_relu((a_src[r, hd] + a_dst[r, hd]) + ae_self[r, hd])
//
// le is read row-major from device memory, each valid slot's term once
// per head: the TPU kernel's slot-major stacked copy fed its one-hot
// gather tiles and has no use here.
//
// Modes (inference only): in both only the projection changes
// (gat_common.cuh; the f32 mode's products are split TF32 in three
// passes).  bf16 (mode 1, the TPU kernel's mm="bf16") rounds
// its operands; int8 (mode 2, quant=True, the serving precision)
// quantizes x per row against int8 W with column scales, for a
// receiver's own row as for its neighbours'.  h, the logit halves, the
// softmax and the weighted sum stay float32, and the gather is exact: the
// TPU kernel's gather is its "highest" one-hot product or its hi/lo
// "split2" pair whatever gather_mode says, never a bf16 rounding.
//
// What bounds it on the H100: operations.  The projection is 2 Fin HC
// flops per row (1 M at 512 x 512) against ~4 KB of row traffic; the
// attention adds ~2 HC flops per edge.  The projection runs on the tensor
// cores (gat_common.cuh: split TF32 in f32, bf16 and s8 MMAs in the
// modes), so its least time is min(flops / 67 T, 3 flops / 495 T) in f32.
//
// Design: two launches, since a row's neighbours can be anywhere in the
// batch.  The first is the projection (gat_common.cuh, gat_proj_tc_kernel:
// a CTA per 128 rows and head, the head's staged weights streamed once
// per CTA through the ring, h and the logit halves to device memory).
// The second gives each warp one receiver row: its slot ids go to shared
// memory, the lanes take the slots for the logits (a warp max and a warp
// sum give m and den per head, the exp weights go to shared memory), then
// the lanes take the output columns (four of one head a lane with 16-byte
// loads where C % 4 == 0), each summing its column over the slots in slot
// order, the self slot last.  A neighbour id is an exact
// indexed load of h, so the TPU kernel's one-hot MXU gathers, its hi/lo
// split, the head expansion matmuls and the window DMAs do not apply.

#include "gat_common.cuh"

namespace {

using namespace gnnb_gat;

// ------------------------------------------------------------ projection

struct ProjArgs {
  const float* x;              // [N, Fin]
  const int8_t* xq;            // INT8: levels [N rounded up to 128, Kp]
  const float* xs;             // INT8: row scales [N rounded up to 128]
  const unsigned char* wst;    // staged weights (stage_projection)
  const float* sw;             // [HC] column scales (INT8), else null
  const float* att_src;        // [HC] (att_src[0, hd, c] at hd * C + c)
  const float* att_dst;        // [HC]
  float* h;                    // [N, HC]
  float* a_src;                // [N, H]
  float* a_dst;                // [N, H]
  int n_rows, Fin, H, C;
};

// INT8: each row of x quantized with its own scale (quant.cuh: s =
// max(max |x| / 127, 1e-12), q = clip(rint(x / s), -127, 127), IEEE
// division), once for every head's CTAs; one warp per row, rows past N
// and k in [Fin, Kp) zero.
__global__ void __launch_bounds__(THREADS)
quantize_rows_kernel(const float* __restrict__ x, int n_rows, int Fin,
                     int Kp, int n_pad, int8_t* __restrict__ q,
                     float* __restrict__ s) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n_pad) return;
  const float* xr = x + (size_t)r * Fin;
  const bool real = r < n_rows;
  float m = 0.f;
  if (real)
    for (int k = lane; k < Fin; k += 32) m = fmaxf(m, fabsf(__ldg(xr + k)));
  m = warp_max(m);
  const float sc = gnnb_quant::quant_scale(m);
  for (int k = lane; k < Kp; k += 32)
    q[(size_t)r * Kp + k] =
        (int8_t)(real && k < Fin ? gnnb_quant::quant_level(__ldg(xr + k), sc)
                                 : 0);
  if (lane == 0) s[r] = sc;
}

template <int MODE, int NP>
using ProjLayout = ProjSmem<MODE, NP, false, 0>;

// One CTA per 128 rows (blockIdx.x) and head (blockIdx.y): the head's
// chunks in turn, h to device memory from the accumulators, the logit
// halves summed over the chunks in shared memory and written last.
template <int MODE, int NP>
__global__ void __launch_bounds__(TC_THREADS, 1)
gat_proj_tc_kernel(ProjArgs a) {
  using SM = ProjLayout<MODE, NP>;
  constexpr int CW = 64 * NP;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* smem = tc_smem;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * BM, hd = blockIdx.y;
  const int C = a.C, HC = a.H * C, nch = (C + CW - 1) / CW;
  const int nk = (a.Fin + KC - 1) / KC;
  const TileRing<SM::S, SM::TB> ring{smem + SM::RING,
                                     gnnb_mma::smem_addr(smem + SM::BAR)};
  if (tid == 0) init_ring<SM::S>(ring.full);
  float* sq = reinterpret_cast<float*>(smem + SM::SQ);
  float* part = reinterpret_cast<float*>(smem + SM::PART);
  float* AS = reinterpret_cast<float*>(smem + SM::AS);
  float* AD = reinterpret_cast<float*>(smem + SM::AD);
  const int wr = warp & 3, wc = warp >> 2;
  if constexpr (MODE == INT8) {
    if (tid < BM) sq[tid] = a.xs[row0 + tid];
  }
  const XSrc src{a.x, a.xq, a.n_rows, a.Fin, nk * KC,
                 a.Fin % 4 == 0 && ((uintptr_t)a.x & 15) == 0};
  __syncthreads();
  int it = 0;
  Acc<MODE, NP> acc;
  for (int ch = 0; ch < nch; ++ch) {
    project<MODE, NP, false>(acc, src, row0, nk, smem + SM::X, ring,
                             a.wst + (size_t)(hd * nch + ch) * nk * SM::TB,
                             it, tid);
    const int c0 = hd * C + ch * CW;         // the chunk's first column
    const int cw = min(CW, C - ch * CW);     // its real columns
    // h as f32: the sum, or under INT8 (float)q * s_row * s_col
    auto hv = [&](int mt, int n, int i) -> float {
      if constexpr (MODE == INT8) {
        const int r = 32 * wr + 16 * mt + (lane >> 2) + 8 * (i >> 1);
        const int c = 32 * NP * wc + 8 * n + 2 * (lane & 3) + (i & 1);
        return __fmul_rn(__fmul_rn((float)acc.v[mt][n][i], sq[r]),
                         c < cw ? __ldg(a.sw + c0 + c) : 0.f);
      } else {
        return acc.v[mt][n][i];
      }
    };
    each_pair<NP>(wr, wc, lane, [&](int mt, int n, int hh, int r, int c) {
      const int row = row0 + r;
      if (row >= a.n_rows) return;
      float* dst = a.h + (size_t)row * HC + c0 + c;
      if (c < cw) dst[0] = hv(mt, n, 2 * hh);
      if (c + 1 < cw) dst[1] = hv(mt, n, 2 * hh + 1);
    });
    logit_partials<NP>(hv, a.att_src + c0, a.att_dst + c0, cw, part, wr, wc,
                       lane);
    __syncthreads();
    if (tid < BM) sum_partials(part, AS, AD, tid, ch == 0);
    // the next chunk's partials are written after project()'s barriers
  }
  __syncthreads();
  if (tid < BM && row0 + tid < a.n_rows) {
    a.a_src[(size_t)(row0 + tid) * a.H + hd] = AS[tid];
    a.a_dst[(size_t)(row0 + tid) * a.H + hd] = AD[tid];
  }
}

template <int MODE, int NP>
cudaError_t launch_proj_np(const ProjArgs& p, cudaStream_t st) {
  constexpr int smem = ProjLayout<MODE, NP>::END;
  cudaError_t err = cudaFuncSetAttribute(
      gat_proj_tc_kernel<MODE, NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n_rows + BM - 1) / BM, p.H);
  gat_proj_tc_kernel<MODE, NP><<<grid, TC_THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_proj_mode(const ProjArgs& p, cudaStream_t st) {
  return chunk_cols(p.C) == 64 ? launch_proj_np<MODE, 1>(p, st)
                               : launch_proj_np<MODE, 2>(p, st);
}

cudaError_t launch_proj(const ProjArgs& p, int mode, cudaStream_t st) {
  if (mode == BF16) return launch_proj_mode<BF16>(p, st);
  if (mode == INT8) return launch_proj_mode<INT8>(p, st);
  return launch_proj_mode<F32>(p, st);
}

template <int MODE, int NP>
cudaError_t proj_info(int* regs, int* smem_bytes, int* ctas) {
  return kernel_info(gat_proj_tc_kernel<MODE, NP>,
                     ProjLayout<MODE, NP>::END, regs, smem_bytes, ctas);
}

// ------------------------------------------------------------- attention

struct AttnArgs {
  const float* h;       // [N, HC]
  const float* a_src;   // [N, H]
  const float* a_dst;   // [N, H]
  const int* nbr;       // [N, W]
  const int* deg;       // [N]
  const float* le;      // [N, W, H] slot edge terms (EDGE)
  const float* ae_self; // [N, H] self-slot edge terms (EDGE)
  const float* bias;    // [HC]
  const float* skip;    // [N, HC] or null
  float* out;           // [N, HC]
  int n_rows, W, H, C, self_loops, act;
  int vec4;             // C % 4 == 0, h, bias, skip, out 16-byte aligned
  float neg_slope;
};

// Shared floats per warp: the slot ids (W), the exp weights (H x W), and
// per head the self weight and the denominator.
__host__ __device__ __forceinline__ int warp_words(int W, int H) {
  return W + H * W + 2 * H;
}

template <bool EDGE>
__global__ void __launch_bounds__(THREADS) gat_attn_kernel(AttnArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int W = a.W, H = a.H, C = a.C, HC = H * C;
  float* base = smem + (size_t)warp * warp_words(W, H);
  int* ids = reinterpret_cast<int*>(base);   // [W]
  float* ew = base + W;                      // [H, W]
  float* es = ew + H * W;                    // [H]
  float* den = es + H;                       // [H]
  const float ns = a.neg_slope;
  for (int r = blockIdx.x * WARPS + warp; r < a.n_rows;
       r += gridDim.x * WARPS) {
    const int d = a.deg[r];
    for (int k = lane; k < d; k += 32) ids[k] = a.nbr[(size_t)r * W + k];
    __syncwarp();
    for (int hd = 0; hd < H; ++hd) {
      const float ad = a.a_dst[(size_t)r * H + hd];
      float mx = -BIG;
      for (int k = lane; k < d; k += 32) {
        float z = a.a_src[(size_t)ids[k] * H + hd] + ad;
        if (EDGE) z += a.le[((size_t)r * W + k) * H + hd];
        z = lrelu(z, ns);
        ew[hd * W + k] = z;
        mx = fmaxf(mx, z);
      }
      mx = warp_max(mx);
      float zs = 0.f;
      if (a.self_loops) {
        zs = a.a_src[(size_t)r * H + hd] + ad;
        if (EDGE) zs += a.ae_self[(size_t)r * H + hd];
        zs = lrelu(zs, ns);
        mx = fmaxf(mx, zs);
      }
      mx = fmaxf(mx, -BIG * 0.5f);
      float sum = 0.f;
      for (int k = lane; k < d; k += 32) {
        const float e = expf(ew[hd * W + k] - mx);
        ew[hd * W + k] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      const float e_s = a.self_loops ? expf(zs - mx) : 0.f;
      if (lane == 0) {
        es[hd] = e_s;
        den[hd] = sum + e_s;
      }
    }
    __syncwarp();
    if (a.vec4) {   // four columns of one head a lane, 16-byte loads
      for (int c = 4 * lane; c < HC; c += 128) {
        const int hd = c / C;
        const float* e = ew + hd * W;
        float num[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < d; ++k) {
          const float w = e[k];
          const float4 hv = *reinterpret_cast<const float4*>(
              a.h + (size_t)ids[k] * HC + c);
          num[0] = fmaf(w, hv.x, num[0]);
          num[1] = fmaf(w, hv.y, num[1]);
          num[2] = fmaf(w, hv.z, num[2]);
          num[3] = fmaf(w, hv.w, num[3]);
        }
        const size_t o_idx = (size_t)r * HC + c;
        if (a.self_loops) {
          const float4 hs = *reinterpret_cast<const float4*>(a.h + o_idx);
          num[0] = fmaf(es[hd], hs.x, num[0]);
          num[1] = fmaf(es[hd], hs.y, num[1]);
          num[2] = fmaf(es[hd], hs.z, num[2]);
          num[3] = fmaf(es[hd], hs.w, num[3]);
        }
        const float dn = fmaxf(den[hd], 1e-16f);
        const float4 b = *reinterpret_cast<const float4*>(a.bias + c);
        float o[4] = {num[0] / dn + b.x, num[1] / dn + b.y, num[2] / dn + b.z,
                      num[3] / dn + b.w};
        if (a.skip != nullptr) {
          const float4 sk = *reinterpret_cast<const float4*>(a.skip + o_idx);
          o[0] += sk.x;
          o[1] += sk.y;
          o[2] += sk.z;
          o[3] += sk.w;
        }
        *reinterpret_cast<float4*>(a.out + o_idx) =
            make_float4(act_fn(o[0], a.act), act_fn(o[1], a.act),
                        act_fn(o[2], a.act), act_fn(o[3], a.act));
      }
    } else {
      for (int c = lane; c < HC; c += 32) {
        const int hd = c / C;
        const float* e = ew + hd * W;
        float num = 0.f;
        for (int k = 0; k < d; ++k)
          num = fmaf(e[k], a.h[(size_t)ids[k] * HC + c], num);
        const size_t o_idx = (size_t)r * HC + c;
        if (a.self_loops) num = fmaf(es[hd], a.h[o_idx], num);
        float o = num / fmaxf(den[hd], 1e-16f) + a.bias[c];
        if (a.skip != nullptr) o += a.skip[o_idx];
        a.out[o_idx] = act_fn(o, a.act);
      }
    }
    __syncwarp();
  }
}

size_t attn_smem_bytes(int W, int H) {
  return (size_t)WARPS * warp_words(W, H) * sizeof(float);
}

}  // namespace

extern "C" {

// Shared memory the attention launch needs at ELL width W and H heads, in
// bytes (the wrapper checks it against gnnb_smem_per_block_optin).
int gnnb_gat_layer_smem_bytes(int W, int H) {
  return (int)attn_smem_bytes(W, H);
}

// Registers, shared memory (bytes) and resident CTAs per SM of the
// projection's instance for `mode` and chunk width 64 * np (np 1, 2).
int gnnb_gat_proj_info(int mode, int np, int* regs, int* smem_bytes,
                       int* ctas_per_sm) {
  if (np != 1 && np != 2) return (int)cudaErrorInvalidValue;
  if (mode == F32)
    return (int)(np == 1 ? proj_info<F32, 1>(regs, smem_bytes, ctas_per_sm)
                         : proj_info<F32, 2>(regs, smem_bytes, ctas_per_sm));
  if (mode == BF16)
    return (int)(np == 1 ? proj_info<BF16, 1>(regs, smem_bytes, ctas_per_sm)
                         : proj_info<BF16, 2>(regs, smem_bytes, ctas_per_sm));
  if (mode == INT8)
    return (int)(np == 1 ? proj_info<INT8, 1>(regs, smem_bytes, ctas_per_sm)
                         : proj_info<INT8, 2>(regs, smem_bytes, ctas_per_sm));
  return (int)cudaErrorInvalidValue;
}

// Launches the layer on `stream` of `device`: the projection into the
// scratch h [N, H*C], a_src and a_dst [N, H], then the attention into out
// [N, H*C].  wst: the weights in stage_projection's layout for `mode`
// (no logit tile), wst_bytes long, 16-byte aligned; act: 0 none, 1 relu,
// 2 gelu, 3 sigmoid, 4 tanh; skip may be null; mode: 0 f32, 1 bf16, 2
// int8 (with column scales sw [H*C] and the scratch xq [N128, Kp] int8
// and xs [N128] f32, N128 = N rounded up to 128 and Kp = Fin rounded up
// to 32, 16-byte aligned; all three null otherwise); le [N, W, H] and
// ae_self [N, H] both given (the edge-logit mode) or both null.  All
// other arrays contiguous f32 / i32 as documented in ops/cuda/gat_layer.py.
// Returns the cudaError_t of the launches (0 = success).
int gnnb_gat_layer(const void* x, const void* nbr, const void* deg,
                   int n_rows, int W, int Fin, int H, int C, const void* wst,
                   long long wst_bytes, const void* att_src,
                   const void* att_dst, const void* bias, const void* skip,
                   float neg_slope, int self_loops, int act, int mode,
                   const void* sw, const void* le, const void* ae_self,
                   void* xq, void* xs, void* h, void* a_src, void* a_dst,
                   void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows < 0 || W < 1 || Fin < 1 || H < 1 || C < 1 || act < 0 ||
      act > 4 || !x || !nbr || !deg || !wst || !att_src || !att_dst ||
      !bias || !h || !a_src || !a_dst || !out || mode < F32 ||
      mode > INT8 || (mode == INT8) != (sw != nullptr) ||
      (mode == INT8) != (xq != nullptr && xs != nullptr) ||
      (le == nullptr) != (ae_self == nullptr) || ((uintptr_t)wst & 15) ||
      wst_bytes != (long long)staged_bytes(mode, Fin, H, C, false))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  size_t optin = 0;
  err = optin_bytes(device, &optin);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = attn_smem_bytes(W, H);
  if (smem > optin) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int Kp = n_ktiles(Fin) * KC;
  const int n_pad = (n_rows + BM - 1) / BM * BM;
  if (mode == INT8) {
    quantize_rows_kernel<<<(n_pad + WARPS - 1) / WARPS, THREADS, 0, st>>>(
        (const float*)x, n_rows, Fin, Kp, n_pad, (int8_t*)xq, (float*)xs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  ProjArgs p;
  p.x = (const float*)x;
  p.xq = (const int8_t*)xq;
  p.xs = (const float*)xs;
  p.wst = (const unsigned char*)wst;
  p.sw = (const float*)sw;
  p.att_src = (const float*)att_src;
  p.att_dst = (const float*)att_dst;
  p.h = (float*)h;
  p.a_src = (float*)a_src;
  p.a_dst = (float*)a_dst;
  p.n_rows = n_rows;
  p.Fin = Fin;
  p.H = H;
  p.C = C;
  err = launch_proj(p, mode, st);
  if (err != cudaSuccess) return (int)err;
  AttnArgs a;
  a.h = (const float*)h;
  a.a_src = (const float*)a_src;
  a.a_dst = (const float*)a_dst;
  a.nbr = (const int*)nbr;
  a.deg = (const int*)deg;
  a.le = (const float*)le;
  a.ae_self = (const float*)ae_self;
  a.bias = (const float*)bias;
  a.skip = (const float*)skip;
  a.out = (float*)out;
  a.n_rows = n_rows;
  a.W = W;
  a.H = H;
  a.C = C;
  a.self_loops = self_loops != 0;
  a.act = act;
  a.vec4 = C % 4 == 0 && !(((uintptr_t)h | (uintptr_t)bias |
                            (uintptr_t)skip | (uintptr_t)out) & 15);
  a.neg_slope = neg_slope;
  auto kernel = le != nullptr ? gat_attn_kernel<true>
                               : gat_attn_kernel<false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_rows + WARPS - 1) / WARPS;
  kernel<<<blocks, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
