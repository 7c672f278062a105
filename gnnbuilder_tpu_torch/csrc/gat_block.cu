// One GAT layer on a block-packed batch: attention restricted to each
// 128-row block, from the block adjacency's edge counts; inference only.
//
// Replaces: gnnbuilder_tpu/ops/pallas/gat_block.py fused_gat_block_layer
// (kernel body _kernel).  A[t, i, j] is the number of edges
// (t*128 + j) -> (t*128 + i).  For every row r = t*128 + i and head hd:
//
//   h, a_src, a_dst  = the projection of x (gat_common.cuh)
//   z_j   = leaky_relu(a_dst[r, hd] + a_src[t*128 + j, hd])
//   m     = max(max over A[t, i, j] > 0 of z_j, z_s), z_s the self logit
//           leaky_relu(a_src[r, hd] + a_dst[r, hd]); at least -BIG / 2
//   w_j   = A[t, i, j] exp(z_j - m)     (k parallel edges: k equal terms)
//   den   = sum_j w_j + exp(z_s - m);  num = sum_j w_j h[t*128 + j] +
//           exp(z_s - m) h[r]           (j in column order, self last)
//   res   = num / max(den, 1e-16)
//   out   = act(res + bias [+ skip])                  (concat: [N, H*C])
//   out   = act((sum_hd res_hd) / H + bias [+ skip])  (head mean: [N, C])
//
// The self terms drop out with self_loops = 0 (an empty row then gives
// bias).  No int8 mode, as in the JAX package: its gate sends GAT to the
// layer kernel under int8.
//
// Edge-logit mode (elog given; GATConv edge_dim, in both modes): elog [N / 128, H, 128, 128] holds a float32 term per pair and
// self_extra [N, H] one per self loop, added before the leaky ReLU:
//
//   z_j   = leaky_relu((a_dst[r, hd] + a_src[t*128 + j, hd])
//                      + elog[t, hd, i, j])
//   z_s   = leaky_relu((a_src[r, hd] + a_dst[r, hd]) + self_extra[r, hd])
//
// (the TPU kernel's elog_in, float32 in every mode).  Each row's 512
// contiguous bytes of its head's table are read once, as one 16-byte load
// a lane, a row ahead.
//
// bf16 mode (mode 1, the TPU kernel's mm="bf16"; inference only): the
// projection rounds x to bf16 against bfloat16 W, and forms the logit
// terms as x . wa with bf16 operands, wa = bf16(bf16(W) A) per head (the
// TPU kernel's asrc = x @ (W @ A_src), not h . att_src), as two more MMA
// columns of the projection (gat_common.cuh's logit tile);
// the weighted sum rounds each weight w_j and each gathered h[j] to bf16
// (the TPU kernel's dot(wgt, hblk) in bf16), while den sums the unrounded
// weights and the self term es * h[r] and the bias stay float32.
//
// What bounds it on the H100: operations: the projection's 2 Fin HC
// flops per row dominate (a QM9 block is ~97 % zeros, so the attention is
// ~2 HC flops per edge).  The products run on the tensor cores
// (gat_common.cuh), so the least time is min(flops / 67 T, 3 flops /
// 495 T) for the f32 products, the attention at 67 T.
//
// Design: one launch, as the TPU kernel keeps h in VMEM (h_scr).  Every
// neighbour of a row lies in the row's 128-row block, so a CTA takes one
// block and one head (concat: grid [N / 128, H]; head mean: one CTA per
// block loops over the heads, adding each head's res into out, which the
// same thread reads back, and finishes with the mean, bias, skip and act
// at the last head).  It projects the head's [128, C] slice of h on the
// tensor cores (gat_common.cuh, with the logit halves of the block's
// rows) into shared memory, over the ring's and the x chunks' bytes once
// the products are done, and runs the softmax and the weighted sum from
// there: each warp takes one row at a time, compacts its adjacency row
// into (count << 8 | column) entries in column order (the next row's
// counts, the row's skip and bias loaded ahead: with one CTA per SM
// nothing else hides their latency), the lanes take the entries for the
// logits (a warp max and a warp sum give m and den, the weights go to
// shared memory), then the output columns, each summed over the entries
// in column order, the self slot last.  A head wider than 128 columns takes its chunks in
// turn (in f32 a first pass over the chunks forms its logit halves, a
// second recomputes each chunk for the weighted sum); the next region's
// tiles are issued into those bytes only after a fence and a barrier.  h
// never reaches device memory.

#include "gat_common.cuh"

namespace {

using namespace gnnb_gat;

constexpr int BB = 128;               // rows of an adjacency block (= BM)
static_assert(BB == BM, "a CTA owns one adjacency block");

struct BlockArgs {
  const float* x;              // [N, Fin]
  const float* adj;            // [N / 128, 128, 128] counts
  const unsigned char* wst;    // staged weights (stage_projection)
  const float* att_src;        // [HC]
  const float* att_dst;        // [HC]
  const float* elog;           // [N / 128, H, 128, 128] edge terms or null
  const float* sextra;         // [N, H] self-loop edge terms or null
  const float* bias;           // [HC] (concat) or [C] (head mean)
  const float* skip;           // [N, out width] or null
  float* out;                  // [N, HC] or [N, C]
  int n_rows, Fin, H, C, self_loops, concat, act;
  float neg_slope;
};

// h of one chunk in shared memory: [128, 64 NP + 8] f32 (the pad keeps
// the epilogue's stores of 8 rows off one bank)
template <int NP> __host__ __device__ constexpr int ldh() {
  return 64 * NP + 8;
}
template <int NP> __host__ __device__ constexpr int hs_bytes() {
  return BM * ldh<NP>() * 4;
}

// the projection's carve-up with h over the ring and x chunks, then each
// warp's list of its current row and the row's weights
template <int MODE, int NP> struct BlockSmem {
  using P = ProjSmem<MODE, NP, MODE == BF16, hs_bytes<NP>()>;
  static constexpr int ENT = P::END;                   // [CWARPS][BB] int
  static constexpr int EW = ENT + CWARPS * BB * 4;     // [CWARPS][BB] f32
  static constexpr int END = EW + CWARPS * BB * 4;
  static_assert(END <= 232448, "shared memory over the card's limit");
};

// The softmax and the weighted sum of head hd over the block's rows, for
// the chunk's columns [c0, c0 + cw) of the head, h of the chunk in Hs.
// Each warp takes rows warp, warp + 8, ...: it compacts the row's 128
// adjacency counts into (count << 8 | column) entries in column order (a
// warp prefix sum over the lanes' four columns each, as block_lists.cuh
// compact_rows), with the next row's counts and pair terms, the row's
// skip, bias and self term loaded ahead; then the lanes take the entries
// for the logits (a pair term comes from the lane that loaded its column)
// and the columns (2 NP a lane, unrolled) for the weighted sum.
template <int MODE, int NP>
__device__ __forceinline__ void attend(const BlockArgs& a, int hd, int c0,
                                       int cw, const float* Hs,
                                       const float* AS, const float* AD,
                                       int* ent, float* ew, int row0,
                                       int warp, int lane) {
  constexpr int LD = ldh<NP>();
  constexpr int NC = 2 * NP;                 // columns a lane
  const int H = a.H, C = a.C, HC = H * C;
  const int out_w = a.concat ? HC : C;
  const int bcol = a.concat ? hd * C + c0 : c0;   // first output column
  const float ns = a.neg_slope;
  const int t = row0 / BB;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* adj = reinterpret_cast<const float4*>(a.adj) +
                      (size_t)row0 * (BB / 4);
  // this block's [128, 128] pair terms of head hd, a row a warp at a time
  const float4* el = a.elog != nullptr
                         ? reinterpret_cast<const float4*>(a.elog) +
                               ((size_t)t * H + hd) * BB * (BB / 4)
                         : nullptr;
  float4 q = __ldg(adj + (size_t)warp * (BB / 4) + lane);
  float4 eq = el != nullptr ? __ldg(el + (size_t)warp * (BB / 4) + lane)
                            : zero4;
  for (int i = warp; i < BM; i += CWARPS) {
    const int r = row0 + i;
    const bool more = i + CWARPS < BM;
    const float4 qn =
        more ? __ldg(adj + (size_t)(i + CWARPS) * (BB / 4) + lane) : zero4;
    const float4 eqn = more && el != nullptr
                           ? __ldg(el + (size_t)(i + CWARPS) * (BB / 4) + lane)
                           : zero4;
    const float se = a.self_loops && a.sextra != nullptr
                         ? __ldg(a.sextra + (size_t)r * H + hd) : 0.f;
    float sk[NC], bs[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      const bool ok = c < cw;
      bs[j] = ok ? __ldg(a.bias + bcol + c) : 0.f;
      sk[j] = ok && a.skip != nullptr
                  ? __ldg(a.skip + (size_t)r * out_w + bcol + c) : 0.f;
    }
    // the row's entries
    const float qv[4] = {q.x, q.y, q.z, q.w};
    const int nl = (q.x != 0.f) + (q.y != 0.f) + (q.z != 0.f) + (q.w != 0.f);
    int incl = nl;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const int n = __shfl_sync(0xffffffffu, incl, 31);
    int e = incl - nl;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (qv[k] != 0.f) ent[e++] = ((int)qv[k] << 8) | (lane * 4 + k);
    __syncwarp();
    const float ad = AD[i];
    float mx = -BIG;
    for (int k0 = 0; k0 < n; k0 += 32) {   // all lanes: the shuffles below
      const int k = k0 + lane;
      const int jl = k < n ? ent[k] & 0xFF : 0;
      float z = ad + AS[jl];
      if (el != nullptr) {   // the pair term, from the lane holding column jl
        const int src = jl >> 2, c = jl & 3;
        const float e0 = __shfl_sync(0xffffffffu, eq.x, src);
        const float e1 = __shfl_sync(0xffffffffu, eq.y, src);
        const float e2 = __shfl_sync(0xffffffffu, eq.z, src);
        const float e3 = __shfl_sync(0xffffffffu, eq.w, src);
        z += c == 0 ? e0 : c == 1 ? e1 : c == 2 ? e2 : e3;
      }
      z = lrelu(z, ns);
      if (k < n) {
        ew[k] = z;
        mx = fmaxf(mx, z);
      }
    }
    mx = warp_max(mx);
    float zs = 0.f;
    if (a.self_loops) {
      zs = AS[i] + ad;
      if (a.sextra != nullptr) zs += se;
      zs = lrelu(zs, ns);
      mx = fmaxf(mx, zs);
    }
    mx = fmaxf(mx, -BIG * 0.5f);
    float sum = 0.f;
    for (int k = lane; k < n; k += 32) {
      const float wk = (float)(ent[k] >> 8) * expf(ew[k] - mx);
      // the weighted sum's operand; den sums the weight unrounded
      ew[k] = MODE == BF16 ? gnnb_quant::bf16r(wk) : wk;
      sum += wk;
    }
    sum = warp_sum(sum);
    const float e_s = a.self_loops ? expf(zs - mx) : 0.f;
    const float den = fmaxf(sum + e_s, 1e-16f);
    __syncwarp();
    float num[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) num[j] = 0.f;
    for (int k = 0; k < n; ++k) {
      const int p = ent[k];
      const float w = ew[k];
      const float* hr = Hs + (p & 0xFF) * LD + lane;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float hv = hr[32 * j];
        num[j] = fmaf(w, MODE == BF16 ? gnnb_quant::bf16r(hv) : hv, num[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      if (c >= cw) continue;
      if (a.self_loops) num[j] = fmaf(e_s, Hs[i * LD + c], num[j]);
      const float res = num[j] / den;
      const size_t o_idx = (size_t)r * out_w + bcol + c;
      if (a.concat) {
        a.out[o_idx] = act_fn(res + bs[j] + sk[j], a.act);
      } else {
        // the head mean: res of each head added in head order, in out
        const float acc = hd == 0 ? res : a.out[o_idx] + res;
        a.out[o_idx] = hd + 1 < H ? acc
                                  : act_fn(acc * (1.f / H) + bs[j] + sk[j],
                                           a.act);
      }
    }
    __syncwarp();
    q = qn;
    eq = eqn;
  }
}

template <int MODE, int NP>
__global__ void __launch_bounds__(TC_THREADS, 1)
gat_block_tc_kernel(BlockArgs a) {
  using SM = BlockSmem<MODE, NP>;
  using P = typename SM::P;
  constexpr bool LOGIT = MODE == BF16;
  constexpr int CW = 64 * NP;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * BM;
  const int C = a.C, nch = (C + CW - 1) / CW;
  const int nk = (a.Fin + KC - 1) / KC;
  const int hd0 = a.concat ? blockIdx.y : 0;
  const int hd1 = a.concat ? blockIdx.y + 1 : a.H;
  // f32 forms a wide head's logit halves in a first pass over its chunks
  const bool pass_a = MODE == F32 && nch > 1;
  const TileRing<P::S, P::TB> ring{smem + P::RING,
                                   gnnb_mma::smem_addr(smem + P::BAR)};
  if (tid == 0) init_ring<P::S>(ring.full);
  float* part = reinterpret_cast<float*>(smem + P::PART);
  float* AS = reinterpret_cast<float*>(smem + P::AS);
  float* AD = reinterpret_cast<float*>(smem + P::AD);
  float* Hs = reinterpret_cast<float*>(smem);          // over ring and x
  int* ent = reinterpret_cast<int*>(smem + SM::ENT) + warp * BB;
  float* ew = reinterpret_cast<float*>(smem + SM::EW) + warp * BB;
  const int wr = warp & 3, wc = warp >> 2;
  const XSrc src{a.x, nullptr, a.n_rows, a.Fin, nk * KC,
                 a.Fin % 4 == 0 && ((uintptr_t)a.x & 15) == 0};
  Acc<MODE, NP> acc;
  int it = 0;
  __syncthreads();
  for (int hd = hd0; hd < hd1; ++hd) {
    const float* att_s = a.att_src + hd * C;
    const float* att_d = a.att_dst + hd * C;
    for (int pass = pass_a ? 0 : 1; pass < 2; ++pass) {
      for (int ch = 0; ch < nch; ++ch) {
        const int cw = min(CW, C - ch * CW);
        project<MODE, NP, LOGIT>(
            acc, src, row0, nk, smem + P::X, ring,
            a.wst + (size_t)(hd * nch + ch) * nk * P::TB, it, tid);
        // the logit halves: f32 from h . att (every chunk of the first
        // pass, or the one chunk); bf16 from the logit tile (chunk 0)
        if (MODE == F32 && (pass == 0 || nch == 1)) {
          logit_partials<NP>(
              [&](int mt, int n, int i) { return (float)acc.v[mt][n][i]; },
              att_s + ch * CW, att_d + ch * CW, cw, part, wr, wc, lane);
        }
        if (MODE == BF16 && ch == 0 && wc == 0 && (lane & 3) == 0) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = 32 * wr + 16 * mt + (lane >> 2) + 8 * hh;
              AS[r] = (float)acc.l[mt][2 * hh];
              AD[r] = (float)acc.l[mt][2 * hh + 1];
            }
        }
        if (pass == 1) {   // h of the chunk over the ring and x chunks
          each_pair<NP>(wr, wc, lane,
                        [&](int mt, int n, int hh, int r, int c) {
                          *reinterpret_cast<float2*>(Hs + r * ldh<NP>() + c) =
                              make_float2((float)acc.v[mt][n][2 * hh],
                                          (float)acc.v[mt][n][2 * hh + 1]);
                        });
        }
        __syncthreads();
        if (MODE == F32 && (pass == 0 || nch == 1)) {
          if (tid < BM) sum_partials(part, AS, AD, tid, ch == 0);
          __syncthreads();
        }
        if (pass == 1)
          attend<MODE, NP>(a, hd, ch * CW, cw, Hs, AS, AD, ent, ew, row0,
                           warp, lane);
        fence_async();   // Hs lies over the ring: the next region's copies
        __syncthreads();
      }
    }
  }
}

template <int MODE, int NP>
cudaError_t launch_block_np(const BlockArgs& a, cudaStream_t st) {
  constexpr int smem = BlockSmem<MODE, NP>::END;
  cudaError_t err = cudaFuncSetAttribute(
      gat_block_tc_kernel<MODE, NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_rows / BM, a.concat ? a.H : 1);
  gat_block_tc_kernel<MODE, NP><<<grid, TC_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_block_mode(const BlockArgs& a, cudaStream_t st) {
  return chunk_cols(a.C) == 64 ? launch_block_np<MODE, 1>(a, st)
                               : launch_block_np<MODE, 2>(a, st);
}

template <int MODE, int NP>
cudaError_t block_info(int* regs, int* smem_bytes, int* ctas) {
  return kernel_info(gat_block_tc_kernel<MODE, NP>,
                     BlockSmem<MODE, NP>::END, regs, smem_bytes, ctas);
}

}  // namespace

extern "C" {

// Rows of an adjacency block the kernel takes.
int gnnb_gat_block_rows() { return BB; }

// Registers, shared memory (bytes) and resident CTAs per SM of the
// kernel's instance for `mode` (0 f32, 1 bf16) and chunk width 64 * np.
int gnnb_gat_block_info(int mode, int np, int* regs, int* smem_bytes,
                        int* ctas_per_sm) {
  if (np != 1 && np != 2) return (int)cudaErrorInvalidValue;
  if (mode == F32)
    return (int)(np == 1 ? block_info<F32, 1>(regs, smem_bytes, ctas_per_sm)
                         : block_info<F32, 2>(regs, smem_bytes, ctas_per_sm));
  if (mode == BF16)
    return (int)(np == 1 ? block_info<BF16, 1>(regs, smem_bytes, ctas_per_sm)
                         : block_info<BF16, 2>(regs, smem_bytes, ctas_per_sm));
  return (int)cudaErrorInvalidValue;
}

// Launches the layer on `stream` of `device` into out ([N, H*C] with
// concat, else [N, C]).  n_rows % 128 == 0; wst: the weights in
// stage_projection's layout for `mode` (0 f32; 1 bf16, with the logit
// tile of wa_src / wa_dst), wst_bytes long, 16-byte aligned; act: 0 none,
// 1 relu, 2 gelu, 3 sigmoid, 4 tanh; skip may be null; elog [N / 128, H,
// 128, 128] and self_extra [N, H] both given (the edge-logit mode) or
// both null.  All other arrays contiguous f32 as documented in
// ops/cuda/gat_block.py.  Returns the cudaError_t of the launch (0 =
// success).
int gnnb_gat_block(const void* x, const void* adj, int n_rows, int Fin,
                   int H, int C, const void* wst, long long wst_bytes,
                   const void* att_src, const void* att_dst,
                   const void* bias, const void* skip, float neg_slope,
                   int self_loops, int concat, int act, int mode,
                   const void* elog, const void* self_extra, void* out,
                   void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows < 0 || n_rows % BB || Fin < 1 || H < 1 || C < 1 || act < 0 ||
      act > 4 || !x || !adj || !wst || !att_src || !att_dst || !bias ||
      !out || (mode != F32 && mode != BF16) ||
      (elog == nullptr) != (self_extra == nullptr) ||
      ((uintptr_t)wst & 15) || ((uintptr_t)adj & 15) ||
      wst_bytes != (long long)staged_bytes(mode, Fin, H, C, mode == BF16))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  BlockArgs a;
  a.x = (const float*)x;
  a.adj = (const float*)adj;
  a.wst = (const unsigned char*)wst;
  a.att_src = (const float*)att_src;
  a.att_dst = (const float*)att_dst;
  a.elog = (const float*)elog;
  a.sextra = (const float*)self_extra;
  a.bias = (const float*)bias;
  a.skip = (const float*)skip;
  a.out = (float*)out;
  a.n_rows = n_rows;
  a.Fin = Fin;
  a.H = H;
  a.C = C;
  a.self_loops = self_loops != 0;
  a.concat = concat != 0;
  a.act = act;
  a.neg_slope = neg_slope;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(mode == BF16 ? launch_block_mode<BF16>(a, st)
                            : launch_block_mode<F32>(a, st));
}

}  // extern "C"
