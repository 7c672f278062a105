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
// (gat_common.cuh).  bf16 (mode 1, the TPU kernel's mm="bf16") rounds
// its operands; int8 (mode 2, quant=True, the serving precision)
// quantizes x per row against int8 W with column scales, for a
// receiver's own row as for its neighbours'.  h, the logit halves, the
// softmax and the weighted sum stay float32, and the gather is exact: the
// TPU kernel's gather is its "highest" one-hot product or its hi/lo
// "split2" pair whatever gather_mode says, never a bf16 rounding.
//
// What bounds it on the H100: operations.  The projection is 2 Fin HC
// flops per row (1 M at 512 x 512) against ~4 KB of row traffic; the
// attention adds ~2 HC flops per edge.  Plain f32 FMAs (no tensor cores),
// so the f32 FMA rate is its roof.
//
// Design: two launches.  The first is the projection (gat_common.cuh).
// The second gives each warp one receiver row: its slot ids go to shared
// memory, the lanes take the slots for the logits (a warp max and a warp
// sum give m and den per head, the exp weights go to shared memory), then
// the lanes take the output columns, each summing its column over the
// slots in slot order.  A neighbour id is an exact indexed load of h, so
// the TPU kernel's one-hot MXU gathers, its hi/lo split, the head
// expansion matmuls and the window DMAs do not apply, and no width is
// padded.

#include "gat_common.cuh"

namespace {

using namespace gnnb_gat;

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

// Launches the layer on `stream` of `device`: the projection into the
// scratch h [N, H*C], a_src and a_dst [N, H], then the attention into out
// [N, H*C].  act: 0 none, 1 relu, 2 gelu, 3 sigmoid, 4 tanh; skip may be
// null; mode: 0 f32, 1 bf16 (w bfloat16), 2 int8 (w int8 with column
// scales sw [H*C]; sw null otherwise); le [N, W, H] and ae_self [N, H]
// both given (the edge-logit mode) or both null.  All other arrays
// contiguous f32 / i32 as documented in ops/cuda/gat_layer.py.  Returns
// the cudaError_t of the launches (0 = success).
int gnnb_gat_layer(const void* x, const void* nbr, const void* deg,
                   int n_rows, int W, int Fin, int H, int C, const void* w,
                   const void* att_src, const void* att_dst,
                   const void* bias, const void* skip, float neg_slope,
                   int self_loops, int act, int mode, const void* sw,
                   const void* le, const void* ae_self,
                   void* h, void* a_src, void* a_dst, void* out,
                   void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows < 0 || W < 1 || Fin < 1 || H < 1 || C < 1 || act < 0 ||
      act > 4 || !x || !nbr || !deg || !w || !att_src || !att_dst ||
      !bias || !h || !a_src || !a_dst || !out || mode < F32 ||
      mode > INT8 || (mode == INT8) != (sw != nullptr) ||
      (le == nullptr) != (ae_self == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  size_t optin = 0;
  err = optin_bytes(device, &optin);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = attn_smem_bytes(W, H);
  if (smem > optin) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ProjArgs p;
  p.x = (const float*)x;
  p.w = w;
  p.sw = (const float*)sw;
  p.att_src = (const float*)att_src;
  p.att_dst = (const float*)att_dst;
  p.wa_src = p.wa_dst = nullptr;
  p.h = (float*)h;
  p.a_src = (float*)a_src;
  p.a_dst = (float*)a_dst;
  p.n_rows = n_rows;
  p.Fin = Fin;
  p.H = H;
  p.C = C;
  err = launch_proj(p, mode, optin, st);
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
