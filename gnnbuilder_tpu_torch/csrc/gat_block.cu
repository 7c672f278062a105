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
// bias).  No edge-logit mode here (the TPU kernel's edge_table is still
// to port), and no int8 mode, as in the JAX package: its gate sends GAT
// to the layer kernel under int8.
//
// bf16 mode (mode 1, the TPU kernel's mm="bf16"; inference only): the
// projection rounds x to bf16 against bfloat16 W, and forms the logit
// terms as x . wa with bf16 operands, wa = bf16(bf16(W) A) per head (the
// TPU kernel's asrc = x @ (W @ A_src), not h . att_src: gat_common.cuh);
// the weighted sum rounds each weight w_j and each gathered h[j] to bf16
// (the TPU kernel's dot(wgt, hblk) in bf16), while den sums the unrounded
// weights and the self term es * h[r] and the bias stay float32.
//
// What bounds it on the H100: operations, as in gat_layer.cu: the
// projection's 2 Fin HC flops per row dominate (a QM9 block is ~97 %
// zeros, so the attention is ~2 HC flops per edge).  Plain f32 FMAs.
//
// Design: two launches, the projection first (gat_common.cuh).  In the
// second a CTA owns 32 rows of one block: it compacts their adjacency
// rows into (count, column) lists in shared memory (block_lists.cuh, as
// the mp kernels do), so only edges are visited; then each warp takes
// one row at a time: the lanes take the list entries for the logits (a
// warp max and a warp sum per head give m and den, the weights go to
// shared memory), then the output columns, each summed over the list in
// column order.  The TPU kernel's dense [128, 128] score tiles and its
// MXU product existed for the TPU's vector units; here a sparse row
// costs its edges.

#include "block_lists.cuh"
#include "gat_common.cuh"

namespace {

using namespace gnnb_gat;

constexpr int BB = gnnb::LIST_COLS;   // rows of an adjacency block
constexpr int R = 32;                 // rows per attention CTA

struct BlockArgs {
  const float* h;       // [N, HC]
  const float* a_src;   // [N, H]
  const float* a_dst;   // [N, H]
  const float* adj;     // [N / 128, 128, 128] counts
  const float* bias;    // [HC] (concat) or [C] (head mean)
  const float* skip;    // [N, out width] or null
  float* out;           // [N, HC] or [N, C]
  int n_rows, H, C, self_loops, concat, act;
  float neg_slope;
};

// Shared floats per warp: the weights (H x 128) and per head the self
// weight and the denominator.
__host__ __device__ __forceinline__ int warp_words(int H) {
  return H * BB + 2 * H;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) gat_block_kernel(BlockArgs a) {
  extern __shared__ float smem[];
  __shared__ int s_cnt[R], s_ptr[R + 1], s_ent[R * BB];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int H = a.H, C = a.C, HC = H * C;
  const int row0 = blockIdx.x * R;
  const int blk0 = (row0 / BB) * BB;     // the block's first row
  gnnb::compact_rows<THREADS>(a.adj + (size_t)row0 * BB, R, s_cnt, s_ptr,
                              s_ent);
  float* ew = smem + (size_t)warp * warp_words(H);   // [H, 128]
  float* es = ew + H * BB;                            // [H]
  float* den = es + H;                                // [H]
  const float ns = a.neg_slope;
  for (int i = warp; i < R; i += WARPS) {
    const int r = row0 + i;
    const int e0 = s_ptr[i], n = s_ptr[i + 1] - e0;
    const int* ent = s_ent + e0;
    for (int hd = 0; hd < H; ++hd) {
      const float ad = a.a_dst[(size_t)r * H + hd];
      float mx = -BIG;
      for (int k = lane; k < n; k += 32) {
        const int j = blk0 + (ent[k] & 0xFF);
        const float z = lrelu(ad + a.a_src[(size_t)j * H + hd], ns);
        ew[hd * BB + k] = z;
        mx = fmaxf(mx, z);
      }
      mx = warp_max(mx);
      float zs = 0.f;
      if (a.self_loops) {
        zs = lrelu(a.a_src[(size_t)r * H + hd] + ad, ns);
        mx = fmaxf(mx, zs);
      }
      mx = fmaxf(mx, -BIG * 0.5f);
      float sum = 0.f;
      for (int k = lane; k < n; k += 32) {
        const float wk = (float)(ent[k] >> 8) * expf(ew[hd * BB + k] - mx);
        // the weighted sum's operand; den sums the weight unrounded
        ew[hd * BB + k] = MODE == BF16 ? gnnb_quant::bf16r(wk) : wk;
        sum += wk;
      }
      sum = warp_sum(sum);
      const float e_s = a.self_loops ? expf(zs - mx) : 0.f;
      if (lane == 0) {
        es[hd] = e_s;
        den[hd] = sum + e_s;
      }
    }
    __syncwarp();
    const int out_w = a.concat ? HC : C;
    for (int c = lane; c < out_w; c += 32) {
      float acc = 0.f;
      for (int hd = a.concat ? c / C : 0; hd < H; ++hd) {
        const int col = a.concat ? c : hd * C + c;
        const float* w = ew + hd * BB;
        float num = 0.f;
        for (int k = 0; k < n; ++k) {
          const float hv = a.h[(size_t)(blk0 + (ent[k] & 0xFF)) * HC + col];
          num = fmaf(w[k], MODE == BF16 ? gnnb_quant::bf16r(hv) : hv, num);
        }
        if (a.self_loops) num = fmaf(es[hd], a.h[(size_t)r * HC + col], num);
        acc += num / fmaxf(den[hd], 1e-16f);
        if (a.concat) break;
      }
      float o = (a.concat ? acc : acc * (1.f / H)) + a.bias[c];
      const size_t o_idx = (size_t)r * out_w + c;
      if (a.skip != nullptr) o += a.skip[o_idx];
      a.out[o_idx] = act_fn(o, a.act);
    }
    __syncwarp();
  }
}

size_t block_smem_bytes(int H) {
  return (size_t)WARPS * warp_words(H) * sizeof(float);
}

size_t block_static_bytes() {
  return (size_t)(2 * R + 1 + R * BB) * sizeof(int);
}

}  // namespace

extern "C" {

// Rows of an adjacency block the kernel takes.
int gnnb_gat_block_rows() { return BB; }

// Shared memory of the attention launch with H heads, in bytes.
int gnnb_gat_block_smem_bytes(int H) {
  return (int)(block_smem_bytes(H) + block_static_bytes());
}

// Launches the layer on `stream` of `device`: the projection into the
// scratch h [N, H*C], a_src and a_dst [N, H], then the block attention
// into out ([N, H*C] with concat, else [N, C]).  n_rows % 128 == 0; act:
// 0 none, 1 relu, 2 gelu, 3 sigmoid, 4 tanh; skip may be null; mode: 0
// f32, 1 bf16 (w bfloat16, with the bfloat16 logit weights wa_src and
// wa_dst [Fin, H]; null in mode 0).  All other arrays contiguous f32 as
// documented in ops/cuda/gat_block.py.  Returns the cudaError_t of the
// launches (0 = success).
int gnnb_gat_block(const void* x, const void* adj, int n_rows, int Fin,
                   int H, int C, const void* w, const void* att_src,
                   const void* att_dst, const void* bias, const void* skip,
                   float neg_slope, int self_loops, int concat, int act,
                   int mode, const void* wa_src, const void* wa_dst,
                   void* h, void* a_src, void* a_dst, void* out,
                   void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows < 0 || n_rows % BB || Fin < 1 || H < 1 || C < 1 || act < 0 ||
      act > 4 || !x || !adj || !w || !att_src || !att_dst || !bias || !h ||
      !a_src || !a_dst || !out || (mode != F32 && mode != BF16) ||
      (mode == BF16) != (wa_src != nullptr && wa_dst != nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  size_t optin = 0;
  err = optin_bytes(device, &optin);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = block_smem_bytes(H);
  if (smem + block_static_bytes() > optin) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ProjArgs p;
  p.x = (const float*)x;
  p.w = w;
  p.sw = nullptr;
  p.att_src = (const float*)att_src;
  p.att_dst = (const float*)att_dst;
  p.wa_src = (const __nv_bfloat16*)wa_src;
  p.wa_dst = (const __nv_bfloat16*)wa_dst;
  p.h = (float*)h;
  p.a_src = (float*)a_src;
  p.a_dst = (float*)a_dst;
  p.n_rows = n_rows;
  p.Fin = Fin;
  p.H = H;
  p.C = C;
  err = launch_proj(p, mode, optin, st);
  if (err != cudaSuccess) return (int)err;
  BlockArgs a;
  a.h = (const float*)h;
  a.a_src = (const float*)a_src;
  a.a_dst = (const float*)a_dst;
  a.adj = (const float*)adj;
  a.bias = (const float*)bias;
  a.skip = (const float*)skip;
  a.out = (float*)out;
  a.n_rows = n_rows;
  a.H = H;
  a.C = C;
  a.self_loops = self_loops != 0;
  a.concat = concat != 0;
  a.act = act;
  a.neg_slope = neg_slope;
  auto kernel = mode == BF16 ? gat_block_kernel<BF16> : gat_block_kernel<F32>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_rows / R, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
