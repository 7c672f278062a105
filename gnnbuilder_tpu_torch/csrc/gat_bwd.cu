// The GAT softmax backward over the ELL neighbour table: the value and
// logit gradients of the windowed GAT layer, without a scatter and
// without atomics.
//
// Replaces: gnnbuilder_tpu/ops/pallas/gat_bwd.py
// fused_gat_scatter_backward (kernel body _kernel).  Per head hd, with
// receiver i, its slots w < deg[i] (sender j_w = nbr[i, w]), pre_w =
// a_src[j_w] + a_dst[i], z_w = leaky_relu(pre_w) and the self slot s:
//
//   m_i, den_i   recomputed from these logits as the forward computes them
//                (m at least -BIG / 2; den before its 1e-16 clamp)
//   alpha_w      = exp(z_w - m_i) / max(den_i, 1e-16)
//   dalpha_w     = dz[i, hd*C : (hd+1)*C] . h[j_w, hd*C : (hd+1)*C]
//   s_i          = sum_w alpha_w dalpha_w (+ the self slot's term)
//   dpre_w       = alpha_w (dalpha_w - s_i) leaky_relu'(pre_w)
//   dsum_i       = sum_w dpre_w                    (self slot excluded)
//   dh_val[j]   += alpha_w dz[i]  (head hd's C columns)
//   da_src[j]   += dpre_w
//
// over every edge j -> i.  The caller adds the self slot's terms with the
// same m and den (returned), and runs the dense chains (dW, dx, datt,
// dbias) in torch, as the JAX package runs them in XLA.  Like the TPU
// kernel, this recomputes m and den instead of taking the forward's.
//
// What bounds it on the H100: bytes.  Each edge costs ~4 HC flops (two
// C-long dots per head and the value term) against a gathered row of dz
// and one of h (~4 KB at HC = 512): ~0.5 flop per byte, far below the
// f32 ridge of 20.
//
// Design: two launches, each a warp per row, every sum in a fixed order
// in one warp, so the results are the same bits on every run.
// * Receiver pass: per receiver i, the lanes take the slots for the
//   logits (warp max, warp sum: m, den), then for each slot the lanes
//   take the C columns of the dot dalpha (a warp sum), and s and dsum
//   follow in slot order.  It writes dsum, s, m and den [N, H].
// * Sender pass: per sender j, over j's reverse slots (the batch's
//   reverse table, or the reverse CSR of ops/ell.py reverse_csr, as a
//   template argument) in slot order, 32 at a time: the warp recomputes
//   alpha and dpre of each edge from a_src[j], a_dst[i], m_i, den_i, s_i
//   and the dot of dz[i] with h[j], keeps da_src[j]'s running sum, then
//   the lanes take the output columns and add alpha dz[i] over the
//   chunk's slots in order into dh_val[j].
// The TPU kernel's one-hot scatter matmuls, hi/lo bf16 passes, window
// margins and head expansion matrices existed because Mosaic has no
// dynamic row gather or scatter; here a gather over the reverse slots
// replaces the scatter.

#include "gat_common.cuh"

namespace {

using namespace gnnb_gat;

constexpr int CHUNK = 32;   // reverse slots per pass of the sender warp

struct BwdArgs {
  const float* dz;      // [N, HC]
  const float* h;       // [N, HC]
  const float* a_src;   // [N, H]
  const float* a_dst;   // [N, H]
  const int* nbr;       // [N, W]
  const int* deg;       // [N]
  const int* rev;       // [N, Wr] (table mode) or rev_idx [E] (CSR mode)
  const int* odeg;      // [N] (table mode) or rev_ptr [N + 1] (CSR mode)
  float* dsum;          // [N, H]
  float* s;             // [N, H]
  float* m;             // [N, H]
  float* den;           // [N, H]
  float* dh_val;        // [N, HC]
  float* da_src;        // [N, H]
  int n_rows, W, Wr, H, C, self_loops;
  float neg_slope;
};

// dz[i, hd*C : (hd+1)*C] . h[j, hd*C : (hd+1)*C], every lane the same bits.
__device__ __forceinline__ float head_dot(const BwdArgs& a, int i, int j,
                                          int hd, int lane) {
  const int HC = a.H * a.C;
  const float* x = a.dz + (size_t)i * HC + hd * a.C;
  const float* y = a.h + (size_t)j * HC + hd * a.C;
  float p = 0.f;
  for (int c = lane; c < a.C; c += 32) p = fmaf(x[c], y[c], p);
  return warp_sum(p);
}

// Shared words per receiver warp: slot ids, pre-activations and dalpha.
__host__ __device__ __forceinline__ int recv_words(int W) { return 3 * W; }

__global__ void __launch_bounds__(THREADS) gat_bwd_recv_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int W = a.W, H = a.H;
  float* base = smem + (size_t)warp * recv_words(W);
  int* ids = reinterpret_cast<int*>(base);   // [W]
  float* pre = base + W;                     // [W]
  float* dal = pre + W;                      // [W]
  const float ns = a.neg_slope;
  for (int i = blockIdx.x * WARPS + warp; i < a.n_rows;
       i += gridDim.x * WARPS) {
    const int d = a.deg[i];
    for (int k = lane; k < d; k += 32) ids[k] = a.nbr[(size_t)i * W + k];
    __syncwarp();
    for (int hd = 0; hd < H; ++hd) {
      const size_t ih = (size_t)i * H + hd;
      const float ad = a.a_dst[ih];
      float mx = -BIG;
      for (int k = lane; k < d; k += 32) {
        const float p = a.a_src[(size_t)ids[k] * H + hd] + ad;
        pre[k] = p;
        mx = fmaxf(mx, lrelu(p, ns));
      }
      mx = warp_max(mx);
      const float pre_s = a.a_src[ih] + ad;
      const float zs = lrelu(pre_s, ns);
      if (a.self_loops) mx = fmaxf(mx, zs);
      mx = fmaxf(mx, -BIG * 0.5f);
      float sum = 0.f;
      for (int k = lane; k < d; k += 32)
        sum += expf(lrelu(pre[k], ns) - mx);
      sum = warp_sum(sum);
      const float e_s = a.self_loops ? expf(zs - mx) : 0.f;
      const float dn = sum + e_s;
      const float dc = fmaxf(dn, 1e-16f);
      __syncwarp();
      float sv = 0.f;
      for (int k = 0; k < d; ++k) {
        const float da = head_dot(a, i, ids[k], hd, lane);
        if (lane == 0) dal[k] = da;
        sv += expf(lrelu(pre[k], ns) - mx) / dc * da;
      }
      if (a.self_loops) sv += e_s / dc * head_dot(a, i, i, hd, lane);
      __syncwarp();
      float ds = 0.f;
      for (int k = 0; k < d; ++k) {
        const float alpha = expf(lrelu(pre[k], ns) - mx) / dc;
        ds += alpha * (dal[k] - sv) * (pre[k] >= 0.f ? 1.f : ns);
      }
      if (lane == 0) {
        a.dsum[ih] = ds;
        a.s[ih] = sv;
        a.m[ih] = mx;
        a.den[ih] = dn;
      }
      __syncwarp();
    }
  }
}

// Shared words per sender warp: the chunk's receivers, its alphas (H per
// slot) and the running da_src (H).
__host__ __device__ __forceinline__ int send_words(int H) {
  return CHUNK + CHUNK * H + H;
}

template <bool CSR>
__global__ void __launch_bounds__(THREADS) gat_bwd_send_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int H = a.H, C = a.C, HC = H * C;
  float* base = smem + (size_t)warp * send_words(H);
  int* ids = reinterpret_cast<int*>(base);   // [CHUNK]
  float* alph = base + CHUNK;                // [CHUNK, H]
  float* dacc = alph + CHUNK * H;            // [H]
  const float ns = a.neg_slope;
  for (int j = blockIdx.x * WARPS + warp; j < a.n_rows;
       j += gridDim.x * WARPS) {
    int d;
    const int* slots;
    if (CSR) {
      const int p0 = a.odeg[j];
      d = a.odeg[j + 1] - p0;
      slots = a.rev + p0;
    } else {
      d = a.odeg[j];
      slots = a.rev + (size_t)j * a.Wr;
    }
    for (int hd = lane; hd < H; hd += 32) dacc[hd] = 0.f;
    if (d == 0)
      for (int c = lane; c < HC; c += 32) a.dh_val[(size_t)j * HC + c] = 0.f;
    for (int r0 = 0; r0 < d; r0 += CHUNK) {
      const int nr = min(CHUNK, d - r0);
      __syncwarp();
      if (lane < nr) ids[lane] = slots[r0 + lane];
      __syncwarp();
      for (int rr = 0; rr < nr; ++rr) {
        const int i = ids[rr];
        for (int hd = 0; hd < H; ++hd) {
          const size_t ih = (size_t)i * H + hd;
          const float da = head_dot(a, i, j, hd, lane);
          const float p = a.a_src[(size_t)j * H + hd] + a.a_dst[ih];
          const float alpha =
              expf(lrelu(p, ns) - a.m[ih]) / fmaxf(a.den[ih], 1e-16f);
          const float dpre = alpha * (da - a.s[ih]) * (p >= 0.f ? 1.f : ns);
          if (lane == 0) {
            alph[rr * H + hd] = alpha;
            dacc[hd] += dpre;
          }
        }
      }
      __syncwarp();
      for (int c = lane; c < HC; c += 32) {
        const int hd = c / C;
        const size_t o_idx = (size_t)j * HC + c;
        float acc = r0 == 0 ? 0.f : a.dh_val[o_idx];
        for (int rr = 0; rr < nr; ++rr)
          acc += alph[rr * H + hd] * a.dz[(size_t)ids[rr] * HC + c];
        a.dh_val[o_idx] = acc;
      }
    }
    __syncwarp();
    for (int hd = lane; hd < H; hd += 32)
      a.da_src[(size_t)j * H + hd] = dacc[hd];
    __syncwarp();
  }
}

int launch(BwdArgs a, void* stream, int device, bool csr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.n_rows < 0 || a.W < 1 || a.H < 1 || a.C < 1 || !a.dz || !a.h ||
      !a.a_src || !a.a_dst || !a.nbr || !a.deg || !a.rev || !a.odeg ||
      !a.dsum || !a.s || !a.m || !a.den || !a.dh_val || !a.da_src)
    return (int)cudaErrorInvalidValue;
  if (a.n_rows == 0) return (int)cudaSuccess;
  size_t optin = 0;
  err = optin_bytes(device, &optin);
  if (err != cudaSuccess) return (int)err;
  const size_t s_recv = (size_t)WARPS * recv_words(a.W) * sizeof(float);
  const size_t s_send = (size_t)WARPS * send_words(a.H) * sizeof(float);
  if (s_recv > optin || s_send > optin) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (a.n_rows + WARPS - 1) / WARPS;
  err = cudaFuncSetAttribute(gat_bwd_recv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s_recv);
  if (err != cudaSuccess) return (int)err;
  gat_bwd_recv_kernel<<<blocks, THREADS, s_recv, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (csr) {
    err = cudaFuncSetAttribute(gat_bwd_send_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)s_send);
    if (err != cudaSuccess) return (int)err;
    gat_bwd_send_kernel<true><<<blocks, THREADS, s_send, st>>>(a);
  } else {
    err = cudaFuncSetAttribute(gat_bwd_send_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)s_send);
    if (err != cudaSuccess) return (int)err;
    gat_bwd_send_kernel<false><<<blocks, THREADS, s_send, st>>>(a);
  }
  return (int)cudaGetLastError();
}

BwdArgs args(const void* dz, const void* h, const void* a_src,
             const void* a_dst, const void* nbr, const void* deg,
             const void* rev, const void* odeg, int n_rows, int W, int Wr,
             int H, int C, float neg_slope, int self_loops, void* dsum,
             void* s, void* m, void* den, void* dh_val, void* da_src) {
  BwdArgs a;
  a.dz = (const float*)dz;
  a.h = (const float*)h;
  a.a_src = (const float*)a_src;
  a.a_dst = (const float*)a_dst;
  a.nbr = (const int*)nbr;
  a.deg = (const int*)deg;
  a.rev = (const int*)rev;
  a.odeg = (const int*)odeg;
  a.dsum = (float*)dsum;
  a.s = (float*)s;
  a.m = (float*)m;
  a.den = (float*)den;
  a.dh_val = (float*)dh_val;
  a.da_src = (float*)da_src;
  a.n_rows = n_rows;
  a.W = W;
  a.Wr = Wr;
  a.H = H;
  a.C = C;
  a.self_loops = self_loops != 0;
  a.neg_slope = neg_slope;
  return a;
}

}  // namespace

extern "C" {

// Launches both passes on `stream` of `device`, the sender pass over the
// reverse table rev [N, Wr] / odeg [N].  All arrays contiguous f32 / i32
// as documented in ops/cuda/gat_bwd.py.  Returns the cudaError_t of the
// launches (0 = success).
int gnnb_gat_bwd(const void* dz, const void* h, const void* a_src,
                 const void* a_dst, const void* nbr, const void* deg,
                 const void* rev, const void* odeg, int n_rows, int W,
                 int Wr, int H, int C, float neg_slope, int self_loops,
                 void* dsum, void* s, void* m, void* den, void* dh_val,
                 void* da_src, void* stream, int device) {
  return launch(args(dz, h, a_src, a_dst, nbr, deg, rev, odeg, n_rows, W,
                     Wr, H, C, neg_slope, self_loops, dsum, s, m, den,
                     dh_val, da_src),
                stream, device, false);
}

// The same with the sender pass over the reverse CSR (rev_ptr [N + 1],
// rev_idx [E] int32).
int gnnb_gat_bwd_csr(const void* dz, const void* h, const void* a_src,
                     const void* a_dst, const void* nbr, const void* deg,
                     const void* rev_ptr, const void* rev_idx, int n_rows,
                     int W, int H, int C, float neg_slope, int self_loops,
                     void* dsum, void* s, void* m, void* den, void* dh_val,
                     void* da_src, void* stream, int device) {
  return launch(args(dz, h, a_src, a_dst, nbr, deg, rev_idx, rev_ptr,
                     n_rows, W, 0, H, C, neg_slope, self_loops, dsum, s, m,
                     den, dh_val, da_src),
                stream, device, true);
}

}  // extern "C"
