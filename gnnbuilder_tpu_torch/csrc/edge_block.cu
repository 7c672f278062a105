// One EdgeConv layer (Dynamic Graph CNN): x'_i = aggr_j lin1(relu(
// lin0([x_i || x_j - x_i]))) over each receiver's valid ELL slots, for
// aggr max, sum or mean, in two launches.
//
// Replaces: gnnbuilder_tpu/ops/pallas/edge_block.py fused_edge_block_layer
// (kernel body _kernel).  lin0 is PairLinear-split (w_pair [2 Fin, F],
// self rows first): [x_i || x_j - x_i] W0 + b0 = w_i + v_j with
//
//   v = x W_diff,  w = (x W_self + b0) - v
//
// and then, per valid slot s < deg[i] with j = nbr[i, s],
// t_s = relu(w_i + v_j):
//
//   max   o = max_s (t_s W1) + b1          (0 on an empty row)
//   sum   o = (sum_s t_s) W1 + deg b1
//   mean  o = ((sum_s t_s) / deg) W1 + b1  (0 on an empty row)
//   out   = act(o [+ skip])                (skip added before the act)
//
// What bounds it on the H100: operations (2 Fin F per row for each half
// of lin0, and for max 2 F Fout per valid slot), run as plain f32 FMAs.
//
// Design: the first launch forms v and w for every row (dense_rows.cuh:
// x's rows in shared memory, one output column per thread) and writes
// them to device memory (L2 resident at the canonical batch), because
// every receiver reads its neighbours' v, which another CTA forms.  The
// second launch gives a CTA R = 32 consecutive rows; per slot it builds
// the rows' t in shared memory with indexed loads of v (slots up to the
// CTA's largest in-degree only), then runs the lin1 product per thread
// column and keeps the running max in registers; for sum and mean it sums
// t first and runs lin1 once.  The TPU kernel's block-local one-hot
// gathers (hi/lo bf16 passes) existed because Mosaic has no dynamic row
// gather; an indexed load is exact and needs no block locality, so the
// kernel takes any ELL table, though EdgeConv sends it block-packed
// batches only, as the JAX package does.
//
// The bf16 mode (a template argument; the JAX kernel's gather_mode
// "bf16" with mm="bf16", inference only): w_pair and w1 are bf16, x's
// rows are rounded as they are loaded (they feed only products), each
// gathered v_j is rounded to bf16, and t (or its sum, or mean) is stored
// rounded for the lin1 product; sums stay float32.  There is no int8 mode,
// as in the JAX package (its gate declines under int8).

#include "dense_rows.cuh"

namespace {

using namespace gnnb_dense;
using gnnb_quant::bf16r;

constexpr int SLOT_R = 32;   // rows per CTA of the slot launch

enum Aggr { MAX = 0, SUM = 1, MEAN = 2 };

struct EdgeArgs {
  const float* x;        // [N, Fin]
  const int* nbr;        // [N, W]
  const int* deg;        // [N]
  const void* w_self;    // [Fin, F] (float32, or bf16 in the bf16 mode)
  const void* w_diff;    // [Fin, F]
  const float* b0;       // [F]
  const void* w1;        // [F, Fout]
  const float* b1;       // [Fout]
  const float* skip;     // [N, Fout] or null
  float* v;              // [N, F] scratch
  float* w;              // [N, F] scratch
  float* out;            // [N, Fout]
  int n_rows, W, Fin, F, Fout, aggr, act;
};

// v and w of R rows.
template <int R, bool BF16>
__global__ void __launch_bounds__(THREADS) edge_proj_kernel(EdgeArgs a) {
  using TW = typename gnnb_quant::WeightOf<BF16 ? gnnb_quant::BF16
                                                : gnnb_quant::F32>::T;
  constexpr int RG = R / GROUPS;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);   // [R, ldFin]
  const int Fin = a.Fin, F = a.F, ldX = rup4(Fin);
  const int row0 = blockIdx.x * R;
  for (int e = threadIdx.x; e < R * ldX; e += THREADS) {
    const int i = e / ldX, c = e % ldX, r = row0 + i;
    const float x = (c < Fin && r < a.n_rows) ? a.x[(size_t)r * Fin + c]
                                              : 0.f;
    X[e] = BF16 ? bf16r(x) : x;
  }
  __syncthreads();
  const int col = threadIdx.x % CB;
  const int i0 = (threadIdx.x / CB) * RG;
  for (int c = col; c < F; c += CB) {
    float av[RG], au[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) av[i] = au[i] = 0.f;
    dot_rows<RG>(av, X, ldX, i0, static_cast<const TW*>(a.w_diff), F, c,
                 Fin);
    dot_rows<RG>(au, X, ldX, i0, static_cast<const TW*>(a.w_self), F, c,
                 Fin);
    const float b = a.b0[c];
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int r = row0 + i0 + i;
      if (r >= a.n_rows) continue;
      a.v[(size_t)r * F + c] = av[i];
      a.w[(size_t)r * F + c] = (au[i] + b) - av[i];
    }
  }
}

// relu(w_i + v_j) of slot s for the CTA's rows into T (0 where s is not a
// valid slot of the row), or their sum over the valid slots (s < 0); with
// BF16 each v_j and each stored value rounded to bf16.
template <bool BF16>
__device__ __forceinline__ void build_t(const EdgeArgs& a, float* T,
                                        const int* s_deg, int row0, int s) {
  auto vj = [&](int j, int c) {
    const float x = a.v[(size_t)j * a.F + c];
    return BF16 ? bf16r(x) : x;
  };
  const int F = a.F, ldF = rup4(F);
  for (int e = threadIdx.x; e < SLOT_R * ldF; e += THREADS) {
    const int i = e / ldF, c = e % ldF, r = row0 + i;
    float t = 0.f;
    if (c < F && r < a.n_rows) {
      const float wi = a.w[(size_t)r * F + c];
      const int* nb = a.nbr + (size_t)r * a.W;
      if (s >= 0) {
        if (s < s_deg[i]) t = fmaxf(wi + vj(nb[s], c), 0.f);
      } else {
        for (int q = 0; q < s_deg[i]; ++q) t += fmaxf(wi + vj(nb[q], c), 0.f);
        if (a.aggr == MEAN) t /= fmaxf((float)s_deg[i], 1.f);
      }
    }
    T[e] = BF16 ? bf16r(t) : t;
  }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS) edge_slot_kernel(EdgeArgs a) {
  using TW = typename gnnb_quant::WeightOf<BF16 ? gnnb_quant::BF16
                                                : gnnb_quant::F32>::T;
  const TW* W1 = static_cast<const TW*>(a.w1);
  constexpr int RG = SLOT_R / GROUPS;
  extern __shared__ float4 smem4[];
  __shared__ int s_deg[SLOT_R];
  __shared__ int s_max;
  float* T = reinterpret_cast<float*>(smem4);   // [SLOT_R, ldF]
  const int F = a.F, Fout = a.Fout, ldF = rup4(F);
  const int row0 = blockIdx.x * SLOT_R;
  if (threadIdx.x == 0) s_max = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < SLOT_R; i += THREADS) {
    s_deg[i] = row0 + i < a.n_rows ? a.deg[row0 + i] : 0;
    atomicMax(&s_max, s_deg[i]);
  }
  __syncthreads();
  const int col = threadIdx.x % CB;
  const int i0 = (threadIdx.x / CB) * RG;
  const bool is_max = a.aggr == MAX;
  if (!is_max) {
    build_t<BF16>(a, T, s_deg, row0, -1);
    __syncthreads();
  }
  for (int c0 = 0; c0 < Fout; c0 += CB) {
    const int c = c0 + col;
    float acc[RG];
    if (is_max) {
      float mx[RG];
#pragma unroll
      for (int i = 0; i < RG; ++i) mx[i] = -INFINITY;
      for (int s = 0; s < s_max; ++s) {
        __syncthreads();   // the last slot's T is read by every thread
        build_t<BF16>(a, T, s_deg, row0, s);
        __syncthreads();
        if (c < Fout) {
#pragma unroll
          for (int i = 0; i < RG; ++i) acc[i] = 0.f;
          dot_rows<RG>(acc, T, ldF, i0, W1, Fout, c, F);
#pragma unroll
          for (int i = 0; i < RG; ++i)
            if (s < s_deg[i0 + i]) mx[i] = fmaxf(mx[i], acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < RG; ++i) acc[i] = mx[i];
    } else if (c < Fout) {
#pragma unroll
      for (int i = 0; i < RG; ++i) acc[i] = 0.f;
      dot_rows<RG>(acc, T, ldF, i0, W1, Fout, c, F);
    }
    if (c >= Fout) continue;
    const float b = a.b1[c];
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int r = row0 + i0 + i;
      if (r >= a.n_rows) continue;
      const int d = s_deg[i0 + i];
      float o;
      if (a.aggr == SUM)
        o = acc[i] + (float)d * b;
      else
        o = d > 0 ? acc[i] + b : 0.f;
      const size_t o_idx = (size_t)r * Fout + c;
      if (a.skip != nullptr) o += a.skip[o_idx];
      a.out[o_idx] = act_fn(o, a.act);
    }
  }
}

size_t proj_smem_bytes(int R, int Fin) {
  return (size_t)R * rup4(Fin) * sizeof(float);
}

size_t slot_smem_bytes(int F) {
  return (size_t)SLOT_R * rup4(F) * sizeof(float);
}

template <int R, bool BF16>
cudaError_t launch_proj(const EdgeArgs& a, cudaStream_t s) {
  const size_t smem = proj_smem_bytes(R, a.Fin);
  cudaError_t err = cudaFuncSetAttribute(
      edge_proj_kernel<R, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  edge_proj_kernel<R, BF16><<<(a.n_rows + R - 1) / R, THREADS, smem, s>>>(
      a);
  return cudaGetLastError();
}

// The two launches: projection, then slots.
template <bool BF16>
cudaError_t launch_layer(const EdgeArgs& a, size_t fits, cudaStream_t st) {
  cudaError_t err;
  if (proj_smem_bytes(32, a.Fin) <= fits)
    err = launch_proj<32, BF16>(a, st);
  else if (proj_smem_bytes(16, a.Fin) <= fits)
    err = launch_proj<16, BF16>(a, st);
  else if (proj_smem_bytes(MIN_R, a.Fin) <= fits)
    err = launch_proj<MIN_R, BF16>(a, st);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const size_t smem = slot_smem_bytes(a.F);
  if (smem + (SLOT_R + 1) * sizeof(int) > fits) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(edge_slot_kernel<BF16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  edge_slot_kernel<BF16>
      <<<(a.n_rows + SLOT_R - 1) / SLOT_R, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of the slot launch (the larger of the two at equal
// widths), in bytes.
int gnnb_edge_block_smem_bytes(int Fin, int F) {
  const size_t p = proj_smem_bytes(MIN_R, Fin);
  const size_t s = slot_smem_bytes(F) + (SLOT_R + 1) * sizeof(int);
  return (int)(p > s ? p : s);
}

// Launches the layer on `stream` of `device`: the projection into the
// scratch v and w [N, F], then the slots.  aggr: 0 max, 1 sum, 2 mean;
// act: 0 none, 1 relu, 2 gelu, 3 sigmoid, 4 tanh; mode: 0 f32, 1 bf16
// (w_pair and w1 bfloat16); skip may be null.  All other arrays
// contiguous f32 / i32 as documented in ops/cuda/edge_block.py.  Returns
// the cudaError_t of the launches (0 = success).
int gnnb_edge_block(const void* x, const void* nbr, const void* deg,
                    int n_rows, int W, int Fin, int F, int Fout,
                    const void* w_pair, const void* b0, const void* w1,
                    const void* b1, const void* skip, int aggr, int act,
                    int mode, void* v, void* w, void* out, void* stream,
                    int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows < 0 || W < 1 || Fin < 1 || F < 1 || Fout < 1 || aggr < MAX ||
      aggr > MEAN || act < 0 || act > 4 || !x || !nbr || !deg || !w_pair ||
      !b0 || !w1 || !b1 || !v || !w || !out ||
      (mode != gnnb_quant::F32 && mode != gnnb_quant::BF16))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  const size_t wsize = mode == gnnb_quant::BF16 ? 2 : 4;
  EdgeArgs a;
  a.x = (const float*)x;
  a.nbr = (const int*)nbr;
  a.deg = (const int*)deg;
  a.w_self = w_pair;
  a.w_diff = (const char*)w_pair + (size_t)Fin * F * wsize;
  a.b0 = (const float*)b0;
  a.w1 = w1;
  a.b1 = (const float*)b1;
  a.skip = (const float*)skip;
  a.v = (float*)v;
  a.w = (float*)w;
  a.out = (float*)out;
  a.n_rows = n_rows;
  a.W = W;
  a.Fin = Fin;
  a.F = F;
  a.Fout = Fout;
  a.aggr = aggr;
  a.act = act;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == gnnb_quant::BF16)
    return (int)launch_layer<true>(a, (size_t)optin, st);
  return (int)launch_layer<false>(a, (size_t)optin, st);
}

}  // extern "C"
