// Fused readout: per-graph add/mean pooling, the [add|mean|max] concat,
// the whole MLP head and the output activation, one CTA per 8 graphs.
//
// Replaces: gnnbuilder_tpu/ops/pallas/readout.py fused_readout (kernel
// body _kernel).  For graph g with rows [start_g, start_g + n_g):
//
//   s      = sum of x over the rows       mean = s / max(n_g, 1)
//   pooled = concat of s / mean / mx[g] in the order of `aggrs`
//   out    = out_act(MLP(pooled)),  relu-like `act` between the Linears
//
// Max pooling comes in as mx (computed outside, as in the JAX model).
// Row ranges are clipped to the batch, so the ghost graph (its range runs
// past the last row under block packing) gives finite garbage, masked
// downstream.
//
// What bounds it on the H100: bytes, and at this size launch latency.
// Pooling reads each node row once (N*F*4 bytes); the MLP is ~25 k MACs
// per graph, ~50 MFLOP for 1,025 graphs, under a microsecond of f32 FMA.
// Design: a CTA loads every MLP weight and bias into shared memory once
// (~100 KB for the canonical 192-64-64-64-64-1 head) and reuses it for 8
// graphs, or, for a head too large for the card's shared memory per
// block, reads them from device memory (L2 resident across CTAs); pooling reads are coalesced along the feature axis; the
// hidden activations ping-pong between two shared [8, width] buffers and
// never reach device memory.
//
// Modes (the JAX kernel's mm and quant; the pooling stays exact in all):
//   F32  (0): as above.
//   BF16 (1): each Linear's input rows are rounded to bf16 in place before
//        the product, the weights arrive rounded to bf16 (held as f32 in
//        the packed buffer), and the sums stay f32 (mm="bf16").
//   INT8 (2): each Linear's input rows are quantized in place with one
//        symmetric scale each (s = max(max|h| / 127, 1e-12), q =
//        clip(rint(h / s), -127, 127)); the weights arrive as int8
//        values (held as f32 integers in the packed buffer, exact) with
//        one scale per column at s_off; the sum is int32 and y =
//        float(sum) * s_row * s_col + b: the JAX package's _qdot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TG = 8;           // graphs per CTA
constexpr int THREADS = 256;
constexpr int MAX_LIN = 8;
constexpr int MAX_AGGR = 3;

enum Mode { F32 = 0, BF16 = 1, INT8 = 2 };

struct Head {
  int n_lin;
  int dims[MAX_LIN + 1];  // dims[0] = pooled width, dims[n_lin] = out
  int w_off[MAX_LIN];     // offsets into the packed parameter buffer
  int b_off[MAX_LIN];
  int s_off[MAX_LIN];     // int8: the weights' column scales
  int n_aggr;
  int aggr[MAX_AGGR];     // 0 add, 1 mean, 2 max
};

__device__ __forceinline__ float act_fn(float x, int act) {
  switch (act) {
    case 1: return fmaxf(x, 0.f);
    case 2: return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
    case 3: return 1.f / (1.f + expf(-x));
    case 4: return tanhf(x);
    default: return x;
  }
}

// Rows [0, TG) of the [TG, din] tile A (row stride width) as the next
// product's operand, in place: rounded to bf16, or quantized to int8
// levels (f32 integers) with the row's scale in s[t]; one warp per row.
// The divisions are IEEE (no fast math), rintf rounds half to even.
__device__ void operand_rows(float* A, int width, int din, int mode,
                             float* s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < TG; t += THREADS / 32) {
    float* a = A + t * width;
    if (mode == BF16) {
      for (int k = lane; k < din; k += 32)
        a[k] = __bfloat162float(__float2bfloat16_rn(a[k]));
      continue;
    }
    float m = 0.f;
    for (int k = lane; k < din; k += 32) m = fmaxf(m, fabsf(a[k]));
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float sc = fmaxf(m / 127.f, 1e-12f);
    for (int k = lane; k < din; k += 32)
      a[k] = fminf(fmaxf(rintf(a[k] / sc), -127.f), 127.f);
    if (lane == 0) s[t] = sc;
  }
}

__global__ void __launch_bounds__(THREADS)
readout_kernel(const float* __restrict__ x, int N, int F,
               const int* __restrict__ starts,
               const int* __restrict__ n_node, int G,
               const float* __restrict__ mx,
               const float* __restrict__ params, int n_params, Head hd,
               int width, int act, int out_act, int mode,
               bool params_in_smem, float* __restrict__ out) {
  extern __shared__ float sm[];
  float* B0 = sm;                                   // [TG, width]
  float* B1 = B0 + TG * width;                      // [TG, width]
  float* Ps = B1 + TG * width;                      // packed MLP params
  const float* P = params_in_smem ? Ps : params;

  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * TG;
  if (params_in_smem)
    for (int i = tid; i < n_params; i += THREADS) Ps[i] = params[i];

  for (int p = tid; p < TG * F; p += THREADS) {
    const int t = p / F, f = p % F, g = g0 + t;
    float s = 0.f, n = 0.f;
    if (g < G) {
      const int st = starts[g];
      const int end = min(st + n_node[g], N);
      for (int r = st; r < end; ++r) s += x[(size_t)r * F + f];
      n = (float)n_node[g];
    }
    for (int a = 0; a < hd.n_aggr; ++a) {
      float v;
      if (hd.aggr[a] == 0) v = s;
      else if (hd.aggr[a] == 1) v = s / fmaxf(n, 1.f);
      else v = g < G ? mx[(size_t)g * F + f] : 0.f;
      B0[t * width + a * F + f] = v;
    }
  }
  __syncthreads();

  __shared__ float s_row[TG];   // int8: the input rows' scales
  float* in = B0;
  float* nxt = B1;
  for (int l = 0; l < hd.n_lin; ++l) {
    const int din = hd.dims[l], dout = hd.dims[l + 1];
    const float* Wm = P + hd.w_off[l];
    const float* b = P + hd.b_off[l];
    if (mode != F32) {
      operand_rows(in, width, din, mode, s_row);
      __syncthreads();
    }
    for (int p = tid; p < TG * dout; p += THREADS) {
      const int t = p / dout, o = p % dout;
      const float* h = in + t * width;
      float acc;
      if (mode == INT8) {
        int q = 0;
        for (int k = 0; k < din; ++k)
          q += __float2int_rn(h[k]) * __float2int_rn(Wm[k * dout + o]);
        acc = (float)q * s_row[t] * P[hd.s_off[l] + o] + b[o];
      } else {
        acc = b[o];
        for (int k = 0; k < din; ++k)
          acc = fmaf(h[k], Wm[k * dout + o], acc);
      }
      nxt[t * width + o] = l + 1 < hd.n_lin ? act_fn(acc, act) : acc;
    }
    __syncthreads();
    float* tmp = in;
    in = nxt;
    nxt = tmp;
  }

  const int dout = hd.dims[hd.n_lin];
  for (int t = tid; t < TG; t += THREADS) {
    const int g = g0 + t;
    if (g >= G) continue;
    const float* h = in + t * width;
    float* o = out + (size_t)g * dout;
    if (out_act == 0) {
      for (int j = 0; j < dout; ++j) o[j] = h[j];
      continue;
    }
    float m = -INFINITY;
    for (int j = 0; j < dout; ++j) m = fmaxf(m, h[j]);
    float z = 0.f;
    for (int j = 0; j < dout; ++j) z += expf(h[j] - m);
    for (int j = 0; j < dout; ++j)
      o[j] = out_act == 1 ? expf(h[j] - m) / z : h[j] - m - logf(z);
  }
}

}  // namespace

extern "C" {

int gnnb_readout_max_linears() { return MAX_LIN; }
int gnnb_readout_max_aggregators() { return MAX_AGGR; }

// Shared memory the launch needs, in bytes: the two activation buffers
// (the wrapper checks it against gnnb_smem_per_block_optin before
// launching); the launcher adds the MLP parameters where they fit.
int gnnb_readout_smem_bytes(int n_params, int width) {
  return (int)(2 * TG * width * sizeof(float));
}

// Shared memory one block of `device` may use, in bytes (0 on error).
int gnnb_smem_per_block_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return v;
}

// dims[0..n_lin], w_off/b_off/s_off[0..n_lin-1] and aggr[0..n_aggr-1]
// are host arrays (s_off read in mode 2 only); everything else lives on
// `device`.  mx may be null when no aggregator is max.  Returns the
// cudaError_t of the launch (0 = success).
int gnnb_readout(const void* x, int n_rows, int feat, const void* starts,
                 const void* n_node, int n_graphs, const void* mx,
                 const void* params, int n_params, int n_lin,
                 const int* dims, const int* w_off, const int* b_off,
                 const int* s_off, int n_aggr, const int* aggr, int width,
                 int act, int out_act, int mode, void* out, void* stream,
                 int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_lin < 1 || n_lin > MAX_LIN || n_aggr < 1 || n_aggr > MAX_AGGR ||
      mode < F32 || mode > INT8)
    return (int)cudaErrorInvalidValue;
  Head hd;
  hd.n_lin = n_lin;
  for (int i = 0; i <= n_lin; ++i) hd.dims[i] = dims[i];
  for (int i = 0; i < n_lin; ++i) {
    hd.w_off[i] = w_off[i];
    hd.b_off[i] = b_off[i];
    hd.s_off[i] = mode == INT8 ? s_off[i] : 0;
  }
  hd.n_aggr = n_aggr;
  for (int a = 0; a < n_aggr; ++a) hd.aggr[a] = aggr[a];
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  const int buffers = gnnb_readout_smem_bytes(n_params, width);
  const int staged = buffers + n_params * (int)sizeof(float);
  const bool params_in_smem = staged <= optin;
  const int smem = params_in_smem ? staged : buffers;
  err = cudaFuncSetAttribute(readout_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_graphs + TG - 1) / TG;
  if (blocks == 0) return (int)cudaSuccess;
  readout_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, n_rows, feat, (const int*)starts,
      (const int*)n_node, n_graphs, (const float*)mx,
      (const float*)params, n_params, hd, width, act, out_act, mode,
      params_in_smem, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
