// Whole GCN, GIN or SAGE conv stack on a block-packed batch, one CTA per
// 128-row block.
//
// Replaces: gnnbuilder_tpu/ops/pallas/mp_block.py mp_block_stack (kernel
// body _kernel).  Per layer l, for every node row r of the block, with A
// the block's [128, 128] adjacency counts (A[i, j] = edges j -> i):
//
//   gcn   p = (h W0) * dis;           o = dis * (A p + p) + b0
//   gin   o = relu(((1 + eps) h + A h) W0 + b0) W1 + b1
//   sage  o = (A h / max(deg, 1)) W0 + b0 + h W1
//
//   h = act(o [+ h])                   (skip added before the activation)
//
// with dis = 1 / sqrt(deg + 1) (the self loop added analytically).  Every
// width is one F, a multiple of 128 (the caller zero-pads, as the TPU
// kernel's caller does).
//
// What bounds it on the H100: operations at F = 128 (2 F^2 flops per row
// and dot, 1 or 2 dots per layer, against ~1 KB of row data in and out
// once for the whole stack), run as plain f32 FMAs.
//
// Design: no graph crosses a 128-row block, so a CTA owns its block's
// whole problem for all L layers and device memory sees x once and the
// final h once.  The adjacency is read once per CTA and compacted in
// shared memory into per-row lists of (neighbour, count) pairs in
// neighbour order (a QM9 block is ~97 % zeros); every layer's aggregation
// walks those lists, so a block with a hub over the ELL width runs like
// any other.  The TPU kernel's dense [128, 128] MXU products, split into
// bf16 hi/lo passes, do not apply here.  Where they fit the card's shared
// memory (F = 128), the hidden state H and the per-layer buffer T (gcn's
// p, or the aggregate of gin and sage) stay there; at wider F they live
// in device memory (H in the output itself, T in a scratch array), where
// the CTA's rows are its own and L2 holds them.  The Linear epilogues of
// gin and sage run over R-row chunks (32, or 16 or 8 at widths where 32
// rows of a chunk buffer Z do not fit) with one thread per output column
// and R / 2 rows; weights stream from device memory (L2 resident,
// coalesced along the column), each read feeding R / 2 FMAs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BB = 128;               // rows per block = rows per CTA
constexpr int CB = 128;               // columns per column block
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / CB;  // row groups (2)
constexpr int NWARPS = THREADS / 32;
constexpr int VT = 32;                // rows per register tile, whole block
constexpr int MAX_L = 16;
constexpr int MAX_NNZ = BB * BB;      // a dense block fits the list
constexpr int MIN_R = 8;
// the kernel's static shared arrays (row pointers, counts, dis, denom)
constexpr size_t STATIC_SMEM = (BB + 1 + 3 * BB) * 4;

enum Conv { GCN = 0, GIN = 1, SAGE = 2 };

struct StackArgs {
  const float* x;     // [N, F]
  const float* adj;   // [N / 128, 128, 128] counts
  const int* deg;     // [N]
  const float* w0;    // [L, F, F]
  const float* b0;    // [L, F]
  const float* w1;    // [L, F, F]
  const float* b1;    // [L, F]
  float* out;         // [N, F]
  float* scratch;     // [N, F] T in device memory, or null
  int n_rows, F, L, conv, act;
  float eps[MAX_L];
  int skip[MAX_L];
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

// acc[i] += A[r0 + i, 0:K] . W[0:K, col]; A rows 16-byte aligned (shared
// or device memory), W row-major in device memory.
template <int NR>
__device__ __forceinline__ void dot_rows(float (&acc)[NR], const float* A,
                                         int lda, int r0,
                                         const float* __restrict__ W,
                                         int ldw, int col, int K) {
  for (int k = 0; k < K; k += 4) {
    const float w0 = __ldg(W + (size_t)(k + 0) * ldw + col);
    const float w1 = __ldg(W + (size_t)(k + 1) * ldw + col);
    const float w2 = __ldg(W + (size_t)(k + 2) * ldw + col);
    const float w3 = __ldg(W + (size_t)(k + 3) * ldw + col);
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(A + (size_t)(r0 + i) * lda + k);
      acc[i] = fmaf(a.x, w0, acc[i]);
      acc[i] = fmaf(a.y, w1, acc[i]);
      acc[i] = fmaf(a.z, w2, acc[i]);
      acc[i] = fmaf(a.w, w3, acc[i]);
    }
  }
}

// sum_j A[r, j] S[j, c] over row r's list; an entry is (count << 8) | j.
__device__ __forceinline__ float agg_row(const int* ent, int e0, int e1,
                                         const float* S, int F, int c) {
  float s = 0.f;
  for (int e = e0; e < e1; ++e) {
    const int p = ent[e];
    s = fmaf((float)(p >> 8), S[(size_t)(p & 0xFF) * F + c], s);
  }
  return s;
}

template <int R>
__global__ void __launch_bounds__(THREADS, 1)
mp_block_stack_kernel(StackArgs a, int ht_smem) {
  constexpr int RG = R / GROUPS;      // rows per thread in a chunk
  const int F = a.F;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const size_t row0 = (size_t)blockIdx.x * BB;
  float *H, *T;
  if (ht_smem) {
    H = sm;
    T = H + BB * F;
    sm = T + BB * F;
  } else {
    H = a.out + row0 * F;
    T = a.scratch + row0 * F;
  }
  float* Z = sm;                                  // [R, F] chunk buffer
  int* ent = reinterpret_cast<int*>(Z + R * F);   // [MAX_NNZ] lists
  __shared__ int s_ptr[BB + 1];
  __shared__ int s_cnt[BB];
  __shared__ float s_dis[BB];
  __shared__ float s_den[BB];                     // max(deg, 1)

  const int tid = threadIdx.x;
  const int col = tid % CB;
  const int grp = tid / CB;
  const int lane = tid % 32;
  const int warp = tid / 32;

  {  // h = x
    const float4* xs = reinterpret_cast<const float4*>(a.x + row0 * F);
    float4* hs = reinterpret_cast<float4*>(H);
    for (int i = tid; i < BB * F / 4; i += THREADS) hs[i] = xs[i];
  }
  for (int r = tid; r < BB; r += THREADS) {
    const float d = (float)a.deg[row0 + r];
    s_dis[r] = 1.f / sqrtf(d + 1.f);
    s_den[r] = fmaxf(d, 1.f);
  }
  // adjacency rows -> per-row lists: count nonzeros, scan, write
  const float* A = a.adj + row0 * BB;
  for (int r = warp; r < BB; r += NWARPS) {
    const float4 q = reinterpret_cast<const float4*>(A + (size_t)r * BB)[lane];
    int n = (q.x != 0.f) + (q.y != 0.f) + (q.z != 0.f) + (q.w != 0.f);
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
    if (lane == 0) s_cnt[r] = n;
  }
  __syncthreads();
  if (tid == 0) {
    s_ptr[0] = 0;
    for (int r = 0; r < BB; ++r) s_ptr[r + 1] = s_ptr[r] + s_cnt[r];
  }
  __syncthreads();
  for (int r = warp; r < BB; r += NWARPS) {
    const float4 q = reinterpret_cast<const float4*>(A + (size_t)r * BB)[lane];
    const float qv[4] = {q.x, q.y, q.z, q.w};
    const int n = (q.x != 0.f) + (q.y != 0.f) + (q.z != 0.f) + (q.w != 0.f);
    int incl = n;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    int e = s_ptr[r] + incl - n;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (qv[k] != 0.f) ent[e++] = ((int)qv[k] << 8) | (lane * 4 + k);
  }
  __syncthreads();

  const int rA0 = grp * (BB / GROUPS);            // whole-block rows
  for (int l = 0; l < a.L; ++l) {
    const float* W0 = a.w0 + (size_t)l * F * F;
    const float* W1 = a.w1 + (size_t)l * F * F;
    const float* B0 = a.b0 + (size_t)l * F;
    const float* B1 = a.b1 + (size_t)l * F;
    const bool skip = a.skip[l] != 0;

    // T over the whole block: gcn p = (h W0) dis; gin (1+eps) h + A h;
    // sage A h / max(deg, 1)
    for (int c = col; c < F; c += CB) {
      if (a.conv == GCN) {
        for (int r0 = rA0; r0 < rA0 + BB / GROUPS; r0 += VT) {
          float acc[VT];
#pragma unroll
          for (int i = 0; i < VT; ++i) acc[i] = 0.f;
          dot_rows<VT>(acc, H, F, r0, W0, F, c, F);
#pragma unroll
          for (int i = 0; i < VT; ++i)
            T[(size_t)(r0 + i) * F + c] = acc[i] * s_dis[r0 + i];
        }
      } else {
        const float ope = 1.f + a.eps[l];
        for (int r = rA0; r < rA0 + BB / GROUPS; ++r) {
          const float s = agg_row(ent, s_ptr[r], s_ptr[r + 1], H, F, c);
          T[(size_t)r * F + c] = a.conv == GIN
              ? ope * H[(size_t)r * F + c] + s : s / s_den[r];
        }
      }
    }
    __syncthreads();

    if (a.conv == GCN) {   // o = dis (A p + p) + b0, in place per element
      for (int c = col; c < F; c += CB) {
        const float b = B0[c];
        for (int r = rA0; r < rA0 + BB / GROUPS; ++r) {
          const float s = agg_row(ent, s_ptr[r], s_ptr[r + 1], T, F, c);
          float o = s_dis[r] * (s + T[(size_t)r * F + c]) + b;
          if (skip) o += H[(size_t)r * F + c];
          H[(size_t)r * F + c] = act_fn(o, a.act);
        }
      }
      __syncthreads();
      continue;
    }

    const int i0 = grp * RG;
    for (int c0 = 0; c0 < BB; c0 += R) {
      // Z = gin relu(T W0 + b0) | sage T W0 + b0 + h W1, for the chunk
      for (int c = col; c < F; c += CB) {
        float acc[RG];
#pragma unroll
        for (int i = 0; i < RG; ++i) acc[i] = 0.f;
        dot_rows<RG>(acc, T, F, c0 + i0, W0, F, c, F);
        if (a.conv == SAGE) dot_rows<RG>(acc, H, F, c0 + i0, W1, F, c, F);
        const float b = B0[c];
#pragma unroll
        for (int i = 0; i < RG; ++i)
          Z[(i0 + i) * F + c] =
              a.conv == GIN ? fmaxf(acc[i] + b, 0.f) : acc[i] + b;
      }
      __syncthreads();
      // h = act(o [+ h]); gin o = Z W1 + b1, sage o = Z
      for (int c = col; c < F; c += CB) {
        float acc[RG];
#pragma unroll
        for (int i = 0; i < RG; ++i) acc[i] = 0.f;
        if (a.conv == GIN) {
          dot_rows<RG>(acc, Z, F, i0, W1, F, c, F);
          const float b = B1[c];
#pragma unroll
          for (int i = 0; i < RG; ++i) acc[i] += b;
        } else {
#pragma unroll
          for (int i = 0; i < RG; ++i) acc[i] = Z[(i0 + i) * F + c];
        }
#pragma unroll
        for (int i = 0; i < RG; ++i) {
          const size_t e = (size_t)(c0 + i0 + i) * F + c;
          float o = acc[i];
          if (skip) o += H[e];
          H[e] = act_fn(o, a.act);
        }
      }
      __syncthreads();
    }
  }

  if (ht_smem) {
    float4* os = reinterpret_cast<float4*>(a.out + row0 * F);
    const float4* hs = reinterpret_cast<const float4*>(H);
    for (int i = tid; i < BB * F / 4; i += THREADS) os[i] = hs[i];
  }
}

// Dynamic shared memory of a launch with R chunk rows, H and T in shared
// memory or not.
size_t smem_bytes(int R, int F, bool ht_smem) {
  return ((ht_smem ? 2 * (size_t)BB * F : 0) + (size_t)R * F) *
             sizeof(float) +
         (size_t)MAX_NNZ * sizeof(int);
}

template <int R>
cudaError_t launch(const StackArgs& a, bool ht_smem, cudaStream_t s) {
  const size_t smem = smem_bytes(R, a.F, ht_smem);
  cudaError_t err = cudaFuncSetAttribute(
      mp_block_stack_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  mp_block_stack_kernel<R><<<a.n_rows / BB, THREADS, smem, s>>>(
      a, ht_smem ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gnnb_mp_block_rows() { return BB; }
int gnnb_mp_block_width_multiple() { return CB; }
int gnnb_mp_block_max_layers() { return MAX_L; }

// Dynamic shared memory the stack needs at width F with the fewest chunk
// rows and H, T in device memory, in bytes (the launcher keeps them in
// shared memory, with more rows, where that fits).
int gnnb_mp_block_smem_bytes(int F) {
  return (int)(smem_bytes(MIN_R, F, false) + STATIC_SMEM);
}

// Whether a launch at width F keeps H and T in shared memory (1) or in
// device memory (0) on `device`; -1 on a CUDA error.
int gnnb_mp_block_ht_in_smem(int F, int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return smem_bytes(32, F, true) + STATIC_SMEM <= (size_t)optin ? 1 : 0;
}

// Launches the stack on `stream` of `device`; n_rows % 128 == 0 and
// F % 128 == 0, all arrays contiguous f32 / i32 as documented in
// ops/cuda/mp_block.py; `scratch` ([N, F] f32) is read only when H and T
// do not fit shared memory.  conv: 0 gcn, 1 gin, 2 sage.  Returns the
// cudaError_t of the launch (0 = success).
int gnnb_mp_block_stack(const void* x, const void* adj, const void* deg,
                        int n_rows, int F, const void* w0, const void* b0,
                        const void* w1, const void* b1, int n_layers,
                        int conv, const float* epss, const int* skips,
                        int act, void* out, void* scratch, void* stream,
                        int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_layers < 1 || n_layers > MAX_L || n_rows % BB != 0 || F % CB ||
      F < CB || conv < GCN || conv > SAGE)
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  StackArgs a;
  a.x = (const float*)x;
  a.adj = (const float*)adj;
  a.deg = (const int*)deg;
  a.w0 = (const float*)w0;
  a.b0 = (const float*)b0;
  a.w1 = (const float*)w1;
  a.b1 = (const float*)b1;
  a.out = (float*)out;
  a.scratch = (float*)scratch;
  a.n_rows = n_rows;
  a.F = F;
  a.L = n_layers;
  a.conv = conv;
  a.act = act;
  for (int l = 0; l < MAX_L; ++l) {
    a.eps[l] = l < n_layers ? epss[l] : 0.f;
    a.skip[l] = l < n_layers ? skips[l] : 0;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const size_t limit = (size_t)optin - STATIC_SMEM;
  if (smem_bytes(32, F, true) <= limit) return (int)launch<32>(a, true, s);
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (smem_bytes(32, F, false) <= limit) return (int)launch<32>(a, false, s);
  if (smem_bytes(16, F, false) <= limit) return (int)launch<16>(a, false, s);
  if (smem_bytes(MIN_R, F, false) <= limit)
    return (int)launch<MIN_R>(a, false, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
