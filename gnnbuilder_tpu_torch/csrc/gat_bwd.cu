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
// The slope is pre >= 0 ? 1 : neg_slope; exp and the divisions are IEEE
// (no fast math).
//
// What bounds it on the H100: bytes.  Each edge costs ~4 HC flops (two
// C-long dots per head and the value term) against a gathered row of dz
// and one of h (~4 KB at HC = 512): ~0.5 flop per byte, far below the
// f32 ridge of 20.  What held the first version at a fifth of that bound
// was latency: one warp reduction per (slot, head), one after another,
// and loads issued in several rounds per row.
//
// Design: two launches, each a warp per work item, every sum in a fixed
// order, so the results are the same bits on every run.  The main path's
// widths (C = 128 and C = 64) take the row instances below; every other
// width, or arrays not 16-byte aligned, the general instance (one head
// at a time, scalar columns, the sender recomputing each edge's alpha
// and dpre as the first version did).
// * Row instances.  A work item is a row and a unit of its columns: a
//   lane holds NU float4 chunks q = lane + 32 k of the unit, chunk q in
//   head q / CPH (C = 128: a chunk a head; C = 64: two heads a chunk,
//   one per half-warp).  A dot of two rows is four products a chunk,
//   then a butterfly over the head's CPH lanes, and the dots of every
//   (slot, head) of a group reduce together, interleaved (not H x d warp
//   sums one after another).  Every lane of a head's segment ends with
//   the same bits and forms the same per-head values; the segment's
//   first lane writes them.  Each warp loads the next item's degree and
//   slot ids while it works on the current one.
// * Receiver pass: per (receiver i, unit), every load of the row and of
//   its first group (RU = 4 slots: the train batch's ELL width) is issued
//   before any use: dz[i], h[i], the logit halves and the group's h rows.
//   Each (slot, head)'s exp is formed once and kept in registers for den,
//   s and dsum.  Each slot's (alpha, dpre) is written to the scratch ev
//   at its edge's reverse position: in CSR mode from reverse_csr's
//   positions (loaded with the ids), in table mode found by eight lanes a
//   slot scanning rev[j, :odeg[j]] for i (a pair's repeats matched in
//   order; their values are the same).  A row with more slots (a hub)
//   takes its max first, lane-parallel, then groups of RU, keeping exp,
//   dalpha, pre and the positions per (slot, head) in shared memory.
// * Sender pass: per (sender j, unit), over j's reverse slots in slot
//   order, SU = 4 at a time, ids shared by __shfl_sync: dh_val[j] +=
//   alpha dz[i] and da_src[j] += dpre, from dz[i] (gathered once per
//   edge) and the receiver pass's (alpha, dpre): no h row, no dot, no
//   exp.  Both running sums stay in registers across the whole reverse
//   list.  This spares the sender h[j] (a fifth of the layer's bytes)
//   and a round of loads per item, for 2 H floats an edge written and
//   read back.
// * The grid is each instance's occupancy on every SM, the dynamic
//   shared-memory attribute is set once per instance, and index math is
//   32-bit (N x HC < 2^31 is checked at the entry).
// The TPU kernel's one-hot scatter matmuls, hi/lo bf16 passes, window
// margins and head expansion matrices existed because Mosaic has no
// dynamic row gather or scatter; here a gather over the reverse slots
// replaces the scatter.

#include <stdint.h>

#include <initializer_list>

#include "gat_common.cuh"

namespace {

using namespace gnnb_gat;

constexpr unsigned FULL = 0xffffffffu;
// the row instances' shapes: float4 chunks a lane per work unit (C = 128;
// C = 64) and CTAs an SM each pass is built for
constexpr int RECV_NU32 = 2, RECV_NU16 = 2, RECV_CTAS = 2;
constexpr int SEND_NU32 = 2, SEND_NU16 = 2, SEND_CTAS = 3;
constexpr int RU = 4;       // receiver pass: a group's slots, in registers
constexpr int SU = 4;       // sender pass: reverse slots' loads in flight
constexpr int CHUNK = 32;   // general sender pass: reverse slots a pass

struct BwdArgs {
  const float* dz;      // [N, HC]
  const float* h;       // [N, HC]
  const float* a_src;   // [N, H]
  const float* a_dst;   // [N, H]
  const int* nbr;       // [N, W]
  const int* deg;       // [N]
  const int* rev;       // [N, Wr] (table mode) or rev_idx [E] (CSR mode)
  const int* odeg;      // [N] (table mode) or rev_ptr [N + 1] (CSR mode)
  const int* rev_pos;   // CSR mode: [N, W] each slot's CSR position
  float* dsum;          // [N, H]
  float* s;             // [N, H]
  float* m;             // [N, H]
  float* den;           // [N, H]
  float* dh_val;        // [N, HC]
  float* da_src;        // [N, H]
  float* ev;            // [P, H, 2]: (alpha, dpre) at each reverse
                        // position (P = N Wr, or E in CSR mode)
  int n_rows, W, Wr, H, C, self_loops;
  float neg_slope;
};

__device__ __forceinline__ float slope(float pre, float ns) {
  return pre >= 0.f ? 1.f : ns;
}

// a row's float4 chunk, read-only and not allocated in L1
__device__ __forceinline__ float4 ld4(const float* p) {
  float4 r;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
      : "l"(p));
  return r;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

// the butterfly over each CPH-lane segment, all K sums interleaved: every
// lane of a segment ends with the same bits
template <int CPH, int K>
__device__ __forceinline__ void seg_sum(float (&p)[K]) {
#pragma unroll
  for (int o = CPH / 2; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < K; ++k) p[k] += __shfl_xor_sync(FULL, p[k], o);
}

// A lane's chunks of a work unit (a row's NU chunk columns): chunk k of
// unit u is q = lane + 32 (u NU + k) of the row's HC / 4, in head q / CPH;
// ok where it lies in the row.
template <int CPH, int NU>
struct Chunks {
  int hd[NU];
  bool ok[NU];
  bool lead;   // the first lane of its segments: writes per-head values
  int q0;      // the unit's first chunk column of lane 0
  __device__ __forceinline__ Chunks(int lane, int H, int unit) {
    const int nq = H * CPH;
    q0 = 32 * NU * unit;
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      const int q = q0 + lane + 32 * k;
      ok[k] = q < nq;
      hd[k] = q / CPH;
    }
    lead = lane % CPH == 0;
  }
};

// units of a row: the row's float4 chunks a lane holds, NU a unit
template <int CPH, int NU>
__host__ __device__ __forceinline__ int units_of(int H) {
  return ((H * CPH + 31) / 32 + NU - 1) / NU;
}

// row r of an [N, H] array at the lane's chunks' heads
template <int CPH, int NU>
__device__ __forceinline__ void head_vals(const float* x, int r, int H,
                                          const Chunks<CPH, NU>& ch,
                                          float (&out)[NU]) {
#pragma unroll
  for (int k = 0; k < NU; ++k)
    out[k] = ch.ok[k] ? __ldg(x + r * H + ch.hd[k]) : 0.f;
}

// the lane's chunks of row r of an [N, HC] array (zero where not ok)
template <int CPH, int NU>
__device__ __forceinline__ void row_chunks(const float* x, int r, int HC,
                                           const Chunks<CPH, NU>& ch,
                                           float4 (&out)[NU]) {
  const float* p = x + r * HC + 4 * (ch.q0 + (threadIdx.x & 31));
#pragma unroll
  for (int k = 0; k < NU; ++k)
    out[k] = ch.ok[k] ? ld4(p + 128 * k) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Shared words per receiver warp of the row instances: exp, dalpha and
// pre of each (slot, head), and each slot's reverse position, for rows of
// more than RU slots.
__host__ __device__ __forceinline__ int hub_words(int W, int H) {
  return W > RU ? 3 * W * H + W : 0;
}

// the position of the n-th set bit of g (n < popc(g))
__device__ __forceinline__ int nth_bit(unsigned g, int n) {
  for (int q = 0; q < n; ++q) g &= g - 1;
  return __ffs(g) - 1;
}

// Table mode: where the sender pass finds the edges of a group's slots
// k0 + u of row i (senders js[u]): slot w's edge j -> i is the c-th
// occurrence of i in rev[j, :odeg[j]], c the occurrences of j among the
// row's earlier slots (a pair's repeats are matched in order; their
// values are the same), at position j Wr + r.  Eight lanes a slot scan
// j's list; the first eight entries and the out-degree are loaded here,
// beside the group's rows (scan_issue), and matched once they land
// (scan_finish).
struct Scan {
  int jl, len, v0;
};

__device__ __forceinline__ Scan scan_issue(const BwdArgs& a, int k0, int d,
                                           const int (&js)[RU], int lane) {
  static_assert(RU * 8 == 32, "eight lanes a slot");
  const int ul = lane >> 3, rl = lane & 7;
  Scan sc;
  sc.jl = js[0];
#pragma unroll
  for (int u = 1; u < RU; ++u)
    if (ul == u) sc.jl = js[u];
  const bool on = k0 + ul < d;
  sc.len = on ? __ldg(a.odeg + sc.jl) : 0;
  sc.v0 = on && rl < a.Wr ? __ldg(a.rev + sc.jl * a.Wr + rl) : -1;
  return sc;
}

__device__ __forceinline__ void scan_finish(const BwdArgs& a, int i, int k0,
                                            int d, int mine,
                                            const int (&js)[RU],
                                            const Scan& sc, int lane,
                                            int (&pos)[RU]) {
  const int ul = lane >> 3, rl = lane & 7;
  // c: the occurrences of the slot's sender among the row's earlier slots
  const int cb = k0 & ~31;   // mine holds slots cb + lane
  int c[RU];
#pragma unroll
  for (int u = 0; u < RU; ++u)
    c[u] = __popc(__ballot_sync(FULL, cb + lane < d && mine == js[u]) &
                  ((1u << (k0 + u - cb)) - 1u));
  for (int wb = 0; wb < cb; wb += 32) {   // a hub's earlier id chunks
    const int id = __ldg(a.nbr + i * a.W + wb + lane);
#pragma unroll
    for (int u = 0; u < RU; ++u)
      c[u] += __popc(__ballot_sync(FULL, id == js[u]));
  }
  int cl = c[0];
#pragma unroll
  for (int u = 1; u < RU; ++u)
    if (ul == u) cl = c[u];
  int most = 8;   // a table of at most eight slots is scanned in one step
  if (a.Wr > 8) {
    most = sc.len;
    for (int o = 16; o > 0; o >>= 1)
      most = max(most, __shfl_xor_sync(FULL, most, o));
  }
  int found = -1, seen = 0;
  for (int r0 = 0; r0 < most; r0 += 8) {
    const int r = r0 + rl;
    const int v = r0 == 0 ? sc.v0
                  : r < sc.len ? __ldg(a.rev + sc.jl * a.Wr + r) : -1;
    const unsigned g =
        (__ballot_sync(FULL, r < sc.len && v == i) >> (8 * ul)) & 0xffu;
    const int n = cl - seen;
    if (found < 0 && n < __popc(g)) found = r0 + nth_bit(g, n);
    seen += __popc(g);
  }
  const int p = found < 0 ? -1 : sc.jl * a.Wr + found;
#pragma unroll
  for (int u = 0; u < RU; ++u) pos[u] = __shfl_sync(FULL, p, 8 * u);
}

// A group's loads: the h rows and a_src values of its slots k0 + u < d
template <int CPH, int NU>
__device__ __forceinline__ void load_group(const BwdArgs& a, int k0, int d,
                                           const int (&js)[RU], int HC,
                                           const Chunks<CPH, NU>& ch,
                                           float4 (&hv)[RU][NU],
                                           float (&pre)[RU][NU]) {
#pragma unroll
  for (int u = 0; u < RU; ++u) {
    if (k0 + u < d) {
      row_chunks(a.h, js[u], HC, ch, hv[u]);
      head_vals(a.a_src, js[u], a.H, ch, pre[u]);
    } else {
#pragma unroll
      for (int k = 0; k < NU; ++k) {
        hv[u][k] = make_float4(0.f, 0.f, 0.f, 0.f);
        pre[u][k] = 0.f;
      }
    }
  }
}

// work item t's row degree (lane 0), its first slot ids and, in CSR mode,
// their reverse positions (lane l < W: slot l), for the receiver pass;
// nothing past the last item
template <bool CSR>
__device__ __forceinline__ void prefetch_row(const BwdArgs& a, int t,
                                             int units, int total, int lane,
                                             int& d, int& ids, int& pos) {
  if (t >= total) return;
  const int i = t / units;
  if (lane == 0) d = __ldg(a.deg + i);
  if (lane < a.W) {
    ids = __ldg(a.nbr + i * a.W + lane);
    if (CSR) pos = __ldg(a.rev_pos + i * a.W + lane);
  }
}

// The receiver pass of the row instances: per (row, unit), m, den, s and
// dsum of the unit's heads, and each slot's (alpha, dpre) written at its
// edge's reverse position for the sender pass.
template <bool CSR, int CPH, int NU>
__global__ void __launch_bounds__(THREADS, RECV_CTAS)
gat_bwd_recv_rows_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = a.W, H = a.H, HC = H * a.C;
  const int units = units_of<CPH, NU>(H);
  const float ns = a.neg_slope;
  float* se = smem + warp * hub_words(W, H);   // [W, H] each
  float* sd = se + W * H;
  float* sp = sd + W * H;
  int* sq = reinterpret_cast<int*>(sp + W * H);   // [W]
  const int total = a.n_rows * units, stride = gridDim.x * WARPS;
  // one work item ahead: the degree, each lane's first slot id (and its
  // reverse position), loaded beside it
  int d_next = 0, ids_next = 0, pos_next = -1;
  prefetch_row<CSR>(a, blockIdx.x * WARPS + warp, units, total, lane,
                    d_next, ids_next, pos_next);
  for (int t = blockIdx.x * WARPS + warp; t < total; t += stride) {
    const int i = t / units;
    const Chunks<CPH, NU> ch(lane, H, t - i * units);
    const int d = __shfl_sync(FULL, d_next, 0);
    int mine = ids_next, mpos = pos_next;
    prefetch_row<CSR>(a, t + stride, units, total, lane, d_next, ids_next,
                      pos_next);
    // every load of the row and of its first group, before any use
    float4 dz[NU], hs[NU], hv[RU][NU];
    float ad[NU], zs[NU], pre[RU][NU];
    int js[RU];
    row_chunks(a.dz, i, HC, ch, dz);
    if (a.self_loops) {
      row_chunks(a.h, i, HC, ch, hs);
    } else {
#pragma unroll
      for (int k = 0; k < NU; ++k) hs[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    head_vals(a.a_dst, i, H, ch, ad);
    head_vals(a.a_src, i, H, ch, zs);
#pragma unroll
    for (int u = 0; u < RU; ++u) js[u] = __shfl_sync(FULL, mine, u);
    load_group(a, 0, d, js, HC, ch, hv, pre);
    Scan sc = {0, 0, -1};
    if (!CSR) sc = scan_issue(a, 0, d, js, lane);
    float mx[NU], den[NU], ps[NU];
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      mx[k] = -BIG;
      den[k] = 0.f;
    }
    if (d > RU) {   // a hub: the max over every slot first
      for (int kb = 0; kb < d; kb += 32) {
        const int j = kb + lane < d
                          ? (kb == 0 ? mine : __ldg(a.nbr + i * W + kb + lane))
                          : -1;
        for (int hh = 0; hh < H; ++hh) {
          const float z =
              j < 0 ? -BIG
                    : lrelu(__ldg(a.a_src + j * H + hh) +
                                __ldg(a.a_dst + i * H + hh), ns);
          const float zm = warp_max(z);
#pragma unroll
          for (int k = 0; k < NU; ++k)
            if (ch.hd[k] == hh) mx[k] = fmaxf(mx[k], zm);
        }
      }
    }
    // the group's exp, dalpha, pre and reverse positions (the whole row
    // where d <= RU)
    float e[RU][NU], dal[RU][NU];
    int pos[RU];
    for (int k0 = 0;;) {
      // the group's dots, and in the first group the self slot's dot
      // dz[i] . h[i], reduced together
      float p[(RU + 1) * NU];
#pragma unroll
      for (int u = 0; u < RU; ++u)
#pragma unroll
        for (int k = 0; k < NU; ++k) {
          pre[u][k] += ad[k];
          p[u * NU + k] = dot4(dz[k], hv[u][k]);
        }
#pragma unroll
      for (int k = 0; k < NU; ++k)
        p[RU * NU + k] = k0 == 0 ? dot4(dz[k], hs[k]) : 0.f;
      seg_sum<CPH>(p);
      if (CSR) {
#pragma unroll
        for (int u = 0; u < RU; ++u)
          pos[u] = __shfl_sync(FULL, mpos, (k0 + u) & 31);
      } else {
        scan_finish(a, i, k0, d, mine, js, sc, lane, pos);
      }
      if (k0 == 0) {   // m: the slots' max (a hub's is formed), the self
                       // slot, the clamp
#pragma unroll
        for (int k = 0; k < NU; ++k) {
          ps[k] = p[RU * NU + k];
          zs[k] = lrelu(zs[k] + ad[k], ns);
          if (d <= RU)
#pragma unroll
            for (int u = 0; u < RU; ++u)
              if (u < d) mx[k] = fmaxf(mx[k], lrelu(pre[u][k], ns));
          if (a.self_loops) mx[k] = fmaxf(mx[k], zs[k]);
          mx[k] = fmaxf(mx[k], -BIG * 0.5f);
        }
      }
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        if (k0 + u >= d) break;
#pragma unroll
        for (int k = 0; k < NU; ++k) {
          e[u][k] = expf(lrelu(pre[u][k], ns) - mx[k]);
          den[k] += e[u][k];
          dal[u][k] = p[u * NU + k];
          if (d > RU && ch.lead && ch.ok[k]) {
            const int o = (k0 + u) * H + ch.hd[k];
            se[o] = e[u][k];
            sd[o] = dal[u][k];
            sp[o] = pre[u][k];
          }
        }
        if (d > RU && lane == 0) sq[k0 + u] = pos[u];
      }
      k0 += RU;
      if (k0 >= d) break;
      // a hub's next group
      if ((k0 & 31) == 0) {
        mine = k0 + lane < d ? __ldg(a.nbr + i * W + k0 + lane) : 0;
        if (CSR)
          mpos = k0 + lane < d ? __ldg(a.rev_pos + i * W + k0 + lane) : -1;
      }
#pragma unroll
      for (int u = 0; u < RU; ++u)
        js[u] = __shfl_sync(FULL, mine, (k0 + u) & 31);
      load_group(a, k0, d, js, HC, ch, hv, pre);
      if (!CSR) sc = scan_issue(a, k0, d, js, lane);
    }
    if (d > RU) __syncwarp();
    float dc[NU], es[NU], sv[NU], ds[NU];
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      es[k] = a.self_loops ? expf(zs[k] - mx[k]) : 0.f;
      den[k] += es[k];
      dc[k] = fmaxf(den[k], 1e-16f);
      sv[k] = ds[k] = 0.f;
    }
    if (d <= RU) {
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        if (u >= d) break;
#pragma unroll
        for (int k = 0; k < NU; ++k) {
          e[u][k] = e[u][k] / dc[k];   // alpha from here on
          sv[k] += e[u][k] * dal[u][k];
        }
      }
    } else {
      for (int w = 0; w < d; ++w)
#pragma unroll
        for (int k = 0; k < NU; ++k) {
          const int o = w * H + (ch.ok[k] ? ch.hd[k] : 0);
          sv[k] += se[o] / dc[k] * sd[o];
        }
    }
#pragma unroll
    for (int k = 0; k < NU; ++k)
      if (a.self_loops) sv[k] += es[k] / dc[k] * ps[k];
    // dpre per slot: summed into dsum in slot order and written with
    // alpha at the edge's reverse position
    if (d <= RU) {
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        if (u >= d) break;
#pragma unroll
        for (int k = 0; k < NU; ++k) {
          const float dp =
              e[u][k] * (dal[u][k] - sv[k]) * slope(pre[u][k], ns);
          ds[k] += dp;
          if (ch.lead && ch.ok[k] && pos[u] >= 0)
            *reinterpret_cast<float2*>(a.ev + 2 * (pos[u] * H + ch.hd[k])) =
                make_float2(e[u][k], dp);
        }
      }
    } else {
      for (int w = 0; w < d; ++w) {
        const int q = sq[w];
#pragma unroll
        for (int k = 0; k < NU; ++k) {
          const int o = w * H + (ch.ok[k] ? ch.hd[k] : 0);
          const float al = se[o] / dc[k];
          const float dp = al * (sd[o] - sv[k]) * slope(sp[o], ns);
          ds[k] += dp;
          if (ch.lead && ch.ok[k] && q >= 0)
            *reinterpret_cast<float2*>(a.ev + 2 * (q * H + ch.hd[k])) =
                make_float2(al, dp);
        }
      }
      __syncwarp();   // the next row's writes
    }
    if (ch.lead) {
#pragma unroll
      for (int k = 0; k < NU; ++k) {
        if (!ch.ok[k]) continue;
        const int o = i * H + ch.hd[k];
        a.dsum[o] = ds[k];
        a.s[o] = sv[k];
        a.m[o] = mx[k];
        a.den[o] = den[k];
      }
    }
  }
}

// work item t's out-degree (lane 0) and, in table mode, its first slot
// ids (lane l < Wr: slot l); in CSR mode the segment's start (lane 0)
template <bool CSR>
__device__ __forceinline__ void prefetch_rev(const BwdArgs& a, int t,
                                             int units, int total, int lane,
                                             int& d, int& base, int& first) {
  if (t >= total) return;
  const int j = t / units;
  if (CSR) {
    if (lane == 0) {
      base = __ldg(a.odeg + j);
      d = __ldg(a.odeg + j + 1) - base;
    }
  } else {
    if (lane == 0) d = __ldg(a.odeg + j);
    if (lane < a.Wr) first = __ldg(a.rev + j * a.Wr + lane);
  }
}

// The sender pass of the row instances: per (row j, unit), over j's
// reverse slots in order, dh_val[j] += alpha dz[i] and da_src[j] += dpre,
// from the (alpha, dpre) the receiver pass wrote at each slot.
template <bool CSR, int CPH, int NU>
__global__ void __launch_bounds__(THREADS, SEND_CTAS)
gat_bwd_send_rows_kernel(BwdArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H = a.H, HC = H * a.C;
  const int units = units_of<CPH, NU>(H);
  const int total = a.n_rows * units, stride = gridDim.x * WARPS;
  // one work item ahead: the out-degree and the first slot ids (CSR: the
  // segment's start, and its ids at the end of the item before)
  int d_next = 0, base_next = 0, first_next = 0;
  int t = blockIdx.x * WARPS + warp;
  prefetch_rev<CSR>(a, t, units, total, lane, d_next, base_next,
                    first_next);
  if (CSR) {
    const int b = __shfl_sync(FULL, base_next, 0);
    if (t < total && lane < __shfl_sync(FULL, d_next, 0))
      first_next = __ldg(a.rev + b + lane);
  }
  for (; t < total; t += stride) {
    const int j = t / units;
    const Chunks<CPH, NU> ch(lane, H, t - j * units);
    const int d = __shfl_sync(FULL, d_next, 0);
    const int base = CSR ? __shfl_sync(FULL, base_next, 0) : j * a.Wr;
    int mine = first_next;
    prefetch_rev<CSR>(a, t + stride, units, total, lane, d_next, base_next,
                      first_next);
    float4 acc[NU];
    float dacc[NU];
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      dacc[k] = 0.f;
    }
    for (int wb = 0; wb < d; wb += 32) {
      if (wb > 0) mine = wb + lane < d ? __ldg(a.rev + base + wb + lane) : 0;
      const int nr = min(32, d - wb);
      for (int w = 0; w < nr; w += SU) {
        float4 dzv[SU][NU];
        float2 ev[SU][NU];
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const int i = __shfl_sync(FULL, mine, (w + u) & 31);
          if (w + u < nr) {
            row_chunks(a.dz, i, HC, ch, dzv[u]);
            const float2* q = reinterpret_cast<const float2*>(a.ev) +
                              (base + wb + w + u) * H;
#pragma unroll
            for (int k = 0; k < NU; ++k)
              ev[u][k] =
                  ch.ok[k] ? __ldg(q + ch.hd[k]) : make_float2(0.f, 0.f);
          }
        }
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          if (w + u >= nr) break;
#pragma unroll
          for (int k = 0; k < NU; ++k) {
            const float alpha = ev[u][k].x;
            dacc[k] += ev[u][k].y;
            acc[k].x = fmaf(alpha, dzv[u][k].x, acc[k].x);
            acc[k].y = fmaf(alpha, dzv[u][k].y, acc[k].y);
            acc[k].z = fmaf(alpha, dzv[u][k].z, acc[k].z);
            acc[k].w = fmaf(alpha, dzv[u][k].w, acc[k].w);
          }
        }
      }
    }
    float* out = a.dh_val + j * HC + 4 * (ch.q0 + lane);
#pragma unroll
    for (int k = 0; k < NU; ++k) {
      if (!ch.ok[k]) continue;
      *reinterpret_cast<float4*>(out + 128 * k) = acc[k];
      if (ch.lead) a.da_src[j * H + ch.hd[k]] = dacc[k];
    }
    if (CSR) {   // the next item's ids, now that its start has landed
      const int b = __shfl_sync(FULL, base_next, 0);
      if (t + stride < total && lane < __shfl_sync(FULL, d_next, 0))
        first_next = __ldg(a.rev + b + lane);
    }
  }
}

// ---------------------------------------------------------------------------
// The general instance: any C, any H, any alignment.  A warp per row, one
// head at a time, the lanes strided over the head's C columns with scalar
// loads; the per-slot values in shared memory.

// dz[i, hd*C : (hd+1)*C] . h[j, hd*C : (hd+1)*C], every lane the same bits.
__device__ __forceinline__ float head_dot(const BwdArgs& a, int i, int j,
                                          int hd, int lane) {
  const int HC = a.H * a.C;
  const float* x = a.dz + i * HC + hd * a.C;
  const float* y = a.h + j * HC + hd * a.C;
  float p = 0.f;
  for (int c = lane; c < a.C; c += 32) p = fmaf(x[c], y[c], p);
  return warp_sum(p);
}

// Shared words per general receiver warp: slot ids, pre-activations, exps
// and dalpha.
__host__ __device__ __forceinline__ int recv_words(int W) { return 4 * W; }

__global__ void __launch_bounds__(THREADS) gat_bwd_recv_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int W = a.W, H = a.H;
  float* base = smem + warp * recv_words(W);
  int* ids = reinterpret_cast<int*>(base);   // [W]
  float* pre = base + W;                     // [W]
  float* ex = pre + W;                       // [W]
  float* dal = ex + W;                       // [W]
  const float ns = a.neg_slope;
  for (int i = blockIdx.x * WARPS + warp; i < a.n_rows;
       i += gridDim.x * WARPS) {
    const int d = a.deg[i];
    for (int k = lane; k < d; k += 32) ids[k] = a.nbr[i * W + k];
    __syncwarp();
    for (int hd = 0; hd < H; ++hd) {
      const int ih = i * H + hd;
      const float ad = a.a_dst[ih];
      float mx = -BIG;
      for (int k = lane; k < d; k += 32) {
        const float p = a.a_src[ids[k] * H + hd] + ad;
        pre[k] = p;
        mx = fmaxf(mx, lrelu(p, ns));
      }
      mx = warp_max(mx);
      const float zs = lrelu(a.a_src[ih] + ad, ns);
      if (a.self_loops) mx = fmaxf(mx, zs);
      mx = fmaxf(mx, -BIG * 0.5f);
      float sum = 0.f;
      for (int k = lane; k < d; k += 32) {
        const float e = expf(lrelu(pre[k], ns) - mx);
        ex[k] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      const float e_s = a.self_loops ? expf(zs - mx) : 0.f;
      const float dn = sum + e_s;
      const float dc = fmaxf(dn, 1e-16f);
      __syncwarp();
      float sv = 0.f;
      for (int k = 0; k < d; ++k) {
        const float da = head_dot(a, i, ids[k], hd, lane);
        if (lane == (k & 31)) dal[k] = da;
        sv += ex[k] / dc * da;
      }
      if (a.self_loops) sv += e_s / dc * head_dot(a, i, i, hd, lane);
      __syncwarp();
      float ds = 0.f;
      for (int k = 0; k < d; ++k)
        ds += ex[k] / dc * (dal[k] - sv) * slope(pre[k], ns);
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

// Shared words per general sender warp: the chunk's receivers, its alphas
// (H per slot) and the running da_src (H).
__host__ __device__ __forceinline__ int send_words(int H) {
  return CHUNK + CHUNK * H + H;
}

template <bool CSR>
__global__ void __launch_bounds__(THREADS) gat_bwd_send_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int H = a.H, C = a.C, HC = H * C;
  float* base = smem + warp * send_words(H);
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
      slots = a.rev + j * a.Wr;
    }
    for (int hd = lane; hd < H; hd += 32) dacc[hd] = 0.f;
    if (d == 0)
      for (int c = lane; c < HC; c += 32) a.dh_val[j * HC + c] = 0.f;
    for (int r0 = 0; r0 < d; r0 += CHUNK) {
      const int nr = min(CHUNK, d - r0);
      __syncwarp();
      if (lane < nr) ids[lane] = slots[r0 + lane];
      __syncwarp();
      for (int rr = 0; rr < nr; ++rr) {
        const int i = ids[rr];
        for (int hd = 0; hd < H; ++hd) {
          const int ih = i * H + hd;
          const float da = head_dot(a, i, j, hd, lane);
          const float p = a.a_src[j * H + hd] + a.a_dst[ih];
          const float alpha =
              expf(lrelu(p, ns) - a.m[ih]) / fmaxf(a.den[ih], 1e-16f);
          const float dpre = alpha * (da - a.s[ih]) * slope(p, ns);
          if (lane == 0) {
            alph[rr * H + hd] = alpha;
            dacc[hd] += dpre;
          }
        }
      }
      __syncwarp();
      for (int c = lane; c < HC; c += 32) {
        const int hd = c / C;
        const int o = j * HC + c;
        float acc = r0 == 0 ? 0.f : a.dh_val[o];
        for (int rr = 0; rr < nr; ++rr)
          acc += alph[rr * H + hd] * a.dz[ids[rr] * HC + c];
        a.dh_val[o] = acc;
      }
    }
    __syncwarp();
    for (int hd = lane; hd < H; hd += 32) a.da_src[j * H + hd] = dacc[hd];
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Launch

// per instance: the shared-memory attribute (set once), CTAs an SM at the
// last dynamic shared-memory size
struct Inst {
  bool attr = false;
  long long smem = -1;
  int per_sm = 0;
};

// `items` warps' work items: rows, or (row, unit) pairs
template <typename Kern>
cudaError_t launch_one(Kern kernel, Inst& in, size_t smem, long long items,
                       const BwdArgs& a, cudaStream_t st, int device) {
  static int sms = 0;
  static size_t optin = 0;
  cudaError_t err;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err == cudaSuccess) err = optin_bytes(device, &optin);
    if (err != cudaSuccess) {
      sms = 0;
      return err;
    }
  }
  if (smem > optin) return cudaErrorInvalidValue;
  if (!in.attr) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)optin);
    if (err != cudaSuccess) return err;
    in.attr = true;
  }
  if ((long long)smem != in.smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&in.per_sm, kernel,
                                                        THREADS, smem);
    if (err != cudaSuccess) return err;
    if (in.per_sm < 1) return cudaErrorInvalidValue;
    in.smem = (long long)smem;
  }
  const long long want = (items + WARPS - 1) / WARPS;
  const long long most = (long long)in.per_sm * sms;
  kernel<<<(int)(want < most ? want : most), THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// the instances: kind 0 the receiver pass (table mode; the general
// instance's in both modes), 1 the sender pass over the reverse table, 2
// over the reverse CSR, 3 the receiver pass of CSR mode; cph 32 (C = 128),
// 16 (C = 64), 0 the general instance
template <int KIND, int CPH> Inst& inst() {
  static Inst s;
  return s;
}

size_t recv_smem(int cph, int W, int H) {
  return (size_t)WARPS * sizeof(float) *
         (cph ? hub_words(W, H) : recv_words(W));
}

size_t send_smem(int cph, int H) {
  return cph ? 0 : (size_t)WARPS * sizeof(float) * send_words(H);
}

template <int CPH>
cudaError_t launch_cph(const BwdArgs& a, bool csr, cudaStream_t st,
                       int device) {
  const size_t rs = recv_smem(CPH, a.W, a.H), ss = send_smem(CPH, a.H);
  const long long rows = a.n_rows;
  cudaError_t err;
  if constexpr (CPH == 0) {
    err = launch_one(gat_bwd_recv_kernel, inst<0, 0>(), rs, rows, a, st,
                     device);
    if (err != cudaSuccess) return err;
    if (csr)
      return launch_one(gat_bwd_send_kernel<true>, inst<2, 0>(), ss, rows, a,
                        st, device);
    return launch_one(gat_bwd_send_kernel<false>, inst<1, 0>(), ss, rows, a,
                      st, device);
  } else {
    constexpr int NR = CPH == 32 ? RECV_NU32 : RECV_NU16;
    constexpr int NS = CPH == 32 ? SEND_NU32 : SEND_NU16;
    const long long ir = rows * units_of<CPH, NR>(a.H);
    const long long is = rows * units_of<CPH, NS>(a.H);
    if (csr) {
      err = launch_one(gat_bwd_recv_rows_kernel<true, CPH, NR>,
                       inst<3, CPH>(), rs, ir, a, st, device);
      if (err != cudaSuccess) return err;
      return launch_one(gat_bwd_send_rows_kernel<true, CPH, NS>,
                        inst<2, CPH>(), ss, is, a, st, device);
    }
    err = launch_one(gat_bwd_recv_rows_kernel<false, CPH, NR>,
                     inst<0, CPH>(), rs, ir, a, st, device);
    if (err != cudaSuccess) return err;
    return launch_one(gat_bwd_send_rows_kernel<false, CPH, NS>,
                      inst<1, CPH>(), ss, is, a, st, device);
  }
}

bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if ((uintptr_t)p % 16) return false;
  return true;
}

// the row instance of (H, C) and the arrays' alignment: 32, 16 or 0
int pick_cph(const BwdArgs& a, size_t optin) {
  if (a.C % 4 || !a.ev || !aligned16({a.dz, a.h, a.dh_val, a.ev}))
    return 0;
  const int cph = a.C == 128 ? 32 : a.C == 64 ? 16 : 0;
  if (cph && recv_smem(cph, a.W, a.H) > optin) return 0;
  return cph;
}

int launch(BwdArgs a, void* stream, int device, bool csr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a.n_rows < 0 || a.W < 1 || a.H < 1 || a.C < 1 || a.Wr < 0 || !a.dz ||
      !a.h || !a.a_src || !a.a_dst || !a.nbr || !a.deg || !a.rev ||
      !a.odeg || !a.dsum || !a.s || !a.m || !a.den || !a.dh_val ||
      !a.da_src || (long long)a.n_rows * a.H * a.C >= (1LL << 31) ||
      (long long)a.n_rows * a.W >= (1LL << 31) ||
      (long long)a.n_rows * a.Wr >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (a.n_rows == 0) return (int)cudaSuccess;
  size_t optin = 0;
  err = optin_bytes(device, &optin);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (pick_cph(a, optin)) {
    case 32: return (int)launch_cph<32>(a, csr, st, device);
    case 16: return (int)launch_cph<16>(a, csr, st, device);
    default: return (int)launch_cph<0>(a, csr, st, device);
  }
}

BwdArgs args(const void* dz, const void* h, const void* a_src,
             const void* a_dst, const void* nbr, const void* deg,
             const void* rev, const void* odeg, const void* rev_pos,
             int n_rows, int W, int Wr, int H, int C, float neg_slope,
             int self_loops, void* dsum, void* s, void* m, void* den,
             void* dh_val, void* da_src, void* ev) {
  BwdArgs a;
  a.dz = (const float*)dz;
  a.h = (const float*)h;
  a.a_src = (const float*)a_src;
  a.a_dst = (const float*)a_dst;
  a.nbr = (const int*)nbr;
  a.deg = (const int*)deg;
  a.rev = (const int*)rev;
  a.odeg = (const int*)odeg;
  a.rev_pos = (const int*)rev_pos;
  a.dsum = (float*)dsum;
  a.s = (float*)s;
  a.m = (float*)m;
  a.den = (float*)den;
  a.dh_val = (float*)dh_val;
  a.da_src = (float*)da_src;
  a.ev = (float*)ev;
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
// as documented in ops/cuda/gat_bwd.py; N x H x C below 2^31; ev the
// [N Wr, H, 2] f32 scratch of the edge values.  Returns the cudaError_t
// of the launches (0 = success).
int gnnb_gat_bwd(const void* dz, const void* h, const void* a_src,
                 const void* a_dst, const void* nbr, const void* deg,
                 const void* rev, const void* odeg, int n_rows, int W,
                 int Wr, int H, int C, float neg_slope, int self_loops,
                 void* dsum, void* s, void* m, void* den, void* dh_val,
                 void* da_src, void* ev, void* stream, int device) {
  return launch(args(dz, h, a_src, a_dst, nbr, deg, rev, odeg, nullptr,
                     n_rows, W, Wr, H, C, neg_slope, self_loops, dsum, s, m,
                     den, dh_val, da_src, ev),
                stream, device, false);
}

// The same with the sender pass over the reverse CSR (rev_ptr [N + 1],
// rev_idx [E] int32; rev_pos [N, W] int32 each forward slot's CSR
// position, ops/ell.py reverse_csr(positions=True)); ev [E, H, 2].
int gnnb_gat_bwd_csr(const void* dz, const void* h, const void* a_src,
                     const void* a_dst, const void* nbr, const void* deg,
                     const void* rev_ptr, const void* rev_idx,
                     const void* rev_pos, int n_rows, int W, int H, int C,
                     float neg_slope, int self_loops, void* dsum, void* s,
                     void* m, void* den, void* dh_val, void* da_src,
                     void* ev, void* stream, int device) {
  if (rev_pos == nullptr) return (int)cudaErrorInvalidValue;
  return launch(args(dz, h, a_src, a_dst, nbr, deg, rev_idx, rev_ptr,
                     rev_pos, n_rows, W, 0, H, C, neg_slope, self_loops,
                     dsum, s, m, den, dh_val, da_src, ev),
                stream, device, true);
}

// Registers per thread, shared memory (static plus the dynamic bytes the
// launch gives it at ELL width W and H heads) and resident CTAs per SM of
// an instance: kind 0 the receiver pass of table mode (the general
// instance's of both), 1 the sender pass over the reverse table, 2 over
// the reverse CSR, 3 the receiver pass of CSR mode; cph 32 (C = 128), 16
// (C = 64) or 0 (the general instance), on the current device.
int gnnb_gat_bwd_info(int kind, int cph, int W, int H, int* regs,
                      int* smem_bytes, int* ctas_per_sm) {
  const void* k = nullptr;
  const size_t dyn =
      kind == 0 || kind == 3 ? recv_smem(cph, W, H) : send_smem(cph, H);
  if (cph == 0)
    k = kind == 0   ? (const void*)gat_bwd_recv_kernel
        : kind == 1 ? (const void*)gat_bwd_send_kernel<false>
        : kind == 2 ? (const void*)gat_bwd_send_kernel<true>
                    : nullptr;
#define GNNB_PICK(CPH, NR, NS)                                               \
  if (cph == CPH)                                                            \
    k = kind == 0   ? (const void*)gat_bwd_recv_rows_kernel<false, CPH, NR>  \
        : kind == 3 ? (const void*)gat_bwd_recv_rows_kernel<true, CPH, NR>   \
        : kind == 1 ? (const void*)gat_bwd_send_rows_kernel<false, CPH, NS>  \
        : kind == 2 ? (const void*)gat_bwd_send_rows_kernel<true, CPH, NS>   \
                    : nullptr;
  GNNB_PICK(32, RECV_NU32, SEND_NU32) GNNB_PICK(16, RECV_NU16, SEND_NU16)
#undef GNNB_PICK
  if (k == nullptr || W < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return (int)err;
  *regs = fa.numRegs;
  *smem_bytes = (int)(fa.sharedSizeBytes + dyn);
  if (dyn > 48 * 1024) {
    int device = 0;
    size_t optin = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = optin_bytes(device, &optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)optin);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, k,
                                                            THREADS, dyn);
}

}  // extern "C"
