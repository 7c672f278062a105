// Native graph-packing library: edge sort + CSR and ELL table build.
//
// The host side of batch packing (core/packing.py): the tables are built
// once on the host per batch and shipped to the card with it.  A copy of
// the JAX package's packer, with the same algorithm and results; the
// numpy functions of core/packing.py are its plain version.
//
// Exposed via ctypes (gnnbuilder_tpu_torch/native/lib.py); built by
// gnnbuilder_tpu_torch/native/build.py (g++ -O3 -shared -fPIC) at first
// use.
//
// Algorithm: stable counting sort keyed by receiver — O(E + N), single pass
// of counts, prefix sum, single scatter pass.  Pad edge slots become
// ghost->ghost self edges so the sorted-by-receiver invariant holds across
// the padded tail and segment reductions dump pad traffic into the ghost row.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Bumped whenever an exported signature changes; lib.py refuses a library
// whose version is not the one it expects.
int gnnb_abi_version() { return 2; }

// Returns 0 on success; 1 if an edge endpoint is out of [0, num_nodes);
// 2 if num_edges > e_pad or sizes are inconsistent.
int gnnb_sort_and_csr(
    const int64_t* senders,    // [num_edges]
    const int64_t* receivers,  // [num_edges]
    int64_t num_edges,
    int64_t num_nodes,
    int64_t n_pad,
    int64_t e_pad,
    int64_t ghost,
    int32_t* out_senders,      // [e_pad]
    int32_t* out_receivers,    // [e_pad]
    int64_t* out_perm,         // [num_edges]
    int32_t* out_row_offsets,  // [n_pad + 1]
    int32_t* out_in_degree) {  // [n_pad]
  if (num_edges > e_pad || num_nodes > n_pad || ghost < 0 || ghost >= n_pad) {
    return 2;
  }

  // Pass 1: in-degree counts (real edges only).
  std::memset(out_in_degree, 0, sizeof(int32_t) * static_cast<size_t>(n_pad));
  for (int64_t e = 0; e < num_edges; ++e) {
    const int64_t r = receivers[e];
    const int64_t s = senders[e];
    if (r < 0 || r >= num_nodes || s < 0 || s >= num_nodes) return 1;
    ++out_in_degree[r];
  }

  // Prefix sum -> row offsets.  The ghost row additionally absorbs the pad
  // edges at the tail (as core/packing.py's numpy version does).
  std::vector<int64_t> cursor(static_cast<size_t>(n_pad), 0);
  int64_t acc = 0;
  out_row_offsets[0] = 0;
  for (int64_t v = 0; v < n_pad; ++v) {
    cursor[static_cast<size_t>(v)] = acc;
    int64_t c = out_in_degree[v];
    if (v == ghost) c += e_pad - num_edges;
    acc += c;
    out_row_offsets[v + 1] = static_cast<int32_t>(acc);
  }

  // Pass 2: stable scatter into sorted position.
  for (int64_t e = 0; e < num_edges; ++e) {
    const int64_t r = receivers[e];
    const int64_t pos = cursor[static_cast<size_t>(r)]++;
    out_senders[pos] = static_cast<int32_t>(senders[e]);
    out_receivers[pos] = static_cast<int32_t>(r);
    out_perm[pos] = e;
  }

  // Pad tail: ghost->ghost self edges.
  for (int64_t e = num_edges; e < e_pad; ++e) {
    out_senders[e] = static_cast<int32_t>(ghost);
    out_receivers[e] = static_cast<int32_t>(ghost);
  }
  return 0;
}

// Concatenate per-graph node features and edge lists into the flat batch
// layout (the inner loop of build_graph_batch, core/graph.py) —
// offsets edge endpoints by the running node count and emits per-node graph
// ids.  Feature copy stays in numpy (memcpy-bound either way); this handles
// the index arithmetic which is the python-loop-bound part.
int gnnb_concat_edges(
    const int64_t* edge_counts,   // [num_graphs] edges per graph
    const int64_t* node_counts,   // [num_graphs] nodes per graph
    const int64_t* edges_concat,  // [2 * total_edges] raw per-graph edge ids,
                                  // graph-major, row 0 = senders
    int64_t num_graphs,
    int64_t total_edges,
    int64_t* out_senders,    // [total_edges] global node ids
    int64_t* out_receivers,  // [total_edges]
    int32_t* out_node_graph,  // [total_nodes] graph id per node
    int64_t total_nodes) {
  int64_t eoff = 0, noff = 0;
  const int64_t* src_s = edges_concat;
  const int64_t* src_r = edges_concat + total_edges;
  for (int64_t g = 0; g < num_graphs; ++g) {
    const int64_t ne = edge_counts[g];
    const int64_t nn = node_counts[g];
    for (int64_t e = 0; e < ne; ++e) {
      out_senders[eoff + e] = src_s[eoff + e] + noff;
      out_receivers[eoff + e] = src_r[eoff + e] + noff;
    }
    for (int64_t v = 0; v < nn; ++v) {
      out_node_graph[noff + v] = static_cast<int32_t>(g);
    }
    eoff += ne;
    noff += nn;
  }
  if (eoff != total_edges || noff != total_nodes) return 2;
  return 0;
}

// Build ELL (padded neighbor table) format from the sorted-CSR arrays
// produced by gnnb_sort_and_csr.  The host-side analog of the reference's
// gather_node_neighbors[_and_edge_indices] (gnn_builder_lib.h:1168-1207):
// a dense [n_pad, ell_width] table of neighbor node ids and edge ids, padded
// with the ghost node / last pad edge, so aggregation becomes a dense gather
// + masked reduce over the width axis — no scatter on the accelerator.
//
// Rows whose in-degree exceeds ell_width are truncated (callers size
// ell_width to the batch max in-degree; the ghost row, which absorbs all pad
// edges, is truncated by design and masked out downstream).
int gnnb_build_ell(
    const int32_t* sorted_senders,  // [e_pad]
    const int32_t* row_offsets,     // [n_pad + 1]
    int64_t n_pad,
    int64_t e_pad,
    int64_t ell_width,
    int64_t ghost,
    int32_t* out_nbr_nodes,   // [n_pad * ell_width]
    int32_t* out_nbr_edges) { // [n_pad * ell_width]
  const int32_t pad_edge = static_cast<int32_t>(e_pad - 1);
  for (int64_t v = 0; v < n_pad; ++v) {
    const int64_t lo = row_offsets[v];
    int64_t len = row_offsets[v + 1] - lo;
    if (len > ell_width) len = ell_width;
    int32_t* nn = out_nbr_nodes + v * ell_width;
    int32_t* ne = out_nbr_edges + v * ell_width;
    int64_t k = 0;
    for (; k < len; ++k) {
      nn[k] = sorted_senders[lo + k];
      ne[k] = static_cast<int32_t>(lo + k);
    }
    for (; k < ell_width; ++k) {
      nn[k] = static_cast<int32_t>(ghost);
      ne[k] = pad_edge;
    }
  }
  return 0;
}

}  // extern "C"
