// marex_host: the host routines of marex_tpu_torch, loaded with ctypes by
// marex_tpu_torch/_native.py (built by g++ at first use):
//   * union-find over the event graph (event clustering: the merge march's
//     overlap edges joined into events);
//   * LZ4 block decompression (blosc/lz4 zarr chunks read by io/zarr_lite.py).
//
// Built as a plain shared library with a C interface: no pybind11 and no
// PyTorch headers.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Path-compressed union-find over an edge list. node_ids must be sorted
// ascending; comp receives 0-based component indices ordered by smallest
// member.
static int64_t uf_find(std::vector<int64_t>& parent, int64_t i) {
  int64_t root = i;
  while (parent[root] != root) root = parent[root];
  while (parent[i] != root) {
    int64_t next = parent[i];
    parent[i] = root;
    i = next;
  }
  return root;
}

void marex_union_find(const int64_t* edge_a, const int64_t* edge_b,
                      int64_t n_edges, const int64_t* node_ids,
                      int64_t n_nodes, int32_t* comp_out) {
  std::unordered_map<int64_t, int64_t> index;
  index.reserve(n_nodes * 2);
  for (int64_t i = 0; i < n_nodes; ++i) index[node_ids[i]] = i;

  std::vector<int64_t> parent(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i) parent[i] = i;

  for (int64_t e = 0; e < n_edges; ++e) {
    auto ia = index.find(edge_a[e]);
    auto ib = index.find(edge_b[e]);
    if (ia == index.end() || ib == index.end()) continue;
    int64_t ra = uf_find(parent, ia->second);
    int64_t rb = uf_find(parent, ib->second);
    if (ra != rb) parent[ra > rb ? ra : rb] = (ra < rb ? ra : rb);
  }

  // densify component ids in order of first appearance (root index order)
  std::unordered_map<int64_t, int32_t> remap;
  remap.reserve(n_nodes);
  int32_t next = 0;
  for (int64_t i = 0; i < n_nodes; ++i) {
    int64_t r = uf_find(parent, i);
    auto it = remap.find(r);
    if (it == remap.end()) {
      remap[r] = next;
      comp_out[i] = next;
      ++next;
    } else {
      comp_out[i] = it->second;
    }
  }
}

// LZ4 block-format decompression (safe: bounds-checked). Used by the
// zarr-lite reader to decode blosc/lz4 chunks (the reference ecosystem's
// default codec) without external compression libraries. Returns the number
// of bytes written to dst, or -1 on malformed input.
int64_t marex_lz4_decompress(const uint8_t* src, int64_t src_len,
                             uint8_t* dst, int64_t dst_capacity) {
  int64_t si = 0;
  int64_t di = 0;
  while (si < src_len) {
    const uint8_t token = src[si++];
    // literals
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t x;
      do {
        if (si >= src_len) return -1;
        x = src[si++];
        lit += x;
      } while (x == 255);
    }
    if (si + lit > src_len || di + lit > dst_capacity) return -1;
    std::memcpy(dst + di, src + si, static_cast<size_t>(lit));
    si += lit;
    di += lit;
    if (si >= src_len) break;  // last sequence has no match part
    // match
    if (si + 2 > src_len) return -1;
    const int64_t offset = static_cast<int64_t>(src[si]) |
                           (static_cast<int64_t>(src[si + 1]) << 8);
    si += 2;
    if (offset == 0 || offset > di) return -1;
    int64_t mlen = token & 15;
    if (mlen == 15) {
      uint8_t x;
      do {
        if (si >= src_len) return -1;
        x = src[si++];
        mlen += x;
      } while (x == 255);
    }
    mlen += 4;
    if (di + mlen > dst_capacity) return -1;
    int64_t from = di - offset;
    if (offset >= mlen) {
      std::memcpy(dst + di, dst + from, static_cast<size_t>(mlen));
      di += mlen;
    } else {
      for (int64_t k = 0; k < mlen; ++k) dst[di + k] = dst[from + k];
      di += mlen;
    }
  }
  return di;
}

}  // extern "C"
