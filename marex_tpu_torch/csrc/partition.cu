// The grid partition of merging children for Hopper (sm_90a).
//
// marex_partition_grid cuts every merging child of one march step among its
// parents, what ops/partition.py:partition_children_grid_plain computes with
// nn = True: each cell of child k goes to the parent p whose nearest cell is
// closest (the exact periodic Euclidean distance transform of the parent's
// cells in the previous slice), unless that distance is beyond the child's
// cap, and then to the parent whose centroid is closest; the cell takes the
// piece id of (k, p), and the six integer sums behind each piece's (area, cy,
// cx) are accumulated on the way. It replaces no Pallas kernel: the
// reference (marex_tpu/ops/partition.py:partition_nn_grid) leaves the
// distance transform to XLA, as a min over every source row of
// d_row(y')**2 + (y - y')**2 at every cell of the slice, which the port ran
// as PyTorch operations over (parents, rows, source rows, W) blocks.
//
// Exactness. Squared distances are integers, computed here in 64 bits, and
// rounded once to float32 before the square root (IEEE, no fast math): the
// plain version's float32 values wherever they are exact, that is while the
// squares stay below 2**24 (any H and W up to 4096). The parents' roots are
// compared, with the lowest index winning ties (two integers near 2**24 can
// share a root), the cap is d <= max_dist[k] in float32, and the centroid
// fallback is fl(fl(dy*dy) + fl(dx*dx)) with dx folded into [-W/2, W/2], in
// the plain version's order (the _rn intrinsics keep nvcc from fusing it).
// The sums are integers, so the order of the atomics does not matter.
//
// Two launches on the caller's stream:
// 1. row_pass_kernel, one warp per (k, p, row): the distance along the row to
//    the nearest cell of parent p (periodic when wrap, the seam rule of
//    _row_distance_periodic), -1 for a row without one. The parent's mask is
//    prev == parent_ids[k, p] tested on the fly (never stored); each warp
//    walks its row 32 cells at a time, forward with a ballot and the last set
//    bit for the nearest cell at or before x, then backward for the nearest
//    at or after x (the cell's own forward result says whether it is set).
//    Linear in K * P * H * W.
// 2. cell_kernel, one thread per cell and child (blocks of 32 columns x 8
//    rows; a warp without a cell of its child leaves at once). The column
//    pass at this cell alone, for all parents at once: the rows y -+ dy for
//    dy = 0, 1, ..., each row holding a cell of parent p giving the candidate
//    dy**2 + d_row**2 for p, until the root of dy**2 passes the least root
//    found (no farther row can come nearer, or tie) or dy passes floor(cap) +
//    1 (a row that far gives a distance over the cap: the capped result is
//    exact, as the reference's row window was for a cap within it). The
//    least (root, slot) over the candidates is the argmin over the parents'
//    capped roots with the lowest slot winning ties. Then the fallback and
//    the piece id, and the sums gathered per piece across the warp (ballots
//    and __reduce_add_sync), one atomic a sum a piece a warp.
//
// What bounds it on an H100: the two label slices read once and the updated
// slice written once (12 B a cell, 3.7 us at 720 x 1440 and 3.35 TB/s). What
// it moves instead: each (k, p) reads the previous slice and writes its row
// distances (8 B a cell, mostly in the 50 MB L2 at K * P of a few), every
// child reads the current slice, and each child cell reads P row distances
// a row out to its distance from the nearest parent (from L1: the 256 cells
// of a block share the rows they read). That search is the part that grows
// with the data, with the children's distance from their parents, and it is
// spread over every cell of every child. A linear-time envelope along each
// column (Meijster's second phase, one thread a (parent, column), its stack
// in global memory) needs fewer steps in all, but runs them as one dependent
// chain a column over the few columns a child spans: on grid-merge's batches
// it took 0.93 ms a call on an NVIDIA H100 80GB HBM3 at 700 W.
//
// All launch on the caller's stream, never synchronise, allocate nothing,
// and return cudaGetLastError() of the last launch.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowWarps = 8;    // warps a block of the row pass
constexpr int kCellRows = 8;    // rows a block of the cell kernel (one warp a row)
constexpr int kEdgeZone = 100;  // ops/properties.py:EDGE_ZONE
constexpr unsigned kAll = 0xffffffffu;

__global__ void row_pass_kernel(const int32_t* __restrict__ prev, const int32_t* __restrict__ parent_ids,
                                const bool* __restrict__ parent_valid, int32_t* __restrict__ rowd, long long n_rows,
                                int H, int W, int wrap) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowWarps + threadIdx.x / kWarp;
  if (row >= n_rows) return;  // the whole warp
  const int lane = threadIdx.x % kWarp;
  const long long kp = row / H;
  const int y = static_cast<int>(row - kp * H);
  const int32_t pid = parent_ids[kp];
  const bool valid = parent_valid[kp];
  const int32_t* src = prev + static_cast<size_t>(y) * W;
  int32_t* dst = rowd + static_cast<size_t>(row) * W;

  // forward: the nearest set cell at or before x; the row's first and last
  int last_set = -1, first_set = -1;
  for (int x0 = 0; x0 < W; x0 += kWarp) {
    const int x = x0 + lane;
    const unsigned bits = __ballot_sync(kAll, valid && x < W && src[x] == pid);
    const unsigned upto = bits & (kAll >> (kWarp - 1 - lane));
    if (x < W) dst[x] = upto ? x0 + kWarp - 1 - __clz(upto) : last_set;
    if (bits) {
      last_set = x0 + kWarp - 1 - __clz(bits);
      if (first_set < 0) first_set = x0 + __ffs(bits) - 1;
    }
  }
  // backward: the nearest set cell at or after x, then the distance
  int next_set = -1;
  for (int x0 = ((W - 1) / kWarp) * kWarp; x0 >= 0; x0 -= kWarp) {
    const int x = x0 + lane;
    const int before = x < W ? dst[x] : -1;  // this lane's own forward result
    const unsigned bits = __ballot_sync(kAll, x < W && before == x);
    const unsigned from = bits & (kAll << lane);
    const int after = from ? x0 + __ffs(from) - 1 : next_set;
    if (bits) next_set = x0 + __ffs(bits) - 1;
    if (x < W) {
      int d = -1;
      if (first_set >= 0) {
        const int none = INT_MAX;
        const int fwd = before >= 0 ? x - before : (wrap ? x + W - last_set : none);
        const int bwd = after >= 0 ? after - x : (wrap ? first_set + W - x : none);
        d = min(fwd, bwd);
      }
      dst[x] = d;
    }
  }
}

__global__ void cell_kernel(const int32_t* __restrict__ cur, const int32_t* __restrict__ rowd,
                            const int32_t* __restrict__ child_ids, const int32_t* __restrict__ piece_ids,
                            const bool* __restrict__ parent_valid, const float* __restrict__ cents,
                            const float* __restrict__ max_dist, int32_t* __restrict__ out,
                            unsigned long long* __restrict__ sums, int P, int H, int W, int wrap) {
  const int k = blockIdx.z;
  const int32_t cid = child_ids[k];
  if (cid <= 0) return;  // an inactive slot: the whole block
  const int lane = threadIdx.x % kWarp;
  const int x = blockIdx.x * kWarp + lane;
  const int y = blockIdx.y * kCellRows + threadIdx.x / kWarp;
  const size_t cell = static_cast<size_t>(y) * W + x;
  const bool mine = x < W && y < H && cur[cell] == cid;
  if (!__any_sync(kAll, mine)) return;  // the whole warp

  int a = -1;  // the cell's parent slot
  if (mine) {
    const float inf = __int_as_float(0x7f800000);
    const float cap = max_dist[k];
    // rows farther than floor(cap) + 1 give distances over the cap (NaN: none)
    const int reach = cap >= static_cast<float>(H) ? H : (cap >= 0.0f ? static_cast<int>(floorf(cap)) + 1 : -1);
    const size_t plane = static_cast<size_t>(H) * W;
    const int32_t* col = rowd + static_cast<size_t>(k) * P * plane + x;
    const int32_t* pieces = piece_ids + static_cast<size_t>(k) * P;
    const bool* valid = parent_valid + static_cast<size_t>(k) * P;
    const float* cent = cents + static_cast<size_t>(k) * P * 2;
    // the column pass of all parents at once, rows y -+ dy outwards: the least
    // (root, slot) of the candidates dy**2 + d_row**2 is the least of the
    // parents' (root of their squared distance, slot); a row farther out gives
    // a root at least that of dy**2, so the search ends once that passes the best
    float best = inf;
    for (int dy = 0; dy <= reach; ++dy) {
      const long long dy2 = static_cast<long long>(dy) * dy;
      if (__fsqrt_rn(__ll2float_rn(dy2)) > best || (y < dy && y + dy >= H)) break;
      for (int side = 0; side < (dy ? 2 : 1); ++side) {
        const int row = side ? y + dy : y - dy;
        if (row < 0 || row >= H) continue;
        for (int p = 0; p < P; ++p) {
          const int g = col[p * plane + static_cast<size_t>(row) * W];
          if (g < 0) continue;
          const float d = __fsqrt_rn(__ll2float_rn(dy2 + static_cast<long long>(g) * g));
          if (d < best || (d == best && p < a)) best = d, a = p;
        }
      }
    }
    if (a < 0 || !(best <= cap)) {  // no parent within the cap: the nearest centroid
      best = inf, a = 0;
      const float half = 0.5f * static_cast<float>(W);
      for (int p = 0; p < P; ++p) {
        float v = inf;
        if (valid[p]) {
          const float dy = __fsub_rn(static_cast<float>(y), cent[2 * p]);
          float dx = __fsub_rn(static_cast<float>(x), cent[2 * p + 1]);
          if (wrap) {
            if (dx > half) dx = __fsub_rn(dx, static_cast<float>(W));
            if (dx < -half) dx = __fadd_rn(dx, static_cast<float>(W));
          }
          v = __fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx));
        }
        if (p == 0 || v < best) best = v, a = p;
      }
    }
    if (pieces[a] > 0) out[cell] = pieces[a];
  }

  // the pieces' sums: the warp's cells gathered by parent slot
  unsigned todo = __ballot_sync(kAll, a >= 0);
  while (todo) {
    const int slot = __shfl_sync(kAll, a, __ffs(todo) - 1);
    const bool in = a == slot;
    const unsigned group = __ballot_sync(kAll, in);
    const unsigned sum_y = __reduce_add_sync(kAll, in ? static_cast<unsigned>(y) : 0u);
    const unsigned sum_x = __reduce_add_sync(kAll, in ? static_cast<unsigned>(x) : 0u);
    const unsigned right = __popc(__ballot_sync(kAll, in && x >= W / 2 + 1));
    const unsigned left_edge = __popc(__ballot_sync(kAll, in && x < kEdgeZone));
    const unsigned right_edge = __popc(__ballot_sync(kAll, in && x >= W - kEdgeZone));
    if (lane == __ffs(group) - 1) {
      unsigned long long* b = sums + (static_cast<size_t>(k) * P + slot) * 6;
      atomicAdd(b + 0, static_cast<unsigned long long>(__popc(group)));
      atomicAdd(b + 1, static_cast<unsigned long long>(sum_y));
      atomicAdd(b + 2, static_cast<unsigned long long>(sum_x));
      if (right) atomicAdd(b + 3, static_cast<unsigned long long>(right));
      if (left_edge) atomicAdd(b + 4, static_cast<unsigned long long>(left_edge));
      if (right_edge) atomicAdd(b + 5, static_cast<unsigned long long>(right_edge));
    }
    todo &= ~group;
  }
}

}  // namespace

// prev, cur, out: (H, W) int32, out a copy of cur that the kernel overwrites
// at the children's cells; child_ids (K,) int32 (0 = inactive slot; the
// nonzero ids distinct); piece_ids, parent_ids (K, P) int32; parent_valid
// (K, P) bool; cents (K, P, 2) float32 (y, x) pixels; max_dist (K,) float32;
// rowd: (K, P, H, W) int32 scratch; sums: (K, P, 6) int64 zeros on entry, on
// return each piece's cell count, sum of y, sum of x, cells right of W / 2,
// cells in the left and in the right edge zone. K == 0 launches nothing.
extern "C" int marex_partition_grid(const int32_t* prev, const int32_t* cur, const int32_t* child_ids,
                                    const int32_t* piece_ids, const int32_t* parent_ids, const bool* parent_valid,
                                    const float* cents, const float* max_dist, int32_t* rowd, int32_t* out,
                                    long long* sums, int K, int P, int H, int W, int wrap, void* stream) {
  if (K < 0 || K > 65535 || P < 1 || H < 1 || W < 1 || (H + kCellRows - 1) / kCellRows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (K == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_rows = static_cast<long long>(K) * P * H;
  row_pass_kernel<<<static_cast<unsigned>((n_rows + kRowWarps - 1) / kRowWarps), kRowWarps * kWarp, 0, s>>>(
      prev, parent_ids, parent_valid, rowd, n_rows, H, W, wrap);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((W + kWarp - 1) / kWarp),
                  static_cast<unsigned>((H + kCellRows - 1) / kCellRows), static_cast<unsigned>(K));
  cell_kernel<<<grid, kCellRows * kWarp, 0, s>>>(cur, rowd, child_ids, piece_ids, parent_valid, cents, max_dist, out,
                                                 reinterpret_cast<unsigned long long*>(sums), P, H, W, wrap);
  return static_cast<int>(cudaGetLastError());
}
