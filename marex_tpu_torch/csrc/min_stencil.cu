// Connected-component labelling (CCL) kernels for Hopper (sm_90a).
//
// marex_ccl_step replaces the Pallas TPU kernel
// marex_tpu/ops/pallas_kernels.py:min_stencil_pallas (bodies
// _stencil_kernel_masked / _stencil_kernel_plain / _min9_block) and fuses
// into it the hooking step of the port's fixpoints. Its modes:
//   kPlain   out = 3x3-min(lab)                       (Pallas plain body)
//   kMasked  out = where(data, 3x3-min(lab), BIG)     (Pallas masked body)
//   kStep2d  m = where(data, 3x3-min(lab), BIG), then the hook, per slice
//   kStep3d  m = where(data, 3x3x3-min(lab), BIG), then the hook, over the
//            whole block (marex_tpu/ops/label.py:_min_pool_3x3x3 masked)
// on (T, H, W) int32 labels; periodic in x when wrap_x (else BIG beyond
// the x edges), BIG beyond the y and t edges. kPlain and kMasked store m.
//
// The hook (the port's stand-in for the reference's segmented-min sweeps,
// marex_tpu/ops/label.py:_segmented_min_sweep) lets every active cell whose
// new label m is below its old label r != BIG lower the cell r of its hook
// slice (H*W cells in 2-D, T*H*W in 3-D) to m. The step writes its result
// into out by atomicMin only: each active cell lowers its own cell to m and
// the cell r of its hook. On entry out must hold a field that is >= m
// element by element (BIG-filled, say); then the result is exactly
// min(m, the hooks aimed at the cell), which is hook_plain(lab, m) bit for
// bit, whatever the order of the atomics. In the fixpoints out is the
// previous iteration's hooked field B, and that is always >= the next m:
// the labels are lab = jump(B) <= B, m <= lab wherever data is true (the
// stencil includes the centre), and inactive cells are BIG in both. So two
// label buffers ping-pong with no copy: the step reads A and lowers B, the
// jump reads B and writes A; the first iteration takes a BIG-filled B.
//
// The step also sets *flag when some active cell had m < lab. That is
// exactly "this iteration changes the labels": if m < lab somewhere the new
// label there is <= m < lab; if nowhere, m == lab on every active cell, so
// the labels are constant on each component and the cell each names lies
// in it, and the hook and the jump change nothing. The flag replaces a
// full comparison of old and new labels.
//
// marex_pointer_jump is the pointer-jumping hop of those fixpoints,
// out = min(lab, lab[base + lab]) per slice, with BIG left as BIG
// (marex_tpu/ops/label.py:_jump, an XLA gather in the reference), out of
// place, so its result is deterministic.
//
// What bounds them on an H100: none does arithmetic worth counting. The
// step must read lab (4 B) and the mask (1 B) and write out (4 B) per
// cell: 9 B/cell, about 3 ms over the production field (1095 x 720 x
// 1440) at the data sheet's 3.35 TB/s. (The step writes only the cells it
// lowers, and reads out as said below.) The design for that bound:
//  - a warp takes a strip of 128 columns of a row, each lane the 4 cells
//    32 columns apart, so that every atomic instruction of a warp covers
//    32 neighbouring cells: 4 sectors, where a lane of 4 neighbouring
//    cells would spread it over 16; x-neighbours come by shuffles, and only
//    the end lanes load the strip's halo (with the x wrap);
//  - 2-D: a warp marches down y through a chunk of rows of one slice and
//    keeps the horizontal 3-min of rows y-1, y, y+1 in registers, loading
//    row y+2, and the mask and out of row y+1, while row y is finished, so
//    each label is read from memory about once. Labels and out come as one
//    16-byte load a lane and are turned into the lane's own cells through
//    a 512-byte buffer of the warp in shared memory; the mask comes as one
//    4-byte word a lane, spread by shuffles (both faster than 4 scalar
//    loads a lane);
//  - 3-D: a block of 8 warps takes an 8-row x 128-column tile and marches
//    along t through a chunk of planes. cp.async copies the next plane's
//    tile (with its halo rows and columns) into the other half of a
//    two-stage shared-memory buffer while the current one is reduced to
//    its planar 3x3 min; the planar mins of planes t-1, t, t+1 stay in
//    registers. TMA is not used: it fills with zero, not BIG, and cannot
//    wrap x. (The 2-D step's 16-byte loads of mask and out made this
//    kernel slower: more registers and shared memory, fewer blocks);
//  - 32-bit index arithmetic inside a slice, the slice base added once;
//  - atomics only where they change something: the own-cell write reads
//    out first and the hook reads its target first (a stale read is safe:
//    out only falls), a hook aimed at the cell itself (every cell of the
//    first iteration) is left to the own write, and inactive cells issue
//    none. The hooks of a component's cells aim at few roots, and atomics
//    on one address serialise;
//  - the flag is a warp vote and one store per warp that saw a change;
//  - any W and any alignment take the same code; 16-byte accesses where
//    W % 4 == 0 and the tensors are aligned for them, else 4-byte ones.
// The jump reads one label array in one coalesced pass plus one gather per
// active cell.
//
// All entry points launch on the caller's stream, never synchronise,
// allocate nothing, and return cudaGetLastError() of the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int32_t kBig = 2147483647;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kMaxGridY = 65535;

enum Mode { kPlain = 0, kMasked = 1, kStep2d = 2, kStep3d = 3 };

// A warp takes a strip of kStrip columns; lane l holds its columns
// l, l + 32, l + 64, l + 96 (kGroups cells), so that each load, store and
// atomic instruction of a warp covers 32 consecutive cells.
constexpr int kGroups = 4;
constexpr int kStrip = 32 * kGroups;
// 2-D: strips (warps) per block and rows per block
constexpr int kStripWarps = 4;
constexpr int kChunkRows = 32;
// 3-D: rows per tile (one warp each) and planes per block
constexpr int kTileRows = 8;
constexpr int kChunkPlanes = 32;

// Value of column x >= 0 of a row for the stencil: the label inside the
// row; beyond it BIG, except column W, which holds column 0 when x wraps
// (the right neighbour of column W - 1).
__device__ __forceinline__ int32_t column(const int32_t* __restrict__ row, int x, int W, int wrap_x) {
  return x < W ? row[x] : (x == W && wrap_x ? row[0] : kBig);
}

// Horizontal 3-min of a lane's cells. Inside a group the neighbours come by
// shuffles; across groups lane 0 takes lane 31's value of the group before
// and lane 31 lane 0's of the group after; at the strip's ends lane 0 takes
// `left` and lane 31 `right`, which those lanes loaded.
__device__ __forceinline__ void hmin3(const int32_t (&v)[kGroups], int32_t left, int32_t right,
                                      int32_t (&h)[kGroups]) {
  const int lane = threadIdx.x & 31;
  int32_t up[kGroups], down[kGroups];
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    up[g] = __shfl_sync(kFull, v[g], (lane + 31) & 31);
    down[g] = __shfl_sync(kFull, v[g], (lane + 1) & 31);
  }
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int32_t l = lane > 0 ? up[g] : (g > 0 ? up[g - 1] : left);
    const int32_t r = lane < 31 ? down[g] : (g < kGroups - 1 ? down[g + 1] : right);
    h[g] = min(min(l, v[g]), r);
  }
}

// The fused hook of one active cell: lower its own entry (`own`, flat index
// `self` in its hook slice) and the entry of its old label r, both to m.
// `seen` is an earlier read of *own. A read may be stale, but out only
// falls, so a value read <= m means that the atomic would change nothing.
// A label equal to the cell's own index aims the hook at the cell itself,
// which the own write covers.
__device__ __forceinline__ void hook_cell(int32_t m, int32_t r, int32_t self, int32_t seen, int32_t* own,
                                          int32_t* hook_slice, bool& changed) {
  if (m < r) {
    changed = true;
    if (r != kBig && r != self && hook_slice[r] > m) atomicMin(hook_slice + r, m);
  }
  if (m < seen) atomicMin(own, m);
}

// One row of a strip as loaded, plus the halo columns its end lanes need.
// With VEC16 a lane holds 4 neighbouring columns (one 16-byte load), else
// its own kGroups columns; to_groups() turns the first into the second.
struct Row {
  int32_t q[kGroups];
  int32_t left, right;
};

// The cells of a strip's row as loaded (p: the row, or null for a row
// outside the field, which reads as BIG).
template <bool VEC16>
__device__ __forceinline__ void load_cells(const int32_t* __restrict__ p, int W, int xs, int wrap_x,
                                           int32_t (&q)[kGroups]) {
  const int lane = threadIdx.x & 31;
  if (p == nullptr) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) q[g] = kBig;
  } else if (VEC16) {
    const int x = xs + 4 * lane;
    if (x < W) {
      const int4 v = *reinterpret_cast<const int4*>(p + x);
      q[0] = v.x;
      q[1] = v.y;
      q[2] = v.z;
      q[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] = column(p, x + j, W, wrap_x);
    }
  } else {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) q[g] = column(p, xs + 32 * g + lane, W, wrap_x);
  }
}

template <bool VEC16>
__device__ __forceinline__ void load_row(const int32_t* __restrict__ slice, int yy, int H, int W, int xs,
                                         int wrap_x, Row& row) {
  const int lane = threadIdx.x & 31;
  const int32_t* p = yy >= 0 && yy < H ? slice + yy * W : nullptr;
  load_cells<VEC16>(p, W, xs, wrap_x, row.q);
  row.left = row.right = kBig;
  if (p == nullptr) return;
  if (lane == 0) row.left = xs > 0 ? p[xs - 1] : (wrap_x ? p[W - 1] : kBig);
  if (lane == 31) row.right = column(p, xs + kStrip, W, wrap_x);
}

// A lane's own cells (columns lane + 32 g of the strip) from a load: with
// VEC16 through the warp's buffer in shared memory, else as they are.
template <bool VEC16>
__device__ __forceinline__ void to_groups(const int32_t (&q)[kGroups], int32_t* wbuf, int32_t (&v)[kGroups]) {
  const int lane = threadIdx.x & 31;
  if (VEC16) {
    __syncwarp();  // the warp's last reads of wbuf are done
    *reinterpret_cast<int4*>(wbuf + 4 * lane) = make_int4(q[0], q[1], q[2], q[3]);
    __syncwarp();
#pragma unroll
    for (int g = 0; g < kGroups; ++g) v[g] = wbuf[32 * g + lane];
  } else {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) v[g] = q[g];
  }
}

// Store a lane's own cells into a strip's row: with VEC16 turned back
// through the warp's buffer into 4 neighbouring columns a lane and one
// 16-byte store.
template <bool VEC16>
__device__ __forceinline__ void store_cells(int32_t* p, int W, int xs, const int32_t (&v)[kGroups], int32_t* wbuf) {
  const int lane = threadIdx.x & 31;
  if (VEC16) {
    __syncwarp();
#pragma unroll
    for (int g = 0; g < kGroups; ++g) wbuf[32 * g + lane] = v[g];
    __syncwarp();
    if (xs + 4 * lane < W) *reinterpret_cast<int4*>(p + xs + 4 * lane) = *reinterpret_cast<const int4*>(wbuf + 4 * lane);
  } else {
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      if (xs + 32 * g + lane < W) p[xs + 32 * g + lane] = v[g];
  }
}

// The mask of a strip's row as loaded: with VEC16 one 4-byte word of 4
// neighbouring columns a lane, else a byte of each of its own cells.
template <bool VEC16>
__device__ __forceinline__ uint32_t load_mask(const uint8_t* __restrict__ row, int W, int xs) {
  const int lane = threadIdx.x & 31;
  if (VEC16) {
    const int x = xs + 4 * lane;
    return x < W ? *reinterpret_cast<const uint32_t*>(row + x) : 0u;
  }
  uint32_t bits = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int x = xs + 32 * g + lane;
    bits |= static_cast<uint32_t>(x < W && row[x]) << g;
  }
  return bits;
}

// Whether each of a lane's own cells is active, from load_mask(): with
// VEC16 the byte of cell lane + 32 g is byte lane % 4 of lane 8 g + lane / 4.
template <bool VEC16>
__device__ __forceinline__ void mask_groups(uint32_t word, bool (&d)[kGroups]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    if (VEC16) d[g] = (__shfl_sync(kFull, word, 8 * g + (lane >> 2)) >> (8 * (lane & 3))) & 0xffu;
    else d[g] = (word >> g) & 1u;
  }
}

// 2-D modes. Block b: a chunk of kChunkRows rows of slice t and kStripWarps
// strips, one per warp; slices stride over grid y. VEC16: W % 4 == 0 and
// every tensor aligned for 16-byte (labels, out) and 4-byte (mask) loads.
template <int MODE, bool VEC16>
__global__ void __launch_bounds__(kStripWarps * 32)
step2d_kernel(const int32_t* __restrict__ lab, const uint8_t* __restrict__ data, int32_t* out, int32_t* flag, int T,
              int H, int W, int wrap_x) {
  __shared__ __align__(16) int32_t buf[kStripWarps][kStrip];
  const int lane = threadIdx.x & 31;
  const int n_strips = (W + kStrip - 1) / kStrip;
  const int n_bstrips = (n_strips + kStripWarps - 1) / kStripWarps;
  const int strip = (blockIdx.x % n_bstrips) * kStripWarps + (threadIdx.x >> 5);
  if (strip >= n_strips) return;  // whole warps only
  int32_t* wbuf = buf[threadIdx.x >> 5];
  const int y0 = (blockIdx.x / n_bstrips) * kChunkRows;
  const int y1 = min(H, y0 + kChunkRows);
  const int xs = strip * kStrip;
  bool changed = false;

  for (long long t = blockIdx.y; t < T; t += gridDim.y) {
    const long long base = t * H * W;
    const int32_t* slice = lab + base;
    const uint8_t* mask = data + base;
    int32_t* dst = out + base;
    Row row, next;
    int32_t r0[kGroups], r1[kGroups], hp[kGroups], hc[kGroups], hn[kGroups];
    load_row<VEC16>(slice, y0 - 1, H, W, xs, wrap_x, row);
    to_groups<VEC16>(row.q, wbuf, r0);
    hmin3(r0, row.left, row.right, hp);
    load_row<VEC16>(slice, y0, H, W, xs, wrap_x, row);
    to_groups<VEC16>(row.q, wbuf, r1);
    hmin3(r1, row.left, row.right, hc);
    load_row<VEC16>(slice, y0 + 1, H, W, xs, wrap_x, next);
    uint32_t word = MODE != kPlain ? load_mask<VEC16>(mask + y0 * W, W, xs) : 0u;
    int32_t seen[kGroups];  // out of the row being finished, as loaded
    if (MODE == kStep2d) load_cells<VEC16>(dst + y0 * W, W, xs, 0, seen);
    for (int y = y0; y < y1; ++y) {
      // in flight while row y is finished: the labels of row y + 2, and the
      // mask and out of row y + 1 (out is read whatever the mask, so
      // neither load waits on the other)
      Row ahead;
      int32_t seen_n[kGroups];
      load_row<VEC16>(slice, y + 2, H, W, xs, wrap_x, ahead);
      const uint32_t word_n = MODE != kPlain && y + 1 < y1 ? load_mask<VEC16>(mask + (y + 1) * W, W, xs) : 0u;
      if (MODE == kStep2d) load_cells<VEC16>(y + 1 < y1 ? dst + (y + 1) * W : nullptr, W, xs, 0, seen_n);

      int32_t rn[kGroups];
      to_groups<VEC16>(next.q, wbuf, rn);
      hmin3(rn, next.left, next.right, hn);
      bool d[kGroups];
      mask_groups<VEC16>(word, d);
      int32_t own[kGroups];
      if (MODE == kStep2d) to_groups<VEC16>(seen, wbuf, own);
      int32_t m[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        m[g] = min(min(hp[g], hc[g]), hn[g]);
        if (MODE == kMasked && !d[g]) m[g] = kBig;
        const int i = y * W + xs + 32 * g + lane;
        if (MODE == kStep2d && d[g]) hook_cell(m[g], r1[g], i, own[g], dst + i, dst, changed);
      }
      if (MODE != kStep2d) store_cells<VEC16>(dst + y * W, W, xs, m, wbuf);
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        hp[g] = hc[g];
        hc[g] = hn[g];
        r1[g] = rn[g];
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g) seen[g] = seen_n[g];
      next = ahead;
      word = word_n;
    }
  }
  if (MODE == kStep2d && __any_sync(kFull, changed) && lane == 0) *flag = 1;
}

__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_prior() { asm volatile("cp.async.wait_group 1;\n" ::); }

// A 3-D tile in shared memory, two stages of kTileRows + 2 rows: slot
// 4 + c holds column xs + c of the strip (as column() gives it), slot 3
// the column left of the strip and slot 4 + kStrip the one right of it.
constexpr int kSlots = kStrip + 8;

struct Tile {
  alignas(16) int32_t row[2][kTileRows + 2][kSlots];
};

// Copy rows y0 - 1 .. y0 + kTileRows of plane p into stage s: 16-byte
// copies where a lane's four columns lie inside the row and the labels are
// aligned for them (VEC16), else 4-byte ones; BIG and the x wrap by stores.
template <bool VEC16>
__device__ __forceinline__ void issue_plane(Tile& tile, int s, const int32_t* __restrict__ lab, long long p, int H,
                                            int W, int y0, int xs, int wrap_x) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rr = warp; rr < kTileRows + 2; rr += kTileRows) {
    int32_t* dst = tile.row[s][rr];
    const int yy = y0 - 1 + rr;
    if (yy < 0 || yy >= H) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) dst[4 + 32 * g + lane] = kBig;
      if (lane == 0) dst[3] = kBig;
      if (lane == 31) dst[4 + kStrip] = kBig;
      continue;
    }
    const int32_t* src = lab + p * H * W + static_cast<long long>(yy) * W;
    if (VEC16) {
      const int x = xs + 4 * lane;
      if (x < W) {
        cp_async16(dst + 4 + 4 * lane, src + x);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[4 + 4 * lane + j] = column(src, x + j, W, wrap_x);
      }
    } else {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int x = xs + 32 * g + lane;
        if (x < W) cp_async4(dst + 4 + 32 * g + lane, src + x);
        else dst[4 + 32 * g + lane] = column(src, x, W, wrap_x);
      }
    }
    if (lane == 0) {
      if (xs > 0) cp_async4(dst + 3, src + xs - 1);
      else dst[3] = wrap_x ? src[W - 1] : kBig;
    }
    if (lane == 31) {
      if (xs + kStrip < W) cp_async4(dst + 4 + kStrip, src + xs + kStrip);
      else dst[4 + kStrip] = column(src, xs + kStrip, W, wrap_x);
    }
  }
}

// 3-D step. Block: a tile (row tile, strip) over grid x, chunks of
// kChunkPlanes planes over grid y; warp w takes tile row w.
template <bool VEC16>
__global__ void __launch_bounds__(kTileRows * 32)
step3d_kernel(const int32_t* __restrict__ lab, const uint8_t* __restrict__ data, int32_t* out, int32_t* flag, int T,
              int H, int W, int wrap_x) {
  __shared__ Tile tile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_strips = (W + kStrip - 1) / kStrip;
  const int xs = (blockIdx.x % n_strips) * kStrip;
  const int y0 = (blockIdx.x / n_strips) * kTileRows;
  const int y = y0 + warp;
  const int HW = H * W;  // T*H*W < 2**31: every flat index fits in 32 bits
  const int n_chunks = (T + kChunkPlanes - 1) / kChunkPlanes;
  bool changed = false;

  for (int c = blockIdx.y; c < n_chunks; c += gridDim.y) {
    const int t0 = c * kChunkPlanes;
    const int t1 = min(T, t0 + kChunkPlanes);
    const int K = t1 - t0 + 2;  // planes t0 - 1 .. t1
    if (t0 > 0) issue_plane<VEC16>(tile, 0, lab, t0 - 1, H, W, y0, xs, wrap_x);
    cp_async_commit();
    int32_t pa[kGroups], pb[kGroups], rb[kGroups];  // planar mins of planes p-2, p-1; labels of p-1
#pragma unroll
    for (int g = 0; g < kGroups; ++g) pa[g] = pb[g] = rb[g] = kBig;
    for (int k = 0; k < K; ++k) {
      const int p = t0 - 1 + k;
      if (k + 1 < K && p + 1 < T) issue_plane<VEC16>(tile, (k + 1) & 1, lab, p + 1, H, W, y0, xs, wrap_x);
      cp_async_commit();
      // the mask and out of plane p - 1, in flight during the wait (out read
      // whatever the mask, so neither load waits on the other)
      bool d[kGroups];
      int32_t seen[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int x = xs + 32 * g + lane;
        const int i = (p - 1) * HW + y * W + x;
        d[g] = k >= 2 && y < H && x < W && data[i];
        seen[g] = k >= 2 && y < H && x < W ? out[i] : kBig;
      }
      cp_async_wait_prior();
      __syncthreads();
      int32_t pc[kGroups], rc[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) pc[g] = rc[g] = kBig;
      if (p >= 0 && p < T) {
#pragma unroll
        for (int rr = 0; rr < 3; ++rr) {
          const int32_t* src = tile.row[k & 1][warp + rr] + 4 + lane;
#pragma unroll
          for (int g = 0; g < kGroups; ++g) {
            const int32_t v = src[32 * g];
            pc[g] = min(pc[g], min(min(src[32 * g - 1], v), src[32 * g + 1]));
            if (rr == 1) rc[g] = v;
          }
        }
      }
      __syncthreads();  // stage k & 1 is refilled at k + 1
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        if (d[g]) {
          const int i = (p - 1) * HW + y * W + xs + 32 * g + lane;
          hook_cell(min(min(pa[g], pb[g]), pc[g]), rb[g], i, seen[g], out + i, out, changed);
        }
        pa[g] = pb[g];
        pb[g] = pc[g];
        rb[g] = rc[g];
      }
    }
  }
  if (__any_sync(kFull, changed) && lane == 0) *flag = 1;
}

// Per-slice jump: block (x, y) takes tile x of slice y, kJumpTile
// contiguous cells; thread t takes cells t, t + 256, ... of the tile, all
// loaded before any is used, so each thread has 8 gathers in flight.
// Blocks resident at one time cover neighbouring tiles of one slice, which
// keeps a per-slice gather inside a few MB of L2. Both loops stride only
// past the grid's limits.
constexpr int kJumpThreads = 256;
constexpr int kJumpCells = 8;
constexpr long long kJumpTile = static_cast<long long>(kJumpThreads) * kJumpCells;
constexpr long long kMaxGridX = 2147483647;

__global__ void __launch_bounds__(kJumpThreads)
pointer_jump_kernel(const int32_t* __restrict__ lab, int32_t* __restrict__ out, long long n_slices,
                    long long slice_size) {
  const long long n_tiles = (slice_size + kJumpTile - 1) / kJumpTile;
  for (long long s = blockIdx.y; s < n_slices; s += gridDim.y) {
    const int32_t* base = lab + s * slice_size;
    int32_t* dst = out + s * slice_size;
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long long c0 = tile * kJumpTile + threadIdx.x;
      int32_t v[kJumpCells];
#pragma unroll
      for (int j = 0; j < kJumpCells; ++j) {
        const long long c = c0 + j * kJumpThreads;
        v[j] = c < slice_size ? base[c] : kBig;
      }
#pragma unroll
      for (int j = 0; j < kJumpCells; ++j) {
        const long long c = c0 + j * kJumpThreads;
        if (c < slice_size) dst[c] = v[j] == kBig ? kBig : min(v[j], base[v[j]]);
      }
    }
  }
}

int launch_step(const int32_t* lab, const uint8_t* data, int32_t* out, int32_t* flag, int T, int H, int W, int mode,
                int wrap_x, cudaStream_t stream) {
  const unsigned n_strips = (W + kStrip - 1) / kStrip;
  // 16-byte loads and stores of labels and out, 4-byte loads of the mask
  const bool vec16 = W % 4 == 0 && reinterpret_cast<uintptr_t>(lab) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0 && reinterpret_cast<uintptr_t>(data) % 4 == 0;
  if (mode == kStep3d) {
    const int n_chunks = (T + kChunkPlanes - 1) / kChunkPlanes;
    const dim3 grid(n_strips * ((H + kTileRows - 1) / kTileRows),
                    static_cast<unsigned>(n_chunks < kMaxGridY ? n_chunks : kMaxGridY));
    if (vec16)
      step3d_kernel<true><<<grid, kTileRows * 32, 0, stream>>>(lab, data, out, flag, T, H, W, wrap_x);
    else
      step3d_kernel<false><<<grid, kTileRows * 32, 0, stream>>>(lab, data, out, flag, T, H, W, wrap_x);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((n_strips + kStripWarps - 1) / kStripWarps * ((H + kChunkRows - 1) / kChunkRows),
                  static_cast<unsigned>(T < kMaxGridY ? T : kMaxGridY));
  const auto kernel = mode == kPlain    ? (vec16 ? step2d_kernel<kPlain, true> : step2d_kernel<kPlain, false>)
                      : mode == kMasked ? (vec16 ? step2d_kernel<kMasked, true> : step2d_kernel<kMasked, false>)
                                        : (vec16 ? step2d_kernel<kStep2d, true> : step2d_kernel<kStep2d, false>);
  kernel<<<grid, kStripWarps * 32, 0, stream>>>(lab, data, out, flag, T, H, W, wrap_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 plain 3x3 min, 1 masked 3x3 min (both store into out), 2 the
// fused 2-D step, 3 the fused 3-D step (both lower out by atomicMin and set
// *flag on a change; out must be >= m on entry). flag may be null in modes
// 0 and 1, data in mode 0. Modes 2 and 3 need T*H*W < 2**31 in 3-D and
// H*W < 2**31 always.
extern "C" int marex_ccl_step(const int32_t* lab, const uint8_t* data, int32_t* out, int32_t* flag, int T, int H,
                              int W, int mode, int wrap_x, void* stream) {
  if (T <= 0 || H <= 0 || W <= 0 || mode < kPlain || mode > kStep3d) return static_cast<int>(cudaErrorInvalidValue);
  return launch_step(lab, data, out, flag, T, H, W, mode, wrap_x, static_cast<cudaStream_t>(stream));
}

extern "C" int marex_pointer_jump(const int32_t* lab, int32_t* out, long long n_slices, long long slice_size,
                                  void* stream) {
  if (n_slices <= 0 || slice_size <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (slice_size + kJumpTile - 1) / kJumpTile;
  const dim3 grid(static_cast<unsigned>(n_tiles < kMaxGridX ? n_tiles : kMaxGridX),
                  static_cast<unsigned>(n_slices < kMaxGridY ? n_slices : kMaxGridY));
  pointer_jump_kernel<<<grid, kJumpThreads, 0, static_cast<cudaStream_t>(stream)>>>(lab, out, n_slices, slice_size);
  return static_cast<int>(cudaGetLastError());
}
