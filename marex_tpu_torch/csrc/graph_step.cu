// Connected-component labelling on an unstructured mesh for Hopper (sm_90a).
//
// The mesh fixpoint (ops/label.py:label_slices_unstructured) works on (T, C)
// int32 labels, a (K, C) int32 neighbour table shared by all T slices
// (0-based cell indices, -1 = no neighbour), and the list of the field's
// active cells, made once a fixpoint: int64 flat indices t * C + c,
// ascending, so slice-major and ascending in the cell. 64 bits because T * C
// passes 2**31 - 1 on long series (2049 days of a 1M-cell mesh); a kernel
// splits an entry into its slice base t * C and its cell c with a float64
// reciprocal of C and one correction (slice_base below), exact for entries
// below 2**52. The mask is never read inside the loop: an inactive cell gets
// no thread and is never written, and is read only as a neighbour, where it
// holds BIG (both label buffers start BIG there, and a hook only targets the
// cell an active label names, which is an active cell of the same slice).
//
// marex_count_active and marex_write_active make that list from the (T, C)
// mask, once a fixpoint (the set-up of the loop, not a port of a TPU
// kernel): one block a tile of 4096 mask bytes, 16 a thread in one 16-byte
// load, a block scan of the per-thread counts; the first launch writes each
// tile's count, the caller's prefix sum places the tiles, the second
// launch writes each tile's entries in order, reading again only the tiles
// that hold some. Bound: the mask read once and 8 B an entry written; it
// reads the mask once, and a second time in the tiles that hold an active
// cell. torch.nonzero, which it replaces, takes 1.84 ms on config 5's
// 765M-cell mask (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W).
//
// marex_graph_step is the mesh counterpart of marex_ccl_step (min_stencil.cu):
// one fixpoint iteration's propagation fused with the hook and the
// convergence flag. It replaces the gather-min of
// marex_tpu/ops/label.py:_unstr_block (an XLA gather in the reference,
// lab[:, nb_idx] then a min over K), which the reference iterated without a
// hook, a label moving one cell an iteration. For every listed cell c of
// slice t:
//   m = min(lab[t, c], lab[t, n] for each valid neighbour n of c)
// then the hook: out[t, c] is lowered to m and, when m < r for the cell's old
// label r, so is out[t, r], the cell its old label names. Labels are BIG or a
// cell index inside the slice. out is written by atomicMin only and must hold
// a field >= m on entry (BIG-filled, or the previous iteration's hooked
// field, which is >= the next m because labels only fall); then the result is
// exactly min(m, the hooks aimed at the cell), whatever the order of the
// atomics: the contract of marex_ccl_step, so the same ping-pong fixpoint
// drives both. *flag is set when some listed cell had m < lab, which is
// exactly "this iteration changes the labels".
//
// marex_graph_jump is the mesh fixpoint's pointer jump (the reference's
// marex_tpu/ops/label.py:_jump, which the grid serves with the whole-field
// marex_pointer_jump): a[t, c] = min(v, b[t, v]) for v = b[t, c] != BIG (BIG
// stays BIG), for the listed cells only; a's other cells are not touched.
//
// What bounds them on an H100: bytes of the active cells. A step must read
// each active cell's label and lower its out (8 B), a jump read b and write a
// (8 B); the table (4 K bytes a cell, 12.6 MB at 1M cells and K = 3) is read
// once and then sits in the 50 MB L2. The list adds 8 B an entry to each
// launch, the neighbour gathers and hook targets up to 4 (K + 1) B of L2 or
// device traffic, depending on how local the mesh's numbering is. A dense
// walk over every cell read the mask for all T * C cells every iteration,
// 35 times an active cell's bytes on a field 2.8 % active. The design: a
// grid-stride loop over the list sized to the card (132 SMs x the blocks that
// fit), each thread taking kPer entries a step of the loop, all loaded before
// any is used, so that a thread has kPer chains of dependent loads (list,
// label, table, gathers) in flight; consecutive threads take consecutive
// entries, so list, label and out accesses are coalesced and, on a local
// numbering, a warp's gathers share L2 lines; the table is read through the
// read-only path; atomics only where they change something (the reads before
// them may be stale, but out only falls); the flag is a warp vote and one
// store a warp. What holds them on config 5's field (chip_smoke.py phase 6,
// NVIDIA H100 80GB HBM3 at 700 W): a step takes 0.30-0.33 ms and a jump
// 0.26-0.27 ms against 0.054 and 0.051 ms of bytes, while moving the same
// cells' labels from one buffer to the other with torch.take and index_put_
// takes 0.38 ms: the active cells' scatter over the (T, C) buffers, not the
// arithmetic, sets the time; with the cells renumbered at random a step takes
// about 10 times as long and a jump 4-6 times.
//
// All launch on the caller's stream, never synchronise, allocate nothing,
// and return cudaGetLastError() of the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int32_t kBig = 2147483647;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kPer = 4;
constexpr long long kTile = static_cast<long long>(kThreads) * kPer;

// The list's compaction: kCompactBytes mask bytes a tile, one block a tile,
// 16 bytes a thread (one 16-byte load where the mask is aligned)
constexpr int kCompactBytes = kThreads * 16;

// which of the 16 mask bytes from `at` are nonzero, as a 16-bit set (bit j:
// byte at + j; bytes past n are zero)
__device__ __forceinline__ unsigned mask_bits(const uint8_t* __restrict__ mask, long long n, long long at, bool vec) {
  unsigned bits = 0;
  if (vec && at + 16 <= n) {
    const uint4 w = *reinterpret_cast<const uint4*>(mask + at);
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned ne = __vcmpne4(words[q], 0u);  // 0xff in each nonzero byte
#pragma unroll
      for (int j = 0; j < 4; ++j) bits |= ((ne >> (8 * j)) & 1u) << (4 * q + j);
    }
  } else {
    for (int j = 0; j < 16; ++j) {
      if (at + j < n && mask[at + j]) bits |= 1u << j;
    }
  }
  return bits;
}

// exclusive prefix of v over the block's threads, and the block's total
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    before += w < warp ? warp_sums[w] : 0;
    all += warp_sums[w];
  }
  *total = all;
  return before + x - v;
}

__global__ void __launch_bounds__(kThreads)
count_active_kernel(const uint8_t* __restrict__ mask, long long n, long long* __restrict__ counts, bool vec) {
  const long long at = static_cast<long long>(blockIdx.x) * kCompactBytes + threadIdx.x * 16;
  int total;
  block_exclusive_scan(__popc(mask_bits(mask, n, at, vec)), &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
write_active_kernel(const uint8_t* __restrict__ mask, long long n, const long long* __restrict__ ends,
                    long long* __restrict__ active, bool vec) {
  const long long begin = blockIdx.x ? ends[blockIdx.x - 1] : 0;
  if (ends[blockIdx.x] == begin) return;  // an empty tile: its mask is not read again
  const long long at = static_cast<long long>(blockIdx.x) * kCompactBytes + threadIdx.x * 16;
  unsigned bits = mask_bits(mask, n, at, vec);
  int total;
  const int before = block_exclusive_scan(__popc(bits), &total);
  long long* dst = active + begin + before;
  while (bits) {
    const int j = __ffs(bits) - 1;
    *dst++ = at + j;
    bits &= bits - 1;
  }
}

// t * C for the flat index f = t * C + c, 0 <= c < C: the float64 quotient
// is within 1 of t for f < 2**52, so one correction makes it exact
__device__ __forceinline__ long long slice_base(long long f, int C, double inv_c) {
  long long base = static_cast<long long>(static_cast<double>(f) * inv_c) * C;
  if (base > f) base -= C;
  else if (f - base >= C) base += C;
  return base;
}

__global__ void __launch_bounds__(kThreads)
graph_step_kernel(const int32_t* __restrict__ lab, const long long* __restrict__ active, long long n,
                  const int32_t* __restrict__ nb, int32_t* out, int32_t* flag, int C, int K, double inv_c) {
  bool changed = false;
  for (long long tile = blockIdx.x; tile * kTile < n; tile += gridDim.x) {
    long long f[kPer], base[kPer];
    int c[kPer];
    int32_t r[kPer], m[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long i = tile * kTile + j * kThreads + threadIdx.x;
      f[j] = i < n ? active[i] : -1;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (f[j] < 0) continue;
      base[j] = slice_base(f[j], C, inv_c);
      c[j] = static_cast<int>(f[j] - base[j]);
      r[j] = lab[f[j]];
      m[j] = r[j];
    }
    for (int k = 0; k < K; ++k) {
      int32_t nbr[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) nbr[j] = f[j] < 0 ? -1 : __ldg(nb + static_cast<long long>(k) * C + c[j]);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (nbr[j] >= 0) m[j] = min(m[j], lab[base[j] + nbr[j]]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (f[j] < 0) continue;
      int32_t* dst = out + base[j];
      if (m[j] < r[j]) {
        changed = true;
        if (r[j] != kBig && r[j] != c[j] && dst[r[j]] > m[j]) atomicMin(dst + r[j], m[j]);
      }
      if (m[j] < dst[c[j]]) atomicMin(dst + c[j], m[j]);
    }
  }
  if (__any_sync(kFull, changed) && (threadIdx.x & 31) == 0) *flag = 1;
}

__global__ void __launch_bounds__(kThreads)
graph_jump_kernel(const int32_t* __restrict__ b, const long long* __restrict__ active, long long n,
                  int32_t* __restrict__ a, int C, double inv_c) {
  for (long long tile = blockIdx.x; tile * kTile < n; tile += gridDim.x) {
    long long f[kPer];
    int32_t v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long i = tile * kTile + j * kThreads + threadIdx.x;
      f[j] = i < n ? active[i] : -1;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[j] = f[j] < 0 ? kBig : b[f[j]];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (f[j] < 0) continue;
      a[f[j]] = v[j] == kBig ? kBig : min(v[j], b[slice_base(f[j], C, inv_c) + v[j]]);
    }
  }
}

// blocks of `kernel` that keep the card's SMs full, or fewer when the list
// is short; 0 on an error (cudaGetLastError() then reports it)
template <typename Kernel>
unsigned grid_for(Kernel kernel, long long n) {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess)
    return 0;
  const long long tiles = (n + kTile - 1) / kTile;
  const long long fit = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<unsigned>(tiles < fit ? tiles : fit);
}

}  // namespace

// The list of a mask's n bytes that are nonzero, ascending, in two launches
// around a prefix sum: marex_count_active writes each tile's count into
// counts[(n + kCompactBytes - 1) / kCompactBytes]; the caller turns them into
// their inclusive prefix sums, ends; marex_write_active writes the tile's
// flat indices into active[ends[tile - 1] ..] (16-byte loads where the
// mask is aligned), skipping the empty tiles.
extern "C" long long marex_active_tiles(long long n) { return (n + kCompactBytes - 1) / kCompactBytes; }

extern "C" int marex_count_active(const uint8_t* mask, long long n, long long* counts, void* stream) {
  if (n <= 0 || marex_active_tiles(n) > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  count_active_kernel<<<static_cast<unsigned>(marex_active_tiles(n)), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(mask, n, counts, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int marex_write_active(const uint8_t* mask, long long n, const long long* ends, long long* active,
                                  void* stream) {
  if (n <= 0 || marex_active_tiles(n) > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  write_active_kernel<<<static_cast<unsigned>(marex_active_tiles(n)), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(mask, n, ends, active, vec);
  return static_cast<int>(cudaGetLastError());
}

// lab, out: (T, C) int32; active: n ascending int64 flat indices t * C + c of
// the cells to step, each below 2**52; nb: (K, C) int32, entries in [0, C)
// or negative; flag: one int32. out must be >= the step's minimum on entry
// and is lowered in place. n == 0 launches nothing.
extern "C" int marex_graph_step(const int32_t* lab, const long long* active, long long n, const int32_t* nb,
                                int32_t* out, int32_t* flag, int C, int K, void* stream) {
  if (n < 0 || C <= 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = grid_for(graph_step_kernel, n);
  if (grid == 0) return static_cast<int>(cudaGetLastError());
  graph_step_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(lab, active, n, nb, out, flag, C, K,
                                                                               1.0 / C);
  return static_cast<int>(cudaGetLastError());
}

// b, a: distinct (T, C) int32 buffers; active as for marex_graph_step. Writes
// a at the listed cells only. n == 0 launches nothing.
extern "C" int marex_graph_jump(const int32_t* b, const long long* active, long long n, int32_t* a, int C,
                                void* stream) {
  if (n < 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const unsigned grid = grid_for(graph_jump_kernel, n);
  if (grid == 0) return static_cast<int>(cudaGetLastError());
  graph_jump_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(b, active, n, a, C, 1.0 / C);
  return static_cast<int>(cudaGetLastError());
}
