// Connected-component labelling (CCL) propagation kernels for Hopper (sm_90a).
//
// marex_min_stencil replaces the Pallas TPU kernel
// marex_tpu/ops/pallas_kernels.py:min_stencil_pallas (bodies
// _stencil_kernel_masked / _stencil_kernel_plain / _min9_block): the 3x3
// neighbourhood min of (T, H, W) int32 labels, periodic in x (or BIG beyond
// the x edges when wrap_x == 0), BIG beyond the y edges, and with masked != 0
// BIG wherever data is false. It is the propagation step of both fixpoint
// CCLs of the port: masked for the per-slice labelling, plain (then a +-1
// time min in PyTorch) for the 3-D event labelling.
//
// marex_hook is the hooking step that makes those fixpoints converge in a
// few iterations instead of one per cell of the longest path: every cell
// whose new label m is below its old label r lowers the label of cell r
// (the cell its old label names) to m, by atomicMin into a copy of m. The
// reference accelerates the same fixpoints with segmented-min sweeps
// (marex_tpu/ops/label.py:_segmented_min_sweep). It reads lab and m only and
// writes atomically into out, so its result does not depend on the order of
// the atomics: it equals its plain PyTorch version bit for bit.
//
// marex_pointer_jump is the pointer-jumping hop of those fixpoints,
// out = min(lab, lab[base + lab]) per slice, with BIG left as BIG
// (marex_tpu/ops/label.py:_jump, an XLA gather in the reference). It runs
// out of place so that its result is deterministic and equal, bit for bit,
// to its plain PyTorch version.
//
// What bounds them on an H100: none does arithmetic worth counting. A
// masked stencil pass over the production field (1095 x 720 x 1440 cells)
// reads 4.54 GB of labels and 1.14 GB of mask and writes 4.54 GB: about 3 ms
// at the data sheet's 3.35 TB/s, so the pass is bound by device memory
// bandwidth. The design keeps the one pass: one thread per output cell,
// neighbouring threads on neighbouring x, so every load and the store are
// coalesced; the three rows a cell reads are shared with its neighbours
// through L1/L2 instead of shared memory. An inactive cell of the masked
// mode reads no labels at all. The jump and the hook read two label arrays
// in one coalesced pass plus one gather or atomic per active cell; the
// atomics of the hook meet on a component's root cell, which bounds it when
// large components are still merging. Tiling the stencil's halo through
// shared memory (or TMA) and fusing the steps of an iteration into fewer
// passes is later work.
//
// All entry points launch on the caller's stream, never synchronise,
// allocate nothing, and return cudaGetLastError() of the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int32_t kBig = 2147483647;
constexpr int kThreads = 256;
constexpr int kCellsPerThread = 8;
constexpr long long kTile = static_cast<long long>(kThreads) * kCellsPerThread;
constexpr long long kMaxGridX = 2147483647;
constexpr long long kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
min_stencil_kernel(const int32_t* __restrict__ lab, const uint8_t* __restrict__ data, int32_t* __restrict__ out,
                   int H, int W, long long rows, int masked, int wrap_x) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= W) return;
  int xl = x - 1;
  int xr = x + 1;
  bool has_l = xl >= 0;
  bool has_r = xr < W;
  if (wrap_x) {
    if (!has_l) xl = W - 1;
    if (!has_r) xr = 0;
    has_l = has_r = true;
  }
  // one block row per (t, y) image row; grid-stride over rows
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long i = r * W + x;
    if (masked && !data[i]) {
      out[i] = kBig;
      continue;
    }
    const int y = static_cast<int>(r % H);
    int32_t m = kBig;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const int yy = y + dy;
      if (yy < 0 || yy >= H) continue;
      const int32_t* row = lab + (r + dy) * W;
      m = min(m, row[x]);
      if (has_l) m = min(m, row[xl]);
      if (has_r) m = min(m, row[xr]);
    }
    out[i] = m;
  }
}

// Per-slice kernels: block (x, y) takes tile x of slice y, kTile contiguous
// cells; thread t takes cells t, t + kThreads, ... of the tile, all loaded
// before any is used, so each thread has kCellsPerThread gathers or atomics
// in flight. Blocks resident at one time cover neighbouring tiles of one
// slice, which keeps a per-slice gather inside a few MB of L2. Both loops
// stride only past the grid's limits.
__global__ void __launch_bounds__(kThreads)
pointer_jump_kernel(const int32_t* __restrict__ lab, int32_t* __restrict__ out, long long n_slices,
                    long long slice_size) {
  const long long n_tiles = (slice_size + kTile - 1) / kTile;
  for (long long s = blockIdx.y; s < n_slices; s += gridDim.y) {
    const int32_t* base = lab + s * slice_size;
    int32_t* dst = out + s * slice_size;
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long long c0 = tile * kTile + threadIdx.x;
      int32_t v[kCellsPerThread];
#pragma unroll
      for (int j = 0; j < kCellsPerThread; ++j) {
        const long long c = c0 + j * kThreads;
        v[j] = c < slice_size ? base[c] : kBig;
      }
#pragma unroll
      for (int j = 0; j < kCellsPerThread; ++j) {
        const long long c = c0 + j * kThreads;
        if (c < slice_size) dst[c] = v[j] == kBig ? kBig : min(v[j], base[v[j]]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
hook_kernel(const int32_t* __restrict__ lab, const int32_t* __restrict__ m, int32_t* out, long long n_slices,
            long long slice_size) {
  const long long n_tiles = (slice_size + kTile - 1) / kTile;
  for (long long s = blockIdx.y; s < n_slices; s += gridDim.y) {
    const long long base = s * slice_size;
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const long long c0 = base + tile * kTile + threadIdx.x;
      const long long end = base + slice_size;
      int32_t r[kCellsPerThread];
      int32_t v[kCellsPerThread];
#pragma unroll
      for (int j = 0; j < kCellsPerThread; ++j) {
        const long long c = c0 + j * kThreads;
        r[j] = c < end ? lab[c] : kBig;
        v[j] = r[j] != kBig ? m[c] : kBig;
      }
#pragma unroll
      for (int j = 0; j < kCellsPerThread; ++j) {
        if (v[j] < r[j]) atomicMin(out + base + r[j], v[j]);
      }
    }
  }
}

// Grid for the per-slice entry points, one rule for every slice count: one
// block per tile, one row of blocks per slice.
dim3 slice_grid(long long n_slices, long long slice_size) {
  const long long n_tiles = (slice_size + kTile - 1) / kTile;
  return dim3(static_cast<unsigned>(n_tiles < kMaxGridX ? n_tiles : kMaxGridX),
              static_cast<unsigned>(n_slices < kMaxGridY ? n_slices : kMaxGridY));
}

}  // namespace

extern "C" int marex_min_stencil(const int32_t* lab, const uint8_t* data, int32_t* out, int T, int H, int W,
                                 int masked, int wrap_x, void* stream) {
  if (T <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(T) * H;
  const dim3 grid((W + kThreads - 1) / kThreads, static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
  min_stencil_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(lab, data, out, H, W, rows, masked,
                                                                                wrap_x);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int marex_pointer_jump(const int32_t* lab, int32_t* out, long long n_slices, long long slice_size,
                                  void* stream) {
  if (n_slices <= 0 || slice_size <= 0) return static_cast<int>(cudaErrorInvalidValue);
  pointer_jump_kernel<<<slice_grid(n_slices, slice_size), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lab, out, n_slices, slice_size);
  return static_cast<int>(cudaGetLastError());
}

// out must hold a copy of m on entry
extern "C" int marex_hook(const int32_t* lab, const int32_t* m, int32_t* out, long long n_slices, long long slice_size,
                          void* stream) {
  if (n_slices <= 0 || slice_size <= 0) return static_cast<int>(cudaErrorInvalidValue);
  hook_kernel<<<slice_grid(n_slices, slice_size), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lab, m, out, n_slices, slice_size);
  return static_cast<int>(cudaGetLastError());
}
