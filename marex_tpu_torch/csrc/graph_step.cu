// Connected-component labelling on an unstructured mesh for Hopper (sm_90a).
//
// marex_graph_step is the mesh counterpart of marex_ccl_step (min_stencil.cu):
// one fixpoint iteration's propagation fused with the hook and the
// convergence flag, on (T, C) int32 labels and a (K, C) int32 neighbour table
// shared by all T slices (0-based cell indices, -1 = no neighbour). It
// replaces the gather-min of marex_tpu/ops/label.py:_unstr_block (an XLA
// gather in the reference, lab[:, nb_idx] then a min over K), which the
// reference iterated without a hook, a label moving one cell an iteration.
//
// For every active cell c of slice t:
//   m = min(lab[t, c], lab[t, n] for each valid neighbour n of c)
// (an inactive neighbour holds BIG and drops out of the min), then the hook:
// out[t, c] is lowered to m and, when m < r for the cell's old label r, so
// is out[t, r], the cell its old label names. Labels are BIG or a cell index
// inside the slice. out is written by atomicMin only and must hold a field
// >= m on entry (BIG-filled, or the previous iteration's hooked field, which
// is >= the next m because labels only fall); then the result is exactly
// min(m, the hooks aimed at the cell), whatever the order of the atomics: the
// contract of marex_ccl_step, so the same ping-pong fixpoint drives both.
// *flag is set when some active cell had m < lab, which is exactly "this
// iteration changes the labels".
//
// What bounds it on an H100: bytes. Per cell and slice it must read the label
// (4 B) and the mask (1 B) and write out (4 B), 9 B; the table (4 K bytes a
// cell, 12.6 MB at 1M cells and K = 3) is read from device memory once and
// then sits in the 50 MB L2 for the other slices. The neighbour gathers add
// up to 4 K B a cell of L2 or device traffic, depending on how local the
// mesh's numbering is. The design: one thread a cell, a block of 256
// neighbouring cells marching through chunks of kChunkSlices slices, so that
// a block's table rows stay in L1 across its slices and its label, mask and
// out accesses are coalesced; a chunk's mask bytes are loaded together before
// any is looked at; the table is read through the read-only path;
// atomics only where they change something (the reads before them may be
// stale, but out only falls); the flag is a warp vote and one store a warp.
//
// Launches on the caller's stream, never synchronises, allocates nothing,
// and returns cudaGetLastError() of the launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int32_t kBig = 2147483647;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kChunkSlices = 8;
constexpr long long kMaxGridY = 65535;
// blocks a launch aims for: a few waves of the card's 132 SMs at 8 blocks an
// SM. A block then walks several chunks of slices over the same cells (a
// launch of one block a chunk spent most of its time starting blocks)
constexpr long long kTargetBlocks = 132 * 8 * 8;

__global__ void __launch_bounds__(kThreads)
graph_step_kernel(const int32_t* __restrict__ lab, const uint8_t* __restrict__ data, const int32_t* __restrict__ nb,
                  int32_t* out, int32_t* flag, int T, int C, int K) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  bool changed = false;
  if (c < C) {
    const int n_chunks = (T + kChunkSlices - 1) / kChunkSlices;
    for (int chunk = blockIdx.y; chunk < n_chunks; chunk += gridDim.y) {
      const int t0 = chunk * kChunkSlices;
      // the chunk's mask bytes first, as independent loads: most cells of a
      // real field are inactive, and one load a slice, each waited for
      // before the next, leaves the kernel bound by latency
      uint8_t active[kChunkSlices];
#pragma unroll
      for (int i = 0; i < kChunkSlices; ++i) {
        active[i] = t0 + i < T ? data[static_cast<long long>(t0 + i) * C + c] : 0;
      }
#pragma unroll
      for (int i = 0; i < kChunkSlices; ++i) {
        if (!active[i]) continue;
        const long long base = static_cast<long long>(t0 + i) * C;
        const int32_t* slice = lab + base;
        const int32_t r = slice[c];
        int32_t m = r;
        for (int k = 0; k < K; ++k) {
          const int32_t n = __ldg(nb + static_cast<long long>(k) * C + c);
          if (n >= 0) m = min(m, slice[n]);
        }
        int32_t* dst = out + base;
        if (m < r) {
          changed = true;
          if (r != kBig && r != c && dst[r] > m) atomicMin(dst + r, m);
        }
        if (m < dst[c]) atomicMin(dst + c, m);
      }
    }
  }
  if (__any_sync(kFull, changed) && (threadIdx.x & 31) == 0) *flag = 1;
}

}  // namespace

// lab, out: (T, C) int32; data: (T, C) bytes (0 = inactive); nb: (K, C) int32,
// entries in [0, C) or negative; flag: one int32. out must be >= the step's
// minimum on entry and is lowered in place.
extern "C" int marex_graph_step(const int32_t* lab, const uint8_t* data, const int32_t* nb, int32_t* out,
                                int32_t* flag, int T, int C, int K, void* stream) {
  if (T <= 0 || C <= 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_chunks = (static_cast<long long>(T) + kChunkSlices - 1) / kChunkSlices;
  const long long grid_x = (static_cast<long long>(C) + kThreads - 1) / kThreads;
  long long grid_y = (kTargetBlocks + grid_x - 1) / grid_x;
  if (grid_y > n_chunks) grid_y = n_chunks;
  if (grid_y > kMaxGridY) grid_y = kMaxGridY;
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y));
  graph_step_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(lab, data, nb, out, flag, T, C, K);
  return static_cast<int>(cudaGetLastError());
}
