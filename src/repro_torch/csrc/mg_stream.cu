// Streamed (windowed) sketch fold kernels for Hopper (sm_90a): the fused
// kernels' four folds over the windowed layout of a StreamedFoldPlan.
//
// K5 mg_stream_fold_kernel replaces the TPU kernel
//    src/repro/kernels/mg_sketch/streaming.py:_stream_fold_kernel: one
//    launch per fold round; row slot s of window w folds its entries into
//    a k-slot weighted MG sketch.
// K6 mg_stream_select_kernel replaces the TPU kernel
//    src/repro/kernels/mg_sketch/streaming.py:_stream_select_kernel: the
//    last round's fold, then the move selection.
// K7 mg_stream_bm_kernel replaces the TPU kernel
//    src/repro/kernels/mg_sketch/streaming.py:_stream_bm_kernel: round 0
//    only, a weighted Boyer-Moore scan per row slot from its incumbent.
// K8 mg_stream_rescan_kernel replaces the TPU kernel
//    src/repro/kernels/mg_sketch/streaming.py:_stream_rescan_kernel: the
//    rescan second pass over round 0's windows.
//
// Addressing. A round is n_windows windows of W entry slots and tile_r row
// slots: window w owns entry slots [w*W, (w+1)*W) and row slots
// [w*tile_r, (w+1)*tile_r); row_start is window-relative. Row slot s of
// window w reads exactly row_count[w*tile_r + s] entries from
// (int64) w*W + row_start[w*tile_r + s]: the base is int64 because
// n_windows*W passes 2^31 on large graphs (272.8 M slots on round 0 of the
// 2^22-vertex smoke graph, past 2^31 at 2^25). Outputs are in row-slot
// order.
//
// Design. One block per window. K5 folds a row slot with a group of K
// lanes, lane j owning sketch slot j (sketch_rows.cuh:mg_fold_group, as
// K1 in mg_fused.cu): the block's groups stride over the window's tile_r
// row slots, 128 / K slots per pass (blockDim = tile_r * K rounded up to
// a whole warp, at most 128). A group reads its row in chunks of K
// contiguous entries with the next chunk's load in flight, broadcasts each
// entry to its lanes, and two ballots over the slots' state pick the
// branch each lane applies to its own slot: lane j performs slot j's
// float32 operations of the reference, in entry order, so the sketches
// are bit-identical to the reference and to the fused engine. Lane j
// stores out[slot*K + j]: a warp writes 128 contiguous bytes of labels
// and of weights per store instruction. Staging the window's occupied
// prefix through shared memory is not needed: a group reads each real
// entry of its row once, in whole sectors, and never a pad slot past the
// window's last row. K6-K8 keep one thread per row slot (blockDim =
// min(tile_r, 128); every plan the package builds has tile_r = 128) on
// the fused kernels' per-row bodies, the reference's float32 sequence
// too. The TPU kernel's window blocks, pad lanes and per-window loop
// bound (step_dmax) are tiling devices: no thread reads a pad slot. Pad
// row slots (row_count == 0) fold nothing: K5 writes (-1, 0.0f), K6 the
// incumbent, K7 (init, 0.0f), K8 zeros.
//
// Bound on the H100. Bytes, as for K1-K4: the kernels read only real
// entries (8 B each), so their bytes bounds equal the fused kernels'
// (K5: 2.74 GB over its four rounds at 2^22, 0.819 ms at 3.35 TB/s).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 (700 W), 2^22
// vertices: K5 takes 2.458 ms per iteration, 33.3% of that bound (round 0
// 1.050 ms, rounds 1-3 0.45-0.48 ms), against 3.281 ms for the
// thread-per-row version it replaced. Within a window round 0's rows stay
// in vertex order, so a warp's loop runs to the longest of its rows.
// What the windowed layout adds is outside the kernels: the re-layout
// gather of every unaligned round (windowed_entries, plain torch), which
// writes n_windows*W padded slots per round.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sketch_rows.cuh"

namespace {

using sketch_rows::bm_fold_row;
using sketch_rows::mg_fold_group;
using sketch_rows::mg_fold_row;
using sketch_rows::rescan_row;
using sketch_rows::select_row;

constexpr int kMaxThreadsPerBlock = 128;

// K5: the block's groups of K lanes stride over the window's row slots.
// The pass loop is block-uniform; a group past tile_r folds count 0 and
// stores nothing (it must still run the group fold: full-warp shuffles).
template <int K>
__global__ void __launch_bounds__(kMaxThreadsPerBlock)
mg_stream_fold_kernel(const int* __restrict__ row_start,
                      const int* __restrict__ row_count,
                      const int* __restrict__ wlab,
                      const float* __restrict__ wwgt,
                      int* __restrict__ out_k, float* __restrict__ out_v,
                      int tile_r, int64_t window_entries) {
  const int64_t w = blockIdx.x;
  const int64_t base = w * window_entries;
  const int group = static_cast<int>(threadIdx.x) / K;
  const int per_pass = static_cast<int>(blockDim.x) / K;
  for (int s0 = 0; s0 < tile_r; s0 += per_pass) {
    const int s = s0 + group;
    const bool real = s < tile_r;
    const int64_t slot = w * tile_r + s;
    const int64_t e = real ? base + row_start[slot] : 0;
    int lab;
    float val;
    mg_fold_group<K>(wlab + e, wwgt + e, real ? row_count[slot] : 0, lab,
                     val);
    if (real) {
      const int64_t o = slot * K + (threadIdx.x & (K - 1));
      out_k[o] = lab;
      out_v[o] = val;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kMaxThreadsPerBlock)
mg_stream_select_kernel(const int* __restrict__ row_start,
                        const int* __restrict__ row_count,
                        const int* __restrict__ incumbents, int seed,
                        const int* __restrict__ wlab,
                        const float* __restrict__ wwgt,
                        int* __restrict__ out_c, int tile_r,
                        int64_t window_entries) {
  const int64_t w = blockIdx.x;
  const int64_t base = w * window_entries;
  for (int s = threadIdx.x; s < tile_r; s += blockDim.x) {
    const int64_t slot = w * tile_r + s;
    const int64_t e = base + row_start[slot];
    int lab[K];
    float val[K];
    mg_fold_row<K>(wlab + e, wwgt + e, row_count[slot], lab, val);
    out_c[slot] = select_row<K>(lab, val, incumbents[slot], seed);
  }
}

__global__ void __launch_bounds__(kMaxThreadsPerBlock)
mg_stream_bm_kernel(const int* __restrict__ row_start,
                    const int* __restrict__ row_count,
                    const int* __restrict__ init,
                    const int* __restrict__ wlab,
                    const float* __restrict__ wwgt,
                    int* __restrict__ out_c, float* __restrict__ out_w,
                    int tile_r, int64_t window_entries) {
  const int64_t w = blockIdx.x;
  const int64_t base = w * window_entries;
  for (int s = threadIdx.x; s < tile_r; s += blockDim.x) {
    const int64_t slot = w * tile_r + s;
    const int64_t e = base + row_start[slot];
    bm_fold_row(wlab + e, wwgt + e, row_count[slot], init[slot],
                out_c + slot, out_w + slot);
  }
}

template <int K>
__global__ void __launch_bounds__(kMaxThreadsPerBlock)
mg_stream_rescan_kernel(const int* __restrict__ row_start,
                        const int* __restrict__ row_count,
                        const int* __restrict__ cand,
                        const int* __restrict__ wlab,
                        const float* __restrict__ wwgt,
                        float* __restrict__ out, int tile_r,
                        int64_t window_entries) {
  const int64_t w = blockIdx.x;
  const int64_t base = w * window_entries;
  for (int s = threadIdx.x; s < tile_r; s += blockDim.x) {
    const int64_t slot = w * tile_r + s;
    const int64_t e = base + row_start[slot];
    const int64_t o = slot * K;
    rescan_row<K>(wlab + e, wwgt + e, row_count[slot], cand + o, out + o);
  }
}

// Shared launcher checks: 0 when the launch may go ahead, -1 when there is
// nothing to launch, else the CUDA error to return.
inline int prepare(int n_windows, int tile_r, long long window_entries,
                   int device) {
  if (n_windows < 0 || tile_r < 1 || window_entries < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return n_windows == 0 ? -1 : 0;
}

inline unsigned block_for(int tile_r) {
  return static_cast<unsigned>(tile_r < kMaxThreadsPerBlock
                                   ? tile_r
                                   : kMaxThreadsPerBlock);
}

// K5's block: K lanes per row slot, whole warps (the group fold's
// shuffles take the full warp), at most 128 threads.
inline unsigned group_block_for(int tile_r, int k) {
  const long long lanes = (static_cast<long long>(tile_r) * k + 31) / 32 * 32;
  return static_cast<unsigned>(lanes < kMaxThreadsPerBlock
                                   ? lanes
                                   : kMaxThreadsPerBlock);
}

}  // namespace

// Launchers: plain C interface for ctypes. Each returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for a k that
// has no instantiation or a negative size. The grid is n_windows blocks.
// The caller owns all buffers; nothing is allocated or synchronised here.
extern "C" int mg_stream_fold(const void* row_start, const void* row_count,
                              const void* wlab, const void* wwgt,
                              void* out_k, void* out_v, int n_windows,
                              int tile_r, long long window_entries, int k,
                              int device, void* stream) {
  const int ready = prepare(n_windows, tile_r, window_entries, device);
  if (ready != 0) return ready < 0 ? 0 : ready;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rs = static_cast<const int*>(row_start);
  const int* rc = static_cast<const int*>(row_count);
  const int* el = static_cast<const int*>(wlab);
  const float* ew = static_cast<const float*>(wwgt);
  int* ok = static_cast<int*>(out_k);
  float* ov = static_cast<float*>(out_v);
  const dim3 grid(static_cast<unsigned>(n_windows));
  switch (k) {
#define STREAM_FOLD_CASE(KK)                                              \
  case KK:                                                                \
    mg_stream_fold_kernel<KK><<<grid, group_block_for(tile_r, KK), 0,     \
                                s>>>(rs, rc, el, ew, ok, ov, tile_r,      \
                                     window_entries);                     \
    break;
    SKETCH_ROWS_FOR_EACH_K(STREAM_FOLD_CASE)
#undef STREAM_FOLD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mg_stream_select(const void* row_start, const void* row_count,
                                const void* incumbents, int seed,
                                const void* wlab, const void* wwgt,
                                void* out_c, int n_windows, int tile_r,
                                long long window_entries, int k, int device,
                                void* stream) {
  const int ready = prepare(n_windows, tile_r, window_entries, device);
  if (ready != 0) return ready < 0 ? 0 : ready;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rs = static_cast<const int*>(row_start);
  const int* rc = static_cast<const int*>(row_count);
  const int* inc = static_cast<const int*>(incumbents);
  const int* el = static_cast<const int*>(wlab);
  const float* ew = static_cast<const float*>(wwgt);
  int* oc = static_cast<int*>(out_c);
  const dim3 grid(static_cast<unsigned>(n_windows));
  switch (k) {
#define STREAM_SELECT_CASE(KK)                                            \
  case KK:                                                                \
    mg_stream_select_kernel<KK><<<grid, block_for(tile_r), 0, s>>>(       \
        rs, rc, inc, seed, el, ew, oc, tile_r, window_entries);           \
    break;
    SKETCH_ROWS_FOR_EACH_K(STREAM_SELECT_CASE)
#undef STREAM_SELECT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mg_stream_bm_fold(const void* row_start, const void* row_count,
                                 const void* init, const void* wlab,
                                 const void* wwgt, void* out_c, void* out_w,
                                 int n_windows, int tile_r,
                                 long long window_entries, int device,
                                 void* stream) {
  const int ready = prepare(n_windows, tile_r, window_entries, device);
  if (ready != 0) return ready < 0 ? 0 : ready;
  mg_stream_bm_kernel<<<dim3(static_cast<unsigned>(n_windows)),
                        block_for(tile_r), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_start), static_cast<const int*>(row_count),
      static_cast<const int*>(init), static_cast<const int*>(wlab),
      static_cast<const float*>(wwgt), static_cast<int*>(out_c),
      static_cast<float*>(out_w), tile_r, window_entries);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mg_stream_rescan(const void* row_start, const void* row_count,
                                const void* cand, const void* wlab,
                                const void* wwgt, void* out, int n_windows,
                                int tile_r, long long window_entries, int k,
                                int device, void* stream) {
  const int ready = prepare(n_windows, tile_r, window_entries, device);
  if (ready != 0) return ready < 0 ? 0 : ready;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rs = static_cast<const int*>(row_start);
  const int* rc = static_cast<const int*>(row_count);
  const int* cd = static_cast<const int*>(cand);
  const int* el = static_cast<const int*>(wlab);
  const float* ew = static_cast<const float*>(wwgt);
  float* o = static_cast<float*>(out);
  const dim3 grid(static_cast<unsigned>(n_windows));
  switch (k) {
#define STREAM_RESCAN_CASE(KK)                                            \
  case KK:                                                                \
    mg_stream_rescan_kernel<KK><<<grid, block_for(tile_r), 0, s>>>(       \
        rs, rc, cd, el, ew, o, tile_r, window_entries);                   \
    break;
    SKETCH_ROWS_FOR_EACH_K(STREAM_RESCAN_CASE)
#undef STREAM_RESCAN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
