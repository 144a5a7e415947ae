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
// Design. One block per window. K5 and K8 take a row slot with a group of
// K lanes (for_each_row_slot): the block's groups stride over the
// window's tile_r row slots, blockDim / K slots per pass (blockDim =
// tile_r * K rounded up to a whole warp, at most 128 for K5 and 256 for
// K8). K5's lane j owns sketch slot
// j (sketch_rows.cuh:mg_fold_group, as K1 in mg_fused.cu): a group reads
// its row in chunks of K contiguous entries with the next chunk's load in
// flight, broadcasts each entry to its lanes, and two ballots over the
// slots' state pick the branch each lane applies to its own slot: lane j
// performs slot j's float32 operations of the reference, in entry order,
// so the sketches are bit-identical to the reference and to the fused
// engine. K8's lane j owns candidate j (sketch_rows.cuh:rescan_group, as
// K4): the same chunked reads and broadcasts, and lane j adds each entry's
// weight iff its candidate is the entry's label, in entry order from
// +0.0f. Lane j loads cand[slot*K + j] and stores out[slot*K + j]: a warp
// reads and writes 128 contiguous bytes per instruction. K6 and K7 keep
// one thread per row slot (blockDim = min(tile_r, 128); every plan the
// package builds has tile_r = 128) on the fused kernels' per-row bodies,
// the reference's float32 sequence too. The TPU kernel's window blocks,
// pad lanes and per-window loop bound (step_dmax) are tiling devices: no
// thread reads a pad slot. Pad row slots (row_count == 0) fold nothing:
// K5 writes (-1, 0.0f), K6 the incumbent, K7 (init, 0.0f), K8 zeros.
//
// Bound on the H100. Bytes, as for K1-K4: the kernels read only real
// entries (8 B each), so their bytes bounds equal the fused kernels'
// (K5: 2.74 GB over its four rounds at 2^22, 0.819 ms at 3.35 TB/s; K8:
// 1.029 GB, 0.307 ms). A plan sorts each round's rows by ascending count
// before packing them into windows, so a window's rows lie one after
// another and a warp's groups read rows of about one length: a warp's
// loop runs to the longest of its rows, and its groups' reads fall in
// neighbouring sectors. Measured by chip_smoke.py and
// scripts/k8_layouts.py on an NVIDIA H100 80GB HBM3 (700 W), 2^22
// vertices: K5 takes 2.458 ms per iteration, 33.3% of its bound (round 0
// 1.050 ms, rounds 1-3 0.45-0.48 ms), against 3.281 ms for the
// thread-per-row version it replaced; K8 0.40 ms, 77% of its bound,
// against 0.80 ms for one thread per row slot. Blocks of 128 (3% slower)
// and 1,024 threads (one pass over a window's row slots; 9% slower) and a
// stage of the window's occupied prefix in shared memory (16- or 4-byte
// cp.async; 30-60% slower) lost to 256 threads (scripts/k8_layouts.cu
// keeps them). What the windowed
// layout adds is outside the kernels: the re-layout gather of every
// unaligned round (windowed_entries, plain torch), which writes
// n_windows*W padded slots per round.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sketch_rows.cuh"

namespace {

using sketch_rows::bm_fold_row;
using sketch_rows::mg_fold_group;
using sketch_rows::mg_fold_row;
using sketch_rows::rescan_group;
using sketch_rows::select_row;

constexpr int kMaxThreadsPerBlock = 128;
// K8's block: 256 / K row slots a pass
constexpr int kRescanThreads = 256;

// The window loop of K5 and K8: the block's groups of K lanes stride over
// window blockIdx.x's tile_r row slots, blockDim.x / K slots a pass, and
// call row(slot, real) for each, slot the global row slot and real false
// for a group past tile_r. The pass loop is block-uniform; a group past
// tile_r must still run its group scan (full-warp shuffles) and store
// nothing.
template <int K, class Row>
__device__ __forceinline__ void for_each_row_slot(int tile_r, Row&& row) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * tile_r;
  const int group = static_cast<int>(threadIdx.x) / K;
  const int per_pass = static_cast<int>(blockDim.x) / K;
  for (int s0 = 0; s0 < tile_r; s0 += per_pass) {
    const int s = s0 + group;
    row(first + s, s < tile_r);
  }
}

// K5: a group of K lanes folds each row slot (mg_fold_group).
template <int K>
__global__ void __launch_bounds__(kMaxThreadsPerBlock)
mg_stream_fold_kernel(const int* __restrict__ row_start,
                      const int* __restrict__ row_count,
                      const int* __restrict__ wlab,
                      const float* __restrict__ wwgt,
                      int* __restrict__ out_k, float* __restrict__ out_v,
                      int tile_r, int64_t window_entries) {
  const int64_t base = blockIdx.x * window_entries;
  const int lane = static_cast<int>(threadIdx.x) & (K - 1);
  for_each_row_slot<K>(tile_r, [&](int64_t slot, bool real) {
    const int64_t e = real ? base + row_start[slot] : 0;
    int lab;
    float val;
    mg_fold_group<K>(wlab + e, wwgt + e, real ? row_count[slot] : 0, lab,
                     val);
    if (real) {
      out_k[slot * K + lane] = lab;
      out_v[slot * K + lane] = val;
    }
  });
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

// K8: a group of K lanes scores each row slot's candidates (rescan_group),
// lane j candidate j: it loads cand[slot*K + j] and stores
// out[slot*K + j]. Pad row slots (count 0) store zeros.
template <int K>
__global__ void __launch_bounds__(kRescanThreads)
mg_stream_rescan_kernel(const int* __restrict__ row_start,
                        const int* __restrict__ row_count,
                        const int* __restrict__ cand,
                        const int* __restrict__ wlab,
                        const float* __restrict__ wwgt,
                        float* __restrict__ out, int tile_r,
                        int64_t window_entries) {
  const int64_t base = blockIdx.x * window_entries;
  const int lane = static_cast<int>(threadIdx.x) & (K - 1);
  for_each_row_slot<K>(tile_r, [&](int64_t slot, bool real) {
    const int64_t o = slot * K + lane;
    const int64_t e = real ? base + row_start[slot] : 0;
    const float acc = rescan_group<K>(wlab + e, wwgt + e,
                                      real ? row_count[slot] : 0,
                                      real ? cand[o] : -1);
    if (real) out[o] = acc;
  });
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

// K5's and K8's block: K lanes per row slot, whole warps (the group
// scans' shuffles take the full warp), at most max_threads threads.
inline unsigned group_block_for(int tile_r, int k, int max_threads) {
  const long long lanes = (static_cast<long long>(tile_r) * k + 31) / 32 * 32;
  return static_cast<unsigned>(lanes < max_threads ? lanes : max_threads);
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
    mg_stream_fold_kernel<KK><<<                                          \
        grid, group_block_for(tile_r, KK, kMaxThreadsPerBlock), 0, s>>>(  \
        rs, rc, el, ew, ok, ov, tile_r, window_entries);                  \
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
    mg_stream_rescan_kernel<KK><<<                                        \
        grid, group_block_for(tile_r, KK, kRescanThreads), 0, s>>>(       \
        rs, rc, cd, el, ew, o, tile_r, window_entries);                   \
    break;
    SKETCH_ROWS_FOR_EACH_K(STREAM_RESCAN_CASE)
#undef STREAM_RESCAN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
