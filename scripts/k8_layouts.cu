// K8's layouts that lost to the shipped one, kept for scripts/k8_layouts.py
// to time beside mg_stream.cu:mg_stream_rescan_kernel (a group of K lanes
// per row slot, blocks of 256 threads: 256 / K row slots a pass). Not
// part of the port: nothing in src/repro_torch builds or calls this file.
//
//   layout 0: one thread per row slot holding all K candidates, walking its
//             row entry by entry (K8 before its redesign; 128 threads)
//   layout 1: the shipped kernel's group at up to 1,024 threads a block
//             (every row slot of a window in one pass at k = 8)
//   layout 2: the same at up to 128 threads a block (K5's block)
//   layout 6: the same at up to 512 threads a block
//   layout 3: the window stage: the block copies its window's occupied
//             entry prefix into shared memory with 16-byte cp.async, then
//             each group scans its row from there (up to 1,024 threads)
//   layout 4: layout 3 with 4-byte cp.async (what an unaligned window
//             base or a W that is no multiple of 4 takes)
//   layout 5: layout 3 at up to 512 threads a block
//
// Every layout adds each candidate's weights in entry order from +0.0f,
// rescan_group's sequence, so its bits equal the shipped kernel's and the
// plain version's.
//
// Build: nvcc with the port's flags (kernels/build.py:NVCC_FLAGS) and
// -I src/repro_torch/csrc.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_stage.cuh"
#include "sketch_rows.cuh"

namespace {

using row_stage::cp_async_16;
using row_stage::cp_async_4;
using row_stage::cp_async_commit;
using row_stage::cp_async_wait;
using sketch_rows::rescan_group;

constexpr unsigned kFull = 0xFFFFFFFFu;

// mg_stream.cu:for_each_row_slot.
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

// Layout 0: one thread per row slot, all K candidates in registers.
template <int K>
__global__ void __launch_bounds__(128)
rescan_thread_kernel(const int* __restrict__ row_start,
                     const int* __restrict__ row_count,
                     const int* __restrict__ cand,
                     const int* __restrict__ wlab,
                     const float* __restrict__ wwgt, float* __restrict__ out,
                     int tile_r, int64_t window_entries) {
  const int64_t w = blockIdx.x;
  const int64_t base = w * window_entries;
  for (int s = threadIdx.x; s < tile_r; s += blockDim.x) {
    const int64_t slot = w * tile_r + s;
    const int* el = wlab + base + row_start[slot];
    const float* ew = wwgt + base + row_start[slot];
    const int count = row_count[slot];
    int lab[K];
    float acc[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      lab[j] = cand[slot * K + j];
      acc[j] = 0.0f;
    }
    for (int i = 0; i < count; ++i) {
      const int c = __ldg(el + i);
      const float x = __ldg(ew + i);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (lab[j] >= 0 && lab[j] == c) acc[j] += x;
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) out[slot * K + j] = acc[j];
  }
}

// Layouts 1, 2 and 6: the shipped kernel at up to kThreads threads a
// block.
template <int K, int kThreads>
__global__ void __launch_bounds__(kThreads)
rescan_group_kernel(const int* __restrict__ row_start,
                    const int* __restrict__ row_count,
                    const int* __restrict__ cand,
                    const int* __restrict__ wlab,
                    const float* __restrict__ wwgt, float* __restrict__ out,
                    int tile_r, int64_t window_entries) {
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

// Layouts 3-5: the window's occupied prefix [0, end), end the largest
// row_start + row_count of its rows, goes to shared memory (labels in
// the first W words, weights in the next W), in 16-byte pieces (kVec: the
// window base and W must be 16-byte aligned) or 4-byte words. Then each
// lane of a group reads its row's entries from there, the K lanes of a
// group the same word (a broadcast), and adds its candidate's weights in
// entry order. No shuffle: each lane loops to its own row's count.
template <int K, bool kVec, int kThreads>
__global__ void __launch_bounds__(kThreads)
rescan_stage_kernel(const int* __restrict__ row_start,
                    const int* __restrict__ row_count,
                    const int* __restrict__ cand,
                    const int* __restrict__ wlab,
                    const float* __restrict__ wwgt, float* __restrict__ out,
                    int tile_r, int64_t window_entries) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int s_end;
  int* s_lab = smem;
  float* s_wgt = reinterpret_cast<float*>(smem + window_entries);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * tile_r;
  const int64_t base = blockIdx.x * window_entries;
  if (threadIdx.x == 0) s_end = 0;
  __syncthreads();
  int end = 0;
  for (int s = threadIdx.x; s < tile_r; s += blockDim.x) {
    const int c = row_count[first + s];
    if (c > 0) end = max(end, row_start[first + s] + c);
  }
  end = __reduce_max_sync(kFull, end);
  if ((threadIdx.x & 31) == 0) atomicMax(&s_end, end);
  __syncthreads();
  end = s_end;
  if constexpr (kVec) {
    for (int i = 4 * threadIdx.x; i < end; i += 4 * blockDim.x) {
      cp_async_16(s_lab + i, wlab + base + i);
      cp_async_16(s_wgt + i, wwgt + base + i);
    }
  } else {
    for (int i = threadIdx.x; i < end; i += blockDim.x) {
      cp_async_4(s_lab + i, wlab + base + i);
      cp_async_4(s_wgt + i, wwgt + base + i);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int lane = static_cast<int>(threadIdx.x) & (K - 1);
  for_each_row_slot<K>(tile_r, [&](int64_t slot, bool real) {
    if (!real) return;
    const int64_t o = slot * K + lane;
    const int start = row_start[slot];
    const int c = cand[o];
    const int count = c >= 0 ? row_count[slot] : 0;
    float acc = 0.0f;
    for (int i = 0; i < count; ++i) {
      const float added = acc + s_wgt[start + i];
      acc = s_lab[start + i] == c ? added : acc;
    }
    out[o] = acc;
  });
}

unsigned block_for(int tile_r, int k, int max_threads) {
  const long long lanes = (static_cast<long long>(tile_r) * k + 31) / 32 * 32;
  return static_cast<unsigned>(lanes < max_threads ? lanes : max_threads);
}

template <class Kernel>
int launch_stage(Kernel kernel, dim3 grid, unsigned block,
                 long long window_entries, cudaStream_t s,
                 const int* rs, const int* rc, const int* cd, const int* el,
                 const float* ew, float* o, int tile_r) {
  const long long smem = 8 * window_entries;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, block, static_cast<size_t>(smem), s>>>(
      rs, rc, cd, el, ew, o, tile_r, window_entries);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8's launcher contract (mg_stream.cu:mg_stream_rescan, k = 8) with a
// layout code; cudaErrorInvalidValue for an unknown layout, a negative
// size, a stage that does not fit, or 16-byte copies of a window base or
// stride that is not 16-byte aligned.
extern "C" int k8_layout_rescan(const void* row_start, const void* row_count,
                                const void* cand, const void* wlab,
                                const void* wwgt, void* out, int n_windows,
                                int tile_r, long long window_entries,
                                int layout, void* stream) {
  constexpr int K = 8;
  if (n_windows < 0 || tile_r < 1 || window_entries < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_windows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rs = static_cast<const int*>(row_start);
  const int* rc = static_cast<const int*>(row_count);
  const int* cd = static_cast<const int*>(cand);
  const int* el = static_cast<const int*>(wlab);
  const float* ew = static_cast<const float*>(wwgt);
  float* o = static_cast<float*>(out);
  const dim3 grid(static_cast<unsigned>(n_windows));
  const bool aligned = reinterpret_cast<uintptr_t>(wlab) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(wwgt) % 16 == 0 &&
                       window_entries % 4 == 0;
  switch (layout) {
    case 0:
      rescan_thread_kernel<K><<<grid, tile_r < 128 ? tile_r : 128, 0, s>>>(
          rs, rc, cd, el, ew, o, tile_r, window_entries);
      return static_cast<int>(cudaGetLastError());
    case 1:
      rescan_group_kernel<K, 1024><<<grid, block_for(tile_r, K, 1024), 0,
                                     s>>>(rs, rc, cd, el, ew, o, tile_r,
                                          window_entries);
      return static_cast<int>(cudaGetLastError());
    case 2:
      rescan_group_kernel<K, 128><<<grid, block_for(tile_r, K, 128), 0, s>>>(
          rs, rc, cd, el, ew, o, tile_r, window_entries);
      return static_cast<int>(cudaGetLastError());
    case 6:
      rescan_group_kernel<K, 512><<<grid, block_for(tile_r, K, 512), 0, s>>>(
          rs, rc, cd, el, ew, o, tile_r, window_entries);
      return static_cast<int>(cudaGetLastError());
    case 3:
      if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
      return launch_stage(rescan_stage_kernel<K, true, 1024>, grid,
                          block_for(tile_r, K, 1024), window_entries, s, rs,
                          rc, cd, el, ew, o, tile_r);
    case 4:
      return launch_stage(rescan_stage_kernel<K, false, 1024>, grid,
                          block_for(tile_r, K, 1024), window_entries, s, rs,
                          rc, cd, el, ew, o, tile_r);
    case 5:
      if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
      return launch_stage(rescan_stage_kernel<K, true, 512>, grid,
                          block_for(tile_r, K, 512), window_entries, s, rs,
                          rc, cd, el, ew, o, tile_r);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
