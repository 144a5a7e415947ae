// Per-bucket tile fold kernels for Hopper (sm_90a): the weighted
// Misra-Gries fold and the weighted Boyer-Moore fold of one dense, padded
// [R, D] tile, the per-bucket ("pallas") engine's kernels.
//
// K9 mg_tile_fold_kernel replaces the TPU kernel
//    src/repro/kernels/mg_sketch/mg_sketch.py:_mg_kernel: row r of the
//    row-major tile (labels[r * D + i], weights[r * D + i], i < D) folds
//    into a k-slot weighted MG sketch, out_k/out_v[r * k + j].
// K10 mg_tile_bm_fold_kernel replaces the TPU kernel
//    src/repro/kernels/mg_sketch/mg_sketch.py:_bm_kernel: row r runs a
//    weighted Boyer-Moore scan over its D entries from the carry
//    (init[r], 0.0f), giving (out_c[r], out_w[r]).
//
// Design. One thread per row, calling the per-row fold bodies that the
// fused and streamed kernels share (sketch_rows.cuh) with a pointer to
// the row's first entry and count = D. The tile's pads (label -1, weight
// 0.0) are no-ops in both bodies, so each row sees the reference's exact
// sequence of float32 adds, subtracts and maxes: the results are
// bit-identical to repro_torch.core.sketch.mg_fold_tile / bm_fold_tile.
// The TPU kernel's row padding to tile_r is a tiling device; a thread per
// row takes the R rows as they are.
//
// Bound on the H100. Both kernels are bound by bytes: K9 reads 8 B per
// tile slot (int32 label + float32 weight) and writes 8*k B per row (64 B
// at k = 8); K10 reads 8 B per slot and a 4 B incumbent per row and
// writes 8 B per row. The tile is row-major, so at each step a warp's 32
// threads read 32 addresses D * 4 B apart (up to 32 cache lines), the
// uncoalesced pattern that costs the fused K1 about 2.2x on the card
// (PERF.md); staging a block's rows through shared memory with coalesced
// loads, or a transposed tile, is later work. The padded tile itself is
// built outside the kernels, by the plain torch gather of the plan walk
// (repro_torch.core.sketch._gather_entries), as XLA builds it in the
// reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sketch_rows.cuh"

namespace {

using sketch_rows::bm_fold_row;
using sketch_rows::mg_fold_row;

constexpr int kThreadsPerBlock = 128;

template <int K>
__global__ void __launch_bounds__(kThreadsPerBlock)
mg_tile_fold_kernel(const int* __restrict__ labels,
                    const float* __restrict__ weights,
                    int* __restrict__ out_k, float* __restrict__ out_v,
                    int n_rows, int width) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int64_t base = static_cast<int64_t>(r) * width;
  int lab[K];
  float val[K];
  mg_fold_row<K>(labels + base, weights + base, width, lab, val);
  const int64_t o = static_cast<int64_t>(r) * K;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    out_k[o + j] = lab[j];
    out_v[o + j] = val[j];
  }
}

__global__ void __launch_bounds__(kThreadsPerBlock)
mg_tile_bm_fold_kernel(const int* __restrict__ labels,
                       const float* __restrict__ weights,
                       const int* __restrict__ init, int* __restrict__ out_c,
                       float* __restrict__ out_w, int n_rows, int width) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int64_t base = static_cast<int64_t>(r) * width;
  bm_fold_row(labels + base, weights + base, width, init[r], out_c + r,
              out_w + r);
}

inline dim3 grid_for(int n_rows) {
  return dim3(static_cast<unsigned>((n_rows + kThreadsPerBlock - 1) /
                                    kThreadsPerBlock));
}

}  // namespace

// Launchers: plain C interface for ctypes. Each returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for a k that
// has no instantiation or a negative size. With n_rows == 0 nothing is
// launched (a zero-size grid is refused) and 0 is returned. The caller
// owns all buffers; nothing is allocated or synchronised here.
extern "C" int mg_tile_fold(const void* labels, const void* weights,
                            void* out_k, void* out_v, int n_rows, int width,
                            int k, int device, void* stream) {
  if (n_rows < 0 || width < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* wgt = static_cast<const float*>(weights);
  int* ok = static_cast<int*>(out_k);
  float* ov = static_cast<float*>(out_v);
  switch (k) {
#define TILE_FOLD_CASE(KK)                                                \
  case KK:                                                                \
    mg_tile_fold_kernel<KK><<<grid_for(n_rows), kThreadsPerBlock, 0, s>>>( \
        lab, wgt, ok, ov, n_rows, width);                                 \
    break;
    SKETCH_ROWS_FOR_EACH_K(TILE_FOLD_CASE)
#undef TILE_FOLD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mg_tile_bm_fold(const void* labels, const void* weights,
                               const void* init, void* out_c, void* out_w,
                               int n_rows, int width, int device,
                               void* stream) {
  if (n_rows < 0 || width < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows == 0) return 0;
  mg_tile_bm_fold_kernel<<<grid_for(n_rows), kThreadsPerBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(labels), static_cast<const float*>(weights),
      static_cast<const int*>(init), static_cast<int*>(out_c),
      static_cast<float*>(out_w), n_rows, width);
  return static_cast<int>(cudaGetLastError());
}
