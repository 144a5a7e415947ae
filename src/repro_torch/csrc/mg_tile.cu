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
// Design. Both kernels fold a block of 128 consecutive rows, one thread
// per row, from one shared-memory stage (row_stage.cuh:fold_staged over
// TileRows): the block's rows are one contiguous span of each array,
// [r0*D, (r0+128)*D), copied with cp.async in column chunks of C entries
// (C = 8 for D <= 8, else 32), two buffers, so that a 128-wide row needs
// 4 chunks and not 128 KB of stage. Where D is a multiple of 4 and both
// arrays are 16-byte aligned the copy moves 16-byte pieces, a warp's 32
// pieces consecutive in memory; otherwise (an odd D, a tile that is a
// slice at an unaligned offset) 4-byte words, a warp's 32 consecutive.
// Either way a warp's copy covers whole sectors, where one thread per row
// reading from device memory touched 32 rows' sectors per load. Thread t
// folds its row from the stage in entry order: K9 into k slots in
// registers (sketch_rows.cuh:MgSketch, mg_fold_entry), K10 into its carry
// (BmCarry, bm_fold_entry). The stores differ:
//  - K9 stages its [128, k] sketch through shared memory (row stride
//    k + 1: conflict-free) and writes it as 16-byte vectors, a warp's
//    stores covering 512 consecutive bytes of each output, where one
//    thread per row made 2k scalar stores 8k bytes apart;
//  - K10 writes out_c[r] and out_w[r] from registers: consecutive rows
//    make those stores coalesced already.
// Each row thus sees mg_fold_row's (bm_fold_row's) exact float32
// sequence over its D entries (the pads, label -1 and weight 0.0, are
// no-ops), so the results are bit-identical to
// repro_torch.core.sketch.mg_fold_tile (bm_fold_tile). The TPU kernel's
// row padding to tile_r is a tiling device; the last block folds the
// rows that are left and stores nothing past R.
//
// Bound on the H100. Both kernels are bound by bytes: K9 reads 8 B per
// tile slot (int32 label + float32 weight) and writes 8*k B per row (64 B
// at k = 8); K10 reads 8 B per slot and a 4 B incumbent per row and
// writes 8 B per row. Measured by chip_smoke.py on an NVIDIA H100 80GB
// HBM3 (700 W), 2^22 vertices: K9 takes 1.752 ms per iteration (23
// launches), 58.2% of its 1.019 ms bound, against 7.814 ms for the
// thread-per-row version it replaced; its 8- and 32-wide buckets, which
// hold nearly every slot, run at 75% and 70%, while the 64- and 128-wide
// ones (two or four chunks, three blocks a multiprocessor) and the small
// buckets of rounds 1-4 stay far below. K10 (6 launches, round 0's
// buckets) takes 0.382 ms per iteration, 81.5% of its 0.312 ms bound,
// against 1.123 ms for the thread-per-row version it replaced; its
// 32-wide bucket, which holds 83% of the slots, runs at 88%, its 64- and
// 128-wide ones at 60% and 74% (no 64 B sketch to store, where K9's stay
// near 21%), and the 4- and 8-wide ones, too small to fill the card, far
// below. The padded
// tile itself is built outside the kernels, by the plain torch gather of
// the plan walk (repro_torch.core.sketch._gather_entries), as XLA builds
// it in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_stage.cuh"
#include "sketch_rows.cuh"

namespace {

using row_stage::fold_staged;
using row_stage::kRows;
using row_stage::TileRows;
using sketch_rows::BmCarry;
using sketch_rows::mg_empty;
using sketch_rows::MgSketch;

// A tile's stage: chunks of 8 entries for D <= 8, else 32; 16-byte copies
// iff D % 4 == 0 and both arrays are 16-byte aligned (every row then
// starts 16-byte aligned).
inline int tile_chunk(int width) { return width <= 8 ? 8 : 32; }

inline bool tile_vec(int width, bool aligned) {
  return aligned && width % 4 == 0;
}

template <int C, bool V>
struct TileStage {
  static constexpr int kChunk = C;
  static constexpr bool kVec = V;
};

// f(TileStage<C, kVec>{}) for the tile's stage.
template <class F>
cudaError_t with_tile_stage(int width, bool aligned, F&& f) {
  const bool vec = tile_vec(width, aligned);
  if (tile_chunk(width) == 8) {
    return vec ? f(TileStage<8, true>{}) : f(TileStage<8, false>{});
  }
  return vec ? f(TileStage<32, true>{}) : f(TileStage<32, false>{});
}

// Dynamic shared memory of one launch on a tile of width D: the stage (one
// buffer per chunk, two at most) or, for K9 (k > 0), the [kRows, k + 1]
// sketch stage of its store, whichever is larger. K10 (k = 0) stores its
// carries straight from registers.
inline int tile_fold_smem(int width, bool aligned, int k) {
  const int c = tile_chunk(width);
  const int n_chunks = (width + c - 1) / c;
  const int stage = row_stage::stage_bytes(c, tile_vec(width, aligned),
                                           n_chunks < 2 ? n_chunks : 2);
  const int sketch = k > 0 ? 2 * kRows * (k + 1) * 4 : 0;
  return stage > sketch ? stage : sketch;
}

template <int K, int C, bool kVec>
__global__ void __launch_bounds__(kRows)
mg_tile_fold_kernel(const int* __restrict__ labels,
                    const float* __restrict__ weights,
                    int* __restrict__ out_k, float* __restrict__ out_v,
                    int n_rows, int width) {
  extern __shared__ __align__(16) int smem[];
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, n_rows - r0);
  MgSketch<K> sk;
  mg_empty<K>(sk.lab, sk.val);
  fold_staged<C, kVec, 2>(labels, weights,
                       TileRows{static_cast<int64_t>(r0) * width, width}, nr,
                       (width + C - 1) / C, smem, sk);
  // the sketch through shared memory (the stage is free: every fold
  // passed the last barrier), then 16-byte stores of whole rows
  int* s_k = smem;
  float* s_v = reinterpret_cast<float*>(smem + kRows * (K + 1));
  if (t < nr) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      s_k[t * (K + 1) + j] = sk.lab[j];
      s_v[t * (K + 1) + j] = sk.val[j];
    }
  }
  __syncthreads();
  static_assert(K % 4 == 0, "a 16-byte store holds 4 slots of one row");
  int4* ok = reinterpret_cast<int4*>(out_k + static_cast<int64_t>(r0) * K);
  float4* ov =
      reinterpret_cast<float4*>(out_v + static_cast<int64_t>(r0) * K);
  for (int u = t; u < nr * (K / 4); u += kRows) {
    const int s = (u / (K / 4)) * (K + 1) + (u % (K / 4)) * 4;
    ok[u] = make_int4(s_k[s], s_k[s + 1], s_k[s + 2], s_k[s + 3]);
    ov[u] = make_float4(s_v[s], s_v[s + 1], s_v[s + 2], s_v[s + 3]);
  }
}

template <int C, bool kVec>
__global__ void __launch_bounds__(kRows)
mg_tile_bm_fold_kernel(const int* __restrict__ labels,
                       const float* __restrict__ weights,
                       const int* __restrict__ init, int* __restrict__ out_c,
                       float* __restrict__ out_w, int n_rows, int width) {
  extern __shared__ __align__(16) int smem[];
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, n_rows - r0);
  BmCarry bm{t < nr ? init[r0 + t] : -1, 0.0f};
  fold_staged<C, kVec, 2>(labels, weights,
                       TileRows{static_cast<int64_t>(r0) * width, width}, nr,
                       (width + C - 1) / C, smem, bm);
  if (t < nr) {
    out_c[r0 + t] = bm.ck;
    out_w[r0 + t] = bm.wk;
  }
}

template <int K>
cudaError_t tile_fold(const int* lab, const float* wgt, int* ok, float* ov,
                      int n_rows, int width, bool aligned, cudaStream_t s) {
  const int smem = tile_fold_smem(width, aligned, K);
  return with_tile_stage(width, aligned, [&](auto stage) {
    using S = decltype(stage);
    return row_stage::launch(mg_tile_fold_kernel<K, S::kChunk, S::kVec>,
                             row_stage::grid_for(n_rows), smem, s, lab, wgt,
                             ok, ov, n_rows, width);
  });
}

cudaError_t tile_bm_fold(const int* lab, const float* wgt, const int* init,
                         int* oc, float* ow, int n_rows, int width,
                         bool aligned, cudaStream_t s) {
  const int smem = tile_fold_smem(width, aligned, 0);
  return with_tile_stage(width, aligned, [&](auto stage) {
    using S = decltype(stage);
    return row_stage::launch(mg_tile_bm_fold_kernel<S::kChunk, S::kVec>,
                             row_stage::grid_for(n_rows), smem, s, lab, wgt,
                             init, oc, ow, n_rows, width);
  });
}

inline bool both_aligned(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) %
             16 ==
         0;
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
  const bool aligned = both_aligned(lab, wgt);
  int* ok = static_cast<int*>(out_k);
  float* ov = static_cast<float*>(out_v);
  switch (k) {
#define TILE_FOLD_CASE(KK)                                                \
  case KK:                                                                \
    return static_cast<int>(                                              \
        tile_fold<KK>(lab, wgt, ok, ov, n_rows, width, aligned, s));
    SKETCH_ROWS_FOR_EACH_K(TILE_FOLD_CASE)
#undef TILE_FOLD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory per launch of K9 (k > 0) or K10 (k = 0) for a
// tile of width D whose arrays are 16-byte aligned (aligned != 0) or not;
// -1 for a k that has no instantiation or a negative width. The launchers
// size their launches with the same function.
extern "C" int mg_tile_fold_smem_bytes(int width, int k, int aligned) {
  if (width < 0) return -1;
  switch (k) {
#define TILE_SMEM_CASE(KK) case KK:
    case 0:  // K10
    SKETCH_ROWS_FOR_EACH_K(TILE_SMEM_CASE)
      return tile_fold_smem(width, aligned != 0, k);
#undef TILE_SMEM_CASE
    default:
      return -1;
  }
}

extern "C" int mg_tile_bm_fold(const void* labels, const void* weights,
                               const void* init, void* out_c, void* out_w,
                               int n_rows, int width, int device,
                               void* stream) {
  if (n_rows < 0 || width < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows == 0) return 0;
  return static_cast<int>(tile_bm_fold(
      static_cast<const int*>(labels), static_cast<const float*>(weights),
      static_cast<const int*>(init), static_cast<int*>(out_c),
      static_cast<float*>(out_w), n_rows, width, both_aligned(labels, weights),
      static_cast<cudaStream_t>(stream)));
}
