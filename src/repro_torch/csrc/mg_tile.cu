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
// Design of K9. A block of 128 threads folds 128 consecutive rows, one
// thread per row with the k slots in registers, from a shared-memory stage
// of the block's rows:
//  1. Stage. The block's rows are one contiguous span of each array,
//     [r0*D, (r0+128)*D). They are copied into shared memory with cp.async
//     in column chunks of C entries (C = 8 for D <= 8, else 32), the next
//     chunk's copy in flight while the current one is folded (two
//     buffers), so a 128-wide row needs 4 chunks and not 128 KB of stage.
//     Where D is a multiple of 4 and both arrays are 16-byte aligned,
//     every row starts 16-byte aligned and the copy moves 16-byte pieces,
//     a warp's 32 pieces consecutive in memory; otherwise (an odd D, a
//     tile that is a slice at an unaligned offset) it moves 4-byte words,
//     a warp's 32 words consecutive. Either way a warp's copy covers whole
//     sectors, where one thread per row reading from device memory touched
//     32 rows' sectors per load.
//  2. Fold. Thread t folds its row's entries of the chunk from shared
//     memory in entry order (sketch_rows.cuh:mg_fold_entry, the body of
//     mg_fold_row). The stage's row stride is padded so that 32 threads
//     reading entry i of 32 consecutive rows do not conflict on a bank:
//     C + 1 words for 4-byte reads; 4 * ((C / 4) | 1) words, an odd count
//     of 16-byte pieces, for the aligned stage, whose rows are read 16
//     bytes (4 entries) at a time.
//  3. Store. The [128, k] sketch is staged through shared memory (row
//     stride k + 1: conflict-free) and written out as 16-byte vectors, a
//     warp's stores covering 512 consecutive bytes of each output, where
//     one thread per row made 2k scalar stores 8k bytes apart.
// Each row thus sees mg_fold_row's exact float32 sequence over its D
// entries (the pads, label -1 and weight 0.0, are no-ops), so the
// sketches are bit-identical to repro_torch.core.sketch.mg_fold_tile. The
// TPU kernel's row padding to tile_r is a tiling device; the last block
// folds the rows that are left and stores nothing past R.
//
// K10 keeps one thread per row on the shared body bm_fold_row, reading
// its row from device memory (a pointer to the row's first entry and
// count = D).
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
// buckets of rounds 1-4 stay far below. K10's row-major reads from device
// memory are the uncoalesced pattern that K9's stage removes. The padded
// tile itself is built outside the kernels, by the plain torch gather of
// the plan walk (repro_torch.core.sketch._gather_entries), as XLA builds
// it in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sketch_rows.cuh"

namespace {

using sketch_rows::bm_fold_row;
using sketch_rows::mg_empty;
using sketch_rows::mg_fold_entry;

constexpr int kThreadsPerBlock = 128;
// a block's rows, one per thread (K9's stage and sketch are per block)
constexpr int kRows = kThreadsPerBlock;
// shared memory a launch may use without opting in
constexpr int kDefaultSmemBytes = 48 * 1024;

// K9's stage geometry for a chunk of C entries per row: the row stride in
// words, padded so that entry i of 32 consecutive rows falls in 32
// different banks (4-byte reads) or 8 consecutive rows' 16-byte pieces in
// 8 different ones (16-byte reads, an odd count of pieces per row).
template <int C, bool kVec>
struct Stage {
  static_assert(C % 4 == 0 && (C & (C - 1)) == 0, "C: a power of two >= 4");
  static constexpr int kStride = kVec ? 4 * ((C / 4) | 1) : C + 1;
  // words of one array of one buffer
  static constexpr int kWords = kRows * kStride;
};

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of columns [c0, c0 + cw) of the block's nr rows into one
// stage buffer (labels at s_lab, weights at s_wgt, row stride kStride).
// Consecutive threads take consecutive pieces of a row, then of the next.
template <int C, bool kVec>
__device__ __forceinline__ void stage_chunk(const int* __restrict__ labels,
                                            const float* __restrict__ weights,
                                            int64_t base, int width, int nr,
                                            int c0, int cw, int* s_lab,
                                            float* s_wgt) {
  using G = Stage<C, kVec>;
  constexpr int kPiece = kVec ? 4 : 1;  // entries per copy
  constexpr int kPieces = C / kPiece;   // pieces per row of a chunk
  for (int v = threadIdx.x; v < nr * kPieces; v += kThreadsPerBlock) {
    const int row = v / kPieces;
    const int col = (v % kPieces) * kPiece;
    if (col >= cw) continue;
    const int64_t g = base + static_cast<int64_t>(row) * width + c0 + col;
    const int s = row * G::kStride + col;
    if constexpr (kVec) {
      cp_async_16(s_lab + s, labels + g);
      cp_async_16(s_wgt + s, weights + g);
    } else {
      cp_async_4(s_lab + s, labels + g);
      cp_async_4(s_wgt + s, weights + g);
    }
  }
}

// Shared memory of one K9 launch: the stage (one buffer per chunk, two at
// most) or the [kRows, K + 1] sketch stage, whichever is larger.
template <int K, int C, bool kVec>
constexpr int tile_smem_bytes(int n_chunks) {
  const int stage = (n_chunks < 2 ? n_chunks : 2) * 2 *
                    Stage<C, kVec>::kWords * 4;
  const int sketch = 2 * kRows * (K + 1) * 4;
  return stage > sketch ? stage : sketch;
}

template <int K, int C, bool kVec>
__global__ void __launch_bounds__(kThreadsPerBlock)
mg_tile_fold_kernel(const int* __restrict__ labels,
                    const float* __restrict__ weights,
                    int* __restrict__ out_k, float* __restrict__ out_v,
                    int n_rows, int width) {
  using G = Stage<C, kVec>;
  extern __shared__ __align__(16) int smem[];
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, n_rows - r0);
  const int64_t base = static_cast<int64_t>(r0) * width;
  const int n_chunks = (width + C - 1) / C;
  int lab[K];
  float val[K];
  mg_empty<K>(lab, val);
  // buffer b: labels at smem + 2*b*kWords, weights kWords further
  if (n_chunks > 0) {
    stage_chunk<C, kVec>(labels, weights, base, width, nr, 0,
                         min(C, width), smem,
                         reinterpret_cast<float*>(smem + G::kWords));
    cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      int* nb = smem + 2 * G::kWords * ((ch + 1) & 1);
      const int c1 = (ch + 1) * C;
      stage_chunk<C, kVec>(labels, weights, base, width, nr, c1,
                           min(C, width - c1), nb,
                           reinterpret_cast<float*>(nb + G::kWords));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t < nr) {
      const int* rl = smem + 2 * G::kWords * (ch & 1) + t * G::kStride;
      const float* rw = reinterpret_cast<const float*>(rl + G::kWords);
      const int cw = min(C, width - ch * C);
      if constexpr (kVec) {
        for (int q = 0; q < cw; q += 4) {
          const int4 c4 = *reinterpret_cast<const int4*>(rl + q);
          const float4 w4 = *reinterpret_cast<const float4*>(rw + q);
          mg_fold_entry<K>(c4.x, w4.x, lab, val);
          mg_fold_entry<K>(c4.y, w4.y, lab, val);
          mg_fold_entry<K>(c4.z, w4.z, lab, val);
          mg_fold_entry<K>(c4.w, w4.w, lab, val);
        }
      } else {
        for (int i = 0; i < cw; ++i) mg_fold_entry<K>(rl[i], rw[i], lab, val);
      }
    }
    __syncthreads();  // the buffer is staged again two chunks on
  }
  // the sketch through shared memory (the stage is free: every fold
  // passed the last barrier), then 16-byte stores of whole rows
  int* s_k = smem;
  float* s_v = reinterpret_cast<float*>(smem + kRows * (K + 1));
  if (t < nr) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      s_k[t * (K + 1) + j] = lab[j];
      s_v[t * (K + 1) + j] = val[j];
    }
  }
  __syncthreads();
  static_assert(K % 4 == 0, "a 16-byte store holds 4 slots of one row");
  int4* ok = reinterpret_cast<int4*>(out_k + static_cast<int64_t>(r0) * K);
  float4* ov =
      reinterpret_cast<float4*>(out_v + static_cast<int64_t>(r0) * K);
  for (int u = t; u < nr * (K / 4); u += kThreadsPerBlock) {
    const int s = (u / (K / 4)) * (K + 1) + (u % (K / 4)) * 4;
    ok[u] = make_int4(s_k[s], s_k[s + 1], s_k[s + 2], s_k[s + 3]);
    ov[u] = make_float4(s_v[s], s_v[s + 1], s_v[s + 2], s_v[s + 3]);
  }
}

template <int K, int C, bool kVec>
cudaError_t launch_tile_fold(const int* lab, const float* wgt, int* ok,
                             float* ov, int n_rows, int width, int smem,
                             cudaStream_t s) {
  if (smem > kDefaultSmemBytes) {
    const cudaError_t err =
        cudaFuncSetAttribute(mg_tile_fold_kernel<K, C, kVec>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>((n_rows + kRows - 1) / kRows));
  mg_tile_fold_kernel<K, C, kVec><<<grid, kThreadsPerBlock, smem, s>>>(
      lab, wgt, ok, ov, n_rows, width);
  return cudaGetLastError();
}

// K9's instantiation for a tile: the chunk width C (8 for D <= 8, else
// 32) and the copy size (16 bytes iff D % 4 == 0 and both arrays are
// 16-byte aligned, so that every row starts 16-byte aligned).
enum class TileKind { kNarrowVec, kNarrow, kWideVec, kWide };

inline TileKind tile_kind(int width, bool aligned) {
  const bool vec = aligned && width % 4 == 0;
  if (width <= 8) return vec ? TileKind::kNarrowVec : TileKind::kNarrow;
  return vec ? TileKind::kWideVec : TileKind::kWide;
}

template <int K>
int tile_fold_smem(int width, bool aligned) {
  switch (tile_kind(width, aligned)) {
    case TileKind::kNarrowVec:
      return tile_smem_bytes<K, 8, true>((width + 7) / 8);
    case TileKind::kNarrow:
      return tile_smem_bytes<K, 8, false>((width + 7) / 8);
    case TileKind::kWideVec:
      return tile_smem_bytes<K, 32, true>((width + 31) / 32);
    default:
      return tile_smem_bytes<K, 32, false>((width + 31) / 32);
  }
}

template <int K>
cudaError_t tile_fold(const int* lab, const float* wgt, int* ok, float* ov,
                      int n_rows, int width, bool aligned, cudaStream_t s) {
  const int smem = tile_fold_smem<K>(width, aligned);
  switch (tile_kind(width, aligned)) {
    case TileKind::kNarrowVec:
      return launch_tile_fold<K, 8, true>(lab, wgt, ok, ov, n_rows, width,
                                          smem, s);
    case TileKind::kNarrow:
      return launch_tile_fold<K, 8, false>(lab, wgt, ok, ov, n_rows, width,
                                           smem, s);
    case TileKind::kWideVec:
      return launch_tile_fold<K, 32, true>(lab, wgt, ok, ov, n_rows, width,
                                           smem, s);
    default:
      return launch_tile_fold<K, 32, false>(lab, wgt, ok, ov, n_rows, width,
                                            smem, s);
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
  const bool aligned = (reinterpret_cast<uintptr_t>(lab) |
                        reinterpret_cast<uintptr_t>(wgt)) % 16 == 0;
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

// K9's dynamic shared memory per launch for a tile of width D at sketch
// width k whose arrays are 16-byte aligned (aligned != 0) or not; -1 for
// a k that has no instantiation or a negative width. mg_tile_fold sizes
// its launches with the same function.
extern "C" int mg_tile_fold_smem_bytes(int width, int k, int aligned) {
  if (width < 0) return -1;
  switch (k) {
#define TILE_SMEM_CASE(KK) \
  case KK:                 \
    return tile_fold_smem<KK>(width, aligned != 0);
    SKETCH_ROWS_FOR_EACH_K(TILE_SMEM_CASE)
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
  mg_tile_bm_fold_kernel<<<grid_for(n_rows), kThreadsPerBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(labels), static_cast<const float*>(weights),
      static_cast<const int*>(init), static_cast<int*>(out_c),
      static_cast<float*>(out_w), n_rows, width);
  return static_cast<int>(cudaGetLastError());
}
