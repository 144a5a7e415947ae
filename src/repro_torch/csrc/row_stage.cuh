// A block's shared-memory stage of its rows' entries, shared by the tile
// folds K9 and K10 (mg_tile.cu) and the fused BM fold K3 (mg_fused.cu).
//
// A block of kRows threads folds kRows rows, thread t row t, one entry at
// a time in entry order (the reference's per-row float32 sequence). Read
// straight from device memory, a warp's load of entry i touches 32 rows,
// up to 32 sectors for 128 useful bytes. Here the block copies its rows
// into shared memory first, in column chunks of C entries, so that the
// copies are coalesced and the per-entry reads hit shared memory:
//  1. Copy. stage_chunk starts cp.async copies of columns [c0, c0 + C) of
//     every row of the block, consecutive threads on consecutive pieces of
//     one row, then of the next: 16-byte pieces (kVec, for rows that start
//     16-byte aligned and hold a multiple of 4 entries) or 4-byte words. A
//     row past its count copies nothing. Where a row starts is the
//     locator's: TileRows for a dense [R, D] tile (row j at base + j * D,
//     D entries), SegmentRows for (start, count) segments of a flat array.
//  2. Fold. fold_staged keeps two buffers, chunk ch + 1's copy in flight
//     while chunk ch is folded (or one, for more blocks a multiprocessor),
//     and calls fold(c, w) for each entry of thread t's row t from shared
//     memory. The row stride is padded so that 32 threads reading entry i
//     of 32 consecutive rows do not conflict on a bank: C + 1 words for
//     4-byte reads; 4 * ((C / 4) | 1) words, an odd count of 16-byte
//     pieces, for 16-byte reads (a 16-byte cp.async needs a
//     16-byte-aligned destination, which C + 1 breaks).
// The loop runs to the block's longest row; every thread of the block
// calls it (barriers), a thread without a row folding nothing.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace row_stage {

// a block's threads, and its rows: one per thread
constexpr int kRows = 128;
// shared memory a launch may use without opting in
constexpr int kDefaultSmemBytes = 48 * 1024;

// The row stride of a stage of C-entry chunks, in words.
__host__ __device__ constexpr int stride_words(int c, bool vec) {
  return vec ? 4 * ((c / 4) | 1) : c + 1;
}

// Bytes of a stage of `buffers` buffers, each the labels and the weights
// of kRows rows.
__host__ __device__ constexpr int stage_bytes(int c, bool vec, int buffers) {
  return buffers * 2 * kRows * stride_words(c, vec) * 4;
}

// The rows of a dense [R, D] tile: block row j starts at base + j * D and
// holds D entries.
struct TileRows {
  int64_t base;
  int width;
  __device__ __forceinline__ int64_t start(int j) const {
    return base + static_cast<int64_t>(j) * width;
  }
  __device__ __forceinline__ int count(int) const { return width; }
};

// (start, count) segments of a flat entry array, the block's rows' copied
// into shared memory; the starts are int (S = int) or 64-bit.
template <class S>
struct SegmentRowsOf {
  const S* starts;
  const int* counts;
  __device__ __forceinline__ int64_t start(int j) const { return starts[j]; }
  __device__ __forceinline__ int count(int j) const { return counts[j]; }
};
using SegmentRows = SegmentRowsOf<int>;

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

// Start the copy of columns [c0, c0 + C) of the block's nr rows into one
// stage buffer (labels at s_lab, weights at s_wgt).
template <int C, bool kVec, class Rows>
__device__ __forceinline__ void stage_chunk(const int* __restrict__ labels,
                                            const float* __restrict__ weights,
                                            const Rows& rows, int nr, int c0,
                                            int* s_lab, float* s_wgt) {
  static_assert(C % 4 == 0 && (C & (C - 1)) == 0, "C: a power of two >= 4");
  constexpr int kStride = stride_words(C, kVec);
  constexpr int kPiece = kVec ? 4 : 1;  // entries per copy
  constexpr int kPieces = C / kPiece;   // pieces per row of a chunk
  for (int v = threadIdx.x; v < nr * kPieces; v += kRows) {
    const int j = v / kPieces;
    const int col = (v % kPieces) * kPiece;
    if (c0 + col >= rows.count(j)) continue;
    const int64_t g = rows.start(j) + c0 + col;
    const int s = j * kStride + col;
    if constexpr (kVec) {
      cp_async_16(s_lab + s, labels + g);
      cp_async_16(s_wgt + s, weights + g);
    } else {
      cp_async_4(s_lab + s, labels + g);
      cp_async_4(s_wgt + s, weights + g);
    }
  }
}

// Fold the block's nr rows through the stage in `smem` (min(n_chunks,
// kBuffers) buffers, stage_bytes): thread t < nr calls fold(c, w) on
// every entry of its row t in entry order, n_chunks chunks of C entries
// (the longest row's). With two buffers chunk ch + 1's copy is in flight
// while chunk ch is folded; with one, it starts once chunk ch is folded.
// Every thread of the block must call this.
template <int C, bool kVec, int kBuffers, class Rows, class Fold>
__device__ __forceinline__ void fold_staged(const int* __restrict__ labels,
                                            const float* __restrict__ weights,
                                            const Rows& rows, int nr,
                                            int n_chunks, int* smem,
                                            Fold& fold) {
  static_assert(kBuffers == 1 || kBuffers == 2, "one or two buffers");
  constexpr int kStride = stride_words(C, kVec);
  constexpr int kWords = kRows * kStride;  // one array of one buffer
  const int t = threadIdx.x;
  const int count = t < nr ? rows.count(t) : 0;
  // chunk ch goes to buffer ch % kBuffers: its labels at
  // smem + 2 * kWords * buffer, its weights kWords further
  if (n_chunks > 0) {
    stage_chunk<C, kVec>(labels, weights, rows, nr, 0, smem,
                         reinterpret_cast<float*>(smem + kWords));
    cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (kBuffers == 2 && ch + 1 < n_chunks) {
      int* nb = smem + 2 * kWords * ((ch + 1) & 1);
      stage_chunk<C, kVec>(labels, weights, rows, nr, (ch + 1) * C, nb,
                           reinterpret_cast<float*>(nb + kWords));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int cw = min(C, count - ch * C);
    const int* rl = smem + 2 * kWords * (ch & (kBuffers - 1)) + t * kStride;
    const float* rw = reinterpret_cast<const float*>(rl + kWords);
    if constexpr (kVec) {
      for (int q = 0; q < cw; q += 4) {
        const int4 c4 = *reinterpret_cast<const int4*>(rl + q);
        const float4 w4 = *reinterpret_cast<const float4*>(rw + q);
        fold(c4.x, w4.x);
        fold(c4.y, w4.y);
        fold(c4.z, w4.z);
        fold(c4.w, w4.w);
      }
    } else {
      for (int i = 0; i < cw; ++i) fold(rl[i], rw[i]);
    }
    __syncthreads();  // the buffer is staged again kBuffers chunks on
    if (kBuffers == 1 && ch + 1 < n_chunks) {
      stage_chunk<C, kVec>(labels, weights, rows, nr, (ch + 1) * C, smem,
                           reinterpret_cast<float*>(smem + kWords));
      cp_async_commit();
    }
  }
}

// Launch `kernel` on `grid` blocks of kRows threads with `smem` bytes of
// dynamic shared memory, opting in above 48 KB; cudaGetLastError() after.
template <class... Params, class... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int smem,
                   cudaStream_t s, Args... args) {
  if (smem > kDefaultSmemBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kRows, smem, s>>>(args...);
  return cudaGetLastError();
}

// Blocks of `rows_per_block` rows over n_rows rows.
inline dim3 grid_for(int n_rows, int rows_per_block = kRows) {
  return dim3(static_cast<unsigned>((n_rows + rows_per_block - 1) /
                                    rows_per_block));
}

}  // namespace row_stage
