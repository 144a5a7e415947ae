// K3's layouts that lost to the shipped one, kept for scripts/k3_layouts.py
// to time beside mg_fused.cu:mg_fused_bm_fold_kernel (a shared-memory stage
// of C = 32 entries a row in one buffer). Not part of the port: nothing in
// src/repro_torch builds or calls this file.
//
//   layout 0: the stage at C = 16 in two buffers (34,816 B a block)
//   layout 1: the stage at C = 32 in two buffers (67,584 B a block)
//   layout 2: a group of 8 lanes per row, each holding the carry (K4's
//             layout: lane j loads entry chunk*8 + j, two shuffles
//             broadcast it)
//
// Every layout computes bm_fold_row's sequence over each row's entries, so
// its bits equal the shipped kernel's and the plain version's.
//
// Build: nvcc with the port's flags (kernels/build.py:NVCC_FLAGS) and
// -I src/repro_torch/csrc.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_stage.cuh"
#include "sketch_rows.cuh"

namespace {

using row_stage::fold_staged;
using row_stage::grid_for;
using row_stage::kRows;
using row_stage::SegmentRows;
using sketch_rows::bm_fold_entry;
using sketch_rows::BmCarry;

// mg_fused_bm_fold_kernel with the chunk and the buffer count as
// template arguments.
template <int C, int kBuffers>
__global__ void __launch_bounds__(kRows)
bm_stage_kernel(const int* __restrict__ row_start,
                const int* __restrict__ row_count,
                const int* __restrict__ init, const int* __restrict__ elab,
                const float* __restrict__ ewgt, int* __restrict__ out_c,
                float* __restrict__ out_w, int n_rows) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int s_start[kRows];
  __shared__ int s_count[kRows];
  __shared__ int s_longest;
  const int t = threadIdx.x;
  const int r = blockIdx.x * kRows + t;
  const int nr = min(kRows, n_rows - static_cast<int>(blockIdx.x) * kRows);
  int count = 0;
  BmCarry bm{-1, 0.0f};
  if (t < nr) {
    s_start[t] = row_start[r];
    count = row_count[r];
    bm.ck = init[r];
  }
  s_count[t] = count;
  if (t == 0) s_longest = 0;
  __syncthreads();
  const int warp_longest = __reduce_max_sync(0xFFFFFFFFu, count);
  if ((t & 31) == 0) atomicMax(&s_longest, warp_longest);
  __syncthreads();
  fold_staged<C, false, kBuffers>(elab, ewgt, SegmentRows{s_start, s_count},
                                  nr, (s_longest + C - 1) / C, smem, bm);
  if (t < nr) {
    out_c[r] = bm.ck;
    out_w[r] = bm.wk;
  }
}

// A group of G lanes per row, every lane holding the same carry. The group
// walks its row in chunks of G entries, lane j loading entry chunk*G + j,
// the next chunk's load in flight while the current one is folded; each
// entry is broadcast by two shuffles and every lane applies bm_fold_entry
// to its copy of the carry. The loop runs to the longest row of the warp;
// a lane past its row's end broadcasts (-1, 0.0f), a no-op. Rows at or
// past n_rows fold count 0 and store nothing (full-mask shuffles: no lane
// returns early).
template <int G>
__global__ void __launch_bounds__(kRows)
bm_group_kernel(const int* __restrict__ row_start,
                const int* __restrict__ row_count,
                const int* __restrict__ init, const int* __restrict__ elab,
                const float* __restrict__ ewgt, int* __restrict__ out_c,
                float* __restrict__ out_w, int n_rows) {
  constexpr unsigned kFull = 0xFFFFFFFFu;
  const int r = blockIdx.x * (kRows / G) + static_cast<int>(threadIdx.x) / G;
  const bool real = r < n_rows;
  const int start = real ? row_start[r] : 0;
  const int count = real ? row_count[r] : 0;
  const int* el = elab + start;
  const float* ew = ewgt + start;
  int ck = real ? init[r] : -1;
  float wk = 0.0f;
  const int slot = static_cast<int>(threadIdx.x) & (G - 1);
  const int longest = __reduce_max_sync(kFull, count);
  int c = -1;
  float w = 0.0f;
  if (slot < count) {
    c = __ldg(el + slot);
    w = __ldg(ew + slot);
  }
  for (int chunk = 0; chunk < longest; chunk += G) {
    int next_c = -1;
    float next_w = 0.0f;
    if (chunk + G + slot < count) {
      next_c = __ldg(el + chunk + G + slot);
      next_w = __ldg(ew + chunk + G + slot);
    }
    const int steps = longest - chunk;  // warp-uniform
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (i == steps) break;
      const int ci = __shfl_sync(kFull, c, i, G);
      const float wi = __shfl_sync(kFull, w, i, G);
      bm_fold_entry(ci, wi, ck, wk);
    }
    c = next_c;
    w = next_w;
  }
  if (real && slot == 0) {
    out_c[r] = ck;
    out_w[r] = wk;
  }
}

}  // namespace

// K3's launcher contract (mg_fused.cu:mg_fused_bm_fold) with a layout code;
// cudaErrorInvalidValue for an unknown layout or a negative row count.
extern "C" int k3_layout_fold(const void* row_start, const void* row_count,
                              const void* init, const void* elab,
                              const void* ewgt, void* out_c, void* out_w,
                              int n_rows, int layout, void* stream) {
  if (n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rs = static_cast<const int*>(row_start);
  const int* rc = static_cast<const int*>(row_count);
  const int* in = static_cast<const int*>(init);
  const int* el = static_cast<const int*>(elab);
  const float* ew = static_cast<const float*>(ewgt);
  int* oc = static_cast<int*>(out_c);
  float* ow = static_cast<float*>(out_w);
  switch (layout) {
    case 0:
      return static_cast<int>(row_stage::launch(
          bm_stage_kernel<16, 2>, grid_for(n_rows),
          row_stage::stage_bytes(16, false, 2), s, rs, rc, in, el, ew, oc,
          ow, n_rows));
    case 1:
      return static_cast<int>(row_stage::launch(
          bm_stage_kernel<32, 2>, grid_for(n_rows),
          row_stage::stage_bytes(32, false, 2), s, rs, rc, in, el, ew, oc,
          ow, n_rows));
    case 2:
      return static_cast<int>(row_stage::launch(
          bm_group_kernel<8>, grid_for(n_rows, kRows / 8), 0, s, rs, rc, in,
          el, ew, oc, ow, n_rows));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
