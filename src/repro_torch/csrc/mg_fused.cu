// Fused sketch fold kernels for Hopper (sm_90a): the weighted Misra-Gries
// fold and select, the weighted Boyer-Moore fold and the rescan pass.
//
// K1 mg_fused_fold_kernel replaces the TPU kernel
//    src/repro/kernels/mg_sketch/fused.py:_fused_fold_kernel
//    (bodies _gather_tile and _mg_fold): one launch per fold round; row r
//    folds its entries [row_start[r], row_start[r] + row_count[r]) of the
//    flat (label, weight) arrays into a k-slot MG sketch.
// K2 mg_fused_select_kernel replaces the TPU kernel
//    src/repro/kernels/mg_sketch/fused.py:_fused_select_kernel
//    (bodies _select_rows and _hash_mix): the last round's fold, then the
//    move selection among the slots with weight > 0 plus the incumbent.
// K3 mg_fused_bm_fold_kernel replaces the TPU kernel
//    src/repro/kernels/mg_sketch/fused.py:_bm_fold_kernel (body _bm_fold):
//    round 0 only; row r runs a weighted Boyer-Moore scan over its entries
//    from the carry (init[r], 0.0f).
// K4 mg_fused_rescan_kernel replaces the TPU kernel
//    src/repro/kernels/mg_sketch/fused.py:_rescan_fold_kernel (body
//    _rescan_acc): the rescan second pass; row r re-reads its round-0
//    entries and sums, per candidate of its vertex, the weights of the
//    entries carrying that label.
//
// Design of K1. A row is folded by a group of K lanes, lane j owning
// sketch slot j (one int label, one float weight, in registers): 8 rows a
// warp at k = 4, 4 at k = 8, 1 at k = 32 (sketch_rows.cuh:mg_fold_group).
// A block of 128 threads folds 128 / K consecutive rows. The group reads
// its row in chunks of K entries, lane j entry chunk*K + j, so a warp's
// load covers 32 / K short contiguous runs (one or two 32 B sectors each)
// instead of 32 scattered 4 B words, and the next chunk's load is in
// flight while the current one is folded. Each entry is broadcast to the
// group; two ballots over the slots' state pick its branch (add to the
// matching slot, claim the first free slot, or decrement every slot,
// clamped at 0), and each lane applies it to its own slot with selects,
// so groups that take different branches do not diverge. Lane j thus
// performs on slot j exactly the float32 operations of the reference's
// slot j, in entry order: no arithmetic crosses lanes, so the sketches
// are bit-identical to the reference. Lane j stores out[r*K + j]: a
// warp's two store instructions write 32 consecutive slots of labels and
// of weights (128 contiguous bytes each), where one thread per row made
// 2*K stores 8*K bytes apart. The loop runs to the longest row of the
// warp; rows sorted by ascending count (the fused plan's order) keep
// that close to every row's own length, and a lane past its row's end
// folds pad no-ops and reads nothing. Staging entries through shared
// memory is not needed: every real entry is read once, in sectors.
//
// Design of K4. K1's layout with a lighter step: a group of K lanes per
// row, lane j owning candidate j and its accumulator
// (sketch_rows.cuh:rescan_group). Lane j loads cand[r*K + j] and stores
// out[r*K + j], so a warp's candidate load and partial store each cover
// 32 consecutive words; the group reads its row in chunks of K entries,
// lane j entry chunk*K + j, the next chunk's load in flight while the
// current one is scanned. Each entry is broadcast with two shuffles and
// lane j adds its weight iff its candidate is the entry's label: no
// ballot, since a rescan slot neither claims nor decrements. Each slot's
// adds are the reference's, in entry order from +0.0f, so the partials
// are bit-identical to it. Control is warp-uniform as in K1: the loop
// runs to the longest row of the warp, rows past n_rows scan count 0.
//
// K2 and K3 keep one thread per fold row, the k slots in registers
// (sketch_rows.cuh:mg_fold_row, bm_fold_row), walking the row's entries
// in entry order: the reference's float32 sequence, so their results are
// bit-identical to it too. Every kernel reads exactly
// row_count entries: the TPU kernel's chunk-wide slices, pad lanes,
// per-step loop bound (step_dmax) and chunk slack entries are tiling
// devices that the CUDA kernels do not need. Pad rows (row_count == 0)
// write empty sketches (-1, 0.0f), which the next round reads as exact
// no-ops.
//
// Bound on the H100. All four kernels are bound by bytes, not operations:
// round 0 of K1 reads 8 B per entry (int32 label + float32 weight) plus
// 8 B of (start, count) per row and writes 8*k B per row (64 B at k = 8);
// K2 reads the same plus a 4 B incumbent per row and writes 4 B per row;
// K3 reads 8 B per entry and 12 B per row (start, count, init) and writes
// 8 B per row; K4 reads 8 B per entry and 8 + 4*k B per row and writes
// 4*k B per row. At 2^22 vertices (90.3 M round-0 entries, 4.2 M rows a
// round) K1's four rounds must move 2.74 GB, 0.818 ms at 3.35 TB/s.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 (700 W), 2^22
// vertices: K1 takes 2.354 ms per iteration, 34.7% of that bound (round 0
// 1.011 ms at 30.3%, rounds 1-3 0.44-0.45 ms at 38%), against 6.729 ms
// for the thread-per-row version it replaced; reading round 0 from a
// row-contiguous copy no longer changes its time. Rounds 1-3 are not held
// by bytes (rounds 2 and 3 read wholly contiguous rows) but by the group
// step's instructions and latency: a warp advances 4 rows per step where a
// thread-per-row warp advances 32.
// K4 on round 0 takes 0.594 ms, 51.6% of its 0.306 ms bound (1.027 GB),
// against 1.887 ms for the thread-per-row version it replaced.
// K2 and K3 remain one thread per row: a warp's loads of one step hit 32
// rows, i.e. up to 32 different cache lines, far from the bound.
//
// Offsets are int32, as in the reference plan: a round's flat entry array
// must stay below 2^31 entries (90 M at 4 M vertices of the smoke graph).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sketch_rows.cuh"

namespace {

using sketch_rows::bm_fold_row;
using sketch_rows::mg_fold_group;
using sketch_rows::mg_fold_row;
using sketch_rows::rescan_group;
using sketch_rows::select_row;

constexpr int kThreadsPerBlock = 128;

// K1: a group of K lanes per row (sketch_rows.cuh:mg_fold_group). Rows at
// or past n_rows fold count 0 and store nothing; they must not return
// before the group fold, whose shuffles and ballots take the full warp.
template <int K>
__global__ void __launch_bounds__(kThreadsPerBlock)
mg_fused_fold_kernel(const int* __restrict__ row_start,
                     const int* __restrict__ row_count,
                     const int* __restrict__ elab,
                     const float* __restrict__ ewgt,
                     int* __restrict__ out_k, float* __restrict__ out_v,
                     int n_rows) {
  constexpr int kRowsPerBlock = kThreadsPerBlock / K;
  const int r = blockIdx.x * kRowsPerBlock + static_cast<int>(threadIdx.x) / K;
  const bool real = r < n_rows;
  const int start = real ? row_start[r] : 0;
  int lab;
  float val;
  mg_fold_group<K>(elab + start, ewgt + start, real ? row_count[r] : 0, lab,
                   val);
  if (real) {
    const int64_t o = static_cast<int64_t>(r) * K + (threadIdx.x & (K - 1));
    out_k[o] = lab;
    out_v[o] = val;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreadsPerBlock)
mg_fused_select_kernel(const int* __restrict__ row_start,
                       const int* __restrict__ row_count,
                       const int* __restrict__ incumbents, int seed,
                       const int* __restrict__ elab,
                       const float* __restrict__ ewgt,
                       int* __restrict__ out_c, int n_rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  int lab[K];
  float val[K];
  const int start = row_start[r];
  mg_fold_row<K>(elab + start, ewgt + start, row_count[r], lab, val);
  out_c[r] = select_row<K>(lab, val, incumbents[r], seed);
}

// K3: one BM scan per row from its incumbent (pad rows: count 0, init -1,
// write (-1, 0.0f)).
__global__ void __launch_bounds__(kThreadsPerBlock)
mg_fused_bm_fold_kernel(const int* __restrict__ row_start,
                        const int* __restrict__ row_count,
                        const int* __restrict__ init,
                        const int* __restrict__ elab,
                        const float* __restrict__ ewgt,
                        int* __restrict__ out_c, float* __restrict__ out_w,
                        int n_rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int start = row_start[r];
  bm_fold_row(elab + start, ewgt + start, row_count[r], init[r], out_c + r,
              out_w + r);
}

// K4: per-candidate sums of one row's round-0 entries, a group of K lanes
// per row (sketch_rows.cuh:rescan_group). Rows at or past n_rows scan
// count 0 and store nothing; they must not return before the group scan,
// whose shuffles take the full warp.
template <int K>
__global__ void __launch_bounds__(kThreadsPerBlock)
mg_fused_rescan_kernel(const int* __restrict__ row_start,
                       const int* __restrict__ row_count,
                       const int* __restrict__ cand,
                       const int* __restrict__ elab,
                       const float* __restrict__ ewgt,
                       float* __restrict__ out, int n_rows) {
  constexpr int kRowsPerBlock = kThreadsPerBlock / K;
  const int r = blockIdx.x * kRowsPerBlock + static_cast<int>(threadIdx.x) / K;
  const bool real = r < n_rows;
  const int64_t o = static_cast<int64_t>(r) * K + (threadIdx.x & (K - 1));
  const int start = real ? row_start[r] : 0;
  const float acc = rescan_group<K>(elab + start, ewgt + start,
                                    real ? row_count[r] : 0,
                                    real ? cand[o] : -1);
  if (real) out[o] = acc;
}

inline dim3 grid_for(int n_rows, int rows_per_block = kThreadsPerBlock) {
  return dim3(static_cast<unsigned>((n_rows + rows_per_block - 1) /
                                    rows_per_block));
}

}  // namespace

// Launchers: plain C interface for ctypes. Each returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for a k that
// has no instantiation or a negative row count. The caller owns all
// buffers; nothing is allocated or synchronised here.
extern "C" int mg_fused_fold(const void* row_start, const void* row_count,
                             const void* elab, const void* ewgt, void* out_k,
                             void* out_v, int n_rows, int k, int device,
                             void* stream) {
  if (n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rs = static_cast<const int*>(row_start);
  const int* rc = static_cast<const int*>(row_count);
  const int* el = static_cast<const int*>(elab);
  const float* ew = static_cast<const float*>(ewgt);
  int* ok = static_cast<int*>(out_k);
  float* ov = static_cast<float*>(out_v);
  switch (k) {
#define MG_FOLD_CASE(KK)                                                 \
  case KK:                                                               \
    mg_fused_fold_kernel<KK><<<grid_for(n_rows, kThreadsPerBlock / KK),  \
                               kThreadsPerBlock, 0, s>>>(rs, rc, el, ew, \
                                                         ok, ov, n_rows); \
    break;
    SKETCH_ROWS_FOR_EACH_K(MG_FOLD_CASE)
#undef MG_FOLD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mg_fused_select(const void* row_start, const void* row_count,
                               const void* incumbents, int seed,
                               const void* elab, const void* ewgt,
                               void* out_c, int n_rows, int k, int device,
                               void* stream) {
  if (n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rs = static_cast<const int*>(row_start);
  const int* rc = static_cast<const int*>(row_count);
  const int* inc = static_cast<const int*>(incumbents);
  const int* el = static_cast<const int*>(elab);
  const float* ew = static_cast<const float*>(ewgt);
  int* oc = static_cast<int*>(out_c);
  switch (k) {
#define MG_SELECT_CASE(KK)                                                \
  case KK:                                                                \
    mg_fused_select_kernel<KK><<<grid_for(n_rows), kThreadsPerBlock, 0,   \
                                 s>>>(rs, rc, inc, seed, el, ew, oc,      \
                                      n_rows);                            \
    break;
    SKETCH_ROWS_FOR_EACH_K(MG_SELECT_CASE)
#undef MG_SELECT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mg_fused_bm_fold(const void* row_start, const void* row_count,
                                const void* init, const void* elab,
                                const void* ewgt, void* out_c, void* out_w,
                                int n_rows, int device, void* stream) {
  if (n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows == 0) return 0;
  mg_fused_bm_fold_kernel<<<grid_for(n_rows), kThreadsPerBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_start), static_cast<const int*>(row_count),
      static_cast<const int*>(init), static_cast<const int*>(elab),
      static_cast<const float*>(ewgt), static_cast<int*>(out_c),
      static_cast<float*>(out_w), n_rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mg_fused_rescan(const void* row_start, const void* row_count,
                               const void* cand, const void* elab,
                               const void* ewgt, void* out, int n_rows, int k,
                               int device, void* stream) {
  if (n_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rs = static_cast<const int*>(row_start);
  const int* rc = static_cast<const int*>(row_count);
  const int* cd = static_cast<const int*>(cand);
  const int* el = static_cast<const int*>(elab);
  const float* ew = static_cast<const float*>(ewgt);
  float* o = static_cast<float*>(out);
  switch (k) {
#define MG_RESCAN_CASE(KK)                                                \
  case KK:                                                                \
    mg_fused_rescan_kernel<KK><<<grid_for(n_rows, kThreadsPerBlock / KK), \
                                 kThreadsPerBlock, 0, s>>>(rs, rc, cd, el, \
                                                           ew, o, n_rows); \
    break;
    SKETCH_ROWS_FOR_EACH_K(MG_RESCAN_CASE)
#undef MG_RESCAN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
