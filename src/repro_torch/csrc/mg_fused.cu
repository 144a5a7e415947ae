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
// Design of K3. A block of 128 consecutive fused rows, thread t owning
// row r0 + t, folds from a shared-memory stage of its rows
// (row_stage.cuh:fold_staged over SegmentRows), the tile kernels' stage
// with a per-row locator: column chunk c of row r is the entries
// [row_start[r] + c*C, row_start[r] + min((c+1)*C, row_count[r])). The
// starts are arbitrary, so the copies are 4-byte cp.async words,
// consecutive threads on consecutive entries of one row's chunk (at C = 32
// a warp's copy moves one row's 128 contiguous bytes), where one thread
// per row reading from device memory made a warp's load touch 32
// unrelated places. The chunk loop runs to the block's longest row; rows
// come sorted by ascending count, so that is close to every row's own
// length, and a row past its count copies and folds nothing. Thread t
// then folds its row from the stage with bm_fold_entry (BmCarry), in
// entry order from (init[r], 0.0f), and stores out_c[r], out_w[r].
// Nothing depends on the row order (the sparse path hands K3 compacted
// rows). The stage holds C = 32 entries a row in one buffer: 33,792 B a
// block, six blocks a multiprocessor, and most rows fit one chunk, so one
// copy and one pair of barriers; a longer row's next chunk is copied once
// the block has folded the current one. It measured faster than C = 32 in
// two buffers (67,584 B, three blocks), C = 16 in two (34,816 B, six
// blocks) and a group of 8 lanes per row each holding the carry, K4's
// layout (times below), which scripts/k3_layouts.cu keeps and
// scripts/k3_layouts.py times beside this kernel.
//
// K2 keeps one thread per fold row, the k slots in registers
// (sketch_rows.cuh:mg_fold_row), walking the row's entries in entry
// order. Every kernel thus computes the reference's float32 sequence, so
// their results are bit-identical to it. Every kernel reads exactly
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
// K2 remains one thread per row: a warp's loads of one step hit 32 rows,
// i.e. up to 32 different cache lines.
// K3 on round 0 takes 0.497 ms, 48.5% of its 0.241 ms bound (C = 32 in
// two buffers 0.562, C = 16 0.585, the group layout 0.597), against
// 0.774 ms for the thread-per-row version it replaced. The rest is the
// CSR order of its rows: each row's entries sit where its vertex's
// adjacency does, so a block's 128 rows read 128 unrelated segments; on
// a row-contiguous copy of the same entries K3 takes 0.335 ms.
//
// Row starts come in two widths, S = int or long long: every kernel is
// instantiated for both, and the launcher takes the width in bytes. Round
// 0's starts are slot positions of the graph, in the width of its offsets
// (int32 up to 2^31 - 1 slots, int64 past that); later rounds index k-slot
// sketches and stay int32. The int32 instantiation is the same code as
// before the width was a parameter. Counts, rows and output positions stay
// int: a row holds at most chunk entries, and rows * k < 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_stage.cuh"
#include "sketch_rows.cuh"

namespace {

using row_stage::fold_staged;
using row_stage::grid_for;
using row_stage::kRows;
using row_stage::SegmentRowsOf;
using sketch_rows::BmCarry;
using sketch_rows::mg_fold_group;
using sketch_rows::mg_fold_row;
using sketch_rows::rescan_group;
using sketch_rows::select_row;

constexpr int kThreadsPerBlock = 128;  // K1, K2 and K4's block
// K3's stage: chunks of kBmChunk entries a row, in one buffer
constexpr int kBmChunk = 32;
constexpr int kBmBuffers = 1;

// K1: a group of K lanes per row (sketch_rows.cuh:mg_fold_group). Rows at
// or past n_rows fold count 0 and store nothing; they must not return
// before the group fold, whose shuffles and ballots take the full warp.
template <typename S, int K>
__global__ void __launch_bounds__(kThreadsPerBlock)
mg_fused_fold_kernel(const S* __restrict__ row_start,
                     const int* __restrict__ row_count,
                     const int* __restrict__ elab,
                     const float* __restrict__ ewgt,
                     int* __restrict__ out_k, float* __restrict__ out_v,
                     int n_rows) {
  constexpr int kRowsPerBlock = kThreadsPerBlock / K;
  const int r = blockIdx.x * kRowsPerBlock + static_cast<int>(threadIdx.x) / K;
  const bool real = r < n_rows;
  const S start = real ? row_start[r] : 0;
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

template <typename S, int K>
__global__ void __launch_bounds__(kThreadsPerBlock)
mg_fused_select_kernel(const S* __restrict__ row_start,
                       const int* __restrict__ row_count,
                       const int* __restrict__ incumbents, int seed,
                       const int* __restrict__ elab,
                       const float* __restrict__ ewgt,
                       int* __restrict__ out_c, int n_rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  int lab[K];
  float val[K];
  const S start = row_start[r];
  mg_fold_row<K>(elab + start, ewgt + start, row_count[r], lab, val);
  out_c[r] = select_row<K>(lab, val, incumbents[r], seed);
}

// K3: one BM scan per row from its incumbent, a block of kRows
// consecutive rows staged through shared memory in chunks of kBmChunk
// entries (row_stage.cuh:fold_staged over SegmentRows, 4-byte copies: the
// rows' starts are arbitrary). Pad rows (count 0, init -1) write
// (-1, 0.0f).
template <typename S>
__global__ void __launch_bounds__(kRows)
mg_fused_bm_fold_kernel(const S* __restrict__ row_start,
                        const int* __restrict__ row_count,
                        const int* __restrict__ init,
                        const int* __restrict__ elab,
                        const float* __restrict__ ewgt,
                        int* __restrict__ out_c, float* __restrict__ out_w,
                        int n_rows) {
  extern __shared__ __align__(16) int smem[];
  __shared__ S s_start[kRows];
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
  fold_staged<kBmChunk, false, kBmBuffers>(
      elab, ewgt, SegmentRowsOf<S>{s_start, s_count}, nr,
      (s_longest + kBmChunk - 1) / kBmChunk, smem, bm);
  if (t < nr) {
    out_c[r] = bm.ck;
    out_w[r] = bm.wk;
  }
}

// K4: per-candidate sums of one row's round-0 entries, a group of K lanes
// per row (sketch_rows.cuh:rescan_group). Rows at or past n_rows scan
// count 0 and store nothing; they must not return before the group scan,
// whose shuffles take the full warp.
template <typename S, int K>
__global__ void __launch_bounds__(kThreadsPerBlock)
mg_fused_rescan_kernel(const S* __restrict__ row_start,
                       const int* __restrict__ row_count,
                       const int* __restrict__ cand,
                       const int* __restrict__ elab,
                       const float* __restrict__ ewgt,
                       float* __restrict__ out, int n_rows) {
  constexpr int kRowsPerBlock = kThreadsPerBlock / K;
  const int r = blockIdx.x * kRowsPerBlock + static_cast<int>(threadIdx.x) / K;
  const bool real = r < n_rows;
  const int64_t o = static_cast<int64_t>(r) * K + (threadIdx.x & (K - 1));
  const S start = real ? row_start[r] : 0;
  const float acc = rescan_group<K>(elab + start, ewgt + start,
                                    real ? row_count[r] : 0,
                                    real ? cand[o] : -1);
  if (real) out[o] = acc;
}

template <typename S>
int launch_fold(const void* row_start, const void* row_count,
                const void* elab, const void* ewgt, void* out_k, void* out_v,
                int n_rows, int k, cudaStream_t s) {
  const S* rs = static_cast<const S*>(row_start);
  const int* rc = static_cast<const int*>(row_count);
  const int* el = static_cast<const int*>(elab);
  const float* ew = static_cast<const float*>(ewgt);
  int* ok = static_cast<int*>(out_k);
  float* ov = static_cast<float*>(out_v);
  switch (k) {
#define MG_FOLD_CASE(KK)                                                    \
  case KK:                                                                  \
    mg_fused_fold_kernel<S, KK><<<grid_for(n_rows, kThreadsPerBlock / KK),  \
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

template <typename S>
int launch_select(const void* row_start, const void* row_count,
                  const void* incumbents, int seed, const void* elab,
                  const void* ewgt, void* out_c, int n_rows, int k,
                  cudaStream_t s) {
  const S* rs = static_cast<const S*>(row_start);
  const int* rc = static_cast<const int*>(row_count);
  const int* inc = static_cast<const int*>(incumbents);
  const int* el = static_cast<const int*>(elab);
  const float* ew = static_cast<const float*>(ewgt);
  int* oc = static_cast<int*>(out_c);
  switch (k) {
#define MG_SELECT_CASE(KK)                                                \
  case KK:                                                                \
    mg_fused_select_kernel<S, KK><<<grid_for(n_rows, kThreadsPerBlock),   \
                                    kThreadsPerBlock, 0, s>>>(rs, rc, inc, \
                                                              seed, el,   \
                                                              ew, oc,     \
                                                              n_rows);    \
    break;
    SKETCH_ROWS_FOR_EACH_K(MG_SELECT_CASE)
#undef MG_SELECT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_bm_fold(const void* row_start, const void* row_count,
                   const void* init, const void* elab, const void* ewgt,
                   void* out_c, void* out_w, int n_rows, cudaStream_t s) {
  return static_cast<int>(row_stage::launch(
      mg_fused_bm_fold_kernel<S>, grid_for(n_rows),
      row_stage::stage_bytes(kBmChunk, false, kBmBuffers), s,
      static_cast<const S*>(row_start), static_cast<const int*>(row_count),
      static_cast<const int*>(init), static_cast<const int*>(elab),
      static_cast<const float*>(ewgt), static_cast<int*>(out_c),
      static_cast<float*>(out_w), n_rows));
}

template <typename S>
int launch_rescan(const void* row_start, const void* row_count,
                  const void* cand, const void* elab, const void* ewgt,
                  void* out, int n_rows, int k, cudaStream_t s) {
  const S* rs = static_cast<const S*>(row_start);
  const int* rc = static_cast<const int*>(row_count);
  const int* cd = static_cast<const int*>(cand);
  const int* el = static_cast<const int*>(elab);
  const float* ew = static_cast<const float*>(ewgt);
  float* o = static_cast<float*>(out);
  switch (k) {
#define MG_RESCAN_CASE(KK)                                                  \
  case KK:                                                                  \
    mg_fused_rescan_kernel<S, KK><<<grid_for(n_rows,                        \
                                             kThreadsPerBlock / KK),        \
                                    kThreadsPerBlock, 0, s>>>(rs, rc, cd,   \
                                                              el, ew, o,    \
                                                              n_rows);      \
    break;
    SKETCH_ROWS_FOR_EACH_K(MG_RESCAN_CASE)
#undef MG_RESCAN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Checks shared by the launchers: 0 to launch, -1 for nothing to launch
// (n_rows == 0), else the error to return.
int prelude(int n_rows, int start_bytes, int device) {
  if (n_rows < 0 || (start_bytes != 4 && start_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return n_rows == 0 ? -1 : 0;
}

}  // namespace

// Launchers: plain C interface for ctypes. start_bytes is the width of
// row_start's elements: 4 (int32) or 8 (int64). Each returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a k that has no instantiation, another
// start_bytes or a negative row count; an error of the shared-memory
// opt-in above 48 KB is returned as it is. With n_rows == 0 nothing is
// launched. The caller owns all buffers; nothing is allocated or
// synchronised here.
extern "C" int mg_fused_fold(const void* row_start, int start_bytes,
                             const void* row_count, const void* elab,
                             const void* ewgt, void* out_k, void* out_v,
                             int n_rows, int k, int device, void* stream) {
  const int pre = prelude(n_rows, start_bytes, device);
  if (pre != 0) return pre < 0 ? 0 : pre;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return start_bytes == 4
             ? launch_fold<int>(row_start, row_count, elab, ewgt, out_k,
                                out_v, n_rows, k, s)
             : launch_fold<long long>(row_start, row_count, elab, ewgt,
                                      out_k, out_v, n_rows, k, s);
}

extern "C" int mg_fused_select(const void* row_start, int start_bytes,
                               const void* row_count, const void* incumbents,
                               int seed, const void* elab, const void* ewgt,
                               void* out_c, int n_rows, int k, int device,
                               void* stream) {
  const int pre = prelude(n_rows, start_bytes, device);
  if (pre != 0) return pre < 0 ? 0 : pre;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return start_bytes == 4
             ? launch_select<int>(row_start, row_count, incumbents, seed,
                                  elab, ewgt, out_c, n_rows, k, s)
             : launch_select<long long>(row_start, row_count, incumbents,
                                        seed, elab, ewgt, out_c, n_rows, k,
                                        s);
}

extern "C" int mg_fused_bm_fold(const void* row_start, int start_bytes,
                                const void* row_count, const void* init,
                                const void* elab, const void* ewgt,
                                void* out_c, void* out_w, int n_rows,
                                int device, void* stream) {
  const int pre = prelude(n_rows, start_bytes, device);
  if (pre != 0) return pre < 0 ? 0 : pre;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return start_bytes == 4
             ? launch_bm_fold<int>(row_start, row_count, init, elab, ewgt,
                                   out_c, out_w, n_rows, s)
             : launch_bm_fold<long long>(row_start, row_count, init, elab,
                                         ewgt, out_c, out_w, n_rows, s);
}

extern "C" int mg_fused_rescan(const void* row_start, int start_bytes,
                               const void* row_count, const void* cand,
                               const void* elab, const void* ewgt, void* out,
                               int n_rows, int k, int device, void* stream) {
  const int pre = prelude(n_rows, start_bytes, device);
  if (pre != 0) return pre < 0 ? 0 : pre;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return start_bytes == 4
             ? launch_rescan<int>(row_start, row_count, cand, elab, ewgt, out,
                                  n_rows, k, s)
             : launch_rescan<long long>(row_start, row_count, cand, elab,
                                        ewgt, out, n_rows, k, s);
}
