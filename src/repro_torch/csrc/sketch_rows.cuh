// Per-row sketch folds shared by the fused (mg_fused.cu), the streamed
// (mg_stream.cu) and the per-bucket tile (mg_tile.cu) kernels: one fold
// body per sketch, so every engine keeps the reference's per-row float32
// order. Each body reads exactly `count` entries from `elab`/`ewgt`,
// already offset to the row's first entry, in entry order; the kernels
// differ only in how they find that offset.
//
// Two MG bodies. mg_fold_group folds a row with a group of K lanes, one
// sketch slot per lane (K1 and K5, whose sketch store is then coalesced);
// one thread holding all K slots folds it entry by entry with
// mg_fold_entry, which mg_fold_row drives from device memory (K2, K6) and
// the tile kernel K9 from its shared-memory stage (MgSketch). Both compute
// the same float32 bits: mg_fold_group's lane j does to its slot exactly
// what mg_fold_entry does to slot j.
//
// One BM body, bm_fold_entry, for one carry: bm_fold_row drives it from
// device memory (K7) and BmCarry from a shared-memory stage (K3, K10).
//
// One rescan body, rescan_group (K4 and K8: a group of K lanes, lane j
// owning candidate j).
//
// Bit-exactness. Every body is a fixed sequence of float32 adds, subtracts
// and maxes per row, the reference's sequence. The folds have no multiply,
// so contraction could not change a bit; the build still passes
// -fmad=false and no fast-math flag.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sketch_rows {

constexpr int kIntMax = 0x7FFFFFFF;
constexpr uint32_t kUintMax = 0xFFFFFFFFu;

// The empty sketch: every slot (-1, 0.0f).
template <int K>
__device__ __forceinline__ void mg_empty(int (&lab)[K], float (&val)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    lab[j] = -1;
    val[j] = 0.0f;
  }
}

// Weighted MG accumulate of one entry (c, w) into a thread's K slots
// (reference: fused.py:_mg_fold and repro.core.sketch.mg_fold_tile). An
// entry is valid iff w > 0 and c >= 0. A valid entry adds w to the
// occupied slot holding c; else it claims the first free slot as (c, w);
// else every slot loses w, clamped at 0.
template <int K>
__device__ __forceinline__ void mg_fold_entry(int c, float w,
                                              int (&lab)[K],
                                              float (&val)[K]) {
  if (!(w > 0.0f && c >= 0)) return;
  bool matched = false;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (val[j] > 0.0f && lab[j] == c) {
      val[j] += w;
      matched = true;
    }
  }
  if (matched) return;
  bool claimed = false;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (!claimed && !(val[j] > 0.0f)) {
      lab[j] = c;
      val[j] = w;
      claimed = true;
    }
  }
  if (claimed) return;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const float d = val[j] - w;
    val[j] = d < 0.0f ? 0.0f : d;  // the reference's maximum(d, 0.0)
  }
}

// The MG fold of one row read from device memory, in entry order.
template <int K>
__device__ __forceinline__ void mg_fold_row(const int* __restrict__ elab,
                                            const float* __restrict__ ewgt,
                                            int count, int (&lab)[K],
                                            float (&val)[K]) {
  mg_empty<K>(lab, val);
  for (int i = 0; i < count; ++i) {
    mg_fold_entry<K>(__ldg(elab + i), __ldg(ewgt + i), lab, val);
  }
}

// A thread's K-slot MG sketch as a function object: fold(c, w) is
// mg_fold_entry on its slots. K9 drives it from its shared-memory stage
// (row_stage.cuh:fold_staged).
template <int K>
struct MgSketch {
  int lab[K];
  float val[K];
  __device__ __forceinline__ void operator()(int c, float w) {
    mg_fold_entry<K>(c, w, lab, val);
  }
};

// mg_fold_row with a group of K lanes per row, lane j holding slot j
// (lab, val). Lanes 0..31 of a warp form 32/K groups of K consecutive
// lanes, one row each; every lane of the warp must call this with the
// same control flow (full-mask shuffles and ballots), a lane without a
// row passing count 0, which reads nothing and returns the empty slot
// (-1, 0.0f).
//
// The group walks its row in chunks of K entries: lane j loads entry
// chunk*K + j (K contiguous labels and K contiguous weights per group),
// and the next chunk's load is started before the current chunk is folded.
// Each entry (c, w) of the chunk is then broadcast to the group and folded
// as in mg_fold_row: two ballots over the slots' state before the entry,
// masked to the group's lanes in place, choose the branch (some occupied
// slot holds c: it adds w; else some slot is free: the lowest free lane
// claims (c, w); else every slot subtracts w, clamped at 0), and each lane
// applies it to its own slot with selects, without branching. No
// arithmetic crosses lanes, so the bits are mg_fold_row's. The loop runs
// to the longest row of the warp, so a lane past its row's end folds pads
// (-1, 0.0f), which are no-ops.
template <int K>
__device__ __forceinline__ void mg_fold_group(const int* __restrict__ elab,
                                              const float* __restrict__ ewgt,
                                              int count, int& lab,
                                              float& val) {
  static_assert(K >= 1 && K <= 32 && (K & (K - 1)) == 0,
                "a group is a power-of-two share of a warp");
  constexpr unsigned kFull = 0xFFFFFFFFu;
  const unsigned lane = threadIdx.x & 31u;
  const int slot = static_cast<int>(lane) & (K - 1);
  const unsigned lane_bit = 1u << lane;
  // the group's K lanes as warp bits (K = 32: all; never 1u << 32)
  const unsigned group = (kFull >> (32 - K)) << (lane - slot);
  lab = -1;
  val = 0.0f;
  const int longest = __reduce_max_sync(kFull, count);
  int c = -1;
  float w = 0.0f;
  if (slot < count) {
    c = __ldg(elab + slot);
    w = __ldg(ewgt + slot);
  }
  for (int chunk = 0; chunk < longest; chunk += K) {
    int next_c = -1;
    float next_w = 0.0f;
    if (chunk + K + slot < count) {
      next_c = __ldg(elab + chunk + K + slot);
      next_w = __ldg(ewgt + chunk + K + slot);
    }
    const int steps = longest - chunk;  // warp-uniform
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (i == steps) break;
      const int ci = __shfl_sync(kFull, c, i, K);
      const float wi = __shfl_sync(kFull, w, i, K);
      const bool occupied = val > 0.0f;
      const bool mine = occupied && lab == ci;
      const unsigned match = __ballot_sync(kFull, mine) & group;
      const unsigned free = __ballot_sync(kFull, !occupied) & group;
      const bool valid = wi > 0.0f && ci >= 0;
      // free & -free: the group's lowest free lane (0 when none is free)
      const bool claim =
          valid && match == 0u && (free & (0u - free)) == lane_bit;
      const bool decrement = valid && (match | free) == 0u;
      const float added = val + wi;
      const float d = val - wi;
      val = valid && mine ? added : val;
      val = decrement ? (d < 0.0f ? 0.0f : d) : val;  // maximum(d, 0.0)
      val = claim ? wi : val;
      lab = claim ? ci : lab;
    }
    c = next_c;
    w = next_w;
  }
}

// repro.core.sketch.hash_mix in native uint32 arithmetic (wraps mod 2^32).
__device__ __forceinline__ uint32_t hash_mix(int x, int seed) {
  uint32_t h = static_cast<uint32_t>(x) * 2654435761u;
  h ^= static_cast<uint32_t>(seed) * 0x9E3779B9u;
  h ^= h >> 15;
  h *= 0x85EBCA77u;
  return h ^ (h >> 13);
}

// fused.py:_select_rows for one row: candidates are the slots with weight
// > 0 plus the incumbent at its sketched weight (0 if absent); the max
// weight wins, ties go to the min hash, then to the min label; with no
// candidate the row keeps the incumbent.
template <int K>
__device__ __forceinline__ int select_row(const int (&lab)[K],
                                          const float (&val)[K], int inc,
                                          int seed) {
  int cand[K + 1];
  float wgt[K + 1];
  float cur_w = 0.0f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    cand[j] = val[j] > 0.0f ? lab[j] : -1;
    wgt[j] = val[j];
    if (cand[j] == inc && val[j] > 0.0f && val[j] > cur_w) cur_w = val[j];
  }
  cand[K] = inc;
  wgt[K] = cur_w;
  float w_best = -1.0f;
#pragma unroll
  for (int j = 0; j <= K; ++j) {
    const float w = cand[j] >= 0 ? wgt[j] : -1.0f;
    if (w > w_best) w_best = w;
  }
  uint32_t h[K + 1];
  uint32_t h_best = kUintMax;
#pragma unroll
  for (int j = 0; j <= K; ++j) {
    const bool tied = cand[j] >= 0 && wgt[j] >= w_best;
    h[j] = tied ? hash_mix(cand[j], seed) : kUintMax;
    if (h[j] < h_best) h_best = h[j];
  }
  int c_best = kIntMax;
#pragma unroll
  for (int j = 0; j <= K; ++j) {
    const bool tied = cand[j] >= 0 && wgt[j] >= w_best;
    if (tied && h[j] <= h_best && cand[j] < c_best) c_best = cand[j];
  }
  return c_best == kIntMax ? inc : c_best;
}

// Weighted Boyer-Moore accumulate of one entry (c, w) into the carry
// (ck, wk) (reference: fused.py:_bm_fold and mg_sketch.py:_bm_kernel). An
// entry is valid iff w > 0 and c >= 0. A valid entry adds w if it carries
// ck; else it subtracts w if wk > w; else it replaces the carry by (c, w):
// a tie wk == w replaces, it is not a decrement. The reference writes the
// update as wk + where(same, w, 0) - where(bigger, w, 0); adding or
// subtracting +0.0f leaves the carry's bits unchanged because the carry is
// never -0.0f (it starts at +0.0f, grows by w > 0, shrinks only while
// wk > w), so the selects below are bit-identical to it. Every value is
// computed and then selected, with no branch: written with if/else and
// inlined into a loop, the body compiled to divergent branches, the
// threads of a warp, one per row, taking different ones (K7 ran 7x
// slower that way at 2^22 on an H100).
__device__ __forceinline__ void bm_fold_entry(int c, float w, int& ck,
                                              float& wk) {
  const bool valid = w > 0.0f && c >= 0;
  const float added = wk + w;
  const float less = wk - w;
  const bool same = c == ck;
  const bool bigger = wk > w;
  const float kept = bigger ? less : w;
  const float next_w = same ? added : kept;
  const bool keep_c = same || bigger;
  const int next_c = keep_c ? ck : c;
  wk = valid ? next_w : wk;
  ck = valid ? next_c : ck;
}

// The BM fold of one row read from device memory, in entry order, from
// the carry (init, 0.0f) (K7). A row of count 0 keeps (init, 0.0f).
__device__ __forceinline__ void bm_fold_row(const int* __restrict__ elab,
                                            const float* __restrict__ ewgt,
                                            int count, int init, int* ck_out,
                                            float* wk_out) {
  int ck = init;
  float wk = 0.0f;
  for (int i = 0; i < count; ++i) bm_fold_entry(elab[i], ewgt[i], ck, wk);
  *ck_out = ck;
  *wk_out = wk;
}

// The carry of a BM fold as a function object: fold(c, w) is
// bm_fold_entry on (ck, wk). The staged folds (row_stage.cuh:fold_staged)
// drive it: K10 from a tile, K3 from its rows' segments.
struct BmCarry {
  int ck;
  float wk;
  __device__ __forceinline__ void operator()(int c, float w) {
    bm_fold_entry(c, w, ck, wk);
  }
};

// fused.py:_rescan_acc for one row, with a group of K lanes per row, lane
// j holding candidate j (`cand`, -1 for an empty slot) and returning its
// accumulator. Unlike the other folds every entry counts, w <= 0
// included: acc[j] += w for each candidate j >= 0 equal to the entry's
// label, in entry order from +0.0f. The reference adds 0.0f to the other
// slots, which changes no bit (an accumulator that starts at +0.0f is
// never -0.0f: x + (-x) and +0.0f + -0.0f are +0.0f), so those adds are
// skipped. Lanes
// 0..31 of a warp form 32/K groups of K consecutive lanes, one row each;
// every lane of the warp must call this with the same control flow
// (full-mask shuffles), a lane without a row passing count 0 and cand -1.
//
// The group walks its row in chunks of K entries: lane j loads entry
// chunk*K + j, and the next chunk's load is started before the current
// chunk is scanned. Each entry (c, w) of the chunk is broadcast to the
// group, and lane j adds w to its accumulator iff cand >= 0 and cand ==
// c, so each slot's adds are the reference's, in entry order from +0.0f;
// duplicate candidates each accumulate. No ballot is needed: a rescan
// slot neither claims nor decrements. The loop runs to the longest row
// of the warp; a lane past its row's end broadcasts (-1, 0.0f), which
// matches no candidate.
template <int K>
__device__ __forceinline__ float rescan_group(const int* __restrict__ elab,
                                              const float* __restrict__ ewgt,
                                              int count, int cand) {
  static_assert(K >= 1 && K <= 32 && (K & (K - 1)) == 0,
                "a group is a power-of-two share of a warp");
  constexpr unsigned kFull = 0xFFFFFFFFu;
  const int slot = static_cast<int>(threadIdx.x) & (K - 1);
  const int longest = __reduce_max_sync(kFull, count);
  const bool live = cand >= 0;
  float acc = 0.0f;
  int c = -1;
  float w = 0.0f;
  if (slot < count) {
    c = __ldg(elab + slot);
    w = __ldg(ewgt + slot);
  }
  for (int chunk = 0; chunk < longest; chunk += K) {
    int next_c = -1;
    float next_w = 0.0f;
    if (chunk + K + slot < count) {
      next_c = __ldg(elab + chunk + K + slot);
      next_w = __ldg(ewgt + chunk + K + slot);
    }
    const int steps = longest - chunk;  // warp-uniform
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (i == steps) break;
      const int ci = __shfl_sync(kFull, c, i, K);
      const float wi = __shfl_sync(kFull, w, i, K);
      const float added = acc + wi;
      acc = live && cand == ci ? added : acc;
    }
    c = next_c;
    w = next_w;
  }
  return acc;
}

}  // namespace sketch_rows

// The widths a run or a test on the card uses: k = 8 on the main path,
// 4 and 32 in tests/test_torch_cuda_kernels.py (the MG folds, the select
// and the rescan; the BM fold keeps one carry and has no k).
#define SKETCH_ROWS_FOR_EACH_K(X) X(4) X(8) X(32)
