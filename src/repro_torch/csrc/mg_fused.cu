// Fused weighted Misra-Gries fold kernels for Hopper (sm_90a).
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
//
// Design. One thread per fold row. The k (label, weight) slots live in
// registers (K is a template parameter, every slot loop is unrolled), and
// the thread walks its row's entries in entry order, so each row sees the
// reference's exact sequence of float32 adds, subtracts and maxes: the
// results are bit-identical to the reference. The fold has no multiply, so
// contraction could not change a bit; the build still passes -fmad=false
// and no fast-math flag. The thread reads exactly row_count entries: the
// TPU kernel's chunk-wide slices, pad lanes, per-step loop bound
// (step_dmax) and chunk slack entries are tiling devices that a per-thread
// loop does not need. Pad rows (row_count == 0) write empty sketches
// (-1, 0.0f), which the next round reads as exact no-ops.
//
// Bound on the H100. Both kernels are bound by bytes, not operations:
// round 0 of K1 reads 8 B per entry (int32 label + float32 weight) plus
// 8 B of (start, count) per row and writes 8*k B per row (64 B at k = 8);
// K2 reads the same plus a 4 B incumbent per row and writes 4 B per row.
// One thread per row makes a warp's 32 loads of one step hit 32 different
// rows, i.e. up to 32 different cache lines, so the kernels are expected
// far from the 3.35 TB/s bound; rows sorted by ascending count keep a
// warp's loop trip counts close. A warp per row, or staging a block's
// entries through shared memory with coalesced loads, is later work.
//
// Offsets are int32, as in the reference plan: a round's flat entry array
// must stay below 2^31 entries (90 M at 4 M vertices of the smoke graph).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsPerBlock = 128;
constexpr int kIntMax = 0x7FFFFFFF;
constexpr uint32_t kUintMax = 0xFFFFFFFFu;

// Weighted MG accumulate of one row (reference: fused.py:_mg_fold and
// repro.core.sketch.mg_fold_tile). An entry is valid iff w > 0 and c >= 0.
// A valid entry adds w to the occupied slot holding c; else it claims the
// first free slot as (c, w); else every slot loses w, clamped at 0.
template <int K>
__device__ __forceinline__ void mg_fold_row(const int* __restrict__ elab,
                                            const float* __restrict__ ewgt,
                                            int start, int count,
                                            int (&lab)[K], float (&val)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    lab[j] = -1;
    val[j] = 0.0f;
  }
  for (int i = 0; i < count; ++i) {
    const int c = __ldg(elab + start + i);
    const float w = __ldg(ewgt + start + i);
    if (!(w > 0.0f && c >= 0)) continue;
    bool matched = false;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (val[j] > 0.0f && lab[j] == c) {
        val[j] += w;
        matched = true;
      }
    }
    if (matched) continue;
    bool claimed = false;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (!claimed && !(val[j] > 0.0f)) {
        lab[j] = c;
        val[j] = w;
        claimed = true;
      }
    }
    if (claimed) continue;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float d = val[j] - w;
      val[j] = d < 0.0f ? 0.0f : d;  // the reference's maximum(d, 0.0)
    }
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

template <int K>
__global__ void __launch_bounds__(kThreadsPerBlock)
mg_fused_fold_kernel(const int* __restrict__ row_start,
                     const int* __restrict__ row_count,
                     const int* __restrict__ elab,
                     const float* __restrict__ ewgt,
                     int* __restrict__ out_k, float* __restrict__ out_v,
                     int n_rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  int lab[K];
  float val[K];
  mg_fold_row<K>(elab, ewgt, row_start[r], row_count[r], lab, val);
  const int64_t o = static_cast<int64_t>(r) * K;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    out_k[o + j] = lab[j];
    out_v[o + j] = val[j];
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
  mg_fold_row<K>(elab, ewgt, row_start[r], row_count[r], lab, val);
  out_c[r] = select_row<K>(lab, val, incumbents[r], seed);
}

inline dim3 grid_for(int n_rows) {
  return dim3(static_cast<unsigned>((n_rows + kThreadsPerBlock - 1) /
                                    kThreadsPerBlock));
}

}  // namespace

// The widths a run or a test on the card uses: k = 8 on the main path,
// 4 and 32 in tests/test_torch_cuda_kernels.py.
#define MG_FUSED_FOR_EACH_K(X) X(4) X(8) X(32)

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
#define MG_FOLD_CASE(KK)                                              \
  case KK:                                                            \
    mg_fused_fold_kernel<KK><<<grid_for(n_rows), kThreadsPerBlock, 0, \
                               s>>>(rs, rc, el, ew, ok, ov, n_rows);  \
    break;
    MG_FUSED_FOR_EACH_K(MG_FOLD_CASE)
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
    MG_FUSED_FOR_EACH_K(MG_SELECT_CASE)
#undef MG_SELECT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
