// Frontier marks for Hopper (sm_90a): after an LPA iteration, every
// neighbour of a vertex that changed its label is marked unprocessed
// (the paper's Alg. 1 l. 31).
//
// frontier_marks_kernel replaces no Pallas kernel. The reference computes
// the marks with a plain jax.ops.segment_max over the CSR-expanded edge
// sources (src/repro/core/lpa.py:mark_frontier), which XLA lowers for the
// TPU. Its plain torch counterpart (kernels/frontier.py:
// frontier_marks_plain) writes an [M] int32 copy of changed[edge_src] and
// an [M] int64 copy of indices, then scatters an atomic amax into [N]
// int32: on a 567 M-slot web graph 6.8 GB of temporaries and 22 ms an
// iteration. This kernel computes the same [N] bool from the CSR arrays
// alone: for every vertex v with changed[v] it stores 1 at
// marked[indices[e]] for each slot e of v's row.
//
// No atomics. Every store writes the same byte, so the result is the OR
// of the marks in any order: bit for bit the reference's segment_max > 0.
// The caller hands in marked zeroed; nothing else is allocated.
//
// Bound on the H100: memory. It reads changed ([N] bytes), the offsets of
// the changed vertices ([N+1] int32 at most), the indices of their rows
// only (at most [M] int32), and stores bytes into marked, [N] bytes that
// L2 (50 MB) holds at 18.5 M vertices: 6 N + 4 M bytes with every vertex
// changed. At 18.5 M vertices and 567 M slots that is 2.38 GB, 0.71 ms at
// 3.35 TB/s; at 50.9 M vertices and 108 M slots (degree <= 4) 0.74 GB,
// 0.22 ms.
//
// Design. A thread takes 8 consecutive vertices, a warp 256, a block of
// 256 threads 2,048 (the grid comes from N alone); a thread's 8 changed
// bytes are one load, so each step of a warp's chain of dependent loads
// (flags, offsets, indices) serves 256 vertices. A changed vertex's row
// bounds come from offsets, and its degree picks who walks the row:
//  * degree >= kBlockRow (256): the whole block strides the row, one such
//    row at a time (claimed through shared memory), 8 loads a thread in
//    flight: a 194,944-slot hub is 96 block steps, not 194,944 steps of
//    one thread.
//  * shorter rows: the warp lays its rows end to end (a scan of their
//    degrees, in vertex order) and walks the concatenation 128 slots at a
//    time, 4 loads a lane in flight; each lane finds its slot's row by a
//    binary search over the warp's 256 row starts in shared memory. No
//    lane idles on a short row: 256 rows of degree <= 4 are about 4 such
//    steps. Consecutive rows are contiguous in indices, so a step's loads
//    are runs of consecutive slots.
// indices are read with the streaming hint (read once: evict first), so
// marked keeps its place in L2. An unchanged row's indices are never read.
// Measured on each iteration's changed of a detection on the benchmark's
// two graphs (NVIDIA H100 80GB HBM3, 700 W): 2.15 ms on the web graph's
// heaviest iteration against its 0.64 ms bound, 0.44 ms on the road
// network's first against 0.16 ms; the scattered byte stores take about
// a third of that. chip_smoke.py holds it to the plain version and times
// it on every mask of its main graph's runs (the FM lines).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVerts = 8;                    // vertices a thread
constexpr int kWarpRows = 32 * kVerts;       // rows a warp concatenates
constexpr int kBlockRow = 256;               // degree the block walks
constexpr int kUnroll = 4;                   // loads a lane in flight
constexpr unsigned kFull = 0xffffffffu;

// Slots s, s + stride, ... below end: kUnroll loads in flight, then the
// stores. 64-bit slot arithmetic: s + kUnroll * stride may pass INT_MAX.
template <int kU>
__device__ __forceinline__ void mark_strided(
    const int* __restrict__ indices, unsigned char* __restrict__ marked,
    long long s, long long end, int stride) {
  for (; s + (kU - 1) * static_cast<long long>(stride) < end;
       s += kU * static_cast<long long>(stride)) {
    int dst[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) dst[u] = __ldcs(indices + s + u * stride);
#pragma unroll
    for (int u = 0; u < kU; ++u) marked[dst[u]] = 1;
  }
  for (; s < end; s += stride) marked[__ldcs(indices + s)] = 1;
}

__global__ void __launch_bounds__(kThreads)
frontier_marks_kernel(const unsigned char* __restrict__ changed,
                      const int* __restrict__ offsets,
                      const int* __restrict__ indices,
                      unsigned char* __restrict__ marked, int n) {
  __shared__ int s_start[kWarps][kWarpRows];  // row's first slot in the
  __shared__ int s_beg[kWarps][kWarpRows];    // concatenation; in indices
  __shared__ int s_owner, s_row_beg, s_row_end;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long v0 = (static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x) * kVerts;

  // this thread's 8 changed flags, one load where the 8 lie in range
  unsigned flags = 0;
  if (v0 + kVerts <= n &&
      (reinterpret_cast<uintptr_t>(changed + v0) & (kVerts - 1)) == 0) {
    const uint2 w = *reinterpret_cast<const uint2*>(changed + v0);
#pragma unroll
    for (int i = 0; i < kVerts; ++i) {
      const unsigned word = i < 4 ? w.x : w.y;
      if ((word >> (8 * (i & 3))) & 0xffu) flags |= 1u << i;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVerts; ++i) {
      if (v0 + i < n && changed[v0 + i]) flags |= 1u << i;
    }
  }
  int beg[kVerts], deg[kVerts];
  unsigned long_rows = 0;
#pragma unroll
  for (int i = 0; i < kVerts; ++i) {
    beg[i] = 0;
    deg[i] = 0;
    if (flags & (1u << i)) {
      beg[i] = __ldg(offsets + v0 + i);
      deg[i] = __ldg(offsets + v0 + i + 1) - beg[i];
      if (deg[i] >= kBlockRow) long_rows |= 1u << i;
    }
  }

  // rows of 256 slots or more: the block, one row at a time. Every
  // thread reaches each barrier (threads past n hold no rows).
  while (__syncthreads_or(long_rows != 0)) {
    if (long_rows) s_owner = threadIdx.x;  // one of the writes lands
    __syncthreads();
    if (s_owner == static_cast<int>(threadIdx.x)) {
      const int i = __ffs(long_rows) - 1;
      long_rows &= long_rows - 1;
      int b = 0, d = 0;
#pragma unroll
      for (int k = 0; k < kVerts; ++k) {
        if (k == i) {
          b = beg[k];
          d = deg[k];
        }
      }
      s_row_beg = b;
      s_row_end = b + d;
    }
    __syncthreads();
    mark_strided<8>(indices, marked, static_cast<long long>(s_row_beg) +
                    threadIdx.x, s_row_end, kThreads);
  }

  // shorter rows: the warp's 256 rows end to end, in vertex order (row
  // 8 * lane + i); the long ones count 0 here
  int mine = 0;
#pragma unroll
  for (int i = 0; i < kVerts; ++i) {
    if (deg[i] >= kBlockRow) deg[i] = 0;
    mine += deg[i];
  }
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  if (total == 0) return;  // warp-uniform; no barrier follows
  int start = incl - mine;
#pragma unroll
  for (int i = 0; i < kVerts; ++i) {
    s_start[warp][kVerts * lane + i] = start;
    s_beg[warp][kVerts * lane + i] = beg[i];
    start += deg[i];
  }
  __syncwarp();
  const int* st = s_start[warp];
  const int* bg = s_beg[warp];
  for (int base = 0; base < total; base += 32 * kUnroll) {
    int dst[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = base + 32 * u + lane;
      dst[u] = -1;
      if (s < total) {
        // the row of slot s: the last row whose start is <= s (a row of
        // degree 0 shares its start with the next row)
        int r = 0;
#pragma unroll
        for (int step = kWarpRows / 2; step > 0; step >>= 1) {
          if (st[r + step] <= s) r += step;
        }
        dst[u] = __ldcs(indices + bg[r] + (s - st[r]));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (dst[u] >= 0) marked[dst[u]] = 1;
    }
  }
}

}  // namespace

// Launcher: plain C interface for ctypes. Returns cudaGetLastError() after
// the launch (0 = launched), or cudaErrorInvalidValue for a negative n.
// With n == 0 nothing is launched. The caller owns every buffer and hands
// in marked zeroed; nothing is allocated or synchronised here.
extern "C" int frontier_marks(const void* changed, const void* offsets,
                              const void* indices, void* marked, int n,
                              int device, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  constexpr int kPerBlock = kThreads * kVerts;
  const unsigned blocks = static_cast<unsigned>((n - 1) / kPerBlock + 1);
  frontier_marks_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(changed),
      static_cast<const int*>(offsets), static_cast<const int*>(indices),
      static_cast<unsigned char*>(marked), n);
  return static_cast<int>(cudaGetLastError());
}
