// One-hot SpMV for Hopper (sm_90a): the whole product y = K x of one
// direction of highs_tpu_torch/ops/onehot_spmv.py in a single launch.
//
// It replaces both Pallas TPU kernels of highs_tpu/ops/onehot_spmv.py
// together with the XLA code between and after them (`_spmv_cells`,
// :167-206):
//   _gather_kernel (:132)   U[j][s] = gval[j][s] * x[128 j + gcol[j][s]],
//   the relayout            U (j-major) -> V (i-major), re-padded,
//   _scatter_kernel (:146)  y[128 i + l] = sum_s [srow[i][s] == l] V[i][s],
//   the spill               y[spill_row] += spill_val * x[spill_col].
// The TPU computes the lookup and the histogram as iota compares over
// 128 lanes and pads every cell to P slots in (8, 128) tiles, because it
// has no cheap addressable gather or scatter.  The card has both, so the
// padded cells are not carried over: the host derives from them once a
// table that holds each kept slot and each spilled entry exactly once
// (no padding), grouped by output row:
//   row_ptr[r] .. row_ptr[r + 1]   the entries of padded row r (int32),
//   col[e], val[e]                 global column (int32) and value.
// Inside a row the entries come in the cells' order (column block j,
// then slot p), then the row's spill entries.
//
// Design.  Each output row is owned by a fixed group of kLanesPerRow = 8
// lanes (a warp takes 4 rows, a block of 256 threads 32 rows): synth50k
// has about 10 terms a row, so a whole warp per row would idle most of
// its lanes.  Lane k of a group takes the row's entries k, k + 8, ...:
// neighbouring lanes read neighbouring entries, and the 4 rows of a warp
// are contiguous in the table, so the loads are coalesced.  The kernel
// is bound by the latency of three dependent loads (row pointer, then
// column and value, then x), so a lane issues the column and value loads
// of kBatch = 4 terms at once, then their x loads, before it adds any:
// one pass covers rows of up to 32 terms (synth50k's longest has 26).
// x is read through the read-only path (__ldg); it is 196 KB in f32 and
// stays in the L2.  Each lane sums its terms in order in a register (FMA
// in the data's type: f32 stays f32, f64 stays f64), then the group adds
// its 8 partial sums with a fixed xor-shuffle tree and its first lane
// writes y once.  So there are no atomics, no zero-fill pass and no shared
// memory, every sum has one fixed order, and a rerun gives the same
// bits.  A row without entries (the padding rows) gets 0.
//
// Bound: bytes.  Every input read once and y written once: the table
// (4 (m + 1) + (4 + itemsize) nnz bytes), x and y, 4.6 MB for synth50k
// in f32 (1.4 us at 3.35 TB/s) and 7.0 MB in f64; 2 operations a term,
// far below the card's rate.  The padded-cell product (gather kernel,
// relayout, scatter kernel, spill) moved about 33 MB in six launches.
//
// Plain C interface for ctypes: the entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerRow = 8;
constexpr int kRowsPerBlock = kThreads / kLanesPerRow;
constexpr int kBatch = 4;  // terms whose loads a lane issues together

template <typename T>
__global__ void __launch_bounds__(kThreads)
onehot_spmv_kernel(const int* __restrict__ row_ptr,
                   const int* __restrict__ col,
                   const T* __restrict__ val,
                   const T* __restrict__ x,
                   T* __restrict__ y, int m) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanesPerRow;
  const int lane = threadIdx.x % kLanesPerRow;
  int begin = 0;
  int end = 0;
  if (row < m) {
    begin = __ldg(row_ptr + row);
    end = __ldg(row_ptr + row + 1);
  }
  T sum = T(0);
  for (int e0 = begin + lane; e0 < end; e0 += kLanesPerRow * kBatch) {
    int c[kBatch];
    T v[kBatch];
    T xv[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = e0 + q * kLanesPerRow;
      c[q] = e < end ? __ldg(col + e) : 0;
      v[q] = e < end ? __ldg(val + e) : T(0);
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      xv[q] = e0 + q * kLanesPerRow < end ? __ldg(x + c[q]) : T(0);
    }
    // the terms in entry order: the same sum on every run
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (e0 + q * kLanesPerRow < end) sum = fma(v[q], xv[q], sum);
    }
  }
  // every lane of the warp reaches the shuffles: a group of 8 lanes is
  // aligned to 8, so xor 4, 2, 1 stays inside it
#pragma unroll
  for (int off = kLanesPerRow / 2; off > 0; off /= 2) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (row < m && lane == 0) y[row] = sum;
}

template <typename T>
int launch(const void* row_ptr, const void* col, const void* val,
           const void* x, void* y, int m, void* stream) {
  if (m > 0) {
    const int blocks = (m + kRowsPerBlock - 1) / kRowsPerBlock;
    onehot_spmv_kernel<T><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(row_ptr), static_cast<const int*>(col),
        static_cast<const T*>(val), static_cast<const T*>(x),
        static_cast<T*>(y), m);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int onehot_spmv_f32(const void* row_ptr, const void* col,
                               const void* val, const void* x, void* y,
                               int m, void* stream) {
  return launch<float>(row_ptr, col, val, x, y, m, stream);
}

extern "C" int onehot_spmv_f64(const void* row_ptr, const void* col,
                               const void* val, const void* x, void* y,
                               int m, void* stream) {
  return launch<double>(row_ptr, col, val, x, y, m, stream);
}
