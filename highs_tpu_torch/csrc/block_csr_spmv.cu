// Block-CSR SpMV for Hopper (sm_90a): y = K x over dense 128x128 tiles.
//
// Replaces the Pallas TPU kernel highs_tpu/ops/block_csr.py:_spmv_kernel
// (launched by _spmv), which runs a sequential grid over the nonzero
// tiles and accumulates each block-row in VMEM.  Here the blocks of the
// grid run in parallel and in no order, so the work is cut by block-row
// instead: one thread block of 128 threads owns one 128-row block of y,
// walks that row's tiles (contiguous in the layout, located by row_ptr)
// and writes its 128 outputs once.  No atomics, no zero-fill pass.
//
// Layout (highs_tpu_torch/ops/block_csr.py): tiles are stored TRANSPOSED,
// blocks[k][c][r] = K_tile_k[r][c], so y[r] = sum_c blocks[k][c][r] x[c].
// Thread r reads column c of every tile at blocks[k][c][r]: the 32 threads
// of a warp read 32 neighbouring elements, so every tile load coalesces.
// The x block of each tile is staged once in shared memory.
//
// Bound: the tile stream.  One product reads nnzb * 128 * 128 * sizeof(T)
// bytes of tiles (x, y and the indices are under 1% of that) and does two
// operations per tile element, far below the card's ops-per-byte
// balance, so memory bandwidth bounds it.  The accumulator has the type
// of the data and every step is a plain FMA: f32 stays full f32 (no
// TF32), matching the reference's Precision.HIGHEST.
//
// Plain C interface for ctypes; each entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
block_csr_spmv_kernel(const T* __restrict__ blocks,
                      const int* __restrict__ block_col,
                      const int* __restrict__ row_ptr,
                      const T* __restrict__ x,
                      T* __restrict__ y) {
  __shared__ T xs[kBlock];
  const int row = blockIdx.x;
  const int r = threadIdx.x;
  const int k_begin = row_ptr[row];
  const int k_end = row_ptr[row + 1];
  T acc = T(0);
  for (int k = k_begin; k < k_end; ++k) {
    __syncthreads();  // every thread is done with the previous x block
    xs[r] = x[static_cast<size_t>(block_col[k]) * kBlock + r];
    __syncthreads();
    const T* tile = blocks + static_cast<size_t>(k) * kBlock * kBlock + r;
#pragma unroll 16
    for (int c = 0; c < kBlock; ++c) {
      acc = fma_rn(tile[c * kBlock], xs[c], acc);
    }
  }
  y[static_cast<size_t>(row) * kBlock + r] = acc;
}

template <typename T>
int launch(const void* blocks, const void* block_col, const void* row_ptr,
           const void* x, void* y, int mb, void* stream) {
  if (mb > 0) {
    block_csr_spmv_kernel<T><<<mb, kBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(blocks), static_cast<const int*>(block_col),
        static_cast<const int*>(row_ptr), static_cast<const T*>(x),
        static_cast<T*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int block_csr_spmv_f32(const void* blocks, const void* block_col,
                                  const void* row_ptr, const void* x,
                                  void* y, int mb, void* stream) {
  return launch<float>(blocks, block_col, row_ptr, x, y, mb, stream);
}

extern "C" int block_csr_spmv_f64(const void* blocks, const void* block_col,
                                  const void* row_ptr, const void* x,
                                  void* y, int mb, void* stream) {
  return launch<double>(blocks, block_col, row_ptr, x, y, mb, stream);
}
