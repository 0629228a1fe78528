// Gather-rate probe for Hopper (sm_90a): out[s][j] = table[s][idx[s][j]].
//
// Replaces the two Pallas TPU probes tools/gather_probe.py:79-86
// (pallas_gather, take_along_axis in VMEM) and tools/gather_probe2.py:
// 29-39 (the same for same-shape tables).  They measure how fast the
// chip looks up one element per index, the rate the gather formats of
// ops/linops.py (ELL and the panel formats) live on.  The product never
// launches this kernel; highs_tpu_torch/tools/gather_probe.py times it.
//
// Design: one block per (table row s, chunk of kChunk outputs); each
// thread computes the output elements j = chunk start + thread, + 256,
// ... of its row.  When the row of the table fits in shared memory
// (k * sizeof(T) <= kMaxStaged bytes) the block stages it first and
// the lookups read shared memory; otherwise they read device memory
// (through L1/L2).  Reads of idx and writes of out are coalesced.
//
// Bound: bytes.  Each call must read the table and idx once and write
// out once; it does no arithmetic.  The indices must lie in [0, k): the
// kernel does not check them (the probe's tool draws them so).
//
// Plain C interface for ctypes; each entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;             // outputs per block
constexpr int kMaxStaged = 48 * 1024;    // bytes of static-limit smem

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
gather_probe_kernel(const T* __restrict__ table,
                    const int* __restrict__ idx, T* __restrict__ out,
                    int k, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* row = reinterpret_cast<T*>(smem);
  const int s = blockIdx.y;
  const T* trow = table + static_cast<size_t>(s) * k;
  if (kStaged) {
    for (int c = threadIdx.x; c < k; c += kThreads) row[c] = trow[c];
    __syncthreads();
  }
  const size_t base = static_cast<size_t>(s) * w;
  const int begin = blockIdx.x * kChunk;
  const int end = min(w, begin + kChunk);
#pragma unroll 4
  for (int j = begin + threadIdx.x; j < end; j += kThreads) {
    const int c = idx[base + j];
    out[base + j] = kStaged ? row[c] : trow[c];
  }
}

template <typename T>
int launch(const void* table, const void* idx, void* out, int s, int k,
           int w, void* stream) {
  if (s > 0 && w > 0) {
    const dim3 grid((w + kChunk - 1) / kChunk, s);
    const size_t staged = static_cast<size_t>(k) * sizeof(T);
    auto st = static_cast<cudaStream_t>(stream);
    if (staged <= kMaxStaged) {
      gather_probe_kernel<T, true><<<grid, kThreads, staged, st>>>(
          static_cast<const T*>(table), static_cast<const int*>(idx),
          static_cast<T*>(out), k, w);
    } else {
      gather_probe_kernel<T, false><<<grid, kThreads, 0, st>>>(
          static_cast<const T*>(table), static_cast<const int*>(idx),
          static_cast<T*>(out), k, w);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gather_probe_f32(const void* table, const void* idx,
                                void* out, int s, int k, int w,
                                void* stream) {
  return launch<float>(table, idx, out, s, k, w, stream);
}

extern "C" int gather_probe_f64(const void* table, const void* idx,
                                void* out, int s, int k, int w,
                                void* stream) {
  return launch<double>(table, idx, out, s, k, w, stream);
}
