// Gather-rate probe for Hopper (sm_90a): out[s][j] = table[s][idx[s][j]].
//
// Replaces the two Pallas TPU probes tools/gather_probe.py:79-86
// (pallas_gather, take_along_axis in VMEM) and tools/gather_probe2.py:
// 29-39 (the same for same-shape tables).  They measure how fast the
// chip looks up one element per index, the rate the gather formats of
// ops/linops.py (ELL and the panel formats) live on.  The product never
// launches this kernel; highs_tpu_torch/tools/gather_probe.py times it.
//
// Bound: bytes.  Each call must read the table and idx once and write
// out once; it does no arithmetic.  At the probe's headline shape
// (table 128 x 128, idx 128 x 4,352, f32) that is 4.5 MB, 1.35 us at
// 3.35 TB/s: about as long as one round trip to device memory plus the
// launch, so the design is about having every byte in flight at once.
//
// Design:
// - 16-byte accesses: each thread loads U int4 vectors of indices (4
//   indices each) and stores 4 outputs per vector as one float4 (f32)
//   or two double2 (f64).  A row's vector body starts at the first
//   element whose flat offset s * w + j is a multiple of 4, so rows of
//   any width stay aligned; the at most 3 elements before it (head) and
//   after it (tail) are done one by one.
// - All U index loads of a thread are sent before any is used, and
//   before the table row is staged: the index stream and the staging
//   are in flight together (what a bulk TMA copy of the index chunk
//   would buy, without the barrier).
// - Grid: one block of 128 threads per (table row, chunk of U * 128
//   vectors), U in {1, 2, 4, 8} the smallest that keeps the grid within
//   one wave of 16 blocks per SM, so every SM's memory pipe has work and
//   no block waits for a second wave.  (128 threads measured faster
//   than 256 in f64 at the probe-1 shapes, and the same in f32.)
// - The table row is staged in shared memory, in 16-byte copies where
//   the row allows them, when it is no larger than the block's share of
//   outputs (and 48 KB); otherwise the lookups go through L1 (__ldg):
//   the tables are 64-512 KB and sit in L2.
// - Indices and outputs are streamed (__ldcs / __stcs): they are used
//   once and should not push the table out of the caches.
// The indices must lie in [0, k): the kernel does not check them (the
// probe's tool draws them so).  idx and out must start on a 16-byte
// boundary; the wrapper checks it.
//
// Plain C interface for ctypes; each entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStaged = 48 * 1024;  // bytes of dynamic smem, no opt-in
constexpr int kBlocksPerSm = 16;       // 2,048 threads an SM

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

__device__ __forceinline__ void store4(double* p, double a, double b,
                                       double c, double d) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(a, b));
  __stcs(reinterpret_cast<double2*>(p) + 1, make_double2(c, d));
}

template <typename T, bool kStaged>
__device__ __forceinline__ T lookup(const T* row, const T* trow, int c) {
  if constexpr (kStaged) {
    return row[c];
  } else {
    return __ldg(trow + c);
  }
}

template <typename T, bool kStaged, int U>
__global__ void __launch_bounds__(kThreads)
gather_probe_kernel(const T* __restrict__ table,
                    const int* __restrict__ idx, T* __restrict__ out,
                    int k, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* row = reinterpret_cast<T*>(smem);
  const int s = blockIdx.y;
  const size_t a = static_cast<size_t>(s) * w;  // flat start of row s
  const int head = min(w, static_cast<int>((4 - (a & 3)) & 3));
  const int nvec = (w - head) >> 2;
  const int tail = w - head - 4 * nvec;
  const int4* iv = reinterpret_cast<const int4*>(idx + a + head);
  T* ov = out + a + head;
  const int v0 = blockIdx.x * (U * kThreads) + threadIdx.x;

  // every index load of this thread in flight before any is used
  int4 c[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int v = v0 + u * kThreads;
    if (v < nvec) c[u] = __ldcs(iv + v);
  }
  const T* trow = table + static_cast<size_t>(s) * k;
  if constexpr (kStaged) {
    // 16-byte copies where the row allows them: at the probe's shapes
    // one load a thread, so the staging costs one round trip, overlapped
    // with the index loads above
    constexpr int kPer16 = 16 / sizeof(T);
    if (k % kPer16 == 0 && (reinterpret_cast<size_t>(trow) & 15) == 0) {
      const int4* src = reinterpret_cast<const int4*>(trow);
      int4* dst = reinterpret_cast<int4*>(row);
      for (int i = threadIdx.x; i < k / kPer16; i += kThreads) {
        dst[i] = __ldg(src + i);
      }
    } else {
      for (int i = threadIdx.x; i < k; i += kThreads) row[i] = trow[i];
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int v = v0 + u * kThreads;
    if (v < nvec) {
      store4(ov + 4 * v, lookup<T, kStaged>(row, trow, c[u].x),
             lookup<T, kStaged>(row, trow, c[u].y),
             lookup<T, kStaged>(row, trow, c[u].z),
             lookup<T, kStaged>(row, trow, c[u].w));
    }
  }
  // the scalar head and tail of the row, in its first chunk
  if (blockIdx.x == 0 && threadIdx.x < head + tail) {
    const int j = threadIdx.x < head
                      ? threadIdx.x
                      : head + 4 * nvec + (threadIdx.x - head);
    out[a + j] = lookup<T, kStaged>(row, trow, idx[a + j]);
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0) {
    return 132;  // the attribute is only a sizing hint
  }
  return n;
}

template <typename T, int U>
void launch_u(const T* table, const int* idx, T* out, int s, int k, int w,
              cudaStream_t st) {
  // vectors of the widest row body (a row loses at most 3 to its head)
  const int nvec = w / 4;
  const int chunks = nvec > 0 ? (nvec + U * kThreads - 1) / (U * kThreads)
                              : 1;
  const dim3 grid(chunks, s);
  const size_t staged = static_cast<size_t>(k) * sizeof(T);
  if (staged <= kMaxStaged &&
      static_cast<long long>(k) <= 4LL * U * kThreads) {
    gather_probe_kernel<T, true, U><<<grid, kThreads, staged, st>>>(
        table, idx, out, k, w);
  } else {
    gather_probe_kernel<T, false, U><<<grid, kThreads, 0, st>>>(
        table, idx, out, k, w);
  }
}

template <typename T>
int launch(const void* table, const void* idx, void* out, int s, int k,
           int w, void* stream) {
  if (s > 0 && w > 0) {
    auto t = static_cast<const T*>(table);
    auto i = static_cast<const int*>(idx);
    auto o = static_cast<T*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    // the smallest U whose grid fits in one wave
    const long long wave = static_cast<long long>(kBlocksPerSm) * sm_count();
    const long long nvec = w / 4;
    auto blocks = [&](int u) {
      return static_cast<long long>(s) *
             (nvec > 0 ? (nvec + u * kThreads - 1) / (u * kThreads) : 1);
    };
    if (blocks(1) <= wave) {
      launch_u<T, 1>(t, i, o, s, k, w, st);
    } else if (blocks(2) <= wave) {
      launch_u<T, 2>(t, i, o, s, k, w, st);
    } else if (blocks(4) <= wave) {
      launch_u<T, 4>(t, i, o, s, k, w, st);
    } else {
      launch_u<T, 8>(t, i, o, s, k, w, st);
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
