// One-hot cell SpMV for Hopper (sm_90a): the gather and the scatter of
// the padded-cell layout of highs_tpu_torch/ops/onehot_spmv.py.
//
// Layout.  A matrix padded to (mb * 128, nb * 128) is cut into 128 x 128
// cells; cell (j, i) keeps up to P of its nonzeros in slots.
//   gather side, j-major:  gcol[j][s], gval[j][s], s < slots_g: local
//     column and value of slot s of column block j (padding: 0 and 0);
//   scatter side, i-major: srow[i][s], s < slots_s: local row of slot s
//     of row block i (padding: row 0, and its value in V is 0).
// Between the two kernels torch permutes U (j-major) into V (i-major).
//
// onehot_gather replaces the Pallas TPU kernel
// highs_tpu/ops/onehot_spmv.py:_gather_kernel (:132):
//     U[j][s] = gval[j][s] * x[128 j + gcol[j][s]].
// The TPU kernel computes the lookup as an iota compare and a masked sum
// over 128 lanes, because the TPU has no cheap addressable gather.  Here
// it is a plain gather: a block stages the 128 values of x_j in shared
// memory once, and each thread reads its slots' column and value
// (coalesced), looks x up in shared memory and writes U (coalesced).
// Grid: (column block j, chunk of kGatherChunk slots).
//
// onehot_scatter replaces _scatter_kernel (:146):
//     y[128 i + l] = sum_s [srow[i][s] == l] * V[i][s].
// The TPU kernel's grid runs in order over slot tiles and accumulates a
// resident output block, zeroed at t == 0 (:154-156).  Here one block
// owns one row block i and a loop inside the block replaces that grid
// axis; each output element is written once, with no global atomics and
// no zero-fill pass.  Inside the block each warp takes 32 consecutive
// slots at a time and keeps its own 128-entry partial sum in shared
// memory: lanes holding the same row are grouped with __match_any_sync,
// the group's lowest lane adds their values in lane order into the
// warp's partial sum, and at the end thread l adds the warps' partial
// sums for row l in warp order.  So the order of every sum is fixed and
// the result is the same bit for bit from run to run.  Slots whose value
// is zero are skipped (exact): about 60% of the synth50k slots are
// padding, all on row 0, and would otherwise pile onto one entry.
//
// Bound: bytes.  A product reads each slot's index (4 bytes) and value
// and writes or reads one value per slot, plus x and y: for synth50k in
// f32 about 14.5 MB for the gather and 9.6 MB for the scatter
// (1,204,224 slots per side), a few microseconds at 3.35 TB/s, and one
// multiply (gather) or add (scatter) per slot, far below the card's
// operation rate.  Both kernels keep the data's type in every operation:
// f32 stays f32 and f64 stays f64.
//
// Plain C interface for ctypes; each entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;          // rows or columns of a block
constexpr int kGatherThreads = 256;
constexpr int kGatherChunk = 1024;   // slots per gather block
constexpr int kScatterThreads = 256;
constexpr int kWarps = kScatterThreads / 32;
constexpr int kScatterUnroll = 4;    // 32-slot tiles in flight per warp

template <typename T>
__global__ void __launch_bounds__(kGatherThreads)
onehot_gather_kernel(const int* __restrict__ gcol,
                     const T* __restrict__ gval,
                     const T* __restrict__ x,
                     T* __restrict__ u, int slots) {
  __shared__ T xs[kLanes];
  const int j = blockIdx.x;
  if (threadIdx.x < kLanes) {
    xs[threadIdx.x] = x[static_cast<size_t>(j) * kLanes + threadIdx.x];
  }
  __syncthreads();
  const size_t base = static_cast<size_t>(j) * slots;
  const int begin = blockIdx.y * kGatherChunk;
  const int end = min(slots, begin + kGatherChunk);
#pragma unroll 4
  for (int s = begin + threadIdx.x; s < end; s += kGatherThreads) {
    u[base + s] = gval[base + s] * xs[gcol[base + s]];
  }
}

template <typename T>
__global__ void __launch_bounds__(kScatterThreads)
onehot_scatter_kernel(const int* __restrict__ srow,
                      const T* __restrict__ v,
                      T* __restrict__ y, int slots) {
  __shared__ T part[kWarps][kLanes];
  __shared__ T stage[kWarps][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int e = threadIdx.x; e < kWarps * kLanes; e += kScatterThreads) {
    part[e / kLanes][e % kLanes] = T(0);
  }
  __syncthreads();
  const size_t base = static_cast<size_t>(blockIdx.x) * slots;
  // slots is a multiple of 32, so a tile is either whole or absent and
  // every lane of a warp takes the same branches below
  for (int t0 = warp * 32; t0 < slots;
       t0 += kScatterThreads * kScatterUnroll) {
    T vals[kScatterUnroll];
    int keys[kScatterUnroll];
#pragma unroll
    for (int k = 0; k < kScatterUnroll; ++k) {
      const int s = t0 + k * kScatterThreads + lane;
      vals[k] = T(0);
      keys[k] = -1;
      if (s < slots) {
        vals[k] = v[base + s];
        const int row = srow[base + s];
        keys[k] = vals[k] != T(0) ? row : -1;
      }
    }
#pragma unroll
    for (int k = 0; k < kScatterUnroll; ++k) {
      if (t0 + k * kScatterThreads >= slots) break;
      const unsigned peers = __match_any_sync(0xffffffffu, keys[k]);
      stage[warp][lane] = vals[k];
      __syncwarp();
      if (keys[k] >= 0 && lane == __ffs(peers) - 1) {
        T sum = stage[warp][lane];
        for (unsigned rest = peers & (peers - 1); rest; rest &= rest - 1) {
          sum += stage[warp][__ffs(rest) - 1];
        }
        part[warp][keys[k]] += sum;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (threadIdx.x < kLanes) {
    T acc = part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) acc += part[w][threadIdx.x];
    y[static_cast<size_t>(blockIdx.x) * kLanes + threadIdx.x] = acc;
  }
}

template <typename T>
int launch_gather(const void* gcol, const void* gval, const void* x,
                  void* u, int nb, int slots, void* stream) {
  if (nb > 0 && slots > 0) {
    const dim3 grid(nb, (slots + kGatherChunk - 1) / kGatherChunk);
    onehot_gather_kernel<T><<<grid, kGatherThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(gcol), static_cast<const T*>(gval),
        static_cast<const T*>(x), static_cast<T*>(u), slots);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scatter(const void* srow, const void* v, void* y, int mb,
                   int slots, void* stream) {
  if (mb > 0) {
    onehot_scatter_kernel<T><<<mb, kScatterThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(srow), static_cast<const T*>(v),
        static_cast<T*>(y), slots);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int onehot_gather_f32(const void* gcol, const void* gval,
                                 const void* x, void* u, int nb, int slots,
                                 void* stream) {
  return launch_gather<float>(gcol, gval, x, u, nb, slots, stream);
}

extern "C" int onehot_gather_f64(const void* gcol, const void* gval,
                                 const void* x, void* u, int nb, int slots,
                                 void* stream) {
  return launch_gather<double>(gcol, gval, x, u, nb, slots, stream);
}

extern "C" int onehot_scatter_f32(const void* srow, const void* v, void* y,
                                  int mb, int slots, void* stream) {
  return launch_scatter<float>(srow, v, y, mb, slots, stream);
}

extern "C" int onehot_scatter_f64(const void* srow, const void* v, void* y,
                                  int mb, int slots, void* stream) {
  return launch_scatter<double>(srow, v, y, mb, slots, stream);
}
