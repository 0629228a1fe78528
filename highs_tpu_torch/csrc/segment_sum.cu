// Segment sums in the host's order, for the PDLP scaling and presolve's
// activity bounds on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package scales K on the host with numpy
// (highs_tpu/solvers/pdlp/scaling.py), and the port's torch route of that
// scaling (highs_tpu_torch/solvers/pdlp/scaling.py `scale_problem`)
// must give the host's bits.  Its Pock-Chambolle and L2 passes sum |a| or
// a * a over each row and each column of K.  The host sums with
// np.bincount(ids, weights), which adds a segment's terms one after
// another in array order, starting from 0; the order decides the bits,
// and no library reduction promises one.  So one thread owns one segment
// and adds its terms in that order, each product and each sum rounded by
// itself: __dmul_rn and __dadd_rn, which nvcc never contracts into an FMA.
//
// Segment s is values[ptr[s]] .. values[ptr[s+1] - 1] (a row of the CSR),
// or, with `order`, values[order[ptr[s]]] .. (a column, through a stable
// permutation of the entries by column, so its terms come in CSR order).
//
// Bound: bytes.  A call reads each value once (8 B), each order entry once
// (8 B) and each pointer once, and writes one f64 a segment; its
// arithmetic is one add (and one multiply) a value.  A thread's loads are
// independent of its running sum, so the unrolled loop keeps several in
// flight; neighbouring threads walk neighbouring segments, whose cache
// lines each serve a thread for several terms.
//
// The signed mode (`segment_signed_dot_f64`) serves presolve's activity
// bounds (highs_tpu_torch/presolve/device.py), which the host took as
// max(A, 0) @ l + min(A, 0) @ u with scipy's csr_matvec: each row's
// products added one after another in CSR order, from 0.  It sums a row's
// positive entries times x1 and times x2, and its negative entries times
// x2 and times x1, four sums in one walk over the row.  A row's sum over
// max(A, 0) adds a product of 0 for each of its other entries; such a
// term is +0 or -0, and adding it leaves a sum that is never -0 as it
// was, so the kernel skips it.  Bound: bytes, 12 a value (the value and
// its 4-byte column index) and one read of x1 and x2 a value, which the
// L2 cache serves.
//
// Plain C interface for ctypes; the entry points launch on the given
// stream, allocate nothing and return cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kSquare, bool kOrdered>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const double* __restrict__ values,
                   const long long* __restrict__ order,
                   const long long* __restrict__ ptr, long long nseg,
                   double* __restrict__ out) {
  const long long s =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= nseg) return;
  const long long end = ptr[s + 1];
  double acc = 0.0;
#pragma unroll 8
  for (long long k = ptr[s]; k < end; ++k) {
    const double x = values[kOrdered ? order[k] : k];
    acc = __dadd_rn(acc, kSquare ? __dmul_rn(x, x) : fabs(x));
  }
  out[s] = acc;
}

template <bool kSquare, bool kOrdered>
void launch(const void* values, const void* order, const void* ptr,
            long long nseg, void* out, cudaStream_t stream) {
  const long long grid = (nseg + kThreads - 1) / kThreads;
  segment_sum_kernel<kSquare, kOrdered>
      <<<static_cast<unsigned int>(grid), kThreads, 0, stream>>>(
          static_cast<const double*>(values),
          static_cast<const long long*>(order),
          static_cast<const long long*>(ptr), nseg,
          static_cast<double*>(out));
}

__global__ void __launch_bounds__(kThreads)
signed_dot_kernel(const double* __restrict__ values,
                  const int* __restrict__ cols,
                  const long long* __restrict__ ptr, long long nseg,
                  const double* __restrict__ x1,
                  const double* __restrict__ x2,
                  double* __restrict__ out) {
  const long long s =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= nseg) return;
  const long long end = ptr[s + 1];
  double pos1 = 0.0, neg2 = 0.0, pos2 = 0.0, neg1 = 0.0;
#pragma unroll 4
  for (long long k = ptr[s]; k < end; ++k) {
    const double v = values[k];
    const int j = cols[k];
    const double a = x1[j];
    const double b = x2[j];
    if (v > 0.0) {
      pos1 = __dadd_rn(pos1, __dmul_rn(v, a));
      pos2 = __dadd_rn(pos2, __dmul_rn(v, b));
    } else if (v < 0.0) {
      neg2 = __dadd_rn(neg2, __dmul_rn(v, b));
      neg1 = __dadd_rn(neg1, __dmul_rn(v, a));
    }
  }
  out[s] = pos1;
  out[nseg + s] = neg2;
  out[2 * nseg + s] = pos2;
  out[3 * nseg + s] = neg1;
}

}  // namespace

// out[s] = sum over segment s of values^2 (square != 0) or |values|, in
// segment order; `order` may be null (the identity).
extern "C" int segment_sum_f64(const void* values, const void* order,
                               const void* ptr, long long nseg, int square,
                               void* out, void* stream) {
  if (nseg > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (square && order) {
      launch<true, true>(values, order, ptr, nseg, out, st);
    } else if (square) {
      launch<true, false>(values, order, ptr, nseg, out, st);
    } else if (order) {
      launch<false, true>(values, order, ptr, nseg, out, st);
    } else {
      launch<false, false>(values, order, ptr, nseg, out, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// out[0 * nseg + s] = sum of v * x1[col] over segment s's entries v > 0,
// out[1 * nseg + s] = of v * x2[col] over v < 0, out[2 * nseg + s] = of
// v * x2[col] over v > 0, out[3 * nseg + s] = of v * x1[col] over v < 0,
// each in segment order; `cols` holds 32-bit column indices.
extern "C" int segment_signed_dot_f64(const void* values, const void* cols,
                                      const void* ptr, long long nseg,
                                      const void* x1, const void* x2,
                                      void* out, void* stream) {
  if (nseg > 0) {
    const long long grid = (nseg + kThreads - 1) / kThreads;
    signed_dot_kernel<<<static_cast<unsigned int>(grid), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(values), static_cast<const int*>(cols),
        static_cast<const long long*>(ptr), nseg,
        static_cast<const double*>(x1), static_cast<const double*>(x2),
        static_cast<double*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
