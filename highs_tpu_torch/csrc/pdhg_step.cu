// The elementwise chain of one PDHG step for Hopper (sm_90a), as two
// kernels around the step's two products (K x_r, then K' y_new):
//
//   pdhg_primal_step  x_pd = min(max(x - tau (c - K'y), lo), up),
//                     x_r  = 2 x_pd - x, and
//                     Halpern: x_new = w (g x_r + (1 - g) x) + (1 - w) x_anc
//                     average: x_sum = x_anc + x_pd;
//   pdhg_dual_step    y_raw = y + sigma (b - K x_r),
//                     y_pd  = y_raw on equality rows, else
//                             max(y_raw, y_lo) (y_lo = 0 without one),
//                     Halpern: y_r = 2 y_pd - y,
//                              y_new = w (g y_r + (1 - g) y) + (1 - w) y_anc
//                     average: y_sum = y_anc + y_pd;
//                     and k_next = k + 1 (one thread).
// with tau = eta / omega, sigma = eta * omega, w = (k + 1) / (k + 2) and
// g the Halpern reflection coefficient.
//
// No TPU kernel is replaced: the JAX package leaves this chain to XLA,
// which fuses it into a few loops inside the jitted inner block
// (highs_tpu/solvers/pdlp/pdhg.py:180 `_halpern_step`, :438
// `_avg_pdhg_step`).  In PyTorch the same chain is about 40 launches a
// step; here it is two.  eta, omega and k are read on the card through
// pointers, so a CUDA graph that captured a launch needs no host value
// when it is replayed.
//
// Rounding.  The kernels round every operation where the plain PyTorch
// chain (highs_tpu_torch/ops/pdhg_step.py `primal_step_plain`,
// `dual_step_plain`) rounds it, in the same order: each product, sum and
// difference through the _rn intrinsics (nvcc contracts none of them into
// an FMA), the divisions of tau and w correctly rounded as torch divides
// two tensors, max/min that return a NaN operand (first operand first)
// as torch.maximum, torch.minimum and clamp_min do, and the Python
// floats g and 1 - g rounded once to the data's type, as torch casts a
// Python scalar.  So on the card the kernels equal the plain chain bit
// for bit.
//
// Bound: bytes.  The primal kernel reads six n-vectors (x, c, K'y, lo,
// up, x_anc) and writes three; the dual kernel reads five m-vectors (six
// with y_lo) and writes two.  A handful of operations an element is far
// below the card's rate.  One thread an element, 256 threads a block:
// block64k's 65,536-vectors are 256 blocks, under two waves of the 132
// SMs, so the time is close to the per-launch floor.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }

// torch.maximum / torch.minimum / clamp_min on the card: a NaN operand
// is returned (the first one first), else ::max / ::min
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return ::max(a, b);
}

template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return ::min(a, b);
}

// w = (k + 1) / (k + 2) and 1 - w, as torch computes them from the int32
// step count cast to T
template <typename T>
__device__ __forceinline__ void halpern_weights(const int* k, T* w, T* wc) {
  const T kf = static_cast<T>(*k);
  *w = quo(add(kf, T(1)), add(kf, T(2)));
  *wc = sub(T(1), *w);
}

template <typename T, bool kHalpern>
__global__ void __launch_bounds__(kThreads)
primal_kernel(const T* __restrict__ x, const T* __restrict__ c,
              const T* __restrict__ aty, const T* __restrict__ lo,
              const T* __restrict__ up, const T* __restrict__ x_anchor,
              const T* __restrict__ eta, const T* __restrict__ omega,
              const int* __restrict__ k, T gamma, T gamma_c,
              T* __restrict__ x_pd, T* __restrict__ x_r,
              T* __restrict__ x_out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= n) return;
  const T tau = quo(*eta, *omega);
  const T xi = x[i];
  const T pd = nan_min(nan_max(sub(xi, mul(tau, sub(c[i], aty[i]))), lo[i]),
                       up[i]);
  const T r = sub(mul(T(2), pd), xi);
  x_pd[i] = pd;
  x_r[i] = r;
  if (kHalpern) {
    T w, wc;
    halpern_weights(k, &w, &wc);
    x_out[i] = add(mul(w, add(mul(gamma, r), mul(gamma_c, xi))),
                   mul(wc, x_anchor[i]));
  } else {
    x_out[i] = add(x_anchor[i], pd);
  }
}

template <typename T, bool kHalpern, bool kYLo>
__global__ void __launch_bounds__(kThreads)
dual_kernel(const T* __restrict__ y, const T* __restrict__ b,
            const T* __restrict__ ax_r, const T* __restrict__ is_eq,
            const T* __restrict__ y_lo, const T* __restrict__ y_anchor,
            const T* __restrict__ eta, const T* __restrict__ omega,
            const int* __restrict__ k, T gamma, T gamma_c,
            T* __restrict__ y_pd, T* __restrict__ y_out,
            int* __restrict__ k_next, long long m) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i == 0) *k_next = *k + 1;
  if (i >= m) return;
  const T sigma = mul(*eta, *omega);
  const T yi = y[i];
  const T raw = add(yi, mul(sigma, sub(b[i], ax_r[i])));
  const T cone = kYLo ? nan_max(raw, y_lo[i]) : nan_max(raw, T(0));
  const T pd = is_eq[i] > T(0) ? raw : cone;
  y_pd[i] = pd;
  if (kHalpern) {
    T w, wc;
    halpern_weights(k, &w, &wc);
    const T r = sub(mul(T(2), pd), yi);
    y_out[i] = add(mul(w, add(mul(gamma, r), mul(gamma_c, yi))),
                   mul(wc, y_anchor[i]));
  } else {
    y_out[i] = add(y_anchor[i], pd);
  }
}

unsigned grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks > 0 ? blocks : 1);
}

template <typename T>
int primal(const void* x, const void* c, const void* aty, const void* lo,
           const void* up, const void* x_anchor, const void* eta,
           const void* omega, const void* k, double gamma, double gamma_c,
           int halpern, void* x_pd, void* x_r, void* x_out, long long n,
           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid_for(n), kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(c),
        static_cast<const T*>(aty), static_cast<const T*>(lo),
        static_cast<const T*>(up), static_cast<const T*>(x_anchor),
        static_cast<const T*>(eta), static_cast<const T*>(omega),
        static_cast<const int*>(k), static_cast<T>(gamma),
        static_cast<T>(gamma_c), static_cast<T*>(x_pd),
        static_cast<T*>(x_r), static_cast<T*>(x_out), n);
  };
  if (halpern) {
    args(primal_kernel<T, true>);
  } else {
    args(primal_kernel<T, false>);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dual(const void* y, const void* b, const void* ax_r, const void* is_eq,
         const void* y_lo, const void* y_anchor, const void* eta,
         const void* omega, const void* k, double gamma, double gamma_c,
         int halpern, void* y_pd, void* y_out, void* k_next, long long m,
         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid_for(m), kThreads, 0, s>>>(
        static_cast<const T*>(y), static_cast<const T*>(b),
        static_cast<const T*>(ax_r), static_cast<const T*>(is_eq),
        static_cast<const T*>(y_lo), static_cast<const T*>(y_anchor),
        static_cast<const T*>(eta), static_cast<const T*>(omega),
        static_cast<const int*>(k), static_cast<T>(gamma),
        static_cast<T>(gamma_c), static_cast<T*>(y_pd),
        static_cast<T*>(y_out), static_cast<int*>(k_next), m);
  };
  const bool has_lo = y_lo != nullptr;
  if (halpern && has_lo) {
    args(dual_kernel<T, true, true>);
  } else if (halpern) {
    args(dual_kernel<T, true, false>);
  } else if (has_lo) {
    args(dual_kernel<T, false, true>);
  } else {
    args(dual_kernel<T, false, false>);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pdhg_primal_step_f32(
    const void* x, const void* c, const void* aty, const void* lo,
    const void* up, const void* x_anchor, const void* eta,
    const void* omega, const void* k, double gamma, double gamma_c,
    int halpern, void* x_pd, void* x_r, void* x_out, long long n,
    void* stream) {
  return primal<float>(x, c, aty, lo, up, x_anchor, eta, omega, k, gamma,
                       gamma_c, halpern, x_pd, x_r, x_out, n, stream);
}

extern "C" int pdhg_primal_step_f64(
    const void* x, const void* c, const void* aty, const void* lo,
    const void* up, const void* x_anchor, const void* eta,
    const void* omega, const void* k, double gamma, double gamma_c,
    int halpern, void* x_pd, void* x_r, void* x_out, long long n,
    void* stream) {
  return primal<double>(x, c, aty, lo, up, x_anchor, eta, omega, k, gamma,
                        gamma_c, halpern, x_pd, x_r, x_out, n, stream);
}

extern "C" int pdhg_dual_step_f32(
    const void* y, const void* b, const void* ax_r, const void* is_eq,
    const void* y_lo, const void* y_anchor, const void* eta,
    const void* omega, const void* k, double gamma, double gamma_c,
    int halpern, void* y_pd, void* y_out, void* k_next, long long m,
    void* stream) {
  return dual<float>(y, b, ax_r, is_eq, y_lo, y_anchor, eta, omega, k,
                     gamma, gamma_c, halpern, y_pd, y_out, k_next, m,
                     stream);
}

extern "C" int pdhg_dual_step_f64(
    const void* y, const void* b, const void* ax_r, const void* is_eq,
    const void* y_lo, const void* y_anchor, const void* eta,
    const void* omega, const void* k, double gamma, double gamma_c,
    int halpern, void* y_pd, void* y_out, void* k_next, long long m,
    void* stream) {
  return dual<double>(y, b, ax_r, is_eq, y_lo, y_anchor, eta, omega, k,
                      gamma, gamma_c, halpern, y_pd, y_out, k_next, m,
                      stream);
}
