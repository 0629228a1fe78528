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
// What it replaces.  No TPU kernel: the JAX package leaves this chain to
// XLA, which fuses it into a few loops inside the jitted inner block
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
// What bounds them.  Bytes, and below that the latency of one launch.
// The primal kernel reads six n-vectors (x, c, K'y, lo, up, x_anc) and
// writes three; the dual kernel reads five m-vectors (six with y_lo) and
// writes two: at the PDLP widths (50,176 and 65,536) that is 0.5-0.7 us
// of HBM time in f32, less than one launch and one memory round trip
// take (inside the PDLP loop's graphs the vectors come from the L2 and
// the launch is nearly all of it).  So the design cuts the fixed cost:
//
// - One memory round trip a thread.  Each thread issues all its loads,
//   the vectors' and then the scalars' (eta, omega, k), before any
//   arithmetic: the loads are volatile, so they keep that order and no
//   load waits behind the division that needs eta and omega
//   (chip_smoke.py fails if the SASS shows a global load after a
//   division).  Each thread then computes tau or sigma, w and 1 - w
//   itself: a block-wide broadcast from one thread (shared memory and a
//   barrier) measured slower inside the PDLP loop's graphs (PERF.md §6).
// - 16-byte accesses.  Every vector moves as float4 / double2, neighbour
//   threads on neighbour 16-byte words; a length off the vector grid has
//   a scalar tail (fewer than 4 elements), loaded in the same round trip
//   by the first threads.  Every pointer must start on a 16-byte
//   boundary: the wrapper refuses one that does not (a view that starts
//   inside its storage), and so does the entry point.
// - One wave.  The geometry (grid, threads, one or two vectors a thread)
//   comes from the wrapper (`launch_geometry` in ops/pdhg_step.py, which
//   the CPU tests check covers every element once): at the PDLP widths
//   one block of 96-256 threads on each of 128-131 SMs, one vector a
//   thread, one pass, no loop.
// - The loads bypass the L1: inside the PDLP loop's graphs the vectors
//   were written by the kernel before, and come from the L2.
//
// Programmatic dependent launch was measured (the kernels launched with
// cudaLaunchAttributeProgrammaticStreamSerialization, the iterates read
// after griddepcontrol.wait) and left out: inside the graphs it made
// every step slower, since the products ahead of the step kernels signal
// nothing early (PERF.md §6).
//
// A batch.  The same kernels take b instances at once (the batched LP
// solve runs every instance's step under torch.func.vmap): the vectors
// are (b, n) with the row stride `stride`, eta, omega and k are (b,)
// arrays, and blockIdx.y is the instance.  Each instance is covered by
// the same grid of blocks, so a block never spans two instances and reads
// its instance's scalars; the single-instance launch is the case b = 1.
// A row stride of a whole number of 16-byte words keeps every instance's
// first word on the 16-byte grid (the entry point checks it for b > 1).
//
// Plain C interface for ctypes: each entry point checks the geometry and
// the alignment, launches on the given stream, allocates nothing and
// returns the launch's error code.

#include <cuda_runtime.h>

#include <initializer_list>

namespace {

constexpr int kMaxThreads = 256;

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

// 16 bytes of T: the unit of every vector access
template <typename T>
struct alignas(16) Vec {
  static constexpr int kWidth = 16 / sizeof(T);
  T v[kWidth];
};

// Every load is volatile (ld.volatile.global), so the compiler keeps the
// loads in the order the source gives them (the plain ld.global.cg of
// __ldcg let ptxas hoist eta and omega, and the division after them,
// ahead of the vector loads in the f64 Halpern primal kernel).  Volatile
// loads are not cached in the L1, as .cg loads are not.
__device__ __forceinline__ Vec<float> load(const float* p) {
  Vec<float> a;
  asm volatile("ld.volatile.global.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(a.v[0]), "=f"(a.v[1]), "=f"(a.v[2]), "=f"(a.v[3])
               : "l"(p));
  return a;
}
__device__ __forceinline__ Vec<double> load(const double* p) {
  Vec<double> a;
  asm volatile("ld.volatile.global.v2.f64 {%0, %1}, [%2];"
               : "=d"(a.v[0]), "=d"(a.v[1])
               : "l"(p));
  return a;
}
__device__ __forceinline__ float load_one(const float* p) {
  float a;
  asm volatile("ld.volatile.global.f32 %0, [%1];" : "=f"(a) : "l"(p));
  return a;
}
__device__ __forceinline__ double load_one(const double* p) {
  double a;
  asm volatile("ld.volatile.global.f64 %0, [%1];" : "=d"(a) : "l"(p));
  return a;
}
__device__ __forceinline__ int load_one(const int* p) {
  int a;
  asm volatile("ld.volatile.global.s32 %0, [%1];" : "=r"(a) : "l"(p));
  return a;
}
__device__ __forceinline__ void store(float* p, const Vec<float>& a) {
  *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
}
__device__ __forceinline__ void store(double* p, const Vec<double>& a) {
  *reinterpret_cast<double2*>(p) = make_double2(a.v[0], a.v[1]);
}

// w = (k + 1) / (k + 2) and 1 - w, as torch computes them from the int32
// step count cast to T
template <typename T>
__device__ __forceinline__ void halpern_weights(int k, T* w, T* wc) {
  const T kf = static_cast<T>(k);
  *w = quo(add(kf, T(1)), add(kf, T(2)));
  *wc = sub(T(1), *w);
}

// one element of the primal half; returns x_pd, sets x_r and x_out
template <typename T, bool kHalpern>
__device__ __forceinline__ T primal_element(T xi, T ci, T ai, T loi, T upi,
                                            T anc, T tau, T w, T wc,
                                            T gamma, T gamma_c, T* r_out,
                                            T* out) {
  const T pd = nan_min(nan_max(sub(xi, mul(tau, sub(ci, ai))), loi), upi);
  const T r = sub(mul(T(2), pd), xi);
  *r_out = r;
  *out = kHalpern ? add(mul(w, add(mul(gamma, r), mul(gamma_c, xi))),
                        mul(wc, anc))
                  : add(anc, pd);
  return pd;
}

// one element of the dual half; returns y_pd, sets y_out
template <typename T, bool kHalpern, bool kYLo>
__device__ __forceinline__ T dual_element(T yi, T bi, T axi, T eqi, T ylo,
                                          T anc, T sigma, T w, T wc,
                                          T gamma, T gamma_c, T* out) {
  const T raw = add(yi, mul(sigma, sub(bi, axi)));
  const T cone = kYLo ? nan_max(raw, ylo) : nan_max(raw, T(0));
  const T pd = eqi > T(0) ? raw : cone;
  if (kHalpern) {
    const T r = sub(mul(T(2), pd), yi);
    *out = add(mul(w, add(mul(gamma, r), mul(gamma_c, yi))), mul(wc, anc));
  } else {
    *out = add(anc, pd);
  }
  return pd;
}

// Each thread owns kPer vectors of instance blockIdx.y (indices t,
// t + stride, ... with t its index in the row of blocks and stride that
// row's thread count) and, on threads 0 .. tail-1, one element of the
// scalar tail after the last vector.
template <typename T, int kPer, bool kHalpern>
__global__ void __launch_bounds__(kMaxThreads)
primal_kernel(const T* __restrict__ x, const T* __restrict__ c,
              const T* __restrict__ aty, const T* __restrict__ lo,
              const T* __restrict__ up, const T* __restrict__ x_anchor,
              const T* __restrict__ eta, const T* __restrict__ omega,
              const int* __restrict__ k, T gamma, T gamma_c,
              T* __restrict__ x_pd, T* __restrict__ x_r,
              T* __restrict__ x_out, long long vectors, int tail,
              long long row) {
  constexpr int W = Vec<T>::kWidth;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const bool has_tail = t < tail;
  const long long at = vectors * W + t;  // its tail element
  // this block's instance: its row of every vector, its scalars
  const long long base = static_cast<long long>(blockIdx.y) * row;
  x += base, c += base, aty += base, lo += base, up += base;
  x_anchor += base, x_pd += base, x_r += base, x_out += base;
  eta += blockIdx.y, omega += blockIdx.y, k += blockIdx.y;
  Vec<T> xv[kPer], cv[kPer], av[kPer], lov[kPer], upv[kPer], ancv[kPer];
  T xs = T(0), cs = T(0), as = T(0), los = T(0), ups = T(0), ancs = T(0);

  // every load, then the arithmetic
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long v = t + j * stride;
    if (v < vectors) {
      xv[j] = load(x + v * W);
      cv[j] = load(c + v * W);
      av[j] = load(aty + v * W);
      lov[j] = load(lo + v * W);
      upv[j] = load(up + v * W);
      ancv[j] = load(x_anchor + v * W);
    }
  }
  if (has_tail) {
    xs = load_one(x + at);
    cs = load_one(c + at);
    as = load_one(aty + at);
    los = load_one(lo + at);
    ups = load_one(up + at);
    ancs = load_one(x_anchor + at);
  }
  const T eta_v = load_one(eta), omega_v = load_one(omega);
  const int kk = kHalpern ? load_one(k) : 0;
  const T tau = quo(eta_v, omega_v);
  T w = T(0), wc = T(0);
  if (kHalpern) halpern_weights(kk, &w, &wc);

#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long v = t + j * stride;
    if (v < vectors) {
      Vec<T> pd, r, out;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        pd.v[e] = primal_element<T, kHalpern>(
            xv[j].v[e], cv[j].v[e], av[j].v[e], lov[j].v[e], upv[j].v[e],
            ancv[j].v[e], tau, w, wc, gamma, gamma_c, &r.v[e], &out.v[e]);
      }
      store(x_pd + v * W, pd);
      store(x_r + v * W, r);
      store(x_out + v * W, out);
    }
  }
  if (has_tail) {
    T r, out;
    x_pd[at] = primal_element<T, kHalpern>(xs, cs, as, los, ups, ancs, tau,
                                           w, wc, gamma, gamma_c, &r, &out);
    x_r[at] = r;
    x_out[at] = out;
  }
}

template <typename T, int kPer, bool kHalpern, bool kYLo>
__global__ void __launch_bounds__(kMaxThreads)
dual_kernel(const T* __restrict__ y, const T* __restrict__ b,
            const T* __restrict__ ax_r, const T* __restrict__ is_eq,
            const T* __restrict__ y_lo, const T* __restrict__ y_anchor,
            const T* __restrict__ eta, const T* __restrict__ omega,
            const int* __restrict__ k, T gamma, T gamma_c,
            T* __restrict__ y_pd, T* __restrict__ y_out,
            int* __restrict__ k_next, long long vectors, int tail,
            long long row) {
  constexpr int W = Vec<T>::kWidth;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const bool has_tail = t < tail;
  const long long at = vectors * W + t;
  const long long base = static_cast<long long>(blockIdx.y) * row;
  y += base, b += base, ax_r += base, is_eq += base, y_anchor += base;
  if (kYLo) y_lo += base;
  y_pd += base, y_out += base;
  eta += blockIdx.y, omega += blockIdx.y, k += blockIdx.y;
  k_next += blockIdx.y;
  Vec<T> yv[kPer], bv[kPer], axv[kPer], eqv[kPer], lov[kPer], ancv[kPer];
  T ys = T(0), bs = T(0), axs = T(0), eqs = T(0), ylos = T(0), ancs = T(0);

  // every load, then the arithmetic
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long v = t + j * stride;
    if (v < vectors) {
      yv[j] = load(y + v * W);
      bv[j] = load(b + v * W);
      axv[j] = load(ax_r + v * W);
      eqv[j] = load(is_eq + v * W);
      if (kYLo) lov[j] = load(y_lo + v * W);
      ancv[j] = load(y_anchor + v * W);
    }
  }
  if (has_tail) {
    ys = load_one(y + at);
    bs = load_one(b + at);
    axs = load_one(ax_r + at);
    eqs = load_one(is_eq + at);
    if (kYLo) ylos = load_one(y_lo + at);
    ancs = load_one(y_anchor + at);
  }
  const T eta_v = load_one(eta), omega_v = load_one(omega);
  const int kk = load_one(k);
  const T sigma = mul(eta_v, omega_v);
  T w = T(0), wc = T(0);
  if (kHalpern) halpern_weights(kk, &w, &wc);
  if (t == 0) *k_next = kk + 1;  // one thread of the instance

#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long v = t + j * stride;
    if (v < vectors) {
      Vec<T> pd, out;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        pd.v[e] = dual_element<T, kHalpern, kYLo>(
            yv[j].v[e], bv[j].v[e], axv[j].v[e], eqv[j].v[e],
            kYLo ? lov[j].v[e] : T(0), ancv[j].v[e], sigma, w, wc, gamma,
            gamma_c, &out.v[e]);
      }
      store(y_pd + v * W, pd);
      store(y_out + v * W, out);
    }
  }
  if (has_tail) {
    T out;
    y_pd[at] = dual_element<T, kHalpern, kYLo>(ys, bs, axs, eqs, ylos, ancs,
                                               sigma, w, wc, gamma, gamma_c,
                                               &out);
    y_out[at] = out;
  }
}

// The launch geometry of ops/pdhg_step.py `launch_geometry`, checked:
// every element of each of the `batch` instances covered, 16-byte aligned
// vectors, and for a batch a row stride of whole 16-byte words, so that
// no word spans two instances.
struct Geometry {
  int batch;
  long long row;  // elements from one instance's row to the next
  int grid, threads, per_thread, tail;
  long long vectors;  // 16-byte words of one instance
};

template <typename T>
bool valid(const Geometry& g, long long n,
           std::initializer_list<const void*> ptrs) {
  constexpr int W = Vec<T>::kWidth;
  if (g.grid < 1 || g.threads < 32 || g.threads > kMaxThreads ||
      g.threads % 32 != 0 || (g.per_thread != 1 && g.per_thread != 2) ||
      g.tail < 0 || g.tail >= W || g.tail > g.threads || g.vectors < 0 ||
      g.vectors * W + g.tail != n ||
      static_cast<long long>(g.grid) * g.threads * g.per_thread < g.vectors)
    return false;
  if (g.batch < 1 || g.batch > 65535 || g.row < n ||
      (g.batch > 1 && g.row % W != 0))
    return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<unsigned long long>(p) % 16 != 0) return false;
  return true;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, const Geometry& g, void* stream, Args... args) {
  const dim3 blocks(g.grid, g.batch);
  kernel<<<blocks, g.threads, 0, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int primal(const void* x, const void* c, const void* aty, const void* lo,
           const void* up, const void* x_anchor, const void* eta,
           const void* omega, const void* k, double gamma, double gamma_c,
           int halpern, void* x_pd, void* x_r, void* x_out, long long n,
           const Geometry& g, void* stream) {
  if (!valid<T>(g, n, {x, c, aty, lo, up, x_anchor, x_pd, x_r, x_out}))
    return static_cast<int>(cudaErrorInvalidValue);
  auto go = [&](auto kernel) {
    return launch(kernel, g, stream, static_cast<const T*>(x),
                  static_cast<const T*>(c), static_cast<const T*>(aty),
                  static_cast<const T*>(lo), static_cast<const T*>(up),
                  static_cast<const T*>(x_anchor),
                  static_cast<const T*>(eta), static_cast<const T*>(omega),
                  static_cast<const int*>(k), static_cast<T>(gamma),
                  static_cast<T>(gamma_c), static_cast<T*>(x_pd),
                  static_cast<T*>(x_r), static_cast<T*>(x_out), g.vectors,
                  g.tail, g.row);
  };
  if (g.per_thread == 1)
    return halpern ? go(primal_kernel<T, 1, true>)
                   : go(primal_kernel<T, 1, false>);
  return halpern ? go(primal_kernel<T, 2, true>)
                 : go(primal_kernel<T, 2, false>);
}

template <typename T, int kPer>
int dual_per(const Geometry& g, void* stream, bool halpern, bool has_lo,
             const T* y, const T* b, const T* ax_r, const T* is_eq,
             const T* y_lo, const T* y_anchor, const T* eta, const T* omega,
             const int* k, T gamma, T gamma_c, T* y_pd, T* y_out,
             int* k_next) {
  auto go = [&](auto kernel) {
    return launch(kernel, g, stream, y, b, ax_r, is_eq, y_lo, y_anchor, eta,
                  omega, k, gamma, gamma_c, y_pd, y_out, k_next, g.vectors,
                  g.tail, g.row);
  };
  if (halpern)
    return has_lo ? go(dual_kernel<T, kPer, true, true>)
                  : go(dual_kernel<T, kPer, true, false>);
  return has_lo ? go(dual_kernel<T, kPer, false, true>)
                : go(dual_kernel<T, kPer, false, false>);
}

template <typename T>
int dual(const void* y, const void* b, const void* ax_r, const void* is_eq,
         const void* y_lo, const void* y_anchor, const void* eta,
         const void* omega, const void* k, double gamma, double gamma_c,
         int halpern, void* y_pd, void* y_out, void* k_next, long long m,
         const Geometry& g, void* stream) {
  const bool has_lo = y_lo != nullptr;
  if (!valid<T>(g, m, {y, b, ax_r, is_eq, has_lo ? y_lo : y, y_anchor, y_pd,
                       y_out}))
    return static_cast<int>(cudaErrorInvalidValue);
  auto per = g.per_thread == 1 ? &dual_per<T, 1> : &dual_per<T, 2>;
  return per(g, stream, halpern != 0, has_lo, static_cast<const T*>(y),
             static_cast<const T*>(b), static_cast<const T*>(ax_r),
             static_cast<const T*>(is_eq), static_cast<const T*>(y_lo),
             static_cast<const T*>(y_anchor), static_cast<const T*>(eta),
             static_cast<const T*>(omega), static_cast<const int*>(k),
             static_cast<T>(gamma), static_cast<T>(gamma_c),
             static_cast<T*>(y_pd), static_cast<T*>(y_out),
             static_cast<int*>(k_next));
}

}  // namespace

extern "C" int pdhg_primal_step_f32(
    const void* x, const void* c, const void* aty, const void* lo,
    const void* up, const void* x_anchor, const void* eta,
    const void* omega, const void* k, double gamma, double gamma_c,
    int halpern, void* x_pd, void* x_r, void* x_out, long long n,
    int batch, long long row, int grid, int threads, int per_thread,
    long long vectors, int tail, void* stream) {
  return primal<float>(x, c, aty, lo, up, x_anchor, eta, omega, k, gamma,
                       gamma_c, halpern, x_pd, x_r, x_out, n,
                       {batch, row, grid, threads, per_thread, tail,
                        vectors},
                       stream);
}

extern "C" int pdhg_primal_step_f64(
    const void* x, const void* c, const void* aty, const void* lo,
    const void* up, const void* x_anchor, const void* eta,
    const void* omega, const void* k, double gamma, double gamma_c,
    int halpern, void* x_pd, void* x_r, void* x_out, long long n,
    int batch, long long row, int grid, int threads, int per_thread,
    long long vectors, int tail, void* stream) {
  return primal<double>(x, c, aty, lo, up, x_anchor, eta, omega, k, gamma,
                        gamma_c, halpern, x_pd, x_r, x_out, n,
                        {batch, row, grid, threads, per_thread, tail,
                        vectors},
                       stream);
}

extern "C" int pdhg_dual_step_f32(
    const void* y, const void* b, const void* ax_r, const void* is_eq,
    const void* y_lo, const void* y_anchor, const void* eta,
    const void* omega, const void* k, double gamma, double gamma_c,
    int halpern, void* y_pd, void* y_out, void* k_next, long long m,
    int batch, long long row, int grid, int threads, int per_thread,
    long long vectors, int tail, void* stream) {
  return dual<float>(y, b, ax_r, is_eq, y_lo, y_anchor, eta, omega, k,
                     gamma, gamma_c, halpern, y_pd, y_out, k_next, m,
                     {batch, row, grid, threads, per_thread, tail, vectors},
                     stream);
}

extern "C" int pdhg_dual_step_f64(
    const void* y, const void* b, const void* ax_r, const void* is_eq,
    const void* y_lo, const void* y_anchor, const void* eta,
    const void* omega, const void* k, double gamma, double gamma_c,
    int halpern, void* y_pd, void* y_out, void* k_next, long long m,
    int batch, long long row, int grid, int threads, int per_thread,
    long long vectors, int tail, void* stream) {
  return dual<double>(y, b, ax_r, is_eq, y_lo, y_anchor, eta, omega, k,
                      gamma, gamma_c, halpern, y_pd, y_out, k_next, m,
                      {batch, row, grid, threads, per_thread, tail, vectors},
                     stream);
}
