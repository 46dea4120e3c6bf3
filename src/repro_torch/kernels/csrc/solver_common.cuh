// Device helpers shared by the solver kernels (solver_kernels.cu,
// fused_step.cu, events.cu and, through linalg_common.cuh, linalg.cu), and
// the host's shared-memory opt-in.
//
// Every piece of arithmetic that two kernels must round alike lives here
// once: the weighted stage sums of stage_accum / fused_update, the WRMS terms
// and warp reduction of error_norm, and the single-rounded operations that
// mirror one plain PyTorch op each.  The fused step kernels call the same
// functions as the unfused ones, so on the card a fused step computes
// bitwise the numbers that the unfused kernels compute.  The multiply-adds
// that the kernels fuse are written out as fma, and the ones that PyTorch
// rounds twice as __fmul_rn/__fadd_rn: what the compiler would contract in one
// kernel and not in another is not left to it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace solver {

constexpr int kMaxStages = 8;  // explicit tableaus in the repo have s <= 7
constexpr int kWarpsPerBlock = 8;

template <typename T>
struct Coeffs {
  T v[kMaxStages];
};

template <typename T>
inline Coeffs<T> load_coeffs(const double* host, int n) {
  Coeffs<T> c;
  for (int j = 0; j < kMaxStages; ++j) c.v[j] = j < n ? static_cast<T>(host[j]) : T(0);
  return c;
}

__device__ __forceinline__ float abs_of(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_of(double x) { return fabs(x); }
__device__ __forceinline__ float sqrt_of(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_of(double x) { return sqrt(x); }
__device__ __forceinline__ float fma_of(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_of(double a, double b, double c) { return fma(a, b, c); }

// One PyTorch elementwise op each: rounded on its own, never contracted.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// The dense-output cubic ((c3 * x + c2) * x + c1) * x + c0 at one element,
// as the plain versions (ref.interp_eval, ref.masked_bisect_refine) run it:
// a multiply, then an add, per degree, each rounded on its own.
template <typename T>
__device__ __forceinline__ T horner_rn(T c0, T c1, T c2, T c3, T x) {
  return add_rn(mul_rn(add_rn(mul_rn(add_rn(mul_rn(c3, x), c2), x), c1), x), c0);
}

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  // jnp.maximum / torch.maximum propagate NaN; fmax would drop it.
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}

// sum_j w1[j] * k(j) and sum_j w2[j] * k(j) for j < n, accumulated in the
// plain version's order (j = 0, 1, ...), each k(j) loaded once.
template <typename T, typename Load>
__device__ __forceinline__ void weighted_sums(const Coeffs<T>& w1, const Coeffs<T>& w2, int n,
                                              Load k, T& acc1, T& acc2) {
  acc1 = T(0);
  acc2 = T(0);
#pragma unroll
  for (int j = 0; j < kMaxStages; ++j) {
    if (j < n) {
      const T kj = k(j);
      acc1 = fma_of(w1.v[j], kj, acc1);
      acc2 = fma_of(w2.v[j], kj, acc2);
    }
  }
}

template <typename T, typename Load>
__device__ __forceinline__ T weighted_sum(const Coeffs<T>& w, int n, Load k) {
  T acc = T(0);
#pragma unroll
  for (int j = 0; j < kMaxStages; ++j) {
    if (j < n) acc = fma_of(w.v[j], k(j), acc);
  }
  return acc;
}

// weighted_sum and weighted_sums with the count N a template argument: every
// k(j) is taken before the first fma, with no run-time select, so the loads
// behind them issue together; then the same fmas in the same order, so the
// same bits as the run-time versions at n = N.
template <int N, typename T, typename Load>
__device__ __forceinline__ T weighted_sum_n(const Coeffs<T>& w, Load k) {
  T kj[N];
#pragma unroll
  for (int j = 0; j < N; ++j) kj[j] = k(j);
  T acc = T(0);
#pragma unroll
  for (int j = 0; j < N; ++j) acc = fma_of(w.v[j], kj[j], acc);
  return acc;
}

template <int N, typename T, typename Load>
__device__ __forceinline__ void weighted_sums_n(const Coeffs<T>& w1, const Coeffs<T>& w2,
                                                Load k, T& acc1, T& acc2) {
  T kj[N];
#pragma unroll
  for (int j = 0; j < N; ++j) kj[j] = k(j);
  acc1 = T(0);
  acc2 = T(0);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    acc1 = fma_of(w1.v[j], kj[j], acc1);
    acc2 = fma_of(w2.v[j], kj[j], acc2);
  }
}

// V entries of T: one 16-byte chunk (V = 16 / sizeof(T)), or one entry.
template <typename T, int V>
struct Vec {
  T v[V];
};

// A V-entry chunk from device memory through the read-only path.
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_chunk(const T* p) {
  if constexpr (V == 1) {
    return Vec<T, 1>{{__ldg(p)}};
  } else {
    union {
      uint4 raw;
      Vec<T, V> c;
    } u;
    u.raw = __ldg(reinterpret_cast<const uint4*>(p));
    return u.c;
  }
}

// A V-entry chunk from shared memory.
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> shared_chunk(const T* p) {
  if constexpr (V == 1) {
    return Vec<T, 1>{{*p}};
  } else {
    union {
      uint4 raw;
      Vec<T, V> c;
    } u;
    u.raw = *reinterpret_cast<const uint4*>(p);
    return u.c;
  }
}

// A V-entry chunk to device or shared memory.
template <typename T, int V>
__device__ __forceinline__ void store_chunk(T* p, const Vec<T, V>& c) {
  if constexpr (V == 1) {
    *p = c.v[0];
  } else {
    union {
      uint4 raw;
      Vec<T, V> c;
    } u;
    u.c = c;
    *reinterpret_cast<uint4*>(p) = u.raw;
  }
}

// A null pointer, or one on a 16-byte boundary.
inline bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A scalar, (b,) or (b, f) tolerance: by value when p is null, else through
// (row, column) strides, 0 on a broadcast axis.  `mode` says how a kernel
// laid out in V-entry chunks reads a row of it (make_tol's V): one value a
// row (kTolRow: by value, or a (b,) tolerance read once a row), a chunk at a
// time (kTolChunk: unit column stride, on a 16-byte boundary, rows a whole
// number of chunks apart), or entry by entry (kTolEntry).
enum TolMode : int { kTolRow = 0, kTolChunk = 1, kTolEntry = 2 };

template <typename T>
struct Tol {
  const T* p;
  T val;
  int64_t rs, cs;
  int mode;
  __device__ __forceinline__ T at(int64_t row, int64_t c) const {
    return p ? p[row * rs + c * cs] : val;
  }
  // Row `row` alone, its columns from 0; a value a row is read here, once.
  __device__ __forceinline__ Tol row_of(int64_t row) const {
    if (!p) return *this;
    if (mode == kTolRow) return Tol{nullptr, __ldg(p + row * rs), 0, 0, kTolRow};
    return Tol{p + row * rs, val, 0, cs, mode};
  }
  // Columns c .. c + V - 1 of a row_of view.  kEntries false: the caller
  // knows the mode is kTolRow, so no pointer is kept.
  template <int V, bool kEntries>
  __device__ __forceinline__ Vec<T, V> chunk(int c) const {
    if (kEntries && mode == kTolChunk) return load_chunk<T, V>(p + c);
    Vec<T, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e) o.v[e] = kEntries && mode == kTolEntry ? __ldg(p + (c + e) * cs) : val;
    return o;
  }
};

template <typename T>
inline Tol<T> make_tol(const void* p, double val, int64_t rs, int64_t cs, int V = 1) {
  const auto tp = static_cast<const T*>(p);
  const int mode = !tp || cs == 0 ? kTolRow
                   : V > 1 && cs == 1 && aligned16(tp) && rs % V == 0 ? kTolChunk
                                                                      : kTolEntry;
  return Tol<T>{tp, static_cast<T>(val), rs, cs, mode};
}

// One element's scaled error err / (atol + rtol * max(|y0|, |y1|)), and its
// term of error_norm's sum of squares: sum + r^2.
template <typename T>
__device__ __forceinline__ T wrms_scaled(T err, T y0, T y1, T at, T rt) {
  const T scale = fma_of(rt, nan_max(abs_of(y0), abs_of(y1)), at);
  return err / scale;
}

template <typename T>
__device__ __forceinline__ T wrms_add(T sum, T err, T y0, T y1, T at, T rt) {
  const T r = wrms_scaled(err, y0, y1, at, rt);
  return fma_of(r, r, sum);
}

// error_norm's sum of squares has one fixed order, which every kernel that
// computes a WRMS ratio keeps (solver_kernels.cu's error_norm bodies,
// fused_step.cu's warp body and row_finish), so a fused step's ratio is
// bitwise its unfused step's: lane l of a warp folds wrms_add for c = l,
// l + 32, ... in increasing c, then warp_sum, then wrms_finish.

// Sum over the warp by xor butterfly: every lane ends with the same bits.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ T wrms_finish(T sum, int64_t f) {
  return sqrt_of(sum / static_cast<T>(f));
}

// mbarriers and bulk copies by the TMA unit (linalg_common.cuh's panel ring,
// error_norm's wide body).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One arrival on the barrier, which then also waits for `bytes` more bytes
// of bulk copies.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// A bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from device to shared memory by the TMA unit, completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Dynamic shared memory above the default needs an opt-in per kernel.
constexpr size_t kDefaultSmem = 48 * 1024;

// The dynamic shared memory `kernel` may ask for on the current device.
template <typename Kernel>
cudaError_t dynamic_smem_limit(Kernel kernel, size_t* limit) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess) *limit = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  return e;
}

// Check `smem` against the limit and, above the default, opt the kernel in.
template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t smem) {
  size_t limit = 0;
  cudaError_t e = dynamic_smem_limit(kernel, &limit);
  if (e != cudaSuccess) return e;
  if (smem > limit) return cudaErrorInvalidValue;
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace solver
