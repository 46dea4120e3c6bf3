// Device helpers shared by the chord-Newton kernels of linalg.cu.
//
// The unfused Newton iteration (batched_linsolve, then masked_newton_update)
// and the fused one (batched_lu_factor once per step, then fused_newton_iter)
// must compute the same iterates bitwise on the card, as they do on the CPU.
// So the three pieces they share are written once, here:
//
// - lu_factor_block: the partial-pivoted elimination of one (f, f) matrix
//   by one thread block, in place in device memory, from lu_pivot_column
//   (one column's pivot, swap and multipliers) and lu_update_entry (one
//   entry's trailing fma), which linalg.cu's wide elimination launches
//   column by column over the whole card;
// - lu_substitute_block: the unit-lower, then upper, substitution against
//   those factors, column by column;
// - newton_norm_warp: the scaled RMS of one row of the update, by one warp.
//
// None of them depends on the thread count for its result: the pivot is the
// unique (largest magnitude, lowest row) candidate, every eliminated or
// substituted entry is updated by one fma per column in column order, and
// the norm's lane-strided sum and xor butterfly are those of a warp.

#pragma once

#include "solver_common.cuh"

namespace linalg {

using namespace solver;

constexpr int kThreads = 256;  // threads per block: one block per instance

// Candidate (mag, row) beats (other_mag, other_row): larger magnitude, then
// the lower row (LAPACK's i?amax and the Pallas kernel's first match).  A
// thread with no candidate carries mag -1, which every |a| beats.
template <typename T>
__device__ __forceinline__ bool beats(T mag, int row, T other_mag, int other_row) {
  return mag > other_mag || (mag == other_mag && row < other_row);
}

// The block-wide best (mag, row); every thread gets the result.
template <typename T>
__device__ int argmax_block(T mag, int row) {
  __shared__ T s_mag[32];
  __shared__ int s_row[32];
  __shared__ int s_best;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const T m = __shfl_xor_sync(0xffffffffu, mag, off);
    const int r = __shfl_xor_sync(0xffffffffu, row, off);
    if (beats(m, r, mag, row)) {
      mag = m;
      row = r;
    }
  }
  if (lane == 0) {
    s_mag[warp] = mag;
    s_row[warp] = row;
  }
  __syncthreads();
  if (warp == 0) {
    mag = lane < nwarps ? s_mag[lane] : T(-1);
    row = lane < nwarps ? s_row[lane] : 0x7fffffff;
    for (int off = 16; off > 0; off >>= 1) {
      const T m = __shfl_xor_sync(0xffffffffu, mag, off);
      const int r = __shfl_xor_sync(0xffffffffu, row, off);
      if (beats(m, r, mag, row)) {
        mag = m;
        row = r;
      }
    }
    if (lane == 0) s_best = row;
  }
  __syncthreads();
  return s_best;
}

// Column k of the elimination up to its trailing update: the pivot is the
// row of largest |a[r, k]|, r >= k (lowest row on ties; NaN is never chosen,
// and a column of NaN keeps row k), rows k and p swap (and so do perm[k]
// and perm[p]), and the multipliers below the diagonal are divided by the
// pivot -- a zero pivot leaves its column unscaled, as LAPACK's getrf does,
// and the substitution divides by it.  `perm` must be initialized before
// the call (argmax_block synchronizes ahead of the swap).  Every thread of
// the block must call it; the block is synchronized on return.
template <typename T>
__device__ void lu_pivot_column(T* __restrict__ a, int32_t* __restrict__ perm, int f, int k) {
  const int tid = threadIdx.x, nt = blockDim.x;
  T mag = T(-1);
  int row = k;
  for (int i = k + tid; i < f; i += nt) {
    const T v = abs_of(a[(int64_t)i * f + k]);
    if (v > mag) {  // rows ascend within a thread: the first of equals stays
      mag = v;
      row = i;
    }
  }
  const int p = argmax_block(mag, row);  // synchronizes the block
  if (p != k) {
    for (int j = tid; j < f; j += nt) {
      const T t = a[(int64_t)k * f + j];
      a[(int64_t)k * f + j] = a[(int64_t)p * f + j];
      a[(int64_t)p * f + j] = t;
    }
    if (tid == 0) {
      const int32_t t = perm[k];
      perm[k] = perm[p];
      perm[p] = t;
    }
  }
  __syncthreads();
  const T piv = a[(int64_t)k * f + k];
  if (piv != T(0)) {
    for (int i = k + 1 + tid; i < f; i += nt) a[(int64_t)i * f + k] /= piv;
  }
  __syncthreads();
}

// The trailing update of column k at entry (i, j), i, j > k: one fma.
template <typename T>
__device__ __forceinline__ void lu_update_entry(T* __restrict__ a, int f, int k, int i, int j,
                                                T l) {
  a[(int64_t)i * f + j] = fma_of(-l, a[(int64_t)k * f + j], a[(int64_t)i * f + j]);
}

// Partial-pivoted LU of the (f, f) row-major matrix `a`, in place: the
// unit-lower multipliers below the diagonal, U on and above, and `perm` the
// row permutation (a_in[perm] == L U): per column lu_pivot_column, then the
// trailing block takes one fma per entry.  Needs the whole block; every
// thread must call it.
template <typename T>
__device__ void lu_factor_block(T* __restrict__ a, int32_t* __restrict__ perm, int f) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = (nt + 31) >> 5;
  for (int i = tid; i < f; i += nt) perm[i] = i;
  for (int k = 0; k < f; ++k) {
    lu_pivot_column(a, perm, f, k);
    // Trailing update: a warp per row, lanes along the row (coalesced).
    for (int i = k + 1 + warp; i < f; i += nwarps) {
      const T l = a[(int64_t)i * f + k];
      for (int j = k + 1 + lane; j < f; j += 32) lu_update_entry(a, f, k, i, j, l);
    }
    __syncthreads();
  }
}

// Solve L U y = x for the packed factors `lu` of lu_factor_block: x (the
// permuted right-hand side, f entries the block may overwrite) goes through
// the unit-lower substitution in place, then the upper one writes y.  Column
// oriented: per column one synchronization and one fma per entry below (or
// above) the diagonal, so the work is O(f^2) against the factorization's
// O(f^3).  x must be shared memory (or memory the block alone touches); y is
// written by thread 0 only.  Every thread must call it; the block is
// synchronized on return.
template <typename T>
__device__ void lu_substitute_block(const T* __restrict__ lu, T* x, T* y, int f) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int j = 0; j < f; ++j) {
    __syncthreads();
    const T xj = x[j];
    for (int i = j + 1 + tid; i < f; i += nt) {
      x[i] = fma_of(-lu[(int64_t)i * f + j], xj, x[i]);
    }
  }
  for (int j = f - 1; j >= 0; --j) {
    __syncthreads();
    const T yj = x[j] / lu[(int64_t)j * f + j];
    if (tid == 0) y[j] = yj;
    for (int i = tid; i < j; i += nt) x[i] = fma_of(-lu[(int64_t)i * f + j], yj, x[i]);
  }
  __syncthreads();
}

// sqrt(sum_c (d[c] / s[c])^2 / f) over one row, by one warp: each lane sums
// its columns c = lane, lane + 32, ... in order, then the xor butterfly.
// Every lane returns the same bits.
template <typename T>
__device__ __forceinline__ T newton_norm_warp(const T* d, const T* __restrict__ s, int64_t f,
                                              int lane) {
  T sum = T(0);
  for (int64_t c = lane; c < f; c += 32) {
    const T r = d[c] / s[c];
    sum = fma_of(r, r, sum);
  }
  return wrms_finish(warp_sum(sum), f);
}

}  // namespace linalg
