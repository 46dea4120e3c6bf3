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
//   column by column over the whole card; and lu_factor_staged, the same
//   elimination of a matrix staged in shared memory (same pivots, same
//   division, same fma per entry in the same column order: the same bits);
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

// The staged elimination: the (f, f) matrix in shared memory at row stride
// f + 1 (a column's entries fall in distinct banks), then f multipliers,
// then the int32 permutation -- and, for batched_linsolve, the f-entry
// right-hand side.  linalg.cu stages when this fits the device's opt-in
// shared memory (on an H100 f <= 239 / 238 in float32 for the LU / the
// linsolve, 169 / 168 in float64).
template <typename T>
__host__ __device__ constexpr size_t staged_smem_bytes(int64_t f, bool with_rhs) {
  return sizeof(T) * static_cast<size_t>(f * (f + 1) + f + (with_rhs ? f : 0)) +
         sizeof(int32_t) * static_cast<size_t>(f);
}

// The pivot row of column k of the staged matrix `s` (row stride ld), by
// one warp: each lane keeps the first of its largest |s[i, k]| over rows
// k + lane, k + lane + 32, ..., then the xor butterfly with `beats` --
// the (largest magnitude, lowest row) candidate of argmax_block, NaN never
// chosen, row k for a column without a candidate.  Every lane returns it.
template <typename T>
__device__ __forceinline__ int staged_pivot(const T* s, int ld, int f, int k, int lane) {
  T mag = T(-1);
  int row = k;
  for (int i = k + lane; i < f; i += 32) {
    const T v = abs_of(s[i * ld + k]);
    if (v > mag) {
      mag = v;
      row = i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T m = __shfl_xor_sync(0xffffffffu, mag, off);
    const int r = __shfl_xor_sync(0xffffffffu, row, off);
    if (beats(m, r, mag, row)) {
      mag = m;
      row = r;
    }
  }
  return row;
}

// lu_factor_block on the matrix `s` staged in shared memory (row stride ld
// = f + 1), with `mult` (f entries) and `perm` (f, written here) in shared
// memory too, for f <= 32 NC; the caller stages `s` (its first barrier
// covers the staging).  Per column k
// two barriers instead of four: every warp finds the same pivot p over
// column k (a read-only pass, so no barrier guards it); then rows k and p
// swap outside column k while the multipliers (row i's entry after the
// swap, divided by the pivot unless it is zero) go to `mult`; after one
// barrier, column k takes the pivot and the multipliers and the trailing
// block its fma per entry (lu_update_entry's, with the same operands);
// then the second barrier.  The block is synchronized on return.
constexpr int kStagedCols = 8;  // column chunks of 32: f <= 256 covers every staged width

template <typename T, int NC>
__device__ void lu_factor_staged(T* s, int ld, T* mult, int32_t* perm, int f) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  for (int i = tid; i < f; i += nt) perm[i] = i;
  __syncthreads();
  for (int k = 0; k < f; ++k) {
    const int p = staged_pivot(s, ld, f, k, lane);
    const T piv = s[p * ld + k];
    if (p != k) {
      for (int j = tid; j < f; j += nt) {
        if (j == k) continue;
        const T t = s[k * ld + j];
        s[k * ld + j] = s[p * ld + j];
        s[p * ld + j] = t;
      }
      if (tid == 0) {
        const int32_t t = perm[k];
        perm[k] = perm[p];
        perm[p] = t;
      }
    }
    for (int i = k + 1 + tid; i < f; i += nt) {
      const T a = s[(i == p ? k : i) * ld + k];
      mult[i] = piv != T(0) ? a / piv : a;
    }
    __syncthreads();
    if (tid == 0) s[k * ld + k] = piv;
    for (int i = k + 1 + tid; i < f; i += nt) s[i * ld + k] = mult[i];
    // Trailing update: lanes along a row (consecutive banks), warps over the
    // rows.  A lane holds its columns' u[k, j] in registers (chunk c: j = k
    // + 1 + lane + 32 c, the live chunks only) and reads each row's
    // multiplier once, so an entry costs one load and one store; each entry
    // takes lu_update_entry's fma with the same operands.
    const int live = (f - k + 30) >> 5;  // chunks holding a column > k
    T u[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = k + 1 + lane + 32 * c;
      u[c] = j < f ? s[k * ld + j] : T(0);
    }
    // Four of the warp's rows at a time: every load is issued before the
    // first store, so the rows' shared-memory round trips overlap.
    int i = k + 1 + warp;
    for (; i + 3 * nwarps < f; i += 4 * nwarps) {
      T l[4], a[4][NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        l[r] = mult[i + r * nwarps];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int j = k + 1 + lane + 32 * c;
          a[r][c] = c < live && j < f ? s[(i + r * nwarps) * ld + j] : T(0);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int j = k + 1 + lane + 32 * c;
          if (c < live && j < f) s[(i + r * nwarps) * ld + j] = fma_of(-l[r], u[c], a[r][c]);
        }
    }
    for (; i < f; i += nwarps) {
      const T l = mult[i];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c >= live) break;
        const int j = k + 1 + lane + 32 * c;
        if (j < f) s[i * ld + j] = fma_of(-l, u[c], s[i * ld + j]);
      }
    }
    __syncthreads();
  }
}

// Solve L U y = x for the packed factors `lu` (row stride ld) of
// lu_factor_block or lu_factor_staged: x (the permuted right-hand side, f
// entries the block may overwrite) goes through the unit-lower substitution
// in place, then the upper one writes y.  Column oriented: per column one
// synchronization and one fma per entry below (or above) the diagonal, so
// the work is O(f^2) against the factorization's O(f^3).  `lu` may lie in
// device or shared memory: the arithmetic is the same.  x must be shared
// memory (or memory the block alone touches); y is written by thread 0
// only.  Every thread must call it; the block is synchronized on return.
template <typename T>
__device__ void lu_substitute_block(const T* __restrict__ lu, int64_t ld, T* x, T* y, int f) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int j = 0; j < f; ++j) {
    __syncthreads();
    const T xj = x[j];
    for (int i = j + 1 + tid; i < f; i += nt) {
      x[i] = fma_of(-lu[i * ld + j], xj, x[i]);
    }
  }
  for (int j = f - 1; j >= 0; --j) {
    __syncthreads();
    const T yj = x[j] / lu[j * ld + j];
    if (tid == 0) y[j] = yj;
    for (int i = tid; i < j; i += nt) x[i] = fma_of(-lu[i * ld + j], yj, x[i]);
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
