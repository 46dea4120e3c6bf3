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
//   those factors, column by column (batched_linsolve, and
//   fused_newton_iter's column body); lu_substitute_panels, the same
//   substitution with the factors streamed through shared memory and the
//   columns taken 32 at a time (fused_newton_iter's panel body): the same
//   fma per entry in the same column order, so the same bits;
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

// ------------------------------------------------ the panel substitution
// lu_substitute_panels: the substitution of lu_substitute_block with the
// factors streamed through shared memory in 32 x 32 tiles, for
// fused_newton_iter.
//
// Contract (what keeps the fused Newton iteration bitwise equal to the
// unfused one, whose batched_linsolve substitutes with lu_substitute_block):
// every x[i] receives fma_of(-lu[i, j], x[j], x[i]) for j ascending in the
// forward pass, with x[j] final; in the backward pass yj = x[j] / lu[j, j]
// (correctly rounded: `quotient` below gives the bits of x[j] / lu[j, j])
// and then every x[i], i < j, receives fma_of(-lu[i, j], yj, x[i]) for j
// descending.  Only the grouping of that work changes: the same operands in
// the same order per entry, so the same bits.
//
// Grouping: columns in panels of 32, rows in tiles of 32 (tile row r holds
// rows 32 r .. 32 r + 31; its x entries are owned by consumer warp r % nw,
// lane = row).  Per panel c the owner of tile row c solves the 32 x 32
// diagonal triangle alone, with warp shuffles, x in registers; one consumer
// barrier publishes the panel's final x (forward) or y (backward) entries;
// then each owner of a tile row below (forward) or above (backward) applies
// the panel's 32 fmas to its rows, one lane per row, from shared memory.
// So a panel costs one barrier where the column loop pays 32.
//
// The tiles come from device memory once each, in the order of use:
// forward, panel by panel, the diagonal tile and then the tiles below it;
// backward, right to left, the diagonal tile and then the tiles above it (the
// last forward tile is the first backward one and is kept).  A producer warp
// (the block's last) copies them into a ring of kRingStages<T> slots: where
// every row of the matrix starts 16-byte aligned (f a multiple of 16 /
// sizeof(T)), a tile row by one bulk copy of the TMA unit (lane = row), so
// the copies take no load/store slots from the consumers' shuffles and
// shared-memory reads; else one cp.async per entry.  Each slot has a `full`
// mbarrier (the copies complete on it) and an `empty` one (every consumer warp arrives once: the warp that
// works on the tile when it is done, the others as they pass it), so the
// next tiles are in flight while the consumers work.  A tile row is
// padded by 16 bytes (kTileLd), so the 32 lanes' 16-byte reads of their rows
// fall in distinct banks.
constexpr int kPanel = 32;          // a panel's columns, a tile's rows
constexpr int kPanelConsumers = 4;  // consumer warps at most; one producer warp beside them
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // entries per 16-byte copy
template <typename T>
constexpr int kTileLd = kPanel + kVec<T>;  // a tile's row stride in shared memory
template <typename T>
constexpr int kRingStages = sizeof(T) == 4 ? 4 : 3;  // 18 / 26 KiB of tiles

// The dynamic shared memory of the panel substitution: the ring (two
// mbarriers a slot, then the tiles), then x (f entries, rounded up to 16
// bytes).
template <typename T>
constexpr size_t kPanelRingBytes =
    16 * kRingStages<T> + sizeof(T) * kRingStages<T> * kPanel * kTileLd<T>;
template <typename T>
__host__ __device__ constexpr size_t panel_smem_bytes(int64_t f) {
  return kPanelRingBytes<T> +
         static_cast<size_t>((f * static_cast<int64_t>(sizeof(T)) + 15) / 16 * 16);
}

// The block's threads for width f: a consumer warp per tile row up to
// kPanelConsumers, and the producer warp.
__host__ __device__ constexpr int panel_threads(int64_t f) {
  const int64_t tiles = (f + kPanel - 1) / kPanel;
  return 32 * (1 + static_cast<int>(tiles < kPanelConsumers ? tiles : kPanelConsumers));
}

// An asynchronous copy of one entry (N = 4 or 8 bytes) from device to
// shared memory.
template <int N>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src), "n"(N)
               : "memory");
}

// The barrier receives one arrival once this thread's earlier cp.asyncs land.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// The consumer warps' barrier (named barrier 1; the producer warp is not in it).
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// The ring's item index of tile (r, c) in the forward pass (panels left to
// right, in each the diagonal tile, then the tiles below) and the backward
// pass (right to left, the diagonal tile, then the tiles above; its first
// item is the forward pass's last).  nt tiles a side; items 2 F - 1 in all,
// F = nt (nt + 1) / 2.
__device__ __forceinline__ int fwd_item(int nt, int r, int c) {
  return c * nt - c * (c - 1) / 2 + (r - c);
}
__device__ __forceinline__ int bwd_item(int nt, int r, int c) {
  return nt * (nt + 1) - 1 - (c + 1) * (c + 2) / 2 + (c - r);
}

// One 16-byte chunk (kVec<T> entries) of shared memory.
template <typename T>
struct Chunk {
  T v[kVec<T>];
};
template <typename T>
__device__ __forceinline__ Chunk<T> load_chunk(const T* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  return *reinterpret_cast<const Chunk<T>*>(&raw);
}

// x / u for the backward triangle's chain, with the division's u-only part
// taken ahead: r = 1 / u (correctly rounded), then q = x r and two
// corrections q += (x - u q) r, each residual exact by fma.  The second
// correction starts within an ulp of x / u with r within half an ulp of
// 1 / u, so it rounds to the correctly rounded quotient (Markstein's
// theorem) -- the bits of x / u -- as long as nothing underflows or
// overflows: |x| and |u| within [2^-60, 2^60) in float32 ([2^-500, 2^500)
// in float64).  Anything else (zeros, subnormals, infinities, NaN, huge or
// tiny values) takes x / u itself, out of line.  The chain then holds 5
// dependent multiply-adds where the division's own sequence (reciprocal,
// refinement, range check) held many more.
template <typename T>
struct Divisor {
  T u, r;
  bool ok;
};
template <typename T>
__device__ __forceinline__ bool div_in_range(T a) {
  constexpr T lo = sizeof(T) == 4 ? T(0x1p-60) : T(0x1p-500);
  constexpr T hi = sizeof(T) == 4 ? T(0x1p60) : T(0x1p500);
  return abs_of(a) >= lo && abs_of(a) < hi;  // false for NaN
}
template <typename T>
__device__ __noinline__ T divide(T x, T u) {
  return x / u;
}
template <typename T>
__device__ __forceinline__ Divisor<T> divisor(T u) {
  return {u, divide(T(1), u), div_in_range(u)};
}
template <typename T>
__device__ __forceinline__ T quotient(T x, const Divisor<T>& d) {
  if (d.ok && div_in_range(x)) {
    const T q = mul_rn(x, d.r);
    const T q1 = fma_of(fma_of(-d.u, q, x), d.r, q);
    return fma_of(fma_of(-d.u, q1, x), d.r, q1);
  }
  return divide(x, d.u);
}

// The 32 x 32 diagonal triangles, by one warp: lane l holds x[c0 + l] in
// `xl` and `row` points to row l of the tile (row stride kTileLd<T>, in
// shared memory); ncol <= 32 columns lie within f.  Forward: x[l] -= l[l, j]
// x[j], j ascending; backward: y[j] = x[j] / u[j, j] (`quotient`), then
// x[l] -= u[l, j] y[j], j descending, and lane j keeps y[j].  The column's
// x (or y) moves by shuffle: no barrier, one shuffle and one multiply-add
// (and in the backward pass a `quotient`) per column on the chain.  A full
// tile (ncol = 32) takes a loop without bounds checks.
template <typename T, bool kFull>
__device__ __forceinline__ T triangle_fwd_cols(const T* row, T xl, int ncol, int lane) {
  constexpr int V = kVec<T>, CPR = kPanel / V;
#pragma unroll
  for (int q = 0; q < CPR; ++q) {
    const Chunk<T> a = load_chunk(row + q * V);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int jj = q * V + e;
      if (kFull || jj < ncol) {
        const T xj = __shfl_sync(0xffffffffu, xl, jj);
        if (lane > jj) xl = fma_of(-a.v[e], xj, xl);
      }
    }
  }
  return xl;
}

template <typename T>
__device__ __forceinline__ T triangle_fwd(const T* row, T xl, int ncol, int lane) {
  return ncol == kPanel ? triangle_fwd_cols<T, true>(row, xl, ncol, lane)
                        : triangle_fwd_cols<T, false>(row, xl, ncol, lane);
}

template <typename T, bool kFull>
__device__ __forceinline__ T triangle_bwd_cols(const T* row, T xl, int ncol, int lane) {
  constexpr int V = kVec<T>, CPR = kPanel / V;
  const Divisor<T> d = divisor(row[lane]);  // this lane's diagonal entry
#pragma unroll
  for (int q = CPR - 1; q >= 0; --q) {
    const Chunk<T> a = load_chunk(row + q * V);
#pragma unroll
    for (int e = V - 1; e >= 0; --e) {
      const int jj = q * V + e;
      if (kFull || jj < ncol) {
        T yj = T(0);
        if (lane == jj) yj = quotient(xl, d);
        yj = __shfl_sync(0xffffffffu, yj, jj);
        if (lane == jj) {
          xl = yj;
        } else if (lane < jj) {
          xl = fma_of(-a.v[e], yj, xl);
        }
      }
    }
  }
  return xl;
}

template <typename T>
__device__ __forceinline__ T triangle_bwd(const T* row, T xl, int ncol, int lane) {
  return ncol == kPanel ? triangle_bwd_cols<T, true>(row, xl, ncol, lane)
                        : triangle_bwd_cols<T, false>(row, xl, ncol, lane);
}

// Whether every row of the matrix starts 16-byte aligned: then a tile row's
// columns go by one bulk copy (the TMA unit; lane = row), else by one
// cp.async per entry.
template <typename T>
__device__ __forceinline__ bool rows_aligned(const T* lu, int f) {
  return f % kVec<T> == 0 && (reinterpret_cast<uintptr_t>(lu) & 15) == 0;
}

// The producer: every tile in the order of use into the ring.
template <typename T>
__device__ void panel_producer(const T* __restrict__ lu, int f, int nt, T* ring, uint32_t full,
                               uint32_t empty, int lane) {
  constexpr int S = kRingStages<T>, LD = kTileLd<T>;
  const bool bulk = rows_aligned(lu, f);
  int n = 0;
  auto load = [&](int r, int c) {
    const int s = n % S;
    if (n >= S) mbar_wait(empty + 8 * s, (n / S - 1) & 1);
    T* tile = ring + s * kPanel * LD;
    const int r0 = r * kPanel, c0 = c * kPanel, ncol = min(kPanel, f - c0);
    const int rows = min(kPanel, f - r0);
    if (bulk) {  // ncol is a multiple of 16 / sizeof(T)
      const uint32_t bytes = ncol * sizeof(T);
      if (lane == 0) mbar_expect_tx(full + 8 * s, rows * bytes);
      __syncwarp();
      if (lane < rows) {
        bulk_copy(smem_u32(tile + lane * LD), lu + (int64_t)(r0 + lane) * f + c0, bytes,
                  full + 8 * s);
      }
    } else {
      if (lane < ncol) {
        for (int row = 0; row < rows; ++row) {
          cp_async<static_cast<int>(sizeof(T))>(smem_u32(tile + row * LD + lane),
                                                lu + (int64_t)(r0 + row) * f + c0 + lane);
        }
      }
      cp_async_arrive(full + 8 * s);
    }
    ++n;
  };
  for (int c = 0; c < nt; ++c)
    for (int r = c; r < nt; ++r) load(r, c);
  for (int c = nt - 1; c >= 0; --c)
    for (int r = c == nt - 1 ? c - 1 : c; r >= 0; --r) load(r, c);
}

// Solve L U y = x in place for the packed factors `lu` (row-major, row
// stride f, in device memory) by the contract above: x (f entries of shared
// memory, 16-byte aligned) holds the permuted right-hand side on entry and y
// on return.  `smem` holds the ring (kPanelRingBytes<T>).  The block has panel_threads(f) threads;
// every thread must call it.  The caller's gather may still be writing x
// from the consumer warps: `gather(i)` is called here by the owner of row i,
// before that row is used.  The block is synchronized on return.
template <typename T, typename Gather>
__device__ void lu_substitute_panels(const T* __restrict__ lu, int f, T* x,
                                     unsigned char* smem, Gather gather) {
  constexpr int S = kRingStages<T>, V = kVec<T>, LD = kTileLd<T>, CPR = kPanel / V;
  const int nt = (f + kPanel - 1) / kPanel;
  const int nw = blockDim.x / 32 - 1;  // consumer warps; warp nw is the producer
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t full = smem_u32(smem), empty = full + 8 * S;
  T* ring = reinterpret_cast<T*>(smem + 16 * S);
  if (threadIdx.x == 0) {
    // `full`: the producer's one arrival with the bulk copies' bytes, or
    // its 32 lanes' cp.async arrivals.
    const uint32_t arrivals = rows_aligned(lu, f) ? 1 : 32;
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, arrivals);
      mbar_init(empty + 8 * s, nw);
    }
  }
  __syncthreads();
  if (warp == nw) {
    panel_producer(lu, f, nt, ring, full, empty, lane);
  } else {
    // Every consumer warp waits for every tile in ring order and arrives on
    // its `empty` barrier once: the tiles it works on after its work, the
    // others as it passes them.  So a slot is refilled only after every
    // warp has seen its tile, and a parity wait never meets a barrier two
    // phases behind it.
    int seen = 0;  // tiles this warp has waited for
    auto wait_tile = [&](int n) { mbar_wait(full + 8 * (n % S), (n / S) & 1); };
    auto release = [&](int n) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (n % S));
    };
    auto pass_through = [&](int n) {  // pass every tile up to n
      for (; seen <= n; ++seen) {
        wait_tile(seen);
        release(seen);
      }
    };
    auto acquire = [&](int n) {  // pass the tiles before n, wait for n
      pass_through(n - 1);
      if (seen == n) wait_tile(seen++);
      return ring + (n % S) * kPanel * LD + lane * LD;  // this lane's row of the tile
    };
    for (int r = warp; r < nt; r += nw) {
      if (r * kPanel + lane < f) gather(r * kPanel + lane);
    }
    // Forward: x[i] -= l[i, j] x[j], j ascending.
    for (int c = 0; c < nt; ++c) {
      const int c0 = c * kPanel, ncol = min(kPanel, f - c0);
      if (c % nw == warp) {  // the diagonal triangle, x in registers
        const int n = fwd_item(nt, c, c);
        const T* row = acquire(n);
        const T xl = triangle_fwd(row, lane < ncol ? x[c0 + lane] : T(0), ncol, lane);
        if (lane < ncol) x[c0 + lane] = xl;
        if (c < nt - 1) release(n);  // the last is the backward pass's first
      }
      if (c == nt - 1) break;
      pass_through(fwd_item(nt, c, c));
      consumers_sync(32 * nw);
      for (int r = c + 1 + (warp - (c + 1) % nw + nw) % nw; r < nt; r += nw) {
        const int n = fwd_item(nt, r, c);
        const T* row = acquire(n);
        const int i = r * kPanel + lane;
        if (i < f) {  // every column of a panel with rows below lies within f
          T xi = x[i];
#pragma unroll
          for (int q = 0; q < CPR; ++q) {
            const Chunk<T> a = load_chunk(row + q * V), xj = load_chunk(x + c0 + q * V);
#pragma unroll
            for (int e = 0; e < V; ++e) xi = fma_of(-a.v[e], xj.v[e], xi);
          }
          x[i] = xi;
        }
        release(n);
      }
    }
    // Backward: y[j] = x[j] / u[j, j], then x[i] -= u[i, j] y[j], j descending.
    for (int c = nt - 1; c >= 0; --c) {
      const int c0 = c * kPanel, ncol = min(kPanel, f - c0);
      if (c % nw == warp) {
        const int n = bwd_item(nt, c, c);
        const T* row = acquire(n);
        const T xl = triangle_bwd(row, lane < ncol ? x[c0 + lane] : T(0), ncol, lane);
        if (lane < ncol) x[c0 + lane] = xl;
        release(n);
      }
      if (c == 0) break;
      pass_through(bwd_item(nt, c, c));
      consumers_sync(32 * nw);
      for (int r = (c - 1) - ((c - 1 - warp) % nw + nw) % nw; r >= 0; r -= nw) {
        const int n = bwd_item(nt, r, c);
        const T* row = acquire(n);
        const int i = r * kPanel + lane;  // r < c: every row lies within f
        T xi = x[i];
#pragma unroll
        for (int q = CPR - 1; q >= 0; --q) {
          if (q * V < ncol) {
            const Chunk<T> a = load_chunk(row + q * V), yj = load_chunk(x + c0 + q * V);
#pragma unroll
            for (int e = V - 1; e >= 0; --e) {
              if (q * V + e < ncol) xi = fma_of(-a.v[e], yj.v[e], xi);
            }
          }
        }
        x[i] = xi;
        release(n);
      }
    }
    pass_through(nt * (nt + 1) - 2);  // the last tile: the producer's last waits
  }
  __syncthreads();
}

// sqrt(sum_c (d[c] / s[c])^2 / f) over one row, by one warp: each lane sums
// its columns c = lane, lane + 32, ... in order, then the xor butterfly.
// Every lane returns the same bits.  The columns go kNormBatch a lane at a
// time: fetch(u, c, d, s) loads column c's entries of the update and the
// scale into d and s (and whatever else the caller keeps in slot u) for
// every column of a batch before use(u, c, d) sees the first of them, so a
// lane has the whole batch's loads in flight at once.  masked_newton_update
// commits k - d in use() from the same registers; fused_newton_iter's
// bodies take the row from shared memory (the overload below).
constexpr int kNormBatch = 4;

template <typename T, typename Fetch, typename Use>
__device__ __forceinline__ T newton_norm_warp(int64_t f, int lane, Fetch fetch, Use use) {
  T sum = T(0);
  for (int64_t c0 = lane; c0 < f; c0 += 32 * kNormBatch) {
    T d[kNormBatch], s[kNormBatch];
#pragma unroll
    for (int u = 0; u < kNormBatch; ++u) {
      if (c0 + 32 * u < f) fetch(u, c0 + 32 * u, d[u], s[u]);
    }
#pragma unroll
    for (int u = 0; u < kNormBatch; ++u) {
      if (c0 + 32 * u < f) {
        use(u, c0 + 32 * u, d[u]);
        const T r = d[u] / s[u];
        sum = fma_of(r, r, sum);
      }
    }
  }
  return wrms_finish(warp_sum(sum), f);
}

template <typename T>
__device__ __forceinline__ T newton_norm_warp(const T* d, const T* __restrict__ s, int64_t f,
                                              int lane) {
  return newton_norm_warp<T>(
      f, lane,
      [&](int, int64_t c, T& dc, T& sc) {
        dc = d[c];
        sc = s[c];
      },
      [](int, int64_t, T) {});
}

}  // namespace linalg
