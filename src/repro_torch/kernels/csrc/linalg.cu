// Hand-written Hopper (sm_90a) kernels for the chord-Newton layer of the
// diagonally implicit stepper (core/newton.py).
//
// Each kernel replaces one Pallas TPU kernel of the JAX package
// (src/repro/kernels/pallas_impl.py) and computes the plain PyTorch version
// of the same name in ../ref.py, to rounding: the plain versions go through
// LAPACK/cuSOLVER, which eliminate and substitute in their own (blocked)
// order, so the kernels are held to them at a tolerance, not bitwise.  What
// is bitwise is the card's unfused Newton iteration against its fused one:
// batched_linsolve factors with the same device function as
// batched_lu_factor and substitutes with the same one as fused_newton_iter,
// and masked_newton_update takes its row norm from the same function as
// fused_newton_iter (linalg_common.cuh).
//
// Design of the two elimination kernels (batched_lu_factor,
// batched_linsolve): one thread block per instance (256 threads).  The
// elimination takes one of three paths, picked by cuda_impl.lu_path and
// passed in (the entries refuse a path that does not take the shape):
//
// - staged (f <= 239 / 238 in float32 for the LU / the linsolve, 169 / 168
//   in float64, on an H100): the block copies its matrix into shared memory
//   once (16-byte loads, rows padded to f + 1 entries so a column's entries
//   fall in distinct banks), eliminates it there with two barriers per column
//   (lu_factor_staged) and writes LU back once; the linsolve substitutes
//   from shared memory and writes no LU at all.  At allen_cahn_full's f =
//   128 the device-memory elimination streamed ~f^3 / 3 entries per
//   instance through L2 and device memory, read and written (5.7 GB at b =
//   1024; the 1024 matrices, 64 MiB, do not fit the 50 MB L2): that traffic
//   goes.  Occupancy: 3 blocks per SM in float32 (66 KiB each), 1 in
//   float64.
// - global: the same elimination in place in device memory
//   (lu_factor_block, four barriers per column), for widths between the
//   staged limit and 1024.
// - wide (f >= 1024): column by column over the whole card, below.
//
// The three give the same factors and permutation bitwise (the same pivot
// rule, division and fma per entry in column order).
//
// fused_newton_iter has three bodies, picked by cuda_impl.newton_iter_body
// and passed in (the entry refuses one that does not take the shape), all
// three the same bits (linalg_common.cuh states the contract):
//
// - panel (f > 32, wherever its ring and x fit: f <= 53388 / 25736 in
//   float32 / float64 on an H100): lu_substitute_panels.  The first design
//   (the column body below) ran lu_substitute_block on the LU in device
//   memory: 2 f columns, each behind a barrier, each thread's load of lu[i,
//   j] a line of its own, so at f = 128 256 dependent device-memory round
//   trips per block and every line of the 64 MiB of matrices read back once
//   per column that touches it.  The panel body reads each tile of the LU
//   from device memory once (the diagonal tiles twice: once a pass), a tile
//   row per TMA bulk copy, by a producer warp that keeps the next tiles in
//   flight through a ring of shared-memory slots with mbarriers, and
//   substitutes 32 columns per barrier: 2 (f / 32) barriers, the 32 x 32
//   triangles by warp shuffles (the backward one's divisions with their
//   reciprocals taken ahead, `quotient`), the rest one lane per row from
//   shared memory.  160 threads and 19 / 27 KiB of shared memory a block
//   (float32 / float64): 8 blocks an SM, so allen_cahn_full's 1024
//   instances run in one wave.  What bounds it is the chain of 2 (f / 32)
//   triangles, each waiting for its tile (PERF.md).
// - warp (f <= 32, the small stiff systems: vdp_stiff_mixed's f = 2,
//   robertson_sweep's 3): a warp per instance, every load in flight at
//   once, the same triangles by shuffles, no block barrier.
// - column: the first design, kept as the timed reference (chip_smoke.py's
//   ms_by_body) and for a device whose shared memory holds no panel ring.
//
// Bounds at b = 1024, f = 128, float32 (3.35 TB/s, 67 TFLOP/s outside the
// tensor cores): batched_lu_factor reads M and writes LU (2 b f^2 elements,
// 0.040 ms), 2/3 f^3 b flops (0.021 ms): bytes.  batched_linsolve reads M
// and rhs and writes x (0.020 ms), 2/3 f^3 + 2 f^2 flops per instance
// (0.022 ms): operations.  fused_newton_iter reads LU once (b f^2) and a few
// (b, f) planes (0.021 ms): bytes.  masked_newton_update moves four (b, f)
// planes (0.0006 ms): bytes.  What bounds the elimination instead is
// latency: f synchronizations per factorization column loop, each with
// little work between them at small f; what bounds the panel substitution
// is the chain of its 2 (f / 32) triangles (a division per column in the
// backward one) and the tile loads each waits for.

#include "linalg_common.cuh"

namespace {

using namespace linalg;

// The instance's (f, f) matrix from `src` into `dst` (both row-major).
template <typename T>
__device__ __forceinline__ void copy_matrix(const T* __restrict__ src, T* __restrict__ dst,
                                            int64_t n) {
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// ----------------------------------------------------------- batched_lu_factor
// Replaces pallas_impl.batched_lu_factor (:454, body _lu_factor_kernel :399).
// One block per instance: M is copied into the output LU and eliminated
// there in place (lu_factor_block), the permutation written beside it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lu_factor_kernel(const T* __restrict__ A, T* __restrict__ lu, int32_t* __restrict__ perm,
                 int f) {
  const int64_t n = (int64_t)f * f;
  T* a = lu + blockIdx.x * n;
  copy_matrix(A + blockIdx.x * n, a, n);
  __syncthreads();
  lu_factor_block(a, perm + (int64_t)blockIdx.x * f, f);
}

// The staged path's copies between an instance's row-major (f, f) matrix in
// device memory and the tile `s` in shared memory (row stride f + 1): by
// 16-byte loads and stores where the instance starts 16-byte aligned and
// fills whole 16-byte words, else by element.
template <typename T>
__device__ __forceinline__ void stage_in(const T* __restrict__ src, T* s, int f) {
  constexpr int V = 16 / sizeof(T);
  const int n = f * f;
  if (n % V == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int c = threadIdx.x; c < n / V; c += blockDim.x) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[c];
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = c * V + e;
        s[(i / f) * (f + 1) + i % f] = v[e];
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) s[(i / f) * (f + 1) + i % f] = src[i];
  }
}

template <typename T>
__device__ __forceinline__ void stage_out(const T* s, T* __restrict__ dst, int f) {
  constexpr int V = 16 / sizeof(T);
  const int n = f * f;
  if (n % V == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    for (int c = threadIdx.x; c < n / V; c += blockDim.x) {
      uint4 raw;
      T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = c * V + e;
        v[e] = s[(i / f) * (f + 1) + i % f];
      }
      reinterpret_cast<uint4*>(dst)[c] = raw;
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = s[(i / f) * (f + 1) + i % f];
  }
}

// The staged path: stage M, eliminate in shared memory, write LU and perm
// once (shared memory: staged_smem_bytes<T>(f, false)); f <= 32 NC.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
lu_factor_staged_kernel(const T* __restrict__ A, T* __restrict__ lu,
                        int32_t* __restrict__ perm, int f) {
  extern __shared__ unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  T* mult = s + f * (f + 1);
  int32_t* p = reinterpret_cast<int32_t*>(mult + f);
  const int64_t n = (int64_t)f * f;
  stage_in(A + blockIdx.x * n, s, f);
  lu_factor_staged<T, NC>(s, f + 1, mult, p, f);
  stage_out(s, lu + blockIdx.x * n, f);
  for (int i = threadIdx.x; i < f; i += blockDim.x) perm[(int64_t)blockIdx.x * f + i] = p[i];
}

// ------------------------------------------------------------ batched_linsolve
// Replaces pallas_impl.batched_linsolve (:370, body _linsolve_kernel :319).
// The Pallas kernel runs Gauss-Jordan on the right-hand side; here A is
// factored in a scratch copy by the same device function as
// batched_lu_factor, and the permuted right-hand side substituted by the
// same one as fused_newton_iter, so an unfused Newton iteration equals a
// fused one bitwise.
template <typename T>
__global__ void __launch_bounds__(kThreads)
linsolve_kernel(const T* __restrict__ A, const T* __restrict__ rhs, T* __restrict__ scratch,
                T* __restrict__ x_out, int f) {
  extern __shared__ unsigned char smem[];
  T* x = reinterpret_cast<T*>(smem);
  int32_t* perm = reinterpret_cast<int32_t*>(x + f);
  const int64_t n = (int64_t)f * f;
  T* a = scratch + blockIdx.x * n;
  copy_matrix(A + blockIdx.x * n, a, n);
  __syncthreads();
  lu_factor_block(a, perm, f);  // ends synchronized
  const T* g = rhs + (int64_t)blockIdx.x * f;
  for (int i = threadIdx.x; i < f; i += blockDim.x) x[i] = g[perm[i]];
  lu_substitute_block(a, f, x, x_out + (int64_t)blockIdx.x * f, f);
}

// The staged path of batched_linsolve: the same factors and substitution
// as linsolve_kernel, from shared memory (staged_smem_bytes<T>(f, true));
// no LU is written.  f <= 32 NC.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
linsolve_staged_kernel(const T* __restrict__ A, const T* __restrict__ rhs,
                       T* __restrict__ x_out, int f) {
  extern __shared__ unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  T* mult = s + f * (f + 1);
  T* x = mult + f;
  int32_t* perm = reinterpret_cast<int32_t*>(x + f);
  stage_in(A + blockIdx.x * (int64_t)f * f, s, f);
  lu_factor_staged<T, NC>(s, f + 1, mult, perm, f);  // ends synchronized
  const T* g = rhs + (int64_t)blockIdx.x * f;
  for (int i = threadIdx.x; i < f; i += blockDim.x) x[i] = g[perm[i]];
  lu_substitute_block(s, f + 1, x, x_out + (int64_t)blockIdx.x * f, f);
}

// ------------------------------------------------------------ fused_newton_iter
// Replaces pallas_impl.fused_newton_iter (:540, body _newton_iter_kernel
// :486).  One whole chord-Newton iteration per instance: the residual g = k
// - fk gathered through the permutation, the two substitutions against the
// prefactored LU (O(f^2), where the unfused path pays an O(f^3)
// elimination every iteration), then the scaled RMS of the update and the
// commit k - delta where the row is active.  The column body (the first
// design): one block per instance, lu_substitute_block on the LU in device
// memory, warp 0 takes the norm while the block commits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
newton_iter_kernel(const T* __restrict__ lu, const int32_t* __restrict__ perm,
                   const T* __restrict__ k, const T* __restrict__ fk,
                   const uint8_t* __restrict__ active, const T* __restrict__ scale,
                   T* __restrict__ k_new, T* __restrict__ res, int f) {
  extern __shared__ unsigned char smem[];
  T* x = reinterpret_cast<T*>(smem);
  T* delta = x + f;
  const int64_t row = blockIdx.x, base = row * f;
  const int32_t* p = perm + base;
  for (int i = threadIdx.x; i < f; i += blockDim.x) {
    x[i] = sub_rn(k[base + p[i]], fk[base + p[i]]);
  }
  lu_substitute_block(lu + row * (int64_t)f * f, f, x, delta, f);  // ends synchronized
  if (threadIdx.x < 32) {
    const T r = newton_norm_warp(delta, scale + base, f, threadIdx.x);
    if (threadIdx.x == 0) res[row] = r;
  }
  const bool act = active[row] != 0;
  for (int i = threadIdx.x; i < f; i += blockDim.x) {
    k_new[base + i] = act ? sub_rn(k[base + i], delta[i]) : k[base + i];
  }
}

// The panel body: the same iteration, with the substitution of
// lu_substitute_panels (the LU streamed through a ring of tiles in shared
// memory by a producer warp, 32 columns per barrier).  The gather runs in
// the consumer warps, each on the rows it owns; y overwrites x in place.
// Shared memory: panel_smem_bytes<T>(f); panel_threads(f) threads.
template <typename T>
__global__ void __launch_bounds__(32 * (kPanelConsumers + 1), 8)
newton_iter_panel_kernel(const T* __restrict__ lu, const int32_t* __restrict__ perm,
                         const T* __restrict__ k, const T* __restrict__ fk,
                         const uint8_t* __restrict__ active, const T* __restrict__ scale,
                         T* __restrict__ k_new, T* __restrict__ res, int f) {
  extern __shared__ __align__(16) unsigned char panel_smem[];
  T* x = reinterpret_cast<T*>(panel_smem + kPanelRingBytes<T>);
  const int64_t row = blockIdx.x, base = row * f;
  const int32_t* p = perm + base;
  lu_substitute_panels(lu + row * (int64_t)f * f, f, x, panel_smem, [&](int i) {
    x[i] = sub_rn(k[base + p[i]], fk[base + p[i]]);
  });  // ends synchronized, y in x
  if (threadIdx.x < 32) {
    const T r = newton_norm_warp(x, scale + base, f, threadIdx.x);
    if (threadIdx.x == 0) res[row] = r;
  }
  const bool act = active[row] != 0;
  for (int i = threadIdx.x; i < f; i += blockDim.x) {
    k_new[base + i] = act ? sub_rn(k[base + i], x[i]) : k[base + i];
  }
}

// The warp body, for f <= 32 (the small stiff systems): a warp per
// instance, kWarpInstances to a block.  The warp copies its matrix into a
// tile of shared memory in the panel body's layout and its rows of perm, k,
// fk and scale into registers (lane = entry), all loads at once, gathers x
// by shuffle, solves both triangles by shuffles (triangle_fwd and
// triangle_bwd, the panel body's diagonal steps with ncol = f), then takes
// the row norm and commits: no block barrier and one round trip to device
// memory before the stores.
constexpr int kWarpInstances = 4;
constexpr int kWarpMaxF = kPanel;

template <typename T>
__global__ void __launch_bounds__(32 * kWarpInstances)
newton_iter_warp_kernel(const T* __restrict__ lu, const int32_t* __restrict__ perm,
                        const T* __restrict__ k, const T* __restrict__ fk,
                        const uint8_t* __restrict__ active, const T* __restrict__ scale,
                        T* __restrict__ k_new, T* __restrict__ res, int64_t b, int f) {
  constexpr int LD = kTileLd<T>;
  __shared__ __align__(16) T tiles[kWarpInstances][kPanel * LD + 2 * kPanel];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t row = blockIdx.x * (int64_t)kWarpInstances + w;
  if (row >= b) return;  // the whole warp leaves together
  T* tile = tiles[w];
  T* y = tile + kPanel * LD;
  T* sc = y + kPanel;
  const int64_t base = row * f;
  // Every load up front: the row's entries of perm, k, fk and scale (lane =
  // entry), and the matrix.
  const bool in = lane < f;
  const int32_t pl = in ? perm[base + lane] : 0;
  const T kl = in ? k[base + lane] : T(0), fl = in ? fk[base + lane] : T(0);
  if (in) sc[lane] = scale[base + lane];
  const T* a = lu + row * (int64_t)f * f;
#pragma unroll 4
  for (int i = 0; i < f; ++i) {
    if (in) tile[i * LD + lane] = a[i * f + lane];
  }
  // The gather x[l] = k[p[l]] - fk[p[l]], by shuffle.
  T xl = sub_rn(__shfl_sync(0xffffffffu, kl, pl), __shfl_sync(0xffffffffu, fl, pl));
  __syncwarp();
  xl = triangle_fwd(tile + lane * LD, xl, f, lane);
  xl = triangle_bwd(tile + lane * LD, xl, f, lane);
  if (in) y[lane] = xl;
  __syncwarp();
  const T r = newton_norm_warp(y, sc, f, lane);
  if (lane == 0) res[row] = r;
  if (in) k_new[base + lane] = active[row] != 0 ? sub_rn(kl, xl) : kl;
}

// --------------------------------------------------------- masked_newton_update
// Replaces pallas_impl.masked_newton_update (:608, body _newton_update_kernel
// :589).  k - delta where the row is active, and the scaled RMS of delta: a
// row reduction like error_norm, so one warp per row, with the row norm of
// fused_newton_iter (newton_norm_warp: the same lane-strided sum in the same
// order, so the unfused iteration's bits are the fused one's).
//
// Bound: four (b, f) planes and two (b,) columns, 2.1 MB at allen_cahn_full
// (b = 1024, f = 128, float32): 0.6 us at 3.35 TB/s.  The first design read
// delta twice (the commit, then the norm) and, f being known only at run
// time, kept one or two loads of a lane in flight: some 8 dependent round
// trips to device memory per row, 8.6 us.  Now each of k, delta and scale is
// read once, a lane's kNormBatch columns of all three are loaded before the
// first is used (12 loads in flight at f = 128: one round trip per row),
// delta stays in registers for the commit and the norm, and a block holds
// kUpdateRows rows, so at b = 1024 every SM has two blocks in flight.  The
// layout stays lane-strided 4 or 8 bytes a lane (one 128-byte line per warp
// instruction): wider loads would change which lane sums which columns, and
// so the norm's bits.  What is left is one round trip and the launch: on an
// H100 (700 W) 0.0073 ms at allen_cahn_full, 0.002 ms above the 0.0053 ms
// that any launch takes under the same timing rule (the launch floor); 2, 4
// or 8 rows a block made no difference (PERF.md).
constexpr int kUpdateRows = 4;

template <typename T>
__global__ void __launch_bounds__(32 * kUpdateRows)
newton_update_kernel(const T* __restrict__ k, const T* __restrict__ delta,
                     const uint8_t* __restrict__ active, const T* __restrict__ scale,
                     T* __restrict__ k_new, T* __restrict__ res, int64_t b, int64_t f) {
  const int lane = threadIdx.x & 31;
  const int64_t row = blockIdx.x * (int64_t)kUpdateRows + (threadIdx.x >> 5);
  if (row >= b) return;  // the whole warp leaves together
  const int64_t base = row * f;
  const bool act = active[row] != 0;
  T kv[kNormBatch];
  const T r = newton_norm_warp<T>(
      f, lane,
      [&](int u, int64_t c, T& d, T& s) {
        kv[u] = k[base + c];
        d = delta[base + c];
        s = scale[base + c];
      },
      [&](int u, int64_t c, T d) { k_new[base + c] = act ? sub_rn(kv[u], d) : kv[u]; });
  if (lane == 0) res[row] = r;
}

// ------------------------------------------------ the wide elimination
// One block per instance leaves all but b SMs idle, and its trailing
// update is a latency chain through device memory once the matrix outgrows
// L2: at b = 4, f = 8192 it would take minutes.  From 1024 columns on
// (cuda_impl.LU_WIDE_F), batched_lu_factor and batched_linsolve eliminate
// column by column over the whole card instead: per column one launch of
// lu_pivot_kernel (one
// block per instance: lu_pivot_column, the same device function as the
// one-block path) and one of lu_update_kernel (a warp per row and 8
// columns per lane, over a grid of 8-row by 256-column tiles).  Every entry
// takes the same fma with the same operands in the same column order, so
// the factors are bitwise those of lu_factor_block.

template <typename T>
__global__ void __launch_bounds__(kThreads)
lu_pivot_kernel(T* __restrict__ a_all, int32_t* __restrict__ perm_all, int f, int k) {
  T* a = a_all + blockIdx.x * (int64_t)f * f;
  int32_t* perm = perm_all + blockIdx.x * (int64_t)f;
  if (k == 0) {
    for (int i = threadIdx.x; i < f; i += blockDim.x) perm[i] = i;
  }
  lu_pivot_column(a, perm, f, k);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lu_update_kernel(T* __restrict__ a_all, int f, int k) {
  T* a = a_all + blockIdx.z * (int64_t)f * f;
  const int i = k + 1 + blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (i >= f) return;
  const T l = a[(int64_t)i * f + k];
  const int j0 = k + 1 + blockIdx.y * 256 + (threadIdx.x & 31);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int j = j0 + 32 * c;
    if (j < f) lu_update_entry(a, f, k, i, j, l);
  }
}

// Factor the b matrices at `a` in place, column by column (perm: (b, f)).
template <typename T>
cudaError_t factor_wide(T* a, int32_t* perm, int64_t b, int f, cudaStream_t stream) {
  if (b > 65535) return cudaErrorInvalidValue;  // grid.z of the update
  for (int k = 0; k < f; ++k) {
    lu_pivot_kernel<T><<<static_cast<unsigned>(b), kThreads, 0, stream>>>(a, perm, f, k);
    const int n = f - k - 1;
    if (n > 0) {
      const dim3 grid((n + kThreads / 32 - 1) / (kThreads / 32), (n + 255) / 256,
                      static_cast<unsigned>(b));
      lu_update_kernel<T><<<grid, kThreads, 0, stream>>>(a, f, k);
    }
  }
  return cudaGetLastError();
}

// The substitution of batched_linsolve after a wide elimination: x =
// rhs[perm] through lu_substitute_block, one block per instance.
template <typename T>
__global__ void __launch_bounds__(kThreads)
substitute_kernel(const T* __restrict__ lu, const int32_t* __restrict__ perm,
                  const T* __restrict__ rhs, T* __restrict__ x_out, int f) {
  extern __shared__ unsigned char smem[];
  T* x = reinterpret_cast<T*>(smem);
  const int64_t row = blockIdx.x;
  for (int i = threadIdx.x; i < f; i += blockDim.x) x[i] = rhs[row * f + perm[row * f + i]];
  lu_substitute_block(lu + row * (int64_t)f * f, f, x, x_out + row * f, f);
}

// Shared memory of the substitution: two f-vectors of T (newton_iter), or
// one and the int32 permutation (linsolve).  Above the default 48 KiB a
// launch opts in to the larger dynamic shared memory, up to the device's
// per-block limit (cudaDevAttrMaxSharedMemoryPerBlockOptin, 227 KiB on an
// H100) less the kernel's static shared memory: f <= ~14.5k (newton_iter)
// and ~19.3k (linsolve) in float64 (reserve_smem, solver_common.cuh).

// The elimination paths of batched_lu_factor and batched_linsolve, as
// cuda_impl.LU_PATHS numbers them.
constexpr int kStaged = 0, kGlobal = 1, kWide = 2;
constexpr int64_t kStagedMaxF = 32 * kStagedCols;  // a lane's columns in registers

// The staged kernels for f <= 32 NC (NC the fewest 32-column chunks that
// hold f): batched_linsolve's with `rhs`, else batched_lu_factor's.
template <typename T, int NC = 1>
int launch_staged(const void* A, const void* rhs, void* lu, void* perm, void* x, int64_t b, int f,
                  cudaStream_t stream) {
  if constexpr (NC < kStagedCols) {
    if (f > 32 * NC) return launch_staged<T, NC + 1>(A, rhs, lu, perm, x, b, f, stream);
  }
  const size_t smem = staged_smem_bytes<T>(f, rhs != nullptr);
  const cudaError_t e = rhs ? reserve_smem(linsolve_staged_kernel<T, NC>, smem)
                            : reserve_smem(lu_factor_staged_kernel<T, NC>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (rhs) {
    linsolve_staged_kernel<T, NC><<<static_cast<unsigned>(b), kThreads, smem, stream>>>(
        static_cast<const T*>(A), static_cast<const T*>(rhs), static_cast<T*>(x), f);
  } else {
    lu_factor_staged_kernel<T, NC><<<static_cast<unsigned>(b), kThreads, smem, stream>>>(
        static_cast<const T*>(A), static_cast<T*>(lu), static_cast<int32_t*>(perm), f);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_lu_factor(int path, const void* A, void* lu, void* perm, int64_t b, int64_t f,
                     cudaStream_t stream) {
  if (b < 1 || f < 1 || f > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (path == kWide) {
    const cudaError_t e = cudaMemcpyAsync(lu, A, sizeof(T) * b * f * f,
                                          cudaMemcpyDeviceToDevice, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(factor_wide(static_cast<T*>(lu), static_cast<int32_t*>(perm), b,
                                        static_cast<int>(f), stream));
  }
  if (path == kStaged) {
    if (f > kStagedMaxF) return static_cast<int>(cudaErrorInvalidValue);
    return launch_staged<T>(A, nullptr, lu, perm, nullptr, b, static_cast<int>(f), stream);
  }
  if (path != kGlobal) return static_cast<int>(cudaErrorInvalidValue);
  lu_factor_kernel<T><<<static_cast<unsigned>(b), kThreads, 0, stream>>>(
      static_cast<const T*>(A), static_cast<T*>(lu), static_cast<int32_t*>(perm),
      static_cast<int>(f));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_linsolve(int path, const void* A, const void* rhs, void* scratch, void* perm_scratch,
                    void* x, int64_t b, int64_t f, cudaStream_t stream) {
  if (b < 1 || f < 1 || f > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (path == kStaged) {
    if (f > kStagedMaxF) return static_cast<int>(cudaErrorInvalidValue);
    return launch_staged<T>(A, rhs, nullptr, nullptr, x, b, static_cast<int>(f), stream);
  }
  if (path == kWide) {
    const size_t smem = static_cast<size_t>(f) * sizeof(T);
    cudaError_t e = reserve_smem(substitute_kernel<T>, smem);
    if (e == cudaSuccess) {
      e = cudaMemcpyAsync(scratch, A, sizeof(T) * b * f * f, cudaMemcpyDeviceToDevice, stream);
    }
    if (e == cudaSuccess) {
      e = factor_wide(static_cast<T*>(scratch), static_cast<int32_t*>(perm_scratch), b,
                      static_cast<int>(f), stream);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    substitute_kernel<T><<<static_cast<unsigned>(b), kThreads, smem, stream>>>(
        static_cast<const T*>(scratch), static_cast<const int32_t*>(perm_scratch),
        static_cast<const T*>(rhs), static_cast<T*>(x), static_cast<int>(f));
    return static_cast<int>(cudaGetLastError());
  }
  if (path != kGlobal) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(f) * (sizeof(T) + sizeof(int32_t));
  const cudaError_t e = reserve_smem(linsolve_kernel<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  linsolve_kernel<T><<<static_cast<unsigned>(b), kThreads, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(rhs), static_cast<T*>(scratch),
      static_cast<T*>(x), static_cast<int>(f));
  return static_cast<int>(cudaGetLastError());
}

// The bodies of fused_newton_iter, as cuda_impl.NEWTON_BODIES numbers them.
constexpr int kPanelBody = 0, kColumnBody = 1, kWarpBody = 2;

template <typename T>
int launch_newton_iter(int body, const void* lu, const void* perm, const void* k, const void* fk,
                       const void* active, const void* scale, void* k_new, void* res,
                       int64_t b, int64_t f, cudaStream_t stream) {
  if (b < 1 || f < 1 || f > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto launch = [&](auto kernel, int threads, size_t smem) {
    kernel<<<static_cast<unsigned>(b), threads, smem, stream>>>(
        static_cast<const T*>(lu), static_cast<const int32_t*>(perm), static_cast<const T*>(k),
        static_cast<const T*>(fk), static_cast<const uint8_t*>(active),
        static_cast<const T*>(scale), static_cast<T*>(k_new), static_cast<T*>(res),
        static_cast<int>(f));
  };
  if (body == kPanelBody) {
    const size_t smem = panel_smem_bytes<T>(f);
    const cudaError_t e = reserve_smem(newton_iter_panel_kernel<T>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    launch(newton_iter_panel_kernel<T>, panel_threads(f), smem);
    return static_cast<int>(cudaGetLastError());
  }
  if (body == kWarpBody) {
    if (f > kWarpMaxF) return static_cast<int>(cudaErrorInvalidValue);
    newton_iter_warp_kernel<T><<<static_cast<unsigned>((b + kWarpInstances - 1) / kWarpInstances),
                                 32 * kWarpInstances, 0, stream>>>(
        static_cast<const T*>(lu), static_cast<const int32_t*>(perm), static_cast<const T*>(k),
        static_cast<const T*>(fk), static_cast<const uint8_t*>(active),
        static_cast<const T*>(scale), static_cast<T*>(k_new), static_cast<T*>(res), b,
        static_cast<int>(f));
    return static_cast<int>(cudaGetLastError());
  }
  if (body != kColumnBody) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(f) * sizeof(T);
  const cudaError_t e = reserve_smem(newton_iter_kernel<T>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  launch(newton_iter_kernel<T>, kThreads, smem);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_newton_update(const void* k, const void* delta, const void* active,
                         const void* scale, void* k_new, void* res, int64_t b, int64_t f,
                         cudaStream_t stream) {
  if (b < 1 || f < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (b + kUpdateRows - 1) / kUpdateRows;
  newton_update_kernel<T><<<static_cast<unsigned>(blocks), 32 * kUpdateRows, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(delta),
      static_cast<const uint8_t*>(active), static_cast<const T*>(scale), static_cast<T*>(k_new),
      static_cast<T*>(res), b, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ------------------------------------------------------------- C entry points
// dtype: 0 = float32, 1 = float64; path (batched_lu_factor and
// batched_linsolve): 0 = staged, 1 = global, 2 = wide; body
// (fused_newton_iter): 0 = panel, 1 = column, 2 = warp (f <= 32).  Every entry returns
// cudaGetLastError(), or cudaErrorInvalidValue for an empty shape, an
// unknown path or body, or a width whose shared memory (the staged matrix,
// the panel ring and x, or the substitution vectors) exceeds the device's
// limit (rt_linalg_max_smem()).

extern "C" {

// The smallest dynamic shared-memory limit of the substitution and staged
// kernels on the current device, in bytes (either dtype), or -1 if the
// device cannot be queried.
int rt_linalg_max_smem() {
  size_t least = static_cast<size_t>(-1), limit = 0;
  cudaError_t e = cudaSuccess;
  auto take = [&](cudaError_t r) {
    if (r != cudaSuccess) e = r;
    least = limit < least ? limit : least;
  };
  take(dynamic_smem_limit(linsolve_kernel<float>, &limit));
  take(dynamic_smem_limit(linsolve_kernel<double>, &limit));
  take(dynamic_smem_limit(newton_iter_kernel<float>, &limit));
  take(dynamic_smem_limit(newton_iter_kernel<double>, &limit));
  take(dynamic_smem_limit(newton_iter_panel_kernel<float>, &limit));
  take(dynamic_smem_limit(newton_iter_panel_kernel<double>, &limit));
  take(dynamic_smem_limit(lu_factor_staged_kernel<float, kStagedCols>, &limit));
  take(dynamic_smem_limit(lu_factor_staged_kernel<double, kStagedCols>, &limit));
  take(dynamic_smem_limit(linsolve_staged_kernel<float, kStagedCols>, &limit));
  take(dynamic_smem_limit(linsolve_staged_kernel<double, kStagedCols>, &limit));
  return e == cudaSuccess ? static_cast<int>(least) : -1;
}

int rt_batched_lu_factor(int dtype, int path, const void* A, void* lu, void* perm, int64_t b,
                         int64_t f, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_lu_factor<double>(path, A, lu, perm, b, f, s)
               : launch_lu_factor<float>(path, A, lu, perm, b, f, s);
}

int rt_batched_linsolve(int dtype, int path, const void* A, const void* rhs, void* scratch,
                        void* perm_scratch, void* x, int64_t b, int64_t f, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_linsolve<double>(path, A, rhs, scratch, perm_scratch, x, b, f, s)
               : launch_linsolve<float>(path, A, rhs, scratch, perm_scratch, x, b, f, s);
}

int rt_fused_newton_iter(int dtype, int body, const void* lu, const void* perm, const void* k,
                         const void* fk, const void* active, const void* scale, void* k_new,
                         void* res, int64_t b, int64_t f, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_newton_iter<double>(body, lu, perm, k, fk, active, scale, k_new, res, b,
                                            f, s)
               : launch_newton_iter<float>(body, lu, perm, k, fk, active, scale, k_new, res, b,
                                           f, s);
}

int rt_masked_newton_update(int dtype, const void* k, const void* delta, const void* active,
                            const void* scale, void* k_new, void* res, int64_t b, int64_t f,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_newton_update<double>(k, delta, active, scale, k_new, res, b, f, s)
               : launch_newton_update<float>(k, delta, active, scale, k_new, res, b, f, s);
}

}  // extern "C"
