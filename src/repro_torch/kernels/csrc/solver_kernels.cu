// Hand-written Hopper (sm_90a) kernels for the explicit solver's hot path.
//
// Each kernel replaces one Pallas TPU kernel of the JAX package
// (src/repro/kernels/pallas_impl.py) and computes exactly the plain PyTorch
// version of the same name in ../ref.py.  Every kernel is templated on
// float/double (the state's dtype) and exposed through a plain C entry point
// that launches on the caller's stream and returns cudaGetLastError(), so the
// library is loaded with ctypes and needs no PyTorch headers.
//
// All four ops are elementwise or row reductions that do a handful of flops
// per element: on an H100 (3.35 TB/s HBM, 67 TFLOP/s fp32 outside the tensor
// cores) they are bound by the bytes they move, never by arithmetic.  The
// designs therefore aim at one coalesced pass over each input and no
// intermediate in device memory.  The arithmetic they share with the fused
// step kernels (fused_step.cu) comes from solver_common.cuh.

#include "solver_common.cuh"

namespace {

using namespace solver;

// ---------------------------------------------------------------- stage_accum
// Replaces pallas_impl.stage_accum (:123, body _stage_accum_kernel :115).
// out = y + dt[row] * sum_j a_j K[j], summed in ref.stage_accum's order
// (j = 0, 1, ...).  Bound: (nj + 2) * b * f elements read and written.
//
// Laid out by row: blockIdx.x * blockDim.y + threadIdx.y is the row (the x
// axis of the grid holds 2^31 - 1 blocks, the y axis 65535), threadIdx.x and
// blockIdx.y its V-entry chunks (V = 16 / sizeof(T) where f % V == 0 and y,
// K and out start 16-byte aligned, else V = 1); a row narrower than a warp
// shares its block with others.  A thread reads dt[row] once, indexes within
// its row in 32 bits, and issues all nj K chunks and y's chunk before the
// first fma: the stage count NJ is a template argument (weighted_sum_n), so
// no load waits behind a run-time select.  The first design (one 4-byte
// element a thread, a 64-bit division per element for dt's row, the count
// read at run time with each load behind the fma before it) kept one load of
// a thread in flight: 0.0151 ms at full_width's shape against a 0.0053 ms
// bound on an NVIDIA H100 80GB HBM3 (PERF.md).
constexpr int kAccumThreads = 256;

template <typename T, int NJ, int V>
__global__ void __launch_bounds__(kAccumThreads)
    stage_accum_kernel(const T* __restrict__ y, const T* __restrict__ dt,
                       const T* __restrict__ K, Coeffs<T> a, T* __restrict__ out, int64_t b,
                       int f) {
  const int64_t row = blockIdx.x * (int64_t)blockDim.y + threadIdx.y;
  if (row >= b) return;
  const int64_t plane = b * f;  // K[j] is plane j
  const int64_t base = row * f;
  const int nc = f / V;
  const T h = dt[row];
  for (int q = blockIdx.y * blockDim.x + threadIdx.x; q < nc; q += gridDim.y * blockDim.x) {
    const int c0 = q * V;
    Vec<T, V> kc[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) kc[j] = load_chunk<T, V>(K + j * plane + base + c0);
    const Vec<T, V> yc = load_chunk<T, V>(y + base + c0);
    Vec<T, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      o.v[e] = fma_of(h, weighted_sum_n<NJ>(a, [&](int j) { return kc[j].v[e]; }), yc.v[e]);
    }
    store_chunk<T, V>(out + base + c0, o);
  }
}

// --------------------------------------------------------------- fused_update
// Replaces pallas_impl.fused_update (:78, body _fused_update_kernel :63).
// y1 = y + dt * (b_sol . K), err = dt * (b_err . K) from ONE read of K.
// Bound: (s + 3) * b * f elements, and dt's b.
//
// Laid out by row as stage_accum is (row_shape; V = 16 / sizeof(T) where f %
// V == 0 and y, K, y1 and err start 16-byte aligned, else V = 1).  A thread
// reads dt[row] once, indexes within its row in 32 bits, and issues its NS K
// chunks and y's chunk before the first fma (NS a template argument,
// weighted_sums_n; __launch_bounds__'s minimum of one block an SM leaves
// ptxas the registers for it: without, it holds 32 and spreads the loads
// among the fmas).  Both sums come
// from that one read, with weighted_sums' fmas in its order, so the bits are
// the first design's and the fused step kernels' (fused_step.cu).  The first
// design (one 4-byte element a thread, a 64-bit division per element for
// dt's row, the stage count read at run time with each load behind the fma
// before it) took 0.0201 ms at full_width's shape against a 0.0096 ms bound
// on an NVIDIA H100 80GB HBM3 (PERF.md).
template <typename T, int NS, int V>
__global__ void __launch_bounds__(kAccumThreads, 1)
    fused_update_kernel(const T* __restrict__ y, const T* __restrict__ K,
                        const T* __restrict__ dt, Coeffs<T> bs, Coeffs<T> be,
                        T* __restrict__ y1, T* __restrict__ err, int64_t b, int f) {
  const int64_t row = blockIdx.x * (int64_t)blockDim.y + threadIdx.y;
  if (row >= b) return;
  const int64_t plane = b * f;  // K[j] is plane j
  const int64_t base = row * f;
  const int nc = f / V;
  const T h = dt[row];
  for (int q = blockIdx.y * blockDim.x + threadIdx.x; q < nc; q += gridDim.y * blockDim.x) {
    const int c0 = q * V;
    Vec<T, V> kc[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) kc[j] = load_chunk<T, V>(K + j * plane + base + c0);
    const Vec<T, V> yc = load_chunk<T, V>(y + base + c0);
    Vec<T, V> o1, o2;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      T acc_sol, acc_err;
      weighted_sums_n<NS>(bs, be, [&](int j) { return kc[j].v[e]; }, acc_sol, acc_err);
      o1.v[e] = fma_of(h, acc_sol, yc.v[e]);
      o2.v[e] = h * acc_err;
    }
    store_chunk<T, V>(y1 + base + c0, o1);
    store_chunk<T, V>(err + base + c0, o2);
  }
}

// ----------------------------------------------------------------- error_norm
// Replaces pallas_impl.error_norm (:167, body _error_norm_kernel :149).
// Per-row WRMS of err / (atol + rtol * max(|y0|, |y1|)).  Bound: 3 * b * f
// elements (5 with (b, f) tolerances).  The TPU walks the feature tiles as a
// sequential grid axis with _init/_finalize on an output block; here a row is
// reduced inside one block, with no cross-block state.  Every body folds the
// sum of squares in the one order of solver_common.cuh (lane l takes c = l,
// l + 32, ...; warp_sum; wrms_finish), the fused step kernels' order, so the
// card's fused step computes bitwise its unfused step's ratio: the loads may
// be reordered and widened, the fold may not.  cuda_impl.error_norm_body picks
// the body.
//
// The warp body, the first design: one warp owns one row and loops over f
// itself (coalesced, lane-strided), then a shuffle reduction and sqrt(sum /
// f).  8 rows to a block.  Tolerances come in through (row, column) strides,
// 0 for a broadcast axis; a null pointer means the scalar passed by value.
// It takes the narrow rows, where it was as fast as the row body or faster;
// the rows too wide for the row body's shared memory take the wide body.
template <typename T>
__global__ void error_norm_kernel(const T* __restrict__ err, const T* __restrict__ y0,
                                  const T* __restrict__ y1, Tol<T> atol, Tol<T> rtol,
                                  T* __restrict__ out, int64_t b, int64_t f) {
  const int lane = threadIdx.x & 31;
  const int64_t row = blockIdx.x * (int64_t)kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= b) return;
  const int64_t base = row * f;
  T sum = T(0);
  for (int64_t c = lane; c < f; c += 32) {
    sum = wrms_add(sum, err[base + c], y0[base + c], y1[base + c], atol.at(row, c),
                   rtol.at(row, c));
  }
  sum = warp_sum(sum);
  if (lane == 0) out[row] = wrms_finish(sum, f);
}

// The row body: a block per row, or rows narrower than a warp's worth of
// chunks sharing a block (blockDim.y rows), a thread per V-entry chunk (V =
// 16 / sizeof(T) where f % V == 0 and err, y0, y1 start 16-byte aligned, else
// V = 1).  Phase 1: each thread issues every load of its chunk before the
// chunk's first division -- err, y0, y1 and any tolerance read by chunk or
// entry (Tol's mode) -- and writes r = wrms_scaled(...) to shared memory.
// Phase 2: one warp a row folds r^2 in error_norm's order, as row_finish
// does in fused_step.cu.  The whole row sits in shared memory, so the body
// takes f <= kNormRowMaxF (cuda_impl.NORM_ROW_MAX_F; 32 KB a row in
// float64); wider rows take the wide body below.  kEntries false (both tolerances
// values a row, as the solver passes them) keeps no tolerance pointer in
// registers: 31 registers against 48 in float32 at V = 4.  Measured on an
// NVIDIA H100 80GB HBM3 (PERF.md): the warp body read 9.6 MB in 0.0205 ms at
// full_width's shape, this body 0.0108; capping it at 32 registers (every
// row resident at once, with tolerance pointers) spilled and ran 0.0149; two
// chunks a thread ran 0.0119.
constexpr int kNormThreads = 256;
constexpr int kNormRowMaxF = 4096;

template <typename T, int V, bool kEntries>
__global__ void __launch_bounds__(kNormThreads)
    error_norm_row_kernel(const T* __restrict__ err, const T* __restrict__ y0,
                          const T* __restrict__ y1, Tol<T> atol, Tol<T> rtol,
                          T* __restrict__ out, int64_t b, int f) {
  extern __shared__ __align__(16) unsigned char norm_smem[];
  T* r_s = reinterpret_cast<T*>(norm_smem);
  const int64_t row0 = blockIdx.x * (int64_t)blockDim.y;
  const int64_t row = row0 + threadIdx.y;
  if (row < b) {
    const int64_t base = row * f;
    const Tol<T> at = atol.row_of(row), rt = rtol.row_of(row);
    T* r_row = r_s + threadIdx.y * f;
    for (int q = threadIdx.x; q < f / V; q += blockDim.x) {
      const int c = q * V;
      const Vec<T, V> e = load_chunk<T, V>(err + base + c), a = load_chunk<T, V>(y0 + base + c),
                      y = load_chunk<T, V>(y1 + base + c),
                      ta = at.template chunk<V, kEntries>(c),
                      tr = rt.template chunk<V, kEntries>(c);
      Vec<T, V> r;
#pragma unroll
      for (int j = 0; j < V; ++j) r.v[j] = wrms_scaled(e.v[j], a.v[j], y.v[j], ta.v[j], tr.v[j]);
      store_chunk<T, V>(r_row + c, r);
    }
  }
  __syncthreads();
  // Warp w folds the block's rows w, w + nwarps, ...
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31;
  const int nwarps = blockDim.x * blockDim.y / 32;
  for (int rl = tid >> 5; rl < static_cast<int>(blockDim.y) && row0 + rl < b; rl += nwarps) {
    const T* r_row = r_s + rl * f;
    T s = T(0);
#pragma unroll 8
    for (int c = lane; c < f; c += 32) s = fma_of(r_row[c], r_row[c], s);
    s = warp_sum(s);
    if (lane == 0) out[row0 + rl] = wrms_finish(s, f);
  }
}

// The wide body, for rows wider than the row body holds (f > kNormRowMaxF):
// the same fold, its loads no longer one latency an entry.  The warp body
// walks such a row with one warp, each step a load of err, y0 and y1 and
// then the fold: ~456 ns a step, one memory latency, 74.7 ms at (b, f) =
// (2, 5 242 880) float32 on an NVIDIA H100 80GB HBM3 (PERF.md).  Two
// launches:
//
// - pass 1 (error_norm_scaled_kernel): the whole grid computes r =
//   wrms_scaled(...) in V-entry chunks (16 bytes where f % V == 0 and the
//   inputs are aligned) into a (b, ld) scratch that the wrapper allocates,
//   ld = f rounded up to 16 bytes, so every scratch row starts 16-byte
//   aligned;
// - pass 2 (error_norm_fold_kernel): a block a row, one warp folds r^2 in
//   error_norm's order (lane l: c = l, l + 32, ..., then warp_sum and
//   wrms_finish) from shared memory, while a producer warp keeps the next
//   pieces of the row in flight by bulk copies of the TMA unit into a ring
//   of kFoldStages slots of kFoldStageBytes.
//
// r is stored and read back exactly, so each lane's chain of fmas is the
// warp body's: the same bits.  Bounds, at (2, 5 242 880) float32: the bytes,
// 3 b f 4 B over 3.35 TB/s = 0.038 ms (pass 1 also writes r and pass 2
// reads it back: 5 b f 4 B, 0.063 ms); the chain, f / 32 = 163 840
// dependent fmas a lane at ~4 cycles of a ~1.98 GHz clock, ~0.33 ms (about
// twice in float64).  The fold order is the contract (solver_common.cuh),
// so the chain is the floor at small b.
constexpr int kWideThreads = 256;
constexpr int kFoldStageBytes = 32 * 1024;
constexpr int kFoldStages = 6;
constexpr int kFoldSmem = kFoldStages * kFoldStageBytes + 16 * kFoldStages;
constexpr int kFoldBatch = 16;  // entries a lane loads ahead of its chain

template <typename T, int V, bool kEntries>
__global__ void __launch_bounds__(kWideThreads)
    error_norm_scaled_kernel(const T* __restrict__ err, const T* __restrict__ y0,
                             const T* __restrict__ y1, Tol<T> atol, Tol<T> rtol,
                             T* __restrict__ r, int64_t b, int f, int64_t ld) {
  const int nc = f / V;
  for (int64_t row = blockIdx.y; row < b; row += gridDim.y) {
    const int64_t base = row * f;
    const Tol<T> at = atol.row_of(row), rt = rtol.row_of(row);
    for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < nc; q += gridDim.x * blockDim.x) {
      const int c = q * V;
      const Vec<T, V> e = load_chunk<T, V>(err + base + c), a = load_chunk<T, V>(y0 + base + c),
                      y = load_chunk<T, V>(y1 + base + c),
                      ta = at.template chunk<V, kEntries>(c),
                      tr = rt.template chunk<V, kEntries>(c);
      Vec<T, V> o;
#pragma unroll
      for (int j = 0; j < V; ++j) o.v[j] = wrms_scaled(e.v[j], a.v[j], y.v[j], ta.v[j], tr.v[j]);
      store_chunk<T, V>(r + row * ld + c, o);
    }
  }
}

// A block of two warps a row: warp 0 folds, lane 0 of warp 1 copies.
template <typename T>
__global__ void __launch_bounds__(64)
    error_norm_fold_kernel(const T* __restrict__ r, T* __restrict__ out, int64_t b, int f,
                           int64_t ld) {
  extern __shared__ __align__(128) unsigned char fold_smem[];
  constexpr int kEnt = kFoldStageBytes / static_cast<int>(sizeof(T));  // a multiple of 32
  const T* ring = reinterpret_cast<const T*>(fold_smem);
  const uint32_t ring_s = smem_u32(fold_smem);
  const uint32_t bars = ring_s + kFoldStages * kFoldStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kFoldStages + s); };
  const int64_t row = blockIdx.x;
  if (row >= b) return;  // the empty batch launches one block
  const T* src = r + row * ld;
  const int n_chunks = (f + kEnt - 1) / kEnt;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFoldStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 32) {
    if (lane == 0) {
      for (int i = 0; i < n_chunks; ++i) {
        const int s = i % kFoldStages;
        if (i >= kFoldStages) mbar_wait(empty(s), ((i / kFoldStages) - 1) & 1);
        const int c0 = i * kEnt;
        const int n = f - c0 < kEnt ? f - c0 : kEnt;
        // Rounded up to 16 bytes: the scratch row is ld >= f entries long.
        const uint32_t bytes = (static_cast<uint32_t>(n) * sizeof(T) + 15u) & ~15u;
        mbar_expect_tx(full(s), bytes);
        bulk_copy(ring_s + s * kFoldStageBytes, src + c0, bytes, full(s));
      }
    }
    return;
  }
  T sum = T(0);
  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % kFoldStages;
    mbar_wait(full(s), (i / kFoldStages) & 1);
    const T* st = ring + s * kEnt;
    const int n = f - i * kEnt < kEnt ? f - i * kEnt : kEnt;
    if (n == kEnt) {
      // kFoldBatch entries a lane in registers ahead of the chain: the next
      // batch's loads issue before this batch's fmas.  The plain loop,
      // unrolled 16, ran 0.748 ms at (2, 5 242 880) float32, this 0.623
      // (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
      T cur[kFoldBatch], nxt[kFoldBatch];
#pragma unroll
      for (int e = 0; e < kFoldBatch; ++e) cur[e] = st[lane + 32 * e];
      for (int k0 = 0; k0 < kEnt; k0 += 32 * kFoldBatch) {
        const int next = k0 + 32 * kFoldBatch < kEnt ? k0 + 32 * kFoldBatch : k0;
#pragma unroll
        for (int e = 0; e < kFoldBatch; ++e) nxt[e] = st[next + lane + 32 * e];
#pragma unroll
        for (int e = 0; e < kFoldBatch; ++e) sum = fma_of(cur[e], cur[e], sum);
#pragma unroll
        for (int e = 0; e < kFoldBatch; ++e) cur[e] = nxt[e];
      }
    } else {
      for (int k = lane; k < n; k += 32) sum = fma_of(st[k], st[k], sum);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }
  sum = warp_sum(sum);
  if (lane == 0) out[row] = wrms_finish(sum, f);
}

// ---------------------------------------------------------------- interp_eval
// Replaces pallas_impl.interp_eval (:226, body _interp_kernel :216).
// where(mask, Horner cubic(x), out).  The Pallas kernel reads and rewrites
// the whole (b, n, f) buffer every step; most cells are unmasked on any one
// step, so here only the masked cells' f values are written, IN PLACE, and
// unmasked cells are neither read nor written.  Bound: masked cells x f
// written, the coefficients of the rows with a masked cell and the masked
// cells' positions read, plus the b * n mask bytes scanned (an unmasked
// cell's position is never read).  With a non-null cursor the (b, W)
// positions and masks address the window out[row, cursor[row] + w, :]
// (windowed dense output), so the window is written straight into the buffer
// with no gather/scatter round trip; a column outside [0, n) is never
// written.  Horner rounds each multiply and add on its own
// (solver_common.cuh's horner_rn), as the plain version does, so the cells
// equal ref.interp_eval's bitwise and the event localizer's interpolant
// (events.cu) is the dense output's.
// cuda_impl.interp_eval_body picks the body.  The first design (a warp a
// cell, 8 cells a block, every warp reading its mask byte, each masked cell
// re-reading its row's four coefficient rows) took 0.0225 ms at full_width's
// shape on an NVIDIA H100 80GB HBM3 (PERF.md).
//
// The row body: laid out by row as stage_accum is (rows on blockIdx.x,
// sharing a block when narrower than a warp's worth of chunks; V-entry chunks
// on threadIdx.x and blockIdx.y, V = 16 / sizeof(T) where f % V == 0 and out
// and the four coefficient planes start 16-byte aligned, else V = 1).  The
// block's warps ballot its rows' mask bytes, kInterpWords 32-column words a
// row at a time, into shared memory; a row with no masked cell loads nothing
// more; otherwise each thread loads its four coefficient chunks once, into
// registers, and for each masked column (its bits in order) reads x and
// stores one chunk of out[row, col, :].
constexpr int kInterpThreads = 256;
constexpr int kInterpWords = 8;

template <typename T, int V>
__global__ void interp_eval_row_kernel(const T* __restrict__ c0, const T* __restrict__ c1,
                                       const T* __restrict__ c2, const T* __restrict__ c3,
                                       const T* __restrict__ x,
                                       const uint8_t* __restrict__ mask,
                                       const int64_t* __restrict__ cursor,
                                       T* __restrict__ out, int64_t b, int nw, int64_t n,
                                       int f) {
  __shared__ unsigned bits_s[kInterpThreads * kInterpWords];
  const int64_t row0 = blockIdx.x * (int64_t)blockDim.y;
  const int rows = b - row0 < blockDim.y ? static_cast<int>(b - row0) : blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x * blockDim.y / 32;
  const bool live = static_cast<int>(threadIdx.y) < rows;
  const int64_t row = row0 + threadIdx.y;
  const int nc = f / V;
  const int64_t shift = live && cursor ? cursor[row] : 0;
  const unsigned* my_bits = bits_s + threadIdx.y * kInterpWords;
  const int words = (nw + 31) / 32;
  for (int w0 = 0; w0 < words; w0 += kInterpWords) {
    const int tw = min(kInterpWords, words - w0);
    for (int p = warp; p < rows * tw; p += nwarps) {
      const int rl = p / tw, j = p - rl * tw;
      const int w = (w0 + j) * 32 + lane;
      const bool set = w < nw && mask[(row0 + rl) * nw + w] != 0;
      const unsigned word = __ballot_sync(0xffffffffu, set);
      if (lane == 0) bits_s[rl * kInterpWords + j] = word;
    }
    __syncthreads();
    unsigned any = 0;
    for (int j = 0; j < tw && live; ++j) any |= my_bits[j];
    if (any) {
      for (int q = blockIdx.y * blockDim.x + threadIdx.x; q < nc;
           q += gridDim.y * blockDim.x) {
        const int64_t cb = row * f + q * V;
        const Vec<T, V> a0 = load_chunk<T, V>(c0 + cb), a1 = load_chunk<T, V>(c1 + cb),
                        a2 = load_chunk<T, V>(c2 + cb), a3 = load_chunk<T, V>(c3 + cb);
        for (int j = 0; j < tw; ++j) {
          for (unsigned word = my_bits[j]; word; word &= word - 1) {
            const int w = (w0 + j) * 32 + __ffs(word) - 1;
            const int64_t col = w + shift;
            if (col < 0 || col >= n) continue;  // a bad cursor never writes outside out
            const T xv = __ldg(x + row * nw + w);
            Vec<T, V> o;
#pragma unroll
            for (int e = 0; e < V; ++e) o.v[e] = horner_rn(a0.v[e], a1.v[e], a2.v[e], a3.v[e], xv);
            store_chunk<T, V>(out + (row * n + col) * f + q * V, o);
          }
        }
      }
    }
    if (w0 + kInterpWords < words) __syncthreads();  // before the bits are rewritten
  }
}

// The cell body, for narrow rows: a thread a (row, point) cell, which
// returns at once when the cell is unmasked and otherwise writes the cell's
// f values chunk by chunk, reading its row's coefficients as it goes.
constexpr int kCellThreads = 256;

template <typename T, int V>
__global__ void __launch_bounds__(kCellThreads)
    interp_eval_cell_kernel(const T* __restrict__ c0, const T* __restrict__ c1,
                            const T* __restrict__ c2, const T* __restrict__ c3,
                            const T* __restrict__ x, const uint8_t* __restrict__ mask,
                            const int64_t* __restrict__ cursor, T* __restrict__ out, int64_t b,
                            int64_t nw, int64_t n, int f) {
  const int64_t cell = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (cell >= b * nw || !mask[cell]) return;
  // 32-bit division wherever the cell count allows it (a 64-bit one is a
  // long call).
  const int64_t row = b * nw <= 0xffffffffLL
                          ? static_cast<int64_t>(static_cast<uint32_t>(cell) /
                                                 static_cast<uint32_t>(nw))
                          : cell / nw;
  const int64_t col = cell - row * nw + (cursor ? cursor[row] : 0);
  if (col < 0 || col >= n) return;  // a bad cursor never writes outside out
  const T xv = __ldg(x + cell);
  const int64_t cb = row * f;
  T* o = out + (row * n + col) * f;
  for (int c = 0; c < f; c += V) {
    const Vec<T, V> a0 = load_chunk<T, V>(c0 + cb + c), a1 = load_chunk<T, V>(c1 + cb + c),
                    a2 = load_chunk<T, V>(c2 + cb + c), a3 = load_chunk<T, V>(c3 + cb + c);
    Vec<T, V> r;
#pragma unroll
    for (int e = 0; e < V; ++e) r.v[e] = horner_rn(a0.v[e], a1.v[e], a2.v[e], a3.v[e], xv);
    store_chunk<T, V>(o + c, r);
  }
}

// The launch shape of the kernels laid out by row (stage_accum,
// fused_update, interp_eval's row body) for nc chunks a row: up to a warp, the chunk count
// rounded up to a power of two, and the rest of the block takes further rows;
// above a warp, blocks of at most `threads` a row, the chunks spread evenly
// over whole warps and over blockIdx.y.
struct RowShape {
  dim3 grid, block;
};

inline RowShape row_shape(int nc, int64_t b, int threads) {
  const int64_t chunk_blocks = (nc + threads - 1) / threads;
  int tx = 1;
  while (tx < nc && tx < 32) tx *= 2;
  if (nc > 32) tx = static_cast<int>((nc + chunk_blocks - 1) / chunk_blocks + 31) / 32 * 32;
  const int ty = threads / tx;
  const int64_t row_blocks = (b + ty - 1) / ty;
  return RowShape{dim3(static_cast<unsigned>(row_blocks > 0 ? row_blocks : 1),
                       static_cast<unsigned>(chunk_blocks < 1       ? 1
                                             : chunk_blocks < 65535 ? chunk_blocks
                                                                    : 65535)),
                  dim3(tx, ty)};
}

template <typename T, int NJ, int V>
int launch_stage_accum_n(const T* y, const T* dt, const T* K, const Coeffs<T>& a, T* out,
                         int64_t b, int f, cudaStream_t stream) {
  const RowShape s = row_shape(f / V, b, kAccumThreads);
  stage_accum_kernel<T, NJ, V><<<s.grid, s.block, 0, stream>>>(y, dt, K, a, out, b, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_stage_accum_v(const T* y, const T* dt, const T* K, const Coeffs<T>& a, int nj,
                         T* out, int64_t b, int f, cudaStream_t stream) {
  switch (nj) {
    case 1: return launch_stage_accum_n<T, 1, V>(y, dt, K, a, out, b, f, stream);
    case 2: return launch_stage_accum_n<T, 2, V>(y, dt, K, a, out, b, f, stream);
    case 3: return launch_stage_accum_n<T, 3, V>(y, dt, K, a, out, b, f, stream);
    case 4: return launch_stage_accum_n<T, 4, V>(y, dt, K, a, out, b, f, stream);
    case 5: return launch_stage_accum_n<T, 5, V>(y, dt, K, a, out, b, f, stream);
    case 6: return launch_stage_accum_n<T, 6, V>(y, dt, K, a, out, b, f, stream);
    case 7: return launch_stage_accum_n<T, 7, V>(y, dt, K, a, out, b, f, stream);
    case 8: return launch_stage_accum_n<T, 8, V>(y, dt, K, a, out, b, f, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_stage_accum(const void* y, const void* dt, const void* K, const double* coeffs,
                       int nj, void* out, int64_t b, int64_t f, cudaStream_t stream) {
  static_assert(kMaxStages == 8, "launch_stage_accum_v instantiates counts 1..8");
  if (nj < 1 || nj > kMaxStages || b > 0x7fffffff || f > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b < 1 || f < 1) return static_cast<int>(cudaSuccess);  // nothing to write
  constexpr int V = 16 / sizeof(T);
  const auto yp = static_cast<const T*>(y), dp = static_cast<const T*>(dt),
             kp = static_cast<const T*>(K);
  const auto op = static_cast<T*>(out);
  const Coeffs<T> a = load_coeffs<T>(coeffs, nj);
  const int fi = static_cast<int>(f);
  return f % V == 0 && aligned16(y) && aligned16(K) && aligned16(out)
             ? launch_stage_accum_v<T, V>(yp, dp, kp, a, nj, op, b, fi, stream)
             : launch_stage_accum_v<T, 1>(yp, dp, kp, a, nj, op, b, fi, stream);
}

template <typename T, int NS, int V>
int launch_fused_update_n(const T* y, const T* K, const T* dt, const Coeffs<T>& bs,
                          const Coeffs<T>& be, T* y1, T* err, int64_t b, int f,
                          cudaStream_t stream) {
  // An empty batch still launches one block (row_shape's grid is at least
  // 1 x 1), so every counted launch is a launch.
  const RowShape s = row_shape(f / V, b, kAccumThreads);
  fused_update_kernel<T, NS, V><<<s.grid, s.block, 0, stream>>>(y, K, dt, bs, be, y1, err, b, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_fused_update_v(const T* y, const T* K, const T* dt, const Coeffs<T>& bs,
                          const Coeffs<T>& be, int ns, T* y1, T* err, int64_t b, int f,
                          cudaStream_t stream) {
  switch (ns) {
    case 1: return launch_fused_update_n<T, 1, V>(y, K, dt, bs, be, y1, err, b, f, stream);
    case 2: return launch_fused_update_n<T, 2, V>(y, K, dt, bs, be, y1, err, b, f, stream);
    case 3: return launch_fused_update_n<T, 3, V>(y, K, dt, bs, be, y1, err, b, f, stream);
    case 4: return launch_fused_update_n<T, 4, V>(y, K, dt, bs, be, y1, err, b, f, stream);
    case 5: return launch_fused_update_n<T, 5, V>(y, K, dt, bs, be, y1, err, b, f, stream);
    case 6: return launch_fused_update_n<T, 6, V>(y, K, dt, bs, be, y1, err, b, f, stream);
    case 7: return launch_fused_update_n<T, 7, V>(y, K, dt, bs, be, y1, err, b, f, stream);
    case 8: return launch_fused_update_n<T, 8, V>(y, K, dt, bs, be, y1, err, b, f, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_fused_update(const void* y, const void* K, const void* dt, const double* b_sol,
                        const double* b_err, int ns, void* y1, void* err, int64_t b,
                        int64_t f, cudaStream_t stream) {
  static_assert(kMaxStages == 8, "launch_fused_update_v instantiates counts 1..8");
  if (ns < 1 || ns > kMaxStages || b > 0x7fffffff || f > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int V = 16 / sizeof(T);
  const auto yp = static_cast<const T*>(y), kp = static_cast<const T*>(K),
             dp = static_cast<const T*>(dt);
  const auto y1p = static_cast<T*>(y1), ep = static_cast<T*>(err);
  const Coeffs<T> bs = load_coeffs<T>(b_sol, ns), be = load_coeffs<T>(b_err, ns);
  const int fi = static_cast<int>(f);
  return f % V == 0 && aligned16(y) && aligned16(K) && aligned16(y1) && aligned16(err)
             ? launch_fused_update_v<T, V>(yp, kp, dp, bs, be, ns, y1p, ep, b, fi, stream)
             : launch_fused_update_v<T, 1>(yp, kp, dp, bs, be, ns, y1p, ep, b, fi, stream);
}

// error_norm's bodies, numbered as cuda_impl.ERROR_NORM_BODIES.
constexpr int kNormWarpBody = 0, kNormRowBody = 1, kNormWideBody = 2;

template <typename T, int V, bool kEntries>
int launch_error_norm_row(const T* err, const T* y0, const T* y1, const Tol<T>& atol,
                          const Tol<T>& rtol, T* out, int64_t b, int f, cudaStream_t stream) {
  // A row of more than a warp's worth of chunks has a block of its own (up to
  // kNormThreads threads); narrower rows share one, each with the power of
  // two of threads at or above its chunk count.  The rows' scaled errors sit
  // in shared memory.
  const int nc = f / V;
  int tx = 1;
  while (tx < nc && tx < 32) tx *= 2;
  if (nc > 32) tx = ((nc < kNormThreads ? nc : kNormThreads) + 31) / 32 * 32;
  const int ty = nc > 32 ? 1 : kNormThreads / tx;
  const int64_t blocks = (b + ty - 1) / ty;
  error_norm_row_kernel<T, V, kEntries>
      <<<static_cast<unsigned>(blocks > 0 ? blocks : 1), dim3(tx, ty),
         static_cast<size_t>(ty) * f * sizeof(T), stream>>>(err, y0, y1, atol, rtol, out, b, f);
  return static_cast<int>(cudaGetLastError());
}

// Tolerances that are values a row (scalar or (b,), the solver's) take the
// variant that keeps no tolerance pointer in registers.
template <typename T, int V>
int launch_error_norm_rows(const void* err, const void* y0, const void* y1, const void* atol,
                           double atol_val, int64_t atol_rs, int64_t atol_cs, const void* rtol,
                           double rtol_val, int64_t rtol_rs, int64_t rtol_cs, void* out,
                           int64_t b, int f, cudaStream_t stream) {
  const auto ep = static_cast<const T*>(err), ap = static_cast<const T*>(y0),
             bp = static_cast<const T*>(y1);
  const auto op = static_cast<T*>(out);
  const Tol<T> at = make_tol<T>(atol, atol_val, atol_rs, atol_cs, V),
               rt = make_tol<T>(rtol, rtol_val, rtol_rs, rtol_cs, V);
  return at.mode == kTolRow && rt.mode == kTolRow
             ? launch_error_norm_row<T, V, false>(ep, ap, bp, at, rt, op, b, f, stream)
             : launch_error_norm_row<T, V, true>(ep, ap, bp, at, rt, op, b, f, stream);
}

// The wide body's two launches; `r` is the (b, ld) scratch.
template <typename T, int V, bool kEntries>
int launch_error_norm_wide_v(const T* err, const T* y0, const T* y1, const Tol<T>& atol,
                             const Tol<T>& rtol, T* r, int64_t ld, T* out, int64_t b, int f,
                             cudaStream_t stream) {
  const int64_t nc = f / V;
  const int64_t gx = (nc + kWideThreads - 1) / kWideThreads;
  const dim3 grid(static_cast<unsigned>(gx < 1 ? 1 : gx < 65535 ? gx : 65535),
                  static_cast<unsigned>(b < 1 ? 1 : b < 65535 ? b : 65535));
  error_norm_scaled_kernel<T, V, kEntries><<<grid, kWideThreads, 0, stream>>>(
      err, y0, y1, atol, rtol, r, b, f, ld);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = reserve_smem(error_norm_fold_kernel<T>, kFoldSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  error_norm_fold_kernel<T><<<static_cast<unsigned>(b > 0 ? b : 1), 64, kFoldSmem, stream>>>(
      r, out, b, f, ld);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_error_norm_wide(const void* err, const void* y0, const void* y1, const void* atol,
                           double atol_val, int64_t atol_rs, int64_t atol_cs, const void* rtol,
                           double rtol_val, int64_t rtol_rs, int64_t rtol_cs, void* scratch,
                           void* out, int64_t b, int f, cudaStream_t stream) {
  const auto ep = static_cast<const T*>(err), ap = static_cast<const T*>(y0),
             bp = static_cast<const T*>(y1);
  const auto op = static_cast<T*>(out), rp = static_cast<T*>(scratch);
  constexpr int kV = 16 / sizeof(T);
  const int64_t ld = (static_cast<int64_t>(f) + kV - 1) / kV * kV;
  const Tol<T> at = make_tol<T>(atol, atol_val, atol_rs, atol_cs, V),
               rt = make_tol<T>(rtol, rtol_val, rtol_rs, rtol_cs, V);
  return at.mode == kTolRow && rt.mode == kTolRow
             ? launch_error_norm_wide_v<T, V, false>(ep, ap, bp, at, rt, rp, ld, op, b, f, stream)
             : launch_error_norm_wide_v<T, V, true>(ep, ap, bp, at, rt, rp, ld, op, b, f, stream);
}

template <typename T>
int launch_error_norm(int body, const void* err, const void* y0, const void* y1,
                      const void* atol, double atol_val, int64_t atol_rs, int64_t atol_cs,
                      const void* rtol, double rtol_val, int64_t rtol_rs, int64_t rtol_cs,
                      void* scratch, void* out, int64_t b, int64_t f, cudaStream_t stream) {
  if (body == kNormWarpBody) {
    const int blocks = static_cast<int>((b + kWarpsPerBlock - 1) / kWarpsPerBlock);
    error_norm_kernel<T><<<blocks > 0 ? blocks : 1, 32 * kWarpsPerBlock, 0, stream>>>(
        static_cast<const T*>(err), static_cast<const T*>(y0), static_cast<const T*>(y1),
        make_tol<T>(atol, atol_val, atol_rs, atol_cs),
        make_tol<T>(rtol, rtol_val, rtol_rs, rtol_cs), static_cast<T*>(out), b, f);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int V = 16 / sizeof(T);
  if (body == kNormWideBody) {
    if (b > 0x7fffffff || f > 0x7fffffff || (scratch == nullptr && b > 0) ||
        !aligned16(scratch)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int fi = static_cast<int>(f);
    return f % V == 0 && aligned16(err) && aligned16(y0) && aligned16(y1)
               ? launch_error_norm_wide<T, V>(err, y0, y1, atol, atol_val, atol_rs, atol_cs, rtol,
                                             rtol_val, rtol_rs, rtol_cs, scratch, out, b, fi,
                                             stream)
               : launch_error_norm_wide<T, 1>(err, y0, y1, atol, atol_val, atol_rs, atol_cs, rtol,
                                             rtol_val, rtol_rs, rtol_cs, scratch, out, b, fi,
                                             stream);
  }
  if (body != kNormRowBody || b > 0x7fffffff || f > kNormRowMaxF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int fi = static_cast<int>(f);
  return f % V == 0 && aligned16(err) && aligned16(y0) && aligned16(y1)
             ? launch_error_norm_rows<T, V>(err, y0, y1, atol, atol_val, atol_rs, atol_cs, rtol,
                                           rtol_val, rtol_rs, rtol_cs, out, b, fi, stream)
             : launch_error_norm_rows<T, 1>(err, y0, y1, atol, atol_val, atol_rs, atol_cs, rtol,
                                           rtol_val, rtol_rs, rtol_cs, out, b, fi, stream);
}

// interp_eval's bodies, numbered as cuda_impl.INTERP_BODIES.
constexpr int kInterpCellBody = 0, kInterpRowBody = 1;

template <typename T, int V>
int launch_interp_eval_v(int body, const T* c0, const T* c1, const T* c2, const T* c3,
                         const T* x, const uint8_t* mask, const int64_t* cursor, T* out,
                         int64_t b, int64_t nw, int64_t n, int f, cudaStream_t stream) {
  if (body == kInterpCellBody) {
    const int64_t blocks = (b * nw + kCellThreads - 1) / kCellThreads;
    interp_eval_cell_kernel<T, V>
        <<<static_cast<unsigned>(blocks > 0 ? blocks : 1), kCellThreads, 0, stream>>>(
            c0, c1, c2, c3, x, mask, cursor, out, b, nw, n, f);
  } else {
    const RowShape s = row_shape(f / V, b, kInterpThreads);
    interp_eval_row_kernel<T, V><<<s.grid, s.block, 0, stream>>>(
        c0, c1, c2, c3, x, mask, cursor, out, b, static_cast<int>(nw), n, f);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_interp_eval(int body, const void* c0, const void* c1, const void* c2,
                       const void* c3, const void* x, const void* mask, const void* cursor,
                       void* out, int64_t b, int64_t nw, int64_t n, int64_t f,
                       cudaStream_t stream) {
  if ((body != kInterpCellBody && body != kInterpRowBody) || b > 0x7fffffff ||
      nw > 0x7fffffff || f > 0x7fffffff || b * nw > (int64_t{1} << 38)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int V = 16 / sizeof(T);
  const auto p0 = static_cast<const T*>(c0), p1 = static_cast<const T*>(c1),
             p2 = static_cast<const T*>(c2), p3 = static_cast<const T*>(c3),
             xp = static_cast<const T*>(x);
  const auto mp = static_cast<const uint8_t*>(mask);
  const auto cp = static_cast<const int64_t*>(cursor);
  const auto op = static_cast<T*>(out);
  const int fi = static_cast<int>(f);
  return f % V == 0 && aligned16(out) && aligned16(c0) && aligned16(c1) && aligned16(c2) &&
                 aligned16(c3)
             ? launch_interp_eval_v<T, V>(body, p0, p1, p2, p3, xp, mp, cp, op, b, nw, n, fi,
                                          stream)
             : launch_interp_eval_v<T, 1>(body, p0, p1, p2, p3, xp, mp, cp, op, b, nw, n, fi,
                                          stream);
}

}  // namespace

// ------------------------------------------------------------- C entry points
// dtype: 0 = float32, 1 = float64.  Every entry returns cudaGetLastError().

extern "C" {

int rt_max_stages() { return solver::kMaxStages; }

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rt_stage_accum(int dtype, const void* y, const void* dt, const void* K,
                   const double* coeffs, int nj, void* out, int64_t b, int64_t f,
                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_stage_accum<double>(y, dt, K, coeffs, nj, out, b, f, s)
               : launch_stage_accum<float>(y, dt, K, coeffs, nj, out, b, f, s);
}

int rt_fused_update(int dtype, const void* y, const void* K, const void* dt,
                    const double* b_sol, const double* b_err, int ns, void* y1, void* err,
                    int64_t b, int64_t f, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_fused_update<double>(y, K, dt, b_sol, b_err, ns, y1, err, b, f, s)
               : launch_fused_update<float>(y, K, dt, b_sol, b_err, ns, y1, err, b, f, s);
}

int rt_error_norm(int dtype, int body, const void* err, const void* y0, const void* y1,
                  const void* atol, double atol_val, int64_t atol_rs, int64_t atol_cs,
                  const void* rtol, double rtol_val, int64_t rtol_rs, int64_t rtol_cs,
                  void* scratch, void* out, int64_t b, int64_t f, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_error_norm<double>(body, err, y0, y1, atol, atol_val, atol_rs, atol_cs,
                                           rtol, rtol_val, rtol_rs, rtol_cs, scratch, out, b, f,
                                           s)
               : launch_error_norm<float>(body, err, y0, y1, atol, atol_val, atol_rs, atol_cs,
                                          rtol, rtol_val, rtol_rs, rtol_cs, scratch, out, b, f,
                                          s);
}

int rt_interp_eval(int dtype, int body, const void* c0, const void* c1, const void* c2,
                   const void* c3, const void* x, const void* mask, const void* cursor,
                   void* out, int64_t b, int64_t nw, int64_t n, int64_t f, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_interp_eval<double>(body, c0, c1, c2, c3, x, mask, cursor, out, b, nw,
                                            n, f, s)
               : launch_interp_eval<float>(body, c0, c1, c2, c3, x, mask, cursor, out, b, nw,
                                           n, f, s);
}

}  // extern "C"
