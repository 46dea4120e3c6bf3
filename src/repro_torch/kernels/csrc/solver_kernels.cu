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

constexpr int kThreads = 256;   // threads per block for the elementwise kernels

int blocks_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  // Grid-stride loops cover whatever one launch's grid does not.
  return static_cast<int>(blocks < 65535 * 8 ? (blocks > 0 ? blocks : 1) : 65535 * 8);
}

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
// Bound: (s + 3) * b * f elements.  The same walk as stage_accum with two
// accumulators, so K is streamed once for both outputs.
template <typename T>
__global__ void fused_update_kernel(const T* __restrict__ y, const T* __restrict__ K,
                                    const T* __restrict__ dt, Coeffs<T> bs, Coeffs<T> be,
                                    int ns, T* __restrict__ y1, T* __restrict__ err,
                                    int64_t b, int64_t f) {
  const int64_t n = b * f;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    T acc_sol, acc_err;
    weighted_sums(bs, be, ns, [&](int j) { return K[j * n + i]; }, acc_sol, acc_err);
    const T h = dt[i / f];
    y1[i] = fma_of(h, acc_sol, y[i]);
    err[i] = h * acc_err;
  }
}

// ----------------------------------------------------------------- error_norm
// Replaces pallas_impl.error_norm (:167, body _error_norm_kernel :149).
// Per-row WRMS of err / (atol + rtol * max(|y0|, |y1|)).  Bound: 3 * b * f
// elements (5 with (b, f) tolerances).  The TPU walks the feature tiles as a
// sequential grid axis with _init/_finalize on an output block; here one warp
// owns one row and loops over f itself (coalesced, lane-strided), then a
// shuffle reduction and sqrt(sum / f) -- no cross-block state.  8 rows to a
// block.  Tolerances come in through (row, column) strides, 0 for a broadcast
// axis; a null pointer means the scalar passed by value.
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

// ---------------------------------------------------------------- interp_eval
// Replaces pallas_impl.interp_eval (:226, body _interp_kernel :216).
// where(mask, Horner cubic(x), out).  The Pallas kernel reads and rewrites
// the whole (b, n, f) buffer every step; most cells are unmasked on any one
// step, so here one warp owns one (row, point) cell, returns at once when the
// cell is unmasked, and otherwise writes only that cell's f values IN PLACE.
// Bound: masked cells x f written, the coefficients of those rows read, plus
// b * n positions and masks.  With a non-null cursor the (b, W) positions and
// masks address the window out[row, cursor[row] + w, :] (windowed dense
// output), so the window is written straight into the buffer with no
// gather/scatter round trip.  Horner rounds each multiply and add on its own
// (solver_common.cuh's horner_rn), as the plain version does, so the cells
// equal ref.interp_eval's bitwise and the event localizer's interpolant
// (events.cu) is the dense output's.
template <typename T>
__global__ void interp_eval_kernel(const T* __restrict__ c0, const T* __restrict__ c1,
                                   const T* __restrict__ c2, const T* __restrict__ c3,
                                   const T* __restrict__ x, const uint8_t* __restrict__ mask,
                                   const int64_t* __restrict__ cursor, T* __restrict__ out,
                                   int64_t b, int64_t nw, int64_t n, int64_t f) {
  const int lane = threadIdx.x & 31;
  const int64_t cell = blockIdx.x * (int64_t)kWarpsPerBlock + (threadIdx.x >> 5);
  if (cell >= b * nw || !mask[cell]) return;
  const int64_t row = cell / nw;
  const int64_t col = cell % nw + (cursor ? cursor[row] : 0);
  if (col < 0 || col >= n) return;  // a bad cursor never writes outside out
  const T xv = x[cell];
  const int64_t cb = row * f;
  T* o = out + (row * n + col) * f;
  for (int64_t c = lane; c < f; c += 32) {
    o[c] = horner_rn(c0[cb + c], c1[cb + c], c2[cb + c], c3[cb + c], xv);
  }
}

template <typename T, int NJ, int V>
int launch_stage_accum_n(const T* y, const T* dt, const T* K, const Coeffs<T>& a, T* out,
                         int64_t b, int f, cudaStream_t stream) {
  // Threads of a row: up to a warp, its chunk count rounded up to a power of
  // two, and the rest of the block takes further rows; above a warp, blocks
  // of at most kAccumThreads a row, the chunks spread evenly over whole
  // warps.
  const int nc = f / V;
  const int64_t chunk_blocks = (nc + kAccumThreads - 1) / kAccumThreads;
  int tx = 1;
  while (tx < nc && tx < 32) tx *= 2;
  if (nc > 32) tx = static_cast<int>((nc + chunk_blocks - 1) / chunk_blocks + 31) / 32 * 32;
  const int ty = kAccumThreads / tx;
  const int64_t row_blocks = (b + ty - 1) / ty;
  const dim3 grid(static_cast<unsigned>(row_blocks),
                  static_cast<unsigned>(chunk_blocks < 65535 ? chunk_blocks : 65535));
  stage_accum_kernel<T, NJ, V><<<grid, dim3(tx, ty), 0, stream>>>(y, dt, K, a, out, b, f);
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

template <typename T>
int launch_fused_update(const void* y, const void* K, const void* dt, const double* b_sol,
                        const double* b_err, int ns, void* y1, void* err, int64_t b,
                        int64_t f, cudaStream_t stream) {
  fused_update_kernel<T><<<blocks_for(b * f, kThreads), kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(K), static_cast<const T*>(dt),
      load_coeffs<T>(b_sol, ns), load_coeffs<T>(b_err, ns), ns, static_cast<T*>(y1),
      static_cast<T*>(err), b, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_error_norm(const void* err, const void* y0, const void* y1, const void* atol,
                      double atol_val, int64_t atol_rs, int64_t atol_cs, const void* rtol,
                      double rtol_val, int64_t rtol_rs, int64_t rtol_cs, void* out,
                      int64_t b, int64_t f, cudaStream_t stream) {
  const int blocks = static_cast<int>((b + kWarpsPerBlock - 1) / kWarpsPerBlock);
  error_norm_kernel<T><<<blocks > 0 ? blocks : 1, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const T*>(err), static_cast<const T*>(y0), static_cast<const T*>(y1),
      make_tol<T>(atol, atol_val, atol_rs, atol_cs), make_tol<T>(rtol, rtol_val, rtol_rs, rtol_cs),
      static_cast<T*>(out), b, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_interp_eval(const void* c0, const void* c1, const void* c2, const void* c3,
                       const void* x, const void* mask, const void* cursor, void* out,
                       int64_t b, int64_t nw, int64_t n, int64_t f, cudaStream_t stream) {
  const int64_t blocks = (b * nw + kWarpsPerBlock - 1) / kWarpsPerBlock;
  interp_eval_kernel<T><<<static_cast<unsigned>(blocks > 0 ? blocks : 1),
                          32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const T*>(c0), static_cast<const T*>(c1), static_cast<const T*>(c2),
      static_cast<const T*>(c3), static_cast<const T*>(x),
      static_cast<const uint8_t*>(mask), static_cast<const int64_t*>(cursor),
      static_cast<T*>(out), b, nw, n, f);
  return static_cast<int>(cudaGetLastError());
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

int rt_error_norm(int dtype, const void* err, const void* y0, const void* y1,
                  const void* atol, double atol_val, int64_t atol_rs, int64_t atol_cs,
                  const void* rtol, double rtol_val, int64_t rtol_rs, int64_t rtol_cs,
                  void* out, int64_t b, int64_t f, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_error_norm<double>(err, y0, y1, atol, atol_val, atol_rs, atol_cs,
                                           rtol, rtol_val, rtol_rs, rtol_cs, out, b, f, s)
               : launch_error_norm<float>(err, y0, y1, atol, atol_val, atol_rs, atol_cs,
                                          rtol, rtol_val, rtol_rs, rtol_cs, out, b, f, s);
}

int rt_interp_eval(int dtype, const void* c0, const void* c1, const void* c2, const void* c3,
                   const void* x, const void* mask, const void* cursor, void* out,
                   int64_t b, int64_t nw, int64_t n, int64_t f, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_interp_eval<double>(c0, c1, c2, c3, x, mask, cursor, out, b, nw, n,
                                            f, s)
               : launch_interp_eval<float>(c0, c1, c2, c3, x, mask, cursor, out, b, nw, n,
                                           f, s);
}

}  // extern "C"
