// Hand-written Hopper (sm_90a) kernels for the fused explicit-RK step.
//
// fused_step replaces pallas_impl.fused_step (:1000; bodies _fused_step_kernel
// :744 and the feature-tiled _fused_step_tiled_kernel :880 with
// _tiled_commit :826, _ctrl_decide :651, _ctrl_commit :678).  fused_step_poly
// replaces pallas_impl.fused_step_poly (:1058; _fused_step_poly_kernel :774,
// tiled :902, stages by _poly_stages :723).  Both compute exactly what
// ref.fused_step / ref.fused_step_poly compute: one whole explicit step
// attempt after the stage evaluations -- the b_sol/b_err combine, the WRMS
// error ratio (inf where `failed`), the PID or fixed-step decision, the
// masked commit of (y, f, t, dt) under `running`, and the cubic-Hermite
// coefficients c1..c3 -- in one launch.  The derivative cache f(t, y) that a
// rejected row keeps and the Hermite build reads is K[0], or `f0` where the
// caller passes it (a diagonally implicit tableau whose first stage is
// implicit has K[0] != f(t, y)).  fused_step_poly also runs the stage
// recursion of an elementwise polynomial vector field by Horner in registers
// (and the trailing evaluation of non-FSAL tableaus), so a whole step attempt
// is one launch with no vector-field launch at all.
//
// Bound: the bytes.  fused_step reads y, K (s planes) and f1 and writes y1,
// y_out, f_out and c1..c3: (s + 2 + 6) * b * f elements, a few dozen flops
// each.  fused_step_poly reads y and f0 and writes the same six planes.
//
// Under autograd both kernels also write the embedded error estimate err =
// dt * (b_err . K) (`err`, (b, f)), and fused_step_poly the s stages it used
// (`stages`, the (s, b, f) buffer rk_step would hold; K[0] = f0) and their
// arguments z_i = y + dt * (a_i . K) (`zs`, (s - 1, b, f)): the backwards
// read these bits rather than a recomputation that rounds apart (err is a
// difference of two solutions, and poly'(z) may cancel, so in float32 a few
// ulps move them by much more).  In the warp body and fused_step_poly's row
// body the stores sit behind a template flag (kSave) set only when one of
// the pointers is: without grad the launch runs the variant compiled
// without them, the same code and the same bits (tested at run time they
// cost the poly row body a quarter of its time).  fused_step's row body
// tests its one pointer, err, at run time, at no measured cost.
//
// Schedule.  The TPU holds a whole row in VMEM (one pass), or for f > 128
// runs a two-phase feature-tiled grid.  Here two bodies:
//
// The warp body (where the row body does not fit): one warp owns one row, 8
// rows to a block, as error_norm does, and sweeps f twice:
//   sweep 1 forms y1 and err per element and accumulates error_norm's sum of
//           squares lane-strided, then the same xor-shuffle reduction and
//           sqrt(sum / f); every lane then holds the ratio and runs the
//           controller decision in registers;
//   sweep 2 recomputes y1 (and the stages, for polynomials) per element and
//           writes the planes under the decided accept mask; lane 0 writes
//           the (b,) columns.
// No f limit, no shared memory, no cross-block state; sweep 2 re-reads its
// inputs, largely from L2.
//
// The row bodies (below, with their layout): a block per row, a thread per
// 16-byte chunk, and the row's scaled errors, y and k0 kept in shared memory
// for the ordered sum and the commit (row_finish, one copy for both).
// fused_step_poly's runs the stage recursion once per entry with the
// polynomial's coefficients in registers; fused_step's issues the chunk's
// stage loads together, its stage count a template argument.  What held the
// warp body back on fused_step_poly (PERF.md): 128 blocks for 132 SMs at
// step_bench's b = 1024 (two warps a scheduler), one 4-byte element of a
// lane at a time, the whole recursion run twice with its coefficients
// reloaded at every stage.  On an NVIDIA H100 80GB HBM3 (700 W), b = 1024, f
// = 784, dopri5, the logistic polynomial, float32: 0.080 ms the warp body,
// 0.017 the row body, against a 0.0048 ms bound (16 MB) and a 0.0053 ms
// launch floor.  The register-held Horner takes its coefficient count as a
// template argument: a count read at run time put the coefficients on the
// stack and spent a compare and a select per degree (0.026-0.029 ms).
//
// Bitwise agreement with the unfused card path: the combine, the stage sums
// and the WRMS terms come from solver_common.cuh, as in fused_update,
// stage_accum and error_norm; the controller tail and the Hermite build
// follow ref.pid_update / ref.hermite_coeffs as ATen runs them on the card,
// one rounding per PyTorch op (no contraction), the Python-float coefficients
// cast to T first as ATen casts a scalar operand, and pow with ATen's special
// cases for a scalar exponent.

#include "solver_common.cuh"

// The host's view of one launch, filled through ctypes (see cuda_impl.py):
// device pointers, tolerance strides and the static configuration.
struct FusedStepArgs {
  const void *y, *K, *f1, *poly, *t, *t_new, *dt_cur, *safe_dt, *prev_inv, *prev2_inv;
  const void *running, *failed, *f0, *atol, *rtol;
  void *y1, *ratio, *accept, *y_out, *f_out, *t_out, *dt_out, *new_inv, *new_inv2;
  void *c1, *c2, *c3;
  void* stages;  // fused_step_poly: the (s, b, f) stages, or null
  void* err;     // the (b, f) error estimate, or null
  void* zs;      // fused_step_poly: the (s - 1, b, f) stage arguments, or null
  double atol_val, rtol_val;
  int64_t atol_rs, atol_cs, rtol_rs, rtol_cs, b, f;
  int32_t s, npoly, fsal, ctrl_mode;  // ctrl_mode: 0 = pid, 1 = fixed
  double ctrl[8];  // b1, b2, b3, safety, factor_min, factor_max, dt_min, dt_max
  double b_sol[solver::kMaxStages], b_err[solver::kMaxStages];
  double a[solver::kMaxStages * solver::kMaxStages];  // row-major (s, s), poly only
};

namespace {

using namespace solver;

// The kernel's parameters, by value in its parameter space.
template <typename T>
struct Params {
  const T *y, *K, *f1, *f0, *poly, *t, *t_new, *dt_cur, *safe_dt, *prev_inv, *prev2_inv;
  const uint8_t *running, *failed;
  Tol<T> atol, rtol;
  T *y1, *ratio, *y_out, *f_out, *t_out, *dt_out, *new_inv, *new_inv2, *c1, *c2, *c3;
  T *stages, *err, *zs;
  uint8_t* accept;
  int64_t b, f;
  int s, npoly, fsal, ctrl_mode;
  double ctrl[8];
  Coeffs<T> b_sol, b_err;
  Coeffs<T> a[kMaxStages];
};

__device__ __forceinline__ float rsqrt_of(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_of(double x) { return rsqrt(x); }
__device__ __forceinline__ float pow_of(float x, float e) { return powf(x, e); }
__device__ __forceinline__ double pow_of(double x, double e) { return pow(x, e); }
__device__ __forceinline__ float fmax_of(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax_of(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float fmin_of(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double fmin_of(double a, double b) { return fmin(a, b); }

// torch.pow(x, e) for a Python-float exponent, as ATen computes it on the
// card: 0 fills 1, 1 copies, 0.5 / -0.5 / -1 go to sqrt / rsqrt /
// reciprocal, and after the cast of e to T, 2 / 3 / -2 are products.
template <typename T>
__device__ __forceinline__ T aten_pow(T x, double e) {
  if (e == 0.0) return T(1);
  if (e == 1.0) return x;
  if (e == 0.5) return sqrt_of(x);
  if (e == -0.5) return rsqrt_of(x);
  if (e == -1.0) return T(1) / x;
  const T et = static_cast<T>(e);
  const double de = static_cast<double>(et);
  if (de == 2.0) return mul_rn(x, x);
  if (de == 3.0) return mul_rn(mul_rn(x, x), x);
  if (de == -2.0) return static_cast<T>(1.0 / static_cast<double>(mul_rn(x, x)));
  return pow_of(x, et);
}

// torch.clamp(x, lo, hi) with scalar bounds: NaN passes through.
template <typename T>
__device__ __forceinline__ T aten_clamp(T x, T lo, T hi) {
  return x != x ? x : fmin_of(fmax_of(x, lo), hi);
}

template <typename T>
__device__ __forceinline__ T sign_of(T x) {  // torch.sign: 0 for 0 and NaN
  return static_cast<T>((T(0) < x) - (x < T(0)));
}

template <typename T>
struct Decision {
  bool accept;  // the controller's decision, before the running / failed masks
  T dt_next, new_inv, new_inv2;
};

// ref.pid_update for one row, op for op.
template <typename T>
__device__ __forceinline__ Decision<T> pid_decide(const double* ctrl, T ratio, T dt, T pi1,
                                                  T pi2) {
  const bool finite = isfinite(ratio);
  const T safe = (finite && ratio > T(0)) ? ratio : T(1);
  const T inv = T(1) / safe;
  T factor = mul_rn(static_cast<T>(ctrl[3]), aten_pow(inv, ctrl[0]));
  factor = mul_rn(factor, aten_pow(pi1, ctrl[1]));
  factor = mul_rn(factor, aten_pow(pi2, ctrl[2]));
  if (ratio == T(0)) factor = static_cast<T>(ctrl[5]);
  if (!finite) factor = T(0.5);
  factor = aten_clamp(factor, static_cast<T>(ctrl[4]), static_cast<T>(ctrl[5]));
  const bool accept = finite && ratio <= T(1);
  if (!accept) factor = factor != factor ? factor : fmin_of(factor, T(1));
  const T mag = aten_clamp(mul_rn(abs_of(dt), factor), static_cast<T>(ctrl[6]),
                           static_cast<T>(ctrl[7]));
  return {accept, mul_rn(sign_of(dt), mag), accept ? inv : pi1, accept ? pi1 : pi2};
}

// poly_eval at one element: Horner over the (npoly, f) coefficient rows, a
// multiply then an add per degree, as the plain version's two ops.
template <typename T>
__device__ __forceinline__ T poly_at(const Params<T>& p, int64_t c, T x) {
  T acc = p.poly[(p.npoly - 1) * p.f + c];
  for (int d = p.npoly - 2; d >= 0; --d) acc = add_rn(mul_rn(acc, x), p.poly[d * p.f + c]);
  return acc;
}

// poly_eval at entry c, its coefficients read from device memory.
template <typename T>
struct PolyAt {
  const Params<T>& p;
  int64_t c;
  __device__ __forceinline__ T operator()(T x) const { return poly_at(p, c, x); }
};

constexpr int kPolyRegs = 4;  // coefficient rows the row body holds in registers

// poly_eval at one entry, its NP <= kPolyRegs coefficients in registers: the
// same multiply, then add, per degree.
template <typename T, int NP>
struct PolyRegs {
  T c[NP];
  __device__ __forceinline__ T operator()(T x) const {
    T acc = c[NP - 1];
#pragma unroll
    for (int d = NP - 2; d >= 0; --d) acc = add_rn(mul_rn(acc, x), c[d]);
    return acc;
  }
};

template <typename T>
struct Element {
  T y, y1, err, k0, f1;
};

// The stage recursion of rk_step at one element for the polynomial `pf`
// (stage_accum's sum, then poly_eval), the b_sol/b_err combine and (with_f1)
// the derivative at y1: the last stage, or pf(y1) for a non-FSAL tableau.
// Both bodies of fused_step_poly call it, with the coefficients read from
// device memory (PolyAt) or held in registers (PolyRegs).  With kSave,
// where p.stages (p.zs) is set and i >= 0, the stages (the stage
// arguments) of element i (row * f + c) are stored there.
template <typename T, bool kSave, typename Poly>
__device__ __forceinline__ Element<T> poly_element(const Params<T>& p, T y, T f0, T h,
                                                   bool with_f1, Poly pf, int64_t i) {
  Element<T> e;
  e.y = y;
  T ks[kMaxStages];
  ks[0] = f0;
  T last = ks[0];
#pragma unroll
  for (int st = 1; st < kMaxStages; ++st) {
    if (st < p.s) {
      const T acc = weighted_sum(p.a[st], st, [&](int j) { return ks[j]; });
      const T z = fma_of(h, acc, y);
      if constexpr (kSave) {
        if (p.zs && i >= 0) p.zs[(st - 1) * p.b * p.f + i] = z;
      }
      ks[st] = pf(z);
      last = ks[st];
    }
  }
  T acc_sol, acc_err;
  weighted_sums(p.b_sol, p.b_err, p.s, [&](int j) { return ks[j]; }, acc_sol, acc_err);
  e.k0 = ks[0];
  e.y1 = fma_of(h, acc_sol, y);
  if (with_f1) e.f1 = p.fsal ? last : pf(e.y1);
  e.err = h * acc_err;
  if constexpr (kSave) {
    if (p.stages && i >= 0) {
      const int64_t n = p.b * p.f;
#pragma unroll
      for (int st = 0; st < kMaxStages; ++st) {
        if (st < p.s) p.stages[st * n + i] = ks[st];
      }
    }
  }
  return e;
}

// y1, err, the derivative cache k0 (f0 where given, else K[0]) and
// (with_f1) f1 of element (row, c); i = row * f + c.
template <typename T, bool kPoly, bool kSave>
__device__ __forceinline__ Element<T> element(const Params<T>& p, int64_t i, int64_t c, T h,
                                              bool with_f1) {
  if constexpr (kPoly) {
    // The stages go out once, in sweep 2 (with_f1).
    return poly_element<T, kSave>(p, p.y[i], p.K[i], h, with_f1, PolyAt<T>{p, c},
                                  with_f1 ? i : -1);
  } else {
    Element<T> e;
    e.y = p.y[i];
    T acc_sol, acc_err;
    const int64_t n = p.b * p.f;
    weighted_sums(p.b_sol, p.b_err, p.s, [&](int j) { return p.K[j * n + i]; }, acc_sol,
                  acc_err);
    e.k0 = p.f0 ? p.f0[i] : p.K[i];
    e.y1 = fma_of(h, acc_sol, e.y);
    if (with_f1) e.f1 = p.f1[i];
    e.err = h * acc_err;
    return e;
  }
}

// ref.hermite_coeffs' c2 and c3 at one element, one rounding per op (c1 is
// h * k0).
template <typename T>
__device__ __forceinline__ T hermite_c2(T y, T y1, T k0, T f1, T h) {
  return sub_rn(mul_rn(T(3), sub_rn(y1, y)), mul_rn(h, add_rn(mul_rn(T(2), k0), f1)));
}

template <typename T>
__device__ __forceinline__ T hermite_c3(T y, T y1, T k0, T f1, T h) {
  return add_rn(mul_rn(T(2), sub_rn(y, y1)), mul_rn(h, add_rn(k0, f1)));
}

// __grid_constant__: the helpers take p by reference straight from the
// parameter space, with no per-thread copy of the ~1 KB struct.
template <typename T, bool kPoly, bool kSave>
__global__ void fused_step_kernel(const __grid_constant__ Params<T> p) {
  const int lane = threadIdx.x & 31;
  const int64_t row = blockIdx.x * (int64_t)kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= p.b) return;  // the whole warp leaves together
  const int64_t base = row * p.f;
  const T h = p.safe_dt[row];

  // Sweep 1: error_norm's sum of squares over the row.
  T sum = T(0);
  for (int64_t c = lane; c < p.f; c += 32) {
    const Element<T> e = element<T, kPoly, kSave>(p, base + c, c, h, false);
    sum = wrms_add(sum, e.err, e.y, e.y1, p.atol.at(row, c), p.rtol.at(row, c));
  }
  T ratio = wrms_finish(warp_sum(sum), p.f);
  const bool failed = p.failed && p.failed[row];
  if (failed) ratio = T(INFINITY);

  // The decision, in every lane.
  const T dt_cur = p.dt_cur[row], pi1 = p.prev_inv[row], pi2 = p.prev2_inv[row];
  const Decision<T> d = p.ctrl_mode == 0 ? pid_decide(p.ctrl, ratio, dt_cur, pi1, pi2)
                                         : Decision<T>{true, dt_cur, pi1, pi2};
  const bool running = p.running[row] != 0;
  const bool accept = d.accept && running && !failed;
  if (lane == 0) {
    p.ratio[row] = ratio;
    p.accept[row] = accept;
    p.t_out[row] = accept ? p.t_new[row] : p.t[row];
    p.dt_out[row] = running ? d.dt_next : dt_cur;
    p.new_inv[row] = d.new_inv;
    p.new_inv2[row] = d.new_inv2;
  }

  // Sweep 2: the planes, under the decided mask.
  for (int64_t c = lane; c < p.f; c += 32) {
    const int64_t i = base + c;
    const Element<T> e = element<T, kPoly, kSave>(p, i, c, h, true);
    p.y1[i] = e.y1;
    if constexpr (kSave) {
      if (p.err) p.err[i] = e.err;
    }
    p.y_out[i] = accept ? e.y1 : e.y;
    p.f_out[i] = accept ? e.f1 : e.k0;
    if (p.c1) {  // ref.hermite_coeffs, one rounding per op
      p.c1[i] = mul_rn(h, e.k0);
      p.c2[i] = hermite_c2(e.y, e.y1, e.k0, e.f1, h);
      p.c3[i] = hermite_c3(e.y, e.y1, e.k0, e.f1, h);
    }
  }
}

// ------------------------------------------------------ the row body (poly)
// fused_step_poly's row body: one block per row, a thread per V-entry chunk
// (V = 16 / sizeof(T) where f % V == 0 and the vector planes start 16-byte
// aligned, else V = 1), up to kRowThreads threads.  Three phases:
//   1. each thread issues the loads of its chunk -- y, f0 and the chunk's NP
//      coefficient rows (NP = npoly <= kPolyRegs; NP = 0 reads them from
//      device memory in the chain, as the warp body does), and the next
//      chunk's y and f0 -- then runs the stage recursion once per entry
//      (poly_element) and writes y1, c1..c3 and, as if the row were
//      accepted, y_out = y1 and f_out = f1; it keeps r (the scaled error),
//      y and f0 in shared memory.  Lanes 0-6 of warp 0 also load the row's
//      seven (b,) inputs, one a lane, and leave them in shared memory after
//      the stages;
//   2. warp 0 folds r^2 lane-strided in increasing c from 0 (error_norm's
//      order: lane l takes c = l, l + 32, ...), then warp_sum and
//      wrms_finish, so the ratio is bitwise the warp body's; it decides as
//      the warp body does, writes the (b,) columns and leaves accept in
//      shared memory;
//   3. a rejected row rewrites y_out = y and f_out = f0 from shared memory.
// Shared memory (row_smem_bytes; cuda_impl.row_smem_bytes): kRowHead bytes
// for the seven inputs and accept, then three planes of f entries, each
// padded to 16 bytes.
constexpr int kRowThreads = 128;
constexpr int kRowHead = 80;  // 8 slots of T, then accept at byte 64

// Blocks an SM must hold: 8 of 128 threads (64 registers a thread) in
// float32, 4 (128 registers) in float64.  On an H100 at b = 1024, f = 784
// these measured fastest against 256-thread blocks and the other register
// caps (PERF.md): in float32 all 1024 rows are resident at once.
template <typename T>
constexpr int row_min_blocks() {
  return sizeof(T) == 4 ? 8 : 4;
}

// Bytes of one plane of f entries of `size` bytes, padded to 16 bytes.
__host__ __device__ inline size_t row_plane_bytes(int64_t f, size_t size) {
  return (static_cast<size_t>(f) * size + 15) / 16 * 16;
}

inline size_t row_smem_bytes(int64_t f, size_t size) {
  return kRowHead + 3 * row_plane_bytes(f, size);
}

// Entries of one such plane: the stride of the row bodies' shared planes.
__device__ __forceinline__ int row_plane(int f, size_t size) {
  return static_cast<int>(row_plane_bytes(f, size) / size);
}

// The row's (b,) input that lane k of a row body loads (k < 7), else 0.
template <typename T>
__device__ __forceinline__ T row_column(const Params<T>& p, int64_t row, int k) {
  switch (k) {
    case 0: return p.dt_cur[row];
    case 1: return p.prev_inv[row];
    case 2: return p.prev2_inv[row];
    case 3: return p.t[row];
    case 4: return p.t_new[row];
    case 5: return T(p.running[row] != 0);
    case 6: return T(p.failed && p.failed[row]);
    default: return T(0);
  }
}

// Phases 2 and 3 of both row bodies, once phase 1 has left the row's scaled
// errors r, y and k0 in shared memory and `col` is row_column's input.
template <typename T, int V>
__device__ __forceinline__ void row_finish(const Params<T>& p, int64_t row, T col,
                                           unsigned char* smem) {
  const int f = static_cast<int>(p.f);
  const int nc = f / V;
  const int64_t base = row * p.f;
  T* cols_s = reinterpret_cast<T*>(smem);
  int* accept_s = reinterpret_cast<int*>(smem + 64);
  const T* r_s = reinterpret_cast<const T*>(smem + kRowHead);
  const T* y_s = r_s + row_plane(f, sizeof(T));
  const T* k0_s = y_s + row_plane(f, sizeof(T));
  if (threadIdx.x < 7) cols_s[threadIdx.x] = col;
  __syncthreads();

  // 2. The ratio in error_norm's order, and the decision (the warp body's).
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    T sum = T(0);
#pragma unroll 8
    for (int c = lane; c < f; c += 32) sum = fma_of(r_s[c], r_s[c], sum);
    T ratio = wrms_finish(warp_sum(sum), p.f);
    const bool failed = cols_s[6] != T(0);
    if (failed) ratio = T(INFINITY);
    const T dt_cur = cols_s[0], pi1 = cols_s[1], pi2 = cols_s[2];
    const Decision<T> d = p.ctrl_mode == 0 ? pid_decide(p.ctrl, ratio, dt_cur, pi1, pi2)
                                           : Decision<T>{true, dt_cur, pi1, pi2};
    const bool running = cols_s[5] != T(0);
    const bool accept = d.accept && running && !failed;
    if (lane == 0) {
      p.ratio[row] = ratio;
      p.accept[row] = accept;
      p.t_out[row] = accept ? cols_s[4] : cols_s[3];
      p.dt_out[row] = running ? d.dt_next : dt_cur;
      p.new_inv[row] = d.new_inv;
      p.new_inv2[row] = d.new_inv2;
      *accept_s = accept;
    }
  }
  __syncthreads();

  // 3. A rejected row keeps y and k0.
  if (*accept_s) return;
  for (int q = threadIdx.x; q < nc; q += blockDim.x) {
    const int c0 = q * V;
    store_chunk<T, V>(p.y_out + base + c0, shared_chunk<T, V>(y_s + c0));
    store_chunk<T, V>(p.f_out + base + c0, shared_chunk<T, V>(k0_s + c0));
  }
}

template <typename T, int V, int NP, bool kSave>
__global__ void __launch_bounds__(kRowThreads, row_min_blocks<T>())
    fused_step_poly_row_kernel(const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int f = static_cast<int>(p.f);
  T* r_s = reinterpret_cast<T*>(smem + kRowHead);
  T* y_s = r_s + row_plane(f, sizeof(T));
  T* k0_s = y_s + row_plane(f, sizeof(T));
  const int64_t row = blockIdx.x;
  const int64_t base = row * p.f;
  const T h = p.safe_dt[row];
  const int nc = f / V;
  const int k = threadIdx.x;

  // The row's (b,) inputs, one a lane, in flight while the stages run.
  const T col = row_column(p, row, k);

  // 1. The stages, once per entry; the loads of a chunk before its chain,
  // and the next chunk's y and f0 in flight while it runs.
  Vec<T, V> y_next, f0_next;
  if (threadIdx.x < nc) {
    y_next = load_chunk<T, V>(p.y + base + threadIdx.x * V);
    f0_next = load_chunk<T, V>(p.K + base + threadIdx.x * V);
  }
  for (int q = threadIdx.x; q < nc; q += blockDim.x) {
    const int c0 = q * V;
    const Vec<T, V> y = y_next, f0 = f0_next;
    if (q + static_cast<int>(blockDim.x) < nc) {
      y_next = load_chunk<T, V>(p.y + base + c0 + blockDim.x * V);
      f0_next = load_chunk<T, V>(p.K + base + c0 + blockDim.x * V);
    }
    Vec<T, V> cf[NP > 0 ? NP : 1];
    if constexpr (NP > 0) {
#pragma unroll
      for (int d = 0; d < NP; ++d) {
        cf[d] = load_chunk<T, V>(p.poly + static_cast<int64_t>(d) * f + c0);
      }
    }
    Vec<T, V> r, y1, f1, err;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = c0 + j;
      Element<T> e;
      if constexpr (NP > 0) {
        PolyRegs<T, NP> pr;
#pragma unroll
        for (int d = 0; d < NP; ++d) pr.c[d] = cf[d].v[j];
        e = poly_element<T, kSave>(p, y.v[j], f0.v[j], h, true, pr, base + c);
      } else {
        e = poly_element<T, kSave>(p, y.v[j], f0.v[j], h, true, PolyAt<T>{p, c}, base + c);
      }
      r.v[j] = wrms_scaled(e.err, e.y, e.y1, p.atol.at(row, c), p.rtol.at(row, c));
      y1.v[j] = e.y1;
      f1.v[j] = e.f1;
      err.v[j] = e.err;
    }
    if constexpr (kSave) {
      if (p.err) store_chunk<T, V>(p.err + base + c0, err);
    }
    // The planes as if the row were accepted; a rejected row rewrites y_out
    // and f_out in phase 3 (the first writes are still in L2 then).
    store_chunk<T, V>(p.y1 + base + c0, y1);
    store_chunk<T, V>(p.y_out + base + c0, y1);
    store_chunk<T, V>(p.f_out + base + c0, f1);
    if (p.c1) {  // ref.hermite_coeffs, one rounding per op
      Vec<T, V> c1, c2, c3;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        c1.v[j] = mul_rn(h, f0.v[j]);
        c2.v[j] = hermite_c2(y.v[j], y1.v[j], f0.v[j], f1.v[j], h);
        c3.v[j] = hermite_c3(y.v[j], y1.v[j], f0.v[j], f1.v[j], h);
      }
      store_chunk<T, V>(p.c1 + base + c0, c1);
      store_chunk<T, V>(p.c2 + base + c0, c2);
      store_chunk<T, V>(p.c3 + base + c0, c3);
    }
    store_chunk<T, V>(r_s + c0, r);
    store_chunk<T, V>(y_s + c0, y);
    store_chunk<T, V>(k0_s + c0, f0);
  }
  row_finish<T, V>(p, row, col, smem);
}

// --------------------------------------------------- the row body (K planes)
// fused_step's row body: fused_step_poly's row body with the s stage planes
// K as the stage source.  One block per row, a thread per V-entry chunk (V =
// 16 / sizeof(T) where f % V == 0 and every plane starts 16-byte aligned,
// else V = 1), the stage count S a template argument.  Phase 1: each thread
// issues its chunk's S K loads, y's and, where they are not already among
// them, f1's (FSAL: f1 is the plane K[S-1], compared by pointer) and f0's
// before the first fma; forms y1 and err with fused_update's sums
// (weighted_sums_n: acc from 0, fma(w_j, K_j, acc) for j ascending, the
// bits of the warp body's weighted_sums); writes y1, c1..c3, and y_out = y1,
// f_out = f1 as if the row were accepted; and keeps r, y and k0 (f0 where
// given, else K[0]) in shared memory.  Phases 2 and 3 are row_finish.  What
// held the warp body back, as on fused_step_poly: 128 blocks for 132 SMs at
// b = 1024, one 4-byte element of a lane at a time behind a run-time stage
// count, and every plane read twice (two sweeps).
//
// Threads a block and blocks an SM must hold: 128 and 6 (80 registers a
// thread) in float32, 256 and 2 (128) in float64.  On an H100 at b = 1024
// these measured fastest against the row body of fused_step_poly's 128 and
// 8 (64 registers; the float32 variants of 6 to 8 stages spilled up to 48
// bytes, and rows of f <= 128 ran 10-15 % slower) and 256 threads in
// float32 (PERF.md).
template <typename T>
constexpr int step_row_threads() {
  return sizeof(T) == 4 ? 128 : 256;
}

template <typename T>
constexpr int step_row_min_blocks() {
  return sizeof(T) == 4 ? 6 : 2;
}

template <typename T, int V, int S>
__global__ void __launch_bounds__(step_row_threads<T>(), step_row_min_blocks<T>())
    fused_step_row_kernel(const __grid_constant__ Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int f = static_cast<int>(p.f);
  T* r_s = reinterpret_cast<T*>(smem + kRowHead);
  T* y_s = r_s + row_plane(f, sizeof(T));
  T* k0_s = y_s + row_plane(f, sizeof(T));
  const int64_t row = blockIdx.x;
  const int64_t n = p.b * p.f;  // K[j] is plane j
  const int64_t base = row * p.f;
  const T h = p.safe_dt[row];
  const int nc = f / V;
  const bool f1_is_last = p.f1 == p.K + (S - 1) * n;

  // The row's (b,) inputs, one a lane, in flight while the chunks load.
  const T col = row_column(p, row, threadIdx.x);

  for (int q = threadIdx.x; q < nc; q += blockDim.x) {
    const int c0 = q * V;
    Vec<T, V> ks[S];
#pragma unroll
    for (int j = 0; j < S; ++j) ks[j] = load_chunk<T, V>(p.K + j * n + base + c0);
    const Vec<T, V> y = load_chunk<T, V>(p.y + base + c0);
    const Vec<T, V> f1 = f1_is_last ? ks[S - 1] : load_chunk<T, V>(p.f1 + base + c0);
    const Vec<T, V> k0 = p.f0 ? load_chunk<T, V>(p.f0 + base + c0) : ks[0];
    Vec<T, V> r, y1, errs;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      T acc_sol, acc_err;
      weighted_sums_n<S>(p.b_sol, p.b_err, [&](int j) { return ks[j].v[e]; }, acc_sol,
                         acc_err);
      y1.v[e] = fma_of(h, acc_sol, y.v[e]);
      const T err = h * acc_err;
      errs.v[e] = err;
      r.v[e] = wrms_scaled(err, y.v[e], y1.v[e], p.atol.at(row, c0 + e),
                           p.rtol.at(row, c0 + e));
    }
    if (p.err) store_chunk<T, V>(p.err + base + c0, errs);
    // The planes as if the row were accepted; phase 3 rewrites a rejected
    // row's y_out and f_out.
    store_chunk<T, V>(p.y1 + base + c0, y1);
    store_chunk<T, V>(p.y_out + base + c0, y1);
    store_chunk<T, V>(p.f_out + base + c0, f1);
    if (p.c1) {  // ref.hermite_coeffs, one rounding per op
      Vec<T, V> c1, c2, c3;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        c1.v[e] = mul_rn(h, k0.v[e]);
        c2.v[e] = hermite_c2(y.v[e], y1.v[e], k0.v[e], f1.v[e], h);
        c3.v[e] = hermite_c3(y.v[e], y1.v[e], k0.v[e], f1.v[e], h);
      }
      store_chunk<T, V>(p.c1 + base + c0, c1);
      store_chunk<T, V>(p.c2 + base + c0, c2);
      store_chunk<T, V>(p.c3 + base + c0, c3);
    }
    store_chunk<T, V>(r_s + c0, r);
    store_chunk<T, V>(y_s + c0, y);
    store_chunk<T, V>(k0_s + c0, k0);
  }
  row_finish<T, V>(p, row, col, smem);
}

template <typename T>
Params<T> params_of(const FusedStepArgs& a) {
  Params<T> p;
  p.y = static_cast<const T*>(a.y);
  p.K = static_cast<const T*>(a.K);
  p.f1 = static_cast<const T*>(a.f1);
  p.f0 = static_cast<const T*>(a.f0);
  p.poly = static_cast<const T*>(a.poly);
  p.t = static_cast<const T*>(a.t);
  p.t_new = static_cast<const T*>(a.t_new);
  p.dt_cur = static_cast<const T*>(a.dt_cur);
  p.safe_dt = static_cast<const T*>(a.safe_dt);
  p.prev_inv = static_cast<const T*>(a.prev_inv);
  p.prev2_inv = static_cast<const T*>(a.prev2_inv);
  p.running = static_cast<const uint8_t*>(a.running);
  p.failed = static_cast<const uint8_t*>(a.failed);
  p.atol = make_tol<T>(a.atol, a.atol_val, a.atol_rs, a.atol_cs);
  p.rtol = make_tol<T>(a.rtol, a.rtol_val, a.rtol_rs, a.rtol_cs);
  p.y1 = static_cast<T*>(a.y1);
  p.ratio = static_cast<T*>(a.ratio);
  p.y_out = static_cast<T*>(a.y_out);
  p.f_out = static_cast<T*>(a.f_out);
  p.t_out = static_cast<T*>(a.t_out);
  p.dt_out = static_cast<T*>(a.dt_out);
  p.new_inv = static_cast<T*>(a.new_inv);
  p.new_inv2 = static_cast<T*>(a.new_inv2);
  p.c1 = static_cast<T*>(a.c1);
  p.c2 = static_cast<T*>(a.c2);
  p.c3 = static_cast<T*>(a.c3);
  p.stages = static_cast<T*>(a.stages);
  p.err = static_cast<T*>(a.err);
  p.zs = static_cast<T*>(a.zs);
  p.accept = static_cast<uint8_t*>(a.accept);
  p.b = a.b;
  p.f = a.f;
  p.s = a.s;
  p.npoly = a.npoly;
  p.fsal = a.fsal;
  p.ctrl_mode = a.ctrl_mode;
  for (int k = 0; k < 8; ++k) p.ctrl[k] = a.ctrl[k];
  p.b_sol = load_coeffs<T>(a.b_sol, a.s);
  p.b_err = load_coeffs<T>(a.b_err, a.s);
  for (int r = 0; r < kMaxStages; ++r) p.a[r] = load_coeffs<T>(a.a + r * kMaxStages, r);
  return p;
}

// Whether the launch writes one of the outputs the backwards read.
inline bool saves(const FusedStepArgs& a) { return a.stages || a.err || a.zs; }

template <typename T, bool kPoly>
int launch_fused_step(const FusedStepArgs& a, cudaStream_t stream) {
  if (a.s < 1 || a.s > kMaxStages || (kPoly && a.npoly < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (a.b + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const unsigned grid = static_cast<unsigned>(blocks > 0 ? blocks : 1);
  if (saves(a)) {
    fused_step_kernel<T, kPoly, true><<<grid, 32 * kWarpsPerBlock, 0, stream>>>(params_of<T>(a));
  } else {
    fused_step_kernel<T, kPoly, false><<<grid, 32 * kWarpsPerBlock, 0, stream>>>(params_of<T>(a));
  }
  return static_cast<int>(cudaGetLastError());
}

// A row body's launch: a block per row of up to kThreads threads, `smem`
// bytes of dynamic shared memory (row_smem_bytes), V entries a thread.
template <typename T, int V, int kThreads = kRowThreads, typename Kernel>
int launch_row_kernel(Kernel kernel, const FusedStepArgs& a, size_t smem,
                      cudaStream_t stream) {
  // No static shared memory: up to the default 48 KiB needs no opt-in.
  if (smem > kDefaultSmem) {
    const cudaError_t e = reserve_smem(kernel, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // Whole warps, enough for a chunk each up to kThreads; warp 0 always.
  const int64_t warps = (a.f / V + 31) / 32;
  const unsigned threads =
      32 * static_cast<unsigned>(warps < 1 ? 1 : warps > kThreads / 32 ? kThreads / 32 : warps);
  kernel<<<static_cast<unsigned>(a.b), threads, smem, stream>>>(params_of<T>(a));
  return static_cast<int>(cudaGetLastError());
}

// The coefficient count in registers up to kPolyRegs, else from device memory.
template <typename T, int V, bool kSave>
int launch_row_coeffs(const FusedStepArgs& a, size_t smem, cudaStream_t stream) {
  switch (a.npoly) {
    case 1:
      return launch_row_kernel<T, V>(fused_step_poly_row_kernel<T, V, 1, kSave>, a, smem, stream);
    case 2:
      return launch_row_kernel<T, V>(fused_step_poly_row_kernel<T, V, 2, kSave>, a, smem, stream);
    case 3:
      return launch_row_kernel<T, V>(fused_step_poly_row_kernel<T, V, 3, kSave>, a, smem, stream);
    case 4:
      return launch_row_kernel<T, V>(fused_step_poly_row_kernel<T, V, 4, kSave>, a, smem, stream);
    default:
      return launch_row_kernel<T, V>(fused_step_poly_row_kernel<T, V, 0, kSave>, a, smem, stream);
  }
}

template <typename T, int V>
int launch_row_np(const FusedStepArgs& a, size_t smem, cudaStream_t stream) {
  return saves(a) ? launch_row_coeffs<T, V, true>(a, smem, stream)
                  : launch_row_coeffs<T, V, false>(a, smem, stream);
}

template <typename T, int V, typename Kernel>
int launch_step_row_kernel(Kernel kernel, const FusedStepArgs& a, size_t smem,
                           cudaStream_t stream) {
  return launch_row_kernel<T, V, step_row_threads<T>()>(kernel, a, smem, stream);
}

// fused_step's row body at the stage count s.
template <typename T, int V>
int launch_step_row_s(const FusedStepArgs& a, size_t smem, cudaStream_t stream) {
  static_assert(kMaxStages == 8, "launch_step_row_s instantiates counts 1..8");
  switch (a.s) {
    case 1: return launch_step_row_kernel<T, V>(fused_step_row_kernel<T, V, 1>, a, smem, stream);
    case 2: return launch_step_row_kernel<T, V>(fused_step_row_kernel<T, V, 2>, a, smem, stream);
    case 3: return launch_step_row_kernel<T, V>(fused_step_row_kernel<T, V, 3>, a, smem, stream);
    case 4: return launch_step_row_kernel<T, V>(fused_step_row_kernel<T, V, 4>, a, smem, stream);
    case 5: return launch_step_row_kernel<T, V>(fused_step_row_kernel<T, V, 5>, a, smem, stream);
    case 6: return launch_step_row_kernel<T, V>(fused_step_row_kernel<T, V, 6>, a, smem, stream);
    case 7: return launch_step_row_kernel<T, V>(fused_step_row_kernel<T, V, 7>, a, smem, stream);
    case 8: return launch_step_row_kernel<T, V>(fused_step_row_kernel<T, V, 8>, a, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_step_row(const FusedStepArgs& a, cudaStream_t stream) {
  if (a.s < 1 || a.s > kMaxStages || a.b > 0x7fffffff || a.f > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.b < 1) return static_cast<int>(cudaSuccess);  // no rows: nothing to write
  constexpr int V = 16 / sizeof(T);
  const bool vec = a.f % V == 0 && aligned16(a.y) && aligned16(a.K) && aligned16(a.f1) &&
                   aligned16(a.f0) && aligned16(a.y1) && aligned16(a.y_out) &&
                   aligned16(a.f_out) && aligned16(a.c1) && aligned16(a.c2) &&
                   aligned16(a.c3) && aligned16(a.err);
  const size_t smem = row_smem_bytes(a.f, sizeof(T));
  return vec ? launch_step_row_s<T, V>(a, smem, stream)
             : launch_step_row_s<T, 1>(a, smem, stream);
}

template <typename T>
int launch_row(const FusedStepArgs& a, cudaStream_t stream) {
  if (a.s < 1 || a.s > kMaxStages || a.npoly < 1 || a.b > 0x7fffffff || a.f > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.b < 1) return static_cast<int>(cudaSuccess);  // no rows: nothing to write
  constexpr int V = 16 / sizeof(T);
  const bool vec = a.f % V == 0 && aligned16(a.y) && aligned16(a.K) && aligned16(a.poly) &&
                   aligned16(a.y1) && aligned16(a.y_out) && aligned16(a.f_out) &&
                   aligned16(a.c1) && aligned16(a.c2) && aligned16(a.c3) && aligned16(a.err);
  const size_t smem = row_smem_bytes(a.f, sizeof(T));
  return vec ? launch_row_np<T, V>(a, smem, stream) : launch_row_np<T, 1>(a, smem, stream);
}

}  // namespace

// ------------------------------------------------------------- C entry points
// dtype: 0 = float32, 1 = float64; body: 0 = warp, 1 = row.
// Every entry returns cudaGetLastError(), or cudaErrorInvalidValue for a
// stage count outside [1, kMaxStages], no polynomial, an unknown body, or a
// row whose shared memory exceeds the device's limit
// (rt_fused_step_max_smem()).

extern "C" {

int rt_fused_step_args_size() { return static_cast<int>(sizeof(FusedStepArgs)); }

// The dynamic shared memory the row body may ask for on the current device,
// in bytes, or -1 if the device cannot be queried.  No variant has static
// shared memory, so one stands for all.
int rt_fused_step_max_smem() {
  size_t limit = 0;
  return dynamic_smem_limit(fused_step_poly_row_kernel<float, 4, 3, false>, &limit) == cudaSuccess
             ? static_cast<int>(limit)
             : -1;
}

int rt_fused_step(int dtype, int body, const FusedStepArgs* args, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (body == 1) {
    return dtype ? launch_step_row<double>(*args, s) : launch_step_row<float>(*args, s);
  }
  if (body != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dtype ? launch_fused_step<double, false>(*args, s)
               : launch_fused_step<float, false>(*args, s);
}

int rt_fused_step_poly(int dtype, int body, const FusedStepArgs* args, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (body == 1) return dtype ? launch_row<double>(*args, s) : launch_row<float>(*args, s);
  if (body != 0) return static_cast<int>(cudaErrorInvalidValue);
  return dtype ? launch_fused_step<double, true>(*args, s)
               : launch_fused_step<float, true>(*args, s);
}

}  // extern "C"
