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
// Schedule.  The TPU holds a whole row in VMEM (one pass), or for f > 128
// runs a two-phase feature-tiled grid.  Here one warp owns one row, 8 rows to
// a block, as error_norm does, and sweeps f twice:
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

template <typename T>
struct Element {
  T y, y1, err, k0, f1;
};

// y1, err, the derivative cache k0 (f0 where given, else K[0]) and
// (with_f1) f1 of element (row, c); i = row * f + c.
template <typename T, bool kPoly>
__device__ __forceinline__ Element<T> element(const Params<T>& p, int64_t i, int64_t c, T h,
                                              bool with_f1) {
  Element<T> e;
  e.y = p.y[i];
  T acc_sol, acc_err;
  if constexpr (kPoly) {
    // The stage recursion of rk_step: stage_accum's sum, then poly_eval.
    T ks[kMaxStages];
    ks[0] = p.K[i];  // f0
    T last = ks[0];
#pragma unroll
    for (int st = 1; st < kMaxStages; ++st) {
      if (st < p.s) {
        const T acc = weighted_sum(p.a[st], st, [&](int j) { return ks[j]; });
        ks[st] = poly_at(p, c, fma_of(h, acc, e.y));
        last = ks[st];
      }
    }
    weighted_sums(p.b_sol, p.b_err, p.s, [&](int j) { return ks[j]; }, acc_sol, acc_err);
    e.k0 = ks[0];
    e.y1 = fma_of(h, acc_sol, e.y);
    if (with_f1) e.f1 = p.fsal ? last : poly_at(p, c, e.y1);
  } else {
    const int64_t n = p.b * p.f;
    weighted_sums(p.b_sol, p.b_err, p.s, [&](int j) { return p.K[j * n + i]; }, acc_sol,
                  acc_err);
    e.k0 = p.f0 ? p.f0[i] : p.K[i];
    e.y1 = fma_of(h, acc_sol, e.y);
    if (with_f1) e.f1 = p.f1[i];
  }
  e.err = h * acc_err;
  return e;
}

// __grid_constant__: the helpers take p by reference straight from the
// parameter space, with no per-thread copy of the ~1 KB struct.
template <typename T, bool kPoly>
__global__ void fused_step_kernel(const __grid_constant__ Params<T> p) {
  const int lane = threadIdx.x & 31;
  const int64_t row = blockIdx.x * (int64_t)kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= p.b) return;  // the whole warp leaves together
  const int64_t base = row * p.f;
  const T h = p.safe_dt[row];

  // Sweep 1: error_norm's sum of squares over the row.
  T sum = T(0);
  for (int64_t c = lane; c < p.f; c += 32) {
    const Element<T> e = element<T, kPoly>(p, base + c, c, h, false);
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
    const Element<T> e = element<T, kPoly>(p, i, c, h, true);
    p.y1[i] = e.y1;
    p.y_out[i] = accept ? e.y1 : e.y;
    p.f_out[i] = accept ? e.f1 : e.k0;
    if (p.c1) {  // ref.hermite_coeffs, one rounding per op
      p.c1[i] = mul_rn(h, e.k0);
      p.c2[i] = sub_rn(mul_rn(T(3), sub_rn(e.y1, e.y)),
                       mul_rn(h, add_rn(mul_rn(T(2), e.k0), e.f1)));
      p.c3[i] = add_rn(mul_rn(T(2), sub_rn(e.y, e.y1)), mul_rn(h, add_rn(e.k0, e.f1)));
    }
  }
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

template <typename T, bool kPoly>
int launch_fused_step(const FusedStepArgs& a, cudaStream_t stream) {
  if (a.s < 1 || a.s > kMaxStages || (kPoly && a.npoly < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (a.b + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_step_kernel<T, kPoly><<<static_cast<unsigned>(blocks > 0 ? blocks : 1),
                                32 * kWarpsPerBlock, 0, stream>>>(params_of<T>(a));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ------------------------------------------------------------- C entry points
// dtype: 0 = float32, 1 = float64.  Every entry returns cudaGetLastError().

extern "C" {

int rt_fused_step_args_size() { return static_cast<int>(sizeof(FusedStepArgs)); }

int rt_fused_step(int dtype, const FusedStepArgs* args, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_fused_step<double, false>(*args, s)
               : launch_fused_step<float, false>(*args, s);
}

int rt_fused_step_poly(int dtype, const FusedStepArgs* args, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_fused_step<double, true>(*args, s)
               : launch_fused_step<float, true>(*args, s);
}

}  // extern "C"
