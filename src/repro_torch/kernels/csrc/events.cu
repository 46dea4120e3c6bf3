// Hand-written Hopper (sm_90a) kernels for the event layer (core/events.py).
//
// masked_bisect_refine replaces pallas_impl.masked_bisect_refine (:284, body
// _bisect_refine_kernel :258); fused_event_detect replaces
// pallas_impl.fused_event_detect (:1144, body _event_detect_kernel :1123);
// fused_event_commit replaces pallas_impl.fused_event_commit (:1205, body
// _event_commit_kernel :1169).  Each computes exactly the plain PyTorch
// version of the same name in ../ref.py: all three are elementwise ATen ops
// and selections there, so every rounded operation here is the one ATen
// rounds (mul_rn/add_rn, no contraction) and the outputs equal the plain
// version's bitwise on the card.
//
// Bound: the bytes, for all three.  masked_bisect_refine reads the four (b, f)
// coefficient planes and writes y_mid (5 planes, 6 flops an element: at
// full_width's b = 1024, f = 784 in float32, 16 MB, 0.0048 ms at 3.35
// TB/s); fused_event_detect moves a few (b, E) columns; fused_event_commit
// reads y_new and writes y_stop (2 planes), and reads y_ev and writes ev_y
// only in the cells of the crossings it records.
//
// masked_bisect_refine's first design (one thread per entry) spent its time
// around the bytes: a 64-bit division per entry for its row, the row's four
// (b,) inputs reloaded and its bracket recomputed per entry, and 4-byte
// loads.  fused_event_commit's (a warp per row) kept one 4-byte load of a
// lane in flight at a time.  Both are laid out by row now (below): a thread
// per 16-byte chunk, the row's bracket or header once per thread, 16-byte
// loads and stores.  fused_event_detect is laid out by row too, a segment of
// threads per row, with its directions as two 64-bit masks.
//
// The TPU kernels carry bool outputs as int32 (a TPU layout matter); here
// masks are bytes (torch.bool) both ways and n_new is int32.
//
// The event count E is at most kMaxEvents (64): the per-event directions ride
// in the parameter space as two 64-bit masks, the terminal flags as one, and
// a row's recorded crossings are one 64-bit mask in registers.  The wrappers
// raise above it.

#include "solver_common.cuh"

namespace {

using namespace solver;

constexpr int kMaxEvents = 64;
constexpr int kThreads = 256;

unsigned long long terminal_mask(const int8_t* host, int n) {
  unsigned long long mask = 0;
  for (int i = 0; i < n && i < kMaxEvents; ++i) {
    if (host[i]) mask |= 1ull << i;
  }
  return mask;
}

unsigned blocks_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  // Grid-stride loops cover whatever one launch's grid does not.
  return static_cast<unsigned>(blocks < 65535 * 8 ? (blocks > 0 ? blocks : 1) : 65535 * 8);
}

template <typename T>
__device__ __forceinline__ int sign_int(T x) {  // torch.sign, but as an int
  return (T(0) < x) - (x < T(0));
}

// sign(a) != sign(b) as the JAX package decides it: jnp.sign(NaN) is NaN and
// compares unequal to everything, so a NaN on either side picks the left half.
template <typename T>
__device__ __forceinline__ bool sign_differs(T a, T b) {
  return isnan(a) || isnan(b) || sign_int(a) != sign_int(b);
}

// ------------------------------------------------------ masked_bisect_refine
// Rows by 2-D grid, a thread per 16-byte chunk of a row.  A row's segment of
// 2^lanes_log2 threads (lanes_log2 <= 5: up to a warp, fewer for narrow
// rows, so a block holds 256 >> lanes_log2 rows) spans gridDim.x segments;
// each thread computes its row's bracket once, from the four (b,) inputs
// (loads its segment shares), and evaluates the interpolant at the new
// midpoint on one chunk of V entries: c0..c3 read and y_mid written 16 bytes
// at a time.  Where the five (b, f) planes start 16-byte aligned, a row's
// first entries up to a 16-byte boundary (f not a multiple of V) and its
// entries after the last whole chunk go scalar, by the row's first thread;
// otherwise V = 1 and every entry is a chunk.  No division: V is a power of
// two and the grid is laid out by row.  The row's
// first thread writes its four (b,) outputs, once.  y_mid is evaluated for
// every row, active or not, as the plain version does.  The TPU kernel tiles
// (BB, BF) blocks and rewrites the (BB, 1) columns once per feature tile.
template <typename T>
__device__ __forceinline__ void bisect_entry(const T* __restrict__ c0, const T* __restrict__ c1,
                                             const T* __restrict__ c2, const T* __restrict__ c3,
                                             T* __restrict__ y_mid, int64_t i, T m) {
  y_mid[i] = horner_rn(c0[i], c1[i], c2[i], c3[i], m);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) masked_bisect_refine_kernel(
    const T* __restrict__ c0, const T* __restrict__ c1, const T* __restrict__ c2,
    const T* __restrict__ c3, const T* __restrict__ lo, const T* __restrict__ hi,
    const T* __restrict__ v_lo, const T* __restrict__ v_mid,
    const uint8_t* __restrict__ active, T* __restrict__ lo_out, T* __restrict__ hi_out,
    T* __restrict__ vlo_out, T* __restrict__ mid_out, T* __restrict__ y_mid, int b, int f,
    int lanes_log2) {
  const int lane = threadIdx.x & ((1 << lanes_log2) - 1);
  const int rows = kThreads >> lanes_log2;
  const int q = (blockIdx.x << lanes_log2) | lane;  // this thread's chunk of its rows
  const bool first = blockIdx.x == 0 && lane == 0;
  for (int row = blockIdx.y * rows + (threadIdx.x >> lanes_log2); row < b;
       row += gridDim.y * rows) {
    const T l = lo[row], h = hi[row], vl = v_lo[row], vm = v_mid[row];
    const bool act = active[row] != 0;
    const T mid = mul_rn(T(0.5), add_rn(l, h));
    const bool left = sign_differs(vl, vm);
    const T h_new = (act && left) ? mid : h;
    const T l_new = (act && !left) ? mid : l;
    const T m_new = mul_rn(T(0.5), add_rn(l_new, h_new));
    if (first) {
      lo_out[row] = l_new;
      hi_out[row] = h_new;
      vlo_out[row] = (act && !left) ? vm : vl;
      mid_out[row] = m_new;
    }
    const int64_t base = static_cast<int64_t>(row) * f;
    const int head =
        V == 1 ? 0 : min(f, (V - static_cast<int>(base & (V - 1))) & (V - 1));
    const int nc = (f - head) / V;
    if (q < nc) {
      const int64_t i = base + head + static_cast<int64_t>(q) * V;
      if constexpr (V == 1) {
        bisect_entry(c0, c1, c2, c3, y_mid, i, m_new);
      } else {
        union Vec {
          uint4 raw;
          T v[V];
        } a0, a1, a2, a3, y;
        a0.raw = __ldg(reinterpret_cast<const uint4*>(c0 + i));
        a1.raw = __ldg(reinterpret_cast<const uint4*>(c1 + i));
        a2.raw = __ldg(reinterpret_cast<const uint4*>(c2 + i));
        a3.raw = __ldg(reinterpret_cast<const uint4*>(c3 + i));
#pragma unroll
        for (int e = 0; e < V; ++e) y.v[e] = horner_rn(a0.v[e], a1.v[e], a2.v[e], a3.v[e], m_new);
        *reinterpret_cast<uint4*>(y_mid + i) = y.raw;
      }
    }
    if (V > 1 && first) {
      for (int e = 0; e < head; ++e) bisect_entry(c0, c1, c2, c3, y_mid, base + e, m_new);
      for (int e = head + nc * V; e < f; ++e) bisect_entry(c0, c1, c2, c3, y_mid, base + e, m_new);
    }
  }
}

// -------------------------------------------------------- fused_event_detect
// Rows by block, as in masked_bisect_refine: a row's segment of
// 2^lanes_log2 threads (the fewest that hold E events, up to a warp; 256 >>
// lanes_log2 rows to a block).  A thread loads accept[row] once and takes
// its row's events e = lane and lane + 2^lanes_log2 (E <= 64: at most two),
// every load issued before the first test.  The directions come as two
// 64-bit masks built on the host (cuda_impl.direction_masks): bit e of
// up_only set where direction e > 0, of down_only where it is < 0, neither
// for either way.  The first design (a thread per (row, event)) took the
// directions as an int8[64] parameter indexed at run time, which gave every
// thread a 64-byte stack frame, divided a 64-bit index by E for the row and
// reloaded accept[row] per event: 0.0072 ms at b = 1024, E = 2 on an NVIDIA
// H100 80GB HBM3 (700 W), 0.0099 at E = 64.  This one has no stack frame
// (ptxas) and takes 0.0058 and 0.0065 ms, within 0.0012 ms of the 0.0053 ms
// launch floor (PERF.md).  Expressions and their order are
// ref.fused_event_detect's; it moves a few (b, E) columns, so its cost is
// the launch.
template <typename T>
__global__ void __launch_bounds__(kThreads) fused_event_detect_kernel(
    const T* __restrict__ v_prev, const T* __restrict__ v_new,
    const uint8_t* __restrict__ fired, const uint8_t* __restrict__ accept,
    unsigned long long up_only, unsigned long long down_only, uint8_t* __restrict__ newly,
    T* __restrict__ v_keep, int b, int E, int lanes_log2) {
  const int lane = threadIdx.x & ((1 << lanes_log2) - 1);
  const int rows = kThreads >> lanes_log2;
  for (int row = blockIdx.x * rows + (threadIdx.x >> lanes_log2); row < b;
       row += gridDim.x * rows) {
    const int64_t rb = static_cast<int64_t>(row) * E;
    const bool acc = accept[row] != 0;
    T v0[2], v1[2];
    uint8_t fd[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int e = lane + (k << lanes_log2);
      if (e < E) {
        v0[k] = v_prev[rb + e];
        v1[k] = v_new[rb + e];
        fd[k] = fired[rb + e];
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int e = lane + (k << lanes_log2);
      if (e >= E) continue;
      const bool up = (v0[k] <= T(0)) && (v1[k] >= T(0));
      const bool down = (v0[k] >= T(0)) && (v1[k] <= T(0));
      bool crossed = ((up_only >> e) & 1ull) ? up : (((down_only >> e) & 1ull) ? down
                                                                                : (up || down));
      crossed = crossed && ((v0[k] != T(0)) || (v1[k] != T(0)));
      newly[rb + e] = crossed && !fd[k] && acc;
      v_keep[rb + e] = acc ? v1[k] : v0[k];
    }
  }
}

// -------------------------------------------------------- fused_event_commit
// Rows by 2-D grid, a thread per 16-byte chunk of a row, as in
// masked_bisect_refine: a row's segment of 2^lanes_log2 threads (up to a
// warp; 256 >> lanes_log2 rows to a block) spans gridDim.x segments.  Every
// thread resolves its row's header once: the terminal events in order
// (strict <, so the first of two equal crossings wins, as the plain
// version's sequence of wheres does), then the recorded-crossing mask rec =
// newly & (x <= x_stop) over the crossings detected.  It copies one chunk of
// V entries of y_stop from its source row (y_new, or the stopping crossing's
// y_ev row) and the same chunk of each recorded ev_y cell from y_ev, in
// place; ev_y cells of crossings not recorded are neither read nor written.
// The row's first thread writes its (b, E) and (b,) outputs.  V = 16 /
// sizeof(T) where y_new, y_ev, ev_y and y_stop start 16-byte aligned and a
// row is a whole number of 16-byte words, else 1 (entry by entry).
//
// Bound: the bytes this step's data needs (2 (b, f) planes, 2 f per
// recorded cell, the columns): at full_width (b = 1024, f = 784, E = 2,
// event_checks' mixed rows, float32) 12 MB, 0.0036 ms at 3.35 TB/s.  The
// first design (a warp per row, 8 rows a block, 4-byte copies with the
// recorded cells' loop inside the column loop) kept one load of a lane in
// flight: some 25 dependent round trips per row, 0.034 ms.  Here a thread's
// loads come in two rounds: first everything that does not depend on the
// header -- the row's first kHeadEvents columns of newly and x (and of fired
// and ev_t, t0 and dt for the row's first thread) and the y_new chunk, read
// whether or not the row stops -- then, where the row recorded a crossing,
// the y_ev chunks of the recorded cells (kCellBatch at a time) and of the
// stopping one; every load of a round is issued before its stores.
//
// Two events' columns in the first round and two cells a batch cover the
// usual E = 1-2 in two rounds at 48-77 registers a thread (ptxas); wider
// batches (4 and 4: 64-98 registers, fewer blocks an SM) measured slower at
// full_width, and a cap of 64 registers slower still.  The terminal flags
// come as a 64-bit mask: a by-value array parameter indexed at run time is
// copied to each thread's stack (64 bytes).  On an H100 (700 W) the kernel
// takes 0.0109 ms at full_width float32: 0.0056 ms above the launch floor
// (0.0053 ms), the bytes at ~2.1 TB/s where the timing rule's L2 flush
// leaves dirty lines to write back first, as for masked_bisect_refine
// (PERF.md).
constexpr int kHeadEvents = 2;
constexpr int kCellBatch = 2;

template <typename T, int V>
struct Chunk16 {
  T v[V];
};

// The loads of the copies are volatile: a load of round one stays in round
// one, where the compiler could otherwise sink the speculative y_new load
// below the header that may discard it.
__device__ __forceinline__ float load_nc(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ double load_nc(const double* p) {
  double v;
  asm volatile("ld.global.nc.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}

template <typename T, int V>
__device__ __forceinline__ Chunk16<T, V> load16(const T* p) {
  if constexpr (V == 1) {
    return Chunk16<T, V>{{load_nc(p)}};
  } else {
    union {
      uint4 raw;
      Chunk16<T, V> c;
    } u;
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(u.raw.x), "=r"(u.raw.y), "=r"(u.raw.z), "=r"(u.raw.w)
                 : "l"(p));
    return u.c;
  }
}

template <typename T, int V>
__device__ __forceinline__ void store16(T* p, const Chunk16<T, V>& c) {
  if constexpr (V == 1) {
    *p = c.v[0];
  } else {
    union {
      uint4 raw;
      Chunk16<T, V> c;
    } u;
    u.c = c;
    *reinterpret_cast<uint4*>(p) = u.raw;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) fused_event_commit_kernel(
    const T* __restrict__ x, const T* __restrict__ y_ev, const uint8_t* __restrict__ newly,
    const T* __restrict__ y_new, const T* __restrict__ t0, const T* __restrict__ dt,
    const uint8_t* __restrict__ fired, const T* __restrict__ ev_t, T* __restrict__ ev_y,
    unsigned long long terminal, uint8_t* __restrict__ fired_out, T* __restrict__ ev_t_out,
    uint8_t* __restrict__ stop_out, T* __restrict__ t_stop, T* __restrict__ y_stop,
    int32_t* __restrict__ n_new, int b, int E, int f, int lanes_log2) {
  const int lane = threadIdx.x & ((1 << lanes_log2) - 1);
  const int rows = kThreads >> lanes_log2;
  const int q = (blockIdx.x << lanes_log2) | lane;  // this thread's chunk of its rows
  const bool first = blockIdx.x == 0 && lane == 0;
  const int nc = f / V;
  const int64_t o = static_cast<int64_t>(q) * V;
  for (int row = blockIdx.y * rows + (threadIdx.x >> lanes_log2); row < b;
       row += gridDim.y * rows) {
    const int64_t eb = static_cast<int64_t>(row) * E, rb = static_cast<int64_t>(row) * f;
    // Round one: nothing here depends on the header.
    Chunk16<T, V> s;
    if (q < nc) s = load16<T, V>(y_new + rb + o);
    T t0r = T(0), dtr = T(0);
    if (first) {
      t0r = t0[row];
      dtr = dt[row];
    }
    bool nh[kHeadEvents];
    T xh[kHeadEvents], th[kHeadEvents];
    uint8_t fh[kHeadEvents];
#pragma unroll
    for (int k = 0; k < kHeadEvents; ++k) {
      nh[k] = k < E && newly[eb + k] != 0;
      if (k < E) xh[k] = x[eb + k];
      if (first && k < E) {
        fh[k] = fired[eb + k];
        th[k] = ev_t[eb + k];
      }
    }
    // The header: the crossings detected, the earliest terminal one, rec.
    T x_stop = T(INFINITY);
    int i_stop = -1;
    unsigned long long detected = 0;
#pragma unroll
    for (int k = 0; k < kHeadEvents; ++k) {
      if (!nh[k]) continue;
      detected |= 1ull << k;
      if (((terminal >> k) & 1ull) && xh[k] < x_stop) {
        x_stop = xh[k];
        i_stop = k;
      }
    }
    for (int i = kHeadEvents; i < E; ++i) {
      if (!newly[eb + i]) continue;
      detected |= 1ull << i;
      const T xi = x[eb + i];
      if (((terminal >> i) & 1ull) && xi < x_stop) {
        x_stop = xi;
        i_stop = i;
      }
    }
    const bool stop = (detected & terminal) != 0;
    unsigned long long rec = 0;
#pragma unroll
    for (int k = 0; k < kHeadEvents; ++k) {
      if (nh[k] && xh[k] <= x_stop) rec |= 1ull << k;
    }
    for (unsigned long long m = detected >> kHeadEvents; m; m &= m - 1) {
      const int i = kHeadEvents + __ffsll(static_cast<long long>(m)) - 1;
      if (x[eb + i] <= x_stop) rec |= 1ull << i;
    }
    // Round two: the stopping row's source and the first recorded cells.
    unsigned long long m = q < nc ? rec : 0ull;
    int64_t at[kCellBatch];
    Chunk16<T, V> c[kCellBatch];
    const auto load_cells = [&]() {
#pragma unroll
      for (int k = 0; k < kCellBatch; ++k) {
        at[k] = -1;
        if (m) {
          at[k] = (eb + __ffsll(static_cast<long long>(m)) - 1) * f + o;
          m &= m - 1;
          c[k] = load16<T, V>(y_ev + at[k]);
        }
      }
    };
    const auto store_cells = [&]() {
#pragma unroll
      for (int k = 0; k < kCellBatch; ++k) {
        if (at[k] >= 0) store16<T, V>(ev_y + at[k], c[k]);
      }
    };
    if (q < nc && i_stop >= 0) s = load16<T, V>(y_ev + (eb + i_stop) * f + o);
    load_cells();
    if (first) {
#pragma unroll
      for (int k = 0; k < kHeadEvents; ++k) {
        if (k < E) {
          const bool rk = (rec >> k) & 1ull;
          fired_out[eb + k] = fh[k] || rk;
          ev_t_out[eb + k] = rk ? add_rn(t0r, mul_rn(xh[k], dtr)) : th[k];
        }
      }
      for (int i = kHeadEvents; i < E; ++i) {
        const bool ri = (rec >> i) & 1ull;
        fired_out[eb + i] = fired[eb + i] || ri;
        ev_t_out[eb + i] = ri ? add_rn(t0r, mul_rn(x[eb + i], dtr)) : ev_t[eb + i];
      }
      stop_out[row] = stop;
      t_stop[row] = add_rn(t0r, mul_rn(stop ? x_stop : T(0), dtr));
      n_new[row] = __popcll(rec);
    }
    if (q >= nc) continue;
    store16<T, V>(y_stop + rb + o, s);
    store_cells();
    while (m) {  // more than kCellBatch recorded cells
      load_cells();
      store_cells();
    }
  }
}

template <typename T>
int launch_bisect(const void* c0, const void* c1, const void* c2, const void* c3,
                  const void* lo, const void* hi, const void* v_lo, const void* v_mid,
                  const void* active, void* lo_out, void* hi_out, void* vlo_out,
                  void* mid_out, void* y_mid, int64_t b, int64_t f, cudaStream_t stream) {
  if (b < 1 || f < 1 || b > 0x7fffffff || f > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int V = 16 / sizeof(T);
  // 16-byte chunks where the five (b, f) planes start 16-byte aligned, else
  // entry by entry.
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = aligned(c0) && aligned(c1) && aligned(c2) && aligned(c3) && aligned(y_mid);
  const int64_t chunks = f / (vec ? V : 1) > 0 ? f / (vec ? V : 1) : 1;
  int lanes_log2 = 0;
  while ((int64_t{1} << lanes_log2) < chunks && lanes_log2 < 5) ++lanes_log2;
  const int64_t rows = kThreads >> lanes_log2;
  const int64_t gy = (b + rows - 1) / rows;
  const dim3 grid(static_cast<unsigned>((chunks + (1 << lanes_log2) - 1) >> lanes_log2),
                  static_cast<unsigned>(gy < 65535 ? gy : 65535));
  auto kernel = vec ? &masked_bisect_refine_kernel<T, V> : &masked_bisect_refine_kernel<T, 1>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(c0), static_cast<const T*>(c1), static_cast<const T*>(c2),
      static_cast<const T*>(c3), static_cast<const T*>(lo), static_cast<const T*>(hi),
      static_cast<const T*>(v_lo), static_cast<const T*>(v_mid),
      static_cast<const uint8_t*>(active), static_cast<T*>(lo_out), static_cast<T*>(hi_out),
      static_cast<T*>(vlo_out), static_cast<T*>(mid_out), static_cast<T*>(y_mid),
      static_cast<int>(b), static_cast<int>(f), lanes_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_detect(const void* v_prev, const void* v_new, const void* fired,
                  const void* accept, unsigned long long up_only,
                  unsigned long long down_only, int E, void* newly, void* v_keep, int64_t b,
                  cudaStream_t stream) {
  if (b > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (b < 1) return static_cast<int>(cudaSuccess);  // no rows: nothing to write
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < E && lanes_log2 < 5) ++lanes_log2;
  const unsigned blocks = blocks_for(b, kThreads >> lanes_log2);
  fused_event_detect_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(v_prev), static_cast<const T*>(v_new),
      static_cast<const uint8_t*>(fired), static_cast<const uint8_t*>(accept), up_only,
      down_only, static_cast<uint8_t*>(newly), static_cast<T*>(v_keep), static_cast<int>(b), E,
      lanes_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_commit(const void* x, const void* y_ev, const void* newly, const void* y_new,
                  const void* t0, const void* dt, const void* fired, const void* ev_t,
                  void* ev_y, const int8_t* terminal, int E, void* fired_out, void* ev_t_out,
                  void* stop, void* t_stop, void* y_stop, void* n_new, int64_t b, int64_t f,
                  cudaStream_t stream) {
  if (b > 0x7fffffff || f > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (b < 1) return static_cast<int>(cudaSuccess);  // no rows: nothing to write
  constexpr int V = 16 / sizeof(T);
  // 16-byte chunks where the four (b, f) / (b, E, f) planes start 16-byte
  // aligned and a row fills whole 16-byte words, else entry by entry.
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool vec = f % V == 0 && aligned(y_ev) && aligned(y_new) && aligned(ev_y) &&
                   aligned(y_stop);
  const int64_t chunks = f / (vec ? V : 1);
  int lanes_log2 = 0;
  while ((int64_t{1} << lanes_log2) < chunks && lanes_log2 < 5) ++lanes_log2;
  const int64_t rows = kThreads >> lanes_log2;
  const int64_t gy = (b + rows - 1) / rows;
  const int64_t gx = (chunks + (1 << lanes_log2) - 1) >> lanes_log2;  // f = 0: the header alone
  const dim3 grid(static_cast<unsigned>(gx > 0 ? gx : 1),
                  static_cast<unsigned>(gy < 65535 ? gy : 65535));
  auto kernel = vec ? &fused_event_commit_kernel<T, V> : &fused_event_commit_kernel<T, 1>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y_ev),
      static_cast<const uint8_t*>(newly), static_cast<const T*>(y_new),
      static_cast<const T*>(t0), static_cast<const T*>(dt),
      static_cast<const uint8_t*>(fired), static_cast<const T*>(ev_t),
      static_cast<T*>(ev_y), terminal_mask(terminal, E), static_cast<uint8_t*>(fired_out),
      static_cast<T*>(ev_t_out), static_cast<uint8_t*>(stop), static_cast<T*>(t_stop),
      static_cast<T*>(y_stop), static_cast<int32_t*>(n_new), static_cast<int>(b), E,
      static_cast<int>(f), lanes_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ------------------------------------------------------------- C entry points
// dtype: 0 = float32, 1 = float64.  Every entry returns cudaGetLastError(),
// or cudaErrorInvalidValue for an event count outside [1, kMaxEvents].

extern "C" {

int rt_max_events() { return kMaxEvents; }

int rt_masked_bisect_refine(int dtype, const void* c0, const void* c1, const void* c2,
                            const void* c3, const void* lo, const void* hi, const void* v_lo,
                            const void* v_mid, const void* active, void* lo_out, void* hi_out,
                            void* vlo_out, void* mid_out, void* y_mid, int64_t b, int64_t f,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_bisect<double>(c0, c1, c2, c3, lo, hi, v_lo, v_mid, active, lo_out,
                                       hi_out, vlo_out, mid_out, y_mid, b, f, s)
               : launch_bisect<float>(c0, c1, c2, c3, lo, hi, v_lo, v_mid, active, lo_out,
                                      hi_out, vlo_out, mid_out, y_mid, b, f, s);
}

int rt_fused_event_detect(int dtype, const void* v_prev, const void* v_new, const void* fired,
                          const void* accept, unsigned long long up_only,
                          unsigned long long down_only, int E, void* newly, void* v_keep,
                          int64_t b, void* stream) {
  if (E < 1 || E > kMaxEvents) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_detect<double>(v_prev, v_new, fired, accept, up_only, down_only, E,
                                       newly, v_keep, b, s)
               : launch_detect<float>(v_prev, v_new, fired, accept, up_only, down_only, E,
                                      newly, v_keep, b, s);
}

int rt_fused_event_commit(int dtype, const void* x, const void* y_ev, const void* newly,
                          const void* y_new, const void* t0, const void* dt, const void* fired,
                          const void* ev_t, void* ev_y, const int8_t* terminal, int E,
                          void* fired_out, void* ev_t_out, void* stop, void* t_stop,
                          void* y_stop, void* n_new, int64_t b, int64_t f, void* stream) {
  if (E < 1 || E > kMaxEvents) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? launch_commit<double>(x, y_ev, newly, y_new, t0, dt, fired, ev_t, ev_y,
                                       terminal, E, fired_out, ev_t_out, stop, t_stop, y_stop,
                                       n_new, b, f, s)
               : launch_commit<float>(x, y_ev, newly, y_new, t0, dt, fired, ev_t, ev_y,
                                      terminal, E, fired_out, ev_t_out, stop, t_stop, y_stop,
                                      n_new, b, f, s);
}

}  // extern "C"
