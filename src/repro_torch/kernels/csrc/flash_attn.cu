// Hand-written Hopper (sm_90a) kernel for the attention forward of the LM
// serving path (models/attention.flash_attention, one launch per layer per
// prefill).
//
// Replaces the Pallas TPU kernel flash_attention_fwd of the JAX package
// (src/repro/kernels/flash_attn.py:83, pallas_call :132, body _kernel :39)
// and computes the plain PyTorch version of the same name in ../ref.py, to
// rounding: GQA attention, query head h on KV head h / (H / KV), scores
// scaled by 1/sqrt(hd), keys at or past sk and (causal) keys after the
// query's position q_offset + i masked at -1e30, the online softmax with
// float32 (m, l) and accumulator, the output acc / max(l, 1e-30) in q's
// dtype (float32 or bfloat16).
//
// The TPU kernel walks a static list of (q-block, kv-block) pairs on one
// core and carries (m, l, acc) across a q-block's pairs in its output
// blocks.  Here one thread block owns one (64-query tile, head, batch row)
// and loops over its key tiles itself, so the state never leaves the
// block: (m, l) and the 64 x hd accumulator live in registers, the query
// tile (scaled on load) and one 64-key tile of K and of V are staged in
// shared memory as float32, the tile's probabilities P go through shared
// memory between the two products.  Key tiles wholly above the causal
// diagonal are never loaded.  Ragged lengths and q_offset need no padding
// by the caller: rows and keys past the ends are bounds-masked (zero-filled
// in shared memory, never written).  The config's q_chunk/kv_chunk drive
// only the plain version; these tiles are the kernel's own.
//
// Two bodies share that schedule:
//
// - float32 (and bfloat16 with hd > 128): both products in float32 FFMA
//   (TF32 tensor cores would miss the reference's 2e-5), exp by expf.  256
//   threads; each computes a 4 x 4 block of the score tile (rows rg + 16 i,
//   keys cg + 16 j, strided so a warp's float4 reads of K fall in distinct
//   banks) and the same 4 rows of the accumulator over hd / 16 columns; the
//   row max and sum of a tile are reduced over the 16 lanes that share the
//   rows.  Q, K and V are staged as float32.
// - bfloat16 with hd <= 128: both products on the tensor cores, mma.sync
//   m16n8k16 bf16 into float32, operands from shared memory by ldmatrix (V
//   transposed on the way).  128 threads, one warp per 16 query rows; a
//   thread keeps its rows' Q fragments, two rows of (m, l), its 16 x 64
//   score fragment and its 16 x hd accumulator fragment in registers.  The
//   scores are scaled in float32 after the product (the reference scales q
//   first: the same value to rounding), and P is rounded to bf16 for the
//   second product (the accumulator and l stay float32).
//
// The head dim is padded in shared memory to D = 64, 128, 192 or 256 (hd
// any multiple of 8 up to 256), with zeros.
//
// Bound, at qwen2.5-14b's layer (b = 4, sq = sk = 2048, H = 40, KV = 8,
// hd = 128, bf16, causal): 4 b H hd (sq (sq + 1) / 2) = 1.7e11 flops, or
// 0.17 ms on the bf16 tensor cores (989 TFLOP/s), against 0.10 GB of q, k,
// v and o (0.03 ms at 3.35 TB/s): operations.  mma.sync reaches about two
// thirds of that peak at best; wgmma, TMA-fed and pipelined tiles are later
// work.  In float32 the bound is the FFMA pipes' 67 TFLOP/s (2.6 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile (kBQ == kBK: one padding loop)
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load8(const float* __restrict__ p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Rows [row0, row0 + 64) of one head of a (.., n, heads, hd) tensor (`base`
// points at row 0 of the head, rows `stride` elements apart), times `scale`,
// into the float32 tile s[64][ld]; rows at or past n are zeros.  Threads
// take consecutive 8-element chunks of a row: coalesced 16- or 32-byte loads.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ base, int64_t stride,
                                          int64_t row0, int64_t n, int hd, float scale,
                                          float* s, int ld) {
  const int chunks = hd >> 3;
  for (int c = threadIdx.x; c < kBQ * chunks; c += kThreads) {
    const int r = c / chunks, col = (c - r * chunks) << 3;
    float v[8];
    if (row0 + r < n) {
      load8(base + (row0 + r) * stride + col, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    float* dst = s + r * ld + col;
    store4(dst, make_float4(v[0], v[1], v[2], v[3]));
    store4(dst + 4, make_float4(v[4], v[5], v[6], v[7]));
  }
}

// Component i of v (i a compile-time constant after unrolling).
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Reductions over the 16 lanes that share a row group (xor butterflies:
// every lane ends with the same bits).
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (D + 4) + (size_t)kBQ * (kBK + 4));
}

// The FFMA body.  One block per (64-query tile, head, batch row); D is hd
// padded to a multiple of 64.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int64_t sq, int64_t sk, int H, int KV, int hd, int causal,
                 int64_t q_offset, float scale) {
  constexpr int LD = D + 4;      // float row stride of the Q, K, V tiles
  constexpr int LDP = kBK + 4;   // of the probability tile
  constexpr int NC = D / 64;     // float4 accumulator columns per thread and row
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * LD;

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int64_t q0 = (int64_t)blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int kvh = h / (H / KV);
  const T* qb = q + (bi * sq * H + h) * hd;
  const T* kb = k + (bi * sk * KV + kvh) * hd;
  const T* vb = v + (bi * sk * KV + kvh) * hd;

  // The padded columns [hd, D) stay zero for the whole block.
  const int pad = D - hd;
  for (int i = tid; i < kBQ * pad; i += kThreads) {
    const int r = i / pad, c = hd + (i - r * pad);
    sQ[r * LD + c] = 0.f;
    sK[r * LD + c] = 0.f;
    sV[r * LD + c] = 0.f;
  }
  load_tile(qb, (int64_t)H * hd, q0, sq, hd, scale, sQ, LD);

  // Keys this tile can see: all of them, or (causal) up to its last row's
  // position; tiles past that are skipped.
  const int64_t q_last = (q0 + kBQ < sq ? q0 + kBQ : sq) - 1;
  const int64_t n_keys = causal ? (q_offset + q_last + 1 < sk ? q_offset + q_last + 1 : sk) : sk;

  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int64_t k0 = 0; k0 < n_keys; k0 += kBK) {
    __syncthreads();  // the previous tile's products are done with sK, sV, sP
    load_tile(kb, (int64_t)KV * hd, k0, sk, hd, 1.f, sK, LD);
    load_tile(vb, (int64_t)KV * hd, k0, sk, hd, 1.f, sV, LD);
    __syncthreads();

    // S = (scale Q) K^T on this thread's 4 x 4 block.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(sQ + (rg + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(sK + (cg + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // Mask, then the online-softmax update of each row, as the reference:
    // m' = max(m, max_j s), p = exp(s - m'), l' = l exp(m - m') + sum_j p,
    // acc' = acc exp(m - m') + P V.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t q_pos = q_offset + q0 + rg + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t k_pos = k0 + cg + 16 * j;
        if (k_pos >= sk || (causal && k_pos > q_pos)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(rg + 16 * i) * LDP + cg + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
    }
    __syncthreads();

    // acc += P V on this thread's 4 rows and columns 4 (cg + 16 c) + e.
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p4[i] = *reinterpret_cast<const float4*>(sP + (rg + 16 * i) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float4 vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          vv[c] = *reinterpret_cast<const float4*>(sV + (j + jj) * LD + 4 * (cg + 16 * c));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = comp(p4[i], jj);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc[i][c][0] = fmaf(p, vv[c].x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p, vv[c].y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p, vv[c].z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p, vv[c].w, acc[i][c][3]);
          }
        }
      }
    }
  }

  // o = acc / max(l, 1e-30), rows and columns inside the tensor only.
  T* ob = o + (bi * sq * H + h) * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + rg + 16 * i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = 4 * (cg + 16 * c);
      if (col >= hd) continue;
      store4(ob + row * (int64_t)H * hd + col,
             make_float4(acc[i][c][0] / den, acc[i][c][1] / den, acc[i][c][2] / den,
                         acc[i][c][3] / den));
    }
  }
}

// ------------------------------------------------ the bf16 tensor-core body
constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows = kBQ

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d += a b for one 16 x 8 x 16 tile: a (16 x 16, row major) in the four
// registers of the PTX fragment layout, b (16 x 8, column major) in two.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of one head into the bf16 tile s[64][ld]; rows at
// or past n are zeros.
__device__ __forceinline__ void load_tile_bf16(const __nv_bfloat16* __restrict__ base,
                                               int64_t stride, int64_t row0, int64_t n,
                                               int hd, __nv_bfloat16* s, int ld) {
  const int chunks = hd >> 3;
  for (int c = threadIdx.x; c < kBQ * chunks; c += kMmaThreads) {
    const int r = c / chunks, col = (c - r * chunks) << 3;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) v = *reinterpret_cast<const uint4*>(base + (row0 + r) * stride + col);
    *reinterpret_cast<uint4*>(s + r * ld + col) = v;
  }
}

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(kBQ + 2 * kBK) * (D + 8);
}

// One block per (64-query tile, head, batch row), as flash_fwd_kernel; warp
// w owns query rows 16 w .. 16 w + 15 of the tile.  In the fragments a
// thread (lane = 4 g + t) holds rows g and g + 8 and, per 8-column tile,
// columns 2 t and 2 t + 1.  D (hd padded) is 64 or 128.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int64_t sq, int64_t sk, int H, int KV, int hd, int causal,
                     int64_t q_offset, float scale) {
  constexpr int LD = D + 8;  // bf16 row stride: 16-byte rows, ldmatrix conflict-free
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sK = sQ + kBQ * LD;
  __nv_bfloat16* sV = sK + kBK * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t q0 = (int64_t)blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int kvh = h / (H / KV);
  const __nv_bfloat16* qb = q + (bi * sq * H + h) * hd;
  const __nv_bfloat16* kb = k + (bi * sk * KV + kvh) * hd;
  const __nv_bfloat16* vb = v + (bi * sk * KV + kvh) * hd;

  const int pad = D - hd;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < kBQ * pad; i += kMmaThreads) {
    const int r = i / pad, c = hd + (i - r * pad);
    sQ[r * LD + c] = zero;
    sK[r * LD + c] = zero;
    sV[r * LD + c] = zero;
  }
  load_tile_bf16(qb, (int64_t)H * hd, q0, sq, hd, sQ, LD);
  __syncthreads();

  // This warp's Q fragments, one per 16 columns of the head dim.
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    ldmatrix_x4(qa[ks], sQ + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + ks * 16 +
                            8 * (lane >> 4));
  }

  const int64_t q_last = (q0 + kBQ < sq ? q0 + kBQ : sq) - 1;
  const int64_t n_keys = causal ? (q_offset + q_last + 1 < sk ? q_offset + q_last + 1 : sk) : sk;
  const int64_t row_lo = q0 + warp * 16 + g;  // and row_lo + 8

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int64_t k0 = 0; k0 < n_keys; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous K and V tiles
    load_tile_bf16(kb, (int64_t)KV * hd, k0, sk, hd, sK, LD);
    load_tile_bf16(vb, (int64_t)KV * hd, k0, sk, hd, sV, LD);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys, eight 8-key tiles.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, sK + (np * 16 + (lane & 7) + 8 * (lane >> 4)) * LD + ks * 16 +
                            8 * ((lane >> 3) & 1));
        mma_bf16(s[2 * np], qa[ks], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa[ks], kf[2], kf[3]);
      }
    }

    // Scale and mask, then the online softmax of rows g (half 0) and g + 8
    // (half 1); a row's 64 scores sit in the 4 lanes of its quad.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int64_t k_pos = k0 + n * 8 + 2 * t + (e & 1);
        const int64_t q_pos = q_offset + row_lo + 8 * half;
        float x = s[n][e] * scale;
        if (k_pos >= sk || (causal && k_pos > q_pos)) x = kNegInf;
        s[n][e] = x;
        mx[half] = fmaxf(mx[half], x);
      }
    float corr[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float x = mx[half];
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      m_new[half] = fmaxf(m[half], x);
      corr[half] = expf(m[half] - m_new[half]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m_new[e >> 1]);
        s[n][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float x = sum[half];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      l[half] = l[half] * corr[half] + x;
      m[half] = m_new[half];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += P V: P's score fragments are the A fragments of 16-key steps.
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, sV + (j * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                                  dp * 16 + 8 * (lane >> 4));
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // o = acc / max(l, 1e-30) in bf16, rows and columns inside the tensor only.
  __nv_bfloat16* ob = o + (bi * sq * H + h) * hd;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t row = row_lo + 8 * half;
    if (row >= sq) continue;
    const float den = fmaxf(l[half], 1e-30f);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if (col >= hd) continue;
      *reinterpret_cast<uint32_t*>(ob + row * (int64_t)H * hd + col) =
          pack_bf16(acc[n][2 * half] / den, acc[n][2 * half + 1] / den);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int64_t b, int64_t sq,
           int64_t sk, int H, int KV, int hd, int causal, int64_t q_offset,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  const dim3 grid(static_cast<unsigned>((sq + kBQ - 1) / kBQ), static_cast<unsigned>(H),
                  static_cast<unsigned>(b));
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, H, KV, hd, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int64_t b, int64_t sq,
               int64_t sk, int H, int KV, int hd, int causal, int64_t q_offset,
               cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_mma_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  const dim3 grid(static_cast<unsigned>((sq + kBQ - 1) / kBQ), static_cast<unsigned>(H),
                  static_cast<unsigned>(b));
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq, sk, H, KV, hd,
      causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int64_t b, int64_t sq,
              int64_t sk, int H, int KV, int hd, int causal, int64_t q_offset,
              cudaStream_t stream) {
  switch ((hd + 63) / 64) {
    case 1: return launch<T, 64>(q, k, v, o, b, sq, sk, H, KV, hd, causal, q_offset, stream);
    case 2: return launch<T, 128>(q, k, v, o, b, sq, sk, H, KV, hd, causal, q_offset, stream);
    case 3: return launch<T, 192>(q, k, v, o, b, sq, sk, H, KV, hd, causal, q_offset, stream);
    default: return launch<T, 256>(q, k, v, o, b, sq, sk, H, KV, hd, causal, q_offset, stream);
  }
}

// bfloat16 with hd <= 128 on the tensor cores; float32, and wider bf16
// heads (whose fragments would not fit the registers), by FFMA.
int launch_bf16(const void* q, const void* k, const void* v, void* o, int64_t b, int64_t sq,
                int64_t sk, int H, int KV, int hd, int causal, int64_t q_offset,
                cudaStream_t stream) {
  if (hd <= 64) return launch_mma<64>(q, k, v, o, b, sq, sk, H, KV, hd, causal, q_offset, stream);
  if (hd <= 128) {
    return launch_mma<128>(q, k, v, o, b, sq, sk, H, KV, hd, causal, q_offset, stream);
  }
  return launch_hd<__nv_bfloat16>(q, k, v, o, b, sq, sk, H, KV, hd, causal, q_offset, stream);
}

}  // namespace

// ------------------------------------------------------------- C entry point
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  q, o: (b, sq, H,
// hd); k, v: (b, sk, KV, hd); all contiguous and 16-byte aligned.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the kernel does
// not take (an empty dimension, H % KV != 0, hd not a multiple of 8 in
// [8, 256], q_offset < 0, or a grid dimension out of range).

extern "C" {

int rt_flash_attention_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                           int64_t b, int64_t sq, int64_t sk, int64_t H, int64_t KV,
                           int64_t hd, int causal, int64_t q_offset, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || H < 1 || KV < 1 || H % KV != 0 || hd < 8 || hd > 256 ||
      hd % 8 != 0 || q_offset < 0 || H > 65535 || b > 65535 ||
      (sq + kBQ - 1) / kBQ > 0x7fffffff || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(H), kv = static_cast<int>(KV), d = static_cast<int>(hd);
  return dtype ? launch_bf16(q, k, v, o, b, sq, sk, h, kv, d, causal, q_offset, s)
               : launch_hd<float>(q, k, v, o, b, sq, sk, h, kv, d, causal, q_offset, s);
}

}  // extern "C"
