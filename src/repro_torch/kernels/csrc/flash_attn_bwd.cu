// Hand-written Hopper (sm_90a) kernels for the attention backward of the LM's
// training path (kernels/autograd.FlashAttention, one call per layer per
// training step).
//
// Replaces no TPU kernel: the JAX package differentiates its jnp blocked
// attention (src/repro/models/attention.py:39) with jax.grad and has no
// backward Pallas kernel.  The port's forward is a CUDA kernel
// (flash_attn.cu, replacing kernels/flash_attn.py:83), so its gradient needs
// one on the card.  It computes the plain PyTorch version of the same name
// in ../ref.py to rounding: with S = scale Q K^T masked at -1e30 as the
// forward masks it, P = exp(S - lse) (lse the forward's log-sum-exp of
// each row), dP = dO V^T and dS = P (dP - D), D = rowsum(dO o O) given by
// the wrapper,
//
//   dV = P^T dO,  dK = scale dS^T Q,  dQ = scale dS K,
//
// dK and dV summed over the H / KV query heads of each KV head (GQA), in
// float32, stored in q's dtype (float32 or bfloat16).
//
// Two launches, no atomics:
//
// - dK, dV: one block per (64-key tile, KV head, batch row).  K and V stay
//   in shared memory; the block walks the G query heads of its KV head and,
//   for each, the query tiles that see its keys (causal: from the first row
//   whose position reaches the tile), recomputing S^T = K (scale Q)^T and
//   dP^T = V dO^T on the tile, then P^T and dS^T into shared memory, and
//   accumulates dV += P^T dO and dK += dS^T (scale Q) in registers.
// - dQ: one block per (64-query tile, head, batch row), over the key tiles
//   its rows see, recomputing S and dP and accumulating dQ += dS K.
//
// Every product is float32 FFMA, as the forward's FFMA body: 256 threads, a
// 4 x 4 block of each 64 x 64 tile a thread (rows rg + 16 i, columns
// cg + 16 j), tiles staged in shared memory as float32 with the head dim
// padded to D = 64 or 128 (hd a multiple of 8 up to 128).
//
// Bound, at stablelm-3b's layer (b = 2, sq = sk = 2048, H = KV = 32, hd =
// 80, bf16, causal): the five products of the backward, 10 b H hd (sq (sq
// + 1) / 2) = 1.07e11 flops, or 0.11 ms on the bf16 tensor cores; these
// kernels recompute S and dP in both launches (seven products) on the FFMA
// pipes (67 TFLOP/s) at the padded D = 128: 2.5e11 flops, 3.7 ms at best.
// What a faster design would do (ROADMAP B): wgmma on bf16 tiles with P and
// dS in registers, TMA-fed K/V rings, dQ by atomics or a second pass
// without the recomputed S.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attn_common.cuh"

namespace {

constexpr int kB = 64;         // query rows and keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups

using attn::comp;
using attn::kNegInf;
using attn::store4;

template <int D>
constexpr size_t dkdv_smem_bytes() {  // K, V, Q, dO; P^T, dS^T; lse, D
  return sizeof(float) * (4 * (size_t)kB * (D + 4) + 2 * (size_t)kB * (kB + 4) + 2 * kB);
}

template <int D>
constexpr size_t dq_smem_bytes() {  // Q, dO, K, V; dS; lse, D
  return sizeof(float) * (4 * (size_t)kB * (D + 4) + (size_t)kB * (kB + 4) + 2 * kB);
}

// out[i][j] = sum_d A[rg + 16 i][d] B[cg + 16 j][d] over the padded head
// dim: A and B are 64 x D tiles at row stride D + 4.
template <int D>
__device__ __forceinline__ void tile_dot(const float* __restrict__ A,
                                         const float* __restrict__ B, float (&out)[4][4],
                                         int rg, int cg) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (rg + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(B + (cg + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[i][j] = fmaf(a[i].x, b[j].x, out[i][j]);
        out[i][j] = fmaf(a[i].y, b[j].y, out[i][j]);
        out[i][j] = fmaf(a[i].z, b[j].z, out[i][j]);
        out[i][j] = fmaf(a[i].w, b[j].w, out[i][j]);
      }
  }
}

// acc[i][c][e] += sum_j P[rg + 16 i][j] B[j][4 (cg + 16 c) + e]: P a 64 x 64
// tile at row stride 68, B a 64 x D tile at row stride D + 4.
template <int D>
__device__ __forceinline__ void tile_acc(const float* __restrict__ P,
                                         const float* __restrict__ B,
                                         float (&acc)[4][D / 64][4], int rg, int cg) {
  constexpr int LD = D + 4, LDP = kB + 4, NC = D / 64;
#pragma unroll 2
  for (int j = 0; j < kB; j += 4) {
    float4 p4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p4[i] = *reinterpret_cast<const float4*>(P + (rg + 16 * i) * LDP + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float4 bb[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        bb[c] = *reinterpret_cast<const float4*>(B + (j + jj) * LD + 4 * (cg + 16 * c));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = comp(p4[i], jj);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[i][c][0] = fmaf(p, bb[c].x, acc[i][c][0]);
          acc[i][c][1] = fmaf(p, bb[c].y, acc[i][c][1]);
          acc[i][c][2] = fmaf(p, bb[c].z, acc[i][c][2]);
          acc[i][c][3] = fmaf(p, bb[c].w, acc[i][c][3]);
        }
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void zero_acc(float (&acc)[4][D / 64][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
}

// Rows [row0, row0 + 64) of the (.., rows, heads, hd) tensor at `base` (row
// 0 of the head, rows `stride` apart) from acc times `scale`, rows below n
// and columns below hd only.
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* __restrict__ base, int64_t stride, int64_t row0,
                                           int64_t n, int hd, float scale,
                                           const float (&acc)[4][D / 64][4], int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = row0 + rg + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      const int col = 4 * (cg + 16 * c);
      if (col >= hd) continue;
      store4(base + row * stride + col,
             make_float4(acc[i][c][0] * scale, acc[i][c][1] * scale, acc[i][c][2] * scale,
                         acc[i][c][3] * scale));
    }
  }
}

// Zero the padded columns [hd, D) of `n` 64 x D tiles laid out one after
// the other (they stay zero: loads write only [0, hd)).
template <int D>
__device__ __forceinline__ void zero_pad(float* tiles, int n, int hd) {
  constexpr int LD = D + 4;
  const int pad = D - hd;
  for (int i = threadIdx.x; i < n * kB * pad; i += kThreads) {
    const int r = i / pad, c = hd + (i - r * pad);
    tiles[r * LD + c] = 0.f;
  }
}

// 64 entries of a (b, H, sq) float32 row vector from `row0` into s; past n
// they are 0.
__device__ __forceinline__ void load_rows(const float* __restrict__ src, int64_t row0, int64_t n,
                                          float* s) {
  if (threadIdx.x < kB) {
    const int64_t r = row0 + threadIdx.x;
    s[threadIdx.x] = r < n ? src[r] : 0.f;
  }
}

// dK and dV of one (64-key tile, KV head, batch row).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int64_t sq, int64_t sk, int H, int KV, int hd, int causal,
                      int64_t q_offset, float scale) {
  constexpr int LD = D + 4, LDP = kB + 4;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kB * LD;
  float* sQ = sV + kB * LD;
  float* sdO = sQ + kB * LD;
  float* sP = sdO + kB * LD;
  float* sdS = sP + kB * LDP;
  float* sL = sdS + kB * LDP;
  float* sD = sL + kB;

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int64_t k0 = (int64_t)blockIdx.x * kB;
  const int kvh = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int G = H / KV;
  const int64_t kv_stride = (int64_t)KV * hd, q_stride = (int64_t)H * hd;

  zero_pad<D>(sK, 4, hd);
  attn::load_tile<kB, kThreads>(k + (bi * sk * KV + kvh) * hd, kv_stride, k0, sk, hd, 1.f, sK,
                                LD);
  attn::load_tile<kB, kThreads>(v + (bi * sk * KV + kvh) * hd, kv_stride, k0, sk, hd, 1.f, sV,
                                LD);

  // The first query row that sees key k0: causal, row i sees keys up to
  // q_offset + i.
  const int64_t first = causal ? (k0 - q_offset > 0 ? k0 - q_offset : 0) : 0;
  float acc_k[4][D / 64][4], acc_v[4][D / 64][4];
  zero_acc<D>(acc_k);
  zero_acc<D>(acc_v);

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + (bi * sq * H + h) * hd;
    const T* dob = dout + (bi * sq * H + h) * hd;
    const float* lb = lse + (bi * H + h) * sq;
    const float* db = delta + (bi * H + h) * sq;
    for (int64_t q0 = first / kB * kB; q0 < sq; q0 += kB) {
      __syncthreads();  // the previous tile's products are done with sQ, sdO, sP, sdS
      attn::load_tile<kB, kThreads>(qb, q_stride, q0, sq, hd, scale, sQ, LD);
      attn::load_tile<kB, kThreads>(dob, q_stride, q0, sq, hd, 1.f, sdO, LD);
      load_rows(lb, q0, sq, sL);
      load_rows(db, q0, sq, sD);
      __syncthreads();

      // S^T = K (scale Q)^T and dP^T = V dO^T: keys rg + 16 i, queries cg + 16 j.
      float s[4][4], dp[4][4];
      tile_dot<D>(sK, sQ, s, rg, cg);
      tile_dot<D>(sV, sdO, dp, rg, cg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t key = k0 + rg + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int64_t row = q0 + cg + 16 * j;
          const bool masked = key >= sk || row >= sq || (causal && key > q_offset + row);
          const float p = masked ? 0.f : expf(s[i][j] - sL[cg + 16 * j]);
          sP[(rg + 16 * i) * LDP + cg + 16 * j] = p;
          sdS[(rg + 16 * i) * LDP + cg + 16 * j] = p * (dp[i][j] - sD[cg + 16 * j]);
        }
      }
      __syncthreads();
      tile_acc<D>(sP, sdO, acc_v, rg, cg);   // dV += P^T dO
      tile_acc<D>(sdS, sQ, acc_k, rg, cg);   // dK += dS^T (scale Q)
    }
  }
  store_tile<T, D>(dk + (bi * sk * KV + kvh) * hd, kv_stride, k0, sk, hd, 1.f, acc_k, rg, cg);
  store_tile<T, D>(dv + (bi * sk * KV + kvh) * hd, kv_stride, k0, sk, hd, 1.f, acc_v, rg, cg);
}

// dQ of one (64-query tile, head, batch row).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int64_t sq, int64_t sk,
                    int H, int KV, int hd, int causal, int64_t q_offset, float scale) {
  constexpr int LD = D + 4, LDP = kB + 4;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + kB * LD;
  float* sK = sdO + kB * LD;
  float* sV = sK + kB * LD;
  float* sdS = sV + kB * LD;
  float* sL = sdS + kB * LDP;
  float* sD = sL + kB;

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int64_t q0 = (int64_t)blockIdx.x * kB;
  const int h = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int kvh = h / (H / KV);
  const int64_t kv_stride = (int64_t)KV * hd, q_stride = (int64_t)H * hd;
  const T* kb = k + (bi * sk * KV + kvh) * hd;
  const T* vb = v + (bi * sk * KV + kvh) * hd;

  zero_pad<D>(sQ, 4, hd);
  attn::load_tile<kB, kThreads>(q + (bi * sq * H + h) * hd, q_stride, q0, sq, hd, scale, sQ, LD);
  attn::load_tile<kB, kThreads>(dout + (bi * sq * H + h) * hd, q_stride, q0, sq, hd, 1.f, sdO,
                                LD);
  load_rows(lse + (bi * H + h) * sq, q0, sq, sL);
  load_rows(delta + (bi * H + h) * sq, q0, sq, sD);

  // Keys this tile sees: all, or (causal) up to its last row's position.
  const int64_t q_last = (q0 + kB < sq ? q0 + kB : sq) - 1;
  const int64_t n_keys = causal ? (q_offset + q_last + 1 < sk ? q_offset + q_last + 1 : sk) : sk;
  float acc[4][D / 64][4];
  zero_acc<D>(acc);

  for (int64_t k0 = 0; k0 < n_keys; k0 += kB) {
    __syncthreads();  // the previous tile's product is done with sK, sdS
    attn::load_tile<kB, kThreads>(kb, kv_stride, k0, sk, hd, 1.f, sK, LD);
    attn::load_tile<kB, kThreads>(vb, kv_stride, k0, sk, hd, 1.f, sV, LD);
    __syncthreads();

    // S = (scale Q) K^T and dP = dO V^T: queries rg + 16 i, keys cg + 16 j.
    float s[4][4], dp[4][4];
    tile_dot<D>(sQ, sK, s, rg, cg);
    tile_dot<D>(sdO, sV, dp, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + rg + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t key = k0 + cg + 16 * j;
        const bool masked = key >= sk || row >= sq || (causal && key > q_offset + row);
        const float p = masked ? 0.f : expf(s[i][j] - sL[rg + 16 * i]);
        sdS[(rg + 16 * i) * LDP + cg + 16 * j] = p * (dp[i][j] - sD[rg + 16 * i]);
      }
    }
    __syncthreads();
    tile_acc<D>(sdS, sK, acc, rg, cg);  // dQ += dS K (times scale at the store)
  }
  store_tile<T, D>(dq + (bi * sq * H + h) * hd, q_stride, q0, sq, hd, scale, acc, rg, cg);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv, int64_t b,
           int64_t sq, int64_t sk, int H, int KV, int hd, int causal, int64_t q_offset,
           cudaStream_t stream) {
  const size_t smem_kv = dkdv_smem_bytes<D>(), smem_q = dq_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_kv));
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const dim3 kv_grid(static_cast<unsigned>((sk + kB - 1) / kB), static_cast<unsigned>(KV),
                     static_cast<unsigned>(b));
  flash_bwd_dkdv_kernel<T, D><<<kv_grid, kThreads, smem_kv, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, H, KV, hd,
      causal, q_offset, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 q_grid(static_cast<unsigned>((sq + kB - 1) / kB), static_cast<unsigned>(H),
                    static_cast<unsigned>(b));
  flash_bwd_dq_kernel<T, D><<<q_grid, kThreads, smem_q, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), sq, sk, H, KV, hd, causal, q_offset,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, void* dk, void* dv, int64_t b,
                 int64_t sq, int64_t sk, int H, int KV, int hd, int causal, int64_t q_offset,
                 cudaStream_t stream) {
  return hd <= 64 ? launch<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk, H, KV, hd,
                                  causal, q_offset, stream)
                  : launch<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk, H, KV, hd,
                                   causal, q_offset, stream);
}

}  // namespace

// ------------------------------------------------------------- C entry point
// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dq, dk and dv alike).
// q, dout, dq: (b, sq, H, hd); k, v, dk, dv: (b, sk, KV, hd); lse and delta
// (rowsum(dout o o)): float32 (b, H, sq); all contiguous, the tensors of
// (b, ., ., hd) 16-byte aligned.  Launches the dK/dV kernel, then the dQ
// kernel, on `stream`.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a shape the kernels do not take (an empty dimension, H % KV != 0, hd
// not a multiple of 8 in [8, 128], q_offset < 0, a grid dimension out of
// range).

extern "C" {

int rt_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                           const void* dout, const float* lse, const float* delta, void* dq,
                           void* dk, void* dv, int64_t b, int64_t sq, int64_t sk, int64_t H,
                           int64_t KV, int64_t hd, int causal, int64_t q_offset, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || H < 1 || KV < 1 || H % KV != 0 || hd < 8 || hd > 128 ||
      hd % 8 != 0 || q_offset < 0 || H > 65535 || b > 65535 || (dtype != 0 && dtype != 1) ||
      (sq + kB - 1) / kB > 0x7fffffff || (sk + kB - 1) / kB > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(H), kv = static_cast<int>(KV), d = static_cast<int>(hd);
  return dtype ? launch_dtype<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk, h,
                                             kv, d, causal, q_offset, s)
               : launch_dtype<float>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk, h, kv, d,
                                     causal, q_offset, s);
}

}  // extern "C"
