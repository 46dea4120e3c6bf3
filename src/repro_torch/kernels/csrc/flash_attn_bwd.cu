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
// each row), dP = dO V^T and dS = P (dP - D), D = rowsum(dO o O),
//
//   dV = P^T dO,  dK = scale dS^T Q,  dQ = scale dS K,
//
// dK and dV summed over the H / KV query heads of each KV head (GQA), in
// float32, stored in q's dtype (float32 or bfloat16).  D is computed here
// too (flash_bwd_delta_kernel).
//
// Three launches, no atomics, so every call gives the same bits (training
// is reproducible and a resumed run equals a straight one):
//
// - D: rowsum(dO o O) of each query row and head, a thread a row.
// - dK, dV: one block per (key tile, KV head, batch row).  K and V stay in
//   shared memory; the block walks the G query heads of its KV head and,
//   for each, the query tiles that see its keys (causal: from the first row
//   whose position reaches the tile), recomputing S^T and dP^T on the tile,
//   and accumulates dV += P^T dO and dK += dS^T (scale Q), the G heads
//   summed in the accumulators.
// - dQ: one block per (query tile, head, batch row), over the key tiles
//   its rows see, recomputing S and dP and accumulating dQ += dS K.
//
// Two bodies; cuda_impl.flash_bwd_body picks one and the C entry refuses a
// body that does not take the shape:
//
// - wgmma (bfloat16, hd <= 128; the training path): 384 threads, two
//   consumer warpgroups of 64 rows (keys for dK/dV, queries for dQ) and a
//   producer warpgroup.  The producer loads the block's own tile pair once
//   and keeps the other pair (Q and dO, or K and V) in flight by TMA in a
//   three-stage ring with full/empty mbarriers; for dK/dV its second warp
//   puts each query tile's lse (times log2 e) and D beside it.  The
//   products are wgmma m64nNk16 in bf16 with float32 sums: S^T = K Q^T and
//   dP^T = V dO^T (both operands in shared memory, issued together), then
//   P^T = exp2(S^T scale log2 e - lse log2 e) on the SFU, masked, and dS^T =
//   P^T (dP^T - D) in float32; P^T rounded to bf16 in registers, where the
//   accumulator's fragment is the A operand's layout (as the forward's P),
//   dS^T as a hi and a lo bf16 part (a row of dS sums to zero, and one bf16
//   part doubled dQ's error); dV += P^T dO (issued while dP^T runs) and dK
//   += dS^T Q take A from registers and read dO and Q MN-major through the
//   descriptor's transpose bit.  dQ likewise with K read MN-major.  Tiles are 32-column blocks of 64 bytes a row (64-byte
//   swizzle), so hd 80 pads to 96 columns, not 128; TMA zero-fills columns
//   past hd and rows past sq or sk.
// - FFMA (float32, the first design): every product float32 FFMA, 256
//   threads, a 4 x 4 block of each 64 x 64 tile a thread (rows rg + 16 i,
//   columns cg + 16 j), tiles loaded synchronously and staged in shared
//   memory as float32 with the head dim padded to D = 64 or 128.  TF32
//   tensor cores would miss the float32 tolerance (tools/attn_checks.py).
//
// Bound, at stablelm-3b's layer (b = 2, sq = sk = 2048, H = KV = 32, hd =
// 80, bf16, causal): the five products of the backward, 10 b H hd (sq (sq
// + 1) / 2) = 1.07e11 flops, 0.109 ms on the bf16 tensor cores (989
// TFLOP/s); 0.012 ms of bytes.  Both bodies recompute S and dP in the dQ
// launch: seven products, 0.152 ms; the wgmma body's dS in two parts makes
// nine, 0.196 ms (0.235 at the padded 96 columns).  What the wgmma body does
// about the first design's four limits: the products run on the tensor
// cores in bf16 (the FFMA body's floor is 3.7 ms at D = 128 on the 67
// TFLOP/s pipes); the recomputed products stay (a one-pass dQ without
// atomics needs a dQ scratch per key tile, ~1.3 GB at this layer);
// hd 80 pads to 96, not 128; tiles arrive by TMA while the previous tile's
// products run.  What it leaves: inside a warpgroup the exponentials wait
// for the S product and the next products for the exponentials (only the
// two warpgroups overlap), the 64 x 64 score tiles read both operands from
// shared memory, diagonal tiles are computed whole, and the causal blocks'
// work differs by tile (they are launched longest first).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attn_common.cuh"
#include "attn_wgmma.cuh"

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

// D = rowsum(dO o O) of every (batch row, query row, head), float32 sums,
// into delta (b, H, sq): a thread a row of hd entries, read in 8-entry
// chunks of 16 or 32 bytes, threads of one warp on neighbouring rows.
constexpr int kDeltaThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int64_t n_rows, int64_t sq, int H, int hd) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(kDeltaThreads) + threadIdx.x;
  if (r >= n_rows) return;  // r = (bi sq + row) H + h
  const int64_t bs = r / H;
  const int h = static_cast<int>(r - bs * H);
  const int64_t bi = bs / sq, row = bs - bi * sq;
  const T* op = o + r * hd;
  const T* dp = dout + r * hd;
  float acc = 0.f;
  for (int c = 0; c < hd; c += 8) {
    float a[8], d[8];
    attn::load8(op + c, a);
    attn::load8(dp + c, d);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc = fmaf(a[e], d[e], acc);
  }
  delta[(bi * H + h) * sq + row] = acc;
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int64_t b, int64_t sq, int H,
                 int hd, cudaStream_t stream) {
  const int64_t n_rows = b * sq * H;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((n_rows + kDeltaThreads - 1) / kDeltaThreads),
                              kDeltaThreads, 0, stream>>>(static_cast<const T*>(o),
                                                          static_cast<const T*>(dout), delta,
                                                          n_rows, sq, H, hd);
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


// ------------------------------------------------ the bf16 wgmma body
namespace wgb {

using namespace attn_wg;

constexpr int kConsumers = 256;             // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kStages = 3;                  // tiles in flight in each ring
constexpr int kRow = 64;                    // bytes of a row of a 32-column block
constexpr int kWide = 128;                  // the rows a block owns: two warpgroups' 64
constexpr int kStep = 64;                   // the rows of a ring tile
constexpr float kLog2e = 1.4426950408889634f;
// 128 x 40 + 256 x 232 = 384 x 168, the block's registers at launch (see
// flash_attn.cu's kProducerRegs): the producer's second warp computes
// addresses of lse and D rows, so it keeps 40.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// A tile is D / 32 column blocks of its rows x 32 columns (64 bytes a row,
// 64-byte swizzle), so hd = 80 pads to 96 columns, not 128.  Shared memory,
// in bytes from a 1024-byte aligned base: the block's own tile pair (K and
// V for dK/dV, Q and dO for dQ; kWide rows each), then kStages stages of
// the ring's pair (kStep rows each), then, for dK/dV, kStages stages of the
// ring's 64 lse (times log2 e) and 64 D values, then the mbarriers (own,
// full[kStages], empty[kStages]).
template <int D, bool kRowVectors>
struct Layout {
  static constexpr int kCols = D / 32;
  static constexpr int kWideBlk = kWide * kRow;  // one column block of an own tile
  static constexpr int kStepBlk = kStep * kRow;  // of a ring tile
  static constexpr int kOwnTile = kCols * kWideBlk;
  static constexpr int kStepTile = kCols * kStepBlk;
  static constexpr int kOwnA = 0;
  static constexpr int kOwnB = kOwnA + kOwnTile;
  static constexpr int kRingA = kOwnB + kOwnTile;
  static constexpr int kRingB = kRingA + kStages * kStepTile;
  static constexpr int kVecs = kRingB + kStages * kStepTile;
  static constexpr int kBar = kVecs + (kRowVectors ? kStages * 2 * kStep * 4 : 0);
  static constexpr size_t kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 128) {
    wgmma_rs_n128(d, a, db, 1);
  } else if constexpr (D == 96) {
    wgmma_rs_n96(d, a, db, 1);
  } else {
    wgmma_rs_n64(d, a, db, 1);
  }
}

// The D / 16 k16 steps of a 64 x 64 product over the head dim, both
// operands K-major in 64-byte-swizzled column blocks (a_blk and b_blk bytes
// apart): step kk reads column block kk / 2 at byte 32 (kk % 2) of a row.
template <int D>
__device__ __forceinline__ void head_dim_product(float (&d)[32], uint32_t a, int a_blk,
                                                 uint32_t b, int b_blk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss_n64(d, sw64_desc(a + (kk >> 1) * a_blk + (kk & 1) * 32, 16),
                 sw64_desc(b + (kk >> 1) * b_blk + (kk & 1) * 32, 16), kk > 0);
  }
}

// The 64 x 64 accumulator (rows of this warp's 16, lane = 4 g + t: rows g
// and g + 8, per 8-column block n columns 8 n + 2 t and 8 n + 2 t + 1) in
// bf16 as wgmma's A for the 4 k16 steps over its columns: step j is the
// column blocks 2 j and 2 j + 1 (the forward's P at flash_attn.cu).
__device__ __forceinline__ void to_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[j][r] = pack_bf16(x[8 * j + 2 * r], x[8 * j + 2 * r + 1]);
}

// to_a's layout for the hi and lo bf16 parts of x (x = hi + lo to ~2^-17
// of x).  dS goes into its products so: its rows sum to zero, and a bf16 dS
// alone doubled dQ's error against the plain version's (PERF.md).
__device__ __forceinline__ void to_a_split(const float (&x)[32], uint32_t (&hi)[4][4],
                                           uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * j + 2 * r], b = x[8 * j + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      hi[j][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[j][r] = pack_bf16(a - hf.x, b - hf.y);
    }
}

// Rows `row_lo` and row_lo + 8 of a (.., rows, heads, hd) bf16 tensor from
// the D / 2 accumulator registers times `scale`: rows below n and columns
// below hd only.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ base, int64_t stride,
                                           int64_t row_lo, int64_t n, int hd, int t4,
                                           float scale, const float (&acc)[D / 2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t row = row_lo + 8 * half;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + 2 * t4;
      if (col >= hd) continue;
      *reinterpret_cast<uint32_t*>(base + row * stride + col) =
          pack_bf16(acc[4 * c + 2 * half] * scale, acc[4 * c + 2 * half + 1] * scale);
    }
  }
}

// dK and dV of one (128-key tile, KV head, batch row), blocks in the order
// key tile, batch row, KV head (causal: the keys that most queries see
// first).  Warpgroup wg owns keys k0 + 64 wg ..; the producer loads K and V
// once, then walks the G query heads of the KV head and, for each, the
// 64-query tiles that see the block's keys, keeping Q and dO in flight by
// TMA (thread 0) and the tile's lse (times log2 e) and D in shared memory
// (warp 1) in a kStages ring.  A step: S^T = K Q^T and dP^T = V dO^T
// (issued together), P^T = exp2(scale_log2 S^T - lse log2 e) masked and
// rounded to bf16 in registers as A, dV += P^T dO (issued while dP^T runs),
// dS^T = P^T (dP^T - D) as hi and lo bf16 parts, dK += dS^T Q (two
// products), dO and Q read MN-major.  dK is scaled at the store.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                            int64_t b, int64_t sq, int64_t sk, int H, int KV, int hd,
                            int causal, int64_t q_offset, float scale, float scale_log2) {
  using L = Layout<D, true>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* vecs = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kVecs);
  const uint32_t sK = base + L::kOwnA, sV = base + L::kOwnB;
  const uint32_t sQ = base + L::kRingA, sdO = base + L::kRingB;
  const uint32_t kv_full = base + L::kBar;
  auto full = [&](int s) { return kv_full + 8u * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8u * (1 + kStages + s); };

  int64_t w = blockIdx.x;
  const int kvh = static_cast<int>(w % KV);
  w /= KV;
  const int64_t bi = w % b;
  const int64_t k0 = (w / b) * kWide;
  const int G = H / KV;
  // The query tiles that see key k0: causal, row i sees keys up to q_offset + i.
  const int64_t first = causal ? (k0 - q_offset > 0 ? k0 - q_offset : 0) : 0;
  const int64_t n_qt = (sq + kStep - 1) / kStep;
  const int64_t qt0 = first / kStep;
  const int nq = static_cast<int>(n_qt > qt0 ? n_qt - qt0 : 0);
  const int n_steps = G * nq;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1 + 32);  // the TMA thread's expect_tx and warp 1's 32 lanes
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = threadIdx.x - kConsumers;
    if (pt == 0) {
      mbar_expect_tx(kv_full, 2 * L::kOwnTile);
#pragma unroll
      for (int c = 0; c < L::kCols; ++c) {
        tma_load_4d(sK + c * L::kWideBlk, &tm_k, kv_full, 32 * c, kvh, static_cast<int>(k0),
                    static_cast<int>(bi));
        tma_load_4d(sV + c * L::kWideBlk, &tm_v, kv_full, 32 * c, kvh, static_cast<int>(k0),
                    static_cast<int>(bi));
      }
      for (int it = 0; it < n_steps; ++it) {
        const int s = it % kStages;
        const int h = kvh * G + it / nq;
        const int q0 = static_cast<int>((qt0 + it % nq) * kStep);
        if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
        mbar_expect_tx(full(s), 2 * L::kStepTile);
#pragma unroll
        for (int c = 0; c < L::kCols; ++c) {
          tma_load_4d(sQ + (s * L::kCols + c) * L::kStepBlk, &tm_q, full(s), 32 * c, h, q0,
                      static_cast<int>(bi));
          tma_load_4d(sdO + (s * L::kCols + c) * L::kStepBlk, &tm_do, full(s), 32 * c, h, q0,
                      static_cast<int>(bi));
        }
      }
    } else if (pt >= 32 && pt < 64) {
      const int lane = pt - 32;
      for (int it = 0; it < n_steps; ++it) {
        const int s = it % kStages;
        const int64_t h = kvh * G + it / nq;
        const int64_t q0 = (qt0 + it % nq) * kStep;
        if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
        const float* lb = lse + (bi * H + h) * sq;
        const float* db = delta + (bi * H + h) * sq;
#pragma unroll
        for (int i = lane; i < kStep; i += 32) {
          const int64_t r = q0 + i;
          vecs[s * 2 * kStep + i] = r < sq ? lb[r] * kLog2e : 0.f;
          vecs[s * 2 * kStep + kStep + i] = r < sq ? db[r] : 0.f;
        }
        mbar_arrive(full(s));
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g4 = lane >> 2, t4 = lane & 3;
    const int64_t key_wg = k0 + 64 * wg;                // this warpgroup's first key
    const int64_t key_lo = key_wg + 16 * warp + g4;     // this thread's rows: key_lo, + 8
    const uint32_t k_wg = sK + 64 * wg * kRow, v_wg = sV + 64 * wg * kRow;
    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    float sc[32], dp[32];
    uint32_t pa[4][4], dh[4][4], dl[4][4];
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_steps; ++it) {
      const int s = it % kStages;
      const int64_t q0 = (qt0 + it % nq) * kStep;
      mbar_wait(full(s), (it / kStages) & 1);
      if (causal && q_offset + q0 + kStep - 1 < key_wg) {  // no row sees these keys
        mbar_arrive(empty(s));
        continue;
      }
      const uint32_t q_s = sQ + s * L::kStepTile, do_s = sdO + s * L::kStepTile;
      wgmma_fence();
      head_dim_product<D>(sc, k_wg, L::kWideBlk, q_s, L::kStepBlk);  // S^T = K Q^T
      wgmma_commit();
      head_dim_product<D>(dp, v_wg, L::kWideBlk, do_s, L::kStepBlk);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // P^T: key row key_lo + 8 half, query column q0 + 8 n + 2 t + (e & 1);
      // masked past sk, past sq and (causal) above the diagonal.
      const float* lrow = vecs + s * 2 * kStep;
      const float* drow = lrow + kStep;
      const bool edge = key_wg + 64 > sk || q0 + kStep > sq ||
                        (causal && key_wg + 63 > q_offset + q0);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(lrow + 8 * n + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t key = key_lo + 8 * (e >> 1);
          const int64_t query = q0 + 8 * n + 2 * t4 + (e & 1);
          const bool masked =
              edge && (key >= sk || query >= sq || (causal && key > q_offset + query));
          sc[4 * n + e] =
              masked ? 0.f : ex2(fmaf(sc[4 * n + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
        }
      }
      to_a(sc, pa);

      // dV += P^T dO, k16 steps of 16 queries (1024 bytes), issued while
      // dP^T may still run.
      fence_regs(acc_v);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_rs<D>(acc_v, pa[j], sw64_desc(do_s + j * 1024, L::kStepBlk));
      }
      wgmma_commit();
      wgmma_wait<1>();  // dP^T is done (groups complete in order)
      fence_regs(dp);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 d2 = *reinterpret_cast<const float2*>(drow + 8 * n + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[4 * n + e] = sc[4 * n + e] * (dp[4 * n + e] - ((e & 1) ? d2.y : d2.x));
        }
      }
      to_a_split(dp, dh, dl);

      // dK += dS^T Q as its hi and lo parts.
      fence_regs(acc_k);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_rs<D>(acc_k, dh[j], sw64_desc(q_s + j * 1024, L::kStepBlk));
        wgmma_rs<D>(acc_k, dl[j], sw64_desc(q_s + j * 1024, L::kStepBlk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
      mbar_arrive(empty(s));
    }
    const int64_t stride = static_cast<int64_t>(KV) * hd;
    store_rows<D>(dk + (bi * sk * KV + kvh) * hd, stride, key_lo, sk, hd, t4, scale, acc_k);
    store_rows<D>(dv + (bi * sk * KV + kvh) * hd, stride, key_lo, sk, hd, t4, 1.f, acc_v);
  }
}

// dQ of one (128-query tile, head, batch row), blocks in the order query
// tile (causal: the last, longest, first), batch row, head.  Warpgroup wg
// owns rows q0 + 64 wg ..; the producer loads Q and dO once, then keeps the
// 64-key tiles of K and V that the rows see in flight by TMA.  A step: S =
// Q K^T and dP = dO V^T (issued together), P = exp2(scale_log2 S - lse log2
// e) masked, dS = P (dP - D) as hi and lo bf16 parts in registers as A, dQ
// += dS K (two products) with K read MN-major.  dQ is scaled at the store.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int64_t b, int64_t sq, int64_t sk,
                          int H, int KV, int hd, int causal, int64_t q_offset, float scale,
                          float scale_log2) {
  using L = Layout<D, false>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kOwnA, sdO = base + L::kOwnB;
  const uint32_t sK = base + L::kRingA, sV = base + L::kRingB;
  const uint32_t q_full = base + L::kBar;
  auto full = [&](int s) { return q_full + 8u * (1 + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + kStages + s); };

  int64_t w = blockIdx.x;
  const int h = static_cast<int>(w % H);
  w /= H;
  const int64_t bi = w % b;
  const int64_t n_qt = (sq + kWide - 1) / kWide;
  const int64_t q0 = (n_qt - 1 - w / b) * kWide;
  const int kvh = h / (H / KV);
  // Keys the tile sees: all, or (causal) up to its last row's position.
  const int64_t q_last = (q0 + kWide < sq ? q0 + kWide : sq) - 1;
  const int64_t n_keys = causal ? (q_offset + q_last + 1 < sk ? q_offset + q_last + 1 : sk) : sk;
  const int n_steps = static_cast<int>((n_keys + kStep - 1) / kStep);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, 2 * L::kOwnTile);
#pragma unroll
      for (int c = 0; c < L::kCols; ++c) {
        tma_load_4d(sQ + c * L::kWideBlk, &tm_q, q_full, 32 * c, h, static_cast<int>(q0),
                    static_cast<int>(bi));
        tma_load_4d(sdO + c * L::kWideBlk, &tm_do, q_full, 32 * c, h, static_cast<int>(q0),
                    static_cast<int>(bi));
      }
      for (int it = 0; it < n_steps; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
        mbar_expect_tx(full(s), 2 * L::kStepTile);
#pragma unroll
        for (int c = 0; c < L::kCols; ++c) {
          tma_load_4d(sK + (s * L::kCols + c) * L::kStepBlk, &tm_k, full(s), 32 * c, kvh,
                      it * kStep, static_cast<int>(bi));
          tma_load_4d(sV + (s * L::kCols + c) * L::kStepBlk, &tm_v, full(s), 32 * c, kvh,
                      it * kStep, static_cast<int>(bi));
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g4 = lane >> 2, t4 = lane & 3;
    const int64_t row_wg = q0 + 64 * wg;              // this warpgroup's first row
    const int64_t row_lo = row_wg + 16 * warp + g4;   // this thread's rows: row_lo, + 8
    const uint32_t q_wg = sQ + 64 * wg * kRow, do_wg = sdO + 64 * wg * kRow;
    float lse2[2], dd[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = row_lo + 8 * half;
      lse2[half] = row < sq ? lse[(bi * H + h) * sq + row] * kLog2e : 0.f;
      dd[half] = row < sq ? delta[(bi * H + h) * sq + row] : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[32], dp[32];
    uint32_t dh[4][4], dl[4][4];
    mbar_wait(q_full, 0);
    for (int it = 0; it < n_steps; ++it) {
      const int s = it % kStages;
      const int64_t k0 = static_cast<int64_t>(it) * kStep;
      mbar_wait(full(s), (it / kStages) & 1);
      if (causal && k0 > q_offset + row_wg + 63) {  // no row of this warpgroup sees them
        mbar_arrive(empty(s));
        continue;
      }
      const uint32_t k_s = sK + s * L::kStepTile, v_s = sV + s * L::kStepTile;
      wgmma_fence();
      head_dim_product<D>(sc, q_wg, L::kWideBlk, k_s, L::kStepBlk);   // S = Q K^T
      wgmma_commit();
      head_dim_product<D>(dp, do_wg, L::kWideBlk, v_s, L::kStepBlk);  // dP = dO V^T
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);

      // P: query row row_lo + 8 half, key column k0 + 8 n + 2 t + (e & 1).
      const bool edge = k0 + kStep > sk || row_wg + 64 > sq ||
                        (causal && k0 + kStep - 1 > q_offset + row_wg);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1;
          const int64_t row = row_lo + 8 * half;
          const int64_t key = k0 + 8 * n + 2 * t4 + (e & 1);
          const bool masked =
              edge && (key >= sk || row >= sq || (causal && key > q_offset + row));
          sc[4 * n + e] = masked ? 0.f : ex2(fmaf(sc[4 * n + e], scale_log2, -lse2[half]));
        }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dd[(i >> 1) & 1]);
      to_a_split(dp, dh, dl);

      // dQ += dS K as its hi and lo parts: k16 steps of 16 keys (1024 bytes).
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wgmma_rs<D>(acc, dh[j], sw64_desc(k_s + j * 1024, L::kStepBlk));
        wgmma_rs<D>(acc, dl[j], sw64_desc(k_s + j * 1024, L::kStepBlk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty(s));
    }
    store_rows<D>(dq + (bi * sq * H + h) * hd, static_cast<int64_t>(H) * hd, row_lo, sq, hd, t4,
                  scale, acc);
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq, void* dk, void* dv, int64_t b,
                 int64_t sq, int64_t sk, int H, int KV, int hd, int causal, int64_t q_offset,
                 cudaStream_t stream) {
  constexpr auto kSw = CU_TENSOR_MAP_SWIZZLE_64B;
  // dK/dV: K and V by the block's 128 keys, Q and dO by 64-query ring
  // tiles; dQ: Q and dO by the block's 128 rows, K and V by 64-key tiles.
  CUtensorMap q_step, do_step, k_wide, v_wide, q_wide, do_wide, k_step, v_step;
  cudaError_t e = make_map(&q_step, q, b, sq, H, hd, 32, kStep, kSw);
  if (e == cudaSuccess) e = make_map(&do_step, dout, b, sq, H, hd, 32, kStep, kSw);
  if (e == cudaSuccess) e = make_map(&k_wide, k, b, sk, KV, hd, 32, kWide, kSw);
  if (e == cudaSuccess) e = make_map(&v_wide, v, b, sk, KV, hd, 32, kWide, kSw);
  if (e == cudaSuccess) e = make_map(&q_wide, q, b, sq, H, hd, 32, kWide, kSw);
  if (e == cudaSuccess) e = make_map(&do_wide, dout, b, sq, H, hd, 32, kWide, kSw);
  if (e == cudaSuccess) e = make_map(&k_step, k, b, sk, KV, hd, 32, kStep, kSw);
  if (e == cudaSuccess) e = make_map(&v_step, v, b, sk, KV, hd, 32, kStep, kSw);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Layout<D, true>::kBytes));
  }
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Layout<D, false>::kBytes));
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const double inv = 1.0 / std::sqrt(static_cast<double>(hd));
  const float scale = static_cast<float>(inv);
  const float scale_log2 = static_cast<float>(1.4426950408889634 * inv);
  const int64_t kv_blocks = (sk + kWide - 1) / kWide * KV * b;
  flash_bwd_dkdv_wgmma_kernel<D><<<static_cast<unsigned>(kv_blocks), kThreads,
                                   Layout<D, true>::kBytes, stream>>>(
      q_step, do_step, k_wide, v_wide, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), b, sq, sk, H, KV, hd, causal, q_offset, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t q_blocks = (sq + kWide - 1) / kWide * H * b;
  flash_bwd_dq_wgmma_kernel<D><<<static_cast<unsigned>(q_blocks), kThreads,
                                 Layout<D, false>::kBytes, stream>>>(
      q_wide, do_wide, k_step, v_step, lse, delta, static_cast<__nv_bfloat16*>(dq), b, sq, sk,
      H, KV, hd, causal, q_offset, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgb

}  // namespace

// ------------------------------------------------------------- C entry point
// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout, dq, dk and dv alike).
// body: 0 = wgmma (bfloat16 only), 1 = FFMA (either dtype).  q, o, dout, dq:
// (b, sq, H, hd); k, v, dk, dv: (b, sk, KV, hd); lse: float32 (b, H, sq);
// delta: a float32 (b, H, sq) buffer that receives rowsum(dout o o); all
// contiguous, the tensors of (b, ., ., hd) 16-byte aligned.  Launches the D
// kernel, the dK/dV kernel, then the dQ kernel, on `stream`.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the kernels do
// not take (an empty dimension, H % KV != 0, hd not a multiple of 8 in [8,
// 128], q_offset < 0, a grid dimension out of range) or a body that does not
// take it.

extern "C" {

int rt_flash_attention_bwd(int dtype, int body, const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse, float* delta,
                           void* dq, void* dk, void* dv, int64_t b, int64_t sq, int64_t sk,
                           int64_t H, int64_t KV, int64_t hd, int causal, int64_t q_offset,
                           void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || H < 1 || KV < 1 || H % KV != 0 || hd < 8 || hd > 128 ||
      hd % 8 != 0 || q_offset < 0 || H > 65535 || b > 65535 || (dtype != 0 && dtype != 1) ||
      (body != 0 && body != 1) || (sq + kB - 1) / kB > 0x7fffffff ||
      (sk + kB - 1) / kB > 0x7fffffff || (b * sq * H + kDeltaThreads - 1) / kDeltaThreads >
      0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(H), kv = static_cast<int>(KV), d = static_cast<int>(hd);
  if (body == 0 && (dtype != 1 || sq > 0x7fffffff || sk > 0x7fffffff ||
                    (sq + wgb::kWide - 1) / wgb::kWide * H * b > 0x7fffffff ||
                    (sk + wgb::kWide - 1) / wgb::kWide * KV * b > 0x7fffffff)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int e = dtype ? launch_delta<__nv_bfloat16>(o, dout, delta, b, sq, h, d, s)
                      : launch_delta<float>(o, dout, delta, b, sq, h, d, s);
  if (e != 0) return e;
  if (body == 0) {
    return d <= 64   ? wgb::launch_wgmma<64>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk,
                                             h, kv, d, causal, q_offset, s)
           : d <= 96 ? wgb::launch_wgmma<96>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk,
                                             h, kv, d, causal, q_offset, s)
                     : wgb::launch_wgmma<128>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk,
                                              h, kv, d, causal, q_offset, s);
  }
  return dtype ? launch_dtype<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk, h,
                                             kv, d, causal, q_offset, s)
               : launch_dtype<float>(q, k, v, dout, lse, delta, dq, dk, dv, b, sq, sk, h, kv, d,
                                     causal, q_offset, s);
}

}  // extern "C"
