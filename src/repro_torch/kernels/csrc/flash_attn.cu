// Hand-written Hopper (sm_90a) kernels for the attention forward of the LM
// (models/attention.flash_attention): one launch per layer per prefill when
// serving, per layer per training forward (again per layer when remat
// recomputes a period).  Training asks for each row's log-sum-exp as well
// (`lse`), which the backward (flash_attn_bwd.cu) reads.
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
// blocks.  Here a thread block owns one (query tile, head, batch row) at a
// time and loops over its key tiles itself, so the state never leaves it:
// (m, l) and the accumulator live in registers.  Key tiles wholly above the
// causal diagonal are never loaded.  Ragged lengths and q_offset need no
// padding by the caller: rows and keys past the ends are zero-filled and
// masked, never written.  The config's q_chunk/kv_chunk drive only the
// plain version; these tiles are the kernels' own.
//
// Two bodies; cuda_impl.flash_body picks one and the C entry refuses a body
// that does not take the shape:
//
// - wgmma (bfloat16, hd <= 128; the serving path): one block per SM walks
//   work items of 128 query rows -- two consumer warpgroups of 64 rows --
//   with a producer warpgroup.  The producer loads an item's query tile
//   (the next one as soon as the last S product has read the current one)
//   and keeps 128-key tiles of K and V in flight by TMA into a two-stage
//   ring in shared memory (128-byte swizzle, an mbarrier per stage and
//   operand for "full" and for "empty"); TMA zero-fills rows past sq or sk
//   and head columns past hd.  S = Q K^T
//   is wgmma.mma_async m64n128k16 with both operands in shared memory
//   (K-major); the scores are scaled in float32 after the product (the
//   reference scales q first: the same value to rounding), masked, and the
//   online softmax runs on the S accumulator in base 2 (ex2 on the SFU); P,
//   rounded to bf16, stays in registers: the accumulator's fragment layout
//   is the A operand's register layout, so O += P V is wgmma with A from
//   registers and V read MN-major through the descriptor's transpose bit.
//   The two consumer warpgroups take turns at the tensor cores, so one's
//   softmax overlaps the other's products.  setmaxnreg moves registers from
//   the producer to the consumers.  The work items run longest causal query
//   tile first, dealt to the blocks in zig-zag rounds, with the query heads
//   of one KV head side by side, so their K and V tiles are read from L2.
// - FFMA (float32, and bfloat16 with hd > 128): both products in float32
//   FFMA (TF32 tensor cores would miss the reference's 2e-5), exp by expf.
//   256 threads, one block per 64-query tile; each thread computes a 4 x 4
//   block of the 64 x 64 score tile (rows rg + 16 i, keys cg + 16 j, strided
//   so a warp's float4 reads of K fall in distinct banks) and the same 4
//   rows of the accumulator over hd / 16 columns; the row max and sum of a
//   tile are reduced over the 16 lanes that share the rows.  Q (scaled on
//   load), K, V and P are staged in shared memory as float32, loaded
//   synchronously; the head dim is padded to D = 64, 128, 192 or 256.
//
// Bound, at qwen2.5-14b's layer (b = 4, sq = sk = 2048, H = 40, KV = 8,
// hd = 128, bf16, causal): 4 b H hd (sq (sq + 1) / 2) = 1.7e11 flops, or
// 0.17 ms on the bf16 tensor cores (989 TFLOP/s), against 0.10 GB of q, k,
// v and o (0.03 ms at 3.35 TB/s): operations.  What the wgmma body leaves
// on the table: inside a warpgroup the softmax of a tile waits for its S
// product and the next S product for the softmax (only the two warpgroups
// overlap), the exponentials (64 per thread per tile on the SFU) compete
// with that overlap, the diagonal tiles are computed whole, and O is stored
// from the fragments.  In float32 the bound is the FFMA pipes' 67 TFLOP/s
// (2.6 ms).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attn_common.cuh"
#include "attn_wgmma.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile (kBQ == kBK: one padding loop)
constexpr int kThreads = 256;  // 16 row groups x 16 column groups

using attn::comp;
using attn::kNegInf;
using attn::max16;
using attn::store4;
using attn::sum16;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (D + 4) + (size_t)kBQ * (kBK + 4));
}

// The FFMA body.  One block per (64-query tile, head, batch row); D is hd
// padded to a multiple of 64.  With kLse it also stores each row's
// log-sum-exp m + log l (float32, (b, H, sq)) for the backward; the serving
// variant is compiled without that store.
template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int64_t sq, int64_t sk, int H,
                 int KV, int hd, int causal, int64_t q_offset, float scale) {
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
  attn::load_tile<kBQ, kThreads>(qb, (int64_t)H * hd, q0, sq, hd, scale, sQ, LD);

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
    attn::load_tile<kBQ, kThreads>(kb, (int64_t)KV * hd, k0, sk, hd, 1.f, sK, LD);
    attn::load_tile<kBQ, kThreads>(vb, (int64_t)KV * hd, k0, sk, hd, 1.f, sV, LD);
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
    if constexpr (kLse) {
      if (cg == 0) lse[(bi * H + h) * sq + row] = m[i] + logf(l[i]);
    }
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


// ------------------------------------------------ the bf16 wgmma body
namespace wg {

constexpr int kBM = 128;                   // query rows per block
constexpr int kBN = 128;                   // keys per tile
constexpr int kStages = 2;                 // K/V tiles in flight
constexpr int kConsumers = 256;             // two warpgroups of 64 query rows
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kBlk = 128 * 128;             // bytes of 128 rows x 64 bf16 columns
// setmaxnreg moves registers within the block's own allocation at launch:
// ptxas gives a block of three warpgroups 168 registers a thread (65536 /
// 384), so 128 x 24 + 256 x 240 = 384 x 168.  The producer is a whole
// warpgroup (its first thread issues every copy): with a lone producer warp
// the block holds 288 x 168 registers, and the consumers' increase would
// wait forever.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared memory, in bytes from a 1024-byte aligned base (the swizzle atom
// repeats every 1024 bytes): Q as D / 64 column blocks of 128 rows x 64
// columns, then per stage the column blocks of K and of V, then the
// mbarriers (q_full, q_empty, full_k[kStages], full_v[kStages],
// empty_k[kStages], empty_v[kStages]).
template <int D>
struct Layout {
  static constexpr int kCols = D / 64;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kCols * kBlk;
  static constexpr int kV = kK + kStages * kCols * kBlk;
  static constexpr int kBar = kV + kStages * kCols * kBlk;
  static constexpr int kTileBytes = kCols * kBlk;  // one K or V tile, one Q tile
  static constexpr size_t kBytes = kBar + 8 * (2 + 4 * kStages) + 1024;  // + alignment slack
};

using namespace attn_wg;

// A persistent kernel: one block per SM walks its share of the n_work work
// items (128-query tile, head, batch row; `decode_work`, `work_of`), so the
// next item's Q and first K/V tiles load while the current item finishes.  D (hd padded) is 64 or 128.
// In a consumer warp's fragments (lane = 4 g + t) a thread holds rows g and
// g + 8 of the warp's 16 and, per 8-column block, columns 2 t and 2 t + 1.
// scale_log2 is log2(e) / sqrt(hd): the softmax runs in base 2, its running
// maximum m on the scaled scores.
//
// Each consumer warpgroup runs its tiles in order -- S_t = Q K_t^T, the
// softmax, O += P_t V_t -- and the two take turns at the tensor cores
// (named barriers 1 and 2): a warpgroup issues its product only after the
// other has issued its own, so one's softmax runs while the other's product
// does.  Letting a warpgroup also overlap its own softmax with its next
// product (S_{t+1} issued before the softmax of S_t) needs P, S and O
// pinned in registers at once; ptxas then spilled and serialized the
// products at 168 and at 224 registers a thread, and that schedule ran
// slower (PERF.md).  K and V slots are released separately, K after its S
// product and V after its P V product.  With kLse the epilogue also stores
// each row's natural log-sum-exp, (m + log2 l) ln 2 (m is in base 2), as the
// FFMA body does; the serving variant is compiled without it.
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int64_t b, int64_t sq, int64_t sk, int H, int KV, int hd, int causal,
                       int64_t q_offset, float scale_log2, int64_t n_work) {
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8u;
  auto full_k = [&](int s) { return q_full + 8u * (2 + s); };
  auto full_v = [&](int s) { return q_full + 8u * (2 + kStages + s); };
  auto empty_k = [&](int s) { return q_full + 8u * (2 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return q_full + 8u * (2 + 3 * kStages + s); };

  // Work item w -> (query tile q0, batch row bi, head h) and its key tiles:
  // heads fastest, so the H / KV heads of one KV head are neighbours; the
  // last (longest causal) query tiles first.
  const int64_t n_qt = (sq + kBM - 1) / kBM;
  struct Work {
    int64_t q0, bi;
    int h, n_tiles;
  };
  auto decode_work = [&](int64_t w) {
    Work r;
    r.h = static_cast<int>(w % H);
    w /= H;
    r.bi = w % b;
    r.q0 = (n_qt - 1 - w / b) * kBM;
    const int64_t q_last = (r.q0 + kBM < sq ? r.q0 + kBM : sq) - 1;
    const int64_t n_keys =
        causal ? (q_offset + q_last + 1 < sk ? q_offset + q_last + 1 : sk) : sk;
    r.n_tiles = static_cast<int>((n_keys + kBN - 1) / kBN);
    return r;
  };
  // This block's item-th work item: rounds of gridDim.x items, walked
  // forwards and backwards in turn, so that the blocks' sums of the
  // longest-first items come out even.
  auto work_of = [&](int item) {
    const int64_t g = gridDim.x;
    return item * g + ((item & 1) ? g - 1 - blockIdx.x : blockIdx.x);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), kConsumers);
      mbar_init(empty_v(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      int it = 0;  // K/V tiles loaded, over all of this block's items
      int item = 0;
      for (int64_t w; (w = work_of(item)) < n_work; ++item) {
        const Work wk = decode_work(w);
        const int qrow = static_cast<int>(wk.q0), batch = static_cast<int>(wk.bi);
        const int kvh = wk.h / (H / KV);
        if (item > 0) mbar_wait(q_empty, (item - 1) & 1);  // the last item's Q is read
        mbar_expect_tx(q_full, L::kTileBytes);
#pragma unroll
        for (int c = 0; c < L::kCols; ++c) {
          tma_load_4d(sQ + c * kBlk, &tm_q, q_full, 64 * c, wk.h, qrow, batch);
        }
        for (int t = 0; t < wk.n_tiles; ++t, ++it) {
          const int s = it % kStages;
          const uint32_t parity = ((it / kStages) - 1) & 1;  // the slot's previous tile
          const int k0 = t * kBN;
          if (it >= kStages) mbar_wait(empty_k(s), parity);
          mbar_expect_tx(full_k(s), L::kTileBytes);
#pragma unroll
          for (int c = 0; c < L::kCols; ++c) {
            tma_load_4d(sK + (s * L::kCols + c) * kBlk, &tm_k, full_k(s), 64 * c, kvh, k0,
                        batch);
          }
          if (it >= kStages) mbar_wait(empty_v(s), parity);
          mbar_expect_tx(full_v(s), L::kTileBytes);
#pragma unroll
          for (int c = 0; c < L::kCols; ++c) {
            tma_load_4d(sV + (s * L::kCols + c) * kBlk, &tm_v, full_v(s), 64 * c, kvh, k0,
                        batch);
          }
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const uint32_t q_wg = sQ + 64 * wg * 128;  // this warpgroup's 64 rows of Q
    float acc[D / 2];
    float sc[kBN / 2];         // S_t, then P_t in float32
    uint32_t pa[kBN / 16][4];  // P_t in bf16: wgmma's A

    // This warpgroup's turn at the tensor cores: wait at barrier 1 + wg for
    // the other to have passed its turn on; pass the turn on after issuing.
    auto take_turn = [&]() {
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kConsumers) : "memory");
    };
    auto pass_turn = [&]() {
      asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(kConsumers) : "memory");
    };
    if (wg == 1) pass_turn();  // warpgroup 0 goes first

    int it = 0;  // K/V tiles consumed, over all of this block's items
    int item = 0;
    for (int64_t w; (w = work_of(item)) < n_work; ++item) {
      const Work wk = decode_work(w);
      const int64_t wg_row0 = wk.q0 + 64 * wg;
      const int64_t row_lo = wg_row0 + 16 * warp + g;  // and row_lo + 8
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's partial sums
      mbar_wait(q_full, item & 1);
      for (int t = 0; t < wk.n_tiles; ++t, ++it) {
        const int s = it % kStages;
        const uint32_t parity = (it / kStages) & 1;
        const int64_t k0 = static_cast<int64_t>(t) * kBN;

        // S = Q K^T: 64 rows x 128 keys, D / 16 steps of k16.
        mbar_wait(full_k(s), parity);
        take_turn();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk >> 2) * kBlk + (kk & 3) * 32;
          wgmma_ss_n128(sc, sw128_desc(q_wg + off, 16),
                        sw128_desc(sK + s * L::kCols * kBlk + off, 16), kk > 0);
        }
        wgmma_commit();
        pass_turn();
        wgmma_wait<0>();
        fence_regs(sc);
        mbar_arrive(empty_k(s));
        if (t == wk.n_tiles - 1) mbar_arrive(q_empty);  // the producer may load the next Q

        // Mask (only a tile that reaches past sk or, causal, past the
        // diagonal of this warpgroup's first row): row r sees the tile's
        // columns below lim = min(sk, causal ? q_offset + r + 1 : sk) - k0,
        // and a thread's column 8 n + (e & 1) + 2 t is tested against lim -
        // 2 t.  Masked scores are -1e30, as the reference's.
        const bool edge = k0 + kBN > sk || (causal && k0 + kBN - 1 > q_offset + wg_row0);
        int lim[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int64_t diag = q_offset + row_lo + 8 * half + 1;
          int64_t hi = causal && diag < sk ? diag : sk;
          hi -= k0;
          lim[half] = static_cast<int>(hi < kBN ? (hi > 0 ? hi : 0) : kBN) - 2 * t4;
        }
        // The online softmax of rows g (half 0) and g + 8 (half 1): a row's
        // 128 scores sit in the 4 lanes of its quad.  The maximum is taken on
        // the raw scores (the scale is positive) and the scale folded into
        // the exponent's fma.
        float mx[2] = {kNegInf, kNegInf};
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int half = e >> 1;
            float x = sc[4 * n + e];
            if (edge && 8 * n + (e & 1) >= lim[half]) x = kNegInf;
            sc[4 * n + e] = x;
            mx[half] = fmaxf(mx[half], x);
          }
        float corr[2], neg_m[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float x = mx[half];
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
          const float m_new = fmaxf(m[half], x * scale_log2);
          corr[half] = ex2(m[half] - m_new);
          m[half] = m_new;
          l[half] *= corr[half];
          neg_m[half] = -m_new;
        }
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) {
          const int half = (i >> 1) & 1;
          sc[i] = ex2(fmaf(sc[i], scale_log2, neg_m[half]));
          l[half] += sc[i];
        }
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[4 * n] *= corr[0];
          acc[4 * n + 1] *= corr[0];
          acc[4 * n + 2] *= corr[1];
          acc[4 * n + 3] *= corr[1];
        }
        // P into wgmma's A registers: keys 16 j .. 16 j + 15 are the score
        // blocks 2 j and 2 j + 1, one k16 step.
#pragma unroll
        for (int j = 0; j < kBN / 16; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[j][r] = pack_bf16(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]);
          }

        // O += P V: V read MN-major, k16 steps of 16 keys (2048 bytes).
        mbar_wait(full_v(s), parity);
        take_turn();
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kBN / 16; ++j) {
          const uint64_t dv = sw128_desc(sV + s * L::kCols * kBlk + j * 2048, kBlk);
          if constexpr (D == 128) {
            wgmma_rs_n128(acc, pa[j], dv, 1);
          } else {
            wgmma_rs_n64(acc, pa[j], dv, 1);
          }
        }
        wgmma_commit();
        pass_turn();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(empty_v(s));
      }

      // o = acc / max(l, 1e-30) in bf16, rows and columns inside the tensor.
      __nv_bfloat16* ob = o + (wk.bi * sq * H + wk.h) * hd;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float x = l[half];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        const float den = fmaxf(x, 1e-30f);
        const int64_t row = row_lo + 8 * half;
        if (row >= sq) continue;
        if constexpr (kLse) {
          if (t4 == 0) {
            lse[(wk.bi * H + wk.h) * sq + row] = (m[half] + log2f(x)) * 0.69314718055994531f;
          }
        }
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const int col = 8 * n + 2 * t4;
          if (col >= hd) continue;
          *reinterpret_cast<uint32_t*>(ob + row * (int64_t)H * hd + col) =
              pack_bf16(acc[4 * n + 2 * half] / den, acc[4 * n + 2 * half + 1] / den);
        }
      }
    }
  }
}


template <int D, bool kLse>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int64_t b,
                 int64_t sq, int64_t sk, int H, int KV, int hd, int causal, int64_t q_offset,
                 cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t e = make_map(&tm_q, q, b, sq, H, hd);
  if (e == cudaSuccess) e = make_map(&tm_k, k, b, sk, KV, hd);
  if (e == cudaSuccess) e = make_map(&tm_v, v, b, sk, KV, hd);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, kLse>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Layout<D>::kBytes));
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / std::sqrt(static_cast<double>(hd)));
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t n_work = (sq + kBM - 1) / kBM * H * b;
  const int64_t blocks = n_work < sms ? n_work : sms;
  flash_fwd_wgmma_kernel<D, kLse><<<static_cast<unsigned>(blocks), kThreads, Layout<D>::kBytes,
                                    stream>>>(tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o),
                                              lse, b, sq, sk, H, KV, hd, causal, q_offset,
                                              scale_log2, n_work);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

template <typename T, int D, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int64_t b,
           int64_t sq, int64_t sk, int H, int KV, int hd, int causal, int64_t q_offset,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D, kLse>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(hd)));
  const dim3 grid(static_cast<unsigned>((sq + kBQ - 1) / kBQ), static_cast<unsigned>(H),
                  static_cast<unsigned>(b));
  flash_fwd_kernel<T, D, kLse><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sq, sk, H, KV, hd, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kLse>
int launch_ffma(const void* q, const void* k, const void* v, void* o, float* lse, int64_t b,
                int64_t sq, int64_t sk, int H, int KV, int hd, int causal, int64_t q_offset,
                cudaStream_t stream) {
  switch ((hd + 63) / 64) {
    case 1:
      return launch<T, 64, kLse>(q, k, v, o, lse, b, sq, sk, H, KV, hd, causal, q_offset, stream);
    case 2:
      return launch<T, 128, kLse>(q, k, v, o, lse, b, sq, sk, H, KV, hd, causal, q_offset, stream);
    case 3:
      return launch<T, 192, kLse>(q, k, v, o, lse, b, sq, sk, H, KV, hd, causal, q_offset, stream);
    default:
      return launch<T, 256, kLse>(q, k, v, o, lse, b, sq, sk, H, KV, hd, causal, q_offset, stream);
  }
}

// The four variants of a body: with and without the log-sum-exp store.
template <bool kLse>
int launch_body(int dtype, int body, const void* q, const void* k, const void* v, void* o,
                float* lse, int64_t b, int64_t sq, int64_t sk, int H, int KV, int hd, int causal,
                int64_t q_offset, cudaStream_t s) {
  if (body == 0) {
    return hd <= 64 ? wg::launch_wgmma<64, kLse>(q, k, v, o, lse, b, sq, sk, H, KV, hd, causal,
                                                 q_offset, s)
                    : wg::launch_wgmma<128, kLse>(q, k, v, o, lse, b, sq, sk, H, KV, hd, causal,
                                                  q_offset, s);
  }
  return dtype ? launch_ffma<__nv_bfloat16, kLse>(q, k, v, o, lse, b, sq, sk, H, KV, hd, causal,
                                                  q_offset, s)
               : launch_ffma<float, kLse>(q, k, v, o, lse, b, sq, sk, H, KV, hd, causal,
                                          q_offset, s);
}

}  // namespace

// ------------------------------------------------------------- C entry point
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike).  body: 0 = wgmma
// (bfloat16 with hd <= 128 only), 1 = FFMA (either dtype, any hd).  q, o:
// (b, sq, H, hd); k, v: (b, sk, KV, hd); all contiguous and 16-byte
// aligned.  lse: null, or a float32 (b, H, sq) buffer for each row's
// log-sum-exp (the backward's input); o is the same with or without it.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a shape
// the kernels do not take (an empty dimension, H % KV != 0, hd not a
// multiple of 8 in [8, 256], q_offset < 0, a grid dimension out of range)
// or a body that does not take it.

extern "C" {

int rt_flash_attention_fwd(int dtype, int body, const void* q, const void* k, const void* v,
                           void* o, float* lse, int64_t b, int64_t sq, int64_t sk, int64_t H, int64_t KV,
                           int64_t hd, int causal, int64_t q_offset, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || H < 1 || KV < 1 || H % KV != 0 || hd < 8 || hd > 256 ||
      hd % 8 != 0 || q_offset < 0 || H > 65535 || b > 65535 || (dtype != 0 && dtype != 1) ||
      (body != 0 && body != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(H), kv = static_cast<int>(KV), d = static_cast<int>(hd);
  if (body == 0) {
    if (dtype != 1 || hd > 128 || sq > 0x7fffffff || sk > 0x7fffffff ||
        (sq + wg::kBM - 1) / wg::kBM * H * b > 0x7fffffff) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if ((sq + kBQ - 1) / kBQ > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return lse ? launch_body<true>(dtype, body, q, k, v, o, lse, b, sq, sk, h, kv, d, causal,
                                 q_offset, s)
             : launch_body<false>(dtype, body, q, k, v, o, lse, b, sq, sk, h, kv, d, causal,
                                  q_offset, s);
}

}  // extern "C"
