// The bf16 flash-attention forward for Hopper (sm_90a) against the exact
// row max that the flat forward (flash_attn_fwd.cu, B1) and the all-heads
// forward (flash_attn_allheads_fwd.cu, B4f) both launch. Each source wraps
// the body in a __global__ function of its own name, so a trace tells the
// two apart.
//
// What it computes, per (batch, head), the TPU kernels' function:
//   s   = (q * bf(scale*log2e)) . k^T   fp32; keys >= kv_len set to -1e30
//   m   = rowmax(s)                      exact, over all the row's keys
//   p   = exp2(s - m), rounded to bf16
//   l   = rowsum(p)                      from the rounded p, fp32
//   o   = (p . v) * (1 / l)              fp32 accumulation, stored in bf16
//   lse = m + log2(l)                    log2 space, fp32 [B, H, Sq]
// q is read as [B, H, Sq, 64] and k, v as [B, H, Sk, 64] through tensor
// maps over the real strides (the wrappers' `*_fwd_tma_specs`), so the
// three slices of the fused qkv GEMM output are read in place. o is a
// contiguous [B, Sq, H, 64]. The kernel masks its own ragged q and k edges.
//
// Design. A persistent grid, one block a multiprocessor, of a producer
// warpgroup and two consumer warpgroups, each consumer on its own units of
// 64 query rows of one (batch, head) (every other unit, in turn with the
// other blocks) with its own producer thread, as the backward's units are
// laid out (flash_bwd_units.cuh). A consumer's 64 rows of logits are 64 x
// Sk fp32, 132 registers a thread at 257 keys: with o's accumulator and
// p's fragments that is past the 168 registers a thread that a block of
// 384 threads a multiprocessor leaves. So each unit makes two passes over
// 128-key K tiles:
// - pass 1, s = q' . k^T (wgmma m64n128k16, both operands in shared
//   memory) and the exact row max, keys at or past kv_len masked (a key
//   past the tensor's end reads as zero by TMA, so s = 0 there, not
//   -1e30: the mask is explicit);
// - pass 2, the K tiles in reverse, so that the last tile's logits, still
//   in registers from pass 1, are not taken again: p = exp2(s - m) rounded
//   to bf16 in registers as the A operand of o += p . [v | 1] (wgmma
//   m64n72k16, v MN-major through the transpose bit); B's columns 64 .. 71
//   are a tile of ones, so the tensor cores sum l from the rounded p in
//   fp32; s of the next K tile and p . v of this one are issued in
//   separate groups, the exponentials run under p . v, and the loop is
//   peeled so that ptxas serialises no wgmma.
// The fitted tail (kTail8): where kv_len is 1 .. 8 keys past a multiple of
// 128 (ViT-B/14's 257 tokens: 256 + 1), the last key tile is taken as 8
// keys, not 128: s by one m64n8k16 product per k step, issued with the
// first full tile's in one group, and p . [v | 1] by one k16 step. At 257
// keys pass 1 takes 264 keys and pass 2 272, where three 128-key tiles
// took 384 in each, and each pass waits on two groups, not three. The tail
// tile's logits and the last full tile's both stay in registers for pass
// 2, so only the tiles before them are taken again; the tail's K slot goes
// back as soon as its logits land, so that the ring moves on past it
// however many full tiles follow.
// The producer brings each unit's q rows into one of two slots (the next
// unit's land while this one runs) and the K and V tiles, one 16 KB tile a
// slot, through a 5-stage mbarrier ring, by TMA (4-D tensor maps over
// [B, S, H, 64] with the real strides, 128-byte swizzle). The K tile that
// pass 2 takes first (the last but one) stays in its slot from pass 1, so
// it is read once; five stages let the ring move on past it. The consumer
// scales its rows to q' = bf(q * bf(scale*log2e)) in place once; rows past
// Sq read as zeros and are not stored. o = acc * (1 / l) leaves through the
// unit's q slot, swizzled, as 16-byte stores of whole rows by neighbouring
// threads, and the slot goes back to the producer after it. Exponentials
// are ex2.approx.ftz (one SFU instruction). setmaxnreg gives the consumers
// 232 registers and the producer warpgroup 40; ptxas fits the consumers in
// the 168 a thread that the launch bound leaves.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace fwd_units {

using namespace hopper;

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kHeadDim = 64;
constexpr float kMaskedLogit = -1e30f;  // masked keys; keeps a row finite
constexpr int kUnit = 64;    // query rows of a unit
constexpr int kTileK = 128;  // keys of a K or V tile
constexpr int kTail = 8;     // keys of a fitted tail tile
constexpr int kStages = 5;   // each consumer's ring of K or V tiles
constexpr int kRowBytes = kHeadDim * 2;     // 128: one swizzled row
constexpr int kQBytes = kUnit * kRowBytes;  // 8 KB
constexpr int kKBytes = kTileK * kRowBytes;  // 16 KB
constexpr int kThreads = 3 * 128;
// setmaxnreg's split, 2 x 232 + 40 = 504 a thread triple of 3 x 168.
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;

// Shared memory, from a 1024-byte boundary: one part a consumer (two q
// slots, the ring's tiles, the barriers), then the tile of ones that both
// consumers' p . [v | 1] read (past every V slot: the descriptor reaches it
// by a positive offset).
constexpr int kOffQ = 0;
constexpr int kOffStage = kOffQ + 2 * kQBytes;
constexpr int kOffBar = kOffStage + kStages * kKBytes;
constexpr int kNumBars = 4 + 2 * kStages;
constexpr int kPartBytes = (kOffBar + kNumBars * 8 + 1023) / 1024 * 1024;
constexpr int kOffOnes = 2 * kPartBytes;
constexpr int kSmem = 1024 + kOffOnes + kKBytes;
constexpr int kWgBar = 1;  // + c: consumer c's warpgroup alone

struct UnitArgs {
  bf16* o;
  float* lse;
  int Sq, H, kv_len;
  int n_qu;     // units of a (batch, head)
  int n_units;  // n_qu * H * B
  float qscale;
};

// s = q' . k^T over one K tile (64 rows x 128 keys; both operands
// K-major, 16 head dims = 32 bytes a step), one group.
__device__ __forceinline__ void issue_s(float (&s)[64], uint64_t q_desc,
                                        const uint8_t* sk) {
  const uint64_t k_desc = desc_sw128(sk, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_bf16_n128_ss<0, 0>(s, q_desc + 2 * kk, k_desc + 2 * kk, kk > 0);
  wgmma_commit();
}

// s = q' . k^T over the first 8 keys of a K tile (the fitted tail), not
// committed: it joins the group of the product issued after it.
__device__ __forceinline__ void issue_s8(float (&s8)[4], uint64_t q_desc,
                                         const uint8_t* sk) {
  const uint64_t k_desc = desc_sw128(sk, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_bf16_n8_ss(s8, q_desc + 2 * kk, k_desc + 2 * kk, kk > 0);
}

// acc += p . [v | 1] over the first `kSteps` 16-key steps of a V tile (p
// from registers, v MN-major, 16 keys = 2048 bytes a step), one group:
// columns 64 .. 71 of B are the ones tile, so acc's columns 64 .. 71 sum
// each row of the rounded p in fp32, the l of the contract.
template <int kSteps>
__device__ __forceinline__ void issue_pv(float (&acc)[36],
                                         const uint32_t (&pf)[kSteps][4],
                                         const uint8_t* sv,
                                         const uint8_t* ones) {
  const uint64_t v_desc = desc_sw128(
      sv, static_cast<uint32_t>(smem_u32(ones) - smem_u32(sv)), 1024);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    wgmma_bf16_n72_rs<1>(acc, pf[kk], v_desc + 128 * kk, 1);
  wgmma_commit();
}

// The row max of the logits of `kJ` 8-key column groups in a thread's rows
// r0 and r0 + 8, keys at or past kv_len left out.
template <bool kRagged, int kJ>
__device__ __forceinline__ void tile_max(const float (&s)[4 * kJ], float& m0,
                                         float& m1, int key0, int kv_len,
                                         int t) {
#pragma unroll
  for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool masked = kRagged && key0 + 8 * jj + 2 * t + e >= kv_len;
      m0 = fmaxf(m0, masked ? kMaskedLogit : s[4 * jj + e]);
      m1 = fmaxf(m1, masked ? kMaskedLogit : s[4 * jj + 2 + e]);
    }
}

// p = exp2(s - m) of one K tile (`kJ` 8-key column groups), keys at or past
// kv_len masked, rounded to bf16 and packed as the A fragments of p . v
// (k-step kk takes keys 16 kk .. 16 kk + 15: accumulator elements 8 kk ..
// 8 kk + 7); an odd last group leaves the upper half of its step zero. The
// masked logits go to new registers: s is the accumulator of the next s
// product.
template <bool kRagged, int kJ>
__device__ __forceinline__ void tile_p(const float (&s)[4 * kJ],
                                       uint32_t (&pn)[(kJ + 1) / 2][4],
                                       float m0, float m1, int key0,
                                       int kv_len, int t) {
#pragma unroll
  for (int jj = 0; jj < kJ; ++jj) {
    float x[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool masked = kRagged && key0 + 8 * jj + 2 * t + e >= kv_len;
      x[e] = masked ? kMaskedLogit : s[4 * jj + e];
      x[2 + e] = masked ? kMaskedLogit : s[4 * jj + 2 + e];
    }
    pn[jj >> 1][(jj & 1) * 2] =
        pack_bf16(exp2_ftz(x[0] - m0), exp2_ftz(x[1] - m0));
    pn[jj >> 1][(jj & 1) * 2 + 1] =
        pack_bf16(exp2_ftz(x[2] - m1), exp2_ftz(x[3] - m1));
  }
  if constexpr ((kJ & 1) != 0) {
    pn[kJ >> 1][2] = 0u;
    pn[kJ >> 1][3] = 0u;
  }
}

// p of a 128-key tile, the key mask applied only to a tile that reaches
// past kv_len.
__device__ __forceinline__ void p_at(const float (&s)[64],
                                     uint32_t (&pn)[8][4], float m0,
                                     float m1, int key0, int kv_len, int t) {
  if (key0 + kTileK > kv_len)
    tile_p<true, 16>(s, pn, m0, m1, key0, kv_len, t);
  else
    tile_p<false, 16>(s, pn, m0, m1, key0, kv_len, t);
}

// pf = pn by explicit moves, once the p . v that reads pf has landed: a
// plain copy lets the compiler give pn pf's registers, so that the softmax
// would write them while that product still reads them (and ptxas would
// serialise every wgmma to keep it right).
__device__ __forceinline__ void take_frags(uint32_t (&pf)[8][4],
                                           const uint32_t (&pn)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("mov.b32 %0, %1;" : "=r"(pf[kk][i]) : "r"(pn[kk][i]));
}

// Keeps the A fragments of an issued product in their registers until the
// wait that follows this call: the compiler reuses nothing of them before.
__device__ __forceinline__ void hold_frags(const uint32_t (&pf)[1][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" ::"r"(pf[0][i]) : "memory");
}

// The body of the kernel; each source's __global__ wrapper (kThreads
// threads, one block a multiprocessor) calls it. kTail8: kv_len is 1 .. 8
// keys past a multiple of 128, at least 129 (`launch` chooses).
template <bool kTail8>
__device__ __forceinline__ void body(const CUtensorMap& q_map,
                                     const CUtensorMap& k_map,
                                     const CUtensorMap& v_map,
                                     const UnitArgs& a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem0 = align1024(smem_raw);
  const int wg = threadIdx.x >> 7;
  const int wt = threadIdx.x & 127;
  const int lane = wt & 31;
  // Consumer c (warpgroup c + 1) and its producer (warp c of warpgroup 0)
  // share part c of shared memory and take units c + 2 * block, then every
  // 2 * grid further.
  const int c = wg == 0 ? wt >> 5 : wg - 1;
  uint8_t* smem = smem0 + (c & 1) * kPartBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kOffBar);  // [2]
  uint64_t* q_empty = q_full + 2;    // [2]: the unit's o has left the slot
  uint64_t* full = q_full + 4;       // a K or V tile landed
  uint64_t* empty = full + kStages;  // the consumer is done with it
  const uint8_t* ones = smem0 + kOffOnes;
  const int first_unit = 2 * blockIdx.x + c;
  const int stride = 2 * gridDim.x;
  // 128-key tiles; with the fitted tail, the full tiles before it (>= 1).
  const int n_kt = kTail8 ? a.kv_len / kTileK
                          : (a.kv_len + kTileK - 1) / kTileK;

  // The ones tile of p . [v | 1]: bf16 1.0 throughout, so the swizzle
  // does not matter.
  for (int i = threadIdx.x; i < kKBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem0 + kOffOnes)[i] =
        make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u);
  fence_proxy_async();
  if (threadIdx.x == 0 || threadIdx.x == 32) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 4);  // one arrival a consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producers: lane 0 of warps 0 and 1 issue every TMA copy ----
    regs_dealloc<kProducerRegs>();
    if (c < 2 && lane == 0) {
      int it = 0;  // K / V tiles so far, over all of this consumer's units
      int n = 0;
      auto load = [&](const CUtensorMap* map, int h, int key0, int b) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kKBytes);
        tma_load_4d(smem + kOffStage + s * kKBytes, map, &full[s], 0, h, key0,
                    b);
        ++it;
      };
      for (int u = first_unit; u < a.n_units; u += stride, ++n) {
        const int qu = u % a.n_qu;
        const int h = (u / a.n_qu) % a.H;
        const int b = u / (a.n_qu * a.H);
        const int qs = n & 1;
        mbar_wait(&q_empty[qs], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&q_full[qs], kQBytes);
        tma_load_4d(smem + kOffQ + qs * kQBytes, &q_map, &q_full[qs], 0, h,
                    qu * kUnit, b);
        // Pass 1: the tail tile first, then every full K tile. Pass 2, last
        // tile first: V of the tail, V of the last full tile (its s is
        // still in the consumer's registers), then K (but for the last but
        // one's, held from pass 1) and V of each tile before it.
        const int tail0 = n_kt * kTileK;
        if (kTail8) load(&k_map, h, tail0, b);
        for (int j = 0; j < n_kt; ++j) load(&k_map, h, j * kTileK, b);
        if (kTail8) load(&v_map, h, tail0, b);
        load(&v_map, h, (n_kt - 1) * kTileK, b);
        for (int j = n_kt - 2; j >= 0; --j) {
          if (j < n_kt - 2) load(&k_map, h, j * kTileK, b);
          load(&v_map, h, j * kTileK, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows a unit ----
  regs_alloc<kConsumerRegs>();
  const int t = lane & 3;
  const int r0 = (wt >> 5) * 16 + (lane >> 2);  // rows r0 and r0 + 8
  auto tile = [&](int i) { return smem + kOffStage + (i % kStages) * kKBytes; };
  auto wait_tile = [&](int i) { mbar_wait(&full[i % kStages], (i / kStages) & 1); };
  auto free_tile = [&](int i) {
    if (lane == 0) mbar_arrive(&empty[i % kStages]);
  };

  // q' = bf(q * qscale) of unit n, in place: elementwise, so TMA's swizzle
  // stays.
  auto scale_q = [&](int n) {
    uint4* p = reinterpret_cast<uint4*>(smem + kOffQ + (n & 1) * kQBytes);
    mbar_wait(&q_full[n & 1], (n >> 1) & 1);
    uint4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = p[wt + 128 * i];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[wt + 128 * i] = scaled8(v[i], a.qscale);
    fence_proxy_async();
    named_barrier(kWgBar + c, 128);
  };

  float s[64];  // the logits of a K tile
  int it = 0;
  int n = 0;
  for (int u = first_unit; u < a.n_units; u += stride, ++n) {
    const int qu = u % a.n_qu;
    const int h = (u / a.n_qu) % a.H;
    const int b = u / (a.n_qu * a.H);
    const int qs = n & 1;
    const uint64_t q_desc = desc_sw128(smem + kOffQ + qs * kQBytes, 16, 1024);
    scale_q(n);

    float m0 = -INFINITY, m1 = -INFINITY;  // rows r0 and r0 + 8
    float acc[36];  // o's 64 columns, then 8 copies of l
#pragma unroll
    for (int i = 0; i < 36; ++i) acc[i] = 0.f;
    // Ring indices, in the producer's order: the K of the tail (kTail8) at
    // `it`, K of full tile j at k0 + j, the V of the tail at base - 1, then
    // from `base` the V of the last full tile, the V of the last but one,
    // and K and V of each tile before it. Pass 2 takes full tile
    // n_kt - 1 - r at step r: its K (for r = 1 the last but one's, `held`
    // in its slot since pass 1) and the V of the tile of step r - 1.
    const int k0 = it + (kTail8 ? 1 : 0);
    const int base = k0 + n_kt + (kTail8 ? 1 : 0);
    const int held = k0 + n_kt - 2;
    const int tail0 = n_kt * kTileK;
    // Pass 1: the exact row max over every K tile. With the fitted tail,
    // its s is issued first and joins the first full tile's group, and its
    // slot goes back once that group lands (held to the end of the pass, it
    // would block the ring's sixth load, which the pass waits on).
    float s8[4];  // the tail's logits (kTail8)
    if constexpr (kTail8) {
      wait_tile(it);
      wgmma_fence();
      issue_s8(s8, q_desc, tile(it));
    }
    for (int j = 0; j < n_kt; ++j) {
      wait_tile(k0 + j);
      wgmma_fence();
      issue_s(s, q_desc, tile(k0 + j));
      wgmma_wait<0>();
      fence_regs(s);
      if (kTail8 && j == 0) free_tile(it);
      if (j != n_kt - 2) free_tile(k0 + j);
      if (!kTail8 && (j + 1) * kTileK > a.kv_len)
        tile_max<true, 16>(s, m0, m1, j * kTileK, a.kv_len, t);
      else
        tile_max<false, 16>(s, m0, m1, j * kTileK, a.kv_len, t);
    }
    if constexpr (kTail8) {
      wgmma_wait<0>();  // a no-op: ptxas sees no path that skips the loop
      fence_regs(s8);
      tile_max<true, 1>(s8, m0, m1, tail0, a.kv_len, t);
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));

    // Pass 2, the K tiles in reverse, so that the last one's logits, still
    // in s, are not taken again. With the fitted tail, its p . [v | 1] (one
    // k16 step) goes first, in a group of its own.
    uint32_t pf[8][4];  // p of the tile of the step before, A of p . v
    uint32_t pt[1][4];  // p of the fitted tail
    if constexpr (kTail8) tile_p<true, 1>(s8, pt, m0, m1, tail0, a.kv_len, t);
    p_at(s, pf, m0, m1, (n_kt - 1) * kTileK, a.kv_len, t);
    if constexpr (kTail8) {
      wait_tile(base - 1);
      wgmma_fence();
      issue_pv<1>(acc, pt, tile(base - 1), ones);
    }
    // Steps 1 ..: s of this tile and p . v of the one before in two groups;
    // the exponentials of this tile run while p . v does.
    for (int r = 1; r < n_kt; ++r) {
      const int kj = r == 1 ? held : base + 2 * r - 2;
      const int vj = r == 1 ? base : base + 2 * r - 3;
      wait_tile(kj);
      wait_tile(vj);
      wgmma_fence();
      issue_s(s, q_desc, tile(kj));
      issue_pv<8>(acc, pf, tile(vj), ones);
      wgmma_wait<1>();
      fence_regs(s);
      if constexpr (kTail8) {
        if (r == 1) {
          hold_frags(pt);  // the tail's p . v has landed
          free_tile(base - 1);
        }
      }
      free_tile(kj);
      uint32_t pn[8][4];
      p_at(s, pn, m0, m1, (n_kt - 1 - r) * kTileK, a.kv_len, t);
      wgmma_wait<0>();  // p . v of the step before has landed
      fence_regs(acc);
      free_tile(vj);
      take_frags(pf, pn);
    }
    // p . v of the first K tile, the last step's.
    const int vl = n_kt == 1 ? base : base + 2 * n_kt - 3;
    wait_tile(vl);
    wgmma_fence();
    issue_pv<8>(acc, pf, tile(vl), ones);
    wgmma_wait<0>();
    fence_regs(acc);
    free_tile(vl);
    if constexpr (kTail8) {
      if (n_kt == 1) {  // the tail's p . v landed with the last
        hold_frags(pt);
        free_tile(base - 1);
      }
    }
    it = vl + 1;

    // o = acc * (1 / l) in bf16, [B, Sq, H, 64], through the unit's q slot
    // (its last s product has landed) in the 128-byte swizzle, so that each
    // row leaves as eight 16-byte stores of neighbouring threads; lse = m +
    // log2(l), [B, H, Sq]. Then the slot goes back to the producer.
    {
      uint8_t* so = smem + kOffQ + qs * kQBytes;
      const float m_r[2] = {m0, m1};
      const float l_r[2] = {acc[32], acc[34]};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        const float inv = 1.f / l_r[r];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<bf162*>(so + row * kRowBytes +
                                    ((i ^ (row & 7)) << 4) + 4 * t) =
              __floats2bfloat162_rn(acc[4 * i + 2 * r] * inv,
                                    acc[4 * i + 2 * r + 1] * inv);
        const int q_row = qu * kUnit + row;
        if (t == 0 && q_row < a.Sq)
          a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + q_row] =
              m_r[r] + log2f(l_r[r]);
      }
      named_barrier(kWgBar + c, 128);
#pragma unroll
      for (int k = 0; k < kUnit * 8 / 128; ++k) {
        const int ci = wt + 128 * k;
        const int row = ci >> 3;
        const int q_row = qu * kUnit + row;
        if (q_row < a.Sq)
          *reinterpret_cast<uint4*>(
              a.o + ((static_cast<long long>(b) * a.Sq + q_row) * a.H + h) *
                        kHeadDim + (ci & 7) * 8) =
              *reinterpret_cast<const uint4*>(
                  so + row * kRowBytes + (((ci & 7) ^ (row & 7)) << 4));
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty[qs]);
    }
  }
}

// Whether kv_len takes the fitted 8-key tail: 1 .. 8 keys past a multiple
// of 128, at least 129.
inline bool tail8(int kv_len) {
  const int rem = kv_len % kTileK;
  return kv_len > kTileK && rem >= 1 && rem <= kTail;
}

// Encodes the tensor maps from `tma` (the specs of q, in boxes of 64 rows
// of one head, then k and v, in boxes of 128 rows) and launches `whole`
// (128-key tiles throughout) or `tail` (the fitted 8-key tail, where
// `tail8(kv_len)`), __global__ wrappers of `body<false>` and `body<true>`
// taking the three maps and the unit arguments, as a persistent grid on
// `st`; returns a cudaError_t (0 on success).
template <typename Kernel>
inline int launch(Kernel whole, Kernel tail, const void* q, const void* k,
                  const void* v, void* o, float* lse, int batch, int seq_q,
                  int heads, int kv_len, float qscale, const long long* tma,
                  cudaStream_t st) {
  if (tma == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int rc = encode_tensor_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                     ptrs[i], tma + i * kSpecLen,
                                     CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc) return rc;
  }
  Kernel kernel = tail8(kv_len) ? tail : whole;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qu = (seq_q + kUnit - 1) / kUnit;
  const long long n_units = static_cast<long long>(n_qu) * heads * batch;
  if (n_units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const UnitArgs ua{static_cast<bf16*>(o), lse, seq_q, heads, kv_len, n_qu,
                    static_cast<int>(n_units), qscale};
  // A persistent grid: two units a block at a time, at most one block a
  // multiprocessor.
  const long long pairs = (n_units + 1) / 2;
  const int grid = static_cast<int>(pairs < n_sm ? pairs : n_sm);
  kernel<<<grid, kThreads, kSmem, st>>>(maps[0], maps[1], maps[2], ua);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// fp32 CUDA-core kernel: the same two passes, one thread per query row (the
// tensor cores would round fp32 to tf32)
// ---------------------------------------------------------------------------

struct Strides {
  long long b, s, h;  // element strides of batch, row and head
};

constexpr int kF32Rows = 64;  // one thread per query row
constexpr int kF32Keys = 32;  // keys per shared tile

// Keys [key0, key0 + kF32Keys) of k (and of v when `vb` is given) into
// shared memory, zeros past kv_len.
__device__ __forceinline__ void load_f32_tile(float (*sK)[kHeadDim],
                                              float (*sV)[kHeadDim],
                                              const float* kb, const float* vb,
                                              long long k_ss, long long v_ss,
                                              int key0, int kv_len, int tid) {
#pragma unroll
  for (int i = 0; i < (kF32Keys * kHeadDim / 4) / kF32Rows; ++i) {
    const int c = tid + i * kF32Rows;
    const int r = c / (kHeadDim / 4);
    const int col = (c % (kHeadDim / 4)) * 4;
    const int key = key0 + r;
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 vx = kx;
    if (key < kv_len) {
      kx = *reinterpret_cast<const float4*>(kb + key * k_ss + col);
      if (vb) vx = *reinterpret_cast<const float4*>(vb + key * v_ss + col);
    }
    *reinterpret_cast<float4*>(&sK[r][col]) = kx;
    if (vb) *reinterpret_cast<float4*>(&sV[r][col]) = vx;
  }
}

// The body of the fp32 kernel; each source's __global__ wrapper (kF32Rows
// threads a block, grid (query-row blocks, heads, batch)) calls it.
__device__ __forceinline__ void f32_body(const float* __restrict__ q,
                                         const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         float* __restrict__ o,
                                         float* __restrict__ lse, int Sq,
                                         int H, int kv_len, float qscale,
                                         Strides qs, Strides ks, Strides vs) {
  __shared__ __align__(16) float sK[kF32Keys][kHeadDim];
  __shared__ __align__(16) float sV[kF32Keys][kHeadDim];

  const int tid = threadIdx.x;
  const int row = blockIdx.x * kF32Rows + tid;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  float qr[kHeadDim];
  {
    const float* qp = q + b * qs.b + h * qs.h + (row < Sq ? row : 0) * qs.s;
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(qp + d);
      qr[d] = x.x * qscale;
      qr[d + 1] = x.y * qscale;
      qr[d + 2] = x.z * qscale;
      qr[d + 3] = x.w * qscale;
    }
  }

  // Pass 1: the exact row max.
  float m = -INFINITY;
  for (int key0 = 0; key0 < kv_len; key0 += kF32Keys) {
    load_f32_tile(sK, sV, kb, nullptr, ks.s, vs.s, key0, kv_len, tid);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kF32Keys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) dot = fmaf(qr[d], sK[j][d], dot);
      m = fmaxf(m, key0 + j < kv_len ? dot : kMaskedLogit);
    }
    __syncthreads();
  }

  // Pass 2: p against it, o and l.
  float acc[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
  float l = 0.f;
  for (int key0 = 0; key0 < kv_len; key0 += kF32Keys) {
    load_f32_tile(sK, sV, kb, vb, ks.s, vs.s, key0, kv_len, tid);
    __syncthreads();
    for (int j = 0; j < kF32Keys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) dot = fmaf(qr[d], sK[j][d], dot);
      const float p = key0 + j < kv_len ? exp2f(dot - m) : 0.f;
      l += p;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) acc[d] = fmaf(p, sV[j][d], acc[d]);
    }
    __syncthreads();
  }

  if (row < Sq) {
    float* op = o + ((static_cast<long long>(b) * Sq + row) * H + h) * kHeadDim;
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 4)
      *reinterpret_cast<float4*>(op + d) = make_float4(
          acc[d] / l, acc[d + 1] / l, acc[d + 2] / l, acc[d + 3] / l);
    lse[(static_cast<long long>(b) * H + h) * Sq + row] = m + log2f(l);
  }
}

}  // namespace fwd_units
