// The bf16 flash-attention backward for Hopper (sm_90a) that the flat
// backward (flash_attn_bwd.cu, B2) and the all-heads backward
// (flash_attn_allheads_bwd.cu, B4b) both launch: dq, dk and dv of [B, H,
// S, 64] heads in one launch, deterministic. Each source wraps the body in
// a __global__ function of its own name, so a trace tells the two apart.
//
// What it computes, per (batch, head), from the forward's q, k, v, its
// log2 lse and delta = rowsum(dO * o) (delta is taken outside, in torch
// ops, with any lse cotangent folded in):
//   s   = (q * bf(scale*log2e)) . k^T       fp32, log2-space logits
//   p   = exp2(s - lse)                      fp32; 0 for keys >= kv_len
//                                            and for query rows >= q_len
//   dv  = p(bf16)^T . dO                     fp32 sum, stored in bf16
//   dp  = (dO * bf(scale))(bf16) . v^T       fp32
//   ds  = p * (dp - delta * scale)           fp32
//   dk  = ds(bf16)^T . q                     unscaled q; fp32 sum, bf16
//   dq  = ds(bf16) . k                       fp32 sum, bf16
// Keys at or past kv_len get p = 0, so their dk and dv are exactly 0; rows
// at or past q_len get exactly 0 dq. q and dO are read as [B, H, Sq, 64],
// k and v as [B, H, Sk, 64], through tensor maps over the real strides
// (the wrappers' `*_bwd_tma_specs`), so the fused qkv GEMM output's slices
// are read in place; lse and delta are contiguous [B, H, Sq] fp32; dq, dk
// and dv are contiguous [B, S, H, 64] bf16.
//
// Design. The TPU kernels carry dq across their sequential key blocks in a
// revisited output; a Hopper block has 227 KB and its blocks run in no
// order, and summing dq across key-tile blocks needs atomics, whose order
// (and so dq's low bits) varies from run to run. Here the work splits into
// units of 64 rows in two roles, one launch:
// - a dkv unit owns 64 keys of one (batch, head) and loops over 64-row
//   q/dO tiles: s^T = k . q'^T and dp^T = v . dO'^T (wgmma, both operands
//   in shared memory), p^T and ds^T in registers, dv += p^T . dO and
//   dk += ds^T . q (wgmma with A from registers and B MN-major through the
//   transpose bit);
// - a dq unit owns 64 query rows and loops over 64-key K/V tiles:
//   s = q' . k^T and dp = dO' . v^T, p and ds in registers, dq += ds . k
//   (A from registers, k MN-major), written once.
// Seven products per (q tile, key tile) pair where the TPU kernels take
// five, in exchange for no atomics: dq, dk and dv are bit-equal from run to
// run. The role whose units walk more tiles comes first, so the longest
// units start first. A persistent grid, one block a multiprocessor, holds
// a producer warpgroup and two consumer warpgroups; each consumer takes its
// own units (every other one, in turn with the other blocks) and has its
// own producer thread, which brings a unit's own two tiles into one of two
// slots (so the next unit's land while this one runs) and the streamed
// tiles through a 3-stage mbarrier ring, by TMA (4-D tensor maps over
// [B, S, H, 64], 128-byte swizzle; rows out of bounds read as zeros, the
// masks stay explicit). setmaxnreg gives the consumers 232 registers, the
// producer warpgroup 40; ptxas fits the consumers in the 168 a thread that
// one block of 384 threads a multiprocessor leaves, without spills (two
// blocks of 256 threads, 128 registers each, spilled, and ptxas serialised
// their wgmma). The contract rounds the scaled operands: a dq unit scales
// its own q and dO in place once; a dkv unit writes q' = bf(q *
// bf(scale*log2e)) and dO' = bf(dO * bf(scale)) of the next tile into one
// slot while this tile's dv and dk products run (s^T and dp^T, which read
// the slot, have landed), with the tile's lse and delta, loaded a tile
// ahead. p's exponentials are one SFU instruction each (ex2.approx.ftz:
// results below 2^-126 flush to zero, where exp2f adds a denormal fix-up).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace bwd_units {

using namespace hopper;

typedef __nv_bfloat16 bf16;

constexpr int kUnit = 64;    // rows of a unit and of a streamed tile
constexpr int kStages = 3;   // each consumer's ring of streamed tile pairs
constexpr int kRowBytes = 64 * 2;         // 128: one swizzled row
constexpr int kTile = kUnit * kRowBytes;  // 8 KB
constexpr int kThreads = 3 * 128;
// setmaxnreg's split, 2 x 232 + 40 = 504 a thread triple of 3 x 168.
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;

// Shared memory, from a 1024-byte boundary, one part a consumer: two slots
// of a unit's own two tiles (k and v of a dkv unit, q' and dO' of a dq
// unit); per stage the streamed pair (q and dO, or k and v); a dkv unit's
// q' and dO' of one q tile; the lse and delta of two q tiles; the barriers.
constexpr int kOwnBytes = 2 * kTile;
constexpr int kOffOwn = 0;
constexpr int kOffStage = kOffOwn + 2 * kOwnBytes;
constexpr int kStageBytes = 2 * kTile;
constexpr int kOffScaled = kOffStage + kStages * kStageBytes;
constexpr int kOffStats = kOffScaled + 2 * kTile;
constexpr int kOffBar = kOffStats + 2 * 2 * kUnit * 4;
constexpr int kNumBars = 4 + 2 * kStages;
constexpr int kPartBytes = (kOffBar + kNumBars * 8 + 1023) / 1024 * 1024;
constexpr int kSmem = 1024 + 2 * kPartBytes;
constexpr int kWgBar = 1;  // + c: consumer c's warpgroup alone

struct UnitArgs {
  const float* lse;
  const float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int Sq, Sk, H, kv_len, q_len;
  int n_qu, n_ku;  // dq and dkv units of a (batch, head)
  int bh;          // batch * heads
  int n_units;     // bh * (n_qu + n_ku)
  int dq_first;    // 1: the dq units come first
  float qscale, doscale, scale;
};

struct Unit {
  bool dq;     // a dq unit (else dkv)
  int row0;    // its first query row (dq) or key (dkv)
  int h, b;
  int n_tiles;  // streamed tiles: key tiles (dq) or q tiles (dkv); 0 idle
};

__device__ __forceinline__ Unit unit_of(const UnitArgs& a, int u) {
  const int n_first = a.dq_first ? a.n_qu : a.n_ku;
  const int n_second = a.dq_first ? a.n_ku : a.n_qu;
  const bool first = u < a.bh * n_first;
  const int n_role = first ? n_first : n_second;
  if (!first) u -= a.bh * n_first;
  const int bh = u / n_role;
  Unit out;
  out.dq = first == static_cast<bool>(a.dq_first);
  out.row0 = (u % n_role) * kUnit;
  out.h = bh % a.H;
  out.b = bh / a.H;
  // A unit past the live rows walks no tile and only writes zeros.
  if (out.dq)
    out.n_tiles = out.row0 < a.q_len ? (a.kv_len + kUnit - 1) / kUnit : 0;
  else
    out.n_tiles = out.row0 < a.kv_len ? (a.q_len + kUnit - 1) / kUnit : 0;
  return out;
}

// The tile at `src` (q then dO, 16 KB) into `dst` as q' and dO': 8 uint4
// a thread of the warpgroup, four loads in flight.
__device__ __forceinline__ void scale_pair(const uint8_t* src, uint8_t* dst,
                                           int wt, float qscale,
                                           float doscale) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = s[half * 512 + u * 128 + wt];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      d[half * 512 + u * 128 + wt] =
          scaled8(v[u], half == 0 ? qscale : doscale);
  }
}

// x (64 x 64) = a . b^T, both K-major 64 x 64 bf16 tiles in shared
// memory, 16 head dims = 32 bytes a step; issued, not committed.
__device__ __forceinline__ void issue_abt(float (&x)[32], const uint8_t* a,
                                          const uint8_t* b) {
  const uint64_t da = desc_sw128(a, 16, 1024);
  const uint64_t db = desc_sw128(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_bf16_ss<0, 0>(x, da + 2 * kk, db + 2 * kk, kk > 0);
}

// x (64 x 64) += f . m, f the A fragments of a 64 x 64 bf16 operand in
// registers, m a 64 x 64 tile in shared memory read MN-major (16 rows =
// 2048 bytes a step); issued, not committed.
__device__ __forceinline__ void issue_fm(float (&x)[32],
                                         const uint32_t (&f)[4][4],
                                         const uint8_t* m) {
  const uint64_t dm = desc_sw128(m, 1024, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_bf16_rs<1>(x, f[kk], dm + 128 * kk, 1);
}

// The body of the kernel; each source's __global__ wrapper (kThreads
// threads, one block a multiprocessor, kSmem bytes of dynamic shared
// memory) calls it with its __grid_constant__ tensor maps.
__device__ __forceinline__ void body(const CUtensorMap& q_map,
                                     const CUtensorMap& k_map,
                                     const CUtensorMap& v_map,
                                     const CUtensorMap& do_map,
                                     const UnitArgs& a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem0 = align1024(smem_raw);
  const int wg = threadIdx.x >> 7;
  const int wt = threadIdx.x & 127;
  const int lane = wt & 31;
  // Consumer c (warpgroup c + 1) and its producer (warp c of warpgroup 0)
  // share part c of shared memory and take units c + 2 * block, then every
  // 2 * grid further: the units come longest first.
  const int c = wg == 0 ? wt >> 5 : wg - 1;
  uint8_t* smem = smem0 + (c & 1) * kPartBytes;
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + kOffBar);  // [2]
  uint64_t* own_empty = own_full + 2;  // [2]: the unit's products are issued
  uint64_t* full = own_full + 4;       // a streamed pair landed
  uint64_t* empty = full + kStages;    // the consumer is done with it
  const int first_unit = 2 * blockIdx.x + c;
  const int stride = 2 * gridDim.x;
  if (threadIdx.x == 0 || threadIdx.x == 32) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&own_full[i], 1);
      mbar_init(&own_empty[i], 4);  // one arrival a consumer warp
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
      int it = 0;  // streamed tiles so far, over all of this consumer's units
      int n = 0;   // units with tiles so far
      for (int u = first_unit; u < a.n_units; u += stride) {
        const Unit un = unit_of(a, u);
        if (un.n_tiles == 0) continue;
        const CUtensorMap* own0 = un.dq ? &q_map : &k_map;
        const CUtensorMap* own1 = un.dq ? &do_map : &v_map;
        const CUtensorMap* st0 = un.dq ? &k_map : &q_map;
        const CUtensorMap* st1 = un.dq ? &v_map : &do_map;
        const int os = n & 1;
        uint8_t* own = smem + kOffOwn + os * kOwnBytes;
        mbar_wait(&own_empty[os], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&own_full[os], 2 * kTile);
        tma_load_4d(own, own0, &own_full[os], 0, un.h, un.row0, un.b);
        tma_load_4d(own + kTile, own1, &own_full[os], 0, un.h, un.row0, un.b);
        for (int i = 0; i < un.n_tiles; ++i, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * kTile);
          uint8_t* st = smem + kOffStage + s * kStageBytes;
          tma_load_4d(st, st0, &full[s], 0, un.h, i * kUnit, un.b);
          tma_load_4d(st + kTile, st1, &full[s], 0, un.h, i * kUnit, un.b);
        }
        ++n;
      }
    }
    return;
  }

  regs_alloc<kConsumerRegs>();
  const int t = lane & 3;
  const int r0 = (wt >> 5) * 16 + (lane >> 2);  // rows r0 and r0 + 8
  float* stats = reinterpret_cast<float*>(smem + kOffStats);
  int it = 0;
  int n = 0;
  for (int u = first_unit; u < a.n_units; u += stride) {
    const Unit un = unit_of(a, u);
    const int h = un.h;
    const int b = un.b;
    const int row = un.row0 + r0;
    if (un.n_tiles == 0) {  // rows past the live ones: zeros
      float zero[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) zero[i] = 0.f;
      if (un.dq) {
        store_acc_rows(a.dq, zero, row, a.Sq, a.H, h, b, t);
      } else {
        store_acc_rows(a.dk, zero, row, a.Sk, a.H, h, b, t);
        store_acc_rows(a.dv, zero, row, a.Sk, a.H, h, b, t);
      }
      continue;
    }
    const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;
    const int os = n & 1;
    uint8_t* own = smem + kOffOwn + os * kOwnBytes;

    if (un.dq) {
      // ---- dq unit: query rows row0 .. row0 + 63, every K / V tile ----
      const bool live0 = row < a.q_len;
      const bool live1 = row + 8 < a.q_len;
      // lse (+inf past q_len: p = 0 there) and delta * scale of the rows.
      const float lse0 = live0 ? a.lse[row_base + row] : INFINITY;
      const float lse1 = live1 ? a.lse[row_base + row + 8] : INFINITY;
      const float dl0 = live0 ? a.delta[row_base + row] * a.scale : 0.f;
      const float dl1 = live1 ? a.delta[row_base + row + 8] * a.scale : 0.f;
      mbar_wait(&own_full[os], (n >> 1) & 1);
      // q' and dO' in place: the unscaled rows are not needed here.
      scale_pair(own, own, wt, a.qscale, a.doscale);
      fence_proxy_async();
      named_barrier(kWgBar + c, 128);
      float dq[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[i] = 0.f;
      for (int kt = 0; kt < un.n_tiles; ++kt) {
        const int cur = it + kt;
        const int s = cur % kStages;
        mbar_wait(&full[s], (cur / kStages) & 1);
        const uint8_t* st = smem + kOffStage + s * kStageBytes;
        // s = q' . k^T and dp = dO' . v^T: 64 rows x 64 keys.
        float sc[32], dp[32];
        wgmma_fence();
        issue_abt(sc, own, st);
        issue_abt(dp, own + kTile, st + kTile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        if (kt == un.n_tiles - 1 && lane == 0) mbar_arrive(&own_empty[os]);
        // ds as bf16 A fragments: k-step kk takes keys 16 kk .. 16 kk + 15.
        uint32_t dsf[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int key = kt * kUnit + 8 * j + 2 * t;
          const bool k0 = key < a.kv_len;
          const bool k1 = key + 1 < a.kv_len;
          const float p0 = k0 ? exp2_ftz(sc[4 * j] - lse0) : 0.f;
          const float p1 = k1 ? exp2_ftz(sc[4 * j + 1] - lse0) : 0.f;
          const float p2 = k0 ? exp2_ftz(sc[4 * j + 2] - lse1) : 0.f;
          const float p3 = k1 ? exp2_ftz(sc[4 * j + 3] - lse1) : 0.f;
          dsf[j >> 1][(j & 1) * 2] =
              pack_bf16(p0 * (dp[4 * j] - dl0), p1 * (dp[4 * j + 1] - dl0));
          dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(
              p2 * (dp[4 * j + 2] - dl1), p3 * (dp[4 * j + 3] - dl1));
        }
        // dq += ds . k: k MN-major.
        wgmma_fence();
        issue_fm(dq, dsf, st);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      store_acc_rows(a.dq, dq, row, a.Sq, a.H, h, b, t);
    } else {
      // ---- dkv unit: keys row0 .. row0 + 63, every q / dO tile ----
      const bool mask0 = row >= a.kv_len;
      const bool mask1 = row + 8 >= a.kv_len;
      // Thread wt stages row wt % 64 of a q tile: its lse (wt < 64; +inf
      // past q_len: p = 0 there) or its delta, loaded a tile ahead.
      auto stat = [&](int qt) {
        const int r = qt * kUnit + (wt & 63);
        if (r >= a.q_len) return wt < 64 ? INFINITY : 0.f;
        return wt < 64 ? a.lse[row_base + r] : a.delta[row_base + r];
      };
      float st_next = stat(0);
      uint8_t* scaled = smem + kOffScaled;  // q' then dO' of one q tile
      {
        const int s = it % kStages;
        mbar_wait(&full[s], (it / kStages) & 1);
        scale_pair(smem + kOffStage + s * kStageBytes, scaled, wt, a.qscale,
                   a.doscale);
        stats[wt] = st_next;
        st_next = 1 < un.n_tiles ? stat(1) : 0.f;
        fence_proxy_async();
        named_barrier(kWgBar + c, 128);
      }
      mbar_wait(&own_full[os], (n >> 1) & 1);
      float dk[32], dv[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
      for (int qt = 0; qt < un.n_tiles; ++qt) {
        const int cur = it + qt;
        const int s = cur % kStages;
        const uint8_t* st = smem + kOffStage + s * kStageBytes;
        const float* lse = stats + (qt & 1) * 2 * kUnit;
        const float* dlt = lse + kUnit;
        // s^T = k . q'^T and dp^T = v . dO'^T: 64 keys x 64 queries.
        float sT[32], dpT[32];
        wgmma_fence();
        issue_abt(sT, own, scaled);
        issue_abt(dpT, own + kTile, scaled + kTile);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sT);
        fence_regs(dpT);
        if (qt == un.n_tiles - 1 && lane == 0) mbar_arrive(&own_empty[os]);

        // p^T and ds^T as bf16 A fragments: k-step kk takes accumulator
        // columns 16kk .. 16kk + 15, i.e. elements 8kk .. 8kk + 7.
        uint32_t pf[4][4], dsf[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * t;
          const float d0 = dlt[col] * a.scale;
          const float d1 = dlt[col + 1] * a.scale;
          const float p0 = mask0 ? 0.f : exp2_ftz(sT[4 * j] - lse[col]);
          const float p1 = mask0 ? 0.f : exp2_ftz(sT[4 * j + 1] - lse[col + 1]);
          const float p2 = mask1 ? 0.f : exp2_ftz(sT[4 * j + 2] - lse[col]);
          const float p3 = mask1 ? 0.f : exp2_ftz(sT[4 * j + 3] - lse[col + 1]);
          pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
          pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
          dsf[j >> 1][(j & 1) * 2] =
              pack_bf16(p0 * (dpT[4 * j] - d0), p1 * (dpT[4 * j + 1] - d1));
          dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(
              p2 * (dpT[4 * j + 2] - d0), p3 * (dpT[4 * j + 3] - d1));
        }

        // dv += p^T . dO and dk += ds^T . q: B MN-major, 16 q rows a step.
        wgmma_fence();
        issue_fm(dv, pf, st + kTile);
        issue_fm(dk, dsf, st);
        wgmma_commit();
        // While they run: the next tile's q', dO' and row statistics, once
        // every warp is past this tile's s^T and dp^T (they read q', dO').
        named_barrier(kWgBar + c, 128);
        if (qt + 1 < un.n_tiles) {
          const int ns = (cur + 1) % kStages;
          mbar_wait(&full[ns], ((cur + 1) / kStages) & 1);
          scale_pair(smem + kOffStage + ns * kStageBytes, scaled, wt,
                     a.qscale, a.doscale);
          stats[((qt + 1) & 1) * 2 * kUnit + wt] = st_next;
          st_next = qt + 2 < un.n_tiles ? stat(qt + 2) : 0.f;
          fence_proxy_async();
        }
        wgmma_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        named_barrier(kWgBar + c, 128);  // the copies are written
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      store_acc_rows(a.dk, dk, row, a.Sk, a.H, h, b, t);
      store_acc_rows(a.dv, dv, row, a.Sk, a.H, h, b, t);
    }
    it += un.n_tiles;
    ++n;
  }
}

// Encodes the tensor maps from `tma` (the specs of q, k, v and dO, 16
// int64 each, boxes of 64 rows of one head) and launches `kernel`, a
// __global__ wrapper of `body` taking the four maps and the unit
// arguments, as a persistent grid on `st`; returns a cudaError_t (0 on
// success).
template <typename Kernel>
inline int launch(Kernel kernel, const void* q, const void* k,
                  const void* v, const void* dout, const float* lse,
                  const float* delta, void* dq, void* dk, void* dv,
                  int batch, int seq_q, int seq_k, int heads, int kv_len,
                  int q_len, float qscale, float doscale, float scale,
                  const long long* tma, cudaStream_t st) {
  if (tma == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const int rc = encode_tensor_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                     ptrs[i], tma + i * kSpecLen,
                                     CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc) return rc;
  }
  const int n_qu = (seq_q + kUnit - 1) / kUnit;
  const int n_ku = (seq_k + kUnit - 1) / kUnit;
  const long long bh = static_cast<long long>(batch) * heads;
  const long long n_units = bh * (n_qu + n_ku);
  if (n_units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // The role whose units walk more tiles first: a dq unit walks the key
  // tiles, a dkv unit the query tiles.
  const int dq_first =
      (kv_len + kUnit - 1) / kUnit >= (q_len + kUnit - 1) / kUnit;
  const UnitArgs ua{lse,    delta,   static_cast<bf16*>(dq),
                    static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                    seq_q,  seq_k,   heads, kv_len, q_len, n_qu, n_ku,
                    static_cast<int>(bh), static_cast<int>(n_units),
                    dq_first, qscale, doscale, scale};
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // A persistent grid: two units a block at a time, at most one block a
  // multiprocessor.
  const long long pairs = (n_units + 1) / 2;
  const int grid = static_cast<int>(pairs < n_sm ? pairs : n_sm);
  kernel<<<grid, kThreads, kSmem, st>>>(maps[0], maps[1], maps[2], maps[3],
                                        ua);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd_units
