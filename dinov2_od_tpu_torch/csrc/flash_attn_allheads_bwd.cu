// Flash-attention backward over [B, H, S, 64] heads for Hopper (sm_90a),
// plain C interface: dk/dv and dq in one launch, all three deterministic.
//
// Replaces dinov2_od_tpu/ops/flash_attention.py:_bwd_kernel_allheads (B4b),
// the Pallas TPU kernel that the JAX dispatch (`_bhsd_bwd_impl`) runs
// wherever five fp32 [Sq_pad, Sk_pad] logits-sized buffers of one head fit
// its 8 MiB budget (`_head_group(h, sq_pad, sk_pad, 5) >= 1`: self-attention
// up to 640 tokens, Sq != Sk while Sq_pad x Sk_pad <= 419k) and the flat
// kernels do not take the shape: ViT-B/14 under 4-way tensor parallelism,
// 3 heads a rank at 257 tokens, in the adapted blocks' backward.
//
// What it computes, per (batch, head), from the forward's q, k, v, its
// log2 lse and delta = rowsum(dO * o) (delta is taken outside, in torch
// ops, with any lse cotangent folded in):
//   s   = (q * bf(scale*log2e)) . k^T       fp32, log2-space logits
//   p   = exp2(s - lse)                      fp32; 0 for keys >= kv_len
//                                            and for query rows >= q_len
//   dv  = p(dt)^T . dO                       fp32 sum, stored in dt
//   dp  = (dO * bf(scale))(dt) . v^T         fp32
//   ds  = p * (dp - delta * scale)           fp32
//   dk  = ds(dt)^T . q                       unscaled q; fp32 sum, dt
//   dq  = ds(dt) . k                         fp32 sum, dt
// dt is the input type (bf16 or fp32). Keys at or past kv_len get p = 0,
// so their dk and dv are exactly 0; rows at or past q_len get exactly 0 dq.
// q and dO are read as [B, H, Sq, 64], k and v as [B, H, Sk, 64], through
// arbitrary batch, head and row strides (the last dim contiguous), so a
// rank's head slices of the fused qkv GEMM output are read in place; lse
// and delta are contiguous [B, H, Sq] fp32; dq, dk and dv are contiguous
// [B, S, H, 64] in dt.
//
// What bounds it at the tensor-parallel shape [32, 257, 3, 64] bf16: bytes.
// q, k, v and dO read and dq, dk, dv written are 7 x 3.16 MB, the lse and
// delta 0.2 MB: 22.3 MB, 6.7 us at 3.35 TB/s; the five products are
// 10*B*H*S^2*64 = 4.06 GFLOP, 4.1 us at 989 TFLOP/s.
//
// Design. The TPU kernel holds a head's whole [Sq, Sk] logits in VMEM and
// takes dq, dk and dv from them in one pass. A Hopper block has 227 KB, and
// summing dq across key-tile blocks needs atomics (B5b's route, which makes
// dq's low bits vary from run to run). Here the work splits into units of
// 64 rows in two roles, one launch, one unit a block:
// - a dkv unit owns 64 keys of one (batch, head) and loops over 64-row
//   q/dO tiles: s^T = k . q'^T and dp^T = v . dO'^T (wgmma, both operands
//   in shared memory), p^T and ds^T in registers, dv += p^T . dO and
//   dk += ds^T . q (wgmma with A from registers and B MN-major through the
//   transpose bit): B5b's path without its dq share;
// - a dq unit owns 64 query rows and loops over 64-key K/V tiles:
//   s = q' . k^T and dp = dO' . v^T, p and ds in registers, dq += ds . k
//   (A from registers, k MN-major), written once.
// Seven products per (q tile, key tile) pair where the TPU kernel takes
// five, in exchange for no atomics: dq, dk and dv are deterministic. The
// work counts units, not 128-row blocks, so at 257 tokens the one-row
// tail units are a fifth of the work, not a third; the role whose units
// walk more tiles comes first, so the longest units start first. A
// persistent grid, one block a multiprocessor, holds a producer warpgroup
// and two consumer warpgroups; each consumer takes its own units (every
// other one, in turn with the other blocks) and has its own producer
// thread, which brings a unit's own two tiles (refilled as soon as the
// consumer's last product of a unit has read them) and the streamed tiles
// through a 4-stage mbarrier ring by TMA (4-D tensor maps over
// [B, S, H, 64] with the real strides, 128-byte swizzle; rows out of
// bounds read as zeros, the masks stay explicit). setmaxnreg gives the
// consumers 232 registers, the producer warpgroup 40; ptxas fits the
// consumers in the 168 a thread that one block of 384 threads a
// multiprocessor leaves, without spills (two blocks of 256 threads, 128
// registers each, spilled, and ptxas serialised their wgmma). The
// contract rounds the scaled operands: a dq unit scales its own q and dO
// in place once; a dkv unit writes q' = bf(q * bf(scale*log2e)) and
// dO' = bf(dO * bf(scale)) of the next tile into one slot while this
// tile's dv and dk products run (s^T and dp^T, which read the slot, have
// landed), with the tile's lse and delta, loaded a tile ahead. p's
// exponentials are one SFU instruction each (ex2.approx.ftz: results
// below 2^-126 flush to zero, where exp2f adds a denormal fix-up). fp32
// inputs take CUDA-core kernels with the same two roles (one thread per
// key, one per query row), since the tensor cores would round to tf32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

constexpr int kHeadDim = 64;

struct Strides {
  long long b, s, h;  // element strides of batch, row and head
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int Sq, Sk, H, kv_len, q_len;
  int n_key_blocks;  // blocks of the dk/dv role per (head, batch)
  float qscale;      // bf(scale * log2 e), q's multiplier in s
  float doscale;     // scale in the input type, dO's multiplier in dp
  float scale;       // scale in fp32, delta's multiplier in ds
  Strides qs, ks, vs, dos;
};

// ---------------------------------------------------------------------------
// bf16 kernel: TMA, wgmma, a producer warpgroup and two consumer
// warpgroups, each consumer on its own units
// ---------------------------------------------------------------------------

constexpr int kUnit = 64;    // rows of a unit and of a streamed tile
constexpr int kStages = 4;   // each consumer's ring of streamed tile pairs
constexpr int kRowBytes = kHeadDim * 2;  // 128: one swizzled row
constexpr int kTile = kUnit * kRowBytes;  // 8 KB
constexpr int kBf16Threads = 3 * 128;
// setmaxnreg's split, 2 x 232 + 40 = 504 a thread triple of 3 x 168.
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;

// Shared memory, from a 1024-byte boundary, one part a consumer: the
// unit's own two tiles (k and v of a dkv unit, q' and dO' of a dq unit);
// per stage the streamed pair (q and dO, or k and v); a dkv unit's q' and
// dO' of one q tile; the lse and delta of two q tiles; the barriers.
constexpr int kOffOwn = 0;
constexpr int kOffStage = kOffOwn + 2 * kTile;
constexpr int kStageBytes = 2 * kTile;
constexpr int kOffScaled = kOffStage + kStages * kStageBytes;
constexpr int kOffStats = kOffScaled + 2 * kTile;
constexpr int kOffBar = kOffStats + 2 * 2 * kUnit * 4;
constexpr int kNumBars = 2 + 2 * kStages;
constexpr int kPartBytes = (kOffBar + kNumBars * 8 + 1023) / 1024 * 1024;
constexpr int kBf16Smem = 1024 + 2 * kPartBytes;
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

__global__ void __launch_bounds__(kBf16Threads, 1)
    allheads_bwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const UnitArgs a) {
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
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* own_empty = own_full + 1;  // the unit's products are issued
  uint64_t* full = own_full + 2;       // a streamed pair landed
  uint64_t* empty = full + kStages;    // the consumer is done with it
  const int first_unit = 2 * blockIdx.x + c;
  const int stride = 2 * gridDim.x;
  if (threadIdx.x == 0 || threadIdx.x == 32) {
    mbar_init(own_full, 1);
    mbar_init(own_empty, 4);  // one arrival a consumer warp
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
        mbar_wait(own_empty, (n & 1) ^ 1);
        mbar_expect_tx(own_full, 2 * kTile);
        tma_load_4d(smem + kOffOwn, own0, own_full, 0, un.h, un.row0, un.b);
        tma_load_4d(smem + kOffOwn + kTile, own1, own_full, 0, un.h, un.row0,
                    un.b);
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
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = (wt >> 5) * 16 + g;  // rows r0 and r0 + 8 of a unit
  uint8_t* own = smem + kOffOwn;
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

    if (un.dq) {
      // ---- dq unit: query rows row0 .. row0 + 63, every K / V tile ----
      const bool live0 = row < a.q_len;
      const bool live1 = row + 8 < a.q_len;
      // lse (+inf past q_len: p = 0 there) and delta * scale of the rows.
      const float lse0 = live0 ? a.lse[row_base + row] : INFINITY;
      const float lse1 = live1 ? a.lse[row_base + row + 8] : INFINITY;
      const float dl0 = live0 ? a.delta[row_base + row] * a.scale : 0.f;
      const float dl1 = live1 ? a.delta[row_base + row + 8] * a.scale : 0.f;
      mbar_wait(own_full, n & 1);
      // q' and dO' in place: the unscaled rows are not needed here.
      scale_pair(own, own, wt, a.qscale, a.doscale);
      fence_proxy_async();
      named_barrier(kWgBar + c, 128);
      float dq[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[i] = 0.f;
      // s = q' . k^T and dp = dO' . v^T (64 rows x 64 keys) of key tile
      // kt + 1 are issued while dq += ds . k of tile kt runs.
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
        if (kt == un.n_tiles - 1 && lane == 0) mbar_arrive(own_empty);
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
      mbar_wait(own_full, n & 1);
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
        if (qt == un.n_tiles - 1 && lane == 0) mbar_arrive(own_empty);

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

// ---------------------------------------------------------------------------
// fp32 CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kF32Block = 64;       // one thread per key or per query row
constexpr int kF32Stream = 16;      // streamed rows per shared tile
constexpr int kPad = kHeadDim + 1;  // conflict-free per-thread rows

// Row `row` of a strided head (zeros past n_valid) into shared memory.
__device__ __forceinline__ void load_row4(float* dst, const float* base,
                                          long long row_stride, int row,
                                          int n_valid, int col) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < n_valid)
    x = *reinterpret_cast<const float4*>(base + row * row_stride + col);
  dst[col] = x.x;
  dst[col + 1] = x.y;
  dst[col + 2] = x.z;
  dst[col + 3] = x.w;
}

struct F32Smem {
  float own_a[kF32Block * kPad];  // k (dk/dv role) or q (dq role) rows
  float own_b[kF32Block * kPad];  // v (dk/dv role) or dO (dq role) rows
  __align__(16) float sa[kF32Stream][kHeadDim];  // streamed q or k rows
  __align__(16) float sb[kF32Stream][kHeadDim];  // streamed dO or v rows
  float sl[kF32Stream];
  float sd[kF32Stream];
};

__global__ void __launch_bounds__(kF32Block) allheads_bwd_f32_kernel(Args a) {
  __shared__ F32Smem sm;
  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const float* qb = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.ks.b + h * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* dob =
      static_cast<const float*>(a.dout) + b * a.dos.b + h * a.dos.h;

  if (static_cast<int>(blockIdx.x) < a.n_key_blocks) {
    // dk/dv role: thread tid owns key key0 + tid.
    const int key0 = blockIdx.x * kF32Block;
    const int key = key0 + tid;
    float dk[kHeadDim], dv[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) dk[d] = dv[d] = 0.f;
    if (key0 < a.kv_len) {
      for (int c = tid; c < kF32Block * kHeadDim / 4; c += kF32Block) {
        const int r = c / (kHeadDim / 4);
        const int col = (c % (kHeadDim / 4)) * 4;
        load_row4(sm.own_a + r * kPad, kb, a.ks.s, key0 + r, a.kv_len, col);
        load_row4(sm.own_b + r * kPad, vb, a.vs.s, key0 + r, a.kv_len, col);
      }
      // The own rows and the streamed rows are read from shared memory at
      // each use (volatile): held in registers they would take 128 more
      // beside dk and dv, and spill.
      const volatile float* mk = sm.own_a + tid * kPad;
      const volatile float* mv = sm.own_b + tid * kPad;
      const bool live = key < a.kv_len;
      for (int q0 = 0; q0 < a.q_len; q0 += kF32Stream) {
        __syncthreads();  // the previous tile is consumed (and own rows ready)
        for (int c = tid; c < kF32Stream * kHeadDim / 4; c += kF32Block) {
          const int r = c / (kHeadDim / 4);
          const int col = (c % (kHeadDim / 4)) * 4;
          load_row4(sm.sa[r], qb, a.qs.s, q0 + r, a.q_len, col);
          load_row4(sm.sb[r], dob, a.dos.s, q0 + r, a.q_len, col);
        }
        if (tid < kF32Stream) {
          const int r = q0 + tid;
          sm.sl[tid] = r < a.q_len ? a.lse[bh * a.Sq + r] : INFINITY;
          sm.sd[tid] = r < a.q_len ? a.delta[bh * a.Sq + r] : 0.f;
        }
        __syncthreads();
        for (int j = 0; j < kF32Stream; ++j) {
          const volatile float* qj = sm.sa[j];
          const volatile float* doj = sm.sb[j];
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int d = 0; d < kHeadDim; ++d) {
            s = fmaf(qj[d] * a.qscale, mk[d], s);
            dp = fmaf(doj[d] * a.doscale, mv[d], dp);
          }
          const float p = live ? exp2f(s - sm.sl[j]) : 0.f;
          const float ds = p * (dp - sm.sd[j] * a.scale);
#pragma unroll
          for (int d = 0; d < kHeadDim; ++d) {
            dv[d] = fmaf(p, doj[d], dv[d]);
            dk[d] = fmaf(ds, qj[d], dk[d]);
          }
        }
      }
    }
    if (key < a.Sk) {
      const long long off =
          ((static_cast<long long>(b) * a.Sk + key) * a.H + h) * kHeadDim;
      float* dkp = static_cast<float*>(a.dk) + off;
      float* dvp = static_cast<float*>(a.dv) + off;
#pragma unroll
      for (int d = 0; d < kHeadDim; d += 4) {
        *reinterpret_cast<float4*>(dkp + d) =
            make_float4(dk[d], dk[d + 1], dk[d + 2], dk[d + 3]);
        *reinterpret_cast<float4*>(dvp + d) =
            make_float4(dv[d], dv[d + 1], dv[d + 2], dv[d + 3]);
      }
    }
    return;
  }

  // dq role: thread tid owns query row q0 + tid.
  const int q0 = (blockIdx.x - a.n_key_blocks) * kF32Block;
  const int row = q0 + tid;
  const bool live_row = row < a.q_len;
  float dq[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) dq[d] = 0.f;
  if (q0 < a.q_len) {
    for (int c = tid; c < kF32Block * kHeadDim / 4; c += kF32Block) {
      const int r = c / (kHeadDim / 4);
      const int col = (c % (kHeadDim / 4)) * 4;
      load_row4(sm.own_a + r * kPad, qb, a.qs.s, q0 + r, a.q_len, col);
      load_row4(sm.own_b + r * kPad, dob, a.dos.s, q0 + r, a.q_len, col);
    }
    const volatile float* mq = sm.own_a + tid * kPad;  // as above
    const volatile float* mdo = sm.own_b + tid * kPad;
    const float lse = live_row ? a.lse[bh * a.Sq + row] : INFINITY;
    const float dlt = live_row ? a.delta[bh * a.Sq + row] * a.scale : 0.f;
    for (int k0 = 0; k0 < a.kv_len; k0 += kF32Stream) {
      __syncthreads();  // the previous tile is consumed (and own rows ready)
      for (int c = tid; c < kF32Stream * kHeadDim / 4; c += kF32Block) {
        const int r = c / (kHeadDim / 4);
        const int col = (c % (kHeadDim / 4)) * 4;
        load_row4(sm.sa[r], kb, a.ks.s, k0 + r, a.kv_len, col);
        load_row4(sm.sb[r], vb, a.vs.s, k0 + r, a.kv_len, col);
      }
      __syncthreads();
      const int n = min(kF32Stream, a.kv_len - k0);
      for (int j = 0; j < n; ++j) {
        const volatile float* kj = sm.sa[j];
        const volatile float* vj = sm.sb[j];
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) {
          s = fmaf(mq[d] * a.qscale, kj[d], s);
          dp = fmaf(mdo[d] * a.doscale, vj[d], dp);
        }
        const float ds = exp2f(s - lse) * (dp - dlt);
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) dq[d] = fmaf(ds, kj[d], dq[d]);
      }
    }
  }
  if (row < a.Sq) {
    float* dqp = static_cast<float*>(a.dq) +
                 ((static_cast<long long>(b) * a.Sq + row) * a.H + h) * kHeadDim;
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 4)
      *reinterpret_cast<float4*>(dqp + d) =
          make_float4(dq[d], dq[d + 1], dq[d + 2], dq[d + 3]);
  }
}


}  // namespace

// Launches the backward on `stream` and returns the launch's cudaError_t
// (0 on success). is_bf16: 1 for bf16 inputs and outputs, 0 for fp32. dq
// ([batch, seq_q, heads, 64]), dk and dv ([batch, seq_k, heads, 64]) are
// contiguous and written whole. Keys at or past kv_len (<= seq_k) and query
// rows at or past q_len (<= seq_q) are masked. Strides are in elements, in
// the (batch, row, head) order of the model's [B, S, H, 64] layout; every
// pointer and stride must keep 16-byte alignment and head_dim must be 64
// (the Python wrapper checks both). tma: for bf16, the tensor-map specs
// (hopper.cuh) of q, k, v and dO, in that order, 16 int64 each (boxes of
// 64 rows of one head); unused for fp32.
extern "C" int flash_attn_allheads_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    int is_bf16, int batch, int seq_q, int seq_k, int heads, int head_dim,
    int kv_len, int q_len, float qscale, float doscale, float scale,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long do_sb, long long do_ss, long long do_sh,
    const long long* tma, void* stream) {
  if (head_dim != kHeadDim || kv_len < 1 || kv_len > seq_k || q_len < 1 ||
      q_len > seq_q)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
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
    // The role whose units walk more tiles first: a dq unit walks the
    // key tiles, a dkv unit the query tiles.
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
      err = cudaFuncSetAttribute(allheads_bwd_bf16_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kBf16Smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // A persistent grid: two units a block at a time, at most one block a
    // multiprocessor.
    const long long pairs = (n_units + 1) / 2;
    const int grid = static_cast<int>(pairs < n_sm ? pairs : n_sm);
    allheads_bwd_bf16_kernel<<<grid, kBf16Threads, kBf16Smem, st>>>(
        maps[0], maps[1], maps[2], maps[3], ua);
  } else {
    const int n_key_blocks = (seq_k + kF32Block - 1) / kF32Block;
    const int n_q_blocks = (seq_q + kF32Block - 1) / kF32Block;
    Args a{q,      k,       v,      dout,         lse,     delta,
           dq,     dk,      dv,     seq_q,        seq_k,   heads,
           kv_len, q_len,   n_key_blocks, qscale, doscale, scale,
           {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
           {v_sb, v_ss, v_sh}, {do_sb, do_ss, do_sh}};
    const dim3 grid(n_key_blocks + n_q_blocks, heads, batch);
    allheads_bwd_f32_kernel<<<grid, kF32Block, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by flash_attn_allheads_bwd.
extern "C" const char* flash_attn_allheads_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
