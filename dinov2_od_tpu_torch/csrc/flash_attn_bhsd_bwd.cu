// Flash-attention backward over [B, H, S, 64] heads for Hopper (sm_90a),
// plain C interface: one fused pass, dq summed by bulk reduce-adds.
//
// Replaces dinov2_od_tpu/ops/flash_attention.py:_dkv_kernel (B5b), the
// Pallas TPU kernel that the adapted ViT blocks' self-attention runs in
// the train step's backward once the sequence is too long for the flat
// kernel (ViT-L/14 at 560 px: 1601 tokens), and that Sq != Sk and unpaired
// head counts take at any length.
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
//   dq  = ds(dt) . k                         fp32 sum into a scratch
// dt is the input type (bf16 or fp32). Keys at or past kv_len get p = 0,
// so their dk and dv are exactly 0. q and dO are read as [B, H, Sq, 64],
// k and v as [B, H, Sk, 64], through arbitrary batch, head and row
// strides (the last dim contiguous), so the forward's three slices of the
// fused qkv GEMM output are read in place; lse and delta are contiguous
// [B, H, Sq] fp32; dk and dv are contiguous [B, Sk, H, 64] in dt; dq is
// added into a zeroed contiguous fp32 [B, Sq, H, 64] scratch, which the
// wrapper casts to dt once.
//
// What bounds it on an H100 at ViT-L/560, batch 8 (B=8, H=16, S=1601,
// bf16): operations. The five products are 10*B*H*S^2*64 = 210 GFLOP,
// 212 us at 989 TFLOP/s; the bytes (q, k, v, dO read, dk, dv written, lse
// and delta, the fp32 dq scratch written and read once) are ~290 MB,
// 86 us at 3.35 TB/s. Beside the products, the dq partial sums that cross
// key tiles are added in L2: 26 shares of 52 MB at that shape.
//
// Design (FlashAttention-3's backward, https://arxiv.org/abs/2407.08608,
// section 3). The TPU kernel walks its key blocks in order and carries dq
// in a revisited fp32 output across them. Hopper's blocks run in no order,
// so one block per (128-key tile, head, batch) loops over all 64-row q
// tiles itself:
// - a producer warp brings the block's k and v tiles once and then q and
//   dO tiles through a 3-stage mbarrier ring, by TMA (4-D tensor maps over
//   [B, S, H, 64] with the real strides, 128-byte swizzle; rows out of
//   bounds read as zeros, the masks stay explicit);
// - three more warps of its warpgroup scale each landed tile into a second
//   copy, q' = bf(q * bf(scale*log2e)) and dO' = bf(dO * bf(scale)), the
//   contract's rounding (a wgmma reading the TMA'd tile could not round),
//   and stage the tile's lse and delta, loaded a tile ahead;
// - two consumer warpgroups own 64 keys each and run independently:
//   s^T = k . q'^T and dp^T = v . dO'^T by wgmma with both operands in
//   shared memory, p^T and ds^T in registers, dv += p^T . dO and
//   dk += ds^T . q by wgmma with A from registers and B MN-major (the
//   transpose bit), ds^T into shared memory as bf16, and the warpgroup's
//   dq share ds . k over its 64 keys (both operands MN-major) in the same
//   group; the 64 x 64 fp32 share goes through a swizzled staging tile
//   (double-buffered) into the scratch by bulk tensor reduce-adds, each
//   warp's 16 rows its own, where per-thread float2 atomics took 4096
//   adds a tile;
// - setmaxnreg gives the consumers 216 registers, the producer warpgroup
//   72; dk and dv stay in registers and are stored once.
// Each warpgroup adding its own share doubles the reduce traffic (26
// partial sums of each dq element at 1601 keys), but summing the two
// shares in shared memory first, behind a barrier of both warpgroups,
// measured slower on an H100. The reduce-adds land in an order that
// changes from run to run, so dq differs between runs in its last fp32
// bits, and after the cast to bf16 an element may round to the
// neighbouring value; dk and dv are deterministic. fp32 inputs take a
// CUDA-core kernel (one thread per key; the dq share summed through shared
// memory, one thread per head dim), since the tensor cores would round to
// tf32.

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
  float* dq;  // zeroed fp32 [B, Sq, H, 64] scratch, added into
  void* dk;
  void* dv;
  int Sq, Sk, H, kv_len, q_len;
  float qscale;   // bf(scale * log2 e), q's multiplier in s
  float doscale;  // scale in the input type, dO's multiplier in dp
  float scale;    // scale in fp32, delta's multiplier in ds
  Strides qs, ks, vs, dos;
};

// ---------------------------------------------------------------------------
// bf16 kernel: TMA, wgmma, one producer and two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kKeys = 128;  // keys per block, 64 per consumer warpgroup
constexpr int kTileQ = 64;  // rows of a streamed q / dO tile
constexpr int kStages = 3;  // the q / dO ring
constexpr int kRowBytes = kHeadDim * 2;         // 128: one swizzled row
constexpr int kQTile = kTileQ * kRowBytes;      // 8 KB
constexpr int kKTile = kKeys * kRowBytes;       // 16 KB
constexpr int kDsTile = 64 * kRowBytes;         // 8 KB: 64 keys x 64 q
constexpr int kDqTile = kTileQ * kHeadDim * 4;  // 16 KB of fp32
constexpr int kBf16Threads = 3 * 128;
constexpr int kScalers = 96;  // warps 1-3 of the producer warpgroup
// setmaxnreg's split, 2 x 216 + 72 = 504 a thread triple of 512: the
// scaling warps spill below 72, the consumers need no more than 216.
constexpr int kConsumerRegs = 216;
constexpr int kProducerRegs = 72;

// Shared memory, from a 1024-byte boundary: k, v; per stage q, dO and
// their scaled copies q', dO'; per consumer warpgroup its ds^T tile and
// its two fp32 dq staging tiles; per stage the lse and delta of the q
// tile; the barriers.
constexpr int kOffK = 0;
constexpr int kOffV = kOffK + kKTile;
constexpr int kOffStage = kOffV + kKTile;
constexpr int kStageBytes = 4 * kQTile;
constexpr int kOffDS = kOffStage + kStages * kStageBytes;
constexpr int kOffDQ = kOffDS + 2 * kDsTile;
constexpr int kOffStats = kOffDQ + 4 * kDqTile;
constexpr int kOffBar = kOffStats + kStages * 2 * kTileQ * 4;
constexpr int kNumBars = 1 + 3 * kStages;
constexpr int kBf16Smem = 1024 + kOffBar + kNumBars * 8;

struct TileArgs {
  const float* lse;
  const float* delta;
  bf16* dk;
  bf16* dv;
  int Sq, Sk, H, kv_len, q_len;
  float qscale, doscale, scale;
};

__global__ void __launch_bounds__(kBf16Threads, 1)
    bhsd_bwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const __grid_constant__ CUtensorMap dq_map,
                         const TileArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + kOffBar);
  uint64_t* full = kv_full + 1;         // q and dO landed
  uint64_t* scaled = full + kStages;    // q', dO', lse and delta written
  uint64_t* empty = scaled + kStages;   // both consumers are done
  const int key0 = blockIdx.x * kKeys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int wg = threadIdx.x >> 7;
  const int wt = threadIdx.x & 127;
  const int lane = wt & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int lrow = wg * 64 + (wt >> 5) * 16 + g;  // rows lrow, lrow + 8
  const int krow = key0 + lrow;

  if (key0 >= a.kv_len) {  // a tile of masked keys only: dk = dv = 0
    if (wg < 2) {
      float zero[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) zero[i] = 0.f;
      store_acc_rows(a.dk, zero, krow, a.Sk, a.H, h, b, t);
      store_acc_rows(a.dv, zero, krow, a.Sk, a.H, h, b, t);
    }
    return;
  }
  const int n_qt = (a.q_len + kTileQ - 1) / kTileQ;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&scaled[s], kScalers);
      mbar_init(&empty[s], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer warpgroup ----
    regs_dealloc<kProducerRegs>();
    if (wt < 32) {  // TMA, one thread
      if (wt == 0) {
        mbar_expect_tx(kv_full, 2 * kKTile);
        tma_load_4d(smem + kOffK, &k_map, kv_full, 0, h, key0, b);
        tma_load_4d(smem + kOffV, &v_map, kv_full, 0, h, key0, b);
        for (int qt = 0; qt < n_qt; ++qt) {
          const int s = qt % kStages;
          mbar_wait(&empty[s], ((qt / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * kQTile);
          uint8_t* st = smem + kOffStage + s * kStageBytes;
          tma_load_4d(st, &q_map, &full[s], 0, h, qt * kTileQ, b);
          tma_load_4d(st + kQTile, &do_map, &full[s], 0, h, qt * kTileQ, b);
        }
      }
    } else {  // the scaled copies and the row statistics
      const int i0 = wt - 32;  // 0 .. 95
      const long long row0 = (static_cast<long long>(b) * a.H + h) * a.Sq;
      // Row i0 (< 64) of a q tile: its lse (+inf past q_len: p = 0 there)
      // and delta, loaded a tile ahead so their latency hides behind the
      // previous tile.
      float l_next = INFINITY, d_next = 0.f;
      if (i0 < kTileQ && i0 < a.q_len) {
        l_next = a.lse[row0 + i0];
        d_next = a.delta[row0 + i0];
      }
      for (int qt = 0; qt < n_qt; ++qt) {
        const int s = qt % kStages;
        const float l = l_next, d = d_next;
        const int r = (qt + 1) * kTileQ + i0;
        l_next = INFINITY;
        d_next = 0.f;
        if (i0 < kTileQ && r < a.q_len) {
          l_next = a.lse[row0 + r];
          d_next = a.delta[row0 + r];
        }
        mbar_wait(&full[s], (qt / kStages) & 1);
        uint8_t* st = smem + kOffStage + s * kStageBytes;
        // q then dO, into q' then dO', two 16-byte loads in flight a
        // thread: the scaling is elementwise, so the copies keep TMA's
        // swizzled layout.
        const uint4* src = reinterpret_cast<const uint4*>(st);
        uint4* dst = reinterpret_cast<uint4*>(st + 2 * kQTile);
        constexpr int kVecs = 2 * kQTile / 16;
#pragma unroll
        for (int base = 0; base < kVecs; base += 2 * kScalers) {
          uint4 v[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i = base + u * kScalers + i0;
            if (i < kVecs) v[u] = src[i];
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i = base + u * kScalers + i0;
            if (i < kVecs)
              dst[i] = scaled8(v[u], i < kVecs / 2 ? a.qscale : a.doscale);
          }
        }
        float* stats = reinterpret_cast<float*>(smem + kOffStats) +
                       s * 2 * kTileQ;
        if (i0 < kTileQ) {
          stats[i0] = l;
          stats[kTileQ + i0] = d;
        }
        fence_proxy_async();
        mbar_arrive(&scaled[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroups: keys key0 + 64 wg .. + 63 ----
  regs_alloc<kConsumerRegs>();
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  // This warpgroup's k and v rows: K-major A operands of s^T and dp^T,
  // and k as the MN-major B operand of its dq share.
  const uint8_t* my_k = smem + kOffK + wg * 64 * kRowBytes;
  const uint8_t* my_v = smem + kOffV + wg * 64 * kRowBytes;
  const uint64_t k_desc = desc_sw128(my_k, 16, 1024);
  const uint64_t v_desc = desc_sw128(my_v, 16, 1024);
  const uint64_t kb_desc = desc_sw128(my_k, 1024, 1024);
  uint8_t* sds = smem + kOffDS + wg * kDsTile;
  const uint64_t ds_desc = desc_sw128(sds, 1024, 1024);
  uint8_t* sdq = smem + kOffDQ + wg * 2 * kDqTile;  // two staging tiles
  const int bar_id = 2 + wg;  // this warpgroup's named barrier
  const int r0 = (wt >> 5) * 16 + g;  // rows r0 and r0 + 8 of 64
  const bool mask0 = krow >= a.kv_len;
  const bool mask1 = krow + 8 >= a.kv_len;
  mbar_wait(kv_full, 0);

  for (int qt = 0; qt < n_qt; ++qt) {
    const int s = qt % kStages;
    const uint32_t parity = (qt / kStages) & 1;
    mbar_wait(&full[s], parity);
    mbar_wait(&scaled[s], parity);
    const uint8_t* st = smem + kOffStage + s * kStageBytes;
    const float* lse = reinterpret_cast<const float*>(smem + kOffStats) +
                       s * 2 * kTileQ;
    const float* dlt = lse + kTileQ;
    // s^T = k . q'^T and dp^T = v . dO'^T: 64 keys x 64 queries, both
    // operands K-major.
    float sT[32], dpT[32];
    const uint64_t qs_desc = desc_sw128(st + 2 * kQTile, 16, 1024);
    const uint64_t dos_desc = desc_sw128(st + 3 * kQTile, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 head dims = 32 bytes a step
      wgmma_bf16_ss<0, 0>(sT, k_desc + 2 * kk, qs_desc + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16_ss<0, 0>(dpT, v_desc + 2 * kk, dos_desc + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sT);
    fence_regs(dpT);

    // p^T and ds^T as bf16 A fragments: k-step kk takes accumulator
    // columns 16kk .. 16kk + 15, i.e. elements 8kk .. 8kk + 7.
    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float d0 = dlt[c] * a.scale;
      const float d1 = dlt[c + 1] * a.scale;
      const float p0 = mask0 ? 0.f : exp2f(sT[4 * j] - lse[c]);
      const float p1 = mask0 ? 0.f : exp2f(sT[4 * j + 1] - lse[c + 1]);
      const float p2 = mask1 ? 0.f : exp2f(sT[4 * j + 2] - lse[c]);
      const float p3 = mask1 ? 0.f : exp2f(sT[4 * j + 3] - lse[c + 1]);
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      dsf[j >> 1][(j & 1) * 2] =
          pack_bf16(p0 * (dpT[4 * j] - d0), p1 * (dpT[4 * j + 1] - d1));
      dsf[j >> 1][(j & 1) * 2 + 1] =
          pack_bf16(p2 * (dpT[4 * j + 2] - d0), p3 * (dpT[4 * j + 3] - d1));
    }

    // dv += p^T . dO and dk += ds^T . q: B MN-major, 16 q rows a step.
    const uint64_t q_desc = desc_sw128(st, 1024, 1024);
    const uint64_t do_desc = desc_sw128(st + kQTile, 1024, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16_rs<1>(dv, pf[kk], do_desc + 128 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16_rs<1>(dk, dsf[kk], q_desc + 128 * kk, 1);

    // ds^T (64 keys x 64 queries) into shared memory, swizzled as TMA
    // writes a tile (16-byte chunk j of row r at chunk j ^ (r & 7)), then
    // this warpgroup's dq share, ds . k over its 64 keys (both operands
    // MN-major), in the same group as dv and dk.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int chunk = ((j ^ g) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(sds + r0 * kRowBytes + chunk) =
          dsf[j >> 1][(j & 1) * 2];
      *reinterpret_cast<uint32_t*>(sds + (r0 + 8) * kRowBytes + chunk) =
          dsf[j >> 1][(j & 1) * 2 + 1];
    }
    fence_proxy_async();
    named_barrier(bar_id, 128);
    float dq[32];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16_ss<1, 1>(dq, ds_desc + 128 * kk, kb_desc + 128 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(dk);
    fence_regs(dv);
    if (wt == 0) mbar_arrive(&empty[s]);  // q, dO, q', dO' are read

    // The 64 x 64 fp32 share into a staging tile, as two 64 x 32 halves
    // in the 128-byte swizzle (conflict-free stores), then bulk
    // reduce-adds into the scratch: each warp stages and adds its own 16
    // rows, so only warp-level syncs are needed. Two staging tiles per
    // warpgroup, by q-tile parity, so the reduce of the last tile can
    // still be reading the other.
    uint8_t* stage_dq = sdq + (qt & 1) * kDqTile;
    const int w16 = (wt >> 5) * 16;
    if (lane == 0) bulk_wait_read<1>();  // its reduce of two tiles ago
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int half = (j >> 2) * (kDqTile / 2);
      const int chunk = 2 * (j & 3) + (t >> 1);
      const int off = half + (((chunk ^ g) << 4) | ((t & 1) << 3));
      *reinterpret_cast<float2*>(stage_dq + r0 * 128 + off) =
          make_float2(dq[4 * j], dq[4 * j + 1]);
      *reinterpret_cast<float2*>(stage_dq + (r0 + 8) * 128 + off) =
          make_float2(dq[4 * j + 2], dq[4 * j + 3]);
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      tma_reduce_add_4d(&dq_map, stage_dq + w16 * 128, 0, h,
                        qt * kTileQ + w16, b);
      tma_reduce_add_4d(&dq_map, stage_dq + kDqTile / 2 + w16 * 128, 32, h,
                        qt * kTileQ + w16, b);
      bulk_commit();
    }
  }
  if (lane == 0) bulk_wait<0>();
  store_acc_rows(a.dk, dk, krow, a.Sk, a.H, h, b, t);
  store_acc_rows(a.dv, dv, krow, a.Sk, a.H, h, b, t);
}

// ---------------------------------------------------------------------------
// fp32 CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kF32Keys = 64;        // one thread per key, then per head dim
constexpr int kF32Stream = 16;      // streamed q rows per shared tile
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

__global__ void __launch_bounds__(kF32Keys) bhsd_bwd_f32_kernel(Args a) {
  __shared__ float sK[kF32Keys * kPad];
  __shared__ float sV[kF32Keys * kPad];
  __shared__ __align__(16) float sQ[kF32Stream][kHeadDim];
  __shared__ __align__(16) float sDO[kF32Stream][kHeadDim];
  __shared__ float sL[kF32Stream];
  __shared__ float sD[kF32Stream];
  __shared__ float sDS[kF32Stream][kF32Keys + 1];

  const int tid = threadIdx.x;
  const int key0 = blockIdx.x * kF32Keys;
  const int key = key0 + tid;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const float* qb = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.ks.b + h * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* dob =
      static_cast<const float*>(a.dout) + b * a.dos.b + h * a.dos.h;

  float dk[kHeadDim], dv[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) dk[d] = dv[d] = 0.f;

  if (key0 < a.kv_len) {
    for (int c = tid; c < kF32Keys * kHeadDim / 4; c += kF32Keys) {
      const int r = c / (kHeadDim / 4);
      const int col = (c % (kHeadDim / 4)) * 4;
      load_row4(sK + r * kPad, kb, a.ks.s, key0 + r, a.kv_len, col);
      load_row4(sV + r * kPad, vb, a.vs.s, key0 + r, a.kv_len, col);
    }
    // k, v and the q / dO rows are read from shared memory at each use
    // (volatile): held in registers they would take 128 more beside dk
    // and dv, and spill.
    const volatile float* mk = sK + tid * kPad;
    const volatile float* mv = sV + tid * kPad;
    const bool live = key < a.kv_len;
    for (int q0 = 0; q0 < a.q_len; q0 += kF32Stream) {
      __syncthreads();  // the previous tile is consumed (and sK/sV ready)
      for (int c = tid; c < kF32Stream * kHeadDim / 4; c += kF32Keys) {
        const int r = c / (kHeadDim / 4);
        const int col = (c % (kHeadDim / 4)) * 4;
        load_row4(sQ[r], qb, a.qs.s, q0 + r, a.q_len, col);
        load_row4(sDO[r], dob, a.dos.s, q0 + r, a.q_len, col);
      }
      if (tid < kF32Stream) {
        const int r = q0 + tid;
        sL[tid] = r < a.q_len ? a.lse[bh * a.Sq + r] : INFINITY;
        sD[tid] = r < a.q_len ? a.delta[bh * a.Sq + r] : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < kF32Stream; ++j) {
        const volatile float* qj = sQ[j];
        const volatile float* doj = sDO[j];
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) {
          s = fmaf(qj[d] * a.qscale, mk[d], s);
          dp = fmaf(doj[d] * a.doscale, mv[d], dp);
        }
        const float p = live ? exp2f(s - sL[j]) : 0.f;
        const float ds = p * (dp - sD[j] * a.scale);
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) {
          dv[d] = fmaf(p, doj[d], dv[d]);
          dk[d] = fmaf(ds, qj[d], dk[d]);
        }
        sDS[j][tid] = ds;
      }
      __syncthreads();
      // This tile's dq share, thread tid on head dim tid.
      const int n = min(kF32Stream, a.q_len - q0);
      for (int j = 0; j < n; ++j) {
        float acc = 0.f;
#pragma unroll 8
        for (int kk = 0; kk < kF32Keys; ++kk)
          acc = fmaf(sDS[j][kk], sK[kk * kPad + tid], acc);
        atomicAdd(a.dq + ((static_cast<long long>(b) * a.Sq + q0 + j) * a.H + h) *
                             kHeadDim + tid,
                  acc);
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
}

}  // namespace

// Launches the backward on `stream` and returns the launch's cudaError_t
// (0 on success). is_bf16: 1 for bf16 inputs and dk/dv, 0 for fp32. dq is
// a zeroed fp32 [batch, seq_q, heads, 64] buffer the kernel adds into.
// Keys at or past kv_len (<= seq_k) and query rows at or past q_len
// (<= seq_q) are masked. Strides are in elements, in the (batch, row,
// head) order of the model's [B, S, H, 64] layout; every pointer and
// stride must keep 16-byte alignment and head_dim must be 64 (the Python
// wrapper checks both). tma: for bf16, the tensor-map specs (hopper.cuh)
// of q, k, v, dO and the dq scratch, in that order, 16 int64 each (boxes
// of 64, 128, 128 and 64 rows of one head, and 16 rows of 32 head dims of
// the scratch); unused for fp32.
extern "C" int flash_attn_bhsd_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse,
                                   const float* delta, float* dq, void* dk,
                                   void* dv, int is_bf16, int batch, int seq_q,
                                   int seq_k, int heads, int head_dim,
                                   int kv_len, int q_len, float qscale,
                                   float doscale, float scale, long long q_sb,
                                   long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss,
                                   long long k_sh, long long v_sb,
                                   long long v_ss, long long v_sh,
                                   long long do_sb, long long do_ss,
                                   long long do_sh, const long long* tma,
                                   void* stream) {
  if (head_dim != kHeadDim || kv_len < 1 || kv_len > seq_k || q_len < 1 ||
      q_len > seq_q)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (tma == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap maps[5];
    const void* ptrs[4] = {q, k, v, dout};
    for (int i = 0; i < 4; ++i) {
      const int rc = encode_tensor_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                       ptrs[i], tma + i * kSpecLen,
                                       CU_TENSOR_MAP_SWIZZLE_128B);
      if (rc) return rc;
    }
    const int rc = encode_tensor_map(&maps[4], CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                     dq, tma + 4 * kSpecLen,
                                     CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc) return rc;
    const TileArgs ta{lse,    delta,  static_cast<bf16*>(dk),
                      static_cast<bf16*>(dv), seq_q, seq_k, heads, kv_len,
                      q_len,  qscale, doscale, scale};
    cudaError_t err = cudaFuncSetAttribute(
        bhsd_bwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBf16Smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((seq_k + kKeys - 1) / kKeys, heads, batch);
    bhsd_bwd_bf16_kernel<<<grid, kBf16Threads, kBf16Smem, st>>>(
        maps[0], maps[1], maps[2], maps[3], maps[4], ta);
  } else {
    Args a{q,      k,      v,      dout,   lse,     delta,
           dq,     dk,     dv,     seq_q,  seq_k,   heads,
           kv_len, q_len,  qscale, doscale, scale,
           {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
           {v_sb, v_ss, v_sh}, {do_sb, do_ss, do_sh}};
    const dim3 grid((seq_k + kF32Keys - 1) / kF32Keys, heads, batch);
    bhsd_bwd_f32_kernel<<<grid, kF32Keys, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by flash_attn_bhsd_bwd.
extern "C" const char* flash_attn_bhsd_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
