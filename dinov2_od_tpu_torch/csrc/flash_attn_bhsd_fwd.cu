// Flash-attention forward over [B, H, S, 64] heads for Hopper (sm_90a),
// plain C interface: long sequences and Sq != Sk.
//
// Replaces dinov2_od_tpu/ops/flash_attention.py:_fwd_kernel (B5f), the
// Pallas TPU kernel that every ViT block's self-attention runs once the
// sequence is too long for the flat kernel (ViT-L/14 at 560 px: 1601
// tokens), and that Sq != Sk and unpaired head counts take at any length.
//
// What it computes, per (batch, head):
//   s   = (q * bf(scale*log2e)) . k^T   in fp32, keys >= kv_len set to -1e30
//   p   = exp2(s - rowmax(s)), rounded to the input type
//   l   = rowsum(p)                      (from the rounded p, fp32 sum)
//   o   = (p . v) / l                    (fp32 accumulation, stored in the input type)
//   lse = rowmax(s) + log2(l)            (log2 space, fp32, stored [B, H, Sq])
// q is read as [B, H, Sq, 64] and k, v as [B, H, Sk, 64] through arbitrary
// batch, head and row strides (the last dim contiguous), so the three
// slices of the fused qkv GEMM output, in the model's [B, S, H, 64]
// layout, are read in place. o is a contiguous [B, Sq, H, 64]. The kernel
// masks its own ragged q and k edges: nothing outside pads.
//
// What bounds it on an H100 at ViT-L/560, batch 8 (B=8, H=16, S=1601,
// bf16): operations. The two products are 4*B*H*S^2*64 = 84.0 GFLOP,
// 85 us at 989 TFLOP/s; q, k, v and o are 105 MB, 31 us at 3.35 TB/s.
// A second floor of the same size: the 8*16*1601^2 = 328 M exponentials,
// at 16 a clock on each of 132 SMs (the SFU), take about 88 us at 1.75 GHz.
// So the exponentials of one warpgroup have to run under the products of
// another, or the two floors add up.
//
// What cannot carry over from the TPU: `_fwd_kernel` stages the whole K/V
// of one head in VMEM (404 KiB at 1616 tokens in bf16) and takes one
// 816-row q block; a Hopper block has 227 KB of shared memory. So K/V
// tiles stream through shared memory with an online softmax (running max
// and sum in fp32 registers), and the [Sq, Sk] logits never leave
// registers.
//
// Design (FlashAttention-3's forward, https://arxiv.org/abs/2407.08608,
// sections 3.1-3.2): a persistent grid, one block a streaming
// multiprocessor, walks the (128-query tile, head, batch) tiles:
// - a producer warp brings each tile's q rows once (two buffers, so the
//   next tile's q lands while this one runs) and 128-key K and V tiles
//   through a 3-stage mbarrier ring, by TMA (4-D tensor maps over
//   [B, S, H, 64] with the real strides, 128-byte swizzle; rows out of
//   bounds read as zeros, the key mask stays explicit);
// - two consumer warpgroups own 64 query rows each. Each scales its rows
//   to q' = bf(q * bf(scale*log2e)) in place once, then per K/V tile
//   issues s = q' . k^T (wgmma m64n128k16, both operands in shared
//   memory, k K-major) and, in a second group, the previous tile's
//   o += p . v (wgmma m64n72k16 with p as the A operand from registers,
//   the accumulator's layout being the A fragment's, v MN-major through
//   the transpose bit); the softmax of this tile (mask, running max, p
//   rounded to bf16) runs while that product is in flight, and o is
//   rescaled once it has landed, by a warp whose rows' max moved;
// - l comes out of the p . v product: B's columns 64 .. 71 are a tile of
//   ones, so the tensor cores sum each row of the rounded p in fp32, which
//   takes two instructions an element (unpacking p, adding) off the
//   softmax;
// - the two warpgroups take turns to issue their products (two named
//   barriers, "ping-pong"), so one's exponentials run under the other's
//   products;
// - the loop is peeled (first tile, middle tiles, last p . v) and p's
//   fragments move to the product's registers only after it has landed,
//   so that ptxas sees fixed wgmma groups and serialises none of them;
// - setmaxnreg gives the consumers 232 registers and the producer
//   warpgroup 40 (ptxas fits the consumers in the 168 that 384 threads a
//   multiprocessor leave, without spills).
// fp32 route: the tensor cores would round to tf32, so fp32 inputs take a
// CUDA-core kernel with one thread per query row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kHeadDim = 64;
constexpr float kMaskedLogit = -1e30f;  // masked keys; keeps a row finite

struct Strides {
  long long b, s, h;  // element strides of batch, row and head
};

// ---------------------------------------------------------------------------
// bf16 kernel: TMA, wgmma, a producer warp and two consumer warpgroups
// ---------------------------------------------------------------------------

constexpr int kTileQ = 128;  // query rows a tile, 64 per consumer warpgroup
constexpr int kTileK = 128;  // keys a K / V tile
constexpr int kStages = 3;   // the K / V ring
constexpr int kRowBytes = kHeadDim * 2;      // 128: one swizzled row
constexpr int kQBytes = kTileQ * kRowBytes;  // 16 KB
constexpr int kKBytes = kTileK * kRowBytes;  // 16 KB
constexpr int kThreads = 3 * 128;
// setmaxnreg's split, 2 x 232 + 40 = 504 a thread triple of 3 x 168.
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;

// Shared memory, from a 1024-byte boundary: two q tiles (this one and the
// next); per stage a K and a V tile; a tile of ones; the barriers.
constexpr int kOffQ = 0;
constexpr int kOffStage = kOffQ + 2 * kQBytes;
constexpr int kStageBytes = 2 * kKBytes;
constexpr int kOffOnes = kOffStage + kStages * kStageBytes;
constexpr int kOffBar = kOffOnes + kKBytes;
constexpr int kNumBars = 4 + 2 * kStages;
constexpr int kBf16Smem = 1024 + kOffBar + kNumBars * 8;
// Named barriers (0 is __syncthreads'): consumer c's turn to issue is
// kTurnBar + c (both consumers, 256 threads); kWgBar + c is consumer c's
// warpgroup alone.
constexpr int kTurnBar = 1;
constexpr int kWgBar = 3;

struct TileArgs {
  bf16* o;
  float* lse;
  int Sq, H, kv_len;
  int n_qt;     // query tiles of a head
  int n_tiles;  // n_qt * H * B
  float qscale;
};

// Consumer c waits for its turn to issue products, and hands the turn to
// the other consumer ("ping-pong", FlashAttention-3 section 3.1), so that
// one's softmax runs under the other's products.
__device__ __forceinline__ void turn_wait(int c) {
  named_barrier(kTurnBar + c, 256);
}

__device__ __forceinline__ void turn_pass(int c) {
  named_barrier_arrive(kTurnBar + (c ^ 1), 256);
}

__device__ __forceinline__ const uint8_t* stage_of(const uint8_t* smem,
                                                   int it) {
  return smem + kOffStage + (it % kStages) * kStageBytes;
}

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

// acc += p . [v | 1] over one V tile (p from registers, v MN-major, 16
// keys = 2048 bytes a step), one group: columns 64 .. 71 of B are the
// ones tile (`ones`, the same swizzled layout), so acc's columns 64 .. 71
// sum each row of the rounded p in fp32, the l of the contract.
__device__ __forceinline__ void issue_pv(float (&acc)[36],
                                         const uint32_t (&pf)[8][4],
                                         const uint8_t* sv,
                                         const uint8_t* ones) {
  const uint64_t v_desc = desc_sw128(
      sv, static_cast<uint32_t>(smem_u32(ones) - smem_u32(sv)), 1024);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_bf16_n72_rs<1>(acc, pf[kk], v_desc + 128 * kk, 1);
  wgmma_commit();
}

// The online softmax of one K tile in a thread's rows r0 and r0 + 8 (the 4
// threads of a group share each row): keys at or past kv_len masked, the
// running max m and sum l updated, corr the factor that rescales o; p
// rounded to bf16 and packed as the A fragments of p . v (k-step kk takes
// keys 16 kk .. 16 kk + 15: accumulator elements 8 kk .. 8 kk + 7), l
// summed from the rounded p.
template <bool kRagged>
__device__ __forceinline__ void softmax_tile(const float (&s)[64],
                                             uint32_t (&pn)[8][4], float& m0,
                                             float& m1, float& corr0,
                                             float& corr1, int key0,
                                             int kv_len, int t) {
  // The logits with the key mask, in new registers: s itself is the
  // accumulator of the next s product and is left as it is.
  float x[64];
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool masked = kRagged && key0 + 8 * jj + 2 * t + e >= kv_len;
      x[4 * jj + e] = masked ? kMaskedLogit : s[4 * jj + e];
      x[4 * jj + 2 + e] = masked ? kMaskedLogit : s[4 * jj + 2 + e];
    }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    mx0 = fmaxf(mx0, fmaxf(x[4 * jj], x[4 * jj + 1]));
    mx1 = fmaxf(mx1, fmaxf(x[4 * jj + 2], x[4 * jj + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  corr0 = exp2_ftz(m0 - mx0);
  corr1 = exp2_ftz(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    pn[jj >> 1][(jj & 1) * 2] = pack_bf16(exp2_ftz(x[4 * jj] - mx0),
                                          exp2_ftz(x[4 * jj + 1] - mx0));
    pn[jj >> 1][(jj & 1) * 2 + 1] = pack_bf16(exp2_ftz(x[4 * jj + 2] - mx1),
                                              exp2_ftz(x[4 * jj + 3] - mx1));
  }
}

// The softmax of K tile j, the key mask applied only to a tile that
// reaches past kv_len.
__device__ __forceinline__ void softmax_at(const float (&s)[64],
                                           uint32_t (&pn)[8][4], float& m0,
                                           float& m1, float& corr0,
                                           float& corr1, int key0, int kv_len,
                                           int t) {
  if (key0 + kTileK > kv_len)
    softmax_tile<true>(s, pn, m0, m1, corr0, corr1, key0, kv_len, t);
  else
    softmax_tile<false>(s, pn, m0, m1, corr0, corr1, key0, kv_len, t);
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

__global__ void __launch_bounds__(kThreads, 1)
    bhsd_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const TileArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kOffBar);  // [2]
  uint64_t* q_empty = q_full + 2;  // [2]: both consumers took their last s
  uint64_t* full = q_full + 4;     // K and V landed
  uint64_t* empty = full + kStages;  // both consumers are done with them
  const int wg = threadIdx.x >> 7;
  const int wt = threadIdx.x & 127;
  const int n_kt = (a.kv_len + kTileK - 1) / kTileK;

  // The ones tile of p . [v | 1]: bf16 1.0 throughout, so the swizzle
  // does not matter.
  uint8_t* ones = smem + kOffOnes;
  for (int i = threadIdx.x; i < kKBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(ones)[i] =
        make_uint4(0x3f803f80u, 0x3f803f80u, 0x3f803f80u, 0x3f803f80u);
  fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 8);  // one arrival a consumer warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA copy ----
    regs_dealloc<kProducerRegs>();
    if (wt == 0) {
      int it = 0;  // K / V tiles issued so far, over all of this block's tiles
      int n = 0;
      for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x, ++n) {
        const int qt = tile % a.n_qt;
        const int h = (tile / a.n_qt) % a.H;
        const int b = tile / (a.n_qt * a.H);
        const int qs = n & 1;  // q tiles alternate between two buffers
        mbar_wait(&q_empty[qs], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&q_full[qs], kQBytes);
        tma_load_4d(smem + kOffQ + qs * kQBytes, &q_map, &q_full[qs], 0, h,
                    qt * kTileQ, b);
        for (int j = 0; j < n_kt; ++j, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], kStageBytes);
          uint8_t* st = smem + kOffStage + s * kStageBytes;
          tma_load_4d(st, &k_map, &full[s], 0, h, j * kTileK, b);
          tma_load_4d(st + kKBytes, &v_map, &full[s], 0, h, j * kTileK, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: query rows 64 c .. 64 c + 63 of each tile ----
  regs_alloc<kConsumerRegs>();
  const int c = wg - 1;
  const int lane = wt & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = (wt >> 5) * 16 + g;  // rows r0 and r0 + 8 of the 64
  if (c == 1) turn_pass(c);  // consumer 0 issues first

  float s[64];  // the logits of a K tile
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;

  int it = 0;
  int n = 0;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x, ++n) {
    const int qt = tile % a.n_qt;
    const int h = (tile / a.n_qt) % a.H;
    const int b = tile / (a.n_qt * a.H);
    const bool last_tile = tile + static_cast<int>(gridDim.x) >= a.n_tiles;

    // q' = bf(q * qscale), in place: elementwise, so TMA's swizzle stays.
    const int qs = n & 1;
    uint8_t* my_q = smem + kOffQ + qs * kQBytes + c * 64 * kRowBytes;
    const uint64_t q_desc = desc_sw128(my_q, 16, 1024);
    mbar_wait(&q_full[qs], (n >> 1) & 1);
    {
      uint4* p = reinterpret_cast<uint4*>(my_q);
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = p[wt + 128 * u];
#pragma unroll
      for (int u = 0; u < 4; ++u) p[wt + 128 * u] = scaled8(v[u], a.qscale);
    }
    fence_proxy_async();
    named_barrier(kWgBar + c, 128);

    float acc[36];  // o's 64 columns, then 8 copies of l
#pragma unroll
    for (int i = 0; i < 36; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0, r0 + 8
    float corr0, corr1;
    uint32_t pf[8][4];  // p of the last K / V tile, A fragments of p . v

    // Key tile 0: s alone.
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
    turn_wait(c);
    wgmma_fence();
    issue_s(s, q_desc, stage_of(smem, it));
    turn_pass(c);
    wgmma_wait<0>();
    fence_regs(s);
    if (n_kt == 1 && lane == 0) mbar_arrive(&q_empty[qs]);
    softmax_at(s, pf, m0, m1, corr0, corr1, 0, a.kv_len, t);
    // Key tiles 1 ..: s of this tile and p . v of the last one in two
    // groups; the softmax of this tile runs while p . v does.
    for (int j = 1; j < n_kt; ++j) {
      const int cur = it + j;
      mbar_wait(&full[cur % kStages], (cur / kStages) & 1);
      turn_wait(c);
      wgmma_fence();
      issue_s(s, q_desc, stage_of(smem, cur));
      issue_pv(acc, pf, stage_of(smem, cur - 1) + kKBytes, ones);
      turn_pass(c);
      wgmma_wait<1>();
      fence_regs(s);
      if (j == n_kt - 1 && lane == 0) mbar_arrive(&q_empty[qs]);
      uint32_t pn[8][4];
      softmax_at(s, pn, m0, m1, corr0, corr1, j * kTileK, a.kv_len, t);
      wgmma_wait<0>();  // p . v of the last tile has landed
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[(cur - 1) % kStages]);
      // o and l rescaled to the new max, skipped by a warp whose rows'
      // max did not move.
      if (__any_sync(0xffffffffu, corr0 != 1.f || corr1 != 1.f)) {
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          acc[4 * i] *= corr0;
          acc[4 * i + 1] *= corr0;
          acc[4 * i + 2] *= corr1;
          acc[4 * i + 3] *= corr1;
        }
      }
      take_frags(pf, pn);
    }
    // p . v of the last key tile.
    {
      const int last = it + n_kt - 1;
      turn_wait(c);
      wgmma_fence();
      issue_pv(acc, pf, stage_of(smem, last) + kKBytes, ones);
      // Consumer 1's last issue has no one to hand the turn to.
      if (!(c == 1 && last_tile)) turn_pass(c);
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[last % kStages]);
    }
    it += n_kt;

    // o = acc / l in bf16, [B, Sq, H, 64]; lse = m + log2(l), [B, H, Sq].
    const float m_r[2] = {m0, m1};
    const float l_r[2] = {acc[32], acc[34]};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qt * kTileQ + c * 64 + r0 + 8 * r;
      if (row >= a.Sq) continue;
      bf16* op = a.o + ((static_cast<long long>(b) * a.Sq + row) * a.H + h) *
                           kHeadDim + 2 * t;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<bf162*>(op + 8 * i) = __floats2bfloat162_rn(
            acc[4 * i + 2 * r] / l_r[r], acc[4 * i + 2 * r + 1] / l_r[r]);
      if (t == 0)
        a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + row] =
            m_r[r] + log2f(l_r[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 64;  // one thread per query row
constexpr int kF32Keys = 32;  // keys per shared tile

__global__ void __launch_bounds__(kF32Rows)
    bhsd_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int Sq, int H, int kv_len,
                        float qscale, Strides qs, Strides ks, Strides vs) {
  __shared__ __align__(16) float sK[kF32Keys][kHeadDim];
  __shared__ __align__(16) float sV[kF32Keys][kHeadDim];

  const int tid = threadIdx.x;
  const int row = blockIdx.x * kF32Rows + tid;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  float qr[kHeadDim];
  float acc[kHeadDim];
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
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) acc[d] = 0.f;
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int key0 = 0; key0 < kv_len; key0 += kF32Keys) {
#pragma unroll
    for (int i = 0; i < (kF32Keys * kHeadDim / 4) / kF32Rows; ++i) {
      const int c = tid + i * kF32Rows;
      const int r = c / (kHeadDim / 4);
      const int col = (c % (kHeadDim / 4)) * 4;
      const int key = key0 + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (key < kv_len) {
        kx = *reinterpret_cast<const float4*>(kb + key * ks.s + col);
        vx = *reinterpret_cast<const float4*>(vb + key * vs.s + col);
      }
      *reinterpret_cast<float4*>(&sK[r][col]) = kx;
      *reinterpret_cast<float4*>(&sV[r][col]) = vx;
    }
    __syncthreads();

    float s[kF32Keys];
    float mx = m_run;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) dot = fmaf(qr[d], sK[j][d], dot);
      s[j] = key0 + j < kv_len ? dot : kMaskedLogit;
      mx = fmaxf(mx, s[j]);
    }
    const float corr = exp2f(m_run - mx);
    m_run = mx;
    l_run *= corr;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      const float p = exp2f(s[j] - mx);
      l_run += p;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) acc[d] = fmaf(p, sV[j][d], acc[d]);
    }
    __syncthreads();
  }

  if (row < Sq) {
    float* op = o + ((static_cast<long long>(b) * Sq + row) * H + h) * kHeadDim;
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 4)
      *reinterpret_cast<float4*>(op + d) =
          make_float4(acc[d] / l_run, acc[d + 1] / l_run, acc[d + 2] / l_run,
                      acc[d + 3] / l_run);
    lse[(static_cast<long long>(b) * H + h) * Sq + row] = m_run + log2f(l_run);
  }
}


}  // namespace

// Launches the forward on `stream` and returns the launch's cudaError_t
// (0 on success). is_bf16: 1 for bf16 inputs and output, 0 for fp32.
// q has seq_q rows, k and v seq_k; keys at or past kv_len (<= seq_k) are
// masked. Strides are in elements, in the (batch, row, head) order of the
// model's [B, S, H, 64] layout; every pointer and stride must keep 16-byte
// alignment and head_dim must be 64 (the Python wrapper checks both).
// tma: for bf16, the tensor-map specs (hopper.cuh) of q, k and v, in that
// order, 16 int64 each (boxes of 128 rows of one head); unused for fp32.
extern "C" int flash_attn_bhsd_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int is_bf16, int batch,
                                   int seq_q, int seq_k, int heads,
                                   int head_dim, int kv_len, float qscale,
                                   long long q_sb, long long q_ss,
                                   long long q_sh, long long k_sb,
                                   long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss,
                                   long long v_sh, const long long* tma,
                                   void* stream) {
  if (head_dim != kHeadDim || seq_q < 1 || kv_len < 1 || kv_len > seq_k)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (tma == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap maps[3];
    const void* ptrs[3] = {q, k, v};
    for (int i = 0; i < 3; ++i) {
      const int rc = encode_tensor_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                       ptrs[i], tma + i * kSpecLen,
                                       CU_TENSOR_MAP_SWIZZLE_128B);
      if (rc) return rc;
    }
    int dev = 0, n_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bhsd_fwd_bf16_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kBf16Smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_qt = (seq_q + kTileQ - 1) / kTileQ;
    const long long n_tiles = static_cast<long long>(n_qt) * heads * batch;
    if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const TileArgs ta{static_cast<bf16*>(o), lse, seq_q, heads, kv_len, n_qt,
                      static_cast<int>(n_tiles), qscale};
    const int grid = static_cast<int>(n_tiles < n_sm ? n_tiles : n_sm);
    bhsd_fwd_bf16_kernel<<<grid, kThreads, kBf16Smem, st>>>(maps[0], maps[1],
                                                            maps[2], ta);
  } else {
    const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
        vs{v_sb, v_ss, v_sh};
    const dim3 grid((seq_q + kF32Rows - 1) / kF32Rows, heads, batch);
    bhsd_fwd_f32_kernel<<<grid, kF32Rows, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, seq_q,
        heads, kv_len, qscale, qs, ks, vs);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by flash_attn_bhsd_fwd.
extern "C" const char* flash_attn_bhsd_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
