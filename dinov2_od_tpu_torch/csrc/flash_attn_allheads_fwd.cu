// Flash-attention forward against the exact row max, [B, H, S, 64] heads,
// for Hopper (sm_90a), plain C interface.
//
// Replaces dinov2_od_tpu/ops/flash_attention.py:_fwd_kernel_allheads (B4f),
// the Pallas TPU kernel that the JAX dispatch (`_flash_fwd`) runs wherever
// a head's whole fp32 [Sq_pad, Sk_pad] logits fit its 8 MiB budget twice
// over (`_head_group(h, sq_pad, sk_pad, 2) >= 1`) and the flat kernels do
// not take the shape: head counts that do not pair into 128 lanes (ViT-B/14
// under 4-way tensor parallelism: 3 heads a rank at 257 tokens), Sq != Sk
// (50 queries over up to 16k keys), self-attention up to S_pad 1024.
//
// What it computes, per (batch, head), the TPU kernel's function:
//   s   = (q * bf(scale*log2e)) . k^T   fp32; keys >= kv_len set to -1e30
//   m   = rowmax(s)                      exact, over all the row's keys
//   p   = exp2(s - m), rounded to the input type
//   l   = rowsum(p)                      from the rounded p, fp32
//   o   = (p . v) / l                    fp32 accumulation, stored in dt
//   lse = m + log2(l)                    log2 space, fp32 [B, H, Sq]
// q is read as [B, H, Sq, 64] and k, v as [B, H, Sk, 64] through arbitrary
// batch, head and row strides (the last dim contiguous), so a rank's head
// slices of the fused qkv GEMM output are read in place. o is a contiguous
// [B, Sq, H, 64]. The kernel masks its own ragged q and k edges.
//
// The TPU kernel's idea, and what sets it apart from B5f: the whole logits
// row of a head stay on chip, so p is taken against the exact row max, with
// no running max and no rescaling of the accumulator, and p rounds to bf16
// exactly where the plain version rounds it.
//
// What bounds it at the tensor-parallel shape [32, 257, 3, 64] bf16: bytes.
// q, k, v and o are 4 x 3.16 MB and the lse 0.1 MB: 12.7 MB, 3.8 us at
// 3.35 TB/s; the two products are 4*B*H*S^2*64 = 1.62 GFLOP, 1.6 us at
// 989 TFLOP/s. At that size the card is mostly waiting: 480 units of 64
// query rows, under two a consumer warpgroup, each a short chain of loads,
// products and exponentials; the design keeps every link of the chain on
// the hardware that does it fastest and the loads ahead of it.
//
// Design (bf16). A persistent grid, one block a multiprocessor, of a
// producer warpgroup and two consumer warpgroups, each consumer on its own
// units of 64 query rows of one (batch, head) (every other unit, in turn
// with the other blocks) with its own producer thread, as B4b's kernel is
// laid out (flash_bwd_units.cuh). A consumer's 64 rows of logits are 64 x
// Sk fp32, 132 registers a thread at 257 keys: with o's accumulator and
// p's fragments that is past the 168 registers a thread that a block of
// 384 threads a multiprocessor leaves, and a TPU-sized row (1601 keys) is
// far past it. So each unit makes two passes over 128-key K tiles:
// - pass 1, s = q' . k^T (wgmma m64n128k16, both operands in shared
//   memory) and the exact row max, keys at or past kv_len masked (a key
//   past the tensor's end reads as zero by TMA, so s = 0 there, not
//   -1e30: the mask is explicit);
// - pass 2, the K tiles in reverse, so that the last tile's logits, still
//   in registers from pass 1, are not taken again: p = exp2(s - m) rounded
//   to bf16 in registers as the A operand of o += p . [v | 1] (wgmma
//   m64n72k16, v MN-major through the transpose bit); B's columns 64 .. 71
//   are a tile of ones, so the tensor cores sum l from the rounded p in
//   fp32 (B5f's device); s of the next K tile and p . v of this one are
//   issued in separate groups, the exponentials run under p . v, and the
//   loop is peeled as B5f's is so that ptxas serialises no wgmma.
// Recomputing s for all but the last tile costs a third more tensor work
// at 257 keys and reads K twice (from L2), and is cheaper here than
// keeping the logits, which spill registers or take the shared memory the
// K / V ring needs. The producer brings each unit's q rows into one of two
// slots (the next unit's land while this one runs) and the K and V tiles,
// one 16 KB tile a slot, through a 4-stage mbarrier ring, by TMA (4-D
// tensor maps over [B, S, H, 64] with the real strides, 128-byte swizzle).
// The consumer scales its rows to q' = bf(q * bf(scale*log2e)) in place
// once; rows past Sq read as zeros and are not stored. Exponentials are
// ex2.approx.ftz (one SFU instruction).
// setmaxnreg gives the consumers 232 registers and the producer warpgroup
// 40. fp32 inputs take a CUDA-core kernel, one thread per query row, with
// the same two passes (the tensor cores would round fp32 to tf32).

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
// bf16 kernel: TMA, wgmma, a producer warpgroup and two consumer
// warpgroups, each consumer on its own units
// ---------------------------------------------------------------------------

constexpr int kUnit = 64;    // query rows of a unit
constexpr int kTileK = 128;  // keys of a K or V tile
constexpr int kStages = 4;   // each consumer's ring of K or V tiles
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
constexpr int kBf16Smem = 1024 + kOffOnes + kKBytes;
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

// acc += p . [v | 1] over one V tile (p from registers, v MN-major, 16
// keys = 2048 bytes a step), one group: columns 64 .. 71 of B are the
// ones tile, so acc's columns 64 .. 71 sum each row of the rounded p in
// fp32, the l of the contract.
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

// The row max of one K tile's logits in a thread's rows r0 and r0 + 8,
// keys at or past kv_len left out.
template <bool kRagged>
__device__ __forceinline__ void tile_max(const float (&s)[64], float& m0,
                                         float& m1, int key0, int kv_len,
                                         int t) {
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool masked = kRagged && key0 + 8 * jj + 2 * t + e >= kv_len;
      m0 = fmaxf(m0, masked ? kMaskedLogit : s[4 * jj + e]);
      m1 = fmaxf(m1, masked ? kMaskedLogit : s[4 * jj + 2 + e]);
    }
}

// p = exp2(s - m) of one K tile, keys at or past kv_len masked, rounded to
// bf16 and packed as the A fragments of p . v (k-step kk takes keys 16 kk
// .. 16 kk + 15: accumulator elements 8 kk .. 8 kk + 7). The masked logits
// go to new registers: s is the accumulator of the next s product.
template <bool kRagged>
__device__ __forceinline__ void tile_p(const float (&s)[64],
                                       uint32_t (&pn)[8][4], float m0,
                                       float m1, int key0, int kv_len, int t) {
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
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
}

// p of K tile j, the key mask applied only to a tile that reaches past
// kv_len.
__device__ __forceinline__ void p_at(const float (&s)[64],
                                     uint32_t (&pn)[8][4], float m0,
                                     float m1, int key0, int kv_len, int t) {
  if (key0 + kTileK > kv_len)
    tile_p<true>(s, pn, m0, m1, key0, kv_len, t);
  else
    tile_p<false>(s, pn, m0, m1, key0, kv_len, t);
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
    allheads_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const UnitArgs a) {
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
  uint64_t* q_empty = q_full + 2;    // [2]: the unit's last s is issued
  uint64_t* full = q_full + 4;       // a K or V tile landed
  uint64_t* empty = full + kStages;  // the consumer is done with it
  const uint8_t* ones = smem0 + kOffOnes;
  const int first_unit = 2 * blockIdx.x + c;
  const int stride = 2 * gridDim.x;
  const int n_kt = (a.kv_len + kTileK - 1) / kTileK;

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
        // Pass 1: every K tile. Pass 2, last tile first: V of the last
        // (its s is still in the consumer's registers), then K and V of
        // each tile before it.
        for (int j = 0; j < n_kt; ++j) load(&k_map, h, j * kTileK, b);
        load(&v_map, h, (n_kt - 1) * kTileK, b);
        for (int j = n_kt - 2; j >= 0; --j) {
          load(&k_map, h, j * kTileK, b);
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

    // Pass 1: the exact row max over every K tile.
    float m0 = -INFINITY, m1 = -INFINITY;  // rows r0 and r0 + 8
    for (int j = 0; j < n_kt; ++j) {
      wait_tile(it + j);
      wgmma_fence();
      issue_s(s, q_desc, tile(it + j));
      wgmma_wait<0>();
      fence_regs(s);
      free_tile(it + j);
      if (n_kt == 1 && lane == 0) mbar_arrive(&q_empty[qs]);
      if ((j + 1) * kTileK > a.kv_len)
        tile_max<true>(s, m0, m1, j * kTileK, a.kv_len, t);
      else
        tile_max<false>(s, m0, m1, j * kTileK, a.kv_len, t);
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));

    // Pass 2, the K tiles in reverse, so that the last one's logits, still
    // in s, are not taken again. Step r takes tile n_kt - 1 - r: its K at
    // base + 2r - 1 (r >= 1), its V at base + 2r.
    const int base = it + n_kt;
    float acc[36];  // o's 64 columns, then 8 copies of l
#pragma unroll
    for (int i = 0; i < 36; ++i) acc[i] = 0.f;
    uint32_t pf[8][4];  // p of the last tile, A fragments of p . v
    p_at(s, pf, m0, m1, (n_kt - 1) * kTileK, a.kv_len, t);
    // Steps 1 ..: s of this tile and p . v of the one before in two
    // groups; the exponentials of this tile run while p . v does.
    for (int r = 1; r < n_kt; ++r) {
      const int kj = base + 2 * r - 1;
      const int vj = kj - 1;  // V of the tile of step r - 1
      wait_tile(kj);
      wait_tile(vj);
      wgmma_fence();
      issue_s(s, q_desc, tile(kj));
      issue_pv(acc, pf, tile(vj), ones);
      wgmma_wait<1>();
      fence_regs(s);
      free_tile(kj);
      if (r == n_kt - 1 && lane == 0) mbar_arrive(&q_empty[qs]);
      uint32_t pn[8][4];
      p_at(s, pn, m0, m1, (n_kt - 1 - r) * kTileK, a.kv_len, t);
      wgmma_wait<0>();  // p . v of the step before has landed
      fence_regs(acc);
      free_tile(vj);
      take_frags(pf, pn);
    }
    // p . v of the first K tile, the last step's.
    {
      const int vl = base + 2 * (n_kt - 1);
      wait_tile(vl);
      wgmma_fence();
      issue_pv(acc, pf, tile(vl), ones);
      wgmma_wait<0>();
      fence_regs(acc);
      free_tile(vl);
    }
    it = base + 2 * n_kt - 1;

    // o = acc / l in bf16, [B, Sq, H, 64]; lse = m + log2(l), [B, H, Sq].
    const float m_r[2] = {m0, m1};
    const float l_r[2] = {acc[32], acc[34]};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = qu * kUnit + r0 + 8 * r;
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

__global__ void __launch_bounds__(kF32Rows)
    allheads_fwd_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
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

}  // namespace

// Launches the forward on `stream` and returns the launch's cudaError_t
// (0 on success). is_bf16: 1 for bf16 inputs and output, 0 for fp32.
// q has seq_q rows, k and v seq_k; keys at or past kv_len (<= seq_k) are
// masked. Strides are in elements, in the (batch, row, head) order of the
// model's [B, S, H, 64] layout; every pointer and stride must keep 16-byte
// alignment and head_dim must be 64 (the Python wrapper checks both).
// tma: for bf16, the tensor-map specs (hopper.cuh) of q (boxes of 64 rows
// of one head), k and v (boxes of 128 rows), in that order, 16 int64 each;
// unused for fp32.
extern "C" int flash_attn_allheads_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int is_bf16, int batch, int seq_q, int seq_k, int heads, int head_dim,
    int kv_len, float qscale, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, const long long* tma, void* stream) {
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
      err = cudaFuncSetAttribute(allheads_fwd_bf16_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kBf16Smem);
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
    allheads_fwd_bf16_kernel<<<grid, kThreads, kBf16Smem, st>>>(
        maps[0], maps[1], maps[2], ua);
    return static_cast<int>(cudaGetLastError());
  }
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const dim3 grid((seq_q + kF32Rows - 1) / kF32Rows, heads, batch);
  allheads_fwd_f32_kernel<<<grid, kF32Rows, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, seq_q, heads,
      kv_len, qscale, qs, ks, vs);
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by flash_attn_allheads_fwd.
extern "C" const char* flash_attn_allheads_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
