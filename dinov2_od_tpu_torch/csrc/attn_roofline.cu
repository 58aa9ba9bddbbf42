// Ablated attention forward of the attention roofline tool, [B, H, S, 64]
// bf16 heads, for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `kernel` of tools/bench_attn_roofline.py
// (T1, :69; its pallas_call at :94). The tool times three stages of the
// attention forward, each adding one piece of the softmax to the two
// products, and the production forward beside them.
//
// What it computes, per (batch, head), over all S rows and all S keys (no
// mask: the tool's padded rows are data):
//   q' = fp32(q) * fp32(scale * log2 e)   fp32 (the tool's scale is a numpy
//                                          float64, which promotes the bf16 q)
//   s  = q' . k^T                          fp32 accumulation
//   p  = s                                 stage 0, mxu_only
//      = s - rowmax(s)                     stage 1, plus_max
//      = exp2(s - rowmax(s))               stage 2, plus_exp2
//   o  = bf16(sum_j bf16(p_j) . v_j)       fp32 accumulation
// There is no division by the row sum and no lse.
//
// fp32 q' on bf16 tensor cores: q' = q_hi + q_lo, q_hi = bf16(q') and
// q_lo = bf16(q' - q_hi). k is exact in bf16, so both products are exact
// in fp32 but for their own sums, and s = s_hi + s_lo misses the fp32
// product by at most 2^-17 of q' per term.
//
// What bounds it on an H100 at the tool's default, [8, 16, 1376, 64]:
// operations. The two products are 4*B*H*S^2*64 = 62.0 GFLOP, 62.7 us at
// 989 TFLOP/s; q, k, v and o are 90 MB, 27 us at 3.35 TB/s.
//
// Design. The exact row max needs every key before the second product, and
// the stage deltas must measure the softmax pieces, not a recomputation:
// each logit is computed once and kept in shared memory between the
// passes. 64 rows of fp32 logits at 1376 keys are 352 KB, past a block's
// 227 KB, so a unit is 32 query rows (176 KB at 1376 keys, 208 KB at 1616).
// A persistent grid, one block a multiprocessor, of two consumer
// warpgroups and one producer warp; units are taken in (head, row block)
// order, so the blocks of a head run together and its K and V tiles come
// from L2.
// - The producer streams each unit's q rows (a 32-row box, once for each
//   warpgroup), then its K tiles, then its V tiles (64-key boxes), by TMA
//   (4-D tensor maps over [B, H, S, 64] with the real strides, 128-byte
//   swizzle) through an mbarrier ring of 8 KB slots, as many as the logits
//   leave room for (2 to 6). K and V tile j belong to warpgroup j % 2, and
//   a warpgroup holds one tile at a time, so two slots never deadlock.
// - Pass 1, transposed: s^T = k . [q_hi | q_lo]^T, one m64n64k16 product
//   over four k steps a K tile (A: the K tile, 64 keys; B: the 32 rows'
//   q_hi over the same rows' q_lo, 64 rows of head dims, built once a unit
//   in the block of the warpgroup's last K tile, which is free until that
//   tile's logits are stored). Each logit's two halves are computed once
//   and land in the same thread, columns 32 apart, so s = s_hi + s_lo is
//   one fp32 addition in registers: no exchange between warps. Each warp
//   keeps the row max of its keys. One warpgroup's product runs while the
//   other stores.
// - The logits of a 64-key block sit where that block's bf16 p goes: p in
//   the 128-byte-swizzled K-major layout of wgmma's B (32 rows x 64 keys,
//   4 KB), and the fp32 logit of (row, key) at p's 4-byte word of its key
//   pair (even key) or near it 4 KB on (odd key). So the sweep between the
//   passes (max, subtract, exp2, round) reads the two logits of a pair and
//   writes their p over the first, in place, each word read and written by
//   one thread, with no barrier inside the sweep and no bank conflict; a
//   thread loads all its logits of two blocks before it stores any p. Each
//   warpgroup sweeps its own blocks, once both have stored their logits
//   and partial row maxima.
// - Pass 2, transposed: a partial o^T (64 head dims x 32 rows) += v^T . p^T
//   over each warpgroup's V tiles, A = the V tile through the transpose
//   bit, B = the p block, m64n32k16. Each p is read once. Warpgroup 1's
//   partial goes through shared memory to warpgroup 0, which adds it,
//   rounds o to bf16 and stores it in 16-byte rows through shared memory.
// Exponentials are ex2.approx.ftz (one SFU instruction), as in the
// production kernels. Tried in probe builds and not kept, all slower on
// an H100: q_hi over q_lo as wgmma's A (s_hi and s_lo in different warps,
// summed through shared memory behind a barrier a tile), that with the
// next tile's product issued under the stores, and the same 64 rows
// computing the whole s twice over eight k steps (no better than this
// design: the K/V stream from L2, not the tensor cores, sets the time);
// one consumer warpgroup with two accumulators in turn; and clusters of
// two blocks on one head that load each K and V tile once for both by TMA
// multicast (the stream alone got slower with the two blocks' rings
// coupled).
//
// Longest S: 1664, 26 blocks of logits beside two ring slots.

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
constexpr int kRows = 32;                 // query rows of a unit
constexpr int kBlockK = 64;               // keys of a K/V tile and a block
constexpr int kSlot = kBlockK * 128;      // 8 KB: a ring slot
constexpr int kQBytes = kRows * 128;      // 4 KB: a unit's q box
constexpr int kBlockBytes = 8192;         // a block of fp32 logits
constexpr int kPairWords = 1024;          // key pairs of a block
constexpr int kThreads = 288;  // two consumer warpgroups and a producer warp
constexpr int kMaxSmem = 232448;          // a block's dynamic shared memory
constexpr int kMaxSeq = 1664;
constexpr int kMaxStages = 6;
constexpr int kBarAll = 1;   // both consumer warpgroups
constexpr int kBarWg = 2;    // + c: consumer warpgroup c alone
constexpr int kBarRead = 4;  // warpgroup 0 has read warpgroup 1's partial o
constexpr int kStagePitch = 144;  // bytes a row of staged o (64 bf16 + 16)

// Blocks of logits kept: one a 64-key block, at least two (block 1 holds
// warpgroup 1's partial o at the end of a unit).
__host__ __device__ inline int n_blocks(int seq) {
  const int n = (seq + kBlockK - 1) / kBlockK;
  return n > 2 ? n : 2;
}

// Shared memory from a 1024-byte boundary: the logits' blocks, the ring's
// slots, the 32 partial row maxima of each consumer warp, the ring's
// barriers.
size_t smem_bytes(int seq, int stages) {
  return 1024 + static_cast<size_t>(n_blocks(seq)) * kBlockBytes +
         static_cast<size_t>(stages) * kSlot + 8 * kRows * 4 + 2 * stages * 8;
}

struct Args {
  bf16* o;  // contiguous [batch, heads, seq, 64]
  int heads, seq, n_keys, n_qu, n_units;
  float qscale;
};

// The 4-byte word of p (row r, keys 2i, 2i + 1 of a block, i < 32) in the
// 128-byte-swizzled K-major layout of a 32-row x 64-key bf16 tile: 8-row
// groups 1024 bytes apart, a row 128 bytes, its 16-byte chunks XORed with
// the row's place in its group. The fp32 logit of key 2i sits at this word
// of the block, that of key 2i + 1 at word (this word ^ 4) + kPairWords
// (the XOR keeps pass 1's stores of neighbouring keys off one bank).
__device__ __forceinline__ int pair_word(int r, int i) {
  return (r >> 3) * 256 + (r & 7) * 32 + (((i >> 2) ^ (r & 7)) << 2) + (i & 3);
}

// Eight q values (bf16) times the fp32 multiplier, split into bf16 hi
// (lo = 0) or lo (lo = 1) parts: q' = fp32(q) * qscale, hi = bf16(q'),
// lo = bf16(q' - hi).
__device__ __forceinline__ uint4 split8(uint4 raw, float qscale, int lo) {
  uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const bf162*>(&w[i]));
    const float x = __fmul_rn(f.x, qscale);
    const float y = __fmul_rn(f.y, qscale);
    const bf162 h = __floats2bfloat162_rn(x, y);
    if (lo) {
      const float2 hf = __bfloat1622float2(h);
      w[i] = pack_bf16(x - hf.x, y - hf.y);
    } else {
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// p of one logit by stage (before rounding).
template <int kStage>
__device__ __forceinline__ float to_p(float s, float m) {
  if (kStage == 0) return s;
  if (kStage == 1) return s - m;
  return exp2_ftz(s - m);
}

// The logits of a K tile into their block (see pair_word), from the
// accumulator of s^T = k . [q_hi | q_lo]^T: element 4 jj + 2 h + e is key
// 16 warp + g + 8 h of the tile and column 8 jj + 2 t + e, q_hi's rows for
// jj < 4 and the same rows' q_lo for jj >= 4, so a thread holds both
// halves of each of its 16 logits: s = s_hi + s_lo. With the row max of
// the keys before n_keys in m (stages 1 and 2), m[2 jj + e] for row
// 8 jj + 2 t + e.
template <int kStage>
__device__ __forceinline__ void store_tile(const float (&s)[32], float* blk,
                                           int warp, int g, int t, int key0,
                                           int n_keys, float (&m)[8]) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = s[4 * jj + 2 * h + e] + s[4 * (jj + 4) + 2 * h + e];
        const int key = 16 * warp + g + 8 * h;
        const int w = pair_word(8 * jj + 2 * t + e, key >> 1);
        blk[(g & 1) ? (w ^ 4) + kPairWords : w] = x;
        if (kStage != 0 && key0 + key < n_keys)
          m[2 * jj + e] = fmaxf(m[2 * jj + e], x);
      }
}

// The row max of the row of word 128 i + tid of a block, for each i: the
// largest of the eight consumer warps' partial maxima (0 for stage 0, which
// takes none).
template <int kStage>
__device__ __forceinline__ void row_maxima(const float* row_max, int tid,
                                           float (&mr)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int w = 128 * i + tid;
    const int r = (w >> 8) * 8 + ((w >> 5) & 7);
    mr[i] = 0.f;
    if (kStage != 0) {
      mr[i] = row_max[r];
#pragma unroll
      for (int q = 1; q < 8; ++q) mr[i] = fmaxf(mr[i], row_max[q * kRows + r]);
    }
  }
}

// p of the logits of `kNb` blocks (1 or 2: j and j + 2), in place (see
// pair_word): every load before every store, so that the loads of one
// thread do not wait on its stores. Word 128 i + tid of every block is in
// the same row, whose max is mr[i] (see row_maxima).
template <int kStage, int kNb>
__device__ __forceinline__ void sweep_blocks(float* lg, int j, int tid,
                                             const float (&mr)[8],
                                             int n_keys) {
  float x[kNb][8][2];
#pragma unroll
  for (int b = 0; b < kNb; ++b)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float* blk = lg + (j + 2 * b) * (kBlockBytes / 4);
      x[b][i][0] = blk[128 * i + tid];
      x[b][i][1] = blk[((128 * i + tid) ^ 4) + kPairWords];
    }
  uint32_t p[kNb][8];
#pragma unroll
  for (int b = 0; b < kNb; ++b)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int w = 128 * i + tid;
      const int r = (w >> 8) * 8 + ((w >> 5) & 7);
      const int key = (j + 2 * b) * kBlockK +
                      8 * (((w >> 2) & 7) ^ (r & 7)) + 2 * (w & 3);
      const float p0 = key < n_keys ? to_p<kStage>(x[b][i][0], mr[i]) : 0.f;
      const float p1 =
          key + 1 < n_keys ? to_p<kStage>(x[b][i][1], mr[i]) : 0.f;
      p[b][i] = pack_bf16(p0, p1);
    }
#pragma unroll
  for (int b = 0; b < kNb; ++b)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      reinterpret_cast<uint32_t*>(lg + (j + 2 * b) * (kBlockBytes / 4))
          [128 * i + tid] = p[b][i];
}

template <int kStage, int kStages>
__global__ void __launch_bounds__(kThreads, 1)
    roofline_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* logits = align1024(smem_raw);
  uint8_t* ring = logits + n_blocks(a.seq) * kBlockBytes;
  float* row_max = reinterpret_cast<float*>(ring + kStages * kSlot);
  uint64_t* full = reinterpret_cast<uint64_t*>(row_max + 8 * kRows);
  uint64_t* empty = full + kStages;
  const int lane = threadIdx.x & 31;
  const int n_kb = (a.n_keys + kBlockK - 1) / kBlockK;  // K and V tiles
  const int unit_tiles = 2 + 2 * n_kb;  // two q boxes, K, V

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival a warp of the tile's owner
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: lane 0 of warp 8 issues every TMA copy. A unit's
    // stream: its q box once for each warpgroup, the K tiles, the V tiles;
    // K and V tile j belong to warpgroup j % 2. ----
    if (lane == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < a.n_units; u += gridDim.x) {
        const int bh = u / a.n_qu;
        const int h = bh % a.heads;
        const int b = bh / a.heads;
        auto load = [&](const CUtensorMap* map, int bytes, int row) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], bytes);
          tma_load_4d(ring + s * kSlot, map, &full[s], 0, row, h, b);
          ++it;
        };
        for (int c = 0; c < 2; ++c)
          load(&q_map, kQBytes, (u % a.n_qu) * kRows);
        for (int j = 0; j < n_kb; ++j) load(&k_map, kSlot, j * kBlockK);
        for (int j = 0; j < n_kb; ++j) load(&v_map, kSlot, j * kBlockK);
      }
    }
    return;
  }

  // ---- consumer warpgroup c: the unit's K and V tiles c, c + 2, ... ----
  const int c = threadIdx.x >> 7;
  const int wt = threadIdx.x & 127;
  const int warp = wt >> 5;            // in the warpgroup
  const int t = lane & 3;
  const int g = lane >> 2;
  float* lg = reinterpret_cast<float*>(logits);
  auto slot = [&](int i) { return ring + (i % kStages) * kSlot; };
  auto wait_slot = [&](int i) { mbar_wait(&full[i % kStages], (i / kStages) & 1); };
  auto free_slot = [&](int i) {
    if (lane == 0) mbar_arrive(&empty[i % kStages]);
  };
  // This warpgroup's last K tile (when it has one): the block of its
  // logits holds [q_hi | q_lo] until they are stored.
  const int last = c + (n_kb - 1 - c) / 2 * 2;
  uint8_t* qhl = logits + (c < n_kb ? last : c) * kBlockBytes;

  int base = 0;  // the ring index of the unit's first tile
  for (int u = blockIdx.x; u < a.n_units; u += gridDim.x, base += unit_tiles) {
    const int bh = u / a.n_qu;
    const int row0 = (u % a.n_qu) * kRows;
    const int k0 = base + 2;           // K tile j at k0 + j
    const int v0 = base + 2 + n_kb;    // V tile j at v0 + j

    // The B operand of pass 1, 64 rows of 64 head dims: q_hi of the 32 rows
    // over q_lo of the same rows, from this warpgroup's copy of the q box,
    // 16 bytes at a time. Rows r and r + 32 share their place in the
    // 128-byte swizzle, so TMA's layout carries over.
    wait_slot(base + c);
    {
      const uint4* sq = reinterpret_cast<const uint4*>(slot(base + c));
      uint4* dst = reinterpret_cast<uint4*>(qhl);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint4 raw = sq[wt + 128 * i];
        dst[wt + 128 * i] = split8(raw, a.qscale, 0);
        dst[wt + 128 * i + kQBytes / 16] = split8(raw, a.qscale, 1);
      }
    }
    free_slot(base + c);
    fence_proxy_async();
    named_barrier(kBarWg + c, 128);

    // Pass 1, transposed: s^T = k . [q_hi | q_lo]^T over this warpgroup's
    // K tiles, one at a time (A: the K tile, B: the q tile, both K-major,
    // m64n64k16), each logit's two halves once and in one thread (see
    // store_tile); the other warpgroup's product runs while this one
    // stores.
    float m[8];  // partial row maxima, rows 8 jj + 2 t + e
#pragma unroll
    for (int i = 0; i < 8; ++i) m[i] = -INFINITY;
    const uint64_t q_desc = desc_sw128(qhl, 16, 1024);
    float s[32];
    for (int j = c; j < n_kb; j += 2) {
      wait_slot(k0 + j);
      wgmma_fence();
      const uint64_t k_desc = desc_sw128(slot(k0 + j), 16, 1024);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16_ss<0, 0>(s, k_desc + 2 * kk, q_desc + 2 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      free_slot(k0 + j);
      store_tile<kStage>(s, lg + j * (kBlockBytes / 4), warp, g, t,
                         j * kBlockK, a.n_keys, m);
    }

    // The exact row max: each warp's over its keys of its warpgroup's
    // blocks, combined in the sweep.
    if (kStage != 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 4));
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 8));
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 16));
      }
      if (g == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          row_max[(4 * c + warp) * kRows + 8 * (i >> 1) + 2 * t + (i & 1)] =
              m[i];
      }
    }
    named_barrier(kBarAll, 256);  // every logit and partial max is stored

    // p in place of the logits of this warpgroup's blocks (see pair_word).
    float mr[8];
    row_maxima<kStage>(row_max, wt, mr);
    int jb = c;
    for (; jb + 2 < n_kb; jb += 4)
      sweep_blocks<kStage, 2>(lg, jb, wt, mr, a.n_keys);
    if (jb < n_kb) sweep_blocks<kStage, 1>(lg, jb, wt, mr, a.n_keys);
    fence_proxy_async();
    named_barrier(kBarWg + c, 128);

    // Pass 2: a partial o^T += v^T . p^T over this warpgroup's V tiles (A:
    // the V tile, MN-major through the transpose bit; B: the p block,
    // K-major).
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    for (int j = c; j < n_kb; j += 2) {
      wait_slot(v0 + j);
      wgmma_fence();
      const uint64_t v_desc = desc_sw128(slot(v0 + j), 1024, 1024);
      const uint64_t p_desc = desc_sw128(logits + j * kBlockBytes, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16_n32_ss<1, 0>(acc, v_desc + 128 * kk, p_desc + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      free_slot(v0 + j);
    }

    // o = bf16(o0^T + o1^T)^T: warpgroup 1 leaves its partial in block 1
    // (its own p block, read), warpgroup 0 adds it, stages o in block 0
    // and stores it. Element 4 jj + e of acc is head dim 16 warp + g (+ 8
    // for e >= 2) of row 8 jj + 2 t + (e & 1).
    float* part = lg + kBlockBytes / 4;
    if (c == 1) {
#pragma unroll
      for (int i = 0; i < 16; ++i) part[i * 128 + wt] = acc[i];
    }
    named_barrier(kBarAll, 256);
    if (c == 1) {
      named_barrier(kBarRead, 256);  // block 1 is free for the next unit
      continue;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] += part[i * 128 + wt];
    named_barrier_arrive(kBarRead, 256);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 8 * jj + 2 * t + (e & 1);
        const int dim = 16 * warp + g + 8 * (e >> 1);
        *reinterpret_cast<bf16*>(logits + row * kStagePitch + dim * 2) =
            __float2bfloat16_rn(acc[4 * jj + e]);
      }
    named_barrier(kBarWg, 128);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ci = wt + 128 * i;
      const int row = ci >> 3;
      if (row0 + row < a.seq)
        *reinterpret_cast<uint4*>(
            a.o + (static_cast<long long>(bh) * a.seq + row0 + row) *
                      kHeadDim + (ci & 7) * 8) =
            *reinterpret_cast<const uint4*>(logits + row * kStagePitch +
                                            (ci & 7) * 16);
    }
    named_barrier(kBarWg, 128);  // the staging is read before pass 1 reuses it
  }
}

template <int kStage, int kStages>
cudaError_t launch(const CUtensorMap* maps, const Args& a, int n_sm,
                   cudaStream_t st) {
  const size_t bytes = smem_bytes(a.seq, kStages);
  cudaError_t err = cudaFuncSetAttribute(
      roofline_kernel<kStage, kStages>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int grid = a.n_units < n_sm ? a.n_units : n_sm;
  roofline_kernel<kStage, kStages>
      <<<grid, kThreads, bytes, st>>>(maps[0], maps[1], maps[2], a);
  return cudaGetLastError();
}

template <int kStage>
cudaError_t launch_stage(const CUtensorMap* maps, const Args& a, int n_sm,
                         int stages, cudaStream_t st) {
  switch (stages) {
    case 6:
      return launch<kStage, 6>(maps, a, n_sm, st);
    case 4:
      return launch<kStage, 4>(maps, a, n_sm, st);
    case 3:
      return launch<kStage, 3>(maps, a, n_sm, st);
    default:
      return launch<kStage, 2>(maps, a, n_sm, st);
  }
}

}  // namespace

// Launches the ablation kernel on `stream` and returns the launch's
// cudaError_t (0 on success). q, k and v are bf16 [batch, heads, seq, 64]
// views read through the tensor maps of `tma` (hopper.cuh specs, 16 int64
// each: q in boxes of 32 rows of one head, k and v in boxes of 64 rows;
// the wrapper's `attn_roofline_tma_specs`); o is a contiguous bf16 [batch,
// heads, seq, 64]. stage: 0 mxu_only, 1 plus_max, 2 plus_exp2. The first
// n_keys (<= seq) keys take part: seq for the tool; fewer only for a
// control run that must disagree. qscale is fp32(scale * log2 e).
extern "C" int attn_roofline(const void* q, const void* k, const void* v,
                             void* o, int stage, int batch, int heads,
                             int seq, int n_keys, int head_dim, float qscale,
                             const long long* tma, void* stream) {
  if (head_dim != kHeadDim || seq < 1 || seq > kMaxSeq || n_keys < 1 ||
      n_keys > seq || batch < 1 || heads < 1 || stage < 0 || stage > 2 ||
      tma == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long batch_heads = static_cast<long long>(batch) * heads;
  int stages = kMaxStages;
  while (stages > 2 && smem_bytes(seq, stages) > kMaxSmem)
    stages = stages == 6 ? 4 : stages - 1;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int rc = encode_tensor_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                     ptrs[i], tma + i * kSpecLen,
                                     CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc) return rc;
  }
  const int n_qu = (seq + kRows - 1) / kRows;
  const long long n_units = static_cast<long long>(n_qu) * batch_heads;
  if (n_units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<bf16*>(o), heads, seq, n_keys, n_qu,
               static_cast<int>(n_units), qscale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stage == 0) err = launch_stage<0>(maps, a, n_sm, stages, st);
  else if (stage == 1) err = launch_stage<1>(maps, a, n_sm, stages, st);
  else err = launch_stage<2>(maps, a, n_sm, stages, st);
  return static_cast<int>(err);
}

// The longest seq the kernel takes.
extern "C" int attn_roofline_max_seq() { return kMaxSeq; }

// Message for a code returned by attn_roofline.
extern "C" const char* attn_roofline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
