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
// q_lo = bf16(q' - q_hi). k is exact in bf16, so both products are exact in
// fp32, and their fp32 sum misses the fp32 product by at most 2^-17 of q'
// per term. The split doubles the first product (three mma.sync products
// per key tile, not two); the TPU kernel paid for its fp32 operand too.
//
// The exact row max needs every key before the second product, and the
// stage deltas must measure the softmax pieces, not a recomputation: each
// logit is computed once. A 64-row block's fp32 logits over 1376 keys (352
// KB) exceed a block's 227 KB of shared memory, so one block owns 32 query
// rows (two m16 tiles, 8 warps) and keeps their fp32 logits in shared
// memory between the passes (176 KB at 1376 keys, 205 KB at 1616). One
// stream of 64-key tiles, K then V, runs through a cp.async ring of 2-4
// buffers, as many as the rest of shared memory holds:
// - pass 1, the K tiles: warp w takes m-tile w & 1 and keys 16 * (w >> 1)
//   .. +16 of each tile, stores its s and keeps its partial row max;
// - between the passes the block reduces the row max and turns s into p in
//   place, rounded to bf16 (kept as fp32), one elementwise sweep;
// - pass 2, the V tiles: warp w accumulates a partial o for m-tile w & 1
//   over the same 16 keys of each tile and all 64 head dims (mma.sync
//   m16n8k16; v read by ldmatrix.trans), so each p is read once; the four
//   partials are summed through shared memory at the end.
// wgmma and TMA are later work.
//
// Longest S: 1632. 32 rows of logits at a pitch of 1640 floats, two tiles
// and the row-max scratch take 228,864 of a block's 232,448 bytes; at 1648
// the pitch is 1672 and they take 232,960. The wrapper raises past it.
//
// What bounds it on an H100 at the tool's default, [8, 16, 1376, 64]:
// operations. The two products are 4*B*H*S^2*64 = 62.0 GFLOP, 62.7 us at
// 989 TFLOP/s; q, k, v and o are 90 MB, 27 us at 3.35 TB/s. The design
// reads q and writes o once; each K/V tile is read from L2 once per 32-row
// block (43 times a head at 1376), and the logits never leave the SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kHeadDim = 64;
constexpr int kBlockK = 64;          // keys per K/V tile
constexpr int kRows = 32;            // query rows per block: two m16 tiles
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// Row pitch of the shared tiles: 64 + 8 bf16 = 144 bytes, which keeps the
// 16-byte cp.async/ldmatrix rows aligned and spreads a warp's fragment
// loads over all 32 banks.
constexpr int kLd = kHeadDim + 8;
constexpr int kTileElems = kBlockK * kLd;
constexpr int kRedFloats = 4 * kRows;  // partial row max of each key quarter
constexpr int kMaxSmem = 232448;       // a block's dynamic shared memory
constexpr int kMaxSeq = 1632;
constexpr int kMaxStages = 4;
// Float pitch of the partial o rows summed at the end (64 + 8: a half-warp's
// float2 stores hit distinct banks).
constexpr int kPartLd = kHeadDim + 8;

// Float pitch of a row of logits: a multiple of 32 plus 8, so that the
// float2 fragment stores and loads of a half-warp hit distinct banks.
__host__ __device__ constexpr int s_pitch(int n) {
  return (n + 31) / 32 * 32 + 8;
}

// The logits' region, which also holds the four partial o at the end.
__host__ __device__ constexpr int s_floats(int n) {
  return kRows * s_pitch(n) > 4 * kRows * kPartLd ? kRows * s_pitch(n)
                                                  : 4 * kRows * kPartLd;
}

size_t smem_bytes(int n, int stages) {
  return static_cast<size_t>(s_floats(n)) * 4 + kRedFloats * 4 +
         static_cast<size_t>(stages) * kTileElems * 2;
}

__device__ __forceinline__ uint32_t as_u32(bf162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_size = valid ? 16 : 0;  // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(gmem), "r"(src_size)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Rows [row0, row0 + kN) of one head's [S, 64] matrix into a shared tile;
// rows at or past `n_valid` are zero-filled.
template <int kN>
__device__ __forceinline__ void load_rows(bf16* tile, const bf16* base,
                                          int row0, int n_valid, int tid) {
#pragma unroll
  for (int i = 0; i < (kN * kHeadDim / 8) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 3;
    const int col = (c & 7) * 8;
    const int row = row0 + r;
    const bool valid = row < n_valid;
    const bf16* src =
        base + static_cast<long long>(valid ? row : 0) * kHeadDim + col;
    cp_async16(tile + r * kLd + col, src, valid);
  }
}

// Tile i of the block's stream (K tiles 0 .. n_tiles-1, then V tiles) into
// its ring buffer, as one cp.async group; past the stream an empty group,
// so that every iteration commits one and the wait counts stay fixed.
template <int kStages>
__device__ __forceinline__ void fetch_tile(bf16* ring, const bf16* kh,
                                           const bf16* vh, int i, int n_tiles,
                                           int n_keys, int tid) {
  if (i < 2 * n_tiles) {
    const bool is_k = i < n_tiles;
    load_rows<kBlockK>(ring + (i % kStages) * kTileElems, is_k ? kh : vh,
                       (is_k ? i : i - n_tiles) * kBlockK, n_keys, tid);
  }
  cp_async_commit();
}

// Two q values times the fp32 multiplier, split into bf16 hi and lo parts.
__device__ __forceinline__ void split_pair(const bf16* p, float qscale,
                                           uint32_t& hi, uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
  const float x = __fmul_rn(f.x, qscale);
  const float y = __fmul_rn(f.y, qscale);
  const bf162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// p at keys `key` and `key + 1` of a row (0 past n_keys) as a bf16 pair;
// the values are bf16 already, so the conversion is exact.
__device__ __forceinline__ uint32_t p_pair(const float* row, int key,
                                           int n_keys) {
  float2 f;
  if (key + 1 < n_keys) {
    f = *reinterpret_cast<const float2*>(row + key);
  } else {
    f.x = key < n_keys ? row[key] : 0.f;
    f.y = 0.f;
  }
  return as_u32(__floats2bfloat162_rn(f.x, f.y));
}

// The exact max of row r, from the four key quarters' partial maxima.
template <int kStage>
__device__ __forceinline__ float row_max(const float* sRed, int r) {
  if (kStage == 0) return 0.f;
  return fmaxf(fmaxf(sRed[r], sRed[kRows + r]),
               fmaxf(sRed[2 * kRows + r], sRed[3 * kRows + r]));
}

// p of one logit by stage, rounded to bf16 and kept as fp32.
template <int kStage>
__device__ __forceinline__ float to_p(float s, float m) {
  float p = s;
  if (kStage == 1) p = s - m;
  if (kStage == 2) p = exp2f(s - m);
  return __bfloat162float(__float2bfloat16_rn(p));
}

template <int kStage, int kStages>
__global__ void __launch_bounds__(kThreads, 1)
    roofline_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int n,
                    int n_keys, float qscale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld_s = s_pitch(n);
  float* sS = reinterpret_cast<float*>(smem);  // [kRows, ld_s] logits, then p
  float* sRed = sS + s_floats(n);              // [4, kRows] partial row max
  bf16* ring = reinterpret_cast<bf16*>(sRed + kRedFloats);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int mt = warp & 1;        // the warp's m16 tile of the block's rows
  const int quarter = warp >> 1;  // its 16 keys of each K and V tile
  const int row0 = blockIdx.x * kRows;
  const long long head = static_cast<long long>(blockIdx.y) * n * kHeadDim;
  const bf16* qh = q + head;
  const bf16* kh = k + head;
  const bf16* vh = v + head;
  const int n_tiles = (n_keys + kBlockK - 1) / kBlockK;

  // The q rows through the last ring buffer, then the first tiles.
  bf16* q_tile = ring + (kStages - 1) * kTileElems;
  load_rows<kRows>(q_tile, qh, row0, n, tid);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i)
    fetch_tile<kStages>(ring, kh, vh, i, n_tiles, n_keys, tid);
  cp_async_wait<kStages - 1>();
  __syncthreads();

  uint32_t qhi[kHeadDim / 16][4];  // A fragments of q_hi and q_lo
  uint32_t qlo[kHeadDim / 16][4];
  {
    const bf16* qw = q_tile + mt * 16 * kLd;
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      const int c = kk * 16 + t * 2;
      split_pair(qw + g * kLd + c, qscale, qhi[kk][0], qlo[kk][0]);
      split_pair(qw + (g + 8) * kLd + c, qscale, qhi[kk][1], qlo[kk][1]);
      split_pair(qw + g * kLd + c + 8, qscale, qhi[kk][2], qlo[kk][2]);
      split_pair(qw + (g + 8) * kLd + c + 8, qscale, qhi[kk][3], qlo[kk][3]);
    }
  }

  // Pass 1: s = q' k^T into shared memory, and the partial row max.
  float* srow0 = sS + (mt * 16 + g) * ld_s;
  float* srow1 = srow0 + 8 * ld_s;
  float mx[2] = {-INFINITY, -INFINITY};
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` landed; the buffer refilled next was read
    fetch_tile<kStages>(ring, kh, vh, it + kStages - 1, n_tiles, n_keys, tid);
    const bf16* sk = ring + (it % kStages) * kTileElems;
    // Four independent accumulators (two n8 tiles of keys x hi, lo), so
    // the tensor cores take four chains of 4 products, not one of 16.
    float c[2][2][4] = {};
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bf16* kp =
            sk + (quarter * 16 + j * 8 + g) * kLd + kk * 16 + t * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kp + 8);
        mma_16816(c[j][0], qhi[kk], b0, b1);
        mma_16816(c[j][1], qlo[kk], b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] = c[j][0][e] + c[j][1][e];
      const int key = it * kBlockK + quarter * 16 + j * 8 + t * 2;
      if (key + 1 < n_keys) {
        *reinterpret_cast<float2*>(srow0 + key) = make_float2(s[0], s[1]);
        *reinterpret_cast<float2*>(srow1 + key) = make_float2(s[2], s[3]);
        if (kStage != 0) {
          mx[0] = fmaxf(mx[0], fmaxf(s[0], s[1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[2], s[3]));
        }
      } else if (key < n_keys) {
        srow0[key] = s[0];
        srow1[key] = s[2];
        if (kStage != 0) {
          mx[0] = fmaxf(mx[0], s[0]);
          mx[1] = fmaxf(mx[1], s[2]);
        }
      }
    }
  }

  // Between the passes: the exact row max, then p in place.
  if (kStage != 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    if (t == 0) {
      sRed[quarter * kRows + mt * 16 + g] = mx[0];
      sRed[quarter * kRows + mt * 16 + g + 8] = mx[1];
    }
  }
  __syncthreads();  // every logit and partial max is in shared memory
  if (n_keys % 4 == 0) {
    // float4 columns, four rows in flight per thread (row starts are 16-byte
    // aligned: the pitch is a multiple of 4 floats).
    for (int r0 = 0; r0 < kRows; r0 += 4) {
      float m[4];
      float4* rows[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        m[i] = row_max<kStage>(sRed, r0 + i);
        rows[i] = reinterpret_cast<float4*>(sS + (r0 + i) * ld_s);
      }
      for (int c = tid; c < n_keys / 4; c += kThreads) {
        float4 x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = rows[i][c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rows[i][c] = make_float4(
              to_p<kStage>(x[i].x, m[i]), to_p<kStage>(x[i].y, m[i]),
              to_p<kStage>(x[i].z, m[i]), to_p<kStage>(x[i].w, m[i]));
      }
    }
  } else {
    for (int r = 0; r < kRows; ++r) {
      const float m = row_max<kStage>(sRed, r);
      float* row = sS + r * ld_s;
      for (int c = tid; c < n_keys; c += kThreads)
        row[c] = to_p<kStage>(row[c], m);
    }
  }

  // Pass 2: o = p v over the V tiles (the first loop iteration's barrier
  // orders the sweep above before these reads). Warp w sums the keys
  // 16 * (w >> 1) .. +16 of each tile for m-tile w & 1 over all 64 head
  // dims, so each p is read once per block; eight independent accumulators.
  float acc[kHeadDim / 8][4] = {};
  const int mi = lane >> 3;
  const int mr = lane & 7;
  for (int it = n_tiles; it < 2 * n_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    fetch_tile<kStages>(ring, kh, vh, it + kStages - 1, n_tiles, n_keys, tid);
    const bf16* sv = ring + (it % kStages) * kTileElems;
    const int kb = (it - n_tiles) * kBlockK + quarter * 16 + t * 2;
    const uint32_t a[4] = {p_pair(srow0, kb, n_keys), p_pair(srow1, kb, n_keys),
                           p_pair(srow0, kb + 8, n_keys),
                           p_pair(srow1, kb + 8, n_keys)};
#pragma unroll
    for (int np = 0; np < kHeadDim / 16; ++np) {
      // B fragments of dim tiles 2np and 2np+1 for the warp's 16 keys:
      // matrices (keys 0-7 | 8-15) x (tile 2np | 2np + 1).
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, sv + (quarter * 16 + (mi & 1) * 8 + mr) * kLd +
                                (np * 2 + (mi >> 1)) * 8);
      mma_16816(acc[np * 2], a, vf[0], vf[1]);
      mma_16816(acc[np * 2 + 1], a, vf[2], vf[3]);
    }
  }

  // The four key quarters' partial o, summed through shared memory (the
  // logits' space, free now) and stored as bf16.
  __syncthreads();
  float* part = sS;  // [4 quarters][kRows][kPartLd]
#pragma unroll
  for (int n8 = 0; n8 < kHeadDim / 8; ++n8)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(
          part + (quarter * kRows + mt * 16 + g + r * 8) * kPartLd + n8 * 8 +
          t * 2) = make_float2(acc[n8][2 * r], acc[n8][2 * r + 1]);
  __syncthreads();
  {
    const int r = tid >> 3;        // 32 rows x 8 threads
    const int d0 = (tid & 7) * 8;  // 8 head dims each
    float sum[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sum[i] = 0.f;
#pragma unroll
    for (int qt = 0; qt < 4; ++qt) {
      const float* src = part + (qt * kRows + r) * kPartLd + d0;
      const float4 x = *reinterpret_cast<const float4*>(src);
      const float4 y = *reinterpret_cast<const float4*>(src + 4);
      sum[0] += x.x; sum[1] += x.y; sum[2] += x.z; sum[3] += x.w;
      sum[4] += y.x; sum[5] += y.y; sum[6] += y.z; sum[7] += y.w;
    }
    if (row0 + r < n) {
      uint4 packed;
      packed.x = as_u32(__floats2bfloat162_rn(sum[0], sum[1]));
      packed.y = as_u32(__floats2bfloat162_rn(sum[2], sum[3]));
      packed.z = as_u32(__floats2bfloat162_rn(sum[4], sum[5]));
      packed.w = as_u32(__floats2bfloat162_rn(sum[6], sum[7]));
      *reinterpret_cast<uint4*>(
          o + head + static_cast<long long>(row0 + r) * kHeadDim + d0) = packed;
    }
  }
}

template <int kStage, int kStages>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                   int batch_heads, int n, int n_keys, float qscale,
                   cudaStream_t st) {
  const size_t bytes = smem_bytes(n, kStages);
  cudaError_t err = cudaFuncSetAttribute(
      roofline_kernel<kStage, kStages>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRows - 1) / kRows, batch_heads);
  roofline_kernel<kStage, kStages>
      <<<grid, kThreads, bytes, st>>>(q, k, v, o, n, n_keys, qscale);
  return cudaGetLastError();
}

template <int kStage>
cudaError_t launch_stage(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                         int batch_heads, int n, int n_keys, float qscale,
                         int stages, cudaStream_t st) {
  switch (stages) {
    case 4:
      return launch<kStage, 4>(q, k, v, o, batch_heads, n, n_keys, qscale, st);
    case 3:
      return launch<kStage, 3>(q, k, v, o, batch_heads, n, n_keys, qscale, st);
    default:
      return launch<kStage, 2>(q, k, v, o, batch_heads, n, n_keys, qscale, st);
  }
}

}  // namespace

// Launches the ablation kernel on `stream` and returns the launch's
// cudaError_t (0 on success). q, k, v and o are contiguous bf16
// [batch_heads, seq, 64], 16-byte aligned (the Python wrapper checks).
// stage: 0 mxu_only, 1 plus_max, 2 plus_exp2. The first n_keys (<= seq)
// keys take part: seq for the tool; fewer only for a control run that must
// disagree. qscale is fp32(scale * log2 e).
extern "C" int attn_roofline(const void* q, const void* k, const void* v,
                             void* o, int stage, int batch_heads, int seq,
                             int n_keys, int head_dim, float qscale,
                             void* stream) {
  if (head_dim != kHeadDim || seq < 1 || seq > kMaxSeq || n_keys < 1 ||
      n_keys > seq || batch_heads < 1 || batch_heads > 65535 || stage < 0 ||
      stage > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int stages = kMaxStages;
  while (stages > 2 && smem_bytes(seq, stages) > kMaxSmem) --stages;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (stage == 0)
    err = launch_stage<0>(qb, kb, vb, ob, batch_heads, seq, n_keys, qscale,
                          stages, st);
  else if (stage == 1)
    err = launch_stage<1>(qb, kb, vb, ob, batch_heads, seq, n_keys, qscale,
                          stages, st);
  else
    err = launch_stage<2>(qb, kb, vb, ob, batch_heads, seq, n_keys, qscale,
                          stages, st);
  return static_cast<int>(err);
}

// The longest seq the kernel takes.
extern "C" int attn_roofline_max_seq() { return kMaxSeq; }

// Message for a code returned by attn_roofline.
extern "C" const char* attn_roofline_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
