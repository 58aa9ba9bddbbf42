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
// no running max and no rescaling of the accumulator. The p values then
// round to bf16 exactly where the plain version rounds them. A Hopper block
// has 227 KB of shared memory, not VMEM's megabytes, so one block owns 64
// query rows (4 warps of 16) of one head, and the kernel makes two passes
// over the keys: pass 1 streams the K tiles (64 keys, cp.async, double
// buffered), computes s on the tensor cores and takes the row max; pass 2
// streams the V tiles and accumulates p.v. Where the block's fp32 logits
// fit beside the tiles while two blocks share an SM (at most 5 key tiles,
// 320 keys: 80 KB of logits + 18 KB for two tiles, which pass 1 fills with
// K and pass 2 with V), pass 1 keeps them in shared memory, each thread its
// own accumulator fragments, and pass 2 reads them back; for longer rows
// pass 2 recomputes s from the K tiles (one more product, K read twice
// from L2, two more tile buffers). Both products run on mma.sync m16n8k16
// (bf16 in, fp32 accumulate); v is read transposed with ldmatrix.trans.
// wgmma and TMA are later work. fp32 inputs take a CUDA-core kernel, one
// thread per query row, with the same two passes (the tensor cores would
// round fp32 to tf32).
//
// What bounds it at the tensor-parallel shape [32, 257, 3, 64] bf16: bytes.
// q, k, v and o are 4 x 3.16 MB and the lse 0.1 MB: 12.7 MB, 3.8 us at
// 3.35 TB/s; the two products are 4*B*H*S^2*64 = 1.62 GFLOP, 1.6 us at
// 989 TFLOP/s. The design reads each of q, k, v from device memory once per
// block (K twice per block from L2 on the recompute route) and writes o and
// the lse once; the logits never reach device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kHeadDim = 64;
constexpr float kMaskedLogit = -1e30f;  // masked keys; keeps a row finite

struct Strides {
  long long b, s, h;  // element strides of batch, row and head
};

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kBlockK = 64;           // keys per shared K/V tile
constexpr int kWarps = 4;             // 16 query rows each
constexpr int kBlockQ = kWarps * 16;  // 64 query rows per block
constexpr int kThreads = kWarps * 32;
// Row pitch of the shared tiles: 64 + 8 bf16 = 144 bytes keeps the 16-byte
// cp.async/ldmatrix rows aligned and spreads a warp's fragment loads over
// all 32 banks.
constexpr int kLd = kHeadDim + 8;
constexpr int kTileElems = kBlockK * kLd;
// Two bf16 tiles: K in pass 1, and V in pass 2 where the logits are kept.
constexpr int kTwoTilesBytes = 2 * kTileElems * 2;
// One key tile's fp32 logits for the whole block: 4 warps x 8 key groups x
// 32 lanes x 4 accumulator values.
constexpr int kLogitsTileBytes = kWarps * 8 * 32 * 4 * 4;
// Key tiles whose logits stay in shared memory: two blocks to an SM.
constexpr int kMaxStoredTiles = 5;

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

// Rows [row0, row0 + 64) of one head's [S, 64] matrix into a shared tile;
// rows at or past `n_valid` are zero-filled.
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base,
                                          long long row_stride, int row0,
                                          int n_valid, int tid) {
#pragma unroll
  for (int i = 0; i < (kBlockK * kHeadDim / 8) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 3;
    const int col = (c & 7) * 8;
    const int row = row0 + r;
    const bool valid = row < n_valid;
    const bf16* src = base + (valid ? row : 0) * row_stride + col;
    cp_async16(tile + r * kLd + col, src, valid);
  }
}

// Two q values scaled by bf(scale*log2e) and rounded back to bf16, as the
// TPU kernel scales q in its own type.
__device__ __forceinline__ uint32_t scaled_pair(const bf16* p, float qscale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
  return as_u32(__floats2bfloat162_rn(f.x * qscale, f.y * qscale));
}

// s = q k^T over the 64 keys of the shared tile `sk` (8 tiles of 8 keys,
// this warp's 16 rows), keys at or past kv_len masked.
__device__ __forceinline__ void logits(float (&s)[kBlockK / 8][4],
                                       const uint32_t (&qf)[kHeadDim / 16][4],
                                       const bf16* sk, int key0, int kv_len,
                                       int g, int t) {
#pragma unroll
  for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      const bf16* kp = sk + (n * 8 + g) * kLd + kk * 16 + t * 2;
      mma_16816(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kp),
                *reinterpret_cast<const uint32_t*>(kp + 8));
    }
  }
  if (key0 + kBlockK > kv_len) {
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (key0 + n * 8 + t * 2 + j >= kv_len) {
          s[n][j] = kMaskedLogit;
          s[n][2 + j] = kMaskedLogit;
        }
  }
}

// kStore: pass 1 keeps the logits in shared memory for pass 2 (rows of at
// most kMaxStoredTiles key tiles); otherwise pass 2 recomputes them.
template <bool kStore>
__global__ void __launch_bounds__(kThreads)
    allheads_fwd_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ o,
                             float* __restrict__ lse, int Sq, int H,
                             int kv_len, float qscale, Strides qs, Strides ks,
                             Strides vs) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);     // [2][kTileElems]
  bf16* sV = kStore ? sK : sK + 2 * kTileElems;  // [2][kTileElems]
  float4* sS = reinterpret_cast<float4*>(smem + kTwoTilesBytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const int n_tiles = (kv_len + kBlockK - 1) / kBlockK;

  // The 64 q rows through sK[1], with the first K tile in sK[0]; rows past
  // Sq are zeros.
  load_tile(sK + kTileElems, qb, qs.s, q0, Sq, tid);
  load_tile(sK, kb, ks.s, 0, kv_len, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[kHeadDim / 16][4];  // A fragments of this warp's 16 q rows
  {
    const bf16* qw = sK + kTileElems + warp * 16 * kLd;
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      const int c = kk * 16 + t * 2;
      qf[kk][0] = scaled_pair(qw + g * kLd + c, qscale);
      qf[kk][1] = scaled_pair(qw + (g + 8) * kLd + c, qscale);
      qf[kk][2] = scaled_pair(qw + g * kLd + c + 8, qscale);
      qf[kk][3] = scaled_pair(qw + (g + 8) * kLd + c + 8, qscale);
    }
  }
  __syncthreads();  // sK[1] takes the second K tile

  // Pass 1: the exact row max over every key tile.
  float mx[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) {
      load_tile(sK + ((kt + 1) & 1) * kTileElems, kb, ks.s, (kt + 1) * kBlockK,
                kv_len, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[kBlockK / 8][4];
    logits(s, qf, sK + (kt & 1) * kTileElems, kt * kBlockK, kv_len, g, t);
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      if (kStore)
        sS[((kt * kWarps + warp) * 8 + n) * 32 + lane] =
            make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 threads of a group share each row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }

  // Pass 2: p against the exact max, o += p v, l from the rounded p.
  float acc[kHeadDim / 8][4];  // o accumulator, 8 tiles of 8 dims
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
  float rs[2] = {0.f, 0.f};
  load_tile(sV, vb, vs.s, 0, kv_len, tid);
  if (!kStore) load_tile(sK, kb, ks.s, 0, kv_len, tid);
  cp_async_commit();
  const int mi = lane >> 3;
  const int mr = lane & 7;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      const int nb = (kt + 1) & 1;
      load_tile(sV + nb * kTileElems, vb, vs.s, (kt + 1) * kBlockK, kv_len,
                tid);
      if (!kStore)
        load_tile(sK + nb * kTileElems, kb, ks.s, (kt + 1) * kBlockK, kv_len,
                  tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[kBlockK / 8][4];
    if (kStore) {
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) {
        const float4 x = sS[((kt * kWarps + warp) * 8 + n) * 32 + lane];
        s[n][0] = x.x;
        s[n][1] = x.y;
        s[n][2] = x.z;
        s[n][3] = x.w;
      }
    } else {
      logits(s, qf, sK + buf * kTileElems, kt * kBlockK, kv_len, g, t);
    }

    // p in bf16, laid out as the A fragments of the p.v product: the
    // accumulator of key tiles 2j and 2j+1 is the A operand of k-step j.
    uint32_t pf[kBlockK / 16][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      const bf162 p01 = __floats2bfloat162_rn(exp2f(s[n][0] - mx[0]),
                                              exp2f(s[n][1] - mx[0]));
      const bf162 p23 = __floats2bfloat162_rn(exp2f(s[n][2] - mx[1]),
                                              exp2f(s[n][3] - mx[1]));
      const float2 f01 = __bfloat1622float2(p01);
      const float2 f23 = __bfloat1622float2(p23);
      rs[0] += f01.x + f01.y;
      rs[1] += f23.x + f23.y;
      pf[n >> 1][(n & 1) * 2 + 0] = as_u32(p01);
      pf[n >> 1][(n & 1) * 2 + 1] = as_u32(p23);
    }

    // o += p v. ldmatrix.x4.trans hands each lane the B fragments of two
    // 8-dim tiles for 16 keys: matrices (keys 0-7 | 8-15) x (tile 2j | 2j+1).
    const bf16* sv = sV + buf * kTileElems;
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kHeadDim / 16; ++np) {
        uint32_t vf[4];
        ldmatrix_x4_trans(
            vf, sv + (kk * 16 + (mi & 1) * 8 + mr) * kLd + (np * 2 + (mi >> 1)) * 8);
        mma_16816(acc[np * 2], pf[kk], vf[0], vf[1]);
        mma_16816(acc[np * 2 + 1], pf[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Sq) continue;
    bf16* op = o + ((static_cast<long long>(b) * Sq + row) * H + h) * kHeadDim;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n)
      *reinterpret_cast<bf162*>(op + n * 8 + t * 2) = __floats2bfloat162_rn(
          acc[n][2 * r] / rs[r], acc[n][2 * r + 1] / rs[r]);
    if (t == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + row] = mx[r] + log2f(rs[r]);
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

template <bool kStore>
cudaError_t launch_bf16(const dim3& grid, cudaStream_t st, int smem_bytes,
                        const bf16* q, const bf16* k, const bf16* v, bf16* o,
                        float* lse, int Sq, int H, int kv_len, float qscale,
                        const Strides& qs, const Strides& ks,
                        const Strides& vs) {
  cudaError_t err = cudaFuncSetAttribute(
      allheads_fwd_bf16_kernel<kStore>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  allheads_fwd_bf16_kernel<kStore><<<grid, kThreads, smem_bytes, st>>>(
      q, k, v, o, lse, Sq, H, kv_len, qscale, qs, ks, vs);
  return cudaGetLastError();
}

}  // namespace

// Launches the forward on `stream` and returns the launch's cudaError_t
// (0 on success). is_bf16: 1 for bf16 inputs and output, 0 for fp32.
// q has seq_q rows, k and v seq_k; keys at or past kv_len (<= seq_k) are
// masked. Strides are in elements, in the (batch, row, head) order of the
// model's [B, S, H, 64] layout; every pointer and stride must keep 16-byte
// alignment and head_dim must be 64 (the Python wrapper checks both).
extern "C" int flash_attn_allheads_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int is_bf16, int batch, int seq_q, int seq_k, int heads, int head_dim,
    int kv_len, float qscale, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, void* stream) {
  if (head_dim != kHeadDim || seq_q < 1 || kv_len < 1 || kv_len > seq_k)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, heads, batch);
    const int n_tiles = (kv_len + kBlockK - 1) / kBlockK;
    const bf16* qq = static_cast<const bf16*>(q);
    const bf16* kk = static_cast<const bf16*>(k);
    const bf16* vv = static_cast<const bf16*>(v);
    bf16* oo = static_cast<bf16*>(o);
    if (n_tiles <= kMaxStoredTiles)
      return static_cast<int>(launch_bf16<true>(
          grid, st, kTwoTilesBytes + n_tiles * kLogitsTileBytes, qq, kk, vv,
          oo, lse, seq_q, heads, kv_len, qscale, qs, ks, vs));
    return static_cast<int>(launch_bf16<false>(
        grid, st, 2 * kTwoTilesBytes, qq, kk, vv, oo, lse, seq_q, heads,
        kv_len, qscale, qs, ks, vs));
  }
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
