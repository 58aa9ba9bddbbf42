// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces dinov2_od_tpu/ops/flash_attention.py:_bwd_kernel_flat, the
// Pallas TPU kernel that the adapted ViT blocks' self-attention runs in
// the train step's backward.
//
// What it computes, per (batch, head), from the forward's q, k, v, its
// log2 lse and delta = rowsum(dO * o) (delta is taken outside, in torch
// ops, with any lse cotangent folded in):
//   s   = (q * bf(scale*log2e)) . k^T       fp32, log2-space logits
//   p   = exp2(s - lse)                      fp32; 0 for keys >= kv_len
//   dv  = p(dt)^T . dO                       fp32 sum, stored in dt
//   dp  = (dO * bf(scale))(dt) . v^T         fp32
//   ds  = p * (dp - delta * scale)           fp32
//   dk  = ds(dt)^T . q                       unscaled q; fp32 sum, dt
//   dq  = ds(dt) . k                         fp32 sum, dt
// dt is the input type (bf16 or fp32). Keys at or past kv_len get p = 0,
// so their dk and dv are exactly 0. q, k, v and dO are [B, S, H, 64]
// views with arbitrary batch, row and head strides (the last dim
// contiguous), so the forward's three slices of the fused qkv GEMM output
// are read in place; lse and delta are contiguous [B, H, S] fp32; dq, dk
// and dv are contiguous [B, S, H, 64].
//
// What bounds it on an H100 at the train shape (B=32, S=257, H=12, dh=64,
// bf16): bytes. It must read q, k, v, dO (4 x 12.6 MB), lse and delta
// (0.8 MB) and write dq, dk, dv (3 x 12.6 MB): ~89 MB, 27 us at 3.35 TB/s.
// The five products are 16.2 GFLOP, 16 us at 989 TFLOP/s.
//
// Design. The TPU kernel walks its key blocks in order and carries dq in
// a revisited fp32 output; Hopper's blocks run in no order, so nothing
// can be carried between them. Two passes instead, each deterministic
// (no atomics: two runs give bit-identical gradients):
// - dkdv: one thread block per (64-key tile, head, batch) keeps dk and dv
//   for its keys in fp32 registers and streams 64-query tiles of q and dO
//   (with their lse and delta) through double-buffered shared memory
//   (cp.async). Each warp owns 16 keys and works in the transposed
//   orientation (keys as rows), so s^T, p^T and ds^T are A operands
//   straight from the accumulators.
// - dq: one thread block per (64-query tile, head, batch) keeps dq in fp32
//   registers and streams 64-key tiles of k and v, recomputing p and ds.
// Both recompute s and dp, 7 products where the TPU kernel did 5: the
// price of writing dq once, without atomics. All products run on the
// tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate); the
// operands that are needed transposed (dO and q in dkdv, k in dq) are
// read with ldmatrix.trans. No sequence padding: ragged last tiles are
// zero-filled on load and masked. fp32 inputs take CUDA-core kernels with
// one thread per key (dkdv) or per query (dq), since the tensor cores
// would round to tf32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

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
  int S, H, kv_len;
  float qscale;   // bf(scale * log2 e), q's multiplier in s
  float doscale;  // scale in the input type, dO's multiplier in dp
  float scale;    // scale in fp32, delta's multiplier in ds
  Strides qs, ks, vs, dos;
};

// ---------------------------------------------------------------------------
// bf16 tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int kTile = 64;  // rows of a q, dO, k or v tile
constexpr int kWarps = 4;  // 16 rows each
constexpr int kThreads = kWarps * 32;
// Row pitch of the shared tiles: 64 + 8 bf16 = 144 bytes keeps the
// 16-byte cp.async/ldmatrix rows aligned and spreads the fragment loads
// of one warp over all 32 banks.
constexpr int kLd = kHeadDim + 8;

__device__ __forceinline__ uint32_t as_u32(bf162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t raw_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two values multiplied by `mult` and rounded back to bf16, as JAX
// multiplies a bf16 array by a Python scalar.
__device__ __forceinline__ uint32_t scaled_pair(const bf16* p, float mult) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
  return as_u32(__floats2bfloat162_rn(f.x * mult, f.y * mult));
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
  for (int i = 0; i < (kTile * kHeadDim / 8) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 3;
    const int col = (c & 7) * 8;
    const int row = row0 + r;
    const bool valid = row < n_valid;
    const bf16* src = base + (valid ? row : 0) * row_stride + col;
    cp_async16(tile + r * kLd + col, src, valid);
  }
}

// A fragments of the 16 x 64 row block at `rows` (row pitch kLd), each
// value multiplied by `mult` in bf16 (mult 1 leaves it as it is).
__device__ __forceinline__ void a_frags(uint32_t (&f)[kHeadDim / 16][4],
                                        const bf16* rows, int g, int t,
                                        float mult) {
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    f[kk][0] = scaled_pair(rows + g * kLd + c, mult);
    f[kk][1] = scaled_pair(rows + (g + 8) * kLd + c, mult);
    f[kk][2] = scaled_pair(rows + g * kLd + c + 8, mult);
    f[kk][3] = scaled_pair(rows + (g + 8) * kLd + c + 8, mult);
  }
}

// acc[n] (16 x 8 tiles, n = 0..7) += A (16 x 64) . B^T, where B is a
// 64 x 64 shared tile whose rows are the n index (row pitch kLd), each B
// value multiplied by `mult` in bf16 first.
__device__ __forceinline__ void mma_abt(float (&acc)[8][4],
                                        const uint32_t (&a)[4][4],
                                        const bf16* b_rows, int g, int t,
                                        float mult, bool scale_b) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      const bf16* bp = b_rows + (n * 8 + g) * kLd + kk * 16 + t * 2;
      const uint32_t b0 = scale_b ? scaled_pair(bp, mult) : raw_pair(bp);
      const uint32_t b1 =
          scale_b ? scaled_pair(bp + 8, mult) : raw_pair(bp + 8);
      mma_16816(acc[n], a[kk], b0, b1);
    }
  }
}

// The 16 x 64 fp32 accumulator x as bf16 A fragments of a product over
// its 64 columns: accumulator tiles 2j and 2j+1 form k-step j.
__device__ __forceinline__ void acc_to_a(uint32_t (&f)[4][4],
                                         const float (&x)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    f[n >> 1][(n & 1) * 2 + 0] = as_u32(__floats2bfloat162_rn(x[n][0], x[n][1]));
    f[n >> 1][(n & 1) * 2 + 1] = as_u32(__floats2bfloat162_rn(x[n][2], x[n][3]));
  }
}

// acc[n] (16 x 8 tiles over 64 head dims) += A (16 x 64) . M, where M is a
// 64 x 64 shared tile stored row-major over the contraction index, read
// transposed with ldmatrix.trans.
__device__ __forceinline__ void mma_am(float (&acc)[8][4],
                                       const uint32_t (&a)[4][4],
                                       const bf16* m, int lane) {
  const int mi = lane >> 3;
  const int mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int np = 0; np < kHeadDim / 16; ++np) {
      uint32_t bf[4];
      ldmatrix_x4_trans(
          bf, m + (kk * 16 + (mi & 1) * 8 + mr) * kLd + (np * 2 + (mi >> 1)) * 8);
      mma_16816(acc[np * 2], a[kk], bf[0], bf[1]);
      mma_16816(acc[np * 2 + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// Rows row and row + 8 of a 16 x 64 fp32 accumulator into a contiguous
// [B, S, H, 64] bf16 output, rows at or past S skipped.
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[8][4],
                                          int row, int S, int H, int h, int b,
                                          int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + r * 8;
    if (rr >= S) continue;
    bf16* op = out + ((static_cast<long long>(b) * S + rr) * H + h) * kHeadDim;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n)
      *reinterpret_cast<bf162*>(op + n * 8 + t * 2) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// dk and dv for one (64-key tile, head, batch). The block's k and v tiles
// are staged in the second q/dO buffers, turned into register fragments,
// and the buffers then carry the stream of q/dO tiles (37 KB of static
// shared memory in all).
__global__ void __launch_bounds__(kThreads)
    dkdv_bf16_kernel(Args a) {
  __shared__ __align__(16) bf16 sQ[2][kTile * kLd];
  __shared__ __align__(16) bf16 sDO[2][kTile * kLd];
  __shared__ float sL[2][kTile];
  __shared__ float sD[2][kTile];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = a.S;
  const long long bh = static_cast<long long>(b) * a.H + h;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + b * a.dos.b + h * a.dos.h;

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[n][j] = dv[n][j] = 0.f;

  if (key0 < a.kv_len) {  // a tile of masked keys only keeps dk = dv = 0
    const int n_qt = (S + kTile - 1) / kTile;
    load_tile(sQ[1], kb, a.ks.s, key0, a.kv_len, tid);
    load_tile(sDO[1], vb, a.vs.s, key0, a.kv_len, tid);
    load_tile(sQ[0], qb, a.qs.s, 0, S, tid);
    load_tile(sDO[0], dob, a.dos.s, 0, S, tid);
    cp_async_commit();
    // Rows past S: lse +inf makes p exactly 0.
    if (tid < kTile) {
      sL[0][tid] = tid < S ? a.lse[bh * S + tid] : INFINITY;
    } else {
      const int r = tid - kTile;
      sD[0][r] = r < S ? a.delta[bh * S + r] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    uint32_t kf[4][4], vf[4][4];  // this warp's 16 keys of k and v
    a_frags(kf, sQ[1] + warp * 16 * kLd, g, t, 1.f);
    a_frags(vf, sDO[1] + warp * 16 * kLd, g, t, 1.f);
    __syncthreads();  // buffer 1 now takes the second q/dO tile
    const int my_key = key0 + warp * 16 + g;  // rows my_key, my_key + 8
    const bool kmask0 = my_key >= a.kv_len;
    const bool kmask1 = my_key + 8 >= a.kv_len;

    for (int qt = 0; qt < n_qt; ++qt) {
      const int buf = qt & 1;
      if (qt + 1 < n_qt) {
        const int nb = buf ^ 1;
        const int q1 = (qt + 1) * kTile;
        load_tile(sQ[nb], qb, a.qs.s, q1, S, tid);
        load_tile(sDO[nb], dob, a.dos.s, q1, S, tid);
        cp_async_commit();
        if (tid < kTile) {
          sL[nb][tid] = q1 + tid < S ? a.lse[bh * S + q1 + tid] : INFINITY;
        } else {
          const int r = tid - kTile;
          sD[nb][r] = q1 + r < S ? a.delta[bh * S + q1 + r] : 0.f;
        }
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* sq = sQ[buf];
      const bf16* sdo = sDO[buf];
      const float* lse = sL[buf];
      const float* dlt = sD[buf];

      // p^T = exp2(k . qs^T - lse): 16 keys x 64 queries.
      float x[8][4];
      mma_abt(x, kf, sq, g, t, a.qscale, true);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float l = lse[n * 8 + t * 2 + j];
          x[n][j] = kmask0 ? 0.f : exp2f(x[n][j] - l);
          x[n][2 + j] = kmask1 ? 0.f : exp2f(x[n][2 + j] - l);
        }
      uint32_t pf[4][4];
      acc_to_a(pf, x);
      mma_am(dv, pf, sdo, lane);  // dv += p^T . dO

      // ds^T = p^T * (v . dos^T - delta * scale).
      float dp[8][4];
      mma_abt(dp, vf, sdo, g, t, a.doscale, true);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float d = dlt[n * 8 + t * 2 + j] * a.scale;
          x[n][j] = x[n][j] * (dp[n][j] - d);
          x[n][2 + j] = x[n][2 + j] * (dp[n][2 + j] - d);
        }
      uint32_t dsf[4][4];
      acc_to_a(dsf, x);
      mma_am(dk, dsf, sq, lane);  // dk += ds^T . q
      __syncthreads();  // this buffer is refilled two tiles on
    }
  }
  const int row = key0 + warp * 16 + g;
  store_rows(static_cast<bf16*>(a.dk), dk, row, S, a.H, h, b, t);
  store_rows(static_cast<bf16*>(a.dv), dv, row, S, a.H, h, b, t);
}

// dq for one (64-query tile, head, batch). The block's q and dO tiles are
// staged in the second k/v buffers, turned into register fragments, and
// the buffers then carry the stream of k/v tiles (37 KB of static shared
// memory in all).
__global__ void __launch_bounds__(kThreads)
    dq_bf16_kernel(Args a) {
  __shared__ __align__(16) bf16 sK[2][kTile * kLd];
  __shared__ __align__(16) bf16 sV[2][kTile * kLd];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = a.S;
  const long long bh = static_cast<long long>(b) * a.H + h;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + b * a.dos.b + h * a.dos.h;
  const int n_kt = (a.kv_len + kTile - 1) / kTile;

  load_tile(sK[1], qb, a.qs.s, q0, S, tid);
  load_tile(sV[1], dob, a.dos.s, q0, S, tid);
  load_tile(sK[0], kb, a.ks.s, 0, a.kv_len, tid);
  load_tile(sV[0], vb, a.vs.s, 0, a.kv_len, tid);
  cp_async_commit();

  const int row = q0 + warp * 16 + g;  // rows row, row + 8
  float lse[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + r * 8;
    lse[r] = rr < S ? a.lse[bh * S + rr] : INFINITY;
    dlt[r] = (rr < S ? a.delta[bh * S + rr] : 0.f) * a.scale;
  }
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[4][4], dof[4][4];  // this warp's 16 rows of qs and dos
  a_frags(qf, sK[1] + warp * 16 * kLd, g, t, a.qscale);
  a_frags(dof, sV[1] + warp * 16 * kLd, g, t, a.doscale);
  __syncthreads();  // buffer 1 now takes the second k/v tile

  float dq[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[n][j] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) {
      const int nb = buf ^ 1;
      load_tile(sK[nb], kb, a.ks.s, (kt + 1) * kTile, a.kv_len, tid);
      load_tile(sV[nb], vb, a.vs.s, (kt + 1) * kTile, a.kv_len, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sk = sK[buf];
    const bf16* sv = sV[buf];
    const int key0 = kt * kTile;

    // p = exp2(qs . k^T - lse): 16 queries x 64 keys.
    float x[8][4];
    mma_abt(x, qf, sk, g, t, 1.f, false);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool masked = key0 + n * 8 + t * 2 + j >= a.kv_len;
        x[n][j] = masked ? 0.f : exp2f(x[n][j] - lse[0]);
        x[n][2 + j] = masked ? 0.f : exp2f(x[n][2 + j] - lse[1]);
      }
    // ds = p * (dos . v^T - delta * scale).
    float dp[8][4];
    mma_abt(dp, dof, sv, g, t, 1.f, false);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        x[n][j] = x[n][j] * (dp[n][j] - dlt[0]);
        x[n][2 + j] = x[n][2 + j] * (dp[n][2 + j] - dlt[1]);
      }
    uint32_t dsf[4][4];
    acc_to_a(dsf, x);
    mma_am(dq, dsf, sk, lane);  // dq += ds . k
    __syncthreads();  // this buffer is refilled two tiles on
  }
  store_rows(static_cast<bf16*>(a.dq), dq, row, S, a.H, h, b, t);
}

// ---------------------------------------------------------------------------
// fp32 CUDA-core kernels
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 64;    // one thread per key (dkdv) or query (dq)
constexpr int kF32Stream = 16;  // streamed rows per shared tile
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

__global__ void __launch_bounds__(kF32Rows) dkdv_f32_kernel(Args a) {
  __shared__ float sK[kF32Rows * kPad];
  __shared__ float sV[kF32Rows * kPad];
  __shared__ __align__(16) float sQ[kF32Stream][kHeadDim];
  __shared__ __align__(16) float sDO[kF32Stream][kHeadDim];
  __shared__ float sL[kF32Stream];
  __shared__ float sD[kF32Stream];

  const int tid = threadIdx.x;
  const int key0 = blockIdx.x * kF32Rows;
  const int key = key0 + tid;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = a.S;
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
    for (int c = tid; c < kF32Rows * kHeadDim / 4; c += kF32Rows) {
      const int r = c / (kHeadDim / 4);
      const int col = (c % (kHeadDim / 4)) * 4;
      load_row4(sK + r * kPad, kb, a.ks.s, key0 + r, a.kv_len, col);
      load_row4(sV + r * kPad, vb, a.vs.s, key0 + r, a.kv_len, col);
    }
    const float* mk = sK + tid * kPad;
    const float* mv = sV + tid * kPad;
    const bool live = key < a.kv_len;
    for (int q0 = 0; q0 < S; q0 += kF32Stream) {
      __syncthreads();  // the previous tile is consumed (and sK/sV ready)
      for (int c = tid; c < kF32Stream * kHeadDim / 4; c += kF32Rows) {
        const int r = c / (kHeadDim / 4);
        const int col = (c % (kHeadDim / 4)) * 4;
        load_row4(sQ[r], qb, a.qs.s, q0 + r, S, col);
        load_row4(sDO[r], dob, a.dos.s, q0 + r, S, col);
      }
      if (tid < kF32Stream) {
        const int r = q0 + tid;
        sL[tid] = r < S ? a.lse[bh * S + r] : INFINITY;
        sD[tid] = r < S ? a.delta[bh * S + r] : 0.f;
      }
      __syncthreads();
      if (!live) continue;
      for (int j = 0; j < kF32Stream; ++j) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) {
          s = fmaf(sQ[j][d] * a.qscale, mk[d], s);
          dp = fmaf(sDO[j][d] * a.doscale, mv[d], dp);
        }
        const float p = exp2f(s - sL[j]);
        const float ds = p * (dp - sD[j] * a.scale);
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) {
          dv[d] = fmaf(p, sDO[j][d], dv[d]);
          dk[d] = fmaf(ds, sQ[j][d], dk[d]);
        }
      }
    }
  }
  if (key < S) {
    const long long off = ((static_cast<long long>(b) * S + key) * a.H + h) * kHeadDim;
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

__global__ void __launch_bounds__(kF32Rows) dq_f32_kernel(Args a) {
  __shared__ float sQ[kF32Rows * kPad];
  __shared__ float sDO[kF32Rows * kPad];
  __shared__ __align__(16) float sK[kF32Stream][kHeadDim];
  __shared__ __align__(16) float sV[kF32Stream][kHeadDim];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kF32Rows;
  const int row = q0 + tid;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = a.S;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const float* qb = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.ks.b + h * a.ks.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.vs.b + h * a.vs.h;
  const float* dob =
      static_cast<const float*>(a.dout) + b * a.dos.b + h * a.dos.h;

  for (int c = tid; c < kF32Rows * kHeadDim / 4; c += kF32Rows) {
    const int r = c / (kHeadDim / 4);
    const int col = (c % (kHeadDim / 4)) * 4;
    load_row4(sQ + r * kPad, qb, a.qs.s, q0 + r, S, col);
    load_row4(sDO + r * kPad, dob, a.dos.s, q0 + r, S, col);
  }
  const float lse = row < S ? a.lse[bh * S + row] : INFINITY;
  const float dlt = (row < S ? a.delta[bh * S + row] : 0.f) * a.scale;
  const float* mq = sQ + tid * kPad;
  const float* mdo = sDO + tid * kPad;

  float dq[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) dq[d] = 0.f;

  for (int key0 = 0; key0 < a.kv_len; key0 += kF32Stream) {
    __syncthreads();  // the previous tile is consumed (and sQ/sDO ready)
    for (int c = tid; c < kF32Stream * kHeadDim / 4; c += kF32Rows) {
      const int r = c / (kHeadDim / 4);
      const int col = (c % (kHeadDim / 4)) * 4;
      load_row4(sK[r], kb, a.ks.s, key0 + r, a.kv_len, col);
      load_row4(sV[r], vb, a.vs.s, key0 + r, a.kv_len, col);
    }
    __syncthreads();
    const int n = min(kF32Stream, a.kv_len - key0);
    for (int j = 0; j < n; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) {
        s = fmaf(mq[d] * a.qscale, sK[j][d], s);
        dp = fmaf(mdo[d] * a.doscale, sV[j][d], dp);
      }
      const float ds = exp2f(s - lse) * (dp - dlt);
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) dq[d] = fmaf(ds, sK[j][d], dq[d]);
    }
  }
  if (row < S) {
    float* op = static_cast<float*>(a.dq) +
                ((static_cast<long long>(b) * S + row) * a.H + h) * kHeadDim;
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 4)
      *reinterpret_cast<float4*>(op + d) =
          make_float4(dq[d], dq[d + 1], dq[d + 2], dq[d + 3]);
  }
}

}  // namespace

// Launches the backward (the dkdv pass, then the dq pass) on `stream` and
// returns the first launch error as a cudaError_t (0 on success).
// is_bf16: 1 for bf16 inputs and outputs, 0 for fp32. Strides are in
// elements; every pointer and stride must keep 16-byte alignment and
// head_dim must be 64 (the Python wrapper checks both).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dq, void* dk,
                              void* dv, int is_bf16, int batch, int seq,
                              int heads, int head_dim, int kv_len,
                              float qscale, float doscale, float scale,
                              long long q_sb, long long q_ss, long long q_sh,
                              long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh,
                              long long do_sb, long long do_ss,
                              long long do_sh, void* stream) {
  if (head_dim != kHeadDim || kv_len < 1 || kv_len > seq)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,      k,      v,      dout, lse,   delta,  dq,
         dk,     dv,     seq,    heads, kv_len, qscale, doscale,
         scale,  {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
         {v_sb, v_ss, v_sh}, {do_sb, do_ss, do_sh}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid((seq + kTile - 1) / kTile, heads, batch);
    dkdv_bf16_kernel<<<grid, kThreads, 0, st>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dq_bf16_kernel<<<grid, kThreads, 0, st>>>(a);
  } else {
    const dim3 grid((seq + kF32Rows - 1) / kF32Rows, heads, batch);
    dkdv_f32_kernel<<<grid, kF32Rows, 0, st>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dq_f32_kernel<<<grid, kF32Rows, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by flash_attn_bwd.
extern "C" const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
