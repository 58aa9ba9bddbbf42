// Flash-attention backward over [B, H, S, 64] heads for Hopper (sm_90a),
// plain C interface: one fused pass, dq accumulated by atomics.
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
// 86 us at 3.35 TB/s.
//
// Design. The TPU kernel walks its key blocks in order and carries dq in
// a revisited fp32 output across them. Hopper's blocks run in no order, so
// one block per (128-key tile, head, batch) loops over all 64-row q tiles
// itself: for each it recomputes s and p, adds p^T dO into dv and ds^T q
// into dk (fp32 registers, each of the 8 warps owning 16 keys, in the
// transposed orientation so p^T and ds^T are A operands straight from the
// accumulators), stages ds^T in shared memory as bf16, and then the 8
// warps multiply ds by the block's k tile (4 row groups x 2 halves of the
// head dims) and add that q tile's dq share into the scratch with
// float2 atomics. Five products per (q tile, key tile) pair, where the
// flat kernel B2's two deterministic passes take seven. The atomics add
// the 13 key tiles' shares (at 1601 keys) in an order that changes from
// run to run, so dq differs between runs in its last fp32 bits, and after
// the cast to bf16 an element may round to the neighbouring value; dk and
// dv are deterministic. The order was kept free on purpose: per-q-tile
// semaphores would serialise the key tiles of one head. K/V, q and dO
// tiles arrive by cp.async (q/dO double-buffered); all products run on
// the tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate),
// operands needed transposed are read with ldmatrix.trans. 74 KB of
// dynamic shared memory. fp32 inputs take a CUDA-core kernel (one thread
// per key; the dq share summed through shared memory, one thread per head
// dim), since the tensor cores would round to tf32.

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
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kKeys = 128;  // keys per block, 16 per warp
constexpr int kTileQ = 64;  // rows of a streamed q / dO tile
constexpr int kWarps = kKeys / 16;
constexpr int kThreads = kWarps * 32;
// Row pitch of the shared tiles: 64 + 8 bf16 = 144 bytes keeps the
// 16-byte cp.async/ldmatrix rows aligned and spreads the fragment loads
// of one warp over all 32 banks.
constexpr int kLd = kHeadDim + 8;
// sK and sDS [kKeys][kLd], sQ and sDO [2][kTileQ][kLd] bf16, then the lse
// and delta of two q tiles in fp32.
constexpr int kSmemBytes =
    (2 * kKeys + 4 * kTileQ) * kLd * 2 + 4 * kTileQ * 4;

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

// Rows [row0, row0 + ROWS) of one head's [S, 64] matrix into a shared
// tile; rows at or past `n_valid` are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_rows(bf16* tile, const bf16* base,
                                          long long row_stride, int row0,
                                          int n_valid, int tid) {
#pragma unroll
  for (int i = 0; i < (ROWS * kHeadDim / 8) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 3;
    const int col = (c & 7) * 8;
    const int row = row0 + r;
    const bool valid = row < n_valid;
    const bf16* src = base + (valid ? row : 0) * row_stride + col;
    cp_async16(tile + r * kLd + col, src, valid);
  }
}

// lse and delta of q rows [q0, q0 + kTileQ); rows at or past q_len get
// lse +inf, which makes their p exactly 0.
__device__ __forceinline__ void load_stats(float* sl, float* sd, const Args& a,
                                           long long bh, int q0, int tid) {
  if (tid < kTileQ) {
    const int r = q0 + tid;
    sl[tid] = r < a.q_len ? a.lse[bh * a.Sq + r] : INFINITY;
  } else if (tid < 2 * kTileQ) {
    const int r = q0 + tid - kTileQ;
    sd[tid - kTileQ] = r < a.q_len ? a.delta[bh * a.Sq + r] : 0.f;
  }
}

// A fragments of the 16 x 64 row block at `rows` (row pitch kLd).
__device__ __forceinline__ void a_frags(uint32_t (&f)[kHeadDim / 16][4],
                                        const bf16* rows, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    f[kk][0] = raw_pair(rows + g * kLd + c);
    f[kk][1] = raw_pair(rows + (g + 8) * kLd + c);
    f[kk][2] = raw_pair(rows + g * kLd + c + 8);
    f[kk][3] = raw_pair(rows + (g + 8) * kLd + c + 8);
  }
}

// acc[n] (16 x 8 tiles, n = 0..7) = A (16 x 64) . B^T, where B is a
// 64 x 64 shared tile whose rows are the n index (row pitch kLd), each B
// value multiplied by `mult` in bf16 first.
__device__ __forceinline__ void mma_abt(float (&acc)[8][4],
                                        const uint32_t (&a)[4][4],
                                        const bf16* b_rows, int g, int t,
                                        float mult) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      const bf16* bp = b_rows + (n * 8 + g) * kLd + kk * 16 + t * 2;
      mma_16816(acc[n], a[kk], scaled_pair(bp, mult),
                scaled_pair(bp + 8, mult));
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

__global__ void __launch_bounds__(kThreads, 1) bhsd_bwd_bf16_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);  // the block's k tile
  bf16* sDS = sK + kKeys * kLd;  // v at the start, then ds^T of a q tile
  bf16* sQ = sDS + kKeys * kLd;                 // [2][kTileQ * kLd]
  bf16* sDO = sQ + 2 * kTileQ * kLd;            // [2][kTileQ * kLd]
  float* sL = reinterpret_cast<float*>(sDO + 2 * kTileQ * kLd);  // [2][kTileQ]
  float* sD = sL + 2 * kTileQ;                                   // [2][kTileQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mi = lane >> 3;
  const int mr = lane & 7;
  const int key0 = blockIdx.x * kKeys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
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
    const int n_qt = (a.q_len + kTileQ - 1) / kTileQ;
    load_rows<kKeys>(sK, kb, a.ks.s, key0, a.kv_len, tid);
    load_rows<kKeys>(sDS, vb, a.vs.s, key0, a.kv_len, tid);
    load_rows<kTileQ>(sQ, qb, a.qs.s, 0, a.q_len, tid);
    load_rows<kTileQ>(sDO, dob, a.dos.s, 0, a.q_len, tid);
    cp_async_commit();
    load_stats(sL, sD, a, bh, 0, tid);
    cp_async_wait<0>();
    __syncthreads();
    uint32_t kf[4][4], vf[4][4];  // this warp's 16 keys of k and v
    a_frags(kf, sK + warp * 16 * kLd, g, t);
    a_frags(vf, sDS + warp * 16 * kLd, g, t);
    __syncthreads();  // sDS now takes ds^T
    const int my_key = key0 + warp * 16 + g;  // rows my_key, my_key + 8
    const bool kmask0 = my_key >= a.kv_len;
    const bool kmask1 = my_key + 8 >= a.kv_len;
    // The dq product's share of this warp: 16 q rows x 32 head dims.
    const int rg = warp & 3;
    const int dhalf = warp >> 2;

    for (int qt = 0; qt < n_qt; ++qt) {
      const int buf = qt & 1;
      if (qt + 1 < n_qt) {
        const int nb = buf ^ 1;
        const int q1 = (qt + 1) * kTileQ;
        load_rows<kTileQ>(sQ + nb * kTileQ * kLd, qb, a.qs.s, q1, a.q_len, tid);
        load_rows<kTileQ>(sDO + nb * kTileQ * kLd, dob, a.dos.s, q1, a.q_len,
                          tid);
        cp_async_commit();
        load_stats(sL + nb * kTileQ, sD + nb * kTileQ, a, bh, q1, tid);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* sq = sQ + buf * kTileQ * kLd;
      const bf16* sdo = sDO + buf * kTileQ * kLd;
      const float* lse = sL + buf * kTileQ;
      const float* dlt = sD + buf * kTileQ;

      // p^T = exp2(k . qs^T - lse): 16 keys x 64 queries.
      float x[8][4];
      mma_abt(x, kf, sq, g, t, a.qscale);
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
      mma_abt(dp, vf, sdo, g, t, a.doscale);
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

      // ds^T in bf16 into this warp's 16 rows of sDS (keys x queries).
      bf16* dsw = sDS + warp * 16 * kLd;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        *reinterpret_cast<uint32_t*>(dsw + g * kLd + n * 8 + t * 2) =
            dsf[n >> 1][(n & 1) * 2];
        *reinterpret_cast<uint32_t*>(dsw + (g + 8) * kLd + n * 8 + t * 2) =
            dsf[n >> 1][(n & 1) * 2 + 1];
      }
      __syncthreads();

      // dq share = ds (64 queries x 128 keys) . k (128 keys x 64 dims):
      // ds's A fragments come from ds^T by ldmatrix.trans (matrices:
      // keys 0-7 | 8-15 x queries 0-7 | 8-15), k's B fragments as in
      // mma_am.
      float dqa[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) dqa[n][j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_x4_trans(
            af, sDS + (kk * 16 + (mi >> 1) * 8 + mr) * kLd + rg * 16 + (mi & 1) * 8);
#pragma unroll
        for (int np2 = 0; np2 < 2; ++np2) {
          const int np = dhalf * 2 + np2;
          uint32_t bf[4];
          ldmatrix_x4_trans(
              bf, sK + (kk * 16 + (mi & 1) * 8 + mr) * kLd + (np * 2 + (mi >> 1)) * 8);
          mma_16816(dqa[np2 * 2], af, bf[0], bf[1]);
          mma_16816(dqa[np2 * 2 + 1], af, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = qt * kTileQ + rg * 16 + g + r * 8;
        if (row >= a.q_len) continue;
        float* dst = a.dq +
                     ((static_cast<long long>(b) * a.Sq + row) * a.H + h) * kHeadDim +
                     dhalf * 32 + t * 2;
#pragma unroll
        for (int n = 0; n < 4; ++n)
          atomicAdd(reinterpret_cast<float2*>(dst + n * 8),
                    make_float2(dqa[n][2 * r], dqa[n][2 * r + 1]));
      }
      __syncthreads();  // sDS and this q buffer are rewritten next
    }
  }
  const int row = key0 + warp * 16 + g;
  store_rows(static_cast<bf16*>(a.dk), dk, row, a.Sk, a.H, h, b, t);
  store_rows(static_cast<bf16*>(a.dv), dv, row, a.Sk, a.H, h, b, t);
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
    const float* mk = sK + tid * kPad;
    const float* mv = sV + tid * kPad;
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
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) {
          s = fmaf(sQ[j][d] * a.qscale, mk[d], s);
          dp = fmaf(sDO[j][d] * a.doscale, mv[d], dp);
        }
        const float p = live ? exp2f(s - sL[j]) : 0.f;
        const float ds = p * (dp - sD[j] * a.scale);
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) {
          dv[d] = fmaf(p, sDO[j][d], dv[d]);
          dk[d] = fmaf(ds, sQ[j][d], dk[d]);
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
// wrapper checks both).
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
                                   long long do_sh, void* stream) {
  if (head_dim != kHeadDim || kv_len < 1 || kv_len > seq_k || q_len < 1 ||
      q_len > seq_q)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q,      k,      v,      dout,   lse,     delta,
         dq,     dk,     dv,     seq_q,  seq_k,   heads,
         kv_len, q_len,  qscale, doscale, scale,
         {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
         {v_sb, v_ss, v_sh}, {do_sb, do_ss, do_sh}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    cudaError_t err = cudaFuncSetAttribute(
        bhsd_bwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((seq_k + kKeys - 1) / kKeys, heads, batch);
    bhsd_bwd_bf16_kernel<<<grid, kThreads, kSmemBytes, st>>>(a);
  } else {
    const dim3 grid((seq_k + kF32Keys - 1) / kF32Keys, heads, batch);
    bhsd_bwd_f32_kernel<<<grid, kF32Keys, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by flash_attn_bhsd_bwd.
extern "C" const char* flash_attn_bhsd_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
