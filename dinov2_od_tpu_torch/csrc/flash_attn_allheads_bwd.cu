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
// dq's low bits vary from run to run). Here the grid splits in two roles,
// one launch: blocks [0, n_key_tiles) of each (head, batch) own 128 keys (8
// warps of 16) and loop over 64-row q/dO tiles, adding p^T dO into dv and
// ds^T q into dk in fp32 registers (the transposed orientation makes p^T and
// ds^T A operands straight from the accumulators), as B5b does, without its
// dq share; blocks past them own 128 query rows (8 warps of 16), keep their
// q (scaled) and dO (scaled) fragments in registers, stream 64-key K/V
// tiles, recompute s, p, dp and ds, and add ds k into a dq accumulator in
// registers, which each block writes once. Seven products per (q tile, key
// tile) pair where the TPU kernel takes five, in exchange for no atomics: dq,
// dk and dv are all deterministic. Tiles arrive by cp.async, double
// buffered; all products run on mma.sync m16n8k16 (bf16 in, fp32
// accumulate), operands needed transposed are read with ldmatrix.trans. fp32
// inputs take CUDA-core kernels with the same two roles (one thread per key,
// one per query row), since the tensor cores would round to tf32.

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
  int Sq, Sk, H, kv_len, q_len;
  int n_key_blocks;  // blocks of the dk/dv role per (head, batch)
  float qscale;      // bf(scale * log2 e), q's multiplier in s
  float doscale;     // scale in the input type, dO's multiplier in dp
  float scale;       // scale in fp32, delta's multiplier in ds
  Strides qs, ks, vs, dos;
};

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kKeys = 128;  // keys per dk/dv block, 16 per warp
constexpr int kRows = 128;  // query rows per dq block, 16 per warp
constexpr int kTile = 64;   // rows of a streamed q/dO or K/V tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// Row pitch of the shared tiles: 64 + 8 bf16 = 144 bytes keeps the 16-byte
// cp.async/ldmatrix rows aligned and spreads the fragment loads of one warp
// over all 32 banks.
constexpr int kLd = kHeadDim + 8;
// dk/dv role: k and v staging [kKeys][kLd] each, q and dO [2][kTile][kLd]
// each, lse and delta of two q tiles. dq role: q and dO staging [kRows][kLd]
// each, then K and V [2][kTile][kLd] each. The larger of the two.
constexpr int kDkvSmem = (2 * kKeys + 4 * kTile) * kLd * 2 + 4 * kTile * 4;
constexpr int kDqSmem = (2 * kRows + 4 * kTile) * kLd * 2;
constexpr int kSmemBytes = kDkvSmem > kDqSmem ? kDkvSmem : kDqSmem;

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

// lse and delta of q rows [q0, q0 + kTile); rows at or past q_len get
// lse +inf, which makes their p exactly 0.
__device__ __forceinline__ void load_stats(float* sl, float* sd, const Args& a,
                                           long long bh, int q0, int tid) {
  if (tid < kTile) {
    const int r = q0 + tid;
    sl[tid] = r < a.q_len ? a.lse[bh * a.Sq + r] : INFINITY;
  } else if (tid < 2 * kTile) {
    const int r = q0 + tid - kTile;
    sd[tid - kTile] = r < a.q_len ? a.delta[bh * a.Sq + r] : 0.f;
  }
}

// A fragments of the 16 x 64 row block at `rows` (row pitch kLd), each
// value multiplied by `mult` in bf16 unless mult is 1.
__device__ __forceinline__ void a_frags(uint32_t (&f)[kHeadDim / 16][4],
                                        const bf16* rows, int g, int t,
                                        float mult = 1.f) {
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
    const int c = kk * 16 + t * 2;
    const bf16* r0 = rows + g * kLd + c;
    const bf16* r1 = rows + (g + 8) * kLd + c;
    if (mult == 1.f) {
      f[kk][0] = raw_pair(r0);
      f[kk][1] = raw_pair(r1);
      f[kk][2] = raw_pair(r0 + 8);
      f[kk][3] = raw_pair(r1 + 8);
    } else {
      f[kk][0] = scaled_pair(r0, mult);
      f[kk][1] = scaled_pair(r1, mult);
      f[kk][2] = scaled_pair(r0 + 8, mult);
      f[kk][3] = scaled_pair(r1 + 8, mult);
    }
  }
}

// acc[n] (16 x 8 tiles, n = 0..7) = A (16 x 64) . B^T, where B is a
// 64 x 64 shared tile whose rows are the n index (row pitch kLd), each B
// value multiplied by `mult` in bf16 first unless mult is 1.
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
      if (mult == 1.f)
        mma_16816(acc[n], a[kk], raw_pair(bp), raw_pair(bp + 8));
      else
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

// The dk/dv role: 128 keys, every q tile.
__device__ __forceinline__ void dkdv_bf16(const Args& a, unsigned char* smem,
                                          int key0, int h, int b) {
  bf16* sK = reinterpret_cast<bf16*>(smem);  // the block's k rows
  bf16* sV = sK + kKeys * kLd;               // the block's v rows
  bf16* sQ = sV + kKeys * kLd;               // [2][kTile * kLd]
  bf16* sDO = sQ + 2 * kTile * kLd;          // [2][kTile * kLd]
  float* sL = reinterpret_cast<float*>(sDO + 2 * kTile * kLd);  // [2][kTile]
  float* sD = sL + 2 * kTile;                                   // [2][kTile]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
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
    const int n_qt = (a.q_len + kTile - 1) / kTile;
    load_rows<kKeys>(sK, kb, a.ks.s, key0, a.kv_len, tid);
    load_rows<kKeys>(sV, vb, a.vs.s, key0, a.kv_len, tid);
    load_rows<kTile>(sQ, qb, a.qs.s, 0, a.q_len, tid);
    load_rows<kTile>(sDO, dob, a.dos.s, 0, a.q_len, tid);
    cp_async_commit();
    load_stats(sL, sD, a, bh, 0, tid);
    cp_async_wait<0>();
    __syncthreads();
    uint32_t kf[4][4], vf[4][4];  // this warp's 16 keys of k and v
    a_frags(kf, sK + warp * 16 * kLd, g, t);
    a_frags(vf, sV + warp * 16 * kLd, g, t);
    const int my_key = key0 + warp * 16 + g;  // rows my_key, my_key + 8
    const bool kmask0 = my_key >= a.kv_len;
    const bool kmask1 = my_key + 8 >= a.kv_len;

    for (int qt = 0; qt < n_qt; ++qt) {
      const int buf = qt & 1;
      if (qt + 1 < n_qt) {
        const int nb = buf ^ 1;
        const int q1 = (qt + 1) * kTile;
        load_rows<kTile>(sQ + nb * kTile * kLd, qb, a.qs.s, q1, a.q_len, tid);
        load_rows<kTile>(sDO + nb * kTile * kLd, dob, a.dos.s, q1, a.q_len,
                         tid);
        cp_async_commit();
        load_stats(sL + nb * kTile, sD + nb * kTile, a, bh, q1, tid);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* sq = sQ + buf * kTile * kLd;
      const bf16* sdo = sDO + buf * kTile * kLd;
      const float* lse = sL + buf * kTile;
      const float* dlt = sD + buf * kTile;

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
      __syncthreads();  // this q buffer is refilled next
    }
  }
  const int row = key0 + warp * 16 + g;
  store_rows(static_cast<bf16*>(a.dk), dk, row, a.Sk, a.H, h, b, t);
  store_rows(static_cast<bf16*>(a.dv), dv, row, a.Sk, a.H, h, b, t);
}

// The dq role: 128 query rows, every key tile.
__device__ __forceinline__ void dq_bf16(const Args& a, unsigned char* smem,
                                        int q0, int h, int b) {
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [kRows * kLd]
  bf16* sDO = sQ + kRows * kLd;              // [kRows * kLd]
  bf16* sK = sDO + kRows * kLd;              // [2][kTile * kLd]
  bf16* sV = sK + 2 * kTile * kLd;           // [2][kTile * kLd]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long bh = static_cast<long long>(b) * a.H + h;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qs.b + h * a.qs.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks.b + h * a.ks.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs.b + h * a.vs.h;
  const bf16* dob =
      static_cast<const bf16*>(a.dout) + b * a.dos.b + h * a.dos.h;

  float dq[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[n][j] = 0.f;

  if (q0 < a.q_len) {  // rows past q_len only keep dq = 0
    const int n_kt = (a.kv_len + kTile - 1) / kTile;
    load_rows<kRows>(sQ, qb, a.qs.s, q0, a.q_len, tid);
    load_rows<kRows>(sDO, dob, a.dos.s, q0, a.q_len, tid);
    load_rows<kTile>(sK, kb, a.ks.s, 0, a.kv_len, tid);
    load_rows<kTile>(sV, vb, a.vs.s, 0, a.kv_len, tid);
    cp_async_commit();
    // lse and delta of rows g and g + 8 of this warp.
    float lse[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + r * 8;
      const bool live = row < a.q_len;
      lse[r] = live ? a.lse[bh * a.Sq + row] : INFINITY;
      dlt[r] = live ? a.delta[bh * a.Sq + row] * a.scale : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    uint32_t qf[4][4], dof[4][4];  // this warp's 16 rows, scaled in bf16
    a_frags(qf, sQ + warp * 16 * kLd, g, t, a.qscale);
    a_frags(dof, sDO + warp * 16 * kLd, g, t, a.doscale);

    for (int kt = 0; kt < n_kt; ++kt) {
      const int buf = kt & 1;
      if (kt + 1 < n_kt) {
        const int nb = buf ^ 1;
        const int k1 = (kt + 1) * kTile;
        load_rows<kTile>(sK + nb * kTile * kLd, kb, a.ks.s, k1, a.kv_len, tid);
        load_rows<kTile>(sV + nb * kTile * kLd, vb, a.vs.s, k1, a.kv_len, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* sk = sK + buf * kTile * kLd;
      const bf16* sv = sV + buf * kTile * kLd;
      const int key0 = kt * kTile;

      // p = exp2(qs . k^T - lse): 16 rows x 64 keys.
      float x[8][4];
      mma_abt(x, qf, sk, g, t, 1.f);
      float dp[8][4];
      mma_abt(dp, dof, sv, g, t, 1.f);  // dp = dos . v^T
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool live = key0 + n * 8 + t * 2 + j < a.kv_len;
          const float p0 = live ? exp2f(x[n][j] - lse[0]) : 0.f;
          const float p1 = live ? exp2f(x[n][2 + j] - lse[1]) : 0.f;
          x[n][j] = p0 * (dp[n][j] - dlt[0]);
          x[n][2 + j] = p1 * (dp[n][2 + j] - dlt[1]);
        }
      uint32_t dsf[4][4];
      acc_to_a(dsf, x);
      mma_am(dq, dsf, sk, lane);  // dq += ds . k
      __syncthreads();  // this K/V buffer is refilled next
    }
  }
  store_rows(static_cast<bf16*>(a.dq), dq, q0 + warp * 16 + g, a.Sq, a.H, h,
             b, t);
}

__global__ void __launch_bounds__(kThreads, 1) allheads_bwd_bf16_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  if (static_cast<int>(blockIdx.x) < a.n_key_blocks)
    dkdv_bf16(a, smem, blockIdx.x * kKeys, h, b);
  else
    dq_bf16(a, smem, (blockIdx.x - a.n_key_blocks) * kRows, h, b);
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
      const float* mk = sm.own_a + tid * kPad;
      const float* mv = sm.own_b + tid * kPad;
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
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int d = 0; d < kHeadDim; ++d) {
            s = fmaf(sm.sa[j][d] * a.qscale, mk[d], s);
            dp = fmaf(sm.sb[j][d] * a.doscale, mv[d], dp);
          }
          const float p = live ? exp2f(s - sm.sl[j]) : 0.f;
          const float ds = p * (dp - sm.sd[j] * a.scale);
#pragma unroll
          for (int d = 0; d < kHeadDim; ++d) {
            dv[d] = fmaf(p, sm.sb[j][d], dv[d]);
            dk[d] = fmaf(ds, sm.sa[j][d], dk[d]);
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
    const float* mq = sm.own_a + tid * kPad;
    const float* mdo = sm.own_b + tid * kPad;
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
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) {
          s = fmaf(mq[d] * a.qscale, sm.sa[j][d], s);
          dp = fmaf(mdo[d] * a.doscale, sm.sb[j][d], dp);
        }
        const float ds = exp2f(s - lse) * (dp - dlt);
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) dq[d] = fmaf(ds, sm.sa[j][d], dq[d]);
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
// (the Python wrapper checks both).
extern "C" int flash_attn_allheads_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    int is_bf16, int batch, int seq_q, int seq_k, int heads, int head_dim,
    int kv_len, int q_len, float qscale, float doscale, float scale,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long do_sb, long long do_ss, long long do_sh,
    void* stream) {
  if (head_dim != kHeadDim || kv_len < 1 || kv_len > seq_k || q_len < 1 ||
      q_len > seq_q)
    return static_cast<int>(cudaErrorInvalidValue);
  const int key_rows = is_bf16 ? kKeys : kF32Block;
  const int q_rows = is_bf16 ? kRows : kF32Block;
  const int n_key_blocks = (seq_k + key_rows - 1) / key_rows;
  const int n_q_blocks = (seq_q + q_rows - 1) / q_rows;
  Args a{q,      k,       v,      dout,         lse,     delta,
         dq,     dk,      dv,     seq_q,        seq_k,   heads,
         kv_len, q_len,   n_key_blocks, qscale, doscale, scale,
         {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
         {v_sb, v_ss, v_sh}, {do_sb, do_ss, do_sh}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_key_blocks + n_q_blocks, heads, batch);
  if (is_bf16) {
    cudaError_t err = cudaFuncSetAttribute(
        allheads_bwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    allheads_bwd_bf16_kernel<<<grid, kThreads, kSmemBytes, st>>>(a);
  } else {
    allheads_bwd_f32_kernel<<<grid, kF32Block, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by flash_attn_allheads_bwd.
extern "C" const char* flash_attn_allheads_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
