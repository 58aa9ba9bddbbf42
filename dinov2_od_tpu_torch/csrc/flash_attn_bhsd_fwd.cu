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
//
// What cannot carry over from the TPU: `_fwd_kernel` stages the whole K/V
// of one head in VMEM (404 KiB at 1616 tokens in bf16) and takes one
// 816-row q block; a Hopper block has 227 KB of shared memory. So K/V
// tiles of 64 keys stream through double-buffered shared memory (cp.async)
// with an online softmax (running max and sum in fp32 registers), and the
// [Sq, Sk] logits never leave registers.
//
// Design for long sequences: one thread block per (128-query tile, head,
// batch), 8 warps of 16 query rows each, twice the rows of B1's block, so
// each K/V tile read from L2 feeds twice the products (13 re-reads of a
// head's K/V at 1601 tokens, not 26) while 8 x 16 x 13 = 1664 blocks stay
// in flight. The q tile is staged once through the second K/V buffers and
// kept as register fragments. Both products run on the tensor cores with
// mma.sync m16n8k16 (bf16 in, fp32 accumulate); v is read transposed with
// ldmatrix.trans. wgmma, TMA and warp specialisation are later work.
// fp32 route: the tensor cores would round to tf32, so fp32 inputs take a
// CUDA-core kernel with one thread per query row.

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

constexpr int kBlockK = 64;          // keys per shared K/V tile
constexpr int kWarps = 8;            // 16 query rows each
constexpr int kBlockQ = kWarps * 16;  // 128 query rows per block
constexpr int kThreads = kWarps * 32;
// Row pitch of the shared tiles: 64 + 8 bf16 = 144 bytes, which keeps the
// 16-byte cp.async/ldmatrix rows aligned and spreads the fragment loads
// of one warp over all 32 banks.
constexpr int kLd = kHeadDim + 8;

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

__global__ void __launch_bounds__(kThreads)
    bhsd_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int Sq, int H, int kv_len,
                         float qscale, Strides qs, Strides ks, Strides vs) {
  __shared__ __align__(16) bf16 sK[2][kBlockK * kLd];
  __shared__ __align__(16) bf16 sV[2][kBlockK * kLd];

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

  // The 128 q rows go through the second K/V buffers (rows 0-63 in sK[1],
  // 64-127 in sV[1]), with the first K/V tile; rows past Sq are zeros.
  load_tile(sK[1], qb, qs.s, q0, Sq, tid);
  load_tile(sV[1], qb, qs.s, q0 + kBlockK, Sq, tid);
  load_tile(sK[0], kb, ks.s, 0, kv_len, tid);
  load_tile(sV[0], vb, vs.s, 0, kv_len, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[kHeadDim / 16][4];  // A fragments of this warp's 16 q rows
  {
    const bf16* qw = (warp < 4 ? sK[1] : sV[1]) + (warp & 3) * 16 * kLd;
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk) {
      const int c = kk * 16 + t * 2;
      qf[kk][0] = scaled_pair(qw + g * kLd + c, qscale);
      qf[kk][1] = scaled_pair(qw + (g + 8) * kLd + c, qscale);
      qf[kk][2] = scaled_pair(qw + g * kLd + c + 8, qscale);
      qf[kk][3] = scaled_pair(qw + (g + 8) * kLd + c + 8, qscale);
    }
  }
  __syncthreads();  // buffers 1 now take the second K/V tile

  float acc[kHeadDim / 8][4];  // o accumulator, 8 tiles of 8 dims
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) {
      const int nb = (kt + 1) & 1;
      load_tile(sK[nb], kb, ks.s, (kt + 1) * kBlockK, kv_len, tid);
      load_tile(sV[nb], vb, vs.s, (kt + 1) * kBlockK, kv_len, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sk = sK[kt & 1];
    const bf16* sv = sV[kt & 1];

    // s = q k^T over this tile's 64 keys: 8 tiles of 8 keys.
    float s[kBlockK / 8][4];
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
    const int key0 = kt * kBlockK;
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

    // Online softmax: the 4 threads of a group share each row.
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }

    // p in bf16, laid out as the A fragments of the p.v product: the
    // accumulator of key tiles 2j and 2j+1 is the A operand of k-step j.
    uint32_t pf[kBlockK / 16][4];
    float rs[2] = {0.f, 0.f};
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
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_run[r] = l_run[r] * corr[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // o += p v. ldmatrix.x4.trans hands each lane the B fragments of two
    // 8-dim tiles for 16 keys: matrices (keys 0-7 | 8-15) x (tile 2j | 2j+1).
    const int mi = lane >> 3;
    const int mr = lane & 7;
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
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= Sq) continue;
    bf16* op = o + ((static_cast<long long>(b) * Sq + row) * H + h) * kHeadDim;
#pragma unroll
    for (int n = 0; n < kHeadDim / 8; ++n)
      *reinterpret_cast<bf162*>(op + n * 8 + t * 2) = __floats2bfloat162_rn(
          acc[n][2 * r] / l_run[r], acc[n][2 * r + 1] / l_run[r]);
    if (t == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + row] =
          m_run[r] + log2f(l_run[r]);
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
extern "C" int flash_attn_bhsd_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int is_bf16, int batch,
                                   int seq_q, int seq_k, int heads,
                                   int head_dim, int kv_len, float qscale,
                                   long long q_sb, long long q_ss,
                                   long long q_sh, long long k_sb,
                                   long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss,
                                   long long v_sh, void* stream) {
  if (head_dim != kHeadDim || seq_q < 1 || kv_len < 1 || kv_len > seq_k)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const dim3 grid((seq_q + kBlockQ - 1) / kBlockQ, heads, batch);
    bhsd_fwd_bf16_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, seq_q, heads,
        kv_len, qscale, qs, ks, vs);
  } else {
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
