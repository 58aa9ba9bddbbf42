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
// dq's low bits vary from run to run). The bf16 kernel is the one the flat
// backward (B2) launches too, `bwd_units::body` in flash_bwd_units.cuh
// (whose note gives the design): 64-row dq units and dkv units, one
// persistent launch of a producer warpgroup and two consumer warpgroups
// on TMA and wgmma, seven products per tile pair for no atomics, dq, dk and
// dv bit-equal from run to run. The work counts units, not 128-row blocks,
// so at 257 tokens the one-row tail units are a fifth of the work, not a
// third. fp32 inputs take CUDA-core kernels with the same two roles (one
// thread per key, one per query row), since the tensor cores would round
// to tf32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bwd_units.cuh"

namespace {

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
// bf16 kernel: the shared units kernel (flash_bwd_units.cuh) under this
// source's own name
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(bwd_units::kThreads, 1)
    allheads_bwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const bwd_units::UnitArgs a) {
  bwd_units::body(q_map, k_map, v_map, do_map, a);
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
      // The own rows and the streamed rows are read from shared memory at
      // each use (volatile): held in registers they would take 128 more
      // beside dk and dv, and spill.
      const volatile float* mk = sm.own_a + tid * kPad;
      const volatile float* mv = sm.own_b + tid * kPad;
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
          const volatile float* qj = sm.sa[j];
          const volatile float* doj = sm.sb[j];
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int d = 0; d < kHeadDim; ++d) {
            s = fmaf(qj[d] * a.qscale, mk[d], s);
            dp = fmaf(doj[d] * a.doscale, mv[d], dp);
          }
          const float p = live ? exp2f(s - sm.sl[j]) : 0.f;
          const float ds = p * (dp - sm.sd[j] * a.scale);
#pragma unroll
          for (int d = 0; d < kHeadDim; ++d) {
            dv[d] = fmaf(p, doj[d], dv[d]);
            dk[d] = fmaf(ds, qj[d], dk[d]);
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
    const volatile float* mq = sm.own_a + tid * kPad;  // as above
    const volatile float* mdo = sm.own_b + tid * kPad;
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
        const volatile float* kj = sm.sa[j];
        const volatile float* vj = sm.sb[j];
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) {
          s = fmaf(mq[d] * a.qscale, kj[d], s);
          dp = fmaf(mdo[d] * a.doscale, vj[d], dp);
        }
        const float ds = exp2f(s - lse) * (dp - dlt);
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) dq[d] = fmaf(ds, kj[d], dq[d]);
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
// (the Python wrapper checks both). tma: for bf16, the tensor-map specs
// (hopper.cuh) of q, k, v and dO, in that order, 16 int64 each (boxes of
// 64 rows of one head); unused for fp32.
extern "C" int flash_attn_allheads_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    int is_bf16, int batch, int seq_q, int seq_k, int heads, int head_dim,
    int kv_len, int q_len, float qscale, float doscale, float scale,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long do_sb, long long do_ss, long long do_sh,
    const long long* tma, void* stream) {
  if (head_dim != kHeadDim || kv_len < 1 || kv_len > seq_k || q_len < 1 ||
      q_len > seq_q)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return bwd_units::launch(allheads_bwd_bf16_kernel, q, k, v, dout, lse,
                             delta, dq, dk, dv, batch, seq_q, seq_k, heads,
                             kv_len, q_len, qscale, doscale, scale, tma, st);
  const int n_key_blocks = (seq_k + kF32Block - 1) / kF32Block;
  const int n_q_blocks = (seq_q + kF32Block - 1) / kF32Block;
  Args a{q,      k,       v,      dout,         lse,     delta,
         dq,     dk,      dv,     seq_q,        seq_k,   heads,
         kv_len, q_len,   n_key_blocks, qscale, doscale, scale,
         {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
         {v_sb, v_ss, v_sh}, {do_sb, do_ss, do_sh}};
  const dim3 grid(n_key_blocks + n_q_blocks, heads, batch);
  allheads_bwd_f32_kernel<<<grid, kF32Block, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by flash_attn_allheads_bwd.
extern "C" const char* flash_attn_allheads_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
