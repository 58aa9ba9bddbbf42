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
// can be carried between them, and summing dq across key tiles by atomics
// would make its low bits vary from run to run. The bf16 kernel is the one
// the all-heads backward (B4b) launches, `bwd_units::body` in
// flash_bwd_units.cuh, whose note gives the design: one persistent launch
// of 64-row dkv units (dk and dv of 64 keys over every q tile) and dq
// units (dq of 64 rows over every key tile), a producer warpgroup bringing
// the tiles by TMA through the real strides and two consumer warpgroups on
// wgmma; seven products per tile pair where the TPU kernel does five (s
// and dp recomputed so that dq is written once), no atomics, so dq, dk and
// dv are bit-equal from run to run. At the train shape that is 3840 units
// of 5 tiles, about 14.5 a consumer warpgroup. fp32 inputs take CUDA-core
// kernels in two passes, one thread per key (dkdv) or per query (dq),
// since the tensor cores would round to tf32.

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
  int S, H, kv_len;
  float qscale;   // bf(scale * log2 e), q's multiplier in s
  float doscale;  // scale in the input type, dO's multiplier in dp
  float scale;    // scale in fp32, delta's multiplier in ds
  Strides qs, ks, vs, dos;
};

// ---------------------------------------------------------------------------
// bf16 kernel: the shared units kernel (flash_bwd_units.cuh) under this
// source's own name
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(bwd_units::kThreads, 1)
    flat_bwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const bwd_units::UnitArgs a) {
  bwd_units::body(q_map, k_map, v_map, do_map, a);
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
    // The own rows and the streamed rows are read from shared memory at
    // each use (volatile): held in registers they would take 128 more
    // beside dk and dv, and spill.
    const volatile float* mk = sK + tid * kPad;
    const volatile float* mv = sV + tid * kPad;
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
        const volatile float* qj = sQ[j];
        const volatile float* doj = sDO[j];
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) {
          s = fmaf(qj[d] * a.qscale, mk[d], s);
          dp = fmaf(doj[d] * a.doscale, mv[d], dp);
        }
        const float p = exp2f(s - sL[j]);
        const float ds = p * (dp - sD[j] * a.scale);
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) {
          dv[d] = fmaf(p, doj[d], dv[d]);
          dk[d] = fmaf(ds, qj[d], dk[d]);
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
  const volatile float* mq = sQ + tid * kPad;  // as in dkdv_f32_kernel
  const volatile float* mdo = sDO + tid * kPad;

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
      const volatile float* kj = sK[j];
      const volatile float* vj = sV[j];
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

// Launches the backward on `stream` and returns the first launch error as
// a cudaError_t (0 on success): bf16, one launch; fp32, the dkdv pass, then
// the dq pass. is_bf16: 1 for bf16 inputs and outputs, 0 for fp32. Strides
// are in elements; every pointer and stride must keep 16-byte alignment
// and head_dim must be 64 (the Python wrapper checks both). tma: for bf16,
// the tensor-map specs (hopper.cuh) of q, k, v and dO, in that order, 16
// int64 each (boxes of 64 rows of one head); unused for fp32.
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
                              long long do_sh, const long long* tma,
                              void* stream) {
  if (head_dim != kHeadDim || kv_len < 1 || kv_len > seq)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return bwd_units::launch(flat_bwd_bf16_kernel, q, k, v, dout, lse, delta,
                             dq, dk, dv, batch, seq, seq, heads, kv_len, seq,
                             qscale, doscale, scale, tma, st);
  Args a{q,      k,      v,      dout, lse,   delta,  dq,
         dk,     dv,     seq,    heads, kv_len, qscale, doscale,
         scale,  {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
         {v_sb, v_ss, v_sh}, {do_sb, do_ss, do_sh}};
  const dim3 grid((seq + kF32Rows - 1) / kF32Rows, heads, batch);
  dkdv_f32_kernel<<<grid, kF32Rows, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_f32_kernel<<<grid, kF32Rows, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by flash_attn_bwd.
extern "C" const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
