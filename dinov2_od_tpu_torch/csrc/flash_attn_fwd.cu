// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces dinov2_od_tpu/ops/flash_attention.py:_fwd_kernel_flat (B1), the
// Pallas TPU kernel that every ViT block's self-attention runs.
//
// What it computes, per (batch, head), the TPU kernel's function:
//   s   = (q * bf(scale*log2e)) . k^T   fp32; keys >= kv_len set to -1e30
//   m   = rowmax(s)                      exact, over all the row's keys
//   p   = exp2(s - m), rounded to the input type
//   l   = rowsum(p)                      from the rounded p, fp32
//   o   = (p . v) / l                    fp32 accumulation, stored in dt
//   lse = m + log2(l)                    log2 space, fp32 [B, H, S]
// Inputs are [B, S, H, 64] views with arbitrary batch, row and head
// strides (the last dim contiguous), so the three slices of the fused qkv
// GEMM output are read in place. o is a contiguous [B, S, H, 64].
//
// The TPU kernel keeps a head's whole [S, S] logits on chip and takes p
// against the exact row max, summing l on the matrix unit through a ones
// lane of v (dinov2_od_tpu/ops/flash_attention.py:379-391). The all-heads
// forward (B4f) computes the same function over [B, H, S, 64] heads, and
// this kernel is its body (`fwd_units::body` in flash_fwd_units.cuh) under
// its own name: B1 is B4f with Sq = Sk and heads that pair.
//
// What bounds it on an H100 at the serving shape (B=32, S=257, H=12,
// dh=64, bf16): bytes. q, k, v, o and the lse are 51 MB, 15.2 us at
// 3.35 TB/s; the two products are 6.5 GFLOP, 6.6 us at 989 TFLOP/s.
// Design (flash_fwd_units.cuh's note: the 5-stage ring, the K tile held
// from pass 1 into pass 2, o written out through the q slot): a persistent
// grid of a producer warpgroup and two consumer warpgroups, each on its own
// units of 64 query rows, the K and V tiles brought by TMA through the real
// strides, both products on wgmma. At the serving shape that is 1920
// units, 7.3 a consumer warpgroup, so the two consumers of a
// multiprocessor overlap one unit's exponentials and stores with the
// other's products. 257 keys are 256 + 1: the fitted 8-key tail takes the
// last key as an m64n8 product and one k16 step of p . v, so pass 1 takes
// 264 keys and pass 2 272 where 128-key tiles took 384 in each. fp32
// inputs take the CUDA-core kernel `fwd_units::f32_body`, one thread per
// query row, with the same two passes (the tensor cores would round fp32
// to tf32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_fwd_units.cuh"

namespace {

using fwd_units::Strides;

// ---------------------------------------------------------------------------
// The shared kernels (flash_fwd_units.cuh) under this source's own names
// ---------------------------------------------------------------------------

template <bool kTail8>
__global__ void __launch_bounds__(fwd_units::kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const fwd_units::UnitArgs a) {
  fwd_units::body<kTail8>(q_map, k_map, v_map, a);
}

__global__ void __launch_bounds__(fwd_units::kF32Rows)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int S, int H, int kv_len,
                         float qscale, Strides qs, Strides ks, Strides vs) {
  fwd_units::f32_body(q, k, v, o, lse, S, H, kv_len, qscale, qs, ks, vs);
}

}  // namespace

// Launches the forward on `stream` and returns the launch's cudaError_t
// (0 on success). is_bf16: 1 for bf16 inputs and output, 0 for fp32.
// Strides are in elements; every pointer and stride must keep 16-byte
// alignment and head_dim must be 64 (the Python wrapper checks both).
// tma: for bf16, the tensor-map specs (hopper.cuh) of q (boxes of 64 rows
// of one head), k and v (boxes of 128 rows), in that order, 16 int64 each
// (`flat_fwd_tma_specs`); unused for fp32.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int is_bf16, int batch,
                              int seq, int heads, int head_dim, int kv_len,
                              float qscale, long long q_sb, long long q_ss,
                              long long q_sh, long long k_sb, long long k_ss,
                              long long k_sh, long long v_sb, long long v_ss,
                              long long v_sh, const long long* tma,
                              void* stream) {
  if (head_dim != fwd_units::kHeadDim || seq < 1 || kv_len < 1 ||
      kv_len > seq)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return fwd_units::launch(flash_fwd_bf16_kernel<false>,
                             flash_fwd_bf16_kernel<true>, q, k, v, o, lse,
                             batch, seq, heads, kv_len, qscale, tma, st);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const dim3 grid((seq + fwd_units::kF32Rows - 1) / fwd_units::kF32Rows,
                  heads, batch);
  flash_fwd_f32_kernel<<<grid, fwd_units::kF32Rows, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, seq, heads,
      kv_len, qscale, qs, ks, vs);
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by flash_attn_fwd.
extern "C" const char* flash_attn_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
