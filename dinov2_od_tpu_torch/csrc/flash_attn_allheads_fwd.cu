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
// no running max and no rescaling of the accumulator, and p rounds to bf16
// exactly where the plain version rounds it.
//
// What bounds it at the tensor-parallel shape [32, 257, 3, 64] bf16: bytes.
// q, k, v and o are 4 x 3.16 MB and the lse 0.1 MB: 12.7 MB, 3.8 us at
// 3.35 TB/s; the two products are 4*B*H*S^2*64 = 1.62 GFLOP, 1.6 us at
// 989 TFLOP/s. At that size the card is mostly waiting: 480 units of 64
// query rows, under two a consumer warpgroup, each a short chain of loads,
// products and exponentials; the design keeps every link of the chain on
// the hardware that does it fastest and the loads ahead of it.
//
// Design. The bf16 kernel is the body that the flat forward (B1) launches
// too, `fwd_units::body` in flash_fwd_units.cuh, whose note gives the
// design: a persistent grid of a producer warpgroup and two consumer
// warpgroups on units of 64 query rows, two passes over 128-key K tiles
// (the exact row max, then s again with p . [v | 1] on the tensor cores,
// l summed from the rounded p by a tile of ones), the last tile's logits
// kept in registers between the passes, and a fitted 8-key tail tile where
// kv_len is 1 .. 8 keys past a multiple of 128 (257 tokens). At the
// tensor-parallel shape that is 480 units, under two a consumer. fp32
// inputs take a CUDA-core kernel (`fwd_units::f32_body`), one thread per
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
    allheads_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const fwd_units::UnitArgs a) {
  fwd_units::body<kTail8>(q_map, k_map, v_map, a);
}

__global__ void __launch_bounds__(fwd_units::kF32Rows)
    allheads_fwd_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o,
                            float* __restrict__ lse, int Sq, int H, int kv_len,
                            float qscale, Strides qs, Strides ks, Strides vs) {
  fwd_units::f32_body(q, k, v, o, lse, Sq, H, kv_len, qscale, qs, ks, vs);
}

}  // namespace

// Launches the forward on `stream` and returns the launch's cudaError_t
// (0 on success). is_bf16: 1 for bf16 inputs and output, 0 for fp32.
// q has seq_q rows, k and v seq_k; keys at or past kv_len (<= seq_k) are
// masked. Strides are in elements, in the (batch, row, head) order of the
// model's [B, S, H, 64] layout; every pointer and stride must keep 16-byte
// alignment and head_dim must be 64 (the Python wrapper checks both).
// tma: for bf16, the tensor-map specs (hopper.cuh) of q (boxes of 64 rows
// of one head), k and v (boxes of 128 rows), in that order, 16 int64 each;
// unused for fp32.
extern "C" int flash_attn_allheads_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int is_bf16, int batch, int seq_q, int seq_k, int heads, int head_dim,
    int kv_len, float qscale, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, const long long* tma, void* stream) {
  if (head_dim != fwd_units::kHeadDim || seq_q < 1 || kv_len < 1 ||
      kv_len > seq_k)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return fwd_units::launch(allheads_fwd_bf16_kernel<false>,
                             allheads_fwd_bf16_kernel<true>, q, k, v, o, lse,
                             batch, seq_q, heads, kv_len, qscale, tma, st);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const dim3 grid((seq_q + fwd_units::kF32Rows - 1) / fwd_units::kF32Rows,
                  heads, batch);
  allheads_fwd_f32_kernel<<<grid, fwd_units::kF32Rows, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, seq_q, heads,
      kv_len, qscale, qs, ks, vs);
  return static_cast<int>(cudaGetLastError());
}

// Message for a code returned by flash_attn_allheads_fwd.
extern "C" const char* flash_attn_allheads_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
