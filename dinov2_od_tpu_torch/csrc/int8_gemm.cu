// Dynamic row quantization + int8 GEMM for Hopper (sm_90a), plain C
// interface: two kernels under one entry point.
//
// Replaces dinov2_od_tpu/ops/int8_gemm.py:_kernel, the Pallas TPU kernel
// that the W8A8 serving path (and the int8 frozen prefix of training) runs
// for every wide-K linear: the fc2 of each ViT block.
//
// What it computes, for x [M, K] (bf16 or fp32), W [K, N] int8 stored
// K-major (memory [N, K]), w_scale [N] and bias [N] fp32:
//   s[m]    = max(absmax_k |x[m, k]| * fp32(1/127), 1e-8)
//   xq[m,k] = clip(rint(x[m, k] / s[m]), -127, 127)      (int8, half to even)
//   acc     = xq . W                                     (exact, int32)
//   out     = fma(float(acc), s[m] * w_scale[n], bias[n]), rounded to x's type
// The scale multiplies by the fp32 reciprocal of 127 because the JAX
// package runs this quantization inside `jit`, where XLA rewrites the
// division by the constant 127 into that multiply; x / s stays a true
// (IEEE) division, and the epilogue is one fma, as XLA contracts it. This
// file is built without --use_fast_math so that both hold.
//
// What bounds it on an H100 at the ViT-B serving fc2 (M 8224, K 3072,
// N 768, bf16): both about equally. x (50.5 MB), W (2.4 MB) and out
// (12.6 MB) take 19.6 us at 3.35 TB/s; the 38.8 G int8 operations 19.6 us
// at 1979 TOP/s.
//
// Design. The TPU kernel keeps a block's quantized rows in VMEM and
// reuses them over every N step. On Hopper a 64-row slab (what wgmma needs
// as M) is 192 KB at K 3072 and 256 KB at K 4096, past the 227 KB of
// shared memory, and blocks that each stream all of W re-read it from L2
// hundreds of times. So the quantization is its own pass:
//   (a) int8_quantize_rows_kernel: one block a row, held in registers
//       from 16-byte loads all issued at once, so x is read once; writes
//       the codes [M, K] (K-major by construction) and the fp32 row scales;
//       the codes make one 25 MB round trip, mostly through L2;
//   (b) int8_gemm_kernel: one block per 128 x 128 output tile. A producer
//       warp brings 128 x 128 byte tiles of the codes and of W by TMA with
//       the 128-byte swizzle into a 4-stage mbarrier ring; two consumer
//       warpgroups (64 rows each) run wgmma m64n128k32 s8 x s8 -> s32 with
//       both operands K-major in shared memory (wgmma reads s8 K-major
//       only, hence W's layout), keeping one group in flight while the
//       previous stage is handed back; the epilogue applies the single
//       fp32 fma above per element and stores x's type.
// TMA fills rows past M with zeros. The tensor maps are encoded on the
// host from specs the wrapper computes (hopper.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr float kInvQmax = 1.0f / 127.0f;
constexpr float kEps = 1e-8f;
constexpr int kMaxK = 4096;

// ---------------------------------------------------------------------------
// (a) row quantization
// ---------------------------------------------------------------------------

constexpr int kQuantThreads = 128;  // one block a row

// 16 bytes of x as floats: 8 bf16 or 4 fp32.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const bf162* h = reinterpret_cast<const bf162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(h[j]);
    f[2 * j] = v.x;
    f[2 * j + 1] = v.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ uint32_t code(float v, float s) {
  const float q = fminf(fmaxf(rintf(v / s), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q)));
}

// One block per row. Each thread issues all its 16-byte loads of the row
// before it uses the first (K 4096: 4 in bf16, 8 in fp32), so x is read
// once with many loads in flight; the absmax goes through the warps'
// shuffles and shared memory; the codes are computed from registers.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    int8_quantize_rows_kernel(const T* __restrict__ x,
                              int8_t* __restrict__ codes,
                              float* __restrict__ scale, int K) {
  constexpr int V = 16 / sizeof(T);                     // elements a load
  constexpr int kChunks = kMaxK / (kQuantThreads * V);  // loads a thread
  __shared__ float warp_max[kQuantThreads / 32];
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const T* src = x + static_cast<long long>(row) * K;
  int8_t* dst = codes + static_cast<long long>(row) * K;
  uint4 buf[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = (i * kQuantThreads + tid) * V;
    if (c < K) buf[i] = __ldg(reinterpret_cast<const uint4*>(src + c));
  }
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if ((i * kQuantThreads + tid) * V < K) {
      float f[V];
      unpack(buf[i], f);
#pragma unroll
      for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(f[j]));
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((tid & 31) == 0) warp_max[tid >> 5] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float s = fmaxf(amax * kInvQmax, kEps);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = (i * kQuantThreads + tid) * V;
    if (c < K) {
      float f[V];
      unpack(buf[i], f);
      uint32_t word[V / 4];
#pragma unroll
      for (int w = 0; w < V / 4; ++w) {
        word[w] = code(f[4 * w], s) | (code(f[4 * w + 1], s) << 8) |
                  (code(f[4 * w + 2], s) << 16) | (code(f[4 * w + 3], s) << 24);
      }
      if (V == 8)
        *reinterpret_cast<uint2*>(dst + c) = make_uint2(word[0], word[V / 8]);
      else
        *reinterpret_cast<uint32_t*>(dst + c) = word[0];
    }
  }
  if (tid == 0) scale[row] = s;
}

// ---------------------------------------------------------------------------
// (b) s8 GEMM
// ---------------------------------------------------------------------------

constexpr int kTileM = 128;  // rows of the output tile, 64 per consumer
constexpr int kTileN = 128;
constexpr int kTileK = 128;  // bytes of K per stage: one swizzled row
constexpr int kStages = 4;
constexpr int kConsumers = 2;  // warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kATile = kTileM * kTileK;  // 16 KB
constexpr int kBTile = kTileN * kTileK;  // 16 KB
constexpr int kStageBytes = kATile + kBTile;
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap b_map,
                     const float* __restrict__ x_scale,
                     const float* __restrict__ w_scale,
                     const float* __restrict__ bias, T* __restrict__ out,
                     int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x >> 7;
  const int n0 = blockIdx.x * kTileN;
  const int m0 = blockIdx.y * kTileM;
  const int k_tiles = K / kTileK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer warpgroup: one thread issues TMA
    if (threadIdx.x == kConsumers * 128) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        const uint32_t round = kt / kStages;
        mbar_wait(&empty[s], (round & 1) ^ 1);
        mbar_expect_tx(&full[s], kStageBytes);
        uint8_t* stage = smem + s * kStageBytes;
        tma_load_2d(stage, &a_map, &full[s], kt * kTileK, m0);
        tma_load_2d(stage + kATile, &b_map, &full[s], kt * kTileK, n0);
      }
    }
    return;
  }

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint8_t* stage = smem + s * kStageBytes;
    const uint64_t da = desc_sw128(stage + wg * 64 * kTileK, 16, 1024);
    const uint64_t db = desc_sw128(stage + kATile, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileK / 32; ++kk)  // 32 bytes = 2 units a step
      wgmma_s8_m64n128k32(acc, da + 2 * kk, db + 2 * kk, 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous tile's products are done
    if (kt > 0 && (threadIdx.x & 127) == 0)
      mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Accumulator 4j + e sits at row g (+8 for e >= 2), column 8j + 2t
  // (+1 for odd e) of this warp's 16 rows.
  const int wt = threadIdx.x & 127;
  const int lane = wt & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = m0 + wg * 64 + (wt >> 5) * 16 + g;
  const int r1 = r0 + 8;
  const float xs0 = r0 < M ? x_scale[r0] : 0.0f;
  const float xs1 = r1 < M ? x_scale[r1] : 0.0f;
  T* out0 = out + static_cast<long long>(r0) * N;
  T* out1 = out + static_cast<long long>(r1) * N;
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    const float2 ws = *reinterpret_cast<const float2*>(w_scale + col);
    const float2 bs = *reinterpret_cast<const float2*>(bias + col);
    if (r0 < M)
      store2(out0 + col,
             fmaf(static_cast<float>(acc[4 * j]), xs0 * ws.x, bs.x),
             fmaf(static_cast<float>(acc[4 * j + 1]), xs0 * ws.y, bs.y));
    if (r1 < M)
      store2(out1 + col,
             fmaf(static_cast<float>(acc[4 * j + 2]), xs1 * ws.x, bs.x),
             fmaf(static_cast<float>(acc[4 * j + 3]), xs1 * ws.y, bs.y));
  }
}

template <typename T>
int launch(const void* x, int8_t* codes, float* x_scale, const void* w,
           const float* w_scale, const float* bias, void* out, int m, int k,
           int n, const long long* a_spec, const long long* b_spec,
           cudaStream_t stream) {
  int8_quantize_rows_kernel<T><<<m, kQuantThreads, 0, stream>>>(
      static_cast<const T*>(x), codes, x_scale, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap a_map, b_map;
  int rc = encode_tensor_map(&a_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes,
                             a_spec, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  rc = encode_tensor_map(&b_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, b_spec,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  err = cudaFuncSetAttribute(int8_gemm_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n / kTileN, (m + kTileM - 1) / kTileM);
  int8_gemm_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      a_map, b_map, x_scale, w_scale, bias, static_cast<T*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the row quantization and then the GEMM on `stream`; returns the
// first failing step's cudaError_t (0 on success). is_bf16: 1 for bf16 x
// and out, 0 for fp32. x [m, k] and out [m, n] row-major contiguous; codes
// [m, k] int8 and x_scale [m] fp32 are scratch the quantization writes and
// the GEMM reads; w is the int8 [k, n] weight stored K-major (memory
// [n, k], row stride k); w_scale and bias [n] fp32. a_spec and b_spec are
// the tensor-map specs (hopper.cuh) of the codes ([k, m], box 128 x 128)
// and of w ([k, n], box 128 x 128). Every pointer 16-byte aligned, k and
// n multiples of 128, k at most 4096 (the wrapper checks).
extern "C" int int8_gemm(const void* x, void* codes, float* x_scale,
                         const void* w, const float* w_scale,
                         const float* bias, void* out, int is_bf16, int m,
                         int k, int n, const long long* a_spec,
                         const long long* b_spec, void* stream) {
  if (m < 1 || k % 128 || n % 128 || k < 128 || k > kMaxK || n < 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* cq = static_cast<int8_t*>(codes);
  return is_bf16 ? launch<bf16>(x, cq, x_scale, w, w_scale, bias, out, m, k,
                                n, a_spec, b_spec, st)
                 : launch<float>(x, cq, x_scale, w, w_scale, bias, out, m,
                                 k, n, a_spec, b_spec, st);
}

// Message for a code returned by int8_gemm.
extern "C" const char* int8_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
