// Fused dynamic quantization + int8 GEMM for Hopper (sm_90a), plain C
// interface.
//
// Replaces dinov2_od_tpu/ops/int8_gemm.py:_kernel, the Pallas TPU kernel
// that the W8A8 serving path (and the int8 frozen prefix of training) runs
// for every wide-K linear: the fc2 of each ViT block.
//
// What it computes, for x [M, K] (bf16 or fp32), W [K, N] int8 stored
// N-contiguous (the JAX param layout), w_scale [N] and bias [N] fp32:
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
// at 1979 TOP/s. The design keeps the quantized activations out of device
// memory: one block owns a 32-row slab of x, quantizes it once into shared
// memory (the TPU kernel's VMEM scratch, filled on its first N step; here
// the block itself loops over all N tiles, since Hopper's blocks run in no
// order), and then streams W in 64 x 128 tiles through a double-buffered
// cp.async ring while 8 warps run mma.sync m16n8k32 s8 x s8 -> s32.
//
// Operand layout: mma.sync wants B K-major (4 consecutive k of one column
// in a register), but W is N-contiguous and ldmatrix.trans moves only
// 16-bit elements. Each thread instead reads, for 4 consecutive k rows,
// the 32-bit word of 4 neighbouring columns (4g .. 4g+3) and transposes
// the 4 x 4 bytes with byte permutes: that yields the B registers of four
// n8 tiles at once, where tile j's column g is physical column 4g + j. The
// accumulators map back to 8 consecutive physical columns per thread, so
// the epilogue stores 16 or 32 contiguous bytes. The W tiles are stored
// with an XOR swizzle of their 16-byte chunks, the x slab with a 16-byte
// row pad, so that these fragment reads hit 32 distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int kBlockM = 32;   // rows of x per block
constexpr int kBlockN = 128;  // columns of W per tile
constexpr int kBlockK = 64;   // depth of a W tile
constexpr int kWarps = 8;     // 2 (rows of 16) x 4 (columns of 32)
constexpr int kThreads = kWarps * 32;
constexpr int kTileBytes = kBlockK * kBlockN;
constexpr int kSlabPad = 16;  // bytes added to each slab row
constexpr int kMaxK = 4096;
constexpr float kInvQmax = 1.0f / 127.0f;
constexpr float kEps = 1e-8f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk `chunk` (0..7) of row `row` in a W tile.
// Rows 4i .. 4i+3 XOR the chunk with 2 (i mod 4), so the fragment reads of
// one warp (threads t = 0..3 on rows 4t + const) land on distinct chunks.
__device__ __forceinline__ int w_offset(int row, int chunk) {
  return row * kBlockN + ((chunk ^ (((row >> 2) & 3) << 1)) << 4);
}

// W[k0 : k0 + 64, n0 : n0 + 128] into a shared tile, 16 bytes a thread.
__device__ __forceinline__ void load_w_tile(uint8_t* tile,
                                            const int8_t* __restrict__ w,
                                            int N, int k0, int n0, int tid) {
#pragma unroll
  for (int i = 0; i < kTileBytes / 16 / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int row = c >> 3;
    const int chunk = c & 7;
    cp_async16(tile + w_offset(row, chunk),
               w + static_cast<long long>(k0 + row) * N + n0 + chunk * 16);
  }
}

// out[j] = byte j of w[0], w[1], w[2], w[3] (a 4 x 4 byte transpose).
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4],
                                             uint32_t (&out)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  out[0] = __byte_perm(lo01, lo23, 0x5410);
  out[1] = __byte_perm(lo01, lo23, 0x7632);
  out[2] = __byte_perm(hi01, hi23, 0x5410);
  out[3] = __byte_perm(hi01, hi23, 0x7632);
}

// 16 bytes of x as floats.
__device__ __forceinline__ void load_vec(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf162* h = reinterpret_cast<const bf162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(h[j]);
    f[2 * j] = v.x;
    f[2 * j + 1] = v.y;
  }
}

__device__ __forceinline__ void load_vec(const float* p, float (&f)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}

__device__ __forceinline__ uint32_t code(float v, float s) {
  const float q = fminf(fmaxf(rintf(v / s), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q)));
}

// Rows m0 .. m0+31 of x quantized into the slab (row pitch K + 16 bytes),
// their scales into row_scale; rows at or past M become zeros. One warp
// per row: absmax over the row, then the codes, reading x twice.
template <typename T>
__device__ void quantize_rows(const T* __restrict__ x, int8_t* slab,
                              float* row_scale, int M, int K, int m0,
                              int warp, int lane) {
  constexpr int V = 16 / sizeof(T);
  const int pitch = K + kSlabPad;
  for (int r = warp; r < kBlockM; r += kWarps) {
    const int row = m0 + r;
    int8_t* dst = slab + r * pitch;
    if (row >= M) {
      for (int c = lane * V; c < K; c += 32 * V) {
        if (V == 8)
          *reinterpret_cast<uint2*>(dst + c) = make_uint2(0u, 0u);
        else
          *reinterpret_cast<uint32_t*>(dst + c) = 0u;
      }
      if (lane == 0) row_scale[r] = 0.0f;
      continue;
    }
    const T* src = x + static_cast<long long>(row) * K;
    float amax = 0.0f;
    for (int c = lane * V; c < K; c += 32 * V) {
      float f[V];
      load_vec(src + c, f);
#pragma unroll
      for (int j = 0; j < V; ++j) amax = fmaxf(amax, fabsf(f[j]));
    }
#pragma unroll
    for (int o = 16; o; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float s = fmaxf(amax * kInvQmax, kEps);
    for (int c = lane * V; c < K; c += 32 * V) {
      float f[V];
      load_vec(src + c, f);
      uint32_t word[V / 4];
#pragma unroll
      for (int i = 0; i < V / 4; ++i) {
        word[i] = code(f[4 * i], s) | (code(f[4 * i + 1], s) << 8) |
                  (code(f[4 * i + 2], s) << 16) |
                  (code(f[4 * i + 3], s) << 24);
      }
      if (V == 8)
        *reinterpret_cast<uint2*>(dst + c) = make_uint2(word[0], word[V / 8]);
      else
        *reinterpret_cast<uint32_t*>(dst + c) = word[0];
    }
    if (lane == 0) row_scale[r] = s;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float (&o)[8]) {
  uint4 u;
  bf162* h = reinterpret_cast<bf162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(o[2 * j], o[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&o)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(o[4], o[5], o[6], o[7]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    int8_gemm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ w_scale,
                     const float* __restrict__ bias, T* __restrict__ out,
                     int M, int K, int N) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* w_tiles = smem;  // two W tiles
  float* row_scale = reinterpret_cast<float*>(smem + 2 * kTileBytes);
  int8_t* slab =
      reinterpret_cast<int8_t*>(smem + 2 * kTileBytes + kBlockM * 4);
  const int pitch = K + kSlabPad;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row / column group
  const int t = lane & 3;   // thread in group
  const int wm = warp >> 2;  // rows wm*16 .. +15 of the slab
  const int wn = warp & 3;   // columns wn*32 .. +31 of the N tile
  const int m0 = blockIdx.x * kBlockM;
  const int k_tiles = K / kBlockK;
  const int total = k_tiles * (N / kBlockN);

  // The first W tile flies while the slab is quantized.
  load_w_tile(w_tiles, w, N, 0, 0, tid);
  cp_async_commit();
  quantize_rows<T>(x, slab, row_scale, M, K, m0, warp, lane);

  int acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;

  for (int it = 0; it < total; ++it) {
    const int nt = it / k_tiles;
    const int kt = it - nt * k_tiles;
    if (it + 1 < total) {
      const int nn = (it + 1) / k_tiles;
      load_w_tile(w_tiles + ((it + 1) & 1) * kTileBytes, w, N,
                  ((it + 1) - nn * k_tiles) * kBlockK, nn * kBlockN, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile, and at it == 0 the slab, are in place

    const uint8_t* tile = w_tiles + (it & 1) * kTileBytes;
#pragma unroll
    for (int ks = 0; ks < kBlockK / 32; ++ks) {
      const int8_t* ar =
          slab + (wm * 16 + g) * pitch + kt * kBlockK + ks * 32 + t * 4;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(ar);
      a[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * pitch);
      a[2] = *reinterpret_cast<const uint32_t*>(ar + 16);
      a[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * pitch + 16);
      uint32_t b[2][4];  // [k half][n8 tile]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t words[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = ks * 32 + h * 16 + t * 4 + i;
          words[i] = *reinterpret_cast<const uint32_t*>(
              tile + w_offset(row, 2 * wn + (g >> 2)) + (g & 3) * 4);
        }
        transpose4x4(words, b[h]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[j], a, b[0][j], b[1][j]);
    }
    __syncthreads();  // this buffer is refilled at the next iteration

    if (kt == k_tiles - 1) {
      // Tile j's column g is physical column 4g + j, so accumulator i of
      // tile j sits at column 8t + j (+4 for odd i), row g (+8 for i >= 2).
      const int col0 = nt * kBlockN + wn * 32 + t * 8;
      float ws[8], bs[8];
      *reinterpret_cast<float4*>(ws) =
          *reinterpret_cast<const float4*>(w_scale + col0);
      *reinterpret_cast<float4*>(ws + 4) =
          *reinterpret_cast<const float4*>(w_scale + col0 + 4);
      *reinterpret_cast<float4*>(bs) =
          *reinterpret_cast<const float4*>(bias + col0);
      *reinterpret_cast<float4*>(bs + 4) =
          *reinterpret_cast<const float4*>(bias + col0 + 4);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lr = wm * 16 + g + r * 8;
        const int row = m0 + lr;
        if (row < M) {
          const float xs = row_scale[lr];
          float o[8];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            o[j] = fmaf(static_cast<float>(acc[j][2 * r]), xs * ws[j], bs[j]);
            o[4 + j] = fmaf(static_cast<float>(acc[j][2 * r + 1]),
                            xs * ws[4 + j], bs[4 + j]);
          }
          store8(out + static_cast<long long>(row) * N + col0, o);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0;
    }
  }
}

template <typename T>
int launch(const void* x, const int8_t* w, const float* w_scale,
           const float* bias, void* out, int m, int k, int n,
           cudaStream_t stream) {
  const int smem = 2 * kTileBytes + kBlockM * 4 + kBlockM * (k + kSlabPad);
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kBlockM - 1) / kBlockM);
  int8_gemm_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w, w_scale, bias, static_cast<T*>(out), m, k,
      n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the fused quantize + int8 GEMM on `stream` and returns the
// launch's cudaError_t (0 on success). is_bf16: 1 for bf16 x and out, 0
// for fp32. x [m, k] and out [m, n] row-major contiguous, w [k, n] int8
// row-major contiguous, w_scale and bias [n] fp32; every pointer 16-byte
// aligned, k and n multiples of 128, k at most 4096 (the wrapper checks).
extern "C" int int8_gemm(const void* x, const void* w, const float* w_scale,
                         const float* bias, void* out, int is_bf16, int m,
                         int k, int n, void* stream) {
  if (m < 1 || k % 128 || n % 128 || k < 128 || k > kMaxK || n < 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  return is_bf16 ? launch<bf16>(x, wq, w_scale, bias, out, m, k, n, st)
                 : launch<float>(x, wq, w_scale, bias, out, m, k, n, st);
}

// Message for a code returned by int8_gemm.
extern "C" const char* int8_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
