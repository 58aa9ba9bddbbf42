// The auction assignment's whole solve for Hopper (sm_90a), plain C
// interface: one block an image runs every bidding round of every eps
// phase on its own multiprocessor until the image converges or spends its
// round budget.
//
// Replaces no TPU kernel. The JAX package runs the auction
// (dinov2_od_tpu/ops/auction.py) as a `lax.while_loop` of batched rounds
// that XLA compiles into one device program. As PyTorch tensor ops a
// round is ~25 small launches, and a host check every `rounds_per_step`
// rounds drains the card: a few hundred rounds at [128, 50, 100] cost
// ~25 ms, all of it launches and syncs around a few microseconds of
// arithmetic, even with the rounds between checks replayed as a CUDA
// graph. This kernel runs the whole loop on the card, and the host reads
// back one small tensor a solve.
//
// What it computes, per image b, on benefit[b] [M, N] fp32 (higher is
// better), row_valid[b] [M], the list of phase increments eps[0..P),
// rounds_per_step k and round_cap (ops/auction.py `_solve_eager`, the
// plain version, is the contract):
//   p = 0; col_of_row = row_of_col = -1; budget = round_cap
//   for each phase e:
//     if budget > 0: col_of_row = row_of_col = -1 (prices carry over)
//     while some valid row is unassigned and budget > 0:
//       k rounds (a chunk), budget -= k, chunks[b, phase] += 1
//   a round: every valid unassigned row i takes its best column j1 and
//   its best value v1 of v = benefit[i] - p (the first column on ties)
//   and v2, the largest of -1e9 and v over the other columns, and bids
//   (v1 + p[j1]) - v2 + e; each column that received a bid above -5e8
//   goes to its highest bid, the lowest row on exact ties, at that bid
//   as its price; the column's earlier owner becomes unassigned.
// Every value is the same fp32 operation in the same order as in the
// tensor-op rounds (IEEE adds and subtracts, no multiply, so nothing can
// contract); the maxima are exact. A round after an image converged
// places no bids, so the kernel stops there and the image's state is the
// batched loop's: the wrapper reads back the chunks and charges
// k x (the most chunks any image used) a phase, as the loop counted.
//
// What bounds it on an H100: neither bytes nor operations. At the coco100
// cell's [128, 50, 100] the benefit is 2.56 MB (0.8 us at 3.35 TB/s) and
// the rounds' arithmetic well under a microsecond at the card's fp32
// rate. The rounds of an image are a chain: each reads the prices and
// owners the last one wrote. So the time is the longest image's rounds
// times one round's latency, and the design keeps a round short: the
// image's benefit, prices and owners sit in shared memory (the benefit
// is read from device memory, where L2 holds it, when [M, N] does not
// fit beside the rest), a warp a bidding row finds its best and second
// best with shuffles, bids meet in a shared 64-bit atomicMax on a packed
// (bid, lowest row) key, and a round takes two barriers. Each warp finds
// the unassigned rows itself by ballot, so no barrier is spent on a list.
//
// Owners: a bidder owns nothing (it is unassigned, and col_of_row mirrors
// row_of_col), a row bids for one column, and a column's earlier owner
// owned only it; so the winner takes the column and the earlier owner
// drops out with two writes, which equals rebuilding col_of_row from
// row_of_col as the tensor-op rounds do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPhases = 32;
constexpr float kNeg = -1e9f;         // the plain version's bid sentinel
constexpr float kHasBid = -5e8f;      // kNeg / 2, its "a bid came" test
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* benefit;            // [B, M, N]
  const unsigned char* row_valid;  // [B, M] bool
  float* prices;                   // [B, N]
  long long* col_of_row;           // [B, M]
  long long* row_of_col;           // [B, N]
  int* chunks;                     // [B, n_phases]
  int M, N, n_phases, rounds_per_step, round_cap;
  float eps[kMaxPhases];
};

// Shared memory of a block, in this order: the bid keys [N] (8-byte
// aligned first), the staged benefit [M, N] when staged, the prices [N],
// row_of_col [N], col_of_row [M], row_valid [M].
size_t smem_bytes(int M, int N, bool staged) {
  size_t m = M, n = N;
  return n * 8 + (staged ? m * n * 4 : 0) + n * 4 + n * 4 + m * 4 + m;
}

// A bid and its row as one key whose unsigned order is (bid, then the
// lower row) order: the float's bits made monotone, the row inverted.
__device__ __forceinline__ unsigned long long pack(float bid, int row) {
  unsigned u = __float_as_uint(bid);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned>(0xffffffffu - static_cast<unsigned>(row));
}

__device__ __forceinline__ float key_bid(unsigned long long key) {
  unsigned u = static_cast<unsigned>(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_row(unsigned long long key) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(key));
}

// Row `row`'s bid, by one warp: best (value, first column) and second
// best value of benefit[row] - p, lane-local over the columns lane,
// lane + 32, ..., then across the warp. The combine is symmetric, so
// every lane ends with the same three values.
__device__ __forceinline__ void bid_row(const float* __restrict__ ben,
                                        const float* p,
                                        unsigned long long* key, int N,
                                        int row, float e, int lane) {
  const float* br = ben + static_cast<size_t>(row) * N;
  float best = -INFINITY, second = -INFINITY;
  int col = 0x7fffffff;
  for (int j = lane; j < N; j += 32) {
    const float v = __fsub_rn(br[j], p[j]);
    if (v > best) {
      second = best > second ? best : second;
      best = v;
      col = j;
    } else if (v > second) {
      second = v;
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int oc = __shfl_xor_sync(kFull, col, off);
    const float os = __shfl_xor_sync(kFull, second, off);
    const bool other = ob > best || (ob == best && oc < col);
    const float loser = other ? best : ob;
    if (other) {
      best = ob;
      col = oc;
    }
    second = os > second ? os : second;
    second = loser > second ? loser : second;
  }
  if (lane == 0 && col < N) {  // col stays past N only on NaN values
    const float v2 = second > kNeg ? second : kNeg;
    const float bid = __fadd_rn(__fsub_rn(__fadd_rn(best, p[col]), v2), e);
    atomicMax(key + col, pack(bid, row));
  }
}

// The bids of one round: each warp takes the unassigned valid rows of
// rank warp, warp + kWarps, ... (in row order), found by ballot. Returns
// how many rows were unassigned, the same in every thread; 0 means the
// image has converged and no bid was placed.
__device__ __forceinline__ int bid_round(const float* __restrict__ ben,
                                         const float* p,
                                         unsigned long long* key,
                                         const int* cor,
                                         const unsigned char* valid, int M,
                                         int N, float e, int warp,
                                         int lane) {
  int base = 0;
  for (int c = 0; c < M; c += 32) {
    const int i = c + lane;
    const bool open = i < M && valid[i] && cor[i] < 0;
    const unsigned mask = __ballot_sync(kFull, open);
    const int rank = base + __popc(mask & ((1u << lane) - 1u));
    unsigned mine = __ballot_sync(kFull, open && rank % kWarps == warp);
    while (mine) {
      const int row = c + __ffs(mine) - 1;
      mine &= mine - 1u;
      bid_row(ben, p, key, N, row, e, lane);
    }
    base += __popc(mask);
  }
  return base;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) auction_kernel(Args a) {
  extern __shared__ unsigned long long smem[];
  const int M = a.M, N = a.N, k = a.rounds_per_step;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  unsigned long long* key = smem;
  float* ben_s = reinterpret_cast<float*>(key + N);
  float* p = ben_s + (kStaged ? static_cast<size_t>(M) * N : 0);
  int* roc = reinterpret_cast<int*>(p + N);
  int* cor = roc + N;
  unsigned char* valid = reinterpret_cast<unsigned char*>(cor + M);

  const float* ben_g = a.benefit + static_cast<size_t>(b) * M * N;
  if (kStaged) {
    for (size_t x = tid; x < static_cast<size_t>(M) * N; x += kThreads)
      ben_s[x] = ben_g[x];
  }
  const float* ben = kStaged ? ben_s : ben_g;
  for (int j = tid; j < N; j += kThreads) {
    key[j] = 0ull;
    p[j] = 0.0f;
    roc[j] = -1;
  }
  for (int i = tid; i < M; i += kThreads) {
    cor[i] = -1;
    valid[i] = a.row_valid[static_cast<size_t>(b) * M + i];
  }

  int budget = a.round_cap;  // the same in every thread
  for (int ph = 0; ph < a.n_phases; ++ph) {
    const float e = a.eps[ph];
    __syncthreads();
    if (budget > 0) {  // a fresh start; an image out of budget keeps its own
      for (int j = tid; j < N; j += kThreads) roc[j] = -1;
      for (int i = tid; i < M; i += kThreads) cor[i] = -1;
      __syncthreads();
    }
    int chunks = 0, r = 0;  // r: rounds run of the current chunk
    while (r != 0 || budget > 0) {
      if (bid_round(ben, p, key, cor, valid, M, N, e, warp, lane) == 0)
        break;
      if (r == 0) {
        budget -= k;
        ++chunks;
      }
      r = r + 1 == k ? 0 : r + 1;
      __syncthreads();
      for (int j = tid; j < N; j += kThreads) {
        const unsigned long long kk = key[j];
        if (kk == 0ull) continue;
        key[j] = 0ull;
        const float bid = key_bid(kk);
        if (!(bid > kHasBid)) continue;
        const int row = key_row(kk);
        const int old = roc[j];
        if (old >= 0) cor[old] = -1;
        roc[j] = row;
        cor[row] = j;
        p[j] = bid;
      }
      __syncthreads();
    }
    if (tid == 0) a.chunks[static_cast<size_t>(b) * a.n_phases + ph] = chunks;
  }
  __syncthreads();
  for (int j = tid; j < N; j += kThreads) {
    a.prices[static_cast<size_t>(b) * N + j] = p[j];
    a.row_of_col[static_cast<size_t>(b) * N + j] = roc[j];
  }
  for (int i = tid; i < M; i += kThreads)
    a.col_of_row[static_cast<size_t>(b) * M + i] = cor[i];
}

}  // namespace

// 1 where an [M, N] image's benefit is staged in shared memory beside its
// state, 0 where only the state fits (the benefit is read from device
// memory), -1 where not even the state fits a block or the device cannot
// be asked.
extern "C" int auction_staged(int M, int N) {
  int dev = 0, limit = 0;
  if (M < 1 || N < 1 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  if (smem_bytes(M, N, true) <= static_cast<size_t>(limit)) return 1;
  if (smem_bytes(M, N, false) <= static_cast<size_t>(limit)) return 0;
  return -1;
}

extern "C" int auction_solve(const float* benefit,
                             const unsigned char* row_valid, float* prices,
                             long long* col_of_row, long long* row_of_col,
                             int* chunks, int B, int M, int N,
                             const float* eps, int n_phases,
                             int rounds_per_step, int round_cap,
                             void* stream) {
  const int staged = auction_staged(M, N);
  if (B < 1 || staged < 0 || n_phases < 1 || n_phases > kMaxPhases ||
      rounds_per_step < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{benefit, row_valid, prices, col_of_row, row_of_col, chunks,
         M,       N,         n_phases, rounds_per_step, round_cap, {}};
  for (int i = 0; i < n_phases; ++i) a.eps[i] = eps[i];
  const size_t bytes = smem_bytes(M, N, staged == 1);
  void (*kernel)(Args) =
      staged == 1 ? &auction_kernel<true> : &auction_kernel<false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* auction_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
