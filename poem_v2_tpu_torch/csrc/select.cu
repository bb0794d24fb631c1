// The exact K-th smallest packed key of every row, five ways.
//
// Replaces the five Pallas TPU kernel bodies of
//   scripts/bench_radix_select.py (K10: scan32, radix8, pass1, cur, bcast),
// a micro-benchmark of the selection inside the fused KNN attention: keys are
// (B, M, N) int32, `(bits(d2) & ~0xFFF) | column`, non-negative and unique
// within a row.
//
//   scan32  K rounds of "smallest key above the last one"
//   radix8  eight 4-bit passes from the top nibble down: count the active
//           keys under each nibble value, pick the nibble that holds the
//           K-th, narrow the prefix
//   pass1   the int32 wrap-around sum of a row: what one pass costs
//   cur     scan32 that also extracts: every round writes the one-hot row of
//           its key's column, and each chunk of CJ rounds sums its CJ one-hot
//           rows; the result is the K-th key plus the hits of all BQ rows of
//           the query block
//   bcast   the same result with one extraction per chunk: CJ scan rounds for
//           the chunk's threshold, then mask = (lo < key <= thr), the slot of
//           every masked column by a prefix sum, and the CJ one-hot rows
//           written from (mask, slot)
//
// What bounds them on the H100: one read of the keys from device memory
// (bytes) if a row is kept on chip; the rounds then run out of shared memory,
// K (scan32, cur, bcast) or 8 (radix8) passes of N keys a row (operations).
//
// Design:
// * scan32, radix8, pass1: one warp per row, four rows a block. A row (at most
//   4096 keys, the columns a packed key can name) is staged in shared memory
//   once. A round is a strided pass with a warp min
//   (`__reduce_min_sync`). A radix pass counts nibbles in two 64-bit words of
//   eight 8-bit fields per lane, flushed into 16 registers every 255 keys, then
//   16 warp sums; the TPU body's 15 masked sums a pass would cost 15 compares a
//   key here.
// * cur, bcast: one block of 256 threads per query block of BQ rows, one row
//   at a time: the row's keys and the chunk's [CJ][N] one-hot bytes live in
//   shared memory, the hits are summed with `__dp4a`, and the block adds its
//   total to its rows' K-th keys at the end, so BQ and CJ mean what the caller
//   says whatever the launch looks like. `cur` writes one one-hot row a round
//   (one word in N / 4 is not 0). `bcast` clears the chunk's rows, takes the
//   slot of each masked column from `__ballot_sync` / `__popc` within a warp
//   plus the counts of the warps and tiles before it, and sets byte
//   [slot][column]. (The TPU body compares every column with every slot; a
//   scatter builds the same rows.)
#include <limits.h>

#include "common.cuh"

namespace poem {

constexpr int RS_WARPS = 4;        // rows a block in the warp-per-row kernels
constexpr int RS_MAX_N = 4096;     // a packed key names its column in 12 bits
constexpr int OH_THREADS = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;

// The warp's row, staged in `stage` (shared memory).
__device__ __forceinline__ const int* warp_row(const int* __restrict__ g, int* stage, int N,
                                               int lane) {
  for (int j = lane; j < N; j += 32) stage[j] = g[j];
  __syncwarp();
  return stage;
}

__global__ void __launch_bounds__(RS_WARPS * 32)
    kth_key_scan_kernel(const int* __restrict__ keys, int* __restrict__ out, int rows, int N,
                        int K) {
  extern __shared__ int rs_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * RS_WARPS + warp;
  if (row >= rows) return;  // whole warp; no block barrier below
  const int* k = warp_row(keys + (size_t)row * N, rs_smem + warp * N, N, lane);
  int thr = INT_MIN;
  for (int r = 0; r < K; ++r) {
    int best = INT_MAX;
    for (int j = lane; j < N; j += 32) {
      const int v = k[j];
      if (v > thr && v < best) best = v;
    }
    thr = __reduce_min_sync(FULL, best);
  }
  if (lane == 0) out[row] = thr;
}

__global__ void __launch_bounds__(RS_WARPS * 32)
    kth_key_radix_kernel(const int* __restrict__ keys, int* __restrict__ out, int rows, int N,
                         int K) {
  extern __shared__ int rs_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * RS_WARPS + warp;
  if (row >= rows) return;
  const int* k = warp_row(keys + (size_t)row * N, rs_smem + warp * N, N, lane);
  uint32_t prefix = 0;
  int kk = K;  // rank still to find among the active keys
  for (int p = 0; p < 8; ++p) {
    const int shift = 28 - 4 * p;
    int hist[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) hist[t] = 0;
    unsigned long long low = 0, high = 0;  // eight 8-bit counters each: nibbles 0-7, 8-15
    int pending = 0;
    auto flush = [&]() {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        hist[t] += (int)((low >> (8 * t)) & 0xFF);
        hist[8 + t] += (int)((high >> (8 * t)) & 0xFF);
      }
      low = high = 0;
      pending = 0;
    };
    for (int j = lane; j < N; j += 32) {
      const uint32_t v = (uint32_t)k[j];
      // pass 0 has no prefix yet: every key is active (and v >> 32 is undefined)
      const bool active = p == 0 || (v >> (shift + 4)) == prefix;
      const uint32_t nib = (v >> shift) & 0xF;
      const unsigned long long inc = active ? 1ull << ((nib & 7) * 8) : 0ull;
      if (nib < 8) low += inc; else high += inc;
      if (++pending == 255) flush();
    }
    flush();
    // c_t = #{active keys with nibble < t}; the chosen nibble is the largest t
    // with c_t < kk (c is non-decreasing), and c_t of them lie below it
    int c = 0, nibble = 0, below = 0;
#pragma unroll
    for (int t = 1; t < 16; ++t) {
      c += __reduce_add_sync(FULL, hist[t - 1]);
      if (c < kk) {
        nibble = t;
        below = c;
      }
    }
    kk -= below;
    prefix = (prefix << 4) | (uint32_t)nibble;
  }
  if (lane == 0) out[row] = (int)prefix;
}

__global__ void __launch_bounds__(RS_WARPS * 32)
    key_row_sum_kernel(const int* __restrict__ keys, int* __restrict__ out, int rows, int N) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * RS_WARPS + warp;
  if (row >= rows) return;
  const int* k = keys + (size_t)row * N;
  unsigned s = 0;  // unsigned: the sum wraps around as int32 does
  for (int j = lane; j < N; j += 32) s += (unsigned)k[j];
  s = __reduce_add_sync(FULL, s);
  if (lane == 0) out[row] = (int)s;
}

// The least key above `thr` over the block's row; `red` has 2 x 8 slots, used
// in turn by successive calls (`parity`), so one barrier a call is enough.
__device__ __forceinline__ int block_min_above(const int* k, int N, int thr, int* red,
                                               int parity) {
  int best = INT_MAX;
  for (int j = threadIdx.x; j < N; j += OH_THREADS) {
    const int v = k[j];
    if (v > thr && v < best) best = v;
  }
  best = __reduce_min_sync(FULL, best);
  int* slot = red + parity * (OH_THREADS / 32);
  if (threadIdx.x % 32 == 0) slot[threadIdx.x / 32] = best;
  __syncthreads();
  int m = slot[0];
#pragma unroll
  for (int w = 1; w < OH_THREADS / 32; ++w) m = min(m, slot[w]);
  return m;
}

inline size_t onehot_smem(int N, int BQ, int CJ) {
  const size_t NS = ((size_t)N + 3) / 4 * 4;
  return (size_t)N * sizeof(int) + (size_t)CJ * NS + (size_t)BQ * sizeof(int);
}

template <bool BCAST>
__global__ void __launch_bounds__(OH_THREADS)
    kth_key_onehot_kernel(const int* __restrict__ keys, int* __restrict__ out, int M, int N,
                          int K, int BQ, int CJ) {
  extern __shared__ int oh_smem[];
  __shared__ int red[2 * (OH_THREADS / 32)];
  __shared__ int wcount[2 * (OH_THREADS / 32)];
  const int NS = (N + 3) / 4 * 4;  // bytes of a one-hot row; the pad stays 0
  int* krow = oh_smem;                                               // [N] the row's keys
  uint32_t* oh_words = reinterpret_cast<uint32_t*>(krow + N);        // [CJ][NS / 4]
  unsigned char* oh = reinterpret_cast<unsigned char*>(oh_words);    // [CJ][NS]
  int* row_thr = reinterpret_cast<int*>(oh + (size_t)CJ * NS);       // [BQ] K-th key per row
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int words = CJ * (NS / 4);
  const size_t row0 = (size_t)blockIdx.y * M + (size_t)blockIdx.x * BQ;
  unsigned hits = 0;
  int parity = 0;

  for (int r = 0; r < BQ; ++r) {
    const int* g = keys + (row0 + r) * N;
    __syncthreads();  // the previous row's readers of krow are done
    for (int j = t; j < N; j += OH_THREADS) krow[j] = g[j];
    __syncthreads();
    int thr = INT_MIN;
    for (int c = 0; c < K / CJ; ++c) {
      const int lo = thr;
      if (BCAST)
        for (int w = t; w < words; w += OH_THREADS) oh_words[w] = 0u;
      for (int jj = 0; jj < CJ; ++jj) {
        thr = block_min_above(krow, N, thr, red, parity);
        parity ^= 1;
        if (!BCAST) {
          // the round's one-hot row: column (thr & 0xFFF), if the row has it
          const int col = thr & 0xFFF;
          const int hit_word = col < N ? col >> 2 : -1;
          for (int w = t; w < NS / 4; w += OH_THREADS)
            oh_words[jj * (NS / 4) + w] = w == hit_word ? 1u << (8 * (col & 3)) : 0u;
        }
      }
      if (BCAST) {
        // slot of every masked column = masked columns before it in the row
        int before = 0;
        for (int base = 0, tile = 0; base < N; base += OH_THREADS, ++tile) {
          const int j = base + t;
          const bool m = j < N && krow[j] > lo && krow[j] <= thr;
          const unsigned ballot = __ballot_sync(FULL, m);
          int* wc = wcount + (tile & 1) * (OH_THREADS / 32);
          if (lane == 0) wc[warp] = __popc(ballot);
          __syncthreads();
          int slot = before + __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
          for (int w = 0; w < OH_THREADS / 32; ++w) {
            if (w < warp) slot += wc[w];
            before += wc[w];
          }
          if (m && slot < CJ) oh[(size_t)slot * NS + j] = 1;
        }
      }
      __syncthreads();  // the chunk's one-hot rows are complete
      for (int w = t; w < words; w += OH_THREADS) hits = __dp4a(oh_words[w], 0x01010101u, hits);
      __syncthreads();  // before the next chunk overwrites them
    }
    if (t == 0) row_thr[r] = thr;
  }

  // total hits of the block's BQ rows, added to each row's K-th key
  hits = __reduce_add_sync(FULL, hits);
  __syncthreads();
  if (lane == 0) red[warp] = (int)hits;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < OH_THREADS / 32; ++w) total += red[w];
  for (int r = t; r < BQ; r += OH_THREADS) out[row0 + r] = row_thr[r] + total;
}

template <bool BCAST>
cudaError_t launch_onehot(const int* keys, int* out, int B, int M, int N, int K, int BQ, int CJ,
                          cudaStream_t stream) {
  const size_t smem = onehot_smem(N, BQ, CJ);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = kth_key_onehot_kernel<BCAST>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(M / BQ, B), OH_THREADS, smem, stream>>>(keys, out, M, N, K, BQ, CJ);
  return cudaGetLastError();
}

}  // namespace poem

using namespace poem;

// variant 0: scan32 (K strict-threshold rounds), 1: radix8 (non-negative keys),
// 2: pass1 (the row's int32 wrap-around sum; K is not read).
// keys (rows, N <= 4096) int32 contiguous, out (rows,) int32.
extern "C" int poem_kth_key_rows(int variant, const void* keys, void* out, int rows, int N, int K,
                                 void* stream) {
  if (rows < 1 || N < 1 || N > RS_MAX_N || variant < 0 || variant > 2)
    return (int)cudaErrorInvalidValue;
  if (variant != 2 && (K < 1 || K > N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((rows + RS_WARPS - 1) / RS_WARPS);
  const size_t smem = (size_t)RS_WARPS * N * sizeof(int);
  cudaError_t err = cudaSuccess;
  if (variant == 0) {
    err = allow_smem(kth_key_scan_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kth_key_scan_kernel<<<grid, RS_WARPS * 32, smem, s>>>((const int*)keys, (int*)out, rows, N, K);
  } else if (variant == 1) {
    err = allow_smem(kth_key_radix_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kth_key_radix_kernel<<<grid, RS_WARPS * 32, smem, s>>>((const int*)keys, (int*)out, rows, N, K);
  } else {
    key_row_sum_kernel<<<grid, RS_WARPS * 32, 0, s>>>((const int*)keys, (int*)out, rows, N);
  }
  return (int)cudaGetLastError();
}

// The K-th key of every row plus the one-hot hits of its query block of BQ rows
// (cur: bcast == 0, bcast: bcast != 0). keys (B, M, N) int32 with M % BQ == 0 and
// K % CJ == 0, out (B, M) int32.
extern "C" int poem_kth_key_onehot(int bcast, const void* keys, void* out, int B, int M, int N,
                                   int K, int BQ, int CJ, void* stream) {
  if (B < 1 || M < 1 || N < 1 || K < 1 || K > N || BQ < 1 || CJ < 1 || M % BQ || K % CJ)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = bcast ? launch_onehot<true>((const int*)keys, (int*)out, B, M, N, K, BQ, CJ, s)
                          : launch_onehot<false>((const int*)keys, (int*)out, B, M, N, K, BQ, CJ, s);
  return (int)err;
}
