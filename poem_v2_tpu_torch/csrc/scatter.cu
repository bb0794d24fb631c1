// Deterministic scatter-add of gathered-row gradients (the backward of a
// row gather).
//
// Replaces the Pallas TPU kernel
//   poem_v2_tpu/ops/pallas_scatter.py:scatter_add_rows (K7; `_scatter_kernel`)
// which computes out[b, idx[b, e], :] += g[b, e, :] into a (B, n_rows, D)
// float32 output (e runs over the flattened (M, K) neighbour entries) as
// one-hot matrix products on the TPU's matrix unit.
//
// What bounds it on the H100: memory. Each entry's D-wide row is read once
// and each output row written once (at B8, 799 x 32 entries of 256 bf16
// against 4096 rows of 256 float32: about 13 MB in and 4 MB out per batch
// element); there is next to no arithmetic.
//
// Design: float atomics would sum each row in a different order on every
// launch, and the TPU step is deterministic, so the entries are sorted into
// rows first and each row is summed in ascending entry order:
// 1. `scatter_count_kernel`: per-batch histogram of idx (integer atomics,
//    exact in any order);
// 2. `scatter_scan_kernel`: one block per batch element turns the counts
//    into CSR row offsets (exclusive scan);
// 3. `scatter_fill_kernel`: one warp per batch element walks the entries in
//    order, 32 at a time; lanes that hit one row are grouped with
//    __match_any_sync and take consecutive slots from that row's cursor
//    (in shared memory), so each row lists its entries in ascending order
//    (a stable counting sort);
// 4. `scatter_sum_kernel`: one warp per (batch, row) sums the row's entries
//    in that order in float32, 8 columns per lane per 256-column group, and
//    writes every output row (rows no entry hits get 0).
// Two launches on the same input give the same bits. Entries whose index
// lies outside [0, n_rows) are dropped, as the TPU kernel's one-hot drops
// them.
#include "common.cuh"

namespace poem {

constexpr int SC_COUNT_THREADS = 256;
constexpr int SC_SCAN_THREADS = 1024;
constexpr int SC_SUM_WARPS = 8;
constexpr int SC_COLS = 8;  // columns per lane per 256-column group
constexpr int SC_MAX_ROWS_SMEM = 200 * 1024 / 4;

__global__ void scatter_count_kernel(const int* __restrict__ idx, int* __restrict__ counts, int E,
                                     int n_rows) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int r = idx[(size_t)b * E + e];
  if (r >= 0 && r < n_rows) atomicAdd(&counts[(size_t)b * n_rows + r], 1);
}

__global__ void __launch_bounds__(SC_SCAN_THREADS)
    scatter_scan_kernel(const int* __restrict__ counts, int* __restrict__ offsets, int n_rows) {
  __shared__ int warp_tot[SC_SCAN_THREADS / 32];
  const int b = blockIdx.x, t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int* c = counts + (size_t)b * n_rows;
  int* o = offsets + (size_t)b * (n_rows + 1);
  const int per = (n_rows + SC_SCAN_THREADS - 1) / SC_SCAN_THREADS;
  const int lo = min(t * per, n_rows), hi = min(lo + per, n_rows);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += c[i];
  // block-wide exclusive scan of the per-thread sums
  int incl = local;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_tot[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, w, off);
      if (lane >= off) w += y;
    }
    warp_tot[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int run = incl - local + (warp > 0 ? warp_tot[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    o[i] = run;
    run += c[i];
  }
  if (t == SC_SCAN_THREADS - 1) o[n_rows] = run;
}

__global__ void scatter_fill_kernel(const int* __restrict__ idx, const int* __restrict__ offsets,
                                    int* __restrict__ perm, int E, int n_rows) {
  extern __shared__ int cursor[];  // [n_rows]
  const int b = blockIdx.x, lane = threadIdx.x;
  const int* ib = idx + (size_t)b * E;
  int* pb = perm + (size_t)b * E;
  for (int i = lane; i < n_rows; i += 32) cursor[i] = offsets[(size_t)b * (n_rows + 1) + i];
  __syncwarp();
  int r_next = lane < E ? ib[lane] : -1;
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int e = e0 + lane;
    const int r = r_next;
    r_next = e + 32 < E ? ib[e + 32] : -1;  // prefetch the next 32 entries
    const bool valid = e < E && r >= 0 && r < n_rows;
    const int key = valid ? r : -1 - lane;  // invalid lanes stay alone
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, key);
    const int leader = __ffs(peers) - 1;
    const int rank = __popc(peers & ((1u << lane) - 1u));
    int base = 0;
    if (valid && lane == leader) base = cursor[r];
    base = __shfl_sync(0xFFFFFFFFu, base, leader);
    if (valid) pb[base + rank] = e;
    if (valid && lane == leader) cursor[r] = base + __popc(peers);
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(SC_SUM_WARPS * 32)
    scatter_sum_kernel(const T* __restrict__ g, const int* __restrict__ offsets,
                       const int* __restrict__ perm, float* __restrict__ out, int E, int n_rows,
                       int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * SC_SUM_WARPS + warp;
  const int b = blockIdx.y;
  if (row >= n_rows) return;
  const int beg = offsets[(size_t)b * (n_rows + 1) + row];
  const int end = offsets[(size_t)b * (n_rows + 1) + row + 1];
  const int* pb = perm + (size_t)b * E;
  const T* gb = g + (size_t)b * E * D;
  float* ob = out + ((size_t)b * n_rows + row) * D;
  for (int c0 = 0; c0 < D; c0 += 32 * SC_COLS) {
    float acc[SC_COLS];
#pragma unroll
    for (int j = 0; j < SC_COLS; ++j) acc[j] = 0.0f;
    for (int p = beg; p < end; ++p) {
      const T* src = gb + (size_t)pb[p] * D;
#pragma unroll
      for (int j = 0; j < SC_COLS; ++j) {
        const int c = c0 + lane + 32 * j;
        if (c < D) acc[j] += to_f32(src[c]);
      }
    }
#pragma unroll
    for (int j = 0; j < SC_COLS; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < D) ob[c] = acc[j];
    }
  }
}

}  // namespace poem

using namespace poem;

// g (B, E, D) float32 or bfloat16, idx (B, E) int32 -> out (B, n_rows, D)
// float32. Scratch from the caller: counts (B, n_rows), offsets
// (B, n_rows + 1) and perm (B, E), all int32.
extern "C" int poem_scatter_add_rows(int dtype, const void* g, const void* idx, void* out,
                                     void* counts, void* offsets, void* perm, int B, int E,
                                     int n_rows, int D, void* stream) {
  if (B < 1 || E < 1 || n_rows < 1 || D < 1 || n_rows > SC_MAX_ROWS_SMEM)
    return (int)cudaErrorInvalidValue;
  if (dtype != DTYPE_F32 && dtype != DTYPE_BF16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)B * n_rows, s);
  if (err != cudaSuccess) return (int)err;
  scatter_count_kernel<<<dim3((E + SC_COUNT_THREADS - 1) / SC_COUNT_THREADS, B),
                         SC_COUNT_THREADS, 0, s>>>((const int*)idx, (int*)counts, E, n_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scatter_scan_kernel<<<B, SC_SCAN_THREADS, 0, s>>>((const int*)counts, (int*)offsets, n_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t smem = sizeof(int) * (size_t)n_rows;
  err = allow_smem(scatter_fill_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  scatter_fill_kernel<<<B, 32, smem, s>>>((const int*)idx, (const int*)offsets, (int*)perm, E,
                                          n_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 grid((n_rows + SC_SUM_WARPS - 1) / SC_SUM_WARPS, B);
  if (dtype == DTYPE_F32)
    scatter_sum_kernel<float><<<grid, SC_SUM_WARPS * 32, 0, s>>>(
        (const float*)g, (const int*)offsets, (const int*)perm, (float*)out, E, n_rows, D);
  else
    scatter_sum_kernel<__nv_bfloat16><<<grid, SC_SUM_WARPS * 32, 0, s>>>(
        (const __nv_bfloat16*)g, (const int*)offsets, (const int*)perm, (float*)out, E, n_rows,
        D);
  return (int)cudaGetLastError();
}
