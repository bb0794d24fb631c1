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
// and each output row written once (at B4, 799 x 32 entries of 256 bf16
// against 4096 rows of 256 float32: 52 MB in, 17 MB out); there is next to
// no arithmetic. Float atomics would sum each row in a different order on
// every launch, and the TPU step is deterministic, so the entries are sorted
// into rows first (a stable counting sort) and each row is summed in
// ascending entry order. The sort must not be the cost: the first version
// placed a sample's 25 568 entries with one warp (800 dependent steps on B
// warps of a 132-SM card) and its time did not depend on D. Now each
// sample's entries are cut into segments of SEG = 1024, and every pass runs
// in parallel over (segment, sample):
// 1. `scatter_hist_kernel`: one block a segment counts its entries per row in
//    shared memory (integer atomics, exact in any order) and writes the whole
//    histogram, zeros included, to counts[b][s][row]: no memset.
// 2. `scatter_row_prefix_kernel`, one thread a row: the row's entries in
//    the segments before each segment, and its total; `scatter_scan_kernel`,
//    one block a sample: the rows' first slots (an exclusive scan of the
//    totals). Slots go rows in order, and within a row the segments in order.
// 3. `scatter_place_kernel`: one block a segment loads its cursors (one a
//    row: the row's first slot plus its entries in earlier segments) into
//    shared memory, then a warp walks the segment's entries in
//    ascending order, 32 at a time; lanes that hit one row are grouped with
//    __match_any_sync and take consecutive slots from that row's cursor, so
//    each row lists its entries in ascending entry order: the same
//    permutation as a one-warp walk over the whole sample.
// 4. `scatter_sum_kernel`: rows of the output; a lane loads 16 bytes of an
//    entry's row (8 bf16 or 4 float32), a warp takes 32 / L rows at once
//    where L lanes cover a row (L = D / 8 for bf16 up to 32), sums each row's
//    entries in order in float32 and writes every output row (rows no entry
//    hits get 0). Widths that are no multiple of 16 bytes take one column a
//    lane.
// Two launches on the same input give the same bits. Entries whose index
// lies outside [0, n_rows) are dropped, as the TPU kernel's one-hot drops
// them.
#include "common.cuh"

namespace poem {

constexpr int SC_SEG = 1024;  // entries a segment (ops/scatter.py: SEGMENT)
constexpr int SC_HIST_THREADS = 256;
constexpr int SC_SCAN_THREADS = 1024;
constexpr int SC_SUM_WARPS = 8;
constexpr int SC_MAX_ROWS_SMEM = 200 * 1024 / 4;

__global__ void __launch_bounds__(SC_HIST_THREADS)
    scatter_hist_kernel(const int* __restrict__ idx, int* __restrict__ counts, int E, int n_rows) {
  extern __shared__ int hist[];  // [n_rows]
  const int s = blockIdx.x, b = blockIdx.y, S = gridDim.x;
  for (int r = threadIdx.x; r < n_rows; r += SC_HIST_THREADS) hist[r] = 0;
  __syncthreads();
  const int e1 = min(E, (s + 1) * SC_SEG);
  for (int e = s * SC_SEG + threadIdx.x; e < e1; e += SC_HIST_THREADS) {
    const int r = idx[(size_t)b * E + e];
    if (r >= 0 && r < n_rows) atomicAdd(&hist[r], 1);
  }
  __syncthreads();
  int* out = counts + ((size_t)b * S + s) * n_rows;
  for (int r = threadIdx.x; r < n_rows; r += SC_HIST_THREADS) out[r] = hist[r];
}

// first[b][s][row] = the row's entries in segments before s; totals[b][row]
// = the row's entries. One thread a row, the segments' loads in flight together.
__global__ void __launch_bounds__(SC_HIST_THREADS)
    scatter_row_prefix_kernel(const int* __restrict__ counts, int* __restrict__ first,
                              int* __restrict__ totals, int n_rows, int S) {
  const int r = blockIdx.x * SC_HIST_THREADS + threadIdx.x, b = blockIdx.y;
  if (r >= n_rows) return;
  const int* c = counts + (size_t)b * S * n_rows + r;
  int* f = first + (size_t)b * S * n_rows + r;
  int run = 0;
#pragma unroll 8
  for (int s = 0; s < S; ++s) {
    const int n = c[(size_t)s * n_rows];
    f[(size_t)s * n_rows] = run;
    run += n;
  }
  totals[(size_t)b * n_rows + r] = run;
}

// offsets[b][row] = the row's first slot (exclusive scan of the totals),
// offsets[b][n_rows] = the sample's count of valid entries; one block a sample
__global__ void __launch_bounds__(SC_SCAN_THREADS)
    scatter_scan_kernel(const int* __restrict__ totals, int* __restrict__ offsets, int n_rows) {
  __shared__ int warp_tot[SC_SCAN_THREADS / 32];
  const int b = blockIdx.x, t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int* c = totals + (size_t)b * n_rows;
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

__global__ void __launch_bounds__(SC_HIST_THREADS)
    scatter_place_kernel(const int* __restrict__ idx, const int* __restrict__ first,
                         const int* __restrict__ offsets, int* __restrict__ perm, int E,
                         int n_rows) {
  extern __shared__ int cursor[];  // [n_rows]
  const int s = blockIdx.x, b = blockIdx.y, S = gridDim.x;
  const int* f = first + ((size_t)b * S + s) * n_rows;
  const int* o = offsets + (size_t)b * (n_rows + 1);
  for (int r = threadIdx.x; r < n_rows; r += SC_HIST_THREADS) cursor[r] = o[r] + f[r];
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int* ib = idx + (size_t)b * E;
  int* pb = perm + (size_t)b * E;
  const int e1 = min(E, (s + 1) * SC_SEG);
  int r_next = s * SC_SEG + lane < e1 ? ib[s * SC_SEG + lane] : -1;
  for (int e0 = s * SC_SEG; e0 < e1; e0 += 32) {
    const int e = e0 + lane;
    const int r = r_next;
    r_next = e + 32 < e1 ? ib[e + 32] : -1;  // prefetch the next 32 entries
    const bool valid = e < e1 && r >= 0 && r < n_rows;
    const int key = valid ? r : -1 - lane;  // invalid lanes stay alone
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, key);
    const int leader = __ffs(peers) - 1;
    const int rank = __popc(peers & ((1u << lane) - 1u));
    int slot = 0;
    if (valid && lane == leader) slot = cursor[r];
    slot = __shfl_sync(0xFFFFFFFFu, slot, leader);
    if (valid) pb[slot + rank] = e;
    if (valid && lane == leader) cursor[r] = slot + __popc(peers);
    __syncwarp();
  }
}

// 16 bytes of T as float32
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void add(float* acc, const uint4& u) {
    acc[0] += __uint_as_float(u.x);
    acc[1] += __uint_as_float(u.y);
    acc[2] += __uint_as_float(u.z);
    acc[3] += __uint_as_float(u.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void add(float* acc, const uint4& u) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] += __uint_as_float(w[i] << 16);
      acc[2 * i + 1] += __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};

// VEC: L lanes a row, 16 bytes a lane a step (D * sizeof(T) a multiple of 16).
// Otherwise one row a warp, one column a lane a step.
template <typename T, bool VEC>
__global__ void __launch_bounds__(SC_SUM_WARPS * 32)
    scatter_sum_kernel(const T* __restrict__ g, const int* __restrict__ offsets,
                       const int* __restrict__ perm, float* __restrict__ out, int E, int n_rows,
                       int D, int L) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per_warp = VEC ? 32 / L : 1;
  const int row = (blockIdx.x * SC_SUM_WARPS + warp) * per_warp + (VEC ? lane / L : 0);
  const int sub = VEC ? lane % L : lane;
  const int b = blockIdx.y;
  if (row >= n_rows) return;
  const int beg = offsets[(size_t)b * (n_rows + 1) + row];
  const int end = offsets[(size_t)b * (n_rows + 1) + row + 1];
  const int* pb = perm + (size_t)b * E;
  const T* gb = g + (size_t)b * E * D;
  float* ob = out + ((size_t)b * n_rows + row) * D;
  if (VEC) {
    constexpr int W = Vec<T>::N;
    for (int c = sub * W; c < D; c += L * W) {
      float acc[W];
#pragma unroll
      for (int i = 0; i < W; ++i) acc[i] = 0.0f;
      int p = beg;
      // four loads in flight, added in entry order
      for (; p + 4 <= end; p += 4) {
        uint4 u[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          u[k] = __ldg(reinterpret_cast<const uint4*>(gb + (size_t)pb[p + k] * D + c));
#pragma unroll
        for (int k = 0; k < 4; ++k) Vec<T>::add(acc, u[k]);
      }
      for (; p < end; ++p)
        Vec<T>::add(acc, __ldg(reinterpret_cast<const uint4*>(gb + (size_t)pb[p] * D + c)));
#pragma unroll
      for (int i = 0; i < W; i += 4)
        *reinterpret_cast<float4*>(ob + c + i) = make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    }
  } else {
    for (int c = sub; c < D; c += 32) {
      float acc = 0.0f;
      for (int p = beg; p < end; ++p) acc += to_f32(gb[(size_t)pb[p] * D + c]);
      ob[c] = acc;
    }
  }
}

template <typename T>
cudaError_t launch_sum(const void* g, const int* offsets, const int* perm, float* out, int B, int E,
                       int n_rows, int D, cudaStream_t s) {
  constexpr int W = Vec<T>::N;
  const bool vec = D % W == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  int L = 32;
  if (vec)
    while (L > 1 && L * W > D) L /= 2;
  const int rows_per_block = SC_SUM_WARPS * (vec ? 32 / L : 1);
  const dim3 grid((n_rows + rows_per_block - 1) / rows_per_block, B);
  if (vec)
    scatter_sum_kernel<T, true><<<grid, SC_SUM_WARPS * 32, 0, s>>>((const T*)g, offsets, perm,
                                                                  out, E, n_rows, D, L);
  else
    scatter_sum_kernel<T, false><<<grid, SC_SUM_WARPS * 32, 0, s>>>((const T*)g, offsets, perm,
                                                                   out, E, n_rows, D, 32);
  return cudaGetLastError();
}

}  // namespace poem

using namespace poem;

// g (B, E, D) float32 or bfloat16, idx (B, E) int32 -> out (B, n_rows, D)
// float32. Scratch from the caller, int32: counts (B (2 S + 1) n_rows, S =
// ceil(E / 1024): the histograms, the first slots within each row, the row
// totals), offsets (B, n_rows + 1), perm (B, E).
extern "C" int poem_scatter_add_rows(int dtype, const void* g, const void* idx, void* out,
                                     void* counts, void* offsets, void* perm, int B, int E,
                                     int n_rows, int D, void* stream) {
  if (B < 1 || E < 1 || n_rows < 1 || D < 1 || n_rows > SC_MAX_ROWS_SMEM)
    return (int)cudaErrorInvalidValue;
  if (dtype != DTYPE_F32 && dtype != DTYPE_BF16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int S = (E + SC_SEG - 1) / SC_SEG;
  const size_t smem = sizeof(int) * (size_t)n_rows;
  cudaError_t err;
  if ((err = allow_smem(scatter_hist_kernel, smem)) != cudaSuccess) return (int)err;
  if ((err = allow_smem(scatter_place_kernel, smem)) != cudaSuccess) return (int)err;
  scatter_hist_kernel<<<dim3(S, B), SC_HIST_THREADS, smem, s>>>((const int*)idx, (int*)counts, E,
                                                               n_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int* first = (int*)counts + (size_t)B * S * n_rows;
  int* totals = first + (size_t)B * S * n_rows;
  scatter_row_prefix_kernel<<<dim3((n_rows + SC_HIST_THREADS - 1) / SC_HIST_THREADS, B),
                              SC_HIST_THREADS, 0, s>>>((const int*)counts, first, totals, n_rows, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scatter_scan_kernel<<<B, SC_SCAN_THREADS, 0, s>>>(totals, (int*)offsets, n_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scatter_place_kernel<<<dim3(S, B), SC_HIST_THREADS, smem, s>>>(
      (const int*)idx, first, (const int*)offsets, (int*)perm, E, n_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)(dtype == DTYPE_F32
                   ? launch_sum<float>(g, (const int*)offsets, (const int*)perm, (float*)out, B,
                                       E, n_rows, D, s)
                   : launch_sum<__nv_bfloat16>(g, (const int*)offsets, (const int*)perm,
                                               (float*)out, B, E, n_rows, D, s));
}
