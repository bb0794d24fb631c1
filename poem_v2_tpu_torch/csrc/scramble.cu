// The merge-input scramble of a batch that mixes view counts.
//
// Replaces the Pallas TPU kernel
//   poem_v2_tpu/ops/pallas_scramble.py:scrambled_merge_gather (K5)
//
// The sampled features of one sample lie as (V, C, NS), read as V * NS rows
// of C elements. Output row (i, j) of sample b, i < NS, j < V, is source row
//   min(i * n_b + j, V * NS - 1),
// n_b being the sample's number of valid views, read from device memory.
// Rows with j >= n_b alias later data; the merge masks them. A pure copy:
// the element type only sets the row's byte count.
//
// What bounds it on the H100: bytes. Every input row is read about once
// (V / n_b times on average over the aliased rows, which hit the L2) and
// every output byte written once; there is no arithmetic beyond the index.
//
// Design: the TPU kernel copies a span per 64 samples and rearranges it
// with a one-hot product because the TPU has no cheap row gather. Here a
// row is one contiguous run: each thread moves one 16-byte vector,
// neighbouring threads neighbouring vectors of the same row, so a warp reads
// and writes whole 128-byte lines. Reads go through the read-only path and
// writes stream past the L1.
#include "common.cuh"

namespace poem {

constexpr int SCR_THREADS = 256;

__global__ void __launch_bounds__(SCR_THREADS)
    scramble_rows_kernel(const uint4* __restrict__ in, const int* __restrict__ n_val,
                         uint4* __restrict__ out, int V, int NS, int row_vecs,
                         long long total_vecs) {
  const long long o = (long long)blockIdx.x * SCR_THREADS + threadIdx.x;
  if (o >= total_vecs) return;
  const long long row = o / row_vecs;      // b * NS * V + i * V + j
  const int c = (int)(o - row * row_vecs);
  const int rows_per_sample = NS * V;
  const int b = (int)(row / rows_per_sample);
  const int ij = (int)(row - (long long)b * rows_per_sample);
  const int i = ij / V, j = ij - i * V;
  const int src = min(i * n_val[b] + j, rows_per_sample - 1);
  const uint4 v = __ldg(in + ((long long)b * rows_per_sample + src) * row_vecs + c);
  __stcs(out + o, v);
}

}  // namespace poem

using namespace poem;

// in: (B, V * NS rows, row_bytes), out: (B, NS, V, row_bytes), n_val: (B,) int32
// in 1..V. row_bytes must be a multiple of 16 and both pointers 16-byte aligned.
extern "C" int poem_scramble_rows(const void* in, const void* n_val, void* out, int B, int V,
                                  int NS, int row_bytes, void* stream) {
  if (B < 1 || V < 1 || NS < 1 || row_bytes < 16 || row_bytes % 16 != 0 ||
      ((uintptr_t)in | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int row_vecs = row_bytes / 16;
  const long long total = (long long)B * V * NS * row_vecs;
  const long long blocks = (total + SCR_THREADS - 1) / SCR_THREADS;
  if (blocks > 0x7FFFFFFFLL || (long long)V * NS > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  scramble_rows_kernel<<<(unsigned)blocks, SCR_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)in, (const int*)n_val, (uint4*)out, V, NS, row_vecs, total);
  return (int)cudaGetLastError();
}
