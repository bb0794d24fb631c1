// Exact K-NN selection restricted to the candidate k-d buckets of a static
// cloud, with a per-query-block exactness margin.
//
// Replaces the selection and certificate of the Pallas TPU kernel
//   poem_v2_tpu/ops/pallas_knn_attn.py:fused_knn_vector_attention_bucketed (K9)
// (kernel body `_bucketed_kernel`). The gather and the vector attention of
// that body are K1's attention in knn_attn.cu, fed by the indices this kernel
// writes: the TPU's one-hot matrix gather has no place on this card.
//
// The cloud arrives bucket-contiguous: bucket j holds points j * SB ..
// (j + 1) * SB - 1, inside the box lo[j] .. hi[j]. For every block of BQ
// queries the caller names C candidate buckets. Per query the kernel
//   * forms d2 to the C * SB candidate points (`d2_rn`: one rounded operation
//     at a time, as the plain version forms it),
//   * takes the K least (d2, candidate column) keys in order, over full
//     float32 distances, and writes the points' cloud indices
//     cand[column / SB] * SB + column % SB,
//   * and bounds what it did not look at: the least squared distance from the
//     query to the box of any non-candidate bucket, minus the query's K-th
//     selected d2.
// The block's margin is the least of these over its queries; a margin >= 0
// proves that the block's neighbours are those of a search over the whole
// cloud. With no non-candidate bucket the value is not finite and is written
// as 3.4e38.
//
// What bounds it on the H100: 14 float32 operations a (query, candidate)
// pair (13 for d2, one compare), 0.0007 ms at B 4, 799 queries, 1024
// candidates; the bytes (the queries, the cloud once, the indices) are less.
//
// Design: the selection is `select_core.cuh`'s, on 64-bit keys. A query block
// is split over CUDA blocks of 4 to 16 warps, a warp a query (`rows_per_block`:
// at B 4, 799 queries and blocks of 32, 500 blocks of 7; the old kernel had
// 100 blocks). A block stages its candidates' (x, y, z, |p|^2) once in shared
// memory (16 KB at 1024 candidates; more than 6144 candidates are read from L2
// instead, up to 32 768) and marks them in a bitmask of the NB buckets. A
// query's box bound skips the candidates by the bitmask; its margin goes to a
// (B, M) scratch, and a second kernel takes each query block's least, a float
// min, the same value in any order: no atomics, and the same bits on every
// launch.
#include <math.h>

#include "common.cuh"
#include "select_core.cuh"

namespace poem {

inline size_t bucketed_select_smem(int CW, int NB, bool staged) {
  return (staged ? (size_t)CW * sizeof(float4) : 0) + (size_t)(NB + 31) / 32 * sizeof(uint32_t);
}

// Query block qb = blockIdx.x / splits of sample blockIdx.y; this block of qpb
// warps takes its queries part * qpb .. part * qpb + qpb - 1 (part = blockIdx.x
// % splits), a warp a query.
template <bool STAGED>
__global__ void __launch_bounds__(SC_MAX_WARPS * SC_LANES)
    knn_select_bucketed_kernel(const float* __restrict__ qxyz, const float* __restrict__ ptxyz,
                               const int* __restrict__ cand, const float* __restrict__ lo,
                               const float* __restrict__ hi, int* __restrict__ idx,
                               float* __restrict__ qmargin, int M, int N, int NB, int K, int BQ,
                               int C, int SB, int qpb, int splits) {
  extern __shared__ float4 bk_smem[];
  const int CW = C * SB;
  float4* pts = bk_smem;  // [CW] when STAGED
  uint32_t* is_cand = reinterpret_cast<uint32_t*>(bk_smem + (STAGED ? CW : 0));  // [NB / 32]
  const int b = blockIdx.y, qb = blockIdx.x / splits, part = blockIdx.x % splits;
  const int nblk = gridDim.x / splits;
  const int* cb = cand + ((size_t)b * nblk + qb) * C;
  const float* p = ptxyz + (size_t)b * N * 3;

  for (int w = threadIdx.x; w < (NB + 31) / 32; w += blockDim.x) is_cand[w] = 0u;
  if (STAGED) {
    for (int j = threadIdx.x; j < CW; j += blockDim.x) {
      const int c = j / SB;
      const float* pp = p + ((size_t)cb[c] * SB + (j - c * SB)) * 3;
      const float x = pp[0], y = pp[1], z = pp[2];
      pts[j] = make_float4(x, y, z, sq3(x, y, z));
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {  // an OR: the same bits in any order
    const int nb = cb[c];
    atomicOr(is_cand + nb / 32, 1u << (nb % 32));
  }
  __syncthreads();

  const int w = threadIdx.x / SC_LANES, lane = threadIdx.x % SC_LANES;
  const int m = qb * BQ + part * qpb + w;
  if (part * qpb + w < BQ && m < M) {
    const SelQuery q(qxyz + ((size_t)b * M + m) * 3);
    int* out = idx + ((size_t)b * M + m) * K;
    auto emit = [&](int r, key64_t key) {
      const int col = key_column(key), c = col / SB;
      out[r] = cb[c] * SB + (col - c * SB);
    };
    const key64_t kth = STAGED
        ? least_keys_in_order<key64_t>(SmemPoints<key64_t>{pts, CW, q}, K, emit)
        : least_keys_in_order<key64_t>(CandidatePoints{p, cb, SB, CW, q}, K, emit);
    const float kth_d2 = ordered_to_float((uint32_t)(kth >> 32));

    // least box distance over the buckets that are not candidates
    float lb = INFINITY;
    for (int nb = lane; nb < NB; nb += SC_LANES) {
      if ((is_cand[nb / 32] >> (nb % 32)) & 1u) continue;
      const float dx = fmaxf(fmaxf(__fsub_rn(lo[nb * 3], q.x), __fsub_rn(q.x, hi[nb * 3])), 0.0f);
      const float dy =
          fmaxf(fmaxf(__fsub_rn(lo[nb * 3 + 1], q.y), __fsub_rn(q.y, hi[nb * 3 + 1])), 0.0f);
      const float dz =
          fmaxf(fmaxf(__fsub_rn(lo[nb * 3 + 2], q.z), __fsub_rn(q.z, hi[nb * 3 + 2])), 0.0f);
      lb = fminf(lb, sq3(dx, dy, dz));
    }
    // bounds are >= 0 (or +inf): their bits order as the floats do
    lb = __uint_as_float(warp_min(__float_as_uint(lb)));
    if (lane == 0) qmargin[(size_t)b * M + m] = __fsub_rn(lb, kth_d2);
  }
}

// margins[b, qb] = the least margin of query block qb's queries, 3.4e38 when
// it is not finite (every bucket a candidate). One warp a query block.
__global__ void bucket_margin_kernel(const float* __restrict__ qmargin,
                                     float* __restrict__ margins, int M, int BQ) {
  const int qb = blockIdx.x, b = blockIdx.y;
  const int end = min(M, (qb + 1) * BQ);
  float v = INFINITY;
  for (int m = qb * BQ + (int)threadIdx.x; m < end; m += 32)
    v = fminf(v, qmargin[(size_t)b * M + m]);
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  if (threadIdx.x == 0) margins[(size_t)b * gridDim.x + qb] = isfinite(v) ? v : 3.4e38f;
}

}  // namespace poem

using namespace poem;

// Select, for every query, its K nearest points among the C candidate buckets
// of its block: idx (B, M, K) int32 cloud indices in ascending (d2, candidate
// column) order, margins (B, ceil(M / BQ)) float32; qmargin is (B, M) float32
// scratch. cand is (B, ceil(M / BQ), C) int32 bucket ids, lo / hi (NB, 3),
// ptxyz (B, N, 3) with N == NB * SB, all contiguous.
extern "C" int poem_knn_select_bucketed(const void* qxyz, const void* ptxyz, const void* cand,
                                        const void* lo, const void* hi, void* idx,
                                        void* margins, void* qmargin, int B, int M, int N, int NB,
                                        int K, int BQ, int C, int SB, void* stream) {
  if (B < 1 || M < 1 || BQ < 1 || SB < 1 || C < 1 || C > NB || N != NB * SB || K < 1 ||
      (long long)K > (long long)C * SB || (long long)C * SB > 32768)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nblk = (M + BQ - 1) / BQ, CW = C * SB;
  const bool staged = CW <= SC_STAGE_MAX;
  const size_t smem = bucketed_select_smem(CW, NB, staged);
  const int qpb = rows_per_block((long long)B * nblk, BQ, smem);
  const int splits = (BQ + qpb - 1) / qpb;
  cudaError_t err = staged ? allow_smem(knn_select_bucketed_kernel<true>, smem)
                           : allow_smem(knn_select_bucketed_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nblk * splits, B);
  const float *q = (const float*)qxyz, *p = (const float*)ptxyz;
  if (staged)
    knn_select_bucketed_kernel<true><<<grid, qpb * SC_LANES, smem, s>>>(
        q, p, (const int*)cand, (const float*)lo, (const float*)hi, (int*)idx, (float*)qmargin,
        M, N, NB, K, BQ, C, SB, qpb, splits);
  else
    knn_select_bucketed_kernel<false><<<grid, qpb * SC_LANES, smem, s>>>(
        q, p, (const int*)cand, (const float*)lo, (const float*)hi, (int*)idx, (float*)qmargin,
        M, N, NB, K, BQ, C, SB, qpb, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bucket_margin_kernel<<<dim3(nblk, B), 32, 0, s>>>((const float*)qmargin, (float*)margins, M, BQ);
  return (int)cudaGetLastError();
}
