// Exact K-NN selection restricted to the candidate k-d buckets of a static
// cloud, with a per-query-block exactness margin.
//
// Replaces the selection and certificate of the Pallas TPU kernel
//   poem_v2_tpu/ops/pallas_knn_attn.py:fused_knn_vector_attention_bucketed (K9)
// (kernel body `_bucketed_kernel`). The gather and the vector attention of
// that body are `vector_attn_kernel` in knn_attn.cu, fed by the indices this
// kernel writes: the TPU's one-hot matrix gather has no place on this card.
//
// The cloud arrives bucket-contiguous: bucket j holds points j * SB ..
// (j + 1) * SB - 1, inside the box lo[j] .. hi[j]. For every block of BQ
// queries the caller names C candidate buckets. Per query the kernel
//   * forms d2 to the C * SB candidate points (`d2_rn`: one rounded operation
//     at a time, as the plain version forms it),
//   * takes K rounds of (smallest d2, lowest candidate column among equals)
//     over full float32 distances, and writes the points' cloud indices
//     cand[column / SB] * SB + column % SB,
//   * and bounds what it did not look at: the least squared distance from the
//     query to the box of any non-candidate bucket, minus the query's K-th
//     selected d2.
// The block's margin is the least of these over its queries; a margin >= 0
// proves that the block's neighbours are those of a search over the whole
// cloud. With no non-candidate bucket the value is not finite and is written
// as 3.4e38.
//
// What bounds it on the H100: K passes over C * SB keys per query out of
// shared memory (operations; the kernel reads 12 bytes per candidate point
// once per query, from L2). It is small beside the attention that follows:
// 5 D x D products per (query, neighbour) row.
//
// Design: one CUDA block per (sample, query block), whatever BQ is: its warps
// (up to 16, as many as have room for their candidates' distances in shared
// memory) take the block's queries in turn, one warp a query, and ragged last
// blocks simply have fewer queries (a padded copy of the last query would
// repeat its margin and change nothing). A warp keeps the query's candidate
// distances in shared memory as order-preserving unsigned values and selects
// with 64-bit (distance, column) keys, which are unique, so each round is
// "the smallest key above the last one" with a warp min. The margin is a min
// of floats: lanes, then warps through shared memory, in any order the same
// value, so no atomics.
#include <math.h>

#include "common.cuh"

namespace poem {

constexpr int BK_MAX_WARPS = 16;
constexpr size_t BK_SMEM_MAX = 227 * 1024;

inline size_t bucketed_select_smem(int C, int SB, int warps) {
  return ((size_t)C + BK_MAX_WARPS + (size_t)warps * C * SB) * sizeof(uint32_t);
}

__global__ void __launch_bounds__(BK_MAX_WARPS * 32)
    knn_select_bucketed_kernel(const float* __restrict__ qxyz, const float* __restrict__ ptxyz,
                               const int* __restrict__ cand, const float* __restrict__ lo,
                               const float* __restrict__ hi, int* __restrict__ idx,
                               float* __restrict__ margins, int M, int N, int NB, int K, int BQ,
                               int C, int SB) {
  extern __shared__ uint32_t bk_smem[];
  int* cand_s = reinterpret_cast<int*>(bk_smem);               // [C] candidate bucket ids
  float* warp_margin = reinterpret_cast<float*>(cand_s + C);   // [BK_MAX_WARPS]
  const int CW = C * SB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  uint32_t* ord = bk_smem + C + BK_MAX_WARPS + (size_t)warp * CW;  // [CW] this warp's distances
  const int blk = blockIdx.x, b = blockIdx.y;

  for (int j = threadIdx.x; j < C; j += blockDim.x)
    cand_s[j] = cand[((size_t)b * gridDim.x + blk) * C + j];
  __syncthreads();

  const float* p = ptxyz + (size_t)b * N * 3;
  float margin = INFINITY;
  for (int r = warp; r < BQ; r += n_warps) {
    const int m = blk * BQ + r;
    if (m >= M) break;  // the whole warp: the last block may be ragged
    const float* qp = qxyz + ((size_t)b * M + m) * 3;
    const float qx = qp[0], qy = qp[1], qz = qp[2];
    const float qq = sq3(qx, qy, qz);
    for (int j = lane; j < CW; j += 32) {
      const float* pp = p + ((size_t)cand_s[j / SB] * SB + j % SB) * 3;
      ord[j] = float_to_ordered(d2_rn(qx, qy, qz, qq, pp[0], pp[1], pp[2]));
    }
    __syncwarp();

    int* out = idx + ((size_t)b * M + m) * K;
    unsigned long long thr = 0;
    for (int k = 0; k < K; ++k) {
      unsigned long long best = ~0ull;
      for (int j = lane; j < CW; j += 32) {
        const unsigned long long key = ((unsigned long long)ord[j] << 32) | (uint32_t)j;
        if ((k == 0 || key > thr) && key < best) best = key;
      }
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, best, off);
        best = o < best ? o : best;
      }
      thr = best;
      if (lane == 0) {
        const int col = (int)(thr & 0xFFFFFFFFu);
        out[k] = cand_s[col / SB] * SB + col % SB;
      }
    }
    const float kth_d2 = ordered_to_float((uint32_t)(thr >> 32));

    // least box distance over the buckets that are not candidates
    float lb_min = INFINITY;
    for (int nb = lane; nb < NB; nb += 32) {
      bool is_cand = false;
      for (int j = 0; j < C; ++j) is_cand |= cand_s[j] == nb;
      if (is_cand) continue;
      const float dx = fmaxf(fmaxf(__fsub_rn(lo[nb * 3], qx), __fsub_rn(qx, hi[nb * 3])), 0.0f);
      const float dy =
          fmaxf(fmaxf(__fsub_rn(lo[nb * 3 + 1], qy), __fsub_rn(qy, hi[nb * 3 + 1])), 0.0f);
      const float dz =
          fmaxf(fmaxf(__fsub_rn(lo[nb * 3 + 2], qz), __fsub_rn(qz, hi[nb * 3 + 2])), 0.0f);
      lb_min = fminf(lb_min, sq3(dx, dy, dz));
    }
    for (int off = 16; off > 0; off >>= 1)
      lb_min = fminf(lb_min, __shfl_xor_sync(0xFFFFFFFFu, lb_min, off));
    margin = fminf(margin, __fsub_rn(lb_min, kth_d2));
    __syncwarp();  // every lane is done with ord before the next query overwrites it
  }
  if (lane == 0) warp_margin[warp] = margin;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < n_warps; ++w) margin = fminf(margin, warp_margin[w]);
    margins[(size_t)b * gridDim.x + blk] = isfinite(margin) ? margin : 3.4e38f;
  }
}

}  // namespace poem

using namespace poem;

// Select, for every query, its K nearest points among the C candidate buckets
// of its block: idx (B, M, K) int32 cloud indices in ascending (d2, candidate
// column) order, margins (B, ceil(M / BQ)) float32. cand is
// (B, ceil(M / BQ), C) int32 bucket ids, lo / hi (NB, 3), ptxyz (B, N, 3)
// with N == NB * SB, all contiguous.
extern "C" int poem_knn_select_bucketed(const void* qxyz, const void* ptxyz, const void* cand,
                                        const void* lo, const void* hi, void* idx,
                                        void* margins, int B, int M, int N, int NB, int K,
                                        int BQ, int C, int SB, void* stream) {
  if (B < 1 || M < 1 || BQ < 1 || SB < 1 || C < 1 || C > NB || N != NB * SB || K < 1 ||
      (long long)K > (long long)C * SB)
    return (int)cudaErrorInvalidValue;
  // one warp a query at a time: as many warps as the block has queries, up to
  // 16, fewer where their candidates' distances would not fit in shared memory
  int warps = BQ < BK_MAX_WARPS ? BQ : BK_MAX_WARPS;
  while (warps > 1 && bucketed_select_smem(C, SB, warps) > BK_SMEM_MAX) --warps;
  const size_t smem = bucketed_select_smem(C, SB, warps);
  if (smem > BK_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(knn_select_bucketed_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((M + BQ - 1) / BQ, B);
  knn_select_bucketed_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      (const float*)qxyz, (const float*)ptxyz, (const int*)cand, (const float*)lo,
      (const float*)hi, (int*)idx, (float*)margins, M, N, NB, K, BQ, C, SB);
  return (int)cudaGetLastError();
}
