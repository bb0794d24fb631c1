// What the vector-attention core's forward chain (`knn_attn.cu`) and its
// backward (`knn_attn_bwd.cu`) share: the row layout of their intermediates,
// each row's offset delta, and the first position layer t1, with the
// forward's roundings.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace poem {

constexpr int CR = 128;  // rows of a tile: two warpgroups of 64
constexpr int CK = 64;   // reduced columns a ring stage: one 128-byte swizzled row
enum { VA_KNN = 0, VA_ANCHOR = 1, VA_GATHERED = 2 };

// The row layout of the intermediates: tiles of 128 rows holding floor(128 /
// K) whole queries (spare rows at the end), or ceil(K / 128) tiles a query
// for K > 128; `tiles` tiles a sample.
struct RowMap {
  // QB queries a tile (K <= 128), T tiles a query (K > 128), tiles a sample
  int M, K, QB, T, tiles;
  __host__ __device__ RowMap(int M_, int K_) : M(M_), K(K_) {
    QB = K <= CR ? CR / K : 1;
    T = K <= CR ? 1 : (K + CR - 1) / CR;
    tiles = K <= CR ? (M + QB - 1) / QB : M * T;
  }
  // row r -> sample b, query m, neighbour j (clamped into range); false for a spare row
  __device__ __forceinline__ bool at(long long r, int& b, int& m, int& j) const {
    const long long tile_all = r / CR;
    const int i = (int)(r % CR);
    b = (int)(tile_all / tiles);
    const int tile = (int)(tile_all % tiles);
    bool valid;
    if (K <= CR) {
      const int qi = i / K;
      m = tile * QB + qi;
      j = i % K;
      valid = qi < QB && m < M;
    } else {
      m = tile / T;
      j = (tile % T) * CR + i;
      valid = j < K;
    }
    m = min(m, M - 1);
    j = min(j, K - 1);
    return valid;
  }
  // the first row of neighbour j of query m of sample b
  __device__ __forceinline__ long long row_of(int b, int m, int j) const {
    const long long base = (long long)b * tiles * CR;
    return K <= CR ? base + (long long)(m / QB) * CR + (m % QB) * K + j
                   : base + (long long)m * T * CR + j;
  }
};

// delta of row `row`, rounded to T: q_xyz - c_xyz[src] (K1, K2) or given (K8)
template <typename T>
__device__ __forceinline__ void row_delta(const RowMap& rm, long long row, int mode, int N,
                                          const float* __restrict__ qxyz,
                                          const float* __restrict__ cxyz,
                                          const int* __restrict__ idx,
                                          const __nv_bfloat16* __restrict__ delta, float (&d)[3]) {
  int b, m, j;
  rm.at(row, b, m, j);
  if (mode == VA_GATHERED) {
    const __nv_bfloat16* dp = delta + (((size_t)b * rm.M + m) * rm.K + j) * 3;
#pragma unroll
    for (int a = 0; a < 3; ++a) d[a] = __bfloat162float(dp[a]);
  } else {
    const int src = mode == VA_ANCHOR ? j : idx[((size_t)b * rm.M + m) * rm.K + j];
    const float* qp = qxyz + ((size_t)b * rm.M + m) * 3;
    const float* cp = cxyz + ((size_t)b * N + src) * 3;
#pragma unroll
    for (int a = 0; a < 3; ++a) d[a] = round_to<T>(qp[a] - cp[a]);
  }
}

// one channel of t1 = relu(delta W1 + b1) before its rounding: w0, w1, w2 are
// the channel's three weights, bias its b1
__device__ __forceinline__ float t1_value(const float (&d)[3], float w0, float w1, float w2,
                                          float bias) {
  return fmaxf(fmaf(d[2], w2, fmaf(d[1], w1, d[0] * w0)) + bias, 0.0f);
}

}  // namespace poem
