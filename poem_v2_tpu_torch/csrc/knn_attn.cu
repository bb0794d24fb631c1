// Fused exact-KNN vector attention and fixed-anchor vector attention.
//
// Replaces the Pallas TPU kernels
//   poem_v2_tpu/ops/pallas_knn_attn.py:fused_knn_vector_attention (K1)
//   poem_v2_tpu/ops/pallas_knn_attn.py:fused_anchor_vector_attention (K2)
//
// Per query m and neighbour (or anchor) r the attention computes
//   pos  = relu(delta @ W1 + b1) @ W2 + b2        delta = q_xyz - nn_xyz
//   x    = q - k + pos                            k = x_g @ Wk (K1) or given (K2)
//   g    = (relu(x @ G0 + c0) @ G1 + c1) / sqrt(D)
//   out  = sum_r softmax_r(g)_c * (v + pos)_c     v = x_g @ Wv (K1) or given (K2)
// with a separate softmax for every channel c.
//
// What bounds it on the H100: five D x D products per (query, neighbour)
// row, about 5 * D^2 multiply-adds, so at D = 256 and 32 neighbours it is
// arithmetic-bound (about 0.27 TFLOP for one 16 x 799 query call). The
// selection reads only xyz and is cheap beside it.
//
// Design:
// * Selection (`knn_select_kernel`): one warp per query. With the padded
//   cloud at most 4096 points the warp packs (bits(d2) & ~0xFFF) | column
//   into 32-bit keys in shared memory and runs K rounds of "smallest key
//   above the last one" with a warp min, exactly the TPU kernel's packed
//   key selection (lowest index wins ties). Larger clouds take exact
//   argmin rounds over 64-bit (orderable d2 bits, column) keys. d2 is
//   formed with __fmul_rn / __fadd_rn in the plain version's operation
//   order so no fused multiply-add moves the 12 masked bits.
// * Attention (`vector_attn_kernel`): one block of 256 threads takes 32
//   rows (32 / K queries of K neighbours each). Thread j owns output
//   channel j for all 32 rows, so every weight element it reads from
//   global memory serves 32 rows, the row operands come from shared memory
//   as broadcasts, and the per-channel softmax over the K neighbours is
//   local to the thread. Products accumulate in float32. Scalar FMA, no
//   tensor cores yet: that is later work (wgmma).
#include "common.cuh"

namespace poem {

constexpr int SEL_WARPS = 4;
constexpr int PACK_MAX = 4096;
constexpr int VA_ROWS = 32;
constexpr int VA_THREADS = 256;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

template <bool PACKED>
__global__ void knn_select_kernel(const float* __restrict__ qxyz, const float* __restrict__ ptxyz,
                                  int* __restrict__ idx, int M, int N, int K) {
  extern __shared__ uint32_t keys_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const int m = blockIdx.x * SEL_WARPS + warp;
  if (m >= M) return;  // whole warp leaves; the kernel has no block barrier
  const float* qp = qxyz + ((size_t)b * M + m) * 3;
  const float* p = ptxyz + (size_t)b * N * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float qq = sq3(qx, qy, qz);
  int* out = idx + ((size_t)b * M + m) * K;

  auto d2_of = [&](int j) {
    const float px = p[3 * j], py = p[3 * j + 1], pz = p[3 * j + 2];
    const float cross =
        __fadd_rn(__fadd_rn(__fmul_rn(qx, px), __fmul_rn(qy, py)), __fmul_rn(qz, pz));
    return __fsub_rn(__fadd_rn(qq, sq3(px, py, pz)), __fmul_rn(2.0f, cross));
  };

  if (PACKED) {
    uint32_t* keys = keys_smem + warp * N;
    for (int j = lane; j < N; j += 32) {
      const float d = fmaxf(d2_of(j), 0.0f);  // d2 >= 0: unsigned order == float order
      keys[j] = (__float_as_uint(d) & ~0xFFFu) | (uint32_t)j;
    }
    __syncwarp();
    uint32_t thr = 0;
    for (int k = 0; k < K; ++k) {
      uint32_t best = 0xFFFFFFFFu;
      for (int j = lane; j < N; j += 32) {
        const uint32_t key = keys[j];
        if ((k == 0 || key > thr) && key < best) best = key;
      }
      thr = __reduce_min_sync(0xFFFFFFFFu, best);
      if (lane == 0) out[k] = (int)(thr & 0xFFFu);
    }
  } else {
    // exact argmin rounds: (d2, column) in lexicographic order; d2 is not
    // clamped, so map its bits to an order-preserving unsigned value
    unsigned long long thr = 0;
    for (int k = 0; k < K; ++k) {
      unsigned long long best = ~0ull;
      for (int j = lane; j < N; j += 32) {
        const uint32_t u = __float_as_uint(d2_of(j));
        const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
        const unsigned long long key = ((unsigned long long)ord << 32) | (uint32_t)j;
        if ((k == 0 || key > thr) && key < best) best = key;
      }
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, best, off);
        best = o < best ? o : best;
      }
      thr = best;
      if (lane == 0) out[k] = (int)(thr & 0xFFFFFFFFu);
    }
  }
}

// acc[r] = sum_k X[r][k] * W[k][j] for the 32 rows in shared memory X.
template <typename T>
__device__ __forceinline__ void rows_times_matrix(const float* __restrict__ X,
                                                  const T* __restrict__ W, int D, int j,
                                                  float (&acc)[VA_ROWS]) {
#pragma unroll
  for (int r = 0; r < VA_ROWS; ++r) acc[r] = 0.0f;
  for (int k = 0; k < D; k += 4) {
    const float w0 = to_f32(W[(size_t)k * D + j]);
    const float w1 = to_f32(W[(size_t)(k + 1) * D + j]);
    const float w2 = to_f32(W[(size_t)(k + 2) * D + j]);
    const float w3 = to_f32(W[(size_t)(k + 3) * D + j]);
#pragma unroll
    for (int r = 0; r < VA_ROWS; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(X + r * D + k);
      acc[r] = fmaf(x.x, w0, fmaf(x.y, w1, fmaf(x.z, w2, fmaf(x.w, w3, acc[r]))));
    }
  }
}

// ANCHOR = false: K1, rows gathered from x_full by idx, k/v projected here.
// ANCHOR = true:  K2, row r of a query is anchor r, k/v given pre-projected.
template <typename T, bool ANCHOR>
__global__ void __launch_bounds__(VA_THREADS)
    vector_attn_kernel(const T* __restrict__ q, const float* __restrict__ qxyz,
                       const float* __restrict__ cxyz, const int* __restrict__ idx,
                       const T* __restrict__ xk, const T* __restrict__ va,
                       const T* __restrict__ wk, const T* __restrict__ wv,
                       const T* __restrict__ w1, const T* __restrict__ b1,
                       const T* __restrict__ w2, const T* __restrict__ b2,
                       const T* __restrict__ g0, const T* __restrict__ c0,
                       const T* __restrict__ g1, const T* __restrict__ c1, T* __restrict__ out,
                       int M, int N, int D, int K) {
  extern __shared__ float smem[];
  float* XG = smem;                  // [32][D] gathered x, then v + pos
  float* B1 = XG + VA_ROWS * D;      // [32][D] t1, then x, then g
  float* POS = B1 + VA_ROWS * D;     // [32][D] pos, then h
  float* DL = POS + VA_ROWS * D;     // [32][3] delta
  int* SRC = reinterpret_cast<int*>(DL + VA_ROWS * 3);  // [32] source row

  const int QB = VA_ROWS / K;  // queries per block
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * QB;
  const int t = threadIdx.x;
  const int j = t;
  const bool col = j < D;

  if (t < VA_ROWS) {
    const int mq = m0 + t / K, kk = t % K;
    int src = 0;
    float dx = 0.f, dy = 0.f, dz = 0.f;
    if (mq < M) {
      src = ANCHOR ? kk : idx[((size_t)b * M + mq) * K + kk];
      const float* qp = qxyz + ((size_t)b * M + mq) * 3;
      const float* cp = cxyz + ((size_t)b * N + src) * 3;
      dx = qp[0] - cp[0];
      dy = qp[1] - cp[1];
      dz = qp[2] - cp[2];
    }
    SRC[t] = src;
    DL[t * 3 + 0] = round_to<T>(dx);
    DL[t * 3 + 1] = round_to<T>(dy);
    DL[t * 3 + 2] = round_to<T>(dz);
  }
  __syncthreads();

  for (int e = t; e < VA_ROWS * D; e += VA_THREADS) {
    const int r = e / D, c = e % D;
    XG[e] = to_f32(xk[((size_t)b * N + SRC[r]) * D + c]);
  }
  if (col) {
    const float a0 = to_f32(w1[j]), a1 = to_f32(w1[D + j]), a2 = to_f32(w1[2 * D + j]);
    const float bias = to_f32(b1[j]);
    for (int r = 0; r < VA_ROWS; ++r) {
      const float h = fmaf(DL[r * 3 + 2], a2, fmaf(DL[r * 3 + 1], a1, DL[r * 3] * a0)) + bias;
      B1[r * D + j] = round_to<T>(fmaxf(h, 0.0f));
    }
  }
  __syncthreads();

  float acc[VA_ROWS];
  // pos = t1 @ W2 + b2
  if (col) {
    rows_times_matrix(B1, w2, D, j, acc);
    const float bias = to_f32(b2[j]);
#pragma unroll
    for (int r = 0; r < VA_ROWS; ++r) POS[r * D + j] = acc[r] + bias;
  }
  __syncthreads();

  // x = q - k + pos, rounded for the fc_gamma product
  if (col) {
    if (!ANCHOR) rows_times_matrix(XG, wk, D, j, acc);
#pragma unroll
    for (int r = 0; r < VA_ROWS; ++r) {
      const int mq = min(m0 + r / K, M - 1);
      const float kv = ANCHOR ? XG[r * D + j] : acc[r];
      const float qv = to_f32(q[((size_t)b * M + mq) * D + j]);
      B1[r * D + j] = round_to<T>(qv - kv + POS[r * D + j]);
    }
  }
  // v + pos replaces x_g: every thread must finish reading x_g first
  if (!ANCHOR && col) rows_times_matrix(XG, wv, D, j, acc);
  __syncthreads();
  if (col) {
#pragma unroll
    for (int r = 0; r < VA_ROWS; ++r) {
      const float vv = ANCHOR ? to_f32(va[((size_t)b * N + SRC[r]) * D + j]) : acc[r];
      XG[r * D + j] = vv + POS[r * D + j];
    }
  }
  __syncthreads();

  // h = relu(x @ G0 + c0), rounded for the next product; pos is no longer needed
  if (col) {
    rows_times_matrix(B1, g0, D, j, acc);
    const float bias = to_f32(c0[j]);
#pragma unroll
    for (int r = 0; r < VA_ROWS; ++r) POS[r * D + j] = round_to<T>(fmaxf(acc[r] + bias, 0.0f));
  }
  __syncthreads();

  // g = (h @ G1 + c1) / sqrt(D); then the per-channel softmax over each query's rows
  if (col) {
    rows_times_matrix(POS, g1, D, j, acc);
    const float bias = to_f32(c1[j]);
    const float inv_sqrt_d = 1.0f / sqrtf((float)D);
#pragma unroll
    for (int r = 0; r < VA_ROWS; ++r) B1[r * D + j] = (acc[r] + bias) * inv_sqrt_d;
    for (int qi = 0; qi < QB; ++qi) {
      const int mq = m0 + qi;
      if (mq >= M) break;
      const float* g = B1 + qi * K * D + j;
      const float* v = XG + qi * K * D + j;
      float mx = -INFINITY;
      for (int kk = 0; kk < K; ++kk) mx = fmaxf(mx, g[kk * D]);
      float s = 0.f, o = 0.f;
      for (int kk = 0; kk < K; ++kk) {
        const float e = expf(g[kk * D] - mx);
        s += e;
        o = fmaf(e, v[kk * D], o);
      }
      out[((size_t)b * M + mq) * D + j] = from_f32<T>(o / s);
    }
  }
}

template <typename T, bool ANCHOR>
cudaError_t launch_vector_attn(const void* q, const void* qxyz, const void* cxyz, const void* idx,
                               const void* xk, const void* va, const void* wk, const void* wv,
                               const void* w1, const void* b1, const void* w2, const void* b2,
                               const void* g0, const void* c0, const void* g1, const void* c1,
                               void* out, int B, int M, int N, int D, int K,
                               cudaStream_t stream) {
  auto kernel = vector_attn_kernel<T, ANCHOR>;
  const size_t smem = (size_t)3 * VA_ROWS * D * sizeof(float) + VA_ROWS * 3 * sizeof(float) +
                      VA_ROWS * sizeof(int);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int qb = VA_ROWS / K;
  dim3 grid((M + qb - 1) / qb, B);
  kernel<<<grid, VA_THREADS, smem, stream>>>(
      (const T*)q, (const float*)qxyz, (const float*)cxyz, (const int*)idx, (const T*)xk,
      (const T*)va, (const T*)wk, (const T*)wv, (const T*)w1, (const T*)b1, (const T*)w2,
      (const T*)b2, (const T*)g0, (const T*)c0, (const T*)g1, (const T*)c1, (T*)out, M, N, D, K);
  return cudaGetLastError();
}

}  // namespace poem

using namespace poem;

// Select the K nearest cloud points of every query; idx is (B, M, K) int32
// in ascending (distance, index) order. packed != 0 uses the 12-bit
// packed keys (N <= 4096 required), packed == 0 exact argmin rounds.
extern "C" int poem_knn_select(const void* qxyz, const void* ptxyz, void* idx, int B, int M,
                               int N, int K, int packed, void* stream) {
  dim3 grid((M + SEL_WARPS - 1) / SEL_WARPS, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (packed) {
    if (N > PACK_MAX) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)SEL_WARPS * N * sizeof(uint32_t);
    cudaError_t err = allow_smem(knn_select_kernel<true>, smem);
    if (err != cudaSuccess) return (int)err;
    knn_select_kernel<true><<<grid, SEL_WARPS * 32, smem, s>>>(
        (const float*)qxyz, (const float*)ptxyz, (int*)idx, M, N, K);
  } else {
    knn_select_kernel<false><<<grid, SEL_WARPS * 32, 0, s>>>(
        (const float*)qxyz, (const float*)ptxyz, (int*)idx, M, N, K);
  }
  return (int)cudaGetLastError();
}

// anchor == 0: K1 attention over the rows idx selects from x_full (xk),
// projected by wk / wv. anchor != 0: K2, xk / va are the (B, N, D)
// pre-projected anchor keys / values and cxyz the (B, N, 3) anchor coords.
extern "C" int poem_vector_attention(int dtype, int anchor, const void* q, const void* qxyz,
                                     const void* cxyz, const void* idx, const void* xk,
                                     const void* va, const void* wk, const void* wv,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, const void* g0, const void* c0,
                                     const void* g1, const void* c1, void* out, int B, int M,
                                     int N, int D, int K, void* stream) {
  if (D > VA_THREADS || D % 4 != 0 || K < 1 || VA_ROWS % K != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define POEM_VA(T, A)                                                                         \
  launch_vector_attn<T, A>(q, qxyz, cxyz, idx, xk, va, wk, wv, w1, b1, w2, b2, g0, c0, g1, c1, \
                           out, B, M, N, D, K, s)
  cudaError_t err;
  if (dtype == DTYPE_F32)
    err = anchor ? POEM_VA(float, true) : POEM_VA(float, false);
  else if (dtype == DTYPE_BF16)
    err = anchor ? POEM_VA(__nv_bfloat16, true) : POEM_VA(__nv_bfloat16, false);
  else
    err = cudaErrorInvalidValue;
#undef POEM_VA
  return (int)err;
}
