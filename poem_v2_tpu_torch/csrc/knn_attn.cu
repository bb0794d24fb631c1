// Fused exact-KNN vector attention, fixed-anchor vector attention and the
// vector attention on neighbours gathered by the caller.
//
// Replaces the Pallas TPU kernels
//   poem_v2_tpu/ops/pallas_knn_attn.py:fused_knn_vector_attention (K1)
//   poem_v2_tpu/ops/pallas_knn_attn.py:fused_anchor_vector_attention (K2)
//   poem_v2_tpu/ops/pallas_vector_attn.py:fused_vector_attention (K8)
//
// Per query m and neighbour (or anchor) r the attention computes
//   pos  = relu(delta @ W1 + b1) @ W2 + b2        delta = q_xyz - nn_xyz, or given (K8)
//   x    = q - k + pos                            k = x_g @ Wk (K1) or given (K2, K8)
//   g    = (relu(x @ G0 + c0) @ G1 + c1) / sqrt(D)
//   out  = sum_r softmax_r(g)_c * (v + pos)_c     v = x_g @ Wv (K1) or given (K2, K8)
// with a separate softmax for every channel c. Operands of every product
// are rounded to the tensors' dtype, sums, x, the softmax and the
// aggregate stay float32, as the TPU kernels compute them.
//
// What bounds it on the H100: five (K1) or three (K2, K8) D x D products
// per (query, neighbour) row, 2 * D^2 operations each, against one read of
// the inputs: arithmetic-bound at every width the models use (D = 128 to
// 1024). The selection reads only xyz and is cheap beside it.
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
// * Attention (`vector_attn_kernel`): one block of 256 (or 512) threads keeps ROWS
//   (query, neighbour) rows in three [ROWS][D] float32 buffers in shared
//   memory. Thread t owns output channels t, t + threads, ... for all rows, so
//   every weight element it reads from global memory serves ROWS rows, the
//   row operands come from shared memory as broadcasts, and the per-channel
//   softmax over the K neighbours is local to the thread. The buffers must
//   fit 227 KB: a block keeps 32 rows up to D = 256 and 16 above; a
//   query whose K neighbours exceed ROWS is taken in chunks with a running
//   max, sum and output per channel, as the TPU kernel folds its chunks.
//   Products accumulate in float32. Scalar FMA, no tensor cores yet: that
//   is later work (wgmma).
#include "common.cuh"

namespace poem {

constexpr int SEL_WARPS = 4;
constexpr int PACK_MAX = 4096;
constexpr int VA_THREADS = 256;
enum { VA_KNN = 0, VA_ANCHOR = 1, VA_GATHERED = 2 };

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
    return d2_rn(qx, qy, qz, qq, p[3 * j], p[3 * j + 1], p[3 * j + 2]);
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
        const unsigned long long key =
            ((unsigned long long)float_to_ordered(d2_of(j)) << 32) | (uint32_t)j;
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

// acc[r] = sum_k X[r][k] * W[k][j] for the ROWS rows in shared memory X.
template <typename T, int ROWS>
__device__ __forceinline__ void rows_times_matrix(const float* __restrict__ X,
                                                  const T* __restrict__ W, int D, int j,
                                                  float (&acc)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
  for (int k = 0; k < D; k += 4) {
    const float w0 = to_f32(W[(size_t)k * D + j]);
    const float w1 = to_f32(W[(size_t)(k + 1) * D + j]);
    const float w2 = to_f32(W[(size_t)(k + 2) * D + j]);
    const float w3 = to_f32(W[(size_t)(k + 3) * D + j]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(X + r * D + k);
      acc[r] = fmaf(x.x, w0, fmaf(x.y, w1, fmaf(x.z, w2, fmaf(x.w, w3, acc[r]))));
    }
  }
}

// Bytes of dynamic shared memory of one block: three [ROWS][D] float32
// buffers, the [3][D] softmax state, the [ROWS][3] deltas, the [ROWS] source rows.
inline size_t vector_attn_smem(int rows, int D) {
  return ((size_t)3 * rows * D + 3 * D + 3 * rows) * sizeof(float) + rows * sizeof(int);
}

// The two shapes of a block. Narrow (D <= 256): 32 rows and 256 threads, one
// channel a thread and one chunk, both known at compile time, two blocks an
// SM. Wide (D up to 1024): 16 rows, so that the buffers fit, and 512 threads,
// whose extra warps hide more of the weights' latency.
template <bool WIDE>
struct VaBlock {
  static constexpr int ROWS = WIDE ? 16 : 32;
  static constexpr int THREADS = WIDE ? 2 * VA_THREADS : VA_THREADS;
};

// MODE = VA_KNN:      K1, rows gathered from x_full (xk) by idx, k / v projected here.
// MODE = VA_ANCHOR:   K2, neighbour r of every query is anchor r; xk / va are the
//                     (B, N, D) pre-projected anchor keys / values.
// MODE = VA_GATHERED: K8, xk / va are the (B, M, K, D) keys / values already
//                     gathered per (query, neighbour), delta their (B, M, K, 3) offsets.
//
// A block holds ROWS (query, neighbour) rows in shared memory. With
// K <= ROWS it takes ROWS / K whole queries; with K > ROWS one query in
// K / ROWS chunks, folded into a running per-channel max, sum and output
// (the TPU kernel's fold_chunk). Thread t owns channels t, t + THREADS, ...
// WIDE = false is the case D <= 256 and K <= ROWS, known at compile time:
// one channel a thread and one chunk, so neither loop is left in the code.
template <typename T, int MODE, bool WIDE>
__global__ void __launch_bounds__(VaBlock<WIDE>::THREADS)
    vector_attn_kernel(const T* __restrict__ q, const float* __restrict__ qxyz,
                       const float* __restrict__ cxyz, const int* __restrict__ idx,
                       const T* __restrict__ xk, const T* __restrict__ va,
                       const T* __restrict__ delta, const T* __restrict__ wk,
                       const T* __restrict__ wv, const T* __restrict__ w1,
                       const T* __restrict__ b1, const T* __restrict__ w2,
                       const T* __restrict__ b2, const T* __restrict__ g0,
                       const T* __restrict__ c0, const T* __restrict__ g1,
                       const T* __restrict__ c1, T* __restrict__ out, int M, int N, int D, int K) {
  constexpr int ROWS = VaBlock<WIDE>::ROWS, THREADS = VaBlock<WIDE>::THREADS;
  extern __shared__ float smem[];
  float* XG = smem;                // [ROWS][D] gathered x (K1) or k (K2, K8), then h
  float* B1 = XG + ROWS * D;       // [ROWS][D] t1, then x, then g
  float* POS = B1 + ROWS * D;      // [ROWS][D] pos, then v + pos
  float* ST = POS + ROWS * D;      // [3][D] running max, sum, output across chunks
  float* DL = ST + 3 * D;          // [ROWS][3] delta
  int* SRC = reinterpret_cast<int*>(DL + ROWS * 3);  // [ROWS] row of xk / va (/ delta)

  const int KC = (!WIDE || K < ROWS) ? K : ROWS;  // neighbours of one query per chunk
  const int QB = ROWS / KC;                       // queries per block
  const int n_chunks = WIDE ? K / KC : 1;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * QB;
  const int t = threadIdx.x;
  const float inv_sqrt_d = 1.0f / sqrtf((float)D);
  float acc[ROWS];
  // body(j) for every channel j the thread owns
  auto own_channels = [&](auto body) {
    if (WIDE) {
      for (int j = t; j < D; j += THREADS) body(j);
    } else if (t < D) {
      body(t);
    }
  };

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    // the barrier below also ends the previous chunk's reads of XG and B1
    if (t < ROWS) {
      const int mq = m0 + t / KC, kk = chunk * KC + t % KC;
      int src = 0;
      float dx = 0.f, dy = 0.f, dz = 0.f;
      if (mq < M) {
        if (MODE == VA_GATHERED) {
          src = (b * M + mq) * K + kk;
          const T* dp = delta + (size_t)src * 3;
          dx = to_f32(dp[0]);
          dy = to_f32(dp[1]);
          dz = to_f32(dp[2]);
        } else {
          src = b * N + (MODE == VA_ANCHOR ? kk : idx[((size_t)b * M + mq) * K + kk]);
          const float* qp = qxyz + ((size_t)b * M + mq) * 3;
          const float* cp = cxyz + (size_t)src * 3;
          dx = qp[0] - cp[0];
          dy = qp[1] - cp[1];
          dz = qp[2] - cp[2];
        }
      }
      SRC[t] = src;
      DL[t * 3 + 0] = round_to<T>(dx);
      DL[t * 3 + 1] = round_to<T>(dy);
      DL[t * 3 + 2] = round_to<T>(dz);
    }
    __syncthreads();

    for (int e = t; e < ROWS * D; e += THREADS) {
      const int r = e / D, c = e % D;
      XG[e] = to_f32(xk[(size_t)SRC[r] * D + c]);
    }
    // t1 = relu(delta @ W1 + b1), rounded for the next product
    own_channels([&](int j) {
      const float a0 = to_f32(w1[j]), a1 = to_f32(w1[D + j]), a2 = to_f32(w1[2 * D + j]);
      const float bias = to_f32(b1[j]);
      for (int r = 0; r < ROWS; ++r) {
        const float h = fmaf(DL[r * 3 + 2], a2, fmaf(DL[r * 3 + 1], a1, DL[r * 3] * a0)) + bias;
        B1[r * D + j] = round_to<T>(fmaxf(h, 0.0f));
      }
    });
    __syncthreads();

    // pos = t1 @ W2 + b2
    own_channels([&](int j) {
      rows_times_matrix(B1, w2, D, j, acc);
      const float bias = to_f32(b2[j]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) POS[r * D + j] = acc[r] + bias;
    });
    __syncthreads();

    // x = q - k + pos, rounded for the fc_gamma product, into B1; v + pos
    // into POS. Both touch the thread's own columns only; XG is read-only here
    own_channels([&](int j) {
      if (MODE == VA_KNN) rows_times_matrix(XG, wk, D, j, acc);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int mq = min(m0 + r / KC, M - 1);
        const float kv = MODE == VA_KNN ? acc[r] : XG[r * D + j];
        const float qv = to_f32(q[((size_t)b * M + mq) * D + j]);
        B1[r * D + j] = round_to<T>(qv - kv + POS[r * D + j]);
      }
      if (MODE == VA_KNN) rows_times_matrix(XG, wv, D, j, acc);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float vv = MODE == VA_KNN ? acc[r] : to_f32(va[(size_t)SRC[r] * D + j]);
        POS[r * D + j] += vv;
      }
    });
    __syncthreads();

    // h = relu(x @ G0 + c0), rounded for the next product, over the spent XG
    own_channels([&](int j) {
      rows_times_matrix(B1, g0, D, j, acc);
      const float bias = to_f32(c0[j]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) XG[r * D + j] = round_to<T>(fmaxf(acc[r] + bias, 0.0f));
    });
    __syncthreads();

    // g = (h @ G1 + c1) / sqrt(D); then the per-channel softmax over each
    // query's neighbours, folded into the running state when K spans chunks
    own_channels([&](int j) {
      rows_times_matrix(XG, g1, D, j, acc);
      const float bias = to_f32(c1[j]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) B1[r * D + j] = (acc[r] + bias) * inv_sqrt_d;
      for (int qi = 0; qi < QB; ++qi) {
        const int mq = m0 + qi;
        if (mq >= M) break;
        const float* g = B1 + qi * KC * D + j;
        const float* v = POS + qi * KC * D + j;
        float mx = -INFINITY, s = 0.f, o = 0.f;
        if (chunk > 0) {  // n_chunks > 1 means one query per block
          mx = ST[j];
          s = ST[D + j];
          o = ST[2 * D + j];
        }
        float cm = mx;
        for (int kk = 0; kk < KC; ++kk) cm = fmaxf(cm, g[kk * D]);
        if (chunk > 0) {
          const float rescale = expf(mx - cm);
          s *= rescale;
          o *= rescale;
        }
        for (int kk = 0; kk < KC; ++kk) {
          const float e = expf(g[kk * D] - cm);
          s += e;
          o = fmaf(e, v[kk * D], o);
        }
        if (chunk == n_chunks - 1) {
          out[((size_t)b * M + mq) * D + j] = from_f32<T>(o / s);
        } else {
          ST[j] = cm;
          ST[D + j] = s;
          ST[2 * D + j] = o;
        }
      }
    });
  }
}

template <typename T, int MODE, bool WIDE>
cudaError_t launch_vector_attn(const void* q, const void* qxyz, const void* cxyz, const void* idx,
                               const void* xk, const void* va, const void* delta, const void* wk,
                               const void* wv, const void* w1, const void* b1, const void* w2,
                               const void* b2, const void* g0, const void* c0, const void* g1,
                               const void* c1, void* out, int B, int M, int N, int D, int K,
                               cudaStream_t stream) {
  constexpr int ROWS = VaBlock<WIDE>::ROWS, THREADS = VaBlock<WIDE>::THREADS;
  auto kernel = vector_attn_kernel<T, MODE, WIDE>;
  const size_t smem = vector_attn_smem(ROWS, D);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int qb = K < ROWS ? ROWS / K : 1;
  dim3 grid((M + qb - 1) / qb, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const float*)qxyz, (const float*)cxyz, (const int*)idx, (const T*)xk,
      (const T*)va, (const T*)delta, (const T*)wk, (const T*)wv, (const T*)w1, (const T*)b1,
      (const T*)w2, (const T*)b2, (const T*)g0, (const T*)c0, (const T*)g1, (const T*)c1,
      (T*)out, M, N, D, K);
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

// The attention core in its three modes (see vector_attn_kernel):
// mode 0 (K1): idx selects rows of x_full (xk, (B, N, D)), projected by wk / wv;
// mode 1 (K2): xk / va are the (B, N, D) pre-projected anchors, cxyz their (B, N, 3) coords;
// mode 2 (K8): xk / va are (B, M, K, D) gathered keys / values, delta (B, M, K, 3).
// Takes D % 4 == 0 up to 1024 and K dividing 32; the block's shape follows
// from D (VaBlock).
extern "C" int poem_vector_attention(int dtype, int mode, const void* q, const void* qxyz,
                                     const void* cxyz, const void* idx, const void* xk,
                                     const void* va, const void* delta, const void* wk,
                                     const void* wv, const void* w1, const void* b1,
                                     const void* w2, const void* b2, const void* g0,
                                     const void* c0, const void* g1, const void* c1, void* out,
                                     int B, int M, int N, int D, int K, void* stream) {
  if (D < 4 || D % 4 != 0 || D > 1024 || K < 1 || 32 % K != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define POEM_VA_WIDE(T, MODE, WIDE)                                                          \
  launch_vector_attn<T, MODE, WIDE>(q, qxyz, cxyz, idx, xk, va, delta, wk, wv, w1, b1, w2, b2, \
                                    g0, c0, g1, c1, out, B, M, N, D, K, s)
#define POEM_VA(T, MODE) \
  (D <= VA_THREADS ? POEM_VA_WIDE(T, MODE, false) : POEM_VA_WIDE(T, MODE, true))
#define POEM_VA_MODES(T)                                                    \
  (mode == VA_KNN ? POEM_VA(T, VA_KNN)                                      \
                  : mode == VA_ANCHOR ? POEM_VA(T, VA_ANCHOR)               \
                                      : mode == VA_GATHERED ? POEM_VA(T, VA_GATHERED) \
                                                            : cudaErrorInvalidValue)
  cudaError_t err;
  if (dtype == DTYPE_F32)
    err = POEM_VA_MODES(float);
  else if (dtype == DTYPE_BF16)
    err = POEM_VA_MODES(__nv_bfloat16);
  else
    err = cudaErrorInvalidValue;
#undef POEM_VA_MODES
#undef POEM_VA
#undef POEM_VA_WIDE
  return (int)err;
}
