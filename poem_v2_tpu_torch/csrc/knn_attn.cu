// Fused exact-KNN vector attention, fixed-anchor vector attention and the
// vector attention on neighbours gathered by the caller.
//
// Replaces the Pallas TPU kernels
//   poem_v2_tpu/ops/pallas_knn_attn.py:fused_knn_vector_attention (K1, also
//     fed with precomputed indices: _kernel_from_idx)
//   poem_v2_tpu/ops/pallas_knn_attn.py:fused_anchor_vector_attention (K2)
//   poem_v2_tpu/ops/pallas_vector_attn.py:fused_vector_attention (K8)
//
// Per query m and neighbour (or anchor) r the attention computes
//   pos  = relu(delta @ W1 + b1) @ W2 + b2        delta = q_xyz - nn_xyz, or given (K8)
//   x    = q - k + pos                            k = x_g @ Wk (K1) or given (K2, K8)
//   g    = (relu(x @ G0 + c0) @ G1 + c1) / sqrt(D)
//   out  = sum_r softmax_r(g)_c * (v + pos)_c     v = x_g @ Wv (K1) or given (K2, K8)
// with a separate softmax for every channel c. Operands of every product
// are rounded to the tensors' dtype, sums, pos, x, the softmax and the
// aggregate stay float32, as the TPU kernels compute them.
//
// What bounds it on the H100: three D x D products per (query, neighbour)
// row, and for K1 two more per cloud point (the k / v projection), 2 D^2
// operations each, against one read of the inputs: arithmetic-bound at every
// width the models use (D = 128 to 1024). In bfloat16 only `wgmma` reaches
// the tensor cores' rate. The selection reads only xyz.
//
// Selection (`knn_select_kernel`, on `select_core.cuh`): the K least keys of
// each query's row, with the TPU kernel's packed 32-bit keys (bits(d2) &
// ~0xFFF) | column while the cloud padded to 128 is at most 4096 points
// (lowest index wins ties), exact 64-bit (d2, column) keys above. d2 is
// formed with __fmul_rn / __fadd_rn in the plain version's operation order,
// so no fused multiply-add moves the 12 masked bits. What bounds it: 14
// float32 operations a (query, point) pair (13 for d2, one compare), 0.0027
// ms at B 4, 799 queries, 4096 points; one pass over the row keeps it there.
// A block of 4 to 16 warps (`rows_per_block`: 13 at B 4, 799 queries and 4096
// points) takes as many queries of one sample, a warp a query, with the cloud
// staged once a block in shared memory as (x, y, z, |p|^2) (64 KB at 4096
// points; clouds above 6144 points are read from L2 instead). Indices given by
// the caller skip it.
//
// bfloat16 attention: a chain of tensor-core kernels (second half of the
// file, design there). The TPU kernel projects k and v of every gathered row
// (two of K1's five products a row); a cloud point is gathered by ~6 queries
// (cross) or ~32 (self), so the chain projects the cloud once, kv = x_full
// [Wk | Wv] in float32, and gathers rows of it: the same arithmetic up to the
// order of float32 sums. Then every mode runs the same three D x D products
// a row and differs only in where k / v come from.
//
// float32 attention (`vector_attn_kernel`, first half): no tensor-core path
// at full precision; it serves the float32 parity checks and stays a scalar
// FMA kernel. One block of 256 (or 512) threads keeps ROWS (query,
// neighbour) rows in three [ROWS][D] float32 buffers in shared memory; thread
// t owns output channels t, t + threads, ... for all rows, so the per-channel
// softmax over the K neighbours is local to the thread. A block keeps 32 rows
// up to D = 256 and 16 above; a query whose K neighbours exceed ROWS is taken
// in chunks with a running max, sum and output per channel, as the TPU
// kernel folds its chunks; a chunk takes floor(ROWS / K) whole queries
// otherwise. Any K.
#include <cuda.h>

#include <initializer_list>

#include "common.cuh"
#include "hopper.cuh"
#include "knn_core.cuh"
#include "select_core.cuh"

namespace poem {

constexpr int PACK_MAX = 4096;
constexpr int VA_THREADS = 256;

// (x, y, z, |p|^2) of sample b's N points into shared memory, |p|^2 rounded
// as d2_rn forms it.
__device__ __forceinline__ void stage_points(float4* pts, const float* __restrict__ p, int N) {
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const float x = p[3 * j], y = p[3 * j + 1], z = p[3 * j + 2];
    pts[j] = make_float4(x, y, z, sq3(x, y, z));
  }
}

// The K nearest of the N cloud points of every query, in ascending key order:
// Key = uint32_t, the TPU kernel's packed keys (N <= 4096); key64_t, exact
// (d2, column) order. A block of `qpb` warps takes qpb queries of one sample,
// a warp a query (`least_keys_in_order`), with the cloud staged once in shared
// memory (STAGED) or read from L2 (clouds above SC_STAGE_MAX).
template <typename Key, bool STAGED>
__global__ void __launch_bounds__(SC_MAX_WARPS * SC_LANES)
    knn_select_kernel(const float* __restrict__ qxyz, const float* __restrict__ ptxyz,
                      int* __restrict__ idx, int M, int N, int K, int qpb) {
  extern __shared__ float4 sel_pts[];  // [N] when STAGED
  const int b = blockIdx.y, w = threadIdx.x / SC_LANES;
  const float* p = ptxyz + (size_t)b * N * 3;
  if (STAGED) {
    stage_points(sel_pts, p, N);
    __syncthreads();
  }
  const int m = (int)blockIdx.x * qpb + w;
  if (m < M) {
    const SelQuery q(qxyz + ((size_t)b * M + m) * 3);
    int* out = idx + ((size_t)b * M + m) * K;
    auto emit = [&](int r, Key key) { out[r] = key_column(key); };
    if (STAGED)
      least_keys_in_order<Key>(SmemPoints<Key>{sel_pts, N, q}, K, emit);
    else
      least_keys_in_order<Key>(GlobalPoints<Key>{p, N, q}, K, emit);
  }
}

// ---------------------------------------------------------------------------
// float32: the FMA kernel.

// acc[r] = sum_k X[r][k] * W[k][j] for the ROWS rows in shared memory X.
template <int ROWS>
__device__ __forceinline__ void rows_times_matrix(const float* __restrict__ X,
                                                  const float* __restrict__ W, int D, int j,
                                                  float (&acc)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
  for (int k = 0; k < D; k += 4) {
    const float w0 = W[(size_t)k * D + j];
    const float w1 = W[(size_t)(k + 1) * D + j];
    const float w2 = W[(size_t)(k + 2) * D + j];
    const float w3 = W[(size_t)(k + 3) * D + j];
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
// channel a thread, two blocks an SM. Wide (D up to 1024): 16 rows, so that
// the buffers fit, and 512 threads, whose extra warps hide more of the
// weights' latency.
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
// A block holds ROWS (query, neighbour) rows in shared memory: a chunk of
// KC = min(K, ROWS) neighbours of QB = ROWS / KC whole queries, spare rows
// idle. With K > ROWS (CHUNKED) one query takes ceil(K / ROWS) chunks, folded
// into a running per-channel max, sum and output (the TPU kernel's
// fold_chunk); otherwise the one chunk is known at compile time, which keeps
// the chunk loop and its state out of the code (a run-time loop there made
// K1 55% slower at D 256, B4, on an H100 80GB HBM3).
template <int MODE, bool WIDE, bool CHUNKED>
__global__ void __launch_bounds__(VaBlock<WIDE>::THREADS)
    vector_attn_kernel(const float* __restrict__ q, const float* __restrict__ qxyz,
                       const float* __restrict__ cxyz, const int* __restrict__ idx,
                       const float* __restrict__ xk, const float* __restrict__ va,
                       const float* __restrict__ delta, const float* __restrict__ wk,
                       const float* __restrict__ wv, const float* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, const float* __restrict__ g0,
                       const float* __restrict__ c0, const float* __restrict__ g1,
                       const float* __restrict__ c1, float* __restrict__ out, int M, int N,
                       int D, int K) {
  constexpr int ROWS = VaBlock<WIDE>::ROWS, THREADS = VaBlock<WIDE>::THREADS;
  extern __shared__ float smem[];
  float* XG = smem;                // [ROWS][D] gathered x (K1) or k (K2, K8), then h
  float* B1 = XG + ROWS * D;       // [ROWS][D] t1, then x, then g
  float* POS = B1 + ROWS * D;      // [ROWS][D] pos, then v + pos
  float* ST = POS + ROWS * D;      // [3][D] running max, sum, output across chunks
  float* DL = ST + 3 * D;          // [ROWS][3] delta
  int* SRC = reinterpret_cast<int*>(DL + ROWS * 3);  // [ROWS] row of xk / va (/ delta)

  const int KC = CHUNKED ? ROWS : K;   // neighbours of one query per chunk
  const int QB = ROWS / KC;            // queries per block
  const int n_chunks = CHUNKED ? (K + KC - 1) / KC : 1;
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
      if (t / KC < QB && mq < M && kk < K) {
        if (MODE == VA_GATHERED) {
          src = (b * M + mq) * K + kk;
          const float* dp = delta + (size_t)src * 3;
          dx = dp[0];
          dy = dp[1];
          dz = dp[2];
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
      DL[t * 3 + 0] = dx;
      DL[t * 3 + 1] = dy;
      DL[t * 3 + 2] = dz;
    }
    __syncthreads();

    for (int e = t; e < ROWS * D; e += THREADS) {
      const int r = e / D, c = e % D;
      XG[e] = xk[(size_t)SRC[r] * D + c];
    }
    // t1 = relu(delta @ W1 + b1)
    own_channels([&](int j) {
      const float a0 = w1[j], a1 = w1[D + j], a2 = w1[2 * D + j];
      const float bias = b1[j];
      for (int r = 0; r < ROWS; ++r) {
        const float h = fmaf(DL[r * 3 + 2], a2, fmaf(DL[r * 3 + 1], a1, DL[r * 3] * a0)) + bias;
        B1[r * D + j] = fmaxf(h, 0.0f);
      }
    });
    __syncthreads();

    // pos = t1 @ W2 + b2
    own_channels([&](int j) {
      rows_times_matrix(B1, w2, D, j, acc);
      const float bias = b2[j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) POS[r * D + j] = acc[r] + bias;
    });
    __syncthreads();

    // x = q - k + pos into B1; v + pos into POS. Both touch the thread's own
    // columns only; XG is read-only here
    own_channels([&](int j) {
      if (MODE == VA_KNN) rows_times_matrix(XG, wk, D, j, acc);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int mq = min(m0 + r / KC, M - 1);
        const float kv = MODE == VA_KNN ? acc[r] : XG[r * D + j];
        B1[r * D + j] = q[((size_t)b * M + mq) * D + j] - kv + POS[r * D + j];
      }
      if (MODE == VA_KNN) rows_times_matrix(XG, wv, D, j, acc);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float vv = MODE == VA_KNN ? acc[r] : va[(size_t)SRC[r] * D + j];
        POS[r * D + j] += vv;
      }
    });
    __syncthreads();

    // h = relu(x @ G0 + c0) over the spent XG
    own_channels([&](int j) {
      rows_times_matrix(B1, g0, D, j, acc);
      const float bias = c0[j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) XG[r * D + j] = fmaxf(acc[r] + bias, 0.0f);
    });
    __syncthreads();

    // g = (h @ G1 + c1) / sqrt(D); then the per-channel softmax over each
    // query's neighbours, folded into the running state when K spans chunks
    own_channels([&](int j) {
      rows_times_matrix(XG, g1, D, j, acc);
      const float bias = c1[j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) B1[r * D + j] = (acc[r] + bias) * inv_sqrt_d;
      const int kmax = min(KC, K - chunk * KC);
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
        for (int kk = 0; kk < kmax; ++kk) cm = fmaxf(cm, g[kk * D]);
        if (chunk > 0) {
          const float rescale = expf(mx - cm);
          s *= rescale;
          o *= rescale;
        }
        for (int kk = 0; kk < kmax; ++kk) {
          const float e = expf(g[kk * D] - cm);
          s += e;
          o = fmaf(e, v[kk * D], o);
        }
        if (chunk == n_chunks - 1) {
          out[((size_t)b * M + mq) * D + j] = o / s;
        } else {
          ST[j] = cm;
          ST[D + j] = s;
          ST[2 * D + j] = o;
        }
      }
    });
  }
}

template <int MODE, bool WIDE, bool CHUNKED>
cudaError_t launch_vector_attn(const void* q, const void* qxyz, const void* cxyz, const void* idx,
                               const void* xk, const void* va, const void* delta, const void* wk,
                               const void* wv, const void* w1, const void* b1, const void* w2,
                               const void* b2, const void* g0, const void* c0, const void* g1,
                               const void* c1, void* out, int B, int M, int N, int D, int K,
                               cudaStream_t stream) {
  constexpr int ROWS = VaBlock<WIDE>::ROWS, THREADS = VaBlock<WIDE>::THREADS;
  auto kernel = vector_attn_kernel<MODE, WIDE, CHUNKED>;
  const size_t smem = vector_attn_smem(ROWS, D);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int qb = ROWS / (K < ROWS ? K : ROWS);
  dim3 grid((M + qb - 1) / qb, B);
  using F = const float*;
  kernel<<<grid, THREADS, smem, stream>>>((F)q, (F)qxyz, (F)cxyz, (const int*)idx, (F)xk, (F)va,
                                          (F)delta, (F)wk, (F)wv, (F)w1, (F)b1, (F)w2, (F)b2,
                                          (F)g0, (F)c0, (F)g1, (F)c1, (float*)out, M, N, D, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the attention as a chain of tensor-core kernels.
//
// What bounds it: the three D x D products a row (and K1's projection of the
// cloud), so they run as `wgmma`, and the weights must serve many rows per
// pass. Design:
// * Rows. The (query, neighbour) rows are laid out in tiles of 128: a tile
//   holds floor(128 / K) whole queries (spare rows are computed and never
//   read) or, for K > 128, a query takes ceil(K / 128) tiles. K = 32 (every
//   config) wastes no row; K = 24 and 48 waste 8 and 32 of 128.
// * One product kernel (`core_gemm_kernel`), C = A W on a block of 128 rows
//   (two warpgroups of 64) by NS = 128 output columns: R = 128 rows per pass
//   over the weights, each weight byte read once per 128 rows (at D 1024,
//   three products at B4: 5 GB of weight reads from L2). A (128 rows x 64
//   reduced columns) and W (64 reduced rows x NS columns) arrive as 128-byte
//   swizzled boxes through a ring of 3 stages (2 in the softmax pass) in
//   shared memory by TMA, completing on `full` mbarriers; one elected thread
//   refills a stage when all eight warps have given it back on its `empty`
//   mbarrier, with no producer warp (in `cross_attn.cu` a third warpgroup
//   capped the consumers' registers). A is the K-major operand, W the MN-major one, both
//   straight from shared memory; the accumulators are float32 registers (64 a
//   thread). One chunk of products stays in flight while the previous stage
//   is given back. Two blocks share an SM, so that one block's epilogue (the
//   gathers of the pos pass) runs beside the other's products; the column
//   tile varies fastest in the grid, so the D / 128 blocks of a row tile read
//   its A together from L2.
// * The epilogues carry the function's roundings:
//     kv  = x_full [Wk | Wv]             -> float32 (B, N, 2D)   (K1 only)
//     x   = q - k + (t1 W2 + b2)         -> bfloat16 rows; v + pos -> float32 rows,
//       where the pass makes its A operand t1 = relu(delta W1 + b1) itself (three
//       multiply-adds a channel, rounded to bf16) into the stage, in the swizzle
//       TMA would have used, and only the weights arrive by TMA
//     h   = relu(x G0 + c0)              -> bfloat16 rows, through the spent ring
//       by bulk tensor stores (0.077 -> 0.055 ms at D 256, B4, on an H100
//       80GB HBM3; the same staging made the pos pass slower, whose row
//       gathers bound it)
//     g   = (h G1 + c1) / sqrt(D)        -> shared memory, a 128 x 128 float32 tile;
//   then 256 threads, two a column, fold each query's rows into the
//   per-channel softmax and the aggregate with v + pos (float32, a TMA box
//   brought into shared memory while the products ran), and
//   write the output (for K > 128 a running max / sum / output per column
//   across the query's tiles, as the TPU kernel's fold_chunk).
// * Where the intermediates live. A block would need two 128 x D bfloat16
//   row tiles (x while h is formed) beside the ring: 128 KB at D 256, 512 KB
//   at D 1024, beyond the 227 KB of shared memory above D 256. So x, h
//   (bfloat16) and v + pos (float32, as the function keeps it) go to device
//   memory, written once and read once, each row block's share mostly from
//   L2: at D 256, B4, 102 272 rows, 52 MB a bfloat16 intermediate. pos is
//   kept as v + pos beside x, not recomputed; t1 never leaves shared memory.
// The chain needs D a multiple of 128 and 16-byte aligned tensors; the
// wrapper pads other widths with zero channels.
constexpr int CNS = 128;  // output columns a block
constexpr int CORE_THREADS = 256;
enum { EPI_KV = 0, EPI_POS = 1, EPI_RELU = 2, EPI_SOFTMAX = 3 };

// The row layout of the intermediates: RowMap (knn_core.cuh).

// Shared memory of a block: the ring, its barriers (and the softmax pass's
// v + pos barrier), then for the softmax pass the g tile [128][NS + 8] and the
// v + pos tile [128][NS], both float32. The other passes keep 3 stages, 97 KB,
// so that two blocks share an SM (one's epilogue runs beside the other's
// products: 128 registers a thread); the softmax pass keeps 2 stages so that
// both tiles fit, 64 + 68 + 64 KB, one block an SM.
template <int NS, int EPI> struct CoreCfg {
  static constexpr bool SOFTMAX = EPI == EPI_SOFTMAX;
  static constexpr int NST = SOFTMAX ? 2 : 3;      // ring stages
  static constexpr int BLOCKS_PER_SM = SOFTMAX ? 1 : 2;
  static constexpr int A_BYTES = CR * CK * 2;       // [128 rows][64] bf16
  static constexpr int B_BYTES = CK * NS * 2;       // NS / 64 boxes of [64 rows][64] bf16
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int NB = NS / 64;                // 64-column accumulator slices
  static constexpr int GS = NS + 8;                 // row stride of the g tile (floats)
  static constexpr int BAR_BYTES = 128;                // 2 NST + 1 barriers; keeps G 128-byte aligned
  static constexpr int G_BYTES = SOFTMAX ? CR * GS * 4 : 0;
  static constexpr int VP_BYTES = SOFTMAX ? CR * NS * 4 : 0;
  static constexpr size_t SMEM = 1024 + (size_t)NST * STAGE + BAR_BYTES + G_BYTES + VP_BYTES;
};

// what the epilogues read and write
struct CoreArgs {
  const __nv_bfloat16* q;      // (B, M, D)
  const float* kvf;            // K1: (B, N, 2D) float32 projected cloud
  const __nv_bfloat16* kb;     // K2: (B, N, D) anchors' keys; K8: (B, M, K, D) keys
  const __nv_bfloat16* vb;     // values, as kb
  const int* idx;              // K1: (B, M, K)
  const __nv_bfloat16* bias;   // b2, c0 or c1 (D)
  const float* qxyz;           // (B, M, 3): K1, K2
  const float* cxyz;           // (B, N, 3): K1 cloud, K2 anchors
  const __nv_bfloat16* delta;  // K8: (B, M, K, 3)
  const __nv_bfloat16* w1;     // (3, D)
  const __nv_bfloat16* b1;     // (D)
  float* kv;                   // K1's projection pass: (B, N, 2D) float32
  __nv_bfloat16* x;            // the pos pass: (rows, D) x
  float* vp;                   // the pos pass: (rows, D) v + pos
  __nv_bfloat16* out;          // (B, M, D)
  int mode, B, M, N, D, K, n_rows;
  float scale;
};

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) { return hop::pack_bf16(lo, hi); }

// 8 channels c0 .. c0 + 7 of t1 = relu(delta W1 + b1), packed as bf16
__device__ __forceinline__ uint4 t1_chunk(const float (&d)[3], const __nv_bfloat16* __restrict__ w1,
                                          const __nv_bfloat16* __restrict__ b1, int D, int c0) {
  const uint4 w[3] = {__ldg(reinterpret_cast<const uint4*>(w1 + c0)),
                      __ldg(reinterpret_cast<const uint4*>(w1 + D + c0)),
                      __ldg(reinterpret_cast<const uint4*>(w1 + 2 * D + c0))};
  const uint4 bv = __ldg(reinterpret_cast<const uint4*>(b1 + c0));
  const __nv_bfloat162* w0p = reinterpret_cast<const __nv_bfloat162*>(&w[0]);
  const __nv_bfloat162* w1p = reinterpret_cast<const __nv_bfloat162*>(&w[1]);
  const __nv_bfloat162* w2p = reinterpret_cast<const __nv_bfloat162*>(&w[2]);
  const __nv_bfloat162* bp = reinterpret_cast<const __nv_bfloat162*>(&bv);
  uint32_t packed[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a0 = __bfloat1622float2(w0p[i]), a1 = __bfloat1622float2(w1p[i]);
    const float2 a2 = __bfloat1622float2(w2p[i]), bb = __bfloat1622float2(bp[i]);
    packed[i] = bf16x2(t1_value(d, a0.x, a1.x, a2.x, bb.x), t1_value(d, a0.y, a1.y, a2.y, bb.y));
  }
  return make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

// byte offset of (row r, byte b of the row) in [rows][128 bytes] boxes in the
// 128-byte swizzle, which TMA reads and writes (the 16-byte chunk b / 16 is
// XORed with r % 8)
__device__ __forceinline__ int swz(int r, int b) {
  return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

// map_c: Wv (the projection pass), v + pos, float32 (the softmax pass) or
// where the h pass stores h
template <int NS, int EPI>
__global__ void __launch_bounds__(CORE_THREADS, CoreCfg<NS, EPI>::BLOCKS_PER_SM)
    core_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b0,
                     const __grid_constant__ CUtensorMap map_c, const CoreArgs args, int k_in,
                     RowMap rm) {
  using namespace hop;
  using C = CoreCfg<NS, EPI>;
  constexpr int CNST = C::NST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s_ring = smem_u32(base);
  const uint32_t bar_full = s_ring + CNST * C::STAGE, bar_empty = bar_full + 8 * CNST;
  const uint32_t bar_vp = bar_empty + 8 * CNST;
  float* G = reinterpret_cast<float*>(base + CNST * C::STAGE + C::BAR_BYTES);
  float* VPs = G + C::G_BYTES / 4;

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int wg = warp / 4, g = lane / 4, c = lane % 4;
  const int n0 = blockIdx.x * NS;  // the column tile varies fastest: a row tile's A is
                                   // read by its column blocks together, from L2
  // the rows of tile `tt` of this block: one tile, or a query's T tiles in the softmax pass
  const int T = EPI == EPI_SOFTMAX ? rm.T : 1;
  const int groups = rm.K <= CR ? rm.tiles : rm.M;  // softmax pass: blocks a sample
  const int gb = EPI == EPI_SOFTMAX ? (int)(blockIdx.y / groups) : 0;
  const int grp = EPI == EPI_SOFTMAX ? (int)(blockIdx.y % groups) : 0;
  auto row0_of = [&](int tt) -> long long {
    if (EPI != EPI_SOFTMAX) return (long long)blockIdx.y * CR;
    return ((long long)gb * rm.tiles + (long long)grp * T + tt) * CR;
  };
  // K1's projection: columns [0, D) are Wk's, [D, 2D) Wv's
  const CUtensorMap* map_b = (EPI == EPI_KV && n0 >= args.D) ? &map_c : &map_b0;
  const int nb0 = (EPI == EPI_KV && n0 >= args.D) ? n0 - args.D : n0;
  const int nk = k_in / CK, total = T * nk;

  if (t == 0) {
    for (int s = 0; s < CNST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CORE_THREADS / 32);
    }
    mbar_init(bar_vp, 1);
    mbar_init_fence();
  }
  __syncthreads();
  // the softmax pass: tile tt's v + pos rows [128][NS] into VPs, read after its products
  auto load_vp = [&](int tt) {
    mbar_arrive_expect_tx(bar_vp, C::VP_BYTES);
    tma_load_2d(smem_u32(VPs), &map_c, bar_vp, n0, (int)row0_of(tt));
  };
  if (EPI == EPI_SOFTMAX && t == 0) load_vp(0);

  // the pos pass makes its own A, t1 = relu(delta W1 + b1): thread t' of a
  // warpgroup writes 4 of the 8 16-byte chunks of row 64 wg + t' / 2 of each
  // stage, in the 128-byte swizzle TMA would have used; the weights alone come by TMA
  constexpr bool GEN_A = EPI == EPI_POS;
  const int gen_row = 64 * wg + (t % 128) / 2, gen_c0 = 4 * (t % 2);
  float gen_d[3] = {0.0f, 0.0f, 0.0f};
  if (GEN_A)
    row_delta<__nv_bfloat16>(rm, row0_of(0) + gen_row, args.mode, args.N, args.qxyz, args.cxyz,
                             args.idx, args.delta, gen_d);

  auto fill = [&](int it) {
    const int s = it % CNST, tt = it / nk, kc = it % nk;
    const uint32_t sa = s_ring + s * C::STAGE, sb = sa + C::A_BYTES, bar = bar_full + 8 * s;
    mbar_arrive_expect_tx(bar, GEN_A ? C::B_BYTES : C::STAGE);
    if (!GEN_A) tma_load_2d(sa, &map_a, bar, kc * CK, (int)row0_of(tt));
#pragma unroll
    for (int j = 0; j < C::NB; ++j) tma_load_2d(sb + j * 8192, map_b, bar, nb0 + 64 * j, kc * CK);
  };
  auto release = [&](int it) {
    const int s = it % CNST;
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    if (t == 0 && it + CNST < total) {
      mbar_wait(bar_empty + 8 * s, (it / CNST) & 1);
      fill(it + CNST);
    }
  };
  if (t == 0)
    for (int it = 0; it < CNST && it < total; ++it) fill(it);

  float acc[C::NB][32];
  // running per-column softmax state across a query's tiles (K > 128)
  float run_mx = -INFINITY, run_s = 0.0f, run_o = 0.0f;
  for (int tt = 0; tt < T; ++tt) {
    for (int kc = 0; kc < nk; ++kc) {
      const int it = tt * nk + kc, s = it % CNST;
      const uint32_t sa = s_ring + s * C::STAGE + wg * 64 * 128, sb = s_ring + s * C::STAGE + C::A_BYTES;
      if (GEN_A) {
        // the stage's last reader, chunk it - CNST, is done (wait_group 1 below)
        unsigned char* arow = base + s * C::STAGE + gen_row * 128;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int chunk = gen_c0 + cc;
          *reinterpret_cast<uint4*>(arow + ((chunk ^ (gen_row & 7)) << 4)) =
              t1_chunk(gen_d, args.w1, args.b1, args.D, kc * CK + 8 * chunk);
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
      }
      mbar_wait(bar_full + 8 * s, (it / CNST) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CK / 16; ++kk) {
        const uint64_t da = mma_desc(sa + kk * 32, 16, 1024, 1);
#pragma unroll
        for (int j = 0; j < C::NB; ++j)
          wgmma_ss_mn(acc[j], da, mma_desc(sb + j * 8192 + kk * 2048, 8192, 1024, 1),
                      (kc | kk) != 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products are done: give its stage back
      if (kc > 0) release(it - 1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < C::NB; ++j) pin(acc[j]);
    release(tt * nk + nk - 1);

    // ---- epilogue: this thread's rows rl and rl + 8 of the tile, columns
    // n0 + 64 j + 8 jj + 2 c (+1) ----
    const long long row0 = row0_of(tt);
    const int rl = 64 * wg + 16 * (warp % 4) + g;
    if (EPI == EPI_KV) {
      float* kv = args.kv;
      const int D2 = 2 * args.D;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + rl + 8 * h;
        if (row >= args.n_rows) continue;
#pragma unroll
        for (int j = 0; j < C::NB; ++j)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            *reinterpret_cast<float2*>(kv + row * D2 + n0 + 64 * j + 8 * jj + 2 * c) =
                make_float2(acc[j][4 * jj + 2 * h], acc[j][4 * jj + 2 * h + 1]);
      }
    } else if (EPI == EPI_RELU) {
      // h through shared memory (two [128][64] bf16 boxes over the spent ring),
      // then two bulk tensor stores
      __syncthreads();  // both warpgroups' products are done: the ring is free
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rl + 8 * h;
#pragma unroll
        for (int j = 0; j < C::NB; ++j)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int cl = 64 * j + 8 * jj + 2 * c;
            const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(args.bias + n0 + cl);
            *reinterpret_cast<uint32_t*>(base + j * 16384 + swz(r, (cl & 63) * 2)) =
                bf16x2(fmaxf(acc[j][4 * jj + 2 * h] + __low2float(bb), 0.0f),
                       fmaxf(acc[j][4 * jj + 2 * h + 1] + __high2float(bb), 0.0f));
          }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (t == 0) {
#pragma unroll
        for (int j = 0; j < C::NB; ++j) tma_store_2d(&map_c, s_ring + j * 16384, n0 + 64 * j, (int)row0);
        bulk_commit();
        bulk_wait_read();
      }
    } else if (EPI == EPI_POS) {
      // k / v gathered row by row; x and v + pos stored straight from the
      // registers (staging them for bulk stores measured slower: the gathers
      // bound this pass)
      const int D = args.D;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + rl + 8 * h;
        int b, m, jn;
        rm.at(row, b, m, jn);
        const __nv_bfloat16* qr = args.q + ((size_t)b * args.M + m) * D;
        const float* kf = nullptr;
        const __nv_bfloat16 *kr = nullptr, *vr = nullptr;
        if (args.mode == VA_KNN) {
          const int src = args.idx[((size_t)b * args.M + m) * args.K + jn];
          kf = args.kvf + ((size_t)b * args.N + src) * 2 * D;
        } else {
          const size_t src = args.mode == VA_ANCHOR ? (size_t)b * args.N + jn
                                                    : ((size_t)b * args.M + m) * args.K + jn;
          kr = args.kb + src * D;
          vr = args.vb + src * D;
        }
#pragma unroll
        for (int j = 0; j < C::NB; ++j)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int col = n0 + 64 * j + 8 * jj + 2 * c;
            const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(args.bias + col);
            const __nv_bfloat162 qq = *reinterpret_cast<const __nv_bfloat162*>(qr + col);
            float2 kk2, vv2;
            if (kf != nullptr) {
              kk2 = *reinterpret_cast<const float2*>(kf + col);
              vv2 = *reinterpret_cast<const float2*>(kf + D + col);
            } else {
              const __nv_bfloat162 k2 = *reinterpret_cast<const __nv_bfloat162*>(kr + col);
              const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(vr + col);
              kk2 = make_float2(__low2float(k2), __high2float(k2));
              vv2 = make_float2(__low2float(v2), __high2float(v2));
            }
            const float p0 = acc[j][4 * jj + 2 * h] + __low2float(bb);
            const float p1 = acc[j][4 * jj + 2 * h + 1] + __high2float(bb);
            *reinterpret_cast<uint32_t*>(args.x + row * D + col) =
                bf16x2(__low2float(qq) - kk2.x + p0, __high2float(qq) - kk2.y + p1);
            *reinterpret_cast<float2*>(args.vp + row * D + col) =
                make_float2(vv2.x + p0, vv2.y + p1);
          }
      }
    } else {  // EPI_SOFTMAX
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < C::NB; ++j)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int cl = 64 * j + 8 * jj + 2 * c;
            const __nv_bfloat162 bb =
                *reinterpret_cast<const __nv_bfloat162*>(args.bias + n0 + cl);
            *reinterpret_cast<float2*>(G + (rl + 8 * h) * C::GS + cl) =
                make_float2((acc[j][4 * jj + 2 * h] + __low2float(bb)) * args.scale,
                            (acc[j][4 * jj + 2 * h + 1] + __high2float(bb)) * args.scale);
          }
      __syncthreads();
      // one column a thread (two threads a column at NS = 128, each its own queries)
      const int col = t % NS, slot = t / NS, slots = CORE_THREADS / NS;
      const int D = args.D;
      const float* vp = VPs + col;
      mbar_wait(bar_vp, tt & 1);
      if (rm.K <= CR) {
        for (int qi = slot; qi < rm.QB; qi += slots) {
          const int m = grp * rm.QB + qi;
          if (m >= rm.M) break;
          const int i0 = qi * rm.K;
          float mx = -INFINITY;
          for (int i = 0; i < rm.K; ++i) mx = fmaxf(mx, G[(i0 + i) * C::GS + col]);
          float s = 0.0f, o = 0.0f;
#pragma unroll 4
          for (int i = 0; i < rm.K; ++i) {
            const float e = expf(G[(i0 + i) * C::GS + col] - mx);
            s += e;
            o = fmaf(e, vp[(i0 + i) * NS], o);
          }
          args.out[((size_t)gb * rm.M + m) * D + n0 + col] = __float2bfloat16_rn(o / s);
        }
      } else if (slot == 0) {
        const int n = min(CR, rm.K - tt * CR);
        float cm = run_mx;
        for (int i = 0; i < n; ++i) cm = fmaxf(cm, G[i * C::GS + col]);
        const float rescale = expf(run_mx - cm);
        run_s *= rescale;
        run_o *= rescale;
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
          const float e = expf(G[i * C::GS + col] - cm);
          run_s += e;
          run_o = fmaf(e, vp[i * NS], run_o);
        }
        run_mx = cm;
        if (tt == T - 1)
          args.out[((size_t)gb * rm.M + grp) * D + n0 + col] = __float2bfloat16_rn(run_o / run_s);
      }
      __syncthreads();  // G and VPs are written again by the next tile
      if (t == 0 && tt + 1 < T) load_vp(tt + 1);
    }
  }
}

template <int NS, int EPI>
cudaError_t launch_core_gemm(const CUtensorMap& ma, const CUtensorMap& mb0, const CUtensorMap& mc,
                             const CoreArgs& args, int k_in, const RowMap& rm, unsigned blocks,
                             int n_out, cudaStream_t stream) {
  auto kernel = core_gemm_kernel<NS, EPI>;
  const size_t smem = CoreCfg<NS, EPI>::SMEM;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (blocks > 65535u) return cudaErrorInvalidValue;  // grid.y
  kernel<<<dim3(n_out / NS, blocks), CORE_THREADS, smem, stream>>>(ma, mb0, mc, args, k_in, rm);
  return cudaGetLastError();
}

// The chain for one call (see above). kv (B, N, 2D) float32 (K1 only), ta and
// tb (rows, D) bf16, vp (rows, D) float32 are scratch, rows = B * tiles * 128.
cudaError_t launch_core_bf16(int mode, const void* q, const void* qxyz, const void* cxyz,
                             const void* idx, const void* xk, const void* va, const void* delta,
                             const void* wk, const void* wv, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* g0, const void* c0,
                             const void* g1, const void* c1, void* out, void* kv, void* ta,
                             void* tb, void* vp, int B, int M, int N, int D, int K, float scale,
                             cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const RowMap rm(M, K);
  const long long rows = (long long)B * rm.tiles * CR;
  CoreArgs args{(const bf*)q, (const float*)kv, (const bf*)xk, (const bf*)va, (const int*)idx,
                nullptr, (const float*)qxyz, (const float*)cxyz, (const bf*)delta, (const bf*)w1,
                (const bf*)b1, (float*)kv, (bf*)tb, (float*)vp, (bf*)out, mode, B, M, N, D, K, 0,
                scale};
  CUtensorMap ma, mb0, mc;
  cudaError_t err;
#define CORE_GEMM(EPI, BLOCKS, NOUT) \
  launch_core_gemm<CNS, EPI>(ma, mb0, mc, args, D, rm, BLOCKS, NOUT, stream)
  if (mode == VA_KNN) {  // kv = x_full [Wk | Wv], every cloud point once
    if (!make_map_2d(&ma, xk, B * N, D, CR) || !make_map_2d(&mb0, wk, D, D, CK) ||
        !make_map_2d(&mc, wv, D, D, CK))
      return cudaErrorInvalidValue;
    args.n_rows = B * N;
    if ((err = CORE_GEMM(EPI_KV, (unsigned)((B * N + CR - 1) / CR), 2 * D)) != cudaSuccess)
      return err;
  }
  const unsigned row_blocks = (unsigned)(rows / CR);
  // x and v + pos from t1 (made in the kernel) -> x in tb
  if (!make_map_2d(&mb0, w2, D, D, CK)) return cudaErrorInvalidValue;
  args.bias = (const bf*)b2;
  if ((err = CORE_GEMM(EPI_POS, row_blocks, D)) != cudaSuccess) return err;
  // h from x (tb) -> ta
  if (!make_map_2d(&ma, tb, (int)rows, D, CR) || !make_map_2d(&mb0, g0, D, D, CK) ||
      !make_map_2d(&mc, ta, (int)rows, D, CR))
    return cudaErrorInvalidValue;
  args.bias = (const bf*)c0;
  if ((err = CORE_GEMM(EPI_RELU, row_blocks, D)) != cudaSuccess) return err;
  // g from h (ta), the softmax and the aggregate -> out
  if (!make_map_2d(&ma, ta, (int)rows, D, CR) || !make_map_2d(&mb0, g1, D, D, CK) ||
      !make_map_2d_f32(&mc, vp, (int)rows, D, 128, CR))
    return cudaErrorInvalidValue;
  args.bias = (const bf*)c1;
  const unsigned groups = (unsigned)B * (K <= CR ? rm.tiles : M);
  return CORE_GEMM(EPI_SOFTMAX, groups, D);
#undef CORE_GEMM
}

template <typename Key, bool STAGED>
cudaError_t launch_knn_select(const float* qxyz, const float* ptxyz, int* idx, int B, int M, int N,
                              int K, cudaStream_t s) {
  const size_t smem = STAGED ? (size_t)N * sizeof(float4) : 0;
  const int qpb = rows_per_block(B, M, smem);
  cudaError_t err = allow_smem(knn_select_kernel<Key, STAGED>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + qpb - 1) / qpb, B);
  knn_select_kernel<Key, STAGED><<<grid, qpb * SC_LANES, smem, s>>>(qxyz, ptxyz, idx, M, N, K,
                                                                    qpb);
  return cudaGetLastError();
}

}  // namespace poem

using namespace poem;

// Select the K nearest cloud points of every query; idx is (B, M, K) int32
// in ascending (distance, index) order, K <= N. packed != 0 uses the 12-bit
// packed keys (N <= 4096 required), packed == 0 exact (d2, index) keys.
extern "C" int poem_knn_select(const void* qxyz, const void* ptxyz, void* idx, int B, int M,
                               int N, int K, int packed, void* stream) {
  if (B < 1 || M < 1 || K < 1 || K > N || (packed && N > PACK_MAX))
    return (int)cudaErrorInvalidValue;
  const float *q = (const float*)qxyz, *p = (const float*)ptxyz;
  int* out = (int*)idx;
  cudaStream_t s = (cudaStream_t)stream;
  if (packed) return (int)launch_knn_select<uint32_t, true>(q, p, out, B, M, N, K, s);
  if (N <= SC_STAGE_MAX) return (int)launch_knn_select<key64_t, true>(q, p, out, B, M, N, K, s);
  return (int)launch_knn_select<key64_t, false>(q, p, out, B, M, N, K, s);
}

static bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// The attention in its three modes:
// mode 0 (K1): idx (B, M, K) selects rows of x_full (xk, (B, N, D)), projected by wk / wv;
// mode 1 (K2): xk / va are the (B, N, D) pre-projected anchors, cxyz their (B, N, 3) coords;
// mode 2 (K8): xk / va are (B, M, K, D) gathered keys / values, delta (B, M, K, 3).
// float32: the FMA kernel, D % 4 == 0 up to 1024, scratch unused. bfloat16:
// the tensor-core chain, D % 128 == 0, 16-byte aligned tensors, scratch kv,
// ta, tb, vp as launch_core_bf16 says; scale multiplies g (1 / sqrt of the
// unpadded width). Any K >= 1.
extern "C" int poem_vector_attention(int dtype, int mode, const void* q, const void* qxyz,
                                     const void* cxyz, const void* idx, const void* xk,
                                     const void* va, const void* delta, const void* wk,
                                     const void* wv, const void* w1, const void* b1,
                                     const void* w2, const void* b2, const void* g0,
                                     const void* c0, const void* g1, const void* c1, void* out,
                                     void* kv, void* ta, void* tb, void* vp, int B, int M, int N,
                                     int D, int K, float scale, void* stream) {
  if (K < 1 || M < 1 || B < 1 || mode < VA_KNN || mode > VA_GATHERED)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16) {
    if (D < 128 || D % 128 != 0 ||
        !aligned16({q, xk, va, wk, wv, w1, b1, w2, b2, g0, c0, g1, c1, out, kv, ta, tb, vp}))
      return (int)cudaErrorInvalidValue;
    return (int)launch_core_bf16(mode, q, qxyz, cxyz, idx, xk, va, delta, wk, wv, w1, b1, w2, b2,
                                 g0, c0, g1, c1, out, kv, ta, tb, vp, B, M, N, D, K, scale, s);
  }
  if (dtype != DTYPE_F32 || D < 4 || D % 4 != 0 || D > 1024) return (int)cudaErrorInvalidValue;
#define POEM_VA_WIDE(MODE, WIDE, CHUNKED)                                                     \
  launch_vector_attn<MODE, WIDE, CHUNKED>(q, qxyz, cxyz, idx, xk, va, delta, wk, wv, w1, b1,  \
                                          w2, b2, g0, c0, g1, c1, out, B, M, N, D, K, s)
#define POEM_VA_ROWS(MODE, WIDE)                                           \
  (K > VaBlock<WIDE>::ROWS ? POEM_VA_WIDE(MODE, WIDE, true) : POEM_VA_WIDE(MODE, WIDE, false))
#define POEM_VA(MODE) (D <= VA_THREADS ? POEM_VA_ROWS(MODE, false) : POEM_VA_ROWS(MODE, true))
  const cudaError_t err = mode == VA_KNN      ? POEM_VA(VA_KNN)
                          : mode == VA_ANCHOR ? POEM_VA(VA_ANCHOR)
                                              : POEM_VA(VA_GATHERED);
#undef POEM_VA
#undef POEM_VA_ROWS
#undef POEM_VA_WIDE
  return (int)err;
}
