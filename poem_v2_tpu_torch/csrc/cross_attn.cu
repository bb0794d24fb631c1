// Dense multi-head cross-attention, forward and backward.
//
// Replaces the Pallas TPU kernels
//   poem_v2_tpu/ops/pallas_cross_attn.py:dense_cross_attention (K3, forward)
//   poem_v2_tpu/ops/pallas_cross_attn.py:_dense_bwd / _bwd_kernel (K3b, backward)
// which compute, per head h, softmax(q_h k_h^T * scale) v_h with no mask,
// and its gradients dQ, dK, dV.
//
// What bounds it on the H100: at the decoder's shape (799 queries, 4096
// keys, 4 heads of 64) it is 4 * M * N * hd multiply-adds per batch
// element against only (M + 2N) * H elements of input, so it is
// arithmetic-bound; the (M, N) logits must never reach device memory.
//
// Design (flash-style, simple first): one block of 256 threads per
// (query tile of 16, head, batch element). It loops over key tiles of 64,
// staging K and V in shared memory as float32, computes the 16 x 64 score
// tile, folds it into an online softmax kept in float32 (each row's max and
// sum are shared by the 16 threads that own the row), accumulates P V in
// registers and divides by the row sum at the end. P stays float32 (the TPU
// kernel rounds the unnormalised P to bf16 before P V; the port does not).
// That FMA kernel serves float32 at head dims from 32 to 256 in steps of
// 16. bfloat16 runs `dense_attn_tc_kernel` below on the tensor cores
// (WMMA; wgmma and TMA are later work), at head dims 32, 64, 128 and 256
// on 16-byte aligned tensors; the wrapper rejects anything else.
#include <mma.h>

#include <initializer_list>

#include "common.cuh"

namespace poem {

constexpr int CA_BQ = 16;
constexpr int CA_BK = 64;
constexpr int CA_THREADS = 256;
constexpr int CA_MAX_HD = 256;

__global__ void __launch_bounds__(CA_THREADS)
    dense_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out, int M, int N, int H,
                      int hd, float scale) {
  extern __shared__ float smem[];
  const int ks = hd + 1;                  // padded K row: conflict-free column reads
  float* Qs = smem;                       // [BQ][hd]
  float* Ks = Qs + CA_BQ * hd;            // [BK][hd + 1]
  float* Vs = Ks + CA_BK * ks;            // [BK][hd]
  float* Ps = Vs + CA_BK * hd;            // [BQ][BK]

  const int t = threadIdx.x;
  const int row = t / 16, lane16 = t % 16;
  const int m0 = blockIdx.x * CA_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hoff = h * hd;
  const int n_out = hd / 16;              // output columns per thread

  for (int e = t; e < CA_BQ * hd; e += CA_THREADS) {
    const int r = e / hd, c = e % hd;
    const int m = min(m0 + r, M - 1);
    Qs[e] = q[((size_t)b * M + m) * H + hoff + c];
  }

  float o[CA_MAX_HD / 16];
#pragma unroll
  for (int i = 0; i < CA_MAX_HD / 16; ++i) o[i] = 0.0f;
  float m_run = -INFINITY, l_run = 0.0f;

  for (int n0 = 0; n0 < N; n0 += CA_BK) {
    __syncthreads();  // previous tile's K/V/P fully consumed
    for (int e = t; e < CA_BK * hd; e += CA_THREADS) {
      const int r = e / hd, c = e % hd;
      const int n = min(n0 + r, N - 1);
      const size_t g = ((size_t)b * N + n) * H + hoff + c;
      Ks[r * ks + c] = k[g];
      Vs[r * hd + c] = v[g];
    }
    __syncthreads();

    // scores for (row, lane16 + 16 i), i < 4
    float s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = 0.0f;
    for (int c = 0; c < hd; ++c) {
      const float qv = Qs[row * hd + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = fmaf(qv, Ks[(lane16 + 16 * i) * ks + c], s[i]);
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = (n0 + lane16 + 16 * i < N) ? s[i] * scale : -INFINITY;
      tmax = fmaxf(tmax, s[i]);
    }
    for (int off = 8; off > 0; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xFFFFFFFFu, tmax, off));
    const float m_new = fmaxf(m_run, tmax);
    const float corr = expf(m_run - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = expf(s[i] - m_new);
      psum += p;
      Ps[row * CA_BK + lane16 + 16 * i] = p;
    }
    for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xFFFFFFFFu, psum, off);
    l_run = l_run * corr + psum;
    m_run = m_new;
    __syncwarp();  // the row's P values come from the 16 lanes of this half-warp

#pragma unroll
    for (int i = 0; i < CA_MAX_HD / 16; ++i) {
      if (i < n_out) o[i] *= corr;
    }
    const int kmax = min(CA_BK, N - n0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float p = Ps[row * CA_BK + kk];
#pragma unroll
      for (int i = 0; i < CA_MAX_HD / 16; ++i) {
        if (i < n_out) o[i] = fmaf(p, Vs[kk * hd + lane16 + 16 * i], o[i]);
      }
    }
  }

  const int m = m0 + row;
  if (m < M) {
    const float inv = 1.0f / l_run;
#pragma unroll
    for (int i = 0; i < CA_MAX_HD / 16; ++i) {
      if (i < n_out) out[((size_t)b * M + m) * H + hoff + lane16 + 16 * i] = o[i] * inv;
    }
  }
}

cudaError_t launch_dense_attn(const void* q, const void* k, const void* v, void* out, int B,
                              int M, int N, int H, int nh, float scale, cudaStream_t stream) {
  const int hd = H / nh;
  auto kernel = dense_attn_kernel;
  const size_t smem =
      sizeof(float) * ((size_t)CA_BQ * hd + CA_BK * (hd + 1) + CA_BK * hd + CA_BQ * CA_BK);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + CA_BQ - 1) / CA_BQ, nh, B);
  kernel<<<grid, CA_THREADS, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                             (float*)out, M, N, H, hd, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward (K3b).
//
// The TPU kernel keeps a whole (M, N) float32 P per head in VMEM (13 MB at
// 799 x 4096), far beyond the 227 KB of shared memory a block has. So the
// backward is flash-style recompute in two passes that never store P:
//
// * `dense_attn_bwd_dq_kernel` owns 16 query rows of one head. Sweep 1 over
//   the key tiles recomputes the row's logsumexp and
//   D = rowsum(P * dP) = sum_j p_j (dO . v_j) with an online rescale;
//   sweep 2 recomputes P = exp(s - lse), dS = P * (dP - D) * scale and
//   accumulates dQ = dS K. It writes lse and D for the second pass.
// * `dense_attn_bwd_dkv_kernel` owns 16 keys of one head and loops over
//   query tiles: dV = P^T dO and dK = dS^T Q accumulate in registers, so
//   no two blocks write one output and no atomics are needed.
//
// It is arithmetic-bound like the forward (about 4 products of hd per
// (query, key) pair against the forward's 2). Everything stays float32,
// including P and dS, where the TPU kernel rounds them to the input dtype
// before its matrix products. Padded keys (N not a multiple of the tile)
// get p = 0, as the TPU kernel masks keys past n_valid. These FMA kernels
// take float32; bfloat16 runs the tensor-core kernels further down.
constexpr int CB_BQ = 16;    // dq pass: query rows per block
constexpr int CB_BK = 64;    // dq pass: keys per tile
constexpr int CB_BKV = 16;   // dkv pass: keys per block
constexpr int CB_BQT = 64;   // dkv pass: query rows per tile

__device__ __forceinline__ void load_rows(float* dst, int stride, const float* __restrict__ src,
                                          int r0, int rows, int n_valid, int H, int hoff,
                                          int hd) {
  for (int e = threadIdx.x; e < rows * hd; e += CA_THREADS) {
    const int r = e / hd, c = e % hd;
    const int n = min(r0 + r, n_valid - 1);
    dst[r * stride + c] = src[(size_t)n * H + hoff + c];
  }
}

__global__ void __launch_bounds__(CA_THREADS)
    dense_attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             float* __restrict__ dq, float* __restrict__ lse_out,
                             float* __restrict__ delta_out, int M, int N, int H, int hd,
                             float scale) {
  extern __shared__ float smem[];
  const int ks = hd + 1;
  float* Qs = smem;                  // [BQ][hd]
  float* Os = Qs + CB_BQ * hd;       // [BQ][hd] dO
  float* Ks = Os + CB_BQ * hd;       // [BK][hd + 1]
  float* Vs = Ks + CB_BK * ks;       // [BK][hd + 1]
  float* Ss = Vs + CB_BK * ks;       // [BQ][BK] dS

  const int t = threadIdx.x;
  const int row = t / 16, lane16 = t % 16;
  const int m0 = blockIdx.x * CB_BQ;
  const int h = blockIdx.y, b = blockIdx.z, nh = gridDim.y;
  const int hoff = h * hd;
  const int n_out = hd / 16;
  const float* kb = k + (size_t)b * N * H;
  const float* vb = v + (size_t)b * N * H;

  load_rows(Qs, hd, q + (size_t)b * M * H, m0, CB_BQ, M, H, hoff, hd);
  load_rows(Os, hd, dout + (size_t)b * M * H, m0, CB_BQ, M, H, hoff, hd);

  // s = q . k_j * scale and dp = dO . v_j for keys lane16 + 16 i of the tile
  auto scores = [&](int n0, float (&s)[4], float (&dp)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = dp[i] = 0.0f;
    for (int c = 0; c < hd; ++c) {
      const float qv = Qs[row * hd + c], ov = Os[row * hd + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i] = fmaf(qv, Ks[(lane16 + 16 * i) * ks + c], s[i]);
        dp[i] = fmaf(ov, Vs[(lane16 + 16 * i) * ks + c], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = (n0 + lane16 + 16 * i < N) ? s[i] * scale : -INFINITY;
  };

  // sweep 1: logsumexp and D = sum_j p_j dp_j of each row
  float m_run = -INFINITY, l_run = 0.0f, d_run = 0.0f;
  for (int n0 = 0; n0 < N; n0 += CB_BK) {
    __syncthreads();
    load_rows(Ks, ks, kb, n0, CB_BK, N, H, hoff, hd);
    load_rows(Vs, ks, vb, n0, CB_BK, N, H, hoff, hd);
    __syncthreads();
    float s[4], dp[4];
    scores(n0, s, dp);
    float tmax = fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3]));
    for (int off = 8; off > 0; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xFFFFFFFFu, tmax, off));
    const float m_new = fmaxf(m_run, tmax);
    const float corr = expf(m_run - m_new);
    float psum = 0.0f, pd = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = expf(s[i] - m_new);
      psum += p;
      pd = fmaf(p, dp[i], pd);
    }
    for (int off = 8; off > 0; off >>= 1) {
      psum += __shfl_xor_sync(0xFFFFFFFFu, psum, off);
      pd += __shfl_xor_sync(0xFFFFFFFFu, pd, off);
    }
    l_run = l_run * corr + psum;
    d_run = d_run * corr + pd;
    m_run = m_new;
  }
  const float lse = m_run + logf(l_run);
  const float delta = d_run / l_run;
  const int m = m0 + row;
  if (lane16 == 0 && m < M) {
    lse_out[((size_t)b * nh + h) * M + m] = lse;
    delta_out[((size_t)b * nh + h) * M + m] = delta;
  }

  // sweep 2: dQ = sum_j dS_j k_j
  float acc[CA_MAX_HD / 16];
#pragma unroll
  for (int i = 0; i < CA_MAX_HD / 16; ++i) acc[i] = 0.0f;
  for (int n0 = 0; n0 < N; n0 += CB_BK) {
    __syncthreads();  // previous tile's K and dS fully consumed
    load_rows(Ks, ks, kb, n0, CB_BK, N, H, hoff, hd);
    load_rows(Vs, ks, vb, n0, CB_BK, N, H, hoff, hd);
    __syncthreads();
    float s[4], dp[4];
    scores(n0, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = expf(s[i] - lse);  // 0 for padded keys (s = -inf)
      Ss[row * CB_BK + lane16 + 16 * i] = p * (dp[i] - delta) * scale;
    }
    __syncwarp();  // the row's dS values come from the 16 lanes of this half-warp
    const int kmax = min(CB_BK, N - n0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float d = Ss[row * CB_BK + kk];
#pragma unroll
      for (int i = 0; i < CA_MAX_HD / 16; ++i) {
        if (i < n_out) acc[i] = fmaf(d, Ks[kk * ks + lane16 + 16 * i], acc[i]);
      }
    }
  }
  if (m < M) {
#pragma unroll
    for (int i = 0; i < CA_MAX_HD / 16; ++i) {
      if (i < n_out) dq[((size_t)b * M + m) * H + hoff + lane16 + 16 * i] = acc[i];
    }
  }
}

__global__ void __launch_bounds__(CA_THREADS)
    dense_attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse_in,
                              const float* __restrict__ delta_in, float* __restrict__ dk,
                              float* __restrict__ dv, int M, int N, int H, int hd, float scale) {
  extern __shared__ float smem[];
  const int ks = hd + 1;
  float* Ks = smem;                  // [BKV][hd + 1]
  float* Vs = Ks + CB_BKV * ks;      // [BKV][hd + 1]
  float* Qs = Vs + CB_BKV * ks;      // [BQT][hd + 1]
  float* Os = Qs + CB_BQT * ks;      // [BQT][hd + 1] dO
  float* Ls = Os + CB_BQT * ks;      // [BQT] lse
  float* Dl = Ls + CB_BQT;           // [BQT] D
  float* Ps = Dl + CB_BQT;           // [BKV][BQT] P
  float* Ss = Ps + CB_BKV * CB_BQT;  // [BKV][BQT] dS

  const int t = threadIdx.x;
  const int krow = t / 16, lane16 = t % 16;
  const int n0 = blockIdx.x * CB_BKV;
  const int h = blockIdx.y, b = blockIdx.z, nh = gridDim.y;
  const int hoff = h * hd;
  const int n_out = hd / 16;
  const float* qb = q + (size_t)b * M * H;
  const float* ob = dout + (size_t)b * M * H;
  const float* lb = lse_in + ((size_t)b * nh + h) * M;
  const float* db = delta_in + ((size_t)b * nh + h) * M;

  load_rows(Ks, ks, k + (size_t)b * N * H, n0, CB_BKV, N, H, hoff, hd);
  load_rows(Vs, ks, v + (size_t)b * N * H, n0, CB_BKV, N, H, hoff, hd);

  float dk_acc[CA_MAX_HD / 16], dv_acc[CA_MAX_HD / 16];
#pragma unroll
  for (int i = 0; i < CA_MAX_HD / 16; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  for (int m0 = 0; m0 < M; m0 += CB_BQT) {
    __syncthreads();  // previous tile's Q, dO, P and dS fully consumed
    load_rows(Qs, ks, qb, m0, CB_BQT, M, H, hoff, hd);
    load_rows(Os, ks, ob, m0, CB_BQT, M, H, hoff, hd);
    if (t < CB_BQT) {
      const int m = min(m0 + t, M - 1);
      Ls[t] = lb[m];
      Dl[t] = db[m];
    }
    __syncthreads();
    float s[4], dp[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = dp[i] = 0.0f;
    for (int c = 0; c < hd; ++c) {
      const float kv = Ks[krow * ks + c], vv = Vs[krow * ks + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i] = fmaf(kv, Qs[(lane16 + 16 * i) * ks + c], s[i]);
        dp[i] = fmaf(vv, Os[(lane16 + 16 * i) * ks + c], dp[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = lane16 + 16 * i;
      const float p = (m0 + r < M) ? expf(s[i] * scale - Ls[r]) : 0.0f;
      Ps[krow * CB_BQT + r] = p;
      Ss[krow * CB_BQT + r] = p * (dp[i] - Dl[r]) * scale;
    }
    __syncwarp();  // the key's P and dS values come from the 16 lanes of this half-warp
    const int rmax = min(CB_BQT, M - m0);
    for (int r = 0; r < rmax; ++r) {
      const float p = Ps[krow * CB_BQT + r], d = Ss[krow * CB_BQT + r];
#pragma unroll
      for (int i = 0; i < CA_MAX_HD / 16; ++i) {
        if (i < n_out) {
          dv_acc[i] = fmaf(p, Os[r * ks + lane16 + 16 * i], dv_acc[i]);
          dk_acc[i] = fmaf(d, Qs[r * ks + lane16 + 16 * i], dk_acc[i]);
        }
      }
    }
  }
  const int n = n0 + krow;
  if (n < N) {
#pragma unroll
    for (int i = 0; i < CA_MAX_HD / 16; ++i) {
      if (i < n_out) {
        const size_t g = ((size_t)b * N + n) * H + hoff + lane16 + 16 * i;
        dk[g] = dk_acc[i];
        dv[g] = dv_acc[i];
      }
    }
  }
}

cudaError_t launch_dense_attn_bwd(const void* q, const void* k, const void* v, const void* dout,
                                  void* dq, void* dk, void* dv, void* lse, void* delta, int B,
                                  int M, int N, int H, int nh, float scale, cudaStream_t stream) {
  const int hd = H / nh;
  const int ks = hd + 1;
  auto dq_kernel = dense_attn_bwd_dq_kernel;
  const size_t smem_dq =
      sizeof(float) * ((size_t)2 * CB_BQ * hd + 2 * CB_BK * ks + CB_BQ * CB_BK);
  cudaError_t err = allow_smem(dq_kernel, smem_dq);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3((M + CB_BQ - 1) / CB_BQ, nh, B), CA_THREADS, smem_dq, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (float*)dq,
      (float*)lse, (float*)delta, M, N, H, hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dkv_kernel = dense_attn_bwd_dkv_kernel;
  const size_t smem_dkv = sizeof(float) * ((size_t)2 * CB_BKV * ks + 2 * CB_BQT * ks +
                                           2 * CB_BQT + 2 * CB_BKV * CB_BQT);
  err = allow_smem(dkv_kernel, smem_dkv);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<dim3((N + CB_BKV - 1) / CB_BKV, nh, B), CA_THREADS, smem_dkv, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (float*)dk, (float*)dv, M, N, H, hd, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward (K3b) on the tensor cores, for bfloat16 inputs and head dims 32,
// 64, 128 and 256: the same two passes, with every product a 16 x 16 x 16
// bfloat16 warp MMA (WMMA, float32 accumulation) over tiles in shared
// memory. A block owns 32 rows (queries in the dq pass, keys in the dkv
// pass) and streams tiles of 64 rows of the other side; S and dP land in
// shared memory as float32, eight threads per row turn them into P and dS,
// and P and dS are rounded to bfloat16 for the next products, as the TPU
// kernel rounds them to the input dtype (`_bwd_kernel`).
namespace wm = nvcuda::wmma;
constexpr int TB_R = 32;        // rows a block owns
constexpr int TB_T = 64;        // rows of a streamed tile
constexpr int TB_THREADS = 256; // 8 warps
using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, __nv_bfloat16, wm::row_major>;
using FragBc = wm::fragment<wm::matrix_b, 16, 16, 16, __nv_bfloat16, wm::col_major>;
using FragBr = wm::fragment<wm::matrix_b, 16, 16, 16, __nv_bfloat16, wm::row_major>;
using FragC = wm::fragment<wm::accumulator, 16, 16, 16, float>;

// rows [r0, r0 + rows) of one head's (HD-wide) slice of a (.., H) matrix into
// shared memory [rows][HD], 16 bytes per thread; rows past n_valid repeat the last
template <int HD>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                          int rows, int n_valid, int H, int hoff) {
  constexpr int V = HD / 8;
  for (int e = threadIdx.x; e < rows * V; e += TB_THREADS) {
    const int r = e / V, c = (e % V) * 8;
    const int n = min(r0 + r, n_valid - 1);
    *reinterpret_cast<uint4*>(dst + r * HD + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)n * H + hoff + c);
  }
}

// c = A B^T for 16 rows of A and 16 rows of B, both [.][HD] row-major tiles
template <int HD>
__device__ __forceinline__ void mma_abt(FragC& c, const __nv_bfloat16* A, const __nv_bfloat16* B) {
  wm::fill_fragment(c, 0.0f);
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    FragA a;
    FragBc b;
    wm::load_matrix_sync(a, A + kk, HD);
    wm::load_matrix_sync(b, B + kk, HD);
    wm::mma_sync(c, a, b, c);
  }
}

// c += A B for a 16 x TB_T slice of A ([.][TB_T]) and a TB_T x 16 slice of B ([.][HD])
template <int HD>
__device__ __forceinline__ void mma_ab(FragC& c, const __nv_bfloat16* A, const __nv_bfloat16* B) {
#pragma unroll
  for (int kk = 0; kk < TB_T; kk += 16) {
    FragA a;
    FragBr b;
    wm::load_matrix_sync(a, A + kk, TB_T);
    wm::load_matrix_sync(b, B + kk * HD, HD);
    wm::mma_sync(c, a, b, c);
  }
}

template <int HD>
constexpr size_t tc_dq_smem() {
  return (size_t)2 * TB_R * HD * 2 + 2 * TB_T * HD * 2 + 2 * TB_R * TB_T * 4 + TB_R * TB_T * 2;
}
template <int HD>
constexpr size_t tc_dkv_smem() {
  return (size_t)2 * TB_R * HD * 2 + 2 * TB_T * HD * 2 + 2 * TB_R * TB_T * 4 +
         2 * TB_R * TB_T * 2 + 2 * TB_T * 4;
}

template <int HD>
__global__ void __launch_bounds__(TB_THREADS)
    dense_attn_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                const __nv_bfloat16* __restrict__ dout,
                                __nv_bfloat16* __restrict__ dq, float* __restrict__ lse_out,
                                float* __restrict__ delta_out, int M, int N, int H, float scale) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [R][HD]
  __nv_bfloat16* Os = Qs + TB_R * HD;                              // [R][HD] dO
  __nv_bfloat16* Ks = Os + TB_R * HD;                              // [T][HD]
  __nv_bfloat16* Vs = Ks + TB_T * HD;                              // [T][HD]
  float* Ss = reinterpret_cast<float*>(Vs + TB_T * HD);            // [R][T] S
  float* Ps = Ss + TB_R * TB_T;                                    // [R][T] dP
  __nv_bfloat16* DS = reinterpret_cast<__nv_bfloat16*>(Ps + TB_R * TB_T);  // [R][T] dS

  const int t = threadIdx.x, warp = t / 32;
  const int m0 = blockIdx.x * TB_R;
  const int h = blockIdx.y, b = blockIdx.z, nh = gridDim.y;
  const int hoff = h * HD;
  const __nv_bfloat16* kb = k + (size_t)b * N * H;
  const __nv_bfloat16* vb = v + (size_t)b * N * H;
  copy_tile<HD>(Qs, q + (size_t)b * M * H, m0, TB_R, M, H, hoff);
  copy_tile<HD>(Os, dout + (size_t)b * M * H, m0, TB_R, M, H, hoff);
  const int fr = warp / 4, fc = warp % 4;     // this warp's 16 x 16 block of S and dP
  const int row = t / 8, c0 = (t % 8) * 8;    // this thread's 8 entries of a row

  // S = Q K^T and dP = dO V^T for the key tile at n0, into Ss and Ps
  auto scores = [&](int n0) {
    __syncthreads();  // the previous tile's K, S, dP and dS are consumed
    copy_tile<HD>(Ks, kb, n0, TB_T, N, H, hoff);
    copy_tile<HD>(Vs, vb, n0, TB_T, N, H, hoff);
    __syncthreads();
    FragC c;
    mma_abt<HD>(c, Qs + fr * 16 * HD, Ks + fc * 16 * HD);
    wm::store_matrix_sync(Ss + fr * 16 * TB_T + fc * 16, c, TB_T, wm::mem_row_major);
    mma_abt<HD>(c, Os + fr * 16 * HD, Vs + fc * 16 * HD);
    wm::store_matrix_sync(Ps + fr * 16 * TB_T + fc * 16, c, TB_T, wm::mem_row_major);
    __syncthreads();
  };

  // sweep 1: logsumexp and D = sum_j p_j dp_j of each row
  float m_run = -INFINITY, l_run = 0.0f, d_run = 0.0f;
  for (int n0 = 0; n0 < N; n0 += TB_T) {
    scores(n0);
    float s[8], tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j] = (n0 + c0 + j < N) ? Ss[row * TB_T + c0 + j] * scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    for (int off = 4; off > 0; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xFFFFFFFFu, tmax, off));
    const float m_new = fmaxf(m_run, tmax);
    const float corr = expf(m_run - m_new);
    float psum = 0.0f, pd = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      pd = fmaf(p, Ps[row * TB_T + c0 + j], pd);
    }
    for (int off = 4; off > 0; off >>= 1) {
      psum += __shfl_xor_sync(0xFFFFFFFFu, psum, off);
      pd += __shfl_xor_sync(0xFFFFFFFFu, pd, off);
    }
    l_run = l_run * corr + psum;
    d_run = d_run * corr + pd;
    m_run = m_new;
  }
  const float lse = m_run + logf(l_run);
  const float delta = d_run / l_run;
  if (t % 8 == 0 && m0 + row < M) {
    lse_out[((size_t)b * nh + h) * M + m0 + row] = lse;
    delta_out[((size_t)b * nh + h) * M + m0 + row] = delta;
  }

  // sweep 2: dQ = dS K, accumulated in this warp's fragments of the R x HD dQ
  constexpr int NFR = (TB_R / 16) * (HD / 16);
  constexpr int NF = (NFR + 7) / 8;
  FragC acc[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) wm::fill_fragment(acc[i], 0.0f);
  for (int n0 = 0; n0 < N; n0 += TB_T) {
    scores(n0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + j;
      const float p = (n0 + col < N) ? expf(Ss[row * TB_T + col] * scale - lse) : 0.0f;
      DS[row * TB_T + col] = __float2bfloat16_rn(p * (Ps[row * TB_T + col] - delta) * scale);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int f = warp + 8 * i;
      if (f < NFR) {
        const int fi = f / (HD / 16), fj = f % (HD / 16);
        mma_ab<HD>(acc[i], DS + fi * 16 * TB_T, Ks + fj * 16);
      }
    }
  }
  __syncthreads();
  float* St = reinterpret_cast<float*>(Ks);  // [R][HD] staging over the K/V tiles
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int f = warp + 8 * i;
    if (f < NFR) {
      const int fi = f / (HD / 16), fj = f % (HD / 16);
      wm::store_matrix_sync(St + fi * 16 * HD + fj * 16, acc[i], HD, wm::mem_row_major);
    }
  }
  __syncthreads();
  for (int e = t; e < TB_R * HD; e += TB_THREADS) {
    const int r = e / HD, c = e % HD;
    if (m0 + r < M) dq[((size_t)b * M + m0 + r) * H + hoff + c] = __float2bfloat16_rn(St[e]);
  }
}

template <int HD>
__global__ void __launch_bounds__(TB_THREADS)
    dense_attn_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const __nv_bfloat16* __restrict__ dout,
                                 const float* __restrict__ lse_in,
                                 const float* __restrict__ delta_in,
                                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                                 int M, int N, int H, float scale) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [R][HD]
  __nv_bfloat16* Vs = Ks + TB_R * HD;                              // [R][HD]
  __nv_bfloat16* Qs = Vs + TB_R * HD;                              // [T][HD]
  __nv_bfloat16* Os = Qs + TB_T * HD;                              // [T][HD] dO
  float* Ss = reinterpret_cast<float*>(Os + TB_T * HD);            // [R][T] S^T
  float* Ps = Ss + TB_R * TB_T;                                    // [R][T] dP^T
  __nv_bfloat16* PT = reinterpret_cast<__nv_bfloat16*>(Ps + TB_R * TB_T);  // [R][T] P^T
  __nv_bfloat16* DT = PT + TB_R * TB_T;                                   // [R][T] dS^T
  float* Ls = reinterpret_cast<float*>(DT + TB_R * TB_T);         // [T] lse
  float* Dl = Ls + TB_T;                                           // [T] D

  const int t = threadIdx.x, warp = t / 32;
  const int n0 = blockIdx.x * TB_R;
  const int h = blockIdx.y, b = blockIdx.z, nh = gridDim.y;
  const int hoff = h * HD;
  const __nv_bfloat16* qb = q + (size_t)b * M * H;
  const __nv_bfloat16* ob = dout + (size_t)b * M * H;
  const float* lb = lse_in + ((size_t)b * nh + h) * M;
  const float* db = delta_in + ((size_t)b * nh + h) * M;
  copy_tile<HD>(Ks, k + (size_t)b * N * H, n0, TB_R, N, H, hoff);
  copy_tile<HD>(Vs, v + (size_t)b * N * H, n0, TB_R, N, H, hoff);
  const int fr = warp / 4, fc = warp % 4;
  const int row = t / 8, c0 = (t % 8) * 8;

  // fragments of dV (f < NFR / 2) and dK (the rest), each R x HD
  constexpr int NFR = 2 * (TB_R / 16) * (HD / 16);
  constexpr int NF = (NFR + 7) / 8;
  FragC acc[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) wm::fill_fragment(acc[i], 0.0f);

  for (int m0 = 0; m0 < M; m0 += TB_T) {
    __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
    copy_tile<HD>(Qs, qb, m0, TB_T, M, H, hoff);
    copy_tile<HD>(Os, ob, m0, TB_T, M, H, hoff);
    if (t < TB_T) {
      const int m = min(m0 + t, M - 1);
      Ls[t] = lb[m];
      Dl[t] = db[m];
    }
    __syncthreads();
    FragC c;
    mma_abt<HD>(c, Ks + fr * 16 * HD, Qs + fc * 16 * HD);
    wm::store_matrix_sync(Ss + fr * 16 * TB_T + fc * 16, c, TB_T, wm::mem_row_major);
    mma_abt<HD>(c, Vs + fr * 16 * HD, Os + fc * 16 * HD);
    wm::store_matrix_sync(Ps + fr * 16 * TB_T + fc * 16, c, TB_T, wm::mem_row_major);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + j;
      const float p = (m0 + col < M) ? expf(Ss[row * TB_T + col] * scale - Ls[col]) : 0.0f;
      PT[row * TB_T + col] = __float2bfloat16_rn(p);
      DT[row * TB_T + col] = __float2bfloat16_rn(p * (Ps[row * TB_T + col] - Dl[col]) * scale);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int f = warp + 8 * i;
      if (f < NFR) {
        const bool is_dk = f >= NFR / 2;
        const int rem = is_dk ? f - NFR / 2 : f;
        const int fi = rem / (HD / 16), fj = rem % (HD / 16);
        mma_ab<HD>(acc[i], (is_dk ? DT : PT) + fi * 16 * TB_T, (is_dk ? Qs : Os) + fj * 16);
      }
    }
  }
  __syncthreads();
  float* St = reinterpret_cast<float*>(Qs);  // [2][R][HD] staging over the Q/dO tiles
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int f = warp + 8 * i;
    if (f < NFR) {
      const bool is_dk = f >= NFR / 2;
      const int rem = is_dk ? f - NFR / 2 : f;
      const int fi = rem / (HD / 16), fj = rem % (HD / 16);
      wm::store_matrix_sync(St + (is_dk ? TB_R * HD : 0) + fi * 16 * HD + fj * 16, acc[i], HD,
                            wm::mem_row_major);
    }
  }
  __syncthreads();
  for (int e = t; e < TB_R * HD; e += TB_THREADS) {
    const int r = e / HD, c = e % HD;
    if (n0 + r < N) {
      const size_t g = ((size_t)b * N + n0 + r) * H + hoff + c;
      dv[g] = __float2bfloat16_rn(St[e]);
      dk[g] = __float2bfloat16_rn(St[TB_R * HD + e]);
    }
  }
}

template <int HD>
cudaError_t launch_dense_attn_bwd_tc(const void* q, const void* k, const void* v,
                                     const void* dout, void* dq, void* dk, void* dv, void* lse,
                                     void* delta, int B, int M, int N, int H, int nh, float scale,
                                     cudaStream_t stream) {
  using bf = __nv_bfloat16;
  auto dq_kernel = dense_attn_bwd_dq_tc_kernel<HD>;
  cudaError_t err = allow_smem(dq_kernel, tc_dq_smem<HD>());
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3((M + TB_R - 1) / TB_R, nh, B), TB_THREADS, tc_dq_smem<HD>(), stream>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, (bf*)dq, (float*)lse,
      (float*)delta, M, N, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto dkv_kernel = dense_attn_bwd_dkv_tc_kernel<HD>;
  err = allow_smem(dkv_kernel, tc_dkv_smem<HD>());
  if (err != cudaSuccess) return err;
  dkv_kernel<<<dim3((N + TB_R - 1) / TB_R, nh, B), TB_THREADS, tc_dkv_smem<HD>(), stream>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, (const float*)lse,
      (const float*)delta, (bf*)dk, (bf*)dv, M, N, H, scale);
  return cudaGetLastError();
}

// Forward (K3) on the tensor cores, for bfloat16 at head dims 32-256: a
// block owns 32 query rows and streams key tiles of 64. S = Q K^T comes from
// WMMA into shared memory; eight threads per row keep the online max and
// sum and write the unnormalised P, rounded to bfloat16 as the TPU kernel
// rounds it before P V; P V is a WMMA product whose tile the same threads
// fold into their float32 rows of O (rescaled by the running max).
template <int HD>
constexpr size_t tc_fwd_smem() {
  return (size_t)TB_R * HD * 2 + 2 * TB_T * HD * 2 + TB_R * TB_T * 4 + TB_R * TB_T * 2 +
         TB_R * HD * 4;
}

template <int HD>
__global__ void __launch_bounds__(TB_THREADS)
    dense_attn_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                         int M, int N, int H, float scale) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [R][HD]
  __nv_bfloat16* Ks = Qs + TB_R * HD;                              // [T][HD]
  __nv_bfloat16* Vs = Ks + TB_T * HD;                              // [T][HD]
  float* Ss = reinterpret_cast<float*>(Vs + TB_T * HD);            // [R][T] S
  __nv_bfloat16* Pb = reinterpret_cast<__nv_bfloat16*>(Ss + TB_R * TB_T);  // [R][T] P
  float* PV = reinterpret_cast<float*>(Pb + TB_R * TB_T);          // [R][HD] this tile's P V

  const int t = threadIdx.x, warp = t / 32;
  const int m0 = blockIdx.x * TB_R;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hoff = h * HD;
  const __nv_bfloat16* kb = k + (size_t)b * N * H;
  const __nv_bfloat16* vb = v + (size_t)b * N * H;
  copy_tile<HD>(Qs, q + (size_t)b * M * H, m0, TB_R, M, H, hoff);
  const int fr = warp / 4, fc = warp % 4;
  const int row = t / 8, sub = t % 8;  // this thread: row `row`, columns sub + 8 j
  constexpr int NO = HD / 8;
  constexpr int NFR = (TB_R / 16) * (HD / 16);
  constexpr int NF = (NFR + 7) / 8;
  float o[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j] = 0.0f;
  float m_run = -INFINITY, l_run = 0.0f;

  for (int n0 = 0; n0 < N; n0 += TB_T) {
    __syncthreads();  // the previous tile's K, V, P and P V are consumed
    copy_tile<HD>(Ks, kb, n0, TB_T, N, H, hoff);
    copy_tile<HD>(Vs, vb, n0, TB_T, N, H, hoff);
    __syncthreads();
    FragC c;
    mma_abt<HD>(c, Qs + fr * 16 * HD, Ks + fc * 16 * HD);
    wm::store_matrix_sync(Ss + fr * 16 * TB_T + fc * 16, c, TB_T, wm::mem_row_major);
    __syncthreads();
    float s[8], tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = sub * 8 + j;
      s[j] = (n0 + col < N) ? Ss[row * TB_T + col] * scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    for (int off = 4; off > 0; off >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xFFFFFFFFu, tmax, off));
    const float m_new = fmaxf(m_run, tmax);
    const float corr = expf(m_run - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      Pb[row * TB_T + sub * 8 + j] = __float2bfloat16_rn(p);
    }
    for (int off = 4; off > 0; off >>= 1) psum += __shfl_xor_sync(0xFFFFFFFFu, psum, off);
    l_run = l_run * corr + psum;
    m_run = m_new;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      const int f = warp + 8 * i;
      if (f < NFR) {
        const int fi = f / (HD / 16), fj = f % (HD / 16);
        FragC acc;
        wm::fill_fragment(acc, 0.0f);
        mma_ab<HD>(acc, Pb + fi * 16 * TB_T, Vs + fj * 16);
        wm::store_matrix_sync(PV + fi * 16 * HD + fj * 16, acc, HD, wm::mem_row_major);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j] = fmaf(o[j], corr, PV[row * HD + sub + 8 * j]);
  }
  const int m = m0 + row;
  if (m < M) {
    const float inv = 1.0f / l_run;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      out[((size_t)b * M + m) * H + hoff + sub + 8 * j] = __float2bfloat16_rn(o[j] * inv);
  }
}

template <int HD>
cudaError_t launch_dense_attn_tc(const void* q, const void* k, const void* v, void* out, int B,
                                 int M, int N, int H, int nh, float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  auto kernel = dense_attn_tc_kernel<HD>;
  cudaError_t err = allow_smem(kernel, tc_fwd_smem<HD>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3((M + TB_R - 1) / TB_R, nh, B), TB_THREADS, tc_fwd_smem<HD>(), stream>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (bf*)out, M, N, H, scale);
  return cudaGetLastError();
}

}  // namespace poem

using namespace poem;

static bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

static bool tc_head_dim(int hd) { return hd == 32 || hd == 64 || hd == 128 || hd == 256; }

// The shapes each dtype takes: float32 head dims 32..256 in steps of 16;
// bfloat16 head dims 32, 64, 128 or 256 on 16-byte aligned tensors.
static bool shapes_ok(int dtype, int M, int N, int H, int nh,
                      std::initializer_list<const void*> ptrs) {
  if (nh < 1 || H % nh != 0 || M < 1 || N < 1) return false;
  const int hd = H / nh;
  if (dtype == DTYPE_F32) return hd >= 32 && hd <= CA_MAX_HD && hd % 16 == 0;
  if (dtype == DTYPE_BF16) return tc_head_dim(hd) && aligned16(ptrs);
  return false;
}

// q (B, M, H), k and v (B, N, H), out (B, M, H); heads are H / nh wide.
// float32 runs the FMA kernel, bfloat16 the tensor-core kernel.
extern "C" int poem_dense_cross_attention(int dtype, const void* q, const void* k, const void* v,
                                          void* out, int B, int M, int N, int H, int nh,
                                          float scale, void* stream) {
  if (!shapes_ok(dtype, M, N, H, nh, {q, k, v, out})) return (int)cudaErrorInvalidValue;
  const int hd = H / nh;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32) return (int)launch_dense_attn(q, k, v, out, B, M, N, H, nh, scale, s);
#define POEM_FWD_TC(HD) launch_dense_attn_tc<HD>(q, k, v, out, B, M, N, H, nh, scale, s)
  return (int)(hd == 32 ? POEM_FWD_TC(32) : hd == 64 ? POEM_FWD_TC(64)
               : hd == 128 ? POEM_FWD_TC(128) : POEM_FWD_TC(256));
#undef POEM_FWD_TC
}

// Gradients of poem_dense_cross_attention: dq (B, M, H), dk and dv (B, N, H)
// in the input dtype; lse and delta are (B, nh, M) float32 scratch.
// float32 runs the FMA kernels, bfloat16 the tensor-core kernels.
extern "C" int poem_dense_cross_attention_bwd(int dtype, const void* q, const void* k,
                                              const void* v, const void* dout, void* dq,
                                              void* dk, void* dv, void* lse, void* delta, int B,
                                              int M, int N, int H, int nh, float scale,
                                              void* stream) {
  if (!shapes_ok(dtype, M, N, H, nh, {q, k, v, dout, dq, dk, dv}))
    return (int)cudaErrorInvalidValue;
  const int hd = H / nh;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return (int)launch_dense_attn_bwd(q, k, v, dout, dq, dk, dv, lse, delta, B, M, N, H, nh,
                                      scale, s);
#define POEM_BWD_TC(HD)                                                                         \
  launch_dense_attn_bwd_tc<HD>(q, k, v, dout, dq, dk, dv, lse, delta, B, M, N, H, nh, scale, s)
  return (int)(hd == 32 ? POEM_BWD_TC(32) : hd == 64 ? POEM_BWD_TC(64)
               : hd == 128 ? POEM_BWD_TC(128) : POEM_BWD_TC(256));
#undef POEM_BWD_TC
}
