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
// In bfloat16 the bound is the tensor cores' rate, which only `wgmma`
// reaches: the bfloat16 kernels (second half of the file) are built around
// it, with TMA loads that complete on mbarriers and every intermediate in
// registers; their design is described there.
//
// float32 (first half of the file) has no tensor-core path at full
// precision and serves the parity checks only; it stays a simple
// flash-style FMA kernel: one block of 256 threads per (query tile of 16,
// head, batch element). It loops over key tiles of 64, staging K and V in
// shared memory as float32, computes the 16 x 64 score tile, folds it into
// an online softmax kept in float32 (each row's max and sum are shared by
// the 16 threads that own the row), accumulates P V in registers and
// divides by the row sum at the end. P stays float32 there. It takes head
// dims from 16 to 256 in steps of 16; bfloat16 takes head dims 16, 32, 64,
// 128 and 256 on 16-byte aligned tensors; the wrapper rejects anything else.
// Both forwards can write the row logsumexp (float32, (B, heads, M)), which
// the backward takes beside the output.
#include <cuda.h>

#include <initializer_list>

#include "common.cuh"
#include "hopper.cuh"

namespace poem {

constexpr int CA_BQ = 16;
constexpr int CA_BK = 64;
constexpr int CA_THREADS = 256;
constexpr int CA_MAX_HD = 256;

__global__ void __launch_bounds__(CA_THREADS)
    dense_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse_out, int M, int N, int H, int hd, float scale) {
  extern __shared__ float smem[];
  const int ks = hd + 1;                  // padded K row: conflict-free column reads
  float* Qs = smem;                       // [BQ][hd]
  float* Ks = Qs + CA_BQ * hd;            // [BK][hd + 1]
  float* Vs = Ks + CA_BK * ks;            // [BK][hd]
  float* Ps = Vs + CA_BK * hd;            // [BQ][BK]

  const int t = threadIdx.x;
  const int row = t / 16, lane16 = t % 16;
  const int m0 = blockIdx.x * CA_BQ;
  const int h = blockIdx.y, b = blockIdx.z, nh = gridDim.y;
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
    if (lse_out != nullptr && lane16 == 0)
      lse_out[((size_t)b * nh + h) * M + m] = m_run + logf(l_run);
  }
}

cudaError_t launch_dense_attn(const void* q, const void* k, const void* v, void* out, void* lse,
                              int B, int M, int N, int H, int nh, float scale,
                              cudaStream_t stream) {
  const int hd = H / nh;
  auto kernel = dense_attn_kernel;
  const size_t smem =
      sizeof(float) * ((size_t)CA_BQ * hd + CA_BK * (hd + 1) + CA_BK * hd + CA_BQ * CA_BK);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + CA_BQ - 1) / CA_BQ, nh, B);
  kernel<<<grid, CA_THREADS, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                             (float*)out, (float*)lse, M, N, H, hd, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward (K3b).
//
// The TPU kernel keeps a whole (M, N) float32 P per head in VMEM (13 MB at
// 799 x 4096), far beyond the 227 KB of shared memory a block has. So the
// backward is flash-style recompute from the forward's saved output and
// logsumexp, in passes that never store P:
//
// * `dense_attn_bwd_stats_kernel`: D = rowsum(dO * O) of each (row, head),
//   which equals rowsum(P * dP), paired with the row's lse; one warp a row.
// * `dense_attn_bwd_dq_kernel` owns 16 query rows of one head: one sweep
//   over the key tiles recomputes P = exp(s - lse),
//   dS = P * (dP - D) * scale and accumulates dQ = dS K.
// * `dense_attn_bwd_dkv_kernel` owns 16 keys of one head and loops over
//   query tiles: dV = P^T dO and dK = dS^T Q accumulate in registers, so
//   no two blocks write one output and no atomics are needed.
//
// It is arithmetic-bound like the forward (5 products of hd per (query,
// key) pair are needed, the two passes do 7, against the forward's 2).
// Everything stays float32 here, including P and dS, where the TPU kernel
// rounds them to the input dtype before its matrix products. Padded keys
// (N not a multiple of the tile) get p = 0, as the TPU kernel masks keys
// past n_valid. These FMA kernels take float32; bfloat16 runs the
// tensor-core kernels further down.
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

// stats (B, nh, M_pad) pairs (lse * lse_mul, delta), delta = rowsum over one
// head's columns of dout * out, both (B, M, H); one warp a row. M_pad rounds M
// up to the most rows a block owns, and the rows past M hold (+inf, 0): a
// zero row of Q and dO with that pair has P = 0 and dS = 0.
constexpr int STATS_PAD = 128;
inline int stats_rows(int M) { return (M + STATS_PAD - 1) / STATS_PAD * STATS_PAD; }

template <typename T>
__global__ void __launch_bounds__(CA_THREADS)
    dense_attn_bwd_stats_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                                const float* __restrict__ lse, float2* __restrict__ stats,
                                float lse_mul, int B, int M, int M_pad, int H, int nh) {
  const size_t w = ((size_t)blockIdx.x * CA_THREADS + threadIdx.x) / 32;  // (b, h, m)
  const int lane = threadIdx.x % 32;
  if (w >= (size_t)B * nh * M_pad) return;
  const int m = (int)(w % M_pad), hd = H / nh;
  const size_t bh = w / M_pad;
  if (m >= M) {
    if (lane == 0) stats[w] = make_float2(INFINITY, 0.0f);
    return;
  }
  const size_t at = ((bh / nh) * M + m) * H + (bh % nh) * hd;
  float acc = 0.0f;
  for (int c = lane; c < hd; c += 32) acc = fmaf(to_f32(out[at + c]), to_f32(dout[at + c]), acc);
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, off);
  if (lane == 0) stats[w] = make_float2(lse[bh * M + m] * lse_mul, acc);
}

template <typename T>
cudaError_t launch_stats(const void* out, const void* dout, const void* lse, void* stats,
                         float lse_mul, int B, int M, int H, int nh, cudaStream_t stream) {
  const int M_pad = stats_rows(M);
  const size_t warps = (size_t)B * nh * M_pad;
  const unsigned blocks = (unsigned)((warps * 32 + CA_THREADS - 1) / CA_THREADS);
  dense_attn_bwd_stats_kernel<T><<<blocks, CA_THREADS, 0, stream>>>(
      (const T*)out, (const T*)dout, (const float*)lse, (float2*)stats, lse_mul, B, M, M_pad, H,
      nh);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(CA_THREADS)
    dense_attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float2* __restrict__ stats, float* __restrict__ dq, int M,
                             int M_pad, int N, int H, int hd, float scale) {
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

  const int m = m0 + row;
  const float2 stat = stats[((size_t)b * nh + h) * M_pad + min(m, M - 1)];
  const float lse = stat.x, delta = stat.y;

  // dQ = sum_j dS_j k_j
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
                              const float2* __restrict__ stats, float* __restrict__ dk,
                              float* __restrict__ dv, int M, int M_pad, int N, int H, int hd,
                              float scale) {
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
  const float2* sb = stats + ((size_t)b * nh + h) * M_pad;

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
      Ls[t] = sb[m].x;
      Dl[t] = sb[m].y;
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

cudaError_t launch_dense_attn_bwd(const void* q, const void* k, const void* v, const void* out,
                                  const void* dout, const void* lse, void* dq, void* dk, void* dv,
                                  void* stats, int B, int M, int N, int H, int nh, float scale,
                                  cudaStream_t stream) {
  const int hd = H / nh;
  const int ks = hd + 1;
  const int M_pad = stats_rows(M);
  cudaError_t err = launch_stats<float>(out, dout, lse, stats, 1.0f, B, M, H, nh, stream);
  if (err != cudaSuccess) return err;
  auto dq_kernel = dense_attn_bwd_dq_kernel;
  const size_t smem_dq =
      sizeof(float) * ((size_t)2 * CB_BQ * hd + 2 * CB_BK * ks + CB_BQ * CB_BK);
  err = allow_smem(dq_kernel, smem_dq);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3((M + CB_BQ - 1) / CB_BQ, nh, B), CA_THREADS, smem_dq, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float2*)stats, (float*)dq, M, M_pad, N, H, hd, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dkv_kernel = dense_attn_bwd_dkv_kernel;
  const size_t smem_dkv = sizeof(float) * ((size_t)2 * CB_BKV * ks + 2 * CB_BQT * ks +
                                           2 * CB_BQT + 2 * CB_BKV * CB_BQT);
  err = allow_smem(dkv_kernel, smem_dkv);
  if (err != cudaSuccess) return err;
  dkv_kernel<<<dim3((N + CB_BKV - 1) / CB_BKV, nh, B), CA_THREADS, smem_dkv, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float2*)stats, (float*)dk, (float*)dv, M, M_pad, N, H, hd, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 on the H100's warpgroup tensor cores: forward (K3) and the two
// passes of the backward (K3b), head dims 16, 32, 64, 128 and 256. At head
// dim 16 (the synthetic ResNet models' 4 heads of 64) Q K^T is one k-step and
// P V an n16 product.
//
// What bounds them: arithmetic (see the head of the file), so the products
// have to run as `wgmma`, the only instruction that reaches the card's
// tensor-core rate, and nothing else may stand in their way:
//
// * Loads are asynchronous. The tiles a block streams go through a ring of
//   NST stages in shared memory. One elected thread asks the TMA unit for a
//   tile (a tensor map over (H, rows, B) with a box of at most 64 columns of
//   one head, so a box row is 128 bytes, 64 at head dim 32 and 32 at head dim
//   16, and the hardware applies the matching 128-, 64- or 32-byte swizzle
//   that `wgmma` reads without bank conflicts; the descriptors name the same
//   swizzle, `Box::LAYOUT`). The bytes complete on the stage's `full` mbarrier; the
//   warps give the stage back on its `empty` mbarrier, and the elected
//   thread refills it NST - 1 tiles ahead of the products. There is no
//   `__syncthreads()` after the barriers are set up. Rows past the end of a
//   tensor arrive as zeros, so ragged M and N need no clamped re-reads.
//   A `cp.async` ring would have cost every thread address arithmetic and a
//   hand-written swizzle for the same bytes; the tensor maps cost three or
//   four `cuTensorMapEncodeTiled` calls on the host per launch (a few
//   microseconds) and are passed as `__grid_constant__` parameters.
//   There is no producer warp: with a third warpgroup in the block ptxas
//   gave the consumers at most 200 registers whatever `setmaxnreg` asked for
//   (measured: the head-dim-256 forward and the dkv pass spilled their
//   accumulators), while two warpgroups alone get 255 each; asking for a tile
//   is a handful of instructions of one thread.
// * Every intermediate stays in registers. A warpgroup (4 warps) owns 64
//   rows. S = Q K^T comes out of `wgmma` in the accumulator layout
//   (hopper.cuh); the row maximum and sum are two shuffles inside a quad of
//   lanes; exp2 with sm_scale * log2(e) folded in; the unnormalised P,
//   rounded to bfloat16 as the TPU kernel rounds it, is already in the
//   layout of a register A operand, and V (or K, Q, dO in the backward) is
//   the shared-memory B operand as it lies, rows of keys (MN-major, the
//   descriptor's transpose bit). O, dQ, dK and dV are float32 accumulators
//   in registers for the whole sweep. While one warpgroup of a block is in
//   its softmax the other's products keep the tensor cores busy.
// * Tiles: a block has two warpgroups (128 query rows in the forward and the
//   dq pass, which halves the times K and V are read from L2 against 64-row
//   blocks), one in the dq pass at head dim 256; key tiles are 128 wide up
//   to head dim 128 in the forward and 64 elsewhere, which is what the 227 KB
//   of shared memory and 255 registers a thread allow (sizes at each kernel).
//
// The backward takes the forward's saved output and logsumexp, so it is 7
// products a (query, key) pair where the kernels it replaces did 9: a small
// row kernel writes (lse * log2(e), delta = rowsum(dO * O)) pairs; the dq
// pass owns query rows and does S, dP = dO V^T, dQ += dS K in one sweep over
// the keys; the dkv pass owns key rows and streams Q and dO tiles with their
// pairs: S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q. Each output
// row is written by one block: no atomics, the same bits on every launch.
using namespace hop;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// One head's columns arrive in boxes of at most 64 columns: a box is
// [rows][C] bfloat16 with rows RB bytes apart, swizzled over RB bytes (the
// descriptor's swizzle code: 1 for 128 bytes, 2 for 64, 3 for 32).
template <int HD> struct Box {
  static constexpr int C = HD < 64 ? HD : 64;
  static constexpr int RB = C * 2;
  static constexpr int NB = HD / C;
  static constexpr int KSTEPS = C / 16;
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 256 && HD % C == 0, "head dim");
};

// descriptor of a K-major operand (the 16 reduced columns lie along a box row)
template <int HD> __device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return mma_desc(addr, 16, 8 * Box<HD>::RB, Box<HD>::LAYOUT);
}
// descriptor of an MN-major B operand (16 reduced rows of a box, C columns out)
template <int HD> __device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t box_bytes) {
  return mma_desc(addr, box_bytes, 8 * Box<HD>::RB, Box<HD>::LAYOUT);
}

// d = A B^T over the head dim: A = 64 rows at `sa` of boxes `a_box` bytes
// apart, B = the N rows (d has N / 2 registers) at `sb` likewise
template <int HD, int NREG>
__device__ __forceinline__ void mma_abt(float (&d)[NREG], uint32_t sa, uint32_t a_box, uint32_t sb,
                                        uint32_t b_box) {
  using X = Box<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int box = kk / X::KSTEPS, off = (kk % X::KSTEPS) * 32;
    wgmma_ss(d, desc_k<HD>(sa + box * a_box + off), desc_k<HD>(sb + box * b_box + off), kk > 0);
  }
}

// acc[i] += A B[:, box i] for NBX boxes of B: A = 64 x T in registers (T / 4
// of them), B = T rows at `sb`, boxes `b_box` bytes apart
template <int HD, int NBX, int NA>
__device__ __forceinline__ void mma_ab(float (&acc)[NBX][Box<HD>::C / 2], const uint32_t (&a)[NA],
                                       uint32_t sb, uint32_t b_box) {
  using X = Box<HD>;
#pragma unroll
  for (int kk = 0; kk < NA / 4; ++kk) {
#pragma unroll
    for (int i = 0; i < NBX; ++i)
      wgmma_rs(acc[i], &a[4 * kk], desc_mn<HD>(sb + i * b_box + kk * 16 * X::RB, b_box), 1);
  }
}

// all NB boxes of a [rows][HD] tile: rows `row0 ..` of head `h`, sample `b`
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, int rows, const CUtensorMap* map,
                                          uint32_t bar, int h, int row0, int b) {
  using X = Box<HD>;
#pragma unroll
  for (int x = 0; x < X::NB; ++x)
    tma_load_3d(dst + x * rows * X::RB, map, bar, h * HD + x * X::C, row0, b);
}

// The ring's barriers: `first`, on which the tiles a block owns arrive, then
// NST `full` and NST `empty` ones. One thread sets them up before the
// block's only `__syncthreads()`.
template <int NST> struct Ring {
  uint32_t first, full, empty;
  __device__ __forceinline__ explicit Ring(uint32_t at)
      : first(at), full(at + 8), empty(at + 8 + 8 * NST) {}
  __device__ __forceinline__ void init(int warps) const {
    mbar_init(first, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, warps);
    }
    mbar_init_fence();
  }
  static constexpr int BYTES = 8 * (1 + 2 * NST);
};

// the first 1024-byte boundary of the dynamic shared memory: the swizzle is a
// function of the address, and the tiles start on its period
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// 2^x in one special-function instruction (exp2f wraps range handling around
// it); 2^-inf = 0, results below the normal range flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xFFFFFFFFu, x, 1);
  return x + __shfl_xor_sync(0xFFFFFFFFu, x, 2);
}

// rows [row, row + 8] x this thread's columns of NBX boxes of accumulators,
// times `mul[0]` / `mul[1]`, as bfloat16 into dst (.., H) at column `col0`
template <int HD, int NBX>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float (&acc)[NBX][Box<HD>::C / 2],
                                           const float (&mul)[2], int row, int n_rows, int H,
                                           int col0, int c) {
  using X = Box<HD>;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= n_rows) continue;
    __nv_bfloat16* p = dst + (size_t)(row + 8 * r) * H + col0 + 2 * c;
#pragma unroll
    for (int i = 0; i < NBX; ++i) {
#pragma unroll
      for (int j = 0; j < X::C / 8; ++j)
        *reinterpret_cast<uint32_t*>(p + i * X::C + 8 * j) =
            pack_bf16(acc[i][4 * j + 2 * r] * mul[r], acc[i][4 * j + 2 * r + 1] * mul[r]);
    }
  }
}

// ---- forward ----
// Shared memory: Q [NB][64 NWG][RB], then NST stages of K and V
// [NB][KT][RB] each, then the barriers. Head dim 256: 64 + 2 x 64 KB with
// KT = 64; head dim 128: 32 + 2 x 64 KB with KT = 128.
template <int HD> struct FwdCfg {
  static constexpr int NWG = 2;
  static constexpr int KT = HD == 256 ? 64 : 128;
  static constexpr int NST = HD <= 64 ? 4 : 2;
  static constexpr int ROWS = 64 * NWG;
  static constexpr int Q_BYTES = ROWS * HD * 2;
  static constexpr int KV_BYTES = KT * HD * 2;
  static constexpr int THREADS = NWG * 128;
  static constexpr size_t SMEM = 1024 + Q_BYTES + NST * 2 * KV_BYTES + Ring<NST>::BYTES;
};

template <int HD>
__global__ void __launch_bounds__(FwdCfg<HD>::THREADS, 1)
    dense_attn_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         __nv_bfloat16* __restrict__ out, float* __restrict__ lse_out, int M, int N,
                         int H, float scale) {
  using X = Box<HD>;
  using Cfg = FwdCfg<HD>;
  constexpr int KT = Cfg::KT, NST = Cfg::NST, ROWS = Cfg::ROWS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = smem_u32(align_1024(smem_raw)), sKV = sQ + Cfg::Q_BYTES;
  const Ring<NST> ring(sKV + NST * 2 * Cfg::KV_BYTES);

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int m0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z, nh = gridDim.y;
  const int ntiles = (N + KT - 1) / KT;
  if (t == 0) ring.init(4 * Cfg::NWG);
  __syncthreads();

  // tile `it` of K and V into its stage
  auto fill = [&](int it) {
    const int s = it % NST;
    const uint32_t sK = sKV + s * 2 * Cfg::KV_BYTES, bar = ring.full + 8 * s;
    mbar_arrive_expect_tx(bar, 2 * Cfg::KV_BYTES);
    load_tile<HD>(sK, KT, &map_k, bar, h, it * KT, b);
    load_tile<HD>(sK + Cfg::KV_BYTES, KT, &map_v, bar, h, it * KT, b);
  };
  if (t == 0) {
    mbar_arrive_expect_tx(ring.first, Cfg::Q_BYTES);
    load_tile<HD>(sQ, ROWS, &map_q, ring.first, h, m0, b);
    for (int it = 0; it < NST && it < ntiles; ++it) fill(it);
  }

  // warpgroup `wg` owns query rows m0 + 64 wg ..; this thread rows `row` and
  // `row + 8` of them
  const int wg = warp / 4, g = lane / 4, c = lane % 4;
  const int row = m0 + 64 * wg + 16 * (warp % 4) + g;
  const uint32_t sQw = sQ + 64 * wg * X::RB;
  const float scale_log2 = scale * LOG2E;
  float o[X::NB][X::C / 2];
#pragma unroll
  for (int i = 0; i < X::NB; ++i)
#pragma unroll
    for (int j = 0; j < X::C / 2; ++j) o[i][j] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};

  mbar_wait(ring.first, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % NST;
    const uint32_t sK = sKV + s * 2 * Cfg::KV_BYTES, sV = sK + Cfg::KV_BYTES;
    mbar_wait(ring.full + 8 * s, (it / NST) & 1);

    float sc[KT / 2];
    wgmma_fence();
    mma_abt<HD>(sc, sQw, ROWS * X::RB, sK, KT * X::RB);
    wgmma_commit();
    wgmma_wait<0>();
    pin(sc);

    // The softmax costs as many instructions as the products cost tensor-core
    // cycles up to head dim 64, so it is kept to a max, one multiply-add and
    // one exponential an entry: the running maximum m is of the raw logits
    // (the scale is positive) and P = 2^(s c - m c) with c = scale log2(e).
    // Keys past N (zero rows of the tile) are masked.
    const int n0 = it * KT;
    if (n0 + KT > N) {
#pragma unroll
      for (int i = 0; i < KT / 2; ++i)
        if (n0 + 8 * (i / 4) + 2 * c + (i & 1) >= N) sc[i] = -INFINITY;
    }
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) m_new[(i >> 1) & 1] = fmaxf(m_new[(i >> 1) & 1], sc[i]);
    float corr[2], mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = quad_max(m_new[r]);
      corr[r] = ex2((m_run[r] - m_new[r]) * scale_log2);
      mc[r] = m_new[r] * scale_log2;
      m_run[r] = m_new[r];
      l_run[r] *= corr[r];  // this thread's share of the row sum; the quad adds up at the end
    }
    uint32_t p[KT / 4];
#pragma unroll
    for (int i = 0; i < KT / 4; ++i) {
      const float p0 = ex2(fmaf(sc[2 * i], scale_log2, -mc[i & 1]));
      const float p1 = ex2(fmaf(sc[2 * i + 1], scale_log2, -mc[i & 1]));
      l_run[i & 1] += p0 + p1;
      p[i] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < X::NB; ++i)
#pragma unroll
      for (int j = 0; j < X::C / 2; ++j) o[i][j] *= corr[(j >> 1) & 1];

    wgmma_fence();
    mma_ab<HD, X::NB>(o, p, sV, KT * X::RB);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < X::NB; ++i) pin(o[i]);
    pin(p);
    if (lane == 0) mbar_arrive(ring.empty + 8 * s);
    if (t == 0 && it + NST < ntiles) {
      mbar_wait(ring.empty + 8 * s, (it / NST) & 1);
      fill(it + NST);
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    inv[r] = 1.0f / l;
    if (lse_out != nullptr && c == 0 && row + 8 * r < M)
      lse_out[((size_t)b * nh + h) * M + row + 8 * r] =
          (m_run[r] * scale_log2 + log2f(l)) * LN2;
  }
  store_rows<HD, X::NB>(out + (size_t)b * M * H, o, inv, row, M, H, h * HD, c);
}

// tensor map over a contiguous (B, rows, H) bfloat16 tensor, dimensions (H,
// rows, B), with a box of `box_rows` rows of one head's first 64 (or 32, or 16)
// columns
template <int HD>
static bool make_map(CUtensorMap* map, const void* ptr, int B, int rows, int H, int box_rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)H, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)H * 2, (cuuint64_t)rows * H * 2};
  const cuuint32_t box[3] = {(cuuint32_t)Box<HD>::C, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                Box<HD>::SWIZZLE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_dense_attn_wg(const void* q, const void* k, const void* v, void* out, void* lse,
                                 int B, int M, int N, int H, int nh, float scale,
                                 cudaStream_t stream) {
  using Cfg = FwdCfg<HD>;
  CUtensorMap mq, mk, mv;
  if (!make_map<HD>(&mq, q, B, M, H, Cfg::ROWS) || !make_map<HD>(&mk, k, B, N, H, Cfg::KT) ||
      !make_map<HD>(&mv, v, B, N, H, Cfg::KT))
    return cudaErrorInvalidValue;
  auto kernel = dense_attn_wg_kernel<HD>;
  cudaError_t err = allow_smem(kernel, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((M + Cfg::ROWS - 1) / Cfg::ROWS, nh, B), Cfg::THREADS, Cfg::SMEM, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)out, (float*)lse, M, N, H, scale);
  return cudaGetLastError();
}

// ---- backward, dq pass ----
// A block owns 64 NWG query rows: Q and dO once, then the ring of K and V
// tiles of KT keys. Head dim 256: one warpgroup (dQ 128, S and dP 32 each,
// dS 16 registers a thread), 2 x 32 KB + 2 x 64 KB; head dim 128: two
// warpgroups, 2 x 32 KB + 2 x 32 KB.
template <int HD> struct DqCfg {
  static constexpr int NWG = HD == 256 ? 1 : 2;
  static constexpr int KT = 64;
  static constexpr int NST = HD <= 64 ? 4 : 2;
  static constexpr int ROWS = 64 * NWG;
  static constexpr int Q_BYTES = ROWS * HD * 2;
  static constexpr int KV_BYTES = KT * HD * 2;
  static constexpr int THREADS = NWG * 128;
  static constexpr size_t SMEM = 1024 + 2 * Q_BYTES + NST * 2 * KV_BYTES + Ring<NST>::BYTES;
};

template <int HD>
__global__ void __launch_bounds__(DqCfg<HD>::THREADS, 1)
    dense_attn_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_do,
                                const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_v,
                                const float2* __restrict__ stats, __nv_bfloat16* __restrict__ dq,
                                int M, int M_pad, int N, int H, float scale) {
  using X = Box<HD>;
  using Cfg = DqCfg<HD>;
  constexpr int KT = Cfg::KT, NST = Cfg::NST, ROWS = Cfg::ROWS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = smem_u32(align_1024(smem_raw)), sO = sQ + Cfg::Q_BYTES;
  const uint32_t sKV = sO + Cfg::Q_BYTES;
  const Ring<NST> ring(sKV + NST * 2 * Cfg::KV_BYTES);

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int m0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z, nh = gridDim.y;
  const int ntiles = (N + KT - 1) / KT;
  if (t == 0) ring.init(4 * Cfg::NWG);
  __syncthreads();

  auto fill = [&](int it) {
    const int s = it % NST;
    const uint32_t sK = sKV + s * 2 * Cfg::KV_BYTES, bar = ring.full + 8 * s;
    mbar_arrive_expect_tx(bar, 2 * Cfg::KV_BYTES);
    load_tile<HD>(sK, KT, &map_k, bar, h, it * KT, b);
    load_tile<HD>(sK + Cfg::KV_BYTES, KT, &map_v, bar, h, it * KT, b);
  };
  if (t == 0) {
    mbar_arrive_expect_tx(ring.first, 2 * Cfg::Q_BYTES);
    load_tile<HD>(sQ, ROWS, &map_q, ring.first, h, m0, b);
    load_tile<HD>(sO, ROWS, &map_do, ring.first, h, m0, b);
    for (int it = 0; it < NST && it < ntiles; ++it) fill(it);
  }

  const int wg = warp / 4, g = lane / 4, c = lane % 4;
  const int row = m0 + 64 * wg + 16 * (warp % 4) + g;
  const uint32_t sQw = sQ + 64 * wg * X::RB, sOw = sO + 64 * wg * X::RB;
  const float scale_log2 = scale * LOG2E;
  // (lse in units of log 2, delta) of rows `row` and `row + 8`; the rows past
  // M (zero rows of Q and dO) hold (+inf, 0) and get P = 0
  float2 st[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) st[r] = stats[((size_t)b * nh + h) * M_pad + row + 8 * r];
  float acc[X::NB][X::C / 2];
#pragma unroll
  for (int i = 0; i < X::NB; ++i)
#pragma unroll
    for (int j = 0; j < X::C / 2; ++j) acc[i][j] = 0.0f;

  mbar_wait(ring.first, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % NST;
    const uint32_t sK = sKV + s * 2 * Cfg::KV_BYTES, sV = sK + Cfg::KV_BYTES;
    mbar_wait(ring.full + 8 * s, (it / NST) & 1);

    float sc[KT / 2], dp[KT / 2];
    wgmma_fence();
    mma_abt<HD>(sc, sQw, ROWS * X::RB, sK, KT * X::RB);
    mma_abt<HD>(dp, sOw, ROWS * X::RB, sV, KT * X::RB);
    wgmma_commit();
    wgmma_wait<0>();
    pin(sc);
    pin(dp);

    // dS = P (dP - delta) scale, rounded to bfloat16; keys past N give 0
    const int n0 = it * KT;
    const bool ragged = n0 + KT > N;
    uint32_t ds[KT / 4];
#pragma unroll
    for (int i = 0; i < KT / 4; ++i) {
      const int r = i & 1;
      float d0 = ex2(fmaf(sc[2 * i], scale_log2, -st[r].x)) * (dp[2 * i] - st[r].y) * scale;
      float d1 = ex2(fmaf(sc[2 * i + 1], scale_log2, -st[r].x)) * (dp[2 * i + 1] - st[r].y) * scale;
      if (ragged) {
        const int col = n0 + 8 * (i / 2) + 2 * c;
        if (col >= N) d0 = 0.0f;
        if (col + 1 >= N) d1 = 0.0f;
      }
      ds[i] = pack_bf16(d0, d1);
    }
    wgmma_fence();
    mma_ab<HD, X::NB>(acc, ds, sK, KT * X::RB);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < X::NB; ++i) pin(acc[i]);
    pin(ds);
    if (lane == 0) mbar_arrive(ring.empty + 8 * s);
    if (t == 0 && it + NST < ntiles) {
      mbar_wait(ring.empty + 8 * s, (it / NST) & 1);
      fill(it + NST);
    }
  }
  const float one[2] = {1.0f, 1.0f};
  store_rows<HD, X::NB>(dq + (size_t)b * M * H, acc, one, row, M, H, h * HD, c);
}

// ---- backward, dkv pass ----
// A block owns key rows: K and V once, then the ring of Q and dO tiles of
// QT = 64 query rows with their (lse, delta) pairs. Up to head dim 128 its two
// warpgroups own 64 keys each (dK and dV are 2 x 64 registers a thread at
// head dim 128). At head dim 256 the two 64 x 256 accumulators would be 256
// registers a thread, so both warpgroups own the same 64 keys and each half
// the columns of dK and dV: S^T and dP^T are then computed by both (6
// products a pair where 4 are needed) and every register array keeps its
// size. Shared memory at head dim 256: 2 x 32 KB of K and V + 2 stages x
// 65 KB; at 128: 2 x 32 KB + 2 x 33 KB.
template <int HD> struct DkvCfg {
  static constexpr int NWG = 2;
  static constexpr bool SPLIT = HD == 256;           // the warpgroups split columns, not keys
  static constexpr int KROWS = SPLIT ? 64 : 64 * NWG;
  static constexpr int NBX = SPLIT ? Box<HD>::NB / NWG : Box<HD>::NB;  // boxes a warpgroup owns
  static constexpr int QT = 64;
  static constexpr int NST = HD <= 64 ? 4 : 2;
  static constexpr int K_BYTES = KROWS * HD * 2;
  static constexpr int Q_BYTES = QT * HD * 2;
  static constexpr int ST_BYTES = QT * 8;            // the tile's (lse, delta) pairs
  static constexpr int THREADS = NWG * 128;
  static constexpr int STAGE = 2 * Q_BYTES + 1024;   // Q, dO, the pairs
  static constexpr size_t SMEM = 1024 + 2 * K_BYTES + NST * STAGE + Ring<NST>::BYTES;
};

template <int HD>
__global__ void __launch_bounds__(DkvCfg<HD>::THREADS, 1)
    dense_attn_bwd_dkv_wg_kernel(const __grid_constant__ CUtensorMap map_k,
                                 const __grid_constant__ CUtensorMap map_v,
                                 const __grid_constant__ CUtensorMap map_q,
                                 const __grid_constant__ CUtensorMap map_do,
                                 const float2* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
                                 __nv_bfloat16* __restrict__ dv, int M, int M_pad, int N, int H,
                                 float scale) {
  using X = Box<HD>;
  using Cfg = DkvCfg<HD>;
  constexpr int QT = Cfg::QT, NST = Cfg::NST, KROWS = Cfg::KROWS, NBX = Cfg::NBX;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  const uint32_t sK = smem_u32(base), sV = sK + Cfg::K_BYTES, sSt = sV + Cfg::K_BYTES;
  const Ring<NST> ring(sSt + NST * Cfg::STAGE);
  const unsigned char* stages = base + 2 * Cfg::K_BYTES;

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int n0 = blockIdx.x * KROWS, h = blockIdx.y, b = blockIdx.z, nh = gridDim.y;
  const int ntiles = (M + QT - 1) / QT;
  if (t == 0) ring.init(4 * Cfg::NWG);
  __syncthreads();

  // tile `it` of Q and dO and its rows' pairs (M_pad is a multiple of QT:
  // the copy never leaves the sample's rows) into its stage
  auto fill = [&](int it) {
    const int s = it % NST;
    const uint32_t sQs = sSt + s * Cfg::STAGE, bar = ring.full + 8 * s;
    mbar_arrive_expect_tx(bar, 2 * Cfg::Q_BYTES + Cfg::ST_BYTES);
    load_tile<HD>(sQs, QT, &map_q, bar, h, it * QT, b);
    load_tile<HD>(sQs + Cfg::Q_BYTES, QT, &map_do, bar, h, it * QT, b);
    bulk_load(sQs + 2 * Cfg::Q_BYTES, stats + ((size_t)b * nh + h) * M_pad + it * QT,
              Cfg::ST_BYTES, bar);
  };
  if (t == 0) {
    mbar_arrive_expect_tx(ring.first, 2 * Cfg::K_BYTES);
    load_tile<HD>(sK, KROWS, &map_k, ring.first, h, n0, b);
    load_tile<HD>(sV, KROWS, &map_v, ring.first, h, n0, b);
    for (int it = 0; it < NST && it < ntiles; ++it) fill(it);
  }

  // warpgroup `wg` owns key rows `krow0 + ..` and boxes `box0 + ..` of dK and
  // dV; this thread rows `row` and `row + 8`
  const int wg = warp / 4, g = lane / 4, c = lane % 4;
  const int krow0 = Cfg::SPLIT ? 0 : 64 * wg, box0 = Cfg::SPLIT ? NBX * wg : 0;
  const int row = n0 + krow0 + 16 * (warp % 4) + g;
  const uint32_t sKw = sK + krow0 * X::RB, sVw = sV + krow0 * X::RB;
  const float scale_log2 = scale * LOG2E;
  float acc_dk[NBX][X::C / 2], acc_dv[NBX][X::C / 2];
#pragma unroll
  for (int i = 0; i < NBX; ++i)
#pragma unroll
    for (int j = 0; j < X::C / 2; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.0f;

  mbar_wait(ring.first, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % NST;
    const uint32_t sQs = sSt + s * Cfg::STAGE, sOs = sQs + Cfg::Q_BYTES;
    const float4* pairs =
        reinterpret_cast<const float4*>(stages + s * Cfg::STAGE + 2 * Cfg::Q_BYTES);
    mbar_wait(ring.full + 8 * s, (it / NST) & 1);

    float st[QT / 2], dpt[QT / 2];  // S^T and dP^T: rows are keys, columns queries
    wgmma_fence();
    mma_abt<HD>(st, sKw, KROWS * X::RB, sQs, QT * X::RB);
    mma_abt<HD>(dpt, sVw, KROWS * X::RB, sOs, QT * X::RB);
    wgmma_commit();
    wgmma_wait<0>();
    pin(st);
    pin(dpt);

    // a query row past M is a zero row of Q and dO with the pair (+inf, 0): P = dS = 0
    uint32_t pt[QT / 4], dst[QT / 4];
#pragma unroll
    for (int i = 0; i < QT / 4; ++i) {
      const float4 ld = pairs[4 * (i / 2) + c];  // (lse, delta) of columns 8 (i / 2) + 2 c, + 1
      const float p0 = ex2(fmaf(st[2 * i], scale_log2, -ld.x));
      const float p1 = ex2(fmaf(st[2 * i + 1], scale_log2, -ld.z));
      pt[i] = pack_bf16(p0, p1);
      dst[i] = pack_bf16(p0 * (dpt[2 * i] - ld.y) * scale, p1 * (dpt[2 * i + 1] - ld.w) * scale);
    }
    wgmma_fence();
    mma_ab<HD, NBX>(acc_dv, pt, sOs + box0 * QT * X::RB, QT * X::RB);
    mma_ab<HD, NBX>(acc_dk, dst, sQs + box0 * QT * X::RB, QT * X::RB);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NBX; ++i) {
      pin(acc_dv[i]);
      pin(acc_dk[i]);
    }
    pin(pt);
    pin(dst);
    if (lane == 0) mbar_arrive(ring.empty + 8 * s);
    if (t == 0 && it + NST < ntiles) {
      mbar_wait(ring.empty + 8 * s, (it / NST) & 1);
      fill(it + NST);
    }
  }
  const float one[2] = {1.0f, 1.0f};
  store_rows<HD, NBX>(dv + (size_t)b * N * H, acc_dv, one, row, N, H, h * HD + box0 * X::C, c);
  store_rows<HD, NBX>(dk + (size_t)b * N * H, acc_dk, one, row, N, H, h * HD + box0 * X::C, c);
}

template <int HD>
cudaError_t launch_dense_attn_bwd_wg(const void* q, const void* k, const void* v, const void* out,
                                     const void* dout, const void* lse, void* dq, void* dk,
                                     void* dv, void* stats, int B, int M, int N, int H, int nh,
                                     float scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  using A = DqCfg<HD>;
  using C = DkvCfg<HD>;
  const int M_pad = stats_rows(M);
  cudaError_t err = launch_stats<bf>(out, dout, lse, stats, LOG2E, B, M, H, nh, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mo, mk, mv;
  if (!make_map<HD>(&mq, q, B, M, H, A::ROWS) || !make_map<HD>(&mo, dout, B, M, H, A::ROWS) ||
      !make_map<HD>(&mk, k, B, N, H, A::KT) || !make_map<HD>(&mv, v, B, N, H, A::KT))
    return cudaErrorInvalidValue;
  auto dq_kernel = dense_attn_bwd_dq_wg_kernel<HD>;
  if ((err = allow_smem(dq_kernel, A::SMEM)) != cudaSuccess) return err;
  dq_kernel<<<dim3((M + A::ROWS - 1) / A::ROWS, nh, B), A::THREADS, A::SMEM, stream>>>(
      mq, mo, mk, mv, (const float2*)stats, (bf*)dq, M, M_pad, N, H, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (!make_map<HD>(&mk, k, B, N, H, C::KROWS) || !make_map<HD>(&mv, v, B, N, H, C::KROWS) ||
      !make_map<HD>(&mq, q, B, M, H, C::QT) || !make_map<HD>(&mo, dout, B, M, H, C::QT))
    return cudaErrorInvalidValue;
  auto dkv_kernel = dense_attn_bwd_dkv_wg_kernel<HD>;
  if ((err = allow_smem(dkv_kernel, C::SMEM)) != cudaSuccess) return err;
  dkv_kernel<<<dim3((N + C::KROWS - 1) / C::KROWS, nh, B), C::THREADS, C::SMEM, stream>>>(
      mk, mv, mq, mo, (const float2*)stats, (bf*)dk, (bf*)dv, M, M_pad, N, H, scale);
  return cudaGetLastError();
}

}  // namespace poem

using namespace poem;

static bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

static bool wg_head_dim(int hd) {
  return hd == 16 || hd == 32 || hd == 64 || hd == 128 || hd == 256;
}

// The shapes each dtype takes: float32 head dims 16..256 in steps of 16;
// bfloat16 head dims 16, 32, 64, 128 or 256 on 16-byte aligned tensors.
static bool shapes_ok(int dtype, int M, int N, int H, int nh,
                      std::initializer_list<const void*> ptrs) {
  if (nh < 1 || H % nh != 0 || M < 1 || N < 1) return false;
  const int hd = H / nh;
  if (dtype == DTYPE_F32) return hd >= 16 && hd <= CA_MAX_HD && hd % 16 == 0;
  if (dtype == DTYPE_BF16) return wg_head_dim(hd) && aligned16(ptrs);
  return false;
}

// q (B, M, H), k and v (B, N, H), out (B, M, H); heads are H / nh wide.
// lse (B, nh, M) float32 receives the row logsumexp unless it is null.
// float32 runs the FMA kernel, bfloat16 the wgmma kernel, which takes a
// positive scale only (as the TPU kernel, which folds it into the exponent).
extern "C" int poem_dense_cross_attention(int dtype, const void* q, const void* k, const void* v,
                                          void* out, void* lse, int B, int M, int N, int H, int nh,
                                          float scale, void* stream) {
  if (!shapes_ok(dtype, M, N, H, nh, {q, k, v, out})) return (int)cudaErrorInvalidValue;
  const int hd = H / nh;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return (int)launch_dense_attn(q, k, v, out, lse, B, M, N, H, nh, scale, s);
  if (!(scale > 0.0f)) return (int)cudaErrorInvalidValue;  // the running max is of raw logits
#define POEM_FWD_WG(HD) launch_dense_attn_wg<HD>(q, k, v, out, lse, B, M, N, H, nh, scale, s)
  return (int)(hd == 16 ? POEM_FWD_WG(16) : hd == 32 ? POEM_FWD_WG(32)
               : hd == 64 ? POEM_FWD_WG(64) : hd == 128 ? POEM_FWD_WG(128)
                                             : POEM_FWD_WG(256));
#undef POEM_FWD_WG
}

// Gradients of poem_dense_cross_attention from its inputs, its output `out`
// and logsumexp `lse` and the cotangent `dout`: dq (B, M, H), dk and dv
// (B, N, H) in the input dtype; stats is float32 scratch for (B, nh, M rounded
// up to a multiple of 128) pairs (lse, delta).
// float32 runs the FMA kernels, bfloat16 the wgmma kernels.
extern "C" int poem_dense_cross_attention_bwd(int dtype, const void* q, const void* k,
                                              const void* v, const void* out, const void* dout,
                                              const void* lse, void* dq, void* dk, void* dv,
                                              void* stats, int B, int M, int N, int H, int nh,
                                              float scale, void* stream) {
  if (!shapes_ok(dtype, M, N, H, nh, {q, k, v, out, dout, dq, dk, dv}))
    return (int)cudaErrorInvalidValue;
  const int hd = H / nh;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return (int)launch_dense_attn_bwd(q, k, v, out, dout, lse, dq, dk, dv, stats, B, M, N, H, nh,
                                      scale, s);
#define POEM_BWD_WG(HD)                                                                        \
  launch_dense_attn_bwd_wg<HD>(q, k, v, out, dout, lse, dq, dk, dv, stats, B, M, N, H, nh, scale, s)
  return (int)(hd == 16 ? POEM_BWD_WG(16) : hd == 32 ? POEM_BWD_WG(32)
               : hd == 64 ? POEM_BWD_WG(64) : hd == 128 ? POEM_BWD_WG(128)
                                             : POEM_BWD_WG(256));
#undef POEM_BWD_WG
}
