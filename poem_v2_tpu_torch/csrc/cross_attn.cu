// Dense multi-head cross-attention, forward.
//
// Replaces the Pallas TPU kernel
//   poem_v2_tpu/ops/pallas_cross_attn.py:dense_cross_attention (K3, forward)
// which computes, per head h, softmax(q_h k_h^T * scale) v_h with no mask.
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
// Head dims from 32 to 256 in steps of 16 are accepted. Scalar FMA only:
// tensor cores (wgmma) and TMA are later work.
#include "common.cuh"

namespace poem {

constexpr int CA_BQ = 16;
constexpr int CA_BK = 64;
constexpr int CA_THREADS = 256;
constexpr int CA_MAX_HD = 256;

template <typename T>
__global__ void __launch_bounds__(CA_THREADS)
    dense_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ out, int M, int N, int H, int hd, float scale) {
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
    Qs[e] = to_f32(q[((size_t)b * M + m) * H + hoff + c]);
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
      Ks[r * ks + c] = to_f32(k[g]);
      Vs[r * hd + c] = to_f32(v[g]);
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
      if (i < n_out) out[((size_t)b * M + m) * H + hoff + lane16 + 16 * i] = from_f32<T>(o[i] * inv);
    }
  }
}

template <typename T>
cudaError_t launch_dense_attn(const void* q, const void* k, const void* v, void* out, int B,
                              int M, int N, int H, int nh, float scale, cudaStream_t stream) {
  const int hd = H / nh;
  auto kernel = dense_attn_kernel<T>;
  const size_t smem =
      sizeof(float) * ((size_t)CA_BQ * hd + CA_BK * (hd + 1) + CA_BK * hd + CA_BQ * CA_BK);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((M + CA_BQ - 1) / CA_BQ, nh, B);
  kernel<<<grid, CA_THREADS, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)out, M,
                                             N, H, hd, scale);
  return cudaGetLastError();
}

}  // namespace poem

using namespace poem;

// q (B, M, H), k and v (B, N, H), out (B, M, H); heads are H / nh wide.
extern "C" int poem_dense_cross_attention(int dtype, const void* q, const void* k, const void* v,
                                          void* out, int B, int M, int N, int H, int nh,
                                          float scale, void* stream) {
  if (nh < 1 || H % nh != 0) return (int)cudaErrorInvalidValue;
  const int hd = H / nh;
  if (hd < 32 || hd > CA_MAX_HD || hd % 16 != 0 || M < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == DTYPE_F32)
    err = launch_dense_attn<float>(q, k, v, out, B, M, N, H, nh, scale, s);
  else if (dtype == DTYPE_BF16)
    err = launch_dense_attn<__nv_bfloat16>(q, k, v, out, B, M, N, H, nh, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
