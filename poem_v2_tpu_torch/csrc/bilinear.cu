// Bilinear sampling of feature maps at points (the BPS sampler).
//
// Replaces the Pallas TPU kernel
//   poem_v2_tpu/ops/pallas_bilinear.py:grid_sample_points_fused (K4)
// with the semantics of F.grid_sample(bilinear, align_corners=False,
// padding_mode="zeros") on a flat point list: out[b, n, c] blends the four
// taps around ix = ((x + 1) W - 1) / 2, iy = ((y + 1) H - 1) / 2; taps
// outside the map contribute 0.
//
// What bounds it on the H100: memory. Each point reads four C-element
// rows of the map and writes one, with eight flops per channel. At the
// serving shape (B * 8 maps of 16 x 16 x 256, 4096 points each) a map is
// 128 KB in bf16 and stays in L2, so it is bound by L2 traffic.
//
// Design: one warp per (map, point); lanes stride over the channels so
// every tap row is read coalesced. Tap weights are exact float32 (the TPU
// kernel rounds them to bf16; the port follows the JAX package's
// grid_sample_points_matmul, which does not) and the index math uses
// __fmul_rn / __fadd_rn so it rounds as the plain version does.
#include "common.cuh"

namespace poem {

constexpr int BS_WARPS = 8;

template <typename T>
__global__ void grid_sample_kernel(const T* __restrict__ feat, const float* __restrict__ coords,
                                   T* __restrict__ out, int H, int W, int C, int N) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * BS_WARPS + warp;
  const int b = blockIdx.y;
  if (n >= N) return;
  const float x = coords[((size_t)b * N + n) * 2];
  const float y = coords[((size_t)b * N + n) * 2 + 1];
  const float ix = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(x, 1.0f), (float)W), 1.0f), 0.5f);
  const float iy = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(y, 1.0f), (float)H), 1.0f), 0.5f);
  const float x0 = floorf(ix), y0 = floorf(iy);
  const float fx = __fsub_rn(ix, x0), fy = __fsub_rn(iy, y0);

  // tap order (dx, dy) = (0,0), (0,1), (1,0), (1,1), as the plain version sums
  float wt[4];
  int off[4];
#pragma unroll
  for (int tp = 0; tp < 4; ++tp) {
    const int dx = tp / 2, dy = tp % 2;
    const float px = x0 + dx, py = y0 + dy;
    const float wx = dx ? fx : __fsub_rn(1.0f, fx);
    const float wy = dy ? fy : __fsub_rn(1.0f, fy);
    const bool inside = px >= 0.f && px <= W - 1 && py >= 0.f && py <= H - 1;
    wt[tp] = inside ? __fmul_rn(wx, wy) : 0.0f;
    off[tp] = inside ? ((int)py * W + (int)px) * C : 0;
  }
  const T* f = feat + (size_t)b * H * W * C;
  T* o = out + ((size_t)b * N + n) * C;
  for (int c = lane; c < C; c += 32) {
    float acc = 0.0f;
#pragma unroll
    for (int tp = 0; tp < 4; ++tp) acc = __fadd_rn(acc, __fmul_rn(wt[tp], to_f32(f[off[tp] + c])));
    o[c] = from_f32<T>(acc);
  }
}

}  // namespace poem

using namespace poem;

// feat (B, H, W, C), coords (B, N, 2) float32 in [-1, 1] (x over W, y over H), out (B, N, C).
extern "C" int poem_grid_sample_points(int dtype, const void* feat, const void* coords, void* out,
                                       int B, int H, int W, int C, int N, void* stream) {
  dim3 grid((N + BS_WARPS - 1) / BS_WARPS, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    grid_sample_kernel<float><<<grid, BS_WARPS * 32, 0, s>>>(
        (const float*)feat, (const float*)coords, (float*)out, H, W, C, N);
  else if (dtype == DTYPE_BF16)
    grid_sample_kernel<__nv_bfloat16><<<grid, BS_WARPS * 32, 0, s>>>(
        (const __nv_bfloat16*)feat, (const float*)coords, (__nv_bfloat16*)out, H, W, C, N);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
