// Bilinear sampling of feature maps at points (the BPS sampler).
//
// Replaces the Pallas TPU kernel
//   poem_v2_tpu/ops/pallas_bilinear.py:grid_sample_points_fused (K4)
// with the semantics of F.grid_sample(bilinear, align_corners=False,
// padding_mode="zeros") on a flat point list: out[b, n, c] blends the four
// taps around ix = ((x + 1) W - 1) / 2, iy = ((y + 1) H - 1) / 2; taps
// outside the map contribute 0.
//
// What bounds it on the H100: memory. Each point reads four C-element rows
// of its map and writes one, with eight flops per channel; the maps are
// small (16 x 16 x C at the serving shapes, 128 KB in bf16 at C 256) and the
// output is written once: 67 MB at B 4, C 256 in bf16, 0.0216 ms at 3.35 TB/s.
// Read straight from L2 the taps would be four times the output's bytes.
//
// Design:
// * A block takes one map, one channel slice of it and one chunk of its
//   points. It stages the slice (H x W cells x slice_units 16-byte units,
//   64 KB at the serving shapes) into shared memory with `cp.async`, and
//   meanwhile builds the tap table (four float32 weights and four cells) of
//   its first BS_SUB points. Every tap is then a 16-byte shared-memory read;
//   each map crosses L2 once a block, not four times an output element.
// * A lane holds one 16-byte unit: 8 bf16 or 4 float32 channels. `tx` lanes
//   (a power of two up to 32) cover a point's slice, so at C 256 in bf16 a
//   warp serves two points with one 16-byte store each. A C whose rows are
//   not whole units (or a map that is not 16-byte aligned) takes the same
//   kernel with one-element units (U = 1).
// * A map whose slice of one unit a cell cannot fit in shared memory (H W
//   16 bytes above 227 KB; no model makes one) takes the DIRECT instance:
//   the same tables, taps read from device memory, 16 bytes a lane.
// * The output is stored evict-first (`__stcs`): the next op reads it once;
//   on the H100 that beat plain stores by 4-8% at C 256 to 1024.
// * Launch geometry (unit, slice width, chunk, tx, direct) is chosen in
//   ops/bilinear.py:sampler_geometry, where the CPU tests reach it.
// * Per channel, the arithmetic is the plain version's: exact float32 tap
//   weights (the TPU kernel rounds them to bf16; the port follows the JAX
//   package's grid_sample_points_matmul, which does not), the taps summed in
//   the order (0,0), (0,1), (1,0), (1,1), each multiply and add rounded
//   alone (`__fmul_rn` / `__fadd_rn`): bit-identical to
//   ops/bilinear.py:plain_grid_sample_points.
#include "common.cuh"

namespace poem {

constexpr int BS_THREADS = 256;
constexpr int BS_SUB = 256;   // points whose tap table a block holds at once
constexpr int BS_TABLE_BYTES = BS_SUB * (16 + 16);

// U values of T: one 16-byte access (U = 16 / sizeof(T)) or one element (U = 1)
template <typename T, int U> struct Unit;
template <> struct Unit<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};
template <> struct Unit<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> float32 is exact: the bits move up
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // round to nearest even, as from_f32
      __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
};
template <typename T> struct Unit<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float (&v)[1]) { v[0] = to_f32(*p); }
  static __device__ __forceinline__ void store(T* p, const float (&v)[1]) { *p = from_f32<T>(v[0]); }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The tap table of point n: weights in tap order (dx, dy) = (0,0), (0,1),
// (1,0), (1,1) and their cells (y W + x); a tap outside the map has weight 0
// and cell 0, as the plain version has.
__device__ __forceinline__ void tap_table(const float* coords, int n, int H, int W, float4* wt,
                                          int4* cell) {
  const float x = coords[2 * (size_t)n], y = coords[2 * (size_t)n + 1];
  const float ix = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(x, 1.0f), (float)W), 1.0f), 0.5f);
  const float iy = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(y, 1.0f), (float)H), 1.0f), 0.5f);
  const float x0 = floorf(ix), y0 = floorf(iy);
  const float fx = __fsub_rn(ix, x0), fy = __fsub_rn(iy, y0);
  float w[4];
  int c[4];
#pragma unroll
  for (int tp = 0; tp < 4; ++tp) {
    const int dx = tp / 2, dy = tp % 2;
    const float px = x0 + dx, py = y0 + dy;
    const float wx = dx ? fx : __fsub_rn(1.0f, fx);
    const float wy = dy ? fy : __fsub_rn(1.0f, fy);
    const bool inside = px >= 0.f && px <= W - 1 && py >= 0.f && py <= H - 1;
    w[tp] = inside ? __fmul_rn(wx, wy) : 0.0f;
    c[tp] = inside ? (int)py * W + (int)px : 0;
  }
  *wt = make_float4(w[0], w[1], w[2], w[3]);
  *cell = make_int4(c[0], c[1], c[2], c[3]);
}

// grid (point chunks, channel slices, maps); BS_THREADS threads as (tx units) x
// (BS_THREADS / tx points)
template <typename T, int U, bool DIRECT>
__global__ void __launch_bounds__(BS_THREADS)
    grid_sample_slices_kernel(const T* __restrict__ feat, const float* __restrict__ coords,
                              T* __restrict__ out, int H, int W, int C, int N, int slice_units,
                              int chunk_points, int tx) {
  extern __shared__ __align__(16) unsigned char bs_smem[];
  float4* wts = reinterpret_cast<float4*>(bs_smem);            // [BS_SUB]
  int4* cells = reinterpret_cast<int4*>(wts + BS_SUB);         // [BS_SUB]
  T* slice = reinterpret_cast<T*>(cells + BS_SUB);             // [H W][su][U]
  const int b = blockIdx.z;
  const int u0 = blockIdx.y * slice_units;                     // first unit of the slice
  const int su = min(slice_units, C / U - u0);                 // units of this slice
  const int n0 = blockIdx.x * chunk_points;
  const int n1 = min(N, n0 + chunk_points);
  const int tu = threadIdx.x % tx, tp = threadIdx.x / tx, ty = BS_THREADS / tx;
  const T* fmap = feat + (size_t)b * H * W * C + (size_t)u0 * U;
  const float* pts = coords + (size_t)b * N * 2;
  T* orow = out + (size_t)b * N * C + (size_t)u0 * U;

  if (!DIRECT) {  // the slice: cell-major, su units a cell
    for (int cl = tp; cl < H * W; cl += ty)
      for (int u = tu; u < su; u += tx) {
        const T* src = fmap + (size_t)cl * C + u * U;
        T* dst = slice + ((size_t)cl * su + u) * U;
        if constexpr (U * sizeof(T) == 16) cp_async16(dst, src);
        else *dst = *src;
      }
  }
  const T* taps = DIRECT ? fmap : slice;
  const size_t cell_stride = DIRECT ? (size_t)C : (size_t)su * U;

  for (int s0 = n0; s0 < n1; s0 += BS_SUB) {
    const int sn = min(BS_SUB, n1 - s0);
    if (s0 != n0) __syncthreads();  // the last sub-chunk's readers of the table are done
    if (threadIdx.x < sn) tap_table(pts, s0 + threadIdx.x, H, W, wts + threadIdx.x,
                                    cells + threadIdx.x);
    if constexpr (!DIRECT && U * sizeof(T) == 16) if (s0 == n0) cp_async_wait_all();
    __syncthreads();
    for (int p = tp; p < sn; p += ty) {
      const float4 w4 = wts[p];
      const int4 c4 = cells[p];
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
      const size_t off[4] = {c4.x * cell_stride, c4.y * cell_stride, c4.z * cell_stride,
                             c4.w * cell_stride};
      T* o = orow + (size_t)(s0 + p) * C;
      for (int u = tu; u < su; u += tx) {
        float acc[U];
#pragma unroll
        for (int e = 0; e < U; ++e) acc[e] = 0.0f;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          float v[U];
          Unit<T, U>::load(taps + off[t] + u * U, v);
#pragma unroll
          for (int e = 0; e < U; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(w[t], v[e]));
        }
        Unit<T, U>::store(o + u * U, acc);
      }
    }
  }
}

template <typename T, int U, bool DIRECT>
cudaError_t launch_sampler(const void* feat, const void* coords, void* out, int B, int H, int W,
                           int C, int N, int slice_units, int chunk_points, int tx, size_t smem,
                           cudaStream_t s) {
  auto kernel = grid_sample_slices_kernel<T, U, DIRECT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int slices = (C / U + slice_units - 1) / slice_units;
  const dim3 grid((N + chunk_points - 1) / chunk_points, slices, B);
  kernel<<<grid, BS_THREADS, smem, s>>>((const T*)feat, (const float*)coords, (T*)out, H, W, C,
                                        N, slice_units, chunk_points, tx);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t dispatch_sampler(bool vec, bool direct, const void* feat, const void* coords,
                             void* out, int B, int H, int W, int C, int N, int slice_units,
                             int chunk_points, int tx, size_t smem, cudaStream_t s) {
  auto launch = vec ? (direct ? launch_sampler<T, V, true> : launch_sampler<T, V, false>)
                    : (direct ? launch_sampler<T, 1, true> : launch_sampler<T, 1, false>);
  return launch(feat, coords, out, B, H, W, C, N, slice_units, chunk_points, tx, smem, s);
}

}  // namespace poem

using namespace poem;

// feat (B, H, W, C), coords (B, N, 2) float32 in [-1, 1] (x over W, y over H),
// out (B, N, C), all contiguous. The launch geometry comes from
// ops/bilinear.py:sampler_geometry: `unit` elements an access (16 bytes'
// worth, or 1), `slice_units` units a channel slice, `chunk_points` points a
// block, `tx` lanes a point, `direct` (taps from device memory).
extern "C" int poem_grid_sample_points(int dtype, const void* feat, const void* coords, void* out,
                                       int B, int H, int W, int C, int N, int unit,
                                       int slice_units, int chunk_points, int tx, int direct,
                                       void* stream) {
  if (dtype != DTYPE_F32 && dtype != DTYPE_BF16) return (int)cudaErrorInvalidValue;
  const int esz = dtype == DTYPE_F32 ? 4 : 2;
  const int vec = 16 / esz;
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 1 || N < 1 || (unit != 1 && unit != vec) ||
      C % unit || slice_units < 1 || chunk_points < 1 || tx < 1 || tx > 32 || (tx & (tx - 1)))
    return (int)cudaErrorInvalidValue;
  const int units = C / unit;
  if ((units + slice_units - 1) / slice_units > 65535) return (int)cudaErrorInvalidValue;
  if (unit == vec && (((uintptr_t)feat | (uintptr_t)out) & 15)) return (int)cudaErrorInvalidValue;
  const size_t smem = BS_TABLE_BYTES +
      (direct ? 0 : (size_t)H * W * min(slice_units, units) * unit * esz);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return (int)dispatch_sampler<float, 4>(unit == vec, direct, feat, coords, out, B, H, W, C, N,
                                           slice_units, chunk_points, tx, smem, s);
  return (int)dispatch_sampler<__nv_bfloat16, 8>(unit == vec, direct, feat, coords, out, B, H, W,
                                                 C, N, slice_units, chunk_points, tx, smem, s);
}
