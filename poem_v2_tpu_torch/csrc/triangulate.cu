// The masked DLT triangulation of the reference joints, in one launch.
//
// Bound in ops/_lib.py and wrapped by ops/triangulate.py:triangulate_dlt_c2m.
//
// Replaces the plain PyTorch chain on the card
//   poem_v2_tpu_torch/geometry/triangulation.py:triangulate_dlt (after
//   geometry/camera.py:invert_rigid)
// whose TPU counterpart is the jnp chain
//   poem_v2_tpu/geometry/triangulation.py:triangulate_dlt (no Pallas kernel).
//
// One thread solves one (sample b, joint j) system in registers: it inverts
// each view's camera->master transform (R^T, -R^T t), forms P = K [R^T | -R^T t],
// accumulates the 4x4 normal matrix A^T A over the 2V rows (u P_2 - P_0,
// v P_2 - P_1, times the view's mask), runs the fixed cyclic Jacobi of
// jacobi_eigh_4x4 (6 sweeps of the pairs (0,1) (0,2) (0,3) (1,2) (1,3) (2,3),
// no early exit), takes the eigenvector of the first least eigenvalue (as
// torch.argmin) and writes x[:3] / (x[3] + eps).
//
// The arithmetic is the plain chain's, one rounded float32 operation at a
// time: products and sums through __fmul_rn / __fadd_rn / __fsub_rn (no
// fused multiply-add), IEEE square roots and divisions, 1 / x as PyTorch's
// reciprocal, the sums over 3 terms in order from zero, and A^T A's sum over
// its 2V rows as PyTorch's reduction forms it on the card: four accumulators,
// row r into accumulator r % 4, then ((acc0 + acc1) + acc2) + acc3. On an H100
// with PyTorch 2.11 its points equal the plain chain's there bit for bit.
//
// What bounds it on the H100: latency. At most a few hundred systems of
// ~4,450 float32 operations each at 8 views (156 a view, 88 a rotation), one
// dependent chain a thread; the host's launch is the cost this kernel takes
// away (the plain chain is ~2,100 launches).
#include "common.cuh"

namespace poem {

constexpr int TRI_THREADS = 32;  // one warp a block: the few warps spread over the SMs
// w's guard in x[:3] / (x[3] + eps): geometry/triangulation.py:DLT_EPS
constexpr float DLT_EPS = 1e-7f;

struct TriArgs {  // every array contiguous
  const float* kp;    // (B, V, J, 2) pixels
  const float* intr;  // (B, V, 3, 3)
  const float* extr;  // (B, V, 4, 4) camera->master
  const bool* mask;   // (B, V)
  float* out;         // (B, J, 3)
  int B, V, J;
};

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }

// ((0 + a0 b0) + a1 b1) + a2 b2, each product rounded
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2, float b2) {
  return fadd(fadd(fadd(0.0f, fmul(a0, b0)), fmul(a1, b1)), fmul(a2, b2));
}

// the two rows of one view into accumulators lo (row 2v) and hi (row 2v + 1);
// the ten products of the upper triangle (A^T A is symmetric bit for bit)
__device__ __forceinline__ void add_rows(const TriArgs& g, int b, int v, int j, float* lo,
                                         float* hi) {
  const long long bv = (long long)b * g.V + v;
  const float* K = g.intr + bv * 9;
  const float* E = g.extr + bv * 16;
  float k[3][3], r[3][3], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      k[i][c] = K[i * 3 + c];
      r[i][c] = E[i * 4 + c];
    }
    t[i] = E[i * 4 + 3];
  }
  // master->camera: P = [R^T | -R^T t]
  float p[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) p[i][c] = r[c][i];
    p[i][3] = -dot3(r[0][i], t[0], r[1][i], t[1], r[2][i], t[2]);
  }
  float m[3][4];  // K P
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      m[i][c] = dot3(k[i][0], p[0][c], k[i][1], p[1][c], k[i][2], p[2][c]);
  const float* uv = g.kp + (bv * g.J + j) * 2;
  const float u = uv[0], w = uv[1];
  float a0[4], a1[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    a0[c] = fsub(fmul(u, m[2][c]), m[0][c]);
    a1[c] = fsub(fmul(w, m[2][c]), m[1][c]);
  }
  const float mv = g.mask[bv] ? 1.0f : 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    a0[c] = fmul(a0[c], mv);
    a1[c] = fmul(a1[c], mv);
  }
  int e = 0;
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = x; y < 4; ++y, ++e) {
      lo[e] = fadd(lo[e], fmul(a0[x], a0[y]));
      hi[e] = fadd(hi[e], fmul(a1[x], a1[y]));
    }
}

// one Jacobi rotation of the pair (p, q), as jacobi_eigh_4x4 forms it: rows of
// a, then columns of a, then columns of v
template <int p, int q>
__device__ __forceinline__ void rotate(float (&a)[4][4], float (&v)[4][4]) {
  const float app = a[p][p], aqq = a[q][q], apq = a[p][q];
  const bool small =
      fabsf(apq) <= fmul(1e-30f, fadd(fadd(fabsf(app), fabsf(aqq)), 1e-30f));
  const float tau = __fdiv_rn(fsub(aqq, app), small ? 1.0f : fmul(2.0f, apq));
  const float sgn = tau >= 0.0f ? 1.0f : -1.0f;
  float t = __fdiv_rn(sgn, fadd(fabsf(tau), __fsqrt_rn(fadd(1.0f, fmul(tau, tau)))));
  if (small) t = 0.0f;
  const float c = __fdiv_rn(1.0f, __fsqrt_rn(fadd(1.0f, fmul(t, t))));
  const float s = fmul(t, c);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float rp = a[p][k], rq = a[q][k];
    a[p][k] = fsub(fmul(c, rp), fmul(s, rq));
    a[q][k] = fadd(fmul(s, rp), fmul(c, rq));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float cp = a[k][p], cq = a[k][q];
    a[k][p] = fsub(fmul(c, cp), fmul(s, cq));
    a[k][q] = fadd(fmul(s, cp), fmul(c, cq));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float vp = v[k][p], vq = v[k][q];
    v[k][p] = fsub(fmul(c, vp), fmul(s, vq));
    v[k][q] = fadd(fmul(s, vp), fmul(c, vq));
  }
}

__global__ void __launch_bounds__(TRI_THREADS) triangulate_dlt_kernel(const TriArgs g) {
  const int idx = blockIdx.x * TRI_THREADS + threadIdx.x;
  if (idx >= g.B * g.J) return;
  const int b = idx / g.J, j = idx - b * g.J;

  float acc[4][10];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 10; ++e) acc[i][e] = 0.0f;
  // view v holds rows 2v, 2v + 1: accumulators 0, 1 for even v, 2, 3 for odd v
  int v = 0;
  for (; v + 1 < g.V; v += 2) {
    add_rows(g, b, v, j, acc[0], acc[1]);
    add_rows(g, b, v + 1, j, acc[2], acc[3]);
  }
  if (v < g.V) add_rows(g, b, v, j, acc[0], acc[1]);

  float a[4][4], vec[4][4];
  int e = 0;
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = x; y < 4; ++y, ++e) {
      a[x][y] = a[y][x] = fadd(fadd(fadd(acc[0][e], acc[1][e]), acc[2][e]), acc[3][e]);
    }
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) vec[x][y] = x == y ? 1.0f : 0.0f;

#pragma unroll 1
  for (int sweep = 0; sweep < 6; ++sweep) {
    rotate<0, 1>(a, vec);
    rotate<0, 2>(a, vec);
    rotate<0, 3>(a, vec);
    rotate<1, 2>(a, vec);
    rotate<1, 3>(a, vec);
    rotate<2, 3>(a, vec);
  }

  // torch.argmin: the first least eigenvalue, a NaN before any number
  int sel = 0;
  float best = a[0][0];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const float x = a[k][k];
    if (isnan(x) ? !isnan(best) : x < best) {
      sel = k;
      best = x;
    }
  }
  float x[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    x[k] = sel == 0 ? vec[k][0] : sel == 1 ? vec[k][1] : sel == 2 ? vec[k][2] : vec[k][3];
  const float den = fadd(x[3], DLT_EPS);
  float* o = g.out + (long long)idx * 3;
  o[0] = __fdiv_rn(x[0], den);
  o[1] = __fdiv_rn(x[1], den);
  o[2] = __fdiv_rn(x[2], den);
}

}  // namespace poem

using namespace poem;

// kp (B, V, J, 2), intr (B, V, 3, 3), extr (B, V, 4, 4) camera->master, out
// (B, J, 3): float32; mask (B, V) bool; all contiguous.
extern "C" int poem_triangulate_dlt(const void* kp, const void* intr, const void* extr,
                                    const void* mask, void* out, int B, int V, int J,
                                    void* stream) {
  if (B < 1 || V < 0 || J < 1 || (long long)B * J > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  TriArgs g;
  g.kp = (const float*)kp;
  g.intr = (const float*)intr;
  g.extr = (const float*)extr;
  g.mask = (const bool*)mask;
  g.out = (float*)out;
  g.B = B;
  g.V = V;
  g.J = J;
  const int blocks = (B * J + TRI_THREADS - 1) / TRI_THREADS;
  triangulate_dlt_kernel<<<blocks, TRI_THREADS, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}
