// Design variants of the neighbour selection of K1 (`poem_v2_tpu_torch/csrc/
// select_core.cuh`), timed on one card: how many warps a row, how many least
// keys a lane keeps, how many rows a block, and a warp-wide filter that skips
// keys above a running bound on the K-th. Every variant's indices are held
// against the first one's (the shipped design's are held against the plain
// version by scripts/torch_check_knn_select.py). Synthetic rows: B 4, 799
// queries against 4096 and 799 points, K 32 and 48, CUDA events over 50
// launches.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -I poem_v2_tpu_torch/csrc scripts/torch_select_variants.cu -o tmp/select_variants
//   tmp/select_variants
#include <cstdio>
#include <vector>
#include <random>
#include <cstring>
#include "common.cuh"
#include "select_core.cuh"
using namespace poem;

template <int ID, int CNT> __device__ __forceinline__ void cbar() { asm volatile("bar.sync %0, %1;" ::"n"(ID), "n"(CNT) : "memory"); }
template <int CNT> __device__ __forceinline__ void bar_const(int g) {
  switch (g) { case 0: cbar<1, CNT>(); break; case 1: cbar<2, CNT>(); break; case 2: cbar<3, CNT>(); break; default: cbar<4, CNT>(); break; }
}
__device__ __forceinline__ void bar_var(int id, int cnt) { asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(cnt) : "memory"); }

template <typename Key, int D> __device__ __forceinline__ void insD(Key (&b)[D], Key v) {
#pragma unroll
  for (int i = D - 1; i > 0; --i) b[i] = kmax(b[i - 1], kmin(b[i], v));
  b[0] = kmin(b[0], v);
}

// W warps a row; T = 32 W threads; CB: constant barrier ids
template <typename Key, int D, int W, bool CB>
__device__ __forceinline__ void rowsel(const float4* pts, int N, SelQuery q, int K, Key* red, int& parity, int g, int* out) {
  constexpr int T = 32 * W;
  const Key none = key_none<Key>();
  const int t = threadIdx.x % T;
  Key b[D];
#pragma unroll
  for (int i = 0; i < D; ++i) b[i] = none;
#pragma unroll 4
  for (int j = t; j < N; j += T) { const float4 p = pts[j]; insD<Key, D>(b, make_key<Key>(q.d2(p.x, p.y, p.z, p.w), j)); }
  int left = D;
  Key thr = none;
  for (int r = 0; r < K; ++r) {
    Key v = warp_min(b[0]);
    if (W > 1) {
      Key* slot = red + parity * 4;
      if (threadIdx.x % 32 == 0) slot[(threadIdx.x / 32) % W] = v;
      if (CB) bar_const<32 * W>(g); else bar_var(1 + g, 32 * W);
      parity ^= 1;
      v = slot[0];
#pragma unroll
      for (int w = 1; w < W; ++w) v = kmin(v, slot[w]);
    }
    thr = v;
    if (b[0] == thr) {
      out[r] = key_column(thr);
#pragma unroll
      for (int i = 0; i < D - 1; ++i) b[i] = b[i + 1];
      b[D - 1] = none;
      --left;
    }
    const bool refill = left == 0 && r + 1 < K;
    if (__any_sync(0xFFFFFFFFu, refill) && refill) {
#pragma unroll
      for (int i = 0; i < D; ++i) b[i] = none;
      for (int j = t; j < N; j += T) { const float4 p = pts[j]; const Key k = make_key<Key>(q.d2(p.x, p.y, p.z, p.w), j); insD<Key, D>(b, k > thr ? k : none); }
      left = D;
    }
  }
}

template <typename Key, int D, int W, int ROWS, bool CB>  // ROWS rows at a time a block
__global__ void __launch_bounds__(ROWS * 32 * W) kern(const float* qxyz, const float* ptxyz, int* idx, int M, int N, int K, int qpb) {
  extern __shared__ float4 pts[];
  __shared__ Key red[ROWS][8];
  const int b = blockIdx.y, g = threadIdx.x / (32 * W);
  const float* p = ptxyz + (size_t)b * N * 3;
  for (int j = threadIdx.x; j < N; j += blockDim.x) { const float x = p[3*j], y = p[3*j+1], z = p[3*j+2]; pts[j] = make_float4(x, y, z, sq3(x, y, z)); }
  __syncthreads();
  int parity = 0;
  const int m0 = (int)blockIdx.x * qpb, m_end = min(M, m0 + qpb);
  for (int m = m0 + g; m < m_end; m += ROWS) {
    const SelQuery q(qxyz + ((size_t)b * M + m) * 3);
    rowsel<Key, D, W, CB>(pts, N, q, K, red[g], parity, g, idx + ((size_t)b * M + m) * K);
  }
}

template <typename Key, int D, int W, int ROWS, bool CB>
void run_shape(const char* name, const float* q, const float* p, int* idx, int B, int M, int N, int K, int qpb, const int* ref, std::vector<int>& host) {
  auto k = kern<Key, D, W, ROWS, CB>;
  size_t smem = (size_t)N * 16;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int occ = 0; cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, ROWS * 32 * W, smem);
  dim3 grid((M + qpb - 1) / qpb, B);
  cudaEvent_t a, e; cudaEventCreate(&a); cudaEventCreate(&e);
  for (int i = 0; i < 3; ++i) k<<<grid, ROWS * 32 * W, smem>>>(q, p, idx, M, N, K, qpb);
  cudaEventRecord(a);
  const int it = 50;
  for (int i = 0; i < it; ++i) k<<<grid, ROWS * 32 * W, smem>>>(q, p, idx, M, N, K, qpb);
  cudaEventRecord(e); cudaEventSynchronize(e);
  float ms; cudaEventElapsedTime(&ms, a, e);
  cudaError_t err = cudaGetLastError();
  host.resize((size_t)B * M * K);
  cudaMemcpy(host.data(), idx, host.size() * 4, cudaMemcpyDeviceToHost);
  bool same = ref == nullptr || memcmp(ref, host.data(), host.size() * 4) == 0;
  printf("  %-34s N%-5d blocks %5d x %4d thr, %d/SM: %.4f ms %s %s\n", name, N, grid.x * grid.y, ROWS * 32 * W, occ, ms / it, same ? "same" : "DIFFERENT", err ? cudaGetErrorString(err) : "");
}

static void variants() {
  const int B = 4, M = 799, K = 32;
  std::mt19937 rng(0); std::normal_distribution<float> nd;
  for (int N : {4096, 799}) {
    std::vector<float> hq((size_t)B * M * 3), hp((size_t)B * N * 3);
    for (auto& v : hq) v = nd(rng) * 0.4f;
    for (auto& v : hp) v = nd(rng) * 0.5f;
    float *q, *p; int* idx;
    cudaMalloc(&q, hq.size() * 4); cudaMalloc(&p, hp.size() * 4); cudaMalloc(&idx, (size_t)B * M * K * 4);
    cudaMemcpy(q, hq.data(), hq.size() * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(p, hp.data(), hp.size() * 4, cudaMemcpyHostToDevice);
    std::vector<int> ref, h;
    run_shape<uint32_t, 4, 4, 4, false>("W4 D4 4 groups qpb8 runtime bar id", q, p, idx, B, M, N, K, 8, nullptr, ref);
    run_shape<uint32_t, 4, 4, 4, true>("W4 D4 4 groups qpb8 const-bar", q, p, idx, B, M, N, K, 8, ref.data(), h);
    run_shape<uint32_t, 4, 4, 4, true>("W4 D4 4 groups qpb4 const-bar", q, p, idx, B, M, N, K, 4, ref.data(), h);
    run_shape<uint32_t, 4, 4, 2, true>("W4 D4 2 groups qpb4 const-bar", q, p, idx, B, M, N, K, 4, ref.data(), h);
    run_shape<uint32_t, 4, 2, 4, true>("W2 D4 4 rows qpb8 const-bar", q, p, idx, B, M, N, K, 8, ref.data(), h);
    run_shape<uint32_t, 6, 2, 4, true>("W2 D6 4 rows qpb8 const-bar", q, p, idx, B, M, N, K, 8, ref.data(), h);
    run_shape<uint32_t, 4, 1, 8, false>("W1 D4 8 rows qpb8", q, p, idx, B, M, N, K, 8, ref.data(), h);
    run_shape<uint32_t, 6, 1, 8, false>("W1 D6 8 rows qpb8", q, p, idx, B, M, N, K, 8, ref.data(), h);
    run_shape<uint32_t, 8, 1, 8, false>("W1 D8 8 rows qpb8", q, p, idx, B, M, N, K, 8, ref.data(), h);
    run_shape<uint32_t, 6, 1, 8, false>("W1 D6 8 rows qpb16", q, p, idx, B, M, N, K, 16, ref.data(), h);
    run_shape<uint32_t, 6, 1, 16, false>("W1 D6 16 rows qpb16", q, p, idx, B, M, N, K, 16, ref.data(), h);
    run_shape<uint32_t, 6, 1, 4, false>("W1 D6 4 rows qpb4", q, p, idx, B, M, N, K, 4, ref.data(), h);
    run_shape<uint32_t, 6, 1, 8, false>("W1 D6 8 rows qpb24", q, p, idx, B, M, N, K, 24, ref.data(), h);
    run_shape<key64_t, 4, 4, 4, true>("u64 W4 D4 4 groups qpb8 const-bar", q, p, idx, B, M, N, K, 8, nullptr, ref);
    run_shape<key64_t, 6, 1, 8, false>("u64 W1 D6 8 rows qpb8", q, p, idx, B, M, N, K, 8, ref.data(), h);
    run_shape<key64_t, 6, 2, 4, true>("u64 W2 D6 4 rows qpb8", q, p, idx, B, M, N, K, 8, ref.data(), h);
    cudaFree(q); cudaFree(p); cudaFree(idx);
  }
}

__device__ __forceinline__ uint32_t warp_max(uint32_t v) { return __reduce_max_sync(0xFFFFFFFFu, v); }
__device__ __forceinline__ key64_t warp_max(key64_t v) {
  const uint32_t hi = __reduce_max_sync(0xFFFFFFFFu, (uint32_t)(v >> 32));
  const uint32_t lo = __reduce_max_sync(0xFFFFFFFFu, (uint32_t)(v >> 32) == hi ? (uint32_t)v : 0u);
  return ((key64_t)hi << 32) | lo;
}

// FILTER: skip keys above T, the warp's max of the lanes' r-th least (r = (K-1)/32)
template <typename Key, bool FILTER, int REFRESH>
__device__ __forceinline__ void rowsel_filter(const float4* pts, int N, SelQuery q, int K, int* out) {
  const Key none = key_none<Key>();
  const int lane = threadIdx.x % 32;
  Key b[SC_DEPTH];
#pragma unroll
  for (int i = 0; i < SC_DEPTH; ++i) b[i] = none;
  const int r = (K - 1) / 32;
  Key T = none;
  int step = 0;
  for (int j0 = 0; j0 < N; j0 += 32) {
    const int j = j0 + lane;
    Key key = none;
    if (j < N) { const float4 p = pts[j]; key = make_key<Key>(q.d2(p.x, p.y, p.z, p.w), j); }
    if (FILTER) {
      if (__any_sync(0xFFFFFFFFu, key <= T)) insert_sorted(b, key <= T ? key : none);
      if (++step % REFRESH == 0 && r < SC_DEPTH) T = warp_max(b[r]);
    } else {
      insert_sorted(b, key);
    }
  }
  int left = SC_DEPTH;
  Key thr = none;
  for (int rr = 0; rr < K; ++rr) {
    thr = warp_min(b[0]);
    if (b[0] == thr) {
      out[rr] = key_column(thr);
#pragma unroll
      for (int i = 0; i < SC_DEPTH - 1; ++i) b[i] = b[i + 1];
      b[SC_DEPTH - 1] = none;
      --left;
    }
    const bool refill = left == 0 && rr + 1 < K;
    if (__any_sync(0xFFFFFFFFu, refill) && refill) {
#pragma unroll
      for (int i = 0; i < SC_DEPTH; ++i) b[i] = none;
      for (int j = lane; j < N; j += 32) { const float4 p = pts[j]; const Key k = make_key<Key>(q.d2(p.x, p.y, p.z, p.w), j); insert_sorted(b, k > thr ? k : none); }
      left = SC_DEPTH;
    }
  }
}

template <typename Key, bool FILTER, int REFRESH>
__global__ void __launch_bounds__(512) kern_filter(const float* qxyz, const float* ptxyz, int* idx, int M, int N, int K, int qpb) {
  extern __shared__ float4 pts[];
  const int b = blockIdx.y, w = threadIdx.x / 32;
  const float* p = ptxyz + (size_t)b * N * 3;
  for (int j = threadIdx.x; j < N; j += blockDim.x) { const float x = p[3*j], y = p[3*j+1], z = p[3*j+2]; pts[j] = make_float4(x, y, z, sq3(x, y, z)); }
  __syncthreads();
  const int m = (int)blockIdx.x * qpb + w;
  if (m < M) rowsel_filter<Key, FILTER, REFRESH>(pts, N, SelQuery(qxyz + ((size_t)b * M + m) * 3), K, idx + ((size_t)b * M + m) * K);
}

template <typename Key, bool FILTER, int REFRESH>
void run_filter(const char* name, const float* q, const float* p, int* idx, int B, int M, int N, int K, const int* ref, std::vector<int>& host) {
  auto k = kern_filter<Key, FILTER, REFRESH>;
  size_t smem = (size_t)N * 16;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int qpb = rows_per_block(B, M, smem);  // the shipped design's rows a block
  dim3 grid((M + qpb - 1) / qpb, B);
  cudaEvent_t a, e; cudaEventCreate(&a); cudaEventCreate(&e);
  for (int i = 0; i < 3; ++i) k<<<grid, qpb * 32, smem>>>(q, p, idx, M, N, K, qpb);
  cudaEventRecord(a);
  const int it = 50;
  for (int i = 0; i < it; ++i) k<<<grid, qpb * 32, smem>>>(q, p, idx, M, N, K, qpb);
  cudaEventRecord(e); cudaEventSynchronize(e);
  float ms; cudaEventElapsedTime(&ms, a, e);
  cudaError_t err = cudaGetLastError();
  host.resize((size_t)B * M * K);
  cudaMemcpy(host.data(), idx, host.size() * 4, cudaMemcpyDeviceToHost);
  bool same = ref == nullptr || memcmp(ref, host.data(), host.size() * 4) == 0;
  printf("  %-28s N%-5d K%-3d qpb %2d blocks %4d: %.4f ms %s %s\n", name, N, K, qpb, grid.x * grid.y, ms / it, same ? "same" : "DIFFERENT", err ? cudaGetErrorString(err) : "");
}

static void filters() {
  const int B = 4, M = 799;
  std::mt19937 rng(0); std::normal_distribution<float> nd;
  for (int N : {4096, 799}) for (int K : {32, 48}) {
    std::vector<float> hq((size_t)B * M * 3), hp((size_t)B * N * 3);
    for (auto& v : hq) v = nd(rng) * 0.4f;
    for (auto& v : hp) v = nd(rng) * 0.5f;
    float *q, *p; int* idx;
    cudaMalloc(&q, hq.size() * 4); cudaMalloc(&p, hp.size() * 4); cudaMalloc(&idx, (size_t)B * M * K * 4);
    cudaMemcpy(q, hq.data(), hq.size() * 4, cudaMemcpyHostToDevice);
    cudaMemcpy(p, hp.data(), hp.size() * 4, cudaMemcpyHostToDevice);
    std::vector<int> ref, h;
    run_filter<uint32_t, false, 8>("u32 no filter", q, p, idx, B, M, N, K, nullptr, ref);
    run_filter<uint32_t, true, 4>("u32 filter refresh 4", q, p, idx, B, M, N, K, ref.data(), h);
    run_filter<uint32_t, true, 8>("u32 filter refresh 8", q, p, idx, B, M, N, K, ref.data(), h);
    run_filter<uint32_t, true, 16>("u32 filter refresh 16", q, p, idx, B, M, N, K, ref.data(), h);
    run_filter<key64_t, false, 8>("u64 no filter", q, p, idx, B, M, N, K, nullptr, ref);
    run_filter<key64_t, true, 4>("u64 filter refresh 4", q, p, idx, B, M, N, K, ref.data(), h);
    run_filter<key64_t, true, 8>("u64 filter refresh 8", q, p, idx, B, M, N, K, ref.data(), h);
    cudaFree(q); cudaFree(p); cudaFree(idx);
  }
}

int main() {
  printf("warps a row (W), least keys a lane (D), rows a block, K 32:\n");
  variants();
  printf("one warp a row, six keys a lane, with and without the filter:\n");
  filters();
  return 0;
}
