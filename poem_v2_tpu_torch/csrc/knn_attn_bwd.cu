// Backward of the trainable exact-KNN vector attention (K6b).
//
// Replaces the backward of the Pallas TPU kernel
//   poem_v2_tpu/ops/pallas_knn_attn.py:knn_vector_attention_trainable
//   (`_trainable_bwd`: jax.vjp of `_attention_from_idx` at the forward's
//   saved neighbour indices, whose feature gather scatters back by K7)
// with the backward written out. Per (query m, neighbour j) row, kv = x_full
// [Wk | Wv] projected once per cloud point as K1 does:
//   forward, rerun:  t1 = relu(delta W1 + b1)   pos = t1 W2 + b2
//                    x  = q[m] - k + pos        vp  = v + pos
//                    h  = relu(x G0 + c0)       g   = (h G1 + c1) s
//                    a  = softmax_j(g)          o[m] = sum_j a vp
//   backward:        dvp = a dout[m]            dg  = dvp (vp - o[m]) s
//                    da  = (dg G1^T) [h > 0]    dx  = da G0^T
//                    dq[m] = sum_j dx           dpos = dx + dvp
//                    dt1 = (dpos W2^T) [t1 > 0] ddelta = dt1 W1^T
//                    dquery_xyz[m] = sum_j ddelta
// The softmax backward needs no second reduction: sum_j a dout vp = dout o.
// The rows [-dx | dvp | -ddelta] are then scattered to the cloud points by K7
// (one launch, float32), where the wrapper projects them (dx_full = S [Wk |
// Wv]^T, dWk, dWv: N rows instead of M K) and forms the weight gradients as
// products of the row buffers written here (ops/knn_attn.py).
//
// What bounds it on the H100: D x D products, 2 D^2 operations each, six a row
// in these kernels (three of the forward's rerun, three of the backward) and
// three more a row for the weight gradients (cuBLAS, in the wrapper), against
// row buffers of a few bytes a channel: arithmetic-bound at every width (D 128
// to 1024), so in bfloat16 every product here is `wgmma`.
//
// Design. The rows are those of the forward chain (RowMap, knn_core.cuh):
// tiles of 128 rows, floor(128 / K) whole queries a tile, K > 128 over
// ceil(K / 128) tiles. One templated product kernel (`knn_bwd_gemm_kernel`)
// computes a 128-row by 128-column tile of A W (the forward's products, W
// stored (in, out): B MN-major, as `core_gemm_kernel` takes it) or of A W^T
// (the backward's: B K-major, the layout `wgmma` takes without the transpose
// bit), and lands it as float32 in a [128][136] tile in shared memory (over
// the spent ring in bfloat16: two blocks an SM, one block's epilogue beside the
// other's products). Every epilogue reads that tile, so the bfloat16 product
// (TMA ring of 3 stages refilled within a tile, `wgmma`, as in the forward
// chain) and the float32 one (scalar FMA through shared memory, for the float32
// parity checks) share the epilogues:
//   KB_KV   kv = x_full [Wk | Wv]                -> float32 (B, N, 2D)
//   KB_POS  pos = t1 W2 + b2; x = q - k + pos     -> x (T), vp = v + pos (float32)
//   KB_H    h = relu(x G0 + c0)                   -> h (T)
//   KB_SMB  g, the softmax, o and a per column and query (a block holds
//           whole queries: one tile, or a query's tiles in two sweeps, the
//           first for the running max / sum / o) -> dg (T), dvp into S
//   KB_DA   da = (dg G1^T) [h > 0]                -> da (T)
//   KB_DX   dx = da G0^T                          -> dpos (T), -dx into S, and
//           dq per query summed down the tile's rows in order (a query's
//           tiles in order when K > 128)
//   KB_DT1  dt1 = (dpos W2^T) [t1 > 0]            -> dt1 (T), and the ddelta
//           row-dot over the block's 128 channels (a warp a row, a fixed
//           shuffle tree) as one partial per column block
// KB_SMB, KB_DA, KB_DX and KB_DT1 also sum their tile's dg, da, dpos or dt1 down
// each column (the bias gradients, after a sum over the tiles in the wrapper).
// `knn_bwd_t1_kernel` writes t1 (the forward's arithmetic and rounding), the
// rows' delta and their cloud index (-1 on spare rows, which K7 drops);
// `knn_bwd_delta_kernel` adds the column blocks' ddelta partials in order,
// writes -ddelta into S and sums dquery_xyz per query (a warp a query).
// Spare rows (RowMap::at false) hold exact zeros in every gradient buffer.
// No reduction uses atomics: two launches give the same bits.
// The chain needs D a multiple of 128 (the wrapper pads with zero channels)
// and 16-byte aligned tensors.
#include <cuda.h>

#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "knn_core.cuh"

namespace poem {

constexpr int KB_NS = 128;       // output columns a block
constexpr int KB_THREADS = 256;  // two warpgroups
constexpr int KB_WARPS = KB_THREADS / 32;
constexpr int KB_GS = KB_NS + 8;  // row stride of the product tile (floats)
constexpr int KB_NST = 3;         // ring stages (bfloat16)
constexpr int KB_FK = 32;         // reduced columns a step (float32)
enum { KB_KV = 0, KB_POS, KB_H, KB_SMB, KB_DA, KB_DX, KB_DT1 };

// Shared memory: what the product needs; the [128][KB_GS] float32 tile G and
// the column-sum scratch CS ([8][128] float32). In bfloat16 a block holds one
// tile at a time and its ring is spent when G is written, so G and CS overlay
// the ring: 97 KB, two blocks an SM, one block's epilogue beside the other's
// products (the bias sums and the tile in their own memory put one block on
// an SM). Float32 (parity only) keeps them apart.
constexpr int KB_G_BYTES = CR * KB_GS * 4, KB_CS_BYTES = KB_WARPS * KB_NS * 4;
template <typename T> struct KbCfg;
template <> struct KbCfg<__nv_bfloat16> {
  static constexpr int A_BYTES = CR * CK * 2;       // [128 rows][64] bf16
  static constexpr int B_BYTES = CK * KB_NS * 2;    // two [64][64] bf16 boxes
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RING = KB_NST * STAGE;
  static constexpr int G_OFF = 0, CS_OFF = KB_G_BYTES;
  static constexpr size_t SMEM = 1024 + RING + 128;  // the ring, its barriers
  static constexpr int BLOCKS_PER_SM = 2;
  static_assert(CS_OFF + KB_CS_BYTES <= RING, "G and CS overlay the ring");
};
template <> struct KbCfg<float> {
  static constexpr int AS = KB_FK + 1, BS = KB_NS + 4;  // row strides (floats)
  static constexpr int G_OFF = (CR * AS + KB_FK * BS) * 4, CS_OFF = G_OFF + KB_G_BYTES;
  static constexpr size_t SMEM = 1024 + CS_OFF + KB_CS_BYTES;
  static constexpr int BLOCKS_PER_SM = 1;
};

// what the passes read and write; T = float or bfloat16, "f32" always float32
struct KbArgs {
  const void* q;       // (B, M, D) T
  const void* dout;    // (B, M, D) T
  const int* idx;      // (B, M, K) cloud index of each neighbour
  const float* qxyz;   // (B, M, 3)
  const float* cxyz;   // (B, N, 3)
  const void* w1;      // (3, D) T
  const void* b1;      // (D) T
  const void* bias;    // the pass's bias (D) T: b2, c0 or c1
  float* kv;           // (B, N, 2D) f32 projected cloud
  void* t1;            // (rows, D) T, and x, h, dg, da, dpos, dt1 alike
  void* x;
  void* h;
  float* vp;           // (rows, D) f32 v + pos
  void* dg;
  void* da;
  void* dpos;
  void* dt1;
  float* s;            // (rows, 2D + 4) f32 scatter rows [-dx | dvp | -ddelta | 0]
  float* dq;           // (B, M, D) f32
  float* bsum;         // the pass's (D, row tiles) f32 column sums of dg, da, dpos or dt1
  float* ddp;          // (D / 128, rows, 4) f32 ddelta partials of each column block
  void* delta;         // (rows, 4) T: each row's delta (0 on spare rows), then a 0
  int* ridx;           // (rows) cloud index of each row, -1 on a spare row
  float* dqxyz;        // (B, M, 3) f32
  long long n_rows;    // rows of the pass's A: B N for KB_KV, else B tiles 128
  int B, M, N, D, K;
  float scale;         // 1 / sqrt of the unpadded width
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(hop::pack_bf16(v.x, v.y), hop::pack_bf16(v.z, v.w));
}
// v where the flag holds, else 0
__device__ __forceinline__ float4 mask4(float4 v, bool x, bool y, bool z, bool w) {
  return make_float4(x ? v.x : 0.0f, y ? v.y : 0.0f, z ? v.z : 0.0f, w ? v.w : 0.0f);
}

// fill ring stage it % KB_NST with A's rows [row0, row0 + 128) x reduced
// columns of chunk it % nk, and W's matching [64][128]: MN-major boxes (W
// stored (reduced, out)) or K-major (BT: W stored (out, reduced))
template <bool BT>
__device__ __forceinline__ void kb_fill(const CUtensorMap* ma, const CUtensorMap* mb,
                                        uint32_t s_ring, uint32_t bar_full, int it, int nk,
                                        long long row0, int n0) {
  using C = KbCfg<__nv_bfloat16>;
  const int s = it % KB_NST, kc = it % nk;
  const uint32_t sa = s_ring + s * C::STAGE, sb = sa + C::A_BYTES, bar = bar_full + 8 * s;
  hop::mbar_arrive_expect_tx(bar, C::STAGE);
  hop::tma_load_2d(sa, ma, bar, kc * CK, (int)row0);
#pragma unroll
  for (int j = 0; j < KB_NS / 64; ++j) {
    if (BT)
      hop::tma_load_2d(sb + j * 8192, mb, bar, kc * CK, n0 + 64 * j);
    else
      hop::tma_load_2d(sb + j * 8192, mb, bar, n0 + 64 * j, kc * CK);
  }
}

// One pass of the chain: blockIdx.x picks 128 output columns, blockIdx.y a
// row tile, or for KB_SMB / KB_DX a group (a tile of whole queries, or the
// tiles of one query when K > 128). a_ptr / w_ptr / ldw serve the float32
// product, map_a / map_b the bfloat16 one.
template <typename T, int EPI, bool BT>
__global__ void __launch_bounds__(KB_THREADS, KbCfg<T>::BLOCKS_PER_SM)
    knn_bwd_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b, const T* __restrict__ a_ptr,
                        const T* __restrict__ w_ptr, int ldw, const KbArgs args, int k_in,
                        RowMap rm) {
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  constexpr bool GROUPED = EPI == KB_SMB || EPI == KB_DX;
  // the bias gradients: column sums of the tile's dg, da, dpos or dt1
  constexpr bool BSUM = EPI == KB_SMB || EPI == KB_DA || EPI == KB_DX || EPI == KB_DT1;
  using C = KbCfg<T>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  float* G = reinterpret_cast<float*>(base + C::G_OFF);
  float* CS = reinterpret_cast<float*>(base + C::CS_OFF);

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int n0 = blockIdx.x * KB_NS;
  const int D = args.D, SW = 2 * D + 4;
  const int nt = GROUPED ? rm.T : 1;  // tiles of the block
  const int groups = rm.K <= CR ? rm.tiles : rm.M;
  const int gb = GROUPED ? (int)(blockIdx.y / groups) : 0;
  const int grp = GROUPED ? (int)(blockIdx.y % groups) : 0;
  // the softmax backward of a query spread over tiles needs its max, sum and
  // o before any row's gradient: a first sweep over its tiles finds them
  const int sweeps = EPI == KB_SMB && nt > 1 ? 2 : 1;
  auto row0_of = [&](int tt) -> long long {
    if (!GROUPED) return (long long)blockIdx.y * CR;
    return ((long long)gb * rm.tiles + (long long)grp * nt + tt) * CR;
  };
  const int nk = k_in / (BF ? CK : KB_FK);

  uint32_t s_ring = 0, bar_full = 0, bar_empty = 0;
  if constexpr (BF) {
    s_ring = hop::smem_u32(base);
    bar_full = s_ring + C::RING;
    bar_empty = bar_full + 8 * KB_NST;
    if (t == 0) {
      for (int s = 0; s < KB_NST; ++s) {
        hop::mbar_init(bar_full + 8 * s, 1);
        hop::mbar_init(bar_empty + 8 * s, KB_WARPS);
      }
      hop::mbar_init_fence();
    }
    __syncthreads();
  }

  const T* q = static_cast<const T*>(args.q);
  const T* bias = static_cast<const T*>(args.bias);
  // running per-column state across a query's tiles (K > 128): the
  // softmax's max, sum and o (KB_SMB), dq (KB_DX)
  float run_mx = -INFINITY, run_s = 0.0f, run_o = 0.0f;

  for (int p = 0; p < sweeps * nt; ++p) {
    const int tt = p % nt, sweep = p / nt;
    const long long row0 = row0_of(tt);

    // ---- the product tile -> G ----
    if constexpr (BF) {
      const int wg = warp / 4, g = lane / 4, c = lane % 4;
      // the ring is refilled within the tile only: G overlays it between tiles
      if (t == 0) {
        // the previous tile's epilogue wrote G and CS through the generic proxy
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        for (int kc = 0; kc < KB_NST && kc < nk; ++kc)
          kb_fill<BT>(&map_a, &map_b, s_ring, bar_full, p * nk + kc, nk, row0, n0);
      }
      auto release = [&](int it) {
        const int s = it % KB_NST;
        if (lane == 0) hop::mbar_arrive(bar_empty + 8 * s);
        if (t == 0 && it % nk + KB_NST < nk) {
          hop::mbar_wait(bar_empty + 8 * s, (it / KB_NST) & 1);
          kb_fill<BT>(&map_a, &map_b, s_ring, bar_full, it + KB_NST, nk, row0, n0);
        }
      };
      float acc[KB_NS / 64][32];
      for (int kc = 0; kc < nk; ++kc) {
        const int it = p * nk + kc, s = it % KB_NST;
        const uint32_t sa = s_ring + s * C::STAGE + wg * 64 * 128;
        const uint32_t sb = s_ring + s * C::STAGE + C::A_BYTES;
        hop::mbar_wait(bar_full + 8 * s, (it / KB_NST) & 1);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < CK / 16; ++kk) {
          const uint64_t da = hop::mma_desc(sa + kk * 32, 16, 1024, 1);
#pragma unroll
          for (int j = 0; j < KB_NS / 64; ++j) {
            if (BT)
              hop::wgmma_ss(acc[j], da, hop::mma_desc(sb + j * 8192 + kk * 32, 16, 1024, 1),
                            (kc | kk) != 0);
            else
              hop::wgmma_ss_mn(acc[j], da,
                               hop::mma_desc(sb + j * 8192 + kk * 2048, 8192, 1024, 1),
                               (kc | kk) != 0);
          }
        }
        hop::wgmma_commit();
        hop::wgmma_wait<1>();  // the previous chunk's products are done: give its stage back
        if (kc > 0) release(it - 1);
      }
      hop::wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < KB_NS / 64; ++j) hop::pin(acc[j]);
      release(p * nk + nk - 1);
      __syncthreads();  // both warpgroups' products are done: G may overwrite the ring
      // accumulator register 4 jj + 2 h + e: row rl + 8 h, column 64 j + 8 jj + 2 c + e
      const int rl = 64 * wg + 16 * (warp % 4) + g;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < KB_NS / 64; ++j)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            *reinterpret_cast<float2*>(G + (rl + 8 * h) * KB_GS + 64 * j + 8 * jj + 2 * c) =
                make_float2(acc[j][4 * jj + 2 * h], acc[j][4 * jj + 2 * h + 1]);
    } else {
      // 8 x 8 outputs a thread: rows tr + 16 i, columns tc + 16 j
      float* As = reinterpret_cast<float*>(base);
      float* Bs = As + CR * C::AS;
      const int tr = t / 16, tc = t % 16;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      for (int k0 = 0; k0 < k_in; k0 += KB_FK) {
        for (int e = t; e < CR * KB_FK; e += KB_THREADS) {
          const int r = e / KB_FK, kk = e % KB_FK;
          const long long row = row0 + r;
          As[r * C::AS + kk] = row < args.n_rows ? a_ptr[row * k_in + k0 + kk] : 0.0f;
        }
        for (int e = t; e < KB_FK * KB_NS; e += KB_THREADS) {
          if (BT) {
            const int nn = e / KB_FK, kk = e % KB_FK;
            Bs[kk * C::BS + nn] = w_ptr[(size_t)(n0 + nn) * ldw + k0 + kk];
          } else {
            const int kk = e / KB_NS, nn = e % KB_NS;
            Bs[kk * C::BS + nn] = w_ptr[(size_t)(k0 + kk) * ldw + n0 + nn];
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < KB_FK; ++kk) {
          float a[8], b[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = As[(tr + 16 * i) * C::AS + kk];
#pragma unroll
          for (int j = 0; j < 8; ++j) b[j] = Bs[kk * C::BS + tc + 16 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) G[(tr + 16 * i) * KB_GS + tc + 16 * j] = acc[i][j];
    }
    __syncthreads();

    // ---- elementwise epilogues: a warp a row, 4 columns a lane ----
    if constexpr (EPI != KB_SMB) {
      float4 cs = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // the lane's column sums (BSUM)
      auto add = [&](float4 v) {
        cs = make_float4(cs.x + v.x, cs.y + v.y, cs.z + v.z, cs.w + v.w);
      };
      for (int r = warp; r < CR; r += KB_WARPS) {
        const long long row = row0 + r;
        const int cl = 4 * lane, col = n0 + cl;
        const float4 v = *reinterpret_cast<const float4*>(G + r * KB_GS + cl);
        if constexpr (EPI == KB_KV) {
          if (row < args.n_rows) st4(args.kv + row * 2 * D + col, v);
        } else {
          int b, m, j;
          const bool valid = rm.at(row, b, m, j);
          const size_t at = (size_t)row * D + col;
          if constexpr (EPI == KB_POS) {
            const float4 bb = ld4(bias + col);
            const float4 ps = make_float4(v.x + bb.x, v.y + bb.y, v.z + bb.z, v.w + bb.w);
            const int src = args.idx[((size_t)b * args.M + m) * args.K + j];
            const float* kf = args.kv + ((size_t)b * args.N + src) * 2 * D;
            const float4 k4 = ld4(kf + col), v4 = ld4(kf + D + col);
            const float4 q4 = ld4(q + ((size_t)b * args.M + m) * D + col);
            st4(static_cast<T*>(args.x) + at,
                make_float4(q4.x - k4.x + ps.x, q4.y - k4.y + ps.y, q4.z - k4.z + ps.z,
                            q4.w - k4.w + ps.w));
            st4(args.vp + at, make_float4(v4.x + ps.x, v4.y + ps.y, v4.z + ps.z, v4.w + ps.w));
          } else if constexpr (EPI == KB_H) {
            const float4 bb = ld4(bias + col);
            st4(static_cast<T*>(args.h) + at,
                make_float4(fmaxf(v.x + bb.x, 0.0f), fmaxf(v.y + bb.y, 0.0f),
                            fmaxf(v.z + bb.z, 0.0f), fmaxf(v.w + bb.w, 0.0f)));
          } else if constexpr (EPI == KB_DA) {
            const float4 hv = ld4(static_cast<const T*>(args.h) + at);
            const float4 da = mask4(v, valid && hv.x > 0.0f, valid && hv.y > 0.0f,
                                    valid && hv.z > 0.0f, valid && hv.w > 0.0f);
            st4(static_cast<T*>(args.da) + at, da);
            add(da);
          } else if constexpr (EPI == KB_DX) {
            const float4 dx = mask4(v, valid, valid, valid, valid);
            float* sr = args.s + (size_t)row * SW;
            const float4 dvp = ld4(sr + D + col);
            const float4 dpos = make_float4(dx.x + dvp.x, dx.y + dvp.y, dx.z + dvp.z, dx.w + dvp.w);
            st4(static_cast<T*>(args.dpos) + at, dpos);
            st4(sr + col, make_float4(-dx.x, -dx.y, -dx.z, -dx.w));
            add(dpos);
          } else if constexpr (EPI == KB_DT1) {
            const float4 tv = ld4(static_cast<const T*>(args.t1) + at);
            const float4 dt = mask4(v, valid && tv.x > 0.0f, valid && tv.y > 0.0f,
                                    valid && tv.z > 0.0f, valid && tv.w > 0.0f);
            st4(static_cast<T*>(args.dt1) + at, dt);
            add(dt);
            // this block's share of ddelta = dt1 W1^T: 4 channels a lane, then a
            // fixed shuffle tree over the warp's 128
            const T* w1 = static_cast<const T*>(args.w1);
            float part[3];
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              const float4 w = ld4(w1 + (size_t)a * D + col);
              part[a] = fmaf(dt.w, w.w, fmaf(dt.z, w.z, fmaf(dt.y, w.y, dt.x * w.x)));
#pragma unroll
              for (int off = 16; off > 0; off >>= 1)
                part[a] += __shfl_xor_sync(0xFFFFFFFFu, part[a], off);
            }
            if (lane == 0)
              st4(args.ddp + ((size_t)blockIdx.x * args.n_rows + row) * 4,
                  make_float4(part[0], part[1], part[2], 0.0f));
          }
        }
      }
      if constexpr (BSUM) *reinterpret_cast<float4*>(CS + warp * KB_NS + 4 * lane) = cs;
    }

    // ---- down the columns: a thread a column, two slots of queries ----
    const int ct = t % KB_NS, slot = t / KB_NS, col = n0 + ct;
    if constexpr (EPI == KB_SMB) {
      const T* dout = static_cast<const T*>(args.dout);
      T* dg = static_cast<T*>(args.dg);
      const float cb = to_f32(bias[col]);
      auto gval = [&](int i) { return (G[i * KB_GS + ct] + cb) * args.scale; };
      auto vpv = [&](long long row) { return args.vp[(size_t)row * D + col]; };
      float csum = 0.0f;  // the thread's share of its column's sum of dg
      auto put = [&](long long row, float dgv, float dvp) {
        dg[(size_t)row * D + col] = from_f32<T>(dgv);
        args.s[(size_t)row * SW + D + col] = dvp;
        csum += dgv;
      };
      if (rm.K <= CR) {
        for (int qi = slot; qi < rm.QB; qi += 2) {
          const int m = grp * rm.QB + qi, i0 = qi * rm.K;
          if (m >= rm.M) {
            for (int i = 0; i < rm.K; ++i) put(row0 + i0 + i, 0.0f, 0.0f);
            continue;
          }
          const float dov = to_f32(dout[((size_t)gb * rm.M + m) * D + col]);
          float mx = -INFINITY;
          for (int i = 0; i < rm.K; ++i) mx = fmaxf(mx, gval(i0 + i));
          // unrolled so that several rows' v + pos loads are in flight; each
          // row's exp is kept in G (this thread's column) for the last walk
          float s = 0.0f, o = 0.0f;
#pragma unroll 8
          for (int i = 0; i < rm.K; ++i) {
            const float e = expf(gval(i0 + i) - mx);
            G[(i0 + i) * KB_GS + ct] = e;
            s += e;
            o = fmaf(e, vpv(row0 + i0 + i), o);
          }
          o /= s;
#pragma unroll 8
          for (int i = 0; i < rm.K; ++i) {
            const long long row = row0 + i0 + i;
            const float dvp = G[(i0 + i) * KB_GS + ct] / s * dov;
            put(row, dvp * (vpv(row) - o) * args.scale, dvp);
          }
        }
        for (int i = rm.QB * rm.K + slot; i < CR; i += 2) put(row0 + i, 0.0f, 0.0f);
      } else {
        const int n = min(CR, rm.K - tt * CR);
        if (sweep == 0) {  // both slots fold every row: the same state in each
          float cm = run_mx;
          for (int i = 0; i < n; ++i) cm = fmaxf(cm, gval(i));
          const float rescale = expf(run_mx - cm);
          run_s *= rescale;
          run_o *= rescale;
          for (int i = 0; i < n; ++i) {
            const float e = expf(gval(i) - cm);
            run_s += e;
            run_o = fmaf(e, vpv(row0 + i), run_o);
          }
          run_mx = cm;
        } else {
          const float o = run_o / run_s;
          const float dov = to_f32(dout[((size_t)gb * rm.M + grp) * D + col]);
          for (int i = slot; i < CR; i += 2) {
            if (i >= n) {
              put(row0 + i, 0.0f, 0.0f);
              continue;
            }
            const float a = expf(gval(i) - run_mx) / run_s;
            const float dvp = a * dov;
            put(row0 + i, dvp * (vpv(row0 + i) - o) * args.scale, dvp);
          }
        }
      }
      CS[slot * KB_NS + ct] = csum;
    } else if constexpr (EPI == KB_DX) {
      if (rm.K <= CR) {
        for (int qi = slot; qi < rm.QB; qi += 2) {
          const int m = grp * rm.QB + qi;
          if (m >= rm.M) break;
          float sum = 0.0f;
          for (int i = 0; i < rm.K; ++i) sum += G[(qi * rm.K + i) * KB_GS + ct];
          args.dq[((size_t)gb * rm.M + m) * D + col] = sum;
        }
      } else if (slot == 0) {
        const int n = min(CR, rm.K - tt * CR);
        for (int i = 0; i < n; ++i) run_o += G[i * KB_GS + ct];
        if (tt == nt - 1) args.dq[((size_t)gb * rm.M + grp) * D + col] = run_o;
      }
    }
    // the tile's column sums, its parts added in a fixed order (none in the
    // softmax pass's first sweep, which writes no row)
    if constexpr (BSUM) {
      if (EPI != KB_SMB || sweep == sweeps - 1) {
        __syncthreads();
        if (t < KB_NS) {
          float sum = 0.0f;
          for (int w = 0; w < (EPI == KB_SMB ? KB_THREADS / KB_NS : KB_WARPS); ++w)
            sum += CS[w * KB_NS + t];
          args.bsum[(size_t)(n0 + t) * (args.n_rows / CR) + row0 / CR] = sum;
        }
      }
    }
    __syncthreads();  // G and CS are written again by the next tile
  }
}

// t1 = relu(delta W1 + b1) of every row, with the forward's arithmetic and
// rounding; each row's delta (0 on spare rows) and cloud index (-1 on spare
// rows); S's last four columns zeroed (knn_bwd_delta_kernel fills the real
// rows' ddelta). A warp a row.
template <typename T>
__global__ void __launch_bounds__(KB_THREADS) knn_bwd_t1_kernel(const KbArgs args, RowMap rm) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * KB_WARPS + warp;
  if (row >= args.n_rows) return;
  const int D = args.D;
  int b, m, j;
  const bool valid = rm.at(row, b, m, j);
  float d[3];
  row_delta<T>(rm, row, VA_KNN, args.N, args.qxyz, args.cxyz, args.idx, nullptr, d);
  const T* w1 = static_cast<const T*>(args.w1);
  const T* b1 = static_cast<const T*>(args.b1);
  T* t1 = static_cast<T*>(args.t1) + (size_t)row * D;
  for (int c = 4 * lane; c < D; c += 128) {
    const float4 a0 = ld4(w1 + c), a1 = ld4(w1 + D + c), a2 = ld4(w1 + 2 * D + c);
    const float4 bb = ld4(b1 + c);
    st4(t1 + c, make_float4(t1_value(d, a0.x, a1.x, a2.x, bb.x),
                            t1_value(d, a0.y, a1.y, a2.y, bb.y),
                            t1_value(d, a0.z, a1.z, a2.z, bb.z),
                            t1_value(d, a0.w, a1.w, a2.w, bb.w)));
  }
  if (lane == 0) {
    T* dl = static_cast<T*>(args.delta) + row * 4;
#pragma unroll
    for (int a = 0; a < 3; ++a) dl[a] = from_f32<T>(valid ? d[a] : 0.0f);
    dl[3] = from_f32<T>(0.0f);
    args.ridx[row] = valid ? args.idx[((size_t)b * args.M + m) * args.K + j] : -1;
    st4(args.s + (size_t)row * (2 * D + 4) + 2 * D, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  }
}

// ddelta of every real row (the column blocks' partials added in order) into
// S as -ddelta, and dquery_xyz = sum_j ddelta per query: a warp a query, its
// rows strided over the lanes, then a fixed shuffle tree.
__global__ void __launch_bounds__(KB_THREADS)
    knn_bwd_delta_kernel(const KbArgs args, RowMap rm, int n_cb) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long qa = (long long)blockIdx.x * KB_WARPS + warp;
  if (qa >= (long long)args.B * args.M) return;
  const int b = (int)(qa / args.M), m = (int)(qa % args.M);
  const int SW = 2 * args.D + 4;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int j = lane; j < args.K; j += 32) {
    const long long row = rm.row_of(b, m, j);
    float dd[3] = {0.0f, 0.0f, 0.0f};
    for (int cb = 0; cb < n_cb; ++cb) {
      const float4 p = ld4(args.ddp + ((size_t)cb * args.n_rows + row) * 4);
      dd[0] += p.x;
      dd[1] += p.y;
      dd[2] += p.z;
    }
    st4(args.s + (size_t)row * SW + 2 * args.D, make_float4(-dd[0], -dd[1], -dd[2], 0.0f));
#pragma unroll
    for (int a = 0; a < 3; ++a) acc[a] += dd[a];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[a] += __shfl_xor_sync(0xFFFFFFFFu, acc[a], off);
  if (lane == 0)
#pragma unroll
    for (int a = 0; a < 3; ++a) args.dqxyz[qa * 3 + a] = acc[a];
}

// One pass: A (a_rows, k_in) row-major times W (w_rows, w_cols) row-major,
// as A W (MN-major, W (k_in, n_out)) or A W^T (BT, W (n_out, k_in)).
template <typename T, int EPI, bool BT>
cudaError_t launch_kb(const void* a, long long a_rows, const void* w, int w_rows, int w_cols,
                      KbArgs args, int k_in, int n_out, const RowMap& rm, unsigned blocks,
                      cudaStream_t stream) {
  CUtensorMap ma{}, mb{};
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (!make_map_2d(&ma, a, (int)a_rows, k_in, CR) || !make_map_2d(&mb, w, w_rows, w_cols, CK))
      return cudaErrorInvalidValue;
  }
  args.n_rows = a_rows;
  auto kernel = knn_bwd_gemm_kernel<T, EPI, BT>;
  const size_t smem = KbCfg<T>::SMEM;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (blocks < 1 || blocks > 65535u) return cudaErrorInvalidValue;  // grid.y
  kernel<<<dim3(n_out / KB_NS, blocks), KB_THREADS, smem, stream>>>(
      ma, mb, (const T*)a, (const T*)w, w_cols, args, k_in, rm);
  return cudaGetLastError();
}

// The chain for one call; the buffers as the C entry point below lists them.
template <typename T>
cudaError_t launch_knn_bwd(KbArgs args, const void* x_full, const void* wkv, const void* w2,
                           const void* b2, const void* g0, const void* c0, const void* g1,
                           const void* c1, cudaStream_t s) {
  const int B = args.B, M = args.M, N = args.N, D = args.D, K = args.K;
  const RowMap rm(M, K);
  const long long rows = (long long)B * rm.tiles * CR;
  const unsigned row_blocks = (unsigned)(rows / CR);
  const unsigned groups = (unsigned)B * (K <= CR ? rm.tiles : M);
  args.n_rows = rows;
  cudaError_t err;
  // kv = x_full [Wk | Wv], every cloud point once
  if ((err = launch_kb<T, KB_KV, false>(x_full, (long long)B * N, wkv, D, 2 * D, args, D, 2 * D,
                                        rm, (unsigned)((B * N + CR - 1) / CR), s)) != cudaSuccess)
    return err;
  const unsigned t1_blocks = (unsigned)((rows + KB_WARPS - 1) / KB_WARPS);
  knn_bwd_t1_kernel<T><<<t1_blocks, KB_THREADS, 0, s>>>(args, rm);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  args.bias = b2;  // x, v + pos from t1
  if ((err = launch_kb<T, KB_POS, false>(args.t1, rows, w2, D, D, args, D, D, rm, row_blocks, s)) !=
      cudaSuccess)
    return err;
  args.bias = c0;  // h from x
  if ((err = launch_kb<T, KB_H, false>(args.x, rows, g0, D, D, args, D, D, rm, row_blocks, s)) !=
      cudaSuccess)
    return err;
  // the column sums of dg, da, dpos, dt1: (D, row tiles) each, in that order
  float* bsum = args.bsum;
  const size_t bsum_pass = (size_t)row_blocks * D;
  args.bias = c1;  // g from h, the softmax backward -> dg, dvp
  args.bsum = bsum;
  if ((err = launch_kb<T, KB_SMB, false>(args.h, rows, g1, D, D, args, D, D, rm, groups, s)) !=
      cudaSuccess)
    return err;
  // da = (dg G1^T) [h > 0]
  args.bsum = bsum + bsum_pass;
  if ((err = launch_kb<T, KB_DA, true>(args.dg, rows, g1, D, D, args, D, D, rm, row_blocks, s)) !=
      cudaSuccess)
    return err;
  // dx = da G0^T -> dpos, -dx, dq
  args.bsum = bsum + 2 * bsum_pass;
  if ((err = launch_kb<T, KB_DX, true>(args.da, rows, g0, D, D, args, D, D, rm, groups, s)) !=
      cudaSuccess)
    return err;
  // dt1 = (dpos W2^T) [t1 > 0] -> dt1, ddelta partials
  args.bsum = bsum + 3 * bsum_pass;
  if ((err = launch_kb<T, KB_DT1, true>(args.dpos, rows, w2, D, D, args, D, D, rm, row_blocks,
                                        s)) != cudaSuccess)
    return err;
  knn_bwd_delta_kernel<<<(unsigned)(((long long)B * M + KB_WARPS - 1) / KB_WARPS), KB_THREADS, 0,
                         s>>>(args, rm, D / KB_NS);
  return cudaGetLastError();
}

}  // namespace poem

using namespace poem;

// The backward of the trainable KNN vector attention at the saved indices
// idx (B, M, K), up to K7's scatter and the wrapper's products. dtype 0:
// float32 (the FMA product), 1: bfloat16 (wgmma). Inputs in that dtype: q,
// x_full (B, N, D), wkv = [Wk | Wv] (D, 2D), w1 (3, D), b1, w2, b2, g0, c0, g1,
// c1, dout (B, M, D); qxyz, cxyz float32. Outputs and scratch, rows = B tiles
// 128 (RowMap): kv (B, N, 2D) f32; t1, x, h, dg, da, dpos, dt1 (rows, D) in
// the dtype; vp (rows, D) f32; s (rows, 2D + 4) f32; dq (B, M, D) f32; bsum
// (4, D, rows / 128) f32, the row tiles' column sums of dg, da, dpos, dt1 (the
// bias gradients c1, c0, b2, b1 once summed over the tiles); ddp (D / 128, rows,
// 4) f32; delta (rows, 4) in the dtype; ridx (rows) int32;
// dqxyz (B, M, 3) f32. D a multiple of 128 up to 1024, 16-byte aligned
// tensors; scale = 1 / sqrt of the unpadded width.
extern "C" int poem_knn_attention_bwd(
    int dtype, const void* q, const void* qxyz, const void* cxyz, const void* idx,
    const void* x_full, const void* wkv, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* g0, const void* c0, const void* g1, const void* c1,
    const void* dout, void* kv, void* t1, void* x, void* h, void* vp, void* dg, void* da,
    void* dpos, void* dt1, void* s, void* dq, void* bsum, void* ddp, void* delta, void* ridx,
    void* dqxyz, int B, int M, int N, int D, int K, float scale, void* stream) {
  if (B < 1 || M < 1 || N < 1 || K < 1 || D < 128 || D > 1024 || D % 128 != 0)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, x_full, wkv, w1, b1, w2, b2, g0, c0, g1, c1, dout, (const void*)kv,
                        (const void*)t1, (const void*)x, (const void*)h, (const void*)vp,
                        (const void*)dg, (const void*)da, (const void*)dpos, (const void*)dt1,
                        (const void*)s, (const void*)dq, (const void*)bsum, (const void*)ddp,
                        (const void*)delta})
    if (p == nullptr || reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  KbArgs args{q,  dout, (const int*)idx, (const float*)qxyz, (const float*)cxyz, w1, b1, nullptr,
              (float*)kv, t1, x, h, (float*)vp, dg, da, dpos, dt1, (float*)s, (float*)dq,
              (float*)bsum, (float*)ddp, delta, (int*)ridx, (float*)dqxyz, 0, B, M, N, D, K,
              scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return (int)launch_knn_bwd<__nv_bfloat16>(args, x_full, wkv, w2, b2, g0, c0, g1, c1, st);
  if (dtype == DTYPE_F32)
    return (int)launch_knn_bwd<float>(args, x_full, wkv, w2, b2, g0, c0, g1, c1, st);
  return (int)cudaErrorInvalidValue;
}
