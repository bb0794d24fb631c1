// The K least keys of a row, in ascending order, on one warp: the
// neighbour selection that K1 (`knn_attn.cu:knn_select_kernel`) and K9
// (`knn_bucketed.cu:knn_select_bucketed_kernel`) share.
//
// A row is the keys of one query against a set of points, unique within the
// row, in one of two forms:
//   32-bit packed   (bits(max(d2, 0)) & ~0xFFF) | column   (K1, at most 4096 points)
//   64-bit          float_to_ordered(d2) << 32 | column    (K9, and K1 above 4096)
// The keys are never stored: a source (`SmemPoints`, `GlobalPoints`,
// `CandidatePoints`) forms each one in registers from the points' xyz with
// `d2_rn`'s operation order, so the selection is bit-identical to the plain
// versions, which sort the same keys.
//
// Design (K10's scan32, `select.cu`, on keys formed on the fly, one warp a
// row): lane l takes columns l, l + 32, ...; each lane keeps its six least
// keys in order, found in one pass (11 min / max a key). A round is one warp
// min (`__reduce_min_sync`; two for 64-bit keys: high words, then low words
// among the lanes that hold the least high word), with no shared memory and no
// barrier; the lane that held the round's key writes it out and drops it.
// Rounds write their keys in order, so nothing is sorted afterwards. A lane
// that has given all six rescans its share for its six least above the round's
// key: a warp-uniform branch outside any loop, so that nvcc can neither
// if-convert it nor hoist it into every round. With the keys spread over 32
// lanes a lane rarely gives six of the K least (for K 32 about one row in
// 50), so the row is formed about once: any row length takes the same path,
// and no row is held in registers or shared memory. What bounds it, by
// instruction count: the sorted insertions (11 integer min / max a key, at
// half the float rate). Four warps a row with a block min a round, four or
// eight keys a lane, and a warp-wide filter on a running bound of the K-th key
// were all slower (`scripts/torch_select_variants.cu`).
#pragma once

#include "common.cuh"

namespace poem {

constexpr int SC_LANES = 32;    // one warp a row
constexpr int SC_DEPTH = 6;     // least keys a lane keeps
constexpr int SC_MAX_WARPS = 16;  // rows a block at most, a warp each
constexpr int SC_STAGE_MAX = 6144;  // points a block stages in shared memory, 16 bytes each
constexpr unsigned SC_FULL = 0xFFFFFFFFu;

typedef unsigned long long key64_t;

template <typename Key> __device__ __forceinline__ Key key_none();
template <> __device__ __forceinline__ uint32_t key_none<uint32_t>() { return 0xFFFFFFFFu; }
template <> __device__ __forceinline__ key64_t key_none<key64_t>() { return ~0ull; }

// The key of squared distance d2 at column j. Packed keys clamp d2 at 0, so
// the unsigned order of the bits is the float order (the TPU kernel's keys).
template <typename Key> __device__ __forceinline__ Key make_key(float d2, int j);
template <> __device__ __forceinline__ uint32_t make_key<uint32_t>(float d2, int j) {
  return (__float_as_uint(fmaxf(d2, 0.0f)) & ~0xFFFu) | (uint32_t)j;
}
template <> __device__ __forceinline__ key64_t make_key<key64_t>(float d2, int j) {
  return ((key64_t)float_to_ordered(d2) << 32) | (uint32_t)j;
}

// The column a key names.
__device__ __forceinline__ int key_column(uint32_t key) { return (int)(key & 0xFFFu); }
__device__ __forceinline__ int key_column(key64_t key) { return (int)(uint32_t)key; }

template <typename T> __device__ __forceinline__ T kmin(T a, T b) { return b < a ? b : a; }
template <typename T> __device__ __forceinline__ T kmax(T a, T b) { return b < a ? a : b; }

__device__ __forceinline__ uint32_t warp_min(uint32_t v) { return __reduce_min_sync(SC_FULL, v); }
__device__ __forceinline__ key64_t warp_min(key64_t v) {
  const uint32_t hi = __reduce_min_sync(SC_FULL, (uint32_t)(v >> 32));
  const uint32_t lo = __reduce_min_sync(SC_FULL, (uint32_t)(v >> 32) == hi ? (uint32_t)v : SC_FULL);
  return ((key64_t)hi << 32) | lo;
}

// The SC_DEPTH least of the keys seen, in order: one sorted insertion a key.
template <typename Key> __device__ __forceinline__ void insert_sorted(Key (&b)[SC_DEPTH], Key v) {
#pragma unroll
  for (int i = SC_DEPTH - 1; i > 0; --i) b[i] = kmax(b[i - 1], kmin(b[i], v));
  b[0] = kmin(b[0], v);
}

// One query: its coordinates and |q|^2, rounded as d2_rn forms them.
struct SelQuery {
  float x, y, z, qq;
  __device__ __forceinline__ SelQuery(const float* q) : x(q[0]), y(q[1]), z(q[2]) {
    qq = sq3(x, y, z);
  }
  __device__ __forceinline__ float d2(float px, float py, float pz, float pp) const {
    return d2_rn_pp(x, y, z, qq, px, py, pz, pp);
  }
};

// Points staged in shared memory as (x, y, z, |p|^2); column j is pts[j].
template <typename Key> struct SmemPoints {
  const float4* pts;
  int n;
  SelQuery q;
  template <class F> __device__ __forceinline__ void scan(F&& f) const {
#pragma unroll 4
    for (int j = threadIdx.x % SC_LANES; j < n; j += SC_LANES) {
      const float4 p = pts[j];
      f(make_key<Key>(q.d2(p.x, p.y, p.z, p.w), j));
    }
  }
};

// Points read from device memory (through L2), (n, 3) float32; column j is point j.
template <typename Key> struct GlobalPoints {
  const float* p;
  int n;
  SelQuery q;
  template <class F> __device__ __forceinline__ void scan(F&& f) const {
#pragma unroll 4
    for (int j = threadIdx.x % SC_LANES; j < n; j += SC_LANES) {
      const float x = __ldg(p + 3 * j), y = __ldg(p + 3 * j + 1), z = __ldg(p + 3 * j + 2);
      f(make_key<Key>(q.d2(x, y, z, sq3(x, y, z)), j));
    }
  }
};

// The C * SB points of C buckets of SB points, read from device memory:
// column j is point cand[j / SB] * SB + j % SB of the cloud p.
struct CandidatePoints {
  const float* p;
  const int* cand;
  int sb, n;
  SelQuery q;
  template <class F> __device__ __forceinline__ void scan(F&& f) const {
    const int t = threadIdx.x % SC_LANES;
    const int dc = SC_LANES / sb, dofs = SC_LANES - dc * sb;  // a step of 32 columns
    int c = t / sb, o = t - c * sb;
    for (int j = t; j < n; j += SC_LANES) {
      const float* pp = p + ((size_t)__ldg(cand + c) * sb + o) * 3;
      const float x = __ldg(pp), y = __ldg(pp + 1), z = __ldg(pp + 2);
      f(make_key<key64_t>(q.d2(x, y, z, sq3(x, y, z)), j));
      c += dc;
      o += dofs;
      if (o >= sb) {
        o -= sb;
        ++c;
      }
    }
  }
};

// The K least keys of the row `src` forms, in ascending order, on the calling
// warp (K <= the row's length). Round r calls emit(r, key) in the one lane
// that held the key. Returns the K-th key, in every lane.
template <typename Key, class Src, class Emit>
__device__ __forceinline__ Key least_keys_in_order(const Src& src, int K, Emit&& emit) {
  const Key none = key_none<Key>();
  Key b[SC_DEPTH];
#pragma unroll
  for (int i = 0; i < SC_DEPTH; ++i) b[i] = none;
  src.scan([&](Key key) { insert_sorted(b, key); });
  int left = SC_DEPTH;  // entries of b not yet taken
  Key thr = none;
  for (int r = 0; r < K; ++r) {
    thr = warp_min(b[0]);
    if (b[0] == thr) {  // this lane held the round's key (keys are unique)
      emit(r, thr);
#pragma unroll
      for (int i = 0; i < SC_DEPTH - 1; ++i) b[i] = b[i + 1];
      b[SC_DEPTH - 1] = none;
      --left;
    }
    // all given: the least keys above the round's key, by a rescan
    const bool refill = left == 0 && r + 1 < K;
    if (__any_sync(SC_FULL, refill) && refill) {
      const Key lo = thr;
#pragma unroll
      for (int i = 0; i < SC_DEPTH; ++i) b[i] = none;
      src.scan([&](Key key) { insert_sorted(b, key > lo ? key : none); });
      left = SC_DEPTH;
    }
  }
  return thr;
}

// Rows (one a warp) a block of `smem` bytes of shared memory takes when
// `groups` sets of `rows` rows are split into blocks: of the q in [4,
// SC_MAX_WARPS] (or `rows`, if fewer) whose blocks all fit on the card at once,
// the one that least loads the fullest SM, q x ceil(blocks / SMs) rows, ties
// to the larger q; the largest q if none fits. (At B 4, 799 queries and 64 KB
// a block, 8 a block gives 400 blocks, four more than the 3 x 132 that fit;
// this picks 13, 248 blocks: K1's cross selection 0.029 ms against 0.034 at 8,
// from a CUDA graph on an H100, `scripts/torch_check_knn_select.py --times`.)
inline int rows_per_block(long long groups, int rows, size_t smem) {
  int sms = 132, dev;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int lo = rows < 4 ? rows : 4, hi = rows < SC_MAX_WARPS ? rows : SC_MAX_WARPS;
  int best = hi;
  long long best_load = -1;
  for (int q = lo; q <= hi; ++q) {
    const long long blocks = groups * ((rows + q - 1) / q);
    // an SM holds 228 KB of shared memory (1 KB of it reserved a block) and 2048 threads
    long long fit = (long long)(233472 / (smem + 1024));
    if (fit > 2048 / (q * SC_LANES)) fit = 2048 / (q * SC_LANES);
    if (blocks > fit * sms) continue;
    const long long load = q * ((blocks + sms - 1) / sms);
    if (best_load < 0 || load <= best_load) {
      best_load = load;
      best = q;
    }
  }
  return best;
}

}  // namespace poem
