// The exact K-th smallest packed key of every row, five ways.
//
// Replaces the five Pallas TPU kernel bodies of
//   scripts/bench_radix_select.py (K10: scan32, radix8, pass1, cur, bcast),
// a micro-benchmark of the selection inside the fused KNN attention: keys are
// (B, M, N) int32, `(bits(d2) & ~0xFFF) | column`, non-negative and unique
// within a row.
//
//   scan32  K rounds of "smallest key above the last one"
//   radix8  eight 4-bit passes from the top nibble down: count the active
//           keys under each nibble value, pick the nibble that holds the
//           K-th, narrow the prefix
//   pass1   the int32 wrap-around sum of a row: what one pass costs
//   cur     scan32 that also extracts: every round writes the one-hot row of
//           its key's column, and each chunk of CJ rounds sums its CJ one-hot
//           rows; the result is the K-th key plus the hits of all BQ rows of
//           the query block
//   bcast   the same result with one extraction per chunk: CJ scan rounds for
//           the chunk's threshold, then mask = (lo < key <= thr), the slot of
//           every masked column by a prefix sum, and the CJ one-hot rows
//           written from (mask, slot)
//
// What bounds them on the H100: one read of the keys from device memory
// (bytes), 218 MB at (16, 832, 4096), 0.065 ms at 3.35 TB/s, if a row is read
// once and the rounds or passes run on chip.
//
// Design:
// * scan32, radix8, pass1: one block of 128 threads (a warpgroup) a row. The
//   row (at most 4096 keys, the columns a packed key can name) is read once,
//   16 bytes a load where the rows allow, into registers: 32 keys a thread,
//   every load in flight before the first is used. (Blocks that walk rows
//   and fetch the next row while working on one were slower: the kernels
//   are bound by their instructions, not by the loads' latency.)
//   - scan32: a thread keeps its four least keys above the threshold in
//     order; a round is a warp min (`__reduce_min_sync`) and a block min of
//     four, and the thread that held the round's key drops it (four more
//     from its registers when all four are used). The row is never read
//     again, and a thread's keys are scanned once, not once a round.
//   - radix8: while more than 512 keys are active, a pass counts the
//     registers' active nibbles in 4-bit fields of a 64-bit word, moved every
//     15 keys into 8-bit fields, summed as 16-bit fields over the warp
//     (`__reduce_add_sync`) and the block. Then the active keys are compacted
//     into a list in shared memory (a warp prefix sum and one atomic a warp
//     place them), and each later pass counts and compacts only the list; a
//     list of at most 128 keys finishes in warp 0 on ballots of its bits. On
//     the benchmark's keys two passes run on the registers (~2000, then ~100
//     keys active), a row whose keys share a 20-bit prefix takes five.
// * cur, bcast: one block of 256 threads per query block of BQ rows, one row
//   at a time: the row's keys and the chunk's [CJ][N] one-hot bytes live in
//   shared memory, the hits are summed with `__dp4a`, and the block adds its
//   total to its rows' K-th keys at the end, so BQ and CJ mean what the caller
//   says whatever the launch looks like. `cur` writes one one-hot row a round
//   (one word in N / 4 is not 0). `bcast` clears the chunk's rows, takes the
//   slot of each masked column from `__ballot_sync` / `__popc` within a warp
//   plus the counts of the warps and tiles before it, and sets byte
//   [slot][column]. (The TPU body compares every column with every slot; a
//   scatter builds the same rows.)
#include <limits.h>

#include "common.cuh"

namespace poem {

constexpr int RS_MAX_N = 4096;     // a packed key names its column in 12 bits
constexpr int RK_THREADS = 128;    // one warpgroup a row in the row kernels
constexpr int RK_WARPS = RK_THREADS / 32;
constexpr int RK_SLOTS = RS_MAX_N / RK_THREADS;  // 32 keys a thread, in registers
constexpr int RK_LIST = 512;       // radix8 compacts its active keys once this few
constexpr int RK_WARP_LIST = 128;  // a list this short finishes in one warp
constexpr int OH_THREADS = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;

// The row index of slot s of thread t: with VEC, 16-byte accesses (slots
// 4 q .. 4 q + 3 are the int4 at q RK_THREADS + t), else one key an access.
template <bool VEC> __device__ __forceinline__ int slot_index(int s, int t) {
  return VEC ? ((s / 4) * RK_THREADS + t) * 4 + s % 4 : s * RK_THREADS + t;
}

// The block's row into the registers of its warpgroup, every load issued
// before the first is used; slots past N hold `pad`.
template <bool VEC>
__device__ __forceinline__ void load_row(const int* __restrict__ g, int N, int pad,
                                         int (&k)[RK_SLOTS]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int s = 0; s < RK_SLOTS; s += VEC ? 4 : 1) {
    const int j = slot_index<VEC>(s, t);
    if (VEC) {
      int4 v = make_int4(pad, pad, pad, pad);
      if (j < N) v = __ldcs(reinterpret_cast<const int4*>(g + j));
      k[s] = v.x; k[s + 1] = v.y; k[s + 2] = v.z; k[s + 3] = v.w;
    } else {
      k[s] = j < N ? __ldcs(g + j) : pad;
    }
  }
}

// The four least of the thread's keys above thr, in order (INT_MAX where it
// has fewer): one sorted insertion a key, min / max only.
__device__ __forceinline__ void least4_above(const int (&k)[RK_SLOTS], int thr, int (&b)[4]) {
  b[0] = b[1] = b[2] = b[3] = INT_MAX;
#pragma unroll
  for (int s = 0; s < RK_SLOTS; ++s) {
    const int v = k[s] > thr ? k[s] : INT_MAX;
    b[3] = max(b[2], min(b[3], v));
    b[2] = max(b[1], min(b[2], v));
    b[1] = max(b[0], min(b[1], v));
    b[0] = min(b[0], v);
  }
}

// Minimum over the block: a warp min, then the four warps' through `red`
// (2 x RK_WARPS, used in turn, so one barrier a call is enough).
__device__ __forceinline__ int block_min(int v, int* red, int& parity) {
  v = __reduce_min_sync(FULL, v);
  int* slot = red + parity * RK_WARPS;
  if (threadIdx.x % 32 == 0) slot[threadIdx.x / 32] = v;
  __syncthreads();
  parity ^= 1;
  const int4 w = *reinterpret_cast<const int4*>(slot);
  return min(min(w.x, w.y), min(w.z, w.w));
}

// scan32: K rounds of "the least key above the threshold". The row stays in
// registers; a thread keeps its four least keys above the threshold in order,
// so a round is one block min of each thread's least, and the thread that
// held the round's key drops it, taking four more from its keys once all
// four are used.
template <bool VEC>
__global__ void __launch_bounds__(RK_THREADS)
    kth_key_scan_kernel(const int* __restrict__ keys, int* __restrict__ out, int N, int K) {
  __shared__ __align__(16) int red[2 * RK_WARPS];
  int k[RK_SLOTS];
  load_row<VEC>(keys + (size_t)blockIdx.x * N, N, INT_MAX, k);
  int b[4];
  least4_above(k, INT_MIN, b);
  int left = 4;  // entries of b not yet taken
  int thr = INT_MIN, parity = 0;
  for (int r = 0; r < K; ++r) {
    thr = block_min(b[0], red, parity);
    if (b[0] == thr) {  // this thread held the round's key: drop it
      b[0] = b[1]; b[1] = b[2]; b[2] = b[3]; b[3] = INT_MAX;
      --left;
    }
    // Four more keys once the four are used, or past a key equal to the
    // round's (keys are unique by contract; equal ones are skipped, as a
    // strict threshold skips them). A warp-uniform branch, so that only a
    // warp that needs it scans its keys: if-converted, or hoisted out of a
    // loop, every warp would scan every round.
    const bool refill = thr != INT_MAX && (left == 0 || b[0] == thr);
    if (__any_sync(FULL, refill) && refill) {
      least4_above(k, thr, b);
      left = 4;
    }
  }
  if (threadIdx.x == 0) out[blockIdx.x] = thr;
}

// Per-thread nibble counts: a key adds 1 to the 4-bit field of its nibble
// in `acc`; every 15 keys (before a field can overflow) `flush` moves the
// fields into eight 8-bit fields of `ev` (nibbles 0, 2, .., 14) and of `od`
// (1, 3, .., 15). A thread counts at most RK_SLOTS keys a pass.
struct NibbleCount {
  unsigned long long acc = 0, ev = 0, od = 0;
  __device__ __forceinline__ void add(uint32_t nib) { acc += 1ull << (nib * 4); }
  __device__ __forceinline__ void flush() {
    const unsigned long long m = 0x0F0F0F0F0F0F0F0Full;
    ev += acc & m;
    od += (acc >> 4) & m;
    acc = 0;
  }
  __device__ __forceinline__ int own(uint32_t nib) const {
    return (int)(((nib & 1 ? od : ev) >> ((nib >> 1) * 8)) & 0xFF);
  }
};

struct RadixStep {
  uint32_t nibble;  // the nibble that holds the kk-th active key
  int below;        // active keys under it
  int count;        // active keys on it: the next pass's list
};

// The block's nibble histogram from every thread's counts, summed in 16-bit
// fields (a row has at most 4096 keys), and the radix step it gives for rank
// kk: the chosen nibble is the largest t with c_t < kk, c_t = #{active keys
// with nibble < t} (non-decreasing), and c_t keys lie below it. `hred` holds
// 2 x RK_WARPS x 8 words, used in turn by successive passes (`p`): a pass
// writes its half, passes one barrier and reads it, and the next pass's
// barrier lies between those reads and the pass after, which writes the half
// again.
__device__ __forceinline__ RadixStep radix_step(const NibbleCount& cnt, int kk, uint32_t* hred,
                                                int p) {
  const unsigned long long m = 0x00FF00FF00FF00FFull;
  // the four 16-bit fields of f[j] hold nibbles 4 q + (0, 2, 1, 3)[j], q = 0..3
  const unsigned long long f[4] = {cnt.ev & m, (cnt.ev >> 8) & m, cnt.od & m,
                                   (cnt.od >> 8) & m};
  uint32_t w[8];  // w[2 j], w[2 j + 1]: the low and high two 16-bit fields of f[j]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[2 * j] = __reduce_add_sync(FULL, (uint32_t)f[j]);
    w[2 * j + 1] = __reduce_add_sync(FULL, (uint32_t)(f[j] >> 32));
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  hred += (p & 1) * RK_WARPS * 8;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) hred[warp * 8 + i] = w[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = 0;
#pragma unroll
  for (int v = 0; v < RK_WARPS; ++v) {
    const uint4 a = *reinterpret_cast<const uint4*>(hred + v * 8);
    const uint4 b = *reinterpret_cast<const uint4*>(hred + v * 8 + 4);
    w[0] += a.x; w[1] += a.y; w[2] += a.z; w[3] += a.w;
    w[4] += b.x; w[5] += b.y; w[6] += b.z; w[7] += b.w;
  }
  int h[16];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int base = (j & 1) * 2 + (j >> 1);
    h[base] = (int)(w[2 * j] & 0xFFFF);
    h[base + 4] = (int)(w[2 * j] >> 16);
    h[base + 8] = (int)(w[2 * j + 1] & 0xFFFF);
    h[base + 12] = (int)(w[2 * j + 1] >> 16);
  }
  RadixStep st{0u, 0, h[0]};
  int c = 0;
#pragma unroll
  for (int t = 1; t < 16; ++t) {
    c += h[t - 1];
    if (c < kk) {
      st.nibble = t;
      st.below = c;
      st.count = h[t];
    }
  }
  return st;
}

// This thread's place in the next list: its `n` keys go after those of the
// threads before it in its warp, at the warp's share of `fill` (the lists'
// order is free: a pass only counts).
__device__ __forceinline__ int list_offset(int n, int* fill) {
  const int lane = threadIdx.x % 32;
  int x = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  int base = 0;
  if (lane == 31) base = atomicAdd(fill, x);
  return __shfl_sync(FULL, base, 31) + x - n;
}

// The passes p .. 7 of radix8 on a list of L <= RK_WARP_LIST keys, in one
// warp: lane l holds keys l, l + 32, l + 64, l + 96. The ballots of the keys'
// bits are the same in every lane, so each pass runs on masks: the chosen
// nibble (the largest t with c_t < kk) is the nibble of the kk-th smallest
// active key, found bit by bit from the top; the active keys skipped on the
// way are the c_t below it, so (prefix, kk) follow the recurrence exactly.
__device__ __forceinline__ uint32_t radix_warp_passes(const int* list, int L, int p,
                                                      uint32_t prefix, int kk) {
  constexpr int S = RK_WARP_LIST / 32;
  const int lane = threadIdx.x % 32;
  uint32_t v[S], act[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < L ? (uint32_t)list[i] : 0u;
    act[j] = __ballot_sync(FULL, i < L);
  }
  for (; p < 8; ++p) {
    uint32_t nibble = 0;
#pragma unroll
    for (int b = 3; b >= 0; --b) {
      const int bit = 28 - 4 * p + b;
      uint32_t one[S];
      int zeros = 0;
#pragma unroll
      for (int j = 0; j < S; ++j) {
        one[j] = __ballot_sync(FULL, (v[j] >> bit) & 1u);
        zeros += __popc(act[j] & ~one[j]);
      }
      const bool up = kk > zeros;  // the kk-th active key has this bit set
      if (up) kk -= zeros;
#pragma unroll
      for (int j = 0; j < S; ++j) act[j] &= up ? one[j] : ~one[j];
      nibble = (nibble << 1) | (up ? 1u : 0u);
    }
    prefix = (prefix << 4) | nibble;
  }
  return prefix;
}

// radix8: eight 4-bit passes from the top nibble down, the recurrence of
// scripts/bench_radix_select.py: count the active keys (those that share the
// prefix) under each nibble value, take the nibble that holds the kk-th,
// subtract the keys below it from kk, extend the prefix. While more than
// RK_LIST keys are active a pass counts the row in registers; then the active
// keys are compacted into `list` in shared memory (a warp prefix sum and one
// atomic a warp place them), and each later pass counts the list and compacts
// the keys on its chosen nibble (each thread's count is its own histogram's
// field). A list of at most RK_WARP_LIST keys finishes in warp 0
// (radix_warp_passes). Any row stays exact: one whose keys all share a prefix
// just takes more passes over the registers.
template <bool VEC>
__global__ void __launch_bounds__(RK_THREADS)
    kth_key_radix_kernel(const int* __restrict__ keys, int* __restrict__ out, int N, int K) {
  __shared__ int list[RK_LIST];
  __shared__ __align__(16) uint32_t hred[2 * RK_WARPS * 8];
  __shared__ int fill;
  const int t = threadIdx.x;
  int k[RK_SLOTS];
  load_row<VEC>(keys + (size_t)blockIdx.x * N, N, 0, k);
  if (t == 0) fill = 0;
  __syncthreads();  // `fill` is 0 before any warp adds to it, with or without a register pass

  // passes over the registers while many keys are active: a key is active
  // when its bits above the pass's nibble are the prefix (pass 0: all keys)
  uint32_t prefix = 0;
  int kk = K, L = N, p = 0;
  for (; p < 8 && L > RK_LIST; ++p) {
    const int shift = 28 - 4 * p;
    NibbleCount cnt;
#pragma unroll
    for (int s = 0; s < RK_SLOTS; ++s) {
      // d = the key's bits down to this nibble less the prefix's: active iff d < 16
      const uint32_t d = ((uint32_t)k[s] >> shift) - (prefix << 4);
      if (slot_index<VEC>(s, t) < N && d < 16u) cnt.add(d);
      if (s % 15 == 14) cnt.flush();
    }
    cnt.flush();
    const RadixStep st = radix_step(cnt, kk, hred, p);
    prefix = (prefix << 4) | st.nibble;
    kk -= st.below;
    L = st.count;
  }
  if (p < 8) {
    // compact the active keys (those whose bits down to the last pass's
    // nibble are the prefix) into the list
    const int shift = 32 - 4 * p;  // p >= 1: the row has at most RK_LIST keys otherwise
    int n = 0;
#pragma unroll
    for (int s = 0; s < RK_SLOTS; ++s)
      n += slot_index<VEC>(s, t) < N && (p == 0 || ((uint32_t)k[s] >> shift) == prefix);
    int off = list_offset(n, &fill);
#pragma unroll
    for (int s = 0; s < RK_SLOTS; ++s)
      if (slot_index<VEC>(s, t) < N && (p == 0 || ((uint32_t)k[s] >> shift) == prefix))
        list[off++] = k[s];
    __syncthreads();
  }

  // passes over the list while it is longer than one warp takes
  for (; p < 8 && L > RK_WARP_LIST; ++p) {
    const int shift = 28 - 4 * p;
    if (t == 0) fill = 0;  // the last pass's atomics are done: a barrier passed since
    NibbleCount cnt;
    int v[RK_LIST / RK_THREADS];
#pragma unroll
    for (int s = 0; s < RK_LIST / RK_THREADS; ++s) {
      const int j = s * RK_THREADS + t;
      v[s] = j < L ? list[j] : 0;
      if (j < L) cnt.add(((uint32_t)v[s] >> shift) & 0xF);
    }
    cnt.flush();
    const RadixStep st = radix_step(cnt, kk, hred, p);  // its barrier: every read of `list` is done
    if (p < 7) {
      int off = list_offset(cnt.own(st.nibble), &fill);
#pragma unroll
      for (int s = 0; s < RK_LIST / RK_THREADS; ++s)
        if (s * RK_THREADS + t < L && (((uint32_t)v[s] >> shift) & 0xF) == st.nibble)
          list[off++] = v[s];
    }
    prefix = (prefix << 4) | st.nibble;
    kk -= st.below;
    L = st.count;
    __syncthreads();
  }
  if (p < 8) {  // the passes left on a short list, in warp 0
    if (t >= 32) return;
    prefix = radix_warp_passes(list, L, p, prefix, kk);
  }
  if (t == 0) out[blockIdx.x] = (int)prefix;
}

// pass1: the row's int32 wrap-around sum, read as scan32 and radix8 read it
template <bool VEC>
__global__ void __launch_bounds__(RK_THREADS)
    key_row_sum_kernel(const int* __restrict__ keys, int* __restrict__ out, int N) {
  __shared__ __align__(16) unsigned red[RK_WARPS];
  int k[RK_SLOTS];
  load_row<VEC>(keys + (size_t)blockIdx.x * N, N, 0, k);
  unsigned s = 0;  // unsigned: the sum wraps around as int32 does
#pragma unroll
  for (int i = 0; i < RK_SLOTS; ++i) s += (unsigned)k[i];
  s = __reduce_add_sync(FULL, s);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint4 w = *reinterpret_cast<const uint4*>(red);
    out[blockIdx.x] = (int)(w.x + w.y + w.z + w.w);
  }
}

// The least key above `thr` over the block's row; `red` has 2 x 8 slots, used
// in turn by successive calls (`parity`), so one barrier a call is enough.
__device__ __forceinline__ int block_min_above(const int* k, int N, int thr, int* red,
                                               int parity) {
  int best = INT_MAX;
  for (int j = threadIdx.x; j < N; j += OH_THREADS) {
    const int v = k[j];
    if (v > thr && v < best) best = v;
  }
  best = __reduce_min_sync(FULL, best);
  int* slot = red + parity * (OH_THREADS / 32);
  if (threadIdx.x % 32 == 0) slot[threadIdx.x / 32] = best;
  __syncthreads();
  int m = slot[0];
#pragma unroll
  for (int w = 1; w < OH_THREADS / 32; ++w) m = min(m, slot[w]);
  return m;
}

inline size_t onehot_smem(int N, int BQ, int CJ) {
  const size_t NS = ((size_t)N + 3) / 4 * 4;
  return (size_t)N * sizeof(int) + (size_t)CJ * NS + (size_t)BQ * sizeof(int);
}

template <bool BCAST>
__global__ void __launch_bounds__(OH_THREADS)
    kth_key_onehot_kernel(const int* __restrict__ keys, int* __restrict__ out, int M, int N,
                          int K, int BQ, int CJ) {
  extern __shared__ int oh_smem[];
  __shared__ int red[2 * (OH_THREADS / 32)];
  __shared__ int wcount[2 * (OH_THREADS / 32)];
  const int NS = (N + 3) / 4 * 4;  // bytes of a one-hot row; the pad stays 0
  int* krow = oh_smem;                                               // [N] the row's keys
  uint32_t* oh_words = reinterpret_cast<uint32_t*>(krow + N);        // [CJ][NS / 4]
  unsigned char* oh = reinterpret_cast<unsigned char*>(oh_words);    // [CJ][NS]
  int* row_thr = reinterpret_cast<int*>(oh + (size_t)CJ * NS);       // [BQ] K-th key per row
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int words = CJ * (NS / 4);
  const size_t row0 = (size_t)blockIdx.y * M + (size_t)blockIdx.x * BQ;
  unsigned hits = 0;
  int parity = 0;

  for (int r = 0; r < BQ; ++r) {
    const int* g = keys + (row0 + r) * N;
    __syncthreads();  // the previous row's readers of krow are done
    for (int j = t; j < N; j += OH_THREADS) krow[j] = g[j];
    __syncthreads();
    int thr = INT_MIN;
    for (int c = 0; c < K / CJ; ++c) {
      const int lo = thr;
      if (BCAST)
        for (int w = t; w < words; w += OH_THREADS) oh_words[w] = 0u;
      for (int jj = 0; jj < CJ; ++jj) {
        thr = block_min_above(krow, N, thr, red, parity);
        parity ^= 1;
        if (!BCAST) {
          // the round's one-hot row: column (thr & 0xFFF), if the row has it
          const int col = thr & 0xFFF;
          const int hit_word = col < N ? col >> 2 : -1;
          for (int w = t; w < NS / 4; w += OH_THREADS)
            oh_words[jj * (NS / 4) + w] = w == hit_word ? 1u << (8 * (col & 3)) : 0u;
        }
      }
      if (BCAST) {
        // slot of every masked column = masked columns before it in the row
        int before = 0;
        for (int base = 0, tile = 0; base < N; base += OH_THREADS, ++tile) {
          const int j = base + t;
          const bool m = j < N && krow[j] > lo && krow[j] <= thr;
          const unsigned ballot = __ballot_sync(FULL, m);
          int* wc = wcount + (tile & 1) * (OH_THREADS / 32);
          if (lane == 0) wc[warp] = __popc(ballot);
          __syncthreads();
          int slot = before + __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
          for (int w = 0; w < OH_THREADS / 32; ++w) {
            if (w < warp) slot += wc[w];
            before += wc[w];
          }
          if (m && slot < CJ) oh[(size_t)slot * NS + j] = 1;
        }
      }
      __syncthreads();  // the chunk's one-hot rows are complete
      for (int w = t; w < words; w += OH_THREADS) hits = __dp4a(oh_words[w], 0x01010101u, hits);
      __syncthreads();  // before the next chunk overwrites them
    }
    if (t == 0) row_thr[r] = thr;
  }

  // total hits of the block's BQ rows, added to each row's K-th key
  hits = __reduce_add_sync(FULL, hits);
  __syncthreads();
  if (lane == 0) red[warp] = (int)hits;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < OH_THREADS / 32; ++w) total += red[w];
  for (int r = t; r < BQ; r += OH_THREADS) out[row0 + r] = row_thr[r] + total;
}

template <bool BCAST>
cudaError_t launch_onehot(const int* keys, int* out, int B, int M, int N, int K, int BQ, int CJ,
                          cudaStream_t stream) {
  const size_t smem = onehot_smem(N, BQ, CJ);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  auto kernel = kth_key_onehot_kernel<BCAST>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(M / BQ, B), OH_THREADS, smem, stream>>>(keys, out, M, N, K, BQ, CJ);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_rows(int variant, const int* keys, int* out, int rows, int N, int K,
                        cudaStream_t s) {
  if (variant == 0)
    kth_key_scan_kernel<VEC><<<rows, RK_THREADS, 0, s>>>(keys, out, N, K);
  else if (variant == 1)
    kth_key_radix_kernel<VEC><<<rows, RK_THREADS, 0, s>>>(keys, out, N, K);
  else
    key_row_sum_kernel<VEC><<<rows, RK_THREADS, 0, s>>>(keys, out, N);
  return cudaGetLastError();
}

}  // namespace poem

using namespace poem;

// variant 0: scan32 (K strict-threshold rounds), 1: radix8 (non-negative keys),
// 2: pass1 (the row's int32 wrap-around sum; K is not read).
// keys (rows, N <= 4096) int32 contiguous, out (rows,) int32. One block of
// RK_THREADS a row; rows of whole 16-byte units on a 16-byte aligned base are
// read 16 bytes a load.
extern "C" int poem_kth_key_rows(int variant, const void* keys, void* out, int rows, int N, int K,
                                 void* stream) {
  if (rows < 1 || N < 1 || N > RS_MAX_N || variant < 0 || variant > 2)
    return (int)cudaErrorInvalidValue;
  if (variant != 2 && (K < 1 || K > N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = N % 4 == 0 && ((uintptr_t)keys & 15) == 0;
  return (int)(vec ? launch_rows<true>(variant, (const int*)keys, (int*)out, rows, N, K, s)
                   : launch_rows<false>(variant, (const int*)keys, (int*)out, rows, N, K, s));
}

// The K-th key of every row plus the one-hot hits of its query block of BQ rows
// (cur: bcast == 0, bcast: bcast != 0). keys (B, M, N) int32 with M % BQ == 0 and
// K % CJ == 0, out (B, M) int32.
extern "C" int poem_kth_key_onehot(int bcast, const void* keys, void* out, int B, int M, int N,
                                   int K, int BQ, int CJ, void* stream) {
  if (B < 1 || M < 1 || N < 1 || K < 1 || K > N || BQ < 1 || CJ < 1 || M % BQ || K % CJ)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = bcast ? launch_onehot<true>((const int*)keys, (int*)out, B, M, N, K, BQ, CJ, s)
                          : launch_onehot<false>((const int*)keys, (int*)out, B, M, N, K, BQ, CJ, s);
  return (int)err;
}
