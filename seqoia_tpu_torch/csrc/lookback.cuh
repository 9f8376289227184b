// Single-pass scan machinery for the port's Hopper kernels (K1, K5, K7,
// K8): a decoupled look-back across tiles (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA
// 2016), a block scan by warp shuffles, and tile loads and stores by
// 16-byte vectors.
//
// A kernel built on it reads its input once and writes its output once:
//   1. next_tile: a block takes the next tile from a global counter, so
//      tiles start in (row, tile) order and every tile a block waits on
//      belongs to a block that is already running (ordering by blockIdx
//      can deadlock once resident blocks spin on blocks that never start);
//   2. load_tile: the tile comes into shared memory as 16-byte vectors at
//      neighbouring addresses, the ragged head and tail element by element
//      (TileLoad: the same, all reads issued before the values are used);
//   3. block_scan_warp: each thread folds its run of consecutive entries,
//      the block scans the thread aggregates (two barriers);
//   4. tile_prefix: warp 0 publishes the tile's aggregate, folds its
//      predecessors' published values right to left until it meets an
//      inclusive prefix, and publishes its own inclusive prefix;
//   5. the kernel applies the prefix and writes the tile with store_tile.
//
// Status words: one 64-bit word per tile, state in bits 62-63 (none,
// aggregate, inclusive prefix), value in bits 0-61 (C::pack / C::unpack;
// K5 and K8 pack at most 33 bits, K1's pixel and op counts 62).
// A word is published by one 64-bit store and read by 64-bit loads, so
// state and value are seen together. The words and the counter are zeroed
// on the launch's stream before every launch (lb_scratch).
//
// The combines need not commute: every fold is op(left, right), with the
// left operand earlier in the row. C::ident() must be an identity on both
// sides for the values the kernel feeds it (the lanes past a window's stop
// and the entries past a ragged tile's end are padded with it).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace lb {

constexpr int IPT = 16;         // consecutive entries per thread
constexpr int TILE = NT * IPT;  // entries per tile
constexpr int NW = NT / 32;     // warps per block
constexpr unsigned FULL = 0xFFFFFFFFu;

using u64 = unsigned long long;
constexpr int ST_SHIFT = 62;
constexpr u64 ST_AGG = 1ull << ST_SHIFT;
constexpr u64 ST_PREFIX = 2ull << ST_SHIFT;
constexpr u64 VAL_MASK = (1ull << ST_SHIFT) - 1;

// The status word carries its value, so nothing else has to be ordered
// around it: relaxed 64-bit accesses at GPU scope (single-copy atomic, not
// cached in L1) publish and read it.
__device__ __forceinline__ void st_status(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 ld_status(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ int shfl_up(int v, int d) {
  return __shfl_up_sync(FULL, v, d);
}
__device__ __forceinline__ int shfl_down(int v, int d) {
  return __shfl_down_sync(FULL, v, d);
}

// The wrapping int32 sum: K5's counts and K8's sum combine.
struct WordSum {
  using T = int;
  __host__ __device__ static T ident() { return 0; }
  __device__ T operator()(T a, T b) const {
    return (int)((unsigned)a + (unsigned)b);
  }
  __device__ static u64 pack(T v) { return (u64)(unsigned)v; }
  __device__ static T unpack(u64 w) { return (int)(unsigned)w; }
};

// Tiles of a (B, m) row-major array and the scratch of one launch: the
// tile counter in the first 64-bit word, then B * n_tiles status words.
__host__ __device__ inline int n_tiles(int m) {
  return m > TILE ? (m + TILE - 1) / TILE : 1;
}

inline cudaError_t lb_scratch(void* scratch, long long tiles,
                              cudaStream_t st) {
  return cudaMemsetAsync(scratch, 0, (size_t)(tiles + 1) * sizeof(u64), st);
}

// The block's tile: a dynamic index from the counter (row-major over
// (row, tile)). All threads call it; one barrier.
__device__ __forceinline__ int next_tile(unsigned* counter, int* s_id) {
  if (threadIdx.x == 0) *s_id = (int)atomicAdd(counter, 1u);
  __syncthreads();
  return *s_id;
}

// Exclusive scan of one value per thread over the block, in thread order:
// each warp scans its lanes with __shfl_up_sync, warp 0 scans the NW warp
// totals. All threads call it; two barriers. wtot: NW + 1 shared slots.
// Returns the thread's exclusive prefix; *agg gets the block's aggregate.
template <class T, class Op>
__device__ __forceinline__ T block_scan_warp(T v, T ident, T* wtot, T* agg,
                                             Op op) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T o = shfl_up(v, d);
    if (lane >= d) v = op(o, v);
  }
  T ex = shfl_up(v, 1);
  if (lane == 0) ex = ident;
  if (lane == 31) wtot[w] = v;
  __syncthreads();
  if (w == 0) {
    T t = lane < NW ? wtot[lane] : ident;
#pragma unroll
    for (int d = 1; d < NW; d <<= 1) {
      const T o = shfl_up(t, d);
      if (lane >= d) t = op(o, t);
    }
    const T te = shfl_up(t, 1);
    if (lane < NW) wtot[lane] = lane == 0 ? ident : te;
    if (lane == NW - 1) wtot[NW] = t;
  }
  __syncthreads();
  *agg = wtot[NW];
  return op(wtot[w], ex);
}

// The exclusive prefix of tile `tile` of a row whose status words start at
// st, by warp 0 (all 32 lanes call it; lane 0 holds the aggregate `agg`):
// publishes the aggregate, reads 32 predecessors at a time (lane l the
// l-th nearest), waits while any is unpublished, and folds the window's
// values from its farthest lane down to the nearest inclusive prefix into
// the running prefix, ex = op(window, ex), until it meets one. Positions
// before the row's start read as the prefix ident. Publishes the tile's
// inclusive prefix; returns the exclusive one in lane 0.
template <class C>
__device__ typename C::T tile_prefix(u64* st, int tile, typename C::T agg) {
  using T = typename C::T;
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) st_status(st, ST_PREFIX | C::pack(agg));
    return C::ident();
  }
  if (lane == 0) st_status(st + tile, ST_AGG | C::pack(agg));
  T ex = C::ident();
  for (int j = tile - 1;; j -= 32) {
    const int k = j - lane;
    u64 s = k >= 0 ? ld_status(st + k) : ST_PREFIX | C::pack(C::ident());
    while ((s >> ST_SHIFT) == 0) {
      __nanosleep(32);
      s = ld_status(st + k);
    }
    const unsigned pm = __ballot_sync(FULL, (s >> ST_SHIFT) == 2);
    const int stop = pm ? __ffs(pm) - 1 : 31;
    T v = lane <= stop ? C::unpack(s & VAL_MASK) : C::ident();
    // lane 0 ends with v[31] op ... op v[0]: farthest on the left
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T o = shfl_down(v, d);
      if (lane + d < 32) v = C()(o, v);
    }
    ex = C()(v, ex);
    if (pm) break;
  }
  if (lane == 0) st_status(st + tile, ST_PREFIX | C::pack(C()(ex, agg)));
  return ex;
}

// The split of p[0, len) at 16-byte boundaries: `head` elements before
// the first, `nvec` whole 16-byte vectors, then the elements from `tail`
// on. It comes from the pointer itself, so any row length and row start
// works.
struct Span {
  int head, nvec, tail;
};

template <class E>
__device__ __forceinline__ Span span16(const E* p, int len) {
  constexpr int V = 16 / sizeof(E);
  const int head =
      min((int)(((16 - ((uintptr_t)p & 15)) & 15) / sizeof(E)), len);
  const int nvec = (len - head) / V;
  return Span{head, nvec, head + nvec * V};
}

// Reads src[0, len) (len <= TILE, read once: streaming loads) and hands it
// to put: the vectors as put.vec(e, q), q holding elements e..e+V-1, thread
// i taking vector i, i + NT, ... (a warp reads 512 neighbouring bytes);
// the ragged head and tail element by element as put.one(e, x). One vector
// in flight a thread, which keeps registers, and so occupancy, low.
template <class E, class Put>
__device__ __forceinline__ void load_tile(const E* src, int len, Put put) {
  constexpr int V = 16 / sizeof(E);
  const Span sp = span16(src, len);
  const uint4* vs = reinterpret_cast<const uint4*>(src + sp.head);
  for (int i = threadIdx.x; i < sp.nvec; i += NT)
    put.vec(sp.head + i * V, __ldcs(vs + i));
  const int t = threadIdx.x;
  if (t < sp.head) put.one(t, src[t]);
  if (t < len - sp.tail) put.one(sp.tail + t, src[sp.tail + t]);
}

// load_tile in two steps: load() issues every read of the tile at once into
// registers, put() hands the values over later (K5 reads its key tile so
// while its look-back runs).
template <class E>
struct TileLoad {
  static constexpr int V = 16 / sizeof(E);
  static constexpr int PER = TILE / V / NT;  // vectors a thread
  uint4 q[PER];
  E h, t;
  Span sp;
  int len;

  __device__ __forceinline__ void load(const E* src, int n) {
    len = n;
    sp = span16(src, n);
    const uint4* vs = reinterpret_cast<const uint4*>(src + sp.head);
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * NT;
      if (i < sp.nvec) q[u] = __ldcs(vs + i);
    }
    const int k = threadIdx.x;
    if (k < sp.head) h = src[k];
    if (k < len - sp.tail) t = src[sp.tail + k];
  }

  template <class Put>
  __device__ __forceinline__ void put(Put p) const {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * NT;
      if (i < sp.nvec) p.vec(sp.head + i * V, q[u]);
    }
    const int k = threadIdx.x;
    if (k < sp.head) p.one(k, h);
    if (k < len - sp.tail) p.one(sp.tail + k, t);
  }
};

// Writes dst[0, len) the same way (streaming stores): get.vec(e) gives the
// vector of elements e..e+V-1, get.one(e) element e.
template <class E, class Get>
__device__ __forceinline__ void store_tile(E* dst, int len, Get get) {
  constexpr int V = 16 / sizeof(E);
  const Span sp = span16(dst, len);
  uint4* vd = reinterpret_cast<uint4*>(dst + sp.head);
  for (int i = threadIdx.x; i < sp.nvec; i += NT)
    __stcs(vd + i, get.vec(sp.head + i * V));
  const int t = threadIdx.x;
  if (t < sp.head) dst[t] = get.one(t);
  if (t < len - sp.tail) dst[sp.tail + t] = get.one(sp.tail + t);
}

// A byte tile into 16-byte aligned shared memory (load_tile's put): a
// vector store where the tile's vectors fall on 16-byte boundaries of it
// (an aligned row), else byte stores.
struct BytePut {
  uint8_t* s;
  __device__ void vec(int e, uint4 q) const {
    if ((e & 15) == 0) {
      *reinterpret_cast<uint4*>(s + e) = q;
      return;
    }
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&q);
#pragma unroll
    for (int c = 0; c < 16; ++c) s[e + c] = b[c];
  }
  __device__ void one(int e, uint8_t x) const { s[e] = x; }
};

// int32 entries staged contiguously in shared memory (store_tile's get).
struct Linear {
  const int* s;
  __device__ uint4 vec(int e) const {
    return make_uint4((unsigned)s[e], (unsigned)s[e + 1], (unsigned)s[e + 2],
                      (unsigned)s[e + 3]);
  }
  __device__ int one(int e) const { return s[e]; }
};

// A tile of int32 in shared memory, one pad word after every 32 so that a
// thread's run of IPT consecutive entries and a warp's vectors both fall
// on distinct banks.
constexpr int PAD_TILE = TILE + TILE / 32;
__device__ __forceinline__ int pad(int e) { return e + (e >> 5); }

struct PaddedI32 {
  int* s;
  __device__ void vec(int e, uint4 q) const {
    s[pad(e)] = (int)q.x;
    s[pad(e + 1)] = (int)q.y;
    s[pad(e + 2)] = (int)q.z;
    s[pad(e + 3)] = (int)q.w;
  }
  __device__ void one(int e, int x) const { s[pad(e)] = x; }
  __device__ uint4 vec(int e) const {
    return make_uint4((unsigned)s[pad(e)], (unsigned)s[pad(e + 1)],
                      (unsigned)s[pad(e + 2)], (unsigned)s[pad(e + 3)]);
  }
  __device__ int one(int e) const { return s[pad(e)]; }
};

}  // namespace lb
