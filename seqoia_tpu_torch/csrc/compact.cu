// K5: order-preserving compaction of a key stream and its payload streams.
//
// Replaces seqoia_tpu/ops/pallas_engine.py:compact (kernel _compact_kernel):
// the entries of each (B, M) row whose valid byte is set move, in order, to
// the front of the row; totals[b] is their exact count.
//
// Bound on the H100: bytes. It must read the valid mask once, read each kept
// key and payload once and write it once.
//
// Design: the TPU kernel moves each tile's entries left through a butterfly
// network of rolls and appends the packed tile at a cursor carried across
// its sequential grid. Here the cursor is a decoupled look-back over the
// tiles' counts (lookback.cuh), in one launch: a block takes the next
// 4096-entry tile from a counter, loads its mask as 16-byte vectors (16
// entries a thread), counts each thread's kept entries with byte-wise
// arithmetic and a popcount, scans the counts with warp shuffles and gets
// the tile's output base by look-back. Every kept entry's rank in the tile
// goes to shared memory; then each stream's tile is read whole as
// coalesced vectors (at the densities the paths see nearly every 32-byte
// sector holds a kept entry), its kept entries are placed at their ranks in
// shared memory, and the tile's run is written to the output as one
// contiguous stretch of vector stores. The last tile of a row writes its
// total. Nothing past totals is written.

#include <climits>

#include "lookback.cuh"

namespace {

using lb::TILE;
using lb::u64;

// The mask tile as bytes: a vector store where the tile's vectors fall on
// 16-byte boundaries of shared memory (an aligned row), else byte stores.
struct MaskPut {
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

// A stream's tile entry e goes to stage[rank[e]] if it is kept.
struct Scatter {
  const short* rank;
  int* stage;
  __device__ void one(int e, int x) const {
    const int r = rank[e];
    if (r >= 0) stage[r] = x;
  }
  __device__ void vec(int e, uint4 q) const {
    one(e, (int)q.x);
    one(e + 1, (int)q.y);
    one(e + 2, (int)q.z);
    one(e + 3, (int)q.w);
  }
};

struct Linear {
  const int* s;
  __device__ uint4 vec(int e) const {
    return make_uint4((unsigned)s[e], (unsigned)s[e + 1], (unsigned)s[e + 2],
                      (unsigned)s[e + 3]);
  }
  __device__ int one(int e) const { return s[e]; }
};

// 0x01 in each byte of x that is not zero
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
  return (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) >> 7 & 0x01010101u;
}

// After a stream's kept entries went to their ranks in stage: the tile's
// run of n_kept to dst.
__device__ __forceinline__ void write_run(int* dst, int n_kept,
                                          const int* stage) {
  __syncthreads();
  lb::store_tile(dst, n_kept, Linear{stage});
  __syncthreads();
}

// Six blocks an SM (40 registers a thread, with the key tile in flight).
__global__ void __launch_bounds__(NT, 6)
    k5_kernel(const uint8_t* valid, const int* key, const int* p0,
              const int* p1, int m, int n_tiles, u64* status,
              unsigned* counter, int* key_out, int* p0_out, int* p1_out,
              int* totals) {
  __shared__ __align__(16) uint8_t mask[TILE];
  __shared__ __align__(16) short rank[TILE];
  __shared__ int stage[TILE];
  __shared__ int wtot[lb::NW + 1];
  __shared__ int s_base, s_id;
  const int id = lb::next_tile(counter, &s_id);
  const int row = id / n_tiles, tile = id - row * n_tiles;
  const long long off = (long long)row * m + (long long)tile * TILE;
  const int len = max(min(TILE, m - tile * TILE), 0);
  lb::load_tile(valid + off, len, MaskPut{mask});
  __syncthreads();

  // this thread's 16 entries: a 0x01 byte for each kept one
  const int e0 = threadIdx.x * lb::IPT;
  const uint4 q = *reinterpret_cast<const uint4*>(mask + e0);
  unsigned w[4] = {q.x, q.y, q.z, q.w};
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int bytes = min(max(len - e0 - 4 * k, 0), 4);  // past len: none
    const unsigned live = bytes == 4 ? 0xFFFFFFFFu : (1u << (8 * bytes)) - 1;
    w[k] = nonzero_bytes(w[k]) & live;
    cnt += __popc(w[k]);
  }
  int agg;
  int r = lb::block_scan_warp(cnt, 0, wtot, &agg, lb::WordSum());
  // the key tile is read while warp 0 looks back
  lb::TileLoad<int> key_tile;
  if (agg != 0) key_tile.load(key + off, len);
  if (threadIdx.x < 32) {
    const int base = lb::tile_prefix<lb::WordSum>(
        status + (long long)row * n_tiles, tile, agg);
    if (threadIdx.x == 0) {
      s_base = base;
      if (tile == n_tiles - 1) totals[row] = base + agg;
    }
  }
  // each entry's rank in the tile's run, -1 where it is dropped
  unsigned rk[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned b0 = (w[k] >> (16 * h)) & 1u;
      const unsigned b1 = (w[k] >> (16 * h + 8)) & 1u;
      const unsigned lo = b0 ? (unsigned)r : 0xFFFFu;
      r += b0;
      const unsigned hi = b1 ? (unsigned)r : 0xFFFFu;
      r += b1;
      rk[2 * k + h] = lo | (hi << 16);
    }
  }
  uint4* rk_out = reinterpret_cast<uint4*>(rank + e0);
  rk_out[0] = make_uint4(rk[0], rk[1], rk[2], rk[3]);
  rk_out[1] = make_uint4(rk[4], rk[5], rk[6], rk[7]);
  __syncthreads();
  if (agg == 0) return;  // the same in every thread

  const long long out = (long long)row * m + s_base;
  key_tile.put(Scatter{rank, stage});
  write_run(key_out + out, agg, stage);
  if (p0) {
    lb::load_tile(p0 + off, len, Scatter{rank, stage});
    write_run(p0_out + out, agg, stage);
  }
  if (p1) {
    lb::load_tile(p1 + off, len, Scatter{rank, stage});
    write_run(p1_out + out, agg, stage);
  }
}

}  // namespace

// valid (B, m) u8 (0 or 1); key, p0, p1 (B, m) i32 (p0/p1 may be null);
// any row length and alignment. key_out, p0_out, p1_out (B, m) i32, written
// below totals only; totals (B,) i32. scratch: 2 * (B * n_tiles(m) + 1) i32
// (ops/scan.py:scratch_words), zeroed here. Returns cudaGetLastError.
extern "C" int k5_compact(const uint8_t* valid, const int* key, const int* p0,
                          const int* p1, int B, int m, int* scratch,
                          int* key_out, int* p0_out, int* p1_out, int* totals,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0) return 0;
  const int nt = lb::n_tiles(m);
  const long long tiles = (long long)B * nt;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  u64* words = reinterpret_cast<u64*>(scratch);
  const cudaError_t e = lb::lb_scratch(words, tiles, st);
  if (e != cudaSuccess) return (int)e;
  k5_kernel<<<(unsigned)tiles, NT, 0, st>>>(
      valid, key, p0, p1, m, nt, words + 1,
      reinterpret_cast<unsigned*>(words), key_out, p0_out, p1_out, totals);
  return (int)cudaGetLastError();
}
