// K3: SQOA encode front-end, packed pixels -> compacted emission stream.
//
// Replaces seqoia_tpu/ops/pallas_encode.py:encode_front_compact (kernel
// _front_kernel, tile body _front_tile_body): the previous-pixel shift, the
// change/run segmentation (a running max of change positions and the
// closed-form 61/512 run chunking), the LUMA/RGB/mono-GA classification
// with the wrapped deltas packed into the meta word
// (encode_v2._pack_meta's layout), each pixel's emitted byte count with its
// exclusive prefix sum (the byte offsets), and the compaction of the
// emitting pixels.
//
// Bound on the H100: bytes. It must read the (B, N) packed pixels once (up
// to n_valid) and write one (offset, pixel, meta) triple per emitting pixel;
// the rest is a few dozen integer operations a pixel.
//
// Design: the TPU version walks its tiles in order and carries the previous
// pixel, the last change and both cursors in SMEM. Here one launch chains
// the 4096-pixel tiles of each row by two decoupled look-backs
// (lookback.cuh), in the order their values depend on each other:
//   1. the block takes the next tile from a counter and stages its pixels
//      (up to n_valid and no further) in shared memory by 16-byte vectors,
//      and the pixel before it (init_prev at a row's start); a tile wholly
//      past n_valid returns at once (no later tile of its row waits on it);
//   2. each thread compares its 16 consecutive pixels with their
//      predecessors (an XOR swizzle keeps both the vector stores and the
//      threads' runs free of bank conflicts); the block max-scans the
//      threads' last changes, and warp 0 looks back for the last change
//      before the tile. Change positions grow with the tile, so the nearest
//      predecessor with a change holds the answer: a tile with a change
//      publishes it as its inclusive prefix at once (from its last 32
//      pixels, before the walk, where it lies there), and a look-back stops
//      at the first word that holds a change or an inclusive prefix. Values
//      are biased (position + 513, 0 for none: lc0 = -(run_in + 1) is at
//      least -512) and lc0 stands in for none;
//   3. each thread walks its pixels from the last change before its first
//      (the tile's, or an earlier thread's in the tile): pending flush,
//      BIGRUN, class, op length and meta word; it keeps the metas and the
//      byte counts (4 bits a pixel) in registers. The block scans the
//      (entries, bytes) pairs and warp 0 looks back over them (one 64-bit
//      status word: bytes in 32 bits, entries in 30);
//   4. every emitting pixel goes to its rank in a shared-memory buffer, one
//      stream at a time (offsets, pixels, metas), and leaves as one
//      contiguous run of vector stores. The tile holding the row's last
//      valid pixel (tile 0 when n_valid is 0) writes the three per-row
//      scalars: no atomic.

#include <climits>

#include "lookback.cuh"

namespace {

using lb::u64;

constexpr int IPT = lb::IPT;
constexpr int TILE = lb::TILE;
constexpr int LC_BIAS = 513;  // a biased last change is >= 1; 0 is none

enum { CL_LUMA = 0, CL_RGB = 1, CL_MONO_GA = 2, CL_NONE = 7 };

__device__ __forceinline__ int w8(int x) { return ((x + 128) & 255) - 128; }

// Element e of the pixel tile lives at swz(e): an XOR of its low 4 bits
// with bits 5-8, a permutation inside every 16 elements. A thread's run
// (16t + j for fixed j over a warp) and a warp's vector stores (4i + c)
// both land on 32 distinct banks.
__device__ __forceinline__ int swz(int e) { return e ^ ((e >> 5) & 15); }

struct SwzI32 {  // TileLoad's put and store_tile's get
  int* s;
  __device__ void vec(int e, uint4 q) const {
    s[swz(e)] = (int)q.x;
    s[swz(e + 1)] = (int)q.y;
    s[swz(e + 2)] = (int)q.z;
    s[swz(e + 3)] = (int)q.w;
  }
  __device__ void one(int e, int x) const { s[swz(e)] = x; }
  __device__ uint4 vec(int e) const {
    return make_uint4((unsigned)s[swz(e)], (unsigned)s[swz(e + 1)],
                      (unsigned)s[swz(e + 2)], (unsigned)s[swz(e + 3)]);
  }
  __device__ int one(int e) const { return s[swz(e)]; }
};

// (entries, bytes): entries below 2^30 (the wrapper's row limit), bytes
// mod 2^32 (the int32 offsets of the plain version's keys).
struct Sums {
  int cnt;
  unsigned bytes;
};

struct SumC {
  using T = Sums;
  __host__ __device__ static T ident() { return Sums{0, 0u}; }
  __device__ T operator()(T l, T r) const {
    return Sums{l.cnt + r.cnt, l.bytes + r.bytes};
  }
  __device__ static u64 pack(T v) {
    return (u64)v.bytes | ((u64)(unsigned)v.cnt << 32);
  }
  __device__ static T unpack(u64 w) {
    return Sums{(int)((w >> 32) & 0x3FFFFFFFu), (unsigned)w};
  }
};

__device__ __forceinline__ Sums shfl_up(Sums v, int d) {
  return Sums{lb::shfl_up(v.cnt, d), (unsigned)lb::shfl_up((int)v.bytes, d)};
}
__device__ __forceinline__ Sums shfl_down(Sums v, int d) {
  return Sums{lb::shfl_down(v.cnt, d),
              (unsigned)lb::shfl_down((int)v.bytes, d)};
}

// The biased last change before tile `tile` of a row whose status words
// start at st (0: none), by warp 0; agg is the tile's own (0: none). A
// tile with a change publishes it as its inclusive prefix before it looks
// back; one without publishes an empty aggregate, then its prefix.
__device__ u64 lastc_prefix(u64* st, int tile, u64 agg) {
  const int lane = threadIdx.x & 31;
  if (lane == 0)
    lb::st_status(st + tile,
                  (tile == 0 || agg != 0) ? lb::ST_PREFIX | agg : lb::ST_AGG);
  if (tile == 0) return 0;
  u64 ex = 0;
  for (int j = tile - 1;; j -= 32) {
    const int k = j - lane;
    u64 s = k >= 0 ? lb::ld_status(st + k) : lb::ST_PREFIX;
    while ((s >> lb::ST_SHIFT) == 0) {
      __nanosleep(32);
      s = lb::ld_status(st + k);
    }
    const u64 v = s & lb::VAL_MASK;
    const unsigned hit =
        __ballot_sync(lb::FULL, (s >> lb::ST_SHIFT) == 2 || v != 0);
    if (hit) {
      ex = __shfl_sync(lb::FULL, v, __ffs(hit) - 1);
      break;
    }
  }
  if (agg == 0 && lane == 0) lb::st_status(st + tile, lb::ST_PREFIX | ex);
  return ex;
}

// The op of a change pixel: its length and the meta word's class and delta
// fields (pending is or-ed in by the caller). colch 1 keeps r = b = 0, so
// the reference's shared LUMA guard sees vg_r = vg_b = -vg: the mono
// window is vg in [-7, 8].
template <int COLCH>
__device__ __forceinline__ uint32_t op_meta(int cur, int prev, int* op_len) {
  const int vg = w8(((cur >> 8) & 255) - ((prev >> 8) & 255));
  const int va = w8(((cur >> 24) & 255) - ((prev >> 24) & 255));
  int vg_r = 0, vg_b = 0, cls;
  if (COLCH == 3) {
    vg_r = w8(w8((cur & 255) - (prev & 255)) - vg);
    vg_b = w8(w8(((cur >> 16) & 255) - ((prev >> 16) & 255)) - vg);
    const bool luma_ok = vg_r >= -8 && vg_r <= 7 && vg >= -32 && vg <= 31 &&
                         vg_b >= -8 && vg_b <= 7 && va >= -16 && va <= 15;
    cls = luma_ok ? CL_LUMA : CL_RGB;
    *op_len = (luma_ok ? 2 : 4) + (va != 0);
  } else {
    const bool luma_ok = vg >= -7 && vg <= 8 && va >= -16 && va <= 15;
    cls = va != 0 ? CL_MONO_GA : (luma_ok ? CL_LUMA : CL_RGB);
    *op_len = va != 0 ? 3 : (luma_ok ? 1 : 2);
  }
  return ((uint32_t)cls << 9) | ((uint32_t)((vg + 32) & 63) << 12) |
         ((uint32_t)((vg_r + 8) & 15) << 18) |
         ((uint32_t)((vg_b + 8) & 15) << 22) |
         ((uint32_t)((va + 16) & 31) << 26) | ((uint32_t)(va != 0) << 31);
}

// A repeated pixel's meta word: class none, every delta 0.
template <int COLCH>
__device__ __forceinline__ uint32_t none_meta() {
  return ((uint32_t)CL_NONE << 9) | (32u << 12) | (8u << 18) | (8u << 22) |
         (16u << 26);
}

// Four blocks an SM: 32 KB of shared memory each (the pixel tile and the
// output buffer), at most 64 registers a thread, no spills (measured
// faster than three blocks with 80 registers, and than five or six, which
// spill).
template <int COLCH>
__global__ void __launch_bounds__(NT, 4)
    k3_tiles(const int* px, long long N, int nt, const int* nvalid,
             const int* init_prev, const int* lc0, u64* st_lc, u64* st_sum,
             unsigned* counter, int* keys, int* curs, int* metas,
             int* entry_totals, int* chunk_totals, int* last_change) {
  __shared__ __align__(16) int s_px[TILE];
  __shared__ __align__(16) int s_out[TILE];
  __shared__ int itot[lb::NW + 1];
  __shared__ Sums stot[lb::NW + 1];
  __shared__ int s_id, s_prev, s_lc;
  __shared__ Sums s_pre;
  const int id = lb::next_tile(counter, &s_id);
  const int row = id / nt, tile = id - row * nt;
  const long long base = (long long)tile * TILE;
  const int nv = (int)min(max((long long)nvalid[row], 0LL), N);
  if (tile > 0 && base >= nv) return;
  const int n = (int)min((long long)TILE, max((long long)nv - base, 0LL));
  const int* prow = px + row * N;
  {
    lb::TileLoad<int> ld;
    ld.load(prow + base, n);
    if (threadIdx.x == 0) s_prev = base > 0 ? prow[base - 1] : init_prev[row];
    ld.put(SwzI32{s_px});
  }
  __syncthreads();
  // a change among the tile's last 32 pixels is its last change: publish
  // it before the walk, so that the next tile's look-back meets it sooner
  // (lastc_prefix publishes the same word again)
  if (threadIdx.x < 32) {
    const int e = n - 32 + (int)threadIdx.x;
    const bool c =
        e >= 0 && s_px[swz(e)] != (e > 0 ? s_px[swz(e - 1)] : s_prev);
    const unsigned m = __ballot_sync(lb::FULL, c);
    if (m && threadIdx.x == 0)
      lb::st_status(st_lc + (long long)row * nt + tile,
                    lb::ST_PREFIX | (u64)(base + n - 1 - __clz(m) + LC_BIAS));
  }

  // --- the thread's changes; the last change before the tile ------------
  const int i0 = threadIdx.x * IPT;
  const int mine = min(max(n - i0, 0), IPT);  // the thread's valid pixels
  const int prev0 = i0 > 0 ? s_px[swz(i0 - 1)] : s_prev;
  unsigned chm = 0;  // bit j: pixel j changes
  {
    int prev = prev0;
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      const int cur = s_px[swz(i0 + j)];
      if (j < mine && cur != prev) chm |= 1u << j;
      prev = cur;
    }
  }
  int agg_l;
  const int ex_l = lb::block_scan_warp(chm ? i0 + 31 - __clz(chm) : -1, -1,
                                       itot, &agg_l, MaxOp());
  if (threadIdx.x < 32) {
    const u64 ex = lastc_prefix(st_lc + (long long)row * nt, tile,
                                agg_l >= 0 ? (u64)(base + agg_l + LC_BIAS) : 0);
    if (threadIdx.x == 0) s_lc = ex ? (int)(ex - LC_BIAS) : lc0[row];
  }
  __syncthreads();
  const int lc_in = s_lc;

  // --- each pixel's op, meta and bytes; the tile's (entries, bytes) prefix
  int lastc = ex_l >= 0 ? (int)base + ex_l : lc_in;
  uint32_t meta[IPT];
  uint32_t nib[IPT / 8] = {};  // byte count of pixel j in bits 4(j%8)..
  Sums acc = SumC::ident();
  {
    int prev = prev0;
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      const int cur = s_px[swz(i0 + j)];
      const int g = (int)base + i0 + j;
      int tl;
      if ((chm >> j) & 1u) {
        const int pending = (g - 1 - lastc) & 511;
        const int flush = pending > 0 ? (((pending - 1) * 538) >> 15) + 1 : 0;
        int op_len;
        meta[j] = op_meta<COLCH>(cur, prev, &op_len) | (uint32_t)pending;
        tl = flush + op_len;
        lastc = g;
      } else {
        meta[j] = none_meta<COLCH>();
        tl = j < mine && ((g - lastc) & 511) == 0;  // a BIGRUN
      }
      nib[j >> 3] |= (uint32_t)tl << (4 * (j & 7));
      acc.cnt += tl > 0;
      acc.bytes += (unsigned)tl;
      prev = cur;
    }
  }
  Sums agg;
  const Sums ex = lb::block_scan_warp(acc, SumC::ident(), stot, &agg, SumC());
  if (threadIdx.x < 32) {
    const Sums p =
        lb::tile_prefix<SumC>(st_sum + (long long)row * nt, tile, agg);
    if (threadIdx.x == 0) s_pre = p;
  }
  __syncthreads();
  const Sums pre = s_pre;
  if (threadIdx.x == 0 && tile == max(nv - 1, 0) / TILE) {
    entry_totals[row] = pre.cnt + agg.cnt;
    chunk_totals[row] = (int)(pre.bytes + agg.bytes);
    last_change[row] = agg_l >= 0 ? (int)base + agg_l : lc_in;
  }

  // --- the emitting pixels at their ranks, one stream at a time ----------
  if (agg.cnt == 0) return;
  const long long out = (long long)row * N + pre.cnt;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    int r = ex.cnt;
    unsigned b = pre.bytes + ex.bytes;
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      const unsigned tl = (nib[j >> 3] >> (4 * (j & 7))) & 15u;
      if (tl) {
        // ranks about 16 apart from thread to thread: swizzled, as the
        // pixels are, so that a warp's writes fall on distinct banks
        s_out[swz(r++)] =
            q == 0 ? (int)b : q == 1 ? s_px[swz(i0 + j)] : (int)meta[j];
        b += tl;
      }
    }
    __syncthreads();
    lb::store_tile(q == 0 ? keys + out : q == 1 ? curs + out : metas + out,
                   agg.cnt, SwzI32{s_out});
    __syncthreads();
  }
}

}  // namespace

// px (B, N) i32 packed pixels, N < 2^30, any row alignment; nvalid,
// init_prev, lc0 (B,) i32 (nvalid read as clamped to [0, N]; lc0 =
// -(run_in + 1), -1 for a whole image). scratch: 2 * (2 * B * ceil(N / 4096) + 1) i32 (a 64-bit
// tile counter and two 64-bit status words a tile), zeroed here
// (ops/encode_front.py:scratch_words). keys/curs/metas (B, N) i32; the
// three (B,) scalar outputs i32. One memset and one launch; returns
// cudaGetLastError.
extern "C" int k3_encode_front(const int* px, const int* nvalid,
                               const int* init_prev, const int* lc0, int B,
                               long long N, int colch, int* scratch,
                               int* keys, int* curs, int* metas,
                               int* entry_totals, int* chunk_totals,
                               int* last_change, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || N <= 0) return 0;
  if (N >= (1LL << 30) || (colch != 1 && colch != 3))
    return (int)cudaErrorInvalidValue;
  const long long nt = (N + TILE - 1) / TILE;
  const long long tiles = B * nt;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  u64* words = reinterpret_cast<u64*>(scratch);
  const cudaError_t e = lb::lb_scratch(words, 2 * tiles, st);
  if (e != cudaSuccess) return (int)e;
  u64* st_lc = words + 1;
  u64* st_sum = st_lc + tiles;
  unsigned* counter = reinterpret_cast<unsigned*>(words);
  if (colch == 3)
    k3_tiles<3><<<(unsigned)tiles, NT, 0, st>>>(
        px, N, (int)nt, nvalid, init_prev, lc0, st_lc, st_sum, counter, keys,
        curs, metas, entry_totals, chunk_totals, last_change);
  else
    k3_tiles<1><<<(unsigned)tiles, NT, 0, st>>>(
        px, N, (int)nt, nvalid, init_prev, lc0, st_lc, st_sum, counter, keys,
        curs, metas, entry_totals, chunk_totals, last_change);
  return (int)cudaGetLastError();
}
