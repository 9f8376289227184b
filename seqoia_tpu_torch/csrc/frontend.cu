// K1: SQOA decode front-end, bytes -> compacted op stream.
//
// Replaces seqoia_tpu/ops/pallas_frontend.py:decode_front_compact (kernel
// _front_compact_kernel, tile body _front_body): the token automaton, the
// per-op pixel counts and their exclusive offsets, the segmented per-byte
// mod-256 channel sum between absolute anchors (packed RGBA), the
// foreign/REF flag and the order-preserving compaction of the ops.
//
// Bound on the H100: bytes. It must read the (B, M) stream once (up to the
// stream's end) and write one (key, payload) pair per op; everything else
// is integer work, a few dozen operations a byte.
//
// Design: the TPU version walks tiles in order and carries the automaton
// map, the channel sum and the cursors in SMEM. Here one launch chains the
// 4096-byte tiles of each row by three decoupled look-backs
// (lookback.cuh), in the order their values depend on each other:
//   1. the block takes the next tile from a counter and stages its bytes
//      and an 8-byte halo (operands and the absorbed alpha modifier sit at
//      most 5 bytes after an op) in shared memory by 16-byte vectors, up to
//      the stream's end and no further; a tile wholly past it returns at
//      once (nothing after it has an op, so nothing waits on it);
//   2. each thread takes its 16 bytes and the halo into registers (two
//      vector reads of shared memory, no bank conflicts), computes the
//      token lengths four bytes at a time (per-byte SIMD compares), and
//      composes its automaton map with a SWAR step of 8 integer operations
//      a byte; the block scans the maps
//      by warp shuffles and warp 0 looks back over the tiles' composed
//      maps (Compose6, 18 bits): the tile's entry state is the exclusive
//      map applied to state 0;
//   3. each thread runs the automaton over its bytes from its entry state
//      and lists its ops' bytes, in order, in shared memory; the ops (0.35
//      to 1 a byte) are then dealt out as runs of consecutive ops, the
//      same number to every thread, so no lane idles while another walks
//      a byte that starts no op;
//   4. each thread folds its ops' channel elements (Chan, computed from
//      the staged bytes and kept in shared memory for step 5); the block
//      scans them, then warp 0 looks back over the (val, flg) part (34
//      bits, folded right to left: it does not commute) and warp 1 over
//      the (op count, saturating pixel count) part (62 bits). ChanOp
//      combines the two parts independently, so the split is exact;
//   5. each thread folds its ops' elements from its prefix and places
//      every op whose key < n_max at its rank in shared memory; the tile's
//      run leaves as one contiguous stretch of vector stores a stream. The
//      tile in which the pixel count reaches n_max, or else the row's last
//      tile with bytes before the stream's end, writes totals[row]: no
//      atomic.
//
// Segment mode (k > 1) keeps the passes of its first port, in their own
// section below: a row of M bytes packs k small images, image j in bytes
// [j*seg, (j+1)*seg) with its header, each decoding to exactly seg_px
// pixels. The TPU kernel restarts its carried scans there with a reset map,
// an injected anchor and a flagged in-tile prefix. Here the segments are
// independent: every segment is a scan row of its own (the grid runs over
// B*k rows of seg bytes, so no scan needs a reset), keys come out global
// (j*seg_px + offset), ops whose offset reaches seg_px are dropped (a
// suffix of their segment), and the scans run reduce-then-scan across
// blocks:
//   k1_maps      per block: composed automaton map of its 4096 bytes
//   scan         per segment: exclusive composition of the block maps
//   k1_chan      per block: entry state -> token walk -> block aggregate of
//                (SWAR channel sum + flags, op count, pixel count); REF flag
//   scan         per segment: exclusive scan of the channel aggregates
//   k1_segcount  per block: the segment's ops below seg_px (from the block
//                aggregates; only a block that straddles seg_px walks)
//   scan         per packed row: exclusive sum of its segments' counts
//   k1_emit      per block: redo the walk with its prefix and write each op
//                at its rank.
// A segment below 4096 bytes leaves its block underfilled.

#include <climits>

#include "lookback.cuh"

namespace {

using lb::u64;

constexpr int IPT = 16;
constexpr int CHUNK = NT * IPT;  // bytes a block (= lb::TILE)
constexpr int HALO = 8;
constexpr long long HDR1 = 15;  // header + start byte: first op position

enum { MODE_ALPHA = 0, MODE_NOALPHA = 1, MODE_MONO = 2 };

// 6-state automaton (state = bytes left to skip), one 3-bit digit per
// state: digit e of a map is the state after the byte when entering in e.
constexpr uint32_t IDENT6 =
    (0u << 0) | (1u << 3) | (2u << 6) | (3u << 9) | (4u << 12) | (5u << 15);
constexpr uint32_t BASE6 =
    (0u << 3) | (1u << 6) | (2u << 9) | (3u << 12) | (4u << 15);

struct Compose6 {  // apply l, then r
  __device__ uint32_t operator()(uint32_t l, uint32_t r) const {
    uint32_t out = 0;
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const uint32_t fe = (l >> (3 * e)) & 7u;
      out |= ((r >> (3 * fe)) & 7u) << (3 * e);
    }
    return out;
  }
};

// Segmented per-byte channel sum: flg bit 0 resets r,g,b, bit 1 resets a.
struct Chan {
  uint32_t val, flg;
  int cnt, npix;
};

// The (val, flg) part of ChanOp: left then right.
__device__ __forceinline__ void val_op(uint32_t lv, uint32_t lf, uint32_t rv,
                                       uint32_t rf, uint32_t* ov,
                                       uint32_t* of) {
  const uint32_t s =
      ((lv & 0x7F7F7F7Fu) + (rv & 0x7F7F7F7Fu)) ^ ((lv ^ rv) & 0x80808080u);
  const uint32_t m =
      ((rf & 1u) ? 0x00FFFFFFu : 0u) | ((rf & 2u) ? 0xFF000000u : 0u);
  *ov = (rv & m) | (s & ~m);
  *of = (lf | rf) & 3u;
}

// Saturating pixel counts (both are at most INT_MAX, so the unsigned sum is
// exact): 4 MiB of BIGRUN bytes count 2^31 pixels, and a wrapped offset
// would pass the key < n_max test that the plain version's int64 keys fail.
__device__ __forceinline__ int sat_add(int a, int b) {
  return (int)min((unsigned)a + (unsigned)b, (unsigned)INT_MAX);
}

struct ChanOp {
  __device__ Chan operator()(const Chan& l, const Chan& r) const {
    Chan o;
    val_op(l.val, l.flg, r.val, r.flg, &o.val, &o.flg);
    o.cnt = l.cnt + r.cnt;
    o.npix = sat_add(l.npix, r.npix);
    return o;
  }
};

__host__ __device__ __forceinline__ Chan chan_ident() {
  Chan c;
  c.val = 0;
  c.flg = 0;
  c.cnt = 0;
  c.npix = 0;
  return c;
}

// Channel element, pixel count and foreign flag of the op whose bytes are
// b0..b4, with alpha modifier delta att.
__device__ __forceinline__ Chan op_elem_b(int b0, int b1, int b2, int b3,
                                          int b4, int att, int mode,
                                          bool* foreign) {
  const bool luma = (b0 & 0xC0) == 0x80, rgb = b0 == 0xFE, rgba = b0 == 0xFF;
  const int vg = (b0 & 0x3F) - 32;
  const bool anc = rgb || rgba;
  const bool anc_a = rgba && mode != MODE_NOALPHA;
  int r = 0, g = 0, bl = 0, a = 0;
  if (mode == MODE_MONO) {  // gray rides byte lane 0, alpha lane 3
    r = anc ? b1 : (luma ? vg : 0);
    a = anc_a ? b2 : 0;
  } else {
    r = anc ? b1 : (luma ? vg - 8 + ((b1 >> 4) & 15) : 0);
    g = anc ? b2 : (luma ? vg : 0);
    bl = anc ? b3 : (luma ? vg - 8 + (b1 & 15) : 0);
    a = anc_a ? b4 : 0;
    if (mode == MODE_ALPHA) a += att;
  }
  int npix = (b0 & 0x3F) + 1;  // any unmatched byte is a run
  if (luma || anc) npix = 1;
  if (b0 == 0xFD) npix = 512;  // BIGRUN
  if (b0 < 0x60) npix = 1;     // REF: the stream falls back anyway
  *foreign = mode == MODE_NOALPHA ? (b0 < 0x80 || rgba) : (b0 < 0x60);
  Chan e;
  e.val = (uint32_t)(r & 255) | ((uint32_t)(g & 255) << 8) |
          ((uint32_t)(bl & 255) << 16) | ((uint32_t)(a & 255) << 24);
  e.flg = (anc ? 1u : 0u) | (anc_a ? 2u : 0u);
  e.cnt = 1;
  e.npix = npix;
  return e;
}

// The packed RGBA payload after an op (alpha starts at 255).
__device__ __forceinline__ int payload(const Chan& run) {
  uint32_t a = (run.val >> 24) & 255u;
  if (!(run.flg & 2u)) a = (a + 255u) & 255u;
  return (int)((run.val & 0x00FFFFFFu) | (a << 24));
}

// ===== one row a scan (k == 1): one launch, three look-backs a tile =====

// Status words of the three look-backs (lookback.cuh's C interface).
struct MapC {
  using T = uint32_t;
  __host__ __device__ static T ident() { return IDENT6; }
  __device__ T operator()(T l, T r) const { return Compose6()(l, r); }
  __device__ static u64 pack(T v) { return v; }
  __device__ static T unpack(u64 w) { return (T)w; }
};

struct Val {
  uint32_t val, flg;
};

struct ValC {
  using T = Val;
  __host__ __device__ static T ident() { return Val{0, 0}; }
  __device__ T operator()(T l, T r) const {
    T o;
    val_op(l.val, l.flg, r.val, r.flg, &o.val, &o.flg);
    return o;
  }
  __device__ static u64 pack(T v) { return (u64)v.val | ((u64)v.flg << 32); }
  __device__ static T unpack(u64 w) {
    return Val{(uint32_t)w, (uint32_t)(w >> 32) & 3u};
  }
};

struct Cnt {
  int cnt, npix;
};

struct CntC {  // op count (below 2^31: M is) and saturating pixel count
  using T = Cnt;
  __host__ __device__ static T ident() { return Cnt{0, 0}; }
  __device__ T operator()(T l, T r) const {
    return Cnt{l.cnt + r.cnt, sat_add(l.npix, r.npix)};
  }
  __device__ static u64 pack(T v) {
    return (u64)(unsigned)v.cnt | ((u64)(unsigned)v.npix << 31);
  }
  __device__ static T unpack(u64 w) {
    return Cnt{(int)(w & 0x7FFFFFFFu), (int)((w >> 31) & 0x7FFFFFFFu)};
  }
};

__device__ __forceinline__ Val shfl_down(Val v, int d) {
  return Val{(uint32_t)lb::shfl_down((int)v.val, d),
             (uint32_t)lb::shfl_down((int)v.flg, d)};
}
__device__ __forceinline__ Cnt shfl_down(Cnt v, int d) {
  return Cnt{lb::shfl_down(v.cnt, d), lb::shfl_down(v.npix, d)};
}
__device__ __forceinline__ Chan shfl_up(Chan c, int d) {
  Chan o;
  o.val = (uint32_t)lb::shfl_up((int)c.val, d);
  o.flg = (uint32_t)lb::shfl_up((int)c.flg, d);
  o.cnt = lb::shfl_up(c.cnt, d);
  o.npix = lb::shfl_up(c.npix, d);
  return o;
}

// The composed map after one more byte of token length c + 1: a digit in
// a nonzero state steps down, a digit in state 0 starts a token (c bytes
// left to skip). The same as Compose6(m, BASE6 + c), by SWAR.
__device__ __forceinline__ uint32_t step6(uint32_t m, uint32_t c) {
  constexpr uint32_t LOW = 0x9249u;  // bit 0 of each 3-bit digit
  const uint32_t nz = (m | (m >> 1) | (m >> 2)) & LOW;
  return (m - nz) | ((LOW & ~nz) * c);
}

// A thread's 16 bytes and the 8 after them, in registers; k is a constant
// wherever the loops below are unrolled.
struct Run {
  uint32_t w[6];
  __device__ __forceinline__ int b(int k) const {
    return (w[k >> 2] >> (8 * (k & 3))) & 255;
  }
};

// Token length at byte j (the length the automaton skips); in mode alpha an
// op absorbs a following alpha-range byte (the reference's one alpha peek
// after every op), *att being that modifier's delta.
template <int MODE>
__device__ __forceinline__ int tok_len(const Run& r, int j, int* att) {
  const int b = r.b(j);
  const int luma = (b & 0xC0) == 0x80, rgb = b == 0xFE, rgba = b == 0xFF;
  *att = 0;
  if (MODE == MODE_MONO) return 1 + rgb + 2 * rgba;
  if (MODE == MODE_NOALPHA) return 1 + luma + 3 * rgb;
  const int len = 1 + luma + 3 * rgb + 4 * rgba;  // 1, 2, 4 or 5
  const int nx = len == 1   ? r.b(j + 1)
                 : len == 2 ? r.b(j + 2)
                 : len == 4 ? r.b(j + 4)
                            : r.b(j + 5);
  if (nx >= 0x60 && nx < 0x80) {
    *att = (nx & 31) - 16;
    return len + 1;
  }
  return len;
}

// Token length - 1 of bytes 4q..4q+3 of the run, one a byte, four at a
// time by per-byte SIMD compares (the same lengths as tok_len).
template <int MODE>
__device__ __forceinline__ uint32_t lens4(const Run& r, int q) {
  const uint32_t w = r.w[q];
  const uint32_t luma = __vcmpeq4(w & 0xC0C0C0C0u, 0x80808080u);
  const uint32_t rgb = __vcmpeq4(w, 0xFEFEFEFEu);
  const uint32_t rgba = __vcmpeq4(w, 0xFFFFFFFFu);
  if (MODE == MODE_MONO) return (rgb & 0x01010101u) | (rgba & 0x02020202u);
  if (MODE == MODE_NOALPHA) return (luma & 0x01010101u) | (rgb & 0x03030303u);
  // in alpha-range flags of the bytes k after each byte
  const auto alpha_after = [&](int k) {
    const uint32_t x =
        __funnelshift_r(r.w[q + (k >> 2)], r.w[q + (k >> 2) + 1], 8 * (k & 3));
    return __vcmpeq4(x & 0xE0E0E0E0u, 0x60606060u);
  };
  const uint32_t one = ~(luma | rgb | rgba);
  const uint32_t ext = (one & alpha_after(1)) | (luma & alpha_after(2)) |
                       (rgb & alpha_after(4)) | (rgba & alpha_after(5));
  return ((luma & 0x01010101u) | (rgb & 0x03030303u) | (rgba & 0x04040404u)) +
         (ext & 0x01010101u);
}

// The channel element and foreign flag of the op at byte p of the staged
// tile: its bytes p..p+7 from three words of shared memory (funnel
// shifts), its alpha modifier found again from its length.
template <int MODE>
__device__ __forceinline__ Chan elem_at(const uint8_t* s, int p, bool* f) {
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(s);
  const int q = p >> 2, sh = 8 * (p & 3);
  const uint32_t w0 = sw[q], w1 = sw[q + 1], w2 = sw[q + 2];
  Run r;
  r.w[0] = __funnelshift_r(w0, w1, sh);
  r.w[1] = __funnelshift_r(w1, w2, sh);
  int att;
  tok_len<MODE>(r, 0, &att);
  return op_elem_b(r.b(0), r.b(1), r.b(2), r.b(3), r.b(4), att, MODE, f);
}

// Six blocks an SM: 37 KB of shared memory each (the byte tile and the two
// staging arrays), at most 40 registers a thread (measured faster than
// four or five blocks on the 227 MB row, with no spills).
template <int MODE>
__global__ void __launch_bounds__(NT, 6)
    k1_tiles(const uint8_t* data, long long M, int nt, const int* clen,
             int n_max, u64* st_map, u64* st_val, u64* st_cnt,
             unsigned* counter, int* keys, int* pays, int* totals,
             int* has_ref) {
  __shared__ __align__(16) uint8_t s[CHUNK + 16];
  // op k of the tile, at each step: its staged byte (stage_p[k]), then its
  // element (val; npix | flg << 16), then its key and payload. Only the
  // thread whose run holds k touches entry k between the barriers.
  __shared__ __align__(16) int stage_k[CHUNK];
  __shared__ __align__(16) int stage_p[CHUNK];
  __shared__ uint32_t mtot[lb::NW + 1];
  __shared__ int itot[lb::NW + 1];
  __shared__ Chan ctot[lb::NW + 1];
  __shared__ uint32_t s_map;
  __shared__ Val s_val;
  __shared__ Cnt s_cnt;
  __shared__ int s_id, s_emit;
  const int id = lb::next_tile(counter, &s_id);
  const int row = id / nt, tile = id - row * nt;
  const long long base = (long long)tile * CHUNK;
  // ops start before live_end only; the tiles from here on have none
  const long long live_end = min((long long)clen[row], M);
  if (base >= live_end) return;
  const int n =
      (int)min(min(M, live_end + HALO) - base, (long long)(CHUNK + HALO));
  lb::load_tile(data + row * M + base, n, lb::BytePut{s});
  for (int i = n + threadIdx.x; i < CHUNK + 16; i += NT) s[i] = 0;
  if (threadIdx.x == 0) s_emit = 0;
  __syncthreads();

  // --- the thread's bytes, token lengths and automaton map --------------
  const int i0 = threadIdx.x * IPT;
  Run r;
  {
    const uint4 a = *reinterpret_cast<const uint4*>(s + i0);
    const uint2 h = *reinterpret_cast<const uint2*>(s + i0 + IPT);
    r.w[0] = a.x, r.w[1] = a.y, r.w[2] = a.z, r.w[3] = a.w;
    r.w[4] = h.x, r.w[5] = h.y;
  }
  const long long p0 = base + i0;
  // bytes of the run before the first op position; bytes that may start an
  // op (before the stream's end)
  const int lo = (int)min(max(HDR1 - p0, 0LL), (long long)IPT);
  const int hi = (int)min(max(live_end - p0, 0LL), (long long)IPT);
  uint32_t lm1[IPT / 4];  // token length - 1 of byte j in byte j of lm1
#pragma unroll
  for (int q = 0; q < IPT / 4; ++q) lm1[q] = lens4<MODE>(r, q);
  if (lo > 0) {  // the header: one byte a step
#pragma unroll
    for (int j = 0; j < IPT; ++j)
      if (j < lo) lm1[j >> 2] &= ~(0xFFu << (8 * (j & 3)));
  }
  uint32_t map = IDENT6;
#pragma unroll
  for (int j = 0; j < IPT; ++j)
    map = step6(map, (lm1[j >> 2] >> (8 * (j & 3))) & 7u);
  uint32_t agg_map;
  const uint32_t ex_map =
      lb::block_scan_warp(map, IDENT6, mtot, &agg_map, Compose6());
  if (threadIdx.x < 32) {
    const uint32_t t =
        lb::tile_prefix<MapC>(st_map + (long long)row * nt, tile, agg_map);
    if (threadIdx.x == 0) s_map = t;
  }
  __syncthreads();
  const int state0 = (int)((ex_map >> (3 * (s_map & 7u))) & 7u);

  // --- the tile's ops in order: their bytes, listed in shared memory ----
  uint32_t tm = 0;  // bit j: byte j starts an op
  int state = state0;
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    if (state == 0 && j >= lo && j < hi) tm |= 1u << j;
    state = state == 0 ? (int)((lm1[j >> 2] >> (8 * (j & 3))) & 7u)
                       : state - 1;
  }
  int n_ops;
  int o = lb::block_scan_warp(__popc(tm), 0, itot, &n_ops, lb::WordSum());
  for (; tm; tm &= tm - 1) stage_p[o++] = i0 + __ffs(tm) - 1;
  __syncthreads();

  // --- each thread's run of consecutive ops: its aggregate; the tile's
  // prefix by look-back ----------------------------------------------------
  const int per = (n_ops + NT - 1) / NT;
  const int o0 = min((int)threadIdx.x * per, n_ops);
  const int o1 = min(o0 + per, n_ops);
  Chan acc = chan_ident();
  bool fr = false;
  for (int k = o0; k < o1; ++k) {
    bool f;
    const Chan e = elem_at<MODE>(s, stage_p[k], &f);
    acc = ChanOp()(acc, e);
    fr |= f;
    stage_k[k] = (int)e.val;
    stage_p[k] = e.npix | (int)(e.flg << 16);  // npix <= 512
  }
  Chan agg;
  const Chan ex = lb::block_scan_warp(acc, chan_ident(), ctot, &agg, ChanOp());
  if (threadIdx.x < 32) {
    const Val v = lb::tile_prefix<ValC>(st_val + (long long)row * nt, tile,
                                        Val{agg.val, agg.flg});
    if (threadIdx.x == 0) s_val = v;
  } else if (threadIdx.x < 64) {
    const Cnt c = lb::tile_prefix<CntC>(st_cnt + (long long)row * nt, tile,
                                        Cnt{agg.cnt, agg.npix});
    if (threadIdx.x == 32) s_cnt = c;
  }
  if (__syncthreads_or(fr) && threadIdx.x == 0) atomicOr(has_ref + row, 1);

  // --- every op below n_max to its rank in the tile -----------------------
  const Cnt tc = s_cnt;
  Chan run = chan_ident();
  run.val = s_val.val;
  run.flg = s_val.flg;
  run.cnt = tc.cnt;
  run.npix = tc.npix;
  run = ChanOp()(run, ex);
  int here = 0;
  for (int k = o0; k < o1; ++k) {
    Chan e;
    e.val = (uint32_t)stage_k[k];
    e.flg = (uint32_t)stage_p[k] >> 16;
    e.cnt = 1;
    e.npix = stage_p[k] & 0xFFFF;
    const int key = run.npix;
    run = ChanOp()(run, e);
    if (key < n_max) {  // offsets grow with rank: in-range ops are a prefix
      stage_k[k] = key;
      stage_p[k] = payload(run);
      ++here;
    }
  }
  if (here) atomicAdd(&s_emit, here);
  __syncthreads();
  const int n_emit = s_emit;
  if (n_emit) {
    const long long out = (long long)row * M + tc.cnt;
    lb::store_tile(keys + out, n_emit, lb::Linear{stage_k});
    lb::store_tile(pays + out, n_emit, lb::Linear{stage_p});
  }
  if (threadIdx.x == 0) {
    // the ops below n_max are a prefix of the row: the tile where the pixel
    // count reaches n_max holds its last one; if it is never reached, the
    // last tile with bytes before the stream's end holds the row's last op
    const int incl = sat_add(tc.npix, agg.npix);
    if (tc.npix < n_max && incl >= n_max)
      totals[row] = tc.cnt + n_emit;
    else if (incl < n_max && tile == (int)((live_end - 1) / CHUNK))
      totals[row] = tc.cnt + agg.cnt;
  }
}

int front_rows(const uint8_t* data, const int* clen, int B, long long M,
               int n_max, int mode, uint32_t* scratch, int* keys, int* pays,
               int* totals, int* has_ref, cudaStream_t st) {
  if (B <= 0 || M <= 0) return 0;
  if (M >= INT_MAX) return (int)cudaErrorInvalidValue;  // 31-bit op counts
  const long long nt = (M + CHUNK - 1) / CHUNK;
  const long long tiles = B * nt;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  u64* words = reinterpret_cast<u64*>(scratch);
  const cudaError_t e = lb::lb_scratch(words, 3 * tiles, st);
  if (e != cudaSuccess) return (int)e;
  u64* st_map = words + 1;
  u64* st_val = st_map + tiles;
  u64* st_cnt = st_val + tiles;
  unsigned* counter = reinterpret_cast<unsigned*>(words);
#define K1_LAUNCH(MODE)                                                    \
  k1_tiles<MODE><<<(unsigned)tiles, NT, 0, st>>>(                          \
      data, M, (int)nt, clen, n_max, st_map, st_val, st_cnt, counter, keys, \
      pays, totals, has_ref)
  switch (mode) {
    case MODE_ALPHA:
      K1_LAUNCH(MODE_ALPHA);
      break;
    case MODE_NOALPHA:
      K1_LAUNCH(MODE_NOALPHA);
      break;
    case MODE_MONO:
      K1_LAUNCH(MODE_MONO);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K1_LAUNCH
  return (int)cudaGetLastError();
}

// ===== segment mode (k > 1): reduce-then-scan over every segment =====

__device__ void load_chunk(const uint8_t* row, long long M, long long base,
                           uint8_t* s) {
  for (int i = threadIdx.x; i < CHUNK + HALO; i += NT) {
    const long long p = base + i;
    s[i] = p < M ? row[p] : 0;
  }
  __syncthreads();
}

// Token length at local byte i (the length the automaton skips): in mode
// alpha an op absorbs a following alpha-range byte (the reference's one
// alpha peek after every op); *att is that modifier's delta.
__device__ __forceinline__ int eff_len(const uint8_t* s, int i, long long pos,
                                       int mode, int* att) {
  const int b = s[i];
  const int luma = (b & 0xC0) == 0x80, rgb = b == 0xFE, rgba = b == 0xFF;
  int len;
  *att = 0;
  if (mode == MODE_MONO) {
    len = 1 + rgb + 2 * rgba;
  } else if (mode == MODE_NOALPHA) {
    len = 1 + luma + 3 * rgb;  // RGBA is foreign here: parsed as 1 byte
  } else {
    len = 1 + luma + 3 * rgb + 4 * rgba;
    const int nx = s[i + len];
    if (nx >= 0x60 && nx < 0x80) {
      *att = (nx & 31) - 16;
      len += 1;
    }
  }
  return pos >= HDR1 ? len : 1;
}

__device__ uint32_t thread_map(const uint8_t* s, long long base, int mode) {
  Compose6 c;
  uint32_t m = IDENT6;
  const int i0 = threadIdx.x * IPT;
  for (int j = 0; j < IPT; ++j) {
    int att;
    const int L = eff_len(s, i0 + j, base + i0 + j, mode, &att);
    m = c(m, (uint32_t)(L - 1) + BASE6);
  }
  return m;
}

// Channel element, pixel count and foreign flag of the op at local byte i.
__device__ __forceinline__ Chan op_elem(const uint8_t* s, int i, int att,
                                        int mode, bool* foreign) {
  return op_elem_b(s[i], s[i + 1], s[i + 2], s[i + 3], s[i + 4], att, mode,
                   foreign);
}

// Walk the thread's 16 bytes from automaton state `state`, calling
// f(i, att) at every token (op) position.
template <class F>
__device__ __forceinline__ void walk(const uint8_t* s, long long base,
                                     int state, int mode, long long clen,
                                     F f) {
  const int i0 = threadIdx.x * IPT;
  for (int j = 0; j < IPT; ++j) {
    const int i = i0 + j;
    const long long pos = base + i;
    int att;
    const int L = eff_len(s, i, pos, mode, &att);
    if (state == 0 && pos >= HDR1 && pos < clen) f(i, att);
    state = state == 0 ? L - 1 : state - 1;
  }
}

// Automaton state at the thread's first byte.
__device__ int entry_state(const uint8_t* s, long long base, int mode,
                           uint32_t blk_prefix, uint32_t* mbuf) {
  uint32_t tot;
  const uint32_t ex =
      block_scan_excl(thread_map(s, base, mode), IDENT6, mbuf, &tot,
                      Compose6());
  return (int)(Compose6()(blk_prefix, ex) & 7u);
}

// Block (x, y, z) of the grid works on bytes [base, base + CHUNK) of scan
// row z * gridDim.y + y, base = x * CHUNK: the rows fold over y and z (at
// most 65535 each), so no thread divides. g indexes the block aggregates.
struct Blk {
  unsigned row;
  long long g, base;
};

__device__ __forceinline__ Blk k1_block(int nblk) {
  Blk b;
  b.row = blockIdx.z * gridDim.y + blockIdx.y;
  b.g = (long long)b.row * nblk + blockIdx.x;
  b.base = (long long)blockIdx.x * CHUNK;
  return b;
}

__global__ void k1_maps(const uint8_t* data, long long M, unsigned R,
                        int nblk, int mode, uint32_t* blk_maps) {
  __shared__ uint8_t s[CHUNK + HALO];
  __shared__ uint32_t mbuf[NT];
  const Blk blk = k1_block(nblk);
  if (blk.row >= R) return;  // the fold's last z plane may be short
  const long long g = blk.g, row = blk.row, base = blk.base;
  load_chunk(data + row * M, M, base, s);
  uint32_t tot;
  block_scan_excl(thread_map(s, base, mode), IDENT6, mbuf, &tot, Compose6());
  if (threadIdx.x == 0) blk_maps[g] = tot;
}

__global__ void k1_chan(const uint8_t* data, long long M, unsigned R,
                        int nblk, int mode, const int* clen, const uint32_t* blk_map_ex, int k,
                        Chan* blk_chan, int* has_ref) {
  __shared__ uint8_t s[CHUNK + HALO];
  __shared__ uint32_t mbuf[NT];
  __shared__ Chan cbuf[NT];
  const Blk blk = k1_block(nblk);
  if (blk.row >= R) return;  // the fold's last z plane may be short
  const long long g = blk.g, row = blk.row, base = blk.base;
  load_chunk(data + row * M, M, base, s);
  const int st = entry_state(s, base, mode, blk_map_ex[g], mbuf);
  ChanOp op;
  Chan acc = chan_ident();
  bool fr = false;
  walk(s, base, st, mode, clen[row], [&](int i, int att) {
    bool f;
    acc = op(acc, op_elem(s, i, att, mode, &f));
    fr |= f;
  });
  Chan tot;
  block_scan_excl(acc, chan_ident(), cbuf, &tot, op);
  if (threadIdx.x == 0) blk_chan[g] = tot;
  if (fr) atomicOr(has_ref + blk.row / (unsigned)k, 1);  // per packed row
}

// Segment mode: seg_cnt[segment] += the block's ops whose offset in the
// segment is below seg_px. Offsets grow with rank, so a block wholly below
// seg_px counts its aggregate, one wholly past it counts nothing, and only a
// block that straddles seg_px walks its bytes.
__global__ void k1_segcount(const uint8_t* data, long long M, unsigned R,
                            int nblk, int mode, const int* clen,
                            const uint32_t* blk_map_ex, const Chan* blk_chan,
                            const Chan* blk_chan_ex, int seg_px,
                            int* seg_cnt) {
  __shared__ uint8_t s[CHUNK + HALO];
  __shared__ uint32_t mbuf[NT];
  __shared__ Chan cbuf[NT];
  const Blk blk = k1_block(nblk);
  if (blk.row >= R) return;  // the fold's last z plane may be short
  const long long g = blk.g, row = blk.row, base = blk.base;
  const Chan pre = blk_chan_ex[g], agg = blk_chan[g];
  if (pre.npix >= seg_px || agg.cnt == 0) return;
  if ((long long)pre.npix + agg.npix <= seg_px) {
    if (threadIdx.x == 0) atomicAdd(seg_cnt + row, agg.cnt);
    return;
  }
  load_chunk(data + row * M, M, base, s);
  const int st = entry_state(s, base, mode, blk_map_ex[g], mbuf);
  ChanOp op;
  Chan acc = chan_ident();
  walk(s, base, st, mode, clen[row], [&](int i, int att) {
    bool unused;
    acc = op(acc, op_elem(s, i, att, mode, &unused));
  });
  Chan tot;
  const Chan ex = block_scan_excl(acc, chan_ident(), cbuf, &tot, op);
  Chan run = op(pre, ex);
  int here = 0;
  walk(s, base, st, mode, clen[row], [&](int i, int att) {
    bool unused;
    here += run.npix < seg_px;
    run = op(run, op_elem(s, i, att, mode, &unused));
  });
  if (here) atomicAdd(seg_cnt + row, here);
}

// Scan row `row` is segment row % k of output row row / k: its keys start
// at (row % k) * seg_px and its ops rank after seg_base[row].
__global__ void k1_emit(const uint8_t* data, long long M, unsigned R,
                        int nblk, int mode, const int* clen, const uint32_t* blk_map_ex,
                        const Chan* blk_chan_ex, int seg_px, int k,
                        const int* seg_base, int* keys, int* pays,
                        int* totals) {
  __shared__ uint8_t s[CHUNK + HALO];
  __shared__ uint32_t mbuf[NT];
  __shared__ Chan cbuf[NT];
  const Blk blk = k1_block(nblk);
  if (blk.row >= R) return;  // the fold's last z plane may be short
  const long long g = blk.g, row = blk.row, base = blk.base;
  load_chunk(data + row * M, M, base, s);
  const int st = entry_state(s, base, mode, blk_map_ex[g], mbuf);
  ChanOp op;
  Chan acc = chan_ident();
  walk(s, base, st, mode, clen[row], [&](int i, int att) {
    bool unused;
    acc = op(acc, op_elem(s, i, att, mode, &unused));
  });
  Chan tot;
  const Chan ex = block_scan_excl(acc, chan_ident(), cbuf, &tot, op);
  Chan run = op(blk_chan_ex[g], ex);
  const unsigned orow = blk.row / (unsigned)k;
  const int kbase = (int)(blk.row - orow * (unsigned)k) * seg_px;
  const long long rbase = (long long)orow * (M * k) + seg_base[row];
  int* krow = keys + rbase;
  int* prow = pays + rbase;
  int here = 0;
  walk(s, base, st, mode, clen[row], [&](int i, int att) {
    bool f;
    const int key = run.npix;
    run = op(run, op_elem(s, i, att, mode, &f));
    if (key < seg_px) {  // offsets grow with rank: in-range ops are a prefix
      krow[run.cnt - 1] = kbase + key;
      prow[run.cnt - 1] = payload(run);
      ++here;
    }
  });
  if (here) atomicAdd(totals + orow, here);
}

}  // namespace

// data (B, M) u8, any row length and alignment. k = 1: clen (B,) i32 =
// stream length minus the end marker; scratch 2 * (3 * B * ceil(M / 4096)
// + 1) u32, zeroed here (one launch). k > 1 (segment mode): a row packs k
// images of seg = M / k bytes, clen is (B, k), relative to the segment,
// every image decodes to seg_px pixels and n_max = k * seg_px; scratch
// 10 * B * k * nblk + 2 * B * k u32 (nblk = ceil(seg / 4096)). Both sizes:
// ops/frontend.py:scratch_words. keys/pays (B, M) i32; totals, has_ref (B,)
// i32, zeroed by the caller. Returns cudaGetLastError.
extern "C" int k1_decode_front(const uint8_t* data, const int* clen, int B,
                               long long M, int n_max, int mode, int k,
                               int seg_px, uint32_t* scratch, int* keys,
                               int* pays, int* totals, int* has_ref,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k == 1)
    return front_rows(data, clen, B, M, n_max, mode, scratch, keys, pays,
                      totals, has_ref, st);
  const long long seg = M / k;
  const long long R = (long long)B * k;  // scan rows
  const int nblk = (int)((seg + CHUNK - 1) / CHUNK);
  const long long nb = R * nblk;
  if (nb > INT_MAX) return (int)cudaErrorInvalidValue;  // scratch indices
  if (nb == 0) return 0;
  uint32_t* blk_maps = scratch;
  uint32_t* blk_map_ex = scratch + nb;
  Chan* blk_chan = reinterpret_cast<Chan*>(scratch + 2 * nb);
  Chan* blk_chan_ex = reinterpret_cast<Chan*>(scratch + 6 * nb);
  int* seg_cnt = reinterpret_cast<int*>(scratch + 10 * nb);
  int* seg_base = seg_cnt + R;
  const unsigned rows = (unsigned)R, ry = rows < 65535u ? rows : 65535u;
  const dim3 grid(nblk, ry, (rows + ry - 1) / ry);
  k1_maps<<<grid, NT, 0, st>>>(data, seg, rows, nblk, mode, blk_maps);
  scan_blocks_kernel<uint32_t, Compose6><<<rows, NT, 0, st>>>(
      blk_maps, blk_map_ex, nullptr, nblk, IDENT6, Compose6());
  k1_chan<<<grid, NT, 0, st>>>(data, seg, rows, nblk, mode, clen, blk_map_ex,
                               k, blk_chan, has_ref);
  scan_blocks_kernel<Chan, ChanOp><<<rows, NT, 0, st>>>(
      blk_chan, blk_chan_ex, nullptr, nblk, chan_ident(), ChanOp());
  cudaMemsetAsync(seg_cnt, 0, R * sizeof(int), st);
  k1_segcount<<<grid, NT, 0, st>>>(data, seg, rows, nblk, mode, clen,
                                   blk_map_ex, blk_chan, blk_chan_ex, seg_px,
                                   seg_cnt);
  scan_blocks_kernel<int, SumOp><<<B, NT, 0, st>>>(seg_cnt, seg_base, nullptr,
                                                   k, 0, SumOp());
  k1_emit<<<grid, NT, 0, st>>>(data, seg, rows, nblk, mode, clen, blk_map_ex,
                               blk_chan_ex, seg_px, k, seg_base, keys, pays,
                               totals);
  return (int)cudaGetLastError();
}
