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
// Segment mode (k > 1) is one launch too, in its own section below: a row
// of M bytes packs k small images, image j in bytes [j*seg, (j+1)*seg)
// with its header, each decoding to exactly seg_px pixels. The TPU kernel
// restarts its carried scans there with a reset map, an injected anchor
// and a flagged in-tile prefix. Here a 4096-byte tile holds 4096/seg whole
// segments (segmented block scans, a flag at each segment start, no
// look-back of their own) or lies inside one (its maps and channel sums
// look back over that segment's tiles only); keys come out global (j *
// seg_px + offset), ops whose offset reaches seg_px are dropped (a suffix
// of their segment), and the kept ops of a packed row are ranked by one
// look-back over all its tiles. A segment's zero padding past its stream
// is neither read nor walked for ops.

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
// shifts), its alpha modifier found again from its length. In segment
// mode the bytes from `room` on lie past the op's segment and read as 0.
template <int MODE>
__device__ __forceinline__ Chan elem_at(const uint8_t* s, int p, bool* f,
                                        int room = 8) {
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(s);
  const int q = p >> 2, sh = 8 * (p & 3);
  const uint32_t w0 = sw[q], w1 = sw[q + 1], w2 = sw[q + 2];
  Run r;
  r.w[0] = __funnelshift_r(w0, w1, sh);
  r.w[1] = __funnelshift_r(w1, w2, sh);
  if (room < 8) {
    if (room < 4) r.w[0] &= (1u << (8 * room)) - 1u;
    r.w[1] &= room <= 4 ? 0u : (1u << (8 * (room - 4))) - 1u;
  }
  int att;
  tok_len<MODE>(r, 0, &att);
  return op_elem_b(r.b(0), r.b(1), r.b(2), r.b(3), r.b(4), att, MODE, f);
}

// The reference peeks for an alpha modifier after every op, the last one
// too (seqoia.h:777-783): at the first byte at or past the stream's end
// where the automaton is at state 0, in the end marker or past a last op
// whose body runs into it. Mode noalpha parses no modifier, so an
// alpha-range byte there flags the row, as one at an op position does.
// Its offset in the run of the one thread whose bytes 0 .. hi - 1 end the
// stream: the run's first state-0 byte from hi on (tz), or past the run,
// as many bytes on as the state after it (st). It lies at most 3 bytes
// past the end.
__device__ __forceinline__ int end_peek(uint32_t tz, int hi, int st) {
  const uint32_t up = tz >> hi;
  return up ? hi + __ffs(up) - 1 : IPT + st;
}

__device__ __forceinline__ bool is_alpha(int b) {
  return b >= 0x60 && b < 0x80;
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
  uint32_t tz = 0;  // bit j: the automaton is at state 0 at byte j
  int state = state0;
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    if (state == 0) tz |= 1u << j;
    state = state == 0 ? (int)((lm1[j >> 2] >> (8 * (j & 3))) & 7u)
                       : state - 1;
  }
  // bit j: byte j starts an op (past the header, before the stream's end)
  uint32_t tm = tz & ((1u << hi) - 1u) & ~((1u << lo) - 1u);
  // mode noalpha: the thread whose bytes end the stream flags the row if
  // the alpha peek after the last op reads an alpha-range byte (staged up
  // to the end's halo; zero at and past M, so a stream cut by M is not)
  if (MODE == MODE_NOALPHA && (unsigned long long)(live_end - p0 - 1) < IPT &&
      live_end > HDR1 && is_alpha(s[i0 + end_peek(tz, hi, state)]))
    atomicOr(has_ref + row, 1);
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

// ===== segment mode (k > 1): one launch over the packed rows' tiles =====

// The segmented form of a scan: a flag on the element that starts a
// segment, and op(l, r) = r where r holds a start. The map's flag rides
// bit 31 (a map takes 18 bits).
constexpr uint32_t SEG_START = 1u << 31;

struct SegMap {
  __device__ uint32_t operator()(uint32_t l, uint32_t r) const {
    if (r & SEG_START) return r;
    return (l & SEG_START) | Compose6()(l & ~SEG_START, r);
  }
};

// A segment's channel element: (val, flg bits 0-1) as in Chan, flg bit 2
// the start flag, npix the saturating pixel count since the segment start.
struct SChan {
  uint32_t val, flg;
  int npix;
};

constexpr uint32_t SCHAN_START = 4u;

__host__ __device__ __forceinline__ SChan schan_ident() {
  SChan c;
  c.val = 0;
  c.flg = 0;
  c.npix = 0;
  return c;
}

struct SChanOp {
  __device__ SChan operator()(const SChan& l, const SChan& r) const {
    if (r.flg & SCHAN_START) return r;
    SChan o;
    val_op(l.val, l.flg, r.val, r.flg, &o.val, &o.flg);
    o.flg |= l.flg & SCHAN_START;
    o.npix = sat_add(l.npix, r.npix);
    return o;
  }
};

__device__ __forceinline__ SChan shfl_up(SChan c, int d) {
  SChan o;
  o.val = (uint32_t)lb::shfl_up((int)c.val, d);
  o.flg = (uint32_t)lb::shfl_up((int)c.flg, d);
  o.npix = lb::shfl_up(c.npix, d);
  return o;
}

struct NpixC {  // a segment's saturating pixel count across its tiles
  using T = int;
  __host__ __device__ static T ident() { return 0; }
  __device__ T operator()(T l, T r) const { return sat_add(l, r); }
  __device__ static u64 pack(T v) { return (u64)(unsigned)v; }
  __device__ static T unpack(u64 w) { return (int)(w & 0x7FFFFFFFu); }
};

// A staged op between the two folds: its element (val in stage_k; npix,
// flg and its segment, counted from the tile's first, in stage_p).
constexpr int SP_FLG = 10, SP_SEG = 13;  // npix <= 512 takes bits 0-9

// Six blocks an SM, as k1_tiles. Row `row` packs k = M / seg segments of
// seg bytes (seg a power of two, 2^lg); its tiles of 4096 bytes hold
// 4096 / seg whole segments each (seg <= 4096), or a segment spans seg /
// 4096 tiles (seg > 4096). Per tile:
//   1. the live bytes of its segments (up to clen + HALO, in 16-byte
//      vectors) come into shared memory, zeros elsewhere; a tile with no
//      op position publishes an empty rank aggregate and returns (the
//      row's last tile still looks back, for totals);
//   2. the automaton maps restart at each segment start (a segmented block
//      scan); a tile inside a segment longer than a tile takes its entry
//      map by look-back over that segment's earlier tiles only;
//   3. the tile's ops are listed and dealt out as equal runs (k1_tiles' step
//      3); their channel elements and pixel counts are folded by a
//      segmented scan (a start flag on each segment's first op) and, in a
//      segment longer than a tile, by two look-backs over its tiles ((val,
//      flg) by warp 0, the pixel count by warp 1);
//   4. each op's key (its segment's first pixel j * seg_px plus its offset)
//      and payload replace its element in place; ops whose offset reaches
//      seg_px are dropped (a suffix of their segment). The kept ops are
//      ranked by a block scan and a look-back over the whole packed row
//      (segment restarts do not reset it), and leave as one contiguous run
//      of vector stores when the tile dropped none, else op by op. The
//      row's last tile writes totals[row]: no atomic.
template <int MODE>
__global__ void __launch_bounds__(NT, 6)
    k1_segs(const uint8_t* data, long long M, int nt, int k, int lg,
            const int* clen, int seg_px, u64* st_rank, u64* st_map,
            u64* st_val, u64* st_npix, unsigned* counter, int* keys,
            int* pays, int* totals, int* has_ref) {
  __shared__ __align__(16) uint8_t s[CHUNK + 16];
  __shared__ __align__(16) int stage_k[CHUNK];
  __shared__ __align__(16) int stage_p[CHUNK];
  __shared__ uint32_t mtot[lb::NW + 1];
  __shared__ int itot[lb::NW + 1];
  __shared__ SChan ctot[lb::NW + 1];
  __shared__ uint32_t s_map;
  __shared__ Val s_val;
  __shared__ int s_npix, s_rank, s_id;
  const int id = lb::next_tile(counter, &s_id);
  const int row = id / nt, tile = id - row * nt;
  const long long base = (long long)tile * CHUNK;
  const long long seg = 1LL << lg;
  const int* crow = clen + (long long)row * k;
  const int j0 = (int)(base >> lg);  // the segment of the tile's first byte
  // a segment longer than a tile: the tile's index inside it, else -1
  const int tis = seg > CHUNK ? (int)((base & (seg - 1)) / CHUNK) : -1;
  const auto live_end = [&](int j) {  // op positions end here in segment j
    return (int)min(max((long long)crow[j], 0LL), seg);
  };
  u64* const rk = st_rank + (long long)row * nt;

  // --- does any segment of the tile start an op in it? -------------------
  bool any = false;
  if (tis >= 0) {
    any = threadIdx.x == 0 &&
          live_end(j0) > max((int)(base & (seg - 1)), (int)HDR1);
  } else {
    const int nseg = (int)(min((long long)CHUNK, M - base) >> lg);
    any = (int)threadIdx.x < nseg && live_end(j0 + threadIdx.x) > HDR1;
  }
  if (!__syncthreads_or(any)) {
    if (tile == nt - 1) {
      if (threadIdx.x < 32) {
        const int r = lb::tile_prefix<lb::WordSum>(rk, tile, 0);
        if (threadIdx.x == 0) totals[row] = r;
      }
    } else if (threadIdx.x == 0) {
      lb::st_status(rk + tile, tile == 0 ? lb::ST_PREFIX : lb::ST_AGG);
    }
    return;
  }

  // --- stage the live bytes ------------------------------------------------
  const uint8_t* drow = data + (long long)row * M;
  for (int v = threadIdx.x; v <= CHUNK / 16; v += NT) {
    const long long p = base + 16 * v;
    uint4 q = make_uint4(0u, 0u, 0u, 0u);
    if (p < M && (p & (seg - 1)) < live_end((int)(p >> lg)) + HALO)
      q = __ldcs(reinterpret_cast<const uint4*>(drow + p));
    *reinterpret_cast<uint4*>(s + 16 * v) = q;
  }
  __syncthreads();

  // --- the thread's bytes, token lengths and automaton map --------------
  const int i0 = threadIdx.x * IPT;
  const long long p0 = base + i0;
  const int jt = (int)(p0 >> lg);          // the thread's segment
  const int loc0 = (int)(p0 & (seg - 1));  // its first byte in it
  Run r;
  {
    const uint4 a = *reinterpret_cast<const uint4*>(s + i0);
    const uint2 h = *reinterpret_cast<const uint2*>(s + i0 + IPT);
    r.w[0] = a.x, r.w[1] = a.y, r.w[2] = a.z, r.w[3] = a.w;
    // the bytes after a segment's end read as 0
    const bool last = ((loc0 + IPT) & (seg - 1)) == 0;
    r.w[4] = last ? 0u : h.x;
    r.w[5] = last ? 0u : h.y;
  }
  const int lo = min(max((int)HDR1 - loc0, 0), IPT);
  const int hi = p0 < M ? min(max(live_end(jt) - loc0, 0), IPT) : 0;
  uint32_t lm1[IPT / 4];
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
  const bool starts = loc0 == 0;
  uint32_t agg_map;
  const uint32_t ex_map = lb::block_scan_warp(
      map | (starts ? SEG_START : 0u), IDENT6, mtot, &agg_map, SegMap());
  if (tis >= 0 && threadIdx.x < 32) {
    const uint32_t t = lb::tile_prefix<MapC>(st_map + (id - tis), tis,
                                             agg_map & ~SEG_START);
    if (threadIdx.x == 0) s_map = t;
  }
  __syncthreads();
  int state = 0;
  if (!starts) {
    const uint32_t pm = tis > 0 ? s_map : IDENT6;
    state = (ex_map & SEG_START)
                ? (int)(ex_map & 7u)
                : (int)((ex_map >> (3 * (pm & 7u))) & 7u);
  }

  // --- the tile's ops in order: their bytes, listed in shared memory ----
  uint32_t tz = 0;  // bit j: the automaton is at state 0 at byte j
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    if (state == 0) tz |= 1u << j;
    state = state == 0 ? (int)((lm1[j >> 2] >> (8 * (j & 3))) & 7u)
                       : state - 1;
  }
  // bit j: byte j starts an op (past the header, before the segment's end)
  uint32_t tm = tz & ((1u << hi) - 1u) & ~((1u << lo) - 1u);
  // mode noalpha: the alpha peek after the segment's last op (k1_tiles);
  // a byte past the segment's end reads as 0
  if (MODE == MODE_NOALPHA && hi > 0 && loc0 + hi == crow[jt] &&
      crow[jt] > HDR1) {
    const int e = end_peek(tz, hi, state);
    if (loc0 + e < seg && is_alpha(s[i0 + e])) atomicOr(has_ref + row, 1);
  }
  int n_ops;
  int o = lb::block_scan_warp(__popc(tm), 0, itot, &n_ops, lb::WordSum());
  for (; tm; tm &= tm - 1) stage_p[o++] = i0 + __ffs(tm) - 1;
  __syncthreads();

  // --- each thread's run of consecutive ops: its segmented aggregate; in a
  // long segment, the tile's prefix by look-back -----------------------------
  const int per = (n_ops + NT - 1) / NT;
  const int o0 = min((int)threadIdx.x * per, n_ops);
  const int o1 = min(o0 + per, n_ops);
  // the segment (counted from the tile's first) of the op before the run;
  // -1 before the tile's first segment start. Read before any run
  // overwrites its ops' byte positions.
  const auto seg_of = [&](int p) { return (int)((base + p) >> lg) - j0; };
  int prev = o0 > 0 ? seg_of(stage_p[o0 - 1]) : (tis > 0 ? 0 : -1);
  __syncthreads();
  SChan acc = schan_ident();
  bool fr = false;
  for (int q = o0; q < o1; ++q) {
    const int p = stage_p[q];
    const int sg = seg_of(p);
    bool f;
    // bytes left in the op's segment: those past its end read as 0
    const int room = (int)(seg - ((base + p) & (seg - 1)));
    const Chan e = elem_at<MODE>(s, p, &f, room);
    SChan se;
    se.val = e.val;
    se.flg = e.flg | (sg != prev ? SCHAN_START : 0u);
    se.npix = e.npix;
    prev = sg;
    acc = SChanOp()(acc, se);
    fr |= f;
    stage_k[q] = (int)e.val;
    stage_p[q] = e.npix | (int)(se.flg << SP_FLG) | (sg << SP_SEG);
  }
  SChan agg;
  const SChan ex = lb::block_scan_warp(acc, schan_ident(), ctot, &agg,
                                       SChanOp());
  if (tis >= 0) {
    if (threadIdx.x < 32) {
      const Val v = lb::tile_prefix<ValC>(st_val + (id - tis), tis,
                                          Val{agg.val, agg.flg & 3u});
      if (threadIdx.x == 0) s_val = v;
    } else if (threadIdx.x < 64) {
      const int c = lb::tile_prefix<NpixC>(st_npix + (id - tis), tis,
                                           agg.npix);
      if (threadIdx.x == 32) s_npix = c;
    }
  }
  if (__syncthreads_or(fr) && threadIdx.x == 0) atomicOr(has_ref + row, 1);

  // --- every op's key and payload in place; the kept ops' ranks ----------
  SChan run = schan_ident();
  if (tis > 0) {
    run.val = s_val.val;
    run.flg = s_val.flg;
    run.npix = s_npix;
  }
  run = SChanOp()(run, ex);
  int kept = 0;
  for (int q = o0; q < o1; ++q) {
    const int sp = stage_p[q];
    SChan e;
    e.val = (uint32_t)stage_k[q];
    e.flg = (uint32_t)(sp >> SP_FLG) & 7u;
    e.npix = sp & 1023;
    if (e.flg & SCHAN_START) run = schan_ident();
    const int key = run.npix;
    run = SChanOp()(run, e);
    // offsets grow with rank: the kept ops are a prefix of their segment
    const bool keep = key < seg_px;
    stage_k[q] = keep ? (j0 + (sp >> SP_SEG)) * seg_px + key : -1;
    stage_p[q] = payload(Chan{run.val, run.flg & 3u, 0, 0});
    kept += keep;
  }
  int n_kept;
  const int ex_r = lb::block_scan_warp(kept, 0, itot, &n_kept, lb::WordSum());
  if (threadIdx.x < 32) {
    const int rp = lb::tile_prefix<lb::WordSum>(rk, tile, n_kept);
    if (threadIdx.x == 0) s_rank = rp;
  }
  __syncthreads();
  const int rank = s_rank;
  const long long out = (long long)row * M + rank;
  if (n_kept == n_ops) {
    lb::store_tile(keys + out, n_ops, lb::Linear{stage_k});
    lb::store_tile(pays + out, n_ops, lb::Linear{stage_p});
  } else {
    int w = ex_r;
    for (int q = o0; q < o1; ++q)
      if (stage_k[q] >= 0) {
        keys[out + w] = stage_k[q];
        pays[out + w] = stage_p[q];
        ++w;
      }
  }
  if (threadIdx.x == 0 && tile == nt - 1) totals[row] = rank + n_kept;
}

int front_segs(const uint8_t* data, const int* clen, int B, long long M,
               int k, int seg_px, int mode, uint32_t* scratch, int* keys,
               int* pays, int* totals, int* has_ref, cudaStream_t st) {
  if (B <= 0 || M <= 0) return 0;
  const long long seg = M / k;
  int lg = 0;
  while ((1LL << lg) < seg) ++lg;
  if ((1LL << lg) != seg || seg < 128 || M % 16 ||
      ((uintptr_t)data & 15) || M >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const long long nt = (M + CHUNK - 1) / CHUNK;
  const long long tiles = B * nt;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  u64* words = reinterpret_cast<u64*>(scratch);
  const cudaError_t e =
      lb::lb_scratch(words, (seg > CHUNK ? 4 : 1) * tiles, st);
  if (e != cudaSuccess) return (int)e;
  unsigned* counter = reinterpret_cast<unsigned*>(words);
  u64* st_rank = words + 1;
  u64* st_map = st_rank + tiles;
  u64* st_val = st_map + tiles;
  u64* st_npix = st_val + tiles;
#define K1S_LAUNCH(MODE)                                                     \
  k1_segs<MODE><<<(unsigned)tiles, NT, 0, st>>>(                             \
      data, M, (int)nt, k, lg, clen, seg_px, st_rank, st_map, st_val,        \
      st_npix, counter, keys, pays, totals, has_ref)
  switch (mode) {
    case MODE_ALPHA:
      K1S_LAUNCH(MODE_ALPHA);
      break;
    case MODE_NOALPHA:
      K1S_LAUNCH(MODE_NOALPHA);
      break;
    case MODE_MONO:
      K1S_LAUNCH(MODE_MONO);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K1S_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// data (B, M) u8. k = 1: any row length and alignment; clen (B,) i32 =
// stream length minus the end marker; scratch 2 * (3 * B * ceil(M / 4096)
// + 1) u32, zeroed here (one launch). k > 1 (segment mode): a row packs k
// images of seg = M / k bytes (a power of two, at least 128; data 16-byte
// aligned), clen is (B, k), relative to the segment, every image decodes
// to seg_px pixels and n_max = k * seg_px; scratch 2 * (4 * B *
// ceil(M / 4096) + 1) u32, zeroed here (one launch). Both sizes:
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
  return front_segs(data, clen, B, M, k, seg_px, mode, scratch, keys, pays,
                    totals, has_ref, st);
}
