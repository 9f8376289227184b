// K2 place_emit and K6 place_fill: placement + forward fill of a compacted
// monotone stream, with a static epilogue.
//
// Replaces seqoia_tpu/ops/pallas_engine.py:place_emit (kernel
// _place_emit_kernel) and place_fill (kernel _place_kernel). Output slot t
// of row b takes the payloads of the last entry i < totals[b] with
// keys[i] <= t (the fill init before the first entry); the epilogue then
// turns them into the output:
//   EPI_FILL   the filled int32 streams themselves (K6), plus the filled
//              keys when asked
//   EPI_DEC4   decode, out_ch 4: packed RGBA words, zero past n_pixels
//   EPI_DEC3   decode, out_ch 3: the interleaved RGB stream's int32 words
//   EPI_MONO1  mono decode, out_ch 1: gray bytes
//   EPI_MONO2  mono decode, out_ch 2: gray | alpha << 8 (uint16)
//   EPI_ENC3/1 encode, color/mono: the stream bytes, computed in closed
//              form from the filled (pixel, meta word, entry offset) of each
//              byte position, with the trailing BIGRUN and end marker
//   EPI_ENCQ   QOI-compat encode: the same for the .qoi op set (one-byte
//              run flush, INDEX, DIFF, LUMA, RGB, RGBA, the trailing run and
//              the end marker)
//   EPI_GRAY4  gray source, out_ch 4: EPI_DEC4 over the gray word
//   EPI_GRAY3  gray source, out_ch 3: EPI_DEC3 over the gray word
//   EPI_GREEN1 colour source, out_ch 1: EPI_MONO1 over the green word
//   EPI_GREEN2 colour source, out_ch 2: EPI_MONO2 over the green word
//
// Bound on the H100: bytes. The output is written once and the entries are
// read once.
//
// The four conversion epilogues (gray to RGB(A), colour to gray(+alpha))
// replace K6's filled int32 plane and codec/decode_v2._emit_pixels' int64
// channel planes, stack and select, where the JAX package sends these pairs
// through its unfused mono front and XLA's emission. Each is an existing
// store path with a word transform (Xf) applied to every payload it picks,
// the fill init included: gray (byte 0) to R = G = B with byte 3's alpha
// kept, or the green byte moved to byte 0 with the alpha kept. The
// transform is a template parameter, so the other epilogues compile to the
// code they had without it.
//
// Design: the TPU version DMAs one window of entries per output tile, moves
// them into place with a butterfly network and forward-fills with a carry
// from the previous tile, which bounds the fill to max_gap slots. Here one
// block fills one tile of TILE (4096) slots, so there are no carries or gap
// bounds and a slot depends only on the entries:
//   1. warp 0 finds the tile's entries [lo, hi) by 32-way searches of the
//      keys (a ballot a step, about eight dependent loads a tile), while the
//      block marks every slot of its shared-memory entry map empty;
//   2. the slot of each entry's key gets the entry's index (only the last
//      of equal keys writes, so no two threads write one slot) and slot 0
//      the governing entry lo - 1;
//   3. a block max-scan forward-fills the map: each thread folds its 16
//      consecutive slots, lb::block_scan_warp scans the thread maxima;
//   4. the epilogue writes the tile as lb::store_tile does: neighbouring
//      threads store neighbouring 16-byte vectors at any row alignment, each
//      vector reading its slots' entries from the map and their payloads
//      from global memory by independent loads, all of a thread's vectors
//      gathered before the first is stored (a warp's slots share a short
//      run of entries, which meet in L1). The byte epilogues read three
//      streams a byte: the block computes their bytes in slot order, lane by
//      lane (a warp's gathers then read a few neighbouring entries), into
//      shared memory, and stores those.
// A tile wholly past the epilogue's live output (past n_pixels, or past an
// encode's stream total, which sits well short of its worst-case cap)
// stores zeros without a search.
// EPI_DEC3 builds each 16-byte vector of the RGB stream from the six pixels
// it touches (4 pixels make 3 words) with funnel shifts: 32-bit tile-local
// indices and one division by 3 a vector, none a byte.

#include <climits>

#include "lookback.cuh"

namespace {

enum {
  EPI_FILL = 0,
  EPI_DEC4 = 1,
  EPI_DEC3 = 2,
  EPI_MONO1 = 3,
  EPI_MONO2 = 4,
  EPI_ENC3 = 5,
  EPI_ENC1 = 6,
  EPI_ENCQ = 7,
  EPI_GRAY4 = 8,
  EPI_GRAY3 = 9,
  EPI_GREEN1 = 10,
  EPI_GREEN2 = 11,
};

// the decode epilogues: zero from slot n_pixels (the row's scalar) on
__host__ __device__ constexpr bool decodes(int epi) {
  return epi == EPI_DEC4 || epi == EPI_DEC3 || epi == EPI_MONO1 ||
         epi == EPI_MONO2 || epi >= EPI_GRAY4;
}
// the epilogues that store the RGB stream's words (n_out * 3 / 4 a row)
__host__ __device__ constexpr bool rgb_words(int epi) {
  return epi == EPI_DEC3 || epi == EPI_GRAY3;
}

// The conversion epilogues' word transforms (a packed pixel: R in byte 0,
// alpha in byte 3; a gray source's K1 payload: gray in byte 0).
enum { XF_NONE = 0, XF_GRAY = 1, XF_GREEN = 2 };
__host__ __device__ constexpr int xf_of(int epi) {
  return epi == EPI_GRAY4 || epi == EPI_GRAY3     ? XF_GRAY
         : epi == EPI_GREEN1 || epi == EPI_GREEN2 ? XF_GREEN
                                                  : XF_NONE;
}
template <int XF>
__device__ __forceinline__ int xf(int v) {
  const unsigned u = (unsigned)v;
  if (XF == XF_GRAY) return (int)((u & 255u) * 0x010101u | (u & 0xFF000000u));
  if (XF == XF_GREEN) return (int)(((u >> 8) & 255u) | (u & 0xFF000000u));
  return v;
}

constexpr int TILE = lb::TILE;  // slots a block
constexpr int SPT = lb::IPT;    // consecutive slots a thread scans
using lb::pad;

// meta word classes: K3's, then the QOI-compat ones (codec/encode_v2.py)
enum {
  CL_LUMA = 0,
  CL_RGB = 1,
  CL_MONO_GA = 2,
  CL_INDEX = 3,
  CL_RGBA5 = 4,
  CL_DIFF = 5,
  CL_RGB4 = 6,
  CL_NONE = 7
};

struct Place {
  const int* keys;
  const int* p0;
  const int* p1;
  const int* p2;
  const int* totals;
  long long mc;  // row stride of keys and payloads
  const int* scal;
  int n_scal;
  int ini0, ini1, ini2, ini_key;
};

// a + #{i in [a, b): keys[i] <= v} for keys sorted on [a, b), by the whole
// warp: each step the lanes probe 32 evenly spaced keys and the ballot's
// count narrows the range 32-fold. On unsorted keys it still returns an
// index in [a, b].
__device__ int count_le(const int* keys, int a, int b, int v) {
  const int lane = threadIdx.x & 31;
  while (b - a > 32) {
    const int step = (b - a + 31) >> 5;
    const long long i = a + (long long)lane * step;
    const bool le = i < b && __ldg(keys + i) <= v;
    const int c = __popc(__ballot_sync(lb::FULL, le));
    if (c == 0) return a;
    const int na = a + (c - 1) * step + 1;
    b = (int)min((long long)b, a + (long long)c * step);
    a = na;
  }
  const bool le = a + lane < b && __ldg(keys + a + lane) <= v;
  return a + __popc(__ballot_sync(lb::FULL, le));
}

// Payload i of a stream, or its init before the first entry (i < 0). The
// loads of a vector's slots are independent of each other, so a thread has
// them all in flight at once (neighbouring slots mostly share an entry and
// meet in L1).
__device__ __forceinline__ int pick(const int* p, int i, int ini) {
  return i >= 0 ? __ldg(p + i) : ini;
}

// The tile's forward-filled entry map in shared memory.
struct Map {
  const int* ent;
  __device__ __forceinline__ int operator[](int s) const {
    return ent[pad(s)];
  }
};

// int32 outputs (EPI_FILL, EPI_DEC4, EPI_GRAY4): slot s of the tile is
// element s; slots at and past lim are zero (the decodes' n_pixels;
// EPI_FILL: TILE).
template <int XF = XF_NONE>
struct GetWords {
  Map m;
  const int* p;
  int ini, lim;
  __device__ int one(int s) const {
    return s < lim ? xf<XF>(pick(p, m[s], ini)) : 0;
  }
  __device__ uint4 vec(int s) const {
    unsigned w[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      w[c] = s + c < lim ? (unsigned)xf<XF>(pick(p, m[s + c], ini)) : 0u;
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// EPI_DEC3, EPI_GRAY3: element e is word e of the tile's RGB stream (bytes
// 4e..4e+3; byte q is channel q % 3 of pixel q / 3).
template <int XF = XF_NONE>
struct GetRgb {
  Map m;
  const int* p;
  int ini, lim;
  // the rgb words of pixels px[0..5]: w[0..2] hold pixels 0-3, w[3..4]
  // pixels 4-5
  __device__ static void words(const unsigned* px, unsigned* w) {
    w[0] = (px[0] & 0xFFFFFFu) | (px[1] << 24);
    w[1] = ((px[1] >> 8) & 0xFFFFu) | (px[2] << 16);
    w[2] = ((px[2] >> 16) & 0xFFu) | (px[3] << 8);
    w[3] = (px[4] & 0xFFFFFFu) | (px[5] << 24);
    w[4] = (px[5] >> 8) & 0xFFFFu;
  }
  // pixels q .. q+n-1 (zero at and past lim)
  template <int N>
  __device__ void pixels(int q, unsigned* px) const {
#pragma unroll
    for (int k = 0; k < 6; ++k)
      px[k] = k < N && q + k < lim ? (unsigned)xf<XF>(pick(p, m[q + k], ini))
                                   : 0u;
  }
  __device__ uint4 vec(int e) const {
    const int q = (4 * e) / 3, sh = 8 * (4 * e - 3 * q);
    unsigned px[6], w[5];
    pixels<6>(q, px);
    words(px, w);
    return make_uint4(__funnelshift_r(w[0], w[1], sh),
                      __funnelshift_r(w[1], w[2], sh),
                      __funnelshift_r(w[2], w[3], sh),
                      __funnelshift_r(w[3], w[4], sh));
  }
  __device__ int one(int e) const {
    const int q = (4 * e) / 3, sh = 8 * (4 * e - 3 * q);
    unsigned px[6], w[5];
    pixels<3>(q, px);
    words(px, w);
    return (int)__funnelshift_r(w[0], w[1], sh);
  }
};

// The encode epilogues' closed forms (encode_v2._emit_bytes and
// _compat_bytes), from the filled (pixel, meta word, entry offset) of each
// byte position. The meta word's fields are the op bytes' own bits
// (ops/encode_front.pack_meta): vg + 32 in bits 12-17, vg_r + 8 in 18-21,
// vg_b + 8 in 22-25, va + 16 in 26-30, the alpha flag in bit 31.

// Byte k of an entry's chunk (SQOA, colch 3 or 1): its run flush (chunks of
// 61, the last one the remainder), then its op; 0xFD for a BIGRUN.
template <int COLCH>
__device__ __forceinline__ int enc_chunk_byte(int k, int cur, int meta) {
  const int pend = meta & 0x1FF;
  const int cls = (meta >> 9) & 7;
  const int n_full = (max(pend - 1, 0) * 538) >> 15;  // (pend-1) // 61
  const int flush = pend > 0 ? n_full + 1 : 0;
  const int j = min(k - flush, 4);
  const int ch = (int)(((unsigned)cur >> (8 * max(j - 1, 0))) & 255u);
  const int tag = 0xFE | ((meta >> 31) & 1);
  int op;
  if (COLCH == 3) {
    const int luma = j == 0   ? 0x80 | ((meta >> 12) & 63)
                     : j == 1 ? ((meta >> 14) & 0xF0) | ((meta >> 22) & 15)
                              : 0x60 | ((meta >> 26) & 31);
    op = cls == CL_LUMA ? luma : (j == 0 ? tag : ch);
  } else {
    const int ga = j == 1 ? (cur >> 8) & 255 : (cur >> 24) & 255;
    op = cls == CL_LUMA ? 0x80 | ((meta >> 12) & 63)
                        : (j == 0 ? (cls == CL_MONO_GA ? 0xFF : tag) : ga);
  }
  const int run = k >= n_full ? 0xC0 | (pend - 61 * n_full - 1) : 0xFC;
  return cls == CL_NONE ? 0xFD : (k < flush ? run : op);
}

__device__ __forceinline__ int wrap8(int x) { return ((x + 128) & 255) - 128; }

// Byte k of an entry's chunk (QOI-compat): a compat run is cut at 62, so a
// pending run flushes as one RUN byte; then INDEX, DIFF, LUMA, RGB or RGBA.
__device__ __forceinline__ int encq_chunk_byte(int k, int cur, int meta) {
  const int pend = meta & 0x1FF;
  const int cls = (meta >> 9) & 7;
  const int flush = pend > 0 ? 1 : 0;
  const int j = min(k - flush, 4);
  const int ocr = cur & 255, ocg = (cur >> 8) & 255, ocb = (cur >> 16) & 255,
            oca = (cur >> 24) & 255;
  const int ovg = ((meta >> 12) & 63) - 32;
  const int ovg_r = ((meta >> 18) & 15) - 8;
  const int ovg_b = ((meta >> 22) & 15) - 8;
  const int ch = (int)(((unsigned)cur >> (8 * max(j - 1, 0))) & 255u);
  // every class's byte, then a select: no divergent branch in the warp
  const int index = (ocr * 3 + ocg * 5 + ocb * 7 + oca * 11) & 63;
  const int diff = 0x40 | (int)((unsigned)(wrap8(ovg + ovg_r) + 2) << 4) |
                   (int)((unsigned)(ovg + 2) << 2) | (wrap8(ovg + ovg_b) + 2);
  const int luma = j == 0 ? 0x80 | ((meta >> 12) & 63)
                          : ((meta >> 14) & 0xF0) | ((meta >> 22) & 15);
  const int absolute = j == 0 ? 0xFE | (cls == CL_RGBA5 ? 1 : 0) : ch;
  const int op = cls == CL_INDEX  ? index
                 : cls == CL_DIFF ? diff
                 : cls == CL_LUMA ? luma
                                  : absolute;
  return cls == CL_NONE ? 0xFD : (k < flush ? 0xC0 | (pend - 1) : op);
}

// byte outputs (EPI_MONO1, EPI_GREEN1, EPI_ENC3/1/Q): byte s of the tile,
// s its slot;
// t0 the tile's first slot. Slots at and past lim are zero (n_pixels, or
// the stream's total); an encode's slots from chunk_total on hold the
// trailing BIGRUN and the end marker (seqoia.h:640-646). The block computes
// the bytes in slot order, lane by lane, so a warp's gathers read a short
// run of neighbouring entries, and stages them in shared memory for the
// 16-byte stores (StagedBytes).
template <int EPI>
struct Bytes {
  Map m;
  Place P;
  const int* keys;  // the row's
  const int* scal;  // the row's
  long long ro;
  int t0, lim;

  __device__ int byte_at(int s) const {
    if (s >= lim) return 0;
    const int i = m[s];
    if (EPI == EPI_MONO1 || EPI == EPI_GREEN1)
      return xf<xf_of(EPI)>(pick(P.p0 + ro, i, P.ini0)) & 255;
    const int t = t0 + s;
    const int tail_pos = t - scal[0];
    if (tail_pos >= 0) {  // only where the row ends its image (lim)
      const int trail = scal[1];
      return tail_pos == (trail ? 0 : -1) ? 0xFD
             : (tail_pos == (trail ? 8 : 7) ? 1 : 0);
    }
    const int cur = pick(P.p0 + ro, i, P.ini0);
    const int meta = pick(P.p1 + ro, i, P.ini1);
    const int k = t - pick(keys, i, P.ini_key);
    const int b = EPI == EPI_ENCQ ? encq_chunk_byte(k, cur, meta)
                  : EPI == EPI_ENC3 ? enc_chunk_byte<3>(k, cur, meta)
                                    : enc_chunk_byte<1>(k, cur, meta);
    return b & 255;
  }
};

// The tile's bytes staged in 16-byte aligned shared memory.
struct StagedBytes {
  const uint8_t* b;
  __device__ uint8_t one(int e) const { return b[e]; }
  __device__ uint4 vec(int e) const {
    if ((e & 15) == 0) return *reinterpret_cast<const uint4*>(b + e);
    unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int c = 0; c < 16; ++c) w[c >> 2] |= (unsigned)b[e + c] << (8 * (c & 3));
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// EPI_MONO2, EPI_GREEN2: uint16 gray | alpha << 8, zero at and past lim.
template <int XF = XF_NONE>
struct GetGrayAlpha {
  Map m;
  const int* p;
  int ini, lim;
  __device__ static unsigned ga(int v) {
    v = xf<XF>(v);
    return (unsigned)((v & 255) | (((v >> 24) & 255) << 8));
  }
  __device__ uint16_t one(int s) const {
    return s < lim ? (uint16_t)ga(pick(p, m[s], ini)) : 0;
  }
  __device__ uint4 vec(int s) const {
    unsigned w[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int a = s + 2 * c;
      w[c] = (a < lim ? ga(pick(p, m[a], ini)) : 0u) |
             ((a + 1 < lim ? ga(pick(p, m[a + 1], ini)) : 0u) << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// A tile past the row's live output: zeros.
struct GetZero {
  __device__ int one(int) const { return 0; }
  __device__ uint4 vec(int) const { return make_uint4(0, 0, 0, 0); }
};

// lb::store_tile with every vector of a thread gathered before the first is
// stored, so the gathers of all of them are in flight together (a store
// could alias a later gather's address, so the compiler would not hoist
// them itself). PER: vectors a thread, TILE * sizeof(output) / 16 / NT.
template <int PER, class E, class Get>
__device__ __forceinline__ void store_all(E* dst, int len, const Get& g) {
  constexpr int V = 16 / sizeof(E);
  const lb::Span sp = lb::span16(dst, len);
  uint4* vd = reinterpret_cast<uint4*>(dst + sp.head);
  uint4 q[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * NT;
    if (i < sp.nvec) q[u] = g.vec(sp.head + i * V);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * NT;
    if (i < sp.nvec) __stcs(vd + i, q[u]);
  }
  const int t = threadIdx.x;
  if (t < sp.head) dst[t] = g.one(t);
  if (t < len - sp.tail) dst[sp.tail + t] = g.one(sp.tail + t);
}

template <int EPI>
__global__ void __launch_bounds__(NT)
    place_kernel(Place P, int n_out, long long units, void* out0, int* out1,
                 int* out2, int* out_keys) {
  __shared__ int ent[lb::PAD_TILE];
  __shared__ int wtot[lb::NW + 1];
  __shared__ int range[2];
  const int tid = threadIdx.x;
  const long long row = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const long long ro = row * P.mc;
  const int* keys = P.keys + ro;
  const int total = (int)max(0LL, min((long long)P.totals[row], P.mc));
  const int* scal = P.scal + row * P.n_scal;
  // the epilogue's output is zero from slot `end` on: lim live slots here
  long long end = LLONG_MAX;
  if (decodes(EPI))
    end = scal[0];
  else if (EPI == EPI_ENC3 || EPI == EPI_ENC1)
    end = (long long)scal[0] + (scal[2] ? 8 + scal[1] : 0);
  else if (EPI == EPI_ENCQ)
    end = (long long)scal[0] + 8 + scal[1];
  const int lim = (int)max(0LL, min((long long)TILE, end - t0));
  const long long u0 =
      rgb_words(EPI) ? (long long)t0 / 4 * 3 : (long long)t0;
  const int per_tile = rgb_words(EPI) ? TILE / 4 * 3 : TILE;
  const int len = (int)min((long long)per_tile, units - u0);
  const long long base = row * units + u0;
  constexpr int W4 = TILE * 4 / 16 / NT;  // int32 vectors a thread
  if (lim == 0) {  // a tile past the live output (encode caps): no search
    if constexpr (EPI == EPI_MONO2 || EPI == EPI_GREEN2)
      store_all<W4 / 2>((uint16_t*)out0 + base, len, GetZero{});
    else if constexpr (EPI == EPI_MONO1 || EPI == EPI_GREEN1 ||
                       EPI == EPI_ENC3 || EPI == EPI_ENC1 || EPI == EPI_ENCQ)
      store_all<W4 / 4>((uint8_t*)out0 + base, len, GetZero{});
    else
      store_all<W4>((int*)out0 + base, len, GetZero{});
    return;
  }

  // 1. the tile's entries: lo = #{keys <= t0}, hi = #{keys <= t0 + TILE-1}
#pragma unroll
  for (int k = 0; k < SPT; ++k) ent[pad(tid * SPT + k)] = -1;
  if (tid < 32) {
    const int t1 = (int)min((long long)t0 + TILE - 1, (long long)INT_MAX);
    const int lo = count_le(keys, 0, total, t0);
    // strictly increasing keys put at most TILE - 1 in the tile
    const int hb = (int)min((long long)total, (long long)lo + TILE);
    int hi = count_le(keys, lo, hb, t1);
    if (hi == hb && hb < total) hi = count_le(keys, hb, total, t1);
    if (tid == 0) {
      range[0] = lo;
      range[1] = hi;
    }
  }
  __syncthreads();
  // 2. each entry marks its key's slot; slot 0 takes the governing entry
  const int lo = range[0], hi = range[1];
  if (tid == 0) ent[0] = lo - 1;
  for (int j0 = lo; j0 < hi; j0 += NT) {
    const int j = j0 + tid;
    const int key = j < hi ? __ldg(keys + j) : 0;
    int next = lb::shfl_down(key, 1);
    if ((tid & 31) == 31 && j + 1 < hi) next = __ldg(keys + j + 1);
    const long long s = (long long)key - t0;
    if (j < hi && (j + 1 >= hi || next != key) && s > 0 && s < TILE)
      ent[pad((int)s)] = j;
  }
  __syncthreads();
  // 3. forward fill: entry indices grow with the slot, so a max-scan
  int v[SPT];
  int run = -1;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    v[k] = ent[pad(tid * SPT + k)];
    run = max(run, v[k]);
  }
  int agg;
  int ex = lb::block_scan_warp(run, -1, wtot, &agg, MaxOp());
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    ex = max(ex, v[k]);
    ent[pad(tid * SPT + k)] = ex;
  }
  __syncthreads();

  // 4. the epilogue, coalesced
  const Map m{ent};
  constexpr int XF = xf_of(EPI);
  if constexpr (EPI == EPI_FILL) {
    store_all<W4>((int*)out0 + base, len,
                  GetWords<>{m, P.p0 + ro, P.ini0, lim});
    if (out1)
      store_all<W4>(out1 + base, len, GetWords<>{m, P.p1 + ro, P.ini1, lim});
    if (out2)
      store_all<W4>(out2 + base, len, GetWords<>{m, P.p2 + ro, P.ini2, lim});
    if (out_keys)
      store_all<W4>(out_keys + base, len,
                    GetWords<>{m, keys, P.ini_key, lim});
  } else if constexpr (EPI == EPI_DEC4 || EPI == EPI_GRAY4) {
    store_all<W4>((int*)out0 + base, len,
                  GetWords<XF>{m, P.p0 + ro, P.ini0, lim});
  } else if constexpr (rgb_words(EPI)) {
    store_all<W4 * 3 / 4>((int*)out0 + base, len,
                          GetRgb<XF>{m, P.p0 + ro, P.ini0, lim});
  } else if constexpr (EPI == EPI_MONO2 || EPI == EPI_GREEN2) {
    store_all<W4 / 2>((uint16_t*)out0 + base, len,
                      GetGrayAlpha<XF>{m, P.p0 + ro, P.ini0, lim});
  } else {
    __shared__ __align__(16) uint8_t staged[TILE];
    const Bytes<EPI> g{m, P, keys, scal, ro, t0, lim};
#pragma unroll 4
    for (int u = 0; u < SPT; ++u) {
      const int s = tid + u * NT;
      staged[s] = (uint8_t)g.byte_at(s);
    }
    __syncthreads();
    store_all<W4 / 4>((uint8_t*)out0 + base, len, StagedBytes{staged});
  }
}

template <int EPI>
void launch(const Place& P, int B, int n_out, long long units, void* out0,
            int* out1, int* out2, int* out_keys, cudaStream_t st) {
  const dim3 grid((unsigned)((n_out + TILE - 1) / TILE), B);
  place_kernel<EPI><<<grid, NT, 0, st>>>(P, n_out, units, out0, out1, out2,
                                         out_keys);
}

}  // namespace

// keys, p0..p2: (B, mc) i32 (p1/p2 may be null); totals (B,) i32;
// scal (B, n_scal) i32. out0 is (B, units) of the epilogue's dtype, where
// units = n_out, or n_out * 3 / 4 for EPI_DEC3 and EPI_GRAY3; out1, out2
// and out_keys
// (EPI_FILL only) are (B, n_out) i32 or null. Returns cudaGetLastError.
extern "C" int k2_place(int epi, const int* keys, const int* p0,
                        const int* p1, const int* p2, const int* totals,
                        long long mc, int B, int n_out, const int* scal,
                        int n_scal, int ini0, int ini1, int ini2, int ini_key,
                        void* out0, int* out1, int* out2, int* out_keys,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Place P{keys, p0, p1, p2, totals, mc, scal, n_scal,
          ini0, ini1, ini2, ini_key};
  const long long units =
      rgb_words(epi) ? (long long)n_out * 3 / 4 : (long long)n_out;
  switch (epi) {
    case EPI_FILL:
      launch<EPI_FILL>(P, B, n_out, units, out0, out1, out2, out_keys, st);
      break;
    case EPI_DEC4:
      launch<EPI_DEC4>(P, B, n_out, units, out0, out1, out2, out_keys, st);
      break;
    case EPI_DEC3:
      launch<EPI_DEC3>(P, B, n_out, units, out0, out1, out2, out_keys, st);
      break;
    case EPI_MONO1:
      launch<EPI_MONO1>(P, B, n_out, units, out0, out1, out2, out_keys, st);
      break;
    case EPI_MONO2:
      launch<EPI_MONO2>(P, B, n_out, units, out0, out1, out2, out_keys, st);
      break;
    case EPI_ENC3:
      launch<EPI_ENC3>(P, B, n_out, units, out0, out1, out2, out_keys, st);
      break;
    case EPI_ENC1:
      launch<EPI_ENC1>(P, B, n_out, units, out0, out1, out2, out_keys, st);
      break;
    case EPI_ENCQ:
      launch<EPI_ENCQ>(P, B, n_out, units, out0, out1, out2, out_keys, st);
      break;
    case EPI_GRAY4:
      launch<EPI_GRAY4>(P, B, n_out, units, out0, out1, out2, out_keys, st);
      break;
    case EPI_GRAY3:
      launch<EPI_GRAY3>(P, B, n_out, units, out0, out1, out2, out_keys, st);
      break;
    case EPI_GREEN1:
      launch<EPI_GREEN1>(P, B, n_out, units, out0, out1, out2, out_keys, st);
      break;
    case EPI_GREEN2:
      launch<EPI_GREEN2>(P, B, n_out, units, out0, out1, out2, out_keys, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
