// K1: SQOA decode front-end, bytes -> compacted op stream.
//
// Replaces seqoia_tpu/ops/pallas_frontend.py:decode_front_compact (kernel
// _front_compact_kernel, tile body _front_body): the token automaton, the
// per-op pixel counts and their exclusive offsets, the segmented per-byte
// mod-256 channel sum between absolute anchors (packed RGBA), the
// foreign/REF flag and the order-preserving compaction of the ops.
//
// Bound on the H100: bytes. It must read the (B, M) stream once and write
// one (key, payload) pair per op; everything else is integer work that the
// SMs do far faster than HBM delivers bytes.
//
// Design: the TPU version walks tiles in order and carries the automaton
// map, the channel sum and the cursors in SMEM. Here each of the two scans
// (the automaton's map composition, then the channel/count/pixel scan that
// depends on the token flags) runs reduce-then-scan across blocks:
//   k1_maps   per block: composed automaton map of its 4096 bytes
//   scan      per row: exclusive composition of the block maps
//   k1_chan   per block: entry state -> token walk -> block aggregate of
//             (SWAR channel sum + flags, op count, pixel count); REF flag
//   scan      per row: exclusive scan of the channel aggregates
//   k1_emit   per block: redo the walk with its prefix and write each op at
//             its rank (the compaction), counting ops whose key < n_max.
// Each thread owns 16 consecutive bytes, staged with an 8-byte halo in
// shared memory (the operands and the absorbed alpha modifier sit at most
// 5 bytes after an op). The walks are recomputed rather than stored, so
// the only traffic is the byte stream (read three times, from L2 after the
// first) and the compacted output.
//
// Segment mode (k > 1): a row of M bytes packs k small images, image j in
// bytes [j*seg, (j+1)*seg) with its header, each decoding to exactly seg_px
// pixels. The TPU kernel restarts its carried scans there with a reset map,
// an injected anchor and a flagged in-tile prefix. Here the segments are
// independent: every segment is a scan row of its own (the grid runs over
// B*k rows of seg bytes, so no scan needs a reset), keys come out global
// (j*seg_px + offset), ops whose offset reaches seg_px are dropped (a
// suffix of their segment), and two small passes give the compaction its
// rank across the segments of a packed row:
//   k1_segcount  per block: the segment's ops below seg_px (from the block
//                aggregates; only a block that straddles seg_px walks)
//   scan         per packed row: exclusive sum of its segments' counts
// A segment below 4096 bytes leaves its block underfilled.

#include <climits>

#include "common.cuh"

namespace {

constexpr int IPT = 16;
constexpr int CHUNK = NT * IPT;
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

struct ChanOp {
  __device__ Chan operator()(const Chan& l, const Chan& r) const {
    const uint32_t s = ((l.val & 0x7F7F7F7Fu) + (r.val & 0x7F7F7F7Fu)) ^
                       ((l.val ^ r.val) & 0x80808080u);
    const uint32_t m = ((r.flg & 1u) ? 0x00FFFFFFu : 0u) |
                       ((r.flg & 2u) ? 0xFF000000u : 0u);
    Chan o;
    o.val = (r.val & m) | (s & ~m);
    o.flg = (l.flg | r.flg) & 3u;
    o.cnt = l.cnt + r.cnt;
    // saturating (both are at most INT_MAX, so the unsigned sum is exact):
    // 4 MiB of BIGRUN bytes count 2^31 pixels, and a wrapped offset would
    // pass the key < n_max test that the plain version's int64 keys fail
    o.npix = (int)min((unsigned)l.npix + (unsigned)r.npix, (unsigned)INT_MAX);
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
  const int b0 = s[i], b1 = s[i + 1], b2 = s[i + 2], b3 = s[i + 3],
            b4 = s[i + 4];
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

// limit: pixels per scan row (n_max, or seg_px in segment mode). Scan row
// `row` is segment row % k of output row row / k: its keys start at
// (row % k) * limit and its ops rank after seg_base[row] (null: 0).
__global__ void k1_emit(const uint8_t* data, long long M, unsigned R,
                        int nblk, int mode, const int* clen, const uint32_t* blk_map_ex,
                        const Chan* blk_chan_ex, int limit, int k,
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
  const unsigned orow = k == 1 ? blk.row : blk.row / (unsigned)k;
  const int kbase = (int)(blk.row - orow * (unsigned)k) * limit;
  const long long rbase =
      (long long)orow * (M * k) + (seg_base ? seg_base[row] : 0);
  int* krow = keys + rbase;
  int* prow = pays + rbase;
  int here = 0;
  walk(s, base, st, mode, clen[row], [&](int i, int att) {
    bool f;
    const int key = run.npix;
    run = op(run, op_elem(s, i, att, mode, &f));
    if (key < limit) {  // offsets grow with rank: in-range ops are a prefix
      uint32_t a = (run.val >> 24) & 255u;
      if (!(run.flg & 2u)) a = (a + 255u) & 255u;  // alpha starts at 255
      krow[run.cnt - 1] = kbase + key;
      prow[run.cnt - 1] = (int)((run.val & 0x00FFFFFFu) | (a << 24));
      ++here;
    }
  });
  if (here) atomicAdd(totals + orow, here);
}

}  // namespace

// data (B, M) u8. k = 1: clen (B,) i32 = stream length minus the end marker.
// k > 1 (segment mode): a row packs k images of seg = M / k bytes, clen is
// (B, k), relative to the segment, every image decodes to seg_px pixels and
// n_max = k * seg_px. scratch: 10 * B * k * nblk + 2 * B * k u32 (nblk =
// ceil(seg / 4096)). keys/pays (B, M) i32; totals, has_ref (B,) i32, zeroed
// by the caller. Returns cudaGetLastError.
extern "C" int k1_decode_front(const uint8_t* data, const int* clen, int B,
                               long long M, int n_max, int mode, int k,
                               int seg_px, uint32_t* scratch, int* keys,
                               int* pays, int* totals, int* has_ref,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
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
  const unsigned rows = (unsigned)R, ry = rows < 65535u ? rows : 65535u;
  const dim3 grid(nblk, ry, (rows + ry - 1) / ry);
  k1_maps<<<grid, NT, 0, st>>>(data, seg, rows, nblk, mode, blk_maps);
  scan_blocks_kernel<uint32_t, Compose6><<<rows, NT, 0, st>>>(
      blk_maps, blk_map_ex, nullptr, nblk, IDENT6, Compose6());
  k1_chan<<<grid, NT, 0, st>>>(data, seg, rows, nblk, mode, clen, blk_map_ex,
                               k, blk_chan, has_ref);
  scan_blocks_kernel<Chan, ChanOp><<<rows, NT, 0, st>>>(
      blk_chan, blk_chan_ex, nullptr, nblk, chan_ident(), ChanOp());
  int* seg_base = nullptr;
  if (k > 1) {
    int* seg_cnt = reinterpret_cast<int*>(scratch + 10 * nb);
    seg_base = seg_cnt + R;
    cudaMemsetAsync(seg_cnt, 0, R * sizeof(int), st);
    k1_segcount<<<grid, NT, 0, st>>>(data, seg, rows, nblk, mode, clen,
                                     blk_map_ex, blk_chan, blk_chan_ex, seg_px,
                                     seg_cnt);
    scan_blocks_kernel<int, SumOp><<<B, NT, 0, st>>>(seg_cnt, seg_base,
                                                     nullptr, k, 0, SumOp());
  }
  k1_emit<<<grid, NT, 0, st>>>(data, seg, rows, nblk, mode, clen, blk_map_ex,
                               blk_chan_ex, k > 1 ? seg_px : n_max, k,
                               seg_base, keys, pays, totals);
  return (int)cudaGetLastError();
}
