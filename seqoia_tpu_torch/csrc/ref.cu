// K10: sequential decode of SQOA streams that hold OP_REF, one block a
// stream.
//
// Replaces the lax.scan of seqoia_tpu/codec/decode_jax.py:decode_stream_ref,
// the JAX package's device decoder for such streams; it is no Pallas kernel.
// REF (tags 0x00-0x5f) replays 2-4 opcode bytes from a window that ends up
// to 31 bytes back and, when the window is spent, teleports the cursor
// (reference: seqoia.h:729-738 and the SQOA_NEXT macro, seqoia.h:418): the
// cursor is not monotonic, which defeats the parallel front-end (K1), so a
// stream K1 flags goes here. The walk is the reference's, with three kinds
// of fetch kept apart:
// - next(): the replay-aware cursor. At the window's end it jumps to
//   resume + 1 and reads there WITHOUT advancing (SQOA_NEXT exactly), so the
//   byte at resume is skipped and the one after it read twice;
// - the REF's replacement byte: a raw read at the window's start;
// - the alpha-modifier peek (color only): a raw read of bytes[pos], the byte
//   then consumed through next().
// Every fetch is clamped into [0, nbytes - 1], so a malformed stream reads
// nothing outside the buffer. A window that starts before the stream sets
// err (seqoia.h:733-736) and the walk goes on, as the JAX scan does.
// Pixels after chunks_len repeat the last one; the walk stops at n_pixels
// (the reference's loop bound: an op past the last pixel is never read).
//
// Bound on the H100: latency. Each op's position depends on the bytes of
// the op before (and a REF on its own byte), so a stream is one chain; the
// bytes it moves (the stream once, the pixels once) take far less than the
// chain. Its floor is one dependent shared-memory load an op; a single
// thread's instruction issue is the next limit, so the walk's loop is cut to
// about ten instructions an op.
//
// Design: one block walks one stream, the chain in shared memory.
// - Producers stage the stream CHUNK bytes at a time into a byte ring of
//   STAGES chunks and describe every byte position p of a chunk in one
//   16-byte word (from the chunk and the 8 bytes after it): what the op that
//   starts at p does when no replay window is near. x: the shared address of
//   the next op's word and nothing else; y: the op's pixels (run + 1), or a
//   REF's tag and the slow bit; z, w: the byte-wise update of the pixel,
//   (v & w) + z. The whole block stages and describes chunk 0 before the
//   roles split (a small stream waits on one global round trip); then warps
//   1-3 take chunks 1, 2, 3, 4, ... in turn.
// - One walker (thread 0). Fast path, while pos > rend (no window can be
//   reached: true after every teleport) and pos lies in a staged chunk: in
//   batches of ops that can neither leave the staged chunks (6 bytes an op
//   at most) nor pass n_pixels (512 pixels an op at most), each step loads
//   the word after next from the next one's x (one dependent load an op, no
//   mask, no branch on it), then stops at a REF's word or applies its own
//   word, appends a record and adds its pixels; the cursor follows from the
//   words' addresses at the batch's end. A chunk's tail goes op by op with
//   the bounds checked. Byte step, inside a window, on a REF and where pos
//   has walked back into a chunk already freed (nested REFs can walk back
//   without bound): the reference's step for one op on the staged bytes,
//   unchecked where REACH bytes around pos are staged, else clamped and
//   from the stream where not staged.
// - The walker appends one record an op to global memory, (first pixel,
//   value): a fire-and-forget store, no run loop. The pixels are placed
//   after the walk from the records: by the block itself for an image of at
//   most SMALL pixels, else by a second launch over the card (k10_fill);
//   each thread finds its pixel's record by a binary search over a tile of
//   records in shared memory, and stores it in the out_ch layout of
//   decode_jax._format_pixels.
// - The walker frees a chunk when it enters the one after next (a REF
//   window reaches at most 35 bytes back), a producer refills a stage once
//   its chunk is freed, and each stage carries the chunk it holds. Every
//   wait is bounded by the SM clock and sets a fault word, which the wrapper
//   raises on.
// The walk writes stat[0], the err flag, stat[1], the ops walked, stat[2],
// the records, and stat[3], the fault word (0: none); the caller zeroes the
// output past n_pixels.

#include <atomic>

#include "common.cuh"

namespace {

constexpr int HEADER = 14;  // header bytes; the start byte follows
constexpr int OP_ALPHA = 0x60, OP_LUMA = 0x80, OP_BIGRUN = 0xFD,
              OP_RGB = 0xFE, OP_RGBA = 0xFF;
constexpr int MAXRUN = 512;
constexpr unsigned INIT = 0xFF000000u;  // r = g = b = 0, a = 255

// ops/ref.py's CHUNK, STAGES, SMALL, WALK_TILE, FILL_TILE and REACH name
// these for the host
constexpr int LOG_CHUNK = 11;
constexpr int CHUNK = 1 << LOG_CHUNK;  // bytes a chunk
constexpr int STAGES = 4;              // chunks resident: ring stages
constexpr int RING = CHUNK * STAGES;   // descriptor words, staged bytes
constexpr int SPAN = CHUNK + 8;        // bytes a producer reads a chunk
constexpr int WARPS = 4;  // warp 0 walks, warps 1-3 produce
constexpr int PRODUCERS = WARPS - 1;
constexpr int THREADS = WARPS * 32;
constexpr long long SMALL = 1 << 16;  // pixels the block places itself
constexpr int FILL_THREADS = 256;     // records a tile of k10_fill
constexpr int FILL_BLOCKS = 132 * 8;
// the byte walk reads within this many bytes of its op's start (a REF's
// window starts at most 35 back, a teleport lands at most 36 ahead)
constexpr int REACH = 48;

// a descriptor, 16 bytes: x = the shared address of the next op's
// descriptor and nothing else (the walk's chain: one load feeds the next;
// the cursor follows from the addresses); y = the op's pixels (run + 1),
// or for a REF its tag << 16 and the slow bit; z = addend, w = keep mask:
// the pixel becomes (v & w) + z byte-wise. A REF's: x its own address.
constexpr unsigned SLOW = 1u << 31;
// words valid before any producer writes a stage: its first PAD, and PAD
// past a stream's last op; the walk reads at most two ops (12 bytes) ahead
constexpr int PAD = 16;

// shared memory: the descriptor ring, the byte ring (chunk k at
// (k % STAGES) * CHUNK), a SPAN-byte buffer a producer, and the control
// words: the chunk each stage holds, the first chunk not freed, the walk's
// end, the fault word
constexpr int CTL_FREED = STAGES, CTL_DONE = STAGES + 1,
              CTL_FAULT = STAGES + 2, CTL_WORDS = STAGES + 3;
constexpr int SMEM = RING * 16 + RING + PRODUCERS * SPAN + CTL_WORDS * 4;
// waits, in SM clocks: the walker waits on a producer's chunk (a few us),
// a producer on the walker (as long as a chunk's walk takes)
constexpr long long WALKER_WAIT = 1ll << 31, PRODUCER_WAIT = 1ll << 37;

// a descriptor from its shared address; volatile with a memory clobber, so
// that the compiler keeps it after the wait for its chunk
__device__ __forceinline__ uint4 lds128(unsigned addr) {
  uint4 r;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "r"(addr)
               : "memory");
  return r;
}

// a & b & c (0x80), (a & b) ^ c (0x6A), a ^ (b & c) (0x78): one LOP3 each
template <unsigned LUT>
__device__ __forceinline__ unsigned lop3(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "r"(b), "r"(c),
      "n"(LUT));
  return d;
}

// (v & keep) + add byte-wise mod 256: the low 7 bits of each byte summed,
// the top bits xored in (three dependent ops on v)
__device__ __forceinline__ unsigned apply(unsigned v, uint4 d) {
  return lop3<0x78>(lop3<0x80>(v, d.w, 0x7F7F7F7Fu) + (d.z & 0x7F7F7F7Fu),
                    lop3<0x6A>(v, d.w, d.z), 0x80808080u);
}

// a REF's descriptor, or a padding word: its own address, the slow flag
__device__ __forceinline__ uint4 slow_word(unsigned addr, unsigned tag) {
  return make_uint4(addr, SLOW | (tag << 16), 0u, 0u);
}

// a record (first pixel, value) into global memory
__device__ __forceinline__ void record(uint2* p, unsigned t, unsigned v) {
  asm volatile("st.global.v2.u32 [%0], {%1, %2};" ::"l"(p), "r"(t), "r"(v));
}

__device__ __forceinline__ unsigned bytes3(int d0, int d1, int d2) {
  return ((unsigned)d0 & 255u) | (((unsigned)d1 & 255u) << 8) |
         (((unsigned)d2 & 255u) << 16);
}

// the descriptor of the op at byte position p, whose bytes p..p+5 are
// b[0..5]; the value packs r | g << 8 | b << 16 | a << 24 (mono: the gray
// in r, g and b)
template <int COLCH>
__device__ __forceinline__ uint4 describe(const uint8_t* b, int p,
                                          unsigned dbase) {
  const unsigned b0 = b[0];
  if (b0 < (unsigned)OP_ALPHA)  // REF: the walker's byte step
    return slow_word(dbase + (unsigned)(p & (RING - 1)) * 16u, b0);
  unsigned nops = 0, run = 0, keep = ~0u, add = 0;
  if (b0 >= (unsigned)OP_RGB) {
    if (COLCH == 3) {
      add = b[1] | ((unsigned)b[2] << 8) | ((unsigned)b[3] << 16);
      nops = 3;
    } else {
      add = b[1] * 0x010101u;
      nops = 1;
    }
    if (b0 == (unsigned)OP_RGBA) {
      add |= (unsigned)b[nops + 1] << 24;
      ++nops;
      keep = 0u;
    } else {
      keep = 0xFF000000u;
    }
  } else if ((b0 & 0xC0u) == (unsigned)OP_LUMA) {
    const int vg = (int)(b0 & 63u) - 32;
    if (COLCH == 3) {
      const int o = b[1];
      add = bytes3(vg - 8 + (o >> 4), vg, vg - 8 + (o & 15));
      nops = 1;
    } else {
      add = ((unsigned)vg & 255u) * 0x010101u;
    }
  } else if (b0 == (unsigned)OP_BIGRUN) {
    run = MAXRUN - 1;
  } else {
    run = b0 & 63u;
  }
  unsigned len = 1 + nops;
  if (COLCH == 3) {  // alpha modifier: no window near, peek == consumed
    const unsigned pk = b[len];
    if (pk >= (unsigned)OP_ALPHA && pk < (unsigned)OP_LUMA) {
      add += ((pk & 31u) - 16u) << 24;
      ++len;
    }
  }
  return make_uint4(dbase + ((unsigned)(p + (int)len) & (RING - 1)) * 16u,
                    run + 1, add, keep);
}

// the walker's state
struct Walk {
  int pos, rend, res;  // cursor, replay end (-1: none), resume point
  int freed, verified;  // chunks below freed released, up to verified staged
  unsigned v, t;        // the pixel, the pixels emitted
  bool bad;
  uint2* rp;  // the next record
};

// the reference's step for one op, bytes through fetch: CHECKED clamps the
// position and reads the byte ring only where its chunk is resident, else
// the stream itself; unchecked, every byte within REACH of pos is resident
// (a REF's window starts at most 35 bytes back, a teleport lands at most 36
// ahead), a position before the stream read as its first byte. tag: the
// op's first byte where the walker holds it already (a REF's descriptor,
// outside any window), else -1.
template <int COLCH, bool CHECKED>
__device__ __forceinline__ void byte_step(Walk& w,
                                          const uint8_t* __restrict__ data,
                                          int last, const uint8_t* ring,
                                          int tag) {
  auto fetch = [&](int q) -> int {
    if (!CHECKED) return ring[max(q, 0) & (RING - 1)];
    q = min(max(q, 0), last);
    const int k = q >> LOG_CHUNK;
    return (k >= w.freed && k <= w.verified) ? ring[q & (RING - 1)]
                                             : __ldg(data + q);
  };
  auto next = [&]() -> int {  // replay-aware: SQOA_NEXT, without a branch
    const bool tele = w.pos == w.rend;
    const int q = tele ? w.res + 1 : w.pos;
    w.pos = tele ? q : q + 1;
    return fetch(q);
  };
  int r = w.v & 255u, g = (w.v >> 8) & 255u, bl = (w.v >> 16) & 255u,
      al = w.v >> 24;
  int b1;
  if (tag >= 0) {
    b1 = tag;
    ++w.pos;
  } else {
    b1 = next();
  }
  if (b1 < OP_ALPHA) {  // REF: replay 2 + (b1 >> 5) bytes
    w.res = w.pos;
    w.rend = w.pos - (b1 & 31);
    const int start = w.rend - 2 - (b1 >> 5);
    w.bad |= start < 0;
    b1 = fetch(start);  // raw read, not replay-aware
    w.pos = start + 1;
  }
  int run = 0;
  if (b1 == OP_RGB || b1 == OP_RGBA) {
    if (COLCH == 3) {
      r = next();
      g = next();
      bl = next();
    } else {
      g = next();
    }
    if (b1 == OP_RGBA) al = next();
  } else if ((b1 & 0xC0) == OP_LUMA) {
    const int vg = (b1 & 0x3F) - 32;
    g = (g + vg) & 255;
    if (COLCH == 3) {
      const int o = next();
      r = (r + vg - 8 + ((o >> 4) & 15)) & 255;
      bl = (bl + vg - 8 + (o & 15)) & 255;
    }
  } else if (b1 == OP_BIGRUN) {
    run = MAXRUN - 1;
  } else {
    run = b1 & 0x3F;
  }
  if (COLCH == 3) {  // alpha modifier: raw peek, consumed by next()
    const int peek = fetch(w.pos);
    if (peek >= OP_ALPHA && peek < OP_LUMA)
      al = (al + (next() & 0x1F) - 16) & 255;
  } else {
    r = bl = g;
  }
  w.v = (unsigned)r | ((unsigned)g << 8) | ((unsigned)bl << 16) |
        ((unsigned)al << 24);
  record(w.rp++, w.t, w.v);
  w.t += run + 1;
}

// v's pixel p in the out_ch layout of decode_jax._format_pixels
__device__ __forceinline__ void put(uint8_t* __restrict__ out, unsigned p,
                                    int out_ch, unsigned v) {
  if (out_ch == 4) {
    reinterpret_cast<unsigned*>(out)[p] = v;
  } else if (out_ch == 2) {
    reinterpret_cast<unsigned short*>(out)[p] =
        (unsigned short)(((v >> 8) & 255u) | ((v >> 16) & 0xFF00u));
  } else if (out_ch == 3) {
    uint8_t* o = out + 3ull * p;
    o[0] = (uint8_t)v;
    o[1] = (uint8_t)(v >> 8);
    o[2] = (uint8_t)(v >> 16);
  } else {
    out[p] = (uint8_t)(v >> 8);
  }
}

// pixels [0, n_pixels) from the records (first pixel, value), by tiles of
// blockDim.x records: tile j of the block's tiles j0, j0 + step, ...
// covers the pixels from its first record's to the next tile's; a pixel
// takes the value of the last record at or before it (the records' first
// pixels rise, but for the initial value's record and the first op's, both
// at 0)
__device__ void fill(const uint2* __restrict__ rec, int nrec,
                     unsigned n_pixels, int out_ch, uint8_t* __restrict__ out,
                     int j0, int step, unsigned* s_t, unsigned* s_v) {
  const int R = blockDim.x;
  for (long long j = j0; j * R < nrec; j += step) {
    const int i0 = (int)(j * R), cnt = min(R, nrec - i0);
    if ((int)threadIdx.x < cnt) {
      const uint2 r = rec[i0 + threadIdx.x];
      s_t[threadIdx.x] = r.x;
      s_v[threadIdx.x] = r.y;
    }
    const unsigned end = i0 + cnt < nrec ? rec[i0 + cnt].x : n_pixels;
    __syncthreads();
    for (unsigned p = s_t[0] + threadIdx.x; p < end; p += R) {
      int lo = 0, hi = cnt;  // s_t[lo] <= p < s_t[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_t[mid] <= p)
          lo = mid;
        else
          hi = mid;
      }
      put(out, p, out_ch, s_v[lo]);
    }
    __syncthreads();
  }
}

// chunk k's SPAN bytes into sb and its CHUNK into the byte ring, by the
// threads i0, i0 + STEP, ...: a thread's words all loaded before any is
// stored (one global round trip a chunk); the words past the stream's last
// whole one byte by byte, past its last byte that byte (the clamp of the
// byte walk's reads)
template <int STEP>
__device__ __forceinline__ void stage_bytes(const uint8_t* __restrict__ data,
                                            int nbytes, int k, int i0,
                                            uint8_t* sb, uint8_t* ring) {
  constexpr int WORDS = (SPAN / 4 + STEP - 1) / STEP;
  const int last = nbytes - 1;
  const long long base = (long long)k << LOG_CHUNK;
  const bool aligned = (reinterpret_cast<size_t>(data) & 3) == 0;
  const int whole =
      aligned ? (int)((min(base + SPAN, (long long)nbytes) - base) >> 2) : 0;
  const unsigned* src = reinterpret_cast<const unsigned*>(data + base);
  uint8_t* rg = ring + (k & (STAGES - 1)) * CHUNK;
  unsigned x[WORDS];
#pragma unroll
  for (int j = 0; j < WORDS; ++j) {
    const int i = i0 + STEP * j;
    x[j] = i < whole ? __ldg(src + i) : 0u;
  }
  const unsigned end = __ldg(data + last);
#pragma unroll
  for (int j = 0; j < WORDS; ++j) {
    const int i = i0 + STEP * j;
    if (i >= SPAN / 4) break;
    unsigned word = x[j];
    if (i >= whole) {
      word = 0;
      for (int b = 3; b >= 0; --b) {
        const long long q = base + 4 * i + b;
        word = word << 8 | (q < last ? __ldg(data + q) : end);
      }
    }
    reinterpret_cast<unsigned*>(sb)[i] = word;
    if (i < CHUNK / 4) reinterpret_cast<unsigned*>(rg)[i] = word;
  }
}

// the descriptors of chunk k's positions below chunks_len from its bytes in
// sb, and PAD padding words past the last, by the threads i0, i0 + step, ...
template <int COLCH>
__device__ __forceinline__ void describe_chunk(int chunks_len, int k, int i0,
                                               int step, const uint8_t* sb,
                                               uint4* desc, unsigned dbase) {
  const long long base = (long long)k << LOG_CHUNK;
  const int npos = (int)min((long long)CHUNK, chunks_len - base);
  uint4* dd = desc + (k & (STAGES - 1)) * CHUNK;
  for (int i = i0; i < npos; i += step)
    dd[i] = describe<COLCH>(sb + i, (int)base + i, dbase);
  const unsigned a0 = dbase + (unsigned)(k & (STAGES - 1)) * CHUNK * 16u;
  for (int i = npos + i0; i < min(npos + PAD, CHUNK); i += step)
    dd[i] = slow_word(a0 + i * 16u, 0u);
}

template <int COLCH>
__global__ void __launch_bounds__(THREADS)
    k10_walk(const uint8_t* __restrict__ data, int nbytes, int chunks_len,
             unsigned n_pixels, int out_ch, uint8_t* __restrict__ out,
             uint2* __restrict__ rec, int* __restrict__ stat) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* desc = reinterpret_cast<uint4*>(smem);
  uint8_t* ring = smem + RING * 16;
  uint8_t* span = ring + RING;
  volatile int* ctl =
      reinterpret_cast<volatile int*>(span + PRODUCERS * SPAN);
  __shared__ int walked[3];  // err, ops, records
  const unsigned dbase = (unsigned)__cvta_generic_to_shared(desc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int last = nbytes - 1;
  const int nchunks =
      chunks_len > 0 ? (int)(((long long)chunks_len + CHUNK - 1) >> LOG_CHUNK)
                     : 0;
  // the first PAD words of every stage valid (padding: the walk loads the
  // next word before it checks the one in hand), then chunk 0 staged and
  // described by the whole block
  if (threadIdx.x < STAGES * PAD) {
    const int i = (threadIdx.x / PAD) * CHUNK + threadIdx.x % PAD;
    desc[i] = slow_word(dbase + i * 16u, 0u);
  }
  if (threadIdx.x < CTL_WORDS)
    ctl[threadIdx.x] = threadIdx.x < STAGES ? -1 : 0;
  if (nchunks > 0) stage_bytes<THREADS>(data, nbytes, 0, threadIdx.x, span,
                                        ring);
  __syncthreads();
  if (nchunks > 0)
    describe_chunk<COLCH>(chunks_len, 0, threadIdx.x, THREADS, span, desc,
                          dbase);
  if (threadIdx.x == 0) ctl[0] = 0;
  __syncthreads();

  if (threadIdx.x == 0 && ctl[CTL_FAULT] == 0) {
    // ---- the walker ----
    Walk w{HEADER + 1, -1, 0, 0, -1, INIT, 0u, false, rec};
    int fault = 0;
    record(w.rp++, 0u, INIT);
    // the staged span, kept with the chunks it is made of: positions below
    // vend are staged, from fend on they are not freed, and pos < lim
    // starts an op the descriptors hold
    int vend = 0, fend = 0, lim = 0;
    while (w.t < n_pixels && w.pos < chunks_len) {
      if (w.pos >= vend) {  // the cursor entered chunk kp: wait for it
        const int kp = w.pos >> LOG_CHUNK;
        if (kp - 1 > w.freed) {  // a window can reach back into kp - 1
          __threadfence_block();
          ctl[CTL_FREED] = w.freed = kp - 1;
          fend = w.freed << LOG_CHUNK;
        }
        for (; w.verified < kp; ++w.verified) {  // wait for their words
          const int k = w.verified + 1;
          const long long t0 = clock64();
          while (ctl[k & (STAGES - 1)] != k) {
            if (clock64() - t0 > WALKER_WAIT) {
              fault = 1;
              break;
            }
            __nanosleep(32);
          }
          if (fault) break;
        }
        if (fault) break;
        __threadfence_block();
        vend = (int)min((long long)(w.verified + 1) << LOG_CHUNK,
                        0x7FFFFFFFll);
        lim = min(vend, chunks_len);
      }
      int tag = -1;
      if (w.pos > w.rend && w.pos >= fend) {  // ---- fast path ----
        int pos = w.pos;
        unsigned v = w.v, t = w.t;
        const unsigned a0 = dbase + ((unsigned)pos & (RING - 1)) * 16u;
        unsigned at = a0;  // the word of the op at pos
        uint2* rp = w.rp;
        // a batch: ops that can neither leave the staged chunks (6 bytes
        // an op at most) nor pass n_pixels (512 pixels an op at most), so
        // only a REF's word stops them. The chain: each step loads the
        // word after next from the next one (in hand a step ahead); four
        // steps a turn over four words that rotate by name; pos follows
        // from the addresses. The next t goes to a register of its own
        // before the record's store reads the current one.
        const int nb = min((lim - pos) / 6,
                           (int)min((n_pixels - t) / 512u, 1u << 30)) & ~3;
        if (nb > 0) {
          uint4 d0 = lds128(a0), d1 = lds128(d0.x), d2, d3;
#define K10_STEP(D, N, A, I)            \
  A = lds128(N.x);                      \
  if ((int)D.y < 0) {                   \
    at = D.x;                           \
    tag = (int)(D.y >> 16) & 255;       \
    rp += I;                            \
    break;                              \
  }                                     \
  v = apply(v, D);                      \
  {                                     \
    const unsigned tn = t + D.y;        \
    record(rp + I, t, v);               \
    t = tn;                             \
  }
          for (int i = 0;; i += 4) {
            if (i == nb) {
              at = d3.x;
              break;
            }
            K10_STEP(d0, d1, d2, 0)
            K10_STEP(d1, d2, d3, 1)
            K10_STEP(d2, d3, d0, 2)
            K10_STEP(d3, d0, d1, 3)
            rp += 4;
          }
#undef K10_STEP
          pos += (int)(((at - a0) >> 4) & (RING - 1));
        } else {
          // the tail of a chunk or of the image: the word after next
          // loads from the next one before the current one is checked
          uint4 d = lds128(a0);
          uint4 nd = lds128(d.x);
          for (;;) {
            const uint4 nnd = lds128(nd.x);
            if ((int)d.y < 0 || pos >= lim || t >= n_pixels) break;
            v = apply(v, d);
            record(rp++, t, v);
            t += d.y;
            pos += (int)(((d.x - at) >> 4) & (RING - 1));
            at = d.x;
            d = nd;
            nd = nnd;
          }
          if ((int)d.y < 0 && pos < lim && t < n_pixels)
            tag = (int)(d.y >> 16) & 255;  // a REF's word stopped it
        }
        w.rp = rp;
        w.pos = pos;
        w.v = v;
        w.t = t;
        if (tag < 0) continue;  // the next batch, a chunk edge or the end
        // else the word at pos is a REF's, its tag in hand: one byte step
      }
      // unchecked where REACH bytes around pos are staged (and, while no
      // chunk is freed, everything down to the stream's start)
      if ((w.freed == 0 || w.pos >= fend + REACH) && w.pos < vend - REACH)
        byte_step<COLCH, false>(w, data, last, ring, tag);
      else
        byte_step<COLCH, true>(w, data, last, ring, tag);
    }
    const int nrec = (int)(w.rp - rec);
    walked[0] = w.bad;
    walked[1] = nrec - 1;  // an op a record, less the initial value's
    walked[2] = nrec;
    if (fault) atomicOr((int*)&ctl[CTL_FAULT], fault);
    __threadfence_block();
    ctl[CTL_DONE] = 1;
  } else if (warp >= 1 && warp <= PRODUCERS && ctl[CTL_FAULT] == 0) {
    // ---- the producers: chunk k (from 1) in warp 1 + (k - 1) % 3 ----
    uint8_t* sb = span + (warp - 1) * SPAN;  // the chunk and 8 bytes on
    for (int k = warp; k < nchunks; k += PRODUCERS) {
      int go = 1;
      if (lane == 0) {  // the stage's last chunk must be freed
        const long long t0 = clock64();
        while (ctl[CTL_FREED] + STAGES <= k && !ctl[CTL_DONE]) {
          if (clock64() - t0 > PRODUCER_WAIT) {
            atomicOr((int*)&ctl[CTL_FAULT], 2);
            break;
          }
          __nanosleep(256);
        }
        go = ctl[CTL_FREED] + STAGES > k && !ctl[CTL_DONE];
      }
      if (!__shfl_sync(~0u, go, 0)) break;
      __threadfence_block();
      stage_bytes<32>(data, nbytes, k, lane, sb, ring);
      __syncwarp();
      describe_chunk<COLCH>(chunks_len, k, lane, 32, sb, desc, dbase);
      __threadfence_block();
      __syncwarp();
      if (lane == 0) ctl[k & (STAGES - 1)] = k;
    }
  }
  __syncthreads();
  const int fault = ctl[CTL_FAULT];
  if (threadIdx.x == 0) {
    stat[0] = fault ? 0 : walked[0];
    stat[1] = fault ? 0 : walked[1];
    stat[2] = fault ? 0 : walked[2];
    stat[3] = fault;
  }
  if (fault || (long long)n_pixels > SMALL) return;  // k10_fill places them
  unsigned* s_t = reinterpret_cast<unsigned*>(smem);  // the ring is spent
  fill(rec, walked[2], n_pixels, out_ch, out, 0, 1, s_t, s_t + THREADS);
}

__global__ void __launch_bounds__(FILL_THREADS)
    k10_fill(const uint2* __restrict__ rec, const int* __restrict__ stat,
             unsigned n_pixels, int out_ch, uint8_t* __restrict__ out) {
  __shared__ unsigned s_t[FILL_THREADS], s_v[FILL_THREADS];
  if (stat[3]) return;
  fill(rec, stat[2], n_pixels, out_ch, out, blockIdx.x, gridDim.x, s_t, s_v);
}

// one thread chases n dependent __ldg byte reads: off = (off + (byte <<
// shift) + stride) & mask, from 0
__global__ void k10_chase(const uint8_t* __restrict__ buf, unsigned mask,
                          int shift, int stride, int n, int* end,
                          long long* cycles) {
  unsigned off = 0;
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i)
    off = (off + ((unsigned)__ldg(buf + off) << shift) + stride) & mask;
  *cycles = clock64() - t0;
  *end = (int)off;
}

template <int COLCH>
int launch(const uint8_t* data, int nbytes, int chunks_len,
           long long n_pixels, int out_ch, uint8_t* out, uint2* rec,
           int* stat, cudaStream_t stream) {
  // above 48 KB: once a device (the attribute is set per device), before
  // the device's first launch; a bit a device of the current one's index
  static std::atomic<unsigned long long> sized{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(sized.load(std::memory_order_relaxed) & bit)) {
    e = cudaFuncSetAttribute(
        k10_walk<COLCH>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    sized.fetch_or(bit, std::memory_order_relaxed);
  }
  k10_walk<COLCH><<<1, THREADS, SMEM, stream>>>(
      data, nbytes, chunks_len, (unsigned)n_pixels, out_ch, out, rec, stat);
  if (n_pixels > SMALL) {
    const long long tiles = (n_pixels + 1 + FILL_THREADS - 1) / FILL_THREADS;
    k10_fill<<<(int)min(tiles, (long long)FILL_BLOCKS), FILL_THREADS, 0,
               stream>>>(rec, stat, (unsigned)n_pixels, out_ch, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// data: (nbytes,) u8, the stream; out: (n_max * out_ch,) u8, zeroed by the
// caller; rec: (n_pixels + 1) pairs of u32, scratch; stat: (4,) i32, the
// err flag, the ops walked, the records and the fault word (0: none;
// 1: the walker waited out its clock budget for a chunk, 2: a producer for
// a free stage). n_pixels < 2**31.
// Returns cudaGetLastError.
extern "C" int k10_ref_decode(const uint8_t* data, int nbytes, int chunks_len,
                              long long n_pixels, int colch, int out_ch,
                              uint8_t* out, void* rec, int* stat,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  uint2* r = (uint2*)rec;
  return colch == 1 ? launch<1>(data, nbytes, chunks_len, n_pixels, out_ch,
                                out, r, stat, st)
                    : launch<3>(data, nbytes, chunks_len, n_pixels, out_ch,
                                out, r, stat, st);
}

// n dependent byte reads through __ldg in one thread (k10_chase); end (1,)
// i32 gets the last offset, cycles (1,) i64 the SM clocks they took.
// Returns cudaGetLastError.
extern "C" int k10_ldg_chase(const uint8_t* buf, int mask, int shift,
                             int stride, int n, int* end, long long* cycles,
                             void* stream) {
  k10_chase<<<1, 1, 0, (cudaStream_t)stream>>>(buf, (unsigned)mask, shift,
                                               stride, n, end, cycles);
  return (int)cudaGetLastError();
}

// the walk kernel's dynamic shared memory, bytes
extern "C" int k10_shared_bytes() { return SMEM; }
