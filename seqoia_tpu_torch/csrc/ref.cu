// K10: sequential decode of SQOA streams that hold OP_REF, one stream a
// thread.
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
// the op before (and a REF on its own byte), so a stream is one chain of
// dependent loads; the bytes it moves (the stream once, the pixels once)
// take far less than the chain.
//
// Design: one thread walks one stream, one block. The bytes come through
// the read-only path (__ldg), and the pixels are written an op at a time:
// a run is a loop of stores, one word, half-word or 3 bytes a pixel.
// The walk ends by writing stat[0], the err flag, and stat[1], the ops
// walked (for a time an op); the caller zeroes the output past n_pixels.

#include "common.cuh"

namespace {

constexpr int HEADER = 14;  // header bytes; the start byte follows
constexpr int OP_ALPHA = 0x60, OP_LUMA = 0x80, OP_BIGRUN = 0xFD,
              OP_RGB = 0xFE, OP_RGBA = 0xFF;
constexpr int MAXRUN = 512;

struct Cursor {
  const uint8_t* __restrict__ b;
  int last;           // nbytes - 1
  int pos, rend, res;  // position, replay end (-1: none), resume

  __device__ __forceinline__ int fetch(int p) const {
    return __ldg(b + min(max(p, 0), last));
  }
  __device__ __forceinline__ int next() {
    if (pos == rend) {
      pos = res + 1;
      return fetch(pos);
    }
    return fetch(pos++);
  }
};

// pixels [t, t + n) of value r, g, b, a in the out_ch layout of
// decode_jax._format_pixels (mono: gray in g)
template <int COLCH>
__device__ __forceinline__ void emit(uint8_t* __restrict__ out, long long t,
                                     long long n, int out_ch, unsigned r,
                                     unsigned g, unsigned b, unsigned a) {
  if (COLCH == 1) r = b = g;
  if (out_ch == 4) {
    unsigned w = r | (g << 8) | (b << 16) | (a << 24);
    unsigned* o = reinterpret_cast<unsigned*>(out) + t;
    for (long long i = 0; i < n; ++i) o[i] = w;
  } else if (out_ch == 2) {
    unsigned short w = (unsigned short)(g | (a << 8));
    unsigned short* o = reinterpret_cast<unsigned short*>(out) + t;
    for (long long i = 0; i < n; ++i) o[i] = w;
  } else if (out_ch == 3) {
    uint8_t* o = out + 3 * t;
    for (long long i = 0; i < n; ++i, o += 3) {
      o[0] = (uint8_t)r;
      o[1] = (uint8_t)g;
      o[2] = (uint8_t)b;
    }
  } else {
    for (long long i = 0; i < n; ++i) out[t + i] = (uint8_t)g;
  }
}

template <int COLCH>
__global__ void __launch_bounds__(1)
    k10_kernel(const uint8_t* __restrict__ data, int nbytes, int chunks_len,
               long long n_pixels, int out_ch, uint8_t* __restrict__ out,
               int* __restrict__ stat) {
  Cursor c{data, nbytes - 1, HEADER + 1, -1, 0};
  unsigned r = 0, g = 0, bl = 0, a = 255;
  bool bad = false;
  int ops = 0;  // each op emits a pixel: at most n_pixels < 2**31
  long long t = 0;
  while (t < n_pixels) {
    if (c.pos >= chunks_len) {  // past the ops: the last pixel repeats
      emit<COLCH>(out, t, n_pixels - t, out_ch, r, g, bl, a);
      break;
    }
    int b1 = c.next();
    ++ops;
    if (b1 < OP_ALPHA) {  // REF: replay 2 + (b1 >> 5) bytes
      c.res = c.pos;
      c.rend = c.pos - (b1 & 31);
      int start = c.rend - 2 - (b1 >> 5);
      bad |= start < 0;
      b1 = c.fetch(start);  // raw read, not replay-aware
      c.pos = start + 1;
    }
    int run = 0;
    if (b1 == OP_RGB || b1 == OP_RGBA) {
      if (COLCH == 3) {
        r = c.next();
        g = c.next();
        bl = c.next();
      } else {
        g = c.next();
      }
      if (b1 == OP_RGBA) a = c.next();
    } else if ((b1 & 0xC0) == OP_LUMA) {
      int vg = (b1 & 0x3F) - 32;
      g = (g + vg) & 255;
      if (COLCH == 3) {
        int o = c.next();
        r = (r + vg - 8 + ((o >> 4) & 15)) & 255;
        bl = (bl + vg - 8 + (o & 15)) & 255;
      }
    } else if (b1 == OP_BIGRUN) {
      run = MAXRUN - 1;
    } else {
      run = b1 & 0x3F;
    }
    if (COLCH == 3) {  // alpha modifier: raw peek, consumed by next()
      int peek = c.fetch(c.pos);
      if (peek >= OP_ALPHA && peek < OP_LUMA)
        a = (a + (c.next() & 0x1F) - 16) & 255;
    }
    long long n = min((long long)run + 1, n_pixels - t);
    emit<COLCH>(out, t, n, out_ch, r, g, bl, a);
    t += n;
  }
  stat[0] = bad;
  stat[1] = ops;
}

}  // namespace

extern "C" int k10_ref_decode(const uint8_t* data, int nbytes, int chunks_len,
                              long long n_pixels, int colch, int out_ch,
                              uint8_t* out, int* stat, cudaStream_t stream) {
  if (colch == 1)
    k10_kernel<1><<<1, 1, 0, stream>>>(data, nbytes, chunks_len, n_pixels,
                                       out_ch, out, stat);
  else
    k10_kernel<3><<<1, 1, 0, stream>>>(data, nbytes, chunks_len, n_pixels,
                                       out_ch, out, stat);
  return (int)cudaGetLastError();
}
