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
//
// Bound on the H100: bytes. The output is written once and the entries are
// read once; the binary searches touch only the keys, which stay in L2.
//
// Design: the TPU version DMAs one window of entries per output tile, moves
// them into place with a butterfly network and forward-fills with a carry
// from the previous tile, which bounds the fill to max_gap slots. Here each
// thread owns 16 consecutive output units: it binary-searches keys[0,total)
// once for its first slot and then advances its entry index as it walks, so
// there are no windows, carries or gap bounds, and an output slot depends
// only on the entries.

#include "common.cuh"

namespace {

enum {
  EPI_FILL = 0,
  EPI_DEC4 = 1,
  EPI_DEC3 = 2,
  EPI_MONO1 = 3,
  EPI_MONO2 = 4,
  EPI_ENC3 = 5,
  EPI_ENC1 = 6,
};

constexpr int UPT = 16;  // output units per thread

enum { CL_LUMA = 0, CL_RGB = 1, CL_MONO_GA = 2, CL_NONE = 7 };

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

// The entry governing each slot, for slots visited in increasing order.
struct Cursor {
  const int* keys;
  int total;
  int i;
  __device__ void seek(int t) {
    int lo = 0, hi = total;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (keys[mid] <= t) lo = mid + 1; else hi = mid;
    }
    i = lo - 1;
  }
  __device__ void advance(int t) {
    while (i + 1 < total && keys[i + 1] <= t) ++i;
  }
};

__device__ __forceinline__ int pick(const int* p, int i, int ini) {
  return i >= 0 ? p[i] : ini;
}

// One stream byte at position t (encode_v2._emit_epilogue's closed form).
__device__ int enc_byte(int colch, int t, int cur, int meta, int off,
                        int chunk_total, int trail, int emit_tail) {
  const int k = t - off;
  const int pend = meta & 0x1FF;
  const int cls = (meta >> 9) & 7;
  const int n_full = (max(pend - 1, 0) * 538) >> 15;  // (pend-1) // 61
  const int flush = pend > 0 ? n_full + 1 : 0;
  const int ocr = cur & 255, ocg = (cur >> 8) & 255, ocb = (cur >> 16) & 255,
            oca = (cur >> 24) & 255;
  const int ovg = ((meta >> 12) & 63) - 32;
  const int ovg_r = ((meta >> 18) & 15) - 8;
  const int ovg_b = ((meta >> 22) & 15) - 8;
  const int ova = ((meta >> 26) & 31) - 16;
  const int oalpha = (meta >> 31) & 1;
  const int j = k - flush;
  int op;
  if (colch == 3) {
    if (cls == CL_LUMA)
      op = j == 0 ? (0x80 | (ovg + 32))
                  : (j == 1 ? (((ovg_r + 8) << 4) | (ovg_b + 8))
                            : (0x60 | (ova + 16)));
    else
      op = j == 0 ? (0xFE | oalpha)
                  : (j == 1 ? ocr : (j == 2 ? ocg : (j == 3 ? ocb : oca)));
  } else {
    if (cls == CL_MONO_GA)
      op = j == 0 ? 0xFF : (j == 1 ? ocg : oca);
    else if (cls == CL_LUMA)
      op = 0x80 | (ovg + 32);
    else
      op = j == 0 ? (0xFE | oalpha) : (j == 1 ? ocg : oca);
  }
  int byte;
  if (k < flush)
    byte = k >= n_full ? (0xC0 | (pend - 61 * n_full - 1)) : (0xC0 | 60);
  else
    byte = op;
  if (cls == CL_NONE) byte = 0xFD;
  const int total = chunk_total + (emit_tail ? 8 + trail : 0);
  const int tail_pos = t - chunk_total;
  const bool in_tail = tail_pos >= 0 && t < total && emit_tail;
  const int tb = tail_pos == (trail ? 0 : -1) ? 0xFD
                 : (tail_pos == (trail ? 8 : 7) ? 1 : 0);
  const int out = in_tail ? tb : byte;
  return t < total ? (out & 255) : 0;
}

template <int EPI>
__global__ void place_kernel(Place P, long long units, void* out0,
                             int* out1, int* out2, int* out_keys) {
  const long long row = blockIdx.y;
  const long long u0 = ((long long)blockIdx.x * NT + threadIdx.x) * UPT;
  if (u0 >= units) return;
  const int un = (int)min((long long)UPT, units - u0);
  const long long ro = row * P.mc;
  Cursor c;
  c.keys = P.keys + ro;
  c.total = P.totals[row];
  const int* p0 = P.p0 + ro;
  const int* scal = P.scal + row * P.n_scal;
  if (EPI == EPI_DEC3) {
    // word w holds stream bytes 4w..4w+3 of the RGB stream: byte q is
    // channel q % 3 of pixel q / 3
    const int npx = scal[0];
    int* o = (int*)out0 + row * units;
    c.seek((int)(4 * u0 / 3));
    for (int k = 0; k < un; ++k) {
      const long long w = u0 + k;
      uint32_t word = 0;
      for (int b = 0; b < 4; ++b) {
        const long long q = 4 * w + b;
        const int p = (int)(q / 3), ch = (int)(q % 3);
        c.advance(p);
        const int v = p < npx ? pick(p0, c.i, P.ini0) : 0;
        word |= (uint32_t)((v >> (8 * ch)) & 255) << (8 * b);
      }
      o[w] = (int)word;
    }
    return;
  }
  c.seek((int)u0);
  for (int k = 0; k < un; ++k) {
    const int t = (int)(u0 + k);
    c.advance(t);
    const long long ot = row * units + t;
    if (EPI == EPI_FILL) {
      ((int*)out0)[ot] = pick(p0, c.i, P.ini0);
      if (out1) out1[ot] = pick(P.p1 + ro, c.i, P.ini1);
      if (out2) out2[ot] = pick(P.p2 + ro, c.i, P.ini2);
      if (out_keys) out_keys[ot] = pick(c.keys, c.i, P.ini_key);
    } else if (EPI == EPI_DEC4) {
      ((int*)out0)[ot] = t < scal[0] ? pick(p0, c.i, P.ini0) : 0;
    } else if (EPI == EPI_MONO1) {
      ((uint8_t*)out0)[ot] =
          t < scal[0] ? (uint8_t)(pick(p0, c.i, P.ini0) & 255) : 0;
    } else if (EPI == EPI_MONO2) {
      const int v = pick(p0, c.i, P.ini0);
      ((uint16_t*)out0)[ot] =
          t < scal[0] ? (uint16_t)((v & 255) | (((v >> 24) & 255) << 8)) : 0;
    } else {  // EPI_ENC3 / EPI_ENC1
      const int cur = pick(p0, c.i, P.ini0);
      const int meta = pick(P.p1 + ro, c.i, P.ini1);
      const int off = pick(c.keys, c.i, P.ini_key);
      ((uint8_t*)out0)[ot] = (uint8_t)enc_byte(
          EPI == EPI_ENC3 ? 3 : 1, t, cur, meta, off, scal[0], scal[1],
          scal[2]);
    }
  }
}

template <int EPI>
void launch(const Place& P, int B, long long units, void* out0,
            int* out1, int* out2, int* out_keys, cudaStream_t st) {
  const long long per_blk = (long long)NT * UPT;
  const dim3 grid((unsigned)((units + per_blk - 1) / per_blk), B);
  place_kernel<EPI><<<grid, NT, 0, st>>>(P, units, out0, out1, out2,
                                         out_keys);
}

}  // namespace

// keys, p0..p2: (B, mc) i32 (p1/p2 may be null); totals (B,) i32;
// scal (B, n_scal) i32. out0 is (B, units) of the epilogue's dtype, where
// units = n_out, or n_out * 3 / 4 for EPI_DEC3; out1, out2 and out_keys
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
      epi == EPI_DEC3 ? (long long)n_out * 3 / 4 : (long long)n_out;
  switch (epi) {
    case EPI_FILL:
      launch<EPI_FILL>(P, B, units, out0, out1, out2, out_keys, st);
      break;
    case EPI_DEC4:
      launch<EPI_DEC4>(P, B, units, out0, out1, out2, out_keys, st);
      break;
    case EPI_DEC3:
      launch<EPI_DEC3>(P, B, units, out0, out1, out2, out_keys, st);
      break;
    case EPI_MONO1:
      launch<EPI_MONO1>(P, B, units, out0, out1, out2, out_keys, st);
      break;
    case EPI_MONO2:
      launch<EPI_MONO2>(P, B, units, out0, out1, out2, out_keys, st);
      break;
    case EPI_ENC3:
      launch<EPI_ENC3>(P, B, units, out0, out1, out2, out_keys, st);
      break;
    case EPI_ENC1:
      launch<EPI_ENC1>(P, B, units, out0, out1, out2, out_keys, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
