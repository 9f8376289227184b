// K9: sequential decode of QOI-compat ops, one thread per stream.
//
// Replaces the lax.scan of seqoia_tpu/codec/decode_jax.py:decode_stream_compat
// (step _compat_scan_step), the JAX package's sequential compat decoder; it
// is no Pallas kernel. The port runs it on the color .qoi rows the index
// fixpoint (codec/decode_compat.py) leaves unsettled after its bounded
// passes, where the JAX package decodes them on the host, and on every mono
// .qoi row (the JAX package's route for mono too: it has no fixpoint).
//
// Input: the compacted op stream of each row (op bytes 0-3 in one word, byte
// 4 in a second, read by color RGBA ops only; K5's output). Output: the
// packed value after each op, exactly the reference's running pixel
// (seqoia.h:716-787): every op writes its value into the index table at its
// hash, and an INDEX op reads the slot.
//
// Two steps, a compile-time branch each:
// - color: a 64-slot table, the RGBA value packed r | g<<8 | b<<16 | a<<24;
// - mono: a 128-slot table (seqoia.h:690-693), INDEX for every tag below
//   128 (so no DIFF), RGB (0xFE) the gray of byte 1, RGBA (0xFF) gray and
//   alpha of bytes 1-2, LUMA gray += (tag & 63) - 32. The reference keeps
//   gray in g with r = b = 0, so the hash is (g*5 + a*11) % 128; the value
//   is stored and written with gray in byte 0 (gray | a<<24), the layout
//   codec/decode_v2._emit_pixels reads for a mono source.
// A RUN carries the value in both.
//
// Bound on the H100: latency, not bytes. Each op's value depends on the one
// before (and INDEX reads on the table), so a row is one dependent chain of
// a few dozen cycles per op; rows run in parallel threads. The byte bound
// (read 8 bytes, write 4 per op) is far below what one thread can reach.
//
// Design: each thread keeps its table in shared memory, slot-major with the
// block's threads interleaved (no bank conflicts; 16 KB a block for mono),
// and walks its row's ops in order. The caller zeroes the output; nothing
// past a row's total is written.

#include "common.cuh"

namespace {

constexpr int ST = 32;  // threads (rows) per block

template <bool MONO>
__global__ void k9_sequential(const int* lo, const int* hi, const int* totals,
                              int B, int mo, int* out) {
  constexpr int SLOTS = MONO ? 128 : 64;
  __shared__ unsigned tab[SLOTS * ST];
  const int t = threadIdx.x;
  const long long row = (long long)blockIdx.x * ST + t;
  if (row >= B) return;
  for (int s = 0; s < SLOTS; ++s) tab[s * ST + t] = 0u;
  const int* l = lo + row * mo;
  int* o = out + row * mo;
  const int total = min(totals[row], mo);
  unsigned px = 0xFF000000u;  // (0, 0, 0, 255); mono: gray 0, alpha 255
  for (int j = 0; j < total; ++j) {
    const unsigned w = (unsigned)l[j];
    const unsigned b0 = w & 255u;
    unsigned slot;
    if (MONO) {
      if (b0 < 128u) {  // INDEX
        px = tab[b0 * ST + t];
      } else if (b0 == 0xFEu) {  // RGB: gray, alpha carries
        px = (px & 0xFF000000u) | ((w >> 8) & 255u);
      } else if (b0 == 0xFFu) {  // RGBA: gray and alpha
        px = ((w >> 8) & 255u) | (((w >> 16) & 255u) << 24);
      } else if (b0 < 0xC0u) {  // LUMA
        px = (px & 0xFF000000u) | ((px + (b0 & 63u) - 32u) & 255u);
      }  // RUN: the value carries
      slot = ((px & 255u) * 5u + (px >> 24) * 11u) & 127u;
    } else {
      if (b0 < 64u) {  // INDEX
        px = tab[b0 * ST + t];
      } else if (b0 == 0xFEu) {  // RGB: alpha carries
        px = (px & 0xFF000000u) | (w >> 8);
      } else if (b0 == 0xFFu) {  // RGBA
        px = (w >> 8) | (((unsigned)hi[row * mo + j] & 255u) << 24);
      } else if (b0 < 0xC0u) {  // DIFF or LUMA
        int dr, dg, db;
        if (b0 < 0x80u) {
          dr = (int)((b0 >> 4) & 3u) - 2;
          dg = (int)((b0 >> 2) & 3u) - 2;
          db = (int)(b0 & 3u) - 2;
        } else {
          const unsigned b1 = (w >> 8) & 255u;
          dg = (int)(b0 & 0x3Fu) - 32;
          dr = dg - 8 + (int)((b1 >> 4) & 15u);
          db = dg - 8 + (int)(b1 & 15u);
        }
        const unsigned r = ((px & 255u) + (unsigned)dr) & 255u;
        const unsigned g = (((px >> 8) & 255u) + (unsigned)dg) & 255u;
        const unsigned b = (((px >> 16) & 255u) + (unsigned)db) & 255u;
        px = (px & 0xFF000000u) | r | (g << 8) | (b << 16);
      }  // RUN: the value carries
      slot = ((px & 255u) * 3u + ((px >> 8) & 255u) * 5u +
              ((px >> 16) & 255u) * 7u + (px >> 24) * 11u) & 63u;
    }
    tab[slot * ST + t] = px;
    o[j] = (int)px;
  }
}

}  // namespace

// lo, out: (B, mo) i32 (out zeroed by the caller); hi: (B, mo) i32, read by
// the color step only (may be null for colch 1); totals (B,) i32; colch 1
// (mono step) or 3 (color step). Returns cudaGetLastError.
extern "C" int k9_sequential_decode(const int* lo, const int* hi,
                                    const int* totals, int B, int mo,
                                    int colch, int* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0) return 0;
  const int grid = (B + ST - 1) / ST;
  if (colch == 1)
    k9_sequential<true><<<grid, ST, 0, st>>>(lo, hi, totals, B, mo, out);
  else
    k9_sequential<false><<<grid, ST, 0, st>>>(lo, hi, totals, B, mo, out);
  return (int)cudaGetLastError();
}
