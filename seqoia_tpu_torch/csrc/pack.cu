// K4: raw interleaved pixel bytes -> packed r | g<<8 | b<<16 | a<<24 pixels.
//
// Replaces seqoia_tpu/ops/pallas_pack.py:pack_words (kernel _pack_kernel):
// output pixel f reads bytes stride*f.. of the raw buffer, which arrives as
// int32 words (the little-endian view of the bytes):
//   stride 3 (RGB/BGR)     r | g<<8 | b<<16 | 0xFF000000
//   stride 2 (gray, alpha)     g<<8         | a<<24
//   stride 1 (gray)            g<<8         | 0xFF000000
// Stride 4 needs no kernel: the words are the pixels.
//
// Bound on the H100: bytes, (stride + 4) per pixel; the shifts are free.
//
// Design: the TPU version gathers with a butterfly network at a compile-time
// distance pattern, a multiply-shift divide and a forward fill, because a
// TPU tile cannot index. Here a thread takes 4 pixels: `stride` input words
// (12, 8 or 4 bytes, whole words, so nothing straddles two threads) and one
// 16-byte vector store. Neighbouring threads read and write neighbouring
// addresses, so both sides coalesce; the rows are contiguous and N is a
// multiple of 4, so the batch flattens into one range of quads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr uint32_t OPAQUE = 0xFF000000u;

template <int STRIDE>
__global__ void pack_kernel(const uint32_t* __restrict__ words,
                            uint4* __restrict__ out, long long quads) {
  const long long q = (long long)blockIdx.x * NT + threadIdx.x;
  if (q >= quads) return;
  const uint32_t* w = words + q * STRIDE;
  uint4 o;
  if (STRIDE == 3) {
    // bytes r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3
    const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
    o.x = (w0 & 0x00FFFFFFu) | OPAQUE;
    o.y = (w0 >> 24) | ((w1 & 0x0000FFFFu) << 8) | OPAQUE;
    o.z = (w1 >> 16) | ((w2 & 0x000000FFu) << 16) | OPAQUE;
    o.w = (w2 >> 8) | OPAQUE;
  } else if (STRIDE == 2) {
    // bytes g0 a0 g1 a1 | g2 a2 g3 a3
    const uint32_t w0 = w[0], w1 = w[1];
    o.x = ((w0 & 0xFFu) << 8) | ((w0 & 0xFF00u) << 16);
    o.y = ((w0 >> 8) & 0xFF00u) | (w0 & 0xFF000000u);
    o.z = ((w1 & 0xFFu) << 8) | ((w1 & 0xFF00u) << 16);
    o.w = ((w1 >> 8) & 0xFF00u) | (w1 & 0xFF000000u);
  } else {
    // bytes g0 g1 g2 g3
    const uint32_t w0 = w[0];
    o.x = ((w0 & 0xFFu) << 8) | OPAQUE;
    o.y = (w0 & 0xFF00u) | OPAQUE;
    o.z = ((w0 >> 8) & 0xFF00u) | OPAQUE;
    o.w = ((w0 >> 16) & 0xFF00u) | OPAQUE;
  }
  out[q] = o;
}

}  // namespace

// words: n_px * stride / 4 i32 (all rows, contiguous); out: n_px i32, 16-byte
// aligned; n_px a multiple of 4. Returns cudaGetLastError.
extern "C" int k4_pack_words(const int* words, int* out, long long n_px,
                             int stride, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long quads = n_px / 4;
  if (quads == 0) return 0;
  const unsigned grid = (unsigned)((quads + NT - 1) / NT);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words);
  uint4* o = reinterpret_cast<uint4*>(out);
  switch (stride) {
    case 3:
      pack_kernel<3><<<grid, NT, 0, st>>>(w, o, quads);
      break;
    case 2:
      pack_kernel<2><<<grid, NT, 0, st>>>(w, o, quads);
      break;
    case 1:
      pack_kernel<1><<<grid, NT, 0, st>>>(w, o, quads);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
