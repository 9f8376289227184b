// K11: one pass of the .qoi decode's index fixpoint, fused: every op's
// pixel value and QOI hash from the op bytes and the assumed INDEX values
// (k11_values), and the pass's check that no INDEX read changed
// (k11_stable).
//
// Replaces no Pallas kernel: the JAX package computes a pass
// (seqoia_tpu/codec/decode_compat.py:80 _op_values, and the loop body at
// :162) as XLA elementwise ops around two segmented mod-256 sums of
// pallas_scan.py:tile_scan, and the port did the same with about 50 PyTorch
// elementwise launches and two K8 launches a pass, each reading and writing
// whole (B, M) int32 arrays.
//
// Bound on the H100: bytes. A pass must read each op's bytes (the
// compacted lo and hi words) and its assumed INDEX value once and write its
// value and hash once: 20 bytes an op; the check reads K7's answers and the
// assumed values once, 8 bytes an op. The arithmetic is a few dozen
// integer operations an op.
//
// Design: k11_values is K8's look-back scan (lookback.cuh: a block takes
// the next 4096-op tile from a counter, stages its inputs into shared
// memory as 16-byte vectors, each thread folds 16 consecutive ops, warp
// shuffles scan the block, warp 0 gets the tile's exclusive prefix from its
// predecessors) with the pass's elementwise work done in registers around
// it. A thread forms each op's element from the staged words: the four
// channel deltas as bytes of one 32-bit word (r in bits 0-7, as in the
// packed pixel) and two reset flags (the RGB channels at RGB, RGBA and
// INDEX ops; alpha at RGBA and INDEX ops). The combine adds the words
// bytewise mod 256 (SWAR), takes the right side's bytes where it resets
// them, and ORs the flags; one 64-bit status word carries 34 bits. The
// thread then applies the running prefix, the alpha-before-the-first-anchor
// rule (seqoia.h:716-719: alpha is 255 until the first RGBA or INDEX op)
// and the hash (seqoia.h:414-417, -1 at and past the row's op total), and
// writes both in place of its staged inputs, which leave as vectors.
// k11_stable compares K7's answers with the assumed values, one block a
// 4096-entry tile, and clears the row's flag (set to 1 by a memset before
// the launch) where any differ. The C functions zero the look-back's status
// words and set the flags with cudaMemsetAsync before their launches.

#include <climits>

#include "lookback.cuh"

namespace {

using lb::PAD_TILE;
using lb::u64;

constexpr unsigned F_RGB = 1u, F_A = 2u;

// One op's element, or a fold of consecutive ops: v holds the channel sums
// mod 256 (r, g, b, a from the low byte up), f the resets seen.
struct Px {
  unsigned v, f;
};

__device__ __forceinline__ Px shfl_up(Px p, int d) {
  return Px{__shfl_up_sync(lb::FULL, p.v, d), __shfl_up_sync(lb::FULL, p.f, d)};
}
__device__ __forceinline__ Px shfl_down(Px p, int d) {
  return Px{__shfl_down_sync(lb::FULL, p.v, d),
            __shfl_down_sync(lb::FULL, p.f, d)};
}

struct PxC {
  using T = Px;
  __host__ __device__ static T ident() { return Px{0u, 0u}; }
  __device__ T operator()(T l, T r) const {
    const unsigned keep =
        ((r.f & F_RGB) ? 0x00FFFFFFu : 0u) | ((r.f & F_A) ? 0xFF000000u : 0u);
    const unsigned s = ((l.v & 0x7F7F7F7Fu) + (r.v & 0x7F7F7F7Fu)) ^
                       ((l.v ^ r.v) & 0x80808080u);
    return Px{(r.v & keep) | (s & ~keep), l.f | r.f};
  }
  __device__ static u64 pack(T p) { return (u64)p.v | ((u64)(p.f & 3u) << 32); }
  __device__ static T unpack(u64 w) {
    return Px{(unsigned)w, (unsigned)(w >> 32) & 3u};
  }
};

// The element of one op (bytes b0-b3 in lo, b4 the low byte of hi) given
// its assumed INDEX value; past the row's op total, the identity.
__device__ __forceinline__ Px element(unsigned lo, unsigned b4, unsigned iv,
                                      bool valid) {
  const unsigned b0 = lo & 255u, b1 = (lo >> 8) & 255u;
  if (!valid) return Px{0u, 0u};
  if (b0 < 64u) return Px{iv, F_RGB | F_A};  // INDEX
  const unsigned rgb = lo >> 8;              // b1 | b2 << 8 | b3 << 16
  if (b0 == 0xFEu) return Px{rgb, F_RGB};    // RGB: alpha carries on
  if (b0 == 0xFFu) return Px{rgb | (b4 << 24), F_RGB | F_A};  // RGBA
  const unsigned tag = b0 & 0xC0u;
  if (tag == 0x40u) {  // DIFF: -2..1 a channel
    const unsigned dr = ((b0 >> 4) & 3u) - 2u, dg = ((b0 >> 2) & 3u) - 2u,
                   db = (b0 & 3u) - 2u;
    return Px{(dr & 255u) | ((dg & 255u) << 8) | ((db & 255u) << 16), 0u};
  }
  if (tag == 0x80u) {  // LUMA
    const unsigned vg = (b0 & 0x3Fu) - 32u;
    const unsigned dr = vg - 8u + ((b1 >> 4) & 15u), db = vg - 8u + (b1 & 15u);
    return Px{(dr & 255u) | ((vg & 255u) << 8) | ((db & 255u) << 16), 0u};
  }
  return Px{0u, 0u};  // RUN: the previous pixel
}

// The packed RGBA after an op from the fold of the row up to it.
__device__ __forceinline__ unsigned pixel(Px run) {
  const unsigned a = run.v >> 24;
  const unsigned alpha = (run.f & F_A) ? a : ((a + 255u) & 255u);
  return (run.v & 0x00FFFFFFu) | (alpha << 24);
}

__device__ __forceinline__ int qoi_hash(unsigned px) {
  return (int)(((px & 255u) * 3u + ((px >> 8) & 255u) * 5u +
                ((px >> 16) & 255u) * 7u + (px >> 24) * 11u) %
               64u);
}

// The low byte of each int32 entry, staged as bytes (load_tile's put).
struct LowBytes {
  uint8_t* s;
  __device__ void vec(int e, uint4 q) const {
    s[e] = (uint8_t)q.x;
    s[e + 1] = (uint8_t)q.y;
    s[e + 2] = (uint8_t)q.z;
    s[e + 3] = (uint8_t)q.w;
  }
  __device__ void one(int e, int x) const { s[e] = (uint8_t)x; }
};

// About 38 KB of shared memory a block: five blocks an SM.
__global__ void __launch_bounds__(NT, 4)
    k11_values_kernel(const int* lo, long long ld_lo, const int* hi,
                      long long ld_hi, const int* iv, long long ld_iv,
                      const int* totals, int m, int n_tiles, u64* status,
                      unsigned* counter, int* px, int* hashes) {
  __shared__ int s_lo[PAD_TILE];  // the ops' lo words, then their pixels
  __shared__ int s_iv[PAD_TILE];  // the assumed values, then the hashes
  __shared__ __align__(16) uint8_t s_b4[lb::TILE];
  __shared__ Px wtot[lb::NW + 1];
  __shared__ Px s_ex;
  __shared__ int s_id;
  const int id = lb::next_tile(counter, &s_id);
  const int row = id / n_tiles, tile = id - row * n_tiles;
  const int t0 = tile * lb::TILE;
  const int len = min(lb::TILE, m - t0);
  lb::load_tile(lo + (long long)row * ld_lo + t0, len, lb::PaddedI32{s_lo});
  lb::load_tile(hi + (long long)row * ld_hi + t0, len, LowBytes{s_b4});
  lb::load_tile(iv + (long long)row * ld_iv + t0, len, lb::PaddedI32{s_iv});
  const int live = min(max(totals[row] - t0, 0), len);
  __syncthreads();

  // a thread's 16 ops: their lo words and values from the padded tiles,
  // their b4 bytes as one 16-byte read; the elements are formed again for
  // the second sweep rather than held in registers across the scan
  const int e0 = threadIdx.x * lb::IPT;
  const uint4 q = *reinterpret_cast<const uint4*>(s_b4 + e0);
  const unsigned b4w[4] = {q.x, q.y, q.z, q.w};
  auto el = [&](int j) {
    const int e = e0 + j, p = lb::pad(e);
    return element((unsigned)s_lo[p], (b4w[j >> 2] >> (8 * (j & 3))) & 255u,
                   (unsigned)s_iv[p], e < live);
  };
  Px acc = PxC::ident();
#pragma unroll
  for (int j = 0; j < lb::IPT; ++j)
    if (e0 + j < len) acc = PxC()(acc, el(j));
  Px agg;
  const Px ex = lb::block_scan_warp(acc, PxC::ident(), wtot, &agg, PxC());
  if (threadIdx.x < 32) {
    const Px tex =
        lb::tile_prefix<PxC>(status + (long long)row * n_tiles, tile, agg);
    if (threadIdx.x == 0) s_ex = tex;
  }
  __syncthreads();

  Px run = PxC()(s_ex, ex);
#pragma unroll
  for (int j = 0; j < lb::IPT; ++j) {
    const int e = e0 + j;
    if (e < len) {
      run = PxC()(run, el(j));
      const unsigned v = pixel(run);
      const int p = lb::pad(e);
      s_lo[p] = (int)v;
      s_iv[p] = e < live ? qoi_hash(v) : -1;
    }
  }
  __syncthreads();
  const long long out = (long long)row * m + t0;
  lb::store_tile(px + out, len, lb::PaddedI32{s_lo});
  if (hashes != nullptr)
    lb::store_tile(hashes + out, len, lb::PaddedI32{s_iv});
}

__global__ void __launch_bounds__(NT)
    k11_stable_kernel(const int* got, const int* iv, int m, int n_tiles,
                      uint8_t* stable) {
  const int row = blockIdx.x / n_tiles, tile = blockIdx.x - row * n_tiles;
  const int t0 = tile * lb::TILE;
  const int len = min(lb::TILE, m - t0);
  const long long off = (long long)row * m + t0;
  bool diff = false;
#pragma unroll
  for (int j = 0; j < lb::IPT; ++j) {
    const int e = threadIdx.x + j * NT;
    if (e < len) diff |= __ldcs(got + off + e) != __ldcs(iv + off + e);
  }
  if (__syncthreads_or(diff) && threadIdx.x == 0) stable[row] = 0;
}

}  // namespace

// lo, hi, iv: (B, m) i32, row r at base + r * ld_* (ld_* >= m), any
// alignment; totals: (B,) i32. scratch: 2 * (B * n_tiles(m) + 1) i32
// (ops/fixpoint.py:scratch_words), zeroed here. px, hashes: (B, m) i32,
// contiguous; hashes null: the values alone. Returns cudaGetLastError.
extern "C" int k11_values(const int* lo, long long ld_lo, const int* hi,
                          long long ld_hi, const int* iv, long long ld_iv,
                          const int* totals, int B, int m, int* scratch,
                          int* px, int* hashes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || m <= 0) return 0;
  if (m > INT_MAX - lb::TILE) return (int)cudaErrorInvalidValue;
  const int nt = lb::n_tiles(m);
  const long long tiles = (long long)B * nt;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  u64* words = reinterpret_cast<u64*>(scratch);
  const cudaError_t e = lb::lb_scratch(words, tiles, st);
  if (e != cudaSuccess) return (int)e;
  k11_values_kernel<<<(unsigned)tiles, NT, 0, st>>>(
      lo, ld_lo, hi, ld_hi, iv, ld_iv, totals, m, nt, words + 1,
      reinterpret_cast<unsigned*>(words), px, hashes);
  return (int)cudaGetLastError();
}

// got, iv: (B, m) i32, contiguous. stable: (B,) bytes (a torch.bool
// tensor), set here: 1 where every entry of the row agrees, else 0.
// Returns cudaGetLastError.
extern "C" int k11_stable(const int* got, const int* iv, int B, int m,
                          uint8_t* stable, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0) return 0;
  cudaError_t e = cudaMemsetAsync(stable, 1, (size_t)B, st);
  if (e != cudaSuccess || m <= 0) return (int)e;
  if (m > INT_MAX - lb::TILE) return (int)cudaErrorInvalidValue;
  const int nt = lb::n_tiles(m);
  const long long tiles = (long long)B * nt;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  k11_stable_kernel<<<(unsigned)tiles, NT, 0, st>>>(got, iv, m, nt, stable);
  return (int)cudaGetLastError();
}
