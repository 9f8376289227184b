// K8: inclusive associative scan along each row of (B, M) int32 arrays.
//
// Replaces seqoia_tpu/ops/pallas_scan.py:tile_scan (kernel
// _tile_scan_kernel) with its combines: running max, wrapping sum, forward
// fill over a (value, flag) pair, the segmented mod-256 sum of two packed
// channels (scan_ops.pack_pair's layout) and the composition of packed
// 5-state maps (scan_ops.compose_state_maps). None of them need commute:
// every combine is applied as op(left, right).
//
// Bound on the H100: bytes. It must read each input word once and write
// each output word once (4 bytes in and out per entry and array); the
// combines cost a few to a few dozen integer operations per entry.
//
// Design: the TPU kernel walks each row's tiles in order and threads the
// running state from one grid step to the next through SMEM. Here the
// tiles run in parallel, in one launch, on lookback.cuh's decoupled
// look-back: a block takes the next 4096-entry tile from a counter, loads
// it into shared memory as 16-byte vectors, scans it (16 consecutive
// entries a thread, then warp shuffles), gets its exclusive prefix from
// its predecessors' published aggregates and prefixes, and writes the tile
// back as vectors. The C function zeroes the status words with one
// cudaMemsetAsync before the launch.

#include <climits>

#include "lookback.cuh"

namespace {

using lb::PAD_TILE;
using lb::u64;

enum { C_MAX = 0, C_SUM = 1, C_FILL = 2, C_SEGMOD = 3, C_MAPS = 4 };

struct Pair {
  int v, f;
};

__device__ __forceinline__ Pair shfl_up(Pair p, int d) {
  return Pair{__shfl_up_sync(lb::FULL, p.v, d),
              __shfl_up_sync(lb::FULL, p.f, d)};
}
__device__ __forceinline__ Pair shfl_down(Pair p, int d) {
  return Pair{__shfl_down_sync(lb::FULL, p.v, d),
              __shfl_down_sync(lb::FULL, p.f, d)};
}

using Tile = int[PAD_TILE];

// Each combine: its element type, identity, op(left, right), how a tile
// entry at padded position p is read from and written to the one or two
// staged arrays, and (for the status words) how an element packs into 33
// bits.
struct OneArray {
  static constexpr int arrays = 1;
  __device__ static int get(Tile* b, int p) { return b[0][p]; }
  __device__ static void put(Tile* b, int p, int v) { b[0][p] = v; }
};

struct OneWord : OneArray {
  __device__ static u64 pack(int v) { return (u64)(unsigned)v; }
  __device__ static int unpack(u64 w) { return (int)(unsigned)w; }
};

struct MaxC : OneWord {
  using T = int;
  __host__ __device__ static T ident() { return INT_MIN; }
  __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};

struct SumC : OneArray, lb::WordSum {};  // wraps like int32 in JAX

// The flags are 0 or 1 (fill_forward's contract; the status word keeps one
// bit of flag). An entry reads as (value if flagged else 0, flag): the
// kernels start every row from the identity (0, 0), and on entries read
// so it is an identity on both sides.
struct FillC {
  using T = Pair;
  static constexpr int arrays = 2;
  __host__ __device__ static T ident() { return Pair{0, 0}; }
  __device__ T operator()(T l, T r) const {
    return Pair{r.f != 0 ? r.v : l.v, l.f | r.f};
  }
  __device__ static T get(Tile* b, int p) {
    const int f = b[1][p];
    return Pair{f != 0 ? b[0][p] : 0, f};
  }
  __device__ static void put(Tile* b, int p, T v) {
    b[0][p] = v.v;
    b[1][p] = v.f;
  }
  __device__ static u64 pack(T v) {
    return (u64)(unsigned)v.v | ((u64)(v.f != 0) << 32);
  }
  __device__ static T unpack(u64 w) {
    return Pair{(int)(unsigned)w, (int)(w >> 32) & 1};
  }
};

// bits 0-7 channel 0, bit 8 its reset flag, bits 16-23 channel 1, bit 24
// its reset flag: a set flag on the right takes the right's value, else the
// channels add mod 256; flags OR.
struct SegmodC : OneWord {
  using T = int;
  __host__ __device__ static T ident() { return 0; }
  __device__ T operator()(T a, T b) const {
    const unsigned l = (unsigned)a, r = (unsigned)b;
    const unsigned s = ((l & 0x00FF00FFu) + (r & 0x00FF00FFu)) & 0x00FF00FFu;
    const unsigned ch0 = ((r >> 8) & 1u) ? (r & 0xFFu) : (s & 0xFFu);
    const unsigned ch1 = ((r >> 24) & 1u) ? (r & 0xFF0000u) : (s & 0xFF0000u);
    return (int)(ch0 | ch1 | (l & 0x01000100u) | (r & 0x01000100u));
  }
};

// five 3-bit entries: (left then right)[e] = right[left[e]]
struct MapsC : OneWord {
  using T = int;
  __host__ __device__ static T ident() {
    return 0 | (1 << 3) | (2 << 6) | (3 << 9) | (4 << 12);
  }
  __device__ T operator()(T l, T r) const {
    int out = 0;
#pragma unroll
    for (int e = 0; e < 5; ++e) {
      const int fe = (l >> (3 * e)) & 7;
      out |= ((r >> (3 * fe)) & 7) << (3 * e);
    }
    return out;
  }
};

// Eight blocks an SM (32 registers a thread): the blocks in flight hide
// each other's look-back and barriers.
template <class C>
__global__ void __launch_bounds__(NT, 8)
    k8_kernel(const int* x0, const int* x1, int m, int n_tiles, u64* status,
              unsigned* counter, int* y0, int* y1) {
  using T = typename C::T;
  constexpr int NA = C::arrays;
  __shared__ Tile buf[NA];
  __shared__ T wtot[lb::NW + 1];
  __shared__ T s_ex;
  __shared__ int s_id;
  const int id = lb::next_tile(counter, &s_id);
  const int row = id / n_tiles, tile = id - row * n_tiles;
  const long long off = (long long)row * m + (long long)tile * lb::TILE;
  const int len = min(lb::TILE, m - tile * lb::TILE);
  lb::load_tile(x0 + off, len, lb::PaddedI32{buf[0]});
  if constexpr (NA == 2)
    lb::load_tile(x1 + off, len, lb::PaddedI32{buf[NA - 1]});
  __syncthreads();

  const int e0 = threadIdx.x * lb::IPT;
  T acc = C::ident();
#pragma unroll
  for (int j = 0; j < lb::IPT; ++j)
    if (e0 + j < len) acc = C()(acc, C::get(buf, lb::pad(e0 + j)));
  T agg;
  const T ex = lb::block_scan_warp(acc, C::ident(), wtot, &agg, C());
  if (threadIdx.x < 32) {
    const T tex =
        lb::tile_prefix<C>(status + (long long)row * n_tiles, tile, agg);
    if (threadIdx.x == 0) s_ex = tex;
  }
  __syncthreads();

  T run = C()(s_ex, ex);
#pragma unroll
  for (int j = 0; j < lb::IPT; ++j) {
    if (e0 + j < len) {
      const int p = lb::pad(e0 + j);
      run = C()(run, C::get(buf, p));
      C::put(buf, p, run);
    }
  }
  __syncthreads();
  lb::store_tile(y0 + off, len, lb::PaddedI32{buf[0]});
  if constexpr (NA == 2)
    lb::store_tile(y1 + off, len, lb::PaddedI32{buf[NA - 1]});
}

template <class C>
int run(const int* x0, const int* x1, int B, int m, int* scratch, int* y0,
        int* y1, cudaStream_t st) {
  const int nt = lb::n_tiles(m);
  const long long tiles = (long long)B * nt;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  u64* words = reinterpret_cast<u64*>(scratch);
  const cudaError_t e = lb::lb_scratch(words, tiles, st);
  if (e != cudaSuccess) return (int)e;
  k8_kernel<C><<<(unsigned)tiles, NT, 0, st>>>(
      x0, x1, m, nt, words + 1, reinterpret_cast<unsigned*>(words), y0, y1);
  return (int)cudaGetLastError();
}

}  // namespace

// combine: C_MAX, C_SUM, C_FILL (x1/y1 the flags, 0 or 1), C_SEGMOD or
// C_MAPS. x0, x1, y0, y1: (B, m) i32 (x1, y1 null unless C_FILL); any row
// length and 4-byte alignment. scratch: 2 * (B * n_tiles(m) + 1) i32
// (ops/scan.py:scratch_words), zeroed here. Returns cudaGetLastError.
extern "C" int k8_scan(int combine, const int* x0, const int* x1, int B,
                       int m, int* scratch, int* y0, int* y1, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0 || m <= 0) return 0;
  switch (combine) {
    case C_MAX:
      return run<MaxC>(x0, x1, B, m, scratch, y0, y1, st);
    case C_SUM:
      return run<SumC>(x0, x1, B, m, scratch, y0, y1, st);
    case C_FILL:
      return run<FillC>(x0, x1, B, m, scratch, y0, y1, st);
    case C_SEGMOD:
      return run<SegmodC>(x0, x1, B, m, scratch, y0, y1, st);
    case C_MAPS:
      return run<MapsC>(x0, x1, B, m, scratch, y0, y1, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
