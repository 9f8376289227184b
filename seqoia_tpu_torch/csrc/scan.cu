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
// each output word once.
//
// Design: the TPU version walks each row's tiles in order and threads the
// running state through SMEM. Here the blocks run in parallel, so the scan
// runs reduce-then-scan:
//   k8_reduce  per block: the combine of its chunk
//   scan       per row: exclusive scan of the block aggregates
//   k8_apply   per block: redo the thread aggregates, scan them in shared
//              memory, then walk each thread's run from its prefix.
// Each thread owns 16 consecutive elements; the second walk re-reads them
// (in L2 after the first pass) rather than storing per-element state.

#include <climits>

#include "common.cuh"

namespace {

constexpr int IPT = 16;
constexpr int CHUNK = NT * IPT;

enum { C_MAX = 0, C_SUM = 1, C_FILL = 2, C_SEGMOD = 3, C_MAPS = 4 };

struct Pair {
  int v, f;
};

// Each combine: its element type, identity, op(left, right), and how an
// element is read from / written to the one or two int32 arrays.
struct MaxC {
  using T = int;
  __host__ __device__ static T ident() { return INT_MIN; }
  __device__ T operator()(T a, T b) const { return a > b ? a : b; }
  __device__ static T load(const int* x0, const int*, int i) { return x0[i]; }
  __device__ static void store(int* y0, int*, int i, T v) { y0[i] = v; }
};

struct SumC {
  using T = int;
  __host__ __device__ static T ident() { return 0; }
  __device__ T operator()(T a, T b) const {
    return (int)((unsigned)a + (unsigned)b);  // wraps like int32 in JAX
  }
  __device__ static T load(const int* x0, const int*, int i) { return x0[i]; }
  __device__ static void store(int* y0, int*, int i, T v) { y0[i] = v; }
};

struct FillC {
  using T = Pair;
  __host__ __device__ static T ident() { return Pair{0, 0}; }
  __device__ T operator()(T l, T r) const {
    return Pair{r.f != 0 ? r.v : l.v, l.f | r.f};
  }
  __device__ static T load(const int* x0, const int* x1, int i) {
    return Pair{x0[i], x1[i]};
  }
  __device__ static void store(int* y0, int* y1, int i, T v) {
    y0[i] = v.v;
    y1[i] = v.f;
  }
};

// bits 0-7 channel 0, bit 8 its reset flag, bits 16-23 channel 1, bit 24
// its reset flag: a set flag on the right takes the right's value, else the
// channels add mod 256; flags OR.
struct SegmodC {
  using T = int;
  __host__ __device__ static T ident() { return 0; }
  __device__ T operator()(T a, T b) const {
    const unsigned l = (unsigned)a, r = (unsigned)b;
    const unsigned s = ((l & 0x00FF00FFu) + (r & 0x00FF00FFu)) & 0x00FF00FFu;
    const unsigned ch0 = ((r >> 8) & 1u) ? (r & 0xFFu) : (s & 0xFFu);
    const unsigned ch1 = ((r >> 24) & 1u) ? (r & 0xFF0000u) : (s & 0xFF0000u);
    return (int)(ch0 | ch1 | (l & 0x01000100u) | (r & 0x01000100u));
  }
  __device__ static T load(const int* x0, const int*, int i) { return x0[i]; }
  __device__ static void store(int* y0, int*, int i, T v) { y0[i] = v; }
};

// five 3-bit entries: (left then right)[e] = right[left[e]]
struct MapsC {
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
  __device__ static T load(const int* x0, const int*, int i) { return x0[i]; }
  __device__ static void store(int* y0, int*, int i, T v) { y0[i] = v; }
};

template <class C>
__device__ typename C::T thread_agg(const int* r0, const int* r1, int g0,
                                    int m) {
  typename C::T acc = C::ident();
  for (int j = 0; j < IPT; ++j) {
    const int g = g0 + j;
    if (g >= m) break;
    acc = C()(acc, C::load(r0, r1, g));
  }
  return acc;
}

template <class C>
__global__ void k8_reduce(const int* x0, const int* x1, int m, int nblk,
                          typename C::T* blk) {
  using T = typename C::T;
  __shared__ T buf[NT];
  const long long row = blockIdx.y;
  const int* r0 = x0 + row * m;
  const int* r1 = x1 ? x1 + row * m : nullptr;
  const int g0 = blockIdx.x * CHUNK + threadIdx.x * IPT;
  T tot;
  block_scan_excl(thread_agg<C>(r0, r1, g0, m), C::ident(), buf, &tot, C());
  if (threadIdx.x == 0) blk[row * nblk + blockIdx.x] = tot;
}

template <class C>
__global__ void k8_apply(const int* x0, const int* x1, int m, int nblk,
                         const typename C::T* blk_ex, int* y0, int* y1) {
  using T = typename C::T;
  __shared__ T buf[NT];
  const long long row = blockIdx.y;
  const int* r0 = x0 + row * m;
  const int* r1 = x1 ? x1 + row * m : nullptr;
  int* o0 = y0 + row * m;
  int* o1 = y1 ? y1 + row * m : nullptr;
  const int g0 = blockIdx.x * CHUNK + threadIdx.x * IPT;
  T tot;
  const T ex = block_scan_excl(thread_agg<C>(r0, r1, g0, m), C::ident(), buf,
                               &tot, C());
  T run = C()(blk_ex[row * nblk + blockIdx.x], ex);
  for (int j = 0; j < IPT; ++j) {
    const int g = g0 + j;
    if (g >= m) break;
    run = C()(run, C::load(r0, r1, g));
    C::store(o0, o1, g, run);
  }
}

template <class C>
int run(const int* x0, const int* x1, int B, int m, int* scratch, int* y0,
        int* y1, cudaStream_t st) {
  using T = typename C::T;
  const int nblk = (m + CHUNK - 1) / CHUNK;
  T* agg = reinterpret_cast<T*>(scratch);
  T* agg_ex = agg + (long long)B * nblk;
  const dim3 grid(nblk, B);
  k8_reduce<C><<<grid, NT, 0, st>>>(x0, x1, m, nblk, agg);
  scan_blocks_kernel<T, C><<<B, NT, 0, st>>>(agg, agg_ex, nullptr, nblk,
                                             C::ident(), C());
  k8_apply<C><<<grid, NT, 0, st>>>(x0, x1, m, nblk, agg_ex, y0, y1);
  return (int)cudaGetLastError();
}

}  // namespace

// combine: C_MAX, C_SUM, C_FILL (x1/y1 the flags), C_SEGMOD or C_MAPS.
// x0, x1, y0, y1: (B, m) i32 (x1, y1 null unless C_FILL). scratch: 4 * B *
// ceil(m / 4096) i32. Returns cudaGetLastError.
extern "C" int k8_scan(int combine, const int* x0, const int* x1, int B,
                       int m, int* scratch, int* y0, int* y1, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
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
