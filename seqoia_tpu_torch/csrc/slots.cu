// K7: per-slot last writer (the QOI-compat color index table).
//
// Replaces seqoia_tpu/ops/pallas_slots.py:slot_last_writer (kernel
// _slot_kernel): for each position i < n_live with qslot[i] = k in
// [0, n_slots), out[i] = values[j] for the largest j < i with hashes[j] = k,
// else init. Hashes outside [0, n_slots) never write; positions at or past
// n_live return init.
//
// Bound on the H100: bytes. It must read the hashes and qslots once, read
// one value per resolved query and write every output word once.
//
// Design: the TPU version runs one forward fill per slot over each tile and
// carries the 64-128 slot table across its sequential tiles in SMEM. Here
// the answer is a per-slot running maximum of writer indices followed by
// one gather, in one launch on lookback.cuh's decoupled look-back:
//   - a block takes the next 4096-entry tile from a counter; each warp owns
//     512 consecutive entries as 16 groups of 32, one entry a lane, loaded
//     as coalesced words into registers (a tile at or past n_live writes
//     init and reads nothing);
//   - each warp's table of last writers (atomicMax in shared memory), then
//     one thread per slot folds the 8 warp tables into every warp's
//     exclusive prefix and the tile's aggregate;
//   - the aggregate is published as one 64-bit status word per (tile,
//     slot), writer index + 1 in the value bits (0: none), so no fence
//     orders a table against a flag; the same thread walks back over its
//     slot's words, four predecessors a load, until it meets an inclusive
//     prefix (max commutes, so the order of the folds does not matter);
//   - each warp then resolves its groups in order: a query's writer inside
//     its own group is the highest lower lane of its slot's class
//     (__match_any_sync masks written per slot and read masked by
//     lanemask_lt, so a writer never answers its own query), else the
//     warp's running table, which the highest lane of each class updates;
//   - values are gathered for the resolved queries only and the output
//     words leave as coalesced warp stores.
// Shared memory is two words per slot a warp (8 KB at 128 slots); the C
// function zeroes the status words with one cudaMemsetAsync before the
// launch.

#include <climits>

#include "lookback.cuh"

namespace {

using lb::u64;

constexpr int MAX_SLOTS = 128;
constexpr int TILE = lb::TILE;            // entries a tile
constexpr int WRUN = TILE / lb::NW;       // entries a warp
constexpr int GROUPS = WRUN / 32;         // groups of 32 a warp

// The exclusive prefix of slot k in tile `tile` (writer index, -1: none),
// by one thread; st holds the row's words, (tile j, slot k) at j * S + k.
__device__ int slot_prefix(u64* st, int tile, int S, int k, int agg) {
  if (tile == 0) {
    lb::st_status(st + k, lb::ST_PREFIX | (u64)(agg + 1));
    return -1;
  }
  lb::st_status(st + (long long)tile * S + k, lb::ST_AGG | (u64)(agg + 1));
  int ex = -1;
  for (int j = tile - 1;; j -= 4) {
    u64 s[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      s[u] = j - u >= 0 ? lb::ld_status(st + (long long)(j - u) * S + k)
                        : lb::ST_PREFIX;
    bool done = false;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      while ((s[u] >> lb::ST_SHIFT) == 0) {
        __nanosleep(32);
        s[u] = lb::ld_status(st + (long long)(j - u) * S + k);
      }
      ex = max(ex, (int)(s[u] & lb::VAL_MASK) - 1);
      if ((s[u] >> lb::ST_SHIFT) == 2) {
        done = true;
        break;
      }
    }
    if (done) break;
  }
  lb::st_status(st + (long long)tile * S + k,
                lb::ST_PREFIX | (u64)(max(ex, agg) + 1));
  return ex;
}

__global__ void __launch_bounds__(NT, 4)
    k7_kernel(const int* hashes, const int* values, const int* qslots,
              const int* n_live, int m, int nt, int S, int init, u64* status,
              unsigned* counter, int* out) {
  // per warp: the last writer of each slot before the current group, and
  // the current group's writer lanes of each slot (0 between groups)
  __shared__ int tab[lb::NW][MAX_SLOTS];
  __shared__ unsigned cls[lb::NW][MAX_SLOTS];
  __shared__ int s_id;
  const int id = lb::next_tile(counter, &s_id);
  const int row = id / nt, tile = id - row * nt;
  const long long ro = (long long)row * m;
  const int live = max(min(n_live[row], m), 0);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int t0 = tile * TILE;
  const int g0 = t0 + w * WRUN + lane;  // this lane's entry in group 0
  if (t0 >= live) {  // nothing here writes or resolves, nor after it
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
      if (g0 + 32 * g < m) __stcs(out + ro + g0 + 32 * g, init);
    return;
  }
  int h[GROUPS], q[GROUPS];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int i = g0 + 32 * g;
    const bool in = i < live;
    h[g] = in ? __ldcs(hashes + ro + i) : -1;
    q[g] = in ? __ldcs(qslots + ro + i) : -1;
  }
  for (int k = lane; k < S; k += 32) {
    tab[w][k] = -1;
    cls[w][k] = 0;
  }
  __syncwarp();
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    if ((unsigned)h[g] >= (unsigned)S) h[g] = -1;
    if ((unsigned)q[g] >= (unsigned)S) q[g] = -1;
    if (h[g] >= 0) atomicMax(&tab[w][h[g]], g0 + 32 * g);
  }
  __syncthreads();
  if (threadIdx.x < S) {
    const int k = threadIdx.x;
    int agg = -1;
#pragma unroll
    for (int v = 0; v < lb::NW; ++v) {
      const int t = tab[v][k];
      tab[v][k] = agg;
      agg = max(agg, t);
    }
    const int ex =
        slot_prefix(status + (long long)row * nt * S, tile, S, k, agg);
#pragma unroll
    for (int v = 0; v < lb::NW; ++v) tab[v][k] = max(tab[v][k], ex);
  }
  __syncthreads();

  const unsigned lt = (1u << lane) - 1u;
  int* T = tab[w];
  unsigned* C = cls[w];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int hv = h[g], qv = q[g];
    const int first = g0 - lane + 32 * g;  // the group's lane 0
    const unsigned mask = __match_any_sync(lb::FULL, hv);
    const bool top = hv >= 0 && 31 - __clz(mask) == lane;
    if (top) C[hv] = mask;
    __syncwarp();
    int wr = -1;
    if (qv >= 0) {
      const unsigned mm = C[qv] & lt;
      wr = mm ? first + 31 - __clz(mm) : T[qv];
    }
    __syncwarp();
    if (top) {
      T[hv] = first + lane;
      C[hv] = 0;
    }
    __syncwarp();
    q[g] = wr;
  }
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int i = g0 + 32 * g;
    if (i < m) __stcs(out + ro + i, q[g] >= 0 ? values[ro + q[g]] : init);
  }
}

}  // namespace

// hashes, values, qslots, out: (B, m) i32, any alignment; n_live (B,) i32;
// n_slots in [1, 128]. scratch: 2 * (B * n_tiles(m) * n_slots + 1) i32
// (ops/slots.py:scratch_words), zeroed here. Returns cudaGetLastError.
extern "C" int k7_slots(const int* hashes, const int* values,
                        const int* qslots, const int* n_live, int B, int m,
                        int n_slots, int init, int* scratch, int* out,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_slots < 1 || n_slots > MAX_SLOTS || m > INT_MAX - TILE)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || m <= 0) return 0;
  const int nt = lb::n_tiles(m);
  const long long tiles = (long long)B * nt;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  u64* words = reinterpret_cast<u64*>(scratch);
  const cudaError_t e = lb::lb_scratch(words, tiles * n_slots, st);
  if (e != cudaSuccess) return (int)e;
  k7_kernel<<<(unsigned)tiles, NT, 0, st>>>(
      hashes, values, qslots, n_live, m, nt, n_slots, init, words + 1,
      reinterpret_cast<unsigned*>(words), out);
  return (int)cudaGetLastError();
}
