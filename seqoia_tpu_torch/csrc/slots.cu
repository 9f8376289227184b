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
// one gather, run reduce-then-scan with the slot table as the aggregate:
//   k7_reduce   per block: its table of last writers (atomicMax in shared
//               memory; -1 where a slot has none)
//   scan        per (row, slot): exclusive running max over the blocks
//   k7_resolve  per block: each thread builds the table of its own run in
//               shared memory, one thread per slot scans that slot down the
//               threads from the block's prefix, and each thread then walks
//               its run once, answering each query before recording the
//               writer at the same position (a writer is not seen by its
//               own position's query).
// The per-thread tables take NT * (n_slots + 1) words of dynamic shared
// memory (66.5 KB at 64 slots, 132 KB at 128), above the 48 KB default.

#include "common.cuh"

namespace {

constexpr int IPT = 32;
constexpr int CHUNK = NT * IPT;
constexpr int MAX_SLOTS = 128;

__global__ void k7_reduce(const int* hashes, const int* n_live, int m,
                          int nblk, int S, int* blk_tab) {
  __shared__ int tab[MAX_SLOTS];
  const long long row = blockIdx.y;
  const int* h = hashes + row * m;
  const int live = min(n_live[row], m);
  for (int k = threadIdx.x; k < S; k += NT) tab[k] = -1;
  __syncthreads();
  const int g0 = blockIdx.x * CHUNK + threadIdx.x * IPT;
  for (int j = 0; j < IPT; ++j) {
    const int g = g0 + j;
    if (g >= live) break;
    const int s = h[g];
    if ((unsigned)s < (unsigned)S) atomicMax(&tab[s], g);
  }
  __syncthreads();
  // (row, slot)-major, so each slot's block aggregates are contiguous
  for (int k = threadIdx.x; k < S; k += NT)
    blk_tab[(row * S + k) * nblk + blockIdx.x] = tab[k];
}

__global__ void k7_resolve(const int* hashes, const int* values,
                           const int* qslots, const int* n_live, int m,
                           int nblk, int S, int init, const int* blk_ex,
                           int* out) {
  extern __shared__ int tabs[];  // NT tables of S words, stride S + 1
  const int stride = S + 1;
  const long long row = blockIdx.y;
  const long long ro = row * m;
  const int live = min(n_live[row], m);
  const int g0 = blockIdx.x * CHUNK + threadIdx.x * IPT;
  if (blockIdx.x * CHUNK >= live) {  // the whole block is past n_live
    for (int j = 0; j < IPT && g0 + j < m; ++j) out[ro + g0 + j] = init;
    return;
  }
  int* mine = tabs + threadIdx.x * stride;
  for (int k = 0; k < S; ++k) mine[k] = -1;
  for (int j = 0; j < IPT; ++j) {
    const int g = g0 + j;
    if (g >= live) break;
    const int s = hashes[ro + g];
    if ((unsigned)s < (unsigned)S) mine[s] = g;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < S; k += NT) {
    int run = blk_ex[(row * S + k) * nblk + blockIdx.x];
    for (int t = 0; t < NT; ++t) {
      const int v = tabs[t * stride + k];
      tabs[t * stride + k] = run;
      run = max(run, v);
    }
  }
  __syncthreads();
  for (int j = 0; j < IPT; ++j) {
    const int g = g0 + j;
    if (g >= m) break;
    int res = init;
    if (g < live) {
      const int q = qslots[ro + g];
      if ((unsigned)q < (unsigned)S) {
        const int w = mine[q];
        if (w >= 0) res = values[ro + w];
      }
      const int s = hashes[ro + g];
      if ((unsigned)s < (unsigned)S) mine[s] = g;
    }
    out[ro + g] = res;
  }
}

}  // namespace

// hashes, values, qslots, out: (B, m) i32; n_live (B,) i32; n_slots in
// [1, 128]. scratch: 2 * B * n_slots * ceil(m / 8192) i32. Returns
// cudaGetLastError.
extern "C" int k7_slots(const int* hashes, const int* values,
                        const int* qslots, const int* n_live, int B, int m,
                        int n_slots, int init, int* scratch, int* out,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_slots < 1 || n_slots > MAX_SLOTS) return (int)cudaErrorInvalidValue;
  const int nblk = (m + CHUNK - 1) / CHUNK;
  int* blk_tab = scratch;
  int* blk_ex = scratch + (long long)B * n_slots * nblk;
  const dim3 grid(nblk, B);
  const int smem = NT * (n_slots + 1) * (int)sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      k7_resolve, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  k7_reduce<<<grid, NT, 0, st>>>(hashes, n_live, m, nblk, n_slots, blk_tab);
  scan_blocks_kernel<int, MaxOp><<<B * n_slots, NT, 0, st>>>(
      blk_tab, blk_ex, nullptr, nblk, -1, MaxOp());
  k7_resolve<<<grid, NT, smem, st>>>(hashes, values, qslots, n_live, m, nblk,
                                     n_slots, init, blk_ex, out);
  return (int)cudaGetLastError();
}
