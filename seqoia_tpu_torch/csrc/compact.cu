// K5: order-preserving compaction of a key stream and its payload streams.
//
// Replaces seqoia_tpu/ops/pallas_engine.py:compact (kernel _compact_kernel):
// the entries of each (B, M) row whose valid byte is set move, in order, to
// the front of the row; totals[b] is their exact count.
//
// Bound on the H100: bytes. It must read the valid mask once, read each kept
// key and payload once and write it once.
//
// Design: the TPU version moves each tile's entries left through a
// butterfly network of rolls and appends the packed tile at a cursor
// carried across its sequential grid. Here every kept entry's rank is known
// from a count: each block counts its chunk, one block per row scans the
// counts (the row's total falls out), and each block re-counts its threads'
// runs, scans them in shared memory and writes every kept entry straight to
// its rank. Nothing past totals is written.

#include "common.cuh"

namespace {

constexpr int IPT = 16;
constexpr int CHUNK = NT * IPT;

__device__ int thread_count(const uint8_t* v, int g0, int m) {
  int c = 0;
  for (int j = 0; j < IPT; ++j) {
    const int g = g0 + j;
    if (g >= m) break;
    c += v[g] != 0;
  }
  return c;
}

__global__ void k5_count(const uint8_t* valid, int m, int nblk,
                         int* blk_cnt) {
  __shared__ int buf[NT];
  const long long row = blockIdx.y;
  const int g0 = blockIdx.x * CHUNK + threadIdx.x * IPT;
  int tot;
  block_scan_excl(thread_count(valid + row * m, g0, m), 0, buf, &tot,
                  SumOp());
  if (threadIdx.x == 0) blk_cnt[row * nblk + blockIdx.x] = tot;
}

__global__ void k5_scatter(const uint8_t* valid, const int* key,
                           const int* p0, const int* p1, int m, int nblk,
                           const int* blk_ex, int* key_out, int* p0_out,
                           int* p1_out) {
  __shared__ int buf[NT];
  const long long row = blockIdx.y;
  const long long ro = row * m;
  const uint8_t* v = valid + ro;
  const int g0 = blockIdx.x * CHUNK + threadIdx.x * IPT;
  int tot;
  int r = blk_ex[row * nblk + blockIdx.x] +
          block_scan_excl(thread_count(v, g0, m), 0, buf, &tot, SumOp());
  for (int j = 0; j < IPT; ++j) {
    const int g = g0 + j;
    if (g >= m) break;
    if (!v[g]) continue;
    key_out[ro + r] = key[ro + g];
    if (p0) p0_out[ro + r] = p0[ro + g];
    if (p1) p1_out[ro + r] = p1[ro + g];
    ++r;
  }
}

}  // namespace

// valid (B, m) u8 (0 or 1); key, p0, p1 (B, m) i32 (p0/p1 may be null);
// key_out, p0_out, p1_out (B, m) i32, written below totals only; totals
// (B,) i32. scratch: 2 * B * ceil(m / 4096) i32. Returns cudaGetLastError.
extern "C" int k5_compact(const uint8_t* valid, const int* key, const int* p0,
                          const int* p1, int B, int m, int* scratch,
                          int* key_out, int* p0_out, int* p1_out, int* totals,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nblk = (m + CHUNK - 1) / CHUNK;
  int* blk_cnt = scratch;
  int* blk_ex = scratch + (long long)B * nblk;
  const dim3 grid(nblk, B);
  k5_count<<<grid, NT, 0, st>>>(valid, m, nblk, blk_cnt);
  scan_blocks_kernel<int, SumOp><<<B, NT, 0, st>>>(blk_cnt, blk_ex, totals,
                                                   nblk, 0, SumOp());
  k5_scatter<<<grid, NT, 0, st>>>(valid, key, p0, p1, m, nblk, blk_ex,
                                  key_out, p0_out, p1_out);
  return (int)cudaGetLastError();
}
