// Shared device helpers for the port's kernels: a block-wide exclusive scan
// and a per-row scan of block aggregates (the middle pass of every
// reduce-then-scan in frontend.cu and encode_front.cu).
//
// The TPU kernels carried their running state from one grid step to the
// next in SMEM; on the GPU the blocks run in parallel and in no order, so
// each scan runs as three passes: every block reduces its chunk to one
// aggregate, one block per row scans the aggregates, and every block
// re-reads its chunk and applies its prefix.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256  // threads per block in every kernel of the port

// Exclusive scan over the block's NT threads (Hillis-Steele in shared
// memory; `op` need not commute: op(left, right)). Returns the thread's
// exclusive prefix and stores the block aggregate in *total.
template <class T, class Op>
__device__ __forceinline__ T block_scan_excl(T v, T ident, T* buf, T* total,
                                             Op op) {
  const int t = threadIdx.x;
  buf[t] = v;
  __syncthreads();
  for (int off = 1; off < NT; off <<= 1) {
    T x = buf[t];
    if (t >= off) x = op(buf[t - off], x);
    __syncthreads();
    buf[t] = x;
    __syncthreads();
  }
  T ex = t > 0 ? buf[t - 1] : ident;
  *total = buf[NT - 1];
  __syncthreads();
  return ex;
}

// One block per row: out[i] = in[0] op ... op in[i-1] (ident for i == 0)
// over the row's n block aggregates; row_total[row] = the whole row's.
template <class T, class Op>
__global__ void scan_blocks_kernel(const T* in, T* out, T* row_total, int n,
                                   T ident, Op op) {
  __shared__ T buf[NT];
  const long long row = blockIdx.x;
  in += row * n;
  out += row * n;
  const int per = (n + NT - 1) / NT;
  const int lo = min((int)threadIdx.x * per, n);
  const int hi = min(lo + per, n);
  T acc = ident;
  for (int i = lo; i < hi; ++i) acc = op(acc, in[i]);
  T tot;
  T run = block_scan_excl(acc, ident, buf, &tot, op);
  for (int i = lo; i < hi; ++i) {
    out[i] = run;
    run = op(run, in[i]);
  }
  if (threadIdx.x == 0 && row_total != nullptr) row_total[row] = tot;
}

struct SumOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
