// Shared definitions of the port's kernels: the block size and the max
// combine of the block scans (lookback.cuh holds the scan machinery).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256  // threads per block in every kernel of the port

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
