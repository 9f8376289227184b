// K3: SQOA encode front-end, packed pixels -> compacted emission stream.
//
// Replaces seqoia_tpu/ops/pallas_encode.py:encode_front_compact (kernel
// _front_kernel, tile body _front_tile_body): the previous-pixel shift, the
// change/run segmentation (a running max of change positions and the
// closed-form 61/512 run chunking), the LUMA/RGB/mono-GA classification
// with the wrapped deltas packed into the meta word
// (encode_v2._pack_meta's layout), each pixel's emitted byte count with its
// exclusive prefix sum (the byte offsets), and the compaction of the
// emitting pixels.
//
// Bound on the H100: bytes. It must read the (B, N) packed pixels once and
// write one (offset, pixel, meta) triple per emitting pixel.
//
// Design: the TPU version carries the previous pixel, the last change
// index and both cursors across its sequential tiles. Here the two scans
// (the running max of change positions, then the sums of emitted bytes and
// entries, which depend on it) run reduce-then-scan across blocks:
//   k3_lastc  per block: max change position
//   scan      per row: exclusive running max
//   k3_sums   per block: (entries, bytes) of its pixels
//   scan      per row: exclusive sums; the row totals
//   k3_emit   per block: redo the walk with its prefixes and write every
//             emitting pixel at its rank; the per-row scalars.
// Each thread owns 16 consecutive pixels; the walks are recomputed from
// the pixels (in L2 after the first pass) rather than stored.

#include <climits>

#include "common.cuh"

namespace {

constexpr int IPT = 16;
constexpr int CHUNK = NT * IPT;

enum { CL_LUMA = 0, CL_RGB = 1, CL_MONO_GA = 2, CL_NONE = 7 };

struct Sums {
  int cnt, bytes;
};

struct SumsOp {
  __device__ Sums operator()(const Sums& a, const Sums& b) const {
    Sums o;
    o.cnt = a.cnt + b.cnt;
    o.bytes = a.bytes + b.bytes;
    return o;
  }
};

__host__ __device__ __forceinline__ Sums sums_ident() {
  Sums s;
  s.cnt = 0;
  s.bytes = 0;
  return s;
}

__device__ __forceinline__ int w8(int x) { return ((x + 128) & 255) - 128; }

struct Row {
  const int* px;
  int nvalid;
};

__device__ __forceinline__ int prev_of(const Row& r, long long g, int init) {
  return g > 0 ? r.px[g - 1] : init;
}

// Max change position among the thread's pixels (INT_MIN if none).
__device__ int thread_lastc(const Row& r, long long g0, int init) {
  int m = INT_MIN;
  int prev = prev_of(r, g0, init);
  for (int j = 0; j < IPT; ++j) {
    const long long g = g0 + j;
    if (g >= r.nvalid) break;
    const int cur = r.px[g];
    if (cur != prev) m = (int)g;
    prev = cur;
  }
  return m;
}

// Walk the thread's pixels with `lastc` = the last change before g0,
// calling f(g, cur, total_len, meta) for every pixel.
template <class F>
__device__ __forceinline__ void walk(const Row& r, long long g0, int init,
                                     int lastc, int colch, F f) {
  int prev = prev_of(r, g0, init);
  for (int j = 0; j < IPT; ++j) {
    const long long g = g0 + j;
    if (g >= r.nvalid) break;  // invalid pixels emit nothing
    const int cur = r.px[g];
    const bool change = cur != prev;
    const int prev_change = lastc;
    if (change) lastc = (int)g;
    const int pending = change ? (((int)g - 1 - prev_change) & 511) : 0;
    const int flush = pending > 0 ? (((pending - 1) * 538) >> 15) + 1 : 0;
    const bool bigrun = !change && ((((int)g - lastc) & 511) == 0);
    const int vg = w8(((cur >> 8) & 255) - ((prev >> 8) & 255));
    const int va = w8(((cur >> 24) & 255) - ((prev >> 24) & 255));
    int vg_r = 0, vg_b = 0, cls, op_len;
    if (colch == 3) {
      vg_r = w8(w8((cur & 255) - (prev & 255)) - vg);
      vg_b = w8(w8(((cur >> 16) & 255) - ((prev >> 16) & 255)) - vg);
      const bool luma_ok = vg_r >= -8 && vg_r <= 7 && vg >= -32 && vg <= 31 &&
                           vg_b >= -8 && vg_b <= 7 && va >= -16 && va <= 15;
      cls = luma_ok ? CL_LUMA : CL_RGB;
      op_len = (luma_ok ? 2 : 4) + (va != 0);
    } else {
      // mono keeps r = b = 0, so the reference's shared LUMA guard sees
      // vg_r = vg_b = -vg: the mono window is vg in [-7, 8]
      const bool luma_ok = vg >= -7 && vg <= 8 && va >= -16 && va <= 15;
      cls = va != 0 ? CL_MONO_GA : (luma_ok ? CL_LUMA : CL_RGB);
      op_len = va != 0 ? 3 : (luma_ok ? 1 : 2);
    }
    const int tl = change ? flush + op_len : (bigrun ? 1 : 0);
    if (!change) cls = CL_NONE;
    const uint32_t meta = (uint32_t)pending | ((uint32_t)cls << 9) |
                          ((uint32_t)((vg + 32) & 63) << 12) |
                          ((uint32_t)((vg_r + 8) & 15) << 18) |
                          ((uint32_t)((vg_b + 8) & 15) << 22) |
                          ((uint32_t)((va + 16) & 31) << 26) |
                          ((uint32_t)(va != 0) << 31);
    f(g, cur, tl, (int)meta);
    prev = cur;
  }
}

__device__ Row row_of(const int* px, long long N, const int* nvalid,
                      long long row) {
  Row r;
  r.px = px + row * N;
  r.nvalid = nvalid[row];
  return r;
}

// Last change before the thread's first pixel.
__device__ int entry_lastc(const Row& r, long long g0, int init, int blk_ex,
                           int lc0, int* ibuf) {
  int tot;
  const int ex = block_scan_excl(thread_lastc(r, g0, init), INT_MIN, ibuf,
                                 &tot, MaxOp());
  return max(lc0, max(blk_ex, ex));
}

__global__ void k3_lastc(const int* px, long long N, int nblk,
                         const int* nvalid, const int* init_prev,
                         int* blk_max) {
  __shared__ int ibuf[NT];
  const long long row = blockIdx.y;
  const Row r = row_of(px, N, nvalid, row);
  const long long g0 = (long long)blockIdx.x * CHUNK + threadIdx.x * IPT;
  int tot;
  block_scan_excl(thread_lastc(r, g0, init_prev[row]), INT_MIN, ibuf, &tot,
                  MaxOp());
  if (threadIdx.x == 0) blk_max[row * nblk + blockIdx.x] = tot;
}

__global__ void k3_sums(const int* px, long long N, int nblk,
                        const int* nvalid, const int* init_prev,
                        const int* lc0, const int* blk_max_ex, int colch,
                        Sums* blk_sums) {
  __shared__ int ibuf[NT];
  __shared__ Sums sbuf[NT];
  const long long row = blockIdx.y;
  const Row r = row_of(px, N, nvalid, row);
  const long long g0 = (long long)blockIdx.x * CHUNK + threadIdx.x * IPT;
  const int init = init_prev[row];
  const int lc = entry_lastc(r, g0, init, blk_max_ex[row * nblk + blockIdx.x],
                             lc0[row], ibuf);
  Sums acc = sums_ident();
  walk(r, g0, init, lc, colch, [&](long long, int, int tl, int) {
    acc.cnt += tl > 0;
    acc.bytes += tl;
  });
  Sums tot;
  block_scan_excl(acc, sums_ident(), sbuf, &tot, SumsOp());
  if (threadIdx.x == 0) blk_sums[row * nblk + blockIdx.x] = tot;
}

__global__ void k3_emit(const int* px, long long N, int nblk,
                        const int* nvalid, const int* init_prev,
                        const int* lc0, const int* blk_max_ex,
                        const int* row_max, const Sums* blk_sums_ex,
                        const Sums* row_sums, int colch, int* keys, int* curs,
                        int* metas, int* entry_totals, int* chunk_totals,
                        int* last_change) {
  __shared__ int ibuf[NT];
  __shared__ Sums sbuf[NT];
  const long long row = blockIdx.y;
  const Row r = row_of(px, N, nvalid, row);
  const long long g0 = (long long)blockIdx.x * CHUNK + threadIdx.x * IPT;
  const int init = init_prev[row];
  const int lc = entry_lastc(r, g0, init, blk_max_ex[row * nblk + blockIdx.x],
                             lc0[row], ibuf);
  Sums acc = sums_ident();
  walk(r, g0, init, lc, colch, [&](long long, int, int tl, int) {
    acc.cnt += tl > 0;
    acc.bytes += tl;
  });
  Sums tot;
  const Sums ex = block_scan_excl(acc, sums_ident(), sbuf, &tot, SumsOp());
  Sums run = SumsOp()(blk_sums_ex[row * nblk + blockIdx.x], ex);
  int* krow = keys + row * N;
  int* crow = curs + row * N;
  int* mrow = metas + row * N;
  walk(r, g0, init, lc, colch, [&](long long, int cur, int tl, int meta) {
    if (tl > 0) {
      krow[run.cnt] = run.bytes;
      crow[run.cnt] = cur;
      mrow[run.cnt] = meta;
      run.cnt += 1;
      run.bytes += tl;
    }
  });
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    entry_totals[row] = row_sums[row].cnt;
    chunk_totals[row] = row_sums[row].bytes;
    last_change[row] = max(lc0[row], row_max[row]);
  }
}

}  // namespace

// px (B, N) i32 packed pixels; nvalid, init_prev, lc0 (B,) i32 (nvalid <=
// N; lc0 = -(run_in + 1), -1 for a whole image). scratch: 6 * B * nblk + 3
// * B i32 (nblk = ceil(N / 4096)). keys/curs/metas (B, N) i32; the three
// (B,) scalar outputs i32. Returns cudaGetLastError.
extern "C" int k3_encode_front(const int* px, const int* nvalid,
                               const int* init_prev, const int* lc0, int B,
                               long long N, int colch, int* scratch,
                               int* keys, int* curs, int* metas,
                               int* entry_totals, int* chunk_totals,
                               int* last_change, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nblk = (int)((N + CHUNK - 1) / CHUNK);
  const long long nb = (long long)B * nblk;
  int* blk_max = scratch;
  int* blk_max_ex = scratch + nb;
  Sums* blk_sums = reinterpret_cast<Sums*>(scratch + 2 * nb);
  Sums* blk_sums_ex = reinterpret_cast<Sums*>(scratch + 4 * nb);
  int* row_max = scratch + 6 * nb;
  Sums* row_sums = reinterpret_cast<Sums*>(scratch + 6 * nb + B);
  const dim3 grid(nblk, B);
  k3_lastc<<<grid, NT, 0, st>>>(px, N, nblk, nvalid, init_prev, blk_max);
  scan_blocks_kernel<int, MaxOp><<<B, NT, 0, st>>>(blk_max, blk_max_ex,
                                                   row_max, nblk, INT_MIN,
                                                   MaxOp());
  k3_sums<<<grid, NT, 0, st>>>(px, N, nblk, nvalid, init_prev, lc0,
                               blk_max_ex, colch, blk_sums);
  scan_blocks_kernel<Sums, SumsOp><<<B, NT, 0, st>>>(
      blk_sums, blk_sums_ex, row_sums, nblk, sums_ident(), SumsOp());
  k3_emit<<<grid, NT, 0, st>>>(px, N, nblk, nvalid, init_prev, lc0,
                               blk_max_ex, row_max, blk_sums_ex, row_sums,
                               colch, keys, curs, metas, entry_totals,
                               chunk_totals, last_change);
  return (int)cudaGetLastError();
}
