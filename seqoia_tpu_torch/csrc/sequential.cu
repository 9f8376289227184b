// K9: sequential decode of QOI-compat ops, one row a warp.
//
// Replaces the lax.scan of seqoia_tpu/codec/decode_jax.py:decode_stream_compat
// (step _compat_scan_step), the JAX package's sequential compat decoder; it
// is no Pallas kernel. The port runs it on the color .qoi rows the index
// fixpoint (codec/decode_compat.py) leaves unsettled after its bounded
// passes, where the JAX package decodes them on the host, and on every mono
// .qoi row (the JAX package's route for mono too: it has no fixpoint).
//
// Input: the compacted op stream of each row (op bytes 0-3 in one word, byte
// 4 in a second, read by color RGBA ops only; K5's output). Output: the
// packed value after each op, exactly the reference's running pixel
// (seqoia.h:716-787): every op writes its value into the index table at its
// hash, and an INDEX op reads the slot.
//
// Two steps, a compile-time switch each:
// - color: a 64-slot table, the RGBA value packed r | g<<8 | b<<16 | a<<24,
//   hash (r*3 + g*5 + b*7 + a*11) % 64;
// - mono: a 128-slot table (seqoia.h:690-693), INDEX for every tag below
//   128 (so no DIFF), RGB (0xFE) the gray of byte 1, RGBA (0xFF) gray and
//   alpha of bytes 1-2, LUMA gray += (tag & 63) - 32. The reference keeps
//   gray in g with r = b = 0, so the hash is (g*5 + a*11) % 128; the value
//   is stored and written with gray in byte 0 (gray | a<<24), the layout
//   codec/decode_v2._emit_pixels reads for a mono source.
// A RUN carries the value in both.
//
// Bound on the H100: latency, not bytes. Each op's value depends on the one
// before, and an INDEX op on the table write of any op before it, so a row is
// one dependent chain; the byte bound (read 8 or 12 bytes, write 4 an op) is
// three to four orders of magnitude below it. What sets the time is the
// chain's length in cycles a step, and how many rows run side by side.
//
// Design:
// - One row a warp, one warp a block, with its table in shared memory; a
//   class of 32 rows spreads over 32 blocks, not one warp. The table and
//   tiles sit at fixed shared addresses; blocks of 2, 4 and 8 warps ran
//   slower at every shape measured.
// - Ops off the chain: the warp copies its row's op words 32 at a time into
//   a shared ring of STAGES chunks with cp.async (coalesced, three chunks in
//   flight while one is walked). Each lane pre-decodes its op of the chunk
//   into the step's operands, in straight-line code (no lane waits on
//   another's tag): the INDEX slot (as a byte offset) or -1, a keep mask M
//   and a byte-wise addend X (the DIFF/LUMA deltas, or the RGB/RGBA literal
//   in the bytes M clears). Past the row's end the operands are a RUN's, so
//   every walk is 32 steps without a branch.
// - One branch-free step for both forms: v = INDEX ? table : (v & M) + X,
//   byte-wise mod 256 (no carry across bytes; for a literal the bytes are
//   zero, so the sum is the literal), then the slot of v (one dp4a) and the
//   table write. Only the table size and the hash weights differ.
// - A single walker: lane 0 loads the chunk's operands into registers,
//   walks them with the warp's table (it alone touches it, so no ordering
//   between lanes is needed) and writes each value into a 32-word tile; the
//   warp then stores the tile as one 128-byte line per chunk. A lockstep
//   walk (every lane walks, operands by shuffle, one table written by all
//   lanes at the same address) ran about 12% faster on the H100, but the
//   order of its table writes rests on the warp staying converged: a lane
//   that fell behind would write a step's value over a later one. With a
//   table a lane (race-free) it ran slower than this single walker.
// - The table read is taken two steps early: op k's slot is loaded right
//   after op k-3's write, and the writes of ops k-2 and k-1 are forwarded by
//   comparing slots. The chain a step is then the hash (dp4a, and), a
//   compare and two selects; the shared store and load span three steps,
//   so one shared load an op is no floor for this walk.
// The caller zeroes the output; nothing past a row's total is written.

#include "common.cuh"

namespace {

// ops/sequential.py's CHUNK and RING name these two for the host
constexpr int LANES = 32;   // ops a chunk: one a lane
constexpr int STAGES = 4;   // chunks in the ring: one walked, three in flight
constexpr unsigned INIT = 0xFF000000u;  // (0, 0, 0, 255); mono gray 0, a 255

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a & b & c (0x80), (a & b) ^ c (0x6A), a ^ (b & c) (0x78): one LOP3 each
template <unsigned LUT>
__device__ __forceinline__ unsigned lop3(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "r"(b), "r"(c),
      "n"(LUT));
  return d;
}

// the table entry at byte offset off
__device__ __forceinline__ unsigned& at(unsigned* tab, unsigned off) {
  return *(unsigned*)((char*)tab + off);
}

// the operands of one step: slot byte offset or -1 (x), keep mask (y),
// addend (z), addend & 0x7F7F7F7F (w)
__device__ __forceinline__ uint4 operands(int slot4, unsigned keep,
                                          unsigned add) {
  return make_uint4((unsigned)slot4, keep, add, add & 0x7F7F7F7Fu);
}

__device__ __forceinline__ unsigned bytes3(int d0, int d1, int d2) {
  return ((unsigned)d0 & 255u) | (((unsigned)d1 & 255u) << 8) |
         (((unsigned)d2 & 255u) << 16);
}

// straight-line (every lane of a chunk at once, whatever its tag)
template <bool MONO>
__device__ __forceinline__ uint4 predecode(unsigned w, unsigned a) {
  const unsigned b0 = w & 255u, b1 = (w >> 8) & 255u;
  const bool index = b0 < (MONO ? 128u : 64u);
  const bool rgb = b0 == 0xFEu, rgba = b0 == 0xFFu;
  unsigned delta;  // LUMA (and color DIFF): byte-wise deltas
  if (MONO) {
    delta = ((b0 & 63u) - 32u) & 255u;
  } else {
    const int vg = (int)(b0 & 63u) - 32;
    const bool diff = b0 < 128u;
    delta = bytes3(diff ? (int)((b0 >> 4) & 3u) - 2 : vg - 8 + (int)(b1 >> 4),
                   diff ? (int)((b0 >> 2) & 3u) - 2 : vg,
                   diff ? (int)(b0 & 3u) - 2 : vg - 8 + (int)(b1 & 15u));
  }
  // RGB: the color bytes under an alpha that carries; RGBA: every byte
  const unsigned lit = MONO ? b1 : w >> 8;
  const unsigned lit4 = MONO ? b1 | (((w >> 16) & 255u) << 24)
                             : (w >> 8) | ((a & 255u) << 24);
  unsigned add = b0 < 0xC0u ? delta : 0u;  // RUN: 0, the value carries
  add = rgb ? lit : rgba ? lit4 : index ? 0u : add;
  const unsigned keep = (index || rgba) ? 0u : rgb ? 0xFF000000u : ~0u;
  return operands(index ? (int)(b0 * 4u) : -1, keep, add);
}

template <bool MONO>
__global__ void __launch_bounds__(LANES)
    k9_sequential(const int* __restrict__ lo, const int* __restrict__ hi,
                  const int* __restrict__ totals, int mo,
                  int* __restrict__ out) {
  constexpr int SLOTS = MONO ? 128 : 64;
  constexpr unsigned MASK4 = (SLOTS - 1) * 4u;  // a slot's byte offset
  // the hash times 4 (a byte offset) as one dot product of the value's bytes
  constexpr unsigned WEIGHTS4 = MONO ? 0x2C000014u : 0x2C1C140Cu;
  // +1: a dummy slot, the target of the write pending before the first op
  __shared__ unsigned tab[SLOTS + 1];
  __shared__ unsigned ring_lo[STAGES][LANES];
  __shared__ unsigned ring_hi[MONO ? 1 : STAGES][LANES];
  __shared__ uint4 steps_s[LANES];
  __shared__ unsigned vals[LANES];

  const int lane = threadIdx.x;
  const long long row = blockIdx.x;
  const int total = min(totals[row], mo);
  if (total <= 0) return;
  const int* l = lo + row * mo;
  const int* h = MONO ? nullptr : hi + row * mo;
  int* o = out + row * mo;
  for (int s = lane; s <= SLOTS; s += LANES) tab[s] = 0u;

  auto fetch = [&](int c) {  // chunk c's op words into the ring
    const int j = c * LANES + lane;
    if (j < total) {
      cp_async4(&ring_lo[c % STAGES][lane], l + j);
      if (!MONO) cp_async4(&ring_hi[c % STAGES][lane], h + j);
    }
    cp_async_commit();
  };
  for (int c = 0; c < STAGES - 1; ++c) fetch(c);

  // lane 0's walk state: the value, whose write into slot offset hp is
  // pending, and the value before it (written, slot offset hpp)
  unsigned v = INIT, hp = SLOTS * 4u, vp = INIT, hpp = SLOTS * 4u;
  const int n_chunks = (total + LANES - 1) / LANES;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();  // this lane's words of chunk c are in
    const int j = c * LANES + lane;
    steps_s[lane] =
        j < total ? predecode<MONO>(ring_lo[c % STAGES][lane],
                                    MONO ? 0u : ring_hi[c % STAGES][lane])
                  : operands(-1, ~0u, 0u);  // past the end: a RUN
    fetch(c + STAGES - 1);
    __syncwarp();
    if (lane == 0) {
      // the chunk's operands into registers first: the walk's loads and
      // stores of the table then never wait behind them
      uint4 ops[LANES];
#pragma unroll
      for (int k = 0; k < LANES; ++k) ops[k] = steps_s[k];
      // the table reads of ops 0 and 1, as of every write but the pending
      // one (op -1's)
      unsigned t0 = at(tab, ops[0].x & MASK4);
      unsigned t1 = at(tab, ops[1].x & MASK4);
#pragma unroll
      for (int k = 0; k < LANES; ++k) {
        at(tab, hp) = v;  // op k-1's write
        // op k+2's read, two ops ahead: it misses ops k's and k+1's writes
        const unsigned t2 = k + 2 < LANES ? at(tab, ops[k + 2].x & MASK4) : 0u;
        // (v & M) + X byte-wise: the low 7 bits of each byte summed, the
        // top bits xored in (three dependent ops)
        const unsigned sum =
            lop3<0x78>(lop3<0x80>(v, ops[k].y, 0x7F7F7F7Fu) + ops[k].w,
                       lop3<0x6A>(v, ops[k].y, ops[k].z), 0x80808080u);
        // forward ops k-1's and k-2's writes, the later first
        const unsigned read = ops[k].x == hp    ? v
                              : ops[k].x == hpp ? vp
                                                : t0;
        vp = v;
        hpp = hp;
        v = (int)ops[k].x >= 0 ? read : sum;
        hp = __dp4a(v, WEIGHTS4, 0u) & MASK4;
        vals[k] = v;
        t0 = t1;
        t1 = t2;
      }
    }
    __syncwarp();
    if (j < total) o[j] = (int)vals[lane];
  }
}

// one thread chases a cycle through a 128-entry shared table (each entry the
// byte offset of the next): the latency of one dependent shared-memory load
__global__ void k9_chase(int n, int* end, long long* cycles) {
  __shared__ unsigned nxt[128];
  for (int i = 0; i < 128; ++i) nxt[i] = ((i + 37) % 128) * 4u;
  unsigned off = 0;
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i)
    off = *(const volatile unsigned*)((const char*)nxt + off);
  *cycles = clock64() - t0;
  *end = (int)off;
}

}  // namespace

// lo, out: (B, mo) i32 (out zeroed by the caller); hi: (B, mo) i32, read by
// the color step only (may be null for colch 1); totals (B,) i32; colch 1
// (mono step) or 3 (color step). Returns cudaGetLastError.
extern "C" int k9_sequential_decode(const int* lo, const int* hi,
                                    const int* totals, int B, int mo,
                                    int colch, int* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0) return 0;
  if (colch == 1)
    k9_sequential<true><<<B, LANES, 0, st>>>(lo, hi, totals, mo, out);
  else
    k9_sequential<false><<<B, LANES, 0, st>>>(lo, hi, totals, mo, out);
  return (int)cudaGetLastError();
}

// n dependent shared-memory loads in one thread; end (1,) i32 gets the last
// offset, cycles (1,) i64 the SM clocks they took. Returns cudaGetLastError.
extern "C" int k9_smem_chase(int n, int* end, long long* cycles,
                             void* stream) {
  k9_chase<<<1, 1, 0, (cudaStream_t)stream>>>(n, end, cycles);
  return (int)cudaGetLastError();
}
