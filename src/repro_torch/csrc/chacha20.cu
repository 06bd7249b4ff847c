// ChaCha20 keystream XOR for Hopper (sm_90a), fused onto a packed word wire.
//
// Replaces the TPU kernel src/repro/kernels/chacha20/kernel.py::
// chacha20_xor_row_lanes (pallas_call at line 180; tile body
// _chacha20_lanes_tile_kernel, ARX core _keystream_tile). Only the
// (key, nonce, counter) of every block and the output bits have to match it.
// A work item is (row i, block j) of an (n_rows, row_words) u32 wire and a
// per-block table of four words {ctr_base, ctr_rowmul, packed_start, n_valid}:
//   counter = counter0 + ctr_base[j] + ctr_rowmul[j] * ctr_rows[i]  (mod 2^32)
//   nonce   = params.nonce with word 0 ^= nonce_ids[i]
//   y[i, packed_start[j] + w] = x[i, packed_start[j] + w] ^ keystream[w]
//                               for w < n_valid[j]
// On the coalesced shuffle wire packed_start is the leaf's first word plus
// 16 times the block's index in the leaf, and n_valid cuts a leaf's last
// block, so the keystream lands straight on the packed (unpadded) words and
// the tail words a leaf does not use are never produced. The row-aligned
// entry points pass the table {j, 1, 16j, min(16, row_words - 16j)}. Key,
// nonce and counter0 come by value in the launch's parameters: the call
// copies nothing to the card. An optional device pointer to one u32 round id
// is XORed into nonce word 1 on the card (null: nothing is XORed), so a
// launch captured in a CUDA graph keys each replay's round from device
// memory instead of freezing the round it was captured with. An optional
// row count R moves each row's store: the n_rows rows are an (n_rows/R, R)
// grid, and row s·R + r lands on row r·(n_rows/R) + s of y, the grid
// transposed (R 0: row i stays row i); row i's keystream is unchanged. The
// shuffle's send side stores each ciphertext row where its receiver reads
// it, so the exchange that follows moves nothing.
//
// What bounds it on an H100: per 64-byte block the kernel reads 64 bytes,
// writes 64 bytes and does about 1,000 32-bit integer operations (80
// quarter rounds of 12 add/xor/rotate each, the feed-forward, the XOR and
// the counter). At 128 integer operations per SM and clock that is 7.8
// operations per byte against a ridge of 10 at 3.35 TB/s, so a large wire is
// bound by bytes, with operations close behind. The k-means shuffle wire
// (64 rows x 132 blocks) is bound by latency: one thread per block gives
// 8,448 threads, a quarter of the card, each a serial chain of 20 rounds.
//
// Design: two cores behind one entry, chosen by the wrapper by size.
// LANES = 4, for wires that four lanes per block fit in one wave of the card
// (the k-means wire): lane q holds state column q (words q, 4+q, 8+q, 12+q).
// Column rounds run in-thread; for the diagonal rounds the b, c and d rows
// rotate across the 4-lane group with __shfl_sync and back. The k-means wire
// becomes 33,792 threads, one wave of 132 CTAs of 256, each with a quarter
// of a block's arithmetic. Lane q ends holding keystream words q, 4+q,
// 8+q, 12+q, so for each of its four words the group touches 4 adjacent
// words of the wire: word-granular loads and stores, coalesced in 16-byte
// runs whatever the packed offset. The wire words are loaded before the
// rounds so their latency hides behind the arithmetic.
// LANES = 1, for larger wires, is the first design's core: one thread per
// block, the 16-word state in registers, 16-byte vector loads and stores
// where the table is aligned. The shuffles add a quarter to the instructions of a
// block (448 SASS instructions a thread, 60 of them SHFL: 1,792 a block
// against 1,072 for one thread); once one thread per block fills the card
// that is what binds four lanes. On an H100 SXM (700 W) at 64 MiB the
// one-thread core ran in 46.8-49.1 us, within 7% of a plain elementwise XOR
// of the same bytes (45.9-47.7 us), and four lanes in 70.8-71.1 us; at the
// k-means wire four lanes took 2.31-2.33 us and one thread 3.52-3.57 us
// (chip_smoke.py, two runs). Rotations are funnel shifts; the
// compiler issues the adds as IMAD on the FMA pipe, which leaves the XORs
// and rotations (640 of the ~1,000 operations a block) to the integer pipe.
// Rounds are fully unrolled. The kernel allocates nothing and runs on the
// caller's stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct ChachaParams {
  uint32_t key[8];
  uint32_t nonce[3];
  uint32_t counter0;
};

constexpr uint32_t kC0 = 0x61707865u, kC1 = 0x3320646Eu, kC2 = 0x79622D32u,
                   kC3 = 0x6B206574u;

__device__ __forceinline__ uint32_t rotl(uint32_t v, int n) {
  return __funnelshift_l(v, v, n);
}

#define QR(a, b, c, d)                 \
  a += b; d = rotl(d ^ a, 16);         \
  c += d; b = rotl(b ^ c, 12);         \
  a += b; d = rotl(d ^ a, 8);          \
  c += d; b = rotl(b ^ c, 7);

// Select one of four values by a runtime index without indexing the
// parameter space (which would move the parameters to local memory).
__device__ __forceinline__ uint32_t pick4(int q, uint32_t v0, uint32_t v1, uint32_t v2,
                                          uint32_t v3) {
  return q == 0 ? v0 : q == 1 ? v1 : q == 2 ? v2 : v3;
}

// Row i's place in y: with PLACED, row s·R + r of the (S, R) grid of rows
// goes to row r·S + s (the grid transposed); else row i.
template <bool PLACED>
__device__ __forceinline__ unsigned place_of(unsigned i, unsigned R, unsigned S) {
  if (!PLACED) return i;
  const unsigned sh = i / R;
  return (i - sh * R) * S + sh;
}

// Four lanes per block: lane q of a group holds state column q. PLACED: rows
// are stored transposed (`place_of`). Placed and unplaced cores are separate
// instantiations: one kernel with a runtime test ran its unplaced calls 6%
// slower at the k-means wire and 1.6% at the MoE leg (H100 SXM, 700 W).
template <bool PLACED>
__global__ void __launch_bounds__(256)
chacha20_xor_packed_lanes4(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                           const int4* __restrict__ table,
                           const uint32_t* __restrict__ nonce_ids,
                           const uint32_t* __restrict__ ctr_rows,
                           const uint32_t* __restrict__ round_id, ChachaParams p,
                           unsigned n_rows, unsigned n_blocks, size_t row_words,
                           unsigned place_r, unsigned place_s) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  const int q = threadIdx.x & 3;
  const unsigned total = n_rows * n_blocks;
  const unsigned item = t >> 2;
  // Groups past the end still run the rounds (with the last item's inputs):
  // every lane of a warp takes part in the shuffles. They load and store
  // nothing.
  const bool live = item < total;
  const unsigned it = live ? item : total - 1;
  const unsigned i = it / n_blocks;
  const unsigned j = it - i * n_blocks;

  const int4 e = __ldg(table + j);  // base, rowmul, packed_start, n_valid
  const uint32_t* xr = x + (size_t)i * row_words + (unsigned)e.z;
  uint32_t* yr = y + (size_t)place_of<PLACED>(i, place_r, place_s) * row_words + (unsigned)e.z;
  uint32_t m[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int w = 4 * r + q;
    m[r] = (live && w < e.w) ? __ldg(xr + w) : 0u;
  }

  const uint32_t ctr = p.counter0 + (uint32_t)e.x + (uint32_t)e.y * __ldg(ctr_rows + i);
  const uint32_t a0 = pick4(q, kC0, kC1, kC2, kC3);
  const uint32_t b0 = pick4(q, p.key[0], p.key[1], p.key[2], p.key[3]);
  const uint32_t c0 = pick4(q, p.key[4], p.key[5], p.key[6], p.key[7]);
  const uint32_t nonce1 = p.nonce[1] ^ (round_id ? __ldg(round_id) : 0u);
  const uint32_t d0 = pick4(q, ctr, p.nonce[0] ^ __ldg(nonce_ids + i), nonce1, p.nonce[2]);
  uint32_t a = a0, b = b0, c = c0, d = d0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    QR(a, b, c, d);  // column round
    b = __shfl_sync(0xffffffffu, b, q + 1, 4);
    c = __shfl_sync(0xffffffffu, c, q + 2, 4);
    d = __shfl_sync(0xffffffffu, d, q + 3, 4);
    QR(a, b, c, d);  // diagonal round
    b = __shfl_sync(0xffffffffu, b, q + 3, 4);
    c = __shfl_sync(0xffffffffu, c, q + 2, 4);
    d = __shfl_sync(0xffffffffu, d, q + 1, 4);
  }
  const uint32_t ks[4] = {a + a0, b + b0, c + c0, d + d0};
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int w = 4 * r + q;
    if (w < e.w) yr[w] = m[r] ^ ks[r];
  }
}

// One thread per block (the first design's core, on the packed wire). VEC:
// every block is whole (n_valid 16) at a 16-byte aligned word, so its 64
// bytes move as four 16-byte vectors; otherwise word by word up to n_valid.
// PLACED as in the four-lane core.
template <bool VEC, bool PLACED>
__global__ void __launch_bounds__(256)
chacha20_xor_packed_lanes1(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                           const int4* __restrict__ table,
                           const uint32_t* __restrict__ nonce_ids,
                           const uint32_t* __restrict__ ctr_rows,
                           const uint32_t* __restrict__ round_id, ChachaParams p,
                           unsigned n_rows, unsigned n_blocks, size_t row_words,
                           unsigned place_r, unsigned place_s) {
  const unsigned item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= n_rows * n_blocks) return;
  const unsigned i = item / n_blocks;
  const unsigned j = item - i * n_blocks;
  const int4 e = __ldg(table + j);
  const uint32_t* xr = x + (size_t)i * row_words + (unsigned)e.z;

  uint32_t m[16];
  if (VEC) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(xr) + r);
      m[4 * r] = v.x; m[4 * r + 1] = v.y; m[4 * r + 2] = v.z; m[4 * r + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int w = 0; w < 16; ++w) m[w] = w < e.w ? __ldg(xr + w) : 0u;
  }

  uint32_t s[16] = {kC0, kC1, kC2, kC3,
                    p.key[0], p.key[1], p.key[2], p.key[3],
                    p.key[4], p.key[5], p.key[6], p.key[7],
                    p.counter0 + (uint32_t)e.x + (uint32_t)e.y * __ldg(ctr_rows + i),
                    p.nonce[0] ^ __ldg(nonce_ids + i),
                    p.nonce[1] ^ (round_id ? __ldg(round_id) : 0u), p.nonce[2]};
  uint32_t v[16];
#pragma unroll
  for (int w = 0; w < 16; ++w) v[w] = s[w];
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    QR(v[0], v[4], v[8], v[12]);
    QR(v[1], v[5], v[9], v[13]);
    QR(v[2], v[6], v[10], v[14]);
    QR(v[3], v[7], v[11], v[15]);
    QR(v[0], v[5], v[10], v[15]);
    QR(v[1], v[6], v[11], v[12]);
    QR(v[2], v[7], v[8], v[13]);
    QR(v[3], v[4], v[9], v[14]);
  }
#pragma unroll
  for (int w = 0; w < 16; ++w) m[w] ^= v[w] + s[w];
  uint32_t* yr = y + (size_t)place_of<PLACED>(i, place_r, place_s) * row_words + (unsigned)e.z;
  if (VEC) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      reinterpret_cast<uint4*>(yr)[r] =
          make_uint4(m[4 * r], m[4 * r + 1], m[4 * r + 2], m[4 * r + 3]);
  } else {
#pragma unroll
    for (int w = 0; w < 16; ++w)
      if (w < e.w) yr[w] = m[w];
  }
}

}  // namespace

// x, y: distinct (n_rows, row_words) u32 buffers; table: (n_blocks, 4) i32
// {ctr_base, ctr_rowmul, packed_start, n_valid}, whose blocks cover every
// word of a row exactly once; nonce_ids, ctr_rows: (n_rows,) u32 on the card;
// round_id: null, or one u32 on the card that both cores XOR into nonce word 1;
// place_rows: 0, or R > 0 dividing n_rows: row s·R + r's output goes to row
// r·(n_rows/R) + s of y.
// params: 12 host words {key[8], nonce[3], counter0}, passed to the kernel by
// value. lanes: 4 or 1. aligned: every block has n_valid 16 and a packed_start
// that is a multiple of 4 (the one-thread core then moves 16-byte vectors).
// n_rows * n_blocks * 4 must be below 2^31.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int chacha20_xor_packed(const void* x, void* y, const void* table,
                                   const void* nonce_ids, const void* ctr_rows,
                                   const void* round_id, const uint32_t* params,
                                   long long n_rows, long long n_blocks, long long row_words,
                                   long long place_rows, int lanes, int aligned, void* stream) {
  const long long total = n_rows * n_blocks;
  if (total == 0) return 0;
  ChachaParams p;
  for (int w = 0; w < 8; ++w) p.key[w] = params[w];
  for (int w = 0; w < 3; ++w) p.nonce[w] = params[8 + w];
  p.counter0 = params[11];
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  const bool placed = place_rows > 0;
  const unsigned place_r = placed ? (unsigned)place_rows : 1u;
  const unsigned place_s = (unsigned)(n_rows / place_r);
  if (lanes == 4) {
    const unsigned grid = (unsigned)((total * 4 + threads - 1) / threads);
    auto kernel = placed ? chacha20_xor_packed_lanes4<true> : chacha20_xor_packed_lanes4<false>;
    kernel<<<grid, threads, 0, s>>>(
        (const uint32_t*)x, (uint32_t*)y, (const int4*)table, (const uint32_t*)nonce_ids,
        (const uint32_t*)ctr_rows, (const uint32_t*)round_id, p, (unsigned)n_rows,
        (unsigned)n_blocks, (size_t)row_words, place_r, place_s);
  } else {
    const bool vec = aligned && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0 &&
                     row_words % 4 == 0;
    const unsigned grid = (unsigned)((total + threads - 1) / threads);
    auto kernel = vec ? (placed ? chacha20_xor_packed_lanes1<true, true>
                                : chacha20_xor_packed_lanes1<true, false>)
                      : (placed ? chacha20_xor_packed_lanes1<false, true>
                                : chacha20_xor_packed_lanes1<false, false>);
    kernel<<<grid, threads, 0, s>>>(
        (const uint32_t*)x, (uint32_t*)y, (const int4*)table, (const uint32_t*)nonce_ids,
        (const uint32_t*)ctr_rows, (const uint32_t*)round_id, p, (unsigned)n_rows,
        (unsigned)n_blocks, (size_t)row_words, place_r, place_s);
  }
  return (int)cudaGetLastError();
}
