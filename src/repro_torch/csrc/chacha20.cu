// ChaCha20 keystream XOR for Hopper (sm_90a): y = x ^ keystream.
//
// Replaces the TPU kernel src/repro/kernels/chacha20/kernel.py::
// chacha20_xor_row_lanes (pallas_call at line 180; tile body
// _chacha20_lanes_tile_kernel, ARX core _keystream_tile). Only the
// (key, nonce, counter) of every block and the output bits have to match it:
//   row i, block j:  nonce   = state0[13..15] with word 13 ^= nonce_ids[i]
//                    counter = ctr_base[j] + ctr_rowmul[j] * ctr_rows[i]
//                              (mod 2^32; state0[12] is ignored)
// The wire is taken in the (rows, blocks, 16) word order of the JAX
// wrappers, so no transpose is needed around the launch.
//
// What bounds it on an H100: per 64-byte block the kernel reads 64 bytes,
// writes 64 bytes and does about 1,000 32-bit integer operations (80
// quarter rounds of 12 add/xor/rotate each, the feed-forward, the XOR and
// the counter). At 128 integer operations per SM and clock (the INT32 pipe
// plus integer multiply-adds on the FMA pipe: 33 Tops/s) that is 7.8
// operations per byte against a ridge of 10 at 3.35 TB/s, so a large wire is
// bound by bytes, with operations close behind; the k-means wire (8,448
// blocks) is bound by the launch itself.
//
// Design: one thread per (row, block) with the 16-word state in registers;
// rotations are single funnel shifts; the 20 rounds are fully unrolled. The
// 16 words a thread XORs are 64 contiguous bytes, loaded and stored as four
// 16-byte vectors, so a warp touches 2 KiB of contiguous memory. The kernel
// allocates nothing and runs on the caller's stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t v, int n) {
  return __funnelshift_l(v, v, n);
}

#define QR(a, b, c, d)                 \
  a += b; d = rotl(d ^ a, 16);         \
  c += d; b = rotl(b ^ c, 12);         \
  a += b; d = rotl(d ^ a, 8);          \
  c += d; b = rotl(b ^ c, 7);

__global__ void __launch_bounds__(256)
chacha20_xor_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
                    const uint32_t* __restrict__ state0,
                    const uint32_t* __restrict__ nonce_ids,
                    const uint32_t* __restrict__ ctr_rows,
                    const uint32_t* __restrict__ ctr_base,
                    const uint32_t* __restrict__ ctr_rowmul,
                    long long n_rows, long long n_blocks) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_rows * n_blocks) return;
  long long i = idx / n_blocks;
  long long j = idx - i * n_blocks;

  uint32_t s[16];
#pragma unroll
  for (int w = 0; w < 16; ++w) s[w] = __ldg(state0 + w);
  s[12] = __ldg(ctr_base + j) + __ldg(ctr_rowmul + j) * __ldg(ctr_rows + i);
  s[13] ^= __ldg(nonce_ids + i);

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

  const uint4* in = reinterpret_cast<const uint4*>(x + idx * 16);
  uint4* out = reinterpret_cast<uint4*>(y + idx * 16);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint4 m = in[q];
    m.x ^= v[4 * q + 0] + s[4 * q + 0];
    m.y ^= v[4 * q + 1] + s[4 * q + 1];
    m.z ^= v[4 * q + 2] + s[4 * q + 2];
    m.w ^= v[4 * q + 3] + s[4 * q + 3];
    out[q] = m;
  }
}

}  // namespace

// x, y: distinct (n_rows, n_blocks, 16) u32 buffers, 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int chacha20_xor_rows(const void* x, void* y, const void* state0,
                                 const void* nonce_ids, const void* ctr_rows,
                                 const void* ctr_base, const void* ctr_rowmul,
                                 long long n_rows, long long n_blocks,
                                 void* stream) {
  long long total = n_rows * n_blocks;
  if (total == 0) return 0;
  const int threads = 256;
  long long grid = (total + threads - 1) / threads;
  chacha20_xor_kernel<<<(unsigned)grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)state0,
      (const uint32_t*)nonce_ids, (const uint32_t*)ctr_rows,
      (const uint32_t*)ctr_base, (const uint32_t*)ctr_rowmul, n_rows, n_blocks);
  return (int)cudaGetLastError();
}
