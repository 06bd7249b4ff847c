// The MoE prefill's two row movers on Hopper (sm_90a): dispatch and combine.
//
// Replace no TPU kernel: the JAX package's MoE (src/repro/models/moe.py) is
// plain jnp code that XLA fuses, and no function of it reaches
// pl.pallas_call. They replace the port's plain path through the routing's
// slot map in a prefill (repro_torch/models/moe.py::_moe_shuffle_body with
// no gradient), which at granite-moe's per-layer shape (R 8 shards, n 4,096
// tokens a shard, k 8, E_pad 40 experts of capacity C 1,028, d 1,536, bf16)
// copied each token row k times (805 MB), gathered that by the sort order
// (805 MB), filled a spare-slot buffer with zeros (1.01 GB), scattered into
// it, and on the way back copied the received buffer to add a zero row,
// gathered 805 MB by slot, multiplied and added k strided slices: PyTorch's
// advanced indexing moving one 2-byte element at a time.
//
// moe_dispatch_kernel: the (R, S, d) send buffer, S = E_pad * C slots a
// shard, dest-shard-major as the exchange takes it. slots (R, S) int32 holds
// the entry (token * k + j) that each slot carries, or -1 for an empty slot:
//   out[r, s] = x[r, slots[r, s] / k]     (zeros where slots[r, s] is not in [0, n k))
// Bound by bytes: the buffer written once (1.01 GB at granite's shape) and
// each shard's n token rows read once (12.6 MB, 101 MB in all): 0.33 ms at
// 3.35 TB/s. Design: a warp a slot row, each lane moving 16-byte units (a
// bf16 row of 1,536 is 192 of them), all of a lane's loads issued before its
// stores; the stores stream past L2 (st.global.cs), since nothing on the
// card reads the buffer before the exchange's next pass. Empty slots are
// written as zeros with no read. Blocks take the rows in order, and the
// hardware hands blocks out in order, so the warps in flight share one
// shard, whose token rows (read k times over) stay in the 50 MB L2.
//
// moe_combine_kernel: for each token (r, i), with the received (R, S, d)
// buffer `got`, pos (R, n k) int32 the slot of each entry (S or more where it
// was dropped) and gates (R, n, k):
//   y = +0;  for j in 0..k-1:  c = round(v_j * g_j);  y = round(y + c)
// v_j = got[r, pos[r, i k + j]] or zeros for a dropped entry, each step
// rounded to the working dtype as PyTorch's elementwise mul and add round it
// (bf16: the product and the sum in float32, rounded to nearest even; float32:
// __fmul_rn and __fadd_rn, so no fused multiply-add changes a bit). So the
// result equals the plain path's gather, multiply and k adds bit for bit,
// and does not depend on the card's scheduling (no atomics). y is written
// once, at out + r o_r + (i / tps) o_b + (i % tps) o_t: the (R, n, d) layout
// or straight into (B, T, d) order. Bound by bytes: the kept entries' rows
// read once (686 MB at granite's 14.8% drop share) and y written once
// (101 MB): 0.24 ms at 3.35 TB/s. Design: a warp a token, its k slots and
// gates read once by k lanes into shared memory; each lane takes 16-byte
// units of the row in turn and, for each, issues the loads of up to KBATCH
// entries' units before it adds them in order, so a lane has 8 loads in
// flight with few registers and many warps fit an SM. Dropped entries are
// never read; the received rows are read once, past L1 (ld.global.cs).
//
// A unit is the widest of 16, 8, 4 and 2 bytes that divides the row's bytes,
// every row stride and every pointer (the wrapper picks it): a row whose
// bytes are not a multiple of 16 moves in narrower units (a d that is odd in
// bf16, down to one element). bf16 and float32 only. Both kernels allocate
// nothing, run on the caller's stream and never synchronise.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // warps (rows or tokens) a block
constexpr int THREADS = 32 * WARPS;
constexpr int DISPATCH_BATCH = 8;  // units a lane loads before it stores
constexpr int KBATCH = 8;          // a token's entries whose loads a lane issues at once

// --- dispatch ------------------------------------------------------------------

template <typename U>
__global__ void __launch_bounds__(THREADS)
moe_dispatch_kernel(const char* __restrict__ x, const int* __restrict__ slots,
                    char* __restrict__ out, long long n_rows, int S, int n_entries, int k,
                    long long x_r, long long x_n, int units) {
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const long long r = row / S;
  const int e = __ldg(slots + row);
  U* dst = reinterpret_cast<U*>(out + row * (long long)units * sizeof(U));
  if (e < 0 || e >= n_entries) {
    const U zero{};
    for (int u = lane; u < units; u += 32) __stcs(dst + u, zero);
    return;
  }
  const U* src = reinterpret_cast<const U*>(x + r * x_r + (long long)(e / k) * x_n);
  for (int base = lane; base < units; base += 32 * DISPATCH_BATCH) {
    U v[DISPATCH_BATCH];
#pragma unroll
    for (int q = 0; q < DISPATCH_BATCH; ++q) {
      const int u = base + 32 * q;
      if (u < units) v[q] = __ldg(src + u);
    }
#pragma unroll
    for (int q = 0; q < DISPATCH_BATCH; ++q) {
      const int u = base + 32 * q;
      if (u < units) __stcs(dst + u, v[q]);
    }
  }
}

// --- combine -------------------------------------------------------------------

// E: the element's storage, unsigned short (bf16 bits) or float
__device__ __forceinline__ float to_f32(unsigned short b) { return __uint_as_float((unsigned)b << 16); }
__device__ __forceinline__ float to_f32(float f) { return f; }

__device__ __forceinline__ void from_f32(float f, unsigned short& b) {
  b = __bfloat16_as_ushort(__float2bfloat16_rn(f));
}
__device__ __forceinline__ void from_f32(float f, float& out) { out = f; }

// one step of the sum in the working dtype: y = round(y + round(v * g))
__device__ __forceinline__ float step(float y, float v, float g, unsigned short) {
  const float c = __bfloat162float(__float2bfloat16_rn(__fmul_rn(v, g)));
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(y, c)));
}
__device__ __forceinline__ float step(float y, float v, float g, float) {
  return __fadd_rn(y, __fmul_rn(v, g));
}

template <typename U, typename E>
union Unit {
  U u;
  E e[sizeof(U) / sizeof(E)];
};

template <typename U, typename E>
__global__ void __launch_bounds__(THREADS)
moe_combine_kernel(const char* __restrict__ got, const int* __restrict__ pos,
                   const E* __restrict__ gates, char* __restrict__ out, long long n_tokens,
                   int n, int k, int S, long long got_r, long long got_s, int units, int tps,
                   long long o_r, long long o_b, long long o_t) {
  constexpr int N = sizeof(U) / sizeof(E);
  __shared__ int slot_of[WARPS][32];
  __shared__ float gate_of[WARPS][32];
  const int warp = threadIdx.x / 32;
  const long long tok = (long long)blockIdx.x * WARPS + warp;
  if (tok >= n_tokens) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;
  const long long r = tok / n;
  const int i = (int)(tok % n);
  if (lane < k) {
    slot_of[warp][lane] = __ldg(pos + tok * k + lane);
    gate_of[warp][lane] = to_f32(gates[tok * k + lane]);
  }
  __syncwarp();
  const char* base = got + r * got_r;
  U* dst = reinterpret_cast<U*>(out + r * o_r + (long long)(i / tps) * o_b +
                                (long long)(i % tps) * o_t);

  for (int u = lane; u < units; u += 32) {
    float acc[N];
#pragma unroll
    for (int q = 0; q < N; ++q) acc[q] = 0.f;  // +0, as the plain path's zeros
    for (int j0 = 0; j0 < k; j0 += KBATCH) {
      Unit<U, E> v[KBATCH];
#pragma unroll
      for (int b = 0; b < KBATCH; ++b) {  // the batch's loads first, then its sums
        const int j = j0 + b;
        const int p = j < k ? slot_of[warp][j] : -1;
        if (p >= 0 && p < S) {
          v[b].u = __ldcs(reinterpret_cast<const U*>(base + (long long)p * got_s) + u);
        } else {
          v[b].u = U{};
        }
      }
#pragma unroll
      for (int b = 0; b < KBATCH; ++b) {
        if (j0 + b < k) {
          const float g = gate_of[warp][j0 + b];
#pragma unroll
          for (int q = 0; q < N; ++q) acc[q] = step(acc[q], to_f32(v[b].e[q]), g, E{});
        }
      }
    }
    Unit<U, E> w;
#pragma unroll
    for (int q = 0; q < N; ++q) from_f32(acc[q], w.e[q]);
    dst[u] = w.u;
  }
}

unsigned blocks_for(long long warps) { return (unsigned)((warps + WARPS - 1) / WARPS); }

template <typename U>
void launch_dispatch(const void* x, const int* slots, void* out, long long n_rows, int S,
                     int n_entries, int k, long long x_r, long long x_n, long long row_bytes,
                     cudaStream_t stream) {
  moe_dispatch_kernel<U><<<blocks_for(n_rows), THREADS, 0, stream>>>(
      static_cast<const char*>(x), slots, static_cast<char*>(out), n_rows, S, n_entries, k,
      x_r, x_n, (int)(row_bytes / sizeof(U)));
}

template <typename U, typename E>
void launch_combine(const void* got, const int* pos, const void* gates, void* out,
                    long long n_tokens, int n, int k, int S, long long got_r, long long got_s,
                    long long row_bytes, int tps, long long o_r, long long o_b, long long o_t,
                    cudaStream_t stream) {
  moe_combine_kernel<U, E><<<blocks_for(n_tokens), THREADS, 0, stream>>>(
      static_cast<const char*>(got), pos, static_cast<const E*>(gates),
      static_cast<char*>(out), n_tokens, n, k, S, got_r, got_s, (int)(row_bytes / sizeof(U)),
      tps, o_r, o_b, o_t);
}

}  // namespace

// x (R, n, d) with byte strides x_r, x_n and d contiguous; slots (R, S) and
// out (R, S, d) contiguous; row_bytes = d * itemsize; unit in {16, 8, 4, 2}
// divides row_bytes, x_r, x_n and both pointers (the wrapper checks).
// Returns cudaGetLastError() after the launch.
extern "C" int moe_dispatch(const void* x, const int* slots, void* out, int R, int S, int n,
                            int k, long long x_r, long long x_n, long long row_bytes, int unit,
                            void* stream) {
  if (R <= 0 || S <= 0 || row_bytes <= 0) return 0;
  const long long n_rows = (long long)R * S;
  const int n_entries = n * k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: launch_dispatch<uint4>(x, slots, out, n_rows, S, n_entries, k, x_r, x_n, row_bytes, s); break;
    case 8: launch_dispatch<uint2>(x, slots, out, n_rows, S, n_entries, k, x_r, x_n, row_bytes, s); break;
    case 4: launch_dispatch<unsigned>(x, slots, out, n_rows, S, n_entries, k, x_r, x_n, row_bytes, s); break;
    case 2: launch_dispatch<unsigned short>(x, slots, out, n_rows, S, n_entries, k, x_r, x_n, row_bytes, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// got (R, S, d) with byte strides got_r, got_s and d contiguous; pos (R, n k)
// and gates (R, n, k) contiguous, gates in the working dtype (bf16, or
// float32 when `fp32`); out rows at r o_r + (i / tps) o_b + (i % tps) o_t
// bytes; unit divides row_bytes, the strides and the pointers; k <= 32.
// Returns cudaGetLastError() after the launch.
extern "C" int moe_combine(const void* got, const int* pos, const void* gates, void* out,
                           int R, int n, int k, int S, long long got_r, long long got_s,
                           long long row_bytes, int tps, long long o_r, long long o_b,
                           long long o_t, int fp32, int unit, void* stream) {
  if (R <= 0 || n <= 0 || row_bytes <= 0) return 0;
  if (k <= 0 || k > 32 || tps <= 0) return (int)cudaErrorInvalidValue;
  const long long n_tokens = (long long)R * n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MOE_COMBINE(U, E)                                                                   \
  launch_combine<U, E>(got, pos, gates, out, n_tokens, n, k, S, got_r, got_s, row_bytes, tps, \
                       o_r, o_b, o_t, s)
  if (fp32) {
    switch (unit) {
      case 16: MOE_COMBINE(uint4, float); break;
      case 8: MOE_COMBINE(uint2, float); break;
      case 4: MOE_COMBINE(unsigned, float); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (unit) {
      case 16: MOE_COMBINE(uint4, unsigned short); break;
      case 8: MOE_COMBINE(uint2, unsigned short); break;
      case 4: MOE_COMBINE(unsigned, unsigned short); break;
      case 2: MOE_COMBINE(unsigned short, unsigned short); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef MOE_COMBINE
  return (int)cudaGetLastError();
}
