// Fused k-means assign + per-centre accumulate for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/kmeans/kernel.py::
// kmeans_assign_tiles (pallas_call at line 84; tile body _kmeans_tile_kernel).
// Per point x with weight w, against centres c (K, D):
//   d2[k]     = (|x|^2 + |c_k|^2) - 2 * (x . c_k)      full FP32, no TF32
//   assign    = argmin_k d2[k]                          first index on ties
//   sums[a]  += w * x ;  counts[a] += w
// for S shards at once: points (S, n, D), weights (S, n), one shared centre
// table (K, D); outputs assign (S, n) int32, sums (S, K, D), counts (S, K).
//
// What bounds it on an H100: 2*N*K*D FP32 operations for the distances
// against N*D*4 bytes of points read once. At D=64, K=256 that is 32
// operations per byte, far above the FP32 ridge (67 TFLOP/s over 3.35 TB/s
// = 20 per byte), so it is bound by operations.
//
// Design. The Pallas kernel accumulates sums and counts across a sequential
// grid. Hopper CTAs run in parallel and in no order, and float atomics would
// give different bits from run to run, so:
//  * stage 1: CTA (g, s) walks a fixed contiguous range of shard s's points
//    in tiles of THREADS points, one point per thread. The centre table
//    (padded to float4) and |c|^2 sit in shared memory; each thread keeps its
//    point in registers and runs four independent dot products at a time
//    over broadcast float4 reads of four centres. Each tile's assignments go
//    to shared memory, and the per-CTA partial sums/counts (in shared memory)
//    are updated in point order, every (centre, column) entry by exactly one
//    thread, so the partials are deterministic.
//  * stage 2: one thread per output entry adds the G partials of its shard
//    in the order g = 0..G-1.
// The distance expression is evaluated with explicit round-to-nearest adds
// and multiplies so that nvcc cannot contract it into a different FMA order.
// Both kernels run on the caller's stream and allocate nothing: the wrapper
// passes the partial buffers.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 512;  // threads per CTA == points per tile
constexpr int DMAX = 64;
constexpr int D4MAX = DMAX / 4;

__global__ void __launch_bounds__(THREADS)
kmeans_partial_kernel(const float* __restrict__ points,
                      const float* __restrict__ centers,
                      const float* __restrict__ weights,
                      int* __restrict__ assign,
                      float* __restrict__ part_sums,
                      float* __restrict__ part_counts,
                      long long n, int d, int k, int tiles_per_cta) {
  extern __shared__ float4 smem4[];
  const int d4 = (d + 3) / 4;
  float4* cs = smem4;                                  // (k, d4)
  float* c2 = reinterpret_cast<float*>(cs + k * d4);  // (k,)
  float* acc = c2 + k;                                 // (k, d)
  float* acc_c = acc + k * d;                          // (k,)
  int* t_assign = reinterpret_cast<int*>(acc_c + k);   // (THREADS,)
  int* t_group = t_assign + THREADS;                   // (THREADS,)
  float* t_w = reinterpret_cast<float*>(t_group + THREADS);  // (THREADS,)

  const int tid = threadIdx.x;
  const int s = blockIdx.y;
  const int g = blockIdx.x;
  const int n_ctas = gridDim.x;
  const float* X = points + (long long)s * n * d;
  const float* W = weights + (long long)s * n;
  int* A = assign + (long long)s * n;

  float* cs_f = reinterpret_cast<float*>(cs);
  for (int i = tid; i < k * d4 * 4; i += THREADS) {
    int kk = i / (d4 * 4), dd = i - kk * d4 * 4;
    cs_f[i] = dd < d ? centers[kk * d + dd] : 0.f;
  }
  for (int kk = tid; kk < k; kk += THREADS) {
    float v2 = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      float v = centers[kk * d + dd];
      v2 = __fadd_rn(v2, __fmul_rn(v, v));
    }
    c2[kk] = v2;
    acc_c[kk] = 0.f;
  }
  for (int i = tid; i < k * d; i += THREADS) acc[i] = 0.f;
  __syncthreads();

  // accumulation ownership: thread (kg, col) owns entries (a, col) with
  // a % n_groups == kg; the count of centre a belongs to thread (a % n_groups, 0)
  const int n_groups = THREADS / d;
  const int col = tid % d;
  const int kg = tid / d;

  const long long p0 = (long long)g * tiles_per_cta * THREADS;
  for (int t = 0; t < tiles_per_cta; ++t) {
    const long long base = p0 + (long long)t * THREADS;
    if (base >= n) break;  // uniform across the CTA
    const long long p = base + tid;
    int best = -1;
    float w = 0.f;
    if (p < n) {
      float4 xr[D4MAX];
      float x2 = 0.f;
#pragma unroll
      for (int j = 0; j < D4MAX; ++j) {
        if (j < d4) {
          float v[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            int dd = 4 * j + c;
            v[c] = dd < d ? X[p * d + dd] : 0.f;
            if (dd < d) x2 = __fadd_rn(x2, __fmul_rn(v[c], v[c]));
          }
          xr[j] = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
      float bestd = CUDART_INF_F;
      best = 0;
      for (int kk = 0; kk < k; kk += 4) {
        const int k1 = min(kk + 1, k - 1), k2 = min(kk + 2, k - 1), k3 = min(kk + 3, k - 1);
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int j = 0; j < D4MAX; ++j) {
          if (j < d4) {
            const float4 x = xr[j];
            const float4 q0 = cs[kk * d4 + j], q1 = cs[k1 * d4 + j];
            const float4 q2 = cs[k2 * d4 + j], q3 = cs[k3 * d4 + j];
            a0 = fmaf(x.x, q0.x, a0); a0 = fmaf(x.y, q0.y, a0);
            a0 = fmaf(x.z, q0.z, a0); a0 = fmaf(x.w, q0.w, a0);
            a1 = fmaf(x.x, q1.x, a1); a1 = fmaf(x.y, q1.y, a1);
            a1 = fmaf(x.z, q1.z, a1); a1 = fmaf(x.w, q1.w, a1);
            a2 = fmaf(x.x, q2.x, a2); a2 = fmaf(x.y, q2.y, a2);
            a2 = fmaf(x.z, q2.z, a2); a2 = fmaf(x.w, q2.w, a2);
            a3 = fmaf(x.x, q3.x, a3); a3 = fmaf(x.y, q3.y, a3);
            a3 = fmaf(x.z, q3.z, a3); a3 = fmaf(x.w, q3.w, a3);
          }
        }
        const float dots[4] = {a0, a1, a2, a3};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (kk + q < k) {
            float d2 = __fsub_rn(__fadd_rn(x2, c2[kk + q]), __fmul_rn(2.0f, dots[q]));
            if (d2 < bestd) {
              bestd = d2;
              best = kk + q;
            }
          }
        }
      }
      A[p] = best;
      w = W[p];
    }
    t_assign[tid] = best;
    t_group[tid] = best >= 0 ? best % n_groups : -1;
    t_w[tid] = w;
    __syncthreads();

    if (kg < n_groups) {
      const int n_tile = (int)min((long long)THREADS, n - base);
      for (int i = 0; i < n_tile; ++i) {
        if (t_group[i] == kg) {
          const int a = t_assign[i];
          const float wi = t_w[i];
          acc[a * d + col] = __fadd_rn(acc[a * d + col],
                                       __fmul_rn(wi, X[(base + i) * d + col]));
          if (col == 0) acc_c[a] = __fadd_rn(acc_c[a], wi);
        }
      }
    }
    __syncthreads();
  }

  float* ps = part_sums + ((long long)s * n_ctas + g) * k * d;
  float* pc = part_counts + ((long long)s * n_ctas + g) * k;
  for (int i = tid; i < k * d; i += THREADS) ps[i] = acc[i];
  for (int i = tid; i < k; i += THREADS) pc[i] = acc_c[i];
}

__global__ void kmeans_reduce_kernel(const float* __restrict__ part_sums,
                                     const float* __restrict__ part_counts,
                                     float* __restrict__ sums,
                                     float* __restrict__ counts,
                                     int n_shards, int n_ctas, int k, int d) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long kd = (long long)k * d;
  const long long n_sum = n_shards * kd;
  if (i < n_sum) {
    const long long s = i / kd, e = i - s * kd;
    float total = 0.f;
    for (int g = 0; g < n_ctas; ++g)
      total = __fadd_rn(total, part_sums[(s * n_ctas + g) * kd + e]);
    sums[i] = total;
  } else if (i < n_sum + (long long)n_shards * k) {
    const long long j = i - n_sum;
    const long long s = j / k, e = j - s * k;
    float total = 0.f;
    for (int g = 0; g < n_ctas; ++g)
      total = __fadd_rn(total, part_counts[(s * n_ctas + g) * k + e]);
    counts[j] = total;
  }
}

}  // namespace

extern "C" int kmeans_threads() { return THREADS; }

extern "C" long long kmeans_smem_bytes(int k, int d) {
  const int d4 = (d + 3) / 4;
  return (long long)k * d4 * 16 + (long long)k * 4 + (long long)k * d * 4 +
         (long long)k * 4 + 3LL * THREADS * 4;
}

// points (S, n, d) f32, centers (k, d) f32, weights (S, n) f32 ->
// assign (S, n) i32, sums (S, k, d) f32, counts (S, k) f32.
// part_sums (S, n_ctas, k, d) and part_counts (S, n_ctas, k) are scratch.
// Needs 1 <= d <= 64 and kmeans_smem_bytes(k, d) <= 232448.
// Returns cudaGetLastError() after both launches (0 on success).
extern "C" int kmeans_assign_accumulate(const void* points, const void* centers,
                                        const void* weights, void* assign,
                                        void* part_sums, void* part_counts,
                                        void* sums, void* counts,
                                        int n_shards, long long n, int d, int k,
                                        int n_ctas, int tiles_per_cta,
                                        void* stream) {
  if (d < 1 || d > DMAX || k < 1 || n_shards < 1 || n_ctas < 1) return (int)cudaErrorInvalidValue;
  const long long smem = kmeans_smem_bytes(k, d);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaFuncSetAttribute(kmeans_partial_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid1(n_ctas, n_shards);
  kmeans_partial_kernel<<<grid1, THREADS, smem, st>>>(
      (const float*)points, (const float*)centers, (const float*)weights,
      (int*)assign, (float*)part_sums, (float*)part_counts, n, d, k, tiles_per_cta);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)n_shards * k * (d + 1);
  const int threads = 256;
  kmeans_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      (const float*)part_sums, (const float*)part_counts, (float*)sums,
      (float*)counts, n_shards, n_ctas, k, d);
  return (int)cudaGetLastError();
}
