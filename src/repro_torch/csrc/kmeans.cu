// k-means map step for Hopper (sm_90a): assign on the tensor cores in
// 3xTF32 (wgmma), then a deterministic per-centre accumulate.
//
// Replaces the TPU kernel src/repro/kernels/kmeans/kernel.py::
// kmeans_assign_tiles (pallas_call at line 84; tile body _kmeans_tile_kernel).
// Per point x with weight w, against centres c (K, D):
//   d2[k]     = (|x|^2 + |c_k|^2) - 2 * (x . c_k)
//   assign    = argmin_k d2[k]                          first index on ties
//   sums[a]  += w * x ;  counts[a] += w
// for S shards at once: points (S, n, D), weights (S, n), one shared centre
// table (K, D); outputs assign (S, n) int32, sums (S, K, D), counts (S, K).
//
// What bounds it on an H100. The distance product is 2*N*K*D operations
// against N*D*4 bytes of points read once: 32 operations per byte at D=64,
// K=256, above both ridges, so operations bound it. On the FP32 CUDA cores
// (67 TFLOP/s) that is 2.13 ms at N=4,194,304; on the TF32 tensor cores
// (495 TFLOP/s) the three products of the 3xTF32 split take 0.83 ms.
//
// Precision. TF32 keeps 10 mantissa bits, and near-ties would flip `assign`.
// Each operand is split as v = hi + lo, hi = tf32_rna(v), lo = tf32_rna(v -
// hi), and x.c is taken as x_lo.c_hi + x_hi.c_lo + x_hi.c_hi accumulated in
// FP32 (the dropped x_lo.c_lo term is ~2^-22 of |x||c|). That is FP32-grade,
// far inside the near-tie scale 1e-5*(|x|^2 + |c|^2) under which two centres
// are counted as tied (tests/test_torch_kmeans_kernel.py emulates it).
//
// Design (three kernels, issued by one C entry point; any K >= 1, D >= 1):
//  * assign, D <= 64: persistent, one CTA of two warpgroups per SM. The centre table
//    is split once into hi/lo and kept in shared memory as wgmma's K-major
//    operand (8x16-byte core matrices, no swizzle), padded to a multiple of
//    128 centres with zeros; where it does not fit beside the point rings it
//    is streamed through in chunks, with a running (min, argmin). Each
//    warpgroup walks its own tiles of 64 points on a static schedule, with
//    its own 2-stage cp.async ring (16-byte copies where the rows allow,
//    4-byte copies for D not a multiple of 4; rows padded to a stride that
//    makes the fragment loads conflict-free) and its own barrier, so the two
//    drift apart and one's epilogue overlaps the other's products. Per tile
//    it splits the A fragments into hi/lo registers once, then per 128
//    centres issues three wgmma.m64n128k8 per 8 columns (A from registers,
//    B from shared memory) into one of two accumulator sets, the next 128
//    before the epilogue of the last. The epilogue forms d2 with one
//    rounding per step, keeps four strict-< running minima per row (centres
//    in increasing order) and merges them, then the quad's four lanes, by
//    (d2, index), so the first index wins ties. Padded centres are masked
//    by index.
//  * assign, D > 64: the same products and epilogue, with D taken in chunks
//    of 64 columns. A first small kernel splits the centre table once into
//    hi/lo slices of 128 centres x 64 columns in wgmma's layout, with |c|^2
//    over all of D. A CTA of two warpgroups then takes 128 points at a time;
//    per block of 128 centres it walks the chunks, each stage (the table's
//    slice, |c|^2, the points' columns) arriving by cp.async into one of two
//    buffers while the other is worked on. Each warpgroup splits its A
//    fragments from the staged points and adds the chunk's products to the
//    same accumulators (the dot product runs on over the chunks), then forms
//    d2 after the block's last chunk. A ragged last chunk issues only the
//    k-steps it has, its padded columns zero on both sides. Each stage still
//    waits for its products before the CTA's barrier.
//  * accumulate: CTA (g, s) of 1024 threads walks a fixed range of shard s's
//    points in tiles of 256; a tile's x, assignments and weights arrive by
//    cp.async (the next tile's while this one is worked on, where shared
//    memory allows two stages). A bitonic sort of (assign, position) groups
//    the tile's points by centre in point order; each run of one centre is
//    then added, column by column, by the one thread group in whose share
//    of the sorted positions the run starts, into per-CTA partials in shared
//    memory. No float atomics. Where the (K, D) partials do not fit one
//    CTA's shared memory, blockIdx.z takes a block of centres x a block of
//    at most 64 columns: the CTA stages only those columns, sorts only the
//    points assigned inside the centre block, and adds them the same way.
//  * reduce: one thread per output entry adds the CTAs' partials of its shard
//    in the order g = 0..G-1.
// Two runs therefore give the same bits. The kernels run on the caller's
// stream and allocate nothing: the wrapper passes the partial buffers.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int DMAX = 64;
constexpr int KSMAX = DMAX / 8;     // k-steps of 8 columns
constexpr int SMEM_MAX = 232448;    // bytes of shared memory one CTA may use
constexpr unsigned FULL = 0xffffffffu;

constexpr int A_THREADS = 256;            // two warpgroups
constexpr int WG_ROWS = 64;               // points per assign tile: one warpgroup's
constexpr int NW = 128;                   // centres per wgmma (its N)

constexpr int C_TILE = 256;      // accumulate: points per tile
constexpr int C_THREADS = 1024;  // accumulate: threads per CTA
constexpr int C_DB = 64;         // accumulate: columns per block where (K, D) does not fit

constexpr int DC = 64;           // assign, D > 64: columns per chunk
constexpr int DC_KS = DC / 8;    // its k-steps
constexpr int DC_SD = DC + 4;    // row stride of its point chunk (conflict-free fragments)
constexpr int DC_ROWS = 2 * WG_ROWS;  // points per CTA step

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

struct AssignPlan {
  int dp;       // D padded to a multiple of 8
  int sd;       // row stride of a point tile in shared memory (floats)
  int ck;       // centres per shared-memory chunk (multiple of NW)
  int chunked;  // 1 when the padded table does not fit whole
  long long smem;
};

AssignPlan assign_plan(int k, int d) {
  AssignPlan p;
  p.dp = round_up(d, 8);
  p.sd = p.dp + 4;  // sd/4 odd: rows g*sd + t fall in 32 distinct banks
  const long long ring = 2LL * 2 * WG_ROWS * p.sd * 4;
  const long long per_centre = (long long)p.dp * 2 * 4 + 4;  // hi, lo, |c|^2
  const int ckmax = (int)((SMEM_MAX - ring) / per_centre) / NW * NW;
  const int kp = round_up(k, NW);
  p.chunked = kp > ckmax;
  p.ck = p.chunked ? ckmax : kp;
  p.smem = (long long)p.ck * per_centre + ring;
  return p;
}

// Accumulate: `stages` tile buffers (x, assignments, weights), the per-CTA
// partials (k, d) and counts (k,), the end of each centre's run (k,), and the
// sort's keys.
long long accumulate_smem(int k, int d, int stages) {
  return (long long)stages * C_TILE * (d + 2) * 4 + (long long)k * d * 4 + 2LL * k * 4 +
         (long long)C_TILE * 4;
}

// The accumulate's blocks: kb centres x db columns per CTA, `stages` tile
// buffers. The whole (k, d) table when it fits (two stages, else one);
// otherwise blocks of at most 64 columns and as many centres as fit beside
// two stages.
struct AccPlan {
  int kb, db, stages;
};

AccPlan acc_plan(int k, int d) {
  if (accumulate_smem(k, d, 2) <= SMEM_MAX) return {k, d, 2};
  if (accumulate_smem(k, d, 1) <= SMEM_MAX) return {k, d, 1};
  const int db = d < C_DB ? d : C_DB;
  const long long rest = SMEM_MAX - accumulate_smem(0, db, 2);
  const int kb = (int)(rest / ((long long)db * 4 + 8));
  return {kb < k ? kb : k, db, 2};
}

constexpr int DC_TAB = 2 * DC_KS * NW * 8;            // one table slice: hi and lo
constexpr int DC_STAGE = DC_TAB + NW + DC_ROWS * DC_SD;  // floats per stage buffer
constexpr int DC_SMEM = 2 * DC_STAGE * 4;

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// Shared-memory descriptor of a K-major tf32 operand without swizzle: core
// matrices of 8 rows x 16 bytes, the two halves of a k-step 128 bytes apart
// (leading byte offset), successive groups of 8 rows 256 bytes apart (stride
// byte offset).
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// D (64x128 f32, per warpgroup) += A (64x8 tf32, registers) * B (8x128 tf32)
__device__ __forceinline__ void wgmma_tf32(float (&d)[16][4], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across a wgmma
__device__ __forceinline__ void fence_operands(float (&d)[16][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+f"(d[j][q])::"memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Centres [cbase, cbase + cn) split into hi/lo as wgmma's B operand: for
// part p (0 hi, 1 lo) and k-step s, the region cs + (p*KS + s)*cn*8 holds
// centre cl's columns 8s + 4h + e at (cl/8)*64 + h*32 + (cl%8)*4 + e.
// Centres >= k and columns >= d are zero; c2s holds |c|^2.
template <int KS>
__device__ void fill_centres(float* __restrict__ cs, float* __restrict__ c2s,
                             const float* __restrict__ centers, int k, int d, int cbase,
                             int cn) {
  constexpr int DP = KS * 8;
  for (int e = threadIdx.x; e < cn * DP; e += blockDim.x) {
    const int cl = e / DP, dd = e - cl * DP;
    const int kk = cbase + cl;
    const float v = (kk < k && dd < d) ? centers[(long long)kk * d + dd] : 0.f;
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    const int at = (dd >> 3) * cn * 8 + (cl >> 3) * 64 + ((dd >> 2) & 1) * 32 + (cl & 7) * 4 +
                   (dd & 3);
    cs[at] = __uint_as_float(hi);
    cs[KS * cn * 8 + at] = __uint_as_float(lo);
  }
  for (int cl = threadIdx.x; cl < cn; cl += blockDim.x) {
    const int kk = cbase + cl;
    float v2 = 0.f;
    if (kk < k) {
      for (int dd = 0; dd < d; ++dd) {
        const float v = centers[(long long)kk * d + dd];
        v2 = __fadd_rn(v2, __fmul_rn(v, v));
      }
    }
    c2s[cl] = v2;
  }
  // the tensor cores read shared memory through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [tile*WG_ROWS, +WG_ROWS) of X (N, d) into xs (WG_ROWS, sd), issued by
// the 128 threads of one warpgroup (lane wl); rows past N are zero-filled.
// Columns d..sd-1 are left as they are (masked on read).
__device__ void load_tile(float* xs, const float* __restrict__ X, long long N, int d,
                          int sd, long long tile, bool vec, int wl) {
  const long long p0 = tile * WG_ROWS;
  if (vec) {
    const int q = d >> 2;
    for (int i = wl; i < WG_ROWS * q; i += 128) {
      const int r = i / q, c = (i - r * q) * 4;
      const bool ok = p0 + r < N;
      cp_async16(xs + r * sd + c, ok ? X + (p0 + r) * d + c : X, ok);
    }
  } else {
    for (int i = wl; i < WG_ROWS * d; i += 128) {
      const int r = i / d, c = i - r * d;
      const bool ok = p0 + r < N;
      cp_async4(xs + r * sd + c, ok ? X + (p0 + r) * d + c : X, ok);
    }
  }
}

// barrier over the 128 threads of warpgroup wg (barrier 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

__device__ __forceinline__ void take_min(float& bd, int& bi, float od, int oi) {
  if (od < bd || (od == bd && oi < bi)) {
    bd = od;
    bi = oi;
  }
}

// KS = D padded to 8, over 8: the k-steps, fixed at compile time so that the
// A fragments stay in registers and the product loop has no branch.
template <int KS>
__global__ void __launch_bounds__(A_THREADS, 1)
kmeans_assign_kernel(const float* __restrict__ points, const float* __restrict__ centers,
                     int* __restrict__ assign, long long N, int d, int k, int sd, int ck,
                     int chunked, int vec) {
  extern __shared__ __align__(128) float smem[];
  float* cs = smem;                            // (2, KS, ck/8, 2, 8, 4)
  float* c2s = cs + (size_t)ck * KS * 8 * 2;   // (ck,)
  float* ring = c2s + ck;                      // (2 warpgroups, 2, WG_ROWS, sd)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = threadIdx.x & 127;
  const int g = lane >> 2, t = lane & 3;
  const int kp = round_up(k, NW);
  const int n_chunks = (kp + ck - 1) / ck;
  const long long n_tiles = (N + WG_ROWS - 1) / WG_ROWS;
  const long long stride = 2LL * gridDim.x;
  float* my_ring = ring + wg * 2 * WG_ROWS * sd;

  if (!chunked) fill_centres<KS>(cs, c2s, centers, k, d, 0, kp);
  __syncthreads();

  // Each warpgroup walks its own tiles of 64 points, with its own ring and
  // barrier, so the two drift apart and one's epilogue overlaps the other's
  // products. The loop count is the same for both (the chunked table is
  // refilled with CTA-wide barriers); a warpgroup past the end idles.
  long long tile = 2LL * blockIdx.x + wg;
  if (tile < n_tiles) load_tile(my_ring, points, N, d, sd, tile, vec, wl);
  cp_async_commit();
  for (int it = 0; 2LL * blockIdx.x + it * stride < n_tiles; ++it, tile += stride) {
    const bool valid = tile < n_tiles;
    if (tile + stride < n_tiles)
      load_tile(my_ring + ((it + 1) & 1) * WG_ROWS * sd, points, N, d, sd, tile + stride, vec,
                wl);
    cp_async_commit();
    cp_async_wait1();
    wg_sync(wg);

    // this warp's 16 rows: A fragments (rows g, g+8; columns t, t+4 of each
    // k-step) split into hi/lo, and |x|^2 of rows g and g+8
    const float* xs = my_ring + (it & 1) * WG_ROWS * sd + (warp & 3) * 16 * sd;
    uint32_t ahi[KS][4], alo[KS][4];
    float x2a = 0.f, x2b = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int c0 = s * 8 + t, c1 = c0 + 4;
      const float v0 = c0 < d ? xs[g * sd + c0] : 0.f;
      const float v1 = c0 < d ? xs[(g + 8) * sd + c0] : 0.f;
      const float v2 = c1 < d ? xs[g * sd + c1] : 0.f;
      const float v3 = c1 < d ? xs[(g + 8) * sd + c1] : 0.f;
      x2a = __fadd_rn(__fadd_rn(x2a, __fmul_rn(v0, v0)), __fmul_rn(v2, v2));
      x2b = __fadd_rn(__fadd_rn(x2b, __fmul_rn(v1, v1)), __fmul_rn(v3, v3));
      split_tf32(v0, ahi[s][0], alo[s][0]);
      split_tf32(v1, ahi[s][1], alo[s][1]);
      split_tf32(v2, ahi[s][2], alo[s][2]);
      split_tf32(v3, ahi[s][3], alo[s][3]);
    }
    // butterfly over the quad: every lane ends with the same bits
    x2a = __fadd_rn(x2a, __shfl_xor_sync(FULL, x2a, 1));
    x2a = __fadd_rn(x2a, __shfl_xor_sync(FULL, x2a, 2));
    x2b = __fadd_rn(x2b, __shfl_xor_sync(FULL, x2b, 1));
    x2b = __fadd_rn(x2b, __shfl_xor_sync(FULL, x2b, 2));

    float bd0 = CUDART_INF_F, bd1 = CUDART_INF_F;
    int bi0 = INT_MAX, bi1 = INT_MAX;
    // Products of 128 centres go to one of two accumulator sets: the next
    // 128 are issued before the epilogue of the last ones, so the tensor
    // cores keep working while this warpgroup forms d2.
    float acc0[16][4], acc1[16][4];
    auto issue = [&](float (&acc)[16][4], const float* cs_c, int cn, int n0) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const uint64_t b_hi = smem_desc(cs_c + (size_t)s * cn * 8 + n0 * 8);
        const uint64_t b_lo = smem_desc(cs_c + (size_t)(KS + s) * cn * 8 + n0 * 8);
        wgmma_tf32(acc, alo[s], b_hi);
        wgmma_tf32(acc, ahi[s], b_lo);
        wgmma_tf32(acc, ahi[s], b_hi);
      }
      wgmma_commit();
    };
    // Accumulator (j, q): row g (q < 2) or g+8, centre kk0 + 8j + 2t + (q&1).
    // d2 = (|x|^2 + |c|^2) - 2 x.c with one rounding of each step (2 x.c is
    // exact, so the fma rounds as the subtraction would). Four running
    // minima per row (by j % 4), each over increasing centres with a strict
    // <, are merged by (d2, index): the first index still wins ties.
    auto epilogue = [&](float (&acc)[16][4], int c_off, int kk0) {
      fence_operands(acc);
      float m[4][2];
      int mi[4][2];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        m[c][0] = m[c][1] = CUDART_INF_F;
        mi[c][0] = mi[c][1] = INT_MAX;
      }
      auto scan = [&](bool check) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 c2 = *reinterpret_cast<const float2*>(c2s + c_off + j * 8 + 2 * t);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int kk = kk0 + j * 8 + 2 * t + (q & 1);
            const float d2 = __fmaf_rn(-2.0f, acc[j][q],
                                       __fadd_rn(q < 2 ? x2a : x2b, (q & 1) ? c2.y : c2.x));
            if ((!check || kk < k) && d2 < m[j & 3][q >> 1]) {
              m[j & 3][q >> 1] = d2;
              mi[j & 3][q >> 1] = kk;
            }
          }
        }
      };
      if (kk0 + NW <= k) scan(false); else scan(true);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        take_min(bd0, bi0, m[c][0], mi[c][0]);
        take_min(bd1, bi1, m[c][1], mi[c][1]);
      }
    };
    for (int c = 0; c < n_chunks; ++c) {
      const int cbase = c * ck;
      const int cn = min(ck, kp - cbase);
      if (chunked) {
        __syncthreads();
        fill_centres<KS>(cs, c2s, centers, k, d, cbase, cn);
        __syncthreads();
      }
      if (!valid) continue;
      issue(acc0, cs, cn, 0);
      for (int n0 = 0; n0 < cn; n0 += 2 * NW) {
        const bool more1 = n0 + NW < cn;
        if (more1) {
          issue(acc1, cs, cn, n0 + NW);
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        epilogue(acc0, n0, cbase + n0);
        if (!more1) break;
        const bool more0 = n0 + 2 * NW < cn;
        if (more0) {
          issue(acc0, cs, cn, n0 + 2 * NW);
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        epilogue(acc1, n0 + NW, cbase + n0 + NW);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      take_min(bd0, bi0, __shfl_xor_sync(FULL, bd0, off), __shfl_xor_sync(FULL, bi0, off));
      take_min(bd1, bi1, __shfl_xor_sync(FULL, bd1, off), __shfl_xor_sync(FULL, bi1, off));
    }
    if (valid && t == 0) {
      const long long p = tile * WG_ROWS + (warp & 3) * 16 + g;
      if (p < N) assign[p] = bi0 == INT_MAX ? 0 : bi0;
      if (p + 8 < N) assign[p + 8] = bi1 == INT_MAX ? 0 : bi1;
    }
    wg_sync(wg);  // the ring slot is refilled next iteration
  }
  cp_async_wait0();
}

// The chunked assign kernel's centre table, made once per launch: for each
// block of NW centres and chunk of DC columns, its hi/lo split in wgmma's
// K-major layout (as fill_centres lays it out with cn = NW), DC_TAB floats;
// and |c|^2 of every centre over all of D, added in column order as
// fill_centres does, zero past K (c2 holds n_cblocks * NW floats).
__global__ void kmeans_ctab_kernel(const float* __restrict__ centers, float* __restrict__ c2,
                                   float* __restrict__ ctab, int k, int d, int n_dchunks) {
  const int cb = blockIdx.x / n_dchunks, dc = blockIdx.x - cb * n_dchunks;
  const int cbase = cb * NW, d0 = dc * DC;
  float* cs = ctab + (size_t)blockIdx.x * DC_TAB;
  for (int e = threadIdx.x; e < NW * DC; e += blockDim.x) {
    const int cl = e / DC, dd = e - cl * DC;
    const int kk = cbase + cl, c = d0 + dd;
    const float v = (kk < k && c < d) ? centers[(long long)kk * d + c] : 0.f;
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    const int at = (dd >> 3) * NW * 8 + (cl >> 3) * 64 + ((dd >> 2) & 1) * 32 + (cl & 7) * 4 +
                   (dd & 3);
    cs[at] = __uint_as_float(hi);
    cs[DC_KS * NW * 8 + at] = __uint_as_float(lo);
  }
  if (dc == 0 && threadIdx.x < NW) {
    const int kk = cbase + threadIdx.x;
    float v2 = 0.f;
    if (kk < k) {
      for (int dd = 0; dd < d; ++dd) {
        const float v = centers[(long long)kk * d + dd];
        v2 = __fadd_rn(v2, __fmul_rn(v, v));
      }
    }
    c2[kk] = v2;
  }
}

// One stage of the chunked assign kernel into buffer `st` by cp.async: the
// (centre block, D-chunk) slice of the table, the block's |c|^2, and the
// chunk's columns of the CTA's DC_ROWS points (zero past N and past D).
__device__ void load_dchunk_stage(float* st, const float* __restrict__ ctab,
                                  const float* __restrict__ c2g,
                                  const float* __restrict__ points, long long N, int d,
                                  long long p0, int cb, int dc, int n_dchunks, bool vec) {
  const int tid = threadIdx.x;
  const float* src = ctab + (size_t)(cb * n_dchunks + dc) * DC_TAB;
  for (int i = tid; i < DC_TAB / 4; i += A_THREADS) cp_async16(st + 4 * i, src + 4 * i, true);
  float* c2s = st + DC_TAB;
  if (tid < NW / 4) cp_async16(c2s + 4 * tid, c2g + cb * NW + 4 * tid, true);
  float* xs = c2s + NW;
  const int d0 = dc * DC;
  if (vec) {
    for (int i = tid; i < DC_ROWS * DC / 4; i += A_THREADS) {
      const int r = i / (DC / 4), c = (i - r * (DC / 4)) * 4;
      const bool ok = p0 + r < N && d0 + c < d;
      cp_async16(xs + r * DC_SD + c, ok ? points + (p0 + r) * d + d0 + c : points, ok);
    }
  } else {
    for (int i = tid; i < DC_ROWS * DC; i += A_THREADS) {
      const int r = i / DC, c = i - r * DC;
      const bool ok = p0 + r < N && d0 + c < d;
      cp_async4(xs + r * DC_SD + c, ok ? points + (p0 + r) * d + d0 + c : points, ok);
    }
  }
}

// Assign for D > 64: per step a CTA takes DC_ROWS points (64 per warpgroup)
// and, per block of NW centres, walks D in chunks of DC columns. Each
// (tile, centre block, chunk) stage -- the table's slice, |c|^2, the points'
// columns -- arrives by cp.async into one of two buffers while the other is
// worked on; each warpgroup splits its A fragments from the staged points
// and adds the chunk's 3xTF32 products to its accumulators. After a block's
// last chunk the epilogue forms d2 as the D <= 64 kernel does.
__global__ void __launch_bounds__(A_THREADS, 1)
kmeans_assign_dchunk_kernel(const float* __restrict__ points, const float* __restrict__ ctab,
                            const float* __restrict__ c2g, int* __restrict__ assign,
                            long long N, int d, int k, int vec) {
  extern __shared__ __align__(128) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_cblocks = (k + NW - 1) / NW;
  const int n_dchunks = (d + DC - 1) / DC;
  const long long n_tiles = (N + DC_ROWS - 1) / DC_ROWS;
  const int row0 = (warp >> 2) * WG_ROWS + (warp & 3) * 16;  // this warp's 16 rows

  // the stages in order: tile (grid-stride), centre block, chunk
  long long tile = blockIdx.x;
  int cb = 0, dc = 0;
  if (tile < n_tiles)
    load_dchunk_stage(smem, ctab, c2g, points, N, d, tile * DC_ROWS, 0, 0, n_dchunks, vec);
  cp_async_commit();
  float x2a = 0.f, x2b = 0.f;
  float bd0 = CUDART_INF_F, bd1 = CUDART_INF_F;
  int bi0 = INT_MAX, bi1 = INT_MAX;
  float acc[16][4];
  for (int it = 0; tile < n_tiles; ++it) {
    // the next stage into the other buffer
    long long ntile = tile;
    int ncb = cb, ndc = dc + 1;
    if (ndc == n_dchunks) {
      ndc = 0;
      if (++ncb == n_cblocks) {
        ncb = 0;
        ntile += gridDim.x;
      }
    }
    float* st = smem + (it & 1) * DC_STAGE;
    if (ntile < n_tiles)
      load_dchunk_stage(smem + ((it + 1) & 1) * DC_STAGE, ctab, c2g, points, N, d,
                        ntile * DC_ROWS, ncb, ndc, n_dchunks, vec);
    cp_async_commit();
    cp_async_wait1();
    // the tensor cores read the staged table through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const float* cs = st;
    const float* c2s = st + DC_TAB;
    const float* xw = c2s + NW + row0 * DC_SD;
    if (dc == 0) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
    }
    const int ks_n = min(DC_KS, (d - dc * DC + 7) / 8);
    uint32_t ahi[DC_KS][4], alo[DC_KS][4];
#pragma unroll
    for (int s = 0; s < DC_KS; ++s) {
      const int c0 = s * 8 + t, c1 = c0 + 4;
      const float v0 = xw[g * DC_SD + c0], v1 = xw[(g + 8) * DC_SD + c0];
      const float v2 = xw[g * DC_SD + c1], v3 = xw[(g + 8) * DC_SD + c1];
      if (cb == 0) {
        x2a = __fadd_rn(__fadd_rn(x2a, __fmul_rn(v0, v0)), __fmul_rn(v2, v2));
        x2b = __fadd_rn(__fadd_rn(x2b, __fmul_rn(v1, v1)), __fmul_rn(v3, v3));
      }
      split_tf32(v0, ahi[s][0], alo[s][0]);
      split_tf32(v1, ahi[s][1], alo[s][1]);
      split_tf32(v2, ahi[s][2], alo[s][2]);
      split_tf32(v3, ahi[s][3], alo[s][3]);
    }
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < DC_KS; ++s) {
      if (s < ks_n) {
        const uint64_t b_hi = smem_desc(cs + (size_t)s * NW * 8);
        const uint64_t b_lo = smem_desc(cs + (size_t)(DC_KS + s) * NW * 8);
        wgmma_tf32(acc, alo[s], b_hi);
        wgmma_tf32(acc, ahi[s], b_lo);
        wgmma_tf32(acc, ahi[s], b_hi);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);

    if (dc == n_dchunks - 1) {
      if (cb == 0) {  // butterfly over the quad: every lane ends with the same bits
        x2a = __fadd_rn(x2a, __shfl_xor_sync(FULL, x2a, 1));
        x2a = __fadd_rn(x2a, __shfl_xor_sync(FULL, x2a, 2));
        x2b = __fadd_rn(x2b, __shfl_xor_sync(FULL, x2b, 1));
        x2b = __fadd_rn(x2b, __shfl_xor_sync(FULL, x2b, 2));
      }
      // d2 and four strict-< running minima per row, merged by (d2, index)
      const int cbase = cb * NW;
      float m[4][2];
      int mi[4][2];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        m[c][0] = m[c][1] = CUDART_INF_F;
        mi[c][0] = mi[c][1] = INT_MAX;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 c2 = *reinterpret_cast<const float2*>(c2s + j * 8 + 2 * t);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kk = cbase + j * 8 + 2 * t + (q & 1);
          const float d2 = __fmaf_rn(-2.0f, acc[j][q],
                                     __fadd_rn(q < 2 ? x2a : x2b, (q & 1) ? c2.y : c2.x));
          if (kk < k && d2 < m[j & 3][q >> 1]) {
            m[j & 3][q >> 1] = d2;
            mi[j & 3][q >> 1] = kk;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        take_min(bd0, bi0, m[c][0], mi[c][0]);
        take_min(bd1, bi1, m[c][1], mi[c][1]);
      }
      if (cb == n_cblocks - 1) {
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          take_min(bd0, bi0, __shfl_xor_sync(FULL, bd0, off), __shfl_xor_sync(FULL, bi0, off));
          take_min(bd1, bi1, __shfl_xor_sync(FULL, bd1, off), __shfl_xor_sync(FULL, bi1, off));
        }
        if (t == 0) {
          const long long p = tile * DC_ROWS + row0 + g;
          if (p < N) assign[p] = bi0 == INT_MAX ? 0 : bi0;
          if (p + 8 < N) assign[p + 8] = bi1 == INT_MAX ? 0 : bi1;
        }
        x2a = x2b = 0.f;
        bd0 = bd1 = CUDART_INF_F;
        bi0 = bi1 = INT_MAX;
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration's loads
    tile = ntile;
    cb = ncb;
    dc = ndc;
  }
  cp_async_wait0();
}

// One accumulate tile into a stage by cp.async: x (cnt rows of dw floats,
// columns d0.. of rows of d), then the tile's assignments and weights
// (C_TILE each).
__device__ void load_acc_tile(float* st, const float* __restrict__ X,
                              const float* __restrict__ W, const int* __restrict__ A,
                              long long base, int cnt, int d, int d0, int dw, bool vec) {
  const int tid = threadIdx.x;
  const float* Xt = X + base * d + d0;
  if (dw == d) {  // whole rows: one contiguous run
    if (vec) {
      for (int i = tid; i < cnt * d / 4; i += C_THREADS) cp_async16(st + 4 * i, Xt + 4 * i, true);
    } else {
      for (int i = tid; i < cnt * d; i += C_THREADS) cp_async4(st + i, Xt + i, true);
    }
  } else if (vec) {
    const int q = dw / 4;
    for (int i = tid; i < cnt * q; i += C_THREADS) {
      const int r = i / q, c = (i - r * q) * 4;
      cp_async16(st + r * dw + c, Xt + (long long)r * d + c, true);
    }
  } else {
    for (int i = tid; i < cnt * dw; i += C_THREADS) {
      const int r = i / dw, c = i - r * dw;
      cp_async4(st + r * dw + c, Xt + (long long)r * d + c, true);
    }
  }
  if (tid < cnt) {
    cp_async4(st + C_TILE * dw + tid, A + base + tid, true);
    cp_async4(st + C_TILE * (dw + 1) + tid, W + base + tid, true);
  }
}

// Ascending bitonic sort of C_TILE ints, one per thread, by the first C_TILE
// threads alone (barrier 1 over them): shuffles for strides inside a warp,
// shared memory for the others. keys[] gets the result.
__device__ void bitonic_sort(int v, int* keys) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int size = 2; size <= C_TILE; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      int o;
      if (stride >= 32) {
        keys[tid] = v;
        asm volatile("bar.sync 1, %0;\n" :: "n"(C_TILE) : "memory");
        o = keys[tid ^ stride];
        asm volatile("bar.sync 1, %0;\n" :: "n"(C_TILE) : "memory");
      } else {
        o = __shfl_xor_sync(FULL, v, stride);
      }
      const bool keep_min = ((tid & stride) == 0) == ((tid & size) == 0);
      v = keep_min ? min(v, o) : max(v, o);
    }
  }
  keys[tid] = v;
}

// Block z of the grid takes centres [k0, k0 + kw) and columns [d0, d0 + dw)
// (z = centre block * n_dblocks + column block); with one block that is the
// whole table.
__global__ void __launch_bounds__(C_THREADS, 1)
kmeans_accumulate_kernel(const float* __restrict__ points, const float* __restrict__ weights,
                         const int* __restrict__ assign, float* __restrict__ part_sums,
                         float* __restrict__ part_counts, long long n, int d, int k, int kb,
                         int db, int n_dblocks, int tiles_per_cta, int stages, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int kblk = blockIdx.z / n_dblocks, dblk = blockIdx.z - kblk * n_dblocks;
  const int k0 = kblk * kb, kw = min(kb, k - k0);
  const int d0 = dblk * db, dw = min(db, d - d0);
  const int stage_floats = C_TILE * (db + 2);
  float* acc = smem + stages * stage_floats;             // (kw, dw)
  float* acc_c = acc + (size_t)kw * dw;                  // (kw,)
  int* run_end = reinterpret_cast<int*>(acc_c + kw);     // (kw,)
  int* keys = run_end + kw;                              // (C_TILE,)

  const int tid = threadIdx.x;
  const int s = blockIdx.y, g = blockIdx.x, n_ctas = gridDim.x;
  const float* X = points + (long long)s * n * d;
  const float* W = weights + (long long)s * n;
  const int* A = assign + (long long)s * n;

  for (int i = tid; i < kw * dw; i += C_THREADS) acc[i] = 0.f;
  for (int i = tid; i < kw; i += C_THREADS) acc_c[i] = 0.f;

  // thread (kg, col): column col of group kg, one of n_groups groups of dw
  const int n_groups = C_THREADS / dw;
  const int col = tid % dw;
  const int kg = tid / dw;

  const long long p0 = (long long)g * tiles_per_cta * C_TILE;
  const int my_tiles = (int)max(0LL, min((long long)tiles_per_cta,
                                         (n - p0 + C_TILE - 1) / C_TILE));
  auto stage = [&](int t) { return smem + (stages == 2 ? (t & 1) : 0) * stage_floats; };
  auto count = [&](int t) {
    return (int)min((long long)C_TILE, n - p0 - (long long)t * C_TILE);
  };
  if (my_tiles > 0) load_acc_tile(stage(0), X, W, A, p0, count(0), d, d0, dw, vec);
  cp_async_commit();
  for (int t = 0; t < my_tiles; ++t) {
    if (stages == 2 && t + 1 < my_tiles)
      load_acc_tile(stage(t + 1), X, W, A, p0 + (long long)(t + 1) * C_TILE, count(t + 1), d,
                    d0, dw, vec);
    cp_async_commit();
    if (stages == 2) cp_async_wait1(); else cp_async_wait0();
    __syncthreads();

    const float* xs = stage(t);
    const int* as = reinterpret_cast<const int*>(xs + C_TILE * dw);
    const float* ws = xs + C_TILE * (dw + 1);
    const int cnt = count(t);
    // sort (assign, position) of the tile's points in this centre block:
    // grouped by centre, in point order; m of them, the rest keyed past them
    const int a_t = tid < cnt ? as[tid] - k0 : -1;
    const bool mine = a_t >= 0 && a_t < kw;
    if (tid < C_TILE) bitonic_sort(mine ? a_t * C_TILE + tid : INT_MAX, keys);
    const int m = __syncthreads_count(tid < C_TILE && mine);
    if (tid < m) {
      const int a = keys[tid] / C_TILE;
      if (tid == m - 1 || keys[tid + 1] / C_TILE != a) run_end[a] = tid + 1;
    }
    __syncthreads();

    // group kg adds the runs that start in its share of the sorted positions,
    // each to its end: every (centre, column) entry has one owner per tile
    if (kg < n_groups) {
      const int per = (m + n_groups - 1) / n_groups;
      const int hi = min(m, (kg + 1) * per);
      int i = kg * per;
      if (i > 0 && i < hi && keys[i] / C_TILE == keys[i - 1] / C_TILE)
        i = run_end[keys[i] / C_TILE];
      while (i < hi) {
        const int a = keys[i] / C_TILE;
        const int e = run_end[a];
        float sa = acc[a * dw + col], ca = acc_c[a];
        for (; i < e; ++i) {
          const int q = keys[i] & (C_TILE - 1);
          const float wq = ws[q];
          sa = __fadd_rn(sa, __fmul_rn(wq, xs[q * dw + col]));
          ca = __fadd_rn(ca, wq);
        }
        acc[a * dw + col] = sa;
        if (col == 0) acc_c[a] = ca;
      }
    }
    __syncthreads();  // the stage, keys and runs are reused
    if (stages == 1 && t + 1 < my_tiles)
      load_acc_tile(stage(t + 1), X, W, A, p0 + (long long)(t + 1) * C_TILE, count(t + 1), d,
                    d0, dw, vec);
  }

  float* ps = part_sums + ((long long)s * n_ctas + g) * k * d;
  float* pc = part_counts + ((long long)s * n_ctas + g) * k;
  if (dw == d) {
    for (int i = tid; i < kw * d; i += C_THREADS) ps[(long long)k0 * d + i] = acc[i];
  } else {
    for (int i = tid; i < kw * dw; i += C_THREADS) {
      const int a = i / dw, c = i - a * dw;
      ps[(long long)(k0 + a) * d + d0 + c] = acc[i];
    }
  }
  if (dblk == 0)
    for (int i = tid; i < kw; i += C_THREADS) pc[k0 + i] = acc_c[i];
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

template <int KS>
cudaError_t launch_assign(const void* points, const void* centers, void* assign, long long N,
                          int d, int k, const AssignPlan& plan, int ctas, int vec,
                          cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(kmeans_assign_kernel<KS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)plan.smem);
  if (e != cudaSuccess) return e;
  kmeans_assign_kernel<KS><<<ctas, A_THREADS, plan.smem, st>>>(
      (const float*)points, (const float*)centers, (int*)assign, N, d, k, plan.sd, plan.ck,
      plan.chunked, vec);
  return cudaGetLastError();
}

}  // namespace

// points (S, n, d) f32, centers (k, d) f32, weights (S, n) f32 ->
// assign (S, n) i32, sums (S, k, d) f32, counts (S, k) f32.
// part_sums (S, acc_ctas, k, d), part_counts (S, acc_ctas, k) and, for
// d > 64, dscratch (ceil(k/128) * (128 + ceil(d/64) * 16384) floats: |c|^2
// and the split centre table) are scratch (dscratch may be null for d <= 64).
// assign_ctas CTAs walk the S*n points; acc_ctas CTAs per shard (times the
// accumulate's centre x column blocks) each accumulate acc_tiles_per_cta
// tiles of 256 points. Takes any k >= 1, d >= 1.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int kmeans_assign_accumulate(const void* points, const void* centers,
                                        const void* weights, void* assign,
                                        void* part_sums, void* part_counts,
                                        void* sums, void* counts, void* dscratch,
                                        int n_shards, long long n, int d, int k,
                                        int assign_ctas, int acc_ctas, int acc_tiles_per_cta,
                                        void* stream) {
  if (d < 1 || k < 1 || n_shards < 1 || n < 1 || assign_ctas < 1 || acc_ctas < 1 ||
      acc_tiles_per_cta < 1 || (d > DMAX && dscratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const AccPlan ap = acc_plan(k, d);
  const long long acc_smem = accumulate_smem(ap.kb, ap.db, ap.stages);
  const int n_kblocks = (k + ap.kb - 1) / ap.kb, n_dblocks = (d + ap.db - 1) / ap.db;
  if (ap.kb < 1 || acc_smem > SMEM_MAX || (long long)n_kblocks * n_dblocks > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool aligned = reinterpret_cast<uintptr_t>(points) % 16 == 0;
  cudaError_t e;
  if (d <= DMAX) {
    const AssignPlan plan = assign_plan(k, d);
    if (plan.smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
    using Launch = cudaError_t (*)(const void*, const void*, void*, long long, int, int,
                                   const AssignPlan&, int, int, cudaStream_t);
    static const Launch launch[KSMAX] = {launch_assign<1>, launch_assign<2>, launch_assign<3>,
                                         launch_assign<4>, launch_assign<5>, launch_assign<6>,
                                         launch_assign<7>, launch_assign<8>};
    e = launch[plan.dp / 8 - 1](points, centers, assign, (long long)n_shards * n, d, k, plan,
                                assign_ctas, d % 4 == 0 && aligned, st);
  } else {
    const int n_cblocks = (k + NW - 1) / NW, n_dchunks = (d + DC - 1) / DC;
    float* c2 = (float*)dscratch;
    float* ctab = c2 + (size_t)n_cblocks * NW;
    kmeans_ctab_kernel<<<n_cblocks * n_dchunks, A_THREADS, 0, st>>>((const float*)centers, c2,
                                                                    ctab, k, d, n_dchunks);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(kmeans_assign_dchunk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, DC_SMEM);
    if (e != cudaSuccess) return (int)e;
    kmeans_assign_dchunk_kernel<<<assign_ctas, A_THREADS, DC_SMEM, st>>>(
        (const float*)points, ctab, c2, (int*)assign, (long long)n_shards * n, d, k,
        d % 4 == 0 && aligned);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kmeans_accumulate_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)acc_smem);
  if (e != cudaSuccess) return (int)e;
  kmeans_accumulate_kernel<<<dim3(acc_ctas, n_shards, n_kblocks * n_dblocks), C_THREADS,
                             acc_smem, st>>>(
      (const float*)points, (const float*)weights, (const int*)assign, (float*)part_sums,
      (float*)part_counts, n, d, k, ap.kb, ap.db, n_dblocks, acc_tiles_per_cta, ap.stages,
      d % 4 == 0 && ap.db % 4 == 0 && aligned);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)n_shards * k * (d + 1);
  const int threads = 256;
  kmeans_reduce_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      (const float*)part_sums, (const float*)part_counts, (float*)sums, (float*)counts,
      n_shards, acc_ctas, k, d);
  return (int)cudaGetLastError();
}
