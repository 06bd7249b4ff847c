// Fused causal self-attention forward for a prefill, on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's attention
// (src/repro/models/attention.py) is plain jnp code that XLA fuses, and no
// function of it reaches pl.pallas_call. It replaces the port's plain path
// for a prefill (repro_torch/models/attention.py::_attend_chunked and
// _attend_dense), which writes every (query chunk x key) score to device
// memory in bf16, casts it to float32, scales, masks, softmaxes, casts back
// and permutes K and V for the two products: some ten passes over 6.4 GB a
// chunk at granite-moe's prefill (B 8, T 4,096, H 24, Dh 64).
//
// For each query row t of head h (key/value head h / G, G = H / Hkv), over
// positions 0..T-1:
//   s[j]  = (q[t] . k[j]) / sqrt(Dqk)       for j <= t
//   ctx[t] = sum_j softmax(s)[j] v[j]
// Inputs q (B, T, H, Dqk), k (B, T, Hkv, Dqk) and v (B, T, Hkv, Dv), read
// through their strides as the projections leave them (the last dimension
// contiguous); the context is written as (B, T, H, Dv) in q's dtype. Dqk =
// Dv = Dh for grouped-query attention; latent attention (MLA) has Dqk 192
// (128 + a 64-wide rotary part) beside Dv 128. Two kernels, one a dtype:
//
// bf16, attention_prefill_kernel (the serving path). What bounds it on an
// H100: the causal products are 4 B H T^2 Dh / 2 operations (4.12e11 at
// granite-moe's per-layer shape) against reading q, k, v and writing the
// context once (0.25 GB): ~1,600 operations a byte, far above the bf16 ridge
// (~295), so the tensor cores bound it: 0.417 ms at 989 TFLOP/s. The plain
// path is bound by bytes instead: the scores never need to leave the SM.
// Design (the flash-attention scheme, mma.sync m16n8k16 on the tensor cores):
//  * A CTA of 4 warps takes BM query rows of one (batch, head): 128 rows
//    (32 a warp, two m16 tiles) for Dqk and Dv <= 64, 64 rows (16 a warp)
//    above, so the float32 accumulators fit the registers. Its Q tile is
//    staged through shared memory once and kept in registers as A fragments
//    (at 192/128: 48 registers of Q, 64 of the context, 32 of scores).
//  * It walks key tiles of BN = 64 in order, up to the block's last row;
//    only tiles that reach past the block's first row are masked. Tiles
//    above the diagonal are never visited: their softmax weights are
//    exactly 0 in the plain path (exp of -1e30).
//  * K and V tiles arrive by cp.async (16-byte copies, rows past T zero
//    filled) into one buffer each: V_j's copy overlaps S = Q K_j^T, and
//    K_{j+1}'s the P V_j product. Rows are padded by 16 bytes, so ldmatrix
//    reads them without bank conflicts; V's B fragments come transposed by
//    ldmatrix.trans, so V is never permuted in memory.
//  * Scores stay in float32 registers (products accumulate in float32 from
//    bf16 inputs); the online softmax keeps each row's running max and sum
//    in float32, rescaling the float32 context accumulator when a max
//    moves (a warp skips it when none of its rows' maxima moved);
//    exponentials are base 2, log2(e) / sqrt(Dqk) folded into their
//    multiply-add. P is rounded to bf16 for the P V product (as the plain path
//    rounds its weights to q's dtype) and the context divided by the row
//    sum once, at the end, then staged through shared memory and written
//    in 16-byte stores.
//
// float32, attention_prefill_f32_kernel (float32 models on the card, as the
// card-against-CPU checks run them): every product a float32 fma on the CUDA
// cores, as the plain path's float32 matmuls are, never rounded to a 16-bit
// input. A CTA of 4 warps takes 32 query rows, a row to 4 lanes; key tiles of
// 32 rows (padded to an odd stride, so a warp's reads of 8 rows of Q or 4 of
// K fall in distinct banks) and V tiles in shared memory; each lane scores
// its row against 8 keys, the running max and sum (expf, scaled by a
// division by sqrt(Dqk) as the plain path's) reduced over the row's 4 lanes
// by shuffles, and the weights handed to the P V product by shuffles too; a
// lane keeps Dv / 4 of the row's context.
//
// Both: the grid is (B H, T / BM) with the query blocks in reverse, so the
// longest rows of the causal triangle start first and the short ones fill
// the tail; neighbouring CTAs share a key/value head in L2. One (Dqk, Dv)
// pair a build (-DQK_DIM=16..192 and -DV_DIM=16..128, multiples of 16, Dv <=
// Dqk; a (64, 64) build is the former one-head-size build, constant for
// constant). The kernels allocate
// nothing, run on the caller's stream, and are deterministic (no atomics):
// two runs give the same bits.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#if !defined(QK_DIM) || !defined(V_DIM)
#error "build with -DQK_DIM=<16..192> -DV_DIM=<16..128>, multiples of 16"
#endif

namespace {

constexpr int DQK = QK_DIM;  // a head's query and key width
constexpr int DV = V_DIM;    // a head's value (and context) width
static_assert(DQK % 16 == 0 && DQK >= 16 && DQK <= 192, "QK_DIM: 16..192 in steps of 16");
static_assert(DV % 16 == 0 && DV >= 16 && DV <= 128, "V_DIM: 16..128 in steps of 16");
static_assert(DV <= DQK, "the context is staged in the Q tile's rows");
constexpr int NWARPS = 4;
constexpr int THREADS = 32 * NWARPS;
constexpr int MT = DQK <= 64 && DV <= 64 ? 2 : 1;  // m16 tiles of query rows a warp
constexpr int BM = 16 * MT * NWARPS;  // query rows a CTA
constexpr int BN = 64;                // keys a tile
constexpr int LDQ = DQK + 8;          // Q and K tiles' row stride, in elements
constexpr int LDV = DV + 8;           // the V tile's
constexpr int CHV = DV / 8;           // 16-byte chunks of a context row
constexpr int KS = DQK / 16;          // k-steps of Q K^T
constexpr int NT = BN / 8;            // n8 tiles of a score tile
constexpr int DT = DV / 8;            // n8 tiles of the context
constexpr int SMEM_BYTES = ((BM + BN) * LDQ + BN * LDV) * 2;

// the float32 kernel: 32 query rows and 32 keys a tile, 4 lanes a row
constexpr int FB = 32;
constexpr int FLD = DQK + 1;     // Q and K row stride, in floats: odd, so rows fall in distinct banks
constexpr int FKEYS = FB / 4;    // keys a lane scores in a tile
constexpr int FDV = DV / 4;      // context columns a lane keeps
constexpr int F_SMEM_BYTES = (2 * FB * FLD + FB * DV) * 4;

using bf16 = __nv_bfloat16;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h, o_b, o_t, o_h;  // element strides
  int T, H, G, n_qblocks;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: zero fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_approx(float x) {  // ex2(-inf) = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ROWS rows of W elements from `base` (row r at base + (row0 + r) * stride)
// into a shared tile of row stride W + 8; rows at or past `limit` are zero
// filled.
template <int ROWS, int W>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base, long long stride,
                                          int row0, int limit, int tid) {
  constexpr int CH = W / 8, LD = W + 8;  // 16-byte chunks a row, the tile's row stride
  static_assert(ROWS * CH % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < ROWS * CH / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / CH, ch = c % CH, row = row0 + r;
    const bool ok = row < limit;
    cp_async16(smem_addr(tile + r * LD + ch * 8), base + (ok ? row : 0) * stride + ch * 8, ok);
  }
}

__global__ void __launch_bounds__(THREADS, 2) attention_prefill_kernel(const Args a,
                                                                       const float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + BM * LDQ;
  bf16* s_v = s_k + BN * LDQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, hk = h / a.G;
  const int m0 = (a.n_qblocks - 1 - (int)blockIdx.y) * BM;
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_b + h * a.q_h;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_b + hk * a.k_h;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_b + hk * a.v_h;

  // key tiles to visit (up to the block's last row), and the first that
  // reaches past the block's first row, so needs the mask
  const int n_tiles = (min(m0 + BM, a.T) + BN - 1) / BN;
  const int n_full = (m0 + 1) / BN;

  load_tile<BM, DQK>(s_q, qp, a.q_t, m0, a.T, tid);
  load_tile<BN, DQK>(s_k, kp, a.k_t, 0, a.T, tid);
  cp_async_commit();

  // per-lane ldmatrix offsets (elements) and fragment coordinates
  const int g = lane >> 2, tig = lane & 3;
  const int q_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDQ + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * LDQ + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDV + (lane >> 4) * 8;
  const int row_base = m0 + warp * 16 * MT + g;  // this lane's first row; +8, +16 m-tile

  uint32_t qf[MT][KS][4];
  float acc[MT][DT][4];
  float row_max[MT][2], row_sum[MT][2];  // raw-score max, sum of exponentials
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][dt][e] = 0.f;
    row_max[mt][0] = row_max[mt][1] = -CUDART_INF_F;
    row_sum[mt][0] = row_sum[mt][1] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * BN;
    cp_async_wait_all();  // K_j (and, at j = 0, Q)
    __syncthreads();      // ... visible to all; every warp done with V_{j-1}
    load_tile<BN, DV>(s_v, vp, a.v_t, n0, a.T, tid);
    cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          ldsm_x4(qf[mt][ks], smem_addr(s_q + (warp * MT + mt) * 16 * LDQ + q_off + ks * 16));
    }

    // S = Q K_j^T, float32 (unscaled)
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, smem_addr(s_k + np * 16 * LDQ + k_off + ks * 16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], qf[mt][ks], kb[0], kb[1]);
          mma_bf16(s[mt][2 * np + 1], qf[mt][ks], kb[2], kb[3]);
        }
      }
    }

    // mask the diagonal tile (keys past T are past every row below T, so
    // it masks the ragged tile too); online softmax in base 2, the scale
    // folded into one multiply-add (max and sums over raw scores)
    const bool masked = j >= n_full;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row_base + mt * 16 + half * 8;
        float mx = row_max[mt][half];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][nt][half * 2 + e];
            if (masked && n0 + nt * 8 + tig * 2 + e > row) x = -CUDART_INF_F;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float ref = mx == -CUDART_INF_F ? 0.f : mx * scale_log2;  // no key yet: 0
        const float alpha = exp2_approx(fmaf(row_max[mt][half], scale_log2, -ref));
        row_max[mt][half] = mx;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][nt][half * 2 + e];
            x = exp2_approx(fmaf(x, scale_log2, -ref));
            sum += x;
          }
        }
        row_sum[mt][half] = row_sum[mt][half] * alpha + sum;
        if (__any_sync(0xffffffffu, alpha != 1.f)) {  // skipped once no row's max moves
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) {
            acc[mt][dt][half * 2] *= alpha;
            acc[mt][dt][half * 2 + 1] *= alpha;
          }
        }
      }
    }

    cp_async_wait_all();  // V_j
    __syncthreads();      // ... visible to all; every warp done with K_j
    if (j + 1 < n_tiles) {
      load_tile<BN, DQK>(s_k, kp, a.k_t, n0 + BN, a.T, tid);
      cp_async_commit();
    }

    // context += P V_j, P in bf16 straight from the score registers
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, smem_addr(s_v + kk * 16 * LDV + v_off + dp * 16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * dp], pa[mt], vb[0], vb[1]);
          mma_bf16(acc[mt][2 * dp + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }
  }

  // divide by the row sums, stage the bf16 context in the Q tile (each warp
  // its own rows, read by no one since the first tile), store 16 bytes a lane
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float l = row_sum[mt][half];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
      bf16* dst = s_q + ((warp * MT + mt) * 16 + g + half * 8) * LDQ + tig * 2;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<uint32_t*>(dst + dt * 8) =
            pack_bf16(acc[mt][dt][half * 2] * inv, acc[mt][dt][half * 2 + 1] * inv);
    }
  }
  __syncthreads();
  bf16* op = static_cast<bf16*>(a.o) + b * a.o_b + h * a.o_h;
#pragma unroll
  for (int i = 0; i < BM * CHV / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / CHV, ch = c % CHV, row = m0 + r;
    if (row < a.T)
      *reinterpret_cast<uint4*>(op + row * a.o_t + ch * 8) =
          *reinterpret_cast<const uint4*>(s_q + r * LDQ + ch * 8);
  }
}

// FB float32 rows of W from `base` into a shared tile of row stride `ld`;
// rows at or past `limit` are zero filled. 16-byte reads.
template <int W>
__device__ __forceinline__ void load_tile_f32(float* tile, int ld, const float* base,
                                              long long stride, int row0, int limit, int tid) {
  for (int c = tid; c < FB * (W / 4); c += THREADS) {
    const int r = c / (W / 4), col = (c % (W / 4)) * 4, row = row0 + r;
    const float4 x = row < limit ? *reinterpret_cast<const float4*>(base + row * stride + col)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    float* dst = tile + r * ld + col;
    dst[0] = x.x, dst[1] = x.y, dst[2] = x.z, dst[3] = x.w;
  }
}

__global__ void __launch_bounds__(THREADS) attention_prefill_f32_kernel(const Args a,
                                                                        const float sqrt_dqk) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem);
  float* s_k = s_q + FB * FLD;
  float* s_v = s_k + FB * FLD;
  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, hk = h / a.G;
  const int m0 = (a.n_qblocks - 1 - (int)blockIdx.y) * FB;
  const int r = tid >> 2, cg = lane & 3, row = m0 + r;  // this lane's row, and its quarter
  const float* qp = static_cast<const float*>(a.q) + b * a.q_b + h * a.q_h;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_b + hk * a.k_h;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_b + hk * a.v_h;
  const int n_tiles = m0 / FB + 1;  // up to the diagonal tile, the last and only masked one

  load_tile_f32<DQK>(s_q, FLD, qp, a.q_t, m0, a.T, tid);
  float acc[FDV];
#pragma unroll
  for (int d = 0; d < FDV; ++d) acc[d] = 0.f;
  float row_max = -CUDART_INF_F, row_sum = 0.f;  // the sum: this lane's keys only

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * FB;
    __syncthreads();  // every warp done with K_{j-1}, V_{j-1}
    load_tile_f32<DQK>(s_k, FLD, kp, a.k_t, n0, a.T, tid);
    load_tile_f32<DV>(s_v, DV, vp, a.v_t, n0, a.T, tid);
    __syncthreads();

    // this lane's scores: keys n0 + cg + 4 i
    float s[FKEYS];
#pragma unroll
    for (int i = 0; i < FKEYS; ++i) s[i] = 0.f;
#pragma unroll 16
    for (int kk = 0; kk < DQK; ++kk) {
      const float x = s_q[r * FLD + kk];
#pragma unroll
      for (int i = 0; i < FKEYS; ++i) s[i] = fmaf(x, s_k[(cg + 4 * i) * FLD + kk], s[i]);
    }
    float mx = row_max;
#pragma unroll
    for (int i = 0; i < FKEYS; ++i) {
      s[i] /= sqrt_dqk;
      if (j == n_tiles - 1 && n0 + cg + 4 * i > row) s[i] = -CUDART_INF_F;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));  // finite: key 0 <= every row
    const float alpha = expf(row_max - mx);
    row_max = mx;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < FKEYS; ++i) {
      s[i] = expf(s[i] - mx);
      sum += s[i];
    }
    row_sum = row_sum * alpha + sum;

    // context = alpha context + P V_j, key n0 + c + 4 i's weight from lane c of the row
#pragma unroll
    for (int d = 0; d < FDV; ++d) acc[d] *= alpha;
#pragma unroll
    for (int i = 0; i < FKEYS; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = __shfl_sync(0xffffffffu, s[i], (lane & ~3) | c);
        const float* vr = s_v + (c + 4 * i) * DV + cg;
#pragma unroll
        for (int d = 0; d < FDV; ++d) acc[d] = fmaf(p, vr[4 * d], acc[d]);
      }
    }
  }

  row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
  row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
  if (row < a.T) {
    float* op = static_cast<float*>(a.o) + b * a.o_b + h * a.o_h + row * a.o_t + cg;
#pragma unroll
    for (int d = 0; d < FDV; ++d) op[4 * d] = acc[d] / row_sum;
  }
}

// Raise a kernel's dynamic shared-memory limit once a device.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool (&done)[64]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!done[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[device] = true;
  }
  return cudaSuccess;
}

}  // namespace

// q, k, v, out: device pointers (bf16, or float32 when `fp32`); q (B, T, H,
// Dqk), k (B, T, Hkv, Dqk), v (B, T, Hkv, Dv), out (B, T, H, Dv); strides in
// elements, the last dimension contiguous, every stride a multiple of 8 and
// every pointer 16-byte aligned (the wrapper checks). Returns
// cudaGetLastError() after the launch.
extern "C" int attention_prefill(const void* q, const void* k, const void* v, void* out,
                                 int B, int T, int H, int Hkv, long long q_b, long long q_t,
                                 long long q_h, long long k_b, long long k_t, long long k_h,
                                 long long v_b, long long v_t, long long v_h, long long o_b,
                                 long long o_t, long long o_h, int fp32, void* stream) {
  if (B <= 0 || T <= 0) return 0;
  const int bm = fp32 ? FB : BM;
  Args a{q, k, v, out, q_b, q_t, q_h, k_b, k_t, k_h, v_b, v_t, v_h, o_b, o_t, o_h,
         T, H, H / Hkv, (T + bm - 1) / bm};
  dim3 grid((unsigned)(B * H), (unsigned)a.n_qblocks);
  static bool smem_bf16[64] = {}, smem_f32[64] = {};
  cudaError_t err;
  if (fp32) {
    if ((err = allow_smem(attention_prefill_f32_kernel, F_SMEM_BYTES, smem_f32)) != cudaSuccess)
      return (int)err;
    attention_prefill_f32_kernel<<<grid, THREADS, F_SMEM_BYTES, (cudaStream_t)stream>>>(
        a, sqrtf((float)DQK));
  } else {
    if ((err = allow_smem(attention_prefill_kernel, SMEM_BYTES, smem_bf16)) != cudaSuccess)
      return (int)err;
    attention_prefill_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        a, (float)(1.4426950408889634 / sqrt((double)DQK)));
  }
  return (int)cudaGetLastError();
}
