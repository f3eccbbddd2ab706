// Flash attention for Hopper (sm_90a): the forward (K1) and the backward
// (K2) of the port's training path.
//
// Replaces the Pallas TPU kernels of
// pytorch_distributed_tpu/ops/flash_kernel.py:
//   K1 _fwd_kernel (:92)  -> flash_fwd_sm90 (bf16), flash_fwd_f32 (f32)
//   K2 _bwd_kernel (:221) -> flash_bwd_delta, then flash_bwd_dkdv_sm90 +
//                            flash_bwd_dq_sm90 (bf16) or flash_bwd_dkdv_f32 +
//                            flash_bwd_dq_f32 (f32)
//
// What it computes (the same function as the TPU kernels): softmax attention
// over q [B, H, T, D] and k, v [B, Hkv, T, D] (query head h reads KV head
// h / (H / Hkv)), causal (key c <= query r) or not, with the online softmax
// in base 2 (scores scaled by scale * log2(e)) and NEG_INF = -1e30 as the
// finite mask value. The forward writes o in q's dtype and the natural-log
// logsumexp lse [B, H, T] f32. The backward reads q, k, v, o, do and lse,
// computes delta = rowsum(o * do) in f32 (flash_bwd_delta, into a scratch
// buffer the caller passes), and writes dq in q's dtype and dk, dv
// [B, Hkv, T, D] in k's dtype, summed over each KV head's query-head group
// inside the kernel.
//
// What bounds it on this card: at the training shape (B=8, H=12, T=1024,
// D=64, causal, bf16) K1 is bound by its bytes (~15 us for q, k, v, o and
// lse at 3.35 TB/s; its 12.9 GFLOP take 13 us at 989 TFLOP/s) and K2 by its
// operations (~33 us for five causal products on the bf16 tensor cores).
// Only wgmma reaches the tensor cores' rate. After the products come the
// softmax's exp2 (one per score, 16 per SM and clock, so ex2.approx and not
// exp2f's range handling) and the latency of one warpgroup's chain of
// product -> softmax -> product, which only other warpgroups on the SM can
// hide: occupancy is the third limit. The f32 CUDA cores (67 TFLOP/s) sit
// 15x below the tensor cores.
//
// Design of the bf16 kernels (the main path), against the TPU kernel's:
// - The TPU forward kept one head's whole K and V in VMEM and walked a
//   sequential grid axis. Here one CTA per (b, h, 128-query tile) runs two
//   warpgroups of 64 query rows that share a 2-stage ring of 64-key K/V
//   tiles in shared memory, kept in bf16 in the 128-byte swizzled layout
//   that the wgmma descriptor names (flash_sm90.cuh). cp.async fills the
//   ring, 16 bytes a thread, zero-filling rows at or past T (so strided
//   views and ragged T need no host-side tensor map); the copy of tile j + 1
//   runs while tile j is multiplied (a deeper ring measured no faster). The
//   heaviest query tiles launch first.
// - Every product is a bf16 wgmma with an f32 accumulator: S = Q K^T with
//   both operands from shared memory (K-major), then O += P V with P
//   converted to bf16 in registers (the accumulator's fragment is the next
//   product's A fragment) and V read MN-major (the transpose bit). The
//   online softmax runs on the accumulator fragment: row max and sum over
//   the 4 threads that share a row, ex2.approx, the mask only on the
//   diagonal and the ragged last tile; l is summed from the unrounded f32
//   p. A warpgroup skips the tiles its causal rows never see.
// - The TPU backward accumulated dq in a VMEM block revisited along a
//   sequential grid axis. CUDA blocks run in no order, so the backward is
//   two kernels with no atomics (dq, dk, dv bit-deterministic): dk/dv per
//   (b, KV head, 64-key tile), one warpgroup with K and V resident, walking
//   the group's query heads and the query tiles from the diagonal through a
//   cp.async ring of Q/dO tiles with their lse and delta (S^T = K Q^T, dP^T
//   = V dO^T, dV += P^T dO, dK += dS^T Q); and dq per (b, h, 128-query
//   tile), two warpgroups over a K/V ring (S = Q K^T, dP = dO V^T, dQ +=
//   dS K): seven products where a fused kernel with atomics would do five.
// - Each backward tile is taken in two halves of 32 (queries for dk/dv,
//   keys for dq), m64n32 score products feeding k-steps of the m64nD ones,
//   so only half the score registers are live: at D 64 that fits dk/dv in
//   168 registers (3 CTAs per SM) and dq in 128 (2 CTAs of two warpgroups)
//   with no spills. Within a half, the dP product runs while P's exp2 is
//   taken, and dV's while dS is formed (wgmma wait_group 1).
// - P and dS are rounded to bf16 before their products, as the TPU kernel
//   and the plain versions do; everything else is f32 until each output is
//   rounded once, into the [B, T, H, D] view the model reads.
// - The lane-broadcast lse of the TPU (128 lanes, 8 sublanes) was a Mosaic
//   tiling artefact: lse and delta are compact [B, H, T] f32 here.
//
// The f32 kernels (exact parity with the f32 plain versions and the JAX
// reference; TF32 would break it) do their products with f32 FMAs on the
// CUDA cores: one CTA per (b, h, 64-query tile) with 64-row f32 tiles in
// shared memory (row stride D + 4), 256 threads as a 16 x 16 grid each
// owning a 4 x 4 block of the score tile; the same two-kernel backward.
//
// Tensors may be strided views (the head dim contiguous, rows 16-byte
// aligned): the training path passes q, k, v as views of the fused qkv
// projection and takes o, dq, dk, dv in the [B, T, H, D] layout, with no
// transposing copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace {

constexpr int BQ = 64;   // query rows per tile (f32 kernels, bf16 dk/dv)
constexpr int BK = 64;   // key rows per tile
constexpr int NT = 256;  // f32 kernels' CTA: tx = tid % 16, ty = tid / 16
constexpr int LDP = BK + 4;  // row stride of the 64 x 64 f32 score tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

using bf16 = __nv_bfloat16;

constexpr int STAGES = 2;  // depth of the bf16 kernels' cp.async rings

struct Layout {  // element strides of a [B, H, T, D] view; D is contiguous
  long long b, h, t;
};

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  Layout lq, lk, lv, lo;
  int H, Hkv, T, causal;
  float scale;
};

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;  // [B, H, T] scratch: written by flash_bwd_delta
  void* dq;
  void* dk;
  void* dv;
  Layout lq, lk, lv, lo, ldo, ldq, ldk, ldv;
  int H, Hkv, T, causal;
  float scale;
};

// ============================================================ f32 kernels

// Four consecutive f32 values -> dst (one 16-byte store).
__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

// Rows row0..row0+63 of a [rows, D] f32 view (row stride st) -> shared
// tile [64][D + 4]; rows past the end are zero.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long st, int row0,
                                              int rows) {
  constexpr int PER_ROW = D / 4;
  constexpr int LD = D + 4;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows)
      val = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * st +
                                             c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

// s[i][j] = X[ty + 16 i] . Y[tx + 16 j] over D (X, Y: [64][D + 4] f32).
template <int D>
__device__ __forceinline__ void tile_xyT(const float* X, const float* Y,
                                         float s[4][4]) {
  constexpr int LD = D + 4;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(X + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(Y + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(x[i].x, y[j].x, s[i][j]);
        s[i][j] = fmaf(x[i].y, y[j].y, s[i][j]);
        s[i][j] = fmaf(x[i].z, y[j].z, s[i][j]);
        s[i][j] = fmaf(x[i].w, y[j].w, s[i][j]);
      }
  }
}

// acc[i][4 jj + e] += sum_c P[ty + 16 i][c] * Z[c][64 jj + 4 tx + e]
// (P: [64][LDP] f32, Z: [64][D + 4] f32).
template <int D>
__device__ __forceinline__ void tile_pz(const float* P, const float* Z,
                                        float acc[4][D / 16]) {
  constexpr int LD = D + 4;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int c = 0; c < BK; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * LDP + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int jj = 0; jj < D / 64; ++jj) {
        const float4 z = *reinterpret_cast<const float4*>(
            Z + (c + cc) * LD + jj * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = cc == 0 ? p[i].x
                           : cc == 1 ? p[i].y
                           : cc == 2 ? p[i].z
                                     : p[i].w;
          acc[i][jj * 4 + 0] = fmaf(pv, z.x, acc[i][jj * 4 + 0]);
          acc[i][jj * 4 + 1] = fmaf(pv, z.y, acc[i][jj * 4 + 1]);
          acc[i][jj * 4 + 2] = fmaf(pv, z.z, acc[i][jj * 4 + 2]);
          acc[i][jj * 4 + 3] = fmaf(pv, z.w, acc[i][jj * 4 + 3]);
        }
      }
    }
  }
}

// Rows ty + 16 i of a 64-row tile starting at row0 -> T, scaled by mul[i].
template <int D>
__device__ __forceinline__ void store_rows(float* dst, long long st, int row0,
                                           int rows, const float acc[4][D / 16],
                                           const float mul[4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj)
      store4(dst + (long long)r * st + jj * 64 + tx * 4,
                acc[i][jj * 4 + 0] * mul[i], acc[i][jj * 4 + 1] * mul[i],
                acc[i][jj * 4 + 2] * mul[i], acc[i][jj * 4 + 3] * mul[i]);
  }
}

__device__ __forceinline__ float row_max16(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 2));
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 4));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 8));
}

__device__ __forceinline__ float row_sum16(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  x += __shfl_xor_sync(FULL, x, 2);
  x += __shfl_xor_sync(FULL, x, 4);
  return x + __shfl_xor_sync(FULL, x, 8);
}

// ---------------------------------------------------------------- forward
// grid (B * H, ceil(T / BQ)); the heaviest (last) query tiles launch first.
template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_f32(FwdArgs a) {
  constexpr int LD = D + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int nq = (a.T + BQ - 1) / BQ, nk = (a.T + BK - 1) / BK;
  const int q0 = (nq - 1 - blockIdx.y) * BQ;
  const float* q = static_cast<const float*>(a.q) + b * a.lq.b + h * a.lq.h;
  const float* k = static_cast<const float*>(a.k) + b * a.lk.b + hk * a.lk.h;
  const float* v = static_cast<const float*>(a.v) + b * a.lv.b + hk * a.lv.h;
  float* o = static_cast<float*>(a.o) + b * a.lo.b + h * a.lo.h;
  const float s_scale = a.scale * LOG2E;

  load_tile_f32<D>(Qs, q, a.lq.t, q0, a.T);
  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < D / 16; ++n) acc[i][n] = 0.f;
  }
  const int k_end = a.causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  for (int ik = 0; ik < k_end; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();  // the previous tile's readers of Ks, Vs, Ps are done
    load_tile_f32<D>(Ks, k, a.lk.t, k0, a.T);
    load_tile_f32<D>(Vs, v, a.lv.t, k0, a.T);
    __syncthreads();
    float s[4][4];
    tile_xyT<D>(Qs, Ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool ok = c < a.T && (!a.causal || c <= r);
        s[i][j] = ok ? s[i][j] * s_scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + row_sum16(rs);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) acc[i][n] *= corr;
      m[i] = m_new;
    }
    __syncthreads();
    tile_pz<D>(Ps, Vs, acc);
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / li;
    const int r = q0 + ty + 16 * i;
    if (tx == 0 && r < a.T)
      a.lse[(long long)bh * a.T + r] = m[i] * LN2 + logf(li);
  }
  store_rows<D>(o, a.lo.t, q0, a.T, acc, inv);
}

// ------------------------------------------------------- backward: dk, dv
// grid (B * Hkv, ceil(T / BK)); key tile 0 (the longest causal loop) first.
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_f32(BwdArgs a) {
  constexpr int LD = D + 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* Ls = Ps + BK * LDP;
  float* Ds = Ls + BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int group = a.H / a.Hkv;
  const int b = blockIdx.x / a.Hkv, hk = blockIdx.x % a.Hkv;
  const int k0 = blockIdx.y * BK;
  const int nq = (a.T + BQ - 1) / BQ;
  const float s_scale = a.scale * LOG2E;
  const float* k = static_cast<const float*>(a.k) + b * a.lk.b + hk * a.lk.h;
  const float* v = static_cast<const float*>(a.v) + b * a.lv.b + hk * a.lv.h;
  load_tile_f32<D>(Ks, k, a.lk.t, k0, a.T);
  load_tile_f32<D>(Vs, v, a.lv.t, k0, a.T);
  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) dk[i][n] = dv[i][n] = 0.f;
  const int q_begin = a.causal ? k0 / BQ : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const float* q = static_cast<const float*>(a.q) + b * a.lq.b + h * a.lq.h;
    const float* dout =
        static_cast<const float*>(a.dout) + b * a.ldo.b + h * a.ldo.h;
    const long long row_base = ((long long)b * a.H + h) * a.T;
    for (int iq = q_begin; iq < nq; ++iq) {
      const int q0 = iq * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile_f32<D>(Qs, q, a.lq.t, q0, a.T);
      load_tile_f32<D>(dOs, dout, a.ldo.t, q0, a.T);
      if (threadIdx.x < BQ) {
        const int r = q0 + threadIdx.x;
        Ls[threadIdx.x] = r < a.T ? a.lse[row_base + r] * LOG2E : 0.f;
        Ds[threadIdx.x] = r < a.T ? a.delta[row_base + r] : 0.f;
      }
      __syncthreads();
      float pt[4][4], dst[4][4];  // P^T and dS^T: key ty + 16 i, query tx + 16 j
      tile_xyT<D>(Ks, Qs, pt);
      tile_xyT<D>(Vs, dOs, dst);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rr = tx + 16 * j, r = q0 + rr;
          const bool ok = r < a.T && c < a.T && (!a.causal || c <= r);
          const float p = ok ? exp2f(pt[i][j] * s_scale - Ls[rr]) : 0.f;
          pt[i][j] = p;
          dst[i][j] = p * (dst[i][j] - Ds[rr]) * a.scale;
          Ps[(ty + 16 * i) * LDP + rr] = p;
        }
      }
      __syncthreads();
      tile_pz<D>(Ps, dOs, dv);  // dv += P^T dO
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ps[(ty + 16 * i) * LDP + tx + 16 * j] = dst[i][j];
      __syncthreads();
      tile_pz<D>(Ps, Qs, dk);  // dk += dS^T Q
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(static_cast<float*>(a.dk) + b * a.ldk.b + hk * a.ldk.h,
                   a.ldk.t, k0, a.T, dk, one);
  store_rows<D>(static_cast<float*>(a.dv) + b * a.ldv.b + hk * a.ldv.h,
                   a.ldv.t, k0, a.T, dv, one);
}

// ----------------------------------------------------------- backward: dq
// grid (B * H, ceil(T / BQ)); the heaviest (last) query tiles first.
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_f32(BwdArgs a) {
  constexpr int LD = D + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  float* Ls = Ps + BQ * LDP;
  float* Ds = Ls + BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int nq = (a.T + BQ - 1) / BQ, nk = (a.T + BK - 1) / BK;
  const int q0 = (nq - 1 - blockIdx.y) * BQ;
  const float s_scale = a.scale * LOG2E;
  const float* q = static_cast<const float*>(a.q) + b * a.lq.b + h * a.lq.h;
  const float* dout =
      static_cast<const float*>(a.dout) + b * a.ldo.b + h * a.ldo.h;
  const float* k = static_cast<const float*>(a.k) + b * a.lk.b + hk * a.lk.h;
  const float* v = static_cast<const float*>(a.v) + b * a.lv.b + hk * a.lv.h;
  load_tile_f32<D>(Qs, q, a.lq.t, q0, a.T);
  load_tile_f32<D>(dOs, dout, a.ldo.t, q0, a.T);
  if (threadIdx.x < BQ) {
    const int r = q0 + threadIdx.x;
    const long long i = (long long)bh * a.T + r;
    Ls[threadIdx.x] = r < a.T ? a.lse[i] * LOG2E : 0.f;
    Ds[threadIdx.x] = r < a.T ? a.delta[i] : 0.f;
  }
  float dq[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) dq[i][n] = 0.f;
  const int k_end = a.causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  for (int ik = 0; ik < k_end; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();
    load_tile_f32<D>(Ks, k, a.lk.t, k0, a.T);
    load_tile_f32<D>(Vs, v, a.lv.t, k0, a.T);
    __syncthreads();
    float s[4][4], dp[4][4];  // query ty + 16 i, key tx + 16 j
    tile_xyT<D>(Qs, Ks, s);
    tile_xyT<D>(dOs, Vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = ty + 16 * i, r = q0 + rr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool ok = r < a.T && c < a.T && (!a.causal || c <= r);
        const float p = ok ? exp2f(s[i][j] * s_scale - Ls[rr]) : 0.f;
        Ps[rr * LDP + tx + 16 * j] = p * (dp[i][j] - Ds[rr]) * a.scale;
      }
    }
    __syncthreads();
    tile_pz<D>(Ps, Ks, dq);  // dq += dS K
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(static_cast<float*>(a.dq) + b * a.ldq.b + h * a.ldq.h,
                   a.ldq.t, q0, a.T, dq, one);
}

template <int D>
constexpr size_t fwd_smem() {
  return (size_t)(BQ * (D + 4) + 2 * BK * (D + 4) + BQ * LDP) * sizeof(float);
}

template <int D>
constexpr size_t bwd_smem() {
  return (size_t)(2 * BQ * (D + 4) + 2 * BK * (D + 4) + BQ * LDP + 2 * BQ) *
         sizeof(float);
}

// ================================================ the delta pass (both dtypes)
// delta[row] = sum_d o[row, d] * do[row, d] in f32 over rows (b, h, t) in
// [B, H, T] order; D / V threads per row (V values in 16 bytes).
template <typename T, int D>
__global__ void __launch_bounds__(256) flash_bwd_delta(BwdArgs a, int rows) {
  constexpr int V = 16 / sizeof(T), TPR = D / V, RPB = 256 / TPR;
  const int row = blockIdx.x * RPB + threadIdx.x / TPR;
  const int c = (threadIdx.x % TPR) * V;
  float acc = 0.f;
  if (row < rows) {
    const int bh = row / a.T, t = row % a.T, b = bh / a.H, h = bh % a.H;
    const uint4 x = *reinterpret_cast<const uint4*>(
        static_cast<const T*>(a.o) + b * a.lo.b + h * a.lo.h + t * a.lo.t + c);
    const uint4 y = *reinterpret_cast<const uint4*>(
        static_cast<const T*>(a.dout) + b * a.ldo.b + h * a.ldo.h +
        t * a.ldo.t + c);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        acc = fmaf(__uint_as_float(xs[i]), __uint_as_float(ys[i]), acc);
      } else {
        const float2 xf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
        const float2 yf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
        acc = fmaf(xf.x, yf.x, acc);
        acc = fmaf(xf.y, yf.y, acc);
      }
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (threadIdx.x % TPR == 0 && row < rows) a.delta[row] = acc;
}

// ====================================================== bf16 kernels (sm90)
// Shared memory: bf16 tiles of 64 rows x D (TILE bytes) in flash_sm90.cuh's
// layout, from a 1024-byte-aligned base (one spare KB in the allocation).

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return 64 * D * 2;
}

__device__ __forceinline__ uint32_t aligned_base(const uint8_t* smem) {
  return (sm90::smem_u32(smem) + 1023u) & ~1023u;
}

// Thread t of warpgroup w's fragment rows (see flash_sm90.cuh): rows
// 16 (warp % 4) + t / 4 + 8 half of the warpgroup's 64; column 8 j + 2 (t % 4)
// + e of the 64 for fragment index i = 4 j + 2 half + e.
__device__ __forceinline__ int frag_row() {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
}

__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// Rows r0 and r0 + 8 of an m64nD accumulator -> bf16 rows of a [rows, D]
// view (row stride st), scaled by mul[half]; rows at or past `rows` skipped.
template <int D>
__device__ __forceinline__ void store_frag(bf16* dst, long long st, int r0,
                                           int rows, const float (&acc)[D / 2],
                                           const float (&mul)[2]) {
  const int c = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)r * st + 8 * j + c) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] * mul[half],
                                acc[4 * j + 2 * half + 1] * mul[half]);
  }
}

// ---------------------------------------------------------------- forward
// grid (B * H, ceil(T / 128)), 256 threads: warpgroup w owns query rows
// q0 + 64 w .. + 63. Shared: Q (128 rows), then STAGES stages of (K, V).
template <int D>
__global__ void __launch_bounds__(256) flash_fwd_sm90(FwdArgs a) {
  using namespace sm90;
  constexpr int TILE = tile_bytes<D>();
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t Qs = aligned_base(smem), KVs = Qs + 2 * TILE;
  const int wg = threadIdx.x >> 7;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int nq = (a.T + 127) / 128, nk = (a.T + BK - 1) / BK;
  const int q0 = (nq - 1 - blockIdx.y) * 128;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.lq.b + h * a.lq.h;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.lk.b + hk * a.lk.h;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.lv.b + hk * a.lv.h;
  const int n_tiles = a.causal ? min(nk, (q0 + 127) / BK + 1) : nk;

  auto fetch = [&](int tile) {  // K/V tile `tile` into its stage
    if (tile >= n_tiles) return;
    const uint32_t dst = KVs + (tile % STAGES) * 2 * TILE;
    load_tile<64, D, 256>(dst, k, a.lk.t, tile * BK, a.T);
    load_tile<64, D, 256>(dst + TILE, v, a.lv.t, tile * BK, a.T);
  };
  load_tile<128, D, 256>(Qs, q, a.lq.t, q0, a.T);
  for (int tile = 0; tile < STAGES - 1; ++tile) {
    fetch(tile);
    cp_async_commit();
  }

  const int w0 = q0 + 64 * wg;  // this warpgroup's first query row
  const int r0 = w0 + frag_row();
  // Key tiles this warpgroup reads: none past its last row's diagonal.
  const int my_tiles =
      w0 >= a.T ? 0 : a.causal ? min(n_tiles, (w0 + 63) / BK + 1) : n_tiles;
  const uint32_t q_wg = Qs + wg * 64 * 128;
  const float s_scale = a.scale * LOG2E;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // tile it has landed; all reads of tile it - 1 are done
    fetch(it + STAGES - 1);  // into the stage tile it - 1 used
    cp_async_commit();
    if (it >= my_tiles) continue;
    const uint32_t Ks = KVs + (it % STAGES) * 2 * TILE, Vs = Ks + TILE;
    const int k0 = it * BK;

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_k<128>(q_wg, kk), desc_k<64>(Ks, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(s);

    const bool edge = k0 + BK > a.T || (a.causal && k0 + BK - 1 > w0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int half = (i >> 1) & 1;
      float x = s[i] * s_scale;
      if (edge) {
        const int c = k0 + frag_col(i), r = r0 + 8 * half;
        if (c >= a.T || (a.causal && c > r)) x = NEG_INF;
      }
      s[i] = x;
      mx[half] = fmaxf(mx[half], x);
    }
    float corr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = quad_max(mx[half]);
      corr[half] = ex2(m[half] - mx[half]);
      m[half] = mx[half];
      l[half] *= corr[half];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = ex2(s[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += s[i];  // this thread's share; summed over 4 at the end
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(s, kk, pf[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(o, pf[kk], desc_mn<64>(Vs, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(o);
  }
  if (w0 >= a.T) return;
  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float li = fmaxf(quad_sum(l[half]), 1e-30f);
    inv[half] = 1.f / li;
    const int r = r0 + 8 * half;
    if ((threadIdx.x & 3) == 0 && r < a.T)
      a.lse[(long long)bh * a.T + r] = m[half] * LN2 + logf(li);
  }
  store_frag<D>(static_cast<bf16*>(a.o) + b * a.lo.b + h * a.lo.h, a.lo.t, r0,
                a.T, o, inv);
}

// ------------------------------------------------------- backward: dk, dv
// grid (B * Hkv, ceil(T / 64)), 128 threads (one warpgroup); key tile 0 (the
// longest causal loop) first. Shared: K, V (resident), then STAGES stages of
// (Q, dO), then STAGES stages of (lse, delta) as 64 f32 each. At D 64, 3
// CTAs per SM (<= 168 registers).
template <int D>
__global__ void __launch_bounds__(128, D == 64 ? 3 : 1)
    flash_bwd_dkdv_sm90(BwdArgs a) {
  using namespace sm90;
  constexpr int TILE = tile_bytes<D>();
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t Ks = aligned_base(smem), Vs = Ks + TILE;
  const uint32_t QDs = Ks + 2 * TILE, LDs = QDs + STAGES * 2 * TILE;
  const float* ld_gen =
      reinterpret_cast<const float*>(smem + (LDs - smem_u32(smem)));
  const int group = a.H / a.Hkv;
  const int b = blockIdx.x / a.Hkv, hk = blockIdx.x % a.Hkv;
  const int k0 = blockIdx.y * BK;
  const int nq = (a.T + BQ - 1) / BQ;
  const int q_begin = a.causal ? k0 / BQ : 0, per_head = nq - q_begin;
  const int n_iter = group * per_head;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.lk.b + hk * a.lk.h;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.lv.b + hk * a.lv.h;

  // Q/dO tiles, lse and delta of iteration it (query head hk * group +
  // it / per_head, query tile q_begin + it % per_head) into its stage.
  auto fetch = [&](int it) {
    if (it >= n_iter) return;
    const int st = it % STAGES;
    const int h = hk * group + it / per_head;
    const int q0 = (q_begin + it % per_head) * BQ;
    const uint32_t dst = QDs + st * 2 * TILE;
    load_tile<64, D, 128>(
        dst, static_cast<const bf16*>(a.q) + b * a.lq.b + h * a.lq.h, a.lq.t,
        q0, a.T);
    load_tile<64, D, 128>(
        dst + TILE,
        static_cast<const bf16*>(a.dout) + b * a.ldo.b + h * a.ldo.h, a.ldo.t,
        q0, a.T);
    const int t = threadIdx.x & 63, r = q0 + t;
    const long long row = ((long long)b * a.H + h) * a.T + (r < a.T ? r : 0);
    cp_async4(LDs + st * 512 + threadIdx.x * 4,
              threadIdx.x < 64 ? a.lse + row : a.delta + row, r < a.T);
  };

  load_tile<64, D, 128>(Ks, k, a.lk.t, k0, a.T);
  load_tile<64, D, 128>(Vs, v, a.lv.t, k0, a.T);
  for (int it = 0; it < STAGES - 1; ++it) {
    fetch(it);
    cp_async_commit();
  }

  const int c0 = k0 + frag_row();  // fragment rows (keys) c0 and c0 + 8
  const float s_scale = a.scale * LOG2E;
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // iteration it has landed; it - 1's stage is free
    fetch(it + STAGES - 1);
    cp_async_commit();
    const int st = it % STAGES;
    const uint32_t Qt = QDs + st * 2 * TILE, dOt = Qt + TILE;
    const float* lse = ld_gen + st * 128;
    const float* delta = lse + 64;
    const int q0 = (q_begin + it % per_head) * BQ;

    const bool edge =
        q0 + BQ > a.T || k0 + BK > a.T || (a.causal && q0 < k0 + BK);
    // Two halves of 32 queries: half the score registers live at a time.
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float sT[16], dpT[16];  // S^T and dP^T: key rows, query columns
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n32(sT, desc_k<64>(Ks, kk),
                     desc_k<64>(Qt + hf * 32 * 128, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n32(dpT, desc_k<64>(Vs, kk),
                     desc_k<64>(dOt + hf * 32 * 128, kk), kk);
      wgmma_commit();
      wgmma_wait<1>();  // S^T is done; dP^T may still run
      fence_operand(sT);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = 32 * hf + frag_col(i), r = q0 + col;
        const int c = c0 + 8 * ((i >> 1) & 1);
        const bool ok =
            !edge || (r < a.T && c < a.T && (!a.causal || c <= r));
        sT[i] = ok ? ex2(sT[i] * s_scale - lse[col] * LOG2E) : 0.f;
      }
      uint32_t pf[2][4], df[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) a_frag(sT, kk, pf[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)  // dV += P^T dO
        wgmma_rs<D>(dv, pf[kk], desc_mn<64>(dOt, 2 * hf + kk), 1);
      wgmma_commit();
      wgmma_wait<1>();  // dP^T is done; dV may still run
      fence_operand(dpT);
#pragma unroll
      for (int i = 0; i < 16; ++i)  // dS^T
        dpT[i] = sT[i] * (dpT[i] - delta[32 * hf + frag_col(i)]) * a.scale;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) a_frag(dpT, kk, df[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)  // dK += dS^T Q
        wgmma_rs<D>(dk, df[kk], desc_mn<64>(Qt, 2 * hf + kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(dv);
      fence_operand(dk);
    }
  }
  const float one[2] = {1.f, 1.f};
  store_frag<D>(static_cast<bf16*>(a.dk) + b * a.ldk.b + hk * a.ldk.h,
                a.ldk.t, c0, a.T, dk, one);
  store_frag<D>(static_cast<bf16*>(a.dv) + b * a.ldv.b + hk * a.ldv.h,
                a.ldv.t, c0, a.T, dv, one);
}

// ----------------------------------------------------------- backward: dq
// grid (B * H, ceil(T / 128)), 256 threads: warpgroup w owns query rows
// q0 + 64 w .. + 63; the heaviest query tiles first. Shared: Q and dO (128
// rows each), then STAGES stages of (K, V). At D 64, 2 CTAs per SM (<= 128
// registers).
template <int D>
__global__ void __launch_bounds__(256, D == 64 ? 2 : 1)
    flash_bwd_dq_sm90(BwdArgs a) {
  using namespace sm90;
  constexpr int TILE = tile_bytes<D>();
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t Qs = aligned_base(smem), dOs = Qs + 2 * TILE;
  const uint32_t KVs = Qs + 4 * TILE;
  const int wg = threadIdx.x >> 7;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int nq = (a.T + 127) / 128, nk = (a.T + BK - 1) / BK;
  const int q0 = (nq - 1 - blockIdx.y) * 128;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.lk.b + hk * a.lk.h;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.lv.b + hk * a.lv.h;
  const int n_tiles = a.causal ? min(nk, (q0 + 127) / BK + 1) : nk;

  load_tile<128, D, 256>(
      Qs, static_cast<const bf16*>(a.q) + b * a.lq.b + h * a.lq.h, a.lq.t, q0,
      a.T);
  load_tile<128, D, 256>(
      dOs, static_cast<const bf16*>(a.dout) + b * a.ldo.b + h * a.ldo.h,
      a.ldo.t, q0, a.T);
  auto fetch = [&](int tile) {  // K/V tile `tile` into its stage
    if (tile >= n_tiles) return;
    const uint32_t dst = KVs + (tile % STAGES) * 2 * TILE;
    load_tile<64, D, 256>(dst, k, a.lk.t, tile * BK, a.T);
    load_tile<64, D, 256>(dst + TILE, v, a.lv.t, tile * BK, a.T);
  };
  for (int tile = 0; tile < STAGES - 1; ++tile) {
    fetch(tile);
    cp_async_commit();
  }

  const int w0 = q0 + 64 * wg;
  const int r0 = w0 + frag_row();
  const int my_tiles =
      w0 >= a.T ? 0 : a.causal ? min(n_tiles, (w0 + 63) / BK + 1) : n_tiles;
  const uint32_t q_wg = Qs + wg * 64 * 128, do_wg = dOs + wg * 64 * 128;
  const float s_scale = a.scale * LOG2E;
  float lse2[2], dl[2];  // lse * log2(e) and delta of rows r0, r0 + 8
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    const long long i = (long long)bh * a.T + r;
    lse2[half] = r < a.T ? a.lse[i] * LOG2E : 0.f;
    dl[half] = r < a.T ? a.delta[i] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    fetch(it + STAGES - 1);
    cp_async_commit();
    if (it >= my_tiles) continue;
    const uint32_t Ks = KVs + (it % STAGES) * 2 * TILE, Vs = Ks + TILE;
    const int k0 = it * BK;

    const bool edge = k0 + BK > a.T || (a.causal && k0 + BK - 1 > w0);
    // Two halves of 32 keys: half the score registers live at a time.
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float s[16], dp[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n32(s, desc_k<128>(q_wg, kk),
                     desc_k<64>(Ks + hf * 32 * 128, kk), kk);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n32(dp, desc_k<128>(do_wg, kk),
                     desc_k<64>(Vs + hf * 32 * 128, kk), kk);
      wgmma_commit();
      wgmma_wait<1>();  // S is done; dP may still run
      fence_operand(s);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int half = (i >> 1) & 1;
        const int c = k0 + 32 * hf + frag_col(i), r = r0 + 8 * half;
        const bool ok = !edge || (c < a.T && (!a.causal || c <= r));
        s[i] = ok ? ex2(s[i] * s_scale - lse2[half]) : 0.f;  // P
      }
      wgmma_wait<0>();
      fence_operand(dp);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        s[i] = s[i] * (dp[i] - dl[(i >> 1) & 1]) * a.scale;  // dS
      uint32_t df[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) a_frag(s, kk, df[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)  // dQ += dS K
        wgmma_rs<D>(dq, df[kk], desc_mn<64>(Ks, 2 * hf + kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(dq);
    }
  }
  const float one[2] = {1.f, 1.f};
  store_frag<D>(static_cast<bf16*>(a.dq) + b * a.ldq.b + h * a.ldq.h, a.ldq.t,
                r0, a.T, dq, one);
}

// =============================================================== launches

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
int launch_fwd_f32(const FwdArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<D>();
  if (int err = set_smem(flash_fwd_f32<D>, smem)) return err;
  const dim3 grid(B * a.H, (a.T + BQ - 1) / BQ);
  flash_fwd_f32<D><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fwd_sm90(const FwdArgs& a, int B, cudaStream_t stream) {
  // Q (2 tiles), STAGES x (K, V), a spare KB for the 1024-byte alignment
  constexpr size_t smem = (2 + 2 * STAGES) * tile_bytes<D>() + 1024;
  if (int err = set_smem(flash_fwd_sm90<D>, smem)) return err;
  const dim3 grid(B * a.H, (a.T + 127) / 128);
  flash_fwd_sm90<D><<<grid, 256, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_delta(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int rows_per_block = 256 / (D * (int)sizeof(T) / 16);
  const int rows = B * a.H * a.T;
  flash_bwd_delta<T, D><<<(rows + rows_per_block - 1) / rows_per_block, 256,
                          0, stream>>>(a, rows);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_f32(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem<D>();
  if (int err = set_smem(flash_bwd_dkdv_f32<D>, smem)) return err;
  if (int err = set_smem(flash_bwd_dq_f32<D>, smem)) return err;
  if (int err = launch_delta<float, D>(a, B, stream)) return err;
  const dim3 grid_kv(B * a.Hkv, (a.T + BK - 1) / BK);
  flash_bwd_dkdv_f32<D><<<grid_kv, NT, smem, stream>>>(a);
  if (int err = (int)cudaGetLastError()) return err;
  const dim3 grid_q(B * a.H, (a.T + BQ - 1) / BQ);
  flash_bwd_dq_f32<D><<<grid_q, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_sm90(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr int TILE = tile_bytes<D>();
  // dk/dv: K, V, STAGES x (Q, dO), STAGES x (lse, delta); dq: Q, dO (2
  // tiles each), STAGES x (K, V); each with a spare KB for the alignment.
  constexpr size_t smem_kv = (2 + 2 * STAGES) * TILE + STAGES * 512 + 1024;
  constexpr size_t smem_q = (4 + 2 * STAGES) * TILE + 1024;
  if (int err = set_smem(flash_bwd_dkdv_sm90<D>, smem_kv)) return err;
  if (int err = set_smem(flash_bwd_dq_sm90<D>, smem_q)) return err;
  if (int err = launch_delta<bf16, D>(a, B, stream)) return err;
  const dim3 grid_kv(B * a.Hkv, (a.T + BK - 1) / BK);
  flash_bwd_dkdv_sm90<D><<<grid_kv, 128, smem_kv, stream>>>(a);
  if (int err = (int)cudaGetLastError()) return err;
  const dim3 grid_q(B * a.H, (a.T + 127) / 128);
  flash_bwd_dq_sm90<D><<<grid_q, 256, smem_q, stream>>>(a);
  return (int)cudaGetLastError();
}

Layout layout_at(const long long* s, int i) {
  return Layout{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

constexpr int kUnsupported = -1;

}  // namespace

// strides: (b, h, t) element strides of q, k, v, o, in that order (12 values).
// dtype 0 = float32, 1 = bfloat16. Returns 0, a cudaError_t, or -1 for a
// dtype / head_dim the kernel does not take.
extern "C" int pdt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, const long long* strides,
                             int B, int H, int Hkv, int T, int D, int dtype,
                             int causal, float scale, void* stream) {
  FwdArgs a{q, k, v, o, lse,
            layout_at(strides, 0), layout_at(strides, 1),
            layout_at(strides, 2), layout_at(strides, 3),
            H, Hkv, T, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_fwd_f32<64>(a, B, s);
  if (dtype == 0 && D == 128) return launch_fwd_f32<128>(a, B, s);
  if (dtype == 1 && D == 64) return launch_fwd_sm90<64>(a, B, s);
  if (dtype == 1 && D == 128) return launch_fwd_sm90<128>(a, B, s);
  return kUnsupported;
}

// strides: (b, h, t) of q, k, v, o, do, dq, dk, dv, in that order (24
// values). delta: a [B, H, T] f32 scratch buffer the backward fills first.
extern "C" int pdt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const float* lse, float* delta, void* dq,
                             void* dk, void* dv, const long long* strides,
                             int B, int H, int Hkv, int T, int D, int dtype,
                             int causal, float scale, void* stream) {
  BwdArgs a{q, k, v, o, dout, lse, delta, dq, dk, dv,
            layout_at(strides, 0), layout_at(strides, 1),
            layout_at(strides, 2), layout_at(strides, 3),
            layout_at(strides, 4), layout_at(strides, 5),
            layout_at(strides, 6), layout_at(strides, 7),
            H, Hkv, T, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_bwd_f32<64>(a, B, s);
  if (dtype == 0 && D == 128) return launch_bwd_f32<128>(a, B, s);
  if (dtype == 1 && D == 64) return launch_bwd_sm90<64>(a, B, s);
  if (dtype == 1 && D == 128) return launch_bwd_sm90<128>(a, B, s);
  return kUnsupported;
}
