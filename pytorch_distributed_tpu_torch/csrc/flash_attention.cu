// Flash attention for Hopper (sm_90a): the forward (K1) and the backward
// (K2) of the port's training path.
//
// Replaces the Pallas TPU kernels of pytorch_distributed_tpu/ops/flash_kernel.py:
//   K1 _fwd_kernel (:92)  -> flash_fwd_kernel
//   K2 _bwd_kernel (:221) -> flash_bwd_dkdv_kernel + flash_bwd_dq_kernel
//
// What it computes (the same function as the TPU kernels): softmax attention
// over q [B, H, T, D] and k, v [B, Hkv, T, D] (query head h reads KV head
// h / (H / Hkv)), causal (key c <= query r) or not, with the online softmax
// in base 2 (scores scaled by scale * log2(e)) and NEG_INF = -1e30 as the
// finite mask value. The forward writes o in q's dtype and the natural-log
// logsumexp lse [B, H, T] f32. The backward reads q, k, v, do, lse and
// delta = rowsum(o * do) (f32, computed by the wrapper) and writes dq in q's
// dtype and dk, dv [B, Hkv, T, D] in k's dtype, summed over each KV head's
// query-head group inside the kernel.
//
// What bounds it on this card: at the training shape (B=8, H=12, T=1024,
// D=64, causal, bf16) K1 is bound by its bytes (~15 us for q, k, v, o and
// lse at 3.35 TB/s) and K2 by its operations (~33 us for five causal
// products at 989 TFLOP/s on the tensor cores). This first kernel does its
// products with f32 FMAs on the CUDA cores (67 TFLOP/s), so it sits far
// above both bounds; it is written to be right and simple first.
//
// Design, and what it does about the TPU kernel's layout:
// - The TPU forward kept one head's whole K and V resident in VMEM; a CTA
//   here has at most 227 KB of shared memory, so K/V stream through it in
//   64-row tiles, FlashAttention-2 style: one CTA per (b, h, 64-query tile),
//   looping over key tiles up to the diagonal (causal). Tiles are held in
//   shared memory as f32 (row stride D + 4, so 16-byte reads of 16 rows by
//   16 lanes hit distinct banks); 256 threads as a 16 x 16 grid each own a
//   4 x 4 block of the score tile and 4 rows of the output.
// - The TPU backward accumulated dq in a VMEM block revisited along a
//   sequential grid axis. CUDA blocks run in no order, so the backward is two
//   kernels with no atomics (deterministic): dk/dv per (b, KV head, key tile)
//   looping over the group's query heads and the query tiles from the
//   diagonal, and dq per (b, h, query tile) looping over key tiles up to the
//   diagonal, recomputing the scores (seven tile products instead of five).
// - The lane-broadcast lse of the TPU (128 lanes, 8 sublanes) was a Mosaic
//   tiling artefact: lse and delta are compact [B, H, T] f32 here.
// - Any T >= 1: rows and keys past T are zero-filled on load and masked.
// - Tensors may be strided views (the head dim contiguous): the training
//   path passes q, k, v as views of the fused qkv projection and takes o,
//   dq, dk, dv in the [B, T, H, D] layout, with no transposing copies.
// - Softmax weights and dS stay in f32 (the TPU kernel rounds them to the
//   input dtype before its products); outputs are rounded once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // key rows per tile
constexpr int NT = 256;  // threads per CTA: tx = tid % 16, ty = tid / 16
constexpr int LDP = BK + 4;  // row stride of the 64 x 64 score tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

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
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  Layout lq, lk, lv, ldo, ldq, ldk, ldv;
  int H, Hkv, T, causal;
  float scale;
};

// 16 bytes of T -> f32 values.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* out) {
  if constexpr (sizeof(T) == 4) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  } else {  // 8 bf16: the low half of each word is the first element
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Four consecutive f32 values -> T at dst (16-byte or 8-byte store).
template <typename T>
__device__ __forceinline__ void store4(T* dst, float a, float b, float c,
                                       float d) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
    __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = u;
  }
}

// Rows row0..row0+63 of a [rows, D] view (row stride st) -> f32 shared
// tile [64][D + 4]; rows past the end are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long st, int row0, int rows) {
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = D / V;
  constexpr int LD = D + 4;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * V;
    float vals[V];
    if (row0 + r < rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + (long long)(row0 + r) * st + c);
      unpack<T>(raw, vals);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) vals[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(dst + r * LD + c + j) =
          make_float4(vals[j], vals[j + 1], vals[j + 2], vals[j + 3]);
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
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, long long st, int row0,
                                           int rows, const float acc[4][D / 16],
                                           const float mul[4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj)
      store4<T>(dst + (long long)r * st + jj * 64 + tx * 4,
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
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(FwdArgs a) {
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
  const T* q = static_cast<const T*>(a.q) + b * a.lq.b + h * a.lq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.lk.b + hk * a.lk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.lv.b + hk * a.lv.h;
  T* o = static_cast<T*>(a.o) + b * a.lo.b + h * a.lo.h;
  const float s_scale = a.scale * LOG2E;

  load_tile<T, D>(Qs, q, a.lq.t, q0, a.T);
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
    load_tile<T, D>(Ks, k, a.lk.t, k0, a.T);
    load_tile<T, D>(Vs, v, a.lv.t, k0, a.T);
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
  store_rows<T, D>(o, a.lo.t, q0, a.T, acc, inv);
}

// ------------------------------------------------------- backward: dk, dv
// grid (B * Hkv, ceil(T / BK)); key tile 0 (the longest causal loop) first.
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(BwdArgs a) {
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
  const T* k = static_cast<const T*>(a.k) + b * a.lk.b + hk * a.lk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.lv.b + hk * a.lv.h;
  load_tile<T, D>(Ks, k, a.lk.t, k0, a.T);
  load_tile<T, D>(Vs, v, a.lv.t, k0, a.T);
  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) dk[i][n] = dv[i][n] = 0.f;
  const int q_begin = a.causal ? k0 / BQ : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* q = static_cast<const T*>(a.q) + b * a.lq.b + h * a.lq.h;
    const T* dout = static_cast<const T*>(a.dout) + b * a.ldo.b + h * a.ldo.h;
    const long long row_base = ((long long)b * a.H + h) * a.T;
    for (int iq = q_begin; iq < nq; ++iq) {
      const int q0 = iq * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(Qs, q, a.lq.t, q0, a.T);
      load_tile<T, D>(dOs, dout, a.ldo.t, q0, a.T);
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
  store_rows<T, D>(static_cast<T*>(a.dk) + b * a.ldk.b + hk * a.ldk.h,
                   a.ldk.t, k0, a.T, dk, one);
  store_rows<T, D>(static_cast<T*>(a.dv) + b * a.ldv.b + hk * a.ldv.h,
                   a.ldv.t, k0, a.T, dv, one);
}

// ----------------------------------------------------------- backward: dq
// grid (B * H, ceil(T / BQ)); the heaviest (last) query tiles first.
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(BwdArgs a) {
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
  const T* q = static_cast<const T*>(a.q) + b * a.lq.b + h * a.lq.h;
  const T* dout = static_cast<const T*>(a.dout) + b * a.ldo.b + h * a.ldo.h;
  const T* k = static_cast<const T*>(a.k) + b * a.lk.b + hk * a.lk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.lv.b + hk * a.lv.h;
  load_tile<T, D>(Qs, q, a.lq.t, q0, a.T);
  load_tile<T, D>(dOs, dout, a.ldo.t, q0, a.T);
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
    load_tile<T, D>(Ks, k, a.lk.t, k0, a.T);
    load_tile<T, D>(Vs, v, a.lv.t, k0, a.T);
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
  store_rows<T, D>(static_cast<T*>(a.dq) + b * a.ldq.b + h * a.ldq.h,
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

template <typename T, int D>
int launch_fwd(const FwdArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * a.H, (a.T + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_bwd(const BwdArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv(B * a.Hkv, (a.T + BK - 1) / BK);
  flash_bwd_dkdv_kernel<T, D><<<grid_kv, NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q(B * a.H, (a.T + BQ - 1) / BQ);
  flash_bwd_dq_kernel<T, D><<<grid_q, NT, smem, stream>>>(a);
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
  if (dtype == 0 && D == 64) return launch_fwd<float, 64>(a, B, s);
  if (dtype == 0 && D == 128) return launch_fwd<float, 128>(a, B, s);
  if (dtype == 1 && D == 64) return launch_fwd<__nv_bfloat16, 64>(a, B, s);
  if (dtype == 1 && D == 128) return launch_fwd<__nv_bfloat16, 128>(a, B, s);
  return kUnsupported;
}

// strides: (b, h, t) of q, k, v, do, dq, dk, dv, in that order (21 values).
extern "C" int pdt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dq, void* dk, void* dv,
                             const long long* strides, int B, int H, int Hkv,
                             int T, int D, int dtype, int causal, float scale,
                             void* stream) {
  BwdArgs a{q, k, v, dout, lse, delta, dq, dk, dv,
            layout_at(strides, 0), layout_at(strides, 1),
            layout_at(strides, 2), layout_at(strides, 3),
            layout_at(strides, 4), layout_at(strides, 5),
            layout_at(strides, 6),
            H, Hkv, T, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_bwd<float, 64>(a, B, s);
  if (dtype == 0 && D == 128) return launch_bwd<float, 128>(a, B, s);
  if (dtype == 1 && D == 64) return launch_bwd<__nv_bfloat16, 64>(a, B, s);
  if (dtype == 1 && D == 128) return launch_bwd<__nv_bfloat16, 128>(a, B, s);
  return kUnsupported;
}
