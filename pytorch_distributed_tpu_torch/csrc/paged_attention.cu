// Paged single-query decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel pytorch_distributed_tpu/ops/paged_kernel.py:
// _paged_kernel (launched by _paged_call, entry paged_decode_attention).
// One query token per batch row attends over that row's keys 0..lengths[b]
// (inclusive), which live in fixed-size pages of a shared pool
// [P, page, Hkv, D] addressed through block_tables [B, n_pages].
//
// What bounds it: device-memory bytes. Each query head does 2 flops per
// key element read, far below the ~295 operations per byte where H100's
// arithmetic would become the limit, so the least time is the bytes of
// the row's valid K/V pages (plus q and o) over 3.35 TB/s. The design
// answers that by reading each K/V byte once and only the bytes a row
// needs:
//
//  - one CTA per (KV head, row): the query-head group that shares the KV
//    head (group = H / Hkv, grouped-query attention) is computed in the
//    same CTA, so K/V are read once per group, never repeated per head;
//  - the CTA walks only keys 0..lengths[b]: pages past a row's depth are
//    never touched (the TPU kernel skipped them with pl.when);
//  - the CTA reads its own block-table entries (the TPU kernel received
//    them by scalar prefetch);
//  - the sequential page grid dimension of the TPU kernel becomes a loop:
//    the CTA's warps take interleaved runs of UNROLL consecutive tokens,
//    loading all UNROLL K and V rows before reducing, so several loads are
//    in flight per warp; a warp's 32 lanes span D (D/32 elements per lane,
//    one vector load per row), and a butterfly shuffle gives every lane
//    q.k for each query head of the group;
//  - each warp keeps its own online softmax (running max m, sum l and the
//    f32 accumulator) per query head; the warps' partial states are merged
//    through shared memory at the end, the same (m, l, acc) algebra.
//
// All accumulation is f32 whatever the storage type (bf16 or f32); the
// output is written in q's type. Page ids outside [0, P) are clamped into
// the pool, as a JAX gather clamps them, so the kernel never reads out of
// bounds. Known limit of this first version: at small batch the grid is
// only B * Hkv CTAs (GPT-2 124M with 8 rows: 96 CTAs on 132 SMs), so the
// card is not filled; splitting a row's pages across CTAs (flash-decoding)
// is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;
constexpr float kNegInf = -1e30f;  // finite, as the TPU kernel's NEG_INF

template <typename T, int E>
struct Vec;

template <>
struct Vec<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x;
    o[1] = v.y;
  }
};

template <>
struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* o) {
    float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* o) {
    float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = v.x;
    o[1] = v.y;
  }
};

template <>
struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* o) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
    float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
    o[0] = a.x;
    o[1] = a.y;
    o[2] = b.x;
    o[3] = b.y;
  }
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// grid (Hkv, B), block kWarps * 32 threads.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q,        // [B, H, D]
                    const T* __restrict__ k_pages,  // [P, page, Hkv, D]
                    const T* __restrict__ v_pages,  // [P, page, Hkv, D]
                    const int32_t* __restrict__ tables,   // [B, n_pages]
                    const int32_t* __restrict__ lengths,  // [B]
                    T* __restrict__ out,                  // [B, H, D]
                    int hkv, int n_pool, int page, int n_pages, float scale) {
  constexpr int E = D / 32;  // elements of a row each lane holds
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int H = hkv * G;

  // Keys 0..lengths[b] are valid, capped at the table's extent.
  int n_tok = lengths[b] + 1;
  n_tok = min(n_tok, n_pages * page);

  float qf[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g)
    Vec<T, E>::load(q + ((size_t)b * H + h * G + g) * D + lane * E, qf[g]);

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const int32_t* row_table = tables + (size_t)b * n_pages;
  const size_t tok_stride = (size_t)hkv * D;  // elements between tokens

  for (int base = warp * kUnroll; base < n_tok; base += kWarps * kUnroll) {
    float kf[kUnroll][E], vf[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u;
      if (t < n_tok) {
        int pid = __ldg(row_table + t / page);
        pid = min(max(pid, 0), n_pool - 1);
        const size_t off =
            ((size_t)pid * page + t % page) * tok_stride + (size_t)h * D +
            lane * E;
        Vec<T, E>::load(k_pages + off, kf[u]);
        Vec<T, E>::load(v_pages + off, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
    float s[G][kUnroll];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float acc_s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) acc_s = fmaf(qf[g][e], kf[u][e], acc_s);
        s[g][u] = acc_s;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          s[g][u] += __shfl_xor_sync(0xffffffffu, s[g][u], off);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[g][u] = (base + u < n_tok) ? s[g][u] * scale : kNegInf;
        mx = fmaxf(mx, s[g][u]);
      }
      const float corr = expf(m[g] - mx);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = expf(s[g][u] - mx);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vf[u][e], acc[g][e]);
      }
      m[g] = mx;
    }
  }

  // Merge the warps' partial softmax states.
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][g][lane * E + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    const int d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      lsum = fmaf(sm_l[w][g], c, lsum);
      o = fmaf(sm_acc[w][g][d], c, o);
    }
    store(out + ((size_t)b * H + h * G + g) * D + d, o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const int32_t* tables, const int32_t* lengths, void* out,
                     int B, int hkv, int group, int n_pool, int page,
                     int n_pages, float scale, cudaStream_t stream) {
  dim3 grid(hkv, B);
  dim3 block(kWarps * 32);
#define PDT_LAUNCH(GG)                                                      \
  paged_decode_kernel<T, D, GG><<<grid, block, 0, stream>>>(               \
      static_cast<const T*>(q), static_cast<const T*>(k),                   \
      static_cast<const T*>(v), tables, lengths, static_cast<T*>(out), hkv, \
      n_pool, page, n_pages, scale)
  switch (group) {
    case 1: PDT_LAUNCH(1); break;
    case 2: PDT_LAUNCH(2); break;
    case 4: PDT_LAUNCH(4); break;
    case 8: PDT_LAUNCH(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef PDT_LAUNCH
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const int32_t* tables, const int32_t* lengths, void* out,
                     int B, int hkv, int group, int D, int n_pool, int page,
                     int n_pages, float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_d<T, 64>(q, k, v, tables, lengths, out, B, hkv, group,
                             n_pool, page, n_pages, scale, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, tables, lengths, out, B, hkv, group,
                              n_pool, page, n_pages, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). dtype: 0 = float32, 1 = bfloat16.
// Returns the launch's cudaError_t (0 on success); an unsupported
// (dtype, D, group) returns cudaErrorInvalidValue without launching.
extern "C" int pdt_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, int B, int H, int Hkv,
    int D, int n_pool, int page, int n_pages, int dtype, float scale,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv || page <= 0 || n_pages <= 0 ||
      n_pool <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* tb = static_cast<const int32_t*>(tables);
  const int32_t* ln = static_cast<const int32_t*>(lengths);
  cudaError_t err;
  if (dtype == 0)
    err = launch_t<float>(q, k_pages, v_pages, tb, ln, out, B, Hkv, group, D,
                          n_pool, page, n_pages, scale, s);
  else if (dtype == 1)
    err = launch_t<__nv_bfloat16>(q, k_pages, v_pages, tb, ln, out, B, Hkv,
                                  group, D, n_pool, page, n_pages, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
