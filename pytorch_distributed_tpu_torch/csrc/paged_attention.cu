// Paged single-query decode attention for Hopper (sm_90a): K3 and K4.
//
// Replaces two TPU kernels of pytorch_distributed_tpu/ops/paged_kernel.py:
//  - K3, _paged_kernel (launched by _paged_call): pages in f32 or bf16,
//    entry point pdt_paged_decode_attention;
//  - K4, _paged_kernel_q8 (launched by _paged_call_q8): int8 pages with a
//    per-token, per-KV-head f32 scale beside them ([P, page, Hkv]),
//    dequantized in the kernel; entry point pdt_paged_decode_attention_q8.
// Both are one template, paged_decode_kernel<T, KV, D, G>, with KV the
// page element type (T for K3, int8_t for K4).
// One query token per batch row attends over that row's keys 0..lengths[b]
// (inclusive), which live in fixed-size pages of a shared pool
// [P, page, Hkv, D] addressed through block_tables [B, n_pages].
//
// What bounds it: device-memory bytes. Each query head does 2 flops per
// key element read, far below the ~295 operations per byte where H100's
// arithmetic would become the limit, so the least time is the bytes of
// the row's valid K/V pages (plus q and o) over 3.35 TB/s: D x itemsize
// per token per KV head for K and for V (K3), D + 4 for K4 (the int8
// values and the f32 scale). The design answers that by reading each K/V
// byte once and only the bytes a row needs:
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
// K4 dequantizes in f32 on the way: each lane converts its D/32 int8
// values to f32 (2 or 4 bytes per load; every row is D bytes and starts
// D-aligned), every lane reads the token's two scales (one address, a
// broadcast), and the scales multiply after the products — q.k_int * ks,
// and p * vs into the accumulator — which is the TPU kernel's function
// (it scales each element before the dot) in another rounding order.
//
// All accumulation is f32 whatever the storage type; the output is written
// in q's type (f32 or bf16). Page ids outside [0, P) are clamped into the
// pool, as a JAX gather clamps them, so the kernel never reads out of
// bounds. Known limit of this first version: at small batch the grid is
// only B * Hkv CTAs (GPT-2 124M with 8 rows: 96 CTAs on 132 SMs), so the
// card is not filled; splitting a row's pages across CTAs (flash-decoding)
// is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

template <>
struct Vec<int8_t, 2> {
  static __device__ __forceinline__ void load(const int8_t* p, float* o) {
    char2 v = *reinterpret_cast<const char2*>(p);
    o[0] = static_cast<float>(v.x);
    o[1] = static_cast<float>(v.y);
  }
};

template <>
struct Vec<int8_t, 4> {
  static __device__ __forceinline__ void load(const int8_t* p, float* o) {
    char4 v = *reinterpret_cast<const char4*>(p);
    o[0] = static_cast<float>(v.x);
    o[1] = static_cast<float>(v.y);
    o[2] = static_cast<float>(v.z);
    o[3] = static_cast<float>(v.w);
  }
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// grid (Hkv, B), block kWarps * 32 threads. KV == int8_t is K4: the
// scale pools are read; otherwise (K3, KV == T) they are null and unused.
template <typename T, typename KV, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q,         // [B, H, D]
                    const KV* __restrict__ k_pages,  // [P, page, Hkv, D]
                    const KV* __restrict__ v_pages,  // [P, page, Hkv, D]
                    const float* __restrict__ k_scales,  // [P, page, Hkv]
                    const float* __restrict__ v_scales,  // [P, page, Hkv]
                    const int32_t* __restrict__ tables,   // [B, n_pages]
                    const int32_t* __restrict__ lengths,  // [B]
                    T* __restrict__ out,                  // [B, H, D]
                    int hkv, int n_pool, int page, int n_pages, float scale) {
  constexpr bool kQ8 = std::is_same<KV, int8_t>::value;
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

  for (int base = warp * kUnroll; base < n_tok; base += kWarps * kUnroll) {
    float kf[kUnroll][E], vf[kUnroll][E];
    float ks[kUnroll], vs[kUnroll];  // K4's token scales (1 for K3)
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u;
      ks[u] = vs[u] = 1.f;
      if (t < n_tok) {
        int pid = __ldg(row_table + t / page);
        pid = min(max(pid, 0), n_pool - 1);
        // (pool page, slot in page, KV head): the token-head's row index.
        const size_t row = ((size_t)pid * page + t % page) * hkv + h;
        const size_t off = row * D + lane * E;
        Vec<KV, E>::load(k_pages + off, kf[u]);
        Vec<KV, E>::load(v_pages + off, vf[u]);
        if constexpr (kQ8) {
          ks[u] = __ldg(k_scales + row);
          vs[u] = __ldg(v_scales + row);
        }
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
        s[g][u] = (base + u < n_tok) ? s[g][u] * ks[u] * scale : kNegInf;
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
        const float pv = p * vs[u];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pv, vf[u][e], acc[g][e]);
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

template <typename T, typename KV, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const float* ks, const float* vs, const int32_t* tables,
                     const int32_t* lengths, void* out, int B, int hkv,
                     int group, int n_pool, int page, int n_pages, float scale,
                     cudaStream_t stream) {
  dim3 grid(hkv, B);
  dim3 block(kWarps * 32);
#define PDT_LAUNCH(GG)                                                      \
  paged_decode_kernel<T, KV, D, GG><<<grid, block, 0, stream>>>(           \
      static_cast<const T*>(q), static_cast<const KV*>(k),                  \
      static_cast<const KV*>(v), ks, vs, tables, lengths,                   \
      static_cast<T*>(out), hkv, n_pool, page, n_pages, scale)
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

template <typename T, typename KV>
cudaError_t launch_t(const void* q, const void* k, const void* v,
                     const float* ks, const float* vs, const int32_t* tables,
                     const int32_t* lengths, void* out, int B, int hkv,
                     int group, int D, int n_pool, int page, int n_pages,
                     float scale, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_d<T, KV, 64>(q, k, v, ks, vs, tables, lengths, out, B,
                                 hkv, group, n_pool, page, n_pages, scale,
                                 stream);
    case 128:
      return launch_d<T, KV, 128>(q, k, v, ks, vs, tables, lengths, out, B,
                                  hkv, group, n_pool, page, n_pages, scale,
                                  stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// q and out in T (dtype 0 = float32, 1 = bfloat16); pages in T, or int8
// with scales when q8.
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const void* tables,
                   const void* lengths, void* out, int B, int H, int Hkv,
                   int D, int n_pool, int page, int n_pages, int dtype,
                   bool q8, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv || page <= 0 || n_pages <= 0 ||
      n_pool <= 0 || (q8 && (ks == nullptr || vs == nullptr)))
    return cudaErrorInvalidValue;
  const int group = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* tb = static_cast<const int32_t*>(tables);
  const int32_t* ln = static_cast<const int32_t*>(lengths);
  if (dtype == 0 && !q8)
    return launch_t<float, float>(q, k, v, ks, vs, tb, ln, out, B, Hkv,
                                  group, D, n_pool, page, n_pages, scale, s);
  if (dtype == 1 && !q8)
    return launch_t<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, ks, vs, tb, ln, out, B, Hkv, group, D, n_pool, page,
        n_pages, scale, s);
  if (dtype == 0 && q8)
    return launch_t<float, int8_t>(q, k, v, ks, vs, tb, ln, out, B, Hkv,
                                   group, D, n_pool, page, n_pages, scale, s);
  if (dtype == 1 && q8)
    return launch_t<__nv_bfloat16, int8_t>(q, k, v, ks, vs, tb, ln, out, B,
                                           Hkv, group, D, n_pool, page,
                                           n_pages, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (bound with ctypes). dtype is q's and out's: 0 =
// float32, 1 = bfloat16. Each returns the launch's cudaError_t (0 on
// success); an unsupported (dtype, D, group) returns cudaErrorInvalidValue
// without launching.

// K3: pages in q's dtype.
extern "C" int pdt_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, int B, int H, int Hkv,
    int D, int n_pool, int page, int n_pages, int dtype, float scale,
    void* stream) {
  return static_cast<int>(launch(q, k_pages, v_pages, nullptr, nullptr,
                                 tables, lengths, out, B, H, Hkv, D, n_pool,
                                 page, n_pages, dtype, false, scale, stream));
}

// K4: int8 pages with f32 scale pools [P, page, Hkv].
extern "C" int pdt_paged_decode_attention_q8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* lengths, void* out, int B, int H, int Hkv, int D, int n_pool,
    int page, int n_pages, int dtype, float scale, void* stream) {
  return static_cast<int>(launch(
      q, k_pages, v_pages, static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), tables, lengths, out, B, H, Hkv,
      D, n_pool, page, n_pages, dtype, true, scale, stream));
}
