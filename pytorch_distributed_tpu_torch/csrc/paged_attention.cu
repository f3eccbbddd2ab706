// Paged single-query decode attention for Hopper (sm_90a): K3 and K4.
//
// Replaces two TPU kernels of pytorch_distributed_tpu/ops/paged_kernel.py:
//  - K3, _paged_kernel (launched by _paged_call): pages in f32 or bf16,
//    entry point pdt_paged_decode_attention;
//  - K4, _paged_kernel_q8 (launched by _paged_call_q8): int8 pages with a
//    per-token, per-KV-head f32 scale beside them ([P, page, Hkv]),
//    dequantized in the kernel; entry point pdt_paged_decode_attention_q8.
// Both are one template, paged_decode_kernel<T, KV, D, G>, with KV the
// page element type (T for K3, int8_t for K4) and G the query heads that
// share a KV head (grouped-query attention).
// One query token per batch row attends over that row's keys 0..lengths[b]
// (inclusive), which live in fixed-size pages of a shared pool
// [P, page, Hkv, D] addressed through block_tables [B, n_pages].
//
// What bounds it: device-memory bytes. Each query head does 2 flops per
// key element read, far below the ~295 operations per byte where H100's
// arithmetic would become the limit, so the least time is the bytes of
// the row's valid K/V rows (plus q and o) over 3.35 TB/s: D x itemsize
// per token per KV head for K and for V (K3), D + 4 for K4 (the int8
// values and the f32 scale). At decode batch sizes those bytes are a few
// MB, a couple of microseconds, so what stands between a kernel and its
// bound is how many loads are in flight at once and how many dependent
// memory round trips it makes. The design:
//
//  - Rows split across CTAs (flash-decoding). The grid is (KV head, row,
//    split). Each CTA takes one fixed chunk of a row's keys, a whole
//    number of pages (chunk_pages, from the wrapper's _split_plan, which
//    fixes it by page size, D and page type alone — 16 KB of K rows, one
//    round of loads for the CTA's 8 warps — so a row's partition, and so
//    its bits, depend only on its own length, never on the batch or the
//    table's width). A CTA whose chunk starts past the row's depth exits
//    at once; the split is the slowest grid dimension, so those CTAs are
//    scheduled after every row's live ones. Several CTAs share an SM and
//    the card holds far more loads in flight than one CTA per (row, KV
//    head) could.
//  - Page ids first. A CTA's first act is to load the row's length, its
//    chunk's block-table entries (at most kMaxChunkPages) and q, all in
//    one round trip; the page ids, clamped into [0, P), and q in f32 go
//    to shared memory, so no K/V load waits on a table load.
//  - 16-byte loads. A token's row for one KV head is D x itemsize
//    contiguous bytes; a group of L = D x itemsize / 16 lanes covers it
//    with one 16-byte load per lane, so a warp covers 32 / L tokens per
//    load instruction (4 for bf16 at D 64, 8 for int8). Each lane issues U
//    K loads and U V loads (and, for K4, the token's two scales, one
//    address per lane group: a broadcast) before any arithmetic. q.k sums
//    over the lane group only (log2 L shuffle steps: 3 for bf16 at D 64).
//  - Online softmax in base 2: log2(e) is folded into the score scale and
//    exponentials are ex2.approx.ftz. Each lane group keeps its own state
//    (running max m, sum l, accumulator acc[G][D] spread over its lanes);
//    the states are merged across lane groups by shuffles, across warps
//    through shared memory, always with the same (m, l, acc) algebra.
//  - Combine in the same launch, in a fixed order. A row with one active
//    split writes o directly. Otherwise each split writes its partial
//    (m, l, acc[G][D]) in f32 to a workspace and adds one to a per-(row,
//    KV head) counter with one acquire-release atomic (after a barrier,
//    so it releases every thread's writes); the split that arrives last
//    merges the partials in split order 0..n-1 (whatever order they
//    arrived in), writes o and resets the counter to 0 for the next
//    launch. The result is bit-deterministic, and the combine costs no
//    second launch.
//
// Tails are never loaded: a key past lengths[b] (in a partly valid chunk)
// is not read, its registers are zero and its weight p is exactly 0, so a
// recycled page holding NaN past a row's depth cannot reach the output.
// K4 dequantizes in f32 on the way: q.k_int times the token's K scale and
// p times its V scale into the accumulator (the TPU kernel scales each
// element before the dot: the same function in another rounding order).
// All accumulation is f32 whatever the storage type; the output is
// rounded once, to q's type (f32 or bf16). Page ids outside [0, P) are
// clamped into the pool, as a JAX gather clamps them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChunkPages = 64;  // block-table entries one CTA holds
constexpr float kNegInf = -1e30f;   // finite, as the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One RMW with release and acquire semantics at device scope: the
// partials this CTA wrote (ordered before it by __syncthreads) are visible
// to whichever CTA reads the count it leaves, and that CTA sees theirs.
__device__ __forceinline__ int add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// Element i of a 16-byte vector of KV values, as f32 (i is a constant
// after unrolling, so the word select folds away).
template <typename KV>
__device__ __forceinline__ float elem(const uint4& r, int i);

template <>
__device__ __forceinline__ float elem<float>(const uint4& r, int i) {
  return __uint_as_float(word(r, i));
}

template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& r, int i) {
  const uint32_t w = word(r, i / 2);
  return __uint_as_float(i % 2 ? (w & 0xffff0000u) : (w << 16));
}

// int8 -> f32 without a conversion instruction: the byte, biased by 128,
// becomes the low mantissa byte of 2^23, and subtracting 2^23 + 128 is
// exact.
template <>
__device__ __forceinline__ float elem<int8_t>(const uint4& r, int i) {
  const uint32_t w = word(r, i / 4) ^ 0x80808080u;
  return __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7440 + i % 4)) -
         8388736.f;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

struct Args {
  const void* q;            // [B, H, D] in T
  const void* k;            // [P, page, Hkv, D] in KV
  const void* v;            // [P, page, Hkv, D] in KV
  const float* k_scales;    // [P, page, Hkv] (K4), else null
  const float* v_scales;    // [P, page, Hkv] (K4), else null
  const int32_t* tables;    // [B, n_pages]
  const int32_t* lengths;   // [B]
  void* out;                // [B, H, D] in T
  float* work;              // partials: [B, Hkv, n_splits] x G x (D + 2)
  int32_t* counters;        // [B, Hkv], all 0 between launches
  int B, hkv, n_pool, page, n_pages, chunk_pages, n_splits;
  float scale_log2;         // 1/sqrt(D) * log2(e)
};

// grid (Hkv, B, n_splits), block kThreads: every row's first splits are
// scheduled before any row's later ones, which are the ones that exit.
// KV == int8_t is K4: the scale pools are read; otherwise (K3, KV == T)
// they are null and unused.
template <typename T, typename KV, int D, int G>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Args a) {
  constexpr bool kQ8 = std::is_same<KV, int8_t>::value;
  constexpr int E = 16 / sizeof(KV);  // elements per 16-byte load
  constexpr int L = D / E;            // lanes per token row
  constexpr int kTpw = 32 / L;        // tokens per warp per load
  // K (and V) loads in flight per lane: fewer where the G x E
  // accumulators and G x U scores crowd the registers.
  constexpr int U = G * E >= 128 || G == 8 ? 2 : 4;
  constexpr int kStep = kWarps * kTpw * U;  // tokens per CTA iteration
  static_assert(L >= 2 && L <= 32 && 32 % L == 0, "row must span lanes");

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int H = a.hkv * G;
  const int chunk = a.chunk_pages * a.page;

  __shared__ __align__(16) float sq[G][D];
  __shared__ int s_pid[kMaxChunkPages];
  __shared__ float s_m[kWarps][G], s_l[kWarps][G];
  __shared__ __align__(16) float s_acc[kWarps][G][D];
  __shared__ int s_last;

  // The row's length, the chunk's block-table entries and q are loaded
  // together: one memory round trip before the K/V loads, not three.
  const int len = __ldg(a.lengths + b);
  int pid = 0;
  if (tid < a.chunk_pages && split * a.chunk_pages + tid < a.n_pages)
    pid = __ldg(a.tables + (size_t)b * a.n_pages + split * a.chunk_pages +
                tid);
  constexpr int kQPerThread = (G * D + kThreads - 1) / kThreads;
  const T* q = static_cast<const T*>(a.q) + ((size_t)b * H + h * G) * D;
  float qv[kQPerThread];
#pragma unroll
  for (int j = 0; j < kQPerThread; ++j) {
    const int i = tid + j * kThreads;
    qv[j] = i < G * D ? to_float(q[i]) : 0.f;
  }
  // Keys 0..lengths[b] are valid, capped at the table's extent.
  const int n_tok = max(0, min(len + 1, a.n_pages * a.page));
  const int n_active = max(1, (n_tok + chunk - 1) / chunk);
  if (split >= n_active) return;
  const int n_here = min(chunk, n_tok - split * chunk);
#pragma unroll
  for (int j = 0; j < kQPerThread; ++j) {
    const int i = tid + j * kThreads;
    if (i < G * D) sq[i / D][i % D] = qv[j];
  }
  if (tid < a.chunk_pages) s_pid[tid] = min(max(pid, 0), a.n_pool - 1);
  __syncthreads();

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane / L;  // which of the warp's tokens
  const int pos = lane % L;  // which 16 bytes of the token's row
  const KV* k_pages = static_cast<const KV*>(a.k);
  const KV* v_pages = static_cast<const KV*>(a.v);

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int base = 0; base < n_here; base += kStep) {
    uint4 kr[U], vr[U];
    float ks[U], vs[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + (u * kWarps + warp) * kTpw + grp;  // in the chunk
      ok[u] = t < n_here;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      ks[u] = vs[u] = 1.f;
      if (ok[u]) {
        const int pg = t / a.page;
        // (pool page, slot in page, KV head): the token-head's row index.
        const size_t row =
            ((size_t)s_pid[pg] * a.page + (t - pg * a.page)) * a.hkv + h;
        kr[u] = ld16(k_pages + row * D + pos * E);
        vr[u] = ld16(v_pages + row * D + pos * E);
        if constexpr (kQ8) {
          ks[u] = __ldg(a.k_scales + row);
          vs[u] = __ldg(a.v_scales + row);
        }
      }
    }
    float s[G][U];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int u = 0; u < U; ++u) s[g][u] = 0.f;
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&sq[g][pos * E + e]);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          s[g][u] = fmaf(qv.x, elem<KV>(kr[u], e), s[g][u]);
          s[g][u] = fmaf(qv.y, elem<KV>(kr[u], e + 1), s[g][u]);
          s[g][u] = fmaf(qv.z, elem<KV>(kr[u], e + 2), s[g][u]);
          s[g][u] = fmaf(qv.w, elem<KV>(kr[u], e + 3), s[g][u]);
        }
      }
    }
    // q.k over the lane group; a + b == b + a, so every lane of the group
    // ends with the same bits.
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int u = 0; u < U; ++u)
          s[g][u] += __shfl_xor_sync(kFull, s[g][u], off);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[g][u] = ok[u] ? s[g][u] * ks[u] * a.scale_log2 : kNegInf;
        mx = fmaxf(mx, s[g][u]);
      }
      const float corr = ex2(m[g] - mx);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= corr;
      m[g] = mx;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = ok[u] ? ex2(s[g][u] - mx) : 0.f;
        l[g] += p;
        s[g][u] = p * vs[u];  // from here on: the weight of V row u
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float vf = elem<KV>(vr[u], e);
#pragma unroll
        for (int g = 0; g < G; ++g)
          acc[g][e] = fmaf(s[g][u], vf, acc[g][e]);
      }
  }

  // Merge the warp's lane groups (lanes pos, pos + L, ... hold the same
  // columns); lanes 0..L-1 end with the warp's state.
#pragma unroll
  for (int off = L; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo = __shfl_xor_sync(kFull, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float c = ex2(m[g] - mx);
      const float co = ex2(mo - mx);
      l[g] = l[g] * c + lo * co;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(kFull, acc[g][e], off);
        acc[g][e] = acc[g][e] * c + ao * co;
      }
      m[g] = mx;
    }
  if (lane < L) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < E; e += 4)
        *reinterpret_cast<float4*>(&s_acc[warp][g][pos * E + e]) =
            make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2],
                        acc[g][e + 3]);
    if (lane == 0)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        s_m[warp][g] = m[g];
        s_l[warp][g] = l[g];
      }
  }
  __syncthreads();

  // Merge the warps into the chunk's state: o directly for a row with one
  // active split, else a partial in the workspace.
  T* out = static_cast<T*>(a.out) + ((size_t)b * H + h * G) * D;
  const size_t p0 = ((size_t)b * a.hkv + h) * a.n_splits;  // split 0's slot
  const size_t n_slots = (size_t)a.B * a.hkv * a.n_splits;
  float* w_acc = a.work;                   // [slot][G][D]
  float* w_ml = a.work + n_slots * G * D;  // [slot][G][2]: m, l
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = ex2(s_m[w][g] - mx);
      lsum = fmaf(s_l[w][g], c, lsum);
      o = fmaf(s_acc[w][g][d], c, o);
    }
    if (n_active == 1) {
      store(out + i, o / fmaxf(lsum, 1e-30f));
    } else {
      const size_t slot = p0 + split;
      w_acc[slot * G * D + i] = o;
      if (d == 0) {
        w_ml[(slot * G + g) * 2] = mx;
        w_ml[(slot * G + g) * 2 + 1] = lsum;
      }
    }
  }
  if (n_active == 1) return;

  // Publish the partial: the barrier orders every thread's writes before
  // thread 0's release; the split that arrives last combines.
  __syncthreads();
  int32_t* counter = a.counters + (size_t)b * a.hkv + h;
  if (tid == 0) s_last = add_acq_rel(counter, 1) == n_active - 1;
  __syncthreads();
  if (!s_last) return;
  // One pass in split order 0..n-1 with a running max; the loads of
  // several splits are in flight at once (read from L2, where the other
  // splits' writes are).
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float mx = kNegInf, lsum = 0.f, o = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_active; ++s) {
      const float* ml = w_ml + ((p0 + s) * G + g) * 2;
      const float ms = __ldcg(ml);
      const float ls = __ldcg(ml + 1);
      const float as = __ldcg(w_acc + (p0 + s) * G * D + i);
      const float mn = fmaxf(mx, ms);
      const float c = ex2(mx - mn);
      const float cs = ex2(ms - mn);
      lsum = lsum * c + ls * cs;
      o = o * c + as * cs;
      mx = mn;
    }
    store(out + i, o / fmaxf(lsum, 1e-30f));
  }
  if (tid == 0) *counter = 0;  // every split has arrived: ready for reuse
}

template <typename T, typename KV, int D>
cudaError_t launch_d(const Args& a, int group, cudaStream_t stream) {
  const dim3 grid(a.hkv, a.B, a.n_splits);
#define PDT_LAUNCH(GG) \
  paged_decode_kernel<T, KV, D, GG><<<grid, kThreads, 0, stream>>>(a)
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
cudaError_t launch_t(const Args& a, int group, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_d<T, KV, 32>(a, group, stream);
    case 64: return launch_d<T, KV, 64>(a, group, stream);
    case 128: return launch_d<T, KV, 128>(a, group, stream);
    default: return cudaErrorInvalidValue;
  }
}

// q and out in dtype (0 = float32, 1 = bfloat16); pages in that type, or
// int8 with scales when q8.
cudaError_t launch(Args a, int H, int D, int dtype, bool q8, float scale,
                   void* stream) {
  const int group = a.hkv > 0 ? H / a.hkv : 0;
  if (a.B <= 0 || a.B > 65535 || a.hkv <= 0 || a.hkv > 65535 ||
      H % a.hkv || a.page <= 0 || a.n_pages <= 0 || a.n_pool <= 0 ||
      a.chunk_pages <= 0 || a.chunk_pages > kMaxChunkPages ||
      a.n_splits <= 0 || a.n_splits > 65535 ||
      (int64_t)a.n_splits * a.chunk_pages < a.n_pages ||
      (a.n_splits > 1 && (a.work == nullptr || a.counters == nullptr)) ||
      (q8 && (a.k_scales == nullptr || a.v_scales == nullptr)))
    return cudaErrorInvalidValue;
  a.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !q8) return launch_t<float, float>(a, group, D, s);
  if (dtype == 1 && !q8)
    return launch_t<__nv_bfloat16, __nv_bfloat16>(a, group, D, s);
  if (dtype == 0 && q8) return launch_t<float, int8_t>(a, group, D, s);
  if (dtype == 1 && q8) return launch_t<__nv_bfloat16, int8_t>(a, group, D, s);
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, const void* tables, const void* lengths,
               void* out, void* work, void* counters, int B, int Hkv,
               int n_pool, int page, int n_pages, int chunk_pages,
               int n_splits) {
  return Args{q, k, v, static_cast<const float*>(ks),
              static_cast<const float*>(vs),
              static_cast<const int32_t*>(tables),
              static_cast<const int32_t*>(lengths), out,
              static_cast<float*>(work), static_cast<int32_t*>(counters),
              B, Hkv, n_pool, page, n_pages, chunk_pages, n_splits, 0.f};
}

}  // namespace

// Plain C entry points (bound with ctypes). dtype is q's and out's: 0 =
// float32, 1 = bfloat16. work holds B x Hkv x n_splits x G x (D + 2)
// floats and counters B x Hkv int32 zeros (both may be null when
// n_splits == 1); n_splits x chunk_pages must cover n_pages. Each returns
// the launch's cudaError_t (0 on success); an unsupported (dtype, D,
// group) or plan returns cudaErrorInvalidValue without launching.

// K3: pages in q's dtype.
extern "C" int pdt_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, void* work,
    void* counters, int B, int H, int Hkv, int D, int n_pool, int page,
    int n_pages, int chunk_pages, int n_splits, int dtype, float scale,
    void* stream) {
  return static_cast<int>(launch(
      make_args(q, k_pages, v_pages, nullptr, nullptr, tables, lengths, out,
                work, counters, B, Hkv, n_pool, page, n_pages, chunk_pages,
                n_splits),
      H, D, dtype, false, scale, stream));
}

// K4: int8 pages with f32 scale pools [P, page, Hkv].
extern "C" int pdt_paged_decode_attention_q8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* lengths, void* out, void* work, void* counters, int B, int H,
    int Hkv, int D, int n_pool, int page, int n_pages, int chunk_pages,
    int n_splits, int dtype, float scale, void* stream) {
  return static_cast<int>(launch(
      make_args(q, k_pages, v_pages, k_scales, v_scales, tables, lengths, out,
                work, counters, B, Hkv, n_pool, page, n_pages, chunk_pages,
                n_splits),
      H, D, dtype, true, scale, stream));
}
