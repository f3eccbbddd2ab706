// Multi-tenant LoRA delta for Hopper (sm_90a): one launch per adapted
// projection.
//
// For every row i of a projection's input x [n, din] and output y [n, out]
// (a row is one token of one request), with s = rows[i] the row's adapter
// slot, in place:
//
//   y[i] = y[i] + cast((x[i] @ A[s]) @ B[s])
//
// A's slots are laid out as a_flat [din, S * R] (slot s owns columns
// s*R .. s*R+R-1) and B's as b_flat [R, S * out], in f32; slot 0 is the
// zero adapter, so a slot-0 row adds exactly 0. The cast rounds the f32
// delta to y's type before the add, as the plain version's
// ``y + delta.to(y.dtype)`` does.
//
// Not a port of a TPU kernel: the JAX package computes this delta as two
// plain products against every slot with an exact slot selection after
// each (models/decode.py lora_delta), and the port's plain version
// (ops/lora_kernel.lora_delta_reference) keeps that lowering. Eagerly,
// that is five launches and a dozen host calls per adapted projection,
// which at serving batch sizes cost more host time than the projection
// itself (PERF.md); this kernel is one launch.
//
// Design: one CTA of 256 threads per row. Each thread sums x[k] A[k, s, :]
// over its k = tid, tid + 256, ... into R registers; the warp reduces them
// by a fixed xor tree, the 8 warps' sums are added in warp order, so h is
// a fixed-order sum whatever the batch. Then each thread computes the
// outputs o = tid, tid + 256, ...: d = sum_j h[j] B[j, s, o] in j order,
// and adds it into y in place. A row's bits depend only on its own x, its
// slot and the factors: never on its neighbours or the batch size, which
// is what tenant isolation needs.
//
// What bounds it: bytes. 2 (din + out) R flops per row against reading x
// and y once, writing y once, and the slots' factors (din R + R out f32
// per slot in use): far below the H100's ~20 f32 flops per byte.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads) lora_delta_add_kernel(
    const T* __restrict__ x, int64_t x_stride,
    const long long* __restrict__ rows, const float* __restrict__ a_flat,
    const float* __restrict__ b_flat, T* y, int64_t y_stride, int din,
    int n_slots, int out) {
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // Slots past the stack are clamped into it (the wrapper cannot check
  // without a device sync), as a JAX gather clamps.
  const int s = (int)min(max(rows[i], 0LL), (long long)(n_slots - 1));
  const T* xr = x + (int64_t)i * x_stride;

  float part[R];
#pragma unroll
  for (int j = 0; j < R; ++j) part[j] = 0.f;
  const int64_t a_row = (int64_t)n_slots * R;
  for (int k = tid; k < din; k += kThreads) {
    const float xv = to_float(xr[k]);
    const float* ar = a_flat + (int64_t)k * a_row + (int64_t)s * R;
#pragma unroll
    for (int j = 0; j < R; ++j) part[j] = fmaf(xv, __ldg(ar + j), part[j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < R; ++j)
      part[j] += __shfl_xor_sync(kFull, part[j], off);

  __shared__ float s_part[kWarps][R];
  __shared__ float s_h[R];
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < R; ++j) s_part[warp][j] = part[j];
  }
  __syncthreads();
  if (tid < R) {
    float h = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) h += s_part[w][tid];
    s_h[tid] = h;
  }
  __syncthreads();

  const int64_t b_row = (int64_t)n_slots * out;
  const float* br = b_flat + (int64_t)s * out;
  T* yr = y + (int64_t)i * y_stride;
  for (int o = tid; o < out; o += kThreads) {
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j)
      d = fmaf(s_h[j], __ldg(br + (int64_t)j * b_row + o), d);
    yr[o] = from_float<T>(to_float(yr[o]) + to_float(from_float<T>(d)));
  }
}

template <typename T>
cudaError_t launch_t(const void* x, int64_t x_stride, const void* rows,
                     const void* a, const void* b, void* y,
                     int64_t y_stride, int n, int din, int rank,
                     int n_slots, int out, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const long long* rt = static_cast<const long long*>(rows);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  T* yt = static_cast<T*>(y);
#define PDT_LORA(RR)                                                       \
  lora_delta_add_kernel<T, RR><<<n, kThreads, 0, stream>>>(               \
      xt, x_stride, rt, af, bf, yt, y_stride, din, n_slots, out)
  switch (rank) {
    case 1: PDT_LORA(1); break;
    case 2: PDT_LORA(2); break;
    case 4: PDT_LORA(4); break;
    case 8: PDT_LORA(8); break;
    case 16: PDT_LORA(16); break;
    case 32: PDT_LORA(32); break;
    case 64: PDT_LORA(64); break;
    default: return cudaErrorInvalidValue;
  }
#undef PDT_LORA
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). x [n, din] and y [n, out] in
// dtype (0 = float32, 1 = bfloat16), each with its own row stride in
// elements and unit stride within a row; y is updated in place. rows [n]
// int64 adapter slots; a_flat [din, n_slots * rank] and b_flat [rank,
// n_slots * out] f32, contiguous. Returns the launch's cudaError_t (0 on
// success); an unsupported (dtype, rank) or an empty grid returns
// cudaErrorInvalidValue without launching.
extern "C" int pdt_lora_delta_add(const void* x, int64_t x_stride,
                                  const void* rows, const void* a_flat,
                                  const void* b_flat, void* y,
                                  int64_t y_stride, int n, int din, int rank,
                                  int n_slots, int out, int dtype,
                                  void* stream) {
  if (n <= 0 || din <= 0 || out <= 0 || n_slots <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_t<float>(x, x_stride, rows, a_flat,
                                            b_flat, y, y_stride, n, din,
                                            rank, n_slots, out, s));
  if (dtype == 1)
    return static_cast<int>(launch_t<__nv_bfloat16>(
        x, x_stride, rows, a_flat, b_flat, y, y_stride, n, din, rank,
        n_slots, out, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
