// Shared device helpers for the port's kernels (sm_90a, plain C interface).
//
// Activations come in two types, selected at the C boundary by a code:
// 0 = float32, 1 = bfloat16.  All arithmetic is f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace thawk {

enum DType { kF32 = 0, kBF16 = 1 };

static __device__ __forceinline__ float to_f32(float v) { return v; }
static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

static __device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Four consecutive elements as f32 (p must be 16-byte aligned for float,
// 8-byte aligned for bfloat16).
static __device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Two consecutive elements as f32 (p must be 8-byte aligned for float,
// 4-byte aligned for bfloat16).
static __device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
static __device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// N consecutive elements (N = 2 or 4) as f32: the head dims one lane owns
// at head dim 64 or 128 (global or shared memory).
template <int N, typename T>
__device__ __forceinline__ void load_n(const T* p, float* out) {
  static_assert(N == 2 || N == 4, "a lane owns 2 or 4 head dims");
  if constexpr (N == 4) {
    const float4 v = load4(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    const float2 v = load2(p);
    out[0] = v.x; out[1] = v.y;
  }
}

// Eight consecutive elements as f32 (16-byte aligned).
static __device__ __forceinline__ void load8(const float* p, float* out) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
static __device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Programmatic dependent launch (Hopper): launch_dependents lets the next
// kernel on the stream, where it was launched as a programmatic dependent
// of this one, start (its blocks take the SMs this grid frees) once every
// block of this grid has issued it or exited; wait blocks until the kernel
// before this one has completed and its writes are visible.  In a launch
// that is not a programmatic dependent the kernel before has completed
// already, and wait returns.
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

}  // namespace thawk

// What every extern "C" launcher returns: 0, or the cudaError_t of a
// launch that was refused (too many threads, too much shared memory...).
#define THAWK_LAUNCH_RESULT() static_cast<int>(cudaGetLastError())
