// The int8 KV codec and int8 unpacking, shared by kernels 8-12.
//
// A K or V row of Dh values quantizes to Dh int8 codes and one scale,
// bit for bit as tokenhawk_tpu/ops/kvquant.py quantize_kv_block does:
//   scale = amax / 127 (f32, a correctly rounded division);
//   inv   = 1 / scale (0 where scale is 0), then x * inv (a multiply);
//   q     = round half to even (rintf), clipped to +-127;
//   the stored scale is rounded to bfloat16; the codes were made with the
//   unrounded f32 scale.
// The explicit _rn intrinsics keep the division and the multiply IEEE
// whatever flags the file is compiled with.
#pragma once

#include "common.cuh"

namespace thawk {

// A row of 32*N values held by a warp, N per lane (lane l holds
// x[N*l .. N*l+N-1]): N = 2 for a row of 64 (head dim 64), N = 4 for 128.
// Writes the lane's N codes and returns the f32 scale before its bfloat16
// rounding.
template <int N>
__device__ __forceinline__ float quantize_row(const float* x, signed char* q) {
  float a = fabsf(x[0]);
#pragma unroll
  for (int i = 1; i < N; ++i) a = fmaxf(a, fabsf(x[i]));
  const float scale = __fdiv_rn(warp_max(a), 127.f);
  const float inv = scale > 0.f ? __fdiv_rn(1.f, scale) : 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i)
    q[i] = static_cast<signed char>(fminf(fmaxf(rintf(__fmul_rn(x[i], inv)), -127.f), 127.f));
  return scale;
}

// Two int8 codes in the low 16 bits of a word (byte 0 first) as f32.
static __device__ __forceinline__ void unpack2(uint32_t w, float* o) {
  const int s = static_cast<int>(w);
  o[0] = static_cast<float>((s << 24) >> 24);
  o[1] = static_cast<float>((s << 16) >> 24);
}

// Four int8 codes packed in a 32-bit word (byte 0 first) as f32.
static __device__ __forceinline__ void unpack4(uint32_t w, float* o) {
  const int s = static_cast<int>(w);
  o[0] = static_cast<float>((s << 24) >> 24);
  o[1] = static_cast<float>((s << 16) >> 24);
  o[2] = static_cast<float>((s << 8) >> 24);
  o[3] = static_cast<float>(s >> 24);
}

// The N int8 codes a lane owns for P·V (N = 2 or 4) as f32.
template <int N>
__device__ __forceinline__ void load_codes(const int8_t* p, float* o) {
  static_assert(N == 2 || N == 4, "a lane owns 2 or 4 head dims");
  if constexpr (N == 4)
    unpack4(*reinterpret_cast<const uint32_t*>(p), o);
  else
    unpack2(*reinterpret_cast<const uint16_t*>(p), o);
}

// Eight f32 values stored in T (16-byte aligned for bfloat16, 32 for float).
static __device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
static __device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = raw;
}

}  // namespace thawk
