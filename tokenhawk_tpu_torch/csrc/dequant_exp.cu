// Kernel 21: Q4 split-half dequant matmul at B = 8, three dequant variants.
//
// Replaces experiments/dequant_exp.py `build` (make_kernel's kern), the
// reference's experiment on the arithmetic of Q4 dequantization: x [8, K]
// bfloat16 times a weight whose packed byte row r holds row r (low nibble,
// against x[:, :K/2]) and row K/2 + r (high nibble, against x[:, K/2:]);
// one bfloat16 scale per 32 packed rows and column, shared by both nibbles.
// Each weight is dequantized in f32, rounded to bfloat16, then multiplied
// in with f32 accumulation; the output is bfloat16.  The variant (a
// template parameter) is how the code becomes a number:
//   0 int32    through 32-bit integers: (p & 15) - 8, (p >> 4) - 8;
//   1 u8int8   byte ops: p & 15 and p >> 4 as int8, to bfloat16, minus 8 in
//              bfloat16 (the same values);
//   2 biasdot  no -8 at all: wrong by design, as in the reference, which
//              measured what folding the bias out of the dot would save.
//
// The TPU kernel walks K in blocks of 512 packed rows and takes the dot on
// the MXU.  Here a CUDA-core kernel: a block of 8 warps owns 128 columns
// (a lane 4, one 4-byte load of codes per packed row, so a warp reads 128
// contiguous bytes) and 512 packed rows (a warp 64, loaded 8 rows at a time
// so that 8 loads a lane are in flight); x's matching rows sit in shared
// memory as f32 (every lane reads the same value: a broadcast).  The 8
// warps' sums meet in shared memory, and each block writes its f32
// partials [split, 8, N]; a second launch adds the K/1024 splits in a fixed
// order and rounds to bfloat16 (no atomics).  Bound by bytes (the codes:
// 22.5 MB of the 24.2 a call moves at K 4096, N 11008).
#include "common.cuh"

using namespace thawk;

namespace {

constexpr int kRows = 8;        // B
constexpr int kWarps = 8;
constexpr int kCols = 128;      // columns a block owns, 4 a lane
constexpr int kSplit = 512;     // packed rows a block owns
constexpr int kWarpRows = kSplit / kWarps;
constexpr int kUnroll = 8;       // packed rows a warp loads at once

template <int VARIANT>
__device__ __forceinline__ void dequant(uint32_t c, float s, float& lo, float& hi) {
  if constexpr (VARIANT == 0) {
    const int p = static_cast<int>(c);
    lo = static_cast<float>((p & 0x0F) - 8);
    hi = static_cast<float>((p >> 4) - 8);
  } else if constexpr (VARIANT == 1) {
    const uint8_t p = static_cast<uint8_t>(c);
    const int8_t l8 = static_cast<int8_t>(p & 0x0F);
    const int8_t h8 = static_cast<int8_t>(p >> 4);
    const __nv_bfloat16 eight = __float2bfloat16(8.f);
    lo = __bfloat162float(__hsub(__int2bfloat16_rn(l8), eight));
    hi = __bfloat162float(__hsub(__int2bfloat16_rn(h8), eight));
  } else {
    lo = static_cast<float>(c & 0x0F);
    hi = static_cast<float>(c >> 4);
  }
  lo = __bfloat162float(__float2bfloat16(lo * s));
  hi = __bfloat162float(__float2bfloat16(hi * s));
}

template <int VARIANT>
__global__ void __launch_bounds__(kWarps * 32)
    dequant_partials(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qs,
                     const __nv_bfloat16* __restrict__ s, float* __restrict__ partials, int K,
                     int N) {
  __shared__ __align__(16) float xs[2][kRows][kSplit];  // x's low and high halves
  const int KP = K / 2;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * kCols + lane * 4;
  const int r_block = split * kSplit;

  for (int i = tid; i < kRows * kSplit; i += kWarps * 32) {
    const int b = i / kSplit, r = i % kSplit;
    xs[0][b][r] = __bfloat162float(x[static_cast<size_t>(b) * K + r_block + r]);
    xs[1][b][r] = __bfloat162float(x[static_cast<size_t>(b) * K + KP + r_block + r]);
  }
  __syncthreads();

  float acc[kRows][4];
#pragma unroll
  for (int b = 0; b < kRows; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[b][j] = 0.f;

  float sc[4];
  const int r0 = warp * kWarpRows;  // within the block's rows
  for (int rr = 0; rr < kWarpRows; rr += kUnroll) {
    const int r = r_block + r0 + rr;
    uint32_t words[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      words[u] = *reinterpret_cast<const uint32_t*>(qs + static_cast<size_t>(r + u) * N + col0);
    if (rr % 32 == 0) {  // a new scale group (32 rows, a multiple of kUnroll)
      const uint2 raw =
          *reinterpret_cast<const uint2*>(s + static_cast<size_t>(r / 32) * N + col0);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      sc[0] = a.x; sc[1] = a.y; sc[2] = b.x; sc[3] = b.y;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float wlo[4], whi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dequant<VARIANT>((words[u] >> (8 * j)) & 0xFFu, sc[j], wlo[j], whi[j]);
#pragma unroll
      for (int b = 0; b < kRows; ++b) {
        const float xl = xs[0][b][r0 + rr + u], xh = xs[1][b][r0 + rr + u];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[b][j] += xl * wlo[j] + xh * whi[j];
      }
    }
  }

  // The warps' sums meet in shared memory (xs is free once all are done).
  __syncthreads();
  float* red = &xs[0][0][0];  // [kWarps][32 lanes][kRows * 4]
#pragma unroll
  for (int b = 0; b < kRows; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(warp * 32 + lane) * kRows * 4 + b * 4 + j] = acc[b][j];
  __syncthreads();
  if (warp == 0) {
    float* out = partials + static_cast<size_t>(split) * kRows * N;
#pragma unroll
    for (int b = 0; b < kRows; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += red[(w * 32 + lane) * kRows * 4 + b * 4 + j];
        out[static_cast<size_t>(b) * N + col0 + j] = v;
      }
  }
}

__global__ void dequant_finish(const float* __restrict__ partials, int splits, int n,
                               __nv_bfloat16* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = 0.f;
  for (int sp = 0; sp < splits; ++sp) v += partials[static_cast<size_t>(sp) * n + i];
  out[i] = __float2bfloat16(v);
}

}  // namespace

// x bfloat16 [8, K]; qs uint8 [K/2, N]; s bfloat16 [K/64, N]; partials f32
// [K/1024, 8, N] scratch; out bfloat16 [8, N].  K % 1024 == 0, N % 128 == 0.
extern "C" int th_dequant_exp(const void* x, const void* qs, const void* s, void* partials,
                              void* out, int K, int N, int variant, cudaStream_t stream) {
  const dim3 grid(N / kCols, (K / 2) / kSplit);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const uint8_t*>(qs);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  auto* pp = static_cast<float*>(partials);
  if (variant == 0)
    dequant_partials<0><<<grid, kWarps * 32, 0, stream>>>(xp, qp, sp, pp, K, N);
  else if (variant == 1)
    dequant_partials<1><<<grid, kWarps * 32, 0, stream>>>(xp, qp, sp, pp, K, N);
  else
    dequant_partials<2><<<grid, kWarps * 32, 0, stream>>>(xp, qp, sp, pp, K, N);
  const int rc = THAWK_LAUNCH_RESULT();
  if (rc != 0) return rc;
  const int n = kRows * N;
  dequant_finish<<<(n + 255) / 256, 256, 0, stream>>>(pp, grid.y, n,
                                                      static_cast<__nv_bfloat16*>(out));
  return THAWK_LAUNCH_RESULT();
}
