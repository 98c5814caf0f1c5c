// Q4_0 dequant-GEMV/GEMM core shared by qmatmul.cu and ffn.cu.
//
// Weight layout (tokenhawk_tpu_torch/ops/qweight.py): qs uint8 [N, K/2],
// output-major; group g of column n is 16 bytes at qs[n][16g], byte j
// holding input 32g+j (low nibble) and 32g+16+j (high nibble), offset
// binary.  scales f32 [N, K/32].
//
// Work split: a block of 8 warps owns a tile of ROWS activation rows and
// 16 output columns (2 per warp).  K is walked in chunks of 32 groups
// (1024 inputs): the block stages the chunk of its rows, normalised
// (x * inv_rms[row] * gain[k]) when a gain is given, into shared memory
// as f32; then lane l of every warp takes group l of the chunk for both
// of its columns: one 16-byte load of codes and one scale per column,
// 32 codes decoded once into registers and reused by every row.  Each
// warp sums its lanes at the end.
//
// The lanes of a warp read 512 contiguous bytes of a column per chunk.
// Blocks are ordered with the row tiles fastest (blockIdx.x), so at
// prefill the blocks that share a weight column run together and the
// weights come from device memory about once, the re-reads from L2.
#pragma once

#include "common.cuh"

namespace thawk {

constexpr int kQ4Warps = 8;
constexpr int kQ4Threads = kQ4Warps * 32;
constexpr int kQ4Cols = 2;                    // output columns per warp
constexpr int kChunkGroups = 32;              // one group per lane
constexpr int kGroupStride = 36;              // floats per staged group (32 + pad)

enum Q4Epilogue { kStore = 0, kSwiGLU = 1, kResidual = 2 };

// inv[b] = rsqrt(mean(x[b]^2) + eps); one block per row.
template <typename TX>
__global__ void __launch_bounds__(256) row_inv_rms_kernel(const TX* __restrict__ x,
                                                          float* __restrict__ inv, int K,
                                                          float eps) {
  const TX* xr = x + static_cast<size_t>(blockIdx.x) * K;
  float s = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float v = to_f32(xr[k]);
    s += v * v;
  }
  s = warp_sum(s);
  __shared__ float part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < static_cast<int>(blockDim.x >> 5) ? part[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) inv[blockIdx.x] = rsqrtf(s / K + eps);
  }
}

// (q - 8) for the nibble at bit `shift` of w, exactly, without an int->float
// convert: 0x4B000000 | q is the float 2^23 + q.
static __device__ __forceinline__ float nib(uint32_t w, int shift) {
  return __uint_as_float(0x4B000000u | ((w >> shift) & 0xFu)) - 8388616.0f;
}

// y = xn @ W for rows [blockIdx.x*ROWS, +ROWS), columns of this block.
//   kStore:    y[B, N]   = acc
//   kSwiGLU:   y[B, N/2] = silu(acc[:, f]) * acc[:, f + N/2]   (TY = float)
//   kResidual: y[B, N]   = residual + acc
template <typename TX, typename TY, int ROWS, int EPI>
__global__ void __launch_bounds__(kQ4Threads, 2)
    q4_gemv_kernel(const TX* __restrict__ x, int B, int K, const uint8_t* __restrict__ qs,
                   const float* __restrict__ scales, int N, const TX* __restrict__ gain,
                   const float* __restrict__ inv_rms, const TY* __restrict__ residual,
                   TY* __restrict__ y) {
  __shared__ __align__(16) float xs[ROWS][kChunkGroups * kGroupStride];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * ROWS;
  const int G = K / 32;
  const int KH = K / 2;

  int col[kQ4Cols];
  bool live[kQ4Cols];
  if (EPI == kSwiGLU) {
    const int F = N / 2;
    const int f = blockIdx.y * kQ4Warps + warp;
    col[0] = f;      // gate column of w13
    col[1] = f + F;  // matching up column
    live[0] = live[1] = f < F;
  } else {
    const int base = blockIdx.y * (kQ4Warps * kQ4Cols) + warp;
#pragma unroll
    for (int c = 0; c < kQ4Cols; ++c) {
      col[c] = base + c * kQ4Warps;
      live[c] = col[c] < N;
    }
  }

  float acc[kQ4Cols][ROWS];
#pragma unroll
  for (int c = 0; c < kQ4Cols; ++c)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[c][r] = 0.f;

  for (int g0 = 0; g0 < G; g0 += kChunkGroups) {
    const int ng = min(kChunkGroups, G - g0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < ROWS * kChunkGroups * 8; i += kQ4Threads) {
      const int r = i / (kChunkGroups * 8);
      const int gi = (i / 8) % kChunkGroups;
      const int part = i % 8;
      const int row = row0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < B && gi < ng) {
        const int k = (g0 + gi) * 32 + part * 4;
        v = load4(x + static_cast<size_t>(row) * K + k);
        if (gain != nullptr) {
          const float s = inv_rms[row];
          const float4 g = load4(gain + k);
          v.x *= s * g.x;
          v.y *= s * g.y;
          v.z *= s * g.z;
          v.w *= s * g.w;
        }
      }
      *reinterpret_cast<float4*>(&xs[r][gi * kGroupStride + part * 4]) = v;
    }
    __syncthreads();
    if (lane >= ng) continue;  // ragged last chunk (K = 11008 has 344 groups)

    const int g = g0 + lane;
    float w[kQ4Cols][32];
    float sc[kQ4Cols];
#pragma unroll
    for (int c = 0; c < kQ4Cols; ++c) {
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      sc[c] = 0.f;
      if (live[c]) {
        raw = __ldg(reinterpret_cast<const uint4*>(qs + static_cast<size_t>(col[c]) * KH + g * 16));
        sc[c] = __ldg(scales + static_cast<size_t>(col[c]) * G + g);
      }
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          w[c][4 * i + b] = nib(words[i], 8 * b);           // input 4i+b
          w[c][16 + 4 * i + b] = nib(words[i], 8 * b + 4);  // input 16+4i+b
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4* xr = reinterpret_cast<const float4*>(&xs[r][lane * kGroupStride]);
      float part[kQ4Cols];
#pragma unroll
      for (int c = 0; c < kQ4Cols; ++c) part[c] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 xv = xr[j];
#pragma unroll
        for (int c = 0; c < kQ4Cols; ++c) {
          part[c] += xv.x * w[c][4 * j] + xv.y * w[c][4 * j + 1] + xv.z * w[c][4 * j + 2] +
                     xv.w * w[c][4 * j + 3];
        }
      }
#pragma unroll
      for (int c = 0; c < kQ4Cols; ++c) acc[c][r] += sc[c] * part[c];
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float v[kQ4Cols];
#pragma unroll
    for (int c = 0; c < kQ4Cols; ++c) v[c] = warp_sum(acc[c][r]);
    const int row = row0 + r;
    if (lane != 0 || row >= B) continue;
    if (EPI == kSwiGLU) {
      if (live[0]) {
        const float gt = v[0];
        y[static_cast<size_t>(row) * (N / 2) + col[0]] =
            from_f32<TY>(gt / (1.f + expf(-gt)) * v[1]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < kQ4Cols; ++c) {
        if (!live[c]) continue;
        const size_t o = static_cast<size_t>(row) * N + col[c];
        float out = v[c];
        if (EPI == kResidual) out += to_f32(residual[o]);
        y[o] = from_f32<TY>(out);
      }
    }
  }
}

// Host side: pick the row tile and launch.  Returns nothing; the caller
// reads cudaGetLastError().
template <typename TX, typename TY, int EPI>
void launch_q4_gemv(const TX* x, int B, int K, const uint8_t* qs, const float* scales, int N,
                    const TX* gain, const float* inv_rms, const TY* residual, TY* y,
                    cudaStream_t stream) {
  const int cols_per_block = EPI == kSwiGLU ? kQ4Warps : kQ4Warps * kQ4Cols;
  const int ncols = EPI == kSwiGLU ? N / 2 : N;
  const int col_blocks = (ncols + cols_per_block - 1) / cols_per_block;
  const dim3 block(kQ4Threads);
  if (B <= 1) {
    q4_gemv_kernel<TX, TY, 1, EPI><<<dim3(B, col_blocks), block, 0, stream>>>(
        x, B, K, qs, scales, N, gain, inv_rms, residual, y);
  } else if (B <= 2) {
    q4_gemv_kernel<TX, TY, 2, EPI><<<dim3(1, col_blocks), block, 0, stream>>>(
        x, B, K, qs, scales, N, gain, inv_rms, residual, y);
  } else if (B <= 4) {
    q4_gemv_kernel<TX, TY, 4, EPI><<<dim3(1, col_blocks), block, 0, stream>>>(
        x, B, K, qs, scales, N, gain, inv_rms, residual, y);
  } else {
    q4_gemv_kernel<TX, TY, 8, EPI><<<dim3((B + 7) / 8, col_blocks), block, 0, stream>>>(
        x, B, K, qs, scales, N, gain, inv_rms, residual, y);
  }
}

}  // namespace thawk
