// Dequant-GEMV/GEMM core shared by qmatmul.cu (kernel 1 over Q4_0,
// kernel 13 over group codes, kernel 17 over Q4_K super-blocks), ffn.cu
// (kernels 2 and 15, any of them; kernel 2's w13 also super-blocks) and
// flash_decode.cu (kernel 16's Wo projection).
//
// Weight layouts (tokenhawk_tpu_torch/ops/qweight.py), output-major:
//   q4_0: qs uint8 [N, K/2]; group g of column n is 16 bytes at qs[n][16g],
//         byte j holding input 32g+j (low nibble) and 32g+16+j (high
//         nibble), offset binary; scales f32 [N, K/32].
//   qk:   qs int8 [N, K]; scales f32 [N, K/G] and optional mins f32
//         [N, K/G], G 16 or 32; w = code * s + m.
//   sb:   qs as q4_0's (Q4_K codes); d, dmin f32 [N, K/256]; scmn uint8
//         [N, 2K/32], the 6-bit sc of each group of 32 then its mn;
//         w = (code - 8) * s + b, s = d*sc, b = 8s - dmin*mn.
// A reader (Q4Reader, QkReader<G, MINS>, SbReader) turns one 32-input slot
// of a column into 32 code values in registers plus the 32/G scales and
// mins of its groups.
//
// Work split: a block of 8 warps owns a tile of ROWS activation rows and
// 16 output columns (2 per warp).  K is walked in chunks of 32 slots
// (1024 inputs): the block stages the chunk of its rows, normalised
// (x * inv_rms[row] * gain[k]) when a gain is given, into shared memory
// as f32; then lane l of every warp takes slot l of the chunk for both of
// its columns: 16 (q4_0) or 32 (qk) bytes of codes in 16-byte loads, the
// codes converted once into registers and reused by every row.  A group's
// partial dot product is scaled once; with mins, m times the group's sum
// of inputs is added (the reference's per-group bias dot).  Each warp sums
// its lanes at the end.
//
// Blocks are ordered with the row tiles fastest (blockIdx.x), so at
// prefill the blocks that share a weight column run together and the
// weights come from device memory about once, the re-reads from L2.
#pragma once

#include "common.cuh"

namespace thawk {

constexpr int kGemvWarps = 8;
constexpr int kGemvThreads = kGemvWarps * 32;
constexpr int kGemvCols = 2;    // output columns per warp
constexpr int kChunkSlots = 32;  // one 32-input slot per lane
constexpr int kSlotStride = 36;  // floats per staged slot (32 + pad)

enum Epilogue { kStore = 0, kSwiGLU = 1, kResidual = 2 };

// Weight forms at the C boundary (ops/cuda/qmatmul.py form_code).
enum Form {
  kFormQ4 = 0,
  kFormG32 = 1,
  kFormG32Mins = 2,
  kFormG16 = 3,
  kFormG16Mins = 4,
  kFormSb = 5
};

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

// The signed byte at bit `shift` of w, exactly: b ^ 0x80 is b + 128 as an
// unsigned byte, so 0x4B000000 | (b ^ 0x80) is the float 2^23 + 128 + b.
static __device__ __forceinline__ float sbyte(uint32_t w, int shift) {
  return __uint_as_float(0x4B000000u | (((w >> shift) & 0xFFu) ^ 0x80u)) - 8388736.0f;
}

// The 32 codes - 8 of one slot of a packed 4-bit column (q4_0 and sb).
static __device__ __forceinline__ void unpack_nibbles(uint4 raw, float (&w)[32]) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      w[4 * i + b] = nib(words[i], 8 * b);           // input 4i+b
      w[16 + 4 * i + b] = nib(words[i], 8 * b + 4);  // input 16+4i+b
    }
  }
}

struct Q4Reader {
  static constexpr int kSub = 1;  // groups per 32-input slot
  static constexpr bool kMins = false;
  const uint8_t* qs;
  const float* scales;

  __device__ __forceinline__ void load(int col, int slot, int K, bool live, float (&w)[32],
                                       float (&sc)[kSub], float (&mn)[kSub]) const {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    sc[0] = mn[0] = 0.f;
    if (live) {
      raw = __ldg(reinterpret_cast<const uint4*>(qs + static_cast<size_t>(col) * (K / 2) +
                                                 slot * 16));
      sc[0] = __ldg(scales + static_cast<size_t>(col) * (K / 32) + slot);
    }
    unpack_nibbles(raw, w);
  }
};

// Kernel 17's reader: Q4_K's two levels expanded per slot in registers.
// A slot is one group of 32 (sc[g], mn[g]) in super-block g/8 (d, dmin);
// s and b round each step (no FMA contraction), as the plain version does.
// The group's bias b rides the "mins" path: b times the group's input sum.
struct SbReader {
  static constexpr int kSub = 1;
  static constexpr bool kMins = true;
  const uint8_t* qs;
  const float* d;
  const float* dmin;
  const uint8_t* scmn;

  __device__ __forceinline__ void load(int col, int slot, int K, bool live, float (&w)[32],
                                       float (&sc)[kSub], float (&mn)[kSub]) const {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    sc[0] = mn[0] = 0.f;
    if (live) {
      raw = __ldg(reinterpret_cast<const uint4*>(qs + static_cast<size_t>(col) * (K / 2) +
                                                 slot * 16));
      const size_t sb = static_cast<size_t>(col) * (K / 256) + slot / 8;
      const uint8_t* h = scmn + static_cast<size_t>(col) * (K / 16);
      const float s = __fmul_rn(__ldg(d + sb), static_cast<float>(__ldg(h + slot)));
      const float m = __fmul_rn(__ldg(dmin + sb), static_cast<float>(__ldg(h + K / 32 + slot)));
      sc[0] = s;
      mn[0] = __fsub_rn(__fmul_rn(8.f, s), m);
    }
    unpack_nibbles(raw, w);
  }
};

template <int G, bool MINS>
struct QkReader {
  static constexpr int kSub = 32 / G;
  static constexpr bool kMins = MINS;
  const int8_t* qs;
  const float* scales;
  const float* mins;

  __device__ __forceinline__ void load(int col, int slot, int K, bool live, float (&w)[32],
                                       float (&sc)[kSub], float (&mn)[kSub]) const {
    uint4 raw[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
#pragma unroll
    for (int j = 0; j < kSub; ++j) sc[j] = mn[j] = 0.f;
    if (live) {
      const uint4* p = reinterpret_cast<const uint4*>(qs + static_cast<size_t>(col) * K +
                                                      slot * 32);
      raw[0] = __ldg(p);
      raw[1] = __ldg(p + 1);
      const size_t s0 = static_cast<size_t>(col) * (K / G) + slot * kSub;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        sc[j] = __ldg(scales + s0 + j);
        if (MINS) mn[j] = __ldg(mins + s0 + j);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t words[4] = {raw[h].x, raw[h].y, raw[h].z, raw[h].w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int b = 0; b < 4; ++b) w[16 * h + 4 * i + b] = sbyte(words[i], 8 * b);
    }
  }
};

// y = xn @ W for rows [blockIdx.x*ROWS, +ROWS), columns of this block.
//   kStore:    y[B, N]   = acc
//   kSwiGLU:   y[B, N/2] = silu(acc[:, f]) * acc[:, f + N/2]   (TY = float)
//   kResidual: y[B, N]   = residual + acc
// The gain (TG) and the residual (TR) may differ in type from x and y:
// kernel 15 adds a bfloat16 residual into an f32 output, normalises an f32
// input with a bfloat16 gain, and adds an f32 residual into a bfloat16
// output, each value rounded once.
template <typename TX, typename TY, int ROWS, int EPI, typename Reader, typename TG, typename TR>
__global__ void __launch_bounds__(kGemvThreads, 2)
    gemv_kernel(const TX* __restrict__ x, int B, int K, Reader wr, int N,
                const TG* __restrict__ gain, const float* __restrict__ inv_rms,
                const TR* __restrict__ residual, TY* __restrict__ y) {
  constexpr int SUB = Reader::kSub;
  constexpr int F4_PER_SUB = 8 / SUB;  // float4s of one group
  __shared__ __align__(16) float xs[ROWS][kChunkSlots * kSlotStride];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * ROWS;
  const int slots = K / 32;

  int col[kGemvCols];
  bool live[kGemvCols];
  if (EPI == kSwiGLU) {
    const int F = N / 2;
    const int f = blockIdx.y * kGemvWarps + warp;
    col[0] = f;      // gate column of w13
    col[1] = f + F;  // matching up column
    live[0] = live[1] = f < F;
  } else {
    const int base = blockIdx.y * (kGemvWarps * kGemvCols) + warp;
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) {
      col[c] = base + c * kGemvWarps;
      live[c] = col[c] < N;
    }
  }

  float acc[kGemvCols][ROWS];
#pragma unroll
  for (int c = 0; c < kGemvCols; ++c)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[c][r] = 0.f;

  for (int s0 = 0; s0 < slots; s0 += kChunkSlots) {
    const int ns = min(kChunkSlots, slots - s0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < ROWS * kChunkSlots * 8; i += kGemvThreads) {
      const int r = i / (kChunkSlots * 8);
      const int si = (i / 8) % kChunkSlots;
      const int part = i % 8;
      const int row = row0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < B && si < ns) {
        const int k = (s0 + si) * 32 + part * 4;
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
      *reinterpret_cast<float4*>(&xs[r][si * kSlotStride + part * 4]) = v;
    }
    __syncthreads();
    if (lane >= ns) continue;  // ragged last chunk (K = 11008 has 344 slots)

    float w[kGemvCols][32];
    float sc[kGemvCols][SUB], mn[kGemvCols][SUB];
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) wr.load(col[c], s0 + lane, K, live[c], w[c], sc[c], mn[c]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4* xr = reinterpret_cast<const float4*>(&xs[r][lane * kSlotStride]);
      float part[kGemvCols][SUB], xsum[SUB];
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        xsum[j] = 0.f;
#pragma unroll
        for (int c = 0; c < kGemvCols; ++c) part[c][j] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = q / F4_PER_SUB;
        const float4 xv = xr[q];
        if (Reader::kMins) xsum[j] += (xv.x + xv.y) + (xv.z + xv.w);
#pragma unroll
        for (int c = 0; c < kGemvCols; ++c) {
          part[c][j] += xv.x * w[c][4 * q] + xv.y * w[c][4 * q + 1] + xv.z * w[c][4 * q + 2] +
                        xv.w * w[c][4 * q + 3];
        }
      }
#pragma unroll
      for (int c = 0; c < kGemvCols; ++c)
#pragma unroll
        for (int j = 0; j < SUB; ++j) {
          acc[c][r] += sc[c][j] * part[c][j];
          if (Reader::kMins) acc[c][r] += mn[c][j] * xsum[j];
        }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float v[kGemvCols];
#pragma unroll
    for (int c = 0; c < kGemvCols; ++c) v[c] = warp_sum(acc[c][r]);
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
      for (int c = 0; c < kGemvCols; ++c) {
        if (!live[c]) continue;
        const size_t o = static_cast<size_t>(row) * N + col[c];
        float out = v[c];
        if (EPI == kResidual) out += to_f32(residual[o]);
        y[o] = from_f32<TY>(out);
      }
    }
  }
}

// The column blocks of a launch: 16 output columns each (8 gate/up pairs
// for kSwiGLU).
inline int gemv_col_blocks(int EPI, int N) {
  const int cols_per_block = EPI == kSwiGLU ? kGemvWarps : kGemvWarps * kGemvCols;
  const int ncols = EPI == kSwiGLU ? N / 2 : N;
  return (ncols + cols_per_block - 1) / cols_per_block;
}

template <typename T>
struct Same {
  using type = T;
};

// Host side: pick the row tile and launch.  Returns nothing; the caller
// reads cudaGetLastError().  TG and TR default to the types of x and y;
// the gain and residual arguments never deduce them (nullptr is allowed).
template <typename TX, typename TY, int EPI, typename TG = TX, typename TR = TY, typename Reader>
void launch_gemv(const TX* x, int B, int K, const Reader& wr, int N,
                 const typename Same<TG>::type* gain, const float* inv_rms,
                 const typename Same<TR>::type* residual, TY* y, cudaStream_t stream) {
  const int col_blocks = gemv_col_blocks(EPI, N);
  const dim3 block(kGemvThreads);
  if (B <= 1) {
    gemv_kernel<TX, TY, 1, EPI, Reader, TG, TR><<<dim3(B, col_blocks), block, 0, stream>>>(
        x, B, K, wr, N, gain, inv_rms, residual, y);
  } else if (B <= 2) {
    gemv_kernel<TX, TY, 2, EPI, Reader, TG, TR><<<dim3(1, col_blocks), block, 0, stream>>>(
        x, B, K, wr, N, gain, inv_rms, residual, y);
  } else if (B <= 4) {
    gemv_kernel<TX, TY, 4, EPI, Reader, TG, TR><<<dim3(1, col_blocks), block, 0, stream>>>(
        x, B, K, wr, N, gain, inv_rms, residual, y);
  } else {
    gemv_kernel<TX, TY, 8, EPI, Reader, TG, TR>
        <<<dim3((B + 7) / 8, col_blocks), block, 0, stream>>>(x, B, K, wr, N, gain, inv_rms,
                                                              residual, y);
  }
}

// Calls f(reader) with the reader of weight form `form` (enum Form);
// returns false for an unknown form, and for kFormSb unless SB (the
// launches that never take it do not instantiate its reader).  `hi` is
// the sb form's scmn.
template <bool SB, typename Fn>
bool with_reader(int form, const void* qs, const void* scales, const void* mins, const void* hi,
                 Fn&& f) {
  const float* s = static_cast<const float*>(scales);
  const float* m = static_cast<const float*>(mins);
  const int8_t* q8 = static_cast<const int8_t*>(qs);
  const uint8_t* q4 = static_cast<const uint8_t*>(qs);
  switch (form) {
    case kFormQ4:
      f(Q4Reader{q4, s});
      return true;
    case kFormSb:
      if constexpr (SB) {
        f(SbReader{q4, s, m, static_cast<const uint8_t*>(hi)});
        return true;
      }
      return false;
    case kFormG32:
      f(QkReader<32, false>{q8, s, nullptr});
      return true;
    case kFormG32Mins:
      f(QkReader<32, true>{q8, s, m});
      return true;
    case kFormG16:
      f(QkReader<16, false>{q8, s, nullptr});
      return true;
    case kFormG16Mins:
      f(QkReader<16, true>{q8, s, m});
      return true;
    default:
      return false;
  }
}

}  // namespace thawk
