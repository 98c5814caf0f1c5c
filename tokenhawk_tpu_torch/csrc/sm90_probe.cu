// Kernel 22: probes of the sm_90a features the port's dequantizing kernels use.
//
// Replaces experiments/mosaic_probe.py `run_kernel` and `_i4_kernel_input`,
// seven tiny Pallas kernels that asked whether Mosaic lowers each op a Q4/Q8
// dequant needs.  The same seven, one for one, on the same inputs:
//   0  i8 -> f32;
//   1  u8 -> i16, & 0xF -> f32;
//   2  u8 & 0xF (in u8) -> i32 -> f32;
//   3  an int4 input: two signed codes a byte (low nibble first),
//      sign-extended on the card;
//   4  the low nibble of a u8 as a signed int4 (the reference's in-kernel
//      bitcast u8 -> int4, element 0);
//   5  an int8 product with int32 sums through the tensor cores:
//      mma.sync m16n8k32 s32.s8.s8.s32 (inline PTX), one warp a 16 x 8 tile;
//   6  the fma pattern v * s + 1 (v a u8 through i32, s one f32 a column).
// Each is launch-bound at the reference's sizes ([8, 128], 128 x 128).
#include "common.cuh"

using namespace thawk;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float nibble_i4(uint32_t v) {  // 4 bits, two's complement
  return static_cast<float>(static_cast<int>(v << 28) >> 28);
}

__global__ void probe_elementwise(int probe, const void* __restrict__ in0,
                                  const float* __restrict__ in1, float* __restrict__ out,
                                  int rows, int cols) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * cols) return;
  const uint8_t* u8 = static_cast<const uint8_t*>(in0);
  float v;
  switch (probe) {
    case 0: v = static_cast<float>(static_cast<const int8_t*>(in0)[i]); break;
    case 1: v = static_cast<float>(static_cast<int16_t>(u8[i]) & 0xF); break;
    case 2: v = static_cast<float>(static_cast<int32_t>(static_cast<uint8_t>(u8[i] & 0xF))); break;
    case 3: v = nibble_i4(i % 2 == 0 ? u8[i / 2] & 0xFu : u8[i / 2] >> 4); break;
    case 4: v = nibble_i4(u8[i] & 0xFu); break;
    default: v = __fmaf_rn(static_cast<float>(static_cast<int32_t>(u8[i])), in1[i % cols], 1.f);
  }
  out[i] = v;
}

__device__ __forceinline__ uint32_t pack4(const int8_t* p, int step) {
  return static_cast<uint32_t>(static_cast<uint8_t>(p[0])) |
         static_cast<uint32_t>(static_cast<uint8_t>(p[step])) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(p[2 * step])) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(p[3 * step])) << 24;
}

// c [M, N] int32 = a [M, K] int8 @ b [K, N] int8, all row-major; one warp a
// 16 x 8 tile of c, K in steps of 32.  Fragments as the PTX ISA lays them
// out for m16n8k32 with 8-bit inputs (g = lane / 4, t = lane % 4):
// A: regs 0-3 hold rows g, g+8, g, g+8 at columns 4t..4t+3 (+16 for regs
// 2-3); B: regs 0-1 hold rows 4t..4t+3 (+16 for reg 1) of column g;
// C: rows g (regs 0-1) and g+8 (regs 2-3) at columns 2t, 2t+1.
__global__ void probe_mma_s8(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                             int* __restrict__ c, int N, int K) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * 16, col0 = blockIdx.x * 8;
  int d[4] = {0, 0, 0, 0};
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int8_t* ar = a + static_cast<size_t>(row0 + g) * K + k0 + 4 * t;
    const uint32_t a0 = pack4(ar, 1), a1 = pack4(ar + 8 * K, 1);
    const uint32_t a2 = pack4(ar + 16, 1), a3 = pack4(ar + 8 * K + 16, 1);
    const int8_t* bc = b + static_cast<size_t>(k0 + 4 * t) * N + col0 + g;
    const uint32_t b0 = pack4(bc, N), b1 = pack4(bc + 16 * N, N);
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  int* cr = c + static_cast<size_t>(row0 + g) * N + col0 + 2 * t;
  cr[0] = d[0];
  cr[1] = d[1];
  cr[8 * N] = d[2];
  cr[8 * N + 1] = d[3];
}

}  // namespace

// probe 0-4, 6: in0 [rows, cols] (probe 3: packed [rows, cols / 2]), in1 the
// fma's f32 [cols] (probe 6), out f32 [rows, cols].  Probe 5: in0 int8 [rows,
// depth], in1 int8 [depth, cols], out int32 [rows, cols]; rows % 16, cols % 8
// and depth % 32 == 0.
extern "C" int th_sm90_probe(int probe, const void* in0, const void* in1, void* out, int rows,
                             int cols, int depth, cudaStream_t stream) {
  if (probe == 5) {
    probe_mma_s8<<<dim3(cols / 8, rows / 16), 32, 0, stream>>>(
        static_cast<const int8_t*>(in0), static_cast<const int8_t*>(in1),
        static_cast<int*>(out), cols, depth);
  } else {
    const int n = rows * cols;
    probe_elementwise<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        probe, in0, static_cast<const float*>(in1), static_cast<float*>(out), rows, cols);
  }
  return THAWK_LAUNCH_RESULT();
}
